"""Gradient compression and the logical-rank mesh in the port, against the
JAX package: quantization, top-k and error feedback on the same numpy
inputs; ``compressed_psum`` over 4 logical CPU ranks against the mean of the
per-rank JAX arithmetic; every byte twin exactly; the mesh's collectives.

Tolerances: the reference's fp32 2e-5 (tests/test_kernels.py::tol) for the
dequantized payloads, means and residuals (one int8 step may differ where
an element sits on a rounding boundary: then by exactly one scale step, so
the int8 payloads are compared with a budget of such elements).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.dist import compress as jc  # noqa: E402
from repro_torch.dist import compress as tc  # noqa: E402
from repro_torch.dist import mesh as M  # noqa: E402

torch.set_num_threads(2)

TOL = 2e-5


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((8, 16)) * scale).astype(np.float32),
            "b": {"c": rng.standard_normal((33,)).astype(np.float32),
                  "d": np.zeros((4, 4), np.float32)},
            "e": (rng.standard_normal((2, 3, 5)) * 1e-3).astype(np.float32)}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(tree)


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [np.asarray(tree)]


def test_quantize_topk_feedback_match_jax():
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal((64, 32)).astype(np.float32),
              np.zeros((7,), np.float32),
              (rng.standard_normal(1000) * 1e-4).astype(np.float32)):
        jq, js = jc.quantize_int8(jnp.asarray(x))
        tq, ts = tc.quantize_int8(torch.tensor(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
        assert int((tq.numpy().astype(int) - np.asarray(jq)).__abs__()
                   .max(initial=0)) <= 1
        assert np.mean(tq.numpy() != np.asarray(jq)) < 0.01
        np.testing.assert_allclose(
            tc.dequantize_int8(tq, ts).numpy(),
            np.asarray(jc.dequantize_int8(jq, js)),
            atol=float(np.asarray(js)) * 1.0001 + 1e-12)
        jk, jr = jc.topk_sparsify(jnp.asarray(x), 0.05)
        tk, tr = tc.topk_sparsify(torch.tensor(x), 0.05)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert np.array_equal((tk + tr).numpy(), x)
    g = rng.standard_normal((40, 12)).astype(np.float32)
    r = (rng.standard_normal((40, 12)) * 0.01).astype(np.float32)
    jq, js, jn = jc.compress_with_feedback(jnp.asarray(g), jnp.asarray(r))
    tq, ts, tn = tc.compress_with_feedback(torch.tensor(g), torch.tensor(r))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=TOL)
    np.testing.assert_allclose(
        (tc.dequantize_int8(tq, ts) + tn).numpy(), g + r, atol=TOL)


@pytest.mark.parametrize("buckets", [0, 2, 3])
def test_compressed_psum_over_four_ranks_matches_jax_arithmetic(buckets):
    rng = np.random.default_rng(1)
    grads = [_tree(rng, scale=1 + r) for r in range(4)]
    res = [_tree(rng, scale=0.01) for _ in range(4)]
    # the reference's per-rank arithmetic (axis_name=None: its identity
    # mean), averaged over the ranks
    jmeans, jres = [], []
    for g, r in zip(grads, res):
        m, nr = jc.compressed_psum(_j(g), None, _j(r))
        jmeans.append(_flat(m))
        jres.append(_flat(nr))
    want = [np.mean([jm[i] for jm in jmeans], axis=0)
            for i in range(len(jmeans[0]))]
    devices = [torch.device("cpu")] * 4
    M.reset_traffic()
    means, new_res = tc.compressed_psum([_t(g) for g in grads], devices,
                                        [_t(r) for r in res],
                                        buckets=buckets)
    assert len(means) == 4
    for rank in range(4):
        for got, w in zip(_flat({k: v for k, v in means[rank].items()}),
                          want):
            np.testing.assert_allclose(np.asarray(got), w, atol=TOL)
        for got, w in zip(_flat(new_res[rank]), jres[rank]):
            np.testing.assert_allclose(np.asarray(got), w, atol=TOL)
    # the int8 payloads a ring would ship: elements + one scale a leaf,
    # from every rank
    n_elems = sum(x.size for x in _flat(grads[0]))
    assert M.TRAFFIC["psum_int8"] == 4 * (n_elems + 4 * 4)
    # the identity mean (dp = 1) is the reference's axis_name=None path
    m1, r1 = tc.compressed_psum(_t(grads[0]), None, _t(res[0]))
    for got, w in zip(_flat(m1), jmeans[0]):
        np.testing.assert_allclose(np.asarray(got), w, atol=TOL)


def test_inplace_residuals_and_buckets_are_bit_identical():
    rng = np.random.default_rng(2)
    grads = [_t(_tree(rng)) for _ in range(2)]
    res = [_t(_tree(rng, 0.01)) for _ in range(2)]
    devs = [torch.device("cpu")] * 2
    m0, r0 = tc.compressed_psum(grads, devs, [dict(r) for r in res])
    keep = [{k: (v.clone() if torch.is_tensor(v) else
                 {kk: vv.clone() for kk, vv in v.items()})
             for k, v in r.items()} for r in res]
    m2, r2 = tc.compressed_psum(grads, devs, keep, buckets=2, inplace=True)
    for a, b in zip(_flat(m0[1]), _flat(m2[1])):
        assert np.array_equal(a, b)
    for a, b, c in zip(_flat(r0[0]), _flat(r2[0]), _flat(keep[0])):
        assert np.array_equal(a, b) and np.array_equal(b, c)
    dense = tc.bucketed_pmean(grads, devs, buckets=3)
    for got, a, b in zip(_flat(dense[0]), _flat(grads[0]), _flat(grads[1])):
        np.testing.assert_allclose(got, (a + b) / 2, atol=1e-7)


def test_byte_twins_equal_reference_exactly():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    elems = [int(x.size) for x in _flat(tree)]
    assert tc.leaf_elems(_t(tree)) == jc.leaf_elems(_j(tree)) == elems
    for scheme in ("int8", "none", "topk:0.01", "topk:0.3"):
        assert tc.compressed_psum_bytes(_t(tree), scheme) == \
            jc.compressed_psum_bytes(_j(tree), scheme)
        assert tc.tree_allreduce_bytes(elems, scheme) == \
            jc.tree_allreduce_bytes(elems, scheme)
        for n, t in ((1000, 1), (12345, 7), (3, 3)):
            assert tc.compressed_allreduce_bytes(n, t, scheme) == \
                jc.compressed_allreduce_bytes(n, t, scheme)
        for b in (1, 2, 3, 8):
            assert tc.bucket_allreduce_bytes(elems, scheme, b) == \
                jc.bucket_allreduce_bytes(elems, scheme, b)
    for sizes in ([5], [1, 2, 3, 4, 5, 6], [100, 1, 1, 1], [7] * 9):
        for b in (1, 2, 3, 4, 16):
            assert tc.reverse_bucket_indices(sizes, b) == \
                jc.reverse_bucket_indices(sizes, b)
    with pytest.raises(ValueError):
        tc.compressed_allreduce_bytes(10, 1, "fp4")
    st = tc.init_feedback_state(_t(tree), dp=3)
    assert [tuple(x.shape) for x in _flat(st)] == \
        [(3,) + x.shape for x in _flat(tree)]


def test_mesh_collectives_and_device_binding():
    mesh = M.make_mesh((2, 3), ("data", "stage"), device="cpu")
    assert mesh.n_ranks == 6 and mesh.sizes == {"data": 2, "stage": 3}
    assert mesh.group("stage", (1, 0)) == [(1, 0), (1, 1), (1, 2)]
    assert [g[0] for g in mesh.groups("data")] == [(0, 0), (0, 1), (0, 2)]
    assert M.mesh_info(mesh)["axis_sizes"] == (2, 3)
    vals = {c: torch.full((2,), float(mesh.flat(c))) for c in mesh.coords()}
    M.reset_traffic()
    s = mesh.psum(vals, "data")
    assert float(s[(1, 2)][0]) == 2.0 + 5.0
    assert M.TRAFFIC["psum"] == 6 * 8
    p = mesh.pmean(vals, "stage")
    assert float(p[(0, 1)][0]) == 1.0 and float(p[(1, 0)][0]) == 4.0
    r = mesh.ppermute(vals, "stage", [(0, 1), (1, 2)])
    assert float(r[(1, 1)][0]) == 3.0 and r[(1, 0)] is None
    assert r[(1, 1)] is not vals[(1, 0)]      # a copy: ranks own buffers
    assert M.TRAFFIC["ppermute"] == 4 * 8
    ag = mesh.all_gather(vals, "data")
    assert tuple(ag[(0, 2)].shape) == (2, 2)
    assert M.psum([None, None], [torch.device("cpu")] * 2) == [None, None]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.make_mesh((4,), ("data",))
