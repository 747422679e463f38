"""The MoE FFN's dropless path against its einsum path, and the path choice.

Where no choice can drop (``capacity(moe, group) >= group``), autograd is
off, the rank view is the whole, the compute is bf16 or the call is on the
CPU (as here) and the ep_a2a branch did not take the call,
``models/moe.py::moe_ffn`` routes as the einsum path does and runs the
experts over their routed rows alone (``kernels/moe_experts``, its plain
version here on the CPU).  It must compute the einsum path's function:
outputs within 1e-5 in fp32 and the repo's 2e-2 in bf16, the aux loss
equal.  Elsewhere the einsum path runs, as :data:`moe.EP_CALLS` shows.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import MoEConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.dist.mesh import Mesh  # noqa: E402
from repro_torch.kernels.moe_experts import ops as mx  # noqa: E402
from repro_torch.kernels.moe_experts import ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.sharding import RankView, ShardingCtx, use_sharding  # noqa: E402

torch.set_num_threads(2)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _dropless(m: MoEConfig) -> MoEConfig:
    return dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k)


# the smoke MoE shapes of both serve configurations, and the published
# expert counts and top-k of each at small widths
SHAPES = {
    "qwen3 smoke": lambda: (
        _dropless(smoke_variant(get_config("qwen3-moe-235b-a22b")).moe), 128),
    "granite smoke": lambda: (
        _dropless(smoke_variant(get_config("granite-4.0-h-small")).moe), 128),
    "qwen3 experts": lambda: (MoEConfig(num_experts=128, top_k=8,
                                        d_ff_expert=32, capacity_factor=16.0,
                                        group_size=512), 64),
    "granite experts": lambda: (MoEConfig(num_experts=72, top_k=10,
                                          d_ff_expert=48, capacity_factor=7.2,
                                          group_size=512), 64),
}


def _inputs(m: MoEConfig, d: int, case: str, dtype, seed: int = 0):
    """A layer's weights and tokens x (B, S, d) for ``case``."""
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_moe(gen, d, m, dtype)
    shape = {"batch": (2, 16), "one token": (1, 1), "padded bucket": (1, 16),
             "every token to the same experts": (2, 16)}[case]
    x = torch.randn(shape + (d,), generator=gen)
    if case == "padded bucket":
        # a chunk of 10 tokens padded to a bucket of 16: the pad rows alike
        x[:, 10:] = x[:, 9:10]
    if case == "every token to the same experts":
        x[..., 0] = 8.0
        p["router"][0] = 0.0
        p["router"][0, :m.top_k] = 4.0
    return p, x.to(dtype)


def _both(p, x, m, dtype):
    """(dropless y, aux, calls), (einsum y, aux, calls) on the same call."""
    cdt = "float32" if dtype == torch.float32 else "bfloat16"
    moe.reset_ep_calls()
    with torch.no_grad():
        y, aux = moe.moe_ffn(p, x, m, cdt)
    calls = dict(moe.EP_CALLS)
    moe.reset_ep_calls()
    ye, auxe = moe.moe_ffn(p, x, m, cdt)
    return (y, aux, calls), (ye.detach(), auxe.detach(), dict(moe.EP_CALLS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["batch", "one token", "padded bucket",
                                  "every token to the same experts"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_dropless_path_computes_the_einsum_path(shape, case, dtype):
    m, d = SHAPES[shape]()
    p, x = _inputs(m, d, case, dtype)
    (y, aux, calls), (ye, auxe, calls_e) = _both(p, x, m, dtype)
    assert calls == {"dropless": 1} and calls_e == {"einsum": 1}
    assert y.dtype == ye.dtype and y.shape == x.shape
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), ye.float(), rtol=tol, atol=tol)
    assert torch.equal(aux, auxe)
    if case == "every token to the same experts":
        # one expert takes every row of the group, the others none
        n_tok = x.shape[0] * x.shape[1]
        _, _, idx = moe.route(p, x.reshape(1, n_tok, d), m)
        counts = torch.bincount(idx.reshape(-1), minlength=m.num_experts)
        assert counts[:m.top_k].tolist() == [n_tok] * m.top_k
        assert not counts[m.top_k:].any()


def test_path_choice_follows_the_four_conditions():
    m, d = SHAPES["qwen3 smoke"]()
    p, x = _inputs(m, d, "batch", torch.float32)

    def calls(m, ctx=None, grad=False):
        moe.reset_ep_calls()
        with torch.set_grad_enabled(grad), use_sharding(ctx):
            moe.moe_ffn(p, x, m, "float32")
        return dict(moe.EP_CALLS)

    assert calls(m) == {"dropless": 1}
    # capacity can bind: 32 tokens a group, capacity ceil(2 * 32 / 4 * 1.25)
    binding = dataclasses.replace(m, capacity_factor=1.25)
    assert moe.capacity(binding, 32) < 32
    assert calls(binding) == {"einsum": 1}
    # ... but not for one token: its k experts are distinct
    one = x[:1, :1]
    moe.reset_ep_calls()
    with torch.no_grad():
        moe.moe_ffn(p, one, binding, "float32")
    assert moe.EP_CALLS == {"dropless": 1}
    # autograd on, even with no tensor that needs a gradient
    assert calls(m, grad=True) == {"einsum": 1}
    # a dry-run rank's view (here of the whole expert tree)
    mesh = Mesh(("data", "model"), (1, 1), (torch.device("meta"),))
    assert calls(m, ShardingCtx(mesh=mesh, rank=RankView(model=1))) == {
        "einsum": 1}
    # a sharding context without a rank view is the whole
    assert calls(m, ShardingCtx(mesh=mesh)) == {"dropless": 1}


@pytest.mark.parametrize("arch,layers", [("qwen3-moe-235b-a22b", 4),
                                         ("granite-4.0-h-small", 20)])
def test_training_and_serving_take_their_paths(arch, layers):
    """The serve cells' depths at smoke widths and capacity E / k: a loss
    under autograd takes the einsum path in every MoE layer, a paged decode
    call the dropless one (4 calls a qwen3 decode call, 20 a granite one)."""
    from repro_torch.models import build_model
    from repro_torch.serve import paged
    from repro_torch.serve.policy import ServeConfig

    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              num_layers=layers)
    cfg = dataclasses.replace(cfg, moe=_dropless(cfg.moe))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(1, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    moe.reset_ep_calls()
    loss = model.loss(params, {"tokens": tokens, "labels": tokens})
    loss = loss[0] if isinstance(loss, tuple) else loss
    assert moe.EP_CALLS == {"einsum": cfg.num_layers}
    scfg = ServeConfig(slots=2, max_len=32, block_size=8, chunk=8)
    pool = paged.init_pool(cfg, scfg, "cpu")
    tables = torch.zeros((2, scfg.max_blocks_per_slot), dtype=torch.int32)
    moe.reset_ep_calls()
    with torch.inference_mode():
        logits, _ = paged.decode_batch(
            params, pool, torch.ones((2, 1), dtype=torch.int32),
            torch.tensor([3, 0], dtype=torch.int32), tables, cfg, scfg)
    assert moe.EP_CALLS == {"dropless": cfg.num_layers}
    assert torch.isfinite(logits).all()


def test_routing_table_is_the_einsum_paths_slot_order():
    """Rows sorted by expert, within an expert token-major and choice-minor
    (the einsum path's slot order); each expert's 64-row tiles in order; an
    expert with no rows has none; the rest of the table is -1."""
    gen = torch.Generator().manual_seed(3)
    T, k, E = 150, 4, 9
    others = torch.tensor([e for e in range(E) if e != 5])  # 5 takes none
    idx = torch.stack([others[torch.randperm(E - 1, generator=gen)[:k]]
                       for _ in range(T)])
    rows = ref.route_ref(idx, E)
    flat = idx.reshape(-1)
    counts = torch.bincount(flat, minlength=E)
    assert rows["offsets"].tolist() == [0] + torch.cumsum(counts, 0).tolist()
    row_of, src = rows["row_of"].long(), rows["src_tok"].long()
    assert sorted(row_of.tolist()) == list(range(T * k))
    # the choice at each sorted row: its expert ascending, then flat order
    choice = torch.empty_like(row_of)
    choice[row_of] = torch.arange(T * k)
    assert torch.equal(src, choice // k)
    keys = flat[choice] * (T * k) + choice
    assert torch.equal(keys, torch.sort(keys).values)
    tiles = rows["tiles"].tolist()
    want = [[e, int(rows["offsets"][e]) + 64 * j] for e in range(E)
            for j in range(-(-int(counts[e]) // 64))]
    assert tiles[:len(want)] == want
    assert all(t == [-1, 0] for t in tiles[len(want):])
    assert len(tiles) == ref.max_tiles(T * k, E) >= len(want)
    assert counts[5] == 0 and all(t[0] != 5 for t in tiles)


def test_plain_version_is_the_sum_over_each_tokens_choices():
    """``moe_experts_ref`` against a loop over every (token, choice) in
    fp32: y[t] = sum_j gate[t, j] * swiglu expert_j(x[t])."""
    m, d = SHAPES["granite experts"]()
    gen = torch.Generator().manual_seed(4)
    p = moe.init_moe(gen, d, m, torch.float32)
    x = torch.randn(12, d, generator=gen)
    _, gate, idx = moe.route(p, x[None], m)
    gate, idx = gate[0], idx[0]
    y = mx.moe_experts(x, gate, idx, p["wg"], p["wu"], p["wd"])
    want = torch.zeros_like(x)
    for t in range(12):
        for j in range(m.top_k):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(x[t] @ p["wg"][e]) * (
                x[t] @ p["wu"][e])
            want[t] += gate[t, j] * (h @ p["wd"][e])
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_cost_counts_the_routed_experts_bytes():
    T, k, E, D, Fe = 128, 10, 72, 4096, 768
    x = torch.empty(T, D, dtype=torch.bfloat16, device="meta")
    idx = torch.empty(T, k, dtype=torch.int64, device="meta")
    wg = torch.empty(E, D, Fe, dtype=torch.bfloat16, device="meta")
    wd = torch.empty(E, Fe, D, dtype=torch.bfloat16, device="meta")
    ops_, nbytes = mx.cost(x, idx, wg, wg, wd)
    assert ops_ == 6 * T * k * D * Fe
    weights = E * 3 * D * Fe * 2
    assert weights == 1_358_954_496       # a granite layer's experts
    assert weights < nbytes < 1.02 * weights
    _, fewer = mx.cost(x, idx, wg, wg, wd, experts_hit=10)
    assert fewer - 10 * 3 * D * Fe * 2 == nbytes - weights


def test_the_ops_refuse_what_the_kernels_do_not_take():
    m, d = SHAPES["qwen3 smoke"]()
    p = moe.init_moe(torch.Generator().manual_seed(0), d, m, "float32")
    x = torch.randn(4, d)
    gate = torch.full((4, 2), 0.5)
    idx = torch.tensor([[0, 1]] * 4)
    with pytest.raises(TypeError):
        mx.moe_experts(x.bfloat16(), gate, idx, p["wg"], p["wu"], p["wd"])
    with pytest.raises(TypeError):
        mx.moe_experts(x, gate, idx.int(), p["wg"], p["wu"], p["wd"])
    with pytest.raises(ValueError):
        mx.moe_experts(x[:, :64], gate, idx, p["wg"], p["wu"], p["wd"])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mx.route(idx.to("meta"), 4)
    # moe_ffn's dropless path: a tree of fewer experts than the config
    piece = {k: v if k == "router" else v[:2] for k, v in p.items()}
    with torch.no_grad(), pytest.raises(ValueError, match="2 experts"):
        moe.moe_ffn(piece, x[None], m, "float32")
