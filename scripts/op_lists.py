"""The ATen op lists of every family and mode of the port's model layer.

Records with a ``TorchDispatchMode`` every ATen op, with its arguments'
shapes and dtypes, that each mode dispatches on the CPU at smoke size: a
loss and its gradient under each remat policy, ``Model.prefill`` and
``Model.decode``, the paged ``prefill_chunk`` and ``decode_batch`` of the
families the paged engine serves, and the pipelined step (pp 2, two
microbatches, 1F1B) of a small llama and qwen3-moe.  A change that should
not alter what runs, such as a refactor of the model layer, leaves every
list equal.  Record a tree's lists with that tree's ``src`` on the path,
then compare two recordings (exit 1 where they differ)::

    PYTHONPATH=src python scripts/op_lists.py --out new.json
    PYTHONPATH=/path/to/parent/src python scripts/op_lists.py --out old.json
    python scripts/op_lists.py --compare old.json new.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from functools import partial

ARCHS = ("llama3.2-1b", "qwen3-moe-235b-a22b", "pixtral-12b",
         "granite-4.0-h-small", "jamba-1.5-large-398b", "mamba2-2.7b",
         "seamless-m4t-large-v2")


def _sig(x) -> str:
    import torch

    if isinstance(x, torch.Tensor):
        return "x".join(map(str, x.shape)) + ":" + str(x.dtype)[6:]
    if isinstance(x, (list, tuple)):
        return "[" + ",".join(_sig(a) for a in x) + "]"
    return type(x).__name__


def record(fn) -> list[str]:
    """The ops ``fn()`` dispatches, in order, each with its arguments."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(f"{func}({_sig(list(args))})")
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return ops


def _loss_backward(model, params, batch) -> None:
    model.loss(params, batch)[0].backward()


def family_modes(cfg) -> dict[str, list[str]]:
    """Every mode of ``cfg``'s family at smoke size: {mode: ops}."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.models.build import compute_params, make_concrete_batch
    from repro_torch.serve import paged
    from repro_torch.serve.policy import ServeConfig
    from repro_torch.tree import tree_map

    out = {}
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = make_concrete_batch(cfg, ShapeConfig("ops", 32, 2, "train"),
                                device="cpu")
    for remat in ("none", "dots", "full"):
        model = build_model(dataclasses.replace(cfg, remat_policy=remat))
        leaf = tree_map(lambda t: t.detach().clone().requires_grad_(
            t.is_floating_point()), params)
        out[f"loss_grad_{remat}"] = record(
            partial(_loss_backward, model, leaf, batch))
    model = build_model(cfg)
    toks, kw, cache = batch["tokens"][:, :16], {}, {}
    if cfg.num_patches:
        kw["patches"] = batch["patches"]
    if cfg.family == "audio":
        kw["frames"] = make_concrete_batch(
            cfg, ShapeConfig("ops", cfg.source_len, 2, "train"),
            device="cpu")["frames"]

    def prefill():
        cache["c"] = model.prefill(params, toks, max_len=40, **kw)[1]

    with torch.inference_mode():
        out["prefill"] = record(prefill)
        out["decode"] = record(lambda: model.decode(
            params, cache["c"], toks[:, :1], 16 + cfg.num_patches))
    if cfg.family not in paged.SUPPORTED_FAMILIES or cfg.num_patches:
        return out
    scfg = ServeConfig(slots=2, max_len=32, block_size=8, chunk=8)
    cp = compute_params(params, cfg)
    pool = paged.init_pool(cfg, scfg, "cpu")
    row = torch.arange(1, scfg.max_blocks_per_slot + 1, dtype=torch.int32)
    t8 = batch["tokens"][:1, :8]
    slot = 1 if cfg.family == "hybrid" else None

    def chunks():
        for start, width in ((0, 8), (8, 5)):
            paged.prefill_chunk(cp, pool, t8, start, width, row, 0, cfg,
                                scfg, slot=slot)

    with torch.inference_mode():
        out["prefill_chunk"] = record(chunks)
        out["decode_batch"] = record(lambda: paged.decode_batch(
            cp, pool, t8[:, :2].T.contiguous(),
            torch.tensor([0, 13], dtype=torch.int32),
            torch.stack([torch.zeros_like(row), row]), cfg, scfg))
    return out


def pipeline_step(name: str) -> list[str]:
    """The pipelined step of a 4-layer, 64-wide ``name``."""
    import torch

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models import build_model, pipeline
    from repro_torch.models.build import make_concrete_batch

    cfg = smoke_variant(get_config(name))
    cfg = dataclasses.replace(cfg, num_layers=4, d_model=64, num_heads=2,
                              num_kv_heads=2, head_dim=32,
                              d_ff=128 if cfg.d_ff else 0, vocab_size=256)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = make_concrete_batch(cfg, ShapeConfig("ops", 16, 4, "train"),
                                device="cpu")
    plan = pipeline.make_plan(cfg, 2, 2, schedule="1f1b")
    mesh = make_mesh((2,), ("stage",), device="cpu")
    return record(lambda: pipeline.pipeline_loss_and_grads(
        plan, params, batch, mesh))


def all_lists(archs=ARCHS) -> dict[str, list[str]]:
    from repro_torch.configs import get_config, smoke_variant

    out = {}
    for arch in archs:
        cfg = smoke_variant(get_config(arch))
        if cfg.family == "ssm":
            cfg = dataclasses.replace(cfg, num_layers=2)
        for mode, ops in family_modes(cfg).items():
            out[f"{arch}/{mode}"] = ops
    for name in ("llama3.2-1b", "qwen3-moe-235b-a22b"):
        out[f"{name}/pipeline"] = pipeline_step(name)
    return out


def compare(old: dict, new: dict) -> bool:
    """Print each list's op count on both sides; True where all are equal."""
    same = old.keys() == new.keys()
    for key in sorted(old.keys() | new.keys()):
        a, b = old.get(key), new.get(key)
        line = f"{key}: {len(a) if a else '-'} / {len(b) if b else '-'}"
        if a != b:
            same = False
            first = next((i for i, (x, y) in enumerate(zip(a or [], b or []))
                          if x != y), min(len(a or []), len(b or [])))
            line += f"  differ from op {first}"
        print(line)
    print("equal" if same else "NOT equal")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write this tree's op lists here (JSON)")
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"))
    args = ap.parse_args(argv)
    if args.compare:
        lists = []
        for path in args.compare:
            with open(path) as f:
                lists.append(json.load(f))
        return 0 if compare(*lists) else 1
    if not args.out:
        ap.error("give --out or --compare")
    import torch

    torch.set_num_threads(2)
    lists = all_lists()
    with open(args.out, "w") as f:
        json.dump(lists, f, indent=0)
    print(f"{len(lists)} op lists, {sum(map(len, lists.values()))} ops "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
