"""Perf hillclimbing: hypothesis -> change -> re-trace -> re-price.

The counterpart of the JAX package's ``launch/hillclimb.py``: the same
three cells (most collective-bound, worst useful-flop ratio, most
sharding-constrained), the same named variants with their hypotheses and
config transforms, run through the port's dry run
(``repro_torch.launch.dryrun.run_cell``) and summarized on one line each.
Results go to experiments/perf/.

Two of the JAX variants' knobs have no counterpart in the port:
``gqa_repeat_to`` (the flash kernel reads the K/V heads in place, never
repeated) and ``attn_block_kv`` (the kernel has no KV block option).  A
variant that sets them prices the same program as the one without, and its
record's ``notes`` say so.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell kimi|qwen|phi4]
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from repro_torch.configs.base import get_config
from repro_torch.launch.dryrun import run_cell

OUT = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "perf"
)


def _r(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


# (variant_name, hypothesis, transform)
CELLS = {
    "kimi": (
        "kimi-k2-1t-a32b", "train_4k",
        [
            (
                "no_fsdp_experts",
                "FSDP regathers all 384 experts' weights per microbatch while"
                " only top-8 are active; excluding 'experts' tensors from"
                " FSDP should cut the ICI collective term by ~the expert"
                " fraction of params (~97%) at +expert-param memory/chip",
                lambda c: _r(c, fsdp_exclude=("experts",)),
            ),
            (
                "accum1",
                "grad_accum=8 repeats every remaining FSDP gather 8x; a"
                " single macrobatch gathers once fwd + once bwd ->"
                " collective term / ~8 at higher activation memory",
                lambda c: _r(c, grad_accum=1),
            ),
            (
                "no_fsdp_experts_accum2",
                "combine both: experts out of FSDP + 2 microbatches"
                " (activation memory compromise)",
                lambda c: _r(c, fsdp_exclude=("experts",), grad_accum=2),
            ),
            (
                "no_fsdp_experts_accum2_gqa16",
                "additionally repeat KV only to TP width (16) instead of 64"
                " heads: attention KV traffic / 4",
                lambda c: _r(
                    c, fsdp_exclude=("experts",), grad_accum=2,
                    gqa_repeat_to=16,
                ),
            ),
            (
                "ep2d",
                "2D expert sharding (experts->model, expert_ffn->data):"
                " weights AND their grads stay fully sharded (no FSDP gather"
                " of 1T params, no 250GB grad buffer); the comm moves to the"
                " ~13x smaller routed activations",
                lambda c: _r(
                    c,
                    fsdp_exclude=("experts",),
                    sharding_overrides={"expert_ffn": (("data",), ())},
                ),
            ),
            (
                "ep2d_gqa16",
                "ep2d plus KV repeat only to TP width: attention KV traffic /4",
                lambda c: _r(
                    c,
                    fsdp_exclude=("experts",),
                    sharding_overrides={"expert_ffn": (("data",), ())},
                    gqa_repeat_to=16,
                ),
            ),
        ],
    ),
    "qwen": (
        "qwen1.5-110b", "prefill_32k",
        [
            (
                "gqa16",
                "prefill repeats 8 KV heads to 64 (8x KV HBM traffic);"
                " repeating only to TP width 16 (grouped attention, G=4)"
                " cuts attention KV reads 4x -> memory term down",
                lambda c: _r(c, gqa_repeat_to=16),
            ),
            (
                "gqa16_block1024",
                "larger KV blocks (512->1024) halve the blockwise-scan trip"
                " count and its rescale traffic (l/m/acc carries)",
                lambda c: _r(c, gqa_repeat_to=16, attn_block_kv=1024),
            ),
            (
                "gqa16_block2048",
                "push block to 2048: fewer trips, bigger tiles; VMEM-feasible"
                " on v5e at (2048 x 128)",
                lambda c: _r(c, gqa_repeat_to=16, attn_block_kv=2048),
            ),
        ],
    ),
    "phi4": (
        "phi4-mini-3.8b", "train_4k",
        [
            (
                "seqpar",
                "24 heads don't divide the 16-way model axis, so baseline"
                " replicates ALL attention compute 16x; sharding the query"
                " sequence over 'model' (context parallelism) recovers it:"
                " HLO flops/dev should drop toward useful-flop parity",
                lambda c: _r(c, sharding_overrides={"seq_q": (("model",),)}),
            ),
            (
                "seqpar_gqa8",
                "with seq-parallel attention, also avoid repeating KV 8->24:"
                " grouped attention at K=8 (G=3) cuts KV traffic 3x",
                lambda c: _r(
                    c,
                    sharding_overrides={"seq_q": (("model",),)},
                    gqa_repeat_to=8,
                ),
            ),
            (
                "seqpar_gqa8_accum8",
                "halve live microbatch activations once more (accum 4->8) to"
                " claw back the temp memory spent on replicated attention"
                " weights",
                lambda c: _r(
                    c,
                    sharding_overrides={"seq_q": (("model",),)},
                    gqa_repeat_to=8,
                    grad_accum=8,
                ),
            ),
        ],
    ),
}


def summarize(rec: dict) -> str:
    if rec["status"] != "ok":
        return f"{rec['status']}: {rec.get('error', '')[:120]}"
    rl = rec["roofline"]
    return (
        f"compute={rl['compute_s']:.4g}s memory={rl['memory_s']:.4g}s "
        f"coll={rl['collective_s']:.4g}s dominant={rl['dominant']} "
        f"useful={rl['useful_flop_ratio']:.3f} "
        f"temp={rec['memory']['temp_size_in_bytes'] / 2**30:.1f}GiB "
        f"flops/dev={rec['summary']['flops']:.3g}"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(CELLS), default=None)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=os.path.abspath(OUT))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cells = [args.cell] if args.cell else sorted(CELLS)
    for cell in cells:
        arch, shape, variants = CELLS[cell]
        base_cfg = get_config(arch)
        print(f"=== {arch} x {shape} ===", flush=True)
        rec = run_cell(arch, shape, args.mesh, args.out, cfg=base_cfg,
                       tag="baseline", device=args.device)
        print(f"  baseline: {summarize(rec)}", flush=True)
        for name, hypothesis, transform in variants:
            cfg = transform(base_cfg)
            rec = run_cell(arch, shape, args.mesh, args.out, cfg=cfg,
                           tag=name, device=args.device)
            print(f"  {name}: {summarize(rec)}", flush=True)
            print(f"    hypothesis: {hypothesis}", flush=True)
            if rec.get("notes"):
                print(f"    port: {rec['notes']}", flush=True)


if __name__ == "__main__":
    main()
