"""Serve-step pricing: ProfileDB measurements + Dooly-style interpolation.

The DES twin prices exactly two kernel families — one prefill chunk and
one full-batch decode step (``repro_torch.serve.paged``) — through the house
fallback chain:

  1. exact DB hit for (arch, tokens/slots, view)        — measured point
  2. interpolated :class:`ServePricer` curve             — Dooly's idea:
     profile a small config grid, log-log-interpolate the unmeasured
     (batch, seqlen) cells instead of sweeping every point
  3. analytic roofline on the node's flops/bytes         — spec-sheet
     fallback, stamped ``analytic`` provenance

:func:`calibrate_serve` measures the real serve steps (same functions the
engine runs) into the DB; :func:`synthetic_serve_calibration` writes a
deterministic linear-cost grid for tests and the bench gate — same role
as ``repro_torch.netprof.sweep.synthetic_calibration``.

DB schema::

    family "serve_prefill": args {"arch", "tokens", "view"}   (batch 1)
    family "serve_decode":  args {"arch", "slots",  "view"}

``view`` is the padded gathered-KV width (``ServeConfig.view_len``) — the
static shape that determines attention cost, regardless of how full the
cache is.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.database import ProfileDB, ProfileEntry
from repro_torch.pricing import PROV_DB, PROV_FIT, Ledger, PriceQuery
from repro_torch.serve.policy import ServeConfig

FAMILY_PREFILL = "serve_prefill"
FAMILY_DECODE = "serve_decode"
SERVE_FAMILIES = (FAMILY_PREFILL, FAMILY_DECODE)
_XKEY = {FAMILY_PREFILL: "tokens", FAMILY_DECODE: "slots"}
# model families whose serve steps the twin prices (the paged forward
# serves the hybrid family too, whose recurrent state it has no terms for)
PRICED_FAMILIES = ("dense", "moe")


# -- analytic features ----------------------------------------------------------


# bytes per element by dtype name; numpy itself knows no bfloat16 (the JAX
# package gets it from ml_dtypes, which the port does not import)
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def _itemsize(dtype: str) -> int:
    return _ITEMSIZE[str(dtype)]


def _is_moe_layer(cfg: ArchConfig, i: int) -> bool:
    return cfg.moe is not None and i % cfg.moe.every_k == cfg.moe.offset


def _param_bytes(cfg: ArchConfig) -> float:
    """Active-parameter bytes read per serve step (MoE: routed experts
    only — the token actually touches top_k + shared expert weights)."""
    d, v = cfg.d_model, cfg.vocab_size
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    itemsize = _itemsize(cfg.param_dtype)
    attn = d * (H + 2 * K) * hd + H * hd * d + 2 * d
    total = v * d
    if not cfg.tie_embeddings:
        total += d * v
    for i in range(cfg.num_layers):
        total += attn
        if _is_moe_layer(cfg, i):
            e = cfg.moe
            act = e.top_k + e.num_shared_experts
            total += act * 3 * d * e.d_ff_expert + d * e.num_experts
        elif cfg.d_ff:
            total += 3 * d * cfg.d_ff
    return float(total * itemsize)


def _flops_per_token(cfg: ArchConfig, view: int) -> float:
    """Dense-equivalent flops of one token through the stack attending a
    ``view``-wide KV window (2 flops per MAC)."""
    d = cfg.d_model
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    proj = 2 * d * (H + 2 * K) * hd + 2 * H * hd * d
    attn = 2 * 2 * H * hd * view          # qk scores + pv mix
    total = 2 * d * cfg.vocab_size        # logits head
    for i in range(cfg.num_layers):
        total += proj + attn
        if _is_moe_layer(cfg, i):
            e = cfg.moe
            act = e.top_k + e.num_shared_experts
            total += act * 3 * 2 * d * e.d_ff_expert + 2 * d * e.num_experts
        elif cfg.d_ff:
            total += 3 * 2 * d * cfg.d_ff
    return float(total)


def serve_node_features(
    cfg: ArchConfig, scfg: ServeConfig, family: str, x: int
) -> tuple[float, float]:
    """(flops, bytes) of one serve kernel call.

    ``x`` is the pricing args value: prefill chunk width in tokens, or the
    decode batch in slots (one token each) — either way, ``x`` tokens flow
    through the stack.  Bytes: full parameter read + per-token KV view
    traffic (gather-read the view, scatter-write one position).
    """
    view = scfg.view_len
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kv_item = _itemsize(cfg.compute_dtype)
    flops = x * _flops_per_token(cfg, view)
    kv_bytes = (
        cfg.num_layers * x * (view + 1) * K * hd * kv_item * 2  # k and v
    )
    return flops, _param_bytes(cfg) + float(kv_bytes)


def serve_node_meta(
    cfg: ArchConfig, scfg: ServeConfig, family: str, x: int
) -> dict[str, object]:
    """The ``node.meta["serve"]`` pricing annotation."""
    return {
        "family": family,
        "arch": cfg.name,
        _XKEY[family]: int(x),
        "view": int(scfg.view_len),
    }


# -- the pricer -----------------------------------------------------------------


class ServePricer:
    """Measured serve-step times: exact hit -> log-log interpolation.

    Curves are grouped per (family, arch, view); within a view the
    measured ``x`` grid (chunk tokens / decode slots) interpolates
    log-log with edge-slope extension beyond the grid; unmeasured views
    interpolate between the bracketing view curves over ``log(view)`` —
    the same structure as ``CollectiveModel._predict_cross_group``.
    """

    def __init__(self, db: ProfileDB, platform: str):
        self.db = db
        self.platform = platform
        acc: dict[tuple[str, str], dict[int, dict[int, list[float]]]] = {}
        for fam in SERVE_FAMILIES:
            xkey = _XKEY[fam]
            for e in db.entries(platform, fam):
                arch, view = e.args.get("arch"), e.args.get("view")
                x = e.args.get(xkey)
                if not arch or not view or not x or e.mean_s <= 0:
                    continue
                acc.setdefault((fam, arch), {}).setdefault(
                    int(view), {}
                ).setdefault(int(x), []).append(float(e.mean_s))
        self.curves: dict[
            tuple[str, str], dict[int, tuple[np.ndarray, np.ndarray]]
        ] = {}
        for key, by_view in acc.items():
            self.curves[key] = {
                view: (
                    np.log(np.asarray(sorted(by_x), dtype=np.float64)),
                    np.log(
                        np.asarray(
                            [float(np.mean(by_x[x])) for x in sorted(by_x)]
                        )
                    ),
                )
                for view, by_x in by_view.items()
            }
        # per-family provenance ledger (repro_torch.pricing.Ledger) — the serve
        # half of the same tally CollectivePricer keeps for collectives
        self.ledger = Ledger(zero_provs=(PROV_DB, PROV_FIT))
        self.stats = self.ledger.stats

    def covers(self, family: str, arch: str) -> bool:
        return (family, arch) in self.curves

    def price(
        self, family: str, arch: str, x: int, view: int
    ) -> Optional[tuple[float, str]]:
        """(seconds, provenance) — None when this (family, arch) has no
        measurements at all (caller falls through to analytic)."""
        hit = self.db.lookup(
            self.platform, family,
            {"arch": arch, _XKEY[family]: int(x), "view": int(view)},
        )
        if hit is not None and hit.mean_s > 0:
            self.ledger.count(family, PROV_DB)
            return float(hit.mean_s), PROV_DB
        views = self.curves.get((family, arch))
        if not views:
            return None
        t = self._interp_views(views, float(x), float(view))
        self.ledger.count(family, PROV_FIT)
        return t, PROV_FIT

    def price_query(self, query: PriceQuery) -> Optional[tuple[float, str]]:
        """The unified :class:`repro_torch.pricing.Pricer` entry point.

        ``query.kind`` is the serve family; ``query.args`` carry ``arch``,
        ``view``, and the family's x-axis argument (``tokens`` for
        prefill, ``slots`` for decode).
        """
        return self.price(
            query.kind,
            str(query.get("arch")),
            int(query.get(_XKEY[query.kind], 0)),
            int(query.get("view", 0)),
        )

    @staticmethod
    def _interp_curve(
        curve: tuple[np.ndarray, np.ndarray], lx: float
    ) -> float:
        """log-time at log-x on one view curve, edge-slope extended."""
        log_x, log_t = curve
        if len(log_x) == 1:
            return float(log_t[0])
        if log_x[0] <= lx <= log_x[-1]:
            return float(np.interp(lx, log_x, log_t))
        i = (0, 1) if lx < log_x[0] else (-2, -1)
        slope = (log_t[i[1]] - log_t[i[0]]) / (log_x[i[1]] - log_x[i[0]])
        anchor = i[0] if lx < log_x[0] else i[1]
        return float(log_t[anchor] + slope * (lx - log_x[anchor]))

    def _interp_views(
        self,
        views: dict[int, tuple[np.ndarray, np.ndarray]],
        x: float,
        view: float,
    ) -> float:
        lx = math.log(max(x, 1.0))
        vkeys = sorted(views)
        if int(view) in views:
            return math.exp(self._interp_curve(views[int(view)], lx))
        logv = np.log(np.asarray(vkeys, dtype=np.float64))
        logt = np.asarray(
            [self._interp_curve(views[v], lx) for v in vkeys]
        )
        lv = math.log(max(view, 1.0))
        return math.exp(float(np.interp(lv, logv, logt)))


# -- calibration ----------------------------------------------------------------


def calibrate_serve(
    db: ProfileDB,
    model,
    params,
    scfg: ServeConfig,
    platform: str = "cpu_host",
    *,
    buckets: Optional[tuple[int, ...]] = None,
    repeats: int = 3,
    device="cuda",
    context: int = 0,
    mesh=None,
) -> int:
    """Measure the real serving-step primitives into the DB.

    Times exactly what the engine pays per step — one prefill chunk per pow2
    bucket / the full-batch decode step, through the same
    ``repro_torch.serve.paged`` functions the engine calls, PLUS the greedy
    argmax readback that synchronizes the host — so an exact DB hit
    reprices an engine step with the engine's own measured cost.
    ``platform`` is the DB key: on the card, the name of its
    :class:`~repro_torch.core.hardware.PlatformSpec`.

    ``context`` is the cache length every decode lane has already written
    and the position every prefill chunk starts at (clamped into the view).
    The JAX package times both at 0.  The port's attention kernel skips the
    keys past each row's causal edge, so on the card a step costs more at a
    longer context; a caller that knows its traffic passes a typical one.
    The DB key does not record it.

    Pass the engine's ``mesh`` to profile the *deployed* placement: params
    and pool replicated, prefill on every replica, the decode batch
    slot-sharded (``serve.paged.decode_slot_sharded``) — a sharded engine
    pays other step costs (on one card, its ranks' decodes run one after
    another), and the DB must record what the deployment will run.
    """
    import torch

    from repro_torch.core.profiler import time_callable
    from repro_torch.device import resolve_device
    from repro_torch.models.build import compute_params, to_device
    from repro_torch.serve import paged

    dev = resolve_device(device)
    cfg = model.cfg
    paged.check_family(cfg)
    if cfg.family not in PRICED_FAMILIES:
        raise ValueError(
            f"the priced serve twin covers the {PRICED_FAMILIES} families, "
            f"not {cfg.family!r}: it has no terms for a recurrent state")
    if buckets is None:
        buckets = tuple(
            2**p for p in range(0, scfg.chunk.bit_length())
            if 2**p <= scfg.chunk
        )
    params = compute_params(to_device(params, dev), cfg)
    pool = paged.init_pool(cfg, scfg, dev)
    reps = None
    if mesh is not None:
        paged.check_slot_sharding(scfg.slots, mesh)
        reps = paged.replicas(params, pool, mesh)
    mb = scfg.max_blocks_per_slot
    nb = scfg.resolved_num_blocks()
    # calibration tables: lane s owns blocks [1 + s*mb, (s+1)*mb] (wrapped
    # into the pool); scratch is 0
    tables = torch.as_tensor(
        (np.arange(scfg.slots * mb) % (nb - 1) + 1).reshape(scfg.slots, mb),
        dtype=torch.int32, device=dev,
    )
    row = tables[0]
    count = 0
    with torch.inference_mode():
        for b in buckets:
            toks = torch.zeros((1, b), dtype=torch.int32, device=dev)
            start = max(0, min(context, scfg.view_len - b))

            def step_prefill(toks=toks, b=b, start=start):
                if reps is not None:
                    logits, _ = paged.prefill_replicated(
                        reps, toks, start, b, row, 0, cfg, scfg
                    )
                else:
                    logits, _ = paged.prefill_chunk(
                        params, pool, toks, start, b, row, 0, cfg, scfg
                    )
                return int(torch.argmax(logits[0, -1]))

            mean, std = time_callable(step_prefill, repeats=repeats,
                                      device=dev)
            flops, nbytes = serve_node_features(cfg, scfg, FAMILY_PREFILL, b)
            db.add(
                platform, FAMILY_PREFILL,
                ProfileEntry(
                    args={"arch": cfg.name, "tokens": int(b),
                          "view": int(scfg.view_len)},
                    mean_s=float(mean), std_s=float(std), n=repeats,
                    flops=flops, bytes=nbytes,
                ),
            )
            count += 1

        toks = torch.zeros((scfg.slots, 1), dtype=torch.int32, device=dev)
        lens = torch.full((scfg.slots,), min(context, scfg.view_len - 1),
                          dtype=torch.int32, device=dev)

        def step_decode():
            if reps is not None:
                logits, _ = paged.decode_slot_sharded(
                    reps, toks, lens, tables, cfg, scfg, mesh
                )
            else:
                logits, _ = paged.decode_batch(
                    params, pool, toks, lens, tables, cfg, scfg
                )
            return torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

        mean, std = time_callable(step_decode, repeats=repeats, device=dev)
    flops, nbytes = serve_node_features(cfg, scfg, FAMILY_DECODE, scfg.slots)
    db.add(
        platform, FAMILY_DECODE,
        ProfileEntry(
            args={"arch": cfg.name, "slots": int(scfg.slots),
                  "view": int(scfg.view_len)},
            mean_s=float(mean), std_s=float(std), n=repeats,
            flops=flops, bytes=nbytes,
        ),
    )
    count += 1
    meta = db.meta(platform).setdefault("serve", {})
    meta.update(
        {
            "version": 1,
            "backend": dev.type,
            "archs": sorted(set(meta.get("archs", [])) | {cfg.name}),
            "entries": sum(
                len(db.entries(platform, f)) for f in SERVE_FAMILIES
            ),
        }
    )
    return count


def synthetic_serve_calibration(
    db: ProfileDB,
    arch: str,
    platform: str = "cpu_host",
    *,
    views: tuple[int, ...] = (64, 128),
    buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32),
    slot_grid: tuple[int, ...] = (1, 2, 4, 8),
    alpha_s: float = 2e-4,
    per_token_s: float = 5e-5,
    per_kv_token_s: float = 2e-7,
) -> int:
    """Deterministic linear-cost serve grid (tests + the bench gate).

    ``t = α + per_token·x + per_kv·x·view`` — exact, hardware-free, so
    simulated percentile reports priced from it are bit-stable across
    hosts and processes (the serve determinism gate's ground truth).
    """
    count = 0
    for view in views:
        for b in buckets:
            t = alpha_s + per_token_s * b + per_kv_token_s * b * view
            db.add(
                platform, FAMILY_PREFILL,
                ProfileEntry(
                    args={"arch": arch, "tokens": int(b), "view": int(view)},
                    mean_s=float(t), std_s=0.0, n=1, flops=0.0, bytes=0.0,
                ),
            )
            count += 1
        for s in slot_grid:
            t = alpha_s + per_token_s * s + per_kv_token_s * s * view
            db.add(
                platform, FAMILY_DECODE,
                ProfileEntry(
                    args={"arch": arch, "slots": int(s), "view": int(view)},
                    mean_s=float(t), std_s=0.0, n=1, flops=0.0, bytes=0.0,
                ),
            )
            count += 1
    meta = db.meta(platform).setdefault("serve", {})
    meta.update(
        {
            "version": 1,
            "backend": "synthetic",
            "archs": sorted(set(meta.get("archs", [])) | {arch}),
            "entries": sum(
                len(db.entries(platform, f)) for f in SERVE_FAMILIES
            ),
        }
    )
    return count
