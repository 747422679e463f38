"""Calibrate the interconnect into a shareable ProfileDB.

Profile once, simulate forever: runs the collective sweep
(``repro_torch.netprof.sweep``: all-reduce / all-gather / reduce-scatter /
all-to-all / collective-permute over a log-spaced payload x group x dtype x
mesh-axis grid, the flat mesh and the dp x pp sub-axis groups) over a mesh
of ``--ranks`` logical ranks, merges the measurements into the DB at
``--db``, and prints the fitted per-collective models.  Later simulations
price their collectives from them through ``launch/train.py --netprof-db``
or ``python -m repro_torch.analysis --netprof-db`` (or any
``OpTimeEstimator`` built with the DB).  The port's counterpart of the JAX
package's ``scripts/calibrate_net.py``; ``--ranks`` stands in for its
``--force-host-devices``.

    # the card: 4 logical ranks on it (the pp x dp and EP meshes' size)
    PYTHONPATH=src python -m repro_torch.netprof.calibrate --db db.json

    # the CPU, tiny grid
    PYTHONPATH=src python -m repro_torch.netprof.calibrate --db db.json \\
        --device cpu --smoke

    # verify: simulate a pp + int8-dp + MoE step measured-vs-ring and fail
    # unless every profiled collective was priced from measurements
    PYTHONPATH=src python -m repro_torch.netprof.calibrate --db db.json \\
        --verify

On one card the ranks share it: the measurements price collectives among
ranks on one card (device-local copies), not NVLink; the DB's stamp says
so (``backend``, ``device_count``, ``ranks``).
"""
from __future__ import annotations

import argparse
import sys


def _parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.netprof.calibrate",
        description=__doc__.splitlines()[0])
    ap.add_argument("--db", default="netprof_db.json",
                    help="ProfileDB path; existing entries are merged, not "
                         "clobbered")
    ap.add_argument("--platform", default=None,
                    help="platform name the entries are recorded under "
                         "(default: the device's, h100_sxm or cpu_host; "
                         "with --verify the DB's, as --netprof-db picks it)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--ranks", type=int, default=4,
                    help="logical ranks of the swept mesh (default 4)")
    ap.add_argument("--collectives", default="",
                    help="comma list (default: all five)")
    ap.add_argument("--payloads", default="",
                    help="comma list of per-device payload bytes "
                         "(default: log-spaced 4KiB..4MiB)")
    ap.add_argument("--dtypes", default="",
                    help="comma list of sweep dtypes "
                         "(default: float32,bfloat16; int8 too)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--no-subgroups", action="store_true",
                    help="skip the 2-D dp x pp sub-axis sweeps")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid (3 payloads, float32, 3 repeats)")
    ap.add_argument("--concurrent", action="store_true",
                    help="also run the concurrent-collective sweep (two "
                         "streams on one mesh axis) and fit the "
                         "link-contention model")
    ap.add_argument("--streams", type=int, default=2,
                    help="concurrent streams for --concurrent (default 2)")
    ap.add_argument("--verify", action="store_true",
                    help="no sweep: load --db and run the measured-vs-ring "
                         "acceptance simulation (exit 1 on any ring "
                         "fallback for a profiled collective)")
    return ap.parse_args(argv)


def calibrated_platform(db, name=None):
    """``(name, spec)`` of the platform a calibrated DB prices: ``name``,
    else ``cpu_host`` when the DB has it (or nothing), else its first
    platform.  A spec-sheet platform (``h100_sxm``) keeps its spec;
    ``cpu_host`` and custom names derive theirs from the DB's own
    measurements under their own name, so the pricer looks the
    measurements up under it (``core.profiler.calibrate_host``)."""
    from repro_torch.core.hardware import PLATFORMS
    from repro_torch.core.profiler import calibrate_host

    if name is None:
        plats = db.platforms()
        name = plats[0] if plats and "cpu_host" not in plats else "cpu_host"
    if name in PLATFORMS and name != "cpu_host":
        return name, PLATFORMS[name]
    return name, calibrate_host(db, name)


def verify(db_path: str, platform_name=None, log_fn=print) -> int:
    """Price the pp + int8-dp + MoE acceptance graph from the DB and its
    ring model; 0 when every collective node was priced from
    measurements, else 1."""
    from repro_torch.core.database import ProfileDB
    from repro_torch.netprof.pricing import netprof_meta
    from repro_torch.netprof.report import acceptance_graph, measured_vs_ring

    db = ProfileDB.load(db_path)
    name, platform = calibrated_platform(db, platform_name)
    stamp = netprof_meta(db, name)
    if stamp is None:
        log_fn(f"[netprof] FAIL: {db_path} has no netprof calibration for "
               f"{name!r}")
        return 1
    log_fn(f"[netprof] calibration: backend={stamp.get('backend')} "
           f"devices={stamp.get('device_count')} "
           f"ranks={stamp.get('ranks')} groups={stamp.get('groups')} "
           f"entries={stamp.get('entries')}")
    r = measured_vs_ring(acceptance_graph(), db, platform)
    for line in r.lines():
        log_fn(f"[netprof] {line}")
    if r.ring_fallbacks:
        log_fn(f"[netprof] FAIL: {r.ring_fallbacks} collective nodes fell "
               f"back to the ring model despite measurements")
        return 1
    measured = sum(
        s.get("measured-db", 0) + s.get("measured-fit", 0)
        for s in r.provenance.values()
    )
    if measured < r.collective_nodes:
        log_fn(f"[netprof] FAIL: only {measured}/{r.collective_nodes} "
               f"collective nodes priced from measurements")
        return 1
    log_fn(f"[netprof] OK: all {r.collective_nodes} collective nodes priced "
           f"from the measured chain")
    return 0


def main(argv=None) -> int:
    args = _parse(argv)
    if args.verify:
        return verify(args.db, args.platform)

    from repro_torch.core.database import ProfileDB
    from repro_torch.core.profiler import platform_name
    from repro_torch.device import resolve_device
    from repro_torch.netprof.model import fit_collective_models
    from repro_torch.netprof.sweep import SweepConfig, sweep_collectives

    dev = resolve_device(args.device)
    platform = args.platform or platform_name(dev)
    cfg = SweepConfig.smoke() if args.smoke else SweepConfig()
    cfg = SweepConfig(
        collectives=(tuple(args.collectives.split(","))
                     if args.collectives else cfg.collectives),
        payload_bytes=(tuple(int(p) for p in args.payloads.split(","))
                       if args.payloads else cfg.payload_bytes),
        dtypes=tuple(args.dtypes.split(",")) if args.dtypes else cfg.dtypes,
        repeats=cfg.repeats if args.smoke else args.repeats,
        subgroup_meshes=not args.no_subgroups,
    )
    print(f"[netprof] device={dev} ranks={args.ranks} platform={platform} "
          f"db={args.db}")
    if args.ranks < 2:
        print("[netprof] FAIL: need 2 or more ranks to sweep collectives")
        return 1

    db = ProfileDB.load_or_empty(args.db)
    n = sweep_collectives(db, platform=platform, config=cfg,
                          ranks=args.ranks, device=dev)
    if args.concurrent:
        from repro_torch.netprof.model import fit_link_contention
        from repro_torch.netprof.sweep import sweep_concurrent

        nc = sweep_concurrent(db, platform=platform, config=cfg,
                              streams=args.streams, ranks=args.ranks,
                              device=dev)
        print(f"[netprof] recorded {nc} concurrent-collective measurements")
        cm = fit_link_contention(db, platform)
        if cm is None:
            print("[netprof] FAIL: concurrent sweep produced no fittable "
                  "link-contention pairs")
            return 1
        print(f"[netprof] {cm.describe()}")
    db.save(args.db)
    print(f"[netprof] recorded {n} measurements -> {args.db}")

    models = fit_collective_models(db, platform)
    for kind in sorted(models):
        m = models[kind]
        for g in m.groups:
            c = m.curves[g]
            bw = 1.0 / c.sec_per_wire_byte / 1e9
            print(f"[netprof] {kind:<18s} g={g:<3d} "
                  f"payload {c.min_bytes / 1024:.0f}KiB.."
                  f"{c.max_bytes / 1024:.0f}KiB  "
                  f"alpha={c.alpha * 1e6:.1f}us  wire_bw={bw:.2f}GB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
