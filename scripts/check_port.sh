#!/usr/bin/env bash
# The PyTorch port's verification gate: the mirror of scripts/check.sh's
# modes over the port's own entry points (src/repro_torch).  The modes
# that run a launcher (determinism, docs, serve, obs, netprof) run it on
# the card, as the launchers do, and exit 1 when no card is visible;
# DEVICE=cpu runs them on the CPU instead:
#   DEVICE=cpu bash scripts/check_port.sh serve
# Modes:
#   check_port.sh             fast tier (default): collection guard, then
#                             the port's tests (tests/test_torch_*.py)
#   check_port.sh slow        the port's slow tests, the dry run's sweep of
#                             every arch x shape x mesh cell included
#   check_port.sh determinism the priced serve report and the analyzer's
#                             priced plans, each bit-identical across two
#                             processes with different hash salts
#   check_port.sh docs        markdown links + the Table-2 loop's smoke row
#   check_port.sh serve       serving parity gate: calibrate the serve step
#                             on --ranks logical ranks (slot-sharded), then
#                             the engine against the twin on the committed
#                             acceptance trace (exact compositions; priced
#                             latency within tolerance)
#   check_port.sh obs         telemetry smoke: a dp x pp train step and the
#                             acceptance trace with --obs; fails on any
#                             O001/O002 or gap attribution below 95 %
#   check_port.sh netprof     interconnect calibration over --ranks logical
#                             ranks (with the concurrent sweep), then
#                             --verify
#   check_port.sh analyze     the static plan verifier over every config and
#                             the serve acceptance trace
#   check_port.sh cuda        the card tests (-m cuda); needs an NVIDIA card
#   check_port.sh bench       the benchmark gate: the 54 metrics of
#                             benchmarks/baselines/bench_baseline.json
#                             recomputed through the port
#                             (scripts/bench_gate_port.py; --smoke skips the
#                             two executor rows, --out PATH moves the report)
# Options: --ranks N (default 8) stands for check.sh's
# --force-host-devices N: the port's collectives run over N logical ranks.
# Other options go to the bench gate.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
DEVICE="${DEVICE:-cuda}"
MODE=""
RANKS=8
EXTRA=()
while [[ $# -gt 0 ]]; do
    case "$1" in
        --ranks) RANKS="$2"; shift 2 ;;
        --ranks=*) RANKS="${1#*=}"; shift ;;
        -*) EXTRA+=("$1"); shift ;;
        *) if [[ -z "$MODE" ]]; then MODE="$1"; else EXTRA+=("$1"); fi
           shift ;;
    esac
done
MODE="${MODE:-fast}"
if [[ ${#EXTRA[@]} -gt 0 && "$MODE" != bench ]]; then
    echo "[check_port] $MODE: unknown arguments: ${EXTRA[*]}" >&2
    exit 2
fi

python - <<EOF
import platform, torch
print(f"[check_port] python {platform.python_version()} | torch "
      f"{torch.__version__} | cuda {torch.version.cuda} | device $DEVICE "
      f"| ranks $RANKS", flush=True)
EOF

PORT_TESTS=(tests/test_torch_*.py)

# the launcher modes: refuse a cuda run without a card rather than report a
# gate that never touched it
need_device() {
    if [[ "$DEVICE" == cuda* ]] && ! python -c \
            "import sys, torch; sys.exit(not torch.cuda.is_available())"; then
        echo "[check_port] $MODE: DEVICE=$DEVICE but no CUDA card is" \
             "visible; run 'DEVICE=cpu bash scripts/check_port.sh $MODE'" \
             "to run it on the CPU" >&2
        exit 1
    fi
}

case "$MODE" in
fast)
    # fail fast on import-error walls before running anything
    python -m pytest --collect-only -q "${PORT_TESTS[@]}" >/dev/null
    exec python -m pytest -x -q -m "not slow" "${PORT_TESTS[@]}"
    ;;
slow)
    exec python -m pytest -q -m slow "${PORT_TESTS[@]}"
    ;;
determinism)
    need_device
    # the same priced serve report and the same priced plans from two
    # processes with different hash salts
    TMP="$(mktemp -d)"
    trap 'rm -rf "$TMP"' EXIT
    for salt in 0 424242; do
        PYTHONHASHSEED=$salt python -m repro_torch.launch.serve --smoke \
            --device "$DEVICE" --trace poisson --requests 6 --max-len 64 \
            --chunk 8 --block-size 8 --simulate --synthetic-db \
            --report "$TMP/serve_$salt.json" >/dev/null
        PYTHONHASHSEED=$salt python -m repro_torch.analysis --seq 64 \
            --json "$TMP/analyze_$salt.json" >/dev/null
    done
    cmp "$TMP/serve_0.json" "$TMP/serve_424242.json"
    cmp "$TMP/analyze_0.json" "$TMP/analyze_424242.json"
    echo "[check_port] determinism: serve report and priced plans identical"
    ;;
docs)
    need_device
    python scripts/check_docs.py
    exec python -m repro_torch.launch.sim_accuracy --smoke --device "$DEVICE"
    ;;
serve)
    need_device
    DB="${SERVE_DB:-serve_db.json}"
    SERVE_ARGS=(--arch llama3.2-1b --smoke --device "$DEVICE" --slots 8
                --max-len 64 --block-size 8 --chunk 8 --ranks "$RANKS"
                --shard)
    python -m repro_torch.launch.serve "${SERVE_ARGS[@]}" --calibrate \
        --db "$DB"
    exec python -m repro_torch.launch.serve "${SERVE_ARGS[@]}" \
        --trace-file benchmarks/traces/serve_acceptance.json \
        --parity --db "$DB" --tol-rel 0.6 --report SERVE_parity.json
    ;;
obs)
    need_device
    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \
        --device "$DEVICE" --steps 2 --seq 64 --batch 8 --ranks "$RANKS" \
        --pp 2 --microbatches 2 --obs --trace-out OBS_train.json
    DB="${SERVE_DB:-serve_db.json}"
    SERVE_ARGS=(--arch llama3.2-1b --smoke --device "$DEVICE" --slots 8
                --max-len 64 --block-size 8 --chunk 8 --ranks "$RANKS"
                --shard)
    python -m repro_torch.launch.serve "${SERVE_ARGS[@]}" --calibrate \
        --db "$DB"
    python -m repro_torch.launch.serve "${SERVE_ARGS[@]}" \
        --trace-file benchmarks/traces/serve_acceptance.json \
        --obs --db "$DB" --trace-out OBS_serve.json
    exec python - <<'EOF'
import json, sys
bad = 0
for path in ("OBS_train_report.json", "OBS_serve_report.json"):
    rep = json.load(open(path))
    hits = [f for f in rep["findings"] if f["code"] in ("O001", "O002")]
    frac = rep["metrics"].get("obs_gap_attributed_frac", 0.0)
    print(f"[obs-gate] {path}: {len(hits)} O001/O002 findings, "
          f"gap attribution {frac * 100:.1f}%")
    for f in hits:
        print(f"[obs-gate]   {f['code']}: {f['message']}")
    bad += len(hits)
    if frac < 0.95:
        print("[obs-gate]   FAIL: gap attribution below 95%")
        bad += 1
sys.exit(1 if bad else 0)
EOF
    ;;
netprof)
    need_device
    DB="${NETPROF_DB:-netprof_db.json}"
    python -m repro_torch.netprof.calibrate --db "$DB" --device "$DEVICE" \
        --ranks "$RANKS" --smoke --concurrent
    exec python -m repro_torch.netprof.calibrate --db "$DB" --verify
    ;;
analyze)
    exec python -m repro_torch.analysis --json ANALYZE_report.json \
        --serve-trace benchmarks/traces/serve_acceptance.json \
        --serve-json ANALYZE_serve.json
    ;;
cuda)
    # the shared tests/conftest.py imports JAX, which the card's tests do
    # not need
    exec python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py \
        tests/test_torch_dryrun.py
    ;;
bench)
    need_device
    exec python scripts/bench_gate_port.py --device "$DEVICE" \
        ${EXTRA[@]+"${EXTRA[@]}"}
    ;;
*)
    echo "[check_port] unknown mode '$MODE'" >&2
    exit 2
    ;;
esac
