"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix by the names in
``BENCHMARK.json``, builds and warms up the program (``repro_torch``) on
the card, measures for ``--seconds``, checks what the window's path
produced against the plain reference in ``portbench/reference``, and
prints one JSON line last: the cell's end-to-end metrics (``--trace 0``)
or its per-layer metrics from a ``torch.profiler`` trace of the window
(``--trace 1``). The compared numbers and their limits come last, on
standard error and under ``checks``. ``--control`` instead prints the
control's readings (the reference in the next lower precision put in the
program's place), for setting the limits; ``--fault NAME[,NAME...]``
(or ``all``) runs the cell once with each fault of
``harness/faults.py`` planted in the program in turn, and prints each
run's readings. The benchmark's runs take neither.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), where the program cannot be imported, or where
JAX, its libraries or the JAX package were loaded in this process.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import runtime  # noqa: E402

T_SCRIPT = time.time()


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default="")
    return ap.parse_args(argv)


def per_layer(cell, records: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(records)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(torch, cell, *, seed: int, seconds: float, trace: bool,
             device, t0: float) -> tuple[dict, list]:
    """Drive the cell once -> (result without ``checks``, checks)."""
    ctx = runtime.Context(torch=torch, cell=cell, seed=seed, seconds=seconds,
                          trace=trace, device=device)
    outcome = cell.driver().run(ctx)
    setup_s = outcome.window_wall_start - t0
    peak = (torch.cuda.max_memory_allocated(device) if ctx.on_card else 0)
    outcome.records["peak_bytes"] = peak
    metrics = {}
    if trace:
        metrics = per_layer(cell, outcome.records)
    else:
        for m in cell.end_to_end:
            value = (setup_s if m["name"] == "setup_s"
                     else outcome.end_to_end[m["name"]])
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    outcome.release()
    if ctx.on_card:
        torch.cuda.empty_cache()
    checks = outcome.judge()
    from portbench.harness.compare import verdict
    dev = {"platform": "gpu", "kind": (torch.cuda.get_device_name(device)
                                        if ctx.on_card else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and "busy_s" in outcome.records:
        dev["busy_s"] = outcome.records["busy_s"]
        dev["window_s"] = outcome.records["window_s"]
    result = {"correct": verdict(checks), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": dev}
    if trace and "device_ops" in outcome.records:
        result["breakdown"] = {"device_ops": outcome.records["device_ops"],
                               "idle_gaps": outcome.records["idle_gaps"]}
        if not outcome.records.get("complete"):
            print(f"trace: the profiler recorded "
                  f"{outcome.records['port_events']} of the window's "
                  f"{sum(outcome.records['launches'].values())} kernel "
                  "launches; no share is read from it", file=sys.stderr)
    return result, checks


def run_faults(torch, cell, args, seed: int, device) -> int:
    """The cell once with each named fault planted: one line of readings
    each (the reference runs once a seed where the driver keeps it)."""
    import gc
    import json

    from portbench.harness import faults
    names = (faults.names(cell.name) if args.fault == "all"
             else args.fault.split(","))
    for name in names:
        undo = faults.plant(name, cell.name)
        try:
            result, checks = run_cell(torch, cell, seed=seed,
                                      seconds=args.seconds, trace=False,
                                      device=device, t0=time.time())
        finally:
            undo()
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"fault": name, "seed": args.seed,
                          "correct": result["correct"],
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in checks}}), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    t0 = runtime.process_start() or T_SCRIPT
    runtime.cache_environment()
    try:
        bench = runtime.benchmark()
        cell = runtime.Cell(bench, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    runtime.allocator_environment(cell)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 4
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    seed = args.seed % (1 << 63)
    if args.control:
        ctx = runtime.Context(torch=torch, cell=cell, seed=seed,
                              seconds=args.seconds, trace=False,
                              device=device)
        checks = cell.driver().control(ctx)
        bad = runtime.forbidden_modules()
        if bad:
            print(f"portbench: forbidden modules loaded: {bad}",
                  file=sys.stderr)
            return 5
        runtime.print_result({"control": True, "seed": args.seed}, checks)
        return 0
    if args.fault:
        return run_faults(torch, cell, args, seed, device)
    result, checks = run_cell(torch, cell, seed=seed, seconds=args.seconds,
                              trace=bool(args.trace), device=device, t0=t0)
    bad = runtime.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 5
    runtime.print_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
