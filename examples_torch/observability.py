"""Observability on the port: watch a private consensus run without
touching it (the counterpart of ``examples/observability.py``).

One DPPS consensus session runs under the full telemetry pipeline: the
privacy ledger, the budget, round metrics, realized-network stats and the
health watchdog, every producer publishing to one
:class:`repro_torch.obs.MetricsBus`. The bus streams to a JSONL event log
and snapshots to Prometheus text; a second pass profiles one segment into
a per-phase device-time breakdown (``torch.profiler``: the card's kernels
by phase there, the ops' CPU time on the CPU).

``--timeline trace.json`` also records the run's timeline (host segment
spans, the async message lifecycle: the run then gossips through a
bounded-delay network so send->deliver and send->timeout events exist,
and the profile's device phase slices) as Chrome-trace-event JSON: open
it in https://ui.perfetto.dev or chrome://tracing.

    PYTHONPATH=src python examples_torch/observability.py
    PYTHONPATH=src python examples_torch/observability.py --device cpu \\
        --timeline trace.json
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.api import (BudgetHook, LedgerHook, MetricsHook,
                             PrivacySpec, Session)
from repro_torch.core.topology import DOutGraph
from repro_torch.net import DelayModel, NetworkStatsHook
from repro_torch.obs import (JsonlExporter, MetricsBus, TimelineHook,
                             WatchdogHook, prometheus_text)

N = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--events", default="obs_events.jsonl",
                    help="JSONL event-stream output path")
    ap.add_argument("--timeline", default=None, metavar="TRACE_JSON",
                    help="write a Perfetto-loadable Chrome trace of the run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    topo = DOutGraph(n_nodes=N, d=2)
    # the timeline run gossips through a bounded-delay network so the
    # protocol track has a message lifecycle to show; async mass in flight
    # forbids sync rounds
    delays = (DelayModel(max_delay=2, timeout_rate=0.1, seed=7)
              if args.timeline else None)
    session = Session.build(topo, privacy=PrivacySpec(b=5.0, gamma_n=1e-3),
                            chunk=max(args.rounds // 4, 1), delays=delays,
                            sync_interval=0 if delays else None,
                            device=args.device, seed=1)
    private = [torch.randn((N, 32), generator=torch.Generator().manual_seed(0))
               .to(session.device)]

    # one bus, many producers: the ledger counts privacy spend, the metrics
    # hook gauges rows, the network hook counts realized edges, and the
    # watchdog judges the wire stats at every segment boundary
    bus = MetricsBus()
    hooks = [
        LedgerHook(bus=bus),
        BudgetHook(budget=1e9),
        MetricsHook(fields={"sensitivity": "sensitivity_estimate"},
                    log_every=50, bus=bus),
        NetworkStatsHook(bus=bus),
        WatchdogHook(bus=bus),
    ]
    timeline_hook = None
    if args.timeline:
        timeline_hook = TimelineHook(bus=bus)
        hooks.append(timeline_hook)

    with JsonlExporter(args.events).attach(bus) as exporter:
        report = session.run(args.rounds, values=private, hooks=hooks)

    print(f"\n{report.rounds} rounds | epsilon spent "
          f"{report.epsilon_spent:.2e} | compile {report.compile_s:.2f}s + "
          f"run {report.run_s:.3f}s")
    print(f"event stream: {exporter.written} events -> {args.events}")
    stats = report.network
    print(f"realized edges/round: {stats.realized_edges.mean():.1f} | "
          f"B-window connectivity: {stats.connected_windows}/{stats.windows}")
    alerts = bus.events("alert")
    print(f"watchdog: {len(alerts)} alerts on a healthy run")

    prom = prometheus_text(bus)
    print("\n--- Prometheus exposition (aggregate snapshot) ---")
    print(prom)

    # second pass: profile one segment; the phase table attributes device
    # time to the named protocol phases
    profile = session.profile(rounds=50, values=private)
    print("--- profile ---")
    print(json.dumps(profile.summary(), indent=2))

    trace = None
    if timeline_hook is not None:
        # one artifact: the run's host/protocol tracks plus the profile's
        # device phase slices, laid out after it
        timeline_hook.timeline.add_profile(profile)
        trace = timeline_hook.timeline.save(args.timeline)
        print(f"\ntimeline: {len(timeline_hook.timeline)} events -> {trace} "
              "(open in https://ui.perfetto.dev)")
    return dict(session=session, report=report, events=exporter.written,
                alerts=alerts, prometheus=prom, profile=profile, trace=trace)


if __name__ == "__main__":
    main()
