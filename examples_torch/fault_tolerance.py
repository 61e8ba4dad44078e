"""Fault tolerance on the port: private consensus on a lossy random
network (the counterpart of ``examples/fault_tolerance.py``).

Sixteen nodes on a seeded Erdos-Renyi graph reach DP consensus while 20%
of links drop every round (independent Bernoulli masks, drawn from the
session's seed) and one node churns out for a stretch of rounds. The
realized weight matrix is column-renormalised so every sender's mass still
sums to 1, and the a-weight correction (Eq. 10) absorbs the lost symmetry:
mass is conserved at any drop rate. The run takes the "dynamic" dense
schedule (on the card: ``pushsum_mix.cu`` over each round's realized W).

The ``NetworkStatsHook`` checks Assumption-1 window connectivity on the
realized graphs, not the nominal topology.

    PYTHONPATH=src python examples_torch/fault_tolerance.py
    PYTHONPATH=src python examples_torch/fault_tolerance.py --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import PrivacySpec, Session
from repro_torch.net import ErdosRenyiGraph, FaultModel, NetworkStatsHook

N = 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--drop-rate", type=float, default=0.2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    down = (args.rounds // 4, args.rounds // 2)

    topo = ErdosRenyiGraph(n_nodes=N, p=0.3, seed=7)
    faults = FaultModel(drop_rate=args.drop_rate, churn=((3,) + down,))
    session = Session.build(topo, privacy=PrivacySpec(b=5.0, gamma_n=1e-3),
                            faults=faults, device=args.device)
    print(f"graph: er(p=0.3) over {N} nodes | schedule={session.plan.schedule}"
          f" | drop_rate={args.drop_rate} | node 3 down rounds "
          f"[{down[0]}, {down[1]})")

    private = [torch.randn((N, 8), generator=torch.Generator().manual_seed(0))
               .to(session.device)]
    true_mean = private[0].mean(dim=0)

    hook = NetworkStatsHook()
    report = session.run(args.rounds, values=private, hooks=[hook])

    a = report.state.push.a.cpu().numpy()
    print(f"push-sum mass: mean(a) = {a.mean():.6f} (conserved), "
          f"spread [{a.min():.3f}, {a.max():.3f}] (absorbed by Eq. 10)")

    net = report.network
    print(f"network: {net.summary()['realized_edges_mean']:.1f} realized "
          f"edges/round (dropped {int(net.dropped_edges.sum())} total, "
          f"{net.drop_fraction:.0%}), realized-window connectivity "
          f"{net.connected_windows}/{net.windows}")
    deg = np.asarray(report.trajectory["net_out_degree"])
    isolated = int(deg[down[0]:down[1], 3].max()) if down[1] > down[0] else 0
    print(f"realized out-degree during churn: node 3 -> {isolated} "
          "(isolated)")

    consensus = session.consensus(report.state)[0]
    err = float((consensus - true_mean[None]).abs().max())
    print(f"\nconsensus error vs true mean: {err:.4f} — consensus reached "
          f"through {args.drop_rate:.0%} link loss + churn")
    if abs(a.mean() - 1.0) >= 1e-5:
        raise SystemExit("mass conservation violated")
    if isolated != 0:
        raise SystemExit("node 3 sent while churned out")
    print(f"report: {report.rounds} rounds, epsilon spent = "
          f"{report.epsilon_spent:.0f}, effective wire bytes = "
          f"{net.effective_bytes:,} (nominal {net.nominal_bytes:,})")
    return dict(session=session, report=report, mass=float(a.mean()),
                out_degree=deg, error=err)


if __name__ == "__main__":
    main()
