"""Quickstart on the port: DPPS as a plug-and-play private consensus
primitive (the counterpart of ``examples/quickstart.py``).

Ten nodes each hold a private vector; they reach consensus on the average
through the DPPS protocol without any node revealing its exact vector
(each round is b/gamma_n-differentially private, paper Theorem 1).

``Session.build`` calibrates the sensitivity constants to the graph and
derives the plan (circulant gossip for a d-Out graph, the packed wire
buffer, ``--device``'s kernels: on the CUDA card ``l1_norm.cu`` and the
fused ``dpps_perturb.cu`` every round); ``session.run`` returns a typed
report. The exact sensitivity rides along as a hook.

    PYTHONPATH=src python examples_torch/quickstart.py            # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

``--gamma-n`` (the port's addition; default the reference's fixed 1e-3)
sets the noise rate: 0 runs the noiseless consensus.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.api import PrivacySpec, RealSensitivityHook, Session
from repro_torch.core.topology import DOutGraph

N = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--gamma-n", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    topo = DOutGraph(n_nodes=N, d=2)
    # gamma_n sits inside the sensitivity-feedback stability region
    # (gamma_n < (1/lam - 1) * b / (2 C' d_s); see EXPERIMENTS.md SClaims)
    session = Session.build(topo, privacy=PrivacySpec(b=5.0,
                                                      gamma_n=args.gamma_n),
                            device=args.device)
    cfg, plan = session.cfg, session.plan
    print(f"graph: 2-out over {N} nodes | C'={cfg.c_prime:.2f} "
          f"lambda={cfg.lam:.2f} | epsilon per round = b/gamma_n = "
          f"{cfg.epsilon_per_round:.0f} | schedule={plan.schedule} "
          f"(segments of {plan.chunk})")

    # each node's private value, from a seeded generator
    private = [torch.randn((N, 8), generator=torch.Generator().manual_seed(0))
               .to(session.device)]
    true_mean = private[0].mean(dim=0)

    real = RealSensitivityHook()
    report = session.run(args.rounds, values=private, hooks=[real])
    traj = report.trajectory
    for t in range(0, args.rounds, max(args.rounds // 4, 1)):
        print(f"round {t:3d}: estimated sensitivity "
              f"{float(traj['sensitivity_estimate'][t]):8.3f} "
              f">= real {float(traj['sensitivity_real'][t]):8.3f}")
    if real.violations:
        raise SystemExit("Remark 1 violated: estimate fell below real")

    consensus = session.consensus(report.state)[0]
    err = float((consensus - true_mean[None]).abs().max())
    print(f"\nconsensus error vs true mean: {err:.4f} "
          f"(noise floor ~ gamma_n * S / b; privacy was preserved every round)")
    print(f"report: {report.rounds} rounds, epsilon spent = "
          f"{report.epsilon_spent:.0f}, ~{report.wire_bytes:,} wire bytes, "
          f"{report.wall_clock:.2f}s")
    return dict(session=session, report=report, private=private,
                consensus=consensus, error=err)


if __name__ == "__main__":
    main()
