"""The privacy-utility trade-off on the port (paper Table II in
miniature; the counterpart of ``examples/privacy_sweep.py``): the final
accuracy of PartPSP-1 against full-communication SGPDP across privacy
budgets, with the guarantee measured as well as asserted.

Two epsilon figures a row:

* ``eps_total``: the composed theoretical epsilon the training run spent
  at its own gamma_n, read off its ``RunReport``;
* ``eps/rd emp``: the attack battery's Clopper-Pearson lower bound for one
  protocol round audited at the normalised per-round claim ``epsilon = b``
  (gamma_n = 1; the distinguishing statistic depends only on b /
  gamma_n). A healthy implementation keeps it <= b in every row; the audit
  column flags the row otherwise.

The training runs go through ``examples_torch/paper_setup.py`` (the
port's copy of the benchmarks' ``run_experiment``) and the session front
door.

    PYTHONPATH=src python examples_torch/privacy_sweep.py [--smoke]
    PYTHONPATH=src python examples_torch/privacy_sweep.py --device cpu --smoke
"""
from __future__ import annotations

import argparse

from paper_setup import run_experiment

from repro_torch.audit import (LOCAL_EAVESDROPPER, AuditConfig,
                               distinguishing_attack)

SYNC_INTERVAL = 5
GAMMA_N = 1e-4


def audited_epsilon(b: float, trials: int,
                    device=None) -> tuple[float, float, bool]:
    """(theoretical per-round eps, empirical lower bound, flagged) at b."""
    r = distinguishing_attack(
        LOCAL_EAVESDROPPER,
        audit=AuditConfig(b=b, gamma_n=1.0, trials=trials, seed=int(b * 10),
                          device=device))
    return r.theoretical_epsilon, r.empirical.epsilon_lower, r.flagged


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced scale (fewer steps, trials and budgets)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    steps = 40 if args.smoke else 200
    trials = 400 if args.smoke else 1000
    budgets = (1.0,) if args.smoke else (1.0, 3.0, 5.0)

    rows = []
    print(f"{'algorithm':12s} {'b':>5s} {'accuracy':>9s} {'RAS':>9s} "
          f"{'eps_total':>11s} {'eps/rd claim':>12s} {'eps/rd emp>=':>12s} "
          f"{'audit':>7s}")
    for b in budgets:
        eps_th, eps_emp, flagged = audited_epsilon(b, trials, args.device)
        for alg, part in (("partpsp", "partpsp-1"), ("sgpdp", "full")):
            r = run_experiment(algorithm=alg, partition_name=part,
                               topology="4-out", b=b, gamma_n=GAMMA_N,
                               sensitivity_mode="real", steps=steps,
                               sync_interval=SYNC_INTERVAL,
                               schedule="circulant", name=f"{alg}/b={b}",
                               device=args.device)
            print(f"{alg:12s} {b:5.1f} {r.accuracy:9.4f} {r.ras:9.2f} "
                  f"{r.eps_total:11.1f} {eps_th:12.3f} {eps_emp:12.3f} "
                  f"{'FLAG' if flagged else 'ok':>7s}")
            rows.append(dict(algorithm=alg, b=b, result=r, eps_claim=eps_th,
                             eps_emp=eps_emp, flagged=flagged))
    r = run_experiment(algorithm="sgp", topology="4-out", b=1.0, gamma_n=0.0,
                       steps=steps, schedule="circulant", name="sgp/nodp",
                       device=args.device)
    print(f"{'sgp (NoDP)':12s} {'-':>5s} {r.accuracy:9.4f} {'-':>9s} "
          f"{'inf':>11s} {'-':>12s} {'-':>12s} {'-':>7s}")
    rows.append(dict(algorithm="sgp", b=None, result=r))
    print("\nAt tight budgets (b=1) PartPSP-1's smaller d_s buys more")
    print("accuracy than full communication (Theorem 2); as b grows and")
    print("noise fades, full communication's statistical advantage returns:")
    print("the paper's Table II trade-off, end to end. 'eps/rd emp' is the")
    print("attack battery's one-round lower bound and must stay below the")
    print("'eps/rd claim' column (= b), else the audit column flags the")
    print("row; 'eps_total' is the training run's composed spend.")
    return rows


if __name__ == "__main__":
    main()
