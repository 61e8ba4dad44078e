"""The paper's experimental setup at reproduction scale, on the port: the
examples' own copy of ``benchmarks/common.py``'s ``build_setup`` and
``run_experiment`` (that module imports JAX; this one imports
``repro_torch`` only).

Model: the paper's MNIST MLP (784 -> 10 -> 784 -> 10, tanh;
:mod:`repro_torch.models.mlp`). Data: synthetic teacher-MLP
classification with Dirichlet non-IID node splits
(:class:`repro_torch.data.SyntheticClassification`,
:func:`repro_torch.data.dirichlet_partition`): nothing is downloaded.
Network: N = 10 nodes, seed 2024, as the paper's SV.A. Where the reference
keys a draw by ``PRNGKey(k)`` this copy seeds a generator by ``k``. The
sessions take the kernels on the card and their plain versions on the
CPU (the reference's forces its plain path).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import (PrivacySpec, RealSensitivityHook, Session,
                             make_topology)
from repro_torch.core.partpsp import consensus_params
from repro_torch.data import SyntheticClassification, dirichlet_partition
from repro_torch.data.pipeline import seeded_generator
from repro_torch.models.mlp import (D_IN, N_CLASSES, PARTITIONS, init_mlp,
                                    mlp_logits, mlp_loss)

N_NODES = 10
SEED = 2024


@dataclasses.dataclass
class RunResult:
    name: str
    accuracy: float
    ras: float                    # real average sensitivity (paper SV.C)
    est_sens_mean: float
    violations: int               # rounds where real > estimated
    wall_s: float                 # steady-state seconds, all steps
    steps: int
    loss: float
    eps_total: float = float("inf")  # composed epsilon spent by the run
    compile_s: float = 0.0           # the first segment's seconds


def build_setup(*, algorithm: str = "partpsp",
                partition_name: str = "partpsp-1", topology: str = "2-out",
                b: float = 1.0, gamma_n: float = 0.005, gamma_l: float = 0.1,
                gamma_s: float = 0.1, clip: float = 100.0, batch: int = 32,
                sync_interval: int = 5, sensitivity_mode: str = "estimated",
                schedule: str = "dense", chunk: int = 50,
                n_nodes: int | None = None, seed: int = SEED,
                c_prime: float | None = None, lam: float | None = None,
                faults=None, device=None):
    """``(session, task, batch_at)`` for the paper's MLP setup."""
    n_nodes = N_NODES if n_nodes is None else n_nodes
    topo = make_topology(topology, n_nodes, seed=SEED)
    if algorithm in ("sgp", "sgpdp", "pedfl"):
        partition_name = "full"
    session = Session.build(
        topo, privacy=PrivacySpec(b=b, gamma_n=gamma_n, c_prime=c_prime,
                                  lam=lam, sensitivity_mode=sensitivity_mode),
        model=mlp_loss, partition=PARTITIONS[partition_name],
        params=init_mlp(torch.Generator().manual_seed(seed)),
        algorithm=algorithm, gamma_l=gamma_l, gamma_s=gamma_s, clip=clip,
        schedule=schedule, sync_interval=sync_interval, chunk=chunk,
        faults=faults, seed=seed, device=device)
    dev = session.device
    task = SyntheticClassification(d_in=D_IN, n_classes=N_CLASSES, seed=seed,
                                   device=dev)
    skew = dirichlet_partition(n_nodes, N_CLASSES, alpha=0.5, seed=seed)

    def batch_at(t):
        return task.node_batches(seeded_generator(dev, seed + 1, t), n_nodes,
                                 batch, skew)

    return session, task, batch_at


def run_experiment(*, algorithm: str = "partpsp",
                   partition_name: str = "partpsp-1", topology: str = "2-out",
                   b: float = 1.0, gamma_n: float = 0.005,
                   gamma_l: float = 0.1, gamma_s: float = 0.1,
                   clip: float = 100.0, steps: int = 300, batch: int = 32,
                   sync_interval: int = 5,
                   sensitivity_mode: str = "estimated",
                   schedule: str = "dense", track_real: bool = False,
                   driver: str = "engine", chunk: int = 50,
                   n_nodes: int | None = None, seed: int = SEED,
                   name: str | None = None, c_prime: float | None = None,
                   lam: float | None = None, faults=None,
                   device=None) -> RunResult:
    """Train the setup ``steps`` rounds and evaluate the consensus view of
    every node on 2,000 held-out samples (paper SV.D)."""
    n_nodes = N_NODES if n_nodes is None else n_nodes
    session, task, batch_at = build_setup(
        algorithm=algorithm, partition_name=partition_name, topology=topology,
        b=b, gamma_n=gamma_n, gamma_l=gamma_l, gamma_s=gamma_s, clip=clip,
        batch=batch, sync_interval=sync_interval,
        sensitivity_mode=sensitivity_mode, schedule=schedule, chunk=chunk,
        n_nodes=n_nodes, seed=seed, c_prime=c_prime, lam=lam, faults=faults,
        device=device)
    real_hook = RealSensitivityHook() if track_real else None
    report = session.train(steps, batch_at,
                           hooks=[real_hook] if real_hook else [],
                           driver=driver)
    ests = np.asarray(report.trajectory["sensitivity_estimate"])
    reals = (np.asarray(report.trajectory["sensitivity_real"])
             if track_real else None)

    cp = consensus_params(report.state, session.partition)
    x_test, y_test = task.sample(seeded_generator(session.device, seed + 99),
                                 2000)
    accs = []
    with torch.no_grad():
        for i in range(n_nodes):
            pred = mlp_logits({k: v[i] for k, v in cp.items()},
                              x_test).argmax(dim=1)
            accs.append(float((pred == y_test).float().mean()))
    loss = float(np.asarray(report.trajectory["loss_mean"])[-1])
    return RunResult(
        name=name or f"{algorithm}/{partition_name}/{topology}/b={b}",
        accuracy=float(np.mean(accs)),
        ras=float(np.mean(reals)) if reals is not None
        else float(np.mean(ests)),
        est_sens_mean=float(np.mean(ests)) if ests.size else 0.0,
        violations=real_hook.violations if real_hook else 0,
        wall_s=_steady_wall(report, steps, chunk, driver), steps=steps,
        loss=loss, eps_total=report.epsilon_spent,
        compile_s=report.compile_s)


def _steady_wall(report, steps: int, chunk: int, driver: str) -> float:
    """Steady-state wall seconds scaled to all ``steps`` rounds:
    ``report.run_s`` leaves out the first segment; a run of one segment
    gives its whole wall clock."""
    first_n = 1 if driver == "loop" else min(chunk, steps)
    steady = steps - first_n
    if steady <= 0 or report.run_s <= 0:
        return report.wall_clock
    return report.run_s * steps / steady
