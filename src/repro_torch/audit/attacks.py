"""Empirical privacy attacks against the DPPS/PartPSP implementation (port
of ``repro.audit.attacks``).

Where ``core.privacy`` states epsilon analytically, this module measures
it: every attack runs the real protocol (``engine.run_dpps`` with a
transcript tap, through the CUDA kernels on the card), takes the threat
model's view and turns attack success into a confidence-valid empirical
epsilon lower bound by Clopper-Pearson intervals (Jagielski et al.). A
correct implementation keeps every bound below the ledger's theoretical
epsilon; a broken one (noise scale halved) pushes a bound above it.

* :func:`distinguishing_attack`: the Def. 2-4 neighbourhood game, two
  adjacent perturbations whose L1 distance equals the broadcast
  sensitivity, a Laplace log-likelihood-ratio test on the victim's wire,
  and a network-sum test for the global observer.
* :func:`reconstruction_attack`: input reconstruction by averaging the
  noise over repeated observations, and the global observer's sum.
* :func:`membership_inference`: a score-threshold membership test on
  per-example losses, with the same Clopper-Pearson machinery.

Trials. The reference ``vmap``s its trials over ``split(PRNGKey(seed 2 +
world), trials)``. Here trial i of world w is its own ``run_dpps`` call
whose session seed is ``((seed 2 + w) << 32) | i``: its Philox noise key is
(i, seed 2 + w), a stream of (audit seed, world, trial). Trials run one
after another (stacking them as nodes would couple them through the
Remark-1 max). The recorded trials of a (config, mechanism, world) are
cached and shared by every threat model, as the reference's are. The draws
differ from the reference's, so the empirical epsilons do; the scoring of
given transcripts is the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
from scipy import stats as _sstats

from repro_torch.audit.ledger import PrivacyLedger
from repro_torch.audit.mechanisms import LaplaceMechanism, NoiseMechanism
from repro_torch.audit.threat import ThreatModel
from repro_torch.core.dpps import DPPSConfig, dpps_init
from repro_torch.core.topology import DOutGraph
from repro_torch.device import resolve_device
from repro_torch.engine.plan import ProtocolPlan
from repro_torch.engine.rounds import run_dpps

__all__ = [
    "AuditConfig",
    "EpsilonEstimate",
    "DistinguishingResult",
    "clopper_pearson",
    "empirical_epsilon_lower_bound",
    "distinguishing_attack",
    "reconstruction_attack",
    "membership_inference",
    "example_scores",
    "tapped_trials",
    "trial_seed",
]


# -- Clopper-Pearson ---------------------------------------------------------

def clopper_pearson(k: int, n: int, alpha: float) -> tuple[float, float]:
    """Exact two-sided (1 - alpha) binomial confidence interval for k/n."""
    if not 0 <= k <= n or n <= 0:
        raise ValueError(f"need 0 <= k <= n, got k={k} n={n}")
    lo = 0.0 if k == 0 else float(_sstats.beta.ppf(alpha / 2, k, n - k + 1))
    hi = 1.0 if k == n else float(_sstats.beta.ppf(1 - alpha / 2, k + 1, n - k))
    return lo, hi


class EpsilonEstimate(NamedTuple):
    """A confidence-valid empirical epsilon lower bound: with probability
    >= 1 - alpha (jointly over every threshold tested, Bonferroni), the
    true epsilon is at least ``epsilon_lower``."""

    epsilon_lower: float
    alpha: float
    trials: int
    best_threshold: float
    tpr: float          # empirical P(attack accepts | world D)
    fpr: float          # empirical P(attack accepts | world D')


def empirical_epsilon_lower_bound(
    stats_d: np.ndarray,
    stats_dp: np.ndarray,
    *,
    alpha: float = 0.05,
    thresholds: Sequence[float] = (-0.5, 0.0, 0.5),
    n_families: int = 1,
) -> EpsilonEstimate:
    """Threshold-test epsilon lower bound from paired attack statistics.

    For each threshold tau the events {stat > tau} and {stat <= tau} give
    DP-constrained probability pairs; Clopper-Pearson bounds at ``alpha /
    (4 len(thresholds) n_families)`` each make the max over all tests
    jointly valid at level ``alpha``.
    """
    stats_d = np.asarray(stats_d, dtype=np.float64)
    stats_dp = np.asarray(stats_dp, dtype=np.float64)
    n = stats_d.shape[0]
    if stats_dp.shape[0] != n:
        raise ValueError("both worlds need the same number of trials")
    a_each = alpha / (4.0 * len(thresholds) * max(n_families, 1))

    best = EpsilonEstimate(0.0, alpha, n, float(thresholds[0]), 0.0, 0.0)
    for tau in thresholds:
        k1 = int(np.sum(stats_d > tau))
        k0 = int(np.sum(stats_dp > tau))
        p_lo, _ = clopper_pearson(k1, n, a_each)       # P_D(A) from below
        _, q_hi = clopper_pearson(k0, n, a_each)       # P_D'(A) from above
        pc_lo, _ = clopper_pearson(n - k0, n, a_each)  # P_D'(A^c) from below
        _, qc_hi = clopper_pearson(n - k1, n, a_each)  # P_D(A^c) from above
        for num, den in ((p_lo, q_hi), (pc_lo, qc_hi)):
            if num <= 0:
                continue
            eps = math.log(num / max(den, 1e-12))
            if eps > best.epsilon_lower:
                best = EpsilonEstimate(eps, alpha, n, float(tau),
                                       k1 / n, k0 / n)
    return best


# -- the distinguishing game (Def. 2-4) ---------------------------------------

@dataclasses.dataclass(frozen=True)
class AuditConfig:
    """A reduced protocol instance for the battery.

    The adjacent worlds perturb the victim by +/- c along one coordinate
    from s0 = 0 with C' = 1: the broadcast sensitivity is then exactly 2c =
    ||eps - eps'||_1, so the per-round claim ``b / gamma_n`` is audited
    with no slack. ``wire`` is the codec the transcript is recorded
    through (the tap sees the encoded wire). ``device`` (None: the card)
    is where the trials run; the CUDA kernels run there, except for the
    compress-first codec, which refuses them (its trials take the plain
    route on the same device).
    """

    n_nodes: int = 4
    dim: int = 16
    degree: int = 2
    b: float = 1.0
    gamma_n: float = 1.0
    c: float = 1.0          # half-separation of the adjacent perturbations
    trials: int = 1500
    rounds: int = 1
    victim: int = 0
    alpha: float = 0.05
    seed: int = 0
    wire: Any = None
    device: Any = None

    def topology(self) -> DOutGraph:
        return DOutGraph(n_nodes=self.n_nodes, d=self.degree)

    def dpps_config(self) -> DPPSConfig:
        # C' = 1, lam arbitrary (one audited round), no sync, dense W
        return DPPSConfig(b=self.b, gamma_n=self.gamma_n, c_prime=1.0,
                          lam=0.5, schedule="dense", sync_interval=0)

    def ledger(self, mechanism_name: str = "laplace") -> PrivacyLedger:
        return PrivacyLedger(b=self.b, gamma_n=self.gamma_n,
                             mechanism=mechanism_name)


_DEFAULT_MECH = LaplaceMechanism()


class DistinguishingResult(NamedTuple):
    threat: str
    mechanism: str
    theoretical_epsilon: float
    empirical: EpsilonEstimate
    flagged: bool                 # empirical lower bound exceeds the claim
    ledger: PrivacyLedger

    def row(self) -> str:
        return (f"{self.mechanism:18s} {self.threat:18s} "
                f"eps_theory={self.theoretical_epsilon:7.3f} "
                f"eps_emp>={self.empirical.epsilon_lower:6.3f} "
                f"{'FLAGGED' if self.flagged else 'ok'}")


def trial_seed(audit: AuditConfig, world: int, trial: int) -> int:
    """The session seed of trial ``trial`` of ``world``: Philox key
    (trial, seed 2 + world)."""
    return ((audit.seed * 2 + world) << 32) | trial


def _adjacent_eps(audit: AuditConfig, world: int, device) -> list:
    """The world's Def. 2-4 perturbation of each round: one (N, dim) leaf,
    +c (world 0) or -c (world 1) at the victim's coordinate 0 in round 0."""
    eps = torch.zeros((audit.rounds, audit.n_nodes, audit.dim),
                      dtype=torch.float32, device=device)
    eps[0, audit.victim, 0] = audit.c if world == 0 else -audit.c
    return [[eps[t]] for t in range(audit.rounds)]


def tapped_trials(audit: AuditConfig, mechanism: NoiseMechanism | None,
                  world: int, *, draws: Any = None) -> dict[str, np.ndarray]:
    """The world's ``audit.trials`` protocol runs with the tap on ->
    stacked trajectories on the host, (trials, rounds, ...) leaves.
    ``draws`` (tests only) is ``(bits_at, wire_draws_at, noise_draws_at)``
    of ``(trial, t)``, the reference's draws of a trial."""
    from repro_torch.api.hooks import TranscriptHook  # api imports audit
    from repro_torch.api.session import host_array

    dev = resolve_device(audit.device)
    codec = audit.wire
    plan = ProtocolPlan.from_topology(
        audit.topology(), schedule="dense", sync_interval=None, wire=codec,
        device=dev)
    cfg = audit.dpps_config()
    cfg_r = plan.resolve_dpps(cfg)
    eps = _adjacent_eps(audit, world, dev)
    zeros = [torch.zeros((audit.n_nodes, audit.dim), dtype=torch.float32,
                         device=dev)]
    hooks = (TranscriptHook(),)
    runs = []
    with torch.no_grad():
        for i in range(audit.trials):
            seams = {}
            if draws is not None:
                seams = {name: (None if fn is None else
                                functools.partial(fn, i))
                         for name, fn in zip(("bits_at", "wire_draws_at",
                                              "noise_draws_at"), draws)}
            _, traj = run_dpps(dpps_init(zeros, cfg_r),
                               lambda t: eps[t], cfg=cfg, plan=plan,
                               rounds=audit.rounds,
                               seed=trial_seed(audit, world, i), hooks=hooks,
                               mechanism=mechanism, **seams)
            runs.append(traj)
    return {k: host_array(torch.stack([r[k] for r in runs]))
            for k in runs[0]}


@functools.lru_cache(maxsize=64)
def _tapped_trials_cached(audit: AuditConfig,
                          mechanism: NoiseMechanism | None, world: int):
    """One world's recorded trials, shared by every threat model (views of
    the same recordings), as the reference caches them."""
    return tapped_trials(audit, mechanism, world)


def score_distinguishing(threat: ThreatModel, traj_d: dict, traj_dp: dict,
                         *, mechanism: NoiseMechanism | None,
                         audit: AuditConfig) -> DistinguishingResult:
    """The reference's scoring of two worlds' recorded trials (leaves
    (trials, rounds, ...)) under ``threat``: the victim-wire statistic (and
    the network sum for the global observer), the Clopper-Pearson bound,
    the per-round claim and the ledger."""
    visible = threat.visible_nodes(victim=audit.victim,
                                   n_nodes=audit.n_nodes,
                                   topo=audit.topology())
    if audit.victim not in visible:
        raise ValueError(f"threat {threat.name} cannot see the victim's wire")

    # Victim-wire Laplace LLR: coordinates other than 0 cancel exactly, so
    # the statistic is the distance margin along the perturbed coordinate,
    # normalised to [-1, 1].
    def victim_stat(traj):
        m = np.asarray(traj["tap_messages"][:, 0, audit.victim, :])
        mu = np.zeros((audit.dim,)); mu[0] = audit.c
        d_up = np.abs(m - mu[None]).sum(axis=1)
        d_down = np.abs(m + mu[None]).sum(axis=1)
        return (d_down - d_up) / (2.0 * audit.c)

    families = [(victim_stat(traj_d), victim_stat(traj_dp))]
    if threat.kind == "global":
        # zero-sum correlated noise cancels under the observer's sum
        def sum_stat(traj):
            m = np.asarray(traj["tap_messages"][:, 0, :, 0])
            return m.sum(axis=1) / audit.c
        families.append((sum_stat(traj_d), sum_stat(traj_dp)))

    best = None
    for sd, sdp in families:
        est = empirical_epsilon_lower_bound(
            sd, sdp, alpha=audit.alpha, n_families=len(families))
        if best is None or est.epsilon_lower > best.epsilon_lower:
            best = est

    mech_name = mechanism.name if mechanism is not None else "laplace"
    ledger = audit.ledger(mech_name)
    sens = np.asarray(traj_d["sensitivity_estimate"])  # (trials, rounds)
    for t in range(audit.rounds):
        ledger.record_round(t, sensitivity_estimate=float(sens[0, t]))
    # the statistic reads round 0 only: the claim under test is the
    # per-round epsilon, not the ledger's composed total
    mech = mechanism if mechanism is not None else _DEFAULT_MECH
    theory = mech.epsilon_per_round(audit.b, audit.gamma_n)
    return DistinguishingResult(
        threat=threat.name, mechanism=mech_name,
        theoretical_epsilon=theory, empirical=best,
        flagged=best.epsilon_lower > theory, ledger=ledger)


def distinguishing_attack(
    threat: ThreatModel,
    *,
    mechanism: NoiseMechanism | None = None,
    audit: AuditConfig = AuditConfig(),
) -> DistinguishingResult:
    """The adjacent-world distinguishing game under one threat model.

    The statistics audit the first round (the adjacent inputs differ only
    there, and its calibration is exact), so ``theoretical_epsilon`` and
    ``flagged`` compare against the per-round claim ``b / gamma_n``;
    ``flagged`` means the implementation leaks more than it promises a
    round (with confidence 1 - alpha).
    """
    return score_distinguishing(
        threat, _tapped_trials_cached(audit, mechanism, 0),
        _tapped_trials_cached(audit, mechanism, 1), mechanism=mechanism,
        audit=audit)


# -- reconstruction ---------------------------------------------------------

def reconstruction_attack(
    *,
    mechanism: NoiseMechanism | None = None,
    audit: AuditConfig = AuditConfig(),
) -> dict[str, Any]:
    """Reconstruct the victim's perturbation from repeated observations.

    ``victim_err``: relative L1 error of the noise-averaged estimate of the
    victim's input (local eavesdropper, ``trials`` observations).
    ``sum_err``: the global observer's one-shot recovery error of the
    network perturbation sum; about 0 for zero-sum (graph-homomorphic)
    noise, of the noise scale for independent noise.
    """
    traj = _tapped_trials_cached(audit, mechanism, 0)
    msgs = np.asarray(traj["tap_messages"][:, 0])        # (M, N, dim)
    target = np.zeros((audit.dim,)); target[0] = audit.c
    est = msgs[:, audit.victim, :].mean(axis=0)          # s0 = 0: eps + noise
    victim_err = float(np.abs(est - target).sum() / np.abs(target).sum())
    net_sum = msgs.sum(axis=1)                           # (M, dim)
    sum_err = float(np.abs(net_sum - target[None]).sum(axis=1).mean()
                    / np.abs(target).sum())
    return {"victim_err": victim_err, "sum_err": sum_err,
            "mechanism": mechanism.name if mechanism else "laplace"}


# -- membership inference -----------------------------------------------------

def membership_inference(
    scores_members: np.ndarray,
    scores_nonmembers: np.ndarray,
    *,
    alpha: float = 0.05,
    n_thresholds: int = 5,
) -> EpsilonEstimate:
    """Score-threshold membership inference -> epsilon lower bound.

    ``scores_*`` are per-example losses (members score lower on a leaking
    model). The first half of each sample picks the thresholds (pooled
    quantiles) and only the held-out second half is counted, so the
    threshold choice does not invalidate the Clopper-Pearson guarantee.
    """
    s_in = -np.asarray(scores_members, dtype=np.float64)
    s_out = -np.asarray(scores_nonmembers, dtype=np.float64)
    n = min(s_in.shape[0], s_out.shape[0])
    if n < 4:
        raise ValueError("membership inference needs >= 4 scores per world")
    s_in, s_out = s_in[:n], s_out[:n]
    half = n // 2
    pooled = np.concatenate([s_in[:half], s_out[:half]])
    qs = np.linspace(0.1, 0.9, n_thresholds)
    thresholds = [float(t) for t in np.quantile(pooled, qs)]
    return empirical_epsilon_lower_bound(s_in[half:], s_out[half:],
                                         alpha=alpha, thresholds=thresholds)


def example_scores(loss_fn, params, xs: torch.Tensor,
                   ys: torch.Tensor) -> np.ndarray:
    """Per-example losses under one node's parameters: ``loss_fn(params,
    (x[None], y[None]))`` for each example (the reference vmaps it)."""
    with torch.no_grad():
        return np.asarray([float(loss_fn(params, (x[None], y[None])))
                           for x, y in zip(xs, ys)])
