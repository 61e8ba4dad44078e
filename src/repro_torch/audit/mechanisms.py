"""Pluggable per-round noise mechanisms of the DPPS round (port of
``repro.audit.mechanisms``).

``repro_torch.core.dpps.dpps_step`` draws its Eq. 8 noise through the
``mechanism`` seam when one is given. A mechanism returns the round's raw
(N, d_s) noise row for the calibrated Laplace scale ``S / b``; the round
applies the rate ``gamma_n`` and tracks the noise norms as for its own
draw.

* :class:`LaplaceMechanism`: the paper's Lemma 1. With ``scale_factor=1``
  its state is bit for bit ``mechanism=None``'s, packed and pytree, on the
  CPU and on the card: it transforms the round's own noise bits (the
  Philox row the fused perturbation draws, or the bits the caller gave)
  through ``ops.laplace_from_bits`` (``csrc/laplace_noise.cu`` on the
  card), the transform the fused kernel inlines. ``scale_factor=0.5`` is
  the broken variant the battery must flag.
* :class:`GaussianMechanism`: ``sigma = (S / b) sqrt(2 ln(1.25 / delta))``,
  normals by Box-Muller from a Philox stream of their own
  (``core.privacy.normal_row``). Calibrated on the L1 sensitivity, so
  conservative.
* :class:`GraphHomomorphicMechanism`: zero-sum noise ``z - mean_nodes z``
  over the round's Laplace draw: a global observer who sums the N messages
  cancels it (Vlaski & Sayed, arXiv:2010.12288).

The reference draws with ``jax.random`` (threefry), which is not
reproduced; ``draws=`` (tests only) feeds its unit-scale samples, which a
mechanism scales as the reference's ``noise_like`` does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.privacy import laplace_row, normal_row

__all__ = [
    "NoiseMechanism",
    "LaplaceMechanism",
    "GaussianMechanism",
    "GraphHomomorphicMechanism",
    "MECHANISMS",
    "get_mechanism",
    "theoretical_epsilon",
]


@dataclasses.dataclass(frozen=True)
class NoiseMechanism:
    """Base mechanism: the interface and the pure-DP Laplace accounting."""

    name: str = "laplace"

    def sample(self, n: int, d_s: int, scale, *, seed: int, t: int,
               device=None, use_kernels: bool = False,
               bits: torch.Tensor | None = None,
               draws: torch.Tensor | None = None) -> torch.Tensor:
        """The round's raw (N, d_s) noise row; ``scale`` is the Laplace
        scale S / b. ``bits`` are the round's noise bits where the caller
        fed them; ``draws`` unit-scale samples (tests only)."""
        raise NotImplementedError

    def epsilon_per_round(self, b: float, gamma_n: float) -> float:
        """The per-round epsilon this mechanism claims (composed
        linearly)."""
        if gamma_n <= 0:
            return float("inf")
        return b / gamma_n

    @property
    def delta(self) -> float:
        return 0.0


@dataclasses.dataclass(frozen=True)
class LaplaceMechanism(NoiseMechanism):
    """Paper Lemma 1: i.i.d. Lap(0, S / b) a coordinate, times
    ``scale_factor`` (1: the built-in draw bit for bit; < 1 under-noises
    while still claiming ``b / gamma_n``)."""

    name: str = "laplace"
    scale_factor: float = 1.0

    def sample(self, n, d_s, scale, *, seed, t, device=None,
               use_kernels=False, bits=None, draws=None):
        return laplace_row(n, d_s, scale * self.scale_factor, seed=seed,
                           t=t, device=device, bits=bits, draws=draws,
                           use_kernels=use_kernels)

    def true_epsilon_per_round(self, b: float, gamma_n: float) -> float:
        """The epsilon actually delivered (differs when scale_factor != 1)."""
        return self.epsilon_per_round(b, gamma_n) / self.scale_factor


@dataclasses.dataclass(frozen=True)
class GaussianMechanism(NoiseMechanism):
    """(eps, delta) Gaussian mechanism, sigma = (S/b) sqrt(2 ln(1.25/delta))."""

    name: str = "gaussian"
    delta_: float = 1e-5

    def sample(self, n, d_s, scale, *, seed, t, device=None,
               use_kernels=False, bits=None, draws=None):
        sigma_mult = math.sqrt(2.0 * math.log(1.25 / self.delta_))
        return normal_row(n, d_s, scale * sigma_mult, seed=seed, t=t,
                          device=device, draws=draws)

    @property
    def delta(self) -> float:
        return self.delta_


@dataclasses.dataclass(frozen=True)
class GraphHomomorphicMechanism(NoiseMechanism):
    """Zero-sum correlated noise ``q_i = z_i - mean_j z_j``, z i.i.d.
    Laplace. The network mean of the noise is exactly zero every round, so
    a global observer summing all N messages removes it; the nominal
    epsilon is the local-view figure, and the battery measures the rest."""

    name: str = "graph_homomorphic"

    def sample(self, n, d_s, scale, *, seed, t, device=None,
               use_kernels=False, bits=None, draws=None):
        z = laplace_row(n, d_s, scale, seed=seed, t=t, device=device,
                        bits=bits, draws=draws, use_kernels=use_kernels)
        return z - z.mean(dim=0, keepdim=True)


MECHANISMS = {
    "laplace": LaplaceMechanism(),
    "gaussian": GaussianMechanism(),
    "graph_homomorphic": GraphHomomorphicMechanism(),
    "broken_laplace": LaplaceMechanism(name="broken_laplace",
                                       scale_factor=0.5),
}


def get_mechanism(name: str) -> NoiseMechanism:
    try:
        return MECHANISMS[name]
    except KeyError:
        raise ValueError(f"unknown mechanism {name!r}; "
                         f"have {sorted(MECHANISMS)}") from None


def theoretical_epsilon(mechanism: NoiseMechanism | None, b: float,
                        gamma_n: float, rounds: int = 1) -> float:
    """The ledger's claimed epsilon after ``rounds`` (linear composition)."""
    mech = mechanism or LaplaceMechanism()
    return rounds * mech.epsilon_per_round(b, gamma_n)
