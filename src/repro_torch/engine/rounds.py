"""Multi-round protocol drivers, port of ``repro.engine.rounds``.

The reference scans the round with ``jax.lax.scan``; here the round is a
Python loop, since PyTorch runs eagerly. The shared tree is packed into
the (N, d_pad) wire buffer before the loop and unpacked (as views) after
it, as the reference does at segment boundaries.

Noise: round t's bits are a pure function of ``(seed, t, node)`` (Philox,
see :mod:`repro_torch.kernels.ref`), as ``fold_in(key, t)`` makes them in
the reference, so split runs and resumed states continue the same stream.
``bits_at(t) -> (N, d_s) uint32`` feeds explicit bits instead; the
conformance tests use it to hand the port the reference's exact bits.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.dpps import DPPSConfig, DPPSState, dpps_step
from repro_torch.core.packing import PackedLayout
from repro_torch.core.partpsp import PartPSPConfig, PartPSPState, partpsp_step
from repro_torch.core.pushsum import PushSumState
from repro_torch.core.tree_utils import PyTree
from repro_torch.engine.plan import ProtocolPlan

__all__ = ["run_dpps", "run_partpsp", "wire_layout"]

BitsAt = Callable[[int], torch.Tensor] | None


def wire_layout(plan: ProtocolPlan, shared: PyTree) -> PackedLayout:
    """The packed layout the drivers run ``shared`` under."""
    return PackedLayout.from_tree(shared, lane=plan.lane)


def _pack(state: DPPSState, layout: PackedLayout) -> DPPSState:
    return state._replace(push=PushSumState(s=layout.pack(state.push.s),
                                            a=state.push.a))


def _unpack(state: DPPSState, layout: PackedLayout) -> DPPSState:
    return state._replace(push=PushSumState(s=layout.unpack(state.push.s),
                                            a=state.push.a))


def _stack(rows: list[dict[str, Any]]) -> dict[str, torch.Tensor]:
    if not rows:
        return {}
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def run_dpps(state: DPPSState, eps_at: Callable[[int], PyTree] | None, *,
             cfg: DPPSConfig, plan: ProtocolPlan, rounds: int, seed: int = 0,
             bits_at: BitsAt = None) -> tuple[DPPSState, dict[str, torch.Tensor]]:
    """``rounds`` DPPS rounds from ``state``. ``eps_at(t)`` gives round t's
    perturbation tree (``None``: pure consensus, zero perturbation).
    Returns the final (unpacked) state and the per-round diagnostics
    stacked on the device (leaves (T,) / (T, N))."""
    cfg = plan.resolve_dpps(cfg)
    layout = wire_layout(plan, state.push.s)
    st = _pack(state, layout)
    zeros = None
    rows = []
    with torch.no_grad():
        for _ in range(rounds):
            t = st.t
            if eps_at is None:
                if zeros is None:
                    zeros = torch.zeros_like(st.push.s)
                eps = zeros
            else:
                eps = eps_at(t)
            st, diag = dpps_step(st, eps, cfg, layout, seed=seed,
                                 bits=bits_at(t) if bits_at else None,
                                 **plan.mix_at(t))
            rows.append(diag)
    return _unpack(st, layout), _stack(rows)


def run_partpsp(state: PartPSPState, batch_at: Callable[[int], Any], *,
                cfg: PartPSPConfig, partition, loss_fn, plan: ProtocolPlan,
                rounds: int, seed: int = 0, bits_at: BitsAt = None
                ) -> tuple[PartPSPState, dict[str, torch.Tensor]]:
    """``rounds`` PartPSP training rounds (Alg. 2); ``batch_at(t)`` gives
    round t's node-stacked batch."""
    cfg = plan.resolve_partpsp(cfg)
    layout = wire_layout(plan, state.dpps.push.s)
    st = state._replace(dpps=_pack(state.dpps, layout))
    rows = []
    with torch.no_grad():
        for _ in range(rounds):
            t = st.dpps.t
            st, metrics = partpsp_step(
                st, batch_at(t), cfg=cfg, partition=partition,
                loss_fn=loss_fn, layout=layout, seed=seed,
                bits=bits_at(t) if bits_at else None, **plan.mix_at(t))
            rows.append(metrics)
    return st._replace(dpps=_unpack(st.dpps, layout)), _stack(rows)
