"""Top-1 routed Mixture-of-Experts with capacity-bounded scatter dispatch
(port of ``repro.models.moe``).

Tokens are scattered into a dense (E * cap, d) dispatch buffer, the
experts run as E-batched products over (E, cap, d) (``torch.bmm``: the
reference computes them as plain einsums, outside any Pallas kernel), and
the results are gathered back weighted by the router probability. A token
whose position in its expert's queue reaches the capacity is dropped. An
optional always-on shared expert (llama4 style) adds a dense MLP branch.
Expert weights are stacked on a leading E axis.

No step synchronises with the host: dropped tokens are written to an
overflow row past the buffer (every such write writes zeros, so their
order does not matter) rather than selected by a boolean mask. Under
autograd the overflow row is cut off before the experts run, so those
writes carry no gradient to any parameter; a kept token's gradient comes
back through its own slot, and the router's through the gate probability
and the aux loss.

Over a model axis (:mod:`repro_torch.models.parallel`) every rank routes
every token over all E experts with the whole router (the same capacity,
the same drops), keeps the slots of its own experts ``[r E/M, (r+1)
E/M)`` and runs only those rows of the dispatch buffer; the shared
expert's column / row blocks add their partial, and the caller's one
all-reduce combines the ranks. A data dim above 1 routes the tokens of
every data rank (:meth:`ModelAxis.gather_rows`) and keeps its own rows.
In training the routing is replicated (its gradient whole on every
rank); the tokens the experts and the shared expert read, and the gate
probability that weighs the rank's experts' outputs, pass through
:meth:`ModelAxis.copy`, whose backward sums the ranks' partial gradients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.models.parallel import NO_AXIS, ModelAxis

__all__ = ["init_moe", "moe_apply", "moe_capacity", "moe_route"]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             *, shared_expert: bool, dtype=torch.float32, device=None) -> dict:
    params = {
        "router": dense_init(gen, (d_model, n_experts), dtype, device),
        "w_gate": dense_init(gen, (n_experts, d_model, d_ff), dtype, device),
        "w_up": dense_init(gen, (n_experts, d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, (n_experts, d_ff, d_model), dtype, device),
    }
    if shared_expert:
        params["shared"] = {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device),
        }
    return params


def moe_capacity(capacity_factor: float, tokens: int, n_experts: int) -> int:
    return max(1, int(capacity_factor * tokens / n_experts))


def moe_route(router: torch.Tensor, tokens: torch.Tensor, n_experts: int,
              cap: int) -> dict:
    """Top-1 routing of ``tokens`` (T, d): ``probs`` (T, E) f32, the
    chosen ``expert_idx`` (T,) and its ``expert_prob``, the token's
    ``pos`` in its expert's queue (a stable cumsum in token order),
    ``keep`` = pos < cap, and its ``slot`` in the (E cap + 1)-row buffer
    (the last row for a dropped token)."""
    probs = torch.softmax((tokens @ router).float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)  # the first of equal maxima
    expert_prob = probs.gather(1, expert_idx[:, None])[:, 0]
    onehot = F.one_hot(expert_idx, n_experts)
    pos = (onehot.cumsum(dim=0) - 1).gather(1, expert_idx[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, expert_idx * cap + pos.clamp_max(cap - 1),
                       n_experts * cap)
    return dict(probs=probs, onehot=onehot, expert_idx=expert_idx,
                expert_prob=expert_prob, pos=pos, keep=keep, slot=slot)


def moe_apply(params: dict, x: torch.Tensor, *, n_experts: int,
              capacity_factor: float, router_aux_weight: float,
              axis: ModelAxis = NO_AXIS) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output (B, S, d), Switch load-balance aux loss).
    Over a model ``axis`` the output is this rank's partial sum (its
    experts' and its shared-expert block's), and ``params`` its shard."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    routed = axis.gather_rows(tokens)
    cap = moe_capacity(capacity_factor, routed.shape[0], n_experts)
    r = moe_route(params["router"], routed, n_experts, cap)
    # what the rank's experts read: without grad, the tokens themselves
    # (training's axis has a data dim of 1, so routed is tokens there)
    mine_in = axis.copy(tokens)
    dispatched_in = routed if mine_in is tokens else mine_in
    slot, n_local = r["slot"], n_experts
    if axis.off:
        keep = r["keep"][:, None]
    else:  # this rank's experts only; the others' tokens take the overflow row
        mine = axis.block(n_experts, "n_experts")
        n_local = mine.stop - mine.start
        keep = r["keep"] & (r["expert_idx"] >= mine.start) & \
            (r["expert_idx"] < mine.stop)
        slot = torch.where(keep, slot - mine.start * cap, n_local * cap)
        keep = keep[:, None]

    buf = torch.zeros((n_local * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = torch.where(keep, dispatched_in, 0.0)
    dispatched = buf[:-1].reshape(n_local, cap, d)

    gate = F.silu(torch.bmm(dispatched, params["w_gate"]).float()).to(x.dtype)
    up = torch.bmm(dispatched, params["w_up"])
    h = torch.bmm(gate * up, params["w_down"])               # (E, cap, d)

    h_flat = torch.cat([h.reshape(n_local * cap, d), h.new_zeros((1, d))])
    out = h_flat[slot] * axis.copy(r["expert_prob"])[:, None].to(x.dtype)
    out = axis.local_rows(torch.where(keep, out, 0.0))

    if "shared" in params:
        sh = params["shared"]
        sgate = F.silu((mine_in @ sh["w_gate"]).float()).to(x.dtype)
        out = out + (sgate * (mine_in @ sh["w_up"])) @ sh["w_down"]

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    frac_tokens = r["onehot"].float().mean(dim=0)
    frac_probs = r["probs"].mean(dim=0)
    aux = router_aux_weight * n_experts * (frac_tokens * frac_probs).sum()
    return out.reshape(b, s, d), aux
