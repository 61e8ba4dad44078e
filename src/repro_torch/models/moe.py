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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

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
              capacity_factor: float, router_aux_weight: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output (B, S, d), Switch load-balance aux loss)."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    cap = moe_capacity(capacity_factor, b * s, n_experts)
    r = moe_route(params["router"], tokens, n_experts, cap)
    keep = r["keep"][:, None]

    buf = torch.zeros((n_experts * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[r["slot"]] = torch.where(keep, tokens, 0.0)
    dispatched = buf[:-1].reshape(n_experts, cap, d)

    gate = F.silu(torch.bmm(dispatched, params["w_gate"]).float()).to(x.dtype)
    up = torch.bmm(dispatched, params["w_up"])
    h = torch.bmm(gate * up, params["w_down"])               # (E, cap, d)

    h_flat = torch.cat([h.reshape(n_experts * cap, d), h.new_zeros((1, d))])
    out = h_flat[r["slot"]] * r["expert_prob"][:, None].to(x.dtype)
    out = torch.where(keep, out, 0.0)

    if "shared" in params:
        sh = params["shared"]
        sgate = F.silu((tokens @ sh["w_gate"]).float()).to(x.dtype)
        out = out + (sgate * (tokens @ sh["w_up"])) @ sh["w_down"]

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    frac_tokens = r["onehot"].float().mean(dim=0)
    frac_probs = r["probs"].mean(dim=0)
    aux = router_aux_weight * n_experts * (frac_tokens * frac_probs).sum()
    return out.reshape(b, s, d), aux
