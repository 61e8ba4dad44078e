"""Shared neural building blocks (port of ``repro.models.layers``).

Pure functions over plain parameter dicts. Initialisers take an explicit
``torch.Generator`` (the reference's take a JAX key; the two give different
numbers from one seed, so the tests carry the reference's own parameters
across with :func:`repro_torch.convert.transformer_params_from_reference`).
The arithmetic follows the reference where it sets the numbers: norms and
activations in f32, cast back to the residual's type; rope's inverse
frequencies as ``exp(-i/half · log θ)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "init_rms_norm", "dense_init", "mlp_init",
           "mlp_apply", "rope", "softcap"]


def init_rms_norm(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()).to(x.dtype)


def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] over sqrt(fan_in), as the reference."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype=torch.float32, device=None) -> dict:
    params = {"w_up": dense_init(gen, (d_model, d_ff), dtype, device),
              "w_down": dense_init(gen, (d_ff, d_model), dtype, device)}
    if activation in ("silu", "geglu"):  # gated variants carry a gate proj
        params["w_gate"] = dense_init(gen, (d_model, d_ff), dtype, device)
    return params


def mlp_apply(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """Gated (SwiGLU / GeGLU, tanh GELU) or plain tanh-GELU MLP."""
    up = x @ params["w_up"]
    if activation == "silu":
        h = F.silu((x @ params["w_gate"]).float()).to(x.dtype) * up
    elif activation == "geglu":
        h = F.gelu((x @ params["w_gate"]).float(),
                   approximate="tanh").to(x.dtype) * up
    else:  # plain gelu
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return h @ params["w_down"]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding. x: (..., S, H, D) with D even;
    positions: (..., S) int."""
    half = x.shape[-1] // 2
    freq_exponents = torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half
    # log(theta) in f32, taken on the host: a device scalar made from a
    # Python number would be a host-to-device copy, which waits for the
    # stream, on every call (twice a layer in each decode step)
    log_theta = float(torch.log(torch.tensor(theta, dtype=torch.float32)))
    inv_freq = torch.exp(freq_exponents * -log_theta)  # theta ** -(2i/d)
    angles = positions[..., None].float() * inv_freq   # (..., S, half)
    cos = torch.cos(angles)[..., None, :]              # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style logit soft-capping; cap <= 0 is a no-op."""
    if cap and cap > 0:
        return (torch.tanh(logits / cap) * cap).to(logits.dtype)
    return logits
