"""Device and kernel-routing resolution shared by every entry point.

* ``device=None`` means the CUDA card. Without one it raises: the port never
  falls back to the CPU silently. Pass ``device="cpu"`` for the plain
  PyTorch path (the tests do).
* ``use_kernels=None`` means the hand-written kernels on CUDA and their
  plain PyTorch versions on the CPU. ``use_kernels=True`` on the CPU raises.
  The meta device (a dry run, ``repro_torch.launch.dryrun``) routes as the
  card does: its tensors hold no data, and the kernel wrappers' meta paths
  return outputs of the kernels' shapes and count their launches.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_use_kernels"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def resolve_use_kernels(use_kernels: bool | None, device: torch.device) -> bool:
    if use_kernels is None:
        return device.type in ("cuda", "meta")
    if use_kernels and device.type not in ("cuda", "meta"):
        raise ValueError(
            f"use_kernels=True needs a CUDA device, got {device}; the CUDA "
            "kernels have no CPU build (use_kernels=None picks the plain "
            "versions on the CPU)")
    return bool(use_kernels)
