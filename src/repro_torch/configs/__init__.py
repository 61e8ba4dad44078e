"""Architecture registry of the port: ``get_config("<arch-id>")`` ->
ArchSpec (mirrors ``repro.configs``).

The port serves the attention-only family so far: the five architectures
whose every group is an ``AttnGroup``. The reference's other five names
(MoE, xLSTM, Zamba, the VLM) are known here and raise ``KeyError`` saying
that they wait for a later slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, ArchSpec, ShapeSpec

_ARCH_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}
# The reference's architectures whose group kinds the port does not run yet.
_LATER = ("xlstm-125m", "llama-3.2-vision-11b", "llama4-scout-17b-a16e",
          "llama4-maverick-400b-a17b", "zamba2-7b")

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ArchSpec:
    if name in _LATER:
        raise KeyError(
            f"arch {name!r} is not ported yet: its MoE / xLSTM / Mamba / Zamba "
            "/ cross-attention groups wait for a later slice (ROADMAP Queue 1)")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCH_NAMES)}")
    return importlib.import_module(_ARCH_MODULES[name]).SPEC


__all__ = ["ARCH_NAMES", "ArchSpec", "ShapeSpec", "INPUT_SHAPES", "get_config"]
