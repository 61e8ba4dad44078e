"""Architecture registry of the port: ``get_config("<arch-id>")`` ->
ArchSpec (mirrors ``repro.configs``).

All ten of the reference's architectures train and serve.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, ArchSpec, ShapeSpec
from repro_torch.configs.shapes import (input_specs, serve_batch_specs,
                                        train_batch_specs)

_ARCH_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "llama-3.2-vision-11b": "repro_torch.configs.llama3_2_vision_11b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ArchSpec:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCH_NAMES)}")
    return importlib.import_module(_ARCH_MODULES[name]).SPEC


def all_configs() -> dict[str, ArchSpec]:
    return {name: get_config(name) for name in ARCH_NAMES}


__all__ = ["ARCH_NAMES", "ArchSpec", "ShapeSpec",
           "INPUT_SHAPES", "get_config", "all_configs", "input_specs",
           "train_batch_specs", "serve_batch_specs"]
