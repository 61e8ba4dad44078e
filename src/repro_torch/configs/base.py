"""ArchSpec: one assigned architecture = full config + reduced smoke config
+ its PartPSP partial-communication rules + shape eligibility."""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.models.config import ModelConfig

__all__ = ["ArchSpec", "INPUT_SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One entry of the assigned-architecture table."""

    name: str
    family: str                      # dense | audio | ssm | vlm | moe | hybrid
    model: ModelConfig               # the exact assigned configuration
    smoke: ModelConfig               # reduced variant for CPU smoke tests
    # PartPSP partial-communication rules: (regex, action) pairs fed to
    # Partition.from_rules with default "local". See DESIGN.md table.
    shared_rules: Sequence[tuple[str, object]]
    notes: str = ""

    @property
    def skip_shapes(self) -> frozenset[str]:
        if self.model.long_context_ok:
            return frozenset()
        return frozenset({"long_500k"})

    def runs_shape(self, shape: str) -> bool:
        return shape not in self.skip_shapes
