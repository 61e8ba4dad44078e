"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out, each against a limit."""
from __future__ import annotations

import statistics

import torch


def rel_max(got, want) -> float:
    """max |got - want| / max |want| over all entries."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale > 0 else \
        float((got - want).abs().max())


def rel_each(got, want) -> float:
    """max over entries of |got - want| / |want|."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    return float(((got - want).abs() / want.abs()).max())


def worst_leaf(got: dict, want: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap of norms, ``| |got| - |want| |`` over the
    larger of the reference's norm of that leaf and of the median leaf
    (some leaves' norms are all but zero): (gap, leaf)."""
    names = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in names)
    worst, which = 0.0, ""
    for k in names:
        gap = abs(got[k] - want[k]) / max(want[k], med)
        if gap >= worst:
            worst, which = gap, k
    return worst, which


def verdict(numbers: list[tuple[str, float, float]]) -> bool:
    """Every number under its limit (a NaN fails)."""
    return all(value == value and value <= limit
               for _, value, limit in numbers)
