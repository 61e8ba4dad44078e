"""What the per-layer metric files share: a kernel's time a launch in the
traced window, and a share of a least time."""
from __future__ import annotations

import re


def kernel_seconds(rec: dict, names) -> tuple[int, float] | None:
    """(launches, device seconds) of the device events whose name holds
    one of ``names`` as a word, in a complete trace; None otherwise."""
    if not rec.get("complete"):
        return None
    pat = re.compile(r"\b(" + "|".join(names) + r")\b")
    count, secs = 0, 0.0
    for name, (n, s) in rec.get("kernels", {}).items():
        if pat.search(name):
            count += n
            secs += s
    return (count, secs) if count else None


def roofline_pct(rec: dict, names, bound_s) -> float | None:
    """The least time of one launch (``bound_s()``, seconds) over its
    measured time, in %."""
    got = kernel_seconds(rec, names)
    if got is None:
        return None
    count, secs = got
    return 100.0 * bound_s() * count / secs


def phase_ms(rec: dict, keep, per: int) -> float | None:
    """Device milliseconds of the phases ``keep(name)`` selects, over
    ``per`` steps or rounds, in a complete trace."""
    if not rec.get("complete") or not per:
        return None
    phases = rec.get("phases") or {}
    return 1e3 * sum(v for k, v in phases.items() if keep(k)) / per


def idle_pct(rec: dict) -> float | None:
    if not rec.get("complete") or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
