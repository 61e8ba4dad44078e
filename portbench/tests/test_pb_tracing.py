"""The traced window's reading from the profiler's raw results
(``tracing.raw_events``) against the profiler's own ``prof.events()``:
the same events, times and correlations (where ``prof.events()`` merges
a nested op into its parent of the same name, the raw results keep
both), and on the card the same phase breakdown of the device time."""
from collections import Counter

import pytest
import torch

from portbench.harness import tracing


def _profiled(device):
    from repro_torch.obs.trace import PHASE_CLIP, PHASE_GRADS_LOCAL, phase

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    x = torch.randn(64, 64, device=device)
    with torch.profiler.profile(activities=acts) as prof:
        with phase(PHASE_GRADS_LOCAL):
            y = x @ x
        with phase(PHASE_CLIP):
            y = (y.abs().sum() + x).relu()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return prof


def _key(e):
    return (e.name, str(e.device_type), round(e.time_range.start, 3),
            round(e.time_range.end, 3), e.id,
            bool(getattr(e, "is_user_annotation", False)))


def _same_reading(prof, device_type):
    from repro_torch.obs.trace import phase_breakdown

    raw = tracing.raw_events(prof)
    full = list(prof.events())
    got, want = Counter(map(_key, raw)), Counter(map(_key, full))
    assert not want - got
    # ``prof.events()`` merges an op into its parent of the same name
    for name, _, t0, t1, *_ in (got - want).elements():
        assert any(k[0] == name and k[2] <= t0 and t1 <= k[3] for k in want)
    got = phase_breakdown(raw, device=device_type)
    want = phase_breakdown(full, device=device_type)
    assert got[0] == pytest.approx(want[0]) and got[2] == want[2]
    return got


def test_raw_events_are_the_profilers_events_on_the_cpu():
    _same_reading(_profiled(torch.device("cpu")), "cuda")


@pytest.mark.requires_cuda
def test_raw_events_give_the_profilers_phase_breakdown_on_the_card(card):
    phases, total, note = _same_reading(_profiled(card), "cuda")
    assert note is None and total > 0
    assert phases["partpsp_local_grads"] > 0 and phases["partpsp_clip"] > 0
