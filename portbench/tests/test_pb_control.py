"""On the card only: the control (the reference in the next lower
precision put in the program's place: TF32 products for the float32
training, bfloat16 arithmetic for the float32 consensus) must fail the
check, and the program must pass it, here at smoke size. The readings at
the cells' own sizes come from ``run.py --control`` on the card."""
import pytest
import torch

from portbench.harness import compare, runtime
from portbench.tests.pb_smoke import run_smoke, smoke_cell

CELLS = [w["name"] for w in runtime.benchmark()["workloads"]]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(card, cell):
    c = smoke_cell(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (3_000_000_001, 3_000_000_002, 3_000_000_003):
        ctx = runtime.Context(torch=torch, cell=c, seed=seed, seconds=0.5,
                              trace=False, device=card)
        checks = c.driver().control(ctx)
        assert not compare.verdict(checks), checks


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_the_check_on_the_card(card, cell):
    torch.backends.cuda.matmul.allow_tf32 = False
    result, checks = run_smoke(cell, device="cuda")
    assert result["correct"], checks


@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".consensus")])
def test_bf16_control_fails_the_check_on_the_cpu(cell):
    """bfloat16 runs on the CPU too: the consensus control there."""
    c = smoke_cell(cell)
    ctx = runtime.Context(torch=torch, cell=c, seed=3_000_000_004,
                          seconds=0.5, trace=False,
                          device=torch.device("cpu"))
    checks = c.driver().control(ctx)
    assert not compare.verdict(checks), checks
