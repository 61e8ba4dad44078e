"""Cells cut to a size the CPU runs in seconds: the same files, drivers
and checks, with the configuration's widths and the traffic's lengths
made small (the program's own smoke configuration where it builds a
model)."""
from __future__ import annotations

import copy
import time

import torch

from portbench import run as pb_run
from portbench.harness import runtime

MUSICGEN_SMOKE = dict(d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                      d_ff=256, vocab_size=256, n_layers=2)


def smoke_cell(name: str) -> runtime.Cell:
    cell = runtime.Cell(runtime.benchmark(), name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if cfg["name"] == "musicgen-large":
        cfg["preset"] = "smoke"
        cfg["model"].update(MUSICGEN_SMOKE)
        cfg["partition"]["shared_layers"] = 1
        d, f = MUSICGEN_SMOKE["d_model"], MUSICGEN_SMOKE["d_ff"]
        cfg["shared_leaves"] = [
            ["group_0/attn/wk", [1, d, d]], ["group_0/attn/wo", [1, d, d]],
            ["group_0/attn/wq", [1, d, d]], ["group_0/attn/wv", [1, d, d]],
            ["group_0/ln1/scale", [1, d]], ["group_0/ln2/scale", [1, d]],
            ["group_0/mlp/w_down", [1, f, d]], ["group_0/mlp/w_up", [1, d, f]]]
    else:
        cfg["shared_leaves"] = [["group_0/mlstm/cell/w_k", [3, 100]],
                                ["group_0/mlstm/ln/scale", [7]]]
    tr["frames_per_node"] = 16
    tr["max_steps_per_s"] = 1000
    cell.config, cell.traffic = cfg, tr
    return cell


def run_smoke(name: str, *, seed: int = 2_200_000_011, seconds: float = 0.5,
              device: str = "cpu"):
    """One run of the cell at smoke size -> (result, checks)."""
    cell = smoke_cell(name)
    return pb_run.run_cell(torch, cell, seed=seed, seconds=seconds,
                           trace=False, device=torch.device(device),
                           t0=time.time())
