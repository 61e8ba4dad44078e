"""Cells, and the files of a cell, found by name; the run's environment;
the checks that end a run; the result line.

``BENCHMARK.json`` lists the cells and the metrics. A cell names its
configuration (``configs[].file``) and its traffic mix
(``portbench/traffic/<traffic>.json``), which names its driver
(``portbench/drivers/<driver>.py``). A per-layer metric is read by
``portbench/metrics/<name>.py``. Nothing here knows a cell by name.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path
from types import ModuleType

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The wall clock (``time.time()``) at which this process started,
    from the kernel's process table; None where it cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return None


def cache_environment() -> None:
    """Fix every build and kernel cache the run could use to a directory
    inside the checkout (the program builds its kernels into its own
    ``src/repro_torch/kernels/_build``), and keep libraries from loading
    JAX. Call before importing torch."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def allocator_environment(cell: "Cell") -> None:
    """The CUDA caching allocator's options where the cell's configuration
    states them (``allocator``: a ``PYTORCH_CUDA_ALLOC_CONF`` value the
    program needs to fit the cell). Call before importing torch."""
    conf = cell.config.get("allocator")
    if conf:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf["conf"]


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from its file (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell of ``BENCHMARK.json``: its entry, configuration, traffic,
    driver, and the metrics it reports."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                           f"(cells: {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(ROOT / self.config_entry["file"]) as f:
            self.config = json.load(f)
        with open(PORTBENCH / "traffic" / f"{self.entry['traffic']}.json") as f:
            self.traffic = json.load(f)
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]

    def driver(self) -> ModuleType:
        name = self.traffic["driver"]
        return load_module(PORTBENCH / "drivers" / f"{name}.py",
                           f"portbench_driver_{name}")

    def metric_reader(self, metric: str) -> ModuleType:
        return load_module(PORTBENCH / "metrics" / f"{metric}.py",
                           "portbench_metric_" + metric.replace(".", "_"))


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def print_result(result: dict, checks: list[tuple[str, float, float]]) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, the checks under ``checks`` last."""
    for name, value, limit in checks:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr,
              flush=True)
    out = dict(result)
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


class Outcome:
    """What a driver hands back after its window: the window's end-to-end
    figures, its work, the records the per-layer metrics read, a call that
    frees the program's state, and the judge (run after that call) that
    returns the compared numbers as (name, value, limit)."""

    def __init__(self, *, end_to_end: dict, window_wall_start: float,
                 attempted: int, failed: int, records: dict, release,
                 judge):
        self.end_to_end = end_to_end
        self.window_wall_start = window_wall_start
        self.attempted = attempted
        self.failed = failed
        self.records = records
        self.release = release
        self.judge = judge


class Context:
    """A run's settings, as a driver reads them."""

    def __init__(self, *, torch, cell, seed: int, seconds: float,
                 trace: bool, device):
        self.torch = torch
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize(self.device)
