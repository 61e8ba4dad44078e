"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``. Libraries are built at first use, from the sources
in this package only, into ``_build/`` beside them (listed in
``.gitignore``); the file name carries a hash of the sources and flags, so
an edited source is rebuilt. :func:`build_all` starts one ``nvcc`` per
source, all at once.

Nothing here runs at import: the CPU tests import every module, also
where no CUDA toolkit (and so no ``nvcc``) is installed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "function", "library_path"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _F32, _U64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                        ctypes.c_uint64)
# C signatures: pointers and the stream are c_void_p, sizes c_int64.
_SIGNATURES = {
    "l1_norm": ("l1_norm_rows", [_P] + [_I64] * 6 + [_P, _P, _P, _P]),
    "dpps_perturb": ("dpps_perturb_rows",
                     [_P, _P, _P, _P, _F32, _I64, _I64, _I64, _U64, _I64,
                      _I64, _I64, _I64, _I64] + [_I64] * 4 + [_P] * 6),
    "pushsum_mix": ("pushsum_mix", [_P, _P, _P] + [_I64] * 10 + [_P]),
    "spmm": ("spmm", [_P, _P, _P, _P] + [_I64] * 9 + [_P]),
    "clip_scale": ("clip_scale_rows", [_P, _P, _I64, _I64, _I64, _P, _P]),
    "laplace_noise": ("laplace_from_bits", [_P, _P, _I64, _P, _P]),
    "flash_attention": ("flash_attention", [_P, _P, _P, _P] + [_I64] * 18
                        + [_P]),
}
SOURCES = tuple(_SIGNATURES)

_LOADED: dict[str, ctypes.CDLL] = {}
_FUNCTIONS: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every missing library in ``names``, one ``nvcc`` each, all in
    parallel. Returns ``{name: {"seconds", "ptxas", "cached"}}`` (``ptxas``
    is the register/shared-memory report of ``-Xptxas -v``). Raises with
    the compiler's output if any build fails."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs, report = {}, {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            report[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log,
                        "cached": False}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with its C
    function's argtypes and restype set."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.is_file():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = lib
        _FUNCTIONS[name] = fn
    return lib


def function(name: str):
    """The C function of library ``name`` (:func:`load` first if needed),
    looked up once: the wrappers call it on every launch."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        load(name)
        fn = _FUNCTIONS[name]
    return fn
