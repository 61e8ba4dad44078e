"""Time the launch plans of the hand-written kernels on the card, at the
shapes ``chip_smoke.py`` runs.

    python -m repro_torch.kernels.sweep [--out FILE] [--only SECTION ...]

Sections (all by default):

- ``flash``: flash attention at the tile of :data:`repro_torch.kernels.ops.
  FLASH_TILES` for its head dim (to time another tile, change that table
  and the C file's ``REPRO_FLASH_TILES`` list alike), the last 256 query
  rows held against the plain version.
- ``spmm``: each of ``SPMM_CANDIDATES``' stage size, blocks per SM and
  threads (patched into ``ops``), beside one ``torch.sparse.mm`` call.
- ``l1``: ``l1_norm_rows`` at each of ``L1_CANDIDATES``' threads and quads
  a block, beside ``torch.linalg.vector_norm(x, 1, dim=1)``, at the paths'
  shapes and at N = 5 with N = 24's bytes (row count against size).
- ``mix``: ``pushsum_mix`` past its template at ``MIX_SHAPES`` under its
  default plan and each tile of ``ops.MIX_TILES`` (bit for bit the default
  plan's), beside one ``torch.matmul`` call.
- ``perturb``: ``dpps_perturb_rows`` (Philox) at ``PERTURB_SHAPES`` under
  each of ``PERTURB_CANDIDATES``' tables (s_noise bit for bit the default
  plan's), beside ``torch.add(s, eps, out=o)``, a copy that moves the same
  bytes (the ceiling of a streaming kernel, not the same function).

Each result is held against the plain version and printed as one JSON
line, with the card's name and power limit. A tool for choosing the tables
in ``ops.py``; it needs a CUDA card. Run by its path with an older tree's
``src`` first on ``PYTHONPATH``, the ``mix`` and ``perturb`` sections time
that tree's kernels under their default plans alone (the tables they do
not have are skipped), at the same shapes.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from repro_torch.kernels import ops, ref

FLASH_SHAPES = {  # (B, S, H, K, D, window), as chip_smoke.py
    "llama_32k": (1, 32_768, 32, 8, 64, None),
    "gemma3_32k_window512": (1, 32_768, 4, 1, 256, 512),
    "gemma3_32k_global": (1, 32_768, 4, 1, 256, None),
    "ragged_minitron": (2, 1000, 24, 8, 128, None),
    "minitron_32k": (1, 32_768, 24, 8, 128, None),
    "zamba2_4k": (1, 4096, 32, 32, 112, None),
    "scout_4k": (1, 4096, 40, 8, 128, None),
    "vision_4k": (1, 4096, 32, 8, 128, None),
}
# (stage bytes, blocks an SM at most, threads a block) of the column-tile
# ring; stage bytes 0 forces the rows regime
SPMM_CANDIDATES = [(16 << 10, 8, 256), (16 << 10, 4, 256), (16 << 10, 8, 128),
                   (16 << 10, 4, 512), (8 << 10, 8, 256), (32 << 10, 8, 256),
                   (32 << 10, 4, 512), (0, 8, 256)]
SPMM_SHAPES = {  # (N, D, graph seed): ER(N, p = 8/N), as chip_smoke.py
    "sparse_full": (24, 95_669_120, 0),
    "sparse_train": (128, 7936, 0),
    "sweep": (4096, 8, 2024),
}
# (threads a block, quads a block) of l1_norm.cu
L1_CANDIDATES = [(256, 2048), (512, 4096), (256, 4096), (128, 1024),
                 (256, 1024)]
MIX_SHAPES = ((33, 1 << 20), (64, 1 << 20), (256, 1 << 20), (4096, 8),
              (128, 7936), (4096, 128))  # (N, D), as chip_smoke.py
# tables patched into ops; {} is the default plan
PERTURB_CANDIDATES = [
    {}, {"PERTURB_QUADS_PER_BLOCK": 1024}, {"PERTURB_QUADS_PER_BLOCK": 4096},
    {"PERTURB_THREADS": 128, "PERTURB_QUADS_PER_BLOCK": 1024},
    {"PERTURB_ROW_LANES": 32}, {"PERTURB_ROW_LANES": 8},
    {"PERTURB_SHORT_QUADS": 0}]
PERTURB_SHAPES = {  # (N, d_s), as chip_smoke.py
    "dense_full": (5, 505_956_352),
    "sparse_full": (24, 95_669_064),
    "training": (4, 243_286_016),
    "paper": (10, 7840),
    "sparse_train": (128, 7840),
    "rows_65536": (65_536, 300),
    "rows_100003": (100_003, 300),
    "er4096": (4096, 8),
}
L1_SHAPES = {  # (N, d_pad, d_s)
    "dense_full": (5, 505_956_352, 505_956_352),
    "sparse_full": (24, 95_669_120, 95_669_064),
    "n5_sparse_full_bytes": (5, 459_211_776, 459_211_507),
    "paper": (10, 7936, 7840),
    "sparse_train": (128, 7936, 7840),
}


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def sweep_flash(dev, emit) -> None:
    for name, (b, s, h, kh, d, window) in FLASH_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(s + d)
        q = torch.randn((b, s, h, d), generator=gen, device=dev)
        k = torch.randn((b, s, kh, d), generator=gen, device=dev)
        v = torch.randn((b, s, kh, d), generator=gen, device=dev)
        r0 = max(0, s - 256)
        want = ref.flash_attention(
            q[:, r0:].transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            group=h // kh, window=window, q_start=r0).transpose(1, 2)
        iters = 3 if s > 4096 else 20
        got = ops.flash_attention_bshd(q, k, v, window=window)
        err = (got[:, r0:] - want).abs().max().item()
        ms = cuda_ms(lambda: ops.flash_attention_bshd(q, k, v, window=window),
                     iters)
        emit(dict(kernel="flash_attention", shape=name, tile=ops.FLASH_TILES[d],
                  geometry=ops.flash_geometry(b, s, h, d), ms=ms,
                  max_abs_err_last_rows=err))
        del q, k, v, want, got
        torch.cuda.empty_cache()


def sweep_spmm(dev, emit) -> None:
    from repro_torch.net import ErdosRenyiGraph

    saved = (ops.SPMM_STAGE_BYTES, ops.SPMM_BLOCKS_PER_SM, ops.SPMM_THREADS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (n, d, seed) in SPMM_SHAPES.items():
        idx, vals = ErdosRenyiGraph(n, p=8.0 / n, seed=seed).sparse_weights(0)
        idx = torch.as_tensor(idx, device=dev)
        vals = torch.as_tensor(vals, dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((n, d), generator=gen, device=dev)
        base = ops.spmm(idx, vals, x)
        cols = 1 << 24
        err = max((base[:, c:c + cols] - ref.spmm(idx, vals, x[:, c:c + cols]))
                  .abs().max().item() for c in range(0, d, cols))
        iters = 5 if n * d > 1 << 28 else 200
        for candidate in SPMM_CANDIDATES:
            (ops.SPMM_STAGE_BYTES, ops.SPMM_BLOCKS_PER_SM,
             ops.SPMM_THREADS) = candidate
            try:
                plan = ops.spmm_plan(n, idx.shape[1], d, sms)
                same = bool(torch.equal(ops.spmm(idx, vals, x), base))
                ms = cuda_ms(lambda: ops.spmm(idx, vals, x), iters)
            finally:
                (ops.SPMM_STAGE_BYTES, ops.SPMM_BLOCKS_PER_SM,
                 ops.SPMM_THREADS) = saved
            emit(dict(kernel="spmm", shape=name, candidate=candidate,
                      plan=plan, ms=ms, equals_default_plan=same,
                      default_max_abs_err=err))
        w_csr = torch.sparse_csr_tensor(
            *_csr_of(idx, vals, n), size=(n, n), device=dev)
        emit(dict(kernel="spmm", shape=name, library="torch.sparse.mm",
                  ms=cuda_ms(lambda: torch.sparse.mm(w_csr, x), iters)))
        del x, base
        torch.cuda.empty_cache()


def _csr_of(idx, vals, n):
    """(crow, col, values) of W from the padded CSR (zero-weight pads
    dropped)."""
    keep = vals != 0
    crow = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    return crow, idx[keep].to(torch.int64), vals[keep]


def _patched(names: tuple, values: tuple, fn):
    """``fn()`` with ``ops``' tables ``names`` set to ``values``."""
    saved = tuple(getattr(ops, k) for k in names)
    for k, v in zip(names, values):
        setattr(ops, k, v)
    try:
        return fn()
    finally:
        for k, v in zip(names, saved):
            setattr(ops, k, v)


def _shape_iters(elements: int) -> int:
    return 5 if elements > 1 << 28 else 200


def sweep_l1(dev, emit) -> None:
    names = ("L1_THREADS", "L1_QUADS_PER_BLOCK")
    for name, (n, d_pad, d_s) in L1_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(n + d_s)
        buf = torch.randn((n, d_pad), generator=gen, device=dev)
        buf[:, d_s:] = 1e4  # pad lanes: never read
        want = ref.l1_norm_rows(buf, d_s)
        iters = _shape_iters(n * d_pad)
        for candidate in L1_CANDIDATES:
            plan = _patched(names, candidate, lambda: ops.l1_plan(n, d_s))
            got = _patched(names, candidate,
                           lambda: ops.l1_norm_rows(buf, d_s))
            again = _patched(names, candidate,
                             lambda: ops.l1_norm_rows(buf, d_s))
            rel = ((got - want).abs() / want).max().item()
            emit(dict(kernel="l1_norm_rows", shape=name, n=n, d_pad=d_pad,
                      d_s=d_s, candidate=candidate, plan=plan,
                      ms=_patched(names, candidate, lambda: cuda_ms(
                          lambda: ops.l1_norm_rows(buf, d_s), iters)),
                      max_rel_err=rel, within_tol=rel <= 1e-5,
                      two_launches_equal=bool(torch.equal(got, again))))
        emit(dict(kernel="l1_norm_rows", shape=name,
                  library="torch.linalg.vector_norm", ms=cuda_ms(
                      lambda: torch.linalg.vector_norm(buf[:, :d_s], 1, dim=1),
                      iters)))
        del buf
        torch.cuda.empty_cache()


def sweep_mix(dev, emit) -> None:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = getattr(ops, "MIX_TILES", {})
    plan = ops.mix_plan
    for n, d in MIX_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(n + d)
        x = torch.randn((n, d), generator=gen, device=dev)
        w = torch.rand((n, n), generator=gen, device=dev)
        w /= w.sum(0, keepdim=True)
        base = ops.pushsum_mix(w, x)
        err = (base - ref.pushsum_mix(w, x)).abs().max().item()
        iters = _shape_iters(n * d * 64)
        # a first timing after the inputs are made reads slow: untimed
        cuda_ms(lambda: ops.pushsum_mix(w, x), iters)
        emit(dict(kernel="pushsum_mix", n=n, d=d, plan=plan(n, d, sms),
                  ms=cuda_ms(lambda: ops.pushsum_mix(w, x), iters),
                  max_abs_err=err))
        for tile in tiles:
            forced = lambda n_, d_, sms_, tile=tile, **kw: plan(
                n_, d_, sms_, tile, **kw)
            same = _patched(("mix_plan",), (forced,), lambda: bool(
                torch.equal(ops.pushsum_mix(w, x), base)))
            emit(dict(kernel="pushsum_mix", n=n, d=d, tile=tile,
                      ms=_patched(("mix_plan",), (forced,), lambda: cuda_ms(
                          lambda: ops.pushsum_mix(w, x), iters)),
                      equals_default_plan=same))
        emit(dict(kernel="pushsum_mix", n=n, d=d, library="torch.matmul",
                  ms=cuda_ms(lambda: torch.matmul(w, x), iters)))
        del x, w, base
        torch.cuda.empty_cache()


def sweep_perturb(dev, emit) -> None:
    scale = torch.tensor(0.7, device=dev)
    candidates = PERTURB_CANDIDATES if hasattr(ops, "perturb_plan") else [{}]
    for name, (n, d_s) in PERTURB_SHAPES.items():
        d_pad = -(-d_s // 128) * 128
        gen = torch.Generator(device=dev).manual_seed(n + d_s)
        s = torch.randn((n, d_pad), generator=gen, device=dev)
        eps = torch.randn((n, d_pad), generator=gen, device=dev)
        s[:, d_s:] = 1e4
        eps[:, d_s:] = 1e4
        call = lambda: ops.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=7,
                                             t=3)
        base = call()
        iters = _shape_iters(n * d_pad)
        cuda_ms(call, iters)  # untimed warm-up, as in sweep_mix
        for candidate in candidates:
            names, values = tuple(candidate), tuple(candidate.values())
            got = _patched(names, values, call)
            plan = (_patched(names, values,
                             lambda: ops.perturb_plan(n, d_pad))
                    if hasattr(ops, "perturb_plan") else None)
            emit(dict(kernel="dpps_perturb_rows", shape=name, n=n, d_s=d_s,
                      candidate=candidate, plan=plan,
                      ms=_patched(names, values, lambda: cuda_ms(call, iters)),
                      equals_default_plan=bool(torch.equal(got[0], base[0])),
                      norms_max_rel_diff=max(
                          ((g - b).abs() / b).max().item()
                          for g, b in zip(got[1:], base[1:]))))
            del got
        out = torch.empty_like(s)
        emit(dict(kernel="dpps_perturb_rows", shape=name, n=n, d_s=d_s,
                  copy_yardstick="torch.add(s, eps, out=o)",
                  ms=cuda_ms(lambda: torch.add(s, eps, out=out), iters)))
        del s, eps, out, base
        torch.cuda.empty_cache()


SECTIONS = {"flash": sweep_flash, "spmm": sweep_spmm, "l1": sweep_l1,
            "mix": sweep_mix, "perturb": sweep_perturb}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="also append lines here")
    parser.add_argument("--only", nargs="+", choices=tuple(SECTIONS),
                        default=tuple(SECTIONS), help="sections to run")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sweep: no CUDA card is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    sink = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")

    emit(dict(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()))
    for name in args.only:
        SECTIONS[name](dev, emit)
    if sink is not None:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
