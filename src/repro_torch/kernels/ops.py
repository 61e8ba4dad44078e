"""Wrappers of the hand-written CUDA kernels.

For a tensor on the CPU each wrapper returns its plain version from
:mod:`repro_torch.kernels.ref`; for a CUDA tensor it launches the kernel
(built on first use by :mod:`repro_torch.kernels.build`) or raises. It never
falls back. A wrapper checks device, dtype, shape and contiguity, allocates
its outputs and scratch with ``torch.empty``, launches on the current
stream, raises if the C function reports a CUDA error, and adds one to its
``launches`` count (read with :func:`launch_counts`).

:func:`l1_clip_tree` and :func:`laplace_noise_tree` are the tree-level ops
over them, the counterparts of ``repro.kernels.ops.l1_clip_tree`` and
``laplace_noise_tree``. :func:`l1_norm_tree`, :func:`dpps_perturb_tree` and
:func:`laplace_noise_like` are the pytree runtime's entry points (the
counterparts of ``repro/kernels/ops.py:65-181``): one launch of the row
kernel a leaf, each leaf's flat (N, size) rows passed as a view where they
are contiguous, 16-byte aligned and ``size % 4 == 0``, else padded to a
multiple of 4 columns in one copy (:func:`leaf_rows`).

On meta tensors (a dry run, :mod:`repro_torch.launch.op_analysis`) a
wrapper checks its inputs as on the card, returns empty outputs of the
kernel's shape and dtype, and charges the active cost count the launch
the card would make, with its kernel's FLOPs and bytes
(:func:`kernel_cost`, the reckoning of each kernel's bound in ``PERF.md``
§6): the count's ``launches`` holds them, and ``launches`` here counts
only what a card ran. A meta tensor holds no data, so this computes
nothing and stands in for nothing that runs.
:func:`flash_attention` (the (H, S, D) layout of the Pallas kernel) and :func:`flash_attention_bshd` (the model's (B, S, H, D)
layout, counterpart of ``repro.kernels.ops.flash_attention_bshd``) launch
one kernel and share its count, under ``flash_attention``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import loops
from repro_torch.core.packing import LANE, PackedLayout
from repro_torch.core.tree_utils import (PyTree, counted_part, tree_leaves,
                                         tree_map)
from repro_torch.kernels import build, ref

__all__ = ["l1_norm_rows", "dpps_perturb_rows", "pushsum_mix", "spmm",
           "clip_scale_rows", "laplace_from_bits", "l1_clip_tree",
           "laplace_noise_tree", "l1_norm_tree", "dpps_perturb_tree",
           "noise_l1_rows", "noise_l1_tree",
           "laplace_noise_like", "leaf_rows", "leaf_out", "flash_attention", "flash_attention_bshd",
           "launch_counts", "reset_launch_counts",
           "spmm_plan", "l1_plan",
           "mix_plan", "perturb_plan", "flash_geometry", "flash_strides",
           "MIX_TEMPLATE_NODES", "MIX_TILES", "MAX_SPMM_NODES", "FLASH_TILES",
           "FLASH_HEAD_DIMS", "kernel_cost", "visible_pairs"]

MAX_SPMM_NODES = 2 ** 31 - 1  # csrc/spmm.cu: idx is int32

# csrc/pushsum_mix.cu: N <= MIX_TEMPLATE_NODES takes the kernel with N as a
# template parameter (one column a thread); larger N the tiled kernel at one
# of MIX_TILES: name -> (BM, BN, TM, TN, BK, STAGES), a block's BM x BN
# outputs, a thread's TM x TN, BK senders a stage, STAGES stages in the
# cp.async ring (the C file's REPRO_MIX_TILES, which refuses any other).
# mix_plan: D <= MIX_NARROW_D takes the narrow tile; N <= MIX_ONE_ROW_TILE
# the 64-row tile (x read from device memory once); else the first of
# MIX_WIDE_TILES with a tile for each SM, or the last. From
# repro_torch.kernels.sweep.
MIX_TEMPLATE_NODES = 32
MIX_TILES = {
    "128x128": (128, 128, 8, 8, 16, 3),
    "64x128": (64, 128, 4, 8, 16, 4),
    "32x64": (32, 64, 4, 4, 64, 3),
    "16x8": (16, 8, 1, 1, 128, 4),
}
MIX_NARROW_D = 8
MIX_ONE_ROW_TILE = 64
MIX_WIDE_TILES = ("128x128", "64x128", "32x64")

# csrc/dpps_perturb.cu launch plan (perturb_plan), from
# repro_torch.kernels.sweep: rows of at most PERTURB_SHORT_QUADS quads
# (d_pad / 4) take PERTURB_ROW_LANES lanes a row, several rows a block;
# longer rows blocks of PERTURB_QUADS_PER_BLOCK quads
PERTURB_THREADS = 256
PERTURB_QUADS_PER_BLOCK = 2048
PERTURB_SHORT_QUADS = 256
PERTURB_ROW_LANES = 16

# csrc/l1_norm.cu launch plan (l1_plan), from repro_torch.kernels.sweep
L1_THREADS = 256
L1_QUADS_PER_BLOCK = 2048  # 8 float4 loads a thread

# csrc/spmm.cu launch plan (spmm_plan)
SPMM_STAGE_BYTES = 16 * 1024  # a ring slot: N rows of one column tile
SPMM_STAGES = 3               # ring slots (csrc/spmm.cu kSpmmStages)
SPMM_TABLE_BYTES = 32 * 1024  # the (N, K) slot table in shared memory
SPMM_BLOCKS_PER_SM = 8        # at most, persistent column-tile blocks
SPMM_THREADS = 256
SPMM_MAX_TILE = 512
SM_SMEM_BYTES = 233_472       # shared memory of an SM, 1 KB a block reserved

# csrc/flash_attention.cu tiles, for each head dim D: (BQ query rows a block,
# BK key rows a tile, DSPLIT warps sharing a group of 16 rows, each owning
# D / DSPLIT columns). The C function has one instantiation of each entry
# and refuses any other tile.
FLASH_TILES = {64: (64, 32, 1), 112: (64, 32, 2), 128: (64, 64, 2),
               256: (64, 16, 2)}
FLASH_HEAD_DIMS = tuple(FLASH_TILES)
FLASH_STAGES = 2  # the K/V ring of csrc/flash_attention.cu


def _is_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version), False for CUDA tensors or
    meta ones (the kernel, or its meta path); mixed devices raise."""
    devices = {t.device.type for t in tensors}
    if devices <= {"cuda"} or devices == {"meta"}:
        return False
    if devices != {"cpu"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {devices}")
    return True


def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal sequence of length s sees under a
    sliding ``window`` (-1: global): sum over rows i of min(i + 1, window)."""
    if window < 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def kernel_cost(kernel: str, **dims) -> tuple[float, float]:
    """(f32 FLOPs, bytes) of one launch of ``kernel``, the reckoning of its
    bound: each input read once, each output written once; the operations
    as ``chip_smoke.py`` counts them (the perturbation's 25 int32 Philox
    operations an element are not FLOPs and are left out). ``dims``: ``n``,
    ``d_s``, ``d_pad`` for the row kernels (and ``bits`` for the
    perturbation's bits-in variant, which reads them); ``n`` senders,
    ``d`` (and ``k`` slots) for the mixes, with ``b`` receivers (a row
    block; default ``n``); ``m`` for the Laplace draw; ``b``, ``s``,
    ``h``, ``kh``, ``d``, ``window`` for flash attention (4 D FLOPs a
    visible pair and head)."""
    g = dims.get
    if kernel == "l1_norm_rows":
        return 2.0 * g("n") * g("d_s"), 4.0 * g("n") * g("d_s") + 4 * g("n")
    if kernel in ("dpps_perturb_rows", "noise_l1_rows"):
        n, d_s = g("n"), g("d_s")
        nbytes = 8.0 * n * d_s + 4.0 * n * g("d_pad") + 8 * n + 4
        return 17.0 * n * d_s, nbytes + (4.0 * n * d_s if g("bits") else 0)
    if kernel == "pushsum_mix":
        n, d = g("n"), g("d")
        b = g("b") or n
        return 2.0 * b * n * d, 4.0 * (n + b) * d + 4.0 * b * n
    if kernel == "spmm":
        n, d, k = g("n"), g("d"), g("k")
        b = g("b") or n
        return 2.0 * b * k * d, 4.0 * (n + b) * d + 8.0 * b * k
    if kernel == "clip_scale_rows":
        return 1.0 * g("n") * g("d_s"), 8.0 * g("n") * g("d_pad") + 4 * g("n")
    if kernel == "laplace_from_bits":
        return 25.0 * g("m"), 8.0 * g("m") + 4
    if kernel == "flash_attention":
        b, s, h, kh, d = g("b"), g("s"), g("h"), g("kh"), g("d")
        pairs = visible_pairs(s, g("window")) * b * h
        return 4.0 * d * pairs, 4.0 * (2 * b * s * h * d + 2 * b * s * kh * d)
    raise KeyError(f"unknown kernel {kernel!r}")


def _count(fn, t: torch.Tensor, **dims) -> None:
    """One launch of ``fn``'s kernel on ``t``'s device: counted in
    ``launches`` on the card; on meta tensors charged to the active cost
    count (:func:`repro_torch.core.loops.charge`, whose loop rule may make
    it stand for more)."""
    if t.is_meta:
        loops.charge(fn.__name__, *kernel_cost(fn.__name__, **dims))
    else:
        fn.launches += 1


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           align: bool = False) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if align and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    """The handle of the current stream on ``t``'s card (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a ``Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _device_scale(scale, device: torch.device) -> torch.Tensor:
    """``scale`` as one f32 value on ``device``, for the kernel to read
    through its pointer."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(float(scale), dtype=torch.float32, device=device)
    if scale.numel() != 1 or scale.dtype != torch.float32 \
            or scale.device != device:
        raise ValueError("scale must be one f32 value on the same device")
    return scale.contiguous()


def l1_norm_rows(buf: torch.Tensor, d_s: int) -> torch.Tensor:
    """Per-row L1 norm of ``buf[:, :d_s]`` -> (N,) f32."""
    if _is_cpu(buf):
        return ref.l1_norm_rows(buf, d_s)
    _check(buf, "buf", torch.float32, 2, align=True)
    n, d_pad = buf.shape
    if not (0 < d_s <= d_pad) or d_pad % 4 or n < 1:
        raise ValueError(f"need 0 < d_s <= d_pad, d_pad % 4 == 0 and N >= 1, "
                         f"got N={n}, d_s={d_s}, d_pad={d_pad}")
    out = buf.new_empty((n,))
    if not buf.is_meta:
        plan = l1_plan(n, d_s)
        bpr = plan["blocks_per_row"]
        stream = _stream(buf)
        partials, tickets = _row_scratch("l1_norm", buf, stream, n * bpr, n)
        _raise_on(build.function("l1_norm")(
            buf.data_ptr(), n, d_pad, d_s, plan["threads"], bpr,
            plan["quads_per_block"], partials.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), stream), "l1_norm_rows")
    _count(l1_norm_rows, buf, n=n, d_s=d_s)
    return out


# (kernel, device index, stream handle) -> (partials f32, tickets int32 at
# zero)
_ROW_SCRATCH: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _row_scratch(kernel: str, buf: torch.Tensor, stream: int, partials: int,
                 rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The scratch of a row kernel that finishes its rows through ticket
    counters (``csrc/l1_norm.cu``, ``csrc/dpps_perturb.cu``) on one stream:
    at least ``partials`` floats and ``rows`` ticket counters at zero.

    Such a kernel is right only while its counters start at zero and no two
    launches use one set at once. Eager launches keep one set for each
    (kernel, device, stream handle) between calls: launches on one stream
    run in order, each leaves the counters at zero, and two streams or two
    kernels never share a set (zeroing counters each call cost more host
    time than the launch). A stream handle names one stream for the
    process's life for PyTorch's own streams; a ``torch.cuda.ExternalStream``
    destroyed while a launch on it is pending must not have its handle
    reused for another stream that launches these kernels. A launch
    captured into a CUDA graph gets scratch of its own, allocated in the
    capture and not kept here: the graph zeroes its counters on every
    replay, and a replay never shares counters with eager launches or other
    graphs.
    """
    if torch.cuda.is_current_stream_capturing():
        return (buf.new_empty((partials,)),
                torch.zeros((rows,), dtype=torch.int32, device=buf.device))
    key = (kernel, buf.get_device(), stream)
    have = _ROW_SCRATCH.get(key)
    if have is None or have[0].numel() < partials or have[1].numel() < rows:
        size = max(partials, 0 if have is None else have[0].numel())
        count = max(rows, 0 if have is None else have[1].numel())
        have = (buf.new_empty((size,)),
                torch.zeros((count,), dtype=torch.int32, device=buf.device))
        _ROW_SCRATCH[key] = have
    return have


def l1_plan(n: int, d_s: int) -> dict:
    """The launch of ``csrc/l1_norm.cu`` for the first ``d_s`` columns of N
    rows: ``{"threads", "blocks_per_row", "quads_per_block"}``.

    Block b of a row reads the 16-byte quads [b q, min((b + 1) q, d_s // 4))
    for q = :data:`L1_QUADS_PER_BLOCK`; the last block also reads the d_s %
    4 columns of the ragged tail. No block is empty.
    """
    return dict(threads=L1_THREADS, quads_per_block=L1_QUADS_PER_BLOCK,
                blocks_per_row=max(1, -(-(d_s // 4) // L1_QUADS_PER_BLOCK)))


def _launch_columns(col0: int, col_map) -> tuple[int, int, int]:
    """(col0, run, stride) as ``csrc/dpps_perturb.cu`` takes them: the map's
    ``off`` folded into ``col0``, run 0 for contiguous columns."""
    if col_map is None:
        return col0, 0, 0
    c0, run, stride, off = (int(v) for v in col_map)
    if min(c0, off) < 0 or run < 1 or stride < run or off + run > stride:
        raise ValueError(f"column map {tuple(col_map)}: need col0, off >= "
                         "0, 1 <= run <= stride and off + run <= stride")
    if run == stride:
        return c0 + off, 0, 0
    if run < 4:
        raise ValueError(f"column map {tuple(col_map)}: the kernel takes "
                         "runs of at least 4 elements")
    return c0 + off, run, stride


def dpps_perturb_rows(s: torch.Tensor, eps: torch.Tensor, scale,
                      gamma_n: float, d_s: int, *,
                      bits: torch.Tensor | None = None,
                      seed: int | None = None, t: int | None = None,
                      col0: int = 0, node0: int = 0, col_map=None):
    """Fused ``s + eps + gamma_n Lap(scale)`` over (N, d_pad) rows.

    Returns ``(s_noise (N, d_pad), eps_l1 (N,), noise_l1 (N,))``. ``bits``
    (N, d_s) uint32 selects the bits-in variant; otherwise the Philox
    variant draws the bits of ``(seed, t)`` in the kernel, at wire columns
    ``[col0, col0 + d_s)`` (a leaf that starts at column ``col0`` of the
    wire row; 0 for the packed row) of global nodes ``[node0, node0 + N)``
    (a rank's row block; 0 for the whole network). ``col_map`` (a
    :class:`repro_torch.kernels.ref.ColumnMap`, replacing ``col0``) draws
    instead at its columns: a rank's block of a model-sharded leaf, whose
    elements are a strided set of the whole leaf's columns. On CUDA
    ``scale`` is a 0-d f32 device tensor, read by the kernel through its
    pointer.
    """
    if bits is None and (seed is None or t is None):
        raise ValueError("pass bits= or both seed= and t=")
    if col0 < 0 or node0 < 0:
        raise ValueError(f"col0={col0} and node0={node0} must be >= 0")
    if _is_cpu(s, eps, *([bits] if bits is not None else [])):
        return ref.dpps_perturb_rows(s, eps, scale, gamma_n, d_s, bits=bits,
                                     seed=seed, t=t, col0=col0, node0=node0,
                                     col_map=col_map)
    col0, run, stride = _launch_columns(col0, col_map)
    if run and s.shape[1] >= 2 ** 31:
        raise ValueError("the kernel takes a column map over rows of fewer "
                         "than 2^31 elements")
    out = _perturb_launch(s, eps, scale, gamma_n, d_s, bits=bits, seed=seed,
                          t=t, col0=col0, node0=node0, run=run, stride=stride)
    if run and bits is None and not s.is_meta:
        dpps_perturb_rows.mapped_launches += 1
    _count(dpps_perturb_rows, s, n=s.shape[0], d_s=d_s, d_pad=s.shape[1],
           bits=bits is not None)
    return out


def noise_l1_rows(noise: torch.Tensor, d_s: int) -> torch.Tensor:
    """Per-row L1 norm of the first ``d_s`` columns of (N, d_pad) noise
    rows, summed in ``csrc/dpps_perturb.cu``'s order: one launch of that
    kernel with the noise as its perturbation and a zero noise scale (its
    eps norm; the drawn noise and the (N, d_pad) output are thrown away).
    A noise row drawn outside the fused perturbation (an audit mechanism's)
    then has the norm the fused draw gives the same row, bit for bit. Its
    launches are counted apart from the perturbations."""
    if _is_cpu(noise):
        return ref.l1_norm_rows(noise, d_s)
    zero = torch.zeros((), dtype=torch.float32, device=noise.device)
    norm = _perturb_launch(noise, noise, zero, 0.0, d_s, bits=None, seed=0,
                           t=0, col0=0, node0=0)[1]
    _count(noise_l1_rows, noise, n=noise.shape[0], d_s=d_s,
           d_pad=noise.shape[1])
    return norm


def _perturb_launch(s, eps, scale, gamma_n, d_s, *, bits, seed, t, col0,
                    node0, run=0, stride=0):
    """One launch of ``csrc/dpps_perturb.cu`` (see :func:`dpps_perturb_rows`;
    ``run`` 0: contiguous columns from ``col0``, else element j at column
    ``col0 + (j // run) * stride + j % run``)."""
    _check(s, "s", torch.float32, 2, align=True)
    _check(eps, "eps", torch.float32, 2, align=True)
    n, d_pad = s.shape
    if eps.shape != s.shape:
        raise ValueError(f"eps {tuple(eps.shape)} != s {tuple(s.shape)}")
    if not (0 < d_s <= d_pad) or d_pad % 4:
        raise ValueError(f"need 0 < d_s <= d_pad and d_pad % 4 == 0, got "
                         f"d_s={d_s}, d_pad={d_pad}")
    if bits is not None:
        _check(bits, "bits", torch.uint32, 2)
        if tuple(bits.shape) != (n, d_s):
            raise ValueError(f"bits {tuple(bits.shape)} != {(n, d_s)}")
    scale = _device_scale(scale, s.device)
    if not (0 <= int(t if t is not None else 0) < 2 ** 32):
        raise ValueError(f"round t={t} out of the uint32 counter range")
    if node0 + n > 2 ** 32:
        raise ValueError(f"nodes [{node0}, {node0 + n}) out of the uint32 "
                         "counter range")
    out = torch.empty_like(s)
    eps_l1, noise_l1 = s.new_empty((n,)), s.new_empty((n,))
    if s.is_meta:
        return out, eps_l1, noise_l1
    plan = perturb_plan(n, d_pad)
    bpr = plan["blocks_per_row"]
    stream = _stream(s)
    partials = tickets = None
    if bpr > 1:
        partials, tickets = _row_scratch("dpps_perturb", s, stream,
                                         2 * n * bpr, n)
    _raise_on(build.function("dpps_perturb")(
        s.data_ptr(), eps.data_ptr(),
        bits.data_ptr() if bits is not None else None,
        scale.data_ptr(), float(gamma_n), n, d_pad, d_s,
        int(seed or 0) & 0xFFFFFFFFFFFFFFFF, int(t or 0), int(col0),
        int(run), int(stride), int(node0), plan["threads"],
        plan["rows_per_block"], plan["quads_per_block"], bpr,
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(), out.data_ptr(),
        eps_l1.data_ptr(), noise_l1.data_ptr(), stream), "dpps_perturb_rows")
    return out, eps_l1, noise_l1


def perturb_plan(n: int, d_pad: int) -> dict:
    """The launch of ``csrc/dpps_perturb.cu`` for N rows of ``d_pad``
    columns: ``{"threads", "rows_per_block", "quads_per_block",
    "blocks_per_row", "blocks"}``.

    Rows of at most :data:`PERTURB_SHORT_QUADS` quads: ``rows_per_block``
    rows a block of :data:`PERTURB_THREADS`, :data:`PERTURB_ROW_LANES`
    lanes a row, each block writing whole rows (``quads_per_block`` the
    row's quads, one block a row). Longer rows: one row a block, block b of
    a row writing quads [b q, min((b + 1) q, d_pad // 4)) for q =
    :data:`PERTURB_QUADS_PER_BLOCK`; no block is empty. The plan never
    changes ``s_noise``: each quad's value depends on its row and index
    only.
    """
    quads = d_pad // 4
    if quads <= PERTURB_SHORT_QUADS:
        rows = PERTURB_THREADS // PERTURB_ROW_LANES
        return dict(threads=PERTURB_THREADS, rows_per_block=rows,
                    quads_per_block=quads, blocks_per_row=1,
                    blocks=-(-n // rows))
    bpr = -(-quads // PERTURB_QUADS_PER_BLOCK)
    return dict(threads=PERTURB_THREADS, rows_per_block=1,
                quads_per_block=PERTURB_QUADS_PER_BLOCK, blocks_per_row=bpr,
                blocks=n * bpr)


def pushsum_mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``W @ x`` for W (B, N) and x (N, D), any N >= 1, 1 <= B <= N and D
    >= 1, f32 accumulation -> (B, D). B = N mixes the whole network; B < N
    a row block of receivers (a rank of the sharded engine against the
    gathered senders). Each output is one fma chain over the senders in
    increasing order, whichever kernel :func:`mix_plan` picks, so a row
    block gives the same rows of the whole mix bit for bit."""
    if _is_cpu(w, x):
        return ref.pushsum_mix(w, x)
    _check(w, "w", torch.float32, 2)
    _check(x, "x", torch.float32, 2)
    n, d = x.shape
    b = w.shape[0]
    if w.shape[1] != n or not 1 <= b <= n or d < 1:
        raise ValueError(f"need w (B, N) for x (N, D) with 1 <= B <= N and "
                         f"D >= 1, got w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}")
    out = x.new_empty((b, d))
    if not x.is_meta:
        plan = mix_plan(n, d, _sm_count(x.device), rows=b)
        _raise_on(build.function("pushsum_mix")(
            w.data_ptr(), x.data_ptr(), out.data_ptr(), b, n, d,
            *plan["args"], _stream(x)), "pushsum_mix")
    _count(pushsum_mix, x, n=n, d=d, b=b)
    return out


def mix_plan(n: int, d: int, sms: int, tile: str | None = None,
             rows: int | None = None) -> dict:
    """The launch of ``csrc/pushsum_mix.cu`` for W (B, N) and x (N, D) on a
    card with ``sms`` SMs, B = ``rows`` (default N): ``{"kernel", "tile",
    "threads", "tiles", "smem_bytes", "args"}`` (``tiles``: output tiles,
    each a block's walk over the senders; ``args``: the C function's tile
    arguments, BM, BN, TM, TN, BK, STAGES and the dynamic shared memory).
    A row block's tile follows the same rule with its B rows counted in
    the tiles; no tile changes a bit of the output.

    N <= :data:`MIX_TEMPLATE_NODES`: ``"template"``, one column a thread in
    blocks of 256, a block for each 256 columns (the tile arguments all 0).
    Larger N: ``"tiles"`` at ``tile`` where given (any name of
    :data:`MIX_TILES`), else by the rule above :data:`MIX_TILES`. A block
    for each tile of BM rows x BN columns, numbered row tile fastest where
    D >= N (the blocks that share a column tile of x run together), else
    column tile fastest (those that share a row tile of W).
    """
    if n <= MIX_TEMPLATE_NODES:
        return dict(kernel="template", tile=None, threads=256,
                    tiles=-(-d // 256), smem_bytes=0, args=(0,) * 7)

    def tiles(name):
        bm, bn = MIX_TILES[name][:2]
        return -(-(rows or n) // bm) * -(-d // bn)

    if tile is None:
        if d <= MIX_NARROW_D:
            tile = "16x8"
        elif n <= MIX_ONE_ROW_TILE:
            tile = "64x128"
        else:
            tile = next((t for t in MIX_WIDE_TILES if tiles(t) >= sms),
                        MIX_WIDE_TILES[-1])
    bm, bn, tm, tn, bk, stages = MIX_TILES[tile]
    smem = stages * (bm * (bk + 4) + bk * bn) * 4
    return dict(kernel="tiles", tile=tile, threads=(bm // tm) * (bn // tn),
                tiles=tiles(tile), smem_bytes=smem,
                args=(bm, bn, tm, tn, bk, stages, smem))


def spmm(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Padded-CSR mix ``out[i] = sum_k vals[i, k] x[idx[i, k]]`` -> (B, D).

    ``idx`` (B, K) int32 with entries in [0, N) (``core.topology.
    padded_csr`` builds them; the kernel does not check the range),
    ``vals`` (B, K) f32, ``x`` (N, D) f32 with D % 4 == 0, 1 <= B <= N:
    B = N the whole network, B < N a row block of receivers (a rank of the
    sharded engine), whose outputs are the same rows of the whole mix bit
    for bit."""
    if _is_cpu(idx, vals, x):
        return ref.spmm(idx, vals, x)
    _check(idx, "idx", torch.int32, 2)
    _check(vals, "vals", torch.float32, 2)
    _check(x, "x", torch.float32, 2, align=True)
    n, d = x.shape
    k = idx.shape[1]
    b = idx.shape[0]
    if tuple(vals.shape) != tuple(idx.shape) or not 1 <= b <= n or k < 1:
        raise ValueError(f"need idx, vals (B, K) for x (N, D), 1 <= B <= N, "
                         f"got idx "
                         f"{tuple(idx.shape)}, vals {tuple(vals.shape)}, x "
                         f"{tuple(x.shape)}")
    if not (1 <= n <= MAX_SPMM_NODES) or d < 4 or d % 4:
        raise ValueError(f"need 1 <= N <= {MAX_SPMM_NODES} and D % 4 == 0, "
                         f"got x {tuple(x.shape)}")
    out = x.new_empty((b, d))
    if not x.is_meta:
        plan = spmm_plan(n, k, d, _sm_count(x.device), rows=b)
        _raise_on(build.function("spmm")(
            idx.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(), b,
            n, k, d, plan["tile"], plan["stages"], plan["threads"],
            plan["blocks"], plan["smem_bytes"], _stream(x)), "spmm")
    _count(spmm, x, n=n, d=d, k=k, b=b)
    return out


def spmm_plan(n: int, k: int, d: int, sms: int,
              rows: int | None = None) -> dict:
    """The launch of ``csrc/spmm.cu`` for K slots a row of B = ``rows``
    receivers (default N) over x (N, D) on a card with ``sms`` SMs:
    ``{"regime", "tile", "stages", "threads", "blocks", "smem_bytes"}``.

    The tile is the largest power of two <= 512 with N * tile * 4 bytes <=
    :data:`SPMM_STAGE_BYTES`. Column tiles (``"tiles"``) where such a tile
    of at least 4 columns exists (N <= 1024), the row holds at least one
    tile for each SM (D >= sms * tile) and the slot table (B rows of K
    rounded up to 4 slots, 8 bytes a slot) fits in
    :data:`SPMM_TABLE_BYTES`: as many persistent blocks of 256 threads as
    the tiles, the SMs' shared memory and :data:`SPMM_BLOCKS_PER_SM` allow,
    each streaming its tiles through a ring of :data:`SPMM_STAGES` slots.
    Otherwise rows (``"rows"``, tile 0): one thread a (receiver row,
    4 columns), the block halved from 256 threads (to 32 at least) until
    the grid has a block for each SM. The ring holds all N senders whatever
    B is; no regime changes a bit of the output.
    """
    b = n if rows is None else rows
    tile = SPMM_MAX_TILE
    while tile > 4 and n * tile * 4 > SPMM_STAGE_BYTES:
        tile //= 2
    n_tiles = -(-d // tile)
    table = 8 * b * (-(-k // 4) * 4)
    smem = SPMM_STAGES * n * tile * 4 + table
    if (n * tile * 4 <= SPMM_STAGE_BYTES and n_tiles >= sms
            and table <= SPMM_TABLE_BYTES):
        per_sm = min(SPMM_BLOCKS_PER_SM, SM_SMEM_BYTES // (smem + 1024))
        return dict(regime="tiles", tile=tile, stages=SPMM_STAGES,
                    threads=SPMM_THREADS, blocks=min(n_tiles, per_sm * sms),
                    smem_bytes=smem)
    items = b * (d // 4)
    threads = SPMM_THREADS
    while threads > 32 and -(-items // threads) < sms:
        threads //= 2
    return dict(regime="rows", tile=0, stages=0, threads=threads,
                blocks=-(-items // threads), smem_bytes=0)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def clip_scale_rows(buf: torch.Tensor, d_s: int,
                    denom: torch.Tensor) -> torch.Tensor:
    """Row i of ``buf[:, :d_s]`` divided by ``denom[i]``, pad columns 0 ->
    (N, d_pad)."""
    if _is_cpu(buf, denom):
        return ref.clip_scale_rows(buf, d_s, denom)
    _check(buf, "buf", torch.float32, 2, align=True)
    _check(denom, "denom", torch.float32, 1)
    n, d_pad = buf.shape
    if not (0 < d_s <= d_pad) or d_pad % 4 or denom.shape[0] != n:
        raise ValueError(f"need 0 < d_s <= d_pad, d_pad % 4 == 0 and denom "
                         f"(N,), got d_s={d_s}, buf {tuple(buf.shape)}, "
                         f"denom {tuple(denom.shape)}")
    out = torch.empty_like(buf)
    if not buf.is_meta:
        _raise_on(build.function("clip_scale")(
            buf.data_ptr(), denom.data_ptr(), n, d_pad, d_s, out.data_ptr(),
            _stream(buf)), "clip_scale_rows")
    _count(clip_scale_rows, buf, n=n, d_s=d_s, d_pad=d_pad)
    return out


def laplace_from_bits(bits: torch.Tensor, scale) -> torch.Tensor:
    """Laplace(0, scale) from flat (M,) uint32 bits -> (M,) f32. On CUDA
    ``scale`` is a 0-d f32 device tensor (a float is moved there)."""
    if _is_cpu(bits):
        return ref.laplace_from_bits(bits, scale)
    _check(bits, "bits", torch.uint32, 1, align=True)
    scale = _device_scale(scale, bits.device)
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    if bits.numel() == 0:
        return out
    if not bits.is_meta:
        _raise_on(build.function("laplace_noise")(
            bits.data_ptr(), scale.data_ptr(), bits.numel(), out.data_ptr(),
            _stream(bits)), "laplace_from_bits")
    _count(laplace_from_bits, bits, m=bits.numel())
    return out


def l1_clip_tree(tree: PyTree, clip: float) -> tuple[PyTree, torch.Tensor]:
    """Per-node L1 clip (paper Eq. 24) of a node-stacked tree.

    Packs the tree into the (N, d_pad) buffer at lane 128, takes the
    per-node norms with :func:`l1_norm_rows`, ``denom = max(1, norm /
    clip)`` on the device, scales the rows with :func:`clip_scale_rows`
    and unpacks. Returns (clipped tree, pre-clip norms (N,)).
    """
    layout = PackedLayout.from_tree(tree, lane=LANE)
    buf = layout.pack(tree)
    norms = l1_norm_rows(buf, layout.d_s)
    denom = torch.clamp_min(norms / clip, 1.0)
    return layout.unpack(clip_scale_rows(buf, layout.d_s, denom)), norms


def laplace_noise_tree(bits_tree: PyTree, scale) -> PyTree:
    """Laplace(0, scale) noise shaped like ``bits_tree``: one uint32 bit
    tensor per leaf, one launch of :func:`laplace_from_bits` per leaf.
    The tree noise entry points are here: :func:`laplace_noise_like` draws
    one leaf's noise from bits or from the Philox bits of its wire columns,
    and :func:`dpps_perturb_tree` draws the pytree runtime's noise inside
    the fused perturbation, at each leaf's ``col0``."""
    device = tree_leaves(bits_tree)[0].device
    if device.type == "cuda":  # one device scalar for every leaf
        scale = _device_scale(scale, device)
    return tree_map(lambda b: laplace_from_bits(
        b.contiguous().reshape(-1), scale).reshape(b.shape), bits_tree)


def leaf_rows(x: torch.Tensor) -> torch.Tensor:
    """A node-stacked leaf's flat (N, size) rows as the row kernels take
    them: a view where they are contiguous, 16-byte aligned and ``size %
    4 == 0``; else one copy padded with zeros to a multiple of 4 columns.
    A bf16 or f16 leaf is copied to f32 rows first, as the reference's
    kernels compute a half-precision leaf in f32."""
    n, size = x.shape[0], x[0].numel()
    rows = x.reshape(n, size)
    if rows.dtype in (torch.bfloat16, torch.float16):
        rows = rows.float()
    if size % 4 == 0 and rows.is_contiguous() and rows.data_ptr() % 16 == 0:
        return rows
    out = rows.new_zeros((n, -(-size // 4) * 4))
    out[:, :size] = rows
    return out


def leaf_out(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A kernel's (B, d_pad) rows of leaf ``x`` (from :func:`leaf_rows`;
    B = N, or a row block's receivers) back in its row shape (a copy only
    where the rows were padded)."""
    size = x[0].numel()
    if out.shape[1] != size:
        out = out[:, :size].contiguous()
    return out.reshape((out.shape[0],) + tuple(x.shape[1:]))


def l1_norm_tree(leaves, counted=None) -> torch.Tensor:
    """Per-node L1 norms of node-stacked leaves -> (N,): one
    :func:`l1_norm_rows` launch a leaf, the norms summed in leaf order.
    ``counted`` (one entry a leaf, ``core.tree_utils.counted_part``'s;
    default all) leaves out the columns another rank of a model axis
    counts: a leaf it counts none of (or an empty one) is not launched,
    one it counts in part launches on a copy of that part."""
    if _is_cpu(*leaves):
        return ref.l1_norm_tree(leaves, counted)
    total = None
    for i, x in enumerate(leaves):
        part = counted_part(x, None if counted is None else counted[i])
        if part is None:
            norm = x.new_zeros((x.shape[0],), dtype=torch.float32)
        else:
            norm = l1_norm_rows(leaf_rows(part), part[0].numel())
        total = norm if total is None else total + norm
    return total


def dpps_perturb_tree(s_leaves, eps_leaves, scale, gamma_n: float, *,
                      bits=None, seed: int | None = None,
                      t: int | None = None, node0: int = 0, col_maps=None,
                      counted=None):
    """The fused perturbation over node-stacked leaves: one
    :func:`dpps_perturb_rows` launch a leaf -> (s_noise leaves, eps_l1
    (N,), noise_l1 (N,)), the norms summed in leaf order. ``bits`` is one
    uint32 tensor a leaf (its leaf's shape); otherwise leaf i draws in the
    kernel the Philox bits of its wire columns, ``col0`` its first column
    (``ref.leaf_columns``), so the launches draw the bits one launch over
    the packed row draws; or, with ``col_maps``, at ``col_maps[i]`` (a
    rank's shards of a model-sharded tree, each drawing the whole leaf's
    bits at its columns); the rows are global nodes ``node0``, ``node0 +
    1``, ... (:func:`dpps_perturb_rows`). ``counted`` (one entry a leaf,
    ``core.tree_utils.counted_part``'s; default all) leaves out of the
    norms the columns another rank counts: a leaf counted in part takes
    its norms from a second launch over a copy of that part (the same
    Philox columns, ``ref.counted_map``). An empty leaf (a rank without
    heads) launches nothing."""
    if bits is None and (seed is None or t is None):
        raise ValueError("pass bits= or both seed= and t=")
    extra = [] if bits is None else list(bits)
    if _is_cpu(*s_leaves, *eps_leaves, *extra):
        return ref.dpps_perturb_tree(s_leaves, eps_leaves, scale, gamma_n,
                                     bits=bits, seed=seed, t=t, node0=node0,
                                     col_maps=col_maps, counted=counted)
    scale = _device_scale(scale, s_leaves[0].device)
    out, eps_l1, noise_l1 = [], None, None
    maps = ref.tree_column_maps(s_leaves, col_maps)

    def launch(x, e, b, cmap):
        size = x[0].numel()
        b = None if b is None else b.reshape(x.shape[0], size).contiguous()
        return dpps_perturb_rows(leaf_rows(x), leaf_rows(e), scale, gamma_n,
                                 size, bits=b, seed=seed, t=t, node0=node0,
                                 col_map=cmap)

    for i, (x, e, cmap) in enumerate(zip(s_leaves, eps_leaves, maps)):
        keep = None if counted is None else counted[i]
        zero = x.new_zeros((x.shape[0],), dtype=torch.float32)
        if x[0].numel() == 0:
            out.append(x.clone())
            e1 = n1 = zero
        else:
            sn, e1, n1 = launch(x, e, None if bits is None else bits[i],
                                cmap)
            out.append(leaf_out(sn, x))
            if keep is False:
                e1 = n1 = zero
            elif isinstance(keep, slice):
                _, e1, n1 = launch(
                    x[..., keep], e[..., keep],
                    None if bits is None else bits[i][..., keep],
                    ref.counted_map(cmap, keep))
        eps_l1 = e1 if eps_l1 is None else eps_l1 + e1
        noise_l1 = n1 if noise_l1 is None else noise_l1 + n1
    return out, eps_l1, noise_l1


def noise_l1_tree(leaves) -> torch.Tensor:
    """Per-node L1 norms of node-stacked noise leaves -> (N,), in the fused
    perturbation's order: one :func:`noise_l1_rows` launch a leaf, summed
    in leaf order, as :func:`dpps_perturb_tree` sums its norms."""
    if _is_cpu(*leaves):
        return ref.l1_norm_tree(leaves)
    total = None
    for x in leaves:
        norm = noise_l1_rows(leaf_rows(x), x[0].numel())
        total = norm if total is None else total + norm
    return total


def laplace_noise_like(x: torch.Tensor, scale, *,
                       bits: torch.Tensor | None = None,
                       seed: int | None = None, t: int | None = None,
                       col0: int = 0) -> torch.Tensor:
    """Laplace(0, scale) shaped like the node-stacked leaf ``x``, one
    :func:`laplace_from_bits` launch: from ``bits`` (x's shape, uint32), or
    from the Philox bits of wire columns ``[col0, col0 + size)`` of each
    node's row in round ``t`` (``ref.philox_bits``, the bits the
    perturbation kernel draws there). The counterpart of
    ``repro.kernels.ops.laplace_noise_like``, which takes a key."""
    if bits is None and (seed is None or t is None):
        raise ValueError("pass bits= or both seed= and t=")
    if _is_cpu(x, *([bits] if bits is not None else [])):
        return ref.laplace_noise_like(x, scale, bits=bits, seed=seed, t=t,
                                      col0=col0)
    if bits is None:
        bits = ref.philox_bits(seed, t, x.shape[0], col0,
                               col0 + x[0].numel(), device=x.device)
        bits = bits.to(torch.uint32)
    return laplace_from_bits(bits.contiguous().reshape(-1),
                             scale).reshape(x.shape)


def _flash_window(window) -> int:
    """The window as the kernel takes it: -1 for global (``None`` or < 0),
    else a positive int."""
    if window is None:
        return -1
    window = int(window)
    if window == 0:
        raise ValueError("window must be >= 1, or None / < 0 for global")
    return max(window, -1)


def _flash_heads(h: int, kh: int, group: int | None, head0: int) -> tuple:
    """(group, head0) of ``h`` query heads over ``kh`` KV heads, query head
    i reading KV head (head0 + i) // group: ``group`` None is H / K (which
    must divide), one KV head is read as a group of all ``h``; a
    ``ValueError`` unless the heads read exactly KV heads [0, kh)."""
    if group is None:
        if kh < 1 or h % kh:
            raise ValueError(f"{h} query heads over {kh} KV heads: pass "
                             "group= and head0=, or H % K == 0")
        group = h // kh
    if kh == 1 and h >= 1 and head0 + h <= group:
        return h, 0
    if group < 1 or head0 < 0 or (h and (head0 >= group or (
            head0 + h - 1) // group != kh - 1)):
        raise ValueError(f"{h} query heads from head {head0} of the groups "
                         f"of {kh} KV heads x {group}: they must read "
                         "exactly those KV heads")
    return group, head0


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  b: int, s: int, h: int, kh: int, d: int, q_strides: tuple,
                  k_strides: tuple, window: int, group: int,
                  head0: int = 0) -> torch.Tensor:
    """One launch of ``csrc/flash_attention.cu`` for contiguous q, k, v whose
    (batch, position, head) element strides are given; o is laid out as q.
    Query head i reads KV head (``head0`` + i) // ``group``. No heads: no
    launch (an empty output)."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, torch.float32, q.dim(), align=True)
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {FLASH_HEAD_DIMS}")
    if v.shape != k.shape:
        raise ValueError(f"need k, v of one shape, got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if not q.is_meta:
        geo = flash_geometry(b, s, h, d)
        _raise_on(build.function("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
            kh, group, head0, d, *q_strides, *k_strides, window, geo["bq"],
            geo["bk"], geo["dsplit"], geo["smem_bytes"], _stream(q)),
            "flash_attention")
    _count(flash_attention, q, b=b, s=s, h=h, kh=kh, d=d, window=window)
    return out


def flash_geometry(b: int, s: int, h: int, d: int) -> dict:
    """The launch of ``csrc/flash_attention.cu`` for B sequences of S
    positions, H query heads of dim D: the tile of :data:`FLASH_TILES`
    (``bq``, ``bk``, ``dsplit``), ``threads`` (a warp for each 16 query rows
    and D slice), ``smem_bytes`` (the two-stage K/V ring at rows of D + 4
    floats, plus the partial scores of every warp where D is split) and
    ``grid`` (query tiles, heads, batch)."""
    bq, bk, dsplit = FLASH_TILES[d]
    warps = bq // 16 * dsplit
    ring = FLASH_STAGES * 2 * bk * (d + 4)
    xch = warps * (bk // 2) * 32 if dsplit > 1 else 0
    return dict(bq=bq, bk=bk, dsplit=dsplit, threads=32 * warps,
                smem_bytes=4 * (ring + xch), grid=(-(-s // bq), h, b))


def flash_strides(layout: str, s: int, h: int, d: int) -> tuple:
    """Element strides (batch, position, head) of a contiguous tensor of
    ``h`` heads in ``layout``: ``"bshd"`` (B, S, H, D), the model's, or
    ``"hsd"`` (H, S, D), the Pallas kernel's (one sequence)."""
    if layout == "bshd":
        return (s * h * d, h * d, d)
    if layout == "hsd":
        return (h * s * d, d, s * d)
    raise ValueError(f"layout {layout!r} is not 'bshd' or 'hsd'")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    group: int = 1, window: int | None = None) -> torch.Tensor:
    """Causal GQA attention, optional sliding ``window`` (``None`` or < 0:
    global), in the Pallas kernel's layout: q (H, S, D), k, v (H // group,
    S, D) -> (H, S, D). Any S; D in :data:`FLASH_HEAD_DIMS` on the card."""
    window = _flash_window(window)
    if _is_cpu(q, k, v):
        return ref.flash_attention(q, k, v, group=group, window=window)
    h, s, d = q.shape
    kh = k.shape[0]
    if h != kh * group or tuple(k.shape) != (kh, s, d):
        raise ValueError(f"need k, v (H // group, S, D) for q {tuple(q.shape)},"
                         f" group {group}; got k {tuple(k.shape)}")
    return _flash_launch(q, k, v, b=1, s=s, h=h, kh=kh, d=d,
                         q_strides=flash_strides("hsd", s, h, d),
                         k_strides=flash_strides("hsd", s, kh, d),
                         window=window, group=group)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window: int | None = None, group: int | None = None,
                         head0: int = 0) -> torch.Tensor:
    """Model-layout flash attention: q (B, S, H, D), k, v (B, S, K, D), rope
    already applied -> (B, S, H, D). One launch for the whole batch, any S
    (the kernel masks the ragged edge; nothing is padded). Query head i
    reads KV head (``head0`` + i) // ``group`` (default H / K, ``head0``
    0): a model axis's rank launches its own run of heads, which may start
    inside a GQA group and end inside another
    (:class:`~repro_torch.models.parallel.HeadShare`); a rank without
    heads launches nothing."""
    window = _flash_window(window)
    b, s, h, d = q.shape
    kh = k.shape[2]
    if tuple(k.shape) != (b, s, kh, d):
        raise ValueError(f"need k, v (B, S, K, D) for q {tuple(q.shape)}; "
                         f"got k {tuple(k.shape)}")
    if h == 0:
        return torch.empty_like(q)
    group, head0 = _flash_heads(h, kh, group, head0)
    if _is_cpu(q, k, v):
        return ref.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            group=group, window=window, head0=head0).transpose(1, 2)
    return _flash_launch(q, k, v, b=b, s=s, h=h, kh=kh, d=d,
                         q_strides=flash_strides("bshd", s, h, d),
                         k_strides=flash_strides("bshd", s, kh, d),
                         window=window, group=group, head0=head0)


# noise_l1_rows launches csrc/dpps_perturb.cu too, counted under its own
# name: a norm, not a perturbation
_KERNELS = (l1_norm_rows, dpps_perturb_rows, noise_l1_rows, pushsum_mix,
            spmm, clip_scale_rows, laplace_from_bits, flash_attention)
for _fn in _KERNELS:
    _fn.launches = 0
# of dpps_perturb_rows' launches, those at a column map's strided columns
dpps_perturb_rows.mapped_launches = 0


def launch_counts() -> dict[str, int]:
    """Each kernel's launches on a card since the last reset (the strided
    perturbations among ``dpps_perturb_rows``' are also in
    ``dpps_perturb_rows.mapped_launches``)."""
    return {fn.__name__: fn.launches for fn in _KERNELS}


def reset_launch_counts() -> None:
    for fn in _KERNELS:
        fn.launches = 0
    dpps_perturb_rows.mapped_launches = 0
