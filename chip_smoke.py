#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py               # the whole check, on GPU 0
    python3 chip_smoke.py --out DIR     # also write the compiler's report there

Phases, each printing one JSON line:

1. ``build``      compile the three kernels (one nvcc each, in parallel).
2. ``kernels``    each kernel against its plain PyTorch version at the main
                  path's two shapes: the paper MLP's shared layer (N = 10,
                  d_s = 7840) and the full-width consensus buffer (N = 5,
                  d_s = 505,956,352), plus the Philox noise statistics.
3. ``consensus``  ``Session.build(DOutGraph(5, 2), schedule="dense")`` then
                  20 rounds over a (5, 505,956,352) f32 buffer: ms a round
                  and the consensus error of every round.
4. ``training``   PartPSP on the paper MLP (N = 10, 2-out, partpsp-1), 50
                  steps.
5. ``agreement``  the same seeded consensus and training runs on the card
                  (kernels) and on the CPU (plain versions) agree.

Each kernel counts its launches. The counts are set to 0 just before
phases 3 and 4, which are the main path, and read just after; a kernel
that the main path did not launch fails the run. Then come the card's name
and power limit (``nvidia-smi``), the ``kernels`` line with every kernel's
times beside its bound, and the status line. Any failure raises and exits
non-zero. Without a CUDA card, or without the repository beside it, the
script prints nothing on stdout and exits 2.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The card's published peaks (H100 SXM data sheet, dense, no sparsity).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
INT32_OPS_PER_S = 33.5e12  # half the f32 lanes of an SM are int32 lanes

PAPER = dict(n=10, d_s=7840)             # the paper MLP's shared layer l1
FULL = dict(n=5, d_s=505_956_352)        # full-width shared vector, N = 5
CONSENSUS_ROUNDS, TRAIN_STEPS = 20, 50
SEED = 2024

KERNELS = {
    "l1_norm_rows": dict(source="src/repro_torch/kernels/csrc/l1_norm.cu",
                         replaces="src/repro/kernels/l1_clip.py:32"),
    "dpps_perturb_rows": dict(
        source="src/repro_torch/kernels/csrc/dpps_perturb.cu",
        replaces="src/repro/kernels/dpps_perturb.py:49"),
    "pushsum_mix": dict(source="src/repro_torch/kernels/csrc/pushsum_mix.cu",
                        replaces="src/repro/kernels/pushsum_mix.py:38"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(nbytes: float, f32_ops: float = 0.0, int_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
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


def d_pad_of(d_s: int) -> int:
    return -(-d_s // 128) * 128


def compare(got, want, rtol: float, atol: float, cols: int = 1 << 24):
    """(max abs error, all |got - want| <= atol + rtol |want|), taken over
    column windows so no full-size temporary is made."""
    err, ok = 0.0, True
    for c0 in range(0, got.shape[-1], cols):
        g, w = got[..., c0:c0 + cols], want[..., c0:c0 + cols]
        d = (g - w).abs()
        err = max(err, d.max().item())
        ok = ok and bool((d <= atol + rtol * w.abs()).all())
    return err, ok


# -- phase 2: each kernel against its plain version --------------------------

def check_kernels(torch, ops, ref, shape: dict, dev, iters: int,
                  cols: int) -> dict:
    """Kernel vs plain at one shape; returns per-kernel errors and times.

    Where the plain version's temporaries would not fit beside the
    full-width buffers (its Philox draw holds a dozen int64 copies of the
    row), it runs over column windows of ``cols``; its time is then the sum
    of the windows' times, the same work in pieces.
    """
    n, d_s = shape["n"], shape["d_s"]
    d_pad = d_pad_of(d_s)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s = torch.randn((n, d_pad), generator=gen, device=dev)
    eps = torch.randn((n, d_pad), generator=gen, device=dev).mul_(0.1)
    s[:, d_s:] = 0
    eps[:, d_s:] = 0
    scale_v, gamma_n, t = 0.7, 0.1, 3
    scale = torch.tensor(scale_v, device=dev)
    out = {}

    # l1_norm_rows: the plain version fits (one |x| temporary)
    # rtol 1e-5: per-block partials against PyTorch's reduction order
    err, ok = compare(ops.l1_norm_rows(eps, d_s), ref.l1_norm_rows(eps, d_s),
                      rtol=1e-5, atol=0.0)
    require(ok, f"l1_norm_rows disagrees at {shape}: max abs err {err}")
    out["l1_norm_rows"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.l1_norm_rows(eps, d_s), iters),
        plain_ms=cuda_ms(torch, lambda: ref.l1_norm_rows(eps, d_s),
                         max(1, iters // 2)),
        library_ms=cuda_ms(torch, lambda: torch.linalg.vector_norm(
            eps[:, :d_s], 1, dim=1), max(1, iters // 2)),
        bound=bound(4.0 * n * d_s + 4 * n, f32_ops=2.0 * n * d_s))

    # dpps_perturb_rows, Philox variant (the main path's)
    k_out, k_eps, k_noise = ops.dpps_perturb_rows(s, eps, scale, gamma_n, d_s,
                                                  seed=SEED, t=t)
    require(bool((k_out[:, d_s:] == 0).all()), "pad lanes not zero")
    err = 0.0
    eps_l1 = torch.zeros(n, device=dev, dtype=torch.float64)
    noise_l1 = torch.zeros_like(eps_l1)
    events = []

    def window_bits(c0, c1):
        return ref.philox_bits(SEED, t, n, c0, c1, device=dev).to(torch.uint32)

    w0 = min(d_s, cols)  # warm-up: the plain version's first launches
    ref.dpps_perturb_rows(s[:, :w0], eps[:, :w0], scale, gamma_n, w0,
                          bits=window_bits(0, w0))
    for c0 in range(0, d_s, cols):
        c1 = min(d_s, c0 + cols)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()  # the plain version's time includes its Philox draw
        p_out, p_eps, p_noise = ref.dpps_perturb_rows(
            s[:, c0:c1], eps[:, c0:c1], scale, gamma_n, c1 - c0,
            bits=window_bits(c0, c1))
        ev1.record()
        events.append((ev0, ev1))
        diff = (k_out[:, c0:c1] - p_out).abs()
        err = max(err, diff.max().item())
        # rtol 1e-6 / atol 1e-6: the card's logf may differ by an ulp
        require(bool((diff <= 1e-6 + 1e-6 * p_out.abs()).all()),
                f"dpps_perturb_rows disagrees at {shape}, cols [{c0}, {c1})")
        eps_l1 += p_eps.double()
        noise_l1 += p_noise.double()
        del p_out, diff
    torch.cuda.synchronize()
    plain_ms = sum(a.elapsed_time(b) for a, b in events)
    for name, k, p in (("eps_l1", k_eps, eps_l1), ("noise_l1", k_noise,
                                                    noise_l1)):
        rel = ((k.double() - p) / p).abs().max().item()
        require(rel < 1e-5, f"dpps_perturb_rows {name} off by {rel} at {shape}")
    # Laplace(0, scale) has E|x| = scale: the row's noise L1 over d_s
    mean_abs = (k_noise.double() / d_s / scale_v).tolist()
    tol = 6.0 / math.sqrt(d_s) + 1e-4
    require(all(abs(m - 1.0) < tol for m in mean_abs),
            f"Philox noise mean|x|/scale {mean_abs} not within {tol} of 1")
    ms = cuda_ms(torch, lambda: ops.dpps_perturb_rows(
        s, eps, scale, gamma_n, d_s, seed=SEED, t=t), iters)
    # per element: Philox4x32-10 is 10 rounds of 2 mul-hi, 2 mul, 4 xor and
    # 2 key adds over 4 elements (25 int32 ops); the transform, the two
    # adds and the two norms about 17 f32 operations
    out["dpps_perturb_rows"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        noise_mean_abs_over_scale=mean_abs,
        bound=bound(8.0 * n * d_s + 4.0 * n * d_pad + 8 * n + 4,
                    f32_ops=17.0 * n * d_s, int_ops=25.0 * n * d_s))
    del k_out

    # pushsum_mix: W of the d-Out graph; the plain version fits
    w = torch.zeros((n, n), device=dev)
    for i in range(n):
        for k in range(2):
            w[(i + k) % n, i] += 0.5
    got = ops.pushsum_mix(w, s)
    want = ref.pushsum_mix(w, s)
    # rtol 1e-5 / atol 1e-6: fma in j order against cuBLAS's order
    err, ok = compare(got, want, rtol=1e-5, atol=1e-6)
    require(ok, f"pushsum_mix disagrees at {shape}: max abs err {err}")
    del got, want
    out["pushsum_mix"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.pushsum_mix(w, s), iters),
        plain_ms=cuda_ms(torch, lambda: ref.pushsum_mix(w, s),
                         max(1, iters // 2)),
        library_ms=cuda_ms(torch, lambda: torch.matmul(w, s),
                           max(1, iters // 2)),
        bound=bound(8.0 * n * d_pad + 4 * n * n, f32_ops=2.0 * n * n * d_pad))
    return out


def philox_statistics(torch, ops, dev) -> dict:
    """The Philox variant's noise alone (s = eps = 0, gamma_n = 1)."""
    n, d_s = PAPER["n"], PAPER["d_s"]
    zeros = torch.zeros((n, d_pad_of(d_s)), device=dev)
    noise = ops.dpps_perturb_rows(zeros, zeros, 2.0, 1.0, d_s, seed=SEED,
                                  t=0)[0]
    body = noise[:, :d_s].double() / 2.0
    stats = dict(mean_over_scale=body.mean().item(),
                 mean_abs_over_scale=body.abs().mean().item(),
                 frac_abs_above_scale=(body.abs() > 1).double().mean().item(),
                 pad_lanes_zero=bool((noise[:, d_s:] == 0).all()))
    m = n * d_s
    require(abs(stats["mean_over_scale"]) < 6 * math.sqrt(2.0 / m),
            f"noise mean {stats}")
    require(abs(stats["mean_abs_over_scale"] - 1) < 6 / math.sqrt(m),
            f"noise mean |x| {stats}")
    require(abs(stats["frac_abs_above_scale"] - math.exp(-1)) < 0.01,
            f"noise tail {stats}")
    require(stats["pad_lanes_zero"], "pad lanes of the noise not zero")
    return stats


# -- phase 3: consensus at full width ----------------------------------------

def consensus(torch, api, T, ops, dev) -> dict:
    from repro_torch.core.pushsum import consensus_error

    n, d_s = FULL["n"], FULL["d_s"]
    topo = T.DOutGraph(n, 2)
    c_prime, lam = T.calibrate_constants(topo)
    b = 1.0
    # The Remark-1 recursion stays bounded only for
    # gamma_n < (1/lam - 1) * b / (2 C' d_s); take half of that.
    gamma_max = (1.0 / lam - 1.0) * b / (2.0 * c_prime * d_s)
    gamma_n = 0.5 * gamma_max
    session = api.Session.build(topo, privacy=api.PrivacySpec(
        b=b, gamma_n=gamma_n, c_prime=c_prime, lam=lam), schedule="dense",
        seed=SEED)
    require(session.plan.use_kernels and session.device.type == "cuda",
            "the session did not pick the card and its kernels")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    values = {"shared": torch.randn((n, d_s), generator=gen, device=dev)}
    err0 = consensus_error(values["shared"], chunk=1 << 24).item()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    state, round_ms, errors = None, [], []
    for r in range(CONSENSUS_ROUNDS):
        t0 = time.perf_counter()
        rep = (session.run(1, values=values) if state is None
               else session.run(1, state=state))
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        state = rep.state
        errors.append(consensus_error(state.push.s["shared"], a=state.push.a,
                                      chunk=1 << 24).item())
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    a_mean = state.push.a.double().mean().item()
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (state.push.s["shared"], state.push.a, state.sens.s_local))
    require(finite, "consensus state not finite")
    require(abs(a_mean - 1.0) < 1e-6, f"mean(a) = {a_mean}, not 1")
    require(all(v > 0 for v in launches.values()),
            f"a kernel did not run on the consensus path: {launches}")
    require(state.t == CONSENSUS_ROUNDS, "round counter")
    steady = sorted(round_ms[1:])
    return dict(phase="consensus", n=n, d_s=d_s, d_pad=d_pad_of(d_s),
                rounds=CONSENSUS_ROUNDS, c_prime=c_prime, lam=lam, b=b,
                gamma_n=gamma_n, gamma_n_stability_limit=gamma_max,
                ms_per_round_median=steady[len(steady) // 2],
                ms_round_0=round_ms[0], ms_per_round=round_ms,
                consensus_error_initial=err0,
                consensus_error_by_round=errors, a_mean=a_mean,
                launches=launches,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


# -- phase 4: PartPSP training -----------------------------------------------

def training_setup(api, T, mlp, data, torch, device, *, steps: int):
    """The paper MLP setup of benchmarks/common.py build_setup, with the
    noise rate cut to 1e-5: its default 0.005 lies outside the recursion's
    stability region at the calibrated constants, where the reference's
    losses turn to NaN as well. Batches are drawn on the CPU from a seeded
    generator, so every device sees the same ones."""
    n = 10
    params = mlp.init_mlp(torch.Generator().manual_seed(SEED))
    session = api.Session.build(
        T.DOutGraph(n, 2), privacy=api.PrivacySpec(b=1.0, gamma_n=1e-5),
        model=mlp.mlp_loss, params=params, partition=mlp.PARTITIONS[
            "partpsp-1"], algorithm="partpsp", gamma_l=0.1, gamma_s=0.1,
        clip=100.0, schedule="dense", sync_interval=5, seed=SEED,
        device=device)
    task = data.SyntheticClassification(d_in=mlp.D_IN, seed=SEED)
    skew = data.dirichlet_partition(n, mlp.N_CLASSES, seed=SEED)
    batches = [task.node_batches(torch.Generator().manual_seed(SEED + 1 + t),
                                 n, 32, skew) for t in range(steps)]
    batches = [tuple(x.to(session.device) for x in b) for b in batches]
    return session, (lambda t: batches[t])


def training(torch, api, T, mlp, data, ops) -> tuple[dict, object]:
    session, batch_at = training_setup(api, T, mlp, data, torch, None,
                                       steps=TRAIN_STEPS)
    require(session.plan.use_kernels, "training did not pick the kernels")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = session.train(TRAIN_STEPS, batch_at)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    loss = rep.trajectory["loss_mean"]
    require(all(v > 0 for v in launches.values()),
            f"a kernel did not run on the training path: {launches}")
    require(all(math.isfinite(float(x)) for x in loss),
            "training loss not finite")
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    require(last < first, f"loss did not fall: {first} -> {last}")
    return dict(phase="training", n=10, d_s=session.partition.d_shared(),
                steps=TRAIN_STEPS, gamma_n=session.cfg.gamma_n,
                c_prime=session.cfg.c_prime, lam=session.cfg.lam,
                loss_first10=first, loss_last10=last,
                ms_per_step=wall / TRAIN_STEPS * 1e3,
                compile_s=rep.compile_s, launches=launches), rep


# -- phase 5: the card against the CPU ---------------------------------------

def agreement(torch, api, T, mlp, data, train_rep) -> dict:
    """Seeded runs on the card (kernels) and on the CPU (plain versions)
    draw the same Philox bits, so they agree to rounding: rtol 1e-5 plus
    1e-6 of the largest magnitude for consensus, whose near-zero entries
    are differences of much larger mixed terms; 1e-3 for the training
    losses, through which 50 steps of tanh gradients pass the last-ulp
    differences on."""
    n, d_s = PAPER["n"], PAPER["d_s"]
    vals = torch.randn((n, d_s), generator=torch.Generator().manual_seed(1))
    out = {}
    states = {}
    for device in ("cuda", "cpu"):
        session = api.Session.build(
            T.DOutGraph(n, 2), privacy=api.PrivacySpec(b=1.0, gamma_n=1e-6),
            schedule="dense", sync_interval=5, chunk=3, seed=SEED,
            device=device)
        require(session.plan.use_kernels == (device == "cuda"), "routing")
        rep = session.run(7, values={"x": vals})
        states[device] = rep.state.push.s["x"].cpu()
    want = states["cpu"]
    err = (states["cuda"] - want).abs().max().item()
    lim = 1e-6 * want.abs().max().item()
    require(torch.allclose(states["cuda"], want, rtol=1e-5, atol=lim),
            f"consensus on the card differs from the CPU by {err}")
    out["consensus_max_abs_err"] = err
    session, batch_at = training_setup(api, T, mlp, data, torch, "cpu",
                                       steps=TRAIN_STEPS)
    cpu_loss = session.train(TRAIN_STEPS, batch_at).trajectory["loss_mean"]
    gpu_loss = train_rep.trajectory["loss_mean"]
    rel = float(abs(gpu_loss - cpu_loss).max() / abs(cpu_loss).max())
    require(rel < 1e-3, f"training loss on the card vs CPU: rel diff {rel}")
    out["training_loss_max_rel_diff"] = rel
    return dict(phase="agreement", **out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="directory for the compiler's full report")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from the repository root (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch import data
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    report = build.build_all()
    build_s = time.perf_counter() - t0
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "ptxas.txt").write_text("\n".join(
            f"== {k}\n{v['ptxas']}" for k, v in report.items()))
    emit(dict(phase="build", seconds=build_s, kernels={
        k: {"seconds": v["seconds"], "cached": v["cached"]}
        for k, v in report.items()}))

    paper = check_kernels(torch, ops, ref, PAPER, dev, iters=200, cols=1 << 20)
    stats = philox_statistics(torch, ops, dev)
    full = check_kernels(torch, ops, ref, FULL, dev, iters=5, cols=1 << 25)
    torch.cuda.empty_cache()
    emit(dict(phase="kernels", paper_shape=PAPER, full_shape=FULL,
              philox=stats, results={"paper": paper, "full": full}))

    torch.cuda.reset_peak_memory_stats()
    cons = consensus(torch, api, T, ops, dev)
    emit(cons)
    torch.cuda.empty_cache()
    train, train_rep = training(torch, api, T, mlp, data, ops)
    emit(train)
    emit(agreement(torch, api, T, mlp, data, train_rep))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    kernels = []
    for name, meta in KERNELS.items():
        f, p = full[name], paper[name]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=cons["launches"][name] + train["launches"][name],
            max_abs_err=max(f["max_abs_err"], p["max_abs_err"]),
            ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound"][0],
            bound_by=f["bound"][1], library_ms=f["library_ms"],
            shape=dict(FULL, d_pad=d_pad_of(FULL["d_s"])),
            paper_shape=dict(ms=p["ms"], plain_ms=p["plain_ms"],
                             bound_ms=p["bound"][0], bound_by=p["bound"][1],
                             library_ms=p["library_ms"])))
    print(smi, flush=True)
    emit({"kernels": kernels, "card": smi})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
