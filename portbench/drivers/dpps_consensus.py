"""Driver of pure DPPS consensus (paper Alg. 1, no perturbation) over the
node-stacked shared leaves of a configuration, through the program's
``Session.run``.

Set-up: the session is built (``Session.build``: the graph's plan, the
calibrated (C', lambda), the kernels' route), each node's private values
are drawn on the device from the seed, and the first ``setup_rounds``
rounds run through ``Session.run`` itself (it loads the kernels and
warms the allocator); their state is kept for the check. The window:
``Session.run(segment_rounds, state=...)`` calls, each ending in the
session's synchronise, until ``--seconds`` have passed;
``consensus_round_ms`` is the window's time over its rounds.

The check (after the window, the program's state freed but for what is
judged):

* ``start_gap``: the reference's first rounds, every column, from the
  same values, against the state the set-up's rounds left;
* ``sens_gap``: the sensitivity scalars of those rounds, and the
  recursion of a few rounds of the window drawn from the seed, followed
  from the program's own scalars of the round before (each needs the
  whole row's noise norm);
* ``window_gap``: a sample of columns drawn from the seed, followed by
  the reference through every round of the window from the reference's
  state after the set-up's rounds, with the program's noise scale of each
  round, against the program's final state there.
"""
from __future__ import annotations

import time

import numpy as np

from portbench.harness import compare, inputs, program
from portbench.harness.runtime import Outcome
from portbench.reference import dpps as ref_dpps
from portbench.reference import graphs, philox

KERNELS = {"dense": ("l1_norm", "dpps_perturb", "pushsum_mix"),
           "sparse": ("l1_norm", "dpps_perturb", "spmm")}


def layout(cfg: dict) -> tuple[list, int]:
    """[(path, per-node shape, offset, size)] of the shared leaves in wire
    order (a tree flatten's: path components sorted), and d_s."""
    items = sorted(((p, tuple(s)) for p, s in cfg["shared_leaves"]),
                   key=lambda ps: ps[0].split("/"))
    out, off = [], 0
    for path, shape in items:
        size = int(np.prod(shape))
        out.append((path, shape, off, size))
        off += size
    return out, off


def tree_of(buf, segs) -> dict:
    """Views of the (N, d_s) buffer as the nested tree of leaves."""
    tree: dict = {}
    n = buf.shape[0]
    for path, shape, off, size in segs:
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = buf[:, off:off + size].view((n,) + shape)
    return tree


def setup_values(ctx, n: int, d_s: int):
    return inputs.consensus_values(ctx.seed, n, d_s, ctx.device)


def constants(ctx, w: np.ndarray, d_s: int) -> ref_dpps.Consts:
    tr = ctx.traffic
    c_prime, lam = graphs.calibrate(w)
    gamma_n = tr["gamma_n_share_of_limit"] * graphs.gamma_limit(
        c_prime, lam, tr["b"], d_s)
    return ref_dpps.Consts(c_prime=c_prime, lam=lam, gamma_n=gamma_n,
                           b=tr["b"], seed=ctx.seed, sync_interval=0)


def run(ctx) -> Outcome:
    from repro_torch.api import PrivacySpec, Session
    from repro_torch.core.tree_utils import tree_leaves

    torch, cfg, tr = ctx.torch, ctx.config, ctx.traffic
    n = int(cfg["topology"]["nodes"])
    segs, d_s = layout(cfg)
    w_ref = graphs.weights(cfg["topology"])
    k = constants(ctx, w_ref, d_s)
    schedule = cfg["topology"]["schedule"]
    if ctx.on_card:
        program.build_kernels(KERNELS[schedule])
    ctx.sync()
    t0 = time.perf_counter()
    session = Session.build(
        program.topology(cfg), privacy=PrivacySpec(b=k.b, gamma_n=k.gamma_n),
        schedule=schedule, seed=ctx.seed, chunk=int(tr["segment_rounds"]),
        device=ctx.device)
    ctx.sync()
    build_s = time.perf_counter() - t0
    if ctx.on_card and not session.plan.use_kernels:
        raise RuntimeError("the session did not take the card's kernels")
    if session.plan.schedule != schedule:
        raise RuntimeError(f"the session chose {session.plan.schedule!r}")

    values = setup_values(ctx, n, d_s)
    setup_rounds = int(tr["setup_rounds"])
    rep = session.run(setup_rounds, values=tree_of(values, segs))
    del values
    start_state = rep.state
    start_sens = np.asarray(rep.trajectory["sensitivity_used"])
    del rep

    tracer = None
    if ctx.trace:
        from portbench.harness.tracing import Tracer
        tracer = Tracer(torch)
        tracer.start()
    seg = int(tr["segment_rounds"])
    st, rounds, scales, locals_ = start_state, 0, [], []
    ctx.sync()
    wall0 = time.time()
    t0 = time.perf_counter()
    while True:
        rep = session.run(seg, state=st)   # ends in the session's sync
        st = rep.state
        rounds += seg
        scales.append(np.asarray(rep.trajectory["sensitivity_used"]))
        locals_.append(np.asarray(rep.trajectory["sensitivity_local"]))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.stop()
    del rep
    sens_used = np.concatenate(scales)
    sens_local = np.concatenate(locals_)

    cols = inputs.sample(ctx.seed, d_s, int(tr["sample_columns"]))
    final_cols = gather_columns(torch, tree_leaves(st.push.s), segs, cols,
                                ctx.device)
    failed = int((~np.isfinite(sens_used)).sum())
    records = dict(window_s=window_s, rounds=rounds, n=n, d_s=d_s,
                   schedule=schedule, build_s=build_s,
                   w_entries=w_entries(session.plan, schedule, n),
                   spmm_k=(int(session.plan.sparse_idx.shape[-1])
                           if schedule == "sparse" else None),
                   nnz=int((w_ref != 0).sum()))
    if tracer is not None:
        records.update(tracer.records())
    held = dict(st=st, session=session)

    def release():
        held.clear()

    def judge():
        out = dict(start=[tree_leaves(start_state.push.s),
                          start_state.push.a, start_sens],
                   final_cols=final_cols, sens_used=sens_used,
                   sens_local=sens_local)
        return check(ctx, out, cols, segs, d_s, k, w_ref, setup_rounds,
                     rounds)

    return Outcome(end_to_end={"consensus_round_ms": window_s * 1e3 / rounds},
                   window_wall_start=wall0, attempted=rounds, failed=failed,
                   records=records, release=release, judge=judge)


def w_entries(plan, schedule: str, n: int) -> int:
    """Bytes of the mixing operands a round reads: the dense W's N^2 f32
    entries, or the padded CSR's (N, K) int32 indices and f32 values."""
    if schedule == "sparse":
        return 8 * int(plan.sparse_idx.shape[-1]) * n
    return 4 * n * n


def gather_columns(torch, leaves, segs, cols: np.ndarray, device):
    """(N, len(cols)) of the wire row at ``cols`` from the state's leaves."""
    parts = []
    for leaf, (_, _, off, size) in zip(leaves, segs):
        sel = cols[(cols >= off) & (cols < off + size)] - off
        if sel.size:
            idx = torch.as_tensor(sel, dtype=torch.int64, device=device)
            parts.append(leaf.reshape(leaf.shape[0], -1)[:, idx].float())
    return torch.cat(parts, dim=1)


def reference_start(ctx, n, d_s, k, w, rounds):
    """The reference's first ``rounds`` rounds from the seed's values."""
    torch = ctx.torch
    s = setup_values(ctx, n, d_s)
    a = torch.ones((n,), dtype=torch.float32, device=ctx.device)
    sens, used = None, []
    wt = torch.as_tensor(w, dtype=torch.float32, device=ctx.device)
    for t in range(rounds):
        a, sens, diag = ref_dpps.dpps_round(s, a, sens, t, k, wt)
        used.append(float(diag["sensitivity_used"]))
    return s, a, np.asarray(used)


def noise_l1(ctx, n: int, d_s: int, seed: int, t: int, scale) -> np.ndarray:
    """Each node's ||Lap(scale)||_1 of round t over the whole row."""
    torch = ctx.torch
    total = torch.zeros((n,), dtype=torch.float32, device=ctx.device)
    step = max(4, (ref_dpps.BLOCK_ELEMENTS // n) // 4 * 4)
    sc = torch.tensor(float(scale), dtype=torch.float32, device=ctx.device)
    for c0 in range(0, d_s, step):
        c1 = min(d_s, c0 + step)
        total += philox.laplace(philox.bits_block(seed, t, n, c0, c1,
                                                  ctx.device), sc).abs().sum(1)
    return total.cpu().numpy()


def check(ctx, out: dict, cols, segs, d_s: int, k, w, setup_rounds: int,
          rounds: int) -> list:
    """The compared numbers of a consensus run whose outputs are ``out``
    (the program's, or the control's)."""
    torch = ctx.torch
    n = len(w)
    s, a, used = reference_start(ctx, n, d_s, k, w, setup_rounds)
    leaves, a_prog, used_prog = out["start"]
    start_gap = 0.0
    for leaf, (_, _, off, size) in zip(leaves, segs):
        start_gap = max(start_gap, compare.rel_max(
            leaf.reshape(n, -1).float().cpu(), s[:, off:off + size].cpu()))
    start_gap = max(start_gap, compare.rel_max(a_prog.cpu(), a.cpu()))
    sens_gap = compare.rel_each(used_prog, used)
    del leaves
    idx = torch.as_tensor(cols, dtype=torch.int64, device=ctx.device)
    start_cols = s[:, idx].float()
    del s
    scales = out["sens_used"] / k.b
    wt = torch.as_tensor(w, dtype=torch.float32, device=ctx.device)
    want = ref_dpps.replay_columns(start_cols, idx, scales, setup_rounds,
                                   k, wt)
    window_gap = compare.rel_max(out["final_cols"].cpu(), want.cpu())
    # the recursion at a few rounds of the window, from the program's
    # scalars of the round before
    local = out["sens_local"]
    picks = inputs.sample(ctx.seed, rounds - 1,
                          int(ctx.traffic["check_rounds"]), 1) + 1
    for r in picks:
        t_prev = setup_rounds + r - 1
        nl = noise_l1(ctx, n, d_s, k.seed, t_prev, out["sens_used"][r - 1]
                      / k.b)
        lam, cp = np.float32(k.lam), np.float32(k.c_prime)
        want_local = lam * local[r - 1] + np.float32(2.0) * cp * (
            np.float32(0.0) + lam * np.float32(k.gamma_n) * nl)
        sens_gap = max(sens_gap, compare.rel_each(local[r], want_local))
    lim = ctx.traffic["limits"]
    return [("start_gap", start_gap, lim["start_gap"]),
            ("sens_gap", sens_gap, lim["sens_gap"]),
            ("window_gap", window_gap, lim["window_gap"])]


def control(ctx) -> list:
    """The control: the reference in bfloat16 put in the program's place,
    through the set-up's rounds and ``control_rounds`` rounds more (every
    column, its own sensitivity), judged by :func:`check` as a run is."""
    torch, cfg, tr = ctx.torch, ctx.config, ctx.traffic
    n = int(cfg["topology"]["nodes"])
    segs, d_s = layout(cfg)
    w = graphs.weights(cfg["topology"])
    k = constants(ctx, w, d_s)
    setup_rounds, rounds = int(tr["setup_rounds"]), int(tr["control_rounds"])
    bf16 = torch.bfloat16
    s = setup_values(ctx, n, d_s).to(bf16)
    a = torch.ones((n,), dtype=torch.float32, device=ctx.device)
    wt = torch.as_tensor(w, dtype=torch.float32, device=ctx.device)
    sens, used, scales, local = None, [], [], []
    for t in range(setup_rounds + rounds):
        if t == setup_rounds:
            start = [[s[:, off:off + size].clone() for _, _, off, size in segs],
                     a.clone(), np.asarray(used)]
        a, sens, diag = ref_dpps.dpps_round(s, a, sens, t, k, wt, dtype=bf16)
        if t < setup_rounds:
            used.append(float(diag["sensitivity_used"]))
        else:
            scales.append(float(diag["sensitivity_used"]))
            local.append(diag["sensitivity_local"].cpu().numpy())
    cols = inputs.sample(ctx.seed, d_s, int(tr["sample_columns"]))
    idx = torch.as_tensor(cols, dtype=torch.int64, device=ctx.device)
    out = dict(start=start, final_cols=s[:, idx].float(),
               sens_used=np.asarray(scales), sens_local=np.stack(local))
    del s
    return check(ctx, out, cols, segs, d_s, k, w, setup_rounds, rounds)
