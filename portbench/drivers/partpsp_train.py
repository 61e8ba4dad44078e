"""Driver of PartPSP training (paper Alg. 2) of a decoder over frame
embeddings, through the program's ``Session.train``.

Set-up: one node's parameters are drawn on the device from the seed and
handed to ``Session.build`` with the program's ``Transformer`` and the
configuration's partition (the first ``k`` layers shared, the rest and
the head local), every node starting from them; the codebook streams of
every step are drawn at once. The session then trains its first
``setup_steps`` steps through ``Session.train`` itself, on rows that all
differ: one step, whose state gives each local leaf's first gradient as
the update saw it, ``(l0 - l1) / gamma_l``, then the rest, whose state
gives each leaf's change. That same state goes on into the window:
``Session.train(1, ...)`` steps, each ending in the session's synchronise,
until ``--seconds`` have passed; ``train_tokens_per_s`` is every node's
frames of the window's steps over its time.

The check (after the window, the program's state freed): the reference
follows the set-up's steps from the same parameters and frames, and
compares the losses (``loss_gap``) and the largest pre-clip
shared-gradient L1 norm (``clip_norm_gap``) of the first
``steady_steps`` steps, each step's sensitivity scalar (``sens_gap``),
each local leaf's first gradient norm (``grad_gap``) and each leaf's
change after the set-up's steps (``change_gap``), the last two by the
worst leaf. The set-up runs past the first full synchronisation (round
``sync_interval - 1``) and one round beyond it, so the compared steps
hold a sync round and the sensitivity recursion's restart after it. The
losses and norms of later steps are left out: on some seeds the noised
trajectory amplifies any rounding difference from the third step on
(the control's gap there grows by the same factor), so they would
measure the seed and not the program. A leaf whose
reference gradient is under a thousandth of the median leaf's (the
embedding table, which frame inputs never read) is left out of the
change: it moves by round-off alone.
"""
from __future__ import annotations

import math
import time

import numpy as np

from portbench.harness import compare, inputs, program
from portbench.harness.runtime import Outcome
from portbench.harness.yardstick import model_flops_per_sequence
from portbench.reference import dpps as ref_dpps
from portbench.reference import graphs, model as ref_model
from portbench.reference import partpsp as ref_partpsp

KERNELS = ("l1_norm", "dpps_perturb", "pushsum_mix")
EXCLUDE_BELOW = 1e-3   # of the median leaf's first gradient norm


class Inputs:
    """The run's parameters, frames and constants, made from the seed;
    the program and the reference are each handed these."""

    def __init__(self, ctx, streams: int):
        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.m = cfg["model"]
        self.n = int(cfg["topology"]["nodes"])
        self.k = int(cfg["partition"]["shared_layers"])
        self.shapes = ref_model.param_shapes(self.m)
        _, self.d_s = ref_partpsp.shared_segments(self.shapes, self.k)
        self.frames = int(tr["frames_per_node"])
        self.w = graphs.weights(cfg["topology"])
        c_prime, lam = graphs.calibrate(self.w)
        gamma_n = tr["gamma_n_share_of_limit"] * graphs.gamma_limit(
            c_prime, lam, tr["b"], self.d_s)
        self.consts = ref_dpps.Consts(
            c_prime=c_prime, lam=lam, gamma_n=gamma_n, b=tr["b"],
            seed=ctx.seed, sync_interval=int(tr["sync_interval"]))
        self.tokens = inputs.markov_tokens(
            ctx.seed, vocab=self.m["vocab_size"], seq_len=self.frames,
            n_nodes=self.n, streams=streams, device=dev,
            rank=int(tr["markov_rank"]), node_skew=float(tr["node_skew"]))
        self.table = inputs.frame_table(ctx.seed, vocab=self.m["vocab_size"],
                                        d_model=self.m["d_model"],
                                        device=dev)
        self.seed, self.device = ctx.seed, dev

    def params(self) -> dict:
        leaves = inputs.decoder_params(self.seed, self.shapes, self.device)
        return ref_model.from_paths(zip((p for p, _ in self.shapes), leaves))

    def batch(self, t: int) -> dict:
        """Step t's node-stacked batch: one stream a node."""
        if t >= self.tokens.shape[0]:
            raise RuntimeError(f"step {t} is past the {self.tokens.shape[0]} "
                               "streams drawn in set-up")
        tok = self.tokens[t]
        return {"embeds": self.table[tok][:, None], "labels": tok[:, None]}


def leaf_names(shapes, k: int) -> tuple[list, list]:
    """Names of the shared and the local leaf parts in the program's
    partition order (tree-flatten order, the split leaves on both sides)."""
    shared = [f"{p}[:{k}]" for p, _ in shapes if p.startswith("group_0/")]
    local = [f"{p}[{k}:]" if p.startswith("group_0/") else p
             for p, _ in shapes]
    return shared, local


def diff_norm(torch, x, x0) -> float:
    """||x - x0|| of two node-stacked leaves, a layer at a time where they
    are layer stacks (no whole-leaf temporary)."""
    if x.dim() < 3:
        return float(torch.linalg.vector_norm((x - x0).float()))
    return math.sqrt(sum(float(torch.linalg.vector_norm(
        (x[:, i] - x0[:, i]).float())) ** 2 for i in range(x.shape[1])))


def run(ctx) -> Outcome:
    from repro_torch.api import PrivacySpec, Session
    from repro_torch.core.tree_utils import tree_leaves

    torch, cfg, tr = ctx.torch, ctx.config, ctx.traffic
    setup_steps = int(tr["setup_steps"])
    sync = int(tr["sync_interval"])
    if sync and setup_steps <= sync:
        raise ValueError(f"setup_steps {setup_steps} must pass the first "
                         f"sync round ({sync - 1}) and the round after it")
    streams = setup_steps + int(math.ceil(ctx.seconds * tr["max_steps_per_s"])) + 1
    data = Inputs(ctx, streams)
    rules = (("group_0/.*", ("split_layers", data.k)),)
    if ctx.on_card:
        program.build_kernels(KERNELS)
    params = data.params()
    ctx.sync()
    t0 = time.perf_counter()
    session = Session.build(
        program.topology(cfg),
        privacy=PrivacySpec(b=data.consts.b, gamma_n=data.consts.gamma_n),
        model=program.model(cfg), params=params, partition=rules,
        algorithm="partpsp", gamma_l=tr["gamma_l"], gamma_s=tr["gamma_s"],
        clip=tr["clip"], schedule=cfg["topology"]["schedule"],
        sync_interval=int(tr["sync_interval"]), seed=ctx.seed,
        device=ctx.device)
    ctx.sync()
    build_s = time.perf_counter() - t0
    del params
    if ctx.on_card and not session.plan.use_kernels:
        raise RuntimeError("the session did not take the card's kernels")
    if session.partition.d_shared() != data.d_s:
        raise RuntimeError(f"d_s {session.partition.d_shared()} in the "
                           f"program, {data.d_s} in the file")
    shared_names, local_names = leaf_names(data.shapes, data.k)
    init_shared, init_local = session.partition.split(session.init_params)

    def batch_at(t):
        return data.batch(t)

    rows = []
    rep = session.train(1, batch_at)
    st = rep.state
    rows.append(rep.trajectory)
    del rep
    first_grads = {name: diff_norm(torch, l1, l0) / tr["gamma_l"]
                   for name, l0, l1 in zip(local_names, init_local, st.local)}
    rep = session.train(setup_steps - 1, batch_at, state=st)
    st = rep.state
    rows.append(rep.trajectory)
    del rep
    change = {name: diff_norm(torch, x, x0) for name, x, x0 in zip(
        shared_names, tree_leaves(st.dpps.push.s), init_shared)}
    change.update({name: diff_norm(torch, x, x0) for name, x, x0 in zip(
        local_names, st.local, init_local)})
    del init_shared, init_local
    setup = dict(
        losses=np.concatenate([np.asarray(r["loss_per_node"]) for r in rows]),
        clip_norm=np.concatenate([np.asarray(r["grad_l1_max"]) for r in rows]),
        sens=np.concatenate([np.asarray(r["sensitivity_used"]) for r in rows]),
        first_grads=first_grads, change=change)

    tracer = None
    if ctx.trace:
        from portbench.harness.tracing import Tracer
        tracer = Tracer(torch)
        tracer.start()
    steps, losses = 0, []
    ctx.sync()
    wall0 = time.time()
    t0 = time.perf_counter()
    while True:
        rep = session.train(1, batch_at, state=st)  # ends in its sync
        st = rep.state
        steps += 1
        losses.append(np.asarray(rep.trajectory["loss_mean"]))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.stop()
    del rep
    losses = np.concatenate(losses)
    frames = steps * data.n * data.frames
    records = dict(window_s=window_s, steps=steps, n=data.n, d_s=data.d_s,
                   build_s=build_s,
                   model_flops=steps * data.n * model_flops_per_sequence(
                       data.m, data.frames))
    if tracer is not None:
        records.update(tracer.records())
    held = dict(st=st, session=session)

    def release():
        held.clear()

    def judge():
        return check(ctx, data, setup)

    return Outcome(end_to_end={"train_tokens_per_s": frames / window_s},
                   window_wall_start=wall0, attempted=steps,
                   failed=int((~np.isfinite(losses)).sum()),
                   records=records, release=release, judge=judge)


_REFERENCE: dict = {}   # (seed, tf32) -> readings: one run per seed


def reference(ctx, data: Inputs, tf32: bool = False) -> dict:
    """The reference's set-up steps (``tf32``: its matrix products in
    TF32, the control's precision), once a seed in a process."""
    key = (ctx.seed, tf32)
    if key not in _REFERENCE:
        _REFERENCE[key] = _reference(ctx, data, tf32)
    return _REFERENCE[key]


def _reference(ctx, data: Inputs, tf32: bool) -> dict:
    torch, tr = ctx.torch, ctx.traffic
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        w = torch.as_tensor(data.w, dtype=torch.float32, device=data.device)

        def batch_at(t):
            b = data.batch(t)
            return b["embeds"], b["labels"]

        return ref_partpsp.train(
            data.params(), data.m, n_nodes=data.n, k=data.k,
            batch_at=batch_at, steps=int(tr["setup_steps"]), w=w,
            consts=data.consts, gamma_l=tr["gamma_l"], gamma_s=tr["gamma_s"],
            clip=tr["clip"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]


def check(ctx, data: Inputs, got: dict, want: dict | None = None) -> list:
    """The compared numbers of the set-up's steps ``got`` (the program's,
    or the control's) against the reference's ``want``."""
    want = want or reference(ctx, data)
    lim = ctx.traffic["limits"]
    steady = int(ctx.traffic["steady_steps"])
    grads = want["first_grads"]
    med = float(np.median(list(grads.values())))
    moved = {k for k, v in grads.items() if v >= EXCLUDE_BELOW * med}
    local = {k: v for k, v in grads.items() if not k.endswith(
        f"[:{data.k}]")}
    grad_gap, _ = compare.worst_leaf(got["first_grads"], local)
    change_gap, _ = compare.worst_leaf(got["change"], want["change"],
                                       keep=moved)
    clip_want = want["grad_l1"][:steady].max(dim=1).values
    return [
        ("loss_gap", compare.rel_each(got["losses"][:steady],
                                      want["losses"][:steady]),
         lim["loss_gap"]),
        ("clip_norm_gap", compare.rel_each(got["clip_norm"][:steady],
                                           clip_want),
         lim["clip_norm_gap"]),
        ("sens_gap", compare.rel_each(got["sens"], want["sensitivity"]),
         lim["sens_gap"]),
        ("grad_gap", grad_gap, lim["grad_gap"]),
        ("change_gap", change_gap, lim["change_gap"]),
    ]


def control(ctx) -> list:
    """The control: the reference with its matrix products in TF32 put in
    the program's place, judged by :func:`check` against the reference."""
    tr = ctx.traffic
    data = Inputs(ctx, int(tr["setup_steps"]))
    low = reference(ctx, data, tf32=True)
    got = dict(losses=low["losses"].numpy(),
               clip_norm=low["grad_l1"].max(dim=1).values.numpy(),
               sens=low["sensitivity"].numpy(),
               first_grads={k: v for k, v in low["first_grads"].items()},
               change=low["change"])
    del low
    return check(ctx, data, got)
