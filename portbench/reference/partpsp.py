"""PartPSP (paper Alg. 2) steps of the decoder in :mod:`.model`, written out.

Every node starts from the same parameters. The leaves under ``group_0``
are layer stacks whose first ``k`` layers are shared (gossiped through
DPPS as one flat wire row, the leaves in sorted-path order) and the rest
local, as are ``embed``, ``final_ln`` and ``lm_head``. A step, node by
node:

  1. y = s / a                                              (Eq. 10)
  2. l' = l - gamma_l grad_l F(y, l)                        (Eq. 23)
  3. g = grad_y F(y, l'), clipped to L1 norm ``clip``       (Eq. 24)
  4. a DPPS round of :mod:`.dpps` with eps = -gamma_s g     (Eq. 25)

Each layer's activations are recomputed in the backward
(``torch.utils.checkpoint``), which changes no number and keeps a node's
pass within memory at full width.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import dpps, model


def shared_segments(shapes, k: int):
    """[(path, per-node shape of the shared part, offset, size)] of the
    wire row, and d_s."""
    out, off = [], 0
    for path, shape in shapes:
        if path.startswith("group_0/"):
            part = (k,) + tuple(shape[1:])
            size = 1
            for x in part:
                size *= x
            out.append((path, part, off, size))
            off += size
    return out, off


def local_part(path: str, leaf: torch.Tensor, k: int) -> torch.Tensor:
    return leaf[k:] if path.startswith("group_0/") else leaf


def _layers(m: dict, k: int, shared: dict, local: dict) -> list:
    """Each layer's parameter dict, from the shared parts (layers < k)
    and the local parts."""
    out = []
    for i in range(m["n_layers"]):
        lp: dict = {}
        for path in shared:
            _, blk, name = path.split("/")
            leaf = shared[path][i] if i < k else local[path][i - k]
            lp.setdefault(blk, {})[name] = leaf
        out.append(lp)
    return out


def node_loss(m: dict, k: int, shared: dict, local: dict, embeds, labels):
    params = {"final_ln": {"scale": local["final_ln/scale"]},
              "lm_head": local["lm_head"]}
    layers = _layers(m, k, shared, local)
    ck = [lambda x, lp=lp: model.layer(lp, x, m) for lp in layers]
    total = torch.zeros((), dtype=torch.float32, device=embeds.device)
    bsz, s = labels.shape
    for j in range(bsz):
        x = embeds[j].float()
        for fn in ck:
            x = checkpoint(fn, x, use_reentrant=False) \
                if torch.is_grad_enabled() else fn(x)
        x = model.rms(x, params["final_ln"]["scale"], m["norm_eps"])
        logits = (x[:-1] @ params["lm_head"]).float()
        total = total + torch.nn.functional.cross_entropy(
            logits, labels[j, 1:].long(), reduction="sum")
    return total / (bsz * (s - 1))


def train(params0: dict, m: dict, *, n_nodes: int, k: int, batch_at,
          steps: int, w: torch.Tensor, consts: dpps.Consts, gamma_l: float,
          gamma_s: float, clip: float) -> dict:
    """``steps`` PartPSP steps from ``params0`` (one node's parameters,
    every node's start). ``batch_at(t)`` -> (embeds (N, B, S, d), labels
    (N, B, S)). Returns the numbers the benchmark compares: each step's
    losses (steps, N) and pre-clip shared gradient L1 norms (steps, N), the
    first step's gradient norm of each leaf part (over all nodes), and the
    norm of each leaf part's change after the steps."""
    pairs = model.tree_paths(params0)
    shapes = [(p, tuple(x.shape)) for p, x in pairs]
    flat = dict(pairs)
    segs, d_s = shared_segments(shapes, k)
    dev = next(iter(flat.values())).device
    row0 = torch.cat([flat[p][:k].reshape(-1) for p, *_ in segs])
    s = row0[None].repeat(n_nodes, 1)
    a = torch.ones((n_nodes,), dtype=torch.float32, device=dev)
    local_paths = [p for p, _ in shapes]
    local = {p: local_part(p, flat[p], k)[None].expand(
        (n_nodes,) + tuple(local_part(p, flat[p], k).shape))
        for p in local_paths}
    sens = None
    losses, grad_l1, sens_used = [], [], []
    first_grads: dict[str, float] = {}
    for t in range(steps):
        loss_t = torch.zeros((n_nodes,), dtype=torch.float32, device=dev)
        new_local = {p: torch.empty_like(local[p]) for p in local_paths}
        embeds, labels = batch_at(t)
        sq_local = {p: 0.0 for p in local_paths}
        for i in range(n_nodes):
            y = {p: (s[i, off:off + size] / a[i]).reshape(part)
                 for p, part, off, size in segs}
            li = {p: local[p][i].detach().requires_grad_(True)
                  for p in local_paths}
            with torch.enable_grad():
                val = node_loss(m, k, y, li, embeds[i], labels[i])
                gl = torch.autograd.grad(val, [li[p] for p in local_paths],
                                         allow_unused=True)
            loss_t[i] = val.detach()
            for p, g in zip(local_paths, gl):
                g = torch.zeros_like(li[p]) if g is None else g
                if t == 0:
                    sq_local[p] += float(torch.linalg.vector_norm(g)) ** 2
                new_local[p][i] = local[p][i] - gamma_l * g
            del gl, li, y
        eps = torch.empty((n_nodes, d_s), dtype=torch.float32, device=dev)
        norms = torch.zeros((n_nodes,), dtype=torch.float32, device=dev)
        sq_shared = {p: 0.0 for p, *_ in segs}
        for i in range(n_nodes):
            y = {p: (s[i, off:off + size] / a[i]).reshape(part).detach()
                 .requires_grad_(True) for p, part, off, size in segs}
            li = {p: new_local[p][i] for p in local_paths}
            with torch.enable_grad():
                val = node_loss(m, k, y, li, embeds[i], labels[i])
                gs = torch.autograd.grad(val, [y[p] for p, *_ in segs])
            for (p, part, off, size), g in zip(segs, gs):
                eps[i, off:off + size] = g.reshape(-1)
                if t == 0:
                    sq_shared[p] += float(torch.linalg.vector_norm(g)) ** 2
            del gs, y
            norms[i] = eps[i].abs().sum()
            denom = torch.clamp_min(norms[i] / clip, 1.0)
            eps[i] = -gamma_s * (eps[i] / denom)
        a, sens, diag = dpps.dpps_round(s, a, sens, t, consts, w, eps=eps)
        del eps
        local = new_local
        losses.append(loss_t)
        grad_l1.append(norms)
        sens_used.append(diag["sensitivity_used"])
        if t == 0:
            for p in local_paths:
                first_grads[_local_name(p, k)] = sq_local[p] ** 0.5
            for p, *_ in segs:
                first_grads[_shared_name(p, k)] = sq_shared[p] ** 0.5
    change: dict[str, float] = {}
    for p, part, off, size in segs:
        d = s[:, off:off + size] - row0[off:off + size][None]
        change[_shared_name(p, k)] = float(torch.linalg.vector_norm(d))
    for p in local_paths:
        d = local[p] - local_part(p, flat[p], k)[None]
        change[_local_name(p, k)] = float(torch.linalg.vector_norm(d))
    return dict(losses=torch.stack(losses).cpu(),
                grad_l1=torch.stack(grad_l1).cpu(),
                sensitivity=torch.stack(sens_used).cpu(),
                first_grads=first_grads, change=change,
                a=a.cpu())


def _shared_name(path: str, k: int) -> str:
    return f"{path}[:{k}]"


def _local_name(path: str, k: int) -> str:
    return f"{path}[{k}:]" if path.startswith("group_0/") else path
