"""The seam between the port's Python loops and hand-written kernels and a
cost count (:mod:`repro_torch.launch.op_analysis`).

The reference's dry run costs XLA's HLO, where a ``lax.scan`` body is one
computation with a trip count and a ``vmap`` is one batched op. The port
runs both as Python loops: the time loops of :mod:`repro_torch.models.ssm`
(:func:`time_loop`) and the node loop of
:func:`repro_torch.core.partpsp.node_stacked` (:func:`node_loop`). Off a
cost count both run every iteration, bit for bit as a plain loop would.
Under a counter (a :class:`repro_torch.launch.op_analysis.CostMode` on
the dispatch-mode stack, :func:`_counter`), on its device, they run the
loop rule:

* ``node_loop`` runs node 0's body once at the counter's scale times N,
  its inputs sliced and its losses stacked by autograd functions whose
  backward stacks node 0's gradient N times (what ``unbind``'s backward
  does with N gradients) and scales node 0's backward N times;
* ``time_loop`` runs steps 0, 1 and S - 1, step 1 at scale S - 2 (step 0
  frees no carry, since the caller holds it; the last step's carry is not
  taken by another step, so its backward adds no carry gradients), the
  outputs combined from [y_0] + [y_1] * (S - 2) + [y_{S-1}], the backward
  scaled by the same factors.

Memory is kept as in the unrolled run: the storages a repeated body
leaves alive count as many times as it would have run, and the peak
inside the body is raised by the copies the unrolled run would hold by
its last iteration (the counter's regions, ``begin_region`` /
``end_region`` / ``materialize``). For the node loop that is exact, the
backward included; for a time loop it is exact without grad, while under
grad its FLOPs and bytes are exact and its peak is not (the unrolled
backward frees each step's saved tensors one step at a time; the rule's
middle step frees all of its copies at once).

:func:`charge` is the kernels' side: a wrapper in
:mod:`repro_torch.kernels.ops` that meets meta tensors charges the counter
its kernel's FLOPs and bytes. :func:`charge_collective` is the model
axis's (:mod:`repro_torch.models.parallel`): on meta tensors it issues no
c10d call and charges the counter the collective's operand bytes.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["charge", "charge_collective", "node_loop", "time_loop"]


def _counter():
    """The innermost active cost count (a dispatch mode that charges
    kernels), or None. Autograd runs a backward under the modes of the
    forward's caller, so the loop rule's backward functions find it too."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "charge_kernel"):
            return mode
    return None


def charge(kernel: str, flops: float, nbytes: float) -> None:
    """Charge the active cost count, if any, one launch of ``kernel``."""
    c = _counter()
    if c is not None:
        c.charge_kernel(kernel, flops, nbytes)


def charge_collective(kind: str, nbytes: float) -> None:
    """Charge the active cost count, if any, one collective of ``kind``
    (the reference's name: "all-reduce", ...) on ``nbytes`` of operand."""
    c = _counter()
    if c is not None:
        c.charge_collective(kind, nbytes)


def _ruled(tensors: Sequence[torch.Tensor]):
    """The counter, when one is active, its rule on and ``tensors`` on its
    device."""
    c = _counter()
    if c is None or not c.loop_rule:
        return None
    if not any(isinstance(t, torch.Tensor) and t.device == c.device
               for t in tensors):
        return None
    return c


def _repeat(ys: Sequence[torch.Tensor], reps: Sequence[int], dim: int,
            cat: bool) -> torch.Tensor:
    """``torch.stack`` (or ``torch.cat``) along ``dim`` of each of ``ys``
    repeated as ``reps`` says. Under a counter the output is allocated and
    the op's bytes (every operand read, the output written) charged, as
    that one op over the repeated list would be: a list of thousands of
    views costs the meta kernels seconds."""
    c = _counter()
    if c is None:
        seq = [y for y, r in zip(ys, reps) for _ in range(r)]
        return torch.cat(seq, dim) if cat else torch.stack(seq, dim)
    shape = list(ys[0].shape)
    if cat:
        shape[dim] = sum(y.shape[dim] * r for y, r in zip(ys, reps))
    else:
        shape.insert(dim, sum(reps))
    out = torch.empty(shape, dtype=ys[0].dtype, device=ys[0].device)
    c.charge_bytes(sum(y.numel() * y.element_size() * r
                       for y, r in zip(ys, reps))
                   + out.numel() * out.element_size())
    return out


def _keep_requires_grad(ctx, xs, out, k: int) -> None:
    """The outputs made of an input that needs no gradient need none either
    (as ``unbind``'s views): a tensor that requires grad takes other
    decompositions (``matmul``) and adds backward work."""
    if isinstance(ctx, _NoCtx):
        return
    idle = [o for i, x in enumerate(xs) if not ctx.needs_input_grad[i + 1]
            for o in out[i * k:(i + 1) * k]]
    if idle:
        ctx.mark_non_differentiable(*idle)


class _NoCtx:
    """The ``ctx`` of a function run outside autograd."""

    def set_materialize_grads(self, value: bool) -> None:
        pass


def _apply(fn, spec, *xs):
    """``fn.apply`` where a backward will run through it; else its forward
    alone (a custom function applied without grad holds its inputs in a
    reference cycle until the garbage collector runs)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return fn.apply(spec, *xs)
    return fn.forward(_NoCtx(), spec, *xs)


class _Scaled(torch.autograd.Function):
    """Identity on its inputs (as views); its backward sets the counter's
    scale to ``scale`` for the backward ops that run after it (the ops of
    the iteration whose outputs it took)."""

    @staticmethod
    def forward(ctx, scale, *xs):
        ctx.scale = scale
        ctx.set_materialize_grads(False)
        out = tuple(x.view_as(x) for x in xs)
        _keep_requires_grad(ctx, xs, out, 1)
        return out

    @staticmethod
    def backward(ctx, *grads):
        c = _counter()
        if c is not None:
            c.scale = ctx.scale
        return (None,) + grads


class _Slices(torch.autograd.Function):
    """The representative slices of each input along ``dim``: views at the
    indices ``picks``; its backward stacks each slice's gradient as many
    times as ``reps`` says, the gradient of ``unbind``, at scale
    ``scale``. With ``region`` (the node loop) it ends and materializes
    the backward region first, and drops each gradient once stacked."""

    @staticmethod
    def forward(ctx, spec, *xs):
        dim, picks, reps, scale, region = spec
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        out = tuple(x.select(dim, p) for x in xs for p in picks)
        _keep_requires_grad(ctx, xs, out, len(picks))
        return out

    @staticmethod
    def backward(ctx, *grads):
        dim, picks, reps, scale, region = ctx.spec
        c = _counter()
        if c is not None:
            if region is not None and region[0] is not None:
                c.end_region(region[0])
                c.materialize(region[0])
                region[0] = None
            c.scale = scale
        k = len(picks)
        out = [None]
        for i in range(len(grads) // k):
            gs = grads[i * k:(i + 1) * k]
            if not ctx.needs_input_grad[i + 1] or all(g is None for g in gs):
                out.append(None)
                continue
            like = next(g for g in gs if g is not None)
            gs = [torch.zeros_like(like) if g is None else g for g in gs]
            out.append(_repeat(gs, reps, dim, cat=False))
            if c is not None and region is not None:
                c.drop(gs)
        return tuple(out)


class _Combine(torch.autograd.Function):
    """``torch.stack`` (or ``torch.cat``) of the representative outputs,
    each repeated as ``reps`` says, along ``dim``; its backward hands each
    its slice of the gradient (views, as the combine's own backward does)
    at scale ``scale``, and opens the node loop's backward region."""

    @staticmethod
    def forward(ctx, spec, *ys):
        dim, reps, cat, scale, region = spec
        ctx.spec = spec
        ctx.widths = [y.shape[dim] if cat else 1 for y in ys]
        ctx.set_materialize_grads(False)
        return _repeat(ys, reps, dim, cat)

    @staticmethod
    def backward(ctx, grad):
        dim, reps, cat, scale, region = ctx.spec
        c = _counter()
        if c is not None:
            c.scale = scale
            if region is not None:
                region[0] = c.begin_region(region[1], backward=True)
        if grad is None:
            return (None,) * (1 + len(reps))
        out, start = [None], 0
        for width, r in zip(ctx.widths, reps):
            out.append(grad.narrow(dim, start, width) if cat
                       else grad.select(dim, start))
            start += r * (width if cat else 1)
        return tuple(out)


def node_loop(body: Callable, n: int, p_leaves: list, b_leaves: list,
              rebuild: Callable) -> torch.Tensor:
    """``torch.stack([body(*rebuild(i)) for i in range(n)])`` where node
    i's inputs are the i-th slices of the node-stacked ``p_leaves`` and
    ``b_leaves`` (tensors, or objects with ``parts`` and ``unbind``);
    ``rebuild(p_i, b_i)`` gives body's arguments from node i's slices.
    Under a counter, node 0's body stands for all n (module docstring)."""
    flat = [t for x in p_leaves + b_leaves
            for t in (x.parts if hasattr(x, "parts") else (x,))]
    c = _ruled(flat) if n > 1 else None
    if c is None:
        p_nodes = [x.unbind(0) for x in p_leaves]
        b_nodes = [x.unbind(0) for x in b_leaves]
        return torch.stack([body(*rebuild([p[i] for p in p_nodes],
                                          [b[i] for b in b_nodes]))
                            for i in range(n)])
    outer = c.scale
    region = [None, n]
    views = iter(_apply(_Slices, (0, (0,), (n,), outer, region), *flat))
    p0 = [type(x)(tuple(next(views) for _ in x.parts), layer_axis=0)
          if hasattr(x, "parts") else next(views) for x in p_leaves]
    b0 = [next(views) for _ in b_leaves]
    token = c.begin_region(n)
    c.scale = outer * n
    try:
        loss = body(*rebuild(p0, b0))
    finally:
        c.scale = outer
    c.end_region(token)
    c.materialize(token)
    del p0, b0, views
    return _apply(_Combine, (0, (n,), False, outer * n, region), loss)


def _tie(carry, scale: int):
    """``carry`` (a tensor or a tuple of them) through :class:`_Scaled`."""
    if isinstance(carry, torch.Tensor):
        return _apply(_Scaled, scale, carry)[0]
    return type(carry)(_apply(_Scaled, scale, *carry))


def time_loop(step: Callable, carry: Any, xs: Sequence[torch.Tensor], *,
              dim: int = 1, out_dim: int = 1, cat: bool = False):
    """The recurrence ``carry, y_t = step(carry, slices_t)`` over the
    positions of ``xs`` along ``dim`` -> (the y_t stacked along ``out_dim``
    (concatenated with ``cat``), the final carry). ``carry`` is a tensor or
    a tuple of tensors. Under a counter, steps 0, 1 and S - 1 stand for
    all (module docstring)."""
    length = xs[0].shape[dim]
    c = _ruled(xs) if length > 3 else None
    if c is None:
        ys = []
        for inp in zip(*(x.unbind(dim) for x in xs)):
            carry, y = step(carry, inp)
            ys.append(y)
        return (torch.cat(ys, out_dim) if cat else torch.stack(ys, out_dim)), \
            carry
    outer, mid = c.scale, length - 2
    slices = _apply(_Slices, (dim, (0, 1, length - 1), (1, mid, 1), outer,
                              None), *xs)
    carry, y0 = step(carry, tuple(slices[0::3]))
    carry = _tie(carry, outer)
    token = c.begin_region(mid)
    c.scale = outer * mid
    try:
        carry, y1 = step(carry, tuple(slices[1::3]))
    finally:
        c.scale = outer
    c.end_region(token)
    carry, y2 = step(_tie(carry, outer * mid), tuple(slices[2::3]))
    # what a middle step leaves alive after the last one: its output, and
    # under grad its saved tensors and carry
    c.materialize(token)
    del slices
    out = _apply(_Combine, (out_dim, (1, mid, 1), cat, outer, None), y0, y1,
                 y2)
    return out, carry
