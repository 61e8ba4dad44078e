"""Faults planted in the program under test, for showing that a run with
the timed path broken underneath comes out not ``correct``: each fault a
cell can have. ``plant(name, cell)`` patches the program's modules and
returns a call that undoes it. The benchmark's own runs never plant one;
``run.py --fault`` does on the card, at the cell's own size, and
``portbench/tests/test_pb_faults.py`` at smoke size on the CPU."""
from __future__ import annotations

TRAIN = ("unchanged", "half_batch", "no_exchange", "no_sync", "altered")
CONSENSUS = ("unchanged", "no_exchange", "altered")


def names(cell_name: str) -> tuple[str, ...]:
    return TRAIN if cell_name.endswith(".train") else CONSENSUS


class _Patch:
    def __init__(self):
        self.undo = []

    def set(self, obj, attr, value):
        self.undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def __call__(self):
        while self.undo:
            obj, attr, old = self.undo.pop()
            setattr(obj, attr, old)


def _unchanged(step):
    """A step that returns its state unchanged (its counter advanced)."""
    def wrapped(state, *args, **kwargs):
        _, diag = step(state, *args, **kwargs)
        if hasattr(state, "dpps"):
            return state._replace(dpps=state.dpps._replace(
                t=state.dpps.t + 1)), diag
        return state._replace(t=state.t + 1), diag
    return wrapped


def _half_batch(patch):
    """Half of each node's frames left out, the mean over the rest."""
    from repro_torch.models.transformer import Transformer
    loss = Transformer.loss_fn

    def half(self, params, batch):
        s = batch["labels"].shape[-1] // 2
        return loss(self, params, {"embeds": batch["embeds"][:, :s],
                                   "labels": batch["labels"][:, :s]})
    patch.set(Transformer, "loss_fn", half)


def _altered_train(patch):
    """One node's head altered where the step produces it."""
    import repro_torch.engine.rounds as rounds
    step = rounds.partpsp_step

    def altered(state, *args, **kwargs):
        st, diag = step(state, *args, **kwargs)
        local = list(st.local)
        head = local[-1].clone()   # lm_head, last in leaf order
        head[0] *= 1.001
        local[-1] = head
        return st._replace(local=local), diag
    patch.set(rounds, "partpsp_step", altered)


def _altered_consensus(patch):
    """One value of one node altered where the round produces it."""
    import repro_torch.engine.rounds as rounds
    step = rounds.dpps_step

    def altered(state, *args, **kwargs):
        st, diag = step(state, *args, **kwargs)
        s = st.push.s.clone()
        s[0, 3] += 1.0
        return st._replace(push=st.push._replace(s=s)), diag
    patch.set(rounds, "dpps_step", altered)


def plant(name: str, cell_name: str):
    """Plant fault ``name`` for the cell -> a call that removes it."""
    import repro_torch.core.dpps as dpps
    import repro_torch.engine.rounds as rounds

    if name not in names(cell_name):
        raise ValueError(f"no fault {name!r} for {cell_name} "
                         f"(faults: {', '.join(names(cell_name))})")
    patch = _Patch()
    train = cell_name.endswith(".train")
    if name == "unchanged":
        step = "partpsp_step" if train else "dpps_step"
        patch.set(rounds, step, _unchanged(getattr(rounds, step)))
    elif name == "no_exchange":
        # the mix between nodes left out: each keeps its noised values
        patch.set(dpps, "gossip_packed", lambda state, **kw: state)
    elif name == "no_sync":
        # the full synchronisation run as an ordinary gossip round
        patch.set(dpps, "is_sync_round", lambda t, k: False)
    elif name == "half_batch":
        _half_batch(patch)
    elif train:
        _altered_train(patch)
    else:
        _altered_consensus(patch)
    return patch
