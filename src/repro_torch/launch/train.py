"""PartPSP training driver of the port (port of ``repro.launch.train``).

Trains any architecture of the zoo across N nodes on the synthetic Markov
token stream: the model of ``--arch`` (``--reduced``: its smoke config),
the arch's PartPSP partition rules, ``Session.build(..., model=...)`` and
``Session.train``. On the CUDA card by default; pass ``--device cpu`` for
the plain PyTorch path.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --device cpu --nodes 4 --steps 5 --gamma-n 1e-6
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --reduced --device cpu --nodes 4 --steps 3 --gamma-n 1e-6 \\
        --checkpoint ckpt

Flags follow the reference's; the topology, fault, delay and protocol
flags and their parse-time checks come from :mod:`repro_torch.api.cli`:
``--algorithm {partpsp,sgp,sgpdp,pedfl}``,
``--b``, ``--gamma-n``, ``--gamma-l``, ``--gamma-s``, ``--clip``,
``--topology`` (the registry's families) with ``--degree``, the
random families' knobs and ``--resample-period`` (a random family redrawn
every round), ``--sync-interval``, ``--schedule {dense,circulant,sparse}``,
``--use-kernels`` (the CUDA kernels; raises off the card), ``--chunk``
(rounds a segment), ``--packed`` / ``--no-packed`` (the pytree runtime),
the faults' ``--drop-rate``, ``--straggler-rate``, ``--churn
NODE:T_DOWN:T_UP`` (repeatable) and ``--fault-seed``, the delays'
``--max-delay``, ``--timeout-rate``, ``--node-rates r0,r1,...`` and
``--delay-seed`` (they need ``--sync-interval 0``), ``--wire SPEC`` (the wire
codec: ``f32 | bf16 | int8 | topk:K | topk:1/M``, applied after the noise;
it needs ``--packed`` and ``--driver engine``, and bf16 refuses the delay
flags) with the older ``--wire-dtype {f32,bf16}`` (warns once, maps to
``--wire bf16``), ``--checkpoint DIR`` (the consensus view for
``launch.serve --checkpoint``), ``--driver {engine,loop}`` (``loop``: the
per-round driver over the pytree runtime), ``--ledger-out FILE`` (the
per-round privacy ledger as JSONL), ``--privacy-budget EPS`` with
``--strict-budget`` (abort once the budget is exceeded: no checkpoint is
written and the run exits through ``SystemExit``) and ``--metrics-out
FILE`` (the ``MetricsHook`` history as JSON). Every flag of the
reference's launcher is taken. The batches
carry tokens only (embeddings for an embedding-input model), as the
reference's do: llama-3.2-vision-11b, which needs image embeddings, fails
with a ``ValueError`` naming ``image_embeds``, as the reference's
assertion does. The run always goes under a ``LedgerHook`` and a
``MetricsHook``, as the reference's does: every ``--log-every`` steps (and
the last) a line gives the loss, the sensitivity used and the mean
seconds a step so far, at each segment boundary, and the run ends with
``privacy: {ledger summary}``.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --driver loop --ledger-out /tmp/l.jsonl \\
        --privacy-budget 5 --strict-budget
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.api import (BudgetHook, LedgerHook, MetricsHook,
                             PrivacySpec, Session)
from repro_torch.api.cli import (TOPOLOGY_CHOICES, add_delay_arguments,
                                 add_fault_arguments, add_protocol_arguments,
                                 add_topology_arguments, delays_from_args,
                                 faults_from_args, make_topology,
                                 topology_from_args, validate_protocol_args,
                                 wire_from_args)
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import NodeShardedLoader, SyntheticLMStream
from repro_torch.data.pipeline import seeded_generator
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer

# the registry and the flag parsers live in repro_torch.api.cli; the names
# stay importable from here, as the reference's launcher imports them
__all__ = ["TOPOLOGY_CHOICES", "make_topology", "build_session",
           "build_trainer", "build_engine_trainer", "faults_from_args", "delays_from_args", "wire_from_args", "main"]


def build_session(arch_name: str, *, reduced: bool, n_nodes: int,
                  algorithm: str, b: float, gamma_n: float, gamma_l: float,
                  gamma_s: float, clip: float, topology, degree: int = 2,
                  sync_interval: int = 5, schedule: str = "dense",
                  seed: int = 0, device=None, use_kernels: bool | None = None,
                  chunk: int = 50, packed: bool = True, faults=None,
                  delays=None, wire=None):
    """Arch-specific assembly -> (model, model config, session), as the
    reference's ``build_session``: the model and the partition rules (full
    sharing for SGP/SGPDP, split points clamped to 1 on the 2-layer smoke
    stacks); every protocol decision is ``Session.build``'s. ``topology``
    is a :data:`TOPOLOGY_CHOICES` name or a Topology."""
    arch = get_config(arch_name)
    model_cfg = arch.smoke if reduced else arch.model
    model = Transformer(model_cfg)
    topo = (topology if not isinstance(topology, str)
            else make_topology(topology, n_nodes, degree=degree))
    rules = (((".*", "shared"),) if algorithm in ("sgp", "sgpdp")
             else tuple(arch.shared_rules))
    if reduced:
        rules = tuple((pat, ("split_layers", 1) if isinstance(act, tuple)
                       else act) for pat, act in rules)
    session = Session.build(
        topo, privacy=PrivacySpec(b=b, gamma_n=gamma_n), model=model,
        partition=rules, algorithm=algorithm, gamma_l=gamma_l,
        gamma_s=gamma_s, clip=clip, schedule=schedule,
        sync_interval=sync_interval, seed=seed, device=device,
        use_kernels=use_kernels, chunk=chunk, packed=packed, faults=faults,
        delays=delays, wire=wire)
    return model, model_cfg, session


def build_trainer(arch_name: str, **kwargs):
    """The per-round driver over :func:`build_session`'s session: ``(model,
    model_cfg, topo, cfg, partition, state, step)``, ``step`` its
    ``step_fn()`` (round 0's mixing operands bound; call it ``step(state,
    batch, seed=...)``), as the reference's tuple."""
    model, model_cfg, session = build_session(arch_name, **kwargs)
    return (model, model_cfg, session.topology, session.train_cfg,
            session.partition, session.train_state(), session.step_fn())


def build_engine_trainer(arch_name: str, *, chunk: int = 50,
                         packed: bool = True, **kwargs):
    """The engine driver over :func:`build_session`'s session: ``(model,
    model_cfg, topo, cfg, partition, state, run_chunk, plan)``, ``run_chunk``
    its ``segment_runner()`` (call it ``run_chunk(state, batch_at,
    rounds=n, seed=...)``, or drive it with
    :func:`repro_torch.engine.run_segments`), as the reference's tuple."""
    model, model_cfg, session = build_session(arch_name, chunk=chunk,
                                              packed=packed, **kwargs)
    return (model, model_cfg, session.topology, session.train_cfg,
            session.partition, session.train_state(),
            session.segment_runner(), session.plan)


def lm_batches(model_cfg, loader: NodeShardedLoader):
    """``batch_at(t)`` of the loader's token batches; an embedding-input
    model gets Gaussian embeddings (scale 0.1, from a generator seeded by
    (7, t)) with the tokens as its labels, as the reference's driver
    makes them."""
    if model_cfg.input_mode != "embeddings":
        return loader.batch_at
    dev = loader.generator.device

    def batch_at(t: int) -> dict:
        toks = loader.batch_at(t)["tokens"]
        embeds = torch.randn(tuple(toks.shape) + (model_cfg.d_model,),
                             generator=seeded_generator(dev, 7, t),
                             device=dev) * 0.1
        return {"embeds": embeds, "labels": toks}

    return batch_at


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU friendly)")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--per-node-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--algorithm", choices=("partpsp", "sgp", "sgpdp", "pedfl"),
                    default="partpsp")
    ap.add_argument("--b", type=float, default=3.0)
    ap.add_argument("--gamma-n", type=float, default=0.003)
    ap.add_argument("--gamma-l", type=float, default=0.05)
    ap.add_argument("--gamma-s", type=float, default=0.05)
    ap.add_argument("--clip", type=float, default=100.0)
    add_topology_arguments(ap)
    add_fault_arguments(ap)
    add_delay_arguments(ap)
    ap.add_argument("--sync-interval", type=int, default=5)
    ap.add_argument("--schedule", choices=("dense", "circulant", "sparse"),
                    default="dense")
    ap.add_argument("--use-kernels", action="store_true",
                    help="the CUDA kernels (the default on the card; raises "
                         "on another device)")
    ap.add_argument("--seed", type=int, default=2024)   # the paper's seed
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--checkpoint", default=None,
                    help="write the consensus params (s-bar + node 0's "
                         "local ones) here for serving")
    ap.add_argument("--driver", choices=("engine", "loop"), default="engine",
                    help="loop: the per-round driver over the pytree runtime")
    ap.add_argument("--ledger-out", default=None,
                    help="stream the per-round privacy ledger to this JSONL")
    ap.add_argument("--metrics-out", default=None,
                    help="write the per-step metrics history here (JSON)")
    ap.add_argument("--privacy-budget", type=float, default=None,
                    help="total epsilon ceiling for the run")
    ap.add_argument("--strict-budget", action="store_true",
                    help="abort training once --privacy-budget is exceeded")
    add_protocol_arguments(ap)
    return ap


def main(argv=None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    validate_protocol_args(ap, args)
    topo = topology_from_args(ap, args, args.nodes)
    faults = faults_from_args(ap, args, n_nodes=args.nodes)
    delays = delays_from_args(ap, args, n_nodes=args.nodes)
    wire = wire_from_args(ap, args)
    if delays is not None and args.sync_interval:
        ap.error("--max-delay/--timeout-rate/--node-rates need "
                 "--sync-interval 0: a synchronization round would average "
                 "exact values while mass is still in flight in mailboxes")
    if delays is not None and args.schedule == "circulant":
        ap.error("--max-delay/--timeout-rate/--node-rates need --schedule "
                 "dense or sparse: the mailbox runtime consumes per-round "
                 "weight operands, not circulant offsets")
    if args.schedule == "circulant" and topo.offsets(0) is None:
        ap.error(f"--topology {args.topology} is not circulant "
                 f"({type(topo).__name__} has no offset structure); use "
                 "--schedule dense")
    if faults is not None and args.schedule == "circulant":
        ap.error("--drop-rate/--straggler-rate need --schedule dense or "
                 "sparse: masked edges break circulant structure (dense "
                 "switches to the dynamic schedule internally; sparse "
                 "masks its edge list in place)")
    dev = resolve_device(args.device)
    model, model_cfg, session = build_session(
        args.arch, reduced=args.reduced, n_nodes=args.nodes,
        algorithm=args.algorithm, b=args.b, gamma_n=args.gamma_n,
        gamma_l=args.gamma_l, gamma_s=args.gamma_s, clip=args.clip,
        topology=topo, sync_interval=args.sync_interval,
        schedule=args.schedule, seed=args.seed, device=dev,
        use_kernels=True if args.use_kernels else None, chunk=args.chunk,
        packed=args.packed, faults=faults, delays=delays, wire=wire)
    part = session.partition
    print(f"arch={args.arch} ({'reduced' if args.reduced else 'FULL'}) "
          f"algorithm={args.algorithm} nodes={args.nodes} "
          f"topo={args.topology}(d={args.degree}) "
          f"schedule={session.plan.schedule} device={dev} "
          f"kernels={session.plan.use_kernels} "
          f"driver={args.driver}[{'packed' if args.packed else 'pytree'}] "
          f"faults={faults} delays={delays} "
          f"wire={wire.name if wire is not None else 'f32'} "
          f"d_s={part.d_shared():,} d_l={part.d_local():,}")

    stream = SyntheticLMStream(vocab_size=model_cfg.vocab_size,
                               seq_len=args.seq_len, n_nodes=args.nodes,
                               seed=args.seed, device=dev)
    loader = NodeShardedLoader(stream, per_node_batch=args.per_node_batch,
                               seed=args.seed)
    batch_at = lm_batches(model_cfg, loader)

    t0 = time.perf_counter()
    metrics = MetricsHook(
        fields={"loss": "loss_mean", "sensitivity": "sensitivity_used",
                "grad_l1_max": "grad_l1_max"},
        log_every=args.log_every, total=args.steps,
        formatter=lambda r: (f"step {r['step']:5d} loss={r['loss']:.4f} "
                             f"S={r['sensitivity']:.3f} "
                             f"({(time.perf_counter() - t0) / (r['step'] + 1):.2f}"
                             f"s/step)"))
    ledger = LedgerHook(path=args.ledger_out, budget=args.privacy_budget)
    hooks = [ledger, metrics]
    if args.privacy_budget is not None:
        note = (" (engine driver enforces at segment granularity)"
                if args.driver == "engine" else "")
        hooks.append(BudgetHook(args.privacy_budget,
                                strict=args.strict_budget, note=note))

    report = session.train(args.steps, batch_at, hooks=hooks,
                           driver=args.driver)

    print("privacy:", json.dumps(ledger.summary()))
    if args.ledger_out:
        print("privacy ledger written to", args.ledger_out)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics.history, f, indent=1)
    if args.checkpoint and not report.aborted:
        # consensus shared params are identical across nodes; persist node
        # 0's view (s-bar + its personalised local params) for serving
        session.save_consensus(args.checkpoint, report.state,
                               step=report.rounds,
                               metadata={"arch": args.arch,
                                         "algorithm": args.algorithm})
        print("checkpoint written to", args.checkpoint)
    if report.aborted:
        if args.checkpoint:
            # strict mode never releases over-budget parameters, the
            # serving checkpoint included
            print("checkpoint NOT written (over budget):", args.checkpoint)
        raise SystemExit(
            "aborted: privacy budget exhausted (--strict-budget)")


if __name__ == "__main__":
    main()
