"""Decentralized DP training of an assigned architecture with PartPSP
(paper Algorithm 2) on the port (the counterpart of
``examples/partpsp_train.py``).

The reduced llama3.2-1b by default; ``--full-scale`` runs the published
widths (llama3.2-1b: 16 layers, d_model 2048; ~57 GB at 4 nodes on one
80 GB card):

    PYTHONPATH=src python examples_torch/partpsp_train.py --steps 200
    PYTHONPATH=src python examples_torch/partpsp_train.py --full-scale \\
        --nodes 4 --steps 2
    PYTHONPATH=src python examples_torch/partpsp_train.py --device cpu \\
        --steps 8 --chunk 4 --nodes 4

A thin veneer over the session front door: ``launch/train.py``'s
``build_session`` assembles the architecture, ``session.train`` runs it
under a ``MetricsHook``, and the protocol flags are checked at the CLI.
The reference builds its session with seed 0 and trains with
``PRNGKey(1)``; the port's noise stream is keyed by the session's seed
(0), so the two draw different noise.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.api import (MetricsHook, add_protocol_arguments,
                             validate_protocol_args, wire_from_args)
from repro_torch.core.partpsp import privacy_summary
from repro_torch.data import NodeShardedLoader, SyntheticLMStream
from repro_torch.launch.train import build_session


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--b", type=float, default=3.0)
    ap.add_argument("--gamma-n", type=float, default=1e-6)
    ap.add_argument("--full-scale", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    add_protocol_arguments(ap, chunk=25)
    args = ap.parse_args(argv)
    validate_protocol_args(ap, args)

    model, cfg_model, session = build_session(
        args.arch, reduced=not args.full_scale, n_nodes=args.nodes,
        algorithm="partpsp", b=args.b, gamma_n=args.gamma_n,
        gamma_l=0.05, gamma_s=0.05, clip=100.0, topology="dout", degree=2,
        sync_interval=5, schedule="circulant", chunk=args.chunk,
        packed=args.packed, wire=wire_from_args(ap, args), seed=0,
        device=args.device)
    partition = session.partition

    mode = f"packed/{args.wire}" if args.packed else "pytree"
    print(f"PartPSP on {args.arch} ({'full' if args.full_scale else 'reduced'}) "
          f"| {args.nodes} nodes | d_s={partition.d_shared():,} "
          f"d_l={partition.d_local():,} | circulant gossip [{mode}] | "
          f"segments of {args.chunk}")

    stream = SyntheticLMStream(vocab_size=cfg_model.vocab_size, seq_len=64,
                               n_nodes=args.nodes, seed=0,
                               device=session.device)
    loader = NodeShardedLoader(stream, per_node_batch=4, seed=0)

    metrics = MetricsHook(
        fields={"loss": "loss_mean", "S": "sensitivity_used"},
        log_every=20, total=args.steps,
        formatter=lambda r: (f"step {r['step']:4d}  loss {r['loss']:.4f}  "
                             f"S {r['S']:.2f}"))
    report = session.train(args.steps, loader.batch_at, hooks=[metrics])

    summary = privacy_summary(session.train_cfg, args.steps)
    print("privacy:", json.dumps(summary))
    return dict(session=session, report=report, summary=summary,
                d_shared=partition.d_shared(), d_local=partition.d_local())


if __name__ == "__main__":
    main()
