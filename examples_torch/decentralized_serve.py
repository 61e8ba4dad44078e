"""Serve the consensus model on the port (the counterpart of
``examples/decentralized_serve.py``): train briefly with PartPSP, take the
network-average shared parameters s-bar (the protocol output) with node
0's local ones, and decode a batch autoregressively with the KV cache.

One session drives both phases: ``session.train`` for the protocol (on the
card: ``l1_norm.cu``, ``dpps_perturb.cu`` and the dense ``pushsum_mix.cu``
every round) and ``session.serve`` for the prefill and decode.

    PYTHONPATH=src python examples_torch/decentralized_serve.py
    PYTHONPATH=src python examples_torch/decentralized_serve.py --device cpu

``--rounds`` (the port's addition; default the reference's fixed 30) sets
the PartPSP rounds before serving.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.data import NodeShardedLoader, SyntheticLMStream
from repro_torch.data.pipeline import seeded_generator
from repro_torch.launch.train import build_session

ARCH = "gemma3-1b"   # reduced variant: sliding-window + global attention
B, PROMPT, GEN = 2, 12, 12


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    model, cfg_model, session = build_session(
        ARCH, reduced=True, n_nodes=4, algorithm="partpsp", b=3.0,
        gamma_n=1e-6, gamma_l=0.05, gamma_s=0.05, clip=100.0,
        topology="dout", degree=2, sync_interval=5, schedule="dense",
        device=args.device)

    stream = SyntheticLMStream(vocab_size=cfg_model.vocab_size, seq_len=32,
                               n_nodes=4, seed=0, device=session.device)
    loader = NodeShardedLoader(stream, per_node_batch=4, seed=0)
    print(f"training {args.rounds} PartPSP rounds...")
    report = session.train(args.rounds, loader.batch_at)
    print(f"final loss {float(report.trajectory['loss_mean'][-1]):.3f} "
          f"(epsilon spent: {report.epsilon_spent:.1e})")

    # protocol output: s-bar + (node 0's) local parameters
    params = session.consensus_view(report.state, 0)

    dev = session.device
    toks = torch.randint(0, cfg_model.vocab_size, (B, PROMPT),
                         generator=seeded_generator(dev, 7), device=dev)
    served = session.serve(params, {"tokens": toks}, gen=GEN,
                           generator=seeded_generator(dev, 7, 1))
    print("prompt :", toks[0].tolist())
    print("greedy+sampled continuation:", served.tokens[0].tolist())
    return dict(session=session, report=report, prompt=toks, serve=served,
                vocab_size=cfg_model.vocab_size)


if __name__ == "__main__":
    main()
