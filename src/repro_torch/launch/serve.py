"""Serving driver of the port: batched prefill + decode on a fresh model
(port of ``repro.launch.serve``).

Builds the model of ``--arch`` (``--reduced``: its smoke config) from a
seeded ``torch.Generator`` (``--checkpoint DIR``: then restores its params
from a checkpoint, such as ``launch.train --checkpoint`` writes), makes a
seeded batch of prompts and runs ``Session.build(model=...).serve(...)``. A VLM (llama-3.2-vision-11b) also
gets image embeddings, normal x 0.1 of (B, n_image_tokens, d_model), as
``batch["image_embeds"]`` and ``enc=``. On the card by default; pass
``--device cpu`` for the plain PyTorch path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --device cpu --batch 2 --prompt-len 8 --gen 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --reduced --device cpu --checkpoint ckpt
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.api import Session
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer


def model_params(model: Transformer, device, *, seed: int,
                 checkpoint: str | None = None):
    """-> (params, generator, checkpoint meta or None): ``model``'s params
    from a generator on ``device`` seeded with ``seed`` (the generator is
    returned, to draw the prompts after them) or, with ``checkpoint``,
    restored from it into the structure of those params."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device=device)
    meta = None
    if checkpoint:
        params, meta = load_checkpoint(checkpoint, params, device=device)
    return params, gen, meta


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    arch = get_config(args.arch)
    cfg = arch.smoke if args.reduced else arch.model
    dev = resolve_device(args.device)
    model = Transformer(cfg)
    params, gen, meta = model_params(model, dev, seed=args.seed,
                                     checkpoint=args.checkpoint)
    if meta is not None:
        print(f"restored checkpoint (step {meta['step']})")
    session = Session.build(model=model, seed=args.seed, device=dev)

    b, s = args.batch, args.prompt_len
    if cfg.input_mode == "embeddings":
        batch = {"embeds": torch.randn((b, s, cfg.d_model), generator=gen,
                                       device=dev) * 0.1}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device=dev)}
    enc = None
    if arch.family == "vlm":
        enc = torch.randn((b, cfg.groups[0].n_image_tokens, cfg.d_model),
                          generator=gen, device=dev) * 0.1
        batch["image_embeds"] = enc
    step_inputs = None
    if cfg.input_mode == "embeddings" and args.gen > 1:
        step_inputs = torch.randn((args.gen - 1, b, cfg.d_model),
                                  generator=gen, device=dev) * 0.1

    report = session.serve(params, batch, gen=args.gen,
                           temperature=args.temperature,
                           step_inputs=step_inputs, enc=enc)
    print(f"device: {dev}")
    print(f"prefill: {report.prefill_s:.2f}s")
    print(f"decode: {report.steps} steps in {report.decode_s:.2f}s "
          f"({report.ms_per_token:.1f} ms/token/batch)")
    print("generated token ids (first sequence):", report.tokens[0].tolist())


if __name__ == "__main__":
    main()
