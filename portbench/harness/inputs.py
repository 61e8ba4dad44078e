"""The cells' inputs, made from the run's seed on the device in a few
large calls: the same seed gives the same inputs, which the program and
the reference are both handed.

* :func:`generator`: a ``torch.Generator`` on a device seeded from a list
  of integers through numpy's ``SeedSequence`` (a pure function of them).
* :func:`markov_tokens`: codebook streams of a random low-rank
  first-order Markov chain, ``softmax(ctx[tok] @ emit / temp[node])``,
  with a temperature for each node (non-IID nodes): a copy of the token
  generator of the program's ``data/synthetic.py`` (``SyntheticLMStream``),
  sampling every stream of every step at once.
* :func:`frame_table`: the frame embedding of each codebook entry, so the
  frames a model reads carry the token it must continue.
* :func:`decoder_params`: one node's decoder parameters, one normal draw
  for all of them, each matrix scaled by 1 / sqrt(fan_in), norm scales 1.
* :func:`consensus_values`: each node's private values, standard normal.
"""
from __future__ import annotations

import numpy as np
import torch

# salts of the seed, one for each kind of input
WEIGHTS, TOKENS, FRAMES, VALUES, SAMPLE = 1, 2, 3, 4, 5


def generator(device, *keys: int) -> torch.Generator:
    state = np.random.SeedSequence([int(k) % (1 << 64) for k in keys])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def markov_tokens(seed: int, *, vocab: int, seq_len: int, n_nodes: int,
                  streams: int, device, rank: int = 64,
                  node_skew: float = 0.5) -> torch.Tensor:
    """(streams, n_nodes, seq_len) int64 codebook tokens."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    r = min(rank, vocab)
    emit = torch.as_tensor(rng.normal(size=(r, vocab)) * 2.0,
                           dtype=torch.float32, device=device)
    ctx = torch.as_tensor(rng.normal(size=(vocab, r)), dtype=torch.float32,
                          device=device)
    temp = torch.as_tensor(
        1.0 + node_skew * rng.uniform(-1, 1, size=(n_nodes,)),
        dtype=torch.float32, device=device)[None, :, None]
    gen = generator(device, seed, TOKENS)
    tok = torch.randint(0, vocab, (streams, n_nodes), generator=gen,
                        device=device)
    out = torch.empty((streams, n_nodes, seq_len), dtype=torch.int64,
                      device=device)
    out[..., 0] = tok
    for p in range(1, seq_len):
        logits = ctx[tok] @ emit / temp
        u = torch.rand(logits.shape, generator=gen, device=device)
        g = -torch.log(-torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny)))
        tok = torch.argmax(logits + g, dim=-1)
        out[..., p] = tok
    return out


def frame_table(seed: int, *, vocab: int, d_model: int,
                device) -> torch.Tensor:
    """(vocab, d_model) frame embeddings, normal."""
    return torch.randn((vocab, d_model), generator=generator(
        device, seed, FRAMES), device=device)


def decoder_params(seed: int, shapes, device) -> list[torch.Tensor]:
    """One node's parameters for ``shapes`` [(path, shape)], as views
    into one buffer drawn in a single call."""
    sizes = [int(np.prod(shape)) for _, shape in shapes]
    flat = torch.randn((sum(sizes),), generator=generator(
        device, seed, WEIGHTS), device=device)
    out, off = [], 0
    for (path, shape), size in zip(shapes, sizes):
        leaf = flat[off:off + size].view(shape)
        off += size
        if path.endswith("/scale"):
            leaf.fill_(1.0)
        else:  # fan_in: the dim a matrix contracts, the second to last
            leaf.mul_(1.0 / float(np.sqrt(shape[-2])))
        out.append(leaf)
    return out


def consensus_values(seed: int, n_nodes: int, d_s: int,
                     device) -> torch.Tensor:
    """(n_nodes, d_s) private values, standard normal."""
    return torch.randn((n_nodes, d_s), generator=generator(
        device, seed, VALUES), device=device)


def sample(seed: int, population: int, count: int, *keys: int) -> np.ndarray:
    """``count`` distinct sorted integers of [0, population), from the
    seed (and ``keys``), never more than the population."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), SAMPLE, *keys]))
    count = min(count, population)
    return np.sort(rng.choice(population, size=count, replace=False))
