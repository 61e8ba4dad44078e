"""The port's serving path against the reference: ``Session.serve``,
``run_decode`` and the serve CLI, on the CPU.

The reference samples with ``jax.random.categorical``; the port samples
``argmax(logits / T + g)``, the same rule, with g fed through ``noise_at``
as the reference drew it (``test_torch_reference.reference_gumbel``). The
tokens must then be equal: the logits agree to 1e-4 and a near-tie at that
level among the smoke vocabularies' Gumbel-perturbed logits would be a
1-in-10^4 event per token, which these seeds do not hit. The VLM gets
seeded image embeddings (``batch["image_embeds"]`` and ``enc=``) and its
cross-attention gates at 0.5 in both packages' parameters.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.api import ServeReport, Session
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.engine.rounds import run_decode
from repro_torch.launch import serve as serve_cli
from repro_torch.models.attention import open_cross_gates
from repro_torch.models.transformer import Transformer
from test_torch_models import cache_leaves, cfg_to_reference, image_embeds
from test_torch_reference import load_reference, reference_gumbel

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 7


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _setup(R, cfg, b, s, gen):
    ref_model = R.models.Transformer(cfg_to_reference(R, cfg))
    key = jax.random.PRNGKey(SEED)
    params = open_cross_gates(jax.tree_util.tree_map(np.asarray,
                                                     ref_model.init(key)))
    rng = np.random.default_rng(SEED)
    step_inputs = None
    if cfg.input_mode == "embeddings":
        emb = (rng.normal(size=(b, s, cfg.d_model)) * 0.1).astype(np.float32)
        ref_batch = {"embeds": emb, "labels": np.zeros((b, s), np.int32)}
        port_batch = {"embeds": torch.tensor(emb)}
        if gen > 1:
            step_inputs = (rng.normal(size=(gen - 1, b, cfg.d_model))
                           * 0.1).astype(np.float32)
    else:
        toks = rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)
        ref_batch = {"tokens": toks}
        port_batch = {"tokens": torch.tensor(toks.astype(np.int64))}
    enc = image_embeds(cfg, b, SEED)
    if enc is not None:
        ref_batch["image_embeds"] = enc
        port_batch["image_embeds"] = torch.tensor(enc)
    return ref_model, key, params, ref_batch, port_batch, step_inputs, enc


@pytest.mark.parametrize("arch,flash,gen", [
    ("llama3.2-1b", False, 6), ("llama3.2-1b", True, 6), ("llama3.2-1b", False, 1),
    ("gemma3-1b", True, 5), ("minitron-4b", False, 4), ("gemma-7b", True, 3),
    ("musicgen-large", False, 5), ("musicgen-large", True, 1),
    ("llama4-scout-17b-a16e", True, 6), ("llama4-maverick-400b-a17b", False, 5),
    ("xlstm-125m", False, 6), ("zamba2-7b", True, 6),
    ("llama-3.2-vision-11b", True, 5), ("llama-3.2-vision-11b", False, 1)])
def test_serve_tokens_equal_the_references(R, arch, flash, gen):
    cfg = dataclasses.replace(get_config(arch).smoke, flash_prefill=flash)
    b, s, temp = 2, 12, 0.8
    ref_model, key, params, ref_batch, port_batch, step_inputs, enc = _setup(
        R, cfg, b, s, gen)
    ref_rep = R.api.Session.build(model=ref_model, key=key).serve(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, ref_batch), gen=gen,
        temperature=temp, key=key,
        enc=None if enc is None else jnp.asarray(enc),
        step_inputs=None if step_inputs is None else jnp.asarray(step_inputs))
    noise = torch.tensor(reference_gumbel(key, gen - 1, b, cfg.vocab_size))
    model = Transformer(cfg)
    rep = Session.build(model=model, device="cpu").serve(
        convert.transformer_params_from_reference(params, cfg, device="cpu"),
        port_batch, gen=gen, temperature=temp,
        step_inputs=None if step_inputs is None else torch.tensor(step_inputs),
        noise_at=lambda t: noise[t],
        enc=None if enc is None else torch.tensor(enc))
    assert isinstance(rep, ServeReport) and rep.steps == gen - 1
    assert tuple(rep.tokens.shape) == (b, gen)
    np.testing.assert_array_equal(rep.tokens.numpy(), np.asarray(ref_rep.tokens))
    # every KV cache was made at prompt + gen slots, as the reference grafts
    # it (an attention group of one window: that many)
    window = getattr(model.groups[0], "uniform_window", None)
    kv = {p: x.shape[-3] for p, x in cache_leaves(rep.cache).items()
          if p.rsplit("/", 1)[-1] in ("k", "v")}
    assert set(kv.values()) <= {min(s + gen, window or s + gen)}
    assert bool(kv) == (arch != "xlstm-125m")
    assert rep.logits.shape == (b, cfg.vocab_size)
    assert rep.ms_per_token >= 0.0


def test_serve_default_noise_is_seeded_and_in_range():
    cfg = get_config("llama3.2-1b").smoke
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (3, 9),
                                    generator=torch.Generator().manual_seed(1))}
    reps = [Session.build(model=model, seed=seed, device="cpu").serve(
        params, toks, gen=8) for seed in (3, 3, 4)]
    assert torch.equal(reps[0].tokens, reps[1].tokens)
    assert not torch.equal(reps[0].tokens, reps[2].tokens)
    assert bool(((reps[0].tokens >= 0) & (reps[0].tokens < cfg.vocab_size)).all())


def test_run_decode_needs_noise_and_feeds_the_sample_back():
    seen = []

    def decode_fn(cache, tok, pos):
        seen.append((tok.tolist(), pos))
        logits = torch.zeros((2, 5))
        logits[:, pos % 5] = 10.0
        return logits, cache + 1

    with pytest.raises(ValueError, match="generator"):
        run_decode(decode_fn, 0, torch.zeros(2, dtype=torch.int64),
                   start_pos=3, steps=2)
    toks, cache = run_decode(decode_fn, 0, torch.tensor([1, 2]), start_pos=3,
                             steps=3, noise_at=lambda t: torch.zeros((2, 5)))
    assert cache == 3 and toks.tolist() == [[3, 3], [4, 4], [0, 0]]
    assert seen == [([1, 2], 3), ([3, 3], 4), ([4, 4], 5)]
    toks, cache = run_decode(decode_fn, 0, torch.tensor([1, 2]), start_pos=0,
                             steps=0, generator=torch.Generator())
    assert toks.shape == (0, 2) and cache == 0


def test_serve_cli_runs_on_the_cpu(capsys, tmp_path):
    """A fresh model, then one restored from a checkpoint of other params
    (the step printed as the reference's CLI prints it)."""
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "6"]
    serve_cli.main(argv)
    out = capsys.readouterr().out
    assert "decode: 5 steps" in out and "generated token ids" in out
    fresh = out.split("generated token ids")[1]
    model = Transformer(get_config("llama3.2-1b").smoke)
    save_checkpoint(str(tmp_path), model.init(
        torch.Generator().manual_seed(9), device="cpu"), step=7)
    serve_cli.main(argv + ["--checkpoint", str(tmp_path)])
    out = capsys.readouterr().out
    assert "restored checkpoint (step 7)" in out and "decode: 5 steps" in out
    assert out.split("generated token ids")[1] != fresh


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "zamba2-7b",
                                  "llama4-scout-17b-a16e"])
def test_serve_cli_serves_the_other_group_kinds(capsys, arch):
    """The VLM with its image embeddings drawn by the CLI, the hybrid and
    the MoE, at their smoke configs on the CPU."""
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "decode: 3 steps" in out and "generated token ids" in out


def test_serve_of_the_vlm_needs_its_image_embeddings():
    cfg = get_config("llama-3.2-vision-11b").smoke
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="image_embeds"):
        Session.build(model=model, device="cpu").serve(
            params, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}, gen=2)


# -- (vi) guards -------------------------------------------------------------

def test_serve_entry_points_need_a_card_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b").smoke
    model = Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Session.build(model=model)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 4)
    from repro_torch.core.tree_utils import tree_map

    params = tree_map(lambda x: x.numpy(),
                      model.init(torch.Generator(), device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.transformer_params_from_reference(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--reduced"])
    with pytest.raises(ValueError, match="topology"):
        Session.build(device="cpu")
    session = Session.build(model=model, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        session.run(1, values={"x": torch.zeros((2, 3))})


def test_serving_modules_load_no_jax():
    """Importing the serving path leaves jax out of ``sys.modules`` (the
    AST guard in test_torch_session.py covers every file's imports)."""
    code = ("import sys; import repro_torch.launch.serve, "
            "repro_torch.models.transformer, repro_torch.configs, "
            "repro_torch.convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
