"""The privacy audit lab of the port (``repro_torch.audit``: mechanisms, the
transcript tap, threat models, the attack battery) against the
reference's, on the CPU.

* ``LaplaceMechanism()`` (scale factor 1) is bit for bit ``mechanism=None``,
  packed and pytree, with and without explicit noise bits, consensus and
  training: the reference's own pin.
* Each mechanism against the reference's, fed its unit draws
  (``reference_noise_draws``): states and trajectories to rtol 1e-5.
* The ``tap_*`` rows and ``TranscriptHook`` against the reference's (its
  bits fed), the engine against the loop driver; each threat model's
  ``observe`` exactly; ``flatten_messages`` and ``Transcript`` as the
  reference's.
* ``clopper_pearson``, ``empirical_epsilon_lower_bound``,
  ``membership_inference`` and the distinguishing scoring exactly on the
  same inputs (the reference's own recorded trials for the latter).
* The port's own battery (its Philox trials) at the reference's ``--smoke``
  size (400 trials, seed 0) holds the claims of
  ``benchmarks/fig5_audit.py``, and the wire battery those of
  ``tests/test_wire.py``; the reconstruction table's shape.
* The new modules import no JAX and nothing of the reference.

Sizes: N = 8, d_s = 17 (two leaves), <= 4 rounds for the sessions; the
audit's N = 4, dim 16.
"""
from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_net import SEED, _close, _trees_close, _values
from test_torch_reference import (load_reference, reference_bits,
                                  reference_noise_draws, reference_round_key,
                                  reference_tree_bits, to_numpy)
from test_torch_session import _imported_roots

from repro_torch.api import PrivacySpec, Session, TranscriptHook
from repro_torch.audit import (CURIOUS_NEIGHBOR, GLOBAL_OBSERVER,
                               LOCAL_EAVESDROPPER, MECHANISMS, THREAT_MODELS,
                               AuditConfig, GaussianMechanism,
                               LaplaceMechanism, Transcript, TranscriptTap,
                               clopper_pearson, distinguishing_attack,
                               empirical_epsilon_lower_bound, example_scores,
                               get_mechanism, membership_inference,
                               reconstruction_attack, theoretical_epsilon)
from repro_torch.audit import attacks as attacks_mod
from repro_torch.audit.transcript import flatten_messages
from repro_torch.convert import tree_from_numpy
from repro_torch.core import topology as T
from repro_torch.core.privacy import GAUSS_SALT, normal_row
from repro_torch.kernels import ref as kref
from repro_torch.models.mlp import mlp_loss
from repro_torch.wire import parse_wire_spec

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, ROUNDS, D_S = 8, 4, 17
MECHS = ("laplace", "gaussian", "graph_homomorphic", "broken_laplace")


@pytest.fixture(scope="module")
def R():
    """The reference, with the submodules these tests read bound on their
    packages: a submodule left in ``sys.modules`` by a failed collection
    import is not bound again on its re-imported package."""
    ref = load_reference()
    import importlib
    import sys
    for name in ("repro.audit", "repro.audit.attacks",
                 "repro.audit.transcript", "repro.api.hooks",
                 "repro.core.topology"):
        parent, _, child = name.rpartition(".")
        setattr(sys.modules[parent], child, importlib.import_module(name))
    return ref


def _session(mechanism=None, *, packed=True, schedule="dense", noise=True):
    return Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(
        b=5.0, gamma_n=0.02, noise=noise, mechanism=mechanism),
        schedule=schedule, sync_interval=3, chunk=ROUNDS, seed=SEED,
        packed=packed, device="cpu")


def _equal_reports(a, b):
    for x, y in zip(a.state.push.s, b.state.push.s):
        assert torch.equal(x, y)
    assert torch.equal(a.state.push.a, b.state.push.a)
    assert set(a.trajectory) == set(b.trajectory)
    for k, v in a.trajectory.items():
        np.testing.assert_array_equal(v, b.trajectory[k], err_msg=k)


# -- mechanisms ---------------------------------------------------------------

@pytest.mark.parametrize("bits", [False, True], ids=["philox", "bits"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "pytree"])
def test_laplace_scale_factor_one_is_bit_for_bit_no_mechanism(packed, bits):
    vals = tree_from_numpy(_values(np.random.default_rng(0)), device="cpu")
    kw = {}
    if bits:
        rows = lambda t: torch.from_numpy(reference_bits(SEED, t, N, D_S))
        kw["bits_at"] = rows if packed else (
            lambda t: [rows(t)[:, :11], rows(t)[:, 11:].reshape(N, 2, 3)])
    reps = [_session(m, packed=packed).run(ROUNDS, values=vals, **kw)
            for m in (None, "laplace", LaplaceMechanism(scale_factor=1.0))]
    _equal_reports(reps[0], reps[1])
    _equal_reports(reps[0], reps[2])
    broken = _session("broken_laplace", packed=packed).run(
        ROUNDS, values=vals, **kw)
    assert broken.trajectory["noise_l1_mean"][0] == pytest.approx(
        0.5 * reps[0].trajectory["noise_l1_mean"][0], rel=1e-6)


def test_laplace_mechanism_bit_for_bit_in_training():
    """PartPSP with ``mechanism="laplace"`` is bit for bit the built-in
    draw, by the engine and by the loop driver."""
    from test_torch_net import D_IN, HIDDEN, N_CLASSES
    gen = torch.Generator().manual_seed(0)
    params = {"l1": torch.randn((D_IN, HIDDEN), generator=gen),
              "l2": torch.randn((HIDDEN, D_IN), generator=gen),
              "l3": torch.randn((D_IN, N_CLASSES), generator=gen)}
    batches = [(torch.randn((N, 8, D_IN), generator=gen),
                torch.randint(0, N_CLASSES, (N, 8), generator=gen))
               for _ in range(ROUNDS)]
    for driver in ("engine", "loop"):
        reps = []
        for mech in (None, "laplace"):
            session = Session.build(
                T.DOutGraph(N, 2), privacy=PrivacySpec(
                    b=1.0, gamma_n=1e-4, mechanism=mech), model=mlp_loss,
                params=params, partition=(("l1|l2", "shared"),),
                device="cpu", chunk=2, sync_interval=3, seed=SEED)
            reps.append(session.train(ROUNDS, lambda t: batches[t],
                                      driver=driver))
        for x, y in zip(reps[0].state.dpps.push.s, reps[1].state.dpps.push.s):
            assert torch.equal(x, y)
        for k, v in reps[0].trajectory.items():
            np.testing.assert_array_equal(v, reps[1].trajectory[k])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "pytree"])
@pytest.mark.parametrize("name", MECHS)
def test_mechanism_matches_reference_on_its_draws(R, name, packed):
    vals = _values(np.random.default_rng(1))
    ref = R.api.Session.build(
        R.core.topology.DOutGraph(N, 2), privacy=R.api.PrivacySpec(
            b=5.0, gamma_n=0.02, mechanism=name), schedule="dense",
        sync_interval=3, chunk=ROUNDS, seed=SEED, packed=packed,
        use_kernels=False)
    ref_rep = ref.run(ROUNDS, values=[jnp.asarray(v) for v in vals])
    shapes = [v.shape for v in vals]
    rep = _session(name, packed=packed).run(
        ROUNDS, values=tree_from_numpy(vals, device="cpu"),
        noise_draws_at=lambda t: torch.from_numpy(reference_noise_draws(
            name, reference_round_key(SEED, t), shapes)))
    assert set(rep.trajectory) == set(ref_rep.trajectory)
    for k, v in ref_rep.trajectory.items():
        _close(rep.trajectory[k], v, 1e-5)
    _trees_close(rep.state.push, ref_rep.state.push, 1e-5)


def test_mechanism_draws_without_seams():
    """The port's own streams: Gaussian normals (Box-Muller over the salted
    Philox words) have mean 0 and unit variance, share no word with the
    noise bits and repeat for the same (seed, t); graph-homomorphic noise
    sums to zero over the nodes."""
    z = normal_row(64, 4096, 1.0, seed=3, t=2)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    assert torch.equal(z, normal_row(64, 4096, 1.0, seed=3, t=2))
    assert not torch.equal(z, normal_row(64, 4096, 1.0, seed=3, t=3))
    # another key: about as many shared words as two independent draws
    # of 16,384 uint32 share (the birthday count, ~0.06)
    words = kref.philox_bits(3, 2, 4, 0, 4096, salt=GAUSS_SALT)
    noise = kref.philox_bits(3, 2, 4, 0, 4096)
    assert not (words == noise).any()
    assert len(set(words.reshape(-1).tolist())
               & set(noise.reshape(-1).tolist())) < 4
    gh = get_mechanism("graph_homomorphic").sample(
        8, 300, torch.tensor(2.0), seed=1, t=0)
    assert float(gh.sum(dim=0).abs().max()) < 1e-5
    lap = get_mechanism("laplace").sample(8, 300, torch.tensor(2.0), seed=1,
                                          t=0)
    torch.testing.assert_close(
        gh, lap - lap.mean(dim=0, keepdim=True), rtol=0, atol=0)


def test_mechanism_registry_and_accounting(R):
    assert set(MECHANISMS) == set(R.audit.MECHANISMS)
    for name, mech in MECHANISMS.items():
        want = R.audit.MECHANISMS[name]
        assert mech.name == want.name and mech.delta == want.delta
        assert mech.epsilon_per_round(1.0, 0.5) == \
            want.epsilon_per_round(1.0, 0.5)
        assert theoretical_epsilon(mech, 2.0, 0.25, rounds=3) == \
            R.audit.theoretical_epsilon(want, 2.0, 0.25, rounds=3)
    assert theoretical_epsilon(None, 1.0, 1.0) == 1.0
    assert MECHANISMS["broken_laplace"].true_epsilon_per_round(1.0, 1.0) == 2.0
    assert GaussianMechanism().epsilon_per_round(1.0, 0.0) == float("inf")
    with pytest.raises(ValueError, match="unknown mechanism"):
        get_mechanism("cauchy")
    assert PrivacySpec(mechanism="gaussian").resolve_mechanism() == \
        GaussianMechanism()


# -- the tap and the transcript ---------------------------------------------------

def test_tap_rows_and_transcript_match_reference(R):
    """``TranscriptHook`` on ``Session.run`` (noise on, the reference's
    bits): every ``tap_*`` row and the reassembled transcript to rtol 1e-5;
    the messages are the noised wire the gossip mixed."""
    vals = _values(np.random.default_rng(2))
    ref_hook = R.api.TranscriptHook()
    ref = R.api.Session.build(
        R.core.topology.DOutGraph(N, 2), privacy=R.api.PrivacySpec(
            b=5.0, gamma_n=0.02), schedule="dense", sync_interval=3,
        chunk=3, seed=SEED, use_kernels=True)
    ref_rep = ref.run(ROUNDS, values=[jnp.asarray(v) for v in vals],
                      hooks=[ref_hook])
    hook = TranscriptHook()
    session = Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(
        b=5.0, gamma_n=0.02), schedule="dense", sync_interval=3, chunk=3,
        seed=SEED, device="cpu")
    rep = session.run(ROUNDS, values=tree_from_numpy(vals, device="cpu"),
                      hooks=[hook], bits_at=lambda t: torch.from_numpy(
                          reference_bits(SEED, t, N, D_S)))
    assert {k for k in rep.trajectory if k.startswith("tap_")} == {
        "tap_messages", "tap_sens_local", "tap_sensitivity", "tap_weights"}
    for k, v in ref_rep.trajectory.items():
        _close(rep.trajectory[k], v, 1e-5)
    got, want = hook.transcript(), ref_hook.transcript()
    for x, y in zip(got, want):
        _close(x, y, 1e-5)
    assert (got.rounds, got.n_nodes) == (want.rounds, want.n_nodes) == (
        ROUNDS, N)
    assert got.messages.shape == (ROUNDS, N, D_S)


def test_tap_under_the_loop_driver_equals_the_engine():
    from test_torch_net import D_IN, HIDDEN, N_CLASSES
    gen = torch.Generator().manual_seed(1)
    params = {"l1": torch.randn((D_IN, HIDDEN), generator=gen),
              "l2": torch.randn((HIDDEN, D_IN), generator=gen),
              "l3": torch.randn((D_IN, N_CLASSES), generator=gen)}
    batches = [(torch.randn((N, 8, D_IN), generator=gen),
                torch.randint(0, N_CLASSES, (N, 8), generator=gen))
               for _ in range(ROUNDS)]
    session = Session.build(
        T.DOutGraph(N, 2), privacy=PrivacySpec(b=1.0, gamma_n=1e-4),
        model=mlp_loss, params=params, partition=(("l1|l2", "shared"),),
        device="cpu", chunk=3, sync_interval=3, seed=SEED)
    hooks = [TranscriptHook(), TranscriptHook()]
    engine = session.train(ROUNDS, lambda t: batches[t], hooks=[hooks[0]])
    loop = session.train(ROUNDS, lambda t: batches[t], hooks=[hooks[1]],
                         driver="loop")
    for x, y in zip(hooks[0].transcript(), hooks[1].transcript()):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
    assert engine.trajectory["tap_messages"].shape == (ROUNDS, N, 48)
    np.testing.assert_allclose(loop.trajectory["tap_weights"],
                               engine.trajectory["tap_weights"], rtol=1e-6)


def test_tap_switches_and_transcript_as_the_reference(R):
    tap = TranscriptTap(messages=False)
    rows = tap.capture(s_noise=[torch.ones((3, 2))], a_out=torch.ones(3),
                       sens_local=torch.ones(3), sens_scalar=torch.tensor(1.))
    assert set(rows) == {"tap_sens_local", "tap_sensitivity", "tap_weights"}
    tree = [np.arange(6, dtype=np.float32).reshape(3, 2),
            np.arange(12, dtype=np.float32).reshape(3, 2, 2)]
    np.testing.assert_array_equal(
        to_numpy(flatten_messages([torch.from_numpy(x) for x in tree])),
        np.asarray(R.audit.transcript.flatten_messages(
            [jnp.asarray(x) for x in tree])))
    traj = {"tap_sens_local": np.ones((2, 3)), "tap_weights": np.ones((2, 3)),
            "loss": np.zeros(2)}
    got, want = Transcript.from_trajectory(traj), \
        R.audit.Transcript.from_trajectory(traj)
    assert (got.rounds, got.n_nodes) == (want.rounds, want.n_nodes)
    assert got.messages is None and got.sensitivity is None
    with pytest.raises(ValueError, match="empty"):
        Transcript.from_trajectory({}).rounds
    with pytest.raises(ValueError, match="no per-node"):
        Transcript.from_trajectory({"tap_sensitivity": np.ones(2)}).n_nodes


@pytest.mark.parametrize("victim", [0, 3])
@pytest.mark.parametrize("threat", THREAT_MODELS, ids=lambda t: t.name)
def test_threat_observe_exact(R, threat, victim):
    rng = np.random.default_rng(victim)
    traj = {"tap_messages": rng.normal(size=(3, 6, 5)).astype(np.float32),
            "tap_sens_local": rng.normal(size=(3, 6)).astype(np.float32),
            "tap_sensitivity": rng.normal(size=(3,)).astype(np.float32),
            "tap_weights": rng.normal(size=(3, 6)).astype(np.float32)}
    ref_threat = {t.name: t for t in R.audit.THREAT_MODELS}[threat.name]
    got = threat.observe(Transcript.from_trajectory(traj), victim=victim,
                         topo=T.DOutGraph(6, 3))
    want = ref_threat.observe(
        R.audit.Transcript.from_trajectory(
            {k: jnp.asarray(v) for k, v in traj.items()}),
        victim=victim, topo=R.core.topology.DOutGraph(6, 3))
    assert got.visible == want.visible
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(got.node_messages(victim),
                                  np.asarray(want.node_messages(victim)))


def test_threat_errors_as_the_reference(R):
    with pytest.raises(ValueError, match="unknown threat kind"):
        type(LOCAL_EAVESDROPPER)("x", "satellite")
    with pytest.raises(ValueError, match="topo="):
        CURIOUS_NEIGHBOR.visible_nodes(victim=0, n_nodes=4)
    ring = T.DOutGraph(1, 1)
    with pytest.raises(ValueError, match="no out-neighbor"):
        CURIOUS_NEIGHBOR.visible_nodes(victim=0, n_nodes=1, topo=ring)
    for topo, rtopo in ((T.DOutGraph(8, 2), R.core.topology.DOutGraph(8, 2)),
                        (T.ExpGraph(8), R.core.topology.ExpGraph(8))):
        assert topo.edges(0) == rtopo.edges(0)


# -- the scoring ---------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.05, 0.001])
def test_clopper_pearson_exact(R, alpha):
    for n in (1, 7, 400):
        for k in sorted({0, 1, n // 3, n - 1, n}):
            assert clopper_pearson(k, n, alpha) == \
                R.audit.clopper_pearson(k, n, alpha)
    with pytest.raises(ValueError, match="0 <= k <= n"):
        clopper_pearson(5, 4, alpha)


@pytest.mark.parametrize("shift", [0.0, 0.3, 1.5])
def test_epsilon_lower_bound_and_membership_exact(R, shift):
    rng = np.random.default_rng(int(shift * 10))
    sd = rng.laplace(shift, 1.0, 300)
    sdp = rng.laplace(-shift, 1.0, 300)
    for fam in (1, 2):
        assert empirical_epsilon_lower_bound(sd, sdp, n_families=fam) == \
            R.audit.empirical_epsilon_lower_bound(sd, sdp, n_families=fam)
    assert membership_inference(sd, sdp) == \
        R.audit.membership_inference(sd, sdp)
    with pytest.raises(ValueError, match="same number"):
        empirical_epsilon_lower_bound(sd, sdp[:10])
    with pytest.raises(ValueError, match=">= 4"):
        membership_inference(sd[:3], sdp[:3])


@pytest.mark.parametrize("name", ["laplace", "graph_homomorphic"])
def test_distinguishing_scoring_exact_on_reference_transcripts(R, name):
    """The port's scoring of the reference's own recorded trials gives the
    reference's counts, bound and flag under every threat."""
    ref_audit = R.audit.AuditConfig(trials=60, seed=3)
    audit = AuditConfig(trials=60, seed=3, device="cpu")
    ref_mech = R.audit.get_mechanism(name)
    trajs = [{k: np.asarray(v) for k, v in
              R.audit.attacks._tapped_trials_cached(ref_audit, ref_mech,
                                                    w).items()}
             for w in (0, 1)]
    for threat, ref_threat in zip(THREAT_MODELS, R.audit.THREAT_MODELS):
        want = R.audit.distinguishing_attack(ref_threat, mechanism=ref_mech,
                                             audit=ref_audit)
        got = attacks_mod.score_distinguishing(
            threat, *trajs, mechanism=get_mechanism(name), audit=audit)
        assert got.empirical == want.empirical
        assert (got.threat, got.mechanism, got.theoretical_epsilon,
                got.flagged) == (want.threat, want.mechanism,
                                 want.theoretical_epsilon, want.flagged)
        assert got.ledger.entries == want.ledger.entries
        assert got.row() == want.row()


def test_port_trials_take_the_references_draws(R):
    """Fed the reference's draws of each trial, the port's recorded trials
    are the reference's (rtol 1e-5): the trials are the protocol, not a
    re-model of it."""
    ref_audit = R.audit.AuditConfig(trials=8, seed=1)
    audit = AuditConfig(trials=8, seed=1, device="cpu")
    ref_mech = R.audit.get_mechanism("gaussian")
    keys = jax.random.split(jax.random.PRNGKey(ref_audit.seed * 2 + 0), 8)
    shapes = [(audit.n_nodes, audit.dim)]
    draws = (None, None, lambda i, t: torch.from_numpy(reference_noise_draws(
        "gaussian", jax.random.fold_in(keys[i], t), shapes)))
    got = attacks_mod.tapped_trials(audit, get_mechanism("gaussian"), 0,
                                    draws=draws)
    want = R.audit.attacks._tapped_trials_cached(ref_audit, ref_mech, 0)
    for k in ("tap_messages", "tap_weights", "tap_sens_local",
              "sensitivity_estimate", "noise_l1_mean"):
        _close(got[k], np.asarray(want[k]), 1e-5)
    assert got["tap_messages"].shape == (8, 1, 4, 16)


def test_battery_holds_the_fig5_claims():
    """The reference's --smoke battery (400 trials, seed 0) on the port's
    own trials: Laplace not flagged under any threat; the half-scale
    Laplace flagged under at least one; graph-homomorphic noise passes the
    local eavesdropper and is flagged by the global observer."""
    audit = AuditConfig(trials=400, seed=0, device="cpu")
    by = {(m, t.name): distinguishing_attack(t, mechanism=get_mechanism(m),
                                             audit=audit)
          for m in MECHS for t in THREAT_MODELS}
    for t in THREAT_MODELS:
        assert not by[("laplace", t.name)].flagged, by[("laplace",
                                                        t.name)].row()
        assert by[("laplace", t.name)].empirical.trials == 400
    assert any(by[("broken_laplace", t.name)].flagged for t in THREAT_MODELS)
    assert not by[("graph_homomorphic", LOCAL_EAVESDROPPER.name)].flagged
    assert by[("graph_homomorphic", GLOBAL_OBSERVER.name)].flagged
    rec = {m: reconstruction_attack(mechanism=get_mechanism(m), audit=audit)
           for m in ("laplace", "graph_homomorphic")}
    assert rec["graph_homomorphic"]["sum_err"] < 1e-4
    assert rec["laplace"]["sum_err"] > 0.1
    assert rec["laplace"]["mechanism"] == "laplace"


def test_wire_battery_holds_its_claims():
    """tests/test_wire.py's referee (400 trials, seed 7) on the port's
    trials: int8 and top-k, encoded after the noise, are not flagged; the
    compress-first codec is."""
    for spec, flagged in (("int8", False), ("topk:1/16", False),
                          ("broken-compress-first", True)):
        audit = AuditConfig(trials=400, seed=7, device="cpu",
                            wire=parse_wire_spec(spec))
        r = distinguishing_attack(LOCAL_EAVESDROPPER, audit=audit)
        assert r.flagged is flagged, (spec, r.row())
        assert (r.empirical.epsilon_lower > r.theoretical_epsilon) is flagged


def test_example_scores_are_per_example_losses():
    gen = torch.Generator().manual_seed(0)
    params = {"l1": torch.randn((6, 4), generator=gen),
              "l2": torch.randn((4, 6), generator=gen),
              "l3": torch.randn((6, 3), generator=gen)}
    xs = torch.randn((5, 6), generator=gen)
    ys = torch.randint(0, 3, (5,), generator=gen)
    got = example_scores(mlp_loss, params, xs, ys)
    assert got.shape == (5,)
    for i in range(5):
        assert got[i] == pytest.approx(float(mlp_loss(
            params, (xs[i:i + 1], ys[i:i + 1]))), rel=1e-6)


NEW_MODULES = ["wire/__init__.py", "wire/codecs.py", "audit/__init__.py",
               "audit/mechanisms.py", "audit/transcript.py",
               "audit/threat.py", "audit/attacks.py"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_no_jax_and_no_reference(module):
    path = ROOT / "src" / "repro_torch" / module
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}
