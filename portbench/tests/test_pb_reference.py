"""The plain reference against the program at small sizes on the CPU:
the noise words, a DPPS round (dense and sparse, perturbed, a sync round
among them), and each cell run whole at smoke size."""
import numpy as np
import pytest
import torch

from portbench.harness import runtime
from portbench.reference import dpps as ref_dpps
from portbench.reference import graphs, philox
from portbench.tests.pb_smoke import run_smoke

SEED = 3_000_000_123   # over 2^31, as the driver's seeds are


def test_noise_words_and_laplace_match_the_program():
    from repro_torch.kernels import ref as kref

    want = kref.philox_bits(SEED, 7, 3, 5, 203)
    got = philox.bits_block(SEED, 7, 3, 5, 203, "cpu")
    assert torch.equal(got, want)
    cols = torch.tensor([0, 1, 6, 77, 202, 4097], dtype=torch.int64)
    want = kref.philox_columns(SEED, 9, 3, cols)
    got = philox.bits_at(SEED, 9, torch.arange(3), cols)
    assert torch.equal(got, want)
    scale = torch.tensor(0.37)
    assert torch.equal(philox.laplace(want, scale),
                       kref.laplace_from_bits(want, scale))


@pytest.mark.parametrize("kind", ["dout", "erdos_renyi"])
def test_dpps_rounds_match_the_program(kind):
    from repro_torch.core.dpps import DPPSConfig, dpps_init, dpps_step
    from repro_torch.core.packing import PackedLayout
    from repro_torch.core.topology import DOutGraph, padded_csr
    from repro_torch.net import ErdosRenyiGraph

    n, d = (4, 300) if kind == "dout" else (6, 130)
    topo = (DOutGraph(n, 2) if kind == "dout" else
            ErdosRenyiGraph(n, p=0.5, seed=3))
    w = topo.weight_matrix(0)
    spec = ({"kind": "dout", "nodes": n, "d": 2} if kind == "dout" else
            {"kind": "erdos_renyi", "nodes": n,
             "edges": [[i, j] for i in range(n) for j in range(i + 1, n)
                       if w[i, j] != 0]})
    w_ref = graphs.weights(spec)
    np.testing.assert_allclose(w_ref, w, atol=1e-15)
    c_prime, lam = graphs.calibrate(w_ref)
    k = ref_dpps.Consts(c_prime=c_prime, lam=lam, gamma_n=1e-3, b=1.0,
                        seed=SEED, sync_interval=3)
    gen = torch.Generator().manual_seed(5)
    s0 = torch.randn((n, d), generator=gen)
    eps = [0.01 * torch.randn((n, d), generator=gen) for _ in range(4)]
    cfg = DPPSConfig(b=1.0, gamma_n=1e-3, c_prime=c_prime, lam=lam,
                     sync_interval=3,
                     schedule="dense" if kind == "dout" else "sparse")
    layout = PackedLayout.from_tree({"x": s0}, lane=1)
    st = dpps_init({"x": s0}, cfg)
    st = st._replace(push=st.push._replace(s=layout.pack(st.push.s)))
    wt = torch.as_tensor(w, dtype=torch.float32)
    mix = ({"w": wt} if kind == "dout" else dict(zip(
        ("sparse_idx", "sparse_vals"),
        (torch.as_tensor(x) for x in padded_csr(w)))))
    s, a, sens = s0.clone(), torch.ones(n), None
    for t in range(4):
        st, diag = dpps_step(st, eps[t], cfg, layout, seed=SEED, **mix)
        a, sens, rd = ref_dpps.dpps_round(s, a, sens, t, k, wt, eps=eps[t])
        torch.testing.assert_close(st.push.s, s, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(st.push.a, a, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(diag["sensitivity_used"],
                                   rd["sensitivity_used"], rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  runtime.benchmark()["workloads"]])
def test_cell_at_smoke_size_is_correct(cell):
    result, checks = run_smoke(cell)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    for name, value, limit in checks:
        assert value <= limit / 10, (name, value, limit)
