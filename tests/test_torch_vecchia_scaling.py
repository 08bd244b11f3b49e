"""The port's Vecchia scaling curve (``experiments/vecchia_scaling.py``)
against the JAX script and package, on the CPU in float64: the script's
data generator, the scaffold (the exact maxmin order and the device's
neighbours at the script's CPU sizes; the coarse order and kd neighbours
past 20,000 points), the value and gradient at the script's point and its
perturbed repetitions, the manifest copy, the sizes and knobs, and
``main``."""

import json
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.estimate import vecchia as JV
from cokriging_tpu_torch.cov.params import ParamSpec
from cokriging_tpu_torch.estimate import vecchia as TV
from cokriging_tpu_torch.experiments import vecchia_scaling as VS

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _script_draws(sizes, dtype):
    """The script's lines (examples/vecchia_scaling.py:62-69), copied."""
    rng = np.random.default_rng(0)
    out = []
    for n_total in sizes:
        n = n_total // 2
        lat = rng.uniform(24.0, 50.0, n).astype(dtype)
        lon = rng.uniform(-124.0, -67.0, n).astype(dtype)
        c1 = np.column_stack([lat, lon])
        c2 = np.roll(c1, 1, axis=0) + rng.normal(scale=0.05, size=c1.shape).astype(dtype)
        v1 = np.sin(np.deg2rad(lat) * 6).astype(dtype)
        v2 = (-0.5 * v1 + 0.3 * rng.normal(size=n)).astype(dtype)
        out.append(([c1, c2], [v1, v2]))
    return out


@pytest.fixture(scope="module")
def scaffolds():
    """Both packages' likelihoods at the script's CPU sizes (N = 400, 800;
    m = 15), the data drawn as the script draws them."""
    out = {}
    for n_total, (coords, values) in zip(VS.CPU_SIZES["sizes"],
                                         _script_draws(VS.CPU_SIZES["sizes"], np.float64)):
        m = VS.CPU_SIZES["m"]
        out[n_total] = (TV.VecchiaLikelihood(coords, values, m=m, geodesic=True, device="cpu"),
                        JV.VecchiaLikelihood(coords, values, m=m, geodesic=True))
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_draw_is_the_scripts(dtype):
    """``draw`` over one generator across sizes equals the script's lines,
    bit for bit, in both dtypes."""
    sizes = (400, 800, 1202)
    rng = np.random.default_rng(VS.SEED)
    for n_total, (want_c, want_v) in zip(sizes, _script_draws(sizes, dtype)):
        got_c, got_v = VS.draw(rng, n_total, dtype)
        for g, w in zip(got_c + got_v, want_c + want_v):
            assert g.dtype == w.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_total", VS.CPU_SIZES["sizes"])
def test_scaffold_matches_jax_at_the_cpu_sizes(scaffolds, n_total):
    """Maxmin order and the device's neighbour search (N <= 20,000): the
    same permutation, the same masks and, term by term, the same
    conditioning set (coordinates, values, process ids; the order of the
    neighbours within a window is the top-k's and free)."""
    lik, jlik = scaffolds[n_total]
    assert (lik.ordering, lik.neighbor_method) == ("maxmin", "device")
    np.testing.assert_array_equal(lik.perm, np.asarray(jlik.perm))
    np.testing.assert_array_equal(lik._win[4].numpy(), np.asarray(jlik._win[4]))
    mask = lik._win[4].numpy()

    def rows(win):
        c, z, procs = (np.asarray(a) for a in win[:3])
        return [sorted(zip(c[t, mask[t], 0], c[t, mask[t], 1], z[t, mask[t]], procs[t, mask[t]]))
                for t in range(mask.shape[0])]

    assert rows(lik._win) == rows(jlik._win)


def test_scaffold_matches_jax_past_the_auto_switch():
    """Past 20,000 points (N = 24,000): the coarse-to-fine order and the kd
    neighbours, the same permutation and windows as the JAX package's;
    the scaffold's seconds and device bytes recorded."""
    coords, values = _script_draws([400, 800, 24_000], np.float64)[-1]
    lik = TV.VecchiaLikelihood(coords, values, m=20, geodesic=True, device="cpu")
    jlik = JV.VecchiaLikelihood(coords, values, m=20, geodesic=True)
    assert (lik.ordering, lik.neighbor_method) == ("coarse", "kd")
    np.testing.assert_array_equal(lik.perm, np.asarray(jlik.perm))
    for k in (0, 1, 2, 4):
        np.testing.assert_array_equal(lik._win[k].numpy(), np.asarray(jlik._win[k]))
    assert set(lik.scaffold) == set(VS.STEPS) | {"window_bytes"}
    assert lik.scaffold["window_bytes"] == sum(a.numel() * a.element_size() for a in lik._win)


@pytest.mark.parametrize("n_total", VS.CPU_SIZES["sizes"])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_value_and_gradient_match_jax(scaffolds, n_total, k):
    """The script's evaluation ``flat + 1e-6 k`` at k = 0, 1, 2 (off nu =
    1.5 for k > 0, where the reference's dK/dnu jumps): value rtol 1e-10,
    gradient rtol 1e-8, against the JAX package's
    ``vecchia_nll_value_and_grad`` on its own windows."""
    lik, jlik = scaffolds[n_total]
    flat = np.asarray(VS.FLAT) + 1e-6 * k
    v, g = VS.evaluate(lik, torch.tensor(flat), ParamSpec(n_procs=2))
    jv, jg = JV.vecchia_nll_value_and_grad(jnp.asarray(flat), jlik._win, JSpec(n_procs=2),
                                           geodesic=True, chunk=jlik.chunk)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8, atol=1e-12 * np.abs(jg).max())


def test_jax_manifest_is_the_results_file():
    """``JAX_MANIFEST`` is the JAX package's recorded TPU run."""
    ref = json.loads((ROOT / "results" / "vecchia_scaling.json").read_text())
    assert {k: ref[k] for k in VS.JAX_MANIFEST} == VS.JAX_MANIFEST


def test_sizes_and_knobs(monkeypatch):
    """The script's sizes per device; ``BENCH_SIZES`` and ``BENCH_M`` over
    them, keywords over both; an unknown size is refused."""
    cuda = types.SimpleNamespace(type="cuda")
    monkeypatch.delenv("BENCH_SIZES", raising=False)
    monkeypatch.delenv("BENCH_M", raising=False)
    assert VS.sizes_for(cuda) == dict(sizes=(100_000, 250_000, 500_000, 1_000_000), m=20, reps=3)
    assert VS.sizes_for(CPU) == dict(sizes=(400, 800), m=15, reps=1)
    monkeypatch.setenv("BENCH_SIZES", "1000,3000")
    monkeypatch.setenv("BENCH_M", "12")
    assert VS.sizes_for(cuda) == dict(sizes=(1000, 3000), m=12, reps=3)
    assert VS.sizes_for(CPU, m=9)["m"] == 9
    with pytest.raises(TypeError):
        VS.sizes_for(CPU, n=3)


def test_log_slopes():
    rows = [{"n_total": n, "eval_s": 2e-5 * n, "build_s": 1e-6 * n ** 1.2, "order_s": 1.0,
             "neighbors_s": 3e-7 * n ** 0.5, "windows_s": 4.0} for n in (1e5, 2.5e5, 1e6)]
    s = VS.log_slopes(rows)
    np.testing.assert_allclose([s["eval_s"], s["build_s"], s["order_s"], s["neighbors_s"]],
                               [1.0, 1.2, 0.0, 0.5], atol=1e-12)
    assert VS.log_slopes(rows[:1])["eval_s"] is None


def test_main_rows_finite(monkeypatch):
    """``main("cpu")`` at the script's CPU sizes: one finite row per N with
    the scaffold's three steps, the value equal to a fresh evaluation of
    the same data, and the manifest comparison printed beside it."""
    monkeypatch.setenv("COKRIGING_NO_RECORD", "1")
    for var in ("BENCH_SIZES", "BENCH_M"):
        monkeypatch.delenv(var, raising=False)
    r = VS.main("cpu")
    assert [row["n_total"] for row in r["rows"]] == [400, 800] and r["dtype"] == "float64"
    for row in r["rows"]:
        assert np.isfinite(row["value"]) and row["grad_finite"] and len(row["eval_reps_s"]) == 1
        assert all(row[k] >= 0.0 for k in VS.STEPS) and row["window_bytes"] > 0
        assert row["terms_per_s"] == row["n_total"] / row["eval_s"]
    assert set(r["slopes"]) == {"eval_s", "build_s", *VS.STEPS}
    coords, values = _script_draws([400], np.float64)[0]
    lik = TV.VecchiaLikelihood(coords, values, m=15, geodesic=True, device="cpu")
    v, _ = VS.evaluate(lik, torch.tensor(VS.FLAT, dtype=torch.float64), ParamSpec(n_procs=2))
    assert float(v) == r["rows"][0]["value"]
    rows = VS.compare_manifest(r)
    assert [row[0] for row in rows] == [400, 800] and rows[0][2] is None
