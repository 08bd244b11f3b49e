"""The port's exact-NLL scaling curve (``experiments/nll_scaling.py``)
against the JAX script and package, on the CPU in float64 at small n: the
script's data, the value and gradient at its point and at its perturbed
repetitions against ``_nll_value_and_grad``, and ``main``."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.estimate.nll import _nll_value_and_grad, joint_distance_blocks
from cokriging_tpu_torch.cov.params import ParamSpec
from cokriging_tpu_torch.experiments import nll_scaling as NS

torch.set_num_threads(2)

SIZES = (60, 150)  # per process; the script's CPU sizes cost ~100 s per evaluation here
CPU = torch.device("cpu")


def _script_data(sizes):
    """The script's lines (examples/nll_scaling.py:45-58), copied, in
    float64."""
    rng = np.random.default_rng(0)
    out = []
    for n_per in sizes:
        coords = [rng.uniform(0, 1, size=(n_per, 2)) for _ in range(2)]
        out.append((coords, rng.normal(size=2 * n_per)))
    return out


def test_draw_is_the_scripts():
    rng = np.random.default_rng(NS.SEED)
    for n_per, (coords, z) in zip(SIZES, _script_data(SIZES)):
        got_c, got_z = NS.draw(rng, n_per)
        for g, w in zip(got_c + [got_z], coords + [z]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [None, 0, 1, 4])
@pytest.mark.parametrize("size", SIZES)
def test_value_and_gradient_match_jax(size, k):
    """At the script's point (k None) and its timed repetitions
    ``flat[0] += 1e-6 (k + 1)``: value rtol 1e-9, gradient rtol 1e-6 /
    atol 1e-9, against the JAX package's ``_nll_value_and_grad`` with the
    script's spec and jitter."""
    coords, z = _script_data(SIZES)[SIZES.index(size)]
    flat = np.asarray(NS.FLAT, dtype=np.float64)
    if k is not None:
        flat[0] += 1e-6 * (k + 1)
    dists, zt = NS.problem(coords, z, torch.float64, CPU)
    v, g = NS.evaluate(torch.tensor(flat), dists, zt, ParamSpec(2, **NS.BOUNDS))
    jdists = joint_distance_blocks([jnp.asarray(c) for c in coords], geodesic=False)
    jv, jg = _nll_value_and_grad(jnp.asarray(flat), jdists, jnp.asarray(z), JSpec(2, **NS.BOUNDS),
                                 None, NS.JITTER)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)
    assert np.isfinite(float(v)) and np.abs(g.numpy()).max() > 0


def test_sizes():
    cuda = types.SimpleNamespace(type="cuda")
    assert NS.sizes_for(cuda) == dict(sizes=(2_500, 5_000, 12_500), reps=5)
    assert NS.sizes_for(CPU) == dict(sizes=(2_500, 5_000), reps=5)
    assert NS.sizes_for(CPU, sizes=(10,))["sizes"] == (10,)
    with pytest.raises(TypeError):
        NS.sizes_for(CPU, n=3)


def test_main_at_small_sizes(monkeypatch):
    """``main("cpu")`` at small sizes: one row per size, positive definite
    at the script's point, each NLL the JAX package's at the last timed
    point, ms per evaluation and evaluations per second consistent."""
    monkeypatch.setenv("COKRIGING_NO_RECORD", "1")
    r = NS.main("cpu", sizes=SIZES, reps=2)
    assert r["dtype"] == "float64" and [row["n_per"] for row in r["rows"]] == list(SIZES)
    for row, (coords, z) in zip(r["rows"], _script_data(SIZES)):
        assert row["positive_definite"] and row["grad_finite"] and len(row["reps_s"]) == 2
        np.testing.assert_allclose(row["evals_per_s"] * row["ms_per_eval"], 1e3, rtol=1e-12)
        flat = np.asarray(NS.FLAT, dtype=np.float64)
        flat[0] += 2e-6
        jdists = joint_distance_blocks([jnp.asarray(c) for c in coords], geodesic=False)
        jv, _ = _nll_value_and_grad(jnp.asarray(flat), jdists, jnp.asarray(z),
                                    JSpec(2, **NS.BOUNDS), None, NS.JITTER)
        np.testing.assert_allclose(row["nll"], float(jv), rtol=1e-9)
    assert set(r["stage_s"]) == {f"{s}_{n}" for n in SIZES for s in ("distances", "warm", "evals")}
