"""The port's CLI (``python -m cokriging_tpu_torch``) against the JAX
package's (``python -m cokriging_tpu``), in process through ``main(argv)``, on
the CPU in float64: ``fit`` -> ``predict`` -> ``loocv`` on the staged tables
of tests/test_cli.py, parameter files read across the two packages,
``fit --bootstrap`` and ``predict --joint --conditional-sims`` (their
files, columns and shapes), and the parser's errors (``fit --std-errors`` is
held against the JAX package in tests/test_torch_uncertainty.py, beside the
JAX Hessian it shares)."""

import contextlib
import io
import re

import numpy as np
import pandas as pd
import pytest

from cokriging_tpu.__main__ import main as jax_main
from cokriging_tpu.data.grids import main_coords_array
from cokriging_tpu.utils import io as JIO
from cokriging_tpu_torch.__main__ import main as torch_main
from cokriging_tpu_torch.utils import io as TIO
from cokriging_tpu_torch.utils.convert import params_from_numpy

TIMES = ["2018-04-01", "2018-05-01", "2018-06-01"]


def _staged_table(name, rng, scale=1.0, own_seed=123):
    """tests/test_cli.py's staged frame: [time, lat, lon, <name>, <name>_var]
    on the 4 x 5-degree base grid, three months, smooth partially correlated
    signals."""
    mc = main_coords_array()
    srng = np.random.default_rng(own_seed)
    base = (np.sin(np.deg2rad(mc[:, 0]) * 5) + 0.5 * np.cos(np.deg2rad(mc[:, 1]) * (3 + own_seed % 3))
            + 0.6 * srng.normal(size=len(mc)))
    rows = []
    for k, t in enumerate(TIMES):
        vals = scale * (base + 0.15 * rng.normal(size=len(mc))) + 0.05 * k
        rows.append(pd.DataFrame({"time": pd.Timestamp(t), "lat": mc[:, 0], "lon": mc[:, 1],
                                  name: vals, f"{name}_var": 0.01}))
    return pd.concat(rows, ignore_index=True)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(6)
    paths = []
    for k, name in enumerate(["xco2", "sif"]):
        p = tmp / f"{name}.parquet"
        TIO.save_table(p, _staged_table(name, rng, own_seed=600 + k))
        paths.append(str(p))
    mc = main_coords_array()
    grid = tmp / "grid.parquet"
    TIO.save_table(grid, pd.DataFrame({"lat": mc[::3, 0] + 0.5, "lon": mc[::3, 1] + 0.5}))
    return tmp, paths, str(grid)


def _common(paths):
    return ["--data", *paths, "--timestamp", TIMES[1], "--timedeltas", "0", "0"]


@pytest.fixture(scope="module")
def fitted(staged):
    """Both CLIs' ``fit`` (WLS from the moment initializer, 60 iterations,
    projected onto the validity region): their parameter files and printed
    summaries."""
    tmp, paths, _ = staged
    fit = ["fit", *_common(paths), "--max-dist", "3000", "--n-bins", "8", "--maxiter", "60",
           "--project-validity"]
    out = {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        out[name] = tmp / f"params_{name}.npz"
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            main(fit + extra + ["--out", str(out[name])])
        out[name, "printed"] = printed.getvalue()
    return out


def _run(capsys, main, argv):
    main(argv)
    return capsys.readouterr().out


def test_fit_matches_jax_and_files_cross(fitted):
    # each package reads the other's file, and both hold the same model
    j_flat = np.asarray(JIO.load_params(fitted["jax"]).to_flat())
    t_flat = TIO.load_params(fitted["torch"]).to_flat().numpy()
    np.testing.assert_allclose(t_flat, j_flat, rtol=1e-6)
    np.testing.assert_array_equal(TIO.load_params(fitted["jax"]).to_flat().numpy(), j_flat)
    np.testing.assert_array_equal(np.asarray(JIO.load_params(fitted["torch"]).to_flat()), t_flat)
    assert TIO.load_params(fitted["jax"]).spec == params_from_numpy(j_flat).spec
    with np.load(fitted["torch"]) as f:
        assert '"timestamp": "2018-05-01"' in str(f["meta"])
    # the same summary: the parameter table, then the cost line
    j_lines, t_lines = fitted["jax", "printed"].splitlines(), fitted["torch", "printed"].splitlines()
    assert len(j_lines) == len(t_lines) == 13
    assert t_lines[0].split() == j_lines[0].split() == ["name", "value", "bounds"]
    assert [ln.split()[0] for ln in t_lines[1:12]] == [ln.split()[0] for ln in j_lines[1:12]]
    cost = [float(re.match(r"cost (\S+) ->", ln[-1]).group(1)) for ln in (j_lines, t_lines)]
    np.testing.assert_allclose(cost[1], cost[0], rtol=1e-5)


@pytest.mark.parametrize("mode", [[], ["--joint"], ["--joint", "--solver", "cg"]])
def test_predict_matches_jax_on_the_other_packages_params(staged, fitted, mode, capsys):
    """Each CLI predicts from the parameter file the other package wrote."""
    tmp, paths, grid = staged
    tag = "_".join(mode) or "local"
    outs = {}
    for name, main, params, extra in (
        ("jax", jax_main, fitted["torch"], []),
        ("torch", torch_main, fitted["jax"], ["--device", "cpu"]),
    ):
        path = tmp / f"pred_{tag}_{name}.parquet"
        main(["predict", *_common(paths), "--params", str(params), "--process", "1",
              "--max-dist", "2000", "--pred-grid", grid, *mode, *extra, "--out", str(path)])
        outs[name] = TIO.load_table(path)
    capsys.readouterr()
    j, t = outs["jax"], outs["torch"]
    assert list(t.columns) == list(j.columns) == ["lat", "lon", "pred", "pred_err"]
    assert len(t) == len(main_coords_array()[::3]) and np.isfinite(t["pred"]).all()
    atol = 1e-4 if "cg" in mode else 1e-6  # CG to its tolerance, 1e-6 relative
    for col in ("pred", "pred_err"):
        np.testing.assert_allclose(t[col], j[col], atol=atol, err_msg=col)


@pytest.mark.parametrize("predictor", ["local", "joint"])
def test_loocv_matches_jax(staged, fitted, predictor, capsys):
    tmp, paths, _ = staged
    outs, stats = {}, {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        path = tmp / f"cv_{predictor}_{name}.parquet"
        printed = _run(capsys, main, ["loocv", *_common(paths), "--params", str(fitted["jax"]),
                                      "--predictor", predictor, "--max-dist", "3000", *extra,
                                      "--out", str(path)])
        outs[name] = TIO.load_table(path)
        stats[name] = re.search(r"MSPE (\S+)  MAPE (\S+)  95% coverage (\S+)  \((\d+)/(\d+)",
                                printed).groups()
    j, t = outs["jax"], outs["torch"]
    assert list(t.columns) == list(j.columns) == ["lat", "lon", "data", "pred", "residual",
                                                  "pred_err"]
    for col in t.columns:
        np.testing.assert_allclose(t[col], j[col], atol=1e-6, err_msg=col)
    np.testing.assert_allclose(t["residual"], t["data"] - t["pred"], rtol=0, atol=0)
    np.testing.assert_allclose([float(x) for x in stats["torch"][:3]],
                               [float(x) for x in stats["jax"][:3]], rtol=1e-4)
    assert stats["torch"][3:] == stats["jax"][3:]


def test_fit_bootstrap_writes_the_jax_packages_table(staged, fitted, capsys):
    """``fit --bootstrap N``: ``<out>.bootstrap.csv`` with the JAX CLI's
    columns and rows, around the same fitted parameters, and the same printed
    table. The replicates are each package's own draws, so only the fitted
    values agree; the bootstrap columns are finite and the intervals hold
    the replicates' spread."""
    tmp, paths, _ = staged
    fit = ["fit", *_common(paths), "--max-dist", "3000", "--n-bins", "8", "--maxiter", "30",
           "--project-validity", "--bootstrap", "4"]
    tables, printed = {}, {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        out = tmp / f"boot_{name}.npz"
        printed[name] = _run(capsys, main, fit + extra + ["--out", str(out)])
        tables[name] = pd.read_csv(f"{out}.bootstrap.csv")
    j, t = tables["jax"], tables["torch"]
    assert list(t.columns) == list(j.columns) == ["name", "value", "bounds", "std_err", "bias",
                                                  "q025", "q975"]
    assert t.shape == j.shape == (11, 7)
    assert list(t["name"]) == list(j["name"]) and list(t["bounds"]) == list(j["bounds"])
    np.testing.assert_allclose(t["value"], j["value"], rtol=1e-5)
    assert np.isfinite(t[["std_err", "bias", "q025", "q975"]].to_numpy()).all()
    assert (t["q025"] <= t["q975"]).all() and (t["std_err"] >= 0).all()
    for p in printed.values():
        assert p.splitlines()[-1].startswith("bootstrap (4 replicates) -> ")


def test_predict_conditional_sims_writes_the_jax_packages_files(staged, fitted, capsys):
    """``predict --joint --conditional-sims N --seed S``: the prediction
    table as without the flag, and ``<out>.samples.npz`` with one (N,
    n_cells) array under ``samples``, as the JAX CLI writes them."""
    tmp, paths, grid = staged
    files = {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        out = tmp / f"sims_{name}.parquet"
        printed = _run(capsys, main, ["predict", *_common(paths), "--params", str(fitted["jax"]),
                                      "--pred-grid", grid, "--joint", "--conditional-sims", "6",
                                      "--seed", "3", *extra, "--out", str(out)])
        assert f"6 conditional realizations -> {out}.samples.npz" in printed
        with np.load(f"{out}.samples.npz") as f:
            files[name] = (TIO.load_table(out), list(f.keys()), f["samples"])
    (jt, jk, js), (tt, tk, ts) = files["jax"], files["torch"]
    assert tk == jk == ["samples"]
    assert ts.shape == js.shape == (6, len(main_coords_array()[::3])) and np.isfinite(ts).all()
    assert list(tt.columns) == list(jt.columns) == ["lat", "lon", "pred", "pred_err"]
    for col in ("pred", "pred_err"):
        np.testing.assert_allclose(tt[col], jt[col], atol=1e-6, err_msg=col)


@pytest.mark.parametrize("argv,match", [
    (["sim"], "sim/"),
    (["bench"], "benchmark"),
    (["fit", "--method", "nll", "--bootstrap", "4"], "--bootstrap requires --method wls"),
    (["loocv", "--params", "x.npz", "--predictor", "cg"], "invalid choice: 'cg'"),
    (["predict", "--params", "x.npz", "--conditional-sims", "4"],
     "--conditional-sims requires --joint"),
    (["predict", "--params", "x.npz", "--joint", "--solver", "cg", "--conditional-sims", "4"],
     "requires the dense solver"),
    (["fit", "--timedeltas", "0"], "one offset per --data table"),
])
def test_parser_errors_name_what_is_missing(staged, argv, match, capsys):
    _, paths, _ = staged
    if argv[0] in ("fit", "predict"):
        argv = [argv[0], "--data", *paths, "--timestamp", TIMES[1], "--device", "cpu", *argv[1:]]
    with pytest.raises(SystemExit) as e:
        torch_main(argv)
    assert e.value.code == 2
    assert re.search(re.escape(match), capsys.readouterr().err)


def test_default_device_is_the_card(staged, monkeypatch):
    """Without ``--device`` the CLI runs on the card, and raises where there
    is none rather than moving to the CPU."""
    _, paths, _ = staged
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["fit", *_common(paths), "--out", "unused.npz"])
