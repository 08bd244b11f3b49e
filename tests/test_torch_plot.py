"""The port's figures (``plot/``): all 13 render from the port's objects
(the shape of ``tests/test_plot_io.py:49,103``), the monthly GIF has one
frame per month, and the figures that take frames plot the same arrays
(line data, collection offsets and colour arrays, bar rectangles) as the
JAX package's figures on the same frame."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cokriging_tpu.plot as JP  # noqa: E402
import cokriging_tpu_torch.plot as TP  # noqa: E402
from cokriging_tpu_torch.cov.matern import MultivariateMatern  # noqa: E402
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec  # noqa: E402

torch.set_num_threads(1)

SIM_FLAT = [1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.0, 0.0, -0.6]


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _drawn(fig):
    """What a figure plots, axes by axes: line data, collection offsets
    and colour arrays, patch rectangles."""
    out = []
    for ax in fig.axes:
        out += [np.asarray(line.get_xydata(), float) for line in ax.lines]
        for c in ax.collections:
            out.append(np.asarray(c.get_offsets(), float))
            if c.get_array() is not None:
                out.append(np.ma.filled(np.asarray(c.get_array(), float), np.nan))
        out += [np.asarray(p.get_bbox().bounds, float) for p in ax.patches]
    return out


def _same_drawing(port_fig, jax_fig):
    got, want = _drawn(port_fig), _drawn(jax_fig)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def frames():
    """Frames made with numpy: a lat/lon map, a LOOCV frame, two
    prediction frames on x/y, a monthly climatology."""
    rng = np.random.default_rng(5)
    lat, lon = rng.uniform(25, 50, 60), rng.uniform(-120, -70, 60)
    xy = rng.uniform(0, 1, (50, 2))
    pred = {k: pd.DataFrame({"x": xy[:, 0], "y": xy[:, 1], "pred": rng.normal(size=50),
                             "pred_err": rng.uniform(0.2, 1.0, 50)}) for k in ("biv", "uni")}
    cv = pd.DataFrame({"d1": xy[:, 0], "d2": xy[:, 1], "data": rng.normal(size=50),
                       "pred": rng.normal(size=50), "pred_err": rng.uniform(0.1, 1.0, 50)})
    cv["residual"] = cv["data"] - cv["pred"]
    clim = pd.DataFrame({"time": pd.date_range("2015-01-01", periods=36, freq="MS"),
                         "sif": 0.02 * np.arange(36) + rng.normal(size=36),
                         "xco2": 400 + 0.2 * np.arange(36) + rng.normal(size=36)})
    return {"map": pd.DataFrame({"lat": lat, "lon": lon, "v": lat + lon}), "cv": cv,
            "biv": pred["biv"], "uni": pred["uni"], "clim": clim}


@pytest.mark.parametrize("name", ["plot_df", "plot_cv_resid", "plot_err_ratio",
                                  "raw_climatology", "resid_climatology"])
def test_frame_figures_plot_what_jax_plots(frames, name):
    call = {
        "plot_df": lambda m: m.plot_df(frames["map"], "v").figure,
        "plot_cv_resid": lambda m: m.plot_cv_resid(frames["cv"], "Z0"),
        "plot_err_ratio": lambda m: m.plot_err_ratio(frames["biv"], frames["uni"]),
        "raw_climatology": lambda m: m.raw_climatology(frames["clim"], ["sif", "xco2"]),
        "resid_climatology": lambda m: m.resid_climatology(frames["clim"], ["sif", "xco2"]),
    }[name]
    _same_drawing(call(TP), call(JP))


@pytest.fixture(scope="module")
def sim_setup():
    from cokriging_tpu_torch.sim import BivariateRandomField, CartesianGrid

    mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(SIM_FLAT,
                                                                        dtype=torch.float64)))
    grid = CartesianGrid(xcount=15, ycount=15, device="cpu")
    rf = BivariateRandomField(mod, grid, seed=0, device="cpu")
    samples = rf.sample(size=40, epsilon=[0.1, 0.1], seed=1)
    return mod, grid, rf, samples, rf.to_fields(samples)


def test_every_figure_renders(sim_setup, frames):
    import warnings

    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
    from cokriging_tpu_torch.estimate.wls import fit_wls
    from cokriging_tpu_torch.predict.joint import JointPredictor

    mod, grid, rf, samples, mf = sim_setup
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = empirical_variograms(mf, VarioConfig(1.0, 6, geodesic=False), device="cpu")
        spec = ParamSpec(2, len_scale_bounds=(0.02, 1.0), nugget_bounds=(0.0, 0.5))
        init = MaternParams.from_flat(
            torch.tensor([1, 1, 1.5, 1.5, 1.5, 0.1, 0.1, 0.1, 0.01, 0.01, 0.0],
                         dtype=torch.float64), spec=spec)
        _, result = fit_wls(est, init=init, maxiter=20, device="cpu")
        jp = JointPredictor(mod, mf, device="cpu")
        pred = jp(0, grid.coords.values[::5], postprocess=False)
        cv = jp.cross_validation(0, postprocess=True)
        mod_uni = MultivariateMatern(1, MaternParams.from_flat(
            torch.tensor([1.0, 1.5, 0.2, 0.0], dtype=torch.float64), spec=ParamSpec(n_procs=1)))
        pred_uni = JointPredictor(mod_uni, rf.to_fields(samples, i=0), device="cpu")(
            0, grid.coords.values[::5], postprocess=False)
        figures = {
            "plot_fields": TP.plot_fields(mf),
            "plot_variograms": TP.plot_variograms(result, names=["Z0", "Z1"]),
            "plot_samples": TP.plot_samples(samples),
            "qq_plots": TP.qq_plots(mf),
            "resid_coord_avg": TP.resid_coord_avg(mf),
            "plot_sim_pred": TP.plot_sim_pred(rf, pred),
            "plot_err_ratio": TP.plot_err_ratio(pred, pred_uni),
            "plot_cv_resid": TP.plot_cv_resid(cv, "Z0"),
            "plot_df": TP.plot_df(frames["map"], "v").figure,
            "plot_da": TP.plot_da(frames["map"], "v").figure,
            "raw_climatology": TP.raw_climatology(frames["clim"], ["sif"]),
            "resid_climatology": TP.resid_climatology(frames["clim"], ["sif"]),
        }
    for name, fig in figures.items():
        assert fig.axes and any(ax.has_data() for ax in fig.axes), name
    # the truth column found every prediction cell
    truth = figures["plot_sim_pred"].axes[0].collections[0].get_array()
    assert np.isfinite(np.ma.filled(truth, np.nan)).all()
    # with animate_monthly below: the 13 figures of the JAX package's plot/
    assert len(figures) == 12 and "animate_monthly" not in figures


def test_animate_monthly(tmp_path):
    """A GIF of a gridded monthly field: one frame per month, fixed colour
    scale; an empty frame raises."""
    from PIL import Image

    rng = np.random.default_rng(0)
    times = pd.date_range("2015-01-01", periods=4, freq="MS")
    lat, lon = np.meshgrid(np.arange(25.0, 50, 5), np.arange(-120.0, -70, 5))
    df = pd.concat([pd.DataFrame({"time": t, "lat": lat.ravel(), "lon": lon.ravel(),
                                  "sif": rng.normal(size=lat.size)}) for t in times],
                   ignore_index=True)
    out = tmp_path / "anim.gif"
    anim = TP.animate_monthly(df, "sif", out_path=str(out), vcenter=0.0, fps=4)
    assert anim is not None and out.exists()
    with Image.open(out) as im:
        assert im.n_frames == 4
    with pytest.raises(ValueError):
        TP.animate_monthly(df.iloc[:0], "sif")
