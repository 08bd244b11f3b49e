"""The port's granule readers (``data/readers.py``) and NetCDF artifacts
(``utils/io.py::save_dataset`` / ``load_dataset``) against the JAX
package's: frames equal (``pandas.testing.assert_frame_equal``) on the
real-format granules of ``tests/fixtures/*.nc4``, and a dataset written by
either package loads in the other."""

from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
from pandas.testing import assert_frame_equal

from cokriging_tpu.data import readers as JR
from cokriging_tpu.utils import io as JIO
from cokriging_tpu_torch import data as TD
from cokriging_tpu_torch.data import readers as TR
from cokriging_tpu_torch.utils import io as TIO

FIX = Path(__file__).parent / "fixtures"


@pytest.mark.parametrize("kind", ["sif", "xco2"])
def test_open_mf_granules_match_jax(kind):
    """Both days of OCO-2 Lite granules through ``open_mf`` with the
    reader of their kind, on a thread pool and in turn."""
    paths = sorted(FIX.glob(f"oco2_{kind}_lite_*.nc4"))
    assert len(paths) == 2
    want = JR.open_mf(paths, getattr(JR, f"prep_{kind}"))
    got = TR.open_mf(paths, getattr(TD, f"prep_{kind}"))
    assert len(got) > 0
    assert_frame_equal(got, want)
    assert_frame_equal(TR.open_mf(paths, getattr(TR, f"prep_{kind}"), workers=1), want)


def test_readers_on_dicts_match_jax():
    """The quality filters on a dict granule with every flag and sign case,
    numeric and pre-parsed times."""
    rng = np.random.default_rng(3)
    n = 40
    sif = {"Daily_SIF_740nm": rng.normal(0.2, 0.5, n), "SIF_Uncertainty_740nm": rng.uniform(0, 0.3, n),
           "Quality_Flag": rng.integers(0, 3, n), "Longitude": rng.uniform(-120, -70, n),
           "Latitude": rng.uniform(25, 50, n), "Delta_Time": rng.uniform(8e8, 8.1e8, n)}
    xco2 = {"xco2": rng.normal(410, 2, n), "xco2_uncertainty": rng.uniform(0, 1, n),
            "xco2_quality_flag": rng.integers(0, 2, n), "longitude": sif["Longitude"],
            "latitude": sif["Latitude"],
            "time": pd.date_range("2019-07-01", periods=n, freq="h").values}
    assert_frame_equal(TD.prep_sif(sif), JR.prep_sif(sif))
    assert_frame_equal(TD.prep_xco2(xco2), JR.prep_xco2(xco2))


def test_evi_cutout_matches_jax():
    with h5py.File(FIX / "modis_evi_200km.nc4", "r") as f:
        for date in (None, "2019-07-01"):
            assert_frame_equal(TD.prep_evi(f, date=date), JR.prep_evi(f, date=date))


def test_transcom_matches_jax(tmp_path):
    """The region filter on a dict and on a frame, and the IDL binary with
    and without its record markers."""
    rng = np.random.default_rng(4)
    region = rng.integers(0, 23, 360 * 180).astype(">i4")
    ds = {"lon": rng.uniform(-180, 180, 500), "lat": rng.uniform(-90, 90, 500),
          "region": region[:500].astype(float)}
    assert_frame_equal(TD.read_transcom(ds), JR.read_transcom(ds))
    assert_frame_equal(TD.read_transcom(pd.DataFrame(ds)), JR.read_transcom(pd.DataFrame(ds)))
    for marked in (False, True):
        path = tmp_path / f"transcom_{marked}.bin"
        marker = np.array([360 * 180 * 4], ">i4")
        (np.concatenate([marker, region, marker]) if marked else region).tofile(path)
        assert_frame_equal(TR.read_transcom_binary(path), JR.read_transcom_binary(path))
    region[:3].tofile(tmp_path / "short.bin")
    with pytest.raises(ValueError, match="TransCom binary size"):
        TR.read_transcom_binary(tmp_path / "short.bin")


def _monthly_frame():
    """tests/test_netcdf_io.py's frame: 6 months x 3 x 4 cells, ~20% holes."""
    rng = np.random.default_rng(0)
    rows = []
    for t in pd.date_range("2018-01-01", periods=6, freq="MS"):
        for lat in (32.0, 36.0, 40.0):
            for lon in (-110.0, -105.0, -100.0, -95.0):
                if rng.random() < 0.2:
                    continue
                rows.append({"time": t, "lat": lat, "lon": lon, "xco2": 400 + rng.normal(),
                             "xco2_var": float(rng.random())})
    return pd.DataFrame(rows)


def test_netcdf_round_trip_between_packages(tmp_path):
    """A dataset written by either package loads in the other as the same
    frame (and the same cubes and coordinates), and round trips the data."""
    df = _monthly_frame()
    ours, theirs = tmp_path / "port.nc", tmp_path / "jax.nc"
    TIO.save_dataset(ours, df)
    JIO.save_dataset(theirs, df)
    frames = [load(path) for path in (ours, theirs) for load in (TIO.load_dataset,
                                                                 JIO.load_dataset)]
    for frame in frames[1:]:
        assert_frame_equal(frame, frames[0])
    back = frames[0].merge(df, on=["time", "lat", "lon"], suffixes=("", "_in"))
    assert len(back) == len(frames[0]) == len(df)
    np.testing.assert_array_equal(back["xco2"], back["xco2_in"])
    np.testing.assert_array_equal(back["xco2_var"], back["xco2_var_in"])
    cubes, coords = TIO.load_dataset(theirs, as_frame=False)
    jcubes, jcoords = JIO.load_dataset(ours, as_frame=False)
    assert cubes.keys() == jcubes.keys() and cubes["xco2"].shape == (6, 3, 4)
    for k in cubes:
        np.testing.assert_array_equal(cubes[k], jcubes[k])
    for k in coords:
        np.testing.assert_array_equal(np.asarray(coords[k]), np.asarray(jcoords[k]))
    with h5py.File(ours, "r") as f:
        assert f["lat"].is_scale and f["time"].is_scale
        assert f["xco2"].dims[0][0] == f["time"]
        assert f["time"].attrs["units"] == "days since 1970-01-01"
