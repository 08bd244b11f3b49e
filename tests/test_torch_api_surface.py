"""The port's public surface against the JAX package's: every name a JAX
subpackage exports from its ``__init__`` (and the module-level names the
JAX API documents) is exported by the port's counterpart, except the names
listed here as still to come, each with the ROADMAP item that ports it. A
name listed as to come must really be missing, so the list shrinks as the
port grows."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ["kernels", "cov", "estimate", "predict", "fields", "data", "sim", "stats"]

#: JAX names the port does not have yet -> the ROADMAP.md Queue 1 item
TO_COME = {
    "data": {"prep_sif": 10, "prep_xco2": 10, "prep_evi": 10, "read_transcom": 10},
    "utils.io": {"save_dataset": 10, "load_dataset": 10},
}

#: module-level names of the JAX API that live outside the __init__ exports
MODULES = {
    "utils.io": ["save_params", "load_params", "save_table", "load_table", "save_dataset",
                 "load_dataset"],
    "predict.postprocess": ["postprocess_predictions", "loocv_frame", "inverse_transform_data"],
    "estimate.empirical": ["empirical_variograms_device", "empirical_variogram_pair",
                           "variogram_bins"],
    "estimate.wls": ["validity_penalty", "FitResult", "fit_wls_batch_arrays",
                     "make_device_wls_fitter", "make_device_adam_fitter"],
    "cov.spectral": ["bessel_j0", "spectral_correlation_roundtrip"],
    "cov.matern": ["variogram_value", "joint_covariance_from_coords", "block_covariance",
                   "gathered_covariance"],
    "kernels.distance": ["WGS84_A_KM", "WGS84_F", "WGS84_B_KM", "ZERO_SNAP",
                         "ZERO_SNAP_F32_KM"],
    "data.grids": ["to_frame", "prediction_coords", "CONUS_EXTENTS"],
    "fields.field": ["_coord_isin"],
    "estimate.uncertainty": ["observed_information", "nll_std_errors"],
    "utils.profiling": ["trace", "Timer"],
    "utils.results": ["record_manifest", "results_dir", "save_figure"],
    "utils.config": ["compute_dtype", "EARTH_RADIUS_KM"],
}


def _jax_exports(sub):
    """Names the JAX subpackage's __init__ imports."""
    tree = ast.parse((ROOT / "cokriging_tpu" / sub / "__init__.py").read_text())
    return sorted(a.asname or a.name for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_jax(sub):
    port = importlib.import_module(f"cokriging_tpu_torch.{sub}")
    to_come = TO_COME.get(sub, {})
    names = _jax_exports(sub)
    assert names
    missing = [n for n in names if not hasattr(port, n) and n not in to_come]
    assert not missing, f"cokriging_tpu_torch.{sub} lacks {missing}"
    arrived = [n for n in to_come if hasattr(port, n)]
    assert not arrived, f"now ported, drop from TO_COME: {arrived}"
    assert set(to_come) <= set(names)


@pytest.mark.parametrize("module", sorted(MODULES))
def test_module_names_match_jax(module):
    jax_mod = importlib.import_module(f"cokriging_tpu.{module}")
    port = importlib.import_module(f"cokriging_tpu_torch.{module}")
    to_come = TO_COME.get(module, {})
    for name in MODULES[module]:
        assert hasattr(jax_mod, name), (module, name)
        assert hasattr(port, name) != (name in to_come), (module, name)
        if name.isupper():  # a shared constant has the same value
            assert getattr(port, name) == getattr(jax_mod, name), (module, name)


def test_cli_entry_point_exists():
    assert callable(importlib.import_module("cokriging_tpu_torch.__main__").main)
