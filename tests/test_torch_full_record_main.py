"""The port's 71-month record workflow run whole on the CPU at the JAX
script's CPU sizes (``full_record.main(device="cpu")``: 8 months, 1
predicted month, every 8th land cell, float64): the script's gates (every
cost finite, the predicted month > 90% finite), the record's months, the
batched fit's iterations, its manifest and figure, and its comparison with
the JAX manifest. Its batched fit of 8 months x 3 starts runs the CPU's
plain K_nu for every iteration (~50 s), so it has a file of its own."""

import json

import numpy as np
import pytest
import torch

from cokriging_tpu_torch.experiments import full_record as FR
from cokriging_tpu_torch.experiments.modelling_comparison import prediction_frame

torch.set_num_threads(2)


def test_main_on_the_cpu_passes_the_script_gates(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("COKRIGING_RESULTS_DIR", str(tmp_path))
    monkeypatch.delenv("COKRIGING_NO_RECORD", raising=False)
    monkeypatch.delenv("FULL_RECORD_MONTHS", raising=False)
    record = FR.main(device="cpu")
    assert record["sizes"] == FR.CPU_SIZES and record["dtype"] == "float64"
    # the JAX script's months: XCO2 from 2019-01, SIF one month behind
    assert record["months_fit"] == 8 and record["mesh_devices"] == 1
    assert record["months"] == [f"2019-{m:02d}-01" for m in range(2, 10)]
    assert record["record_span"] == ["2019-02-01", "2019-09-01"]
    assert record["pred_months"] == ["2019-02-01"]
    assert record["pred_cells_per_month"] == len(prediction_frame(8)[0])
    # the script's gates, and the fit's bounds and count of iterations
    assert np.isfinite(record["costs"]).all() and min(record["pred_finite_frac"].values()) > 0.9
    assert np.all(np.abs(record["rho_track"]) <= FR.RHO_BOUND)
    assert record["n_rho_bound"] == int((np.abs(record["rho_track"]) > FR.PEGGED).sum())
    assert record["n_converged"] == sum(record["converged"])
    assert 0 < record["fit_iterations"] <= 300 + 1
    assert record["fit_s_per_iteration"] * record["fit_iterations"] == pytest.approx(
        record["wall_s"]["batched_fit"], rel=1e-12)
    assert list(record["wall_s"]) == list(FR.JAX_MANIFEST["wall_s"])
    assert all(not v for v in record["launches"].values()) and record["peak_mib"] == {}

    written = json.loads((tmp_path / "torch_full_record.json").read_text())
    assert written["example"] == "torch_full_record" and written["months_fit"] == 8
    assert record["figures"] and (tmp_path / "figures" / "torch_full_record_months.png").exists()

    rows = dict((r[0], r[1:]) for r in FR.compare_manifest(record))
    assert rows["months_fit"] == (8, 71, -63)
    assert rows["finite 2019-02-01"][1] == 1.0
    assert "not compared month by month" in capsys.readouterr().out
