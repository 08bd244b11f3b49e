"""The port's million-point workflow run whole on the CPU
(``million_point_workflow.main(device="cpu")``) at the JAX package's smoke
test's sizes (``tests/test_workflows_smoke.py``: ``MPW_N=400``,
``MPW_GRID=48``, ``MPW_HOLD=120``, ``MPW_MAXITER=25``, nothing recorded):
it passes the script's own gates (parameter recovery, > 95% finite held-out
predictions, coverage in (0.80, 0.995) below N = 100,000) and returns the
manifest's keys. Its ~65 Vecchia evaluations run the CPU's plain K_nu
(~0.5-1 s each), so it has a file of its own."""

import numpy as np
import torch

from cokriging_tpu_torch.experiments import million_point_workflow as W

torch.set_num_threads(2)


def test_main_on_the_cpu_passes_the_script_gates(monkeypatch):
    for var, value in (("MPW_N", "400"), ("MPW_GRID", "48"), ("MPW_HOLD", "120"),
                       ("MPW_MAXITER", "25"), ("COKRIGING_NO_RECORD", "1")):
        monkeypatch.setenv(var, value)
    monkeypatch.delenv("MPW_M", raising=False)
    record = W.main(device="cpu")
    assert record["n_total"] == 800 and record["grid"] == [48, 48] and record["m"] == 10
    assert record["dtype"] == "float64" and record["predict_cells"] == 120
    assert record["sizes"]["maxiter_full"] == 25 and record["sizes"]["maxiter_warm"] == 30
    assert record["warm_fit"]["n"] == record["full_fit"]["n"] == 800
    assert abs(record["fitted_flat"][-1] - W.TRUTH[-1]) < 0.25
    assert record["predict_finite_frac"] > 0.95 and 0.80 < record["coverage_95"] < 0.995
    assert np.isfinite(record["mspe"]) and record["full_fit"]["nll"] <= record["nll_trace_full"][0]
    assert list(record["stage_s"]) == ["simulate", "fit_warm", "fit_full", "predict"]
    # nothing launches on the CPU; the scaffold's seconds come back per fit
    assert all(not v for v in record["launches"].values()) and record["peak_mib"] == {}
    assert set(record["full_fit"]["scaffold"]) == {"order_s", "neighbors_s", "windows_s",
                                                   "window_bytes"}
