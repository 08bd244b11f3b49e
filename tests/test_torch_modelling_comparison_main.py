"""The port's kriging-vs-cokriging comparison run whole on the CPU
(``modelling_comparison.main(device="cpu")``: ``run_comparison(seed=0,
pred_stride=6, maxiter=250)``, the JAX test's size, float64) and held to
the gates of ``tests/test_modelling_comparison.py``; its manifest, figures
and comparison with the JAX manifest. Its four 250-step Adam fits (each run
twice, as the script times a second run) take most of its time, so it has a
file of its own."""

import json

import numpy as np
import torch

from cokriging_tpu_torch.experiments import modelling_comparison as MC

torch.set_num_threads(2)

STAGES = ["synthesize", "fields_uni", "variogram_uni", "fit_uni", "predictor_uni", "predict_uni",
          "loocv_uni", "fields_biv", "variogram_biv", "fit_biv", "predictor_biv", "predict_biv",
          "loocv_biv"]


def test_main_on_the_cpu_passes_the_jax_tests_gates(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("COKRIGING_RESULTS_DIR", str(tmp_path))
    monkeypatch.delenv("COKRIGING_NO_RECORD", raising=False)
    record = MC.main(device="cpu")
    assert record["sizes"] == dict(months=6, pred_stride=6, maxiter=250)
    assert record["dtype"] == "float64"

    # the gates of tests/test_modelling_comparison.py on the port's run
    assert record["rho"] < -0.15, record["rho"]
    assert record["n_ratio_cells"] > 100
    assert record["err_ratio_lt1_frac"] > 0.8
    assert record["err_ratio_median"] < 0.95
    assert record["mspe"]["cokriging"] <= record["mspe"]["kriging"]
    assert 0.0 < record["pred_mean_cokrig"] < 2.0

    # every land cell of the stride in both frames, merged on float64 lat/lon
    assert record["n_pred_cells"] == record["n_merged_cells"] == len(MC.prediction_frame(6)[0])
    assert list(record["stage_s"]) == STAGES
    assert list(record["stage_warm_s"]) == [s for s in STAGES if s.split("_")[0] in
                                            ("fit", "predict", "loocv")]
    assert all(not v for v in record["launches"].values()) and record["peak_mib"] == {}

    written = json.loads((tmp_path / "torch_modelling_comparison.json").read_text())
    assert written["example"] == "torch_modelling_comparison" and written["backend"] == "cpu"
    assert written["mspe"] == {k: round(v, 6) for k, v in record["mspe"].items()}
    assert record["figures"] and {p.name for p in (tmp_path / "figures").iterdir()} == {
        f"torch_comparison_{k}.png" for k in ("variograms", "err_ratio", "cv_kriging",
                                              "cv_cokriging", "cokrig_pred", "cokrig_pred_err")}

    rows = MC.compare_manifest(record)
    assert len(rows) == 4 + 1 + 11 and all(np.isfinite(r[3]) for r in rows)
    assert "port - JAX" in capsys.readouterr().out
