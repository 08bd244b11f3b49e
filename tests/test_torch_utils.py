"""The port's utilities: the dtype policy (``utils.config.compute_dtype``),
the profiling helpers (``utils.profiling``: ``trace`` over
``torch.profiler``, ``Timer``) and the results manifests
(``utils.results``), on the CPU; the JAX package's manifest keys are kept
beside the card's name and power limit."""

import json
import os

import pytest
import torch

from cokriging_tpu_torch.utils import results
from cokriging_tpu_torch.utils.config import compute_dtype
from cokriging_tpu_torch.utils.profiling import Timer, trace


def test_compute_dtype_policy(monkeypatch):
    monkeypatch.delenv("COKRIGING_DTYPE", raising=False)
    assert compute_dtype("cuda") == torch.float32  # measured on the card (PERF.md)
    assert compute_dtype("cpu") == torch.float64
    assert compute_dtype() == (torch.float32 if torch.cuda.is_available() else torch.float64)
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        monkeypatch.setenv("COKRIGING_DTYPE", name)
        assert compute_dtype("cpu") == dt and compute_dtype("cuda") == dt


def test_trace_writes_a_chrome_trace_and_timer_times(tmp_path):
    x = torch.randn(64, 64, dtype=torch.float64)
    with trace(str(tmp_path / "tr")) as d:
        with Timer() as t:
            y = x @ x
            t.block_on({"y": y, "list": [y]})
    assert d == str(tmp_path / "tr")
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert t.seconds > 0.0


def test_record_manifest_names_the_device(tmp_path, monkeypatch):
    monkeypatch.setenv("COKRIGING_RESULTS_DIR", str(tmp_path))
    monkeypatch.delenv("COKRIGING_NO_RECORD", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = results.record_manifest("demo", {"mspe": 0.1234567891, "n": 3})
    out = json.loads(path.read_text())
    assert path == tmp_path / "demo.json"
    assert out["example"] == "demo" and out["backend"] == "cpu" and out["devices"] == 0
    assert out["mspe"] == 0.123457 and out["n"] == 3 and "git_rev" in out and "recorded" in out
    monkeypatch.setenv("COKRIGING_NO_RECORD", "1")
    os.remove(path)
    assert results.record_manifest("demo", {}) == path and not path.exists()
