"""Committed evidence manifests for example and benchmark runs.

Counterpart of ``cokriging_tpu/utils/results.py``: one small JSON manifest
per recorded run under ``results/`` at the repository root (device,
wall-clock, headline metrics, git revision) plus figures under
``results/figures/``. Where the JAX package records its backend, a
manifest here names the card and its power limit (``nvidia-smi``), since a
card set below its maximum runs slower under load.

Recording is opt-in via ``record_manifest``; set ``COKRIGING_RESULTS_DIR``
to redirect the output, or ``COKRIGING_NO_RECORD=1`` to write nothing.
"""

import json
import os
import pathlib
import subprocess
import time


def _repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2]


def results_dir() -> pathlib.Path:
    override = os.environ.get("COKRIGING_RESULTS_DIR")
    return pathlib.Path(override) if override else _repo_root() / "results"


def _run(cmd) -> str:
    try:
        return subprocess.run(cmd, cwd=_repo_root(), capture_output=True, text=True,
                              timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def _git_rev() -> str:
    return _run(["git", "rev-parse", "--short", "HEAD"]) or "unknown"


def device_record() -> dict:
    """The device a run used: ``{"backend": "cuda", "devices": n,
    "device_name": ..., "power_limit": ...}`` on a card (name and power
    limit as ``nvidia-smi`` reports them), ``{"backend": "cpu", "devices":
    0}`` without one."""
    import torch

    if not torch.cuda.is_available():
        return {"backend": "cpu", "devices": 0}
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    limit = smi.splitlines()[0].split(",")[-1].strip() if smi else "unknown"
    return {
        "backend": "cuda",
        "devices": torch.cuda.device_count(),
        "device_name": torch.cuda.get_device_name(0),
        "power_limit": limit,
    }


def _jsonable(x):
    import numpy as np

    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return [_jsonable(v) for v in x.tolist()]
    if isinstance(x, float):
        return round(x, 6)
    return x


def record_manifest(name: str, payload: dict) -> pathlib.Path:
    """Write ``results/<name>.json`` with the run's metadata and ``payload``.

    Returns the path written (or the would-be path when disabled via
    COKRIGING_NO_RECORD).
    """
    root = results_dir()
    path = root / f"{name}.json"
    if os.environ.get("COKRIGING_NO_RECORD"):
        return path
    out = {
        "example": name,
        **device_record(),
        "git_rev": _git_rev(),
        "recorded": time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime()),
        **_jsonable(payload),
    }
    root.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2) + "\n")
    print(f"[results] wrote {path}")
    return path


def save_figure(fig, name: str):
    """Save a figure into results/figures/<name>.png."""
    if os.environ.get("COKRIGING_NO_RECORD"):
        return None
    root = results_dir() / "figures"
    root.mkdir(parents=True, exist_ok=True)
    path = root / f"{name}.png"
    fig.savefig(path, dpi=110, bbox_inches="tight")
    print(f"[results] wrote {path}")
    return path
