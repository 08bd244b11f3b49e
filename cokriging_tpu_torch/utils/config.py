"""Global constants and the device rule of the port.

Counterpart of ``cokriging_tpu/utils/config.py``. The JAX package switches
on 64-bit mode and a compilation cache here; PyTorch needs neither. What
remains is the shared constant, the one rule every entry point follows
(run on the card unless the caller asks for the CPU, and never fall back)
and the port's dtype policy.
"""

import os

import torch

#: Earth radius in kilometers (reference: src/fields.py:17).
EARTH_RADIUS_KM = 6371.0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``"cuda"``). Asking for a CUDA device on a
    machine without one raises: an entry point never moves to the CPU on
    its own. Pass ``device="cpu"`` to run on the host (as the tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    return dev


def compute_dtype(device=None) -> torch.dtype:
    """The port's dtype policy: float32 on the card, float64 on the CPU.

    float32 is the card's default because it was measured there: bench.py's
    fit + predict runs 3.2-3.8x faster in float32 on an NVIDIA H100, with
    parameters within ~3e-3 of float64's (PERF.md section 5). The CPU keeps
    float64, the dtype of the reference's goldens. ``device`` is where the
    work runs (by default the card where there is one); override per
    process with ``COKRIGING_DTYPE=float32|float64``.
    """
    env = os.environ.get("COKRIGING_DTYPE")
    if env:
        return {"float32": torch.float32, "float64": torch.float64}[env]
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
