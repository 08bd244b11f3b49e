"""Global constants and the device rule of the port.

Counterpart of ``cokriging_tpu/utils/config.py``. The JAX package switches
on 64-bit mode and a compilation cache here; PyTorch needs neither. What
remains is the shared constant and the one rule every entry point follows:
run on the card unless the caller asks for the CPU, and never fall back.
"""

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
