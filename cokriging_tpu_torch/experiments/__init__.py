"""The port's experiments: end-to-end validation runs over the package
(``python -m cokriging_tpu_torch sim`` runs ``simulation_experiment``;
``million_point_workflow`` has no subcommand, as in the JAX package)."""

import os
import time

import torch


def resolve_sizes(device, card, cpu, sizes, env=None, parse=None):
    """A workflow's sizes on ``device``: ``card`` on the card, ``cpu`` on
    the CPU; over them each environment knob of ``env`` ({size: variable})
    that is set, read by ``parse[size]`` (int by default); then ``sizes``,
    whose keys must be the workflow's (TypeError otherwise)."""
    unknown = set(sizes) - set(card)
    if unknown:
        raise TypeError(f"unknown sizes {sorted(unknown)}; the sizes are {sorted(card)}")
    s = dict(card if device.type == "cuda" else cpu)
    for k, var in (env or {}).items():
        if var in os.environ:
            s[k] = (parse or {}).get(k, int)(os.environ[var])
    return {**s, **sizes}


class Stages:
    """Per stage: host seconds, each stage ended by a synchronize of the
    card (when the work runs there), the kernels' launch counts
    (``cuda_ops.LAUNCHES``; none on the CPU) and the peak device memory in
    MiB (on the card). ``stages(name)`` closes the stage that ran since the
    last call (or since the object was made) and prints its seconds;
    ``stages.skip()`` drops what ran since then (work no stage owns)."""

    def __init__(self, device):
        self.device = device
        self.seconds, self.launches, self.peak_mib = {}, {}, {}
        self._open()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _open(self):
        from cokriging_tpu_torch.kernels import cuda_ops

        self._sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self._counts = cuda_ops.launch_counts()
        self._t = time.perf_counter()

    def skip(self):
        self._open()

    def __call__(self, name):
        from cokriging_tpu_torch.kernels import cuda_ops

        self._sync()
        self.seconds[name] = time.perf_counter() - self._t
        now = cuda_ops.launch_counts()
        self.launches[name] = {k: v - self._counts[k] for k, v in now.items() if v > self._counts[k]}
        if self.device.type == "cuda":
            self.peak_mib[name] = torch.cuda.max_memory_allocated(self.device) / 2**20
        print(f"[{self.seconds[name]:6.1f}s] {name}", flush=True)
        self._open()
