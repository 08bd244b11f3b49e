"""Tracing and timing helpers.

Counterpart of ``cokriging_tpu/utils/profiling.py``: a ``torch.profiler``
trace of the host and the card, written as a Chrome trace, and a
wall-clock timer that waits for the card, so that its numbers are device
time and not the time to enqueue.
"""

import contextlib
import os
import tempfile
import time

import torch


def _default_dir():
    return os.path.join(tempfile.gettempdir(), "cokriging_tpu_torch_trace")


@contextlib.contextmanager
def trace(dirname: str = None):
    """Profile the block (CPU and, where there is a card, CUDA activity)
    with ``torch.profiler`` and write ``<dirname>/trace.json`` (Chrome trace
    format, viewable in Perfetto). Yields ``dirname``."""
    dirname = dirname or _default_dir()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield dirname
    os.makedirs(dirname, exist_ok=True)
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))


def _synchronize(tree):
    """Wait for the cards that hold the tensors of a nested structure."""
    if torch.is_tensor(tree):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class Timer:
    """Wall-clock timer that waits for the card.

    >>> with Timer() as t:
    ...     out = fn(x)
    ...     t.block_on(out)
    >>> t.seconds

    ``block_on`` waits for the cards holding the tensors it is given; the
    exit waits for the current card as well when CUDA is in use.
    """

    def __enter__(self):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def block_on(self, tree):
        _synchronize(tree)

    def __exit__(self, *exc):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        return False
