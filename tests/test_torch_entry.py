"""The port's entry points (``cokriging_tpu_torch/entry.py``) on the CPU in
float64: ``entry()``'s joint-cokriging step on the JAX entry's own
example arguments (``__graft_entry__.entry()``, imported and read) equals
the JAX step at rtol 1e-10, and ``dryrun_multichip`` prints its OK line on
two virtual shards at a small size (CG on 2 x 30 points: on the CPU each
CG tile and iteration is one plain K_nu pass)."""

import jax
import numpy as np
import torch

import __graft_entry__ as jax_entry
from cokriging_tpu_torch import entry as E

torch.set_num_threads(1)


def test_entry_step_matches_jax_on_its_example_arguments():
    jfn, jargs = jax_entry.entry()
    want = [np.asarray(o) for o in jax.jit(jfn)(*jargs)]
    fn, args = E.entry(device="cpu")
    assert [tuple(a.shape) for a in args] == [tuple(np.shape(a)) for a in jargs]
    got = fn(*[torch.as_tensor(np.asarray(a)) for a in jargs])
    assert all(np.isfinite(w).all() for w in want)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-10, atol=1e-12)
    # the variance, whose round-off at the prediction cells that hold data
    # (zero nugget: variance 0) the square root lifts to ~1e-8
    np.testing.assert_allclose(got[1].numpy() ** 2, want[1] ** 2, rtol=1e-10, atol=1e-14)


def test_dryrun_multichip_on_two_virtual_shards(capsys):
    E.dryrun_multichip(2, device="cpu", nx=9, sample_size=30, cg_block=64)
    assert "dryrun_multichip OK on 2 devices" in capsys.readouterr().out
