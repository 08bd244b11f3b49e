"""The port's main path imports neither JAX, nor the JAX package, nor the
optional frame/plot libraries. The frame layer (fields from data frames,
the grids' frame wrangling, postprocessing, table I/O, the CLI, the
uncertainty frames, the regional statistics) imports pandas only inside the
functions that take or return frames."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import cokriging_tpu_torch
import cokriging_tpu_torch.cov.matern
import cokriging_tpu_torch.cov.spectral
import cokriging_tpu_torch.data.grids
import cokriging_tpu_torch.estimate.empirical
import cokriging_tpu_torch.estimate.nll
import cokriging_tpu_torch.estimate.vecchia
import cokriging_tpu_torch.estimate.wls
import cokriging_tpu_torch.fields.field
import cokriging_tpu_torch.kernels.cuda_ops
import cokriging_tpu_torch.predict.iterative
import cokriging_tpu_torch.predict.joint
import cokriging_tpu_torch.predict.local
import cokriging_tpu_torch.estimate.bootstrap
import cokriging_tpu_torch.sim
import cokriging_tpu_torch.sim.cofield
import cokriging_tpu_torch.sim.spectral
import cokriging_tpu_torch.utils.convert
import cokriging_tpu_torch.predict.postprocess
import cokriging_tpu_torch.utils.io
import cokriging_tpu_torch.estimate.uncertainty
import cokriging_tpu_torch.stats
import cokriging_tpu_torch.stats.spacetime
import cokriging_tpu_torch.stats.regional
import cokriging_tpu_torch.utils.config
import cokriging_tpu_torch.utils.profiling
import cokriging_tpu_torch.utils.results
import cokriging_tpu_torch.__main__
import cokriging_tpu_torch.cov
import cokriging_tpu_torch.data
import cokriging_tpu_torch.estimate
import cokriging_tpu_torch.fields
import cokriging_tpu_torch.kernels
import cokriging_tpu_torch.predict
from cokriging_tpu_torch.__main__ import _parser
_parser()
from cokriging_tpu_torch.data.grids import prediction_coords
prediction_coords()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "cokriging_tpu", "pandas",
                                    "matplotlib", "optax"))
print(",".join(bad))
"""


def test_main_path_imports_no_jax_pandas_matplotlib_optax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_package_sources_never_import_jax_or_the_jax_package():
    for path in (ROOT / "cokriging_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "cokriging_tpu", "optax"), (path, line)
