"""The port's default arguments against the JAX package's: every public
function and method the two packages share (by module, name and parameter)
takes the JAX package's default wherever the JAX package gives one, so the
same call means the same thing in both. One exception: the directory of
``utils.profiling.trace``, a path and not a result. A behavioural case holds
the predictors' ``postprocess=True`` default on fields built from frames."""

import dataclasses
import importlib
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

#: (module, callable, parameter) -> why the port's default differs
EXCEPTIONS = {
    ("utils.profiling", "trace", "dirname"): "a trace directory: a path, not a result",
}


def _modules(pkg):
    out = []
    for path in sorted((ROOT / pkg).rglob("*.py")):
        parts = [p for p in path.relative_to(ROOT / pkg).with_suffix("").parts if p != "__init__"]
        out.append(".".join(parts))
    return out


def _function(obj):
    return obj.__func__ if isinstance(obj, (staticmethod, classmethod)) else obj


def _shared_callables():
    """(module, qualified name, JAX callable, port callable) for every
    public function and every public method (``__init__`` and ``__call__``
    too) of a public class that a JAX module defines and the port's
    counterpart module also has."""
    out = []
    for mod in sorted(set(_modules("cokriging_tpu")) & set(_modules("cokriging_tpu_torch"))):
        jname = "cokriging_tpu" + (f".{mod}" if mod else "")
        jax_mod = importlib.import_module(jname)
        port = importlib.import_module("cokriging_tpu_torch" + (f".{mod}" if mod else ""))
        for name, jobj in vars(jax_mod).items():
            if name.startswith("_") or getattr(jobj, "__module__", None) != jname:
                continue
            pobj = getattr(port, name, None)
            if inspect.isfunction(jobj) and callable(pobj):
                out.append((mod, name, jobj, pobj))
            elif inspect.isclass(jobj) and inspect.isclass(pobj):
                for meth, jm in vars(jobj).items():
                    if meth.startswith("_") and meth not in ("__init__", "__call__"):
                        continue
                    jm = _function(jm)
                    pm = _function(inspect.getattr_static(pobj, meth, None))
                    if inspect.isfunction(jm) and inspect.isfunction(pm):
                        out.append((mod, f"{name}.{meth}", jm, pm))
    return out


def _defaulted(jfn, pfn):
    """The parameters with a JAX default that the port's callable shares."""
    port = inspect.signature(pfn).parameters
    return [p for p in inspect.signature(jfn).parameters.values()
            if p.default is not inspect.Parameter.empty and p.name in port]


CASES = [c for c in _shared_callables() if _defaulted(c[2], c[3])]


def _same(a, b):
    """Equal defaults across the packages: dataclass instances (each
    package's own class) field by field, sequences item by item."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return (type(a).__name__ == type(b).__name__
                and _same(dataclasses.astuple(a), dataclasses.astuple(b)))
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and bool(np.all(a == b))


@pytest.mark.parametrize("mod,name,jfn,pfn", CASES,
                         ids=[f"{m or 'package'}.{n}" for m, n, _, _ in CASES])
def test_defaults_match_the_jax_package(mod, name, jfn, pfn):
    port = inspect.signature(pfn).parameters
    differ = {}
    for p in _defaulted(jfn, pfn):
        q = port[p.name]
        key = (mod, name, p.name)
        if key in EXCEPTIONS:
            assert not _same(p.default, q.default), f"{key} agrees now: drop it from EXCEPTIONS"
        elif not _same(p.default, q.default):
            differ[p.name] = (p.default, q.default)
    assert not differ, f"{mod}.{name}: (JAX, port) defaults {differ}"


def test_every_exception_is_a_shared_default():
    keys = {(m, n, p.name) for m, n, j, t in CASES for p in _defaulted(j, t)}
    assert set(EXCEPTIONS) <= keys


def test_local_predictor_defaults_to_the_data_scale_of_the_jax_package():
    """On fields built from frames with a trend on the coordinates, the
    same call on the defaults gives the JAX package's data-scale frame
    (rtol 1e-10, float64) in the port, and the standardized values only
    with ``postprocess=False``."""
    from cokriging_tpu.cov import MultivariateMatern as JMod
    from cokriging_tpu.cov.params import MaternParams as JParams
    from cokriging_tpu.fields.field import MultiField as JMultiField
    from cokriging_tpu.predict import LocalPredictor as JLocal
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.fields.field import MultiField
    from cokriging_tpu_torch.predict.local import LocalPrediction, LocalPredictor

    rng = np.random.default_rng(5)
    frames = []
    for k, name in enumerate(("xco2", "sif")):
        lat, lon = rng.uniform(30.0, 45.0, 40), rng.uniform(-110.0, -90.0, 40)
        vals = 400.0 + 3.0 * k + 0.2 * lat - 0.1 * lon + rng.normal(scale=0.5, size=40)
        frames.append(pd.DataFrame({"time": pd.Timestamp("2019-02-01"), "lat": lat, "lon": lon,
                                    name: vals}))
    args = (frames, ["xco2", "sif"], [["lon", "lat"]] * 2)
    kw = dict(timestamp="2019-02-01", timedeltas=[0, 0])
    flat = np.array([1.0, 0.8, 1.3, 1.4, 1.2, 600.0, 500.0, 550.0, 0.1, 0.1, 0.3])
    cells = pd.DataFrame({"lat": rng.uniform(32.0, 43.0, 12), "lon": rng.uniform(-108.0, -92.0, 12)})
    want = JLocal(JMod(params=JParams.from_flat(flat)), JMultiField.from_dataframes(*args, **kw))(
        0, cells, max_dist=800.0)
    lp = LocalPredictor(MultivariateMatern(params=MaternParams.from_flat(torch.tensor(flat))),
                        MultiField.from_dataframes(*args, **kw), device="cpu")
    got = lp(0, cells, max_dist=800.0)
    assert isinstance(got, pd.DataFrame) and list(got.columns) == list(want.columns)
    assert np.isfinite(want["pred"]).all() and float(want["pred"].mean()) > 300.0
    for col in ("pred", "pred_err"):
        np.testing.assert_allclose(got[col], want[col], rtol=1e-10, err_msg=col)
    raw = lp(0, cells, max_dist=800.0, postprocess=False)
    assert isinstance(raw, LocalPrediction) and abs(float(np.mean(raw.pred))) < 10.0


#: the JAX repo's example workflows with a counterpart in the port's
#: ``experiments`` (module, function): their shared defaults must agree too
WORKFLOWS = [("modelling_comparison", "synthesize_conus_months"),
             ("modelling_comparison", "run_comparison")]


@pytest.mark.parametrize("module,name", WORKFLOWS, ids=[f"{m}.{n}" for m, n in WORKFLOWS])
def test_workflow_defaults_match_the_jax_examples(module, name):
    """The port's workflow functions take the JAX script's defaults, and
    every parameter of the JAX function is the port's too (the port adds
    ``device`` and, to ``run_comparison``, ``stages``)."""
    spec = importlib.util.spec_from_file_location(f"_jax_example_{module}",
                                                  ROOT / "examples" / f"{module}.py")
    jax_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_mod)
    port = importlib.import_module(f"cokriging_tpu_torch.experiments.{module}")
    jp = inspect.signature(getattr(jax_mod, name)).parameters
    pp = inspect.signature(getattr(port, name)).parameters
    assert list(pp)[:len(jp)] == list(jp)
    assert set(pp) - set(jp) <= {"device", "stages"}
    differ = {k: (p.default, pp[k].default) for k, p in jp.items()
              if not _same(p.default, pp[k].default)}
    assert not differ, f"{module}.{name}: (JAX, port) defaults {differ}"


@pytest.mark.parametrize("module", ["million_point_workflow", "modelling_comparison", "full_record",
                                    "trivariate_demo", "vecchia_scaling", "nll_scaling"])
def test_workflow_main_defaults(module):
    """A workflow's ``main`` runs on the card unless asked for the CPU
    (``device=None``, resolved by ``utils.config.resolve_device``), makes
    its own ``Stages`` unless given one, and takes its sizes as keywords
    over the script's."""
    port = importlib.import_module(f"cokriging_tpu_torch.experiments.{module}")
    params = inspect.signature(port.main).parameters
    assert params["device"].default is None and params["stages"].default is None
    assert list(params.values())[-1].kind is inspect.Parameter.VAR_KEYWORD
    if module == "modelling_comparison":  # the JAX script's keywords ride along
        assert params["timestamp"].default == "2019-05-01"
