"""A census of the public API: what the JAX package offers, the port must
offer too, name by name, method by method and parameter by parameter.

Both packages are imported on the CPU. For the top level and ``models``,
``utils``, ``trainers``, ``predictors``, ``nets``, ``losses_metrics``,
``transforms``, ``stat``, ``core`` and ``parallel`` (and the submodules
``utils.compat``, ``utils.datasets``, ``utils.aseutils``, ``core.mesh``,
``core.profiling`` and ``core.dtypes``, where the "do not port" names
live) the test lists:
- public names: ``__all__`` and every public attribute defined in the
  package itself;
- public methods (and properties) of each class both packages have;
- parameter names of each callable both have (functions, constructors and
  the shared methods); ``*args`` and ``**kwargs`` count as "*" and "**".

A gap is the JAX side's item missing from the port's. Every gap must
match an entry of ``EXCLUDED`` (an ``fnmatch`` pattern over the gap's
name, each with its reason); every entry must match a gap, so that the
list never outlives what it excuses. Any other gap fails the test and
names itself.
"""

import dataclasses
import fnmatch
import importlib
import inspect

import flax.linen
import pytest
import torch

torch.set_num_threads(1)

NAMESPACES = ["", "models", "utils", "trainers", "predictors", "nets",
              "losses_metrics", "transforms", "stat", "core", "parallel",
              "utils.compat", "utils.datasets", "utils.aseutils",
              "core.mesh", "core.profiling", "core.dtypes"]

_FLAX = "flax linen Module API (the port's nets are torch nn.Modules)"
_TREE = "flax-tree argument (the port's modules hold their own weights)"
_COST = "XLA cost-analysis helper (the port counts FLOPs with torch tools)"
_NOPORT = "ROADMAP 'Do not port': TPU, XLA or tunnel scaffolding"

EXCLUDED = [
    # flax Module classes: flax's own API (less what torch's nn.Module
    # has as well) and dataclass fields
    *[(f"method:nets:*.{n}", _FLAX)
      for n in sorted(set(dir(flax.linen.Module)) - set(dir(torch.nn.Module)))
      if not n.startswith("_")],
    ("param:nets:*.apply:*", _FLAX + ": flax's apply(variables, ...)"),
    ("param:nets:*.__init__:parent", _FLAX),
    ("param:nets:*.__init__:name", _FLAX),
    ("param:nets:SignalED.encode:train", _FLAX + ": the train flag is "
     "module.train() in torch"),
    ("param:nets:SignalED.decode:train", _FLAX + ": the train flag is "
     "module.train() in torch"),
    # flax-tree parameters
    *[(f"param:*:{p}", _TREE) for p in
      ("params", "batch_stats", "variables", "mean_tree", "var_tree", "xnew")],
    ("param:*:key", "a jax.random key: the port draws from torch.Generator"),
    ("name:core:KeySeq", "JAX PRNG idiom; the port has GeneratorSeq"),
    ("name:core:key_from_seed", "JAX PRNG idiom; the port has "
     "generator_from_seed"),
    ("name:core:TrainState", "functional train state; the port keeps "
     "torch optimizer state"),
    # XLA cost helpers
    ("method:*:*.train_bytes_per_cycle", _COST),
    ("method:*:*.train_flops_per_cycle", _COST),
    ("method:*:*.epoch_bytes_accessed", _COST),
    ("method:*:*.forward_compute_elbo_fn", "the pure-function form of the "
     "ELBO; the port's counterpart is forward_compute_elbo"),
    ("param:*:export_model:platforms", "jax.export lowering platforms; "
     "torch.export programs serve on any device"),
    ("name:models:convert_fcnn_state_dict", "builds a flax tree from a "
     "reference .tar; the port's counterpart is load_torch_checkpoint"),
    # ROADMAP's "Do not port" list
    ("name:core.profiling:tunnel_probe", _NOPORT),
    ("name:core.profiling:compiled_bytes_accessed", _NOPORT),
    ("name:core.profiling:jaxpr_matmul_flops", _NOPORT),
    ("name:core.dtypes:enable_compilation_cache", _NOPORT),
]


def _module(pkg, ns):
    return importlib.import_module(pkg + ("." + ns if ns else ""))


def _public_names(mod):
    names = set(getattr(mod, "__all__", ()))
    root = mod.__name__.split(".")[0]
    for n in dir(mod):
        if n.startswith("_"):
            continue
        obj = getattr(mod, n)
        home = obj.__name__ if inspect.ismodule(obj) else \
            getattr(obj, "__module__", None)
        if isinstance(home, str) and home.split(".")[0] == root:
            names.add(n)
    return names


def _methods(cls):
    fields = {f.name for f in dataclasses.fields(cls)} \
        if dataclasses.is_dataclass(cls) else set()
    out = set()
    for n in dir(cls):
        if n.startswith("_") or n in fields:
            continue
        attr = inspect.getattr_static(cls, n, None)
        if isinstance(attr, (staticmethod, classmethod, property)) or \
                inspect.isfunction(attr) or inspect.ismethoddescriptor(attr):
            out.add(n)
    return out


def _params(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    kinds = {inspect.Parameter.VAR_POSITIONAL: "*",
             inspect.Parameter.VAR_KEYWORD: "**"}
    return [kinds.get(p.kind, p.name) for p in sig.parameters.values()]


def _param_gaps(tag, jfn, tfn):
    pj, pt = _params(jfn), _params(tfn)
    if pj is None or pt is None:
        return []
    return [f"param:{tag}:{p}" for p in pj if p not in pt]


def census():
    """Every gap, as "name:<ns>:<name>", "method:<ns>:<Class>.<method>" or
    "param:<ns>:<callable>:<parameter>"."""
    gaps = []
    for ns in NAMESPACES:
        jm, tm = _module("atomai_tpu", ns), _module("atomai_tpu_torch", ns)
        jnames, tnames = _public_names(jm), _public_names(tm)
        gaps += [f"name:{ns}:{n}" for n in sorted(jnames - tnames)]
        for n in sorted(jnames & tnames):
            a, b = getattr(jm, n), getattr(tm, n)
            if inspect.isclass(a) and inspect.isclass(b):
                ma, mb = _methods(a), _methods(b)
                gaps += [f"method:{ns}:{n}.{m}" for m in sorted(ma - mb)]
                for m in sorted(ma & mb) + ["__init__"]:
                    gaps += _param_gaps(f"{ns}:{n}.{m}", getattr(a, m),
                                        getattr(b, m))
            elif callable(a) and callable(b) and not inspect.ismodule(a):
                gaps += _param_gaps(f"{ns}:{n}", a, b)
    return gaps


@pytest.fixture(scope="module")
def gaps():
    return census()


def _excused(gap):
    return [reason for pattern, reason in EXCLUDED
            if fnmatch.fnmatchcase(gap, pattern)]


def test_every_gap_is_excused(gaps):
    unexcused = [g for g in gaps if not _excused(g)]
    assert not unexcused, "the port lacks:\n" + "\n".join(unexcused)


def test_every_exclusion_is_used(gaps):
    """An entry that excuses nothing is stale."""
    stale = [pattern for pattern, reason in EXCLUDED
             if not any(fnmatch.fnmatchcase(g, pattern) for g in gaps)]
    assert not stale, "stale exclusions:\n" + "\n".join(stale)


def test_census_sees_gaps_and_aliases(gaps):
    """The census is not blind: the JAX-only helpers show up as gaps, and
    the names the port has show up as shared, the device-mesh layer's
    among them (names, submodule and parameters)."""
    found = gaps
    assert "method:trainers:BaseTrainer.train_bytes_per_cycle" in found
    assert "param:nets:SignalED.encode:train" in found
    shared = [f"name:utils:{n}" for n in ("Hook", "ase_obj_basic",
                                          "init_dataloader")] + \
        ["method:trainers:BaseTrainer.fit",
         "method:predictors:Locator.rem_edge_coord",
         "param:models:load_seg_model:meta_dict", "name:core:trace"] + \
        [f"name:core:{n}" for n in ("get_mesh", "data_sharding",
                                    "replicate", "ensemble_mesh", "mesh")] + \
        [f"name:core.mesh:{n}" for n in ("resolve_data_mesh",
                                         "resolve_model_mesh", "shard_batch",
                                         "shard_member_stacked")] + \
        ["param:core.mesh:get_mesh:devices",
         "param:core.mesh:resolve_data_mesh:batch_size",
         "name:parallel:shard_batch"]
    assert not set(shared) & set(found)
    jm = _module("atomai_tpu", "core.mesh")
    assert _public_names(jm) <= _public_names(
        _module("atomai_tpu_torch", "core.mesh"))


@pytest.mark.parametrize("ns", ["utils", ""])
def test_all_lists_cover_the_jax_package(ns):
    """``__all__`` of the port's top level and ``utils`` holds every name
    of the JAX package's (a star import gets them all)."""
    jm, tm = _module("atomai_tpu", ns), _module("atomai_tpu_torch", ns)
    missing = sorted(set(jm.__all__) - set(tm.__all__))
    assert not missing, missing


@pytest.mark.parametrize("ns", ["trainers", "models", "predictors"])
def test_every_class_of_the_jax_namespace_is_in_the_census(ns):
    """Each public class of these namespaces is compared method by method
    (a class missing altogether is a name gap)."""
    jm, tm = _module("atomai_tpu", ns), _module("atomai_tpu_torch", ns)
    classes = [n for n in _public_names(jm)
               if inspect.isclass(getattr(jm, n))]
    assert classes and all(inspect.isclass(getattr(tm, n, None))
                           for n in classes)
