"""The registry: everything of a cell is found by name.  ``BENCHMARK.json``
names the cell's configuration and traffic; the configuration's file is the
one its entry names, the traffic is ``traffic/<name>.json``, each metric's
reader is ``metrics/<name>.py`` (or ``metrics/<prefix>.py``, see
:func:`reader`), a traffic's driver is ``drivers/<kind>.py`` and a
configuration's model family is ``families/<family>.py`` (see
:func:`family`).  A new configuration, family, traffic, cell or metric is new
files and new ``BENCHMARK.json`` entries; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# Whole top-level module names that nothing the benchmark runs may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "csm_tpu")


def forbidden_loaded(modules) -> list:
    """The names in ``modules`` whose part before the first dot is one of
    :data:`FORBIDDEN` (``csm_tpu_torch`` is not ``csm_tpu``)."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """``{"name", "config", "traffic", "chips", "config_name", "traffic_name"}``
    of a cell, with its configuration's and traffic's files read."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return {"name": name, "chips": w["chips"], "config_name": w["config"],
            "traffic_name": w["traffic"], "config": _json(os.path.join(root, conf["file"])),
            "traffic": _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))}


def cell_metrics(bench: dict, name: str, section: str) -> list:
    """The entries of ``section`` (``"end_to_end"`` or ``"per_layer"``) that
    the cell reports: those that list it, and those that list no cells."""
    return [m for m in bench[section] if name in m.get("workloads", [name])]


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(conf: dict):
    """The model family module of a configuration: ``families/<family>.py``
    for its ``"family"`` key, ``families/csm.py`` where it has none.  It
    gives the port's config object, the parameter shapes, the tier's
    bundles, the plain reference and the model FLOPs (see
    ``families/csm.py``)."""
    name = conf.get("family", "csm")
    return _load(os.path.join(HERE, "families", name + ".py"), f"benchmark_family_{name}")


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``, or, where there
    is no such file, of ``metrics/<part before the first dot>.py``: one
    reader serves ``idle_share.stream`` and ``idle_share.batch``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", metric.split(".", 1)[0] + ".py")
    return _load(path, f"benchmark_metric_{metric}").read


def driver(kind: str):
    """The driver module of a traffic kind (``drivers/<kind>.py``)."""
    return importlib.import_module(f"benchmark.drivers.{kind}")
