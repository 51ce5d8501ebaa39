"""Finds the benchmark's pieces by name: ``BENCHMARK.json`` at the root,
``cells/<cell>.json``, ``configs/<name>.json``, ``traffic/<name>.json``,
``jobs/<kind>.py`` and ``metrics/<metric>.py``. A piece that a later change adds as a file of its
own is found without an edit here."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


def names(folder: str, suffix: str) -> list:
    """The names of the pieces in ``folder`` (``cells``, ``configs``,
    ``traffic``, ``jobs``, ``metrics``)."""
    d = os.path.join(HERE, folder)
    return sorted(f[:-len(suffix)] for f in os.listdir(d)
                  if f.endswith(suffix) and not f.startswith("_"))


def cell(name: str) -> dict:
    return _json(HERE, "cells", f"{name}.json")


def config(name: str) -> dict:
    return _json(HERE, "configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE, "traffic", f"{name}.json")


def job(kind: str):
    """The job kind's module: ``set_up``, ``job``, ``judge``."""
    return importlib.import_module(f"portbench.jobs.{kind}")


def metric(name: str):
    """The metric's reader: a module with ``read(run) -> float | None``.
    Loaded from its file, since a metric's name may hold dots."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell_name``
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
