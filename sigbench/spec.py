"""What a cell is made of, read from ``BENCHMARK.json`` and the data files
the names in it lead to:

* ``configs/<config>.json``: the shapes and the kernel settings;
* ``traffic/<traffic>.json``: the entry the window drives, with its
  gradient or not, its keywords, the pool of batches and the two input
  distributions;
* ``entries/<entry>.py``: the entry's call into the port, its control, its
  plain reference, its counts and the configuration settings it follows;
* ``workloads/<cell>.json``: how many calls the comparison samples and the
  limit of each number it compares;
* ``metrics/<metric>.py``: a reader with ``read(run)``, and beside it an
  optional ``metrics/<metric>.json`` of data that the reader takes.

Nothing here, in the harness or in the comparison knows a cell, an entry or
a metric by name: a new cell, configuration, traffic mix, entry or metric is
a new file and, but for an entry, a new entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent


def repo_root() -> Path:
    return HERE.parent


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_benchmark(path: Optional[Path] = None) -> dict:
    return load_json(path or repo_root() / "BENCHMARK.json")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    data: Optional[dict]

    def read(self, run) -> Optional[float]:
        """The metric's value for ``run`` (a :class:`sigbench.harness.Run`),
        or None where its reader finds nothing to read."""
        return load_reader(self.name).read(run, self.data)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list


def load_module(folder: str, name: str):
    """The Python file ``<folder>/<name>.py`` under ``sigbench/``, loaded as
    a module of its own (a name may hold ``.`` and ``-``)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {folder}/{name}.py under {HERE}")
    mod_name = f"sigbench_{folder}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    """The reader of the metric ``name`` (``metrics/<name>.py``)."""
    return load_module("metrics", name)


def _metric(entry: dict) -> Metric:
    data_path = HERE / "metrics" / f"{entry['name']}.json"
    data = load_json(data_path) if data_path.exists() else None
    return Metric(entry["name"], entry["unit"], entry["better"], entry["source"], data)


def _reported_in(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``bench`` (default: the repository's
    ``BENCHMARK.json``) with its files read."""
    bench = bench if bench is not None else load_benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise ValueError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    w = found[0]
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                workload=workload,
                end_to_end=[_metric(m) for m in bench["end_to_end"] if _reported_in(m, name)],
                per_layer=[_metric(m) for m in bench["per_layer"] if _reported_in(m, name)])
