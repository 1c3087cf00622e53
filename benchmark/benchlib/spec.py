"""Where the benchmark finds its parts: BENCHMARK.json at the checkout's
root, and under benchmark/ a file of each configuration (configs/), plain
reference (reference/<config>.py), traffic mix (mixes/<mix>.json), limit set
(limits/<cell>.json) and metric reader (metrics/<metric>.py), each found by
the name BENCHMARK.json gives it. Adding a configuration, a mix or a metric
adds files and entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_module(path: str, name: Optional[str] = None) -> ModuleType:
    """Import a Python file by path (names may hold dots and dashes)."""
    name = name or "bench_" + os.path.relpath(path, BENCH_DIR).replace(os.sep, "_") \
        .replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names, loaded."""

    name: str
    entry: dict          # the workload's entry
    config_name: str
    config: dict         # configs/<config>.json
    mix_name: str
    mix: dict            # mixes/<traffic>.json
    limits: dict         # limits/<cell>.json
    end_to_end: list     # the end-to-end metric entries this cell reports
    per_layer: list      # the per-layer metric entries this cell reports

    def reference(self) -> ModuleType:
        """The plain reference (reference/plain.py), after the
        configuration's own file (reference/<config>.py) has named the towers
        it runs and plain.py has been found to hold them."""
        plain = load_module(os.path.join(BENCH_DIR, "reference", "plain.py"),
                            "bench_reference_plain")
        towers = load_module(os.path.join(BENCH_DIR, "reference", self.config_name + ".py")).TOWERS
        kw = self.config["model_kwargs"]
        if (kw["protein_gnn_kwargs"]["base_conv"], kw["molecule_gnn_kwargs"]["base_conv"]) != \
                (towers["protein"], towers["molecule"]) or towers["protein"] not in \
                plain.PROTEIN_TOWERS or towers["molecule"] not in plain.MOLECULE_TOWERS:
            raise ValueError(f"the reference of {self.config_name} names towers {towers}, "
                             f"which the configuration or plain.py does not hold")
        return plain


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json; raises KeyError when
    there is none."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(w['name'] for w in bench['workloads'])})")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf_entry["file"]))
    mix = load_json(os.path.join(BENCH_DIR, "mixes", entry["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
    return Cell(name, entry, entry["config"], config, entry["traffic"], mix, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str) -> ModuleType:
    """metrics/<name>.py: its ``read(ctx)`` returns the value or None."""
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"))
