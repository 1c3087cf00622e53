"""PLINDER dataset: the cached CSV of a previous parse (counterpart of
caster_dta_tpu/data/plinder.py).

Behavioral spec: reference dataset/get_plinder.py:6-184. The JAX package
queries the PLINDER index through the optional ``plinder`` package and caches
the canonical table, with its 'split' column, as
``processed_data_plinderdl.csv``. The port reads that cache as records with
the ``csv`` module and pandas' type inference (data/tables.py), so
``affinity_score`` is float and the split labels reach
``train.loop.split_dataset``. A fresh parse needs the ``plinder`` package and
the PLINDER index and systems it downloads, which this repository does not
carry; without the package it raises the JAX package's ImportError.
"""
from __future__ import annotations

import os

from caster_dta_torch.data import tables


def parse_plinder(dataset_dir: str, save_to_csv: bool = True,
                  force_reparse: bool = False, need_structures: bool = False,
                  dedupe_systems: bool = True) -> dict:
    data_csv_path = os.path.join(dataset_dir, "processed_data_plinderdl.csv")
    if os.path.exists(data_csv_path) and not force_reparse:
        return tables.read_csv(data_csv_path)

    try:
        import plinder.core  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "The optional `plinder` package is required to (re)parse PLINDER; "
            "a previously processed CSV can be used without it") from e
    raise NotImplementedError(
        "a fresh PLINDER parse is not ported: it reads the PLINDER index and systems "
        "that the plinder package downloads, which this repository does not carry; "
        f"place a processed CSV at {data_csv_path} (the JAX package writes one)")
