"""Records as tables: the pandas operations the acquisition and analysis
layers of the JAX package make, on records (a dict of equal-length column
lists, as data/datasets.py keeps a dataset), with pandas' results.

- ``read_csv`` reads a delimited file as ``pandas.read_csv`` does with its
  defaults: the default NA strings (``""``, ``NA``, ``NULL``, ``nan``,
  ``None``, ``N/A`` and the rest of ``NA_VALUES``) become NaN, a column whose
  other cells all parse as integers is int (float where it has NaN), as
  numbers float, as True/False bool; ``on_bad_lines="skip"`` drops a row with
  more fields than the header, a shorter row is padded with NaN.
  A file whose name ends in ``.gz`` is gunzipped.
- ``write_csv`` writes what ``DataFrame.to_csv(index=False)`` writes.
- ``merge`` (inner and left: the left rows in order, each with its matches in
  the right table's order; cross), ``sort_by`` (stable, NaN last),
  ``drop_duplicates`` (``keep="first"`` or ``False``) and ``dropna`` follow
  the DataFrame methods of the same names. NaN keys match each other, as in
  pandas.
"""
from __future__ import annotations

import csv
import gzip
import math
import re

import numpy as np

NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                       "nan", "null"})
_INT = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT = re.compile(r"^\s*[+-]?((\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|inf|infinity)\s*$",
                    re.IGNORECASE)
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
          "false": False}
_NA_KEY = object()


def is_na(v) -> bool:
    """A missing cell: None or a float NaN (pandas' ``isna`` on a scalar)."""
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def n_rows(records: dict) -> int:
    return len(next(iter(records.values()))) if records else 0


def take(records: dict, rows) -> dict:
    """The rows ``rows`` of ``records``, in that order."""
    rows = list(rows)
    return {c: [v[i] for i in rows] for c, v in records.items()}


def _open_text(path: str):
    """A text stream of ``path``, gunzipped where it ends in ``.gz`` (the
    BioLiP downloads; pandas' ``compression="infer"``)."""
    if path.lower().endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8-sig", newline="")
    return open(path, encoding="utf-8-sig", newline="")


def _column(cells: list) -> list:
    """One column's raw cells (None where NA) typed as pandas infers them."""
    real = [c for c in cells if c is not None]
    nan = float("nan")
    if not real:
        return [nan] * len(cells)
    if all(_INT.match(c) for c in real):
        if len(real) == len(cells):
            return [int(c) for c in cells]
        return [nan if c is None else float(int(c)) for c in cells]
    if all(_FLOAT.match(c) for c in real):
        return [nan if c is None else float(c) for c in cells]
    if all(c in _BOOLS for c in real):
        return [nan if c is None else _BOOLS[c] for c in cells]
    return [nan if c is None else c for c in cells]


def read_csv(path: str, sep: str = ",", header: bool = True,
             on_bad_lines: str = "error") -> dict:
    """``pandas.read_csv(path, sep=sep, header=0 or None,
    on_bad_lines=...)`` with its default NA strings and type inference, as
    records. Without a header the columns are named 0, 1, ... and the first
    row sets their number."""
    with _open_text(path) as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    if header:
        names, rows = rows[0], rows[1:]
    else:
        names = list(range(len(rows[0]))) if rows else []
    width = len(names)
    kept = []
    for i, row in enumerate(rows):
        if len(row) > width:
            if on_bad_lines == "skip":
                continue
            raise ValueError(f"{path}: expected {width} fields in row {i + 1}, saw {len(row)}")
        kept.append(row + [None] * (width - len(row)))
    cols = {}
    for j, name in enumerate(names):
        cols[name] = _column([None if r[j] is None or r[j] in NA_VALUES else r[j]
                              for r in kept])
    return cols


def _format_column(values: list) -> list:
    """A column's cells as ``to_csv`` formats them: a numeric column with a
    float or a NaN as floats (float32 scalars in their own shortest form),
    NaN and None as empty cells, anything else by ``str``."""
    real = [v for v in values if not is_na(v)]
    numeric = all(isinstance(v, (int, float, np.integer, np.floating))
                  and not isinstance(v, (bool, np.bool_)) for v in real)
    if numeric and (len(real) < len(values)
                    or any(isinstance(v, (float, np.floating)) for v in real)):
        as32 = bool(real) and all(isinstance(v, np.float32) for v in real)
        kind = np.float32 if as32 else np.float64
        return ["" if is_na(v) else str(kind(v)) for v in values]
    return ["" if is_na(v) else (v if isinstance(v, str) else str(v)) for v in values]


def write_csv(records: dict, path: str) -> None:
    """``DataFrame(records).to_csv(path, index=False)``."""
    cols = [_format_column(list(v)) for v in records.values()]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([str(c) for c in records])
        w.writerows(zip(*cols))


def _key(v):
    return _NA_KEY if is_na(v) else v


def _keys(records: dict, cols) -> list:
    return list(zip(*(map(_key, records[c]) for c in cols))) if cols else []


def merge(left: dict, right: dict, how: str = "inner", on=None, left_on=None,
          right_on=None) -> dict:
    """``left.merge(right, how=how, on=on, left_on=left_on,
    right_on=right_on)`` for how in inner, left and cross. The columns are
    the left's, then the right's that are not join keys of the same name; a
    column name on both sides that is not a shared key is refused (pandas
    would add suffixes)."""
    if how == "cross":
        clash = set(left) & set(right)
        if clash:
            raise ValueError(f"columns on both sides of a cross merge: {sorted(clash)}")
        nl, nr = n_rows(left), n_rows(right)
        out = {c: [v[i] for i in range(nl) for _ in range(nr)] for c, v in left.items()}
        out.update({c: [v[j] for _ in range(nl) for j in range(nr)] for c, v in right.items()})
        return out
    if on is not None:
        left_on = right_on = [on] if isinstance(on, str) else list(on)
    left_on, right_on = list(left_on), list(right_on)
    shared = {a for a, b in zip(left_on, right_on) if a == b}
    extra = [c for c in right if c not in shared]
    clash = set(extra) & set(left)
    if clash:
        raise ValueError(f"columns on both sides of a merge: {sorted(clash)}")
    index = {}
    for j, k in enumerate(_keys(right, right_on)):
        index.setdefault(k, []).append(j)
    pairs = []
    for i, k in enumerate(_keys(left, left_on)):
        matches = index.get(k)
        if matches:
            pairs.extend((i, j) for j in matches)
        elif how == "left":
            pairs.append((i, None))
        elif how != "inner":
            raise ValueError(f"merge how={how!r} is not supported")
    out = {c: [v[i] for i, _ in pairs] for c, v in left.items()}
    nan = float("nan")
    out.update({c: [nan if j is None else right[c][j] for _, j in pairs] for c in extra})
    return out


def sort_by(records: dict, cols, ascending: bool = True) -> dict:
    """Rows sorted by the columns ``cols``, stably (ties keep their order,
    in either direction), NaN last."""
    cols = [cols] if isinstance(cols, str) else list(cols)
    order = list(range(n_rows(records)))
    for c in reversed(cols):
        vals = records[c]
        real = [i for i in order if not is_na(vals[i])]
        na = [i for i in order if is_na(vals[i])]
        real.sort(key=lambda i: vals[i], reverse=not ascending)
        order = real + na
    return take(records, order)


def drop_duplicates(records: dict, subset, keep="first") -> dict:
    """``drop_duplicates(subset=subset, keep=keep)`` for keep "first" or
    False (every row of a repeated key dropped)."""
    keys = _keys(records, [subset] if isinstance(subset, str) else subset)
    if keep == "first":
        seen, rows = set(), []
        for i, k in enumerate(keys):
            if k not in seen:
                seen.add(k)
                rows.append(i)
    elif keep is False:
        counts = {}
        for k in keys:
            counts[k] = counts.get(k, 0) + 1
        rows = [i for i, k in enumerate(keys) if counts[k] == 1]
    else:
        raise ValueError(f"keep={keep!r} is not supported")
    return take(records, rows)


def dropna(records: dict, subset=None) -> dict:
    """Rows with no missing cell in ``subset`` (every column when None)."""
    cols = list(records) if subset is None else ([subset] if isinstance(subset, str)
                                                 else list(subset))
    return take(records, [i for i in range(n_rows(records))
                          if not any(is_na(records[c][i]) for c in cols)])


def where(records: dict, mask) -> dict:
    """The rows where ``mask`` is true."""
    return take(records, [i for i, m in enumerate(mask) if m])


def rename(records: dict, names: dict) -> dict:
    return {names.get(c, c): v for c, v in records.items()}


def select(records: dict, cols) -> dict:
    return {c: list(records[c]) for c in cols}
