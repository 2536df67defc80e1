"""A small column table read from a CSV with the ``csv`` module, in place of
pandas for the SegICH 2D CSVs, so that the port runs without pandas.

:func:`read_csv` reads a file as ``pd.read_csv(path, index_col=0)`` does:
the first column is the index; a column whose cells are all integers is
int64, all numbers (or empty) float64, else strings, with pandas' default
missing-value markers (``""``, ``"None"``, ``"nan"``, ``"NA"``, ...) read
as NaN. A :class:`Table` answers the few DataFrame operations the port's
callers use, so that they take either: ``len``, ``table["col"]`` (a numpy
column), ``table[bool_array]`` (the rows kept), ``.index`` and
``.to_dict("records")``.
"""

from __future__ import annotations

import csv
from typing import Dict, List

import numpy as np

# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def _column(cells: List[str]) -> np.ndarray:
    """A column's cells as pandas' parser types them."""
    present = [c for c in cells if c not in NA_VALUES]
    if len(present) == len(cells):
        try:
            return np.asarray([int(c) for c in cells], dtype=np.int64)
        except ValueError:
            pass
    try:
        return np.asarray([float(c) if c not in NA_VALUES else np.nan for c in cells],
                          dtype=np.float64)
    except ValueError:
        return np.asarray([c if c not in NA_VALUES else np.nan for c in cells], dtype=object)


class Table:
    """Named numpy columns of equal length and an index."""

    def __init__(self, columns: Dict[str, np.ndarray], index: np.ndarray):
        self.columns = columns
        self.index = np.asarray(index)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.columns[key]
        keep = np.asarray(key)
        if keep.dtype != bool:
            raise TypeError("a Table takes a column name or a boolean row mask")
        return Table({k: v[keep] for k, v in self.columns.items()}, self.index[keep])

    def to_dict(self, orient: str = "records") -> List[dict]:
        if orient != "records":
            raise ValueError("only to_dict('records') is supported")
        cols = {k: v.tolist() for k, v in self.columns.items()}  # python scalars
        return [{k: v[i] for k, v in cols.items()} for i in range(len(self))]


def read_csv(path: str) -> Table:
    """``pd.read_csv(path, index_col=0)`` as a :class:`Table`."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    cols = {name: _column([r[j] for r in body]) for j, name in enumerate(header)}
    index = cols.pop(header[0])
    return Table(cols, index)


def unique_in_order(values) -> np.ndarray:
    """The distinct values in order of first appearance, as pandas'
    ``Series.unique`` gives them."""
    values = np.asarray(values)
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]
