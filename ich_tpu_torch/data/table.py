"""A small column table read from a CSV with the ``csv`` module, in place of
pandas for the SegICH 2D CSVs, so that the port runs without pandas.

:func:`read_csv` reads a file as ``pd.read_csv(path, index_col=0)`` does:
the first column is the index; a column whose cells are all integers is
int64, all numbers (or empty) float64, else strings, with pandas' default
missing-value markers (``""``, ``"None"``, ``"nan"``, ``"NA"``, ...) read
as NaN. A :class:`Table` answers the few DataFrame operations the port's
callers use, so that they take either: ``len``, ``table["col"]`` (a numpy
column), ``table[bool_array]`` (the rows kept), ``.index`` and
``.to_dict("records")``. :func:`write_csv` writes rows as ``to_csv``
writes a frame.
"""

from __future__ import annotations

import csv
import re
from typing import Dict, Iterable, List, Sequence

import numpy as np

# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


_POWERS = [float(f"1e{k}") for k in range(309)]
_DECIMAL = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*\Z")


def pandas_float(text: str) -> float:
    """``text`` as pandas' C parser reads a float by default
    (``precise_xstrtod`` in ``pandas/_libs/src/parser/tokenizer.c``): up to
    17 significant digits gathered in a double, then one multiply or divide
    by a power of ten. It is not always correctly rounded: a 17-digit
    ``repr`` may come back one unit in the last place away from ``float``'s
    answer, and pandas writes that value back."""
    m = _DECIMAL.match(text)
    if m is None or not (m.group(2) or m.group(3)):
        return float(text)  # inf, nan and the like; raises on a non-number
    sign, ipart, fpart, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in ipart:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in (fpart or "")[:max(0, 17 - digits)]:
        number = number * 10.0 + (ord(ch) - 48)
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp) if exp else 0
    if exponent > 308:
        return float("inf") if number > 0 else float("-inf")
    if exponent > 0:
        return number * _POWERS[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POWERS[-308 - exponent] / _POWERS[308]
    return number / _POWERS[-exponent]


def parse_column(cells: List[str]) -> np.ndarray:
    """A column's cells as pandas' parser types them."""
    present = [c for c in cells if c not in NA_VALUES]
    if len(present) == len(cells):
        try:
            return np.asarray([int(c) for c in cells], dtype=np.int64)
        except ValueError:
            pass
    try:
        return np.asarray([pandas_float(c) if c not in NA_VALUES else np.nan for c in cells],
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
    cols = {name: parse_column([r[j] for r in body]) for j, name in enumerate(header)}
    index = cols.pop(header[0])
    return Table(cols, index)


def unique_in_order(values) -> np.ndarray:
    """The distinct values in order of first appearance, as pandas'
    ``Series.unique`` gives them."""
    values = np.asarray(values)
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def _cell(v):
    """A cell as pandas' ``to_csv`` writes it: a missing value (None, NaN)
    empty, a number as ``str`` gives it (``repr`` for a float)."""
    if v is None or (isinstance(v, (float, np.floating)) and v != v):
        return ""
    return v


def write_csv(path: str, header: Sequence[str], rows: Iterable[Sequence]) -> None:
    """A header row, then ``rows``, with lines ended by ``\\n``: the bytes
    of pandas' ``to_csv`` for ints, float64s, strings and missing cells. A
    column of ints that pandas holds as floats (one with a missing cell)
    must be passed as floats."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows([_cell(v) for v in r] for r in rows)
