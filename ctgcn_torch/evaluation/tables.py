# coding: utf-8
"""Reading and writing the tables the evaluators exchange, without pandas,
in the bytes ``DataFrame.to_csv(index=False)`` writes, so that either
package reads the other's files:

* split CSVs (``from_id to_id label``, ``node label``), ``file_sep``-separated;
* record CSVs (``date`` then one value column per measure), ``,``-separated;
* the aggregates over repetition folders (avg, max, min per row);
* embedding CSVs, read in float64 (as ``pandas.read_csv`` reads them) and
  reordered to the node list (as ``.loc[full_node_list]`` does).

A column reads as pandas infers it: ints where every cell is an integer,
else floats where every cell is a number (an empty cell is NaN), parsed
to the double pandas' parser gives, else strings.  Floats are written as
Python's ``repr`` (pandas' format), ints in decimal, NaN as an empty
field.
"""
from __future__ import annotations

import math
import os
import re

import numpy as np

from ctgcn_torch.data.formats import (pandas_float, read_embedding_csv,
                                      read_node_list)

_INT = re.compile(r"[+-]?\d+")

def parse_column(tokens):
    """Cells of one column as pandas types them: a list of ints, of floats,
    or of strings."""
    if all(_INT.fullmatch(t) for t in tokens):
        return [int(t) for t in tokens]
    try:
        return [pandas_float(t) for t in tokens]
    except ValueError:
        return list(tokens)


def read_table(path, sep):
    """(header, columns): the header's names and each column's cells, typed
    by :func:`parse_column`; blank lines are skipped."""
    with open(path) as fp:
        lines = [line for line in fp.read().splitlines() if line != ""]
    header = lines[0].split(sep)
    rows = [line.split(sep) for line in lines[1:]]
    columns = [parse_column([r[j] for r in rows]) for j in range(len(header))]
    return header, columns


def read_split(path, sep):
    """A split CSV as one numpy array per column (int64 for ids)."""
    _, columns = read_table(path, sep)
    return [np.asarray(c, dtype=np.int64)
            if all(isinstance(v, int) for v in c) else np.asarray(c)
            for c in columns]


def format_cell(value):
    """One value as ``DataFrame.to_csv`` writes it (floats by ``repr``,
    NaN and None as an empty field)."""
    if isinstance(value, (float, np.floating)):
        return "" if math.isnan(value) else repr(float(value))
    if value is None:
        return ""
    if isinstance(value, np.integer):
        return str(int(value))
    return str(value)


def write_table(path, header, columns, sep):
    """Columns (sequences of equal length) under ``header``."""
    lines = [sep.join(header)]
    lines += [sep.join(format_cell(v) for v in row) for row in zip(*columns)]
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")


def write_record(path, header, rows):
    """A ``,``-separated record CSV of ``rows`` (a header only if none)."""
    write_table(path, header, list(zip(*rows)) or [[]] * len(header), ",")


def read_nodes(base_path, node_file):
    """(full node list, name -> index)."""
    nodes = read_node_list(os.path.abspath(os.path.join(base_path,
                                                        node_file)))
    return nodes, dict(zip(nodes, range(len(nodes))))


def read_embedding(path, full_node_list, sep):
    """The embedding CSV at ``path`` as float64 [N, d], one row per node of
    ``full_node_list`` in its order (``KeyError`` for a node it lacks)."""
    names, arr = read_embedding_csv(path, sep=sep, dtype=np.float64)
    row = dict(zip(names, range(len(names))))
    return arr[[row[name] for name in full_node_list]]


def aggregate_reps(rep_paths, column, names, out_path):
    """Column ``column`` of each repetition's record side by side under
    ``names``, rows matched by position (``pandas.concat(axis=1)``), with
    the first record's dates and each row's avg, max and min over the
    values present."""
    reps = [read_table(p, ",")[1] for p in rep_paths]
    n = max(len(r[0]) for r in reps)
    dates = reps[0][0] + [None] * (n - len(reps[0][0]))
    vals = np.full((n, len(reps)), np.nan)
    for j, cols in enumerate(reps):
        vals[:len(cols[column]), j] = np.asarray(cols[column], np.float64)
    seen = ~np.isnan(vals)
    cnt = seen.sum(1)
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = np.where(seen, vals, 0.0).sum(1) / cnt
    mx = np.where(cnt > 0, np.where(seen, vals, -np.inf).max(
        1, initial=-np.inf), np.nan)
    mn = np.where(cnt > 0, np.where(seen, vals, np.inf).min(
        1, initial=np.inf), np.nan)
    write_table(out_path, ["date"] + names + ["avg", "max", "min"],
                [dates] + [vals[:, j] for j in range(len(reps))]
                + [avg, mx, mn], ",")
