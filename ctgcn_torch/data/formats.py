# coding: utf-8
"""Host-side graph file IO, without pandas.

The artifact contract is ``ctgcn_tpu``'s, so both packages run on the same
data tree:

  <base>/<origin_folder>/<date>.csv      tab-separated edges, header row,
                                         columns from_id, to_id[, weight]
  <base>/nodes_set/nodes.csv             one node name per line (no header)
  <base>/<core_folder>/<date>/<k>.npz    k-core adjacency (scipy)
  <base>/<walk_pair_folder>/<date>.npz   walk co-occurrence matrix
  <base>/<node_freq_folder>/<date>.json  replicated negative-sampling list
  <base>/<embed_folder>/<date>.csv       embedding: header "\\t0\\t1...",
                                         node name as the index column

Node names follow pandas' type inference: a column whose every entry
parses as an integer holds ints, otherwise strings, so names written back
into embedding CSVs read the same as the JAX package's.  Numbers (edge
weights, features) read as the doubles ``pandas.read_csv`` gives
(``pandas_column``), so both packages build the same adjacency from any
token.
"""
from __future__ import annotations

import concurrent.futures
import math
import multiprocessing
import os
import re

import numpy as np
import scipy.sparse as sp

_INT = re.compile(r"[+-]?\d+")
_NUMBER = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?")
#: a column of tokens joined by newlines holds one that is not plain (a
#: character besides digits, point and signs) or longer than 15 characters
_NOT_SHORT = re.compile(r"[^0-9.+\-\n]|[^\n]{16}")
#: pandas' default missing-value tokens
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
       "n/a", "nan", "null"}
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf,
        "infinity": math.inf, "+infinity": math.inf, "-infinity": -math.inf}
_POW10 = [float(f"1e{i}") for i in range(309)]


def pandas_float(token):
    """The double ``pandas.read_csv`` reads from ``token`` by default: its
    C parser's ``precise_xstrtod``, which keeps at most 17 digits (leading
    zeros included), accumulates them in a double and scales by a power of
    ten once.  It differs from ``float()`` by an ulp on many 17-digit
    numbers, so a table read twice reads the same in both packages."""
    if token in _NA:
        return math.nan
    if token.strip().lower() in _INF:
        return _INF[token.strip().lower()]
    m = _NUMBER.fullmatch(token.strip())
    if not m or not (m.group(2) or m.group(3)):
        raise ValueError(token)
    sign, int_part, frac, exp = m.groups()
    number, n_digits, exponent = 0.0, 0, 0
    for ch in int_part:
        if n_digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            n_digits += 1
        else:
            exponent += 1
    for ch in (frac or "")[:max(0, 17 - n_digits)]:
        number = number * 10.0 + (ord(ch) - 48)
        exponent -= 1
    if sign == "-":
        number = -number
    if exp:
        exponent += int(exp)
    if exponent > 308:
        raise ValueError(token)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def exact_float(token):
    """``float(token)`` where it is the double :func:`pandas_float` gives,
    else ``None``.  With at most 15 digits the parser's accumulated integer
    is exact (below 2**53), and with a decimal exponent within +-22 so is
    its power of ten, so its one multiply or divide is correctly rounded:
    the double ``float`` gives."""
    m = _NUMBER.fullmatch(token)
    if m is None:
        return None
    _, int_part, frac, exp = m.groups()
    frac = frac or ""
    if not 0 < len(int_part) + len(frac) <= 15:
        return None
    if not -22 <= int(exp or 0) - len(frac) <= 22:
        return None
    return float(token)


def pandas_column(tokens):
    """A column of number tokens as float64, as ``pandas.read_csv`` reads
    it and ``to_numpy(float64)`` converts it: a column of integers holds
    ints (converted exactly rounded), any other each token as pandas'
    parser reads it.  Tokens of at most 15 plain characters (digits,
    point, sign) are parsed at once by numpy (:func:`exact_float`'s case);
    otherwise each token goes through :func:`exact_float`, and
    :func:`pandas_float` where that gives ``None``.  Raises
    ``ValueError`` for a token that is not a number."""
    tokens = list(tokens)
    if not _NOT_SHORT.search("\n".join(tokens)):
        try:
            return np.array(tokens, dtype=np.float64)
        except ValueError:
            pass        # an empty or malformed token: the slow path
    if all(_INT.fullmatch(t) for t in tokens):
        return np.array([int(t) for t in tokens], dtype=np.float64)
    out = np.empty(len(tokens), np.float64)
    for i, t in enumerate(tokens):
        v = exact_float(t)
        out[i] = pandas_float(t) if v is None else v
    return out


def infer_names(tokens):
    """Node names as pandas types a column of them: ints if every token is
    one, else the strings."""
    try:
        return [int(t) for t in tokens]
    except ValueError:
        return list(tokens)


def read_node_list(node_path):
    with open(node_path) as fp:
        tokens = [line.rstrip("\r\n") for line in fp]
    return infer_names([t for t in tokens if t != ""])


def read_edge_csv(file_path, node2idx, sep="\t"):
    """Read an edge list CSV (header skipped) into (src, dst, weight) arrays
    of *directed* rows as given in the file, self-loops removed; the
    weights as pandas reads them (``pandas_column``)."""
    with open(file_path) as fp:
        lines = fp.read().splitlines()[1:]
    rows = [line.split(sep) for line in lines if line != ""]
    src_names = infer_names([r[0] for r in rows])
    dst_names = infer_names([r[1] for r in rows])
    src = np.fromiter((node2idx[s] for s in src_names), np.int64,
                      count=len(rows))
    dst = np.fromiter((node2idx[d] for d in dst_names), np.int64,
                      count=len(rows))
    if rows and len(rows[0]) >= 3:
        w = pandas_column([r[2] for r in rows])
    else:
        w = np.ones(len(rows), dtype=np.float64)
    keep = src != dst
    return src[keep], dst[keep], w[keep]


def build_adj_from_edges(src, dst, weight, node_num):
    """Symmetric COO adjacency; a duplicate (u, v) takes the *last* weight
    seen in file order (the reference's lil assignment semantics)."""
    both_src = np.concatenate([src, dst])
    both_dst = np.concatenate([dst, src])
    both_w = np.concatenate([weight, weight])
    key = both_src * np.int64(node_num) + both_dst
    # np.unique keeps the first occurrence: on the reversed keys that is
    # the last write
    _, idx = np.unique(key[::-1], return_index=True)
    sel = len(key) - 1 - idx
    return sp.coo_matrix(
        (both_w[sel], (both_src[sel], both_dst[sel])),
        shape=(node_num, node_num))


def get_sp_adj_mat(file_path, full_node_list, sep="\t"):
    """Edge CSV -> symmetric scipy COO over the full node list."""
    node_num = len(full_node_list)
    node2idx = dict(zip(full_node_list, range(node_num)))
    src, dst, w = read_edge_csv(file_path, node2idx, sep=sep)
    return build_adj_from_edges(src, dst, w, node_num)


def sorted_dir(path):
    return sorted(os.listdir(path))


#: rows of an embedding CSV formatted at a time, and the rows of one task
#: of ``write_embedding_csvs``'s worker processes
CHUNK_ROWS = 8192
#: below this many rows in all, ``write_embedding_csvs`` formats in this
#: process: starting the workers costs more than they win
PARALLEL_MIN_ROWS = 65536


def _header(d, sep):
    return sep + sep.join(str(j) for j in range(d)) + "\n"


def format_embedding_rows(arr, names, sep="\t", dtype=np.float32):
    """Rows of an embedding CSV, each ending in a newline: the node name,
    then each value as the shortest string that reads back as the same
    value of ``dtype`` (numpy's ``astype(str)``, e.g. ``1.7640524``,
    ``-0.0``, ``1e-05``), what ``pandas.DataFrame.to_csv`` writes for a
    frame of that dtype (float32: the trainers' exports; float64:
    TIMERS')."""
    cells = np.asarray(arr, dtype=dtype).astype(str)
    return "".join(f"{name}{sep}{sep.join(row)}\n"
                   for name, row in zip(names, cells.tolist()))


def write_embedding_csv(path, arr, names, sep="\t", dtype=np.float32):
    """[N, d] float array -> CSV with a header row of column numbers and
    the node name as the index, byte for byte what the JAX package's
    ``pandas.DataFrame.to_csv`` writes for a frame of ``dtype``
    (:func:`format_embedding_rows`)."""
    with open(path, "w") as fp:
        fp.write(_header(arr.shape[1], sep))
        for s in range(0, arr.shape[0], CHUNK_ROWS):
            fp.write(format_embedding_rows(arr[s:s + CHUNK_ROWS],
                                           names[s:s + CHUNK_ROWS], sep,
                                           dtype))


def write_embedding_csvs(paths, arrays, names, sep="\t"):
    """One embedding CSV per path, the bytes :func:`write_embedding_csv`
    writes.  With ``PARALLEL_MIN_ROWS`` rows or more in all, worker
    processes (``spawn``, up to ``os.cpu_count()``) format the rows,
    ``CHUNK_ROWS`` of one array a task, and this process writes the pieces
    in order: the shortest-repr formatting costs about 0.1 ms a row of 128
    values, so one Enron-sized CSV (87,036 rows) takes seconds alone.
    ``arrays``: numpy [N, d] each, never device tensors."""
    n = sum(a.shape[0] for a in arrays)
    workers = min(os.cpu_count() or 1, -(-n // CHUNK_ROWS))
    if n < PARALLEL_MIN_ROWS or workers < 2:
        for path, arr in zip(paths, arrays):
            write_embedding_csv(path, arr, names, sep=sep)
        return
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
        pieces = [[pool.submit(format_embedding_rows, arr[s:s + CHUNK_ROWS],
                               names[s:s + CHUNK_ROWS], sep)
                   for s in range(0, arr.shape[0], CHUNK_ROWS)]
                  for arr in arrays]
        for path, arr, futures in zip(paths, arrays, pieces):
            with open(path, "w") as fp:
                fp.write(_header(arr.shape[1], sep))
                for fut in futures:
                    fp.write(fut.result())


def read_embedding_csv(path, sep="\t", dtype=np.float32):
    """Inverse of :func:`write_embedding_csv`: (names, [N, d] of ``dtype``).
    The evaluators read float64, as ``pandas.read_csv`` does."""
    with open(path) as fp:
        lines = fp.read().splitlines()[1:]
    rows = [line.split(sep) for line in lines if line != ""]
    names = infer_names([r[0] for r in rows])
    arr = np.array([[float(v) for v in r[1:]] for r in rows], dtype)
    return names, arr


def write_time_csv(path, times):
    """Per-window training seconds under a ``time`` column."""
    with open(path, "w") as fp:
        fp.write("time\n" + "".join(f"{t!r}\n" for t in times))
