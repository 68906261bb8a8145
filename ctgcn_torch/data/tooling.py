# coding: utf-8
"""Dataset construction tooling without pandas (port of
``ctgcn_tpu/data/tooling.py``), writing the same bytes:

  * ``build_dynamic_graph``: shuffle a static edge list and write
    ``graph_num`` cumulative snapshots;
  * ``copy_node_labels``: one copy of a static label file a snapshot;
  * ``get_graph_from_nodes`` / ``get_graph_from_edges``: BFS node-count and
    random edge-count subsets (scalability data);
  * ``format_uci``: the raw KONECT UCI ``graph.txt`` to monthly snapshot
    CSVs with 'U'-prefixed names, and the sorted ``nodes.csv``.

The JAX functions read and write with pandas; here a column is typed as
pandas types it (``tables.parse_column``: ints, else floats parsed as its
C parser parses them, else strings; ids read with ``dtype=str`` stay
verbatim), and written as ``DataFrame.to_csv`` writes it
(``tables.format_cell``: floats by ``repr``, NaN as an empty field;
fields quoted as ``csv.QUOTE_MINIMAL`` quotes them).  Random draws come
from the caller's ``RandomState`` (or ``np.random``) in the JAX
functions' order.
"""
from __future__ import annotations

import datetime
import os
from collections import deque

import numpy as np
from scipy.sparse.csgraph import connected_components

from ctgcn_torch.data.formats import get_sp_adj_mat, read_node_list
from ctgcn_torch.evaluation.tables import format_cell, parse_column
from ctgcn_torch.utils import check_and_make_path


def _field(value, sep):
    text = format_cell(value)
    if sep in text or any(ch in text for ch in '"\n\r'):
        return '"' + text.replace('"', '""') + '"'
    return text


def _write_csv(path, columns, header=None, sep="\t"):
    """``DataFrame(columns).to_csv(path, sep=sep, index=False)``, with the
    ``header`` row when given (``header=False`` without)."""
    lines = [] if header is None else [sep.join(_field(h, sep)
                                                for h in header)]
    lines += [sep.join(_field(v, sep) for v in row) for row in zip(*columns)]
    with open(path, "w") as fp:
        fp.write("".join(line + "\n" for line in lines))


def _rows(path, sep, skiprows=0):
    """A delimited file's non-blank lines after the first ``skiprows``,
    split on ``sep`` (``None``: runs of whitespace, pandas'
    ``sep=r"\\s+"``)."""
    with open(path) as fp:
        lines = fp.read().splitlines()[skiprows:]
    return [line.split(sep) for line in lines
            if (line.strip() if sep is None else line) != ""]


def _read_typed(path, sep):
    """``pd.read_csv(path, sep=sep, header=0)``: (header, typed
    columns)."""
    rows = _rows(path, sep)
    header, body = rows[0], rows[1:]
    return header, [parse_column([r[j] for r in body])
                    for j in range(len(header))]


def _as_str(values):
    """``Series.astype(str)``."""
    return [v if isinstance(v, str) else format_cell(v) for v in values]


def _unique(values):
    """``pd.unique``: first appearances in order."""
    return list(dict.fromkeys(values))


def build_dynamic_graph(file_path, output_dir, node_dir, sep="\t",
                        graph_num=10, rng=None):
    rng = rng or np.random
    check_and_make_path(output_dir)
    check_and_make_path(node_dir)
    rows = _rows(file_path, sep)
    tot_num, col_num = len(rows), len(rows[0])
    if col_num not in (2, 3):
        raise ValueError(f"{file_path}: {col_num} columns, not 2 or 3")
    cols = [[r[j] for r in rows] for j in range(col_num)]
    weight = ([1] * tot_num if col_num == 2
              else [float(w) for w in cols[2]])
    idx_arr = rng.permutation(np.arange(tot_num))
    src = ["U" + cols[0][i] for i in idx_arr]
    dst = ["U" + cols[1][i] for i in idx_arr]
    weight = [weight[i] for i in idx_arr]
    _write_csv(os.path.join(node_dir, "nodes.csv"),
               [sorted(_unique(src + dst))])
    base_num = tot_num // graph_num
    if tot_num % graph_num == 0:
        pos = base_num - 1
    else:
        pos = base_num + tot_num % graph_num - 1
    header = ["from_id", "to_id", "weight"]
    for i in range(graph_num):
        # .loc[:end] takes rows 0..end, end included
        end = pos + base_num * i + 1
        _write_csv(os.path.join(output_dir, f"{i}.csv"),
                   [src[:end], dst[:end], weight[:end]], header)


def copy_node_labels(label_path, output_dir, graph_num=10):
    check_and_make_path(output_dir)
    header, columns = _read_typed(label_path, " ")
    j = header.index("node")
    columns[j] = ["U" + v for v in _as_str(columns[j])]
    for i in range(graph_num):
        _write_csv(os.path.join(output_dir, f"{i}.csv"), columns, header)


def get_graph_from_nodes(file_path, node_file, output_node_dir,
                         output_edge_dir, sep="\t",
                         node_num_list=(50, 100, 500, 1000, 5000, 10000),
                         rng=None):
    """BFS subsets of increasing node count from the largest connected
    component, and the whole graph as the last tier."""
    rng = rng or np.random
    check_and_make_path(output_node_dir)
    check_and_make_path(output_edge_dir)
    full_node_list = read_node_list(node_file)
    adj = get_sp_adj_mat(file_path, full_node_list, sep=sep).tocsr()
    _, labels = connected_components(adj, directed=False)
    largest = np.argmax(np.bincount(labels))
    cc_nodes = np.nonzero(labels == largest)[0]

    for i, node_num in enumerate(node_num_list):
        start = int(rng.choice(cc_nodes))
        seen = {start}
        q = deque([start])
        order = [start]
        while q and len(seen) < node_num:
            cur = q.popleft()
            row = adj.indices[adj.indptr[cur]:adj.indptr[cur + 1]]
            for nb in row:
                if nb not in seen:
                    seen.add(int(nb))
                    order.append(int(nb))
                    q.append(int(nb))
                    if len(seen) >= node_num:
                        break
        sub = adj[np.ix_(order, order)].tocoo()
        names = [full_node_list[j] for j in order]
        _write_csv(os.path.join(output_node_dir, f"{i}.csv"), [names])
        _write_csv(os.path.join(output_edge_dir, f"{i}.csv"),
                   [[names[r] for r in sub.row], [names[c] for c in sub.col],
                    list(sub.data)], ["from_id", "to_id", "weight"])
    last = len(node_num_list)
    _write_csv(os.path.join(output_node_dir, f"{last}.csv"),
               [full_node_list])
    header, columns = _read_typed(file_path, sep)
    _write_csv(os.path.join(output_edge_dir, f"{last}.csv"), columns, header)


def get_graph_from_edges(file_path, node_file, output_node_dir,
                         output_edge_dir, sep="\t",
                         edge_num_list=(50, 100, 500, 1000, 5000, 10000,
                                        70000),
                         rng=None):
    """Random edge-count subsets; ``node_file`` is not read, as in the
    JAX function."""
    rng = rng or np.random
    check_and_make_path(output_node_dir)
    check_and_make_path(output_edge_dir)
    header, columns = _read_typed(file_path, sep)
    all_edge_num = len(columns[0])
    src, dst = header.index("from_id"), header.index("to_id")
    for i, edge_num in enumerate(edge_num_list):
        take = min(edge_num, all_edge_num)
        idx = rng.choice(all_edge_num, size=take, replace=False)
        sub = [[col[k] for k in idx] for col in columns]
        _write_csv(os.path.join(output_node_dir, f"{i}.csv"),
                   [_unique(sub[src] + sub[dst])], ["node"])
        _write_csv(os.path.join(output_edge_dir, f"{i}.csv"), sub, header)


def _month(timestamp):
    """``pd.to_datetime(timestamp, unit="s").strftime("%Y-%m")`` (UTC)."""
    return (datetime.datetime(1970, 1, 1)
            + datetime.timedelta(seconds=timestamp)).strftime("%Y-%m")


def format_uci(input_path, format_dir, node_dir):
    """Raw KONECT UCI ``graph.txt`` (two comment lines, then ``from to
    weight timestamp``) -> one CSV a UTC month, in month order, and the
    sorted node names."""
    check_and_make_path(format_dir)
    check_and_make_path(node_dir)
    rows = _rows(input_path, None, skiprows=2)
    src, dst, weight, stamp = (parse_column([r[j] for r in rows])
                               for j in range(4))
    src = ["U" + v for v in _as_str(src)]
    dst = ["U" + v for v in _as_str(dst)]
    _write_csv(os.path.join(node_dir, "nodes.csv"),
               [sorted(_unique(src + dst))])
    months = {}
    for i, ts in enumerate(stamp):
        months.setdefault(_month(ts), []).append(i)
    for month in sorted(months):
        rows_m = months[month]
        _write_csv(os.path.join(format_dir, f"{month}.csv"),
                   [[col[i] for i in rows_m] for col in (src, dst, weight)],
                   ["from_id", "to_id", "weight"])
