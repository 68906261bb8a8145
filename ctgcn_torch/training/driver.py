# coding: utf-8
"""Embedding-task driver (port of ``ctgcn_tpu/training/driver.py`` for the
CTGCN family: CGCN-C, CGCN-S, CTGCN-C and CTGCN-S, under the learning
types U-neg, U-own, S-node, S-edge, S-link-st and S-link-dy; and for the
model zoo's GCN, TgGCN, GIN, TgGIN, GAT, TgGAT, SAGE, TgSAGE, GCRN,
EvolveGCN, VGRNN and PGNN under U-neg and the four supervised types, and
VGRNN under U-own).

The zoo's window is its adjacency, one ``SparseGraph`` a snapshot, with
the kernels' plans at ``ELL_AUTO_NODES`` nodes and more (``adj_backend``),
normalized as the JAX driver normalizes it: D^-1 (A + I) for GCN, GAT and
GCRN (GAT reads only the structure, so for it that means self-loops);
D^-1/2 (A + I) D^-1/2 for EvolveGCN; the raw
weighted A for TgGCN, TgGAT, SAGE and TgSAGE; A + I for GIN and TgGIN
when ``learn_eps`` is false (every GIN config; TgGIN's configs give no
``learn_eps``, so it is learnt and A stays raw).  SAGE and TgSAGE sample
from the neighbour table of the raw adjacency; GIN's ``pooling_type``
only decides whether that table is built: the JAX driver does not pass it
to GIN, which pools by sum.  SAGE's ``num_sample`` defaults to 5, but
every config's SAGE entry sets it to null, which pools over all
neighbours; TgSAGE's entries do not set it.  GCRN gets only what the JAX
factory passes (so it ignores ``feature_pre``, ``feature_dim`` and
``layer_num``: two convolutions on identity features), EvolveGCN only its
widths and ``model_type`` (so it ignores ``dropout`` and ``bias``).
Dropout (SAGE's sampling, EvolveGCN's rrelu slopes) draws from the
engine's generator, before the U-neg sampler's draws; the export runs
GCN, GIN, GAT and GCRN without dropout, EvolveGCN at rrelu's mean slope,
and SAGE with a generator seeded 0, as the JAX model draws from
``jax.random.key(0)``.

VGRNN reads two graphs a snapshot: its convolutions D^-1/2 (A_bin + 2I)
D^-1/2 over the binary structure (``data["vgrnn_adjs"]``, with the plans
at ``ELL_AUTO_NODES`` nodes and more), its VAE loss the raw weighted A as
the target (``data["adjs"]``, kept sparse, no plans).  It gets only what
the JAX factory passes (widths, ``conv_type``, ``bias``: one GRU layer
whatever ``rnn_layer_num`` says), its identity features are never formed,
and its loss is stateful: the hidden state h crosses an epoch's batches
detached and starts each epoch at zeros, and the export replays that
carry.  The VAE loss ignores the batch, so every batch adds the whole
window's loss.  The export exports ``enc_mean`` and draws its noise from a
generator seeded 0 at every call.  Under a supervised type VGRNN's loss is
the classification loss plus the VAE loss, and its forward is stateful
through ``SupervisedEmbedding``'s ``state_init``.

PGNN reads no adjacency: its window is the dense [T, N, N] proximity
matrices (``data["pgnn_dists"]``, built from the edge lists with the
config's ``approximate`` and moved to the device a snapshot at a time), so
``core_backend`` reports "dense"; the JAX driver also loads a raw
adjacency that PGNN never reads, which the port does not.  The factory
passes what the JAX factory passes (``feature_dim``, by default
``hid_dim``, ``feature_pre``, ``layer_num``, ``dropout``, ``bias``).
Each forward draws a snapshot's anchor sets, then the dropout masks, from
its generator; without one (the validation, test and export forwards)
from a generator seeded 0 made at every call, so PGNN drops out there too,
as the JAX forward without a key draws both from ``jax.random.key(0)``.
Its embedding has one column per anchor set, so the S-node and S-edge
classifiers take ``len(anchor_sizes(N))`` inputs, not ``embed_dim``.

Per window: load the k-core pyramids (on the config's ``core_backend``,
``"auto"`` by default, at its ``matmul_precision``) and the node features
(file features, identity, or degree features for the S-variants and
EvolveGCN), build a fresh model, train it, export the per-timestamp
embedding CSVs (the S-variants export the structure embedding, as the JAX
package does), and record the window's training seconds in
``<base_path>/<method>_time.csv`` after every window.

  * U-neg: the walk tables and the negative-sampling loss; U-own (the
    S-variants): the reconstruction loss.  ``UnsupervisedEmbedding``.
  * S-node / S-edge: the label files, an ``MLPClassifier`` /
    ``EdgeClassifier`` head and the cross-entropy; S-link-st / S-link-dy:
    the window's edges with sampled non-edges, scored by the inner product
    under the binary cross-entropy (S-link-dy predicts snapshot t's edges
    from the embedding of t - 1, so its windows step by ``duration - 1``
    and the last snapshot only gives edges).  The S-variants add the
    reconstruction loss over all rows, VGRNN its VAE loss.  The zoo's
    train step draws its dropout (SAGE its samples, EvolveGCN its slopes,
    VGRNN its noise, PGNN its anchors) from the engine's generator, the
    other forwards as the export does.  ``SupervisedEmbedding``.

The window's numpy ``RandomState(seed)`` draws the degree features and then
the link splits, in the order the JAX package draws them from the global
``np.random``; the classifier's parameters come from a generator seeded
with the window's seed + 1000.

Several parts (``parallel/``, under ``torchrun``), under every learning
type: the config's ``n_devices`` (> 1) splits a window over min(n_devices,
world size) processes.  With ``graph_partition`` the family and GCN /
TgGCN split each snapshot's rows (the halo paths); without it the windows
split over time, the part count clamped to a divisor of T (the JAX
driver's notice when none is left): each part runs its own snapshots
(the family, the per-snapshot zoo methods and GCRN; PGNN builds only its
snapshots' proximity matrices), or, with ``temporal_pipeline``, CTGCN-C
and CTGCN-S run their time RNN GPipe-pipelined over the parts
(``parallel.pipeline``); EvolveGCN and VGRNN, sequential in time, run
on one part, as one device runs them (splitting them gains nothing).
With one part the run is the single-device run.  A rank past the part
count builds the window's draws (to keep its generators in step) and
waits.

The JAX package reads its memory knobs from ``CTGCN_TPU_*`` environment
variables while it traces; here ``core_knobs`` reads the same variables
once per ``gnn_embedding`` call and they reach the family's models as
constructor arguments (the config's ``layer_remat`` and ``remat_policy``
keys first, as the JAX driver sets them).  The driver never sets a
variable.  ``profile_dir`` (else ``CTGCN_TPU_PROFILE_DIR``) traces each
window's steady-state epochs (``training/profiling.py``);
``CTGCN_TPU_PHASE_TIMES`` prints ``[phase]`` lines and
``CTGCN_TPU_MEM_REPORT`` each window's peak device memory.
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np
import scipy.sparse as sp
import torch

from ctgcn_torch.data.formats import read_node_list, write_time_csv
from ctgcn_torch.data.loader import DataLoader
from ctgcn_torch.losses import (classification_loss, negative_sampling_loss,
                                reconstruction_loss, vae_loss)
from ctgcn_torch.nn.core_models import (ACC_MATERIALIZE_BUDGET, ACT_BUDGET,
                                        CGCN, CORE_RNN_BUDGET, CTGCN,
                                        REMAT_POLICIES)
from ctgcn_torch.nn.gat import GAT
from ctgcn_torch.nn.egcn import EvolveGCN
from ctgcn_torch.nn.gcn import GCN, GCRN
from ctgcn_torch.nn.gin import GIN
from ctgcn_torch.nn.heads import EdgeClassifier, MLPClassifier, inner_product
from ctgcn_torch.nn.pgnn import (PGNN, anchor_sizes, draw_anchor_sets,
                                 precompute_dist_data, select_anchor_dists)
from ctgcn_torch.nn.sage import SAGE
from ctgcn_torch.nn.vgrnn import VGRNN
from ctgcn_torch.ops.neighbors import neighbor_table_from_scipy
from ctgcn_torch.ops.rnn import CVJP_BATCH_BUDGET
from ctgcn_torch.parallel import dist as pdist
from ctgcn_torch.parallel.dist import gather_own
from ctgcn_torch.parallel.core_partition import (halo_core_forward,
                                                 partition_pyramid_halo)
from ctgcn_torch.parallel.graph_partition import (halo_gcn_forward,
                                                  partition_graph_halo)
from ctgcn_torch.parallel.mesh import (Sharding, shard_time, time_chunk,
                                       time_sharded_forward)
from ctgcn_torch.parallel.pipeline import ctgcn_pipelined_forward
from ctgcn_torch.training.engine import (SupervisedEmbedding,
                                         UnsupervisedEmbedding)
from ctgcn_torch.training.profiling import PhaseClock, mem_report
from ctgcn_torch.training.splits import (binary_auc, build_label_splits,
                                         build_link_splits, multiclass_auc)
from ctgcn_torch.utils import resolve_device

#: method -> model class
PORTED_METHODS = {"CGCN-C": CGCN, "CGCN-S": CGCN, "CTGCN-C": CTGCN,
                  "CTGCN-S": CTGCN, "GCN": GCN, "TgGCN": GCN, "GIN": GIN,
                  "TgGIN": GIN, "GAT": GAT, "TgGAT": GAT, "SAGE": SAGE,
                  "TgSAGE": SAGE, "GCRN": GCRN, "EvolveGCN": EvolveGCN,
                  "VGRNN": VGRNN, "PGNN": PGNN}
ZOO_METHODS = ("GCN", "TgGCN", "GIN", "TgGIN", "GAT", "TgGAT", "SAGE",
               "TgSAGE", "GCRN", "EvolveGCN", "VGRNN", "PGNN")
S_VARIANTS = ("CGCN-S", "CTGCN-S")
#: the methods with a U-own loss: the S-variants' reconstruction loss,
#: VGRNN's VAE loss
U_OWN_METHODS = S_VARIANTS + ("VGRNN",)
#: the methods whose features are drawn from the degrees when the config
#: names no feature files
DEGREE_FEATURE_METHODS = S_VARIANTS + ("EvolveGCN",)
#: the CTGCN family
FAMILY = ("CGCN-C", "CGCN-S", "CTGCN-C", "CTGCN-S")
#: the methods that ``graph_partition`` splits by rows
PARTITIONED_METHODS = FAMILY + ("GCN", "TgGCN")
#: the methods sequential in time, which run on one part
SEQUENTIAL_METHODS = ("EvolveGCN", "VGRNN")
#: the methods ``temporal_pipeline`` pipelines
PIPELINE_METHODS = ("CTGCN-C", "CTGCN-S")
SUPERVISED_TYPES = ("S-node", "S-edge", "S-link-st", "S-link-dy")
LEARNING_TYPES = ("U-neg", "U-own") + SUPERVISED_TYPES
MATMUL_PRECISIONS = ("highest", "high", "bf16")


def _check_scope(method, args):
    """Raise for what the port does not run (on any number of parts: every
    method and learning type runs over several)."""
    if method not in PORTED_METHODS:
        raise ValueError(
            f"gnn_embedding runs {sorted(PORTED_METHODS)}, not {method!r} "
            "(the non-GNN methods run through nn.dynae.dyngem_embedding and "
            "nn.timers.timers_embedding)")
    lt = args["learning_type"]
    if lt not in LEARNING_TYPES:
        raise ValueError(f"learning_type {lt!r}, not one of "
                         f"{LEARNING_TYPES}")
    if lt == "U-own" and method not in U_OWN_METHODS:
        raise ValueError(f"U-own is defined for the S-variants and VGRNN, "
                         f"not {method}")
    prec = args.get("matmul_precision", "highest")
    if prec not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision {prec!r}, not one of "
                         f"{MATMUL_PRECISIONS}")


def core_knobs(args, env=None):
    """The family's memory knobs as ``CTGCN``/``CGCN`` take them: the
    config's ``layer_remat`` and ``remat_policy`` (a false or absent key
    leaves the variable's setting), else the JAX package's variables
    (``CTGCN_TPU_LAYER_REMAT``, ``CTGCN_TPU_REMAT_POLICY``,
    ``CTGCN_TPU_ACT_BUDGET``, ``CTGCN_TPU_CVJP_BATCH_BUDGET``,
    ``CTGCN_TPU_CORE_RNN_BUDGET``, ``CTGCN_TPU_CORE_VJP``,
    ``CTGCN_TPU_ACC_MATERIALIZE_BUDGET``, ``CTGCN_TPU_BATCH_WINDOW_TAIL``,
    read from ``env``, by default ``os.environ``), else their defaults.
    The zoo reads none of them."""
    env = os.environ if env is None else env
    policy = args.get("remat_policy") or env.get("CTGCN_TPU_REMAT_POLICY",
                                                 "full")
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r}, not one of "
                         f"{REMAT_POLICIES}")

    def num(name, default):
        return int(env.get(name, default))

    return dict(
        act_budget=num("CTGCN_TPU_ACT_BUDGET", ACT_BUDGET),
        remat_policy=policy,
        layer_remat=(bool(args.get("layer_remat"))
                     or env.get("CTGCN_TPU_LAYER_REMAT") == "1"),
        cvjp_batch_budget=num("CTGCN_TPU_CVJP_BATCH_BUDGET",
                              CVJP_BATCH_BUDGET),
        core_rnn_budget=num("CTGCN_TPU_CORE_RNN_BUDGET", CORE_RNN_BUDGET),
        core_vjp=env.get("CTGCN_TPU_CORE_VJP", "1") == "1",
        acc_materialize_budget=num("CTGCN_TPU_ACC_MATERIALIZE_BUDGET",
                                   ACC_MATERIALIZE_BUDGET),
        batch_window_tail=env.get("CTGCN_TPU_BATCH_WINDOW_TAIL", "0") == "1")


def get_data_loader(args):
    """DataLoader over the config's node list; records the absolute
    artifact paths and ``node_num`` in ``args``."""
    base_path = args["base_path"]
    origin_folder = args["origin_folder"]
    core_folder = args.get("core_folder")
    nfeature_folder = args.get("nfeature_folder")
    node_list = read_node_list(
        os.path.abspath(os.path.join(base_path, args["node_file"])))

    def absolute(folder):
        return (os.path.abspath(os.path.join(base_path, folder)) if folder
                else None)

    origin_base_path = absolute(origin_folder)
    core_base_path = absolute(core_folder)
    max_time_num = len(os.listdir(origin_base_path or core_base_path))
    if max_time_num == 0:
        raise ValueError(f"no snapshots under {origin_base_path}")
    args["origin_base_path"] = origin_base_path
    args["core_base_path"] = core_base_path
    args["nfeature_path"] = absolute(nfeature_folder)
    args["node_num"] = len(node_list)
    return DataLoader(node_list, max_time_num)


def _zoo_adjacency(method, idx, time_length, data_loader, args):
    """The zoo's window: its adjacency as the JAX driver normalizes it per
    method, and the neighbor table for SAGE and for GIN when its config
    asks for max pooling."""
    # of the ported methods the JAX driver normalizes GCN, GAT and GCRN to
    # D^-1 (A + I) and EvolveGCN to D^-1/2 (A + I) D^-1/2; GIN pools a
    # node with its neighbours (+I) unless it learns eps
    row_norm = method in ("GCN", "GAT", "GCRN")
    norm = row_norm or method == "EvolveGCN"
    is_gin = method in ("GIN", "TgGIN")
    sep = args.get("file_sep", "\t")
    adjs = data_loader.get_date_adj_list(
        args["origin_base_path"], idx, time_length, sep=sep, normalize=norm,
        row_norm=row_norm,
        add_eye=norm or (is_gin and not args.get("learn_eps", True)),
        adj_backend=args.get("adj_backend", "auto"))
    neighbor_data = None
    if PORTED_METHODS[method] is SAGE or (
            is_gin and args.get("pooling_type", "sum") == "max"):
        neighbor_data = neighbor_table_from_scipy(
            data_loader.get_scipy_adj_list(args["origin_base_path"], idx,
                                           time_length, sep=sep))
    return adjs, neighbor_data


def _vgrnn_norm(mat):
    """D^-1/2 (A_bin + 2I) D^-1/2 of a scipy matrix's binary structure, in
    float64 (the JAX driver's VGRNN branch)."""
    b = (mat.tocsr() != 0).astype(np.float64)
    m = b + 2.0 * sp.eye(b.shape[0])
    d = np.asarray(m.sum(axis=1)).ravel()
    dinv = sp.diags(np.where(d > 0, d ** -0.5, 0.0))
    return (dinv @ m @ dinv).tocoo()


def _vgrnn_adjacency(idx, time_length, data_loader, args):
    """VGRNN's window: (the raw weighted A, the VAE loss's target, without
    plans; D^-1/2 (A_bin + 2I) D^-1/2, the convolutions' graph, with the
    plans under ``adj_backend``), one graph a snapshot each."""
    mats = data_loader.get_scipy_adj_list(args["origin_base_path"], idx,
                                          time_length,
                                          sep=args.get("file_sep", "\t"))
    return (data_loader.graphs_from_scipy(mats, adj_backend="segment"),
            data_loader.graphs_from_scipy(
                [_vgrnn_norm(m) for m in mats],
                adj_backend=args.get("adj_backend", "auto")))


def _halo_adjacency(method, idx, time_length, data_loader, args, parts):
    """This part's ``HaloPart`` of each snapshot: the family's delta
    pyramid slots (K the window's), or GCN's D^-1 (A + I) / TgGCN's raw A,
    partitioned over ``parts.count`` on the host."""
    n = data_loader.node_num
    if method in FAMILY:
        per_snap = data_loader.get_core_scipy_list(
            args["core_base_path"], idx, time_length,
            max_core=args.get("max_core", -1))
        num_slots = max(len(m) for m in per_snap)
        plans = [partition_pyramid_halo(mats, n, parts.count,
                                        num_slots=num_slots)
                 for mats in per_snap]
    else:
        norm = method == "GCN"
        mats = data_loader.get_scipy_adj_list(
            args["origin_base_path"], idx, time_length,
            sep=args.get("file_sep", "\t"), normalize=norm, row_norm=norm,
            add_eye=norm)
        plans = [partition_graph_halo(m, parts.count) for m in mats]
    return tuple(p.part(parts.index) for p in plans)


def get_input_data(method, idx, time_length, data_loader: DataLoader, args,
                   rng=None, device=None, layout=None):
    """(input_dim, data) for one window on the host: ``data["adjs"]`` is
    the stacked ``CorePyramid`` of the family, or the zoo's ``SparseGraph``
    per snapshot (with ``data["neighbor_data"]``; VGRNN's target, and its
    convolutions' graphs in ``data["vgrnn_adjs"]``), and ``data["xs"]``
    the features.  PGNN's proximity matrices (``data["pgnn_dists"]``, no
    ``data["adjs"]``) are built on ``device`` (the CPU by default).

    ``matmul_precision`` sets the family's bank: "bf16" a bf16 dense bank
    / bf16 blocks / bf16 ELL gathers, "high" 3xTF32 GEMMs on an f32 bank.
    xs is None (identity features, never materialized), the files under
    ``nfeature_folder``, or, for CGCN-S, CTGCN-S and EvolveGCN without
    them, degree features drawn from ``rng`` (a numpy ``RandomState``).

    ``layout`` (``make_layout``'s): "graph" gives this part's halo plans
    (``data["halo_adjs"]``, no ``data["adjs"]``); "time" and "pipeline"
    this part's timesteps of the pyramids, of the zoo's graphs and
    neighbour tables (GAT also gets every snapshot's stored edge count,
    ``data["edge_counts"]``: its dropout draws one value an edge), of
    PGNN's proximity matrices and of xs; a rank without a part gets only
    xs (its draws)."""
    kind, parts = layout if layout is not None else (None, None)
    if parts is not None and parts.index is None:
        kind = "idle"
    own = (range(*time_chunk(parts, time_length))
           if kind in ("time", "pipeline") else range(time_length))
    data = {}
    if kind == "idle":
        pass
    elif kind == "graph":
        data["halo_adjs"] = _halo_adjacency(method, idx, time_length,
                                            data_loader, args, parts)
    elif method == "PGNN":
        edge_list = data_loader.get_edge_list(
            args["origin_base_path"], idx, time_length,
            sep=args.get("file_sep", "\t"))
        data["pgnn_dists"] = precompute_dist_data(
            [edge_list[t] for t in own], data_loader.node_num,
            approximate=args.get("approximate", -1), device=device)
    elif method == "VGRNN":
        data["adjs"], data["vgrnn_adjs"] = _vgrnn_adjacency(
            idx, time_length, data_loader, args)
    elif method in ZOO_METHODS:
        adjs, nbrs = _zoo_adjacency(method, idx, time_length, data_loader,
                                    args)
        if PORTED_METHODS[method] is GAT and kind == "time":
            data["edge_counts"] = torch.tensor([g.rows.numel()
                                                for g in adjs])
        data["adjs"] = tuple(adjs[t] for t in own)
        data["neighbor_data"] = (None if nbrs is None
                                 else tuple(a[own.start:own.stop]
                                            for a in nbrs))
    else:
        prec = args.get("matmul_precision", "highest")
        data["adjs"] = data_loader.get_core_adj_list(
            args["core_base_path"], idx, time_length,
            max_core=args.get("max_core", -1),
            core_backend=args.get("core_backend", "auto"),
            dense_budget_bytes=args.get("dense_budget_bytes", 4 << 30),
            dense_dtype=torch.bfloat16 if prec == "bf16" else None,
            dense_prec="high" if prec == "high" else "highest",
            keep=own)
    sep = args.get("file_sep", "\t")
    if method in DEGREE_FEATURE_METHODS and args.get("nfeature_path") is None:
        data["xs"], input_dim = data_loader.get_degree_feature_list(
            args["origin_base_path"], idx, time_length, sep=sep,
            init_type=args["init_type"], std=args.get("std", 1e-4), rng=rng)
    else:
        data["xs"], input_dim = data_loader.get_feature_list(
            args.get("nfeature_path"), idx, time_length, sep=sep)
    if data["xs"] is not None:
        data["xs"] = data["xs"][own.start:own.stop]
    return input_dim, data


def _make_product_mesh(args, time_length, world_size):
    """The number of time parts for the config's ``n_devices``: min(n,
    world size) clamped to the largest divisor of the window's T (UCI's
    T = 7 on 8 GPUs uses 7); 1 (single-device) when n is absent or 1, or
    when no divisor above 1 is left, with the JAX driver's notice."""
    n = args.get("n_devices", 0)
    if not n or n <= 1:
        return 1
    n = min(n, world_size)
    while n > 1 and time_length % n != 0:
        n -= 1
    if n <= 1:
        print(f"n_devices: no divisor of T={time_length} in range; "
              f"running single-device")
    return max(n, 1)


def make_layout(method, args, time_length, groups=None):
    """(kind, ``Parts``) of a window: ("graph", P) for ``graph_partition``
    on the family and GCN / TgGCN (P = min(n_devices, world size)); over
    ``_make_product_mesh``'s P time parts, ("pipeline", P) for CTGCN-C /
    CTGCN-S under ``temporal_pipeline`` and ("time", P) for the others;
    (None, 1 part) for the single-device run and for the methods
    sequential in time, which no part can split (the other ranks hold no
    part: they draw what rank 0 draws and wait).  Every rank calls this
    (it may make a subgroup); ``groups`` caches them across windows."""
    world = pdist.world_size()
    n = args.get("n_devices", 0) or 0
    if (args.get("graph_partition", False) and n > 1
            and method in PARTITIONED_METHODS):
        return "graph", pdist.make_parts(min(n, world), groups)
    count = (1 if method in SEQUENTIAL_METHODS
             else _make_product_mesh(args, time_length, world))
    kind = None
    if count > 1:
        kind = ("pipeline" if (args.get("temporal_pipeline", False)
                               and method in PIPELINE_METHODS) else "time")
    return kind, pdist.make_parts(count, groups)


def _sharding(layout, time_length):
    """The engines' ``Sharding`` of a window's layout (None for one
    part)."""
    kind, parts = layout if layout is not None else (None, None)
    if kind is None:
        return None
    return Sharding(parts, "time" if kind == "pipeline" else kind,
                    time_length=time_length, pipeline=kind == "pipeline")


def _data_to(data, device):
    """The window's inputs on ``device``."""
    out = {}
    for key, val in data.items():
        if isinstance(val, (tuple, list)):
            out[key] = tuple(v.to(device) for v in val)
        else:
            out[key] = None if val is None else val.to(device)
    return out


def _adj_backend(data):
    """The window's backend: the pyramid's core backend, the "ell" /
    "segment" of the graphs the zoo's model reads, or "dense" (PGNN's
    proximity matrices)."""
    if "pgnn_dists" in data:
        return "dense"
    if "halo_adjs" in data:
        return "halo"
    adjs = data.get("vgrnn_adjs", data["adjs"])
    return adjs[0].backend if isinstance(adjs, tuple) else adjs.backend


def get_gnn_model(method, time_length, args, generator, knobs=None):
    """A fresh model of ``method`` for one window, parameters drawn from
    ``generator``; the family's take ``knobs`` (``core_knobs``'s, read
    from the environment when None)."""
    common = dict(bias=args.get("bias", True), generator=generator)
    dims = (args["input_dim"], args["hid_dim"], args["embed_dim"])
    if PORTED_METHODS[method] is GCN:
        return GCN(*dims, dropout=args.get("dropout", 0.0), **common)
    if PORTED_METHODS[method] is GIN:
        # the JAX driver passes no pooling_type: the model pools by sum
        return GIN(*dims, layer_num=args.get("layer_num", 2),
                   mlp_layer_num=args.get("mlp_layer_num", 2),
                   learn_eps=args.get("learn_eps", True),
                   dropout=args.get("dropout", 0.0), **common)
    if PORTED_METHODS[method] is GAT:
        return GAT(*dims, dropout=args.get("dropout", 0.0),
                   alpha=args.get("alpha", 0.2),
                   head_num=args.get("head_num", 1),
                   learning_type=args.get("learning_type", "U-neg"),
                   generator=generator)
    if PORTED_METHODS[method] is SAGE:
        # a config's "num_sample": null stays None: all neighbours
        return SAGE(*dims, num_sample=args.get("num_sample", 5),
                    pooling_type=args.get("pooling_type", "sum"),
                    dropout=args.get("dropout", 0.0), **common)
    # the JAX factory passes GCRN and EvolveGCN only these arguments
    if PORTED_METHODS[method] is GCRN:
        return GCRN(*dims, duration=time_length,
                    dropout=args.get("dropout", 0.0),
                    rnn_type=args.get("rnn_type", "GRU"), **common)
    if PORTED_METHODS[method] is EvolveGCN:
        return EvolveGCN(*dims, egcn_type=args.get("model_type", "EGCNH"),
                         generator=generator)
    if PORTED_METHODS[method] is VGRNN:
        return VGRNN(*dims, conv_type=args.get("conv_type", "GCN"),
                     **common)
    if PORTED_METHODS[method] is PGNN:
        return PGNN(dims[0], args.get("feature_dim", dims[1]), *dims[1:],
                    feature_pre=args.get("feature_pre", True),
                    layer_num=args.get("layer_num", 2),
                    dropout=args.get("dropout", 0.0), **common)
    kw = dict(trans_num=args["trans_layer_num"],
              diffusion_num=args["diffusion_layer_num"],
              rnn_type=args.get("rnn_type", "GRU"),
              model_type=args["model_type"],
              trans_activate_type=args.get("trans_activate_type", "L"),
              **(core_knobs(args) if knobs is None else knobs), **common)
    if PORTED_METHODS[method] is CTGCN:
        kw["duration"] = time_length
    return PORTED_METHODS[method](*dims, **kw)


def _family_forward(model, data, generator=None):
    """CGCN / CTGCN: no dropout, so nothing is drawn."""
    del generator
    return model(data["xs"], data["adjs"])


def _adj_forward(model, data, generator=None, **window):
    """GCN, GCRN and EvolveGCN: the model over the window's features and
    adjacency; ``window`` (a time part's ``own`` snapshots and the
    window's ``time_length``, GCRN's ``gather``) passes to the model."""
    return model(data["xs"], data["adjs"], generator=generator, **window)


def _gat_forward(model, data, generator=None, **window):
    """GAT as ``_adj_forward``; a time part also passes every snapshot's
    stored edge count (the edge dropout of another part's snapshot)."""
    if window:
        window["edge_counts"] = data["edge_counts"]
    return _adj_forward(model, data, generator, **window)


def _gin_forward(model, data, generator=None, **window):
    return model(data["xs"], data["adjs"], data["neighbor_data"],
                 generator=generator, **window)


def _sage_forward(model, data, generator=None, **window):
    return model(data["xs"], data["neighbor_data"], generator=generator,
                 **window)


def _vgrnn_forward(model, data, generator=None, hx=None, noise=None):
    """VGRNN over its convolutions' graphs from the hidden state ``hx``
    (zeros when None): (enc_mean, h, (enc_mean, enc_std, prior_mean,
    prior_std, z))."""
    return model(data["xs"], data["vgrnn_adjs"], hx=hx, generator=generator,
                 noise=noise)


def _pgnn_forward(model, data, generator=None, anchor_sets=None, own=None,
                  time_length=None):
    """PGNN over the window's proximity matrices: each snapshot's anchor
    sets drawn from ``generator`` (or given: ``anchor_sets[t]``, one index
    tensor a set), then the model with its dropout from the same
    generator; without one, both from a generator seeded 0 made for the
    call.  A time part holds the matrices of its ``own`` snapshots of
    ``time_length``: it draws every snapshot's anchor sets and reduces its
    own."""
    dists = data["pgnn_dists"]
    if generator is None:
        generator = torch.Generator(device=dists.device).manual_seed(0)
    n = dists.shape[1]
    sizes = anchor_sizes(n)
    time_length = time_length or dists.shape[0]
    own = range(time_length) if own is None else own
    reduced = []
    for t in range(time_length):
        sets = (draw_anchor_sets(n, sizes, generator, dists.device)
                if anchor_sets is None else anchor_sets[t])
        if t in own:
            reduced.append(select_anchor_dists(dists[t - own.start], sizes,
                                               anchor_sets=sets))
    dm, da = zip(*reduced)
    return model(data["xs"], torch.stack(dm), torch.stack(da),
                 generator=generator, own=own, time_length=time_length)


def make_forward(method, layout=None, node_num=None, time_length=None):
    """(model, data, generator=None) -> embeddings of ``method`` (VGRNN's
    forward also takes ``hx`` and returns more, ``_vgrnn_forward``); the
    zoo draws its dropout masks (SAGE its samples, EvolveGCN its rrelu
    slopes, VGRNN its noise, PGNN its anchors) from ``generator``: without
    one GCN, GIN, GAT and GCRN drop nothing, EvolveGCN takes rrelu's mean
    slope, and SAGE, VGRNN and PGNN draw from a generator seeded 0.

    ``layout`` "graph" gives the halo forwards over ``data["halo_adjs"]``
    (``node_num`` nodes), "time" the time-sharded forwards of a window of
    ``time_length`` snapshots (the zoo's models run their part's own
    snapshots, ``nn.gcn.per_snapshot``, and their outputs are gathered
    over T: GCRN's before its time RNN), "pipeline" the pipelined CTGCN
    forward."""
    kind, parts = layout if layout is not None else (None, None)
    if kind == "graph" and method in FAMILY:
        def fwd(model, data, generator=None):
            return halo_core_forward(model, data["xs"], data["halo_adjs"],
                                     node_num, parts)
        return fwd
    if kind == "graph":
        def fwd(model, data, generator=None):
            return halo_gcn_forward(model, data["xs"], data["halo_adjs"],
                                    node_num, parts, generator=generator)
        return fwd
    if kind == "pipeline":
        def fwd(model, data, generator=None):
            return ctgcn_pipelined_forward(model, data["xs"], data["adjs"],
                                           parts)
        return fwd
    if kind == "time" and method in FAMILY:
        def fwd(model, data, generator=None):
            return time_sharded_forward(model, data["xs"], data["adjs"],
                                        parts)
        return fwd
    cls = PORTED_METHODS[method]
    base = {GCN: _adj_forward, GAT: _gat_forward, GCRN: _adj_forward,
            EvolveGCN: _adj_forward, GIN: _gin_forward, SAGE: _sage_forward,
            VGRNN: _vgrnn_forward, PGNN: _pgnn_forward}.get(cls,
                                                             _family_forward)
    if kind != "time":
        return base
    window = dict(own=range(*time_chunk(parts, time_length)),
                  time_length=time_length)
    gather = functools.partial(gather_own, parts=parts)
    if cls is GCRN:
        return functools.partial(base, gather=gather, **window)

    def fwd(model, data, generator=None, **given):
        return gather(base(model, data, generator, **window, **given))
    return fwd


@functools.lru_cache(maxsize=None)
def _uneg_loss_fn(fwd, take_first, neg_num, Q):
    """U-neg on the node embedding (``res[0]`` of an S-variant); the
    forward's dropout draws from the generator first, then the sampler."""
    def loss_fn(model, data, b_idx, b_mask, generator):
        res = fwd(model, data, generator)
        return negative_sampling_loss(res[0] if take_first else res, b_idx,
                                      b_mask, data["walk"], generator,
                                      neg_num=neg_num, Q=Q)

    return loss_fn


def _vgrnn_state_init(model, data):
    """The hidden state of an epoch's first batch: zeros [L, N, hid]."""
    return model.phi_x.weight.new_zeros(
        model.rnn_layer_num, data["vgrnn_adjs"][0].n_rows, model.hidden_dim)


def _vae_loss_fn_stateful(fwd, eps):
    """VGRNN's U-own loss from the carried state hx: (the VAE loss of the
    whole window, which ignores the batch, against the raw A; the new
    h)."""
    def loss_fn(model, data, b_idx, b_mask, generator, hx):
        del b_idx, b_mask
        _, h, (em, es, pm, ps, z) = fwd(model, data, generator, hx=hx)
        return vae_loss(em, es, pm, ps, z, data["adjs"], eps=eps), h

    return loss_fn


def _uneg_loss_fn_stateful(fwd, neg_num, Q):
    """VGRNN's U-neg loss from the carried state hx: (the negative-sampling
    loss of enc_mean, the noise drawn before the sampler's draws; the new
    h)."""
    def loss_fn(model, data, b_idx, b_mask, generator, hx):
        embs, h, _ = fwd(model, data, generator, hx=hx)
        return negative_sampling_loss(embs, b_idx, b_mask, data["walk"],
                                      generator, neg_num=neg_num, Q=Q), h

    return loss_fn


def _embed_fn_stateful(fwd):
    """(model, data, hx) -> (enc_mean, new h), without a generator: the
    export's replay of the batch carry."""
    def embed(model, data, hx):
        embs, h, _ = fwd(model, data, hx=hx)
        return embs, h

    return embed


def _recon_loss_fn(fwd):
    """U-own: the S-variants' reconstruction loss on the batch rows."""
    def loss_fn(model, data, b_idx, b_mask, generator):
        embs, trans = fwd(model, data, generator)
        return reconstruction_loss(embs, trans, b_idx, b_mask)

    return loss_fn


def _embed_trans(fwd):
    """The exported embedding of an S-variant: its structure embedding (the
    MLP output), as the JAX driver exports it."""
    def embed(model, data):
        return fwd(model, data)[1]

    return embed


def _head(learning_type):
    """(classifier, embeddings, items) -> the logits of ``learning_type``:
    the classifier of the items' rows or edges, or the inner product of the
    edges' ends (S-link-dy on the embeddings before the last snapshot)."""
    drop_last = learning_type == "S-link-dy"

    def head(classifier, embs, items):
        if learning_type == "S-node":
            return classifier(embs, items)
        if learning_type == "S-edge":
            return classifier(embs, items.transpose(1, 2))
        return inner_product(embs[:-1] if drop_last else embs,
                             items.transpose(1, 2))

    return head


def _supervised_forward(fwd, learning_type, s_variant):
    """forward_fn of ``SupervisedEmbedding``: the window's embeddings from
    ``fwd`` (the node embedding of an S-variant), then the head's logits
    for the split's items; aux is (embeddings, structure embedding or
    None)."""
    head = _head(learning_type)

    def forward_fn(model, classifier, data, items, generator=None):
        res = fwd(model, data, generator)
        embs, trans = res if s_variant else (res, None)
        return head(classifier, embs, items), (embs, trans)

    return forward_fn


def _vgrnn_supervised_forward(fwd, learning_type):
    """VGRNN's stateful forward_fn of ``SupervisedEmbedding``: from the
    hidden state hx, (logits of enc_mean, aux (enc_mean, enc_std,
    prior_mean, prior_std, z, the raw targets), the new h, enc_mean)."""
    head = _head(learning_type)

    def forward_fn(model, classifier, data, items, generator, hx):
        embs, h, loss_data = fwd(model, data, generator, hx=hx)
        return (head(classifier, embs, items), loss_data + (data["adjs"],),
                h, embs)

    return forward_fn


def _supervised_loss(method, eps=1e-10):
    """loss_fn of ``SupervisedEmbedding``: the classification loss, plus
    the reconstruction loss over all rows for an S-variant, plus the VAE
    loss for VGRNN."""
    def loss_fn(preds, labels, mask, aux):
        loss, acc = classification_loss(preds, labels, mask=mask)
        if method in S_VARIANTS:
            loss = loss + reconstruction_loss(*aux)
        elif method == "VGRNN":
            loss = loss + vae_loss(*aux, eps=eps)
        return loss, acc

    return loss_fn


def _supervised_parts(method, args, data_loader, idx, time_length, rng,
                      seed, layout=None):
    """(classifier, forward_fn, loss_fn, auc_fn, host splits) of the
    config's supervised learning type for one window; the classifier's
    parameters come from a generator seeded ``seed + 1000``, the link
    splits from ``rng``.  PGNN's classifier takes one input per anchor
    set."""
    lt = args["learning_type"]
    base_path = args["base_path"]
    sep = args.get("file_sep", "\t")
    ratios = (args["train_ratio"], args["val_ratio"], args["test_ratio"])
    classifier = None
    if lt in ("S-node", "S-edge"):
        node = lt == "S-node"
        folder = args["nlabel_folder" if node else "elabel_folder"]
        get = (data_loader.get_node_label_list if node
               else data_loader.get_edge_label_list)
        labels, n_class = get(os.path.abspath(os.path.join(base_path,
                                                           folder)),
                              idx, time_length, sep=sep)
        head = MLPClassifier if node else EdgeClassifier
        embed_dim = (len(anchor_sizes(data_loader.node_num))
                     if method == "PGNN" else args["embed_dim"])
        classifier = head(embed_dim, args.get("cls_hid_dim", embed_dim),
                          n_class, args.get("cls_layer_num", 1),
                          bias=args.get("cls_bias", True),
                          activate_type=args.get("cls_activate_type", "N"),
                          generator=torch.Generator().manual_seed(seed
                                                                  + 1000))
        splits = build_label_splits(labels, *ratios, is_edge=not node)
        auc_fn = functools.partial(multiclass_auc, n_class=n_class)
    else:
        edge_list = data_loader.get_edge_list(args["origin_base_path"], idx,
                                              time_length, sep=sep)
        splits = build_link_splits(edge_list, data_loader.node_num, *ratios,
                                   lt, rng)
        auc_fn = binary_auc
    fwd = make_forward(method, layout, data_loader.node_num, time_length)
    forward_fn = (_vgrnn_supervised_forward(fwd, lt) if method == "VGRNN"
                  else _supervised_forward(fwd, lt, method in S_VARIANTS))
    return (classifier, forward_fn,
            _supervised_loss(method, args.get("eps", 1e-10)), auc_fn, splits)


def build_trainer(method, args, data_loader, idx, time_length, device,
                  generator, rng=None, seed=0, layout=None, knobs=None):
    """The window's inputs on ``device``, a fresh model drawn from
    ``generator``, and the trainer of the config's learning type over
    them.  ``rng`` (numpy ``RandomState``, by default one seeded with
    ``seed``) draws the degree features, then the link splits; ``seed`` is
    the window's (it seeds the classifier).  A supervised trainer carries
    the seconds its splits took to build as ``split_seconds``.

    ``layout`` (``make_layout``'s) splits the window over parts; a rank
    without a part draws what the others draw and gets None.  ``knobs``:
    the family's memory knobs (``core_knobs``)."""
    base_path = args["base_path"]
    rng = rng if rng is not None else np.random.RandomState(seed)
    lt = args["learning_type"]
    input_dim, data = get_input_data(method, idx, time_length, data_loader,
                                     args, rng=rng, device=device,
                                     layout=layout)
    args["input_dim"] = input_dim
    kind, parts = layout if layout is not None else (None, None)
    if parts is not None and parts.index is None:
        if lt in SUPERVISED_TYPES:
            _supervised_parts(method, args, data_loader, idx, time_length,
                              rng, seed, layout)
        get_gnn_model(method, time_length, args, generator, knobs)
        return None
    data = _data_to(data, device)
    s_variant = method in S_VARIANTS
    vgrnn = method == "VGRNN"
    fwd = make_forward(method, layout, data_loader.node_num, time_length)
    sharding = _sharding(layout, time_length)

    def new_model():
        model = get_gnn_model(method, time_length, args, generator, knobs)
        if kind in ("time", "pipeline"):
            shard_time(model, parts, time_length)
        return model.to(device)

    if s_variant:
        embed_fn = _embed_trans(fwd)
    elif vgrnn:
        def embed_fn(model, data):
            return fwd(model, data)[0]
    else:
        embed_fn = fwd
    common = dict(
        base_path=base_path, origin_folder=args["origin_folder"],
        embedding_folder=args["embed_folder"],
        node_list=data_loader.full_node_list,
        embed_fn=embed_fn, data=data,
        device=device, model_folder=args.get("model_folder", "model"),
        file_sep=args.get("file_sep", "\t"))
    if lt in SUPERVISED_TYPES:
        t0 = time.time()
        classifier, forward_fn, loss_fn, auc_fn, splits = _supervised_parts(
            method, args, data_loader, idx, time_length, rng, seed, layout)
        split_seconds = time.time() - t0
        trainer = SupervisedEmbedding(
            model=new_model(),
            classifier=None if classifier is None else classifier.to(device),
            forward_fn=forward_fn, loss_fn=loss_fn, auc_fn=auc_fn,
            splits={k: tuple(a.to(device) for a in v)
                    for k, v in splits.items()},
            state_init=_vgrnn_state_init if vgrnn else None,
            sharding=sharding, **common)
        trainer.split_seconds = split_seconds
        return trainer
    if lt == "U-neg":
        data["walk"] = data_loader.get_walk_data(
            os.path.abspath(os.path.join(base_path,
                                         args["walk_pair_folder"])),
            os.path.abspath(os.path.join(base_path,
                                         args["node_freq_folder"])),
            idx, time_length).to(device)
        loss_fn = (_uneg_loss_fn_stateful(fwd, args["neg_num"], args["Q"])
                   if vgrnn else
                   _uneg_loss_fn(fwd, s_variant, args["neg_num"], args["Q"]))
    elif vgrnn:
        loss_fn = _vae_loss_fn_stateful(fwd, args.get("eps", 1e-10))
    else:
        loss_fn = _recon_loss_fn(fwd)
    if vgrnn:
        common.update(state_init=_vgrnn_state_init,
                      embed_state_fn=_embed_fn_stateful(fwd))
    return UnsupervisedEmbedding(model=new_model(), loss_fn=loss_fn,
                                 sharding=sharding, **common)


def gnn_embedding(method, args, device="cuda"):
    """Run the embedding task over all windows of the config.

    Returns one dict per window: ``idx``, ``time_length``,
    ``setup_seconds`` (loading the window and building its model, on the
    host clock; for the supervised types ``split_seconds`` of it built the
    splits), ``core_backend`` ("halo" on the halo paths), ``parts`` (the
    window's part count; ``idle`` on a rank without a part, which returns
    nothing else) and what the trainer's ``learn_embedding`` returns; the
    last window's also holds its ``trainer`` (the trained model and the
    window's inputs, for a caller that goes on with them).

    On the card the GEMMs run in full FP32: TF32 is turned off for the run
    and the caller's setting restored after it (``matmul_precision:
    "high"`` turns it on only around its bank GEMMs).  That is stricter
    than the JAX package on the TPU, which asks for ``Precision.HIGHEST``
    only in the bank GEMMs and runs the GRU and ``Linear`` GEMMs at XLA's
    default precision, one bf16 pass."""
    _check_scope(method, args)
    dev = resolve_device(device)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run_windows(method, args, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def _run_windows(method, args, dev):
    base_path = args["base_path"]
    model_file = args.get("model_file", method.lower())
    start_idx = args["start_idx"]
    end_idx = args["end_idx"]
    duration = args["duration"]
    load_model = args.get("load_model", False)
    record_time = args.get("record_time", False)
    seed = args.get("seed", 0)
    supervised = args["learning_type"] in SUPERVISED_TYPES
    knobs = core_knobs(args)
    phase_times = bool(os.environ.get("CTGCN_TPU_PHASE_TIMES"))
    report_memory = bool(os.environ.get("CTGCN_TPU_MEM_REPORT"))

    data_loader = get_data_loader(args)
    max_time_num = data_loader.max_time_num
    if start_idx < 0:
        start_idx = max_time_num + start_idx
    end_idx = max_time_num + end_idx + 1 if end_idx < 0 else end_idx + 1
    step = duration
    if args["learning_type"] == "S-link-dy":
        # a window's last snapshot only gives the edges its embedding
        # before predicts, and the next window starts there
        if duration < 2 or end_idx - start_idx < 1:
            raise ValueError(f"S-link-dy needs duration >= 2 (got "
                             f"{duration}) and a snapshot to train on")
        end_idx -= 1
        step = duration - 1

    t_start = time.time()
    time_list, results = [], []
    print(f"start_idx = {start_idx}, end_idx = {end_idx}, "
          f"duration = {duration}")
    print(f"start {method} embedding! (ctgcn_torch on {dev})")
    gen = torch.Generator().manual_seed(seed)
    # degree features and link splits: the JAX driver draws them from the
    # unseeded global np.random; here one stream from the config's seed
    rng = np.random.RandomState(seed)
    groups = {}
    if report_memory and dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for widx, idx in enumerate(range(start_idx, end_idx, step)):
        print(f"idx = {idx}, duration = {duration}")
        time_length = min(idx + duration, end_idx) - idx
        layout = make_layout(method, args, time_length, groups)
        t_setup = time.time()
        clock = PhaseClock(phase_times, dev)
        trainer = build_trainer(method, args, data_loader, idx, time_length,
                                dev, gen, rng=rng, seed=seed + widx,
                                layout=layout, knobs=knobs)
        setup_seconds = time.time() - t_setup
        clock.lap("setup")
        if trainer is None:
            results.append({"idx": idx, "time_length": time_length,
                            "parts": layout[1].count, "idle": True})
            pdist.barrier()
            continue
        # every window overwrites the same model file; only the last
        # window's save is kept unless the run reloads models
        is_last = idx + step >= end_idx
        keep = is_last or load_model
        common = dict(epoch=args["epoch"], lr=args["lr"], start_idx=idx,
                      weight_decay=args.get("weight_decay", 0.0),
                      model_file=model_file if keep else None,
                      load_model=load_model, export=args.get("export", True),
                      seed=seed + widx, profile_dir=args.get("profile_dir"),
                      phase_times=phase_times)
        if supervised:
            res = trainer.learn_embedding(
                classifier_file=args.get("cls_file") if keep else None,
                **common)
            res["split_seconds"] = trainer.split_seconds
        else:
            res = trainer.learn_embedding(
                batch_size=args["batch_size"],
                shuffle=args.get("shuffle", True), **common)
        time_list.append(res["cost_time"])
        clock.lap(f"run_window (train {res['cost_time']:.2f}s incl)")
        if report_memory:
            mem_report(idx, dev)
        results.append({"idx": idx, "time_length": time_length,
                        "setup_seconds": setup_seconds,
                        "core_backend": _adj_backend(trainer.data),
                        "parts": layout[1].count, **res})
        if is_last:
            results[-1]["trainer"] = trainer
        if record_time and pdist.is_primary():
            write_time_csv(os.path.join(base_path, method + "_time.csv"),
                           time_list)
        # rank 0 wrote the window's files; every rank meets here
        pdist.barrier()
    print(f"finish {method} embedding! cost time: "
          f"{time.time() - t_start} seconds!")
    return results
