#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ctgcn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through its CLI at the full width of the
repository's configs (hid 500, embed 128), and holds each hand-written
kernel against its plain PyTorch version:

  * uci_auto    ``configs/uci.json`` CTGCN-C as written (T = 7, batch 2048,
                neg_num 20, Q 20; no ``core_backend``, so ``"auto"``, which
                picks the principal blocks at UCI), 3 epochs on a temporary
                copy of the bundled UCI data;
  * uci_pallas  the same with ``core_backend: "pallas"`` (the BSR plans on
                both CUDA kernels), 1 epoch;
  * as_auto     ``configs/as.json`` CTGCN-C (T = 5, batch 8192) on the first
                5 AS snapshots, one window, under ``"auto"``, which picks
                delta-encoded ELL plans there (the CSR row walk forward, the
                block-parallel kernel on the transpose's hub rows), 3 epochs;
  * as_ctgcn_s  ``configs/as.json`` CTGCN-S as written (U-own, gaussian
                degree features, 3 SELU trans layers, one CoreDiffusion
                layer at 128) on the same window, 3 epochs;
  * as_bf16     as_auto with ``matmul_precision: "bf16"`` (both bf16 kernel
                instantiations: the row walk on the forward, the
                block-parallel kernel on the transpose), 1 epoch;
  * enron_bf16  ``configs/enron.json`` CTGCN-C as written
                (``matmul_precision: "bf16"``, batch 32768: 3 batches an
                epoch) on a preprocessed copy of Enron snapshots 000-004
                (N = 87,036, K = 22 slots), delta-ELL, 1 epoch; both plans
                have hub rows, so only the block-parallel bf16 kernel runs;
                then enron_highest, one epoch of it at ``"highest"`` from
                the same seed (no export), for the first-epoch loss gap;
  * uci_cgcn_c, uci_cgcn_s  ``configs/uci.json`` CGCN-C and CGCN-S (U-own,
                combine features) as written, windows 0-1, 2 epochs;
  * aa_snode    ``configs/america-air.json`` CTGCN-C with ``learning_type:
                "S-node"`` and nothing else changed (its ``nodes_label``,
                classifier keys and 0.5/0.3/0.2 split, duration 10, 50
                epochs) on a preprocessed copy of America-Air (N = 1190,
                T = 10; ``"auto"`` picks the principal blocks);
  * aa_sedge    the same with ``"S-edge"`` and ``elabel_folder:
                "edges_label"``, 5 epochs;
  * as_ctgcn_s_slink  ``configs/as.json`` CTGCN-S with ``"S-link-st"``
                (the supervised type that config gives its PGNN entry) on
                the AS window, delta-ELL, 3 epochs: classification plus
                reconstruction loss;
  * uci_slink_dy  ``configs/uci.json`` CTGCN-C with ``"S-link-dy"`` on BSR
                plans (``core_backend: "pallas"``), 3 epochs: one window of
                6 snapshots whose embeddings predict the next snapshot's
                edges;
  * enron_gcn   ``configs/enron.json`` GCN as written (hid 500, embed 128,
                dropout 0.5, batch 32768) on window 0 (snapshot 000, D^-1
                (A + I)) of the preprocessed Enron copy, 3 epochs: at
                87,036 nodes ``adj_backend: "auto"`` gives the graph the
                kernels' plans, whose hub row (degree 1,147) sends both
                directions to the block-parallel kernel;
  * math_gin    ``configs/math.json`` GIN as written (``learn_eps: false``,
                so A + I; 2 layers of a 2-layer MLP) on a preprocessed copy
                of Math snapshot 000 (24,740 nodes, longest row 226), 3
                epochs: the row walk in both directions;
  * uci_tggcn, as_tggin  ``configs/uci.json`` TgGCN (the raw A) and
                ``configs/as.json`` TgGIN (learnt eps, the raw A) on window
                0, 3 epochs: below 16,384 nodes the segment SpMM, no kernel
                of ours;
  * enron_gat   ``configs/enron.json`` GAT as written (head_num 1, alpha
                0.2, dropout 0.5, batch 32768) on Enron snapshot 000, 3
                epochs: the attention values of D^-1 (A + I)'s structure
                (hub row 1,148) go through ``ell_spmm_ev`` on the
                block-parallel kernel, both directions;
  * math_tggat  ``configs/math.json`` TgGAT (the raw A, default alpha and
                head_num) on Math snapshot 000, 3 epochs: the row walk,
                both directions;
  * enron_sage  ``configs/enron.json`` SAGE as written (``num_sample:
                null``, so every neighbour; sum pooling) on Enron snapshot
                000 (a neighbour table of 87,036 x 1,147), 3 epochs, no
                kernel of ours;
  * as_tgsage   ``configs/as.json`` TgSAGE (5 neighbours sampled, sum
                pooling) on window 0, 3 epochs, no kernel of ours;
  * enron_gcrn  ``configs/enron.json`` GCRN as written (T = 5, one GCN of
                hid 500 and embed 128 a snapshot, GRU, dropout 0.5, batch
                32768) on window 0 of the Enron copy, 3 epochs: every
                snapshot's D^-1 (A + I) (longest rows 1,147-1,149) on the
                block-parallel kernel, both directions;
  * enron_egcn  ``configs/enron.json`` EvolveGCN as written (EGCNH, hid
                128, embed 128, gaussian degree features) but for its
                window, cut from T = 10 to the 5 snapshots of the Enron
                copy (000-004), 1 epoch: D^-1/2 (A + I) D^-1/2 on the
                block-parallel kernel, both directions;
  * math_egcn   ``configs/math.json`` EvolveGCN as written (N = 24,740,
                T = 10, features of width 227) on a preprocessed copy of
                Math snapshots 000-009 (longest rows 226-227), 3 epochs:
                the row walk, both directions;
  * uci_vgrnn   ``configs/uci.json`` VGRNN as written (U-own, T = 7, hid
                500, embed 128, GCN convolutions, batch 2048: one batch),
                3 epochs: below 16,384 nodes the segment SpMM, no kernel
                of ours;
  * math_vgrnn  ``configs/math.json`` VGRNN as written (U-own, batch 32768:
                one batch) on window 0 (snapshots 000-004) of the Math
                copy, 3 epochs: its nine convolutions a step read D^-1/2
                (A_bin + 2I) D^-1/2 (longest row 226) on the row walk, both
                directions; the VAE loss step by step against the sparse
                raw A;
  * uci_pgnn    ``configs/uci.json`` PGNN as written (S-link-st, duration 2,
                feature 32, hid 32, embed 128, dropout 0.5, ``approximate:
                -1``) on window 0, 3 epochs: the proximity matrices of
                every shortest path, 100 anchor sets, no kernel of ours;
  * aa_pgnn     ``configs/america-air.json`` PGNN as written (S-node, hid
                500, the classifier on its 100 anchor-set columns) on
                window 0 (snapshot 0), 50 epochs;
  * math_pgnn   ``configs/math.json`` PGNN as written (S-link-st,
                ``approximate: 2``) on window 0 (snapshots 000-001 of the
                Math copy), 3 epochs: 2 x 24,740^2 proximities on the card
                (4.9 GB), 196 anchor sets, no kernel of ours;
  * uci_dyngem, uci_dynae, uci_dynrnn, uci_dynaernn, uci_timers
                ``configs/uci.json``'s non-GNN entries as written (DynGEM
                on every snapshot, 4,096 edges a batch; DynAE, DynRNN and
                DynAERNN on windows 2-6 of 3 snapshots, look-back 2; 50
                epochs; TIMERS' host SVD updates): [quality] scores them;
  * math_dyngem ``configs/math.json`` DynGEM as written on window 0
                (snapshot 000), 3 epochs: every edge's two rows of the
                dense 24,740-wide snapshot, one batch;
  * math_dynae, math_dynaernn  ``configs/math.json`` DynAE and DynAERNN as
                written on window 0 (snapshots 000-003, look-back 3: a
                dense [4, 24,740, 24,740] window of 9.8 GB on the card, one
                batch of every node), 3 epochs;
  * as_dynrnn   ``configs/as.json`` DynRNN as written on window 0 (AS
                snapshots 000-003), 3 epochs: its last decoder LSTM has
                6,828 hidden units.  These nine run no kernel of ours.

Phases, one line each:

  1. build      the CUDA kernels from ``ctgcn_torch/csrc`` (nvcc, sm_90a),
                failing if ptxas reports a register spill;
  2. preprocess k-core pyramids and walk tables through ``ctgcn_torch.main``
                on the native host-graph kernels (UCI, the AS and the Enron
                snapshots, America-Air, Math snapshot 000, Enron and Math
                snapshots 000-009), and the native
                core numbers against the numpy peel on every UCI snapshot;
  3. kernels    each f32 kernel on the UCI pallas plans (snapshot 2004-05,
                both directions, d = 512 and 128: ``block_spmm`` pads hid
                500 and embed 128 to multiples of 128) against both plain
                versions (CSR gather + index_add_, dense blocks), and on the
                AS delta-ELL plans (the largest snapshot, d = 500 and 128:
                ``ell_spmm`` pads only to a multiple of 4) against the CSR
                one; the autograd gradients of ``block_spmm`` and
                ``ell_spmm``; times of kernel, plain version and one library
                call on every plan at both widths, and each kernel's bound;
                in every kernel phase each kernel runs twice on each input
                and the two outputs must be bit-equal, and each row carries
                the plan's schedule (``schedule``: the chunk and chunks, the
                rows across a chunk's edge, the empty rows and their runs,
                the row walk's CTAs and its rows split over warps, the
                shared memory a CTA takes) and the lane groups at its width
                (``lane_groups``); the row walk's row also times the same
                plan walked in row order (``ms_natural_row_order``, its
                schedule rebuilt by ``bsr_spmm.with_row_order``);
     kernels_bf16  each bf16 instantiation (bf16 and f32 out) on the
                Enron delta plans of snapshot 004 and the AS ones, at d = 504
                and 128 (``ell_spmm`` pads to a multiple of 8 in bf16),
                against its plain version; its time beside the f32 kernel's
                on the same plan and width, ``torch.sparse.mm``'s and the
                bound;
     kernels_zoo  each f32 kernel on the zoo's plans of snapshot 000 (Enron
                under GCN's D^-1 (A + I), Math under GIN's A + I), both
                directions, d = 500 and 128, against the CSR plain version,
                then timed beside it, ``torch.sparse.mm`` and the bound; and
                on EvolveGCN's D^-1/2 (A + I) D^-1/2 plans of the same
                snapshots at d = 128;
                then with edge values given per call (``ell_spmm_ev``'s
                product) on GAT's plans of Enron 000 and TgGAT's of Math
                000, random positive values, at d = 500, 128 and GAT's
                row sum (4), against ``spmm_ev`` and the CSR plain
                version, timed beside them and ``torch.sparse.mm`` on the
                same values, with the value gather and the SDDMM of the
                values' gradient beside their bounds;
     kernels_vgrnn  each f32 kernel on VGRNN's plans of Math snapshot 000
                (D^-1/2 (A_bin + 2I) D^-1/2), both directions, d = 500 and
                128, against the CSR plain version, then timed beside it,
                ``torch.sparse.mm`` and the bound;
     kernels_halo  the halo plans of Enron snapshot 000 at 4 parts
                (``partition_pyramid_halo`` of its k-core pyramid and
                ``partition_graph_halo`` of GCN's D^-1 (A + I)): the host
                seconds, rpp, H, each part's local and remote nonzeros and
                the bytes an exchange ships a part; on the card each
                part's local and remote products at d = 500 and 128 (the
                receive buffer assembled by index from the other parts'
                rows) on the kernel ``dispatch`` gives them, their sum
                against the unpartitioned product, and each part's kernel
                ms beside its bound, the plain version and
                ``torch.sparse.mm``;
     parity     small CTGCN-C models on BSR and on delta-ELL plans, forward
                and gradients, kernels on the GPU against the plain versions
                on the CPU, and one on f32 blocks at ``"high"`` (3xTF32);
                small GCN (on the block-parallel kernel) and GIN (on the
                row walk) models the same way, a small 2-head GAT on each
                kernel (values and gradients through ``ell_spmm_ev``, so
                ``W`` and ``a`` take both d(vals) and d(x); against the
                CPU in float64), a small SAGE with ``num_sample`` above
                its largest degree, and a small GCRN and EvolveGCN (EGCNH)
                on each kernel, their parameters carried over by
                ``params_from_numpy`` (against the CPU in float64), and a
                small VGRNN the same way over two batches carrying h, its
                noise given, forward, VAE loss and gradients; a small PGNN
                given its anchor sets (the reduction's max and argmax,
                the forward and gradients, against the CPU in float64);
                the zoo's supervised branch: a small GCN under S-node on
                each kernel and a small VGRNN under S-link-st carrying h
                from the train step to validation to test (against the
                CPU in float64);
     parity_dyn DynGEM, DynAE, DynRNN and DynAERNN small (N = 800, the
                configs' widths), their parameters carried over by
                ``params_from_numpy``: the embedding, one epoch's summed
                loss and gradients over two batches, and its Adam step,
                against the CPU in float64;
  4. paths      each path with the launch counters set to 0 just before it
                and read just after (``PATHS``: the kernels each must launch,
                every other must not), and Enron's bf16 / "highest" loss gap;
     dist       an NCCL process group of world size 1 through the port's
                ``parallel.dist.init_from_env`` (localhost, a free port):
                UCI CTGCN-C (2 epochs) and GCN (window 0, 2 epochs, the
                CTGCN-C entry's walk tables) through the CLI with
                ``n_devices: 4`` and ``graph_partition: true`` (the halo
                path on one part, a real ``all_to_all_single``; counters
                set to 0 just before each and read just after): their
                epoch losses against the same runs without those keys
                (rtol 1e-4), and the halo path's export of the plain run's
                trained model against the plain run's CSVs (rtol 1e-3,
                atol 1e-4; the trained runs' CSV gap is reported beside
                the plain run's own gap to a rerun: Adam magnifies a
                rounding-level gradient's sign), epoch ms and peak memory;
     pipeline   in the same group, ``configs/as.json`` CTGCN-C (hid 500,
                embed 128, T = 5, delta-ELL) on the AS window through
                ``parallel.pipeline.ctgcn_pipelined_forward`` on one stage
                (K = ``pick_microbatch(6828, 1)`` = 4 node microbatches, a
                real ring ``all_to_all_single`` at every tick) beside the
                plain ``CTGCN`` forward, each with a U-neg loss backward
                on one batch 3 times, counters set to 0 just before each
                and read just after: outputs and every gradient against
                the plain run (rtol 1e-4), both step times, peak memory,
                the launches (equal to the plain run's) and the exchanges
                (K + P - 1 a forward); and what the exchange carries: on
                the group of one ``ring_shift`` sends part 0's carry to
                itself, so a microbatch's h and LSTM's (h, c) must come
                back bit-equal, and their gradients too;
     profile    an epoch's device time by kernel class (``torch.profiler``,
                device activity only) on each path of ``PROFILED``, right
                after its counted run, on the trainer of that run's last
                window (so a window's setup is paid once: enron_egcn's
                draws 0.5e9 gaussians), which that run left warm: one
                epoch on the host clock, one under the profiler;
     model_file the trained model of each path of ``MODEL_FILE_PATHS``
                (UCI CTGCN-C, Enron bf16's) written as the flax msgpack the
                JAX package reads and read back into a copy of the model,
                bit-equal, every parameter float32; its bytes and the write
                and read seconds beside ``torch.save``'s and
                ``torch.load``'s of the same state;
     memory     what lives at a VGRNN epoch's peak on uci_vgrnn and
                math_vgrnn (window, parameters, gradients and Adam, the
                tensors saved for the backward, the loss's z z^T chunk)
                beside the measured peaks of a forward, its backward and an
                epoch; for each PGNN path its profile, the anchor
                selection's device time and share of the device epoch, and
                its memory (the proximity matrices, the saved tensors, the
                peaks); the same profile and memory (the dense window, a
                batch's saved tensors, the peaks) on the non-GNN paths of
                Math and AS;
  5. quality    the UCI Had AUC gates, seeds 0 and 1 each (the zoo's
                runs seed 0; the runs train side by side in
                ``QUALITY_WORKERS`` spawned processes on the card, each
                host-bound, America-Air's second seed first, their
                launches counted), scored by the port's ``link_pred`` over
                edge-split reps 0-2 (mean Had AUC of the last 4 dates):
                CTGCN-C as configured but for 10
                epochs (``RESULTS.md:66-68``) and the same at
                ``matmul_precision: "bf16"`` (``RESULTS.md:69``), each
                failing below ``HAD_AUC_GATE``; CTGCN-S as configured (20
                epochs, ``RESULTS.md:38``), failing below ``S_AUC_GATE``;
                VGRNN as configured (50 epochs, ``RESULTS.md:52``), failing
                below ``VGRNN_AUC_GATE``; PGNN as configured (50 epochs),
                failing below ``PGNN_AUC_GATE``; GCRN, EvolveGCN and TgGCN
                as configured (50 epochs, seed 0), failing below
                ``ZOO_AUC_GATES``; the uci_* non-GNN paths
                (seed 0), failing below ``DYN_AUC_GATES`` and, TIMERS, more
                than ``TIMERS_AUC_TOL`` from the JAX package's figure;
                and aa_snode's mean test accuracy over seeds 0 and 1,
                failing more than ``AA_SNODE_MARGIN`` under the JAX
                package's mean on the same config and seeds
                (``AA_SNODE_JAX_ACC``), and aa_pgnn's, failing under its
                gate (``SNODE_QUALITY``);
     eval       ``cent_pred`` and ``sim_pred`` on seed 0's UCI embeddings;
                ``node_cls`` and ``edge_cls`` on America-Air (preprocessed,
                CTGCN-C trained 3 epochs); the centralities of UCI 2004-05
                and one date's logistic sweep on the GPU against the CPU;
  6. the ``kernels`` JSON line, the card's name and power limit, and the
     final ``{"ok": true, "device": ...}`` line.

Any failure exits non-zero.  Without a GPU, or outside a checkout of the
repository, the script stops before any result.

    python3 chip_smoke.py --compare <another checkout>

runs the build, the preprocessing and the kernel phases only, each
kernel row also holding the other checkout's kernel (its
``ctgcn_torch/ops/bsr_spmm.py``, its ``csrc`` built into its own
``_build``) against the plain version on the same matrix and input, and
timing it in turns with this checkout's and with this checkout's on the
plan's other way of gathering (``compare`` in each row: ``other_ms``,
``ms_turns``, ``ratio``, ``toggled_ms``); the last ``[compare]`` line
lists the dispatched rows more than 5 % slower than the other
checkout's.  Unpack the other commit's ``ctgcn_torch``
under ``tmp_run/`` (``git archive <commit> ctgcn_torch``).
"""
import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_START = time.time()
SNAPSHOT = "2004-05"
EPOCHS = 3
#: the AS snapshots of the ELL path (one window of configs/as.json)
AS_SNAPSHOTS = tuple(f"{i:03d}.csv" for i in range(5))
#: the Enron snapshots of the bf16 path (window 0 of configs/enron.json),
#: its epochs (the loss gap reads the first), and the snapshot whose plans
#: [kernels_bf16] times
ENRON_SNAPSHOTS = tuple(f"{i:03d}.csv" for i in range(5))
ENRON_EPOCHS = 1
ENRON_SNAPSHOT = 4
#: the Math snapshot of the GIN path (window 0 of configs/math.json)
MATH_SNAPSHOTS = ("000.csv",)
#: the snapshots of EvolveGCN's paths (window 0 of its entries: duration 10)
TEN_SNAPSHOTS = tuple(f"{i:03d}.csv" for i in range(10))
#: bf16 kernel with bf16 out vs its plain version: within one bf16 ulp of
#: the plain value (at most 2^-7 of it) plus ATOL_REL * max|plain|
BF16_ULP = 2.0 ** -7
#: relative gap of Enron's first-epoch loss, bf16 against "highest"
ENRON_LOSS_GAP = 1e-2
#: kernel vs plain version: |k - p| <= RTOL * |p| + ATOL_REL * max|p|
#: (f32 sums taken in another order; no TF32 on either side)
RTOL, ATOL_REL = 1e-5, 1e-5
#: small CTGCN-C, GPU kernels vs CPU plain versions (see phase_parity)
PARITY_TOL = 1e-4
#: published H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): FP32
#: outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: device cycles queued ahead of a timed run (about 10 ms on an H100)
SLEEP_CYCLES = 20_000_000
#: the Had AUC gate (RESULTS.md:66-68): CTGCN-C on UCI, 10 epochs, mean Had
#: AUC of the last 4 dates over edge-split reps 0-2, averaged over the seeds.
#: The gate is the JAX package's lowest of 6 seeds (0.9431) less 0.0025,
#: about one seed-to-seed standard deviation
QUALITY_EPOCHS, QUALITY_SEEDS, QUALITY_REPS = 10, (0, 1), 3
HAD_AUC_GATE = 0.9406
HAD_AUC_RANGES = {"ctgcn_tpu, 6 seeds": [0.9431, 0.9496],
                  "torch original, 6 seeds": [0.9453, 0.9519]}
#: CTGCN-S on UCI as configured (20 epochs): the JAX package's one seed,
#: 0.9342 (RESULTS.md:38, rep std 0.0031), less 0.0100
S_AUC_GATE = 0.9242
#: VGRNN on UCI as configured (50 epochs): the JAX package's 0.8955
#: (RESULTS.md:52, rep std 0.0060) less four rep standard deviations
VGRNN_AUC_GATE = 0.8715
#: PGNN on UCI as configured (S-link-st, four windows of duration 2, 50
#: epochs): (mean, run-to-run standard deviation) of RESULTS.md:55 (over
#: reps) and of the JAX package on the CPU (scripts/pgnn_quality_reference.py
#: --package jax --seeds 0 1 2 3, over seeds and reps); the gate is the
#: lower of the two means less four of their deviations
PGNN_AUC_JAX = (0.8536, 0.0112)
PGNN_AUC_REFERENCES = {"RESULTS.md:55": (0.8681, 0.0022),
                       "ctgcn_tpu on the CPU, seeds 0-3": PGNN_AUC_JAX}
PGNN_AUC_GATE = min(m - 4 * sd for m, sd in PGNN_AUC_REFERENCES.values())
#: the zoo's recurrent (GCRN), evolving-weight (EvolveGCN) and
#: per-snapshot (TgGCN) paths on UCI as configured (U-neg, 50 epochs;
#: GCRN and EvolveGCN one window of duration 7, TgGCN seven of duration
#: 1), seed 0: (mean, run-to-run standard deviation) of RESULTS.md (over
#: reps, trained by the JAX package) and of the JAX package on the CPU
#: (scripts/zoo_quality_reference.py --package jax --seeds 0 1, over seeds
#: and reps); each gate is the lower of the two means less four of their
#: deviations
ZOO_JAX = "ctgcn_tpu on the CPU, seeds 0-1"
ZOO_AUC_REFERENCES = {
    "GCRN": {"RESULTS.md:51": (0.8958, 0.0074), ZOO_JAX: (0.8973, 0.0053)},
    "EvolveGCN": {"RESULTS.md:56": (0.8354, 0.0021),
                  ZOO_JAX: (0.8354, 0.0094)},
    "TgGCN": {"RESULTS.md:50": (0.9010, 0.0047), ZOO_JAX: (0.9019, 0.0051)}}
ZOO_AUC_GATES = {m: min(mean - 4 * sd for mean, sd in refs.values())
                 for m, refs in ZOO_AUC_REFERENCES.items()}
ZOO_QUALITY_SEEDS = (0,)
#: the figures printed beside a quality run's gate
QUALITY_REFERENCES = {"PGNN": PGNN_AUC_REFERENCES, **ZOO_AUC_REFERENCES}
#: (name, method, config change, epochs, gate, seeds) of each quality run;
#: the bf16 run's gate is the f32 one, as RESULTS.md:69 found bf16
#: quality-neutral (0.9331 vs 0.9340 at 50 epochs)
QUALITY_RUNS = (
    ("CTGCN-C", "CTGCN-C", {}, QUALITY_EPOCHS, HAD_AUC_GATE, QUALITY_SEEDS),
    ("CTGCN-C-bf16", "CTGCN-C", {"matmul_precision": "bf16"},
     QUALITY_EPOCHS, HAD_AUC_GATE, QUALITY_SEEDS),
    ("CTGCN-S", "CTGCN-S", {}, 20, S_AUC_GATE, QUALITY_SEEDS),
    ("VGRNN", "VGRNN", {}, 50, VGRNN_AUC_GATE, QUALITY_SEEDS),
    ("PGNN", "PGNN", {}, 50, PGNN_AUC_GATE, QUALITY_SEEDS),
    *((m, m, {}, 50, ZOO_AUC_GATES[m], ZOO_QUALITY_SEEDS)
      for m in ZOO_AUC_REFERENCES))
#: America-Air training for node_cls / edge_cls
AA_EPOCHS = 3
#: aa_snode's quality gate: the JAX package's mean test accuracy on the
#: same config (configs/america-air.json CTGCN-C under S-node, 50 epochs)
#: over seeds 0 and 1, on the CPU (scripts/jax_snode_reference.py; the
#: splits are the same, the model inits differ); the port's mean over the
#: same seeds may fall at most AA_SNODE_MARGIN under it
AA_SNODE_JAX_ACC = 0.55085
AA_SNODE_MARGIN = 0.03
AA_SNODE_SEEDS = (0, 1)
#: aa_pgnn's gate: the JAX package's mean test accuracy on the same config
#: (configs/america-air.json PGNN, S-node, window 0, 50 epochs) over seeds
#: 0-3 on the CPU (scripts/pgnn_quality_reference.py), less four of its
#: seed-to-seed standard deviations; RESULTS.md:76's 0.3510 is node_cls's
#: accuracy on the exported embeddings, another measure, printed beside
AA_PGNN_JAX = (0.2616, 0.0395)
AA_PGNN_REFERENCES = {"ctgcn_tpu on the CPU, seeds 0-3": AA_PGNN_JAX,
                      "RESULTS.md:76 (node_cls, not S-node)": 0.3510}
#: path -> (method, config change of the other seeds' runs, the JAX
#: package's mean test accuracy, gate, references)
SNODE_QUALITY = {
    "aa_snode": ("CTGCN-C", {}, AA_SNODE_JAX_ACC,
                 AA_SNODE_JAX_ACC - AA_SNODE_MARGIN, {}),
    "aa_pgnn": ("PGNN", {"end_idx": 0}, AA_PGNN_JAX[0],
                AA_PGNN_JAX[0] - 4 * AA_PGNN_JAX[1], AA_PGNN_REFERENCES)}
#: the non-GNN baselines on UCI as configured (50 epochs; the uci_* paths
#: are their seed-0 runs): (mean, run-to-run standard deviation) of
#: RESULTS.md (over reps, trained by the JAX package) and of the JAX
#: package on the CPU (scripts/dyn_quality_reference.py --package jax
#: --seeds 0 1 --rnn-seeds 0, over seeds and reps); each gate is the lower
#: of the two means less four of their deviations
DYN_JAX = "ctgcn_tpu on the CPU, seeds 0-1 (DynRNN: 0)"
DYN_AUC_REFERENCES = {
    "DynGEM": {"RESULTS.md:48": (0.9124, 0.0038),
               DYN_JAX: (0.9163, 0.0046)},
    "DynAE": {"RESULTS.md:46": (0.9213, 0.0025),
              DYN_JAX: (0.9217, 0.0030)},
    "DynRNN": {"RESULTS.md:54": (0.8756, 0.0062),
               DYN_JAX: (0.8777, 0.0060)},
    "DynAERNN": {"RESULTS.md:53": (0.8883, 0.0020),
                 DYN_JAX: (0.8907, 0.0043)}}
DYN_AUC_GATES = {m: min(mean - 4 * sd for mean, sd in refs.values())
                 for m, refs in DYN_AUC_REFERENCES.items()}
#: TIMERS draws nothing but ARPACK's start, which the port pins to the ones
#: vector as the reference script pins the JAX package's: its Had AUC on
#: the card must lie within TIMERS_AUC_TOL of the JAX package's
#: (scripts/dyn_quality_reference.py); RESULTS.md:58's, from a random
#: start, is printed beside it
TIMERS_AUC_JAX = 0.82025
TIMERS_AUC_TOL = 1e-3
TIMERS_AUC_REFERENCES = {"ctgcn_tpu on the CPU, ARPACK from ones":
                         TIMERS_AUC_JAX, "RESULTS.md:58": (0.8197, 0.0089)}
#: the snapshots of the DynAE family's Math and AS paths (window 0 of
#: their entries: duration 4, look-back 3)
DYN_SNAPSHOTS = tuple(f"{i:03d}.csv" for i in range(4))
#: preprocessing seconds of the numpy walks, chip_smoke.py before the
#: native kernels (PERF.md section 5: NVIDIA H100 80GB HBM3, 700 W host)
NUMPY_PREPROCESS_SECONDS = {"as": 9.7, "enron": 13.2}
#: evaluation on the GPU against the CPU: float64 on both sides
DEVICE_CPU_RTOL = 1e-9


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def _phase(tag, **fields):
    """One result line; ``at_s``: seconds since the script started."""
    fields["at_s"] = time.time() - _START
    print(f"[{tag}] " + json.dumps(fields), flush=True)


def _time_ms(fn, iters=20, warmup=3):
    """Mean device ms of ``fn`` over back-to-back calls: what a call's
    inputs left in L2 stays there for the next.  A device sleep queued
    before the timed calls lets the host enqueue them all before the first
    runs, so the host's own cost per call (Python, a wrapper's checks) is
    not timed, unless ``fn`` waits for the device itself."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_ms_cold(fn, dev, iters=10):
    """Mean device ms of ``fn`` with L2 flushed before each call (a 128 MB
    buffer, over twice the 50 MB L2, is rewritten in between)."""
    import torch

    flush = torch.empty(32 * 1024 * 1024, device=dev)
    fn()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _plan_csr(plan, vals=None):
    """The plan's matrix as a torch sparse CSR tensor on its device (the
    library yardstick's input), from the plan's own CSR arrays (``vals``
    in place of its values when given)."""
    import torch

    return torch.sparse_csr_tensor(
        plan.csr_ptr.long(), plan.csr_col.long(),
        plan.csr_val if vals is None else vals, (plan.n_rows, plan.n_cols),
        check_invariants=False)


def _bound(plan, d, x_bytes=4, out_bytes=4):
    """Least time for ``out = A @ x`` with ``plan`` at width d: the larger
    of the bytes the product must move (A's values, column indices and row
    pointers, the rows of x that A's columns name, and out, each once;
    ``x_bytes`` / ``out_bytes`` per element: 2 for bf16) over the HBM rate
    and its 2 * nnz * d FLOPs over the FP32 peak (the kernels multiply in
    f32 FFMA).  Rows of x that no nonzero names need not be read: in a
    pyramid transpose that is most of g, whose rows for empty slot rows
    are never used."""
    import torch

    x_rows = int(torch.unique(plan.csr_col).numel())
    flops = 2.0 * plan.nnz * d
    bytes_ = (plan.nnz * 8 + (plan.n_rows + 1) * 4
              + x_rows * d * x_bytes + plan.n_rows * d * out_bytes)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, bytes_ / PEAK_HBM_BYTES
    return {
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "x_rows_read": x_rows, "flops": flops, "bytes": bytes_,
    }


def _check_rerun(name, got, again):
    """A kernel's two outputs on the same input must be bit-equal: its sums
    are taken in a fixed order and no atomics."""
    import torch

    if not torch.equal(got, again):
        raise AssertionError(f"{name}: a rerun on the same input differs")


def _schedule(plan, d, bf16=False):
    """The kernels' schedule of ``plan`` at width d, for a kernel row: the
    chunk and chunks, the crossing rows, the empty rows and their runs, the
    row walk's CTAs and split rows, whether a kernel gathers into
    registers (``walk_rows``, ``chunk_regs``), the shared memory a ring
    CTA takes (``bsr_spmm.schedule_stats``), and the lane groups (g lanes,
    G groups, NV pieces a lane, grid-y slices) of the ring kernels and,
    where a kernel gathers into registers, of those (``lane_groups_by_row``)."""
    from ctgcn_torch.ops import bsr_spmm as B

    keys = ("g", "G", "NV", "slices")
    out = {"schedule": B.schedule_stats(plan),
           "lane_groups": dict(zip(keys, B.lane_groups(d, bf16)))}
    if plan.walk_rows or (plan.chunk_regs and not bf16):
        out["lane_groups_by_row"] = dict(zip(keys, B.lane_groups(d, bf16,
                                                                 True)))
    return out


#: with ``--compare DIR``: the other checkout's kernels (``_OtherKernels``)
#: and the rows compared so far; None on a plain run
_OTHER = None
_COMPARED = []


class _OtherKernels:
    """Another checkout's SpMM kernels, for ``--compare DIR``: its
    ``ctgcn_torch/ops/cuda_build.py`` and ``bsr_spmm.py`` loaded under
    other module names (its ``csrc`` built into its own ``_build``), and
    each of this run's plans rebuilt by its own ``_csr_fields`` from the
    nonzeros and row groups this checkout's plan was built from, which
    this object records from then on.  The other checkout's ``bsr_spmm``
    must have ``_csr_fields(r, c, val, n_rows, row_group)``, ``CsrPlan``
    and the four kernel wrappers of this one's signatures."""

    def __init__(self, root):
        import importlib.util
        import types

        from ctgcn_torch.ops import bsr_spmm as B
        from ctgcn_torch.ops import ell

        ops = Path(root).resolve() / "ctgcn_torch" / "ops"
        name = "_other_cuda_build"
        spec = importlib.util.spec_from_file_location(name,
                                                      ops / "cuda_build.py")
        self.build = importlib.util.module_from_spec(spec)
        sys.modules[name] = self.build
        spec.loader.exec_module(self.build)
        # its wrappers import its own cuda_build
        src = (ops / "bsr_spmm.py").read_text().replace(
            "ctgcn_torch.ops.cuda_build", name)
        self.B = types.ModuleType("_other_bsr_spmm")
        self.B.__file__ = str(ops / "bsr_spmm.py")
        sys.modules[self.B.__name__] = self.B
        exec(compile(src, self.B.__file__, "exec"), self.B.__dict__)
        self.sources, self.plans = {}, {}
        fields, to = B._csr_fields, B.CsrPlan.to

        def capture(r, c, val, n_rows, row_group):
            out = fields(r, c, val, n_rows, row_group)
            self.sources[id(out["csr_col"])] = (r, c, val, n_rows, row_group)
            return out

        def moved(plan, *args, **kw):
            out = to(plan, *args, **kw)
            if id(plan.csr_col) in self.sources:
                self.sources[id(out.csr_col)] = self.sources[id(plan.csr_col)]
            return out

        B._csr_fields = ell._csr_fields = capture
        B.CsrPlan.to = moved

    def toggled(self, plan, name):
        """This checkout's ``plan`` with kernel ``name``'s other way of
        gathering (a warp a row or the ring's ranges for the row walk, the
        register or the ring pass for the f32 block-parallel kernel), the
        walk order and groups kept; None for a plan not built through
        ``_csr_fields`` or without nonzeros."""
        from ctgcn_torch.ops import bsr_spmm as B

        key = (id(plan.csr_col), "rowwalk" in name)
        src = self.sources.get(key[0])
        if src is None or plan.nnz == 0 or name == "bsr_spmm_blockpar_bf16":
            # the bf16 block-parallel kernel has one way: the ring
            return None
        if key not in self.plans:
            order = plan.row_order.cpu().numpy()
            mode = ({"walk_rows": not plan.walk_rows} if key[1]
                    else {"chunk_regs": not plan.chunk_regs})
            self.plans[key] = (plan, B.with_row_order(plan, order, src[4],
                                                      **mode))
        return self.plans[key][1]

    def plan(self, plan):
        """The other checkout's plan of the same matrix on plan's device,
        or None for a plan not built through ``_csr_fields``."""
        key = id(plan.csr_col)
        if key not in self.plans:
            src = self.sources.get(key)
            if src is None:
                return None
            other = self.B.CsrPlan(**self.B._csr_fields(*src), n_rows=src[3],
                                   n_cols=plan.n_cols)
            # the plan is kept, so that its id is not reused
            self.plans[key] = (plan, other.to(plan.csr_col.device))
        return self.plans[key][1]


def _compare(label, name, plan, inp, *args):
    """With ``--compare``: kernel ``name`` of the other checkout on the
    same matrix and input, held against the plain version, and timed in
    turns with this checkout's and with this checkout's on the plan's
    other way of gathering (``_OtherKernels.toggled``): other, this,
    toggled, toggled, this, other; {} on a plain run.  ``args``: the
    wrapper's (vals for f32, out_dtype for bf16)."""
    if _OTHER is None:
        return {}
    import torch

    from ctgcn_torch.ops import bsr_spmm as B

    other = _OTHER.plan(plan)
    if other is None:
        return {}
    ours, theirs = getattr(B, name), getattr(_OTHER.B, name)
    alt = _OTHER.toggled(plan, name)
    what = f"{label} {name} d={inp.shape[1]}"
    for tag, kern, p in (("other checkout", theirs, other),
                         ("toggled", ours, alt)):
        if p is None:
            continue
        got = kern(p, inp, *args)
        if name.endswith("_bf16"):
            _check_bf16(f"{what} {tag}", got, B.bsr_spmm_csr_plain_bf16(
                plan, inp, torch.float32), args[0])
        else:
            _check_close(f"{what} {tag}", got,
                         B.bsr_spmm_csr_plain(plan, inp, *args))
        del got
    t = [_time_ms(lambda: theirs(other, inp, *args)),
         _time_ms(lambda: ours(plan, inp, *args))]
    if alt is not None:
        t += [_time_ms(lambda: ours(alt, inp, *args)) for _ in range(2)]
    t += [_time_ms(lambda: ours(plan, inp, *args)),
          _time_ms(lambda: theirs(other, inp, *args))]
    row = {"other_ms": [t[0], t[-1]], "ms_turns": [t[1], t[-2]],
           "ratio": (t[1] + t[-2]) / (t[0] + t[-1])}
    if alt is not None:
        row["toggled_ms"] = t[2:4]
    _COMPARED.append({"plan": label, "kernel": name, "d": inp.shape[1],
                      "walk_rows": plan.walk_rows,
                      "chunk_regs": plan.chunk_regs,
                      "dispatched": B.dispatch(
                          plan, bf16=name.endswith("_bf16")) is ours,
                      **row})
    return {"compare": row}


def _check_close(name, got, ref, rtol=RTOL, atol_rel=ATOL_REL, scale=None):
    """|got - ref| <= rtol * |ref| + atol_rel * scale, ``scale`` max|ref|
    unless given."""
    import torch

    err = (got - ref).abs()
    scale = float(ref.abs().max()) if scale is None else scale
    tol = rtol * ref.abs() + atol_rel * scale
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        raise AssertionError(f"{name}: max abs err {float(err.max()):.3e} "
                             f"over tolerance (rtol {rtol}, atol "
                             f"{atol_rel} * max|ref|)")
    return float(err.max())


#: the f32 kernels, then their bf16 instantiations (same TPU kernels)
F32_KERNELS = {"bsr_spmm_blockpar": "ctgcn_tpu/ops/pallas_spmm.py:146",
               "bsr_spmm_rowwalk": "ctgcn_tpu/ops/pallas_spmm.py:97"}
BF16_KERNELS = {f"{k}_bf16": v for k, v in F32_KERNELS.items()}
KERNELS = {**F32_KERNELS, **BF16_KERNELS}


def _zero_launches():
    """Set the kernels' launch counters (``spmm.launches.<kernel>``) to 0."""
    from ctgcn_torch.training import profiling
    profiling.reset_counters("spmm.launches.")


def _launches():
    """{kernel: launches counted since ``_zero_launches``}."""
    from ctgcn_torch.training import profiling
    return {name: profiling.counter("spmm.launches." + name)
            for name in KERNELS}


def _spmm_widths(cfg, align):
    """The widths of the two CoreDiffusion layers' SpMMs (hid, then
    embed), each padded to a multiple of ``align`` as the path pads it."""
    return tuple(-(-cfg[k] // align) * align
                 for k in ("hid_dim", "embed_dim"))


def _kernel_rows(tag, plans, dev, widths, extra_check=None, vals=None,
                 reached=tuple(F32_KERNELS)):
    """Each kernel on each of ``plans`` (name -> device plan) at each of
    ``widths`` against the CSR plain version (and ``extra_check``), then
    each kernel's time on every plan at every width beside the plain
    version's, the library call's and the bound.  With ``vals`` (name ->
    f32 values in plan order) the kernels, the plain version and the
    library read those in place of the plans' values (the same bytes, so
    the same bound).  ``dispatch`` must give the plans the kernels of
    ``reached``.  Returns the row of each of those kernels on the plan
    ``dispatch`` gives it, at the first width."""
    import numpy as np
    import torch

    from ctgcn_torch.ops import bsr_spmm as B

    def v_of(pk):
        return () if vals is None else (vals[pk],)

    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = {k: torch.randn(p.n_cols, max(widths), device=dev,
                             generator=gen) for k, p in plans.items()}
    # the plan each kernel gets on the path (the first that dispatch gives
    # it)
    main_plan = {}
    for k, p in plans.items():
        main_plan.setdefault(B.dispatch(p).__name__, k)
    if set(main_plan) != set(reached):
        raise AssertionError(f"{tag}: the plans reach {sorted(main_plan)}, "
                             f"not {sorted(reached)}")
    errs = {}
    for name in F32_KERNELS:
        kern = getattr(B, name)
        for pk, plan in plans.items():
            for dd in widths:
                inp = inputs[pk][:, :dd].contiguous()
                got = kern(plan, inp, *v_of(pk))
                _check_rerun(f"{tag} {name} {pk} d={dd}", got,
                             kern(plan, inp, *v_of(pk)))
                ref = B.bsr_spmm_csr_plain(plan, inp, *v_of(pk))
                err = _check_close(f"{tag} {name} {pk} d={dd}", got, ref)
                errs[name, pk, dd] = (err, err / float(ref.abs().max()))
                if extra_check is not None:
                    extra_check(f"{tag} {name} {pk} d={dd}", kern, pk, inp,
                                got, ref)
                del got, ref
    torch.cuda.synchronize()

    results = {}
    times = {name: [] for name in F32_KERNELS}
    for pk, plan in plans.items():
        v = v_of(pk)
        csr = _plan_csr(plan, *v)
        for dd in widths:
            inp = inputs[pk][:, :dd].contiguous()
            bound = _bound(plan, dd)
            library_ms = _time_ms(lambda: torch.sparse.mm(csr, inp))
            _check_close(f"{tag} torch.sparse.mm {pk} d={dd}",
                         torch.sparse.mm(csr, inp),
                         B.bsr_spmm_csr_plain(plan, inp, *v))
            plain_ms = _time_ms(lambda: B.bsr_spmm_csr_plain(plan, inp, *v),
                                iters=5, warmup=1)
            for name in F32_KERNELS:
                kern = getattr(B, name)
                ms = _time_ms(lambda: kern(plan, inp, *v))
                row = {"plan": pk, "d": dd, "ms": ms, "plain_ms": plain_ms,
                       **_compare(f"{tag} {pk}", name, plan, inp, *v),
                       "library_ms": library_ms, "library_dtype": "f32",
                       "bound_ms": bound["bound_ms"],
                       "bound_by": bound["bound_by"],
                       "dispatched": B.dispatch(plan) is kern,
                       **_schedule(plan, dd)}
                times[name].append(row)
                if main_plan.get(name) != pk or dd != widths[0]:
                    continue
                err, rel_err = errs[name, pk, dd]
                if name == "bsr_spmm_rowwalk":
                    # the walk order's worth: the same walk in row order,
                    # its schedule rebuilt for that order
                    natural = B.with_row_order(plan, np.arange(plan.n_rows))
                    extra = {"ms_natural_row_order": _time_ms(
                        lambda: kern(natural, inp, *v))}
                else:
                    extra = {}
                results[name] = {
                    "plan": pk, "shape": [plan.n_rows, plan.n_cols, dd],
                    "nnz": plan.nnz, "max_row_nnz": plan.max_row_nnz,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"],
                    "library_ms": library_ms, "library_dtype": "f32",
                    "ms_cold_l2": _time_ms_cold(lambda: kern(plan, inp, *v),
                                                dev),
                    **_schedule(plan, dd), **extra}
                _phase(tag, kernel=name, **results[name],
                       max_rel_err=rel_err,
                       tolerance=f"rtol {RTOL} + atol {ATOL_REL} * "
                                 "max|plain|",
                       library="torch.sparse.mm (CSR)",
                       x_rows_read=bound["x_rows_read"],
                       flops=bound["flops"], bytes=bound["bytes"])
        del csr
    for name in F32_KERNELS:
        if name in results:
            results[name]["times"] = times[name]
        _phase(tag, kernel=name, times=times[name])
    return results


def phase_kernels(cfg, dev):
    """Both kernels on the UCI pallas plans of snapshot 2004-05 (the
    pallas path's shapes), also against the dense-block oracle and on
    padded plans, and the autograd gradient of ``block_spmm``."""
    import torch

    from ctgcn_torch.data.formats import sorted_dir
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.training.driver import get_data_loader

    args = dict(cfg)
    loader = get_data_loader(args)
    t = sorted_dir(args["core_base_path"]).index(SNAPSHOT)
    t0 = time.time()
    pyr = loader.get_core_adj_list(args["core_base_path"], 0,
                                   args["duration"], core_backend="pallas")
    _phase("kernels", window_plans_built_seconds=time.time() - t0,
           blocks_fwd=[p.num_blocks for p in pyr.plan_fwd],
           blocks_t=[p.num_blocks for p in pyr.plan_t],
           nnz=[p.nnz for p in pyr.plan_fwd],
           max_row_nnz_fwd=[p.max_row_nnz for p in pyr.plan_fwd],
           max_row_nnz_t=[p.max_row_nnz for p in pyr.plan_t])
    hosts = {"forward": pyr.plan_fwd[t], "transpose": pyr.plan_t[t]}
    plans = {k: h.to(dev) for k, h in hosts.items()}
    # the dense oracle needs the blocks, which device plans leave behind;
    # padded plans must give the same product
    with_blocks = {k: h.to(dev, blocks=True) for k, h in hosts.items()}
    padded = {k: B.pad_block_plan(h, h.num_blocks + 37).to(dev)
              for k, h in hosts.items()}

    def block_checks(what, kern, pk, inp, got, ref):
        _check_close(f"{what} vs dense blocks", got,
                     B.bsr_spmm_plain(with_blocks[pk], inp))
        _check_close(f"{what} padded plan", kern(padded[pk], inp), ref)

    widths = _spmm_widths(args, B.BLOCK)
    results = _kernel_rows("kernels", plans, dev, widths, block_checks)
    del with_blocks, padded

    # autograd through block_spmm: layer 1's forward and backward kernels
    fwd, tr = plans["forward"], plans["transpose"]
    gen = torch.Generator(device=dev).manual_seed(1)
    n, dm = pyr.n_nodes, args["hid_dim"]
    xs = torch.randn(n, dm, device=dev, generator=gen, requires_grad=True)
    w = torch.randn(fwd.n_rows, dm, device=dev, generator=gen)
    (B.block_spmm(fwd, tr, xs) * w).sum().backward()
    g_pad = torch.nn.functional.pad(w, (0, widths[0] - dm)).contiguous()
    ref = B.bsr_spmm_csr_plain(tr, g_pad)[:n, :dm]
    gerr = _check_close("block_spmm grad", xs.grad, ref)
    _phase("kernels", check="block_spmm autograd grad", max_abs_err=gerr)
    return results


def phase_kernels_ell(cfg, dev):
    """Both kernels on the AS window's delta-ELL plans (the ELL path's
    shapes) of its largest snapshot, and the autograd gradient of
    ``ell_spmm``."""
    import torch

    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.ops.ell import ell_spmm
    from ctgcn_torch.training.driver import get_data_loader

    args = dict(cfg)
    loader = get_data_loader(args)
    t0 = time.time()
    pyr = loader.get_core_adj_list(args["core_base_path"], 0,
                                   args["duration"])
    built_s = time.time() - t0
    if pyr.backend != "ell" or not pyr.ell_delta:
        raise AssertionError(f"auto chose {pyr.backend} at AS, not ell")
    nnz = [p.nnz for p in pyr.ell_fwd]
    _phase("kernels_ell", window_plans_built_seconds=built_s,
           n_nodes=pyr.n_nodes, num_slots=pyr.num_slots,
           kept_slots=pyr.valid.sum(1).tolist(), nnz=nnz,
           max_row_nnz_fwd=[p.max_row_nnz for p in pyr.ell_fwd],
           max_row_nnz_t=[p.max_row_nnz for p in pyr.ell_t])
    t = max(range(len(nnz)), key=nnz.__getitem__)
    plans = {"forward": pyr.ell_fwd[t].to(dev),
             "transpose": pyr.ell_t[t].to(dev)}
    widths = _spmm_widths(args, B.D_ALIGN)
    results = _kernel_rows("kernels_ell", plans, dev, widths)

    # autograd through ell_spmm: layer 1's forward and backward kernels
    fwd, tr = plans["forward"], plans["transpose"]
    gen = torch.Generator(device=dev).manual_seed(1)
    dm = args["hid_dim"]
    xs = torch.randn(fwd.n_cols, dm, device=dev, generator=gen,
                     requires_grad=True)
    w = torch.randn(fwd.n_rows, dm, device=dev, generator=gen)
    (ell_spmm(fwd, tr, xs) * w).sum().backward()
    g_pad = torch.nn.functional.pad(w, (0, widths[0] - dm)).contiguous()
    gerr = _check_close("ell_spmm grad", xs.grad,
                        B.bsr_spmm_csr_plain(tr, g_pad)[:, :dm])
    _phase("kernels_ell", check="ell_spmm autograd grad", snapshot=t,
           d=dm, max_abs_err=gerr)
    return results, plans


def phase_kernels_zoo(cfgs, dev):
    """Both f32 kernels on the zoo's plans of snapshot 000 as the driver
    builds them (``_zoo_adjacency``): Enron under GCN's D^-1 (A + I) and
    Math under GIN's A + I, each direction, at d = 500 and 128 (hid 500 and
    embed 128; ``ell_spmm`` pads to a multiple of 4; EvolveGCN's 128 and
    128 once).  ``dispatch`` must give Enron's plans the block-parallel
    kernel and Math's the row walk, which the enron_gcn and math_gin paths
    (and EvolveGCN's, on its D^-1/2 (A + I) D^-1/2 plans) then launch."""
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.training.driver import _zoo_adjacency, get_data_loader

    plans = {}
    for data, (cfg, method) in cfgs.items():
        args = dict(cfg)
        loader = get_data_loader(args)
        t0 = time.time()
        adjs, _ = _zoo_adjacency(method, 0, 1, loader, args)
        built_s = time.time() - t0
        graph = adjs[0]
        if graph.backend != "ell":
            raise AssertionError(f"{data} {method}: adj_backend auto gave "
                                 f"{graph.backend}, not the plans")
        fwd, tr = graph.plan_fwd, graph.plan_t
        _phase("kernels_zoo", data=data, method=method,
               window_built_seconds=built_s, n_nodes=fwd.n_rows,
               nnz=fwd.nnz, max_row_nnz_fwd=fwd.max_row_nnz,
               max_row_nnz_t=tr.max_row_nnz,
               dispatch=[B.dispatch(p).__name__ for p in (fwd, tr)])
        plans[f"{data}_forward"] = fwd.to(dev)
        plans[f"{data}_transpose"] = tr.to(dev)
    want = {"enron_forward": "bsr_spmm_blockpar",
            "math_forward": "bsr_spmm_rowwalk"}
    got = {k: B.dispatch(plans[k]).__name__ for k in want}
    if got != want:
        raise AssertionError(f"dispatch gives {got} on the zoo's plans")
    widths = tuple(dict.fromkeys(_spmm_widths(cfgs["enron"][0], B.D_ALIGN)))
    return _kernel_rows("kernels_zoo", plans, dev, widths)


def phase_kernels_zoo_ev(cfgs, dev):
    """Both f32 kernels with edge values given per call (the product of
    ``ell_spmm_ev``) on the ``EvPlan`` pairs of snapshot 000 as the driver
    builds them: Enron under GAT (D^-1 (A + I), hub row 1,148: the
    block-parallel kernel) and Math under TgGAT (the raw A: the row walk),
    each direction, at d = 500 and 128 and at GAT's row sum (a ones
    column, padded to 4), with random positive values: against the CSR
    plain version fed the values in plan order and against the segment
    ``spmm_ev`` fed them in edge order; then timed beside them and
    ``torch.sparse.mm`` on the same values.  Also the other pieces of an
    ``ell_spmm_ev`` call, each beside its bound: the gather of the values
    into plan order (on each plan: the forward's, and the transpose's for
    d(x)), and on the forward plans the SDDMM of d(vals)
    (``g[row] . x[col]``) and the whole forward."""
    import torch

    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.ops.ell import EvPlan, ell_spmm_ev
    from ctgcn_torch.ops.spmm import sddmm, spmm_ev
    from ctgcn_torch.training.driver import get_data_loader, get_input_data

    plans, edge_vals, graphs, coo = {}, {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for data, (cfg, method) in cfgs.items():
        args = dict(cfg)
        loader = get_data_loader(args)
        t0 = time.time()
        _, window = get_input_data(method, 0, 1, loader, args)
        built_s = time.time() - t0
        graph = window["adjs"][0]
        if not isinstance(graph.plan_fwd, EvPlan):
            raise AssertionError(f"{data} {method}: no EvPlan pair")
        graph = graph.to(dev)
        fwd, tr = graph.plan_fwd, graph.plan_t
        _phase("kernels_zoo_ev", data=data, method=method,
               window_built_seconds=built_s, n_nodes=fwd.n_rows,
               nnz=fwd.nnz, max_row_nnz_fwd=fwd.max_row_nnz,
               max_row_nnz_t=tr.max_row_nnz,
               dispatch=[B.dispatch(p).__name__ for p in (fwd, tr)])
        vals = torch.rand(fwd.nnz, device=dev, generator=gen) + 0.1
        graphs[data] = (graph, vals)
        for direction, plan, rc in (
                ("forward", fwd, (graph.rows, graph.cols)),
                ("transpose", tr, (graph.cols, graph.rows))):
            plans[f"{data}_{direction}"] = plan
            edge_vals[f"{data}_{direction}"] = vals
            coo[f"{data}_{direction}"] = rc
    want = {"enron_forward": "bsr_spmm_blockpar",
            "enron_transpose": "bsr_spmm_blockpar",
            "math_forward": "bsr_spmm_rowwalk",
            "math_transpose": "bsr_spmm_rowwalk"}
    got = {k: B.dispatch(plans[k]).__name__ for k in want}
    if got != want:
        raise AssertionError(f"dispatch gives {got} on the EvPlans")
    plan_vals = {k: edge_vals[k][p.csr_eid].contiguous()
                 for k, p in plans.items()}

    def segment_check(what, kern, pk, inp, got, ref):
        _check_close(f"{what} vs spmm_ev", got,
                     spmm_ev(*coo[pk], edge_vals[pk], inp,
                             plans[pk].n_rows))

    # the layers' widths, then the row sum's
    widths = _spmm_widths(cfgs["enron"][0], B.D_ALIGN) + (B.D_ALIGN,)
    results = _kernel_rows("kernels_zoo_ev", plans, dev, widths,
                           segment_check, vals=plan_vals)
    pieces = []
    for pk, plan in plans.items():
        graph, vals = graphs[pk.split("_")[0]]
        rows, cols = coo[pk]
        # eid (int64) and the values read, the values in plan order written
        row = {"plan": pk, "nnz": plan.nnz,
               "gather_ms": _time_ms(lambda: vals[plan.csr_eid]),
               "gather_bound_ms": 16 * plan.nnz / PEAK_HBM_BYTES * 1e3}
        pieces.append(row)
        _phase("kernels_zoo_ev", **row)
        for dd in widths:
            x = torch.randn(plan.n_cols, dd, device=dev, generator=gen)
            g = torch.randn(plan.n_rows, dd, device=dev, generator=gen)
            with torch.no_grad():
                row = {"plan": pk, "d": dd, "nnz": plan.nnz,
                       "spmm_ev_plain_ms": _time_ms(lambda: spmm_ev(
                           rows, cols, vals, x, plan.n_rows),
                           iters=5, warmup=1)}
                if pk.endswith("forward"):
                    # rows and cols (int64), the g and x rows they name,
                    # one f32 an edge written; 2 d FLOPs an edge
                    sddmm_bytes = (
                        16 * plan.nnz + 4 * plan.nnz + 4 * dd * (
                            int(torch.unique(rows).numel())
                            + int(torch.unique(cols).numel())))
                    row.update(
                        sddmm_ms=_time_ms(lambda: sddmm(graph, g, x)),
                        sddmm_bound_ms=max(
                            sddmm_bytes / PEAK_HBM_BYTES,
                            2.0 * plan.nnz * dd / PEAK_FP32_FLOPS) * 1e3,
                        ell_spmm_ev_forward_ms=_time_ms(
                            lambda: ell_spmm_ev(graph, vals, x)))
            pieces.append(row)
            _phase("kernels_zoo_ev", **row)
    for name in F32_KERNELS:
        results[name]["pieces"] = pieces
    return results


def phase_kernels_vgrnn(cfg, dev):
    """Both f32 kernels on VGRNN's plans of Math snapshot 000 as the driver
    builds them (D^-1/2 (A_bin + 2I) D^-1/2, longest row 226: the row walk
    in both directions), each direction at d = 500 (``enc`` and the GRU's
    six convolutions) and 128 (``enc_mean``, ``enc_std``), against the CSR
    plain version, then timed beside it, ``torch.sparse.mm`` and the
    bound."""
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.training.driver import get_data_loader, get_input_data

    args = dict(cfg)
    loader = get_data_loader(args)
    t0 = time.time()
    _, window = get_input_data("VGRNN", 0, 1, loader, args)
    built_s = time.time() - t0
    graph = window["vgrnn_adjs"][0]
    if graph.backend != "ell":
        raise AssertionError(f"math VGRNN: adj_backend auto gave "
                             f"{graph.backend}, not the plans")
    fwd, tr = graph.plan_fwd, graph.plan_t
    _phase("kernels_vgrnn", data="math", method="VGRNN",
           window_built_seconds=built_s, n_nodes=fwd.n_rows, nnz=fwd.nnz,
           max_row_nnz_fwd=fwd.max_row_nnz, max_row_nnz_t=tr.max_row_nnz,
           dispatch=[B.dispatch(p).__name__ for p in (fwd, tr)])
    plans = {"math_forward": fwd.to(dev), "math_transpose": tr.to(dev)}
    widths = tuple(dict.fromkeys(_spmm_widths(args, B.D_ALIGN)))
    return _kernel_rows("kernels_vgrnn", plans, dev, widths,
                        reached=("bsr_spmm_rowwalk",))


#: parts of the halo plans that [kernels_halo] measures at Enron
HALO_PARTS = 4
#: the keys that send a [dist] run down the partitioned path
DIST_KEYS = {"n_devices": 4, "graph_partition": True}
#: the runs of a [dist] path, in order (``phase_dist``)
DIST_RUNS = ("plain", "rerun", "halo", "replay")


def _kept_deltas(mats):
    """A snapshot's delta slots, max core first, straight from scipy: each
    core that differs from the one before it, minus the one kept before
    it (slot 0 whole, without the +I)."""
    kept = [m for j, m in enumerate(mats)
            if j == 0 or abs(m - mats[j - 1]).sum() != 0]
    return [kept[0]] + [kept[k] - kept[k - 1] for k in range(1, len(kept))]


def _halo_rows(tag, what, plan_host, ref_mat, n_nodes, widths, dev):
    """Each part of a halo plan (``PartitionedPyramid`` or
    ``HaloPartitionedGraph``) on the card: its LOCAL product on its x rows
    and its REMOTE product on the receive buffer, assembled here by index
    from the other parts' rows, each by the kernel ``dispatch`` gives it;
    their sum over the parts against the unpartitioned product of
    ``ref_mat`` ([K·N, N] or [N, N] scipy, the plain CSR version); then
    each part's kernel ms beside the bound, the plain version and
    ``torch.sparse.mm``.  Returns the rows by kernel name."""
    import torch

    from ctgcn_torch.ops import bsr_spmm as B

    parts = [plan_host.part(p).to(dev) for p in range(plan_host.parts)]
    rpp, K = plan_host.rows_per_part, parts[0].num_slots
    ref_plan = B.build_csr_plan(ref_mat).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x_all = torch.randn(plan_host.n_rows, max(widths), device=dev,
                        generator=gen)
    rows = {}
    for dd in widths:
        x = x_all[:, :dd].contiguous()
        xs = x.split(rpp)
        outs = []
        for p, part in enumerate(parts):
            recv = torch.cat([xs[q][parts[q].send[p]]
                              for q in range(len(parts))]).contiguous()
            local = B.dispatch(part.local_fwd)(part.local_fwd, xs[p])
            remote = B.dispatch(part.remote_fwd)(part.remote_fwd, recv)
            for what_p, plan, inp, got in (
                    ("local", part.local_fwd, xs[p], local),
                    ("remote", part.remote_fwd, recv, remote)):
                _check_rerun(f"{tag} {what} part {p} {what_p} d={dd}", got,
                             B.dispatch(plan)(plan, inp))
            outs.append((local + remote).reshape(K, rpp, dd))
            for side, plan, inp in (("local", part.local_fwd, xs[p]),
                                    ("remote", part.remote_fwd, recv)):
                kern = B.dispatch(plan)
                bound = _bound(plan, dd)
                csr = _plan_csr(plan)
                row = {"plan": f"{what} part {p} {side}", "d": dd,
                       "shape": [plan.n_rows, plan.n_cols, dd],
                       "nnz": plan.nnz, "max_row_nnz": plan.max_row_nnz,
                       "ms": _time_ms(lambda: kern(plan, inp)),
                       "plain_ms": _time_ms(
                           lambda: B.bsr_spmm_csr_plain(plan, inp),
                           iters=5, warmup=1),
                       "library_ms": _time_ms(
                           lambda: torch.sparse.mm(csr, inp)),
                       "library_dtype": "f32",
                       "bound_ms": bound["bound_ms"],
                       "bound_by": bound["bound_by"], **_schedule(plan, dd),
                       **_compare(f"{tag} {what} part {p} {side}",
                                  kern.__name__, plan, inp)}
                rows.setdefault(kern.__name__, []).append(row)
                _phase(tag, kernel=kern.__name__, **row,
                       library="torch.sparse.mm (CSR)")
        got = torch.cat(outs, dim=1)[:, :n_nodes].reshape(-1, dd)
        ref = B.bsr_spmm_csr_plain(ref_plan, x[:n_nodes])
        err = _check_close(f"{tag} {what} d={dd} parts' sum", got, ref)
        _phase(tag, check=f"{what} parts' sum against the unpartitioned "
               "product", d=dd, max_abs_err=err,
               tolerance=f"rtol {RTOL} + atol {ATOL_REL} * max|plain|")
        for kern_rows in rows.values():
            for row in kern_rows:
                if row["d"] == dd:
                    row["max_abs_err"] = err
    return rows


def phase_kernels_halo(cfg_core, cfg_gcn, dev):
    """The halo plans of Enron snapshot 000 (N = 87,036) at ``HALO_PARTS``
    parts: ``partition_pyramid_halo`` of its core pyramid (CTGCN-C's
    ``graph_partition`` path) and ``partition_graph_halo`` of GCN's
    D^-1 (A + I); the host seconds, rpp, H, each part's local and remote
    nonzeros and the bytes a real exchange ships a part (P·H·d·4); then
    every part's products on the card (``_halo_rows``) at d = 500 and 128.
    Returns the rows by kernel name."""
    import scipy.sparse as sp

    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.parallel.core_partition import partition_pyramid_halo
    from ctgcn_torch.parallel.graph_partition import partition_graph_halo
    from ctgcn_torch.training.driver import get_data_loader

    rows = {}
    widths = _spmm_widths(cfg_core, B.D_ALIGN)
    for what, cfg in (("pyramid", cfg_core), ("gcn", cfg_gcn)):
        args = dict(cfg)
        loader = get_data_loader(args)
        n = loader.node_num
        if what == "pyramid":
            mats = loader.get_core_scipy_list(args["core_base_path"], 0, 1,
                                              max_core=args["max_core"])[0]
            t0 = time.time()
            plan = partition_pyramid_halo(mats, n, HALO_PARTS)
            host_s = time.time() - t0
            ref = sp.vstack([d.tocsr() for d in _kept_deltas(mats)]
                            + [sp.csr_matrix((n, n))]
                            * (plan.num_slots - int(plan.valid.sum())))
        else:
            ref = loader.get_scipy_adj_list(
                args["origin_base_path"], 0, 1, normalize=True,
                row_norm=True, add_eye=True)[0]
            t0 = time.time()
            plan = partition_graph_halo(ref, HALO_PARTS)
            host_s = time.time() - t0
        t0 = time.time()
        host_parts = [plan.part(p) for p in range(plan.parts)]
        _phase("kernels_halo", what=what, n_nodes=n, parts=plan.parts,
               partition_host_seconds=host_s,
               part_plans_host_seconds=time.time() - t0,
               rows_per_part=plan.rows_per_part, halo_width=plan.halo_width,
               num_slots=host_parts[0].num_slots,
               local_nnz=[h.local_fwd.nnz for h in host_parts],
               remote_nnz=[h.remote_fwd.nnz for h in host_parts],
               exchange_bytes_per_part={
                   dd: plan.parts * plan.halo_width * dd * 4
                   for dd in widths},
               dispatch=[[B.dispatch(h.local_fwd).__name__,
                          B.dispatch(h.remote_fwd).__name__]
                         for h in host_parts])
        for name, kern_rows in _halo_rows("kernels_halo", what, plan, ref, n,
                                          widths, dev).items():
            rows.setdefault(name, []).extend(kern_rows)
    return rows


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _csv_arrays(emb):
    from ctgcn_torch.data.formats import read_embedding_csv

    folder = Path(emb["base_path"]) / emb["embed_folder"]
    return {f: read_embedding_csv(folder / f)[1]
            for f in sorted(os.listdir(folder))}


def _halo_kernels(method, cfg, snapshots):
    """The kernels ``dispatch`` gives the one-part plans of the first
    ``snapshots`` snapshots of ``cfg`` as one window (what the [dist] path
    must launch)."""
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.parallel.dist import Parts
    from ctgcn_torch.training.driver import _halo_adjacency, get_data_loader

    args = dict(cfg)
    loader = get_data_loader(args)
    hparts = _halo_adjacency(method, 0, snapshots, loader, args,
                             Parts(1, 0))
    return sorted({B.dispatch(p).__name__ for h in hparts
                   for p in (h.local_fwd, h.local_t, h.remote_fwd,
                             h.remote_t)})


def _csv_gap(got, ref):
    """(max abs difference, share of elements beyond rtol 1e-3 / atol
    1e-4) between two runs' CSVs."""
    import numpy as np

    if list(got) != list(ref) or not ref:
        raise AssertionError(f"CSVs {list(got)} against {list(ref)}")
    diffs = [np.abs(got[f] - ref[f]) for f in ref]
    beyond = [~np.isclose(got[f], ref[f], rtol=1e-3, atol=1e-4) for f in ref]
    return (max(float(d.max()) for d in diffs),
            float(np.mean(np.concatenate([b.ravel() for b in beyond]))))


def _weight_gaps(emb_a, emb_b):
    """How two runs' trained model files differ: the weights, those more
    than the learning rate apart (a step of Adam's that went the other
    way), and the largest gap among the rest."""
    import torch

    from ctgcn_torch.training.engine import read_model_file

    def load(emb):
        folder = Path(emb["base_path"]) / emb["model_folder"]
        return read_model_file(folder / emb["model_file"], "cpu")

    a, b = load(emb_a), load(emb_b)
    if list(a) != list(b):
        raise AssertionError(f"model files' keys {list(a)} / {list(b)}")
    gaps = torch.cat([(a[k] - b[k]).abs().reshape(-1) for k in a])
    apart = gaps > emb_a["lr"]
    return {"weights": int(gaps.numel()),
            "weights_more_than_lr_apart": int(apart.sum()),
            "max_gap_of_other_weights": float(gaps[~apart].max())}


@contextlib.contextmanager
def _nccl_group_of_one(dev):
    """An NCCL process group of world size 1, joined through the port's own
    ``init_from_env`` (localhost, a free port), destroyed on exit."""
    import torch.distributed as dist

    from ctgcn_torch.parallel.dist import init_from_env

    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not init_from_env(dev):
            raise AssertionError("init_from_env did not start a group")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"group {dist.get_backend()} of "
                                 f"{dist.get_world_size()}")
        _phase("dist", backend=dist.get_backend(),
               world_size=dist.get_world_size(), port=env["MASTER_PORT"])
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_dist(runs, dev):
    """The CLI's partitioned path on the NCCL process group of world size
    1 (``_nccl_group_of_one``).  Each of ``runs`` is (path, method, the
    snapshots it covers, and the configs "plain", "rerun" (the plain run
    again), "halo" (``DIST_KEYS`` added) and "replay" (the halo path, 0
    epochs, loading the plain run's model file)); each config runs
    through the CLI with the launch counters set to 0 just before and
    read just after.  The halo run takes the partitioned path on one part
    with a real ``all_to_all_single``: its epoch losses must
    lie within 1e-4 of the plain run's.  Its CSVs after training are
    reported beside the plain run's but not held to them: Adam's first
    step moves every parameter by lr whatever its gradient's size, so a
    gradient that rounding puts on either side of 0 moves a weight by 2·lr
    between two runs that differ only in summation order, and at UCI's
    full width some exported values then differ by more than rtol 1e-3.
    Beside that gap are reported the rerun's (the same path twice) and the
    weights of the two trained model files that lie more than lr apart
    (the flipped steps) against the largest gap of the rest.  The replay's
    CSVs, the halo path's export of the plain run's trained model, are
    held to the plain run's at rtol 1e-3 / atol 1e-4.  Returns the
    launches by path (the halo runs)."""
    import numpy as np

    launches = {}
    for path, method, snapshots, cfgs in runs:
        want = _halo_kernels(method, cfgs["halo"][2], snapshots)
        out, losses = {}, {}
        for tag in DIST_RUNS:
            cfg = cfgs[tag]
            res, wall, counts, peak, _ = _run_cli_counted(cfg[0], method,
                                                          dev)
            ran = sorted(k for k, v in counts.items() if v)
            if ran != ([] if tag in ("plain", "rerun") else want):
                raise AssertionError(f"{path} {tag}: launched {counts}")
            if tag in ("halo", "replay") and [(r["parts"],
                                               r["core_backend"])
                                   for r in res] != [(1, "halo")] * len(
                                       res):
                raise AssertionError(f"{path} {tag}: {res}")
            losses[tag] = [l for r in res for l in r["losses"]]
            if not np.isfinite(losses[tag]).all():
                raise AssertionError(f"{path} {tag}: losses "
                                     f"{losses[tag]}")
            out[tag] = _csv_arrays(cfg[2])
            _phase("dist", path=path, run=tag, method=method,
                   windows=len(res), seconds=wall,
                   epoch_ms=[[1e3 * e for e in r["epoch_seconds"]]
                             for r in res],
                   losses=losses[tag], launches=counts,
                   max_memory_allocated=peak)
            if tag == "halo":
                launches[path] = counts
        np.testing.assert_allclose(losses["halo"], losses["plain"],
                                   rtol=1e-4, err_msg=f"{path} losses")
        trained = _csv_gap(out["halo"], out["plain"])
        rerun = _csv_gap(out["rerun"], out["plain"])
        weights = _weight_gaps(cfgs["plain"][2], cfgs["halo"][2])
        replay = _csv_gap(out["replay"], out["plain"])
        for f in out["plain"]:
            np.testing.assert_allclose(out["replay"][f], out["plain"][f],
                                       rtol=1e-3, atol=1e-4,
                                       err_msg=f"{path} replay {f}")
        _phase("dist", path=path, check="halo runs against the plain "
               "run", csvs=len(out["plain"]),
               loss_max_rel_gap=max(
                   abs(a - b) / abs(b)
                   for a, b in zip(losses["halo"], losses["plain"])),
               trained_csv_max_abs_gap=trained[0],
               trained_csv_share_beyond_tolerance=trained[1],
               rerun_csv_max_abs_gap=rerun[0],
               rerun_csv_share_beyond_tolerance=rerun[1], **weights,
               replay_csv_max_abs_err=replay[0],
               tolerance="losses rtol 1e-4; replay CSVs rtol 1e-3, "
                         "atol 1e-4")
    return launches


#: [pipeline]: the steps of each side, and the tolerance against the plain
#: forward (rtol, and atol of that share of the largest reference value)
PIPELINE_STEPS = 3
PIPELINE_TOL = 1e-4


def _ring_shift_check(parts, rows, width, dev):
    """What ``ring_shift`` carries on the NCCL group of one, at a
    microbatch's carry shape [rows, width]: part 0 is its own next and
    previous part, so a GRU's h and an LSTM's (h, c) must come back
    bit-equal, and the backward must hand the incoming gradients back
    bit-equal.  (Inside the pipeline stage 0 replaces what it receives by
    the zero carry, so the phase's output checks cannot see it.)  Returns
    the collectives made."""
    import torch

    from ctgcn_torch.parallel import dist as pdist

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn():
        return torch.randn(rows, width, generator=gen, device=dev)

    anchor = torch.zeros((), device=dev, requires_grad=True)
    calls = pdist.ring_shift.calls
    for carry in ((randn(),), (randn(), randn())):
        leaves = tuple(c.clone().requires_grad_(True) for c in carry)
        out = pdist.ring_shift(leaves if len(leaves) > 1 else leaves[0],
                               parts, anchor)
        out = out if isinstance(out, tuple) else (out,)
        grads = tuple(randn() for _ in out)
        torch.autograd.backward(out, grads)
        for name, got, want in (("carry", out, carry),
                                ("gradient", tuple(x.grad for x in leaves),
                                 grads)):
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"ring_shift of {len(carry)} "
                                     f"tensor(s): the {name} changed")
    return pdist.ring_shift.calls - calls


def phase_pipeline(cfg, dev):
    """``temporal_pipeline``'s forward at full width, on the NCCL group of
    one (``_nccl_group_of_one``): window 0 of ``cfg`` (``configs/as.json``
    CTGCN-C on the AS copy) through ``ctgcn_pipelined_forward`` on one
    stage, K = ``pick_microbatch(N, 1)`` microbatches and a real ring
    ``all_to_all_single`` at every tick, beside the plain ``CTGCN``
    forward of the same model.  Each side runs a U-neg loss backward on
    the first batch ``PIPELINE_STEPS`` times (the sampler's generator
    seeded 0 each time), the launch counters set to 0 just before and read
    just after.  The pipeline's outputs, loss and every gradient must lie
    within ``PIPELINE_TOL`` of the plain run's, its launches must equal
    the plain run's and reach both f32 kernels, and its forward must make
    K + P - 1 exchanges; then ``_ring_shift_check`` at the microbatch's
    carry shape.  Returns the pipeline's launches."""
    import numpy as np
    import torch

    from ctgcn_torch.losses import negative_sampling_loss
    from ctgcn_torch.parallel import dist as pdist
    from ctgcn_torch.parallel.pipeline import (ctgcn_pipelined_forward,
                                               pick_microbatch)
    from ctgcn_torch.training.driver import build_trainer, get_data_loader
    from ctgcn_torch.training.engine import batch_matrix

    t0 = time.time()
    args = dict(cfg)
    loader = get_data_loader(args)
    T = min(args["duration"], loader.max_time_num)
    trainer = build_trainer("CTGCN-C", args, loader, 0, T, dev,
                            torch.Generator().manual_seed(0))
    model, data = trainer.model, trainer.data
    parts = pdist.make_parts(1)
    if parts.local:
        raise AssertionError("[pipeline] needs the process group")
    k = pick_microbatch(loader.node_num, parts.count)
    batches, masks = batch_matrix(loader.node_num, args["batch_size"],
                                  rng=np.random.default_rng(0))
    b_idx = torch.from_numpy(batches[0]).to(dev)
    b_mask = torch.from_numpy(masks[0]).to(dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    forwards = {
        "plain": lambda: model(data["xs"], data["adjs"]),
        "pipeline": lambda: ctgcn_pipelined_forward(
            model, data["xs"], data["adjs"], parts, n_microbatch=k)}
    runs = {}
    for tag, forward in forwards.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_launches()
        steps, exchanges = [], []
        for _ in range(PIPELINE_STEPS):
            model.zero_grad(set_to_none=True)
            gen = torch.Generator(device=dev).manual_seed(0)
            t_step = time.time()
            calls = pdist.ring_shift.calls
            out = forward()
            fwd_calls = pdist.ring_shift.calls - calls
            loss = negative_sampling_loss(out, b_idx, b_mask, data["walk"],
                                          gen, neg_num=args["neg_num"],
                                          Q=args["Q"])
            loss.backward()
            torch.cuda.synchronize()
            steps.append(1e3 * (time.time() - t_step))
            exchanges.append((fwd_calls,
                              pdist.ring_shift.calls - calls - fwd_calls))
        runs[tag] = {
            "out": out.detach(), "loss": float(loss.detach()),
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "launches": _launches(),
            "peak": torch.cuda.max_memory_allocated(dev), "step_ms": steps,
            "exchanges": exchanges}
    plain, pipe = runs["plain"], runs["pipeline"]
    out_err = _check_close("pipeline embeddings", pipe["out"], plain["out"],
                           rtol=PIPELINE_TOL, atol_rel=PIPELINE_TOL)
    grad_err = max(_check_close(f"pipeline grad {n}", g, plain["grads"][n],
                                rtol=PIPELINE_TOL, atol_rel=PIPELINE_TOL)
                   for n, g in pipe["grads"].items())
    loss_gap = abs(pipe["loss"] - plain["loss"]) / abs(plain["loss"])
    if not loss_gap <= PIPELINE_TOL:
        raise AssertionError(f"pipeline loss {pipe['loss']} against "
                             f"{plain['loss']}")
    if (pipe["launches"] != plain["launches"]
            or not all(pipe["launches"][n] for n in F32_KERNELS)):
        raise AssertionError(f"pipeline launches {pipe['launches']}, plain "
                             f"{plain['launches']}")
    want = k + parts.count - 1
    if any(fwd != want for fwd, _ in pipe["exchanges"]):
        raise AssertionError(f"pipeline exchanges {pipe['exchanges']}, "
                             f"want {want} a forward")
    shift_calls = _ring_shift_check(parts, loader.node_num // k,
                                    model.rnn.hidden_dim, dev)
    _phase("pipeline", path="as_pipeline", method="CTGCN-C", time_length=T,
           nodes=loader.node_num, core_backend=data["adjs"].backend,
           parts=parts.count, microbatches=k,
           bubble=(parts.count - 1) / (parts.count + k - 1),
           setup_seconds=setup_s,
           exchanges_forward_backward=pipe["exchanges"],
           step_ms={t: r["step_ms"] for t, r in runs.items()},
           max_memory_allocated={t: r["peak"] for t, r in runs.items()},
           launches={t: r["launches"] for t, r in runs.items()},
           losses={t: r["loss"] for t, r in runs.items()},
           loss_rel_gap=loss_gap, embeddings_max_abs_err=out_err,
           grads_max_abs_err=grad_err,
           tolerance=f"rtol {PIPELINE_TOL}, atol {PIPELINE_TOL} * max|ref|",
           ring_shift="h and (h, c) of [%d, %d] and their gradients "
                      "bit-equal through the group of one, %d collectives"
                      % (loader.node_num // k, model.rnn.hidden_dim,
                         shift_calls))
    return pipe["launches"]


#: epochs of the traced CLI run: the tracer's window is epochs 1-3
TRACE_EPOCHS = 4
#: [remat]: gradients of "save_spmm" within this share of max|g| of
#: "full"'s
REMAT_GRAD_TOL = 1e-5
#: [window_tail]: epochs a side, and the largest relative loss gap
TAIL_EPOCHS = 3
TAIL_LOSS_TOL = 1e-5


def phase_trace(path, cfg, dev):
    """``profile_dir`` through the CLI: ``run_path``'s checks on the
    traced run (``cfg``: AS window 0 CTGCN-C as configs/as.json gives it,
    ``TRACE_EPOCHS`` epochs, ``profile_dir`` under the work directory),
    then exactly one trace in the directory, whose "epoch" ranges are
    epochs 1-3 and whose device events hold both f32 kernels.  Returns
    the run's launches."""
    cfg_path, _, emb = cfg
    t0 = time.time()
    launches, results, _ = run_path(path, cfg, "CTGCN-C", "ell",
                                    tuple(F32_KERNELS), dev)
    seconds = time.time() - t0
    traces = sorted(Path(emb["profile_dir"]).iterdir())
    if len(traces) != 1:
        raise AssertionError(f"[trace]: {len(traces)} traces, want 1")
    with open(traces[0]) as fp:
        events = json.load(fp)["traceEvents"]
    # the program's "epoch" spans, host ranges entered from C++ ("cpu_op";
    # a Python record_function's would be "user_annotation")
    epochs = sum(1 for e in events if e.get("name") == "epoch"
                 and e.get("cat") in ("user_annotation", "cpu_op"))
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kernels)
             for k in ("rowwalk", "blockpar")}
    if epochs != 3 or not all(found.values()):
        raise AssertionError(f"[trace]: {epochs} epoch ranges (want 3, "
                             f"epochs 1-3), kernel events {found}")
    _phase("trace", path=path, seconds=seconds, epochs=TRACE_EPOCHS,
           trace=traces[0].name, trace_bytes=traces[0].stat().st_size,
           epoch_ranges=epochs, device_kernel_events=len(kernels),
           kernel_events_ours=found,
           epoch_seconds=results[0]["epoch_seconds"], launches=launches)
    return launches


def phase_remat(cfg, dev):
    """``remat_policy`` on the card: window 0 of ``cfg`` (AS CTGCN-C as
    configs/as.json gives it) with ``act_budget`` 0, so the backward
    recomputes every timestep: "full" (the whole step) against
    "save_spmm" (the MLP and each layer's tail, keeping the slot
    products), on one model.  A warm-up step each, then one step each
    (forward, U-neg loss on the first batch, backward; the sampler seeded
    0), timed on the host clock to a synchronise, with its peak memory and
    the launches of the forward plans' kernels ([K·N, N] plans) inside the
    backward.  The losses must be equal, the gradients within
    ``REMAT_GRAD_TOL`` · max|g|, and the backward must launch forward-plan
    kernels under "full" and none under "save_spmm".  Returns the
    launches of the timed steps."""
    import numpy as np
    import torch

    from ctgcn_torch.losses import negative_sampling_loss
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.training.driver import build_trainer, get_data_loader
    from ctgcn_torch.training.engine import batch_matrix

    args = dict(cfg)
    loader = get_data_loader(args)
    T = min(args["duration"], loader.max_time_num)
    trainer = build_trainer("CTGCN-C", args, loader, 0, T, dev,
                            torch.Generator().manual_seed(0))
    model, data = trainer.model, trainer.data
    model.act_budget = 0
    batches, masks = batch_matrix(loader.node_num, args["batch_size"],
                                  rng=np.random.default_rng(0))
    b_idx = torch.from_numpy(batches[0]).to(dev)
    b_mask = torch.from_numpy(masks[0]).to(dev)
    raw = B.block_spmm_raw
    phase = {"name": "forward"}
    fwd_plan_calls = {"forward": 0, "backward": 0}

    def counted(plan, x):
        if plan.n_rows > plan.n_cols:
            fwd_plan_calls[phase["name"]] += 1
        return raw(plan, x)

    def step(policy):
        model.remat_policy = policy
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        phase["name"] = "forward"
        loss = negative_sampling_loss(
            model(data["xs"], data["adjs"]), b_idx, b_mask, data["walk"],
            gen, neg_num=args["neg_num"], Q=args["Q"])
        phase["name"] = "backward"
        loss.backward()
        return loss

    runs, total = {}, {name: 0 for name in KERNELS}
    B.block_spmm_raw = counted
    try:
        for policy in ("full", "save_spmm"):
            step(policy)
        for policy in ("full", "save_spmm"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _zero_launches()
            for key in fwd_plan_calls:
                fwd_plan_calls[key] = 0
            t0 = time.time()
            loss = step(policy)
            torch.cuda.synchronize()
            runs[policy] = {
                "step_ms": 1e3 * (time.time() - t0),
                "loss": float(loss.detach()),
                "peak": torch.cuda.max_memory_allocated(dev),
                "forward_plan_launches": dict(fwd_plan_calls),
                "launches": _launches(),
                "grads": {n: p.grad.detach().clone()
                          for n, p in model.named_parameters()}}
            for name, n in runs[policy]["launches"].items():
                total[name] += n
    finally:
        B.block_spmm_raw = raw
    full, save = runs["full"], runs["save_spmm"]
    scale = max(float(g.abs().max()) for g in full["grads"].values())
    grad_err = max(float((save["grads"][n] - g).abs().max())
                   for n, g in full["grads"].items())
    _phase("remat", path="as_remat", method="CTGCN-C", time_length=T,
           nodes=loader.node_num, num_slots=int(data["adjs"].valid.shape[1]),
           core_backend=data["adjs"].backend,
           **{f"{k}_by_policy": {p: r[k] for p, r in runs.items()}
              for k in ("step_ms", "loss", "peak", "forward_plan_launches",
                        "launches")},
           grads_max_abs_err=grad_err, grads_max_abs=scale,
           tolerance=f"{REMAT_GRAD_TOL} * max|g|")
    if save["loss"] != full["loss"]:
        raise AssertionError(f"[remat] losses {save['loss']} against "
                             f"{full['loss']}")
    if not grad_err <= REMAT_GRAD_TOL * scale:
        raise AssertionError(f"[remat] gradients {grad_err:.3e} apart")
    if (save["forward_plan_launches"]["backward"] != 0
            or full["forward_plan_launches"]["backward"] == 0):
        raise AssertionError(f"[remat] forward-plan launches in the "
                             f"backward: full {full['forward_plan_launches']},"
                             f" save_spmm {save['forward_plan_launches']}")
    return total


def phase_window_tail(cfg, dev):
    """``batch_window_tail`` on the card: window 0 of ``cfg`` (UCI CTGCN-C
    as configs/uci.json gives it, blocks backend), off then on, on one
    trainer: a warm-up epoch, then from the same initial parameters
    ``TAIL_EPOCHS`` epochs each (host clock), then one epoch under
    ``torch.profiler`` for the device time and the kernel launches.  The
    losses must agree within ``TAIL_LOSS_TOL`` relative.  Returns the
    launches of our kernels (the blocks backend runs none)."""
    import copy

    import numpy as np
    import torch


    trainer, kw = _trainer("CTGCN-C", cfg, dev)
    model = trainer.model
    if trainer.data["adjs"].backend != "blocks":
        raise AssertionError(f"[window_tail] backend "
                             f"{trainer.data['adjs'].backend}")
    init = copy.deepcopy(model.state_dict())
    _zero_launches()
    runs = {}
    for tail in (False, True):
        model.batch_window_tail = tail
        # the first epochs on a fresh trainer run slower (UCI's path
        # epochs: 333, 341, then 212 ms)
        trainer.learn_embedding(epoch=1, **kw)
        model.load_state_dict(init)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        res = trainer.learn_embedding(epoch=TAIL_EPOCHS, **kw)
        peak = torch.cuda.max_memory_allocated(dev)
        epoch_ms = [1e3 * s for s in res["epoch_seconds"]]
        per_kernel, profiled_ms = _device_epochs(trainer, kw, 1)
        busy = sum(ms for ms, _ in per_kernel.values())
        steady = float(np.median(epoch_ms))
        runs["on" if tail else "off"] = {
            "losses": res["losses"], "epoch_ms": epoch_ms,
            "epoch_ms_profiled": profiled_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / steady),
            "kernel_launches": sum(n for _, n in per_kernel.values()),
            "peak": peak}
    launches = _launches()
    off, on = runs["off"]["losses"], runs["on"]["losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(on, off))
    _phase("window_tail", path="uci_window_tail", method="CTGCN-C",
           time_length=int(trainer.data["adjs"].valid.shape[0]),
           num_slots=int(trainer.data["adjs"].valid.shape[1]),
           loss_rel_gap=gap, tolerance=TAIL_LOSS_TOL, launches=launches,
           **{k: {t: r[k] for t, r in runs.items()}
              for k in runs["off"]})
    if not gap <= TAIL_LOSS_TOL:
        raise AssertionError(f"[window_tail] losses {on} against {off}")
    return launches


def _check_bf16(name, got, ref_f32, out_dtype):
    """A bf16 kernel's output against its plain version's f32 sum: a bf16
    output within one bf16 ulp of the plain value (the plain version
    rounds that sum once; the kernel's sum, taken in another order, may
    round to the neighbour) plus ATOL_REL * max|plain|; an f32 output at
    RTOL and ATOL_REL."""
    import torch

    if out_dtype == torch.float32:
        return _check_close(name, got, ref_f32)
    ref = ref_f32.bfloat16().float()
    got = got.float()
    err = (got - ref).abs()
    tol = BF16_ULP * ref.abs() + ATOL_REL * float(ref.abs().max())
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        raise AssertionError(f"{name}: max abs err {float(err.max()):.3e} "
                             "over one bf16 ulp + atol")
    return float(err.max())


def _library_ms(plan, x):
    """``torch.sparse.mm``'s time on ``plan`` and x: in bf16 where cuSPARSE
    takes it, else in f32.  Returns (ms, dtype name)."""
    import torch

    csr = torch.sparse_csr_tensor(plan.csr_ptr.long(), plan.csr_col.long(),
                                  plan.csr_val.bfloat16(),
                                  (plan.n_rows, plan.n_cols),
                                  check_invariants=False)
    try:
        torch.sparse.mm(csr, x)
        torch.cuda.synchronize()
        return _time_ms(lambda: torch.sparse.mm(csr, x)), "bf16"
    except RuntimeError:
        csr32, x32 = _plan_csr(plan), x.float()
        return _time_ms(lambda: torch.sparse.mm(csr32, x32)), "f32"


def phase_kernels_bf16(cfg, as_plans, dev):
    """Both bf16 instantiations, with bf16 and with f32 out, on the Enron
    window's delta plans of snapshot ``ENRON_SNAPSHOT`` (forward and
    transpose) and on the AS ones, at d = 504 and 128 (the widths bf16
    ``ell_spmm`` runs: hid 500 padded to a multiple of 8, embed 128),
    against their plain version; then on every plan at every width the
    time of each with the out dtype the path uses there (bf16 forward, f32
    transpose: the backward's dx), beside the f32 kernel's on the same plan
    and width, ``torch.sparse.mm``'s and the bound (2-byte x rows, 8 bytes
    of (col, val) a nonzero, out at 2 or 4 bytes).  Returns each kernel's
    row on the plan its path gives it (the row walk on as_bf16's forward,
    the block-parallel kernel on Enron's forward) at d = 504, and every
    time."""
    import torch

    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.training.driver import get_data_loader

    args = dict(cfg)
    loader = get_data_loader(args)
    t0 = time.time()
    pyr = loader.get_core_adj_list(args["core_base_path"], 0,
                                   args["duration"],
                                   dense_dtype=torch.bfloat16)
    built_s = time.time() - t0
    if pyr.backend != "ell" or not pyr.ell_bf16:
        raise AssertionError(f"auto chose {pyr.backend} (bf16 "
                             f"{pyr.ell_bf16}) at Enron, not bf16 ELL")
    # the enron_bf16 path expects the block-parallel kernel alone
    chosen = {B.dispatch(p, bf16=True).__name__
              for p in pyr.ell_fwd + pyr.ell_t}
    if chosen != set(PATHS["enron_bf16"][3]):
        raise AssertionError(f"dispatch gives {chosen} on the Enron plans")
    fwd = pyr.ell_fwd[ENRON_SNAPSHOT]
    _phase("kernels_bf16", window_plans_built_seconds=built_s,
           n_nodes=pyr.n_nodes, num_slots=pyr.num_slots,
           kept_slots=pyr.valid.sum(1).tolist(),
           nnz=[p.nnz for p in pyr.ell_fwd],
           forward_rows=fwd.n_rows, csr_ptr_max=int(fwd.csr_ptr[-1]),
           max_row_nnz_fwd=[p.max_row_nnz for p in pyr.ell_fwd],
           max_row_nnz_t=[p.max_row_nnz for p in pyr.ell_t],
           dispatch=sorted(chosen))
    plans = {"enron_forward": fwd.to(dev),
             "enron_transpose": pyr.ell_t[ENRON_SNAPSHOT].to(dev),
             "as_forward": as_plans["forward"],
             "as_transpose": as_plans["transpose"]}
    del pyr
    widths = _spmm_widths(args, B.D_ALIGN_BF16)
    gen = torch.Generator(device=dev).manual_seed(2)
    inputs = {k: torch.randn(p.n_cols, max(widths), device=dev,
                             generator=gen).bfloat16()
              for k, p in plans.items()}
    out_of = {k: torch.bfloat16 if k.endswith("forward") else torch.float32
              for k in plans}
    errs = {}
    for name in BF16_KERNELS:
        kern = getattr(B, name)
        for pk, plan in plans.items():
            for dd in widths:
                inp = inputs[pk][:, :dd].contiguous()
                ref = B.bsr_spmm_csr_plain_bf16(plan, inp, torch.float32)
                for od in (torch.bfloat16, torch.float32):
                    got = kern(plan, inp, od)
                    _check_rerun(f"kernels_bf16 {name} {pk} d={dd} {od}", got,
                                 kern(plan, inp, od))
                    err = _check_bf16(f"kernels_bf16 {name} {pk} d={dd} {od}",
                                      got, ref, od)
                    errs[name, pk, dd, od] = (
                        err, err / float(ref.abs().max()))
    torch.cuda.synchronize()
    main = {"bsr_spmm_rowwalk_bf16": "as_forward",
            "bsr_spmm_blockpar_bf16": "enron_forward"}
    results, times = {}, {name: [] for name in BF16_KERNELS}
    for pk, plan in plans.items():
        od = out_of[pk]
        out_bytes = 2 if od == torch.bfloat16 else 4
        for dd in widths:
            inp = inputs[pk][:, :dd].contiguous()
            x32 = inp.float()
            bound = _bound(plan, dd, x_bytes=2, out_bytes=out_bytes)
            library_ms, library_dtype = _library_ms(plan, inp)
            plain_ms = _time_ms(
                lambda: B.bsr_spmm_csr_plain_bf16(plan, inp, od), iters=5,
                warmup=1)
            for name in BF16_KERNELS:
                kern = getattr(B, name)
                f32 = getattr(B, name[:-len("_bf16")])
                row = {"plan": pk, "d": dd, "out": str(od)[6:],
                       "ms": _time_ms(lambda: kern(plan, inp, od)),
                       "f32_kernel_ms": _time_ms(lambda: f32(plan, x32)),
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "library_dtype": library_dtype,
                       "bound_ms": bound["bound_ms"],
                       "bound_by": bound["bound_by"],
                       "dispatched": B.dispatch(plan, bf16=True) is kern,
                       **_schedule(plan, dd, bf16=True),
                       **_compare(f"kernels_bf16 {pk}", name, plan, inp, od)}
                times[name].append(row)
                if main[name] == pk and dd == widths[0]:
                    err, rel = errs[name, pk, dd, od]
                    results[name] = {
                        "plan": pk, "shape": [plan.n_rows, plan.n_cols, dd],
                        "nnz": plan.nnz, "max_row_nnz": plan.max_row_nnz,
                        "max_abs_err": err, **{k: row[k] for k in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "library_dtype", "f32_kernel_ms",
                            "schedule", "lane_groups")}}
                    _phase("kernels_bf16", kernel=name, **results[name],
                           out=row["out"], max_rel_err=rel,
                           library=f"torch.sparse.mm (CSR, {library_dtype})",
                           tolerance="bf16 out: one bf16 ulp + atol "
                                     f"{ATOL_REL} * max|plain|; f32 out: "
                                     f"rtol {RTOL} + atol {ATOL_REL} * "
                                     "max|plain|",
                           x_rows_read=bound["x_rows_read"],
                           flops=bound["flops"], bytes=bound["bytes"])
    for name in BF16_KERNELS:
        results[name]["times"] = times[name]
        _phase("kernels_bf16", kernel=name, times=times[name])
    return results


def _parity_adjacency(rng, n, hub):
    """A sparse random symmetric graph on n nodes whose node 0 has ``hub``
    extra neighbours."""
    import numpy as np
    import scipy.sparse as sp

    dense = (rng.random((n, n)) < 0.002) * rng.random((n, n))
    dense[0, rng.choice(np.arange(1, n), hub, replace=False)] = 1.0
    return sp.csr_matrix(np.triu(dense, 1) + np.triu(dense, 1).T)


def _parity_window(n, T, hub, seed=0):
    """T snapshots of ``_parity_adjacency`` as three nested cores (degree
    >= 4, 2, 1)."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    per_snap = []
    for _ in range(T):
        a = _parity_adjacency(rng, n, hub)
        deg = np.asarray((a != 0).sum(1)).ravel()
        per_snap.append([sp.csr_matrix(a.multiply(np.outer(deg >= k,
                                                           deg >= k)))
                         for k in (4, 2, 1)])
    return per_snap


def phase_parity(dev):
    """A small CTGCN-C (N = 1800, T = 2, K = 3, hid 500), forward and all
    parameter gradients with the kernels on the GPU against the plain
    versions on the CPU, on BSR plans and on delta-ELL plans.  Node 0 is a
    hub, so that some plan's longest row passes ``ROWWALK_MAX_ROW`` and
    both kernels run: degree 150 for the BSR plans (the transpose holds it
    once per slot), 300 for the delta plans (once in all).  Also the
    principal blocks at ``matmul_precision: "high"`` (3xTF32 GEMMs on the
    GPU, full f32 products of the same splits on the CPU)."""
    import torch

    from ctgcn_torch.nn.core_models import CTGCN
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.ops.pyramid import (attach_ell_plans, build_core_pyramid,
                                          stack_pyramids)

    n, T, hid = 1800, 2, 500
    windows = {
        "pallas": stack_pyramids([
            build_core_pyramid(m, n, num_slots=3, build_plans=True)
            for m in _parity_window(n, T, hub=150)]),
        "ell": attach_ell_plans(stack_pyramids([
            build_core_pyramid(m, n, num_slots=3)
            for m in _parity_window(n, T, hub=300)]), delta=True),
        "blocks_high": stack_pyramids([
            build_core_pyramid(m, n, num_slots=3, build_blocks=True,
                               dense_prec="high")
            for m in _parity_window(n, T, hub=150)]),
    }
    for backend, pyr in windows.items():
        if backend == "blocks_high":
            if pyr.backend != "blocks" or pyr.dense_prec != "high":
                raise AssertionError("the high parity model is not on "
                                     "f32 blocks at \"high\"")
        elif pyr.backend != backend or {
                B.dispatch(q).__name__
                for q in (pyr.plan_fwd + pyr.plan_t if backend == "pallas"
                          else pyr.ell_fwd + pyr.ell_t)} != set(F32_KERNELS):
            raise AssertionError(f"the {backend} parity model does not "
                                 "reach both kernels")
        model = CTGCN(n, hid, 64, 1, 2, T,
                      generator=torch.Generator().manual_seed(0))
        out = []
        for d in (torch.device("cpu"), dev):
            m = model.to(d)
            m.zero_grad(set_to_none=True)
            y = m(None, pyr.to(d))
            torch.tanh(y).square().sum().backward()
            out.append((y.detach().cpu(),
                        {k: p.grad.detach().cpu()
                         for k, p in m.named_parameters()}))
        (yc, gc), (yg, gg) = out
        # two GEMM libraries and a deep chain (MLP, 2 x (SpMM, K-step GRU,
        # LayerNorm), time GRU, LayerNorm): f32, but a looser bound than
        # one op
        tol = {"rtol": PARITY_TOL, "atol_rel": PARITY_TOL}
        errs = {"forward": _check_close(f"parity {backend} forward", yg, yc,
                                        **tol)}
        for k in gc:
            errs[k] = _check_close(f"parity {backend} grad {k}", gg[k],
                                   gc[k], **tol)
        _phase("parity", backend=backend, tolerance=PARITY_TOL, n=n, T=T,
               hid=hid, max_abs_err_forward=errs["forward"],
               max_abs_err_grads=max(v for k, v in errs.items()
                                     if k != "forward"))


def phase_parity_zoo(dev):
    """Small GCN and GIN (N = 1800, T = 2, hid 500, embed 64, dropout off),
    forward and all parameter gradients with the kernels on the GPU against
    the plain versions on the CPU, on graphs that carry their plans as the
    zoo's loader gives them: GCN on D^-1 (A + I) of a graph whose node 0
    has degree 300 (both directions on the block-parallel kernel), GIN on
    A + I of one without a hub (both on the row walk)."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp
    import torch

    from ctgcn_torch.nn.gcn import GCN
    from ctgcn_torch.nn.gin import GIN
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.ops.sparse import from_scipy, normalize_scipy_adj

    n, T, hid, out_dim = 1800, 2, 500, 64
    gen = torch.Generator().manual_seed(0)
    models = {
        "gcn": (300, "bsr_spmm_blockpar",
                lambda a: normalize_scipy_adj(a + sp.eye(n), row_norm=True),
                GCN(n, hid, out_dim, dropout=0.5, generator=gen)),
        "gin": (0, "bsr_spmm_rowwalk", lambda a: (a + sp.eye(n)).tocoo(),
                GIN(n, hid, out_dim, 2, 2, learn_eps=False, dropout=0.5,
                    generator=gen)),
    }
    for name, (hub, kernel, adj_of, model) in models.items():
        rng = np.random.default_rng(1)
        graphs = []
        for _ in range(T):
            m = adj_of(_parity_adjacency(rng, n, hub))
            graphs.append(dataclasses.replace(
                from_scipy(m), plan_fwd=B.build_csr_plan(m),
                plan_t=B.build_csr_plan(m.T)))
        chosen = {B.dispatch(g.plan_fwd).__name__ for g in graphs} | {
            B.dispatch(g.plan_t).__name__ for g in graphs}
        if chosen != {kernel}:
            raise AssertionError(f"the {name} parity model reaches {chosen}, "
                                 f"not {kernel}")
        _cpu_against_card(name, model,
                          lambda d: tuple(g.to(d) for g in graphs), dev,
                          kernel=kernel, n=n, T=T, hid=hid)


def _tanh_square(y):
    import torch

    return torch.tanh(y).square().sum()


def _cpu_against_card(name, model, inputs_on, dev, loss=_tanh_square,
                      cpu_dtype=None, xs=None, **fields):
    """Forward and every parameter gradient of ``loss(y)`` (by default
    sum(tanh(y)^2)) for ``model(xs, inputs_on(device))`` on the CPU and
    on the card, within PARITY_TOL: the outputs of their largest, each
    gradient of the model's largest gradient (a bias before a BatchNorm
    has a zero gradient but for rounding).  ``cpu_dtype`` float64 runs
    the CPU side in float64 (the card's stays float32); ``xs`` (host
    features, or None for identity features) go to each side in its
    dtype."""
    import torch

    res = []
    for d in (torch.device("cpu"), dev):
        dtype = (cpu_dtype if d.type == "cpu" and cpu_dtype
                 else torch.float32)
        mod = model.to(d, dtype=dtype)
        mod.zero_grad(set_to_none=True)
        y = mod(None if xs is None else xs.to(d, dtype), inputs_on(d))
        loss(y).backward()
        res.append(({"forward": y.detach().cpu()}, _grads(mod)))
    _compare_sides(name, res,
                   max_abs_forward=float(res[0][0]["forward"].abs().max()),
                   **fields)


def phase_parity_attn(dev):
    """A small GAT (2 heads, N = 1800, T = 2, hid 500, embed 64, dropout
    off) on the kernels through ``ell_spmm_ev``, forward and gradients of
    W and a (so through d(vals) and d(x)), on the card against the CPU:
    on D^-1 (A + I) of a graph whose node 0 has degree 300 (the
    block-parallel kernel) and of one without a hub (the row walk).  Then
    a small SAGE (sum pooling, dropout off) at ``num_sample`` above the
    largest degree, where every node takes all its neighbours and the
    draw is deterministic.

    GAT's loss is sum(y * w) for a fixed normal w, and its CPU side runs
    in float64 through the segment ``spmm_ev`` (the plain version of the
    edge-value product).  Its outputs are log-probabilities near
    -log(64), where tanh saturates: under sum(tanh(y)^2) its gradients
    fall to about 1e-3 with an f32 rounding noise of 4e-7.  And at the
    hub node its gradients are ill-conditioned in f32: the card's lay
    9.0e-4 from the CPU's f32 ones (a largest gradient of 4.2) and 1.1e-6
    from the CPU's float64 ones (NVIDIA H100 80GB HBM3, 700 W)."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp
    import torch

    from ctgcn_torch.nn.gat import GAT
    from ctgcn_torch.nn.sage import SAGE
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.ops.ell import build_ev_plans
    from ctgcn_torch.ops.neighbors import neighbor_table_from_scipy
    from ctgcn_torch.ops.sparse import from_scipy, normalize_scipy_adj

    n, T, hid, out_dim = 1800, 2, 500, 64
    gen = torch.Generator().manual_seed(0)
    for name, hub, kernel in (("gat_hub", 300, "bsr_spmm_blockpar"),
                              ("gat", 0, "bsr_spmm_rowwalk")):
        rng = np.random.default_rng(2)
        graphs = []
        for _ in range(T):
            m = normalize_scipy_adj(_parity_adjacency(rng, n, hub)
                                    + sp.eye(n), row_norm=True)
            g = from_scipy(m)
            fwd, tr = build_ev_plans(g)
            graphs.append(dataclasses.replace(g, plan_fwd=fwd, plan_t=tr))
        chosen = {B.dispatch(p).__name__ for g in graphs
                  for p in (g.plan_fwd, g.plan_t)}
        if chosen != {kernel}:
            raise AssertionError(f"the {name} parity model reaches "
                                 f"{chosen}, not {kernel}")
        model = GAT(n, hid, out_dim, dropout=0.5, head_num=2,
                    generator=gen)
        w = torch.randn(T, n, out_dim, generator=gen, dtype=torch.float64)
        segment = tuple(dataclasses.replace(g, plan_fwd=None, plan_t=None)
                        for g in graphs)
        _cpu_against_card(
            name, model,
            lambda d: segment if d.type == "cpu" else tuple(
                g.to(d) for g in graphs), dev,
            loss=lambda y: (y * w.to(y.device, y.dtype)).sum(),
            cpu_dtype=torch.float64, kernel=kernel, n=n, T=T, hid=hid,
            heads=2, loss_fn="sum(y * w), w normal",
            cpu="float64, segment spmm_ev")
    rng = np.random.default_rng(3)
    nbr, deg = neighbor_table_from_scipy(
        [_parity_adjacency(rng, n, 40) for _ in range(T)])
    model = SAGE(n, hid, out_dim, num_sample=int(deg.max()) + 1,
                 dropout=0.0, generator=gen)
    _cpu_against_card("sage", model, lambda d: (nbr.to(d), deg.to(d)), dev,
                      n=n, T=T, hid=hid, num_sample=int(deg.max()) + 1)


def _jax_layout(model):
    """The model's parameters as the JAX package's tree (nested dicts of
    numpy arrays): GCRN's per-step ``gcns.<t>.*`` stacked on a leading [T]
    axis, as ``GCRN.init`` stacks them."""
    import numpy as np

    flat = {}
    for key, val in model.state_dict().items():
        head, _, rest = key.partition(".")
        if head == "gcns":
            flat.setdefault("gcns." + rest.partition(".")[2], []).append(
                val.numpy())
        else:
            flat[key] = val.numpy()
    tree = {}
    for key, val in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.stack(val) if isinstance(val, list) else val
    return tree


def phase_parity_recurrent(dev):
    """A small GCRN (GRU, N = 1800, T = 2, hid 500, embed 64, dropout off)
    and a small EvolveGCN (EGCNH, 100 normal features, hid 128, embed 64,
    rrelu at its mean slope), forward and every parameter gradient on the
    card through the kernels against the CPU in float64 on the segment
    SpMM (the plain version): GCRN on D^-1 (A + I), EvolveGCN on D^-1/2
    (A + I) D^-1/2, each of a graph whose node 0 has degree 300 (the
    block-parallel kernel, both directions) and of one without a hub (the
    row walk).  The parameters reach the compared model from the JAX
    package's layout through ``params_from_numpy``."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp
    import torch

    from ctgcn_torch.interop import params_from_numpy
    from ctgcn_torch.nn.egcn import EvolveGCN
    from ctgcn_torch.nn.gcn import GCRN
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.ops.ell import build_ev_plans
    from ctgcn_torch.ops.sparse import from_scipy, normalize_scipy_adj

    n, T, hid, out_dim, feat, egcn_hid = 1800, 2, 500, 64, 100, 128
    gen = torch.Generator().manual_seed(0)
    xs = torch.randn(T, n, feat, generator=gen)
    for name, row_norm in (("gcrn", True), ("egcn", False)):
        for hub, kernel in ((300, "bsr_spmm_blockpar"),
                            (0, "bsr_spmm_rowwalk")):
            rng = np.random.default_rng(4)
            graphs = []
            for _ in range(T):
                m = normalize_scipy_adj(_parity_adjacency(rng, n, hub)
                                        + sp.eye(n), row_norm=row_norm)
                g = from_scipy(m)
                fwd, tr = build_ev_plans(g)
                graphs.append(dataclasses.replace(g, plan_fwd=fwd,
                                                  plan_t=tr))
            chosen = {B.dispatch(p).__name__ for g in graphs
                      for p in (g.plan_fwd, g.plan_t)}
            if chosen != {kernel}:
                raise AssertionError(f"the {name} parity model reaches "
                                     f"{chosen}, not {kernel}")
            if name == "gcrn":
                def make(g):
                    return GCRN(n, hid, out_dim, T, dropout=0.5, generator=g)
                x = None
            else:
                def make(g):
                    return EvolveGCN(feat, egcn_hid, out_dim, generator=g)
                x = xs
            model = make(torch.Generator().manual_seed(1))
            carried = make(gen)
            carried.load_state_dict(params_from_numpy(_jax_layout(model)))
            if any(not torch.equal(v, carried.state_dict()[k])
                   for k, v in model.state_dict().items()):
                raise AssertionError(f"parity {name}: params_from_numpy "
                                     "did not carry the parameters")
            segment = tuple(dataclasses.replace(g, plan_fwd=None, plan_t=None)
                            for g in graphs)
            _cpu_against_card(
                f"{name}_{kernel}", carried,
                lambda d: segment if d.type == "cpu" else tuple(
                    g.to(d) for g in graphs), dev,
                cpu_dtype=torch.float64, xs=x, kernel=kernel, n=n, T=T,
                hid=hid if name == "gcrn" else egcn_hid,
                cpu="float64, segment spmm")


def phase_parity_vgrnn(dev):
    """A small VGRNN (GCN convolutions, N = 1800, T = 2, hid 500, embed
    64) over two batches of an epoch as the engine runs them (the second
    starts from the first's h, detached), its noise given: each batch's
    enc_mean, h and VAE loss, and every parameter gradient summed over the
    batches, on the card through the kernels against the CPU in float64
    on the segment SpMM, within PARITY_TOL of their largest.  The
    convolutions read D^-1/2 (A_bin + 2I) D^-1/2 of a graph whose node 0
    has degree 300 (the block-parallel kernel, both directions) and of one
    without a hub (the row walk); the target is the graph's weights in
    (0, 1], so posw and norm come from a sum of weights that is not the
    edge count.  The parameters reach the compared model from the JAX
    package's layout through ``params_from_numpy``."""
    import dataclasses

    import numpy as np
    import torch

    from ctgcn_torch.interop import params_from_numpy
    from ctgcn_torch.losses import vae_loss
    from ctgcn_torch.nn.vgrnn import VGRNN
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.ops.ell import build_ev_plans
    from ctgcn_torch.ops.sparse import from_scipy
    from ctgcn_torch.training.driver import (_vgrnn_forward, _vgrnn_norm,
                                             _vgrnn_state_init)

    n, T, hid, out_dim, batches = 1800, 2, 500, 64, 2
    gen = torch.Generator().manual_seed(0)
    noise = [[torch.randn(n, out_dim, generator=gen) for _ in range(T)]
             for _ in range(batches)]
    for hub, kernel in ((300, "bsr_spmm_blockpar"), (0, "bsr_spmm_rowwalk")):
        rng = np.random.default_rng(5)
        raws = [_parity_adjacency(rng, n, hub) for _ in range(T)]
        graphs = []
        for m in raws:
            g = from_scipy(_vgrnn_norm(m))
            fwd, tr = build_ev_plans(g)
            graphs.append(dataclasses.replace(g, plan_fwd=fwd, plan_t=tr))
        chosen = {B.dispatch(p).__name__ for g in graphs
                  for p in (g.plan_fwd, g.plan_t)}
        if chosen != {kernel}:
            raise AssertionError(f"the vgrnn parity model reaches "
                                 f"{chosen}, not {kernel}")
        segment = tuple(dataclasses.replace(g, plan_fwd=None, plan_t=None)
                        for g in graphs)
        targets = tuple(from_scipy(m) for m in raws)
        model = VGRNN(n, hid, out_dim, generator=torch.Generator()
                      .manual_seed(1))
        carried = VGRNN(n, hid, out_dim, generator=gen)
        carried.load_state_dict(params_from_numpy(_jax_layout(model)))
        if any(not torch.equal(v, carried.state_dict()[k])
               for k, v in model.state_dict().items()):
            raise AssertionError("parity vgrnn: params_from_numpy did not "
                                 "carry the parameters")
        res = []
        for d in (torch.device("cpu"), dev):
            dtype = torch.float64 if d.type == "cpu" else torch.float32
            mod = carried.to(d, dtype=dtype)
            mod.zero_grad(set_to_none=True)
            data = {"xs": None,
                    "vgrnn_adjs": segment if d.type == "cpu" else tuple(
                        g.to(d) for g in graphs),
                    "adjs": tuple(g.to(d) for g in targets)}
            hx = _vgrnn_state_init(mod, data)
            outs = {}
            for b in range(batches):
                em, h, (_, es, pm, ps, z) = _vgrnn_forward(
                    mod, data, hx=hx,
                    noise=[x.to(d, dtype) for x in noise[b]])
                loss = vae_loss(em, es, pm, ps, z, data["adjs"])
                loss.backward()
                hx = h.detach()
                outs.update({f"enc_mean_{b}": em.detach().cpu(),
                             f"h_{b}": hx.cpu(),
                             f"loss_{b}": loss.detach().cpu()})
            res.append((outs, _grads(mod)))
        _compare_sides(
            f"vgrnn_{kernel}", res,
            losses_cpu=[float(res[0][0][f"loss_{b}"])
                        for b in range(batches)],
            losses_card=[float(res[1][0][f"loss_{b}"])
                         for b in range(batches)],
            kernel=kernel, n=n, T=T, hid=hid, batches=batches,
            cpu="float64, segment spmm")


def _compare_sides(name, res, **fields):
    """``res``: [(outputs, gradients) on the CPU, the same on the card],
    dicts of tensors; each output within PARITY_TOL of its largest, each
    gradient of the largest gradient."""
    (oc, gc), (og, gg) = res
    if set(gc) != set(gg) or not gc:
        raise AssertionError(f"parity {name}: gradients of {sorted(gc)} on "
                             f"the CPU, {sorted(gg)} on the card")
    tol = {"rtol": PARITY_TOL, "atol_rel": PARITY_TOL}
    err_f = max(_check_close(f"parity {name} {k}", og[k], oc[k], **tol)
                for k in oc)
    scale = max(float(v.abs().max()) for v in gc.values())
    err_g = max(_check_close(f"parity {name} grad {k}", gg[k], gc[k],
                             scale=scale, **tol) for k in gc)
    _phase("parity", model=name, tolerance=PARITY_TOL,
           max_abs_err_forward=err_f, max_abs_err_grads=err_g,
           max_abs_grad=scale, outputs=sorted(oc), grads=sorted(gc),
           **fields)


def _grads(*modules):
    return {f"{i}.{k}": p.grad.detach().cpu()
            for i, m in enumerate(modules) for k, p in m.named_parameters()
            if p.grad is not None}


def phase_parity_pgnn(dev):
    """A small PGNN (N = 1800, T = 2, three layers, feature 32, hid 32,
    embed 128, dropout off) on the proximity matrices of ``approximate: 2``
    over a sparse random graph, with the same anchor sets on both sides:
    the anchor reduction on the card against the CPU's in float64
    (``dists_argmax`` equal, ``dists_max`` within PARITY_TOL), then the
    forward and every parameter gradient against the CPU in float64, the
    parameters carried over from the JAX layout by
    ``params_from_numpy``."""
    import numpy as np
    import torch

    from ctgcn_torch.interop import params_from_numpy
    from ctgcn_torch.nn.pgnn import (PGNN, anchor_reduce, anchor_sizes,
                                     draw_anchor_sets, precompute_dist_data)

    n, T = 1800, 2
    rng = np.random.default_rng(6)
    edges = []
    for _ in range(T):
        a = _parity_adjacency(rng, n, 0).tocoo()
        edges.append(np.stack([a.row, a.col]).astype(np.int64))
    dists = precompute_dist_data(edges, n, approximate=2)
    gen = torch.Generator().manual_seed(2)
    sets = [draw_anchor_sets(n, anchor_sizes(n), gen) for _ in range(T)]
    sides = ((torch.device("cpu"), torch.float64), (dev, torch.float32))
    reduced = []
    for d, dtype in sides:
        parts = [anchor_reduce(dists[t].to(d, dtype),
                               [a.to(d) for a in sets[t]]) for t in range(T)]
        reduced.append((torch.stack([m for m, _ in parts]),
                        torch.stack([a for _, a in parts])))
    (dm_c, da_c), (dm_g, da_g) = reduced
    if not torch.equal(da_g.cpu(), da_c):
        raise AssertionError("parity pgnn: dists_argmax differs between the "
                             "card and the CPU")
    err_m = _check_close("parity pgnn dists_max", dm_g.cpu(), dm_c,
                         rtol=PARITY_TOL, atol_rel=PARITY_TOL)
    model = PGNN(n, 32, 32, 128, layer_num=3, dropout=0.5,
                 generator=torch.Generator().manual_seed(1))
    carried = PGNN(n, 32, 32, 128, layer_num=3, dropout=0.5, generator=gen)
    carried.load_state_dict(params_from_numpy(_jax_layout(model)))
    if any(not torch.equal(v, carried.state_dict()[k])
           for k, v in model.state_dict().items()):
        raise AssertionError("parity pgnn: params_from_numpy did not carry "
                             "the parameters")
    res = []
    for (d, dtype), (dm, da) in zip(sides, reduced):
        mod = carried.to(d, dtype=dtype)
        mod.zero_grad(set_to_none=True)
        y = mod(None, dm, da)
        _tanh_square(y).backward()
        res.append(({"output": y.detach().cpu()}, _grads(mod)))
    _compare_sides("pgnn", res, max_abs_err_dists_max=err_m,
                   anchor_sets=len(sets[0]), n=n, T=T, layer_num=3,
                   cpu="float64")


def phase_parity_supervised(dev):
    """The zoo's supervised branch on the card against the CPU in float64:
    a small GCN (N = 1800, T = 2, hid 500, embed 64, dropout 0) and its
    ``MLPClassifier`` under S-node, on D^-1 (A + I) of a graph whose node
    0 has degree 300 (the block-parallel kernel) and of one without a hub
    (the row walk): the logits, the loss and every gradient of the model
    and the classifier; then a small VGRNN (hid 500, embed 64) under
    S-link-st through the stateful forward, its noise given, on each
    kernel: the train forward from zeros (logits, loss with its VAE term,
    gradients), the validation forward from the train step's h and the
    test forward from the validation's h (their logits, losses, new h and
    the test forward's embeddings, which the trainer exports)."""
    import dataclasses
    import functools

    import numpy as np
    import scipy.sparse as sp
    import torch

    from ctgcn_torch.interop import params_from_numpy
    from ctgcn_torch.nn.gcn import GCN
    from ctgcn_torch.nn.heads import MLPClassifier
    from ctgcn_torch.nn.vgrnn import VGRNN
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.ops.ell import build_ev_plans
    from ctgcn_torch.ops.sparse import from_scipy, normalize_scipy_adj
    from ctgcn_torch.training import driver as D

    n, T, hid, out_dim, batch = 1800, 2, 500, 64, 300
    gen = torch.Generator().manual_seed(0)
    rows = torch.randint(0, n, (T, batch), generator=gen)
    labels = torch.randint(0, 3, (T, batch), generator=gen)
    mask = torch.rand(T, batch, generator=gen) < 0.9

    def plans(m):
        g = from_scipy(m)
        fwd, tr = build_ev_plans(g)
        return dataclasses.replace(g, plan_fwd=fwd, plan_t=tr)

    def segment(graphs):
        return tuple(dataclasses.replace(g, plan_fwd=None, plan_t=None)
                     for g in graphs)

    for hub, kernel in ((300, "bsr_spmm_blockpar"), (0, "bsr_spmm_rowwalk")):
        rng = np.random.default_rng(7)
        raws = [_parity_adjacency(rng, n, hub) for _ in range(T)]
        graphs = [plans(normalize_scipy_adj(m + sp.eye(n), row_norm=True))
                  for m in raws]
        chosen = {B.dispatch(p).__name__ for g in graphs
                  for p in (g.plan_fwd, g.plan_t)}
        if chosen != {kernel}:
            raise AssertionError(f"the supervised parity model reaches "
                                 f"{chosen}, not {kernel}")
        model = GCN(n, hid, out_dim, dropout=0.0, generator=gen)
        cls = MLPClassifier(out_dim, 64, 3, 1, activate_type="L",
                            generator=gen)
        forward_fn = D._supervised_forward(D.make_forward("GCN"), "S-node",
                                           False)
        loss_fn = D._supervised_loss("GCN")
        res = []
        for d in (torch.device("cpu"), dev):
            dtype = torch.float64 if d.type == "cpu" else torch.float32
            m, c = model.to(d, dtype=dtype), cls.to(d, dtype=dtype)
            m.zero_grad(set_to_none=True)
            c.zero_grad(set_to_none=True)
            data = {"xs": None, "adjs": segment(graphs) if d.type == "cpu"
                    else tuple(g.to(d) for g in graphs)}
            preds, aux = forward_fn(m, c, data, rows.to(d))
            loss, _ = loss_fn(preds, labels.to(d), mask.to(d), aux)
            loss.backward()
            res.append(({"logits": preds.detach().cpu(),
                         "loss": loss.detach().cpu()}, _grads(m, c)))
        _compare_sides(f"gcn_snode_{kernel}", res, kernel=kernel, n=n, T=T,
                       hid=hid, cpu="float64, segment spmm")

        # VGRNN under S-link-st: edges of each snapshot and as many pairs
        edges = torch.stack([torch.from_numpy(np.stack(
            [sp.triu(m, 1).tocoo().row[:batch // 2],
             sp.triu(m, 1).tocoo().col[:batch // 2]], axis=1)).long()
            for m in raws])
        pairs = torch.cat([edges, torch.randint(0, n, edges.shape,
                                                generator=gen)], dim=1)
        link_labels = torch.cat([torch.ones(T, edges.shape[1]),
                                 torch.zeros(T, edges.shape[1])], dim=1)
        link_mask = torch.ones(T, pairs.shape[1], dtype=torch.bool)
        vgraphs = [plans(D._vgrnn_norm(m)) for m in raws]
        targets = tuple(from_scipy(m) for m in raws)
        noise = {k: [torch.randn(n, out_dim, generator=gen)
                     for _ in range(T)] for k in ("train", "val", "test")}
        model = VGRNN(n, hid, out_dim, generator=torch.Generator()
                      .manual_seed(1))
        carried = VGRNN(n, hid, out_dim, generator=gen)
        carried.load_state_dict(params_from_numpy(_jax_layout(model)))
        loss_fn = D._supervised_loss("VGRNN")
        res = []
        for d in (torch.device("cpu"), dev):
            dtype = torch.float64 if d.type == "cpu" else torch.float32
            mod = carried.to(d, dtype=dtype)
            mod.zero_grad(set_to_none=True)
            data = {"xs": None, "adjs": tuple(g.to(d) for g in targets),
                    "vgrnn_adjs": segment(vgraphs) if d.type == "cpu"
                    else tuple(g.to(d) for g in vgraphs)}
            outs, hx = {}, D._vgrnn_state_init(mod, data)
            for split in ("train", "val", "test"):
                fwd = functools.partial(
                    D._vgrnn_forward,
                    noise=[x.to(d, dtype) for x in noise[split]])
                step = D._vgrnn_supervised_forward(fwd, "S-link-st")
                with torch.set_grad_enabled(split == "train"):
                    preds, aux, h, embs = step(mod, None, data,
                                               pairs.to(d), None, hx)
                    loss, _ = loss_fn(preds, link_labels.to(d, dtype),
                                      link_mask.to(d), aux)
                if split == "train":
                    loss.backward()
                hx = h.detach()
                outs.update({f"logits_{split}": preds.detach().cpu(),
                             f"loss_{split}": loss.detach().cpu(),
                             f"h_{split}": hx.cpu()})
            outs["embeddings_test"] = embs.detach().cpu()
            res.append((outs, _grads(mod)))
        _compare_sides(f"vgrnn_slink_{kernel}", res, kernel=kernel, n=n,
                       T=T, hid=hid, pairs=int(pairs.shape[1]),
                       cpu="float64, segment spmm")


def phase_core_numbers(base):
    """The native core numbers against the numpy peel on every snapshot of
    the preprocessed copy at ``base``: equal, with both times."""
    import numpy as np

    from ctgcn_torch.data.formats import (get_sp_adj_mat, read_node_list,
                                          sorted_dir)
    from ctgcn_torch.preprocessing import kcore

    nodes = read_node_list(base / "nodes_set" / "nodes.csv")
    seconds = {"native": 0.0, "numpy": 0.0}
    max_core = []
    for f in sorted_dir(base / "1.format"):
        adj = get_sp_adj_mat(base / "1.format" / f, nodes)
        got = {}
        for side, fn in (("native", kcore.core_numbers),
                         ("numpy", kcore.peel_core_numbers)):
            t0 = time.time()
            got[side] = fn(adj)
            seconds[side] += time.time() - t0
        if not np.array_equal(got["native"], got["numpy"]):
            raise AssertionError(f"core numbers of {base.name}/{f}: native "
                                 "and numpy differ")
        max_core.append(int(got["native"].max()))
    return {"check": "native core numbers equal the numpy peel",
            "data": base.name, "snapshots": len(max_core),
            "max_core": max_core, "native_seconds": seconds["native"],
            "numpy_seconds": seconds["numpy"]}


def _kernel_class(name):
    if "rowwalk" in name or "blockpar" in name:
        return "CSR SpMM kernels (ours)"
    if "gemm" in name.lower() or "xmma" in name or "cutlass" in name:
        return "GEMM (cuBLAS)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    return "other (elementwise, reductions, indexing)"


def _trainer(method, cfg, dev):
    """The trainer of window 0 of ``cfg`` on ``dev`` (setup synchronised)
    and the ``learn_embedding`` arguments of an unexported epoch."""
    import torch

    from ctgcn_torch.training.driver import build_trainer, get_data_loader

    args = dict(cfg)
    loader = get_data_loader(args)
    # S-link-dy's last snapshot only gives edges
    dy = args["learning_type"] == "S-link-dy"
    time_length = min(args["duration"], loader.max_time_num - dy)
    trainer = build_trainer(method, args, loader, 0, time_length, dev,
                            torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    return trainer, _epoch_kw(args)


def _epoch_kw(args):
    """The ``learn_embedding`` arguments of an unexported epoch of the
    config ``args``."""
    from ctgcn_torch.training.driver import SUPERVISED_TYPES

    kw = dict(lr=args["lr"], weight_decay=args["weight_decay"],
              model_file=None, export=False, verbose=False)
    if args["learning_type"] in SUPERVISED_TYPES:
        kw["classifier_file"] = None
    else:
        kw["batch_size"] = args["batch_size"]
    return kw


def _device_epochs(trainer, kw, epochs):
    """``epochs`` epochs of ``trainer`` under ``torch.profiler`` (device
    activity only): ({kernel: (device ms, launches) an epoch}, the
    profiled epoch's wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.learn_embedding(epoch=epochs, **kw)
        torch.cuda.synchronize()
        profiled_ms = (time.time() - t0) * 1e3 / epochs
    per_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        # device-side ranges of host annotations (e.g. Optimizer.step)
        # span kernels counted on their own
        if (ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0
                and not getattr(ev, "is_user_annotation", False)
                and "#" not in ev.key):
            per_kernel[ev.key] = (dev_us / 1e3 / epochs, ev.count // epochs)
    return per_kernel, profiled_ms


def phase_profile(path, trainer, kw, setup_s, epochs, warm=False):
    """Where a training epoch's time goes on the card on ``path``, on a
    ready ``trainer`` (the one the path's CLI run built, whose window's
    setup took ``setup_s``): one warm-up epoch unless the trainer is
    ``warm`` (it has just trained), ``epochs`` epochs timed on the host
    clock, then ``epochs`` more under ``torch.profiler`` for the device
    time by kernel class.  The profiler records the device's
    activity only: with the host's too, summing the events of the
    launch-heavy paths (Enron, America-Air) took it over a minute a path.
    The idle share is 1 - device busy time / the unprofiled epoch time.
    Returns the device busy ms of an epoch."""
    if not warm:
        trainer.learn_embedding(epoch=1, **kw)
    # the epoch's wall time without the profiler's host overhead
    epoch_ms = 1e3 * sum(
        trainer.learn_embedding(epoch=epochs, **kw)["epoch_seconds"]) / epochs
    per_kernel, profiled_ms = _device_epochs(trainer, kw, epochs)
    busy = sum(ms for ms, _ in per_kernel.values())
    classes = {}
    for name, (ms, n) in per_kernel.items():
        c = classes.setdefault(_kernel_class(name), [0.0, 0])
        c[0] += ms
        c[1] += n
    if not per_kernel:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    _phase("profile", path=path, window_setup_seconds=setup_s,
           epochs=epochs,
           epoch_ms=epoch_ms,
           epoch_ms_profiled=profiled_ms, device_busy_ms=busy,
           device_idle_share=max(0.0, 1 - busy / epoch_ms),
           kernel_launches=sum(n for _, n in per_kernel.values()),
           by_class={k: {"ms": v[0], "launches": v[1]}
                     for k, v in sorted(classes.items(),
                                        key=lambda kv: -kv[1][0])},
           top_kernels=[{"name": k[:90], "ms": v[0], "launches": v[1]}
                        for k, v in top])
    return busy


#: the paths whose trained model ``phase_model_file`` writes and reads
#: back: UCI CTGCN-C and the largest family model the script trains
#: (Enron bf16: five [87,036, 500] input layers, 0.87 GB)
MODEL_FILE_PATHS = ("uci_auto", "enron_bf16")


def _synced_seconds(fn, dev):
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.time()
    fn()
    torch.cuda.synchronize(dev)
    return time.time() - t0


def phase_model_file(path, trainer, folder, dev):
    """The path's trained model (its last window's) written as the flax
    msgpack the JAX package reads (``save_model_file``), then read back
    through ``load_model_file`` into a copy whose every tensor was set to
    NaN: each must come back bit-equal, and every parameter must be
    float32 (a bf16 run rounds the bank, not the parameters).  Beside it,
    ``torch.save`` and ``torch.load`` of the same ``state_dict``: bytes and
    seconds."""
    import copy

    import torch

    from ctgcn_torch.training.engine import load_model_file, save_model_file

    model = trainer.model
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    if dtypes != ["torch.float32"]:
        raise AssertionError(f"[model_file] {path}: parameters {dtypes}")
    folder.mkdir(parents=True, exist_ok=True)
    new, old = folder / f"{path}.msgpack", folder / f"{path}.pt"
    write_s = _synced_seconds(lambda: save_model_file(model, str(new)), dev)
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for value in fresh.state_dict().values():
            value.fill_(float("nan"))
    read_s = _synced_seconds(lambda: load_model_file(fresh, str(new), dev),
                             dev)
    want, got = model.state_dict(), fresh.state_dict()
    if list(got) != list(want):
        raise AssertionError(f"[model_file] {path}: keys {list(got)}")
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    if unequal:
        raise AssertionError(f"[model_file] {path}: {unequal} read back "
                             "unequal")
    save_s = _synced_seconds(lambda: torch.save(want, old), dev)
    load_s = _synced_seconds(lambda: torch.load(old, map_location=dev), dev)
    _phase("model_file", path=path, family=type(model).__name__,
           tensors=len(want),
           parameters=sum(v.numel() for v in want.values()),
           parameter_dtypes=dtypes, bit_equal=True,
           bytes=new.stat().st_size, write_seconds=write_s,
           read_seconds=read_s, torch_save_bytes=old.stat().st_size,
           torch_save_seconds=save_s, torch_load_seconds=load_s,
           write_over_torch_save=write_s / save_s)
    new.unlink()
    old.unlink()
    del fresh


def phase_vgrnn_memory(path, cfg, dev):
    """What lives at the peak of a VGRNN epoch on ``path``: the window and
    the parameters (allocated when the trainer is ready), the parameters'
    gradients and Adam's two moments (three times the parameters), the
    tensors the forward and the VAE loss save for the backward (distinct
    storages, counted under ``saved_tensors_hooks``), and the dense
    softplus sum's largest transient chunk (z z^T rows and their softplus);
    their sum beside the measured peaks of one batch's forward and loss,
    of its backward, and of a whole epoch (from the memory allocated before
    each)."""
    import torch

    from ctgcn_torch import losses as L

    trainer, kw = _trainer("VGRNN", cfg, dev)
    window_and_params = torch.cuda.memory_allocated(dev)
    params = sum(p.numel() * p.element_size()
                 for p in trainer.model.parameters())
    data = trainer.data
    torch.cuda.reset_peak_memory_stats(dev)
    (loss, h), saved = _saved_bytes(lambda: trainer.loss_fn(
        trainer.model, data, None, None,
        torch.Generator(device=dev).manual_seed(0),
        trainer.state_init(trainer.model, data)))
    torch.cuda.synchronize()
    after_forward = torch.cuda.memory_allocated(dev)
    forward_peak = torch.cuda.max_memory_allocated(dev)
    loss.backward()
    torch.cuda.synchronize()
    backward_peak = torch.cuda.max_memory_allocated(dev)
    del loss, h
    trainer.model.zero_grad(set_to_none=True)
    n = data["vgrnn_adjs"][0].n_rows
    rows = L._row_chunks(n)[0]
    chunk = 2 * (rows.stop - rows.start) * n * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.learn_embedding(epoch=1, **kw)
    peak = torch.cuda.max_memory_allocated(dev)
    parts = {"window_and_params_bytes": window_and_params,
             "params_bytes": params,
             "grads_and_adam_bytes": 3 * params,
             "saved_for_backward_bytes": saved,
             "gram_chunk_transient_bytes": chunk}
    _phase("memory", path=path, **parts,
           sum_bytes=sum(v for k, v in parts.items() if k != "params_bytes"),
           allocated_after_forward=after_forward,
           forward_peak=forward_peak, backward_peak=backward_peak,
           epoch_peak=peak)


def _saved_bytes(fn):
    """(``fn()``, the bytes of the distinct storages autograd saves for
    its backward)."""
    import torch

    saved = {}

    def pack(t):
        saved[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(saved.values())


def phase_pgnn(path, cfg, dev, epochs=2):
    """PGNN on ``path``: the window's setup (the proximity matrices on the
    host by row chunks of ``dijkstra``, each snapshot copied to the card),
    then ``phase_profile``; the anchor selection's device time (CUDA
    events: a window's draws, ``draw_anchor_sets``, and reductions,
    ``anchor_reduce``, each snapshot's) and its share of the profiled
    device epoch, beside the bytes its gathers move: the profiled
    ``learn_embedding`` runs ``epochs`` train steps and ``epochs - 1``
    validation forwards, each selecting anchors once; and ``[memory]``:
    the proximity matrices, the parameters, what one train forward and its
    loss save for the backward, beside the measured peaks of that forward,
    its backward and an epoch."""
    import torch

    from ctgcn_torch.nn.pgnn import (anchor_reduce, anchor_sizes,
                                     draw_anchor_sets)

    t0 = time.time()
    trainer, kw = _trainer("PGNN", cfg, dev)
    setup_s = time.time() - t0
    busy = phase_profile(path, trainer, kw, setup_s, epochs)

    dists = trainer.data["pgnn_dists"]
    T, n = dists.shape[:2]
    sizes = anchor_sizes(n)
    gen = torch.Generator(device=dev).manual_seed(0)
    sets = [draw_anchor_sets(n, sizes, gen, dev) for _ in range(T)]
    draw_ms = _time_ms(lambda: [draw_anchor_sets(n, sizes, gen, dev)
                                for _ in range(T)], iters=3, warmup=1)
    reduce_ms = _time_ms(lambda: [anchor_reduce(dists[t], sets[t])
                                  for t in range(T)], iters=3, warmup=1)
    gathered = T * sum(len(a) for a in sets[0]) * n * 4
    forwards = (2 * epochs - 1) / epochs
    per_epoch = forwards * (draw_ms + reduce_ms)
    _phase("profile", path=path, anchor_sets=len(sizes), snapshots=T,
           anchor_draw_ms=draw_ms, anchor_reduce_ms=reduce_ms,
           forwards_per_profiled_epoch=forwards,
           anchor_ms_per_epoch=per_epoch, device_busy_ms=busy,
           anchor_share_of_device_epoch=per_epoch / busy,
           gathered_bytes_per_forward=gathered,
           gather_bound_ms=1e3 * gathered / PEAK_HBM_BYTES,
           note="the bound reads each gathered proximity once")

    torch.cuda.synchronize()
    window = dists.numel() * dists.element_size()
    params = sum(p.numel() * p.element_size()
                 for m in trainer._modules() for p in m.parameters())
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    (loss, *_), saved = _saved_bytes(lambda: trainer._run("train", gen))
    torch.cuda.synchronize()
    forward_peak = torch.cuda.max_memory_allocated(dev)
    loss.backward()
    torch.cuda.synchronize()
    backward_peak = torch.cuda.max_memory_allocated(dev)
    del loss
    for m in trainer._modules():
        m.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.learn_embedding(epoch=1, **kw)
    _phase("memory", path=path, proximity_bytes=window,
           params_bytes=params, grads_and_adam_bytes=3 * params,
           saved_for_backward_bytes=saved,
           allocated_before_forward=before, forward_peak=forward_peak,
           backward_peak=backward_peak,
           epoch_peak=torch.cuda.max_memory_allocated(dev))


def phase_parity_dyn(dev):
    """DynGEM, DynAE, DynRNN and DynAERNN small (N = 800, W = 4 snapshots
    of weights 1-4, look-back 2, the configs' widths: units (500, 300),
    rnn units (500,), embed 128) on the card against the CPU in float64,
    their parameters carried over from the JAX layout by
    ``params_from_numpy``: every node's embedding (the export), then one
    epoch of ``train_epoch`` over two batches of 1,000 rows (the sampler's
    draws, the same on both sides) with the configs' loss weights, its
    summed loss and summed gradients, within PARITY_TOL; and the epoch's
    Adam step, given the card's summed gradients on both sides, within
    PARITY_TOL of the largest parameter.  (Adam's first step is lr g /
    (|g| + eps): where a summed gradient lies within rounding of zero, its
    sign in f32 sets the step, so the step is compared given the card's
    gradients.)"""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from ctgcn_torch.interop import params_from_numpy
    from ctgcn_torch.nn import dynae
    from ctgcn_torch.training.engine import make_optimizer

    n, W, lb, batch, lr = 800, 4, 2, 1000, 1e-3
    args = {"embed_dim": 128, "look_back": lb, "n_units": (500, 300),
            "ae_units": (500, 300), "rnn_units": (500,), "bias": True}
    rng = np.random.default_rng(7)
    mats = []
    for _ in range(W):
        a = np.triu((rng.random((n, n)) < 0.01)
                    * rng.integers(1, 5, (n, n)), 1).astype(np.float64)
        mats.append(sp.coo_matrix(a + a.T))
    window = torch.from_numpy(np.stack([m.toarray() for m in mats]))
    edges = sp.find(mats[0])
    cpu = torch.device("cpu")
    for method in dynae.DYN_METHODS:
        # DynGEM's configs weigh the loss otherwise (alpha, beta, nu)
        hyper = (dict(alpha=1e-5, beta=10.0, nu1=1e-4, nu2=1e-4)
                 if method == "DynGEM" else
                 dict(alpha=0.0, beta=5.0, nu1=1e-6, nu2=1e-6))
        model = dynae.build_model(method, n, args,
                                  torch.Generator().manual_seed(1))
        carried = dynae.build_model(method, n, args,
                                    torch.Generator().manual_seed(2))
        carried.load_state_dict(params_from_numpy(_jax_layout(model)))
        init = model.state_dict()
        if any(not torch.equal(v, carried.state_dict()[k])
               for k, v in init.items()):
            raise AssertionError(f"parity {method}: params_from_numpy did "
                                 "not carry the parameters")
        rows = len(edges[0]) if method == "DynGEM" else n * (W - lb)
        batches = dynae.draw_batches(rows, min(batch, rows), 2,
                                     torch.Generator().manual_seed(3))
        loss_fn = dynae.make_batch_loss(method, lb, **hyper)
        res, after = [], []
        for d, dtype in ((cpu, torch.float64), (dev, torch.float32)):
            mod = carried.to(d, dtype)
            mod.load_state_dict(init)
            mod.zero_grad(set_to_none=True)
            if method == "DynGEM":
                data = (window[0].to(d, dtype),
                        *(torch.from_numpy(e.astype(np.int64)).to(d)
                          for e in edges[:2]),
                        torch.from_numpy(edges[2]).to(d, dtype))
            else:
                data = (window.to(d, dtype),)
            with torch.no_grad():
                emb = dynae.embed(method, lb, mod, data)
            total = dynae.train_epoch(
                mod, make_optimizer(list(mod.parameters()), lr), loss_fn,
                data, [b.to(d) for b in batches])
            res.append(({"embedding": emb.cpu(),
                         "epoch_loss": total.detach().cpu().reshape(1)},
                        {k: p.grad.detach().cpu()
                         for k, p in mod.named_parameters()}))
            after.append({k: p.detach().cpu()
                          for k, p in mod.named_parameters()})
        stepped = dynae.build_model(method, n, args, None).double()
        stepped.load_state_dict(init)
        for k, p in stepped.named_parameters():
            p.grad = res[1][1][k].double()
        make_optimizer(list(stepped.parameters()), lr).step()
        want = dict(stepped.named_parameters())
        scale = max(float(v.abs().max()) for v in want.values())
        err_step = max(_check_close(
            f"parity {method} Adam step {k}", after[1][k],
            want[k].detach(), rtol=PARITY_TOL, atol_rel=PARITY_TOL,
            scale=scale) for k in want)
        _compare_sides(f"dyn_{method}", res, n=n, W=W, look_back=lb,
                       batches=len(batches), batch_rows=len(batches[0]),
                       rows=rows, **hyper, max_abs_err_step=err_step,
                       max_abs_param=scale,
                       cpu="float64; the Adam step given the card's "
                           "gradients")


def _dyn_trainer(method, cfg, dev):
    """The trainer of the last window of ``cfg`` (every profiled path
    trains one: its ``end_idx``) on ``dev``, its setup synchronised, and
    the ``learn_embedding`` arguments of an unexported, unsaved epoch."""
    import torch

    from ctgcn_torch.nn import dynae

    args = dict(cfg)
    loader, origin = dynae.get_data_loader(args)
    idx = args["end_idx"]
    trainer = dynae.build_trainer(method, args, loader, origin, idx, dev,
                                  torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    kw = dynae.train_kwargs(method, args)
    del kw["epoch"]
    kw.update(idx=idx, model_file=None, load_model=False, export=False,
              verbose=False)
    return trainer, kw


def phase_dyn(path, method, cfg, dev, epochs=2):
    """A non-GNN path's profile (``phase_profile`` after the window's
    setup: its matrices, the dense [W, N, N] copy on the card, the model),
    then ``[memory]``: the dense window, the parameters, what one batch's
    loss saves for its backward, beside the measured peaks of that batch's
    forward, its backward and an epoch."""
    import torch

    from ctgcn_torch.nn import dynae

    t0 = time.time()
    trainer, kw = _dyn_trainer(method, cfg, dev)
    phase_profile(path, trainer, kw, time.time() - t0, epochs)
    model, window = trainer.model, trainer.data[0]
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    batch = dynae.draw_batches(trainer.row_num,
                               min(kw["batch_size"], trainer.row_num), 1,
                               torch.Generator().manual_seed(0))[0].to(dev)
    loss_fn = dynae.make_batch_loss(method, trainer.look_back, kw["alpha"],
                                    kw["beta"], kw["nu1"], kw["nu2"])
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    loss, saved = _saved_bytes(lambda: loss_fn(model, trainer.data, batch))
    torch.cuda.synchronize()
    forward_peak = torch.cuda.max_memory_allocated(dev)
    loss.backward()
    torch.cuda.synchronize()
    backward_peak = torch.cuda.max_memory_allocated(dev)
    del loss
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.learn_embedding(epoch=1, **kw)
    _phase("memory", path=path, window_bytes=window.numel()
           * window.element_size(), window_shape=list(window.shape),
           params_bytes=params, grads_and_adam_bytes=3 * params,
           batch_rows=len(batch), saved_for_backward_bytes=saved,
           allocated_before_forward=before, forward_peak=forward_peak,
           backward_peak=backward_peak,
           epoch_peak=torch.cuda.max_memory_allocated(dev))


#: path -> (config, method, the core backend (the zoo's: the adjacency
#: backend) "auto" or the config must give, the kernels it must launch:
#: every other kernel must not)
PATHS = {
    "uci_auto": ("uci", "CTGCN-C", "blocks", ()),
    "uci_pallas": ("uci_pallas", "CTGCN-C", "pallas", tuple(F32_KERNELS)),
    "as_auto": ("as", "CTGCN-C", "ell", tuple(F32_KERNELS)),
    "as_ctgcn_s": ("as_ctgcn_s", "CTGCN-S", "ell", tuple(F32_KERNELS)),
    "as_bf16": ("as_bf16", "CTGCN-C", "ell", tuple(BF16_KERNELS)),
    "enron_bf16": ("enron", "CTGCN-C", "ell", ("bsr_spmm_blockpar_bf16",)),
    "enron_highest": ("enron_highest", "CTGCN-C", "ell",
                      ("bsr_spmm_blockpar",)),
    "uci_cgcn_c": ("uci_cgcn_c", "CGCN-C", "blocks", ()),
    "uci_cgcn_s": ("uci_cgcn_s", "CGCN-S", "blocks", ()),
    "aa_snode": ("aa_snode", "CTGCN-C", "blocks", ()),
    "aa_sedge": ("aa_sedge", "CTGCN-C", "blocks", ()),
    "as_ctgcn_s_slink": ("as_ctgcn_s_slink", "CTGCN-S", "ell",
                         tuple(F32_KERNELS)),
    "uci_slink_dy": ("uci_slink_dy", "CTGCN-C", "pallas", tuple(F32_KERNELS)),
    "enron_gcn": ("enron_gcn", "GCN", "ell", ("bsr_spmm_blockpar",)),
    "math_gin": ("math_gin", "GIN", "ell", ("bsr_spmm_rowwalk",)),
    "uci_tggcn": ("uci_tggcn", "TgGCN", "segment", ()),
    "as_tggin": ("as_tggin", "TgGIN", "segment", ()),
    "enron_gat": ("enron_gat", "GAT", "ell", ("bsr_spmm_blockpar",)),
    "math_tggat": ("math_tggat", "TgGAT", "ell", ("bsr_spmm_rowwalk",)),
    "enron_sage": ("enron_sage", "SAGE", "ell", ()),
    "as_tgsage": ("as_tgsage", "TgSAGE", "segment", ()),
    "enron_gcrn": ("enron_gcrn", "GCRN", "ell", ("bsr_spmm_blockpar",)),
    "enron_egcn": ("enron_egcn", "EvolveGCN", "ell", ("bsr_spmm_blockpar",)),
    "math_egcn": ("math_egcn", "EvolveGCN", "ell", ("bsr_spmm_rowwalk",)),
    "uci_vgrnn": ("uci_vgrnn", "VGRNN", "segment", ()),
    "math_vgrnn": ("math_vgrnn", "VGRNN", "ell", ("bsr_spmm_rowwalk",)),
    "uci_pgnn": ("uci_pgnn", "PGNN", "dense", ()),
    "aa_pgnn": ("aa_pgnn", "PGNN", "dense", ()),
    "math_pgnn": ("math_pgnn", "PGNN", "dense", ()),
    "uci_dyngem": ("uci_dyngem", "DynGEM", "dense", ()),
    "uci_dynae": ("uci_dynae", "DynAE", "dense", ()),
    "uci_dynrnn": ("uci_dynrnn", "DynRNN", "dense", ()),
    "uci_dynaernn": ("uci_dynaernn", "DynAERNN", "dense", ()),
    "uci_timers": ("uci_timers", "TIMERS", "host", ()),
    "math_dyngem": ("math_dyngem", "DynGEM", "dense", ()),
    "math_dynae": ("math_dynae", "DynAE", "dense", ()),
    "math_dynaernn": ("math_dynaernn", "DynAERNN", "dense", ()),
    "as_dynrnn": ("as_dynrnn", "DynRNN", "dense", ()),
}
#: the non-GNN paths [quality] scores: path -> its method, whose
#: embed_folder (configs/uci.json) names the scored folder
DYN_QUALITY_PATHS = {"uci_dyngem": "DynGEM", "uci_dynae": "DynAE",
                     "uci_dynrnn": "DynRNN", "uci_dynaernn": "DynAERNN",
                     "uci_timers": "TIMERS"}
#: the non-GNN paths ``phase_dyn`` profiles
DYN_PROFILED = ("math_dyngem", "math_dynae", "math_dynaernn", "as_dynrnn")
#: the paths profiled, each on the trainer of its CLI run's last window,
#: right after it, with their epochs under the profiler (aa_snode's
#: 52,000 launches an epoch take the profiler minutes to sum; aa_sedge
#: runs the same model); the PGNN paths are profiled by ``phase_pgnn``
PROFILED = ("uci_auto", "uci_pallas", "as_auto", "as_ctgcn_s", "as_bf16",
            "enron_bf16", "uci_cgcn_c", "uci_cgcn_s", "aa_snode",
            "as_ctgcn_s_slink", "uci_slink_dy", "enron_gcn", "math_gin",
            "enron_gat", "enron_sage", "enron_gcrn", "enron_egcn",
            "uci_vgrnn", "math_vgrnn")
#: epochs a profiled path is timed for on the host clock and then under
#: the profiler, on the trainer its counted run left warm (no warm-up)
PROFILED_EPOCHS = 1


def _write_config(path, method, pre, emb):
    """A config file of one method; returns (path, preprocessing,
    embedding)."""
    with open(path, "w") as fp:
        json.dump({"preprocessing": {method: pre},
                   "embedding": {method: emb}}, fp, indent=1)
    return path, pre, emb


def _embedding_csv_shape(path, nodes, embed_dim):
    """[rows, cols] of one exported embedding CSV, which must name every
    node of ``nodes`` in order and hold finite values of width
    ``embed_dim``."""
    import numpy as np

    from ctgcn_torch.data.formats import read_embedding_csv

    names, arr = read_embedding_csv(path)
    if (names != nodes or arr.shape != (len(nodes), embed_dim)
            or not np.isfinite(arr).all()):
        raise AssertionError(f"embedding {path}: {arr.shape}")
    return list(arr.shape)


def _run_cli_counted(cfg_path, method, dev):
    """The embedding task of the config at ``cfg_path`` through the CLI,
    the launch counters set to 0 just before and read just after: (what it
    returns, its wall seconds, the launches, the peak device memory, the
    last window's trainer, taken out of what it returns; None for a task
    that keeps none)."""
    import torch

    from ctgcn_torch import main as cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.time()
    results = cli.main([f"--config={cfg_path}", "--task=embedding",
                        f"--method={method}"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    return (results, wall, _launches(),
            torch.cuda.max_memory_allocated(dev),
            results[-1].pop("trainer", None))


def _check_exports(path, emb, method, count):
    """The shapes of the ``count`` embedding CSVs a path exported, each
    holding every node at the method's width (``_embedding_csv_shape``)."""
    from ctgcn_torch.data.formats import PARALLEL_MIN_ROWS, read_node_list
    from ctgcn_torch.nn.pgnn import anchor_sizes

    base = Path(emb["base_path"])
    nodes = read_node_list(base / emb["node_file"])
    emb_dir = base / emb["embed_folder"]
    files = [emb_dir / f for f in sorted(os.listdir(emb_dir))]
    # PGNN's embedding has one column per anchor set, TIMERS' two halves of
    # embed_dim // 2
    width = (len(anchor_sizes(len(nodes))) if method == "PGNN"
             else 2 * (emb["embed_dim"] // 2) if method == "TIMERS"
             else emb["embed_dim"])
    args = (files, [nodes] * len(files), [width] * len(files))
    # parsing an Enron-sized CSV takes seconds: large exports are read in
    # worker processes, as they are written
    if len(files) > 1 and len(nodes) * len(files) >= PARALLEL_MIN_ROWS:
        with concurrent.futures.ProcessPoolExecutor(
                min(os.cpu_count() or 1, len(files)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            shapes = list(pool.map(_embedding_csv_shape, *args))
    else:
        shapes = list(map(_embedding_csv_shape, *args))
    if len(shapes) != count:
        raise AssertionError(f"{path}: {len(shapes)} embedding CSVs, want "
                             f"{count}")
    return shapes


def run_timers_path(path, cfg, method, backend, kernels, dev):
    """TIMERS (host ARPACK and numpy) through the CLI as ``run_path`` runs
    the others: no kernel launched (``kernels`` is empty), every snapshot's
    loss and bound finite, one CSV a snapshot holding every node.  Returns
    the launch counts, the per-snapshot results and None (it keeps no
    trainer)."""
    import numpy as np

    cfg_path, _, emb = cfg
    out, wall, launches, peak, _ = _run_cli_counted(cfg_path, method, dev)
    if any(n > 0 for name, n in launches.items() if name not in kernels):
        raise AssertionError(f"{path}: launches {launches}")
    losses = [r["loss"] for r in out]
    bounds = [r["bound"] for r in out]
    if not np.isfinite(losses + bounds).all():
        raise AssertionError(f"{path}: losses {losses}, bounds {bounds}")
    shapes = _check_exports(path, emb, method, len(out))
    _phase("path", path=path, method=method, core_backend=backend,
           windows=len(out), seconds=wall,
           snapshot_seconds=[r["seconds"] for r in out], losses=losses,
           bounds=bounds, reruns=[r["rerun"] for r in out],
           launches=launches, max_memory_allocated=peak,
           embedding_csvs=shapes)
    return launches, out, None


def run_path(path, cfg, method, backend, kernels, dev):
    """The embedding task of ``cfg`` through the CLI, with the launch
    counters set to 0 just before and read just after.  Checks that
    ``backend`` ran in every window, the losses are finite, (when the
    config exports) every embedding CSV holds every node and (for a
    supervised type) the test accuracy and AUC lie in [0, 1]; that each
    kernel of ``kernels`` was launched and no other.  Returns the launch
    counts, the window results and the last window's trainer."""
    import numpy as np

    cfg_path, _, emb = cfg
    results, wall, launches, peak, trainer = _run_cli_counted(cfg_path,
                                                              method, dev)
    backends = [r["core_backend"] for r in results]
    if not results or backends != [backend] * len(results):
        raise AssertionError(f"{path}: backends {backends}, want "
                             f"{backend!r} in every window")
    losses = [l for r in results for l in r["losses"]]
    if (len(losses) != emb["epoch"] * len(results)
            or not all(np.isfinite(losses))):
        raise AssertionError(f"{path}: losses {losses}")
    for name, n_launch in launches.items():
        if (n_launch > 0) != (name in kernels):
            raise AssertionError(f"{path}: {name} launched {n_launch} "
                                 f"times; the path runs {kernels}")
    shapes = []
    if emb.get("export", True):
        shapes = _check_exports(path, emb, method,
                                sum(r["time_length"] for r in results))
    supervised = {}
    if "acc_test" in results[0]:
        # the supervised types' test results, and the splits' host time
        supervised = {k: [r[k] for r in results] for k in (
            "split_seconds", "acc_val", "best_acc_val", "acc_test",
            "auc_test")}
        if not all(0.0 <= r["acc_test"] <= 1.0 and 0.0 <= r["auc_test"]
                   <= 1.0 for r in results):
            raise AssertionError(f"{path}: test accuracy / AUC "
                                 f"{supervised['acc_test']} / "
                                 f"{supervised['auc_test']}")
    _phase("path", path=path, method=method, core_backend=backend,
           learning_type=emb.get("learning_type"),
           matmul_precision=emb.get("matmul_precision", "highest"),
           windows=len(results), seconds=wall,
           time_length=[r["time_length"] for r in results],
           setup_seconds=[r["setup_seconds"] for r in results],
           train_seconds=[r["cost_time"] for r in results],
           epoch_seconds=[r["epoch_seconds"] for r in results],
           export_seconds=[r["export_seconds"] for r in results],
           losses=losses, launches=launches, max_memory_allocated=peak,
           embedding_csvs=shapes, **supervised)
    return launches, results, trainer


def _enron_acc_gate(cfg):
    """Whether each CoreDiffusion layer of the Enron CTGCN-C stores its
    prefix in bf16 (the tail budget gate), at the window's K and N."""
    import torch

    from ctgcn_torch.nn.core_models import CORE_RNN_BUDGET, acc_in_bf16
    from ctgcn_torch.training.driver import get_data_loader

    args = dict(cfg)
    loader = get_data_loader(args)
    mats = loader.get_core_scipy_list(args["core_base_path"], 0,
                                      args["duration"])
    K, n = max(len(m) for m in mats), loader.node_num
    hid, out = args["hid_dim"], args["embed_dim"]
    return {"num_slots": K, "n_nodes": n, "budget": CORE_RNN_BUDGET,
            "acc_in_bf16_by_layer": [
                acc_in_bf16(torch.bfloat16, K, n, d_in, out, False)
                for d_in in (hid, out)]}


def _cli(config, task, device, method=None):
    """``ctgcn_torch.main`` on a config dict written to a file beside
    ``config["_path"]``; returns what the task returns."""
    from ctgcn_torch import main as cli

    path = config.pop("_path")
    with open(path, "w") as fp:
        json.dump(config, fp, indent=1)
    argv = [f"--config={path}", f"--task={task}", f"--device={device}"]
    return cli.main(argv + ([f"--method={method}"] if method else []))


def _train(base, name, conf, device, method="CTGCN-C", **change):
    """``method`` trained through the CLI on the preprocessed ``base`` into
    ``2.embedding/<name>``; checks the losses and returns the seconds and
    the window results."""
    import numpy as np

    emb = dict(conf["embedding"][method], base_path=str(base),
               embed_folder=f"2.embedding/{name}", model_file=name,
               record_time=False, **change)
    t0 = time.time()
    results = _cli({"_path": base / f"{name}.json",
                    "embedding": {method: emb}}, "embedding", device,
                   method)
    losses = [l for r in results for l in r["losses"]]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    return time.time() - t0, results


#: worker processes that train the quality runs side by side on the card
#: (each host-bound run leaves it mostly idle)
QUALITY_WORKERS = 4
#: the window results' keys the quality gates read
_RESULT_KEYS = ("losses", "core_backend", "acc_test", "auc_test",
                "best_acc_val")


def _train_job(base, name, conf, method, change, device):
    """``_train`` in a worker process (``quality_pool``), TF32 off as in
    the main process: (seconds, each window's ``_RESULT_KEYS``, the
    kernels' launches)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _zero_launches()
    seconds, results = _train(base, name, conf, device, method, **change)
    return (seconds, [{k: r[k] for k in _RESULT_KEYS if k in r}
                      for r in results], _launches())


def quality_pool():
    """The workers that train the quality runs (spawned: each takes the
    card anew)."""
    return concurrent.futures.ProcessPoolExecutor(
        QUALITY_WORKERS, mp_context=multiprocessing.get_context("spawn"))


def _collect(future, launches):
    """A ``_train_job``'s (seconds, results), its launches added to
    ``launches``."""
    seconds, results, counts = future.result()
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    return seconds, results


def phase_quality(base, device, dyn_methods, pool, launches):
    """The Had AUC gates on the preprocessed UCI copy ``base``: each run of
    ``QUALITY_RUNS`` trained once per seed of its own, then one
    ``link_pred`` as ``configs/uci.json`` gives it (ratios 0.5/0.3/0.2, C
    in 0.01-10, four measures) over reps 0-2 on all of them and on the
    folders of ``dyn_methods`` (the uci_* paths' exports, seed 0, as
    configured); each run's mean Had AUC of the last 4 dates, over seeds
    and reps, must reach its gate (``DYN_AUC_GATES`` for the non-GNN
    methods; TIMERS' must lie within ``TIMERS_AUC_TOL`` of the JAX
    package's).  The DynAE family
    exports snapshots 2-6 only, so link_pred scores 4 dates of it, 6 of
    the others.  The runs train side by side in ``pool``'s workers, whose
    kernel launches are added to ``launches``.  Returns the method folders,
    the f32 CTGCN-C seed 0's first."""
    import numpy as np

    from ctgcn_torch.evaluation.tables import read_table

    with open(ROOT / "configs" / "uci.json") as fp:
        conf = json.load(fp)
    runs, methods, train = {}, [], {}
    dates = {}
    jobs = {f"{label}-s{seed}": pool.submit(
                _train_job, base, f"{label}-s{seed}", conf, method,
                dict(change, epoch=epochs, seed=seed), device)
            for label, method, change, epochs, gate, seeds in QUALITY_RUNS
            for seed in seeds}
    for label, method, change, epochs, gate, seeds in QUALITY_RUNS:
        for seed in seeds:
            name = f"{label}-s{seed}"
            seconds, results = _collect(jobs[name], launches)
            train[name] = {"seconds": seconds,
                           "core_backend": [r["core_backend"]
                                            for r in results],
                           "final_loss": results[-1]["losses"][-1]}
            methods.append(name)
            runs.setdefault(label, (gate, epochs, []))[2].append(name)
    for method in dyn_methods:
        gate = (TIMERS_AUC_JAX - TIMERS_AUC_TOL if method == "TIMERS"
                else DYN_AUC_GATES[method])
        runs[method] = (gate, conf["embedding"][method].get("epoch"),
                        [method])
        # a snapshot's edges are scored with the embedding before it
        dates[method] = len(os.listdir(base / "2.embedding" / method)) - 1
    lp = dict(conf["link_pred"], base_path=str(base), start_idx=0,
              rep_num=QUALITY_REPS, method_list=methods + list(dyn_methods),
              aggregate=True)
    timing = _cli({"_path": base / "link_pred.json", "link_pred": lp},
                  "link_pred", device)
    had, means = {}, {}
    for name in methods + list(dyn_methods):
        per_rep = []
        for i in range(QUALITY_REPS):
            header, cols = read_table(base / f"lp_res_{i}"
                                      / f"{name}_auc_record.csv", ",")
            vals = cols[header.index("Had")]
            if (len(vals) != dates.get(name, 6)
                    or not all(0.0 <= v <= 1.0 for v in vals)):
                raise AssertionError(f"{name} rep {i}: Had AUCs {vals}")
            per_rep.append(float(np.mean(vals[-4:])))
            means.setdefault(i, {})[name] = {
                m: float(np.mean(cols[header.index(m)][-4:]))
                for m in lp["measure_list"]}
        had[name] = per_rep
    seed_means = {name: float(np.mean(v)) for name, v in had.items()}
    refs = {**QUALITY_REFERENCES, **DYN_AUC_REFERENCES,
            "TIMERS": TIMERS_AUC_REFERENCES}
    gates = {label: {"had_auc_mean": float(np.mean(
                         [seed_means[n] for n in names])),
                     "gate": gate, "epochs": epochs,
                     **({"references": refs[label]} if label in refs
                        else {})}
             for label, (gate, epochs, names) in runs.items()}
    _phase("quality", had_auc_last4_by_seed_and_rep=had,
           had_auc_by_seed=seed_means, gates=gates,
           reference_ranges=HAD_AUC_RANGES,
           all_measures_last4=means, train=train,
           split_generation_seconds=timing["generate_seconds"],
           fit_seconds=timing["predict_seconds"])
    for label, g in gates.items():
        if not g["had_auc_mean"] >= g["gate"]:
            raise AssertionError(f"{label}: Had AUC {g['had_auc_mean']:.4f}"
                                 f" below the gate {g['gate']}")
    if "TIMERS" in gates and not (abs(gates["TIMERS"]["had_auc_mean"]
                                      - TIMERS_AUC_JAX) <= TIMERS_AUC_TOL):
        raise AssertionError(f"TIMERS: Had AUC "
                             f"{gates['TIMERS']['had_auc_mean']:.5f} more "
                             f"than {TIMERS_AUC_TOL} from the JAX "
                             f"package's {TIMERS_AUC_JAX}")
    return methods


def snode_jobs(aa, path, pool, device):
    """The futures of ``path``'s ``SNODE_QUALITY`` runs but the config's
    seed (the path's own run), trained on the preprocessed America-Air copy
    ``aa`` with the path's config in ``pool``'s workers: seed -> future."""
    method, change = SNODE_QUALITY[path][:2]
    with open(ROOT / "configs" / "america-air.json") as fp:
        conf = json.load(fp)
    return {seed: pool.submit(_train_job, aa, f"{path}-s{seed}", conf, method,
                              dict(change, learning_type="S-node",
                                   seed=seed), device)
            for seed in AA_SNODE_SEEDS
            if seed != conf["embedding"][method].get("seed", 0)}


def phase_quality_snode(path, path_results, jobs, launches):
    """A ``SNODE_QUALITY`` run on America-Air under S-node for each seed of
    ``AA_SNODE_SEEDS``: the config's seed is the path's run, the others
    ``snode_jobs``' (their launches added to ``launches``); the mean test
    accuracy must reach the gate, which lies under the JAX package's mean
    on the same config and seeds."""
    import numpy as np

    method, change, jax_acc, gate, refs = SNODE_QUALITY[path]
    runs = {}
    for seed in AA_SNODE_SEEDS:
        if seed in jobs:
            seconds, results = _collect(jobs[seed], launches)
        else:
            seconds, results = None, path_results
        runs[seed] = {"seconds": seconds, "epochs": len(results[0]["losses"]),
                      "acc_test": results[0]["acc_test"],
                      "auc_test": results[0]["auc_test"],
                      "best_acc_val": results[0]["best_acc_val"]}
    mean = float(np.mean([r["acc_test"] for r in runs.values()]))
    _phase("quality", path=path, runs=runs, mean_acc_test=mean,
           jax_mean_acc_test=jax_acc, gate=gate, references=refs)
    if not mean >= gate:
        raise AssertionError(f"{path}: mean test accuracy {mean:.4f} "
                             f"below the gate {gate:.4f}")


def _check_record(task, path, rows, lo, hi):
    """A record's values: ``rows`` dates, each value finite in [lo, hi]."""
    import math

    from ctgcn_torch.evaluation.tables import read_table

    header, cols = read_table(path, ",")
    vals = [v for c in cols[1:] for v in c]
    if (len(cols[0]) != rows
            or not all(math.isfinite(v) and lo <= v <= hi for v in vals)):
        raise AssertionError(f"{task}: record {path.name}: {cols}")
    return {h: c for h, c in zip(header, cols)}


def phase_eval(uci, method, aa, device):
    """``cent_pred`` and ``sim_pred`` of ``configs/uci.json`` on
    ``method``'s UCI embeddings (all 7 snapshots); ``node_cls`` and
    ``edge_cls`` of ``configs/america-air.json`` (rep 0) on a CTGCN-C
    trained for ``AA_EPOCHS`` epochs on the preprocessed copy of
    America-Air at ``aa``."""
    with open(ROOT / "configs" / "uci.json") as fp:
        conf = json.load(fp)
    for task, res, col_range in (
            ("cent_pred", "centrality_res", (0.0, float("inf"))),
            ("sim_pred", "similarity_res", (-1.0, 1.0))):
        section = dict(conf[task], base_path=str(uci), method_list=[method])
        t0 = time.time()
        timing = _cli({"_path": uci / f"{task}.json", task: section}, task,
                      device)
        record = _check_record(task, uci / res / f"{method}_mse_record.csv",
                               7, *col_range)
        _phase("eval", task=task, data="uci", method=method,
               seconds=time.time() - t0, **timing, record=record,
               checked=f"7 dates, every value finite in {list(col_range)}")

    with open(ROOT / "configs" / "america-air.json") as fp:
        conf = json.load(fp)
    train_s, results = _train(aa, "CTGCN-C", conf, device, epoch=AA_EPOCHS)
    _phase("eval", data="america_air", train_seconds=train_s,
           core_backend=[r["core_backend"] for r in results],
           losses=[l for r in results for l in r["losses"]])
    for task, res in (("node_cls", "nodecls_res_0"),
                      ("edge_cls", "edgecls_res_0")):
        section = dict(conf[task], base_path=str(aa), start_idx=0,
                       rep_num=1, method_list=["CTGCN-C"], aggregate=False)
        t0 = time.time()
        timing = _cli({"_path": aa / f"{task}.json", task: section}, task,
                      device)
        record = _check_record(task, aa / res / "CTGCN-C_acc_record.csv",
                               10, 0.0, 1.0)
        _phase("eval", task=task, data="america_air", method="CTGCN-C",
               seconds=time.time() - t0, **timing, record=record,
               checked="10 dates, every value finite in [0.0, 1.0]")


def _close64(name, got, ref):
    """|got - ref| <= DEVICE_CPU_RTOL * max|ref| (float64 on both)."""
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= DEVICE_CPU_RTOL * scale:
        raise AssertionError(f"{name}: device against cpu {err:.3e} over "
                             f"{DEVICE_CPU_RTOL} * {scale:.3e}")
    return err / scale if scale else 0.0


def phase_device_vs_cpu(uci, method, dev):
    """The three centralities of UCI 2004-05, and one date's logistic
    sweep (Had features of 2004-05's rep-0 training edges on ``method``'s
    2004-04 embedding, every C of ``configs/uci.json``), computed on the
    GPU and on the CPU: float64 on both, so they agree within
    ``DEVICE_CPU_RTOL`` of the largest value."""
    import numpy as np
    import torch

    from ctgcn_torch.data.formats import get_sp_adj_mat, read_node_list
    from ctgcn_torch.evaluation import centrality, linear, tables
    from ctgcn_torch.evaluation.link_prediction import edge_features

    nodes = read_node_list(uci / "nodes_set" / "nodes.csv")
    adj = get_sp_adj_mat(uci / "1.format" / f"{SNAPSHOT}.csv", nodes)
    sides = {"device": dev, "cpu": torch.device("cpu")}
    out, seconds, res, fits = {}, {}, {}, {}
    for side, d in sides.items():
        t0 = time.time()
        A = centrality.edge_pattern(adj, d)
        res[side] = [v.cpu() for v in (
            *centrality.shortest_path_centralities(A),
            centrality.eigenvector_centrality(A))]
        seconds[f"centralities_{side}"] = time.time() - t0
    for k, name in enumerate(("closeness", "betweenness", "eigenvector")):
        out[name] = _close64(name, res["device"][k], res["cpu"][k])

    with open(ROOT / "configs" / "uci.json") as fp:
        lp = json.load(fp)["link_pred"]
    emb = tables.read_embedding(
        uci / "2.embedding" / method / "2004-04.csv", nodes, "\t")
    cols = tables.read_split(uci / "lp_data_0" / f"{SNAPSHOT}_train.csv",
                             "\t")
    for side, d in sides.items():
        edges = torch.from_numpy(np.stack(cols, 1)).to(d)
        X = edge_features(edges, torch.from_numpy(emb).to(d), ["Had"])["Had"]
        t0 = time.time()
        fits[side] = linear.fit_logistic(X, edges[:, 2], lp["c_list"],
                                         lp["max_iter"]).cpu()
        seconds[f"fit_logistic_{side}"] = time.time() - t0
    out["fit_logistic"] = _close64("fit_logistic", fits["device"],
                                   fits["cpu"])
    return {"snapshot": SNAPSHOT, "n_nodes": len(nodes),
            "train_edges": int(len(cols[0])), "C": lp["c_list"],
            "max_rel_err": out, "tolerance": DEVICE_CPU_RTOL,
            "seconds": seconds}


def main(argv=None):
    global _OTHER
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "NVIDIA GPU (see the module docstring).")
    ap.add_argument("--compare", metavar="DIR",
                    help="another checkout of the repository: run the "
                    "kernel phases only, each kernel timed in turns "
                    "against that checkout's on the same plans")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as exc:
        return _fail(f"missing package: {exc}")
    if not torch.cuda.is_available():
        return _fail("no CUDA device (torch.cuda.is_available() is False)")
    if not ((ROOT / "ctgcn_torch" / "csrc").is_dir()
            and (ROOT / "configs" / "uci.json").is_file()
            and (ROOT / "data" / "uci" / "1.format").is_dir()
            and all((ROOT / "data" / "america_air" / f).is_dir()
                    for f in ("nodes_label", "edges_label"))
            and all((ROOT / "data" / "as" / "1.format" / f).is_file()
                    for f in AS_SNAPSHOTS)
            and all((ROOT / "data" / "enron" / "1.format" / f).is_file()
                    for f in ENRON_SNAPSHOTS)
            and all((ROOT / "data" / "math" / "1.format" / f).is_file()
                    for f in TEN_SNAPSHOTS)):
        return _fail(f"{ROOT} is not a checkout of the repository")
    t_start = time.time()
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
           torch=torch.__version__, cuda=torch.version.cuda)

    # 1. build
    from ctgcn_torch.ops.cuda_build import build_kernels, load_kernels

    t0 = time.time()
    _, nvcc_s, log = build_kernels()
    load_kernels()
    spills = [line for line in log.splitlines()
              if "spill" in line and " 0 bytes spill stores, 0 bytes spill"
              not in line]
    _phase("build", seconds=time.time() - t0, nvcc_seconds=nvcc_s,
           ptxas=[line.split("info    : ")[-1] for line in log.splitlines()
                  if "registers" in line], spills=spills)
    if spills:
        raise AssertionError(f"the kernels spill registers: {spills}")
    if args.compare:
        _OTHER = _OtherKernels(args.compare)
        t0 = time.time()
        _, nvcc_s, _ = _OTHER.build.build_kernels()
        _OTHER.build.load_kernels()
        _phase("compare", other=str(Path(args.compare).resolve()),
               build_seconds=time.time() - t0, nvcc_seconds=nvcc_s)

    work = ROOT / "tmp_run" / f"chip_smoke_{os.getpid()}"
    try:
        from ctgcn_torch import main as cli

        # 2. preprocessing on temporary copies of data/uci, of the first
        # AS and Enron snapshots, of data/america_air (with its labels), of
        # Math snapshot 000 (its CTGCN-C entry writes the walk tables that
        # its GIN entry reads) and of Math snapshots 000-009 (EvolveGCN's
        # window)
        cfgs, confs = {}, {}
        for name, conf_name, files, extra, epochs in (
                ("uci", "uci", None, (), EPOCHS),
                ("as", "as", AS_SNAPSHOTS, (), EPOCHS),
                ("enron", "enron", ENRON_SNAPSHOTS, (), ENRON_EPOCHS),
                ("america_air", "america-air", None,
                 ("nodes_label", "edges_label"), AA_EPOCHS),
                ("math", "math", MATH_SNAPSHOTS, (), EPOCHS),
                ("math10", "math", TEN_SNAPSHOTS, (), EPOCHS)):
            base = work / name
            src = ROOT / "data" / conf_name.replace("-", "_")
            for folder in ("nodes_set",) + extra:
                shutil.copytree(src / folder, base / folder)
            if files is None:
                shutil.copytree(src / "1.format", base / "1.format")
            else:
                (base / "1.format").mkdir(parents=True)
                for f in files:
                    shutil.copy(src / "1.format" / f, base / "1.format" / f)
            with open(ROOT / "configs" / f"{conf_name}.json") as fp:
                confs[name] = conf = json.load(fp)
            pre = dict(conf["preprocessing"]["CTGCN-C"], base_path=str(base))
            emb = dict(conf["embedding"]["CTGCN-C"], base_path=str(base),
                       epoch=epochs)
            cfgs[name] = _write_config(work / f"{name}.json", "CTGCN-C", pre,
                                       emb)
            t0 = time.time()
            cli.main([f"--config={cfgs[name][0]}", "--task=preprocessing",
                      "--method=CTGCN-C"])
            _phase("preprocess", data=name, seconds=time.time() - t0,
                   walks="native", host_cpus=os.cpu_count(),
                   numpy_walks_seconds_before=NUMPY_PREPROCESS_SECONDS.get(
                       name))
        _phase("preprocess", **phase_core_numbers(work / "uci"))

        def variant(name, data, method, **change):
            """A config of ``method`` from configs/<data>.json as written,
            on the preprocessed copy, with ``change``."""
            emb = dict(confs[data]["embedding"][method],
                       base_path=str(work / data), **change)
            cfgs[name] = _write_config(work / f"{name}.json", method,
                                       cfgs[data][1], emb)

        emb = cfgs["uci"][2]
        variant("uci_pallas", "uci", "CTGCN-C", core_backend="pallas",
                epoch=1, embed_folder=emb["embed_folder"] + "-pallas")
        variant("as_ctgcn_s", "as", "CTGCN-S", epoch=EPOCHS)
        variant("as_bf16", "as", "CTGCN-C", matmul_precision="bf16", epoch=1,
                embed_folder="2.embedding/CTGCN-C-bf16",
                model_file="ctgcn-c-bf16")
        variant("as_trace", "as", "CTGCN-C", epoch=TRACE_EPOCHS,
                profile_dir=str(work / "as_trace"), export=False,
                model_file="")
        variant("enron_highest", "enron", "CTGCN-C",
                matmul_precision="highest", epoch=1, export=False,
                record_time=False, model_file="")
        for method in ("CGCN-C", "CGCN-S"):
            variant(f"uci_{method.lower().replace('-', '_')}", "uci", method,
                    end_idx=1, epoch=2)
        # the supervised types: configs as written but the learning type
        # (and the outputs' names, and the cuts of epochs)
        variant("aa_snode", "america_air", "CTGCN-C", learning_type="S-node",
                embed_folder="2.embedding/aa_snode", model_file="aa_snode")
        variant("aa_sedge", "america_air", "CTGCN-C", learning_type="S-edge",
                elabel_folder="edges_label", epoch=5,
                embed_folder="2.embedding/aa_sedge", model_file="aa_sedge")
        variant("as_ctgcn_s_slink", "as", "CTGCN-S",
                learning_type="S-link-st", epoch=EPOCHS,
                embed_folder="2.embedding/CTGCN-S-slink",
                model_file="ctgcn-s-slink")
        variant("uci_slink_dy", "uci", "CTGCN-C", learning_type="S-link-dy",
                core_backend="pallas", epoch=EPOCHS,
                embed_folder="2.embedding/CTGCN-C-slink-dy",
                model_file="ctgcn-c-slink-dy")
        # the zoo: configs as written, one window of one snapshot
        for name, data, method in (("enron_gcn", "enron", "GCN"),
                                   ("math_gin", "math", "GIN"),
                                   ("uci_tggcn", "uci", "TgGCN"),
                                   ("as_tggin", "as", "TgGIN"),
                                   ("enron_gat", "enron", "GAT"),
                                   ("math_tggat", "math", "TgGAT"),
                                   ("enron_sage", "enron", "SAGE"),
                                   ("as_tgsage", "as", "TgSAGE")):
            variant(name, data, method, end_idx=0, epoch=EPOCHS)
        # the recurrent GCNs: configs as written, window 0 (EvolveGCN's
        # setup draws 0.5e9 gaussians at Enron, so one epoch there)
        variant("enron_gcrn", "enron", "GCRN", epoch=EPOCHS)
        variant("enron_egcn", "enron", "EvolveGCN", epoch=1)
        variant("math_egcn", "math10", "EvolveGCN", epoch=EPOCHS)
        # VGRNN: configs as written, window 0 (Math's first five
        # snapshots: its duration)
        variant("uci_vgrnn", "uci", "VGRNN", epoch=EPOCHS)
        variant("math_vgrnn", "math10", "VGRNN", end_idx=4, epoch=EPOCHS)
        # PGNN: configs as written, window 0 (duration 2 at UCI and Math,
        # 1 at America-Air, whose 50 epochs are aa_pgnn's quality seed 0)
        variant("uci_pgnn", "uci", "PGNN", end_idx=1, epoch=EPOCHS)
        variant("aa_pgnn", "america_air", "PGNN", end_idx=0)
        variant("math_pgnn", "math10", "PGNN", end_idx=1, epoch=EPOCHS)
        # the non-GNN baselines: UCI's entries as written (every window,
        # 50 epochs: [quality] scores them), and window 0 of Math's and
        # AS's (snapshot 000 for DynGEM, 000-003 for the others)
        for name, data, method, change in (
                ("uci_dyngem", "uci", "DynGEM", {}),
                ("uci_dynae", "uci", "DynAE", {}),
                ("uci_dynrnn", "uci", "DynRNN", {}),
                ("uci_dynaernn", "uci", "DynAERNN", {}),
                ("uci_timers", "uci", "TIMERS", {}),
                ("math_dyngem", "math10", "DynGEM", {"end_idx": 0}),
                ("math_dynae", "math10", "DynAE", {"end_idx": 3}),
                ("math_dynaernn", "math10", "DynAERNN", {"end_idx": 3}),
                ("as_dynrnn", "as", "DynRNN", {"end_idx": 3})):
            if data != "uci":
                change["epoch"] = EPOCHS
            variant(name, data, method, **change)

        # the partitioned path on one part (phase_dist): UCI CTGCN-C and GCN
        # (window 0; the CTGCN-C entry's walk tables), 2 epochs, with and
        # without n_devices: 4 and graph_partition: true, and the halo
        # path's export (0 epochs) of the plain run's model file
        walks = {k: cfgs["uci"][2][k]
                 for k in ("walk_pair_folder", "node_freq_folder")}
        dist_runs = []
        for method, change, snapshots in (
                ("CTGCN-C", {}, 7), ("GCN", dict(end_idx=0, **walks), 1)):
            path = f"dist_{method.lower().replace('-', '_')}"
            for tag, keys in (
                    ("plain", {}), ("rerun", {}), ("halo", DIST_KEYS),
                    ("replay", dict(DIST_KEYS, epoch=0, load_model=True,
                                    model_file=f"{path}_plain"))):
                keys = dict(dict(epoch=2, model_file=f"{path}_{tag}"),
                            **keys)
                variant(f"{path}_{tag}", "uci", method, record_time=False,
                        embed_folder=f"2.embedding/{path}_{tag}", **change,
                        **keys)
            dist_runs.append((path, method, snapshots, {
                tag: cfgs[f"{path}_{tag}"] for tag in DIST_RUNS}))

        # 3. kernels at the paths' shapes, and small-model parity
        kernels = phase_kernels(cfgs["uci_pallas"][2], dev)
        kernels_ell, as_plans = phase_kernels_ell(cfgs["as"][2], dev)
        kernels_bf16 = phase_kernels_bf16(cfgs["enron"][2], as_plans, dev)
        del as_plans
        kernels_zoo = phase_kernels_zoo(
            {"enron": (cfgs["enron_gcn"][2], "GCN"),
             "math": (cfgs["math_gin"][2], "GIN")}, dev)
        kernels_zoo_sym = phase_kernels_zoo(
            {"enron": (cfgs["enron_egcn"][2], "EvolveGCN"),
             "math": (cfgs["math_egcn"][2], "EvolveGCN")}, dev)
        kernels_zoo_ev = phase_kernels_zoo_ev(
            {"enron": (cfgs["enron_gat"][2], "GAT"),
             "math": (cfgs["math_tggat"][2], "TgGAT")}, dev)
        kernels_vgrnn = phase_kernels_vgrnn(cfgs["math_vgrnn"][2], dev)
        kernels_halo = phase_kernels_halo(cfgs["enron"][2],
                                          cfgs["enron_gcn"][2], dev)
        if _OTHER is not None:
            slow = [r for r in _COMPARED
                    if r["dispatched"] and r["ratio"] > 1.05]
            _phase("compare", rows=len(_COMPARED),
                   dispatched=sum(r["dispatched"] for r in _COMPARED),
                   dispatched_over_5_percent=slow, device=smi)
            print(smi)
            return 0
        phase_parity(dev)
        phase_parity_zoo(dev)
        phase_parity_attn(dev)
        phase_parity_recurrent(dev)
        phase_parity_vgrnn(dev)
        phase_parity_pgnn(dev)
        phase_parity_supervised(dev)
        phase_parity_dyn(dev)

        # 4. the paths, counters set to 0 just before and read just after,
        # and where an epoch's time goes on the profiled ones (after the
        # counted run, on the trainer it built)
        launches, results = {}, {}
        for path, (cfg, method, backend, kerns) in PATHS.items():
            run = run_timers_path if method == "TIMERS" else run_path
            launches[path], results[path], trainer = run(
                path, cfgs[cfg], method, backend, kerns, dev)
            if path in PROFILED:
                phase_profile(path, trainer, _epoch_kw(cfgs[cfg][2]),
                              results[path][-1]["setup_seconds"],
                              PROFILED_EPOCHS, warm=True)
            if path in MODEL_FILE_PATHS:
                phase_model_file(path, trainer, work / "model_file", dev)
            del trainer
        first = {p: results[p][0]["losses"][0]
                 for p in ("enron_bf16", "enron_highest")}
        gap = (abs(first["enron_bf16"] - first["enron_highest"])
               / abs(first["enron_highest"]))
        _phase("path", path="enron_bf16", first_epoch_losses=first,
               relative_gap=gap, limit=ENRON_LOSS_GAP,
               **_enron_acc_gate(cfgs["enron"][2]))
        if not gap < ENRON_LOSS_GAP:
            raise AssertionError(f"Enron first-epoch loss: bf16 against "
                                 f"highest {gap:.3e} apart")
        with _nccl_group_of_one(dev):
            launches.update(phase_dist(dist_runs, dev))
            launches["pipeline"] = phase_pipeline(cfgs["as"][2], dev)
        launches["as_trace"] = phase_trace("as_trace", cfgs["as_trace"],
                                           dev)
        launches["remat"] = phase_remat(cfgs["as"][2], dev)
        launches["window_tail"] = phase_window_tail(cfgs["uci"][2], dev)
        for path in ("uci_vgrnn", "math_vgrnn"):
            phase_vgrnn_memory(path, cfgs[path][2], dev)
        for path in ("uci_pgnn", "aa_pgnn", "math_pgnn"):
            phase_pgnn(path, cfgs[path][2], dev)
        for path in DYN_PROFILED:
            phase_dyn(path, PATHS[path][1], cfgs[path][2], dev)

        # 5. model quality and the other evaluation tasks, counters set to
        # 0 just before and read just after (UCI and America-Air train on
        # the blocks backend, and evaluation runs no kernel of ours)
        _zero_launches()
        t0 = time.time()
        worker_launches = {}
        with quality_pool() as pool:
            # America-Air's 50-epoch seeds first: the longest runs
            snode = {path: snode_jobs(work / "america_air", path, pool,
                                      "cuda")
                     for path in SNODE_QUALITY}
            methods = phase_quality(work / "uci", "cuda",
                                    tuple(DYN_QUALITY_PATHS.values()), pool,
                                    worker_launches)
            for path in SNODE_QUALITY:
                phase_quality_snode(path, results[path], snode[path],
                                    worker_launches)
        phase_eval(work / "uci", methods[0], work / "america_air", "cuda")
        launches["evaluation"] = {
            name: n + worker_launches.get(name, 0)
            for name, n in _launches().items()}
        _phase("eval", check="device against cpu",
               **phase_device_vs_cpu(work / "uci", methods[0], dev))
        _phase("eval", total_seconds=time.time() - t0,
               launches=launches["evaluation"])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    entries = []
    for name in KERNELS:
        by_path = {p: n[name] for p, n in launches.items()}
        if name in F32_KERNELS:
            rows = {**kernels[name], "ell_as": kernels_ell[name],
                    "zoo": kernels_zoo[name], "zoo_ev": kernels_zoo_ev[name],
                    "zoo_sym": kernels_zoo_sym[name]}
            if name in kernels_vgrnn:
                rows["zoo_vgrnn"] = kernels_vgrnn[name]
            rows["halo"] = kernels_halo.get(name, [])
            status = ("matches its plain versions, launched on the pallas "
                      "and ELL paths and on the zoo's plans, with the "
                      "plans' values (EvolveGCN's and VGRNN's symmetric "
                      "ones too) and with GAT's per-step values, and on "
                      "the halo paths' part plans")
        else:
            rows = kernels_bf16[name]
            status = ("matches its plain version (bf16 and f32 out), "
                      "launched on the bf16 ELL paths")
        entries.append({
            "name": name, "route": "cuda",
            "source": "ctgcn_torch/csrc/bsr_spmm.cu",
            "replaces": KERNELS[name], "status": status,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **rows})
    print(json.dumps({"kernels": entries}))
    _phase("total", seconds=time.time() - t_start)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
