# coding: utf-8
"""The program's spans and counters (``ctgcn_torch.training.profiling``)
on the CPU:

  * tracing off: ``negative_sampling_loss`` and ``core_rnn_sum`` build the
    autograd graph and run the aten ops of the computation without its
    spans (the sampler and the loss called directly; ``_CoreRnnSum``
    applied directly), and no span is kept;
  * tracing on, over a small CTGCN-C U-neg window driven by the CLI: the
    span names, ``loss`` and ``core_rnn`` under ``epoch``, one ``loss``
    span a batch and direction, the counters against hand counts (the
    core slots from the pyramid's ``valid`` on the host), and the losses
    bit-equal to the run with tracing off;
  * a training loop profiled from outside, U-neg or supervised, keeps
    its spans (``last_trace``), and ``EpochTracer`` still writes one
    trace, in which the spans are named ranges;
  * a plan's ``cols_read``, which the SpMM spans' records carry.
"""
import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ctgcn_torch import main as cli
from ctgcn_torch.losses import (WalkData, negative_sampling_loss,
                                sample_uneg, uneg_loss)
from ctgcn_torch.ops import bsr_spmm, rnn
from ctgcn_torch.training import profiling
from ctgcn_torch.training.engine import SupervisedEmbedding

ROOT = Path(__file__).resolve().parent.parent
N, SNAPS, EPOCHS = 60, 3, 2
ENGINE_SPANS = {"epoch", "batch_plan", "batch_inputs", "optimizer",
                "readback"}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _graph(t):
    """The sorted node names of ``t``'s autograd graph."""
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return sorted(names)


def _run(fn):
    """(output, its graph, the aten ops of the forward and backward)."""
    ops = _Ops()
    with ops:
        out = fn()
        out.sum().backward()
    return out.detach(), _graph(out), ops.names


def _walk(rng, T=2, n=12, width=64):
    deg = rng.integers(0, 9, (T, n)).astype(np.int32)
    off = np.concatenate([np.zeros((T, 1), np.int32),
                          np.cumsum(deg, 1)[:, :-1]], 1).astype(np.int32)
    flat = rng.integers(0, n, (T, width)).astype(np.int32)
    logits = np.log(rng.random((T, n)) + 0.1).astype(np.float32)
    return WalkData(*map(torch.from_numpy, (flat, off, deg, logits)))


def test_off_the_loss_adds_no_node_and_no_op():
    walk = _walk(np.random.default_rng(0))
    embs0 = torch.randn(2, 12, 8)
    b_idx, b_mask = torch.arange(6), torch.tensor([True] * 5 + [False])
    last = profiling.last_trace()

    def plain():
        g = torch.Generator().manual_seed(3)
        embs = embs0.clone().requires_grad_()
        j, neg = sample_uneg(walk, b_idx, 4, g)
        return uneg_loss(embs, b_idx, b_mask, walk, j, neg, Q=5.0)

    def spanned():
        g = torch.Generator().manual_seed(3)
        embs = embs0.clone().requires_grad_()
        return negative_sampling_loss(embs, b_idx, b_mask, walk, g,
                                      neg_num=4, Q=5.0)

    assert profiling.active() is None
    want, got = _run(plain), _run(spanned)
    assert torch.equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
    assert profiling.last_trace() is last


@pytest.mark.parametrize("k_batched", [True, False])
def test_off_the_core_rnn_adds_no_node_and_no_op(k_batched):
    torch.manual_seed(0)
    cell = rnn.GRUCell(6, 5)
    acc0 = torch.randn(4, 7, 6)
    valid = torch.tensor([1.0, 1.0, 1.0, 0.0])
    budget = rnn.CVJP_BATCH_BUDGET if k_batched else 0
    last = profiling.last_trace()

    def plain():
        cell.zero_grad(set_to_none=True)
        acc = acc0.clone().requires_grad_()
        return rnn._CoreRnnSum.apply(acc, valid, cell.w_ih, cell.w_hh,
                                     cell.b_ih, cell.b_hh, False, budget)

    def spanned():
        cell.zero_grad(set_to_none=True)
        acc = acc0.clone().requires_grad_()
        return rnn.core_rnn_sum(cell, acc, valid, budget, kept=3)

    steps = profiling.counter("core_rnn.slot_steps")
    kept = profiling.counter("core_rnn.valid_slot_steps")
    want, got = _run(plain), _run(spanned)
    assert torch.equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
    assert profiling.counter("core_rnn.slot_steps") == steps + 4
    assert profiling.counter("core_rnn.valid_slot_steps") == kept + 3
    assert profiling.last_trace() is last


def test_span_off_is_one_shared_no_op():
    assert profiling.span("a") is profiling.span("b")
    assert profiling.backward_span("a") is profiling.backward_span("b")
    x = torch.ones(2, requires_grad=True)
    assert profiling.backward_span("a").enter(x) is x
    profiling.count("test.spans", 2)
    assert profiling.counter("test.spans") == 2
    profiling.reset_counters("test.")
    assert profiling.counter("test.spans") == 0


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Three snapshots of a small weighted graph, preprocessed by the
    port's CLI, and configs/uci.json's CTGCN-C entry narrowed to test
    size (one window of two epochs, two batches each, no export)."""
    base = tmp_path_factory.mktemp("spans")
    rng = np.random.default_rng(1)
    (base / "nodes_set").mkdir()
    (base / "nodes_set" / "nodes.csv").write_text(
        "\n".join(f"u{i}" for i in range(N)) + "\n")
    (base / "1.format").mkdir()
    for t in range(SNAPS):
        core = rng.choice(N, 14, replace=False)
        edges = [(a, b) for a in core for b in core
                 if a < b and rng.random() < 0.5]
        edges += list(zip(rng.integers(0, N, 200), rng.integers(0, N, 200)))
        (base / "1.format" / f"2010-0{t + 1}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"u{a}\tu{b}\t{rng.integers(1, 5)}\n" for a, b in edges))
    with open(ROOT / "configs" / "uci.json") as fp:
        uci = json.load(fp)
    pre = dict(uci["preprocessing"]["CTGCN-C"], base_path=str(base),
               walk_time=2)
    emb = dict(uci["embedding"]["CTGCN-C"], base_path=str(base),
               duration=SNAPS, hid_dim=8, embed_dim=4, batch_size=30,
               neg_num=3, epoch=EPOCHS, export=False, record_time=False,
               embed_folder="2.embedding/spans", model_file="spans")
    cfg = base / "cfg.json"
    cfg.write_text(json.dumps({"preprocessing": {"CTGCN-C": pre}}))
    cli.main([f"--config={cfg}", "--task=preprocessing", "--method=CTGCN-C",
              "--device=cpu"])
    return base, emb


def _train(dataset, tmp_path, **change):
    """The CLI's embedding task on the narrowed entry: its last window's
    result (with the trainer)."""
    _, emb = dataset
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"embedding": {"CTGCN-C": dict(emb,
                                                              **change)}}))
    with contextlib.redirect_stdout(io.StringIO()):
        results = cli.main([f"--config={path}", "--task=embedding",
                            "--method=CTGCN-C", "--device=cpu"])
    assert len(results) == 1
    return results[0]


def test_traced_window(dataset, tmp_path):
    off = _train(dataset, tmp_path)
    with profiling.tracing("cpu") as trace:
        on = _train(dataset, tmp_path)
    assert on["losses"] == off["losses"]          # bit-equal
    spans, counters = trace.spans, trace.counters
    names = {s.name for s in spans}
    assert names == ENGINE_SPANS | {"loss", "core_rnn"}
    assert all(s.end_ns > s.start_ns and s.device_ms is None
               and s.device_start_ms is None for s in spans)
    for s in spans:
        if s.name == "epoch":
            assert s.parent == -1
        else:
            assert spans[s.parent].name == "epoch"
    trainer = on["trainer"]
    batches = -(-N // 30)
    layers = len(trainer.model.cdns[0].layers)
    valid = trainer.data["adjs"].valid.cpu().numpy()      # [T, K], host
    forwards = EPOCHS * batches
    assert sum(s.name == "loss" for s in spans) == 2 * forwards
    assert sum(s.name == "epoch" for s in spans) == EPOCHS
    assert counters["engine.epochs"] == EPOCHS
    assert trace.spmm == []                 # the CPU launches no kernel
    assert counters["core_rnn.slot_steps"] == forwards * layers * valid.size
    assert counters["core_rnn.valid_slot_steps"] == (
        forwards * layers * int(valid.sum()))
    assert 0 < valid.sum() < valid.size
    assert profiling.last_trace() is trace and profiling.active() is None


def test_a_loop_profiled_from_outside_keeps_its_spans(dataset, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _train(dataset, tmp_path, epoch=1)
    trace = profiling.last_trace()
    assert trace.counters["engine.epochs"] == 1
    assert [s.name for s in trace.spans if s.parent == -1] == ["epoch"]


def test_epoch_tracer_names_the_spans(dataset, tmp_path):
    prof = tmp_path / "prof"
    _train(dataset, tmp_path, epoch=3, profile_dir=str(prof))
    traces = sorted(prof.iterdir())
    assert len(traces) == 1
    with open(traces[0]) as fp:
        events = json.load(fp)["traceEvents"]
    ranges = [e["name"] for e in events
              if e.get("cat") in ("user_annotation", "cpu_op")]
    assert ranges.count("epoch") == 2               # epochs 1-2
    assert ENGINE_SPANS | {"loss", "core_rnn"} <= set(ranges)
    assert ranges.count("loss") == 2 * 2 * -(-N // 30)


def test_a_supervised_loop_profiled_from_outside_keeps_its_epochs(tmp_path):
    """The supervised trainer's loop: one ``epoch`` span an epoch and
    ``engine.epochs``, under a profiler opened by its caller."""
    from torch.profiler import ProfilerActivity, profile
    (tmp_path / "origin").mkdir()
    (tmp_path / "origin" / "2001.csv").write_text("")
    model = torch.nn.Linear(4, 3)
    split = (torch.tensor([[0, 1, 2]]), torch.tensor([[0, 1, 2]]),
             torch.ones(1, 3, dtype=torch.bool))

    def loss_fn(preds, labels, mask, aux):
        return torch.nn.functional.cross_entropy(preds, labels[0]), \
            torch.tensor(0.5)

    trainer = SupervisedEmbedding(
        base_path=str(tmp_path), origin_folder="origin",
        embedding_folder="emb", node_list=list(range(5)), model=model,
        classifier=None,
        forward_fn=lambda m, c, d, items, generator=None: (
            m(d["x"])[items[0]], None),
        loss_fn=loss_fn, embed_fn=lambda m, d: m(d["x"]),
        auc_fn=lambda p, y, m: 0.5, data={"x": torch.randn(5, 4)},
        splits=dict.fromkeys(("train", "val", "test"), split), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.learn_embedding(epoch=3, model_file=None,
                                classifier_file=None, export=False,
                                verbose=False)
    trace = profiling.last_trace()
    assert trace.counters["engine.epochs"] == 3
    assert [s.name for s in trace.spans] == ["epoch"] * 3


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
def test_cols_read_counts_the_columns_with_a_nonzero(density):
    mat = sp.random(40, 70, density=density, format="csr",
                    random_state=np.random.default_rng(2))
    mat.data[::3] = 0.0                      # stored zeros are left out
    plan = bsr_spmm.build_csr_plan(mat)
    cols = plan.csr_col.numpy()
    assert plan.cols_read == np.unique(cols).size
    assert plan.cols_read < 70 or density == 0.5
    moved = bsr_spmm.with_row_order(plan, np.arange(40)[::-1])
    assert moved.cols_read == plan.cols_read
