"""The readers of the program's spans and counters on a small synthetic
traced run of two epochs.  Times are in us of the device trace; the
spans' events run on a clock ``OFF`` behind it, the host's ``HOST``
ahead.  Each reader gives nothing without the program's
trace."""
import pytest

import program_spans
from metrics import (core_rnn_ms, core_rnn_valid_share, engine_idle_ms,
                     loss_span_ms, spmm_span_roofline)
from roofline import spmm_bound_s

H100 = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
READERS = (loss_span_ms, spmm_span_roofline, core_rnn_ms,
           core_rnn_valid_share, engine_idle_ms)
HOST, OFF = 1_000_000.0, 250.0
HTOD = "Memcpy HtoD (Pageable -> Device)"
DTOH = "Memcpy DtoH (Device -> Pinned)"


def _span(name, parent, host, dev):
    """(name, parent, host ns, host ns, device ms, device start ms)."""
    return (name, parent, int((HOST + host[0]) * 1e3),
            int((HOST + host[1]) * 1e3), (dev[1] - dev[0]) / 1e3,
            (dev[0] - OFF) / 1e3)


# (name, parent, host interval, device interval) in trace us; the
# events' clock reads 0 at OFF, where epoch 1 opens
SPANS = [
    ("epoch", -1, (250, 4900), (250, 5000)),
    ("batch_plan", 0, (250, 1250), (250, 1250)),
    ("batch_inputs", 0, (1250, 1500), (1250, 1500)),     # idle before
    ("core_rnn", 0, (1500, 1550), (1500, 2100)),
    ("loss", 0, (1550, 1600), (2100, 3500)),
    ("batch_inputs", 0, (1600, 3620), (3500, 3620)),     # queued
    ("spmm", 0, (3620, 3640), (3620, 3700)),             # idle before
    ("optimizer", 0, (3640, 3700), (3700, 4500)),
    ("readback", 0, (3000, 4800), (4500, 4800)),         # queued
    ("epoch", -1, (5000, 10000), (5000, 10000)),
    ("batch_plan", 9, (5000, 6000), (5000, 6000)),
    ("batch_inputs", 9, (6000, 6300), (6000, 6300)),     # idle before
    ("spmm", 9, (7000, 7020), (9000, 9100)),             # queued
    ("readback", 9, (7020, 9500), (9100, 9500)),         # queued
]
SPMM = "void (anonymous namespace)::blockpar_chunk_kernel<float, float, 4>"
OPS = [(HTOD, 1400, 10), (HTOD, 1450, 10), ("k", 1500, 500),
       ("k", 2200, 1300), (HTOD, 3500, 10), (HTOD, 3560, 10),
       (SPMM, 3620, 60), ("k", 3800, 700), (DTOH, 4500, 5),
       (HTOD, 6150, 10), (HTOD, 6250, 10), ("k", 6300, 2700),
       (SPMM, 9000, 80), (DTOH, 9100, 7)]
# device idle by innermost span over both epochs; the 1,150 us before the
# first op (batch_plan, then batch_inputs) left out
IDLE = {"batch_plan": 1000, "batch_inputs": 80 + 100 + 280, "core_rnn": 100,
        "loss": 100, "spmm": 20 + 20, "optimizer": 100, "readback": 295 + 393,
        "epoch": 200 + 500}
ANCHORED = [(3250, OFF), (4250, OFF), (8750, OFF), (8850, OFF)]


def _ctx(spans=SPANS, ops=OPS):
    prog = {"spans": [_span(*s) for s in spans],
            "spmm": [(1000, 100, 50, 128, "bsr_spmm_blockpar")] * 2,
            "counters": {"engine.epochs": 2, "core_rnn.slot_steps": 44,
                         "core_rnn.valid_slot_steps": 31}}
    return {"program": prog, "trace": {"epochs": 2, "ops": list(ops)},
            "peaks": H100}


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_no_program_trace_reads_nothing(reader):
    assert reader.read({"trace": None, "peaks": H100}) is None
    ctx = _ctx()
    ctx["program"] = None
    assert reader.read(ctx) is None


def test_loss_span_ms_is_the_work_between_its_events():
    # 1,400 us between the events, 100 of them idle
    assert loss_span_ms.read(_ctx()) == pytest.approx(1.3 / 2)


def test_core_rnn_ms_and_valid_share():
    assert core_rnn_ms.read(_ctx()) == pytest.approx(0.5 / 2)
    assert core_rnn_valid_share.read(_ctx()) == pytest.approx(100 * 31 / 44)


def test_spmm_span_roofline():
    bound = spmm_bound_s(1000, 100, 50, 128, H100)
    # 180 us between the two spans' events, 40 of them idle
    assert spmm_span_roofline.read(_ctx()) == pytest.approx(
        100 * 2 * bound / 140e-6)


def test_the_clock_and_idle_by_innermost_span():
    found = program_spans.clock(_ctx())
    # the queued anchors: a batch's copies, both readbacks, the second
    # SpMM (the first copies and SpMM follow idle time)
    assert found["clock"] == ANCHORED
    assert found["residual_us"] == 0 and found["anchors"] == 4
    assert found["idle_us"] == pytest.approx(IDLE)
    assert engine_idle_ms.read(_ctx()) == pytest.approx(
        (1000 + 460 + 100 + 688) / 1e3 / 2)


def test_the_clock_follows_a_drift_between_anchors():
    clock = [(0.0, 100.0), (1000.0, 110.0), (2000.0, 100.0)]
    assert program_spans.on_trace(clock, 500) == pytest.approx(605)
    assert program_spans.on_trace(clock, -50) == pytest.approx(50)
    assert program_spans.on_trace(clock, 2500) == pytest.approx(2600)
    # the second SpMM's kernel starts 10 us later on the trace's clock
    ops = [op if op[1] != 9000 else (SPMM, 9010, 70) for op in OPS]
    found = program_spans.clock(_ctx(ops=ops))
    assert found["clock"][2] == (8750, OFF + 10)
    # it misses the clock of the others by 10 us, and so does the last
    assert found["residual_us"] == pytest.approx(10)


def test_a_loop_without_engine_spans_has_no_engine_idle():
    spans = [s if s[0] not in program_spans.ENGINE else ("x",) + s[1:]
             for s in SPANS]
    assert engine_idle_ms.read(_ctx(spans)) is None
    assert spmm_span_roofline.read(_ctx(spans)) is not None


def test_one_anchor_has_no_residual():
    found = program_spans.clock(_ctx(SPANS[:8], OPS[:8]))
    assert found["anchors"] == 1 and found["residual_us"] is None
    assert found["clock"] == [(3250, OFF)]


def test_no_anchor_no_clock():
    # every copy and SpMM kernel 40 us or more after the op before it
    ops = [(n, t + (80 if t == 9100 else 40), d) if n != "k" else (n, t, d)
           for n, t, d in OPS]
    ctx = _ctx(ops=ops)
    assert program_spans.clock(ctx) is None
    for reader in (loss_span_ms, engine_idle_ms, spmm_span_roofline):
        assert reader.read(ctx) is None
    assert core_rnn_valid_share.read(ctx) == pytest.approx(100 * 31 / 44)


def test_the_session_is_the_traced_runs():
    """Without ``ctx["program"]``, the program's last trace, when its
    epochs are the traced run's."""
    from ctgcn_torch.training import profiling
    with profiling.tracing("cpu"):
        with profiling.span("epoch"):
            profiling.count("engine.epochs")
    got = program_spans.session({"trace": {"epochs": 1}})
    assert [s[0] for s in got["spans"]] == ["epoch"]
    assert got["spans"][0][4:] == (None, None)        # no device off CUDA
    assert got["counters"] == {"engine.epochs": 1}
    assert program_spans.session({"trace": {"epochs": 2}}) is None
