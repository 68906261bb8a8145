"""The cell of VGRNN under U-own at the tiny size (``tiny_cells``): it runs
``correct`` through the harness's CPU entry with its exact checks; its
faults, a Gram at a lower precision and the control come out not correct;
the noise recorder's check of the draws' pairs; and the readers of the
VAE loss's spans on a small synthetic traced run."""
import json
import os
import subprocess
import sys

import pytest
import torch

import program_spans
import tiny
import tiny_cells
from draws import noise
from gram_bound import embed_dim, gram_bound_s
from metrics import gram_ms, gram_roofline, loss_work_ms

EXACT = {"vgrnn.tiny.uown": {"target_mismatch", "conv_mismatch",
                             "gram_faults", "draw_faults"}}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_cells.make_checkout(str(tmp_path_factory.mktemp("co") / "co"))


@pytest.mark.parametrize("cell", tiny_cells.CELLS)
def test_tiny_cell_is_correct_and_its_control_is_not(checkout, cell,
                                                     tmp_path):
    out = tiny.run_cpu(checkout, cell, 2**31 + 11, control=True,
                       tmp=str(tmp_path))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"epoch_ms", "peak_mem_gb", "setup_s"}
    exact = {k for k, (v, lim) in out["checks"].items() if lim == 0}
    assert exact == EXACT[cell]
    assert out["modules"] == []
    assert out["control_correct"] is False, out["control_checks"]
    failed = [k for k, (v, lim) in out["control_checks"].items()
              if not v <= lim]
    assert failed and all(k not in EXACT[cell] for k in failed)
    stats = out["stats"]
    assert stats["noise_pair_z"] < noise.Z_LIMIT
    assert 0 < stats["gram_grad_gap"] <= tiny_cells.GRAM_LIMITS["grad_gap"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("cell", tiny_cells.CELLS)
def test_a_fault_is_not_correct(checkout, cell, fault, tmp_path):
    out = tiny.run_cpu(checkout, cell, 99, fault=fault, tmp=str(tmp_path))
    assert not out["correct"], out["checks"]


def test_a_bf16_gram_is_not_correct(checkout, tmp_path):
    """z rounded to bfloat16 inside the dense softplus sum alone, the rest
    of the program in float32: ``gram_faults`` fails."""
    code = (
        "import sys, json, torch; sys.path.insert(0, 'gpubench');"
        "import harness; from program import patched;"
        "make = lambda orig: lambda z: orig(z.bfloat16().float());"
        "ctx = patched('ctgcn_torch.losses', 'softplus_gram_sum', make);"
        "ctx.__enter__();"
        "print(json.dumps(harness.run_cpu('vgrnn.tiny.uown', 5)))")
    env = dict(os.environ, PYTHONPATH=checkout, OMP_NUM_THREADS="2",
               TMPDIR=str(tmp_path))
    done = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert not out["correct"]
    assert out["checks"]["gram_faults"][0] > 0, out["checks"]
    assert out["stats"]["gram_grad_gap"] > tiny_cells.GRAM_LIMITS["grad_gap"]


def test_the_noise_pairs_check_finds_a_repeated_draw():
    """Independent draws read about a standard normal a pair; a repeated
    or a negated draw reads sqrt(m)."""
    g = torch.Generator().manual_seed(3)
    draws = [torch.randn(300, 8, generator=g) for _ in range(6)]
    assert noise.pair_z(draws).abs().max() < noise.Z_LIMIT
    for bad in (draws[1], -draws[1]):
        z = noise.pair_z(draws + [bad.clone()]).abs()
        assert z[1, 6] == pytest.approx(2400 ** 0.5)
        assert int((z > noise.Z_LIMIT).sum()) == 2
    rec = noise.Recorder()
    rec.noise = draws[:3] + [draws[0].clone()]
    rec.stats = [(0.0, 0.0)] * 4
    steps = [[{}, {}]]
    assert rec.attach(steps) == 1
    assert len(steps[0][0]["draws"]["noise"]) == 2
    assert rec.stats[3][2] == pytest.approx(2400 ** 0.5)


H100 = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
DTOH = "Memcpy DtoH (Device -> Pinned)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8"


def _span(name, parent, dev):
    """(name, parent, host ns, host ns, device ms, device start ms) on one
    clock (the events read 0 where the trace does)."""
    return (name, parent, 0, 1, (dev[1] - dev[0]) / 1e3, dev[0] / 1e3)


# an epoch of a U-own batch and of a supervised step with its validation,
# in trace us: the loss (its gram inside) forward and backward, each
# readback's copy queued behind the work before it (the clock's anchors)
SPANS = [("epoch", -1, (0, 5000)),
         ("loss", 0, (0, 1200)), ("gram", 1, (100, 1000)),
         ("loss", 0, (1200, 3000)), ("gram", 3, (1300, 2900)),
         ("readback", 0, (3000, 3100)),
         ("validate", 0, (3100, 4000)),
         ("readback", 0, (4000, 4100))]
OPS = [(GEMM, 0, 1200), (GEMM, 1300, 1700), (DTOH, 3000, 5),
       (GEMM, 3100, 500), (GEMM, 3700, 300), (DTOH, 4000, 5)]
COUNTERS = {"engine.epochs": 1, "vae.gram_pairs_fwd": 4000 ** 2,
            "vae.gram_pairs_bwd": 4000 ** 2, "vae.gram_chunks": 2}


def _ctx(spans=SPANS, counters=COUNTERS):
    prog = {"spans": [_span(*s) for s in spans], "spmm": [],
            "counters": dict(counters)}
    return {"program": prog, "trace": {"epochs": 1, "ops": list(OPS)},
            "peaks": H100, "precision": "float32"}


def test_the_readers_on_a_recorded_trace():
    found = program_spans.clock(_ctx())
    assert found["anchors"] == 2 and found["residual_us"] == 0
    # the loss: 1,200 + 1,800 us between its events; no idle in the first,
    # 100 us before the backward's first GEMM in the second
    assert loss_work_ms.read(_ctx()) == pytest.approx(2.9)
    # the gram spans, 900 + 1,600 us, hold no idle
    assert gram_ms.read(_ctx()) == pytest.approx(2.5)
    # the configuration of ``gram_roofline``'s cell, vgrnn.enron
    assert embed_dim() == 128
    bound = gram_bound_s(COUNTERS, 128, H100["fp32_flops"])
    assert bound == pytest.approx(6 * 4000 ** 2 * 128 / 67e12)
    assert gram_bound_s(COUNTERS, None, H100["fp32_flops"]) is None
    assert gram_roofline.read(_ctx()) == pytest.approx(100 * bound / 2.5e-3)


@pytest.mark.parametrize("reader", [gram_ms, gram_roofline, loss_work_ms],
                         ids=lambda r: r.__name__)
def test_a_program_without_the_spans_reads_nothing(reader):
    """A parent of the spans (a VAE loss without ``loss`` and ``gram``)
    gives no reading."""
    assert reader.read({"trace": None, "peaks": H100,
                        "precision": "float32"}) is None
    bare = [s for s in SPANS if s[0] in ("epoch", "readback")]
    assert reader.read(_ctx(bare, {"engine.epochs": 1})) is None
