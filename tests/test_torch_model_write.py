# coding: utf-8
"""The port's model files in the JAX package: ``save_model_file`` writes
flax msgpack (``interop.params_to_numpy``, ``training.model_file``'s
encoder), and ``ctgcn_tpu.training.engine.load_params`` reads it into the
JAX model of the same family, leaves equal to the port's parameters.

For every family of ``tests/test_torch_model_file.py``'s ``MODELS`` and
the variants whose JAX trees hold other empty fields (a layer without
bias, PGNN without ``feature_pre`` or at one or three layers, GIN's
one-layer inner MLPs, GCRN's LSTM, EvolveGCN's EGCNO, VGRNN's GIN
convolutions, CTGCN-S, CGCN-C, DynAE, DynAERNN, SAGE) and both heads:

* the JAX package's ``load_params`` reads the port's file and its leaves
  are the port's parameters exactly;
* the decoded trees of the port's file and of JAX's own ``to_bytes`` for
  the same model have the same keys, ``None`` and empty fields, shapes
  and dtypes;
* with the JAX parameters loaded, the port's file is byte-equal to flax's
  ``msgpack_serialize`` of the JAX state dict (the writer sorts each map's
  keys as flax's copy of a tree does).

Also: a chunked file (``MAX_CHUNK_SIZE`` made small on both sides), a
bf16 run's file (float32 leaves), a file saved over two gloo parts
(byte-equal to the single-device file), an old ``torch.save`` archive
that still loads, and a JAX CLI run with ``load_model: true`` over the
model folder the port's DynGEM CLI wrote."""
import json
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from flax import serialization

from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.nn import core_models as TM
from ctgcn_torch.nn import heads as TH
from ctgcn_torch.nn.egcn import EvolveGCN as TEvolveGCN
from ctgcn_torch.nn.gcn import GCN as TGCN
from ctgcn_torch.nn.gcn import GCRN as TGCRN
from ctgcn_torch.nn.gin import GIN as TGIN
from ctgcn_torch.nn.pgnn import PGNN as TPGNN
from ctgcn_torch.nn.sage import SAGE as TSAGE
from ctgcn_torch.nn.vgrnn import VGRNN as TVGRNN
from ctgcn_torch.training import model_file as MFILE
from ctgcn_torch.training.engine import (load_model_file, make_optimizer,
                                         read_model_file, save_model_file)
from ctgcn_tpu import main as jcli
from ctgcn_tpu.nn import core_models as JM
from ctgcn_tpu.nn import egcn as JE
from ctgcn_tpu.nn import heads as JH
from ctgcn_tpu.nn import pgnn as JP
from ctgcn_tpu.nn import vgrnn as JV
from ctgcn_tpu.nn.gcn import GCN as JGCN
from ctgcn_tpu.nn.gcn import GCRN as JGCRN
from ctgcn_tpu.nn.gin import GIN as JGIN
from ctgcn_tpu.nn.sage import SAGE as JSAGE
from ctgcn_tpu.training.engine import load_params
from tests import _torch_dist_ranks
from tests import test_torch_backends as BK
from tests import test_torch_dynae as DY
from tests import test_torch_model_file as MF
from tests.test_torch_dynae import dataset as dyn_dataset  # noqa: F401
from tests.test_torch_precision import _build as _precision_build

N, FEAT, HID, EMB, T = 20, 6, 8, 5, 3


def _models(build):
    return lambda: build()[:2]


def _k(i):
    return jax.random.key(100 + i)


#: family -> () -> (JAX model, the port's model of the same shapes)
WRITE_MODELS = {name: _models(build) for name, build in MF.MODELS.items()}
WRITE_MODELS.update({
    "CTGCN-S": lambda: (
        JM.CTGCN.init(_k(0), N, HID, EMB, 2, 2, T, model_type="S"),
        TM.CTGCN(N, HID, EMB, 2, 2, T, model_type="S")),
    "CGCN-C": lambda: (JM.CGCN.init(_k(1), N, HID, EMB, 1, 2),
                       TM.CGCN(N, HID, EMB, 1, 2)),
    "GCN-no-bias": lambda: (JGCN.init(_k(2), N, HID, EMB, bias=False),
                            TGCN(N, HID, EMB, bias=False)),
    "GIN": lambda: (JGIN.init(_k(3), N, HID, EMB, 2, 2),
                    TGIN(N, HID, EMB, 2, 2)),
    "GIN-one-layer-mlps": lambda: (
        JGIN.init(_k(4), N, HID, EMB, 3, 1, bias=False),
        TGIN(N, HID, EMB, 3, 1, bias=False)),
    "SAGE": lambda: (JSAGE.init(_k(5), FEAT, HID, EMB, num_sample=3),
                     TSAGE(FEAT, HID, EMB, num_sample=3)),
    "GCRN": lambda: (JGCRN.init(_k(6), N, HID, EMB, T),
                     TGCRN(N, HID, EMB, T)),
    "GCRN-LSTM-no-bias": lambda: (
        JGCRN.init(_k(7), FEAT, HID, EMB, T, rnn_type="LSTM", bias=False),
        TGCRN(FEAT, HID, EMB, T, rnn_type="LSTM", bias=False)),
    "EvolveGCN-O": lambda: (JE.EvolveGCN.init(_k(8), FEAT, HID, EMB, "EGCNO"),
                            TEvolveGCN(FEAT, HID, EMB, "EGCNO")),
    "VGRNN-GIN": lambda: (JV.VGRNN.init(_k(9), N, HID, EMB, conv_type="GIN"),
                          TVGRNN(N, HID, EMB, conv_type="GIN")),
    "PGNN-one-layer": lambda: (
        JP.PGNN.init(_k(10), FEAT, 4, HID, EMB, feature_pre=False,
                     layer_num=1),
        TPGNN(FEAT, 4, HID, EMB, feature_pre=False, layer_num=1)),
    "PGNN-three-layers": lambda: (
        JP.PGNN.init(_k(11), N, 4, HID, EMB, layer_num=3),
        TPGNN(N, 4, HID, EMB, layer_num=3)),
    "DynAE": lambda: (DY._jax_model("DynAE"), DY._torch_model("DynAE")),
    "DynAERNN": lambda: (DY._jax_model("DynAERNN"),
                         DY._torch_model("DynAERNN")),
    "MLPClassifier": lambda: (
        JH.MLPClassifier.init(_k(12), EMB, HID, 3, 2, activate_type="N"),
        TH.MLPClassifier(EMB, HID, 3, 2, activate_type="N")),
    "EdgeClassifier": lambda: (
        JH.EdgeClassifier.init(_k(13), EMB, HID, 2, 1),
        TH.EdgeClassifier(EMB, HID, 2, 1)),
})


def _jax_tree(jmodel):
    return jax.tree.map(np.asarray, serialization.to_state_dict(jmodel))


def _layout(tree):
    """A decoded tree's keys, empty fields, shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if tree is None:
        return None
    return (tree.shape, tree.dtype.name)


def _raw_layout(buf):
    """``_layout`` of flax's own decoding of ``buf`` (bfloat16 kept)."""
    return _layout(jax.tree.map(np.asarray, serialization.msgpack_restore(
        buf)))


def _assert_leaves_are_the_ports(jloaded, tmodel):
    """Every leaf JAX restored is the port's parameter, bit for bit."""
    got = params_from_numpy(_jax_tree(jloaded))
    want = tmodel.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name


@pytest.mark.parametrize("family", sorted(WRITE_MODELS))
def test_port_model_file_loads_in_jax(tmp_path, family):
    jmodel, tmodel = WRITE_MODELS[family]()
    path = tmp_path / "model"
    save_model_file(tmodel, str(path))
    raw = path.read_bytes()
    assert not raw.startswith(b"PK")
    _assert_leaves_are_the_ports(load_params(jmodel, str(path)), tmodel)
    assert _raw_layout(raw) == _raw_layout(serialization.to_bytes(jmodel))
    tmodel.load_state_dict(params_from_numpy(_jax_tree(jmodel)))
    save_model_file(tmodel, str(path))
    assert path.read_bytes() == serialization.msgpack_serialize(
        serialization.to_state_dict(jmodel))


def test_chunked_file_loads_in_jax(tmp_path, monkeypatch):
    """With ``MAX_CHUNK_SIZE`` 256 bytes on both sides every CTGCN-C leaf
    above it is written as flax's chunked map: the same bytes as flax
    writes, read by ``load_params`` and by the port."""
    jmodel, tmodel = WRITE_MODELS["CTGCN-C"]()
    tmodel.load_state_dict(params_from_numpy(_jax_tree(jmodel)))
    monkeypatch.setattr(MFILE, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    path = tmp_path / "chunked"
    save_model_file(tmodel, str(path))
    raw = path.read_bytes()
    assert raw.count(b"__msgpack_chunked_array__") > 3
    assert raw == serialization.msgpack_serialize(
        serialization.to_state_dict(jmodel))
    monkeypatch.undo()
    _assert_leaves_are_the_ports(load_params(jmodel, str(path)), tmodel)
    fresh = WRITE_MODELS["CTGCN-C"]()[1]
    load_model_file(fresh, str(path), "cpu")
    for name, value in tmodel.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name


def test_bf16_run_writes_float32_leaves(tmp_path):
    """``matmul_precision: "bf16"`` rounds the bank and the slot products,
    not the parameters: after a bf16 training step on bf16 ELL plans the
    model's parameters are float32, and so is every leaf of its file."""
    tpyr, _ = _precision_build("ell", bf16=True, prec="bf16")
    model = TM.CTGCN(BK.N, BK.HID, BK.EMB, 1, 2, BK.T)
    opt = make_optimizer(list(model.parameters()), 1e-2)
    model(None, tpyr).square().sum().backward()
    opt.step()
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    path = tmp_path / "bf16"
    save_model_file(model, str(path))
    dtypes = {leaf[1] for leaf in jax.tree.leaves(
        _raw_layout(path.read_bytes()), is_leaf=lambda x: isinstance(
            x, tuple))}
    assert dtypes == {"float32"}
    jmodel = JM.CTGCN.init(jax.random.key(0), BK.N, BK.HID, BK.EMB, 1, 2,
                           BK.T)
    _assert_leaves_are_the_ports(load_params(jmodel, str(path)), model)


def test_old_torch_save_archive_still_loads(tmp_path):
    """A ``torch.save`` archive, what the port wrote before, loads as it
    did."""
    _, tmodel = WRITE_MODELS["GCRN"]()
    path = tmp_path / "old"
    torch.save(tmodel.state_dict(), path)
    fresh = TGCRN(N, HID, EMB, T)
    load_model_file(fresh, str(path), "cpu")
    for name, value in tmodel.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name
    assert read_model_file(path).keys() == tmodel.state_dict().keys()


def test_file_saved_over_two_parts_is_the_single_device_file(tmp_path):
    """CTGCN-C (T = 2) and GCRN (T = 4) time-sharded over 2 gloo ranks:
    ``save_model_file`` through the sharding (rank 0 writes the gathered
    model) writes the bytes one device writes, and ``load_params`` reads
    them."""
    built = {"CTGCN-C": (*WRITE_MODELS["CTGCN-C"](),
                         (BK.N, BK.HID, BK.EMB, 1, 2, BK.T)),
             "GCRN": (JGCRN.init(_k(14), N, HID, EMB, 4),
                      TGCRN(N, HID, EMB, 4), (N, HID, EMB, 4))}
    cases = []
    for family, (jmodel, tmodel, args) in built.items():
        tmodel.load_state_dict(params_from_numpy(_jax_tree(jmodel)))
        save_model_file(tmodel, str(tmp_path / f"{family}-single"))
        cases.append({"cls": family, "args": args,
                      "state": {k: v.numpy() for k, v in
                                tmodel.state_dict().items()},
                      "path": str(tmp_path / f"{family}-parts")})
    with open(tmp_path / "save_in.pkl", "wb") as fp:
        pickle.dump({"cases": cases}, fp)
    mp.start_processes(_torch_dist_ranks.main,
                       args=(2, str(tmp_path), ("save",)), nprocs=2,
                       join=True, start_method="spawn")
    for case in cases:
        jmodel, tmodel, _ = built[case["cls"]]
        with open(case["path"], "rb") as fp:
            raw = fp.read()
        assert raw == (tmp_path / f"{case['cls']}-single").read_bytes()
        _assert_leaves_are_the_ports(load_params(jmodel, case["path"]),
                                     tmodel)


def test_jax_cli_load_model_over_a_port_dyngem_folder(dyn_dataset, tmp_path,
                                                      monkeypatch):
    """The port's DynGEM CLI trains every window and leaves its last model
    in the model folder; the JAX CLI with ``load_model: true`` and 0
    epochs over that folder starts every window from it: each export is
    the port's model, read by ``load_params``, on that snapshot."""
    DY._run_cli(dyn_dataset, tmp_path, "DynGEM")
    emb = DY._config(dyn_dataset, "DynGEM", load_model=True, epoch=0,
                     embed_folder="2.embedding/jax-over-port")
    path = dyn_dataset / emb["model_folder"] / emb["model_file"]
    port_state = read_model_file(path)
    jmodel = load_params(DY._jax_model("DynGEM", key=3), str(path))
    monkeypatch.setenv("CTGCN_TPU_CACHE", str(tmp_path / "xla"))
    cfg = tmp_path / "jax.json"
    cfg.write_text(json.dumps({"embedding": {"DynGEM": emb}}))
    jcli.main([f"--config={cfg}", "--task=embedding", "--method=DynGEM"])
    window = DY._window(DY._mats(seed=5))
    out = dyn_dataset / emb["embed_folder"]
    for t in range(DY.W):
        got = DY._read_csv(out / f"2011-0{t + 1}.csv")
        ref = np.asarray(jmodel(jnp.asarray(window[t]))[0])
        np.testing.assert_allclose(got, ref, rtol=MF.TOL,
                                   atol=MF.TOL * np.abs(ref).max())
    tmodel = DY._torch_model("DynGEM")
    tmodel.load_state_dict(port_state)
    _assert_leaves_are_the_ports(jmodel, tmodel)
