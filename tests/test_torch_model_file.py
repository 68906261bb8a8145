# coding: utf-8
"""The JAX package's model files in the port: ``ctgcn_tpu``'s
``save_params`` writes flax msgpack, and ``load_model_file`` reads it into
the port's model of the same family (``training.model_file``'s decoder,
``interop.params_from_numpy``), whose forward then equals the JAX forward
within 1e-5 of its largest value.  The families: CTGCN-C and CGCN-S (the
toy window of ``tests/test_torch_backends.py``), GCN, GAT, EvolveGCN and
VGRNN (``tests/test_torch_vgrnn.py``'s window), PGNN
(``tests/test_torch_pgnn.py``'s proximities) and DynGEM and DynRNN
(``tests/test_torch_dynae.py``'s window).  Also: a file whose arrays flax
chunks (``MAX_CHUNK_SIZE`` made small on the JAX side), the bfloat16 and
scalar leaves, and a CLI run with ``load_model: true`` over a JAX-written
DynGEM file."""
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.nn import core_models as TM
from ctgcn_torch.nn import dynae as TDY
from ctgcn_torch.nn.egcn import EvolveGCN as TEvolveGCN
from ctgcn_torch.nn.gat import GAT as TGAT
from ctgcn_torch.nn.gcn import GCN as TGCN
from ctgcn_torch.nn.pgnn import PGNN as TPGNN
from ctgcn_torch.nn.vgrnn import VGRNN as TVGRNN
from ctgcn_torch.training.engine import load_model_file
from ctgcn_torch.training.model_file import read_flax_msgpack
from ctgcn_tpu.nn import core_models as JM
from ctgcn_tpu.nn import egcn as JE
from ctgcn_tpu.nn import pgnn as JP
from ctgcn_tpu.nn import vgrnn as JV
from ctgcn_tpu.nn.gat import GAT as JGAT
from ctgcn_tpu.nn.gcn import GCN as JGCN
from ctgcn_tpu.training.engine import save_params
from tests import test_torch_backends as BK
from tests import test_torch_dynae as DY
from tests import test_torch_pgnn as PG
from tests import test_torch_vgrnn as VG
from tests.test_torch_dynae import dataset as dyn_dataset  # noqa: F401

TOL = 1e-5


def _graphs():
    """(port graphs, JAX bank) of ``tests/test_torch_vgrnn.py``'s window
    (N = 48, T = 3)."""
    tgraphs, _, bank, _ = VG._window()
    return tgraphs, bank


def _family(model_type):
    per_snap = BK._window()
    tpyr, jpyr = BK._build("segment", per_snap)
    if model_type == "C":
        jmodel = JM.CTGCN.init(jax.random.key(0), BK.N, BK.HID, BK.EMB,
                               trans_num=1, diffusion_num=2, duration=BK.T)
        tmodel = TM.CTGCN(BK.N, BK.HID, BK.EMB, trans_num=1,
                          diffusion_num=2, duration=BK.T)
    else:
        jmodel = JM.CGCN.init(jax.random.key(1), BK.N, BK.HID, BK.EMB,
                              trans_num=2, diffusion_num=2, model_type="S")
        tmodel = TM.CGCN(BK.N, BK.HID, BK.EMB, trans_num=2,
                         diffusion_num=2, model_type="S")
    return (jmodel, tmodel, lambda m: m(None, jpyr),
            lambda m: m(None, tpyr))


def _zoo(name):
    tgraphs, bank = _graphs()
    n, hid, emb, feat = VG.N, VG.HID, VG.EMB, VG.FEAT
    if name == "GCN":
        return (JGCN.init(jax.random.key(2), n, hid, emb, dropout=0.5),
                TGCN(n, hid, emb, dropout=0.5),
                lambda m: m(None, bank), lambda m: m(None, tgraphs))
    if name == "GAT":
        return (JGAT.init(jax.random.key(3), n, hid, emb, dropout=0.5,
                          alpha=0.2, head_num=2),
                TGAT(n, hid, emb, dropout=0.5, head_num=2),
                lambda m: m(None, bank), lambda m: m(None, tgraphs))
    if name == "EvolveGCN":
        xs = VG._normal(4, VG.T, n, feat)
        return (JE.EvolveGCN.init(jax.random.key(4), feat, hid, emb,
                                  "EGCNH"),
                TEvolveGCN(feat, hid, emb, "EGCNH"),
                lambda m: m(jnp.asarray(xs), bank),
                lambda m: m(torch.from_numpy(xs), tgraphs))
    # VGRNN: the encoder means and the last hidden state, the JAX noise
    # given to the port
    key = jax.random.key(5)
    noise = VG._noise(key)

    def jcall(m):
        em, h, _ = m(None, bank, key=key)
        return em, h

    def tcall(m):
        em, h, _ = m(None, tgraphs, noise=noise)
        return em, h

    return (JV.VGRNN.init(jax.random.key(6), n, hid, emb),
            TVGRNN(n, hid, emb), jcall, tcall)


def _pgnn():
    _, dm, da = PG._model_inputs(False)
    return (JP.PGNN.init(jax.random.key(7), PG.N, 8, PG.HID, PG.EMB,
                         feature_pre=True, layer_num=2, dropout=0.5),
            TPGNN(PG.N, 8, PG.HID, PG.EMB, feature_pre=True, layer_num=2,
                  dropout=0.5),
            lambda m: m(None, (dm, da)),
            lambda m: m(None, torch.from_numpy(np.array(dm)),
                        torch.from_numpy(np.array(da)).long()))


def _dyn(method):
    jmodel = DY._jax_model(method)
    window, _, _, data = DY._inputs(method, DY._mats(),
                                    np.random.default_rng(2))
    jwin = jnp.asarray(window)
    return (jmodel, DY._torch_model(method),
            lambda m: DY._jax_embed(method, m, jwin),
            lambda m: TDY.embed(method, DY.LB, m, data))


MODELS = {"CTGCN-C": lambda: _family("C"), "CGCN-S": lambda: _family("S"),
          "GCN": lambda: _zoo("GCN"), "GAT": lambda: _zoo("GAT"),
          "EvolveGCN": lambda: _zoo("EvolveGCN"),
          "VGRNN": lambda: _zoo("VGRNN"), "PGNN": _pgnn,
          "DynGEM": lambda: _dyn("DynGEM"), "DynRNN": lambda: _dyn("DynRNN")}


def _outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


@pytest.mark.parametrize("family", sorted(MODELS))
def test_jax_model_file_loads_and_forwards_as_jax(tmp_path, family):
    """``save_params`` (JAX) then ``load_model_file`` (port): the state is
    the JAX parameters exactly, and the forward equals JAX's."""
    jmodel, tmodel, jcall, tcall = MODELS[family]()
    path = tmp_path / "model"
    save_params(jmodel, str(path))
    assert not path.read_bytes().startswith(b"PK")
    load_model_file(tmodel, str(path), "cpu")
    want = params_from_numpy(jax.tree.map(
        np.asarray, serialization.to_state_dict(jmodel)))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    with torch.no_grad():
        touts = _outputs(tcall(tmodel))
    jouts = _outputs(jcall(jmodel))
    assert len(touts) == len(jouts)
    for t_out, j_out in zip(touts, jouts):
        assert t_out.shape == j_out.shape
        np.testing.assert_allclose(t_out, j_out, rtol=TOL,
                                   atol=TOL * np.abs(j_out).max())


def test_chunked_arrays_and_scalar_leaves(tmp_path, monkeypatch):
    """flax splits an array above ``MAX_CHUNK_SIZE`` bytes into a map of
    flat chunks; the decoder joins them.  With the size made 256 bytes
    every CTGCN-C leaf above it is chunked, and the file loads as the
    unchunked one does.  bfloat16 arrays and numpy scalars decode exactly."""
    jmodel, tmodel, jcall, tcall = _family("C")
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    path = tmp_path / "chunked"
    save_params(jmodel, str(path))
    monkeypatch.undo()
    raw = path.read_bytes()
    assert b"__msgpack_chunked_array__" in raw
    tree = read_flax_msgpack(raw)
    want = jax.tree.map(np.asarray, serialization.to_state_dict(jmodel))
    got_leaves = jax.tree.leaves(tree)
    assert len(got_leaves) == len(jax.tree.leaves(want))
    for g, w in zip(got_leaves, jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    load_model_file(tmodel, str(path), "cpu")
    with torch.no_grad():
        out = tcall(tmodel).numpy()
    ref = np.asarray(jcall(jmodel))
    np.testing.assert_allclose(out, ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())
    misc = {"bf16": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 4,
            "scalar": np.float32(2.5), "int": np.int64(-7),
            "empty": np.zeros((0, 3), np.float32), "flag": True,
            "none": None, "text": "x" * 40, "big": 2 ** 40, "neg": -40000}
    back = read_flax_msgpack(serialization.msgpack_serialize(misc))
    np.testing.assert_array_equal(back["bf16"],
                                  np.asarray(misc["bf16"], np.float32))
    assert back["bf16"].dtype == np.float32
    assert back["scalar"] == np.float32(2.5) and back["int"] == -7
    assert back["empty"].shape == (0, 3)
    assert (back["flag"], back["none"], back["text"], back["big"],
            back["neg"]) == (True, None, "x" * 40, 2 ** 40, -40000)


@pytest.mark.parametrize("data", [b"", b"\xc1", b"\x81\xa1a", b"hello",
                                  b"\x81\xa1a\xc7\x03\x05abc",
                                  b"\x81\xa1a\xd4\x01\x07",
                                  b"\x81\x90\x01"],
                         ids=["empty", "reserved", "truncated", "trailing",
                              "ext-type", "ext-payload", "list-key"])
def test_neither_format_raises_naming_the_path(tmp_path, data):
    path = tmp_path / "model"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{path} is not a model file"):
        load_model_file(TGCN(4, 3, 2), str(path), "cpu")


def test_cli_load_model_over_a_jax_dyngem_file(dyn_dataset, tmp_path):
    """``load_model: true`` with 0 epochs over the JAX package's DynGEM
    file: every window exports the JAX model's embedding of its snapshot
    (window 0 reads the JAX file, each later one the port's save of it)."""
    emb = DY._config(dyn_dataset, "DynGEM", load_model=True, epoch=0)
    path = dyn_dataset / emb["model_folder"] / emb["model_file"]
    jmodel = DY._jax_model("DynGEM", key=3)
    save_params(jmodel, str(path))
    _, results = DY._run_cli(dyn_dataset, tmp_path, "DynGEM",
                             load_model=True, epoch=0)
    assert [r["idx"] for r in results] == list(range(DY.W))
    window = DY._window(DY._mats(seed=5))
    out = dyn_dataset / emb["embed_folder"]
    for t in range(DY.W):
        got = DY._read_csv(out / f"2011-0{t + 1}.csv")
        ref = np.asarray(jmodel(jnp.asarray(window[t]))[0])
        np.testing.assert_allclose(got, ref, rtol=TOL,
                                   atol=TOL * np.abs(ref).max())
