# coding: utf-8
"""Numbers in CSVs read as the JAX package's pandas readers read them.

``ctgcn_torch.data.formats.read_edge_csv`` / ``get_sp_adj_mat`` and the
loader's ``get_feature_list`` against ``ctgcn_tpu``'s (``pd.read_csv``):
edge weights and feature values bit-equal for random 17-digit, 15-digit,
exponent and integer tokens (``float()`` reads many 17-digit tokens an ulp
off pandas' parser), and the fast path (``exact_float``, numpy's parse of
short plain tokens) equal to ``pandas_float`` on every token it takes."""
import numpy as np
import pytest

from ctgcn_torch.data import formats as TF
from ctgcn_torch.data.loader import DataLoader as TLoader
from ctgcn_tpu.data import formats as JF
from ctgcn_tpu.data.loader import DataLoader as JLoader

N = 40


def _tokens(kind, rng, n):
    """``n`` number tokens of one kind, as a user's data may hold them."""
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)
    if kind == "17-digit":
        return [repr(float(v)) for v in x]
    if kind == "15-digit":
        return [f"{v:.15g}" for v in x]
    if kind == "exponent":
        return [f"{v:.{rng.integers(1, 17)}e}" for v in x * 1e-20]
    if kind == "integer":
        return [str(v) for v in rng.integers(-10 ** 18, 10 ** 18, n)]
    return [f"{rng.integers(1, 5)}" if i % 3 else f"{v:.3f}"
            for i, v in enumerate(rng.random(n))]


KINDS = ["17-digit", "15-digit", "exponent", "integer", "short"]


def _bits(a):
    return np.asarray(a, np.float64).view(np.int64)


def _edge_file(path, kind, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, 300), rng.integers(0, N, 300)
    weights = _tokens(kind, rng, 300)
    path.write_text("from_id\tto_id\tweight\n" + "".join(
        f"n{a}\tn{b}\t{w}\n" for a, b, w in zip(src, dst, weights)))
    return weights


@pytest.mark.parametrize("kind", KINDS)
def test_edge_weights_read_as_pandas_reads_them(tmp_path, kind):
    path = tmp_path / "edges.csv"
    tokens = _edge_file(path, kind, KINDS.index(kind))
    nodes = [f"n{i}" for i in range(N)]
    node2idx = dict(zip(nodes, range(N)))
    got = TF.read_edge_csv(str(path), node2idx)
    want = JF.read_edge_csv(str(path), node2idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(_bits(got[2]), _bits(want[2]))
    tadj = TF.get_sp_adj_mat(str(path), nodes).tocsr()
    jadj = JF.get_sp_adj_mat(str(path), nodes).tocsr()
    np.testing.assert_array_equal(tadj.indptr, jadj.indptr)
    np.testing.assert_array_equal(tadj.indices, jadj.indices)
    np.testing.assert_array_equal(_bits(tadj.data), _bits(jadj.data))
    if kind == "17-digit":
        # float() reads some of these tokens an ulp off pandas' parser
        assert any(float(t) != TF.pandas_float(t) for t in tokens)


#: 17-digit tokens an ulp apart in float() and pandas' parser whose two
#: doubles round to two float32s (one lies on a float32 tie)
FLOAT32_TIES = ["1.2573022395372393e-01", "1.3040000610351563e+03",
                "-1.2654214631766079e-02"]


def test_features_read_as_pandas_reads_them(tmp_path):
    """One file a snapshot: an integer column, 17-digit, 15-digit and
    exponent columns and one of ``FLOAT32_TIES``, and a narrower snapshot
    padded with zeros.  The loader's float32 features hide most of a
    double's ulp; the ties do not."""
    assert all(np.float32(float(t)) != np.float32(TF.pandas_float(t))
               for t in FLOAT32_TIES)
    rng = np.random.default_rng(7)
    folder = tmp_path / "features"
    folder.mkdir()
    for t in range(3):
        kinds = KINDS[:4] if t != 1 else KINDS[:2]
        cols = [_tokens(k, rng, N) for k in kinds]
        if t != 1:
            cols.append([FLOAT32_TIES[i % 3] for i in range(N)])
        folder.joinpath(f"{t}.csv").write_text(
            "\t".join(f"f{j}" for j in range(len(cols))) + "\n"
            + "".join("\t".join(row) + "\n" for row in zip(*cols)))
    nodes = [f"n{i}" for i in range(N)]
    txs, tdim = TLoader(nodes, 3).get_feature_list(str(folder), 0, 3)
    jxs, jdim = JLoader(nodes, 3).get_feature_list(str(folder), 0, 3)
    assert tdim == jdim == 5
    np.testing.assert_array_equal(txs.numpy().view(np.int32),
                                  np.asarray(jxs).view(np.int32))


def test_fast_path_agrees_with_pandas_float_on_every_token_it_takes():
    """``exact_float`` returns a double only for at most 15 digits and a
    decimal exponent within +-22, and then the one ``pandas_float``
    gives; a column of short plain tokens (numpy's parse) too."""
    rng = np.random.default_rng(11)
    tokens = [t for kind in KINDS for t in _tokens(kind, rng, 2000)]
    tokens += [f"{v:.{d}f}" for v, d in zip(rng.random(2000) * 1e4,
                                            rng.integers(0, 12, 2000))]
    tokens += [f"{m}e{e}" for m, e in zip(rng.integers(1, 10 ** 9, 2000),
                                          rng.integers(-40, 40, 2000))]
    taken = 0
    for t in tokens:
        v = TF.exact_float(t)
        if v is not None:
            taken += 1
            assert _bits(v) == _bits(TF.pandas_float(t)), t
    assert 4000 < taken < len(tokens)
    short = [t for t in tokens if len(t) <= 15 and "e" not in t]
    np.testing.assert_array_equal(
        _bits(TF.pandas_column(short)),
        _bits([TF.pandas_float(t) for t in short]))


@pytest.mark.parametrize("tokens, want", [
    (["1", "2", "3"], [1.0, 2.0, 3.0]),
    (["12345678901234567", "3"], [12345678901234567.0, 3.0]),
    (["1.5", "", "NA", "nan", "-inf"], [1.5, np.nan, np.nan, np.nan,
                                        -np.inf]),
    (["1e400", "0.5"], None)], ids=["ints", "long-int", "missing", "range"])
def test_column_edge_cases(tokens, want):
    """An integer column converts its ints exactly (pandas reads it as
    int64); missing tokens read NaN; a token out of the double's range
    raises."""
    if want is None:
        with pytest.raises(ValueError):
            TF.pandas_column(tokens)
        return
    np.testing.assert_array_equal(TF.pandas_column(tokens), want)
