"""The port's nine string and token stages against the JAX package's.

CountVectorizer, FeatureHasher, HashingTF, IDF, NGram, RegexTokenizer,
StopWordsRemover, StringIndexer (with IndexToStringModel) and Tokenizer in
flink_ml_tpu_torch get the same seeded numpy inputs as flink_ml_tpu's, on
every layout the JAX package has: a `DictTokenMatrix` (the JAX side holds
a `jax.Array` of the ids, the port the same ids as a numpy array or a CPU
tensor), a host unicode token matrix or string column, and rows as token
lists. The JAX side runs on a one-device mesh, the port under
`config.use_device("cpu")`.

Tolerance: none. Every output is equal: vocabularies and their order,
sparse indices, values, padded widths and dtypes (float32 on the device
path, float64 on the host paths), token lists and n-gram vocabularies.
The IDF weights come from the same float64 formula on equal counts, and
each transform multiplies as its JAX path does (float32 on the device,
float64 on the host), so they are equal too. Also: the params and their
validators, save and load both ways between the packages, StringIndexer's
unseen values under error, skip and keep, and the Java number formatting.
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.feature import countvectorizer as jax_cv
from flink_ml_tpu.models.feature import featurehasher as jax_fh
from flink_ml_tpu.models.feature import hashingtf as jax_htf
from flink_ml_tpu.models.feature import idf as jax_idf
from flink_ml_tpu.models.feature import ngram as jax_ng
from flink_ml_tpu.models.feature import regextokenizer as jax_rt
from flink_ml_tpu.models.feature import stopwordsremover as jax_sw
from flink_ml_tpu.models.feature import stringindexer as jax_si
from flink_ml_tpu.models.feature import tokenizer as jax_tk
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.table import DictTokenMatrix as JaxDictTokenMatrix
from flink_ml_tpu.table import SparseBatch as JaxSparseBatch
from flink_ml_tpu_torch import SparseBatch, Table, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.feature import countvectorizer as port_cv
from flink_ml_tpu_torch.models.feature import featurehasher as port_fh
from flink_ml_tpu_torch.models.feature import hashingtf as port_htf
from flink_ml_tpu_torch.models.feature import idf as port_idf
from flink_ml_tpu_torch.models.feature import ngram as port_ng
from flink_ml_tpu_torch.models.feature import regextokenizer as port_rt
from flink_ml_tpu_torch.models.feature import stopwordsremover as port_sw
from flink_ml_tpu_torch.models.feature import stringindexer as port_si
from flink_ml_tpu_torch.models.feature import tokenizer as port_tk
from flink_ml_tpu_torch.table import DictTokenMatrix

LAYOUTS = ["dict-numpy", "dict-tensor", "matrix", "lists"]


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _matrix(n=60, k=8, m=12, seed=0):
    vocab = np.arange(m).astype(str)
    return vocab[np.random.RandomState(seed).randint(0, m, size=(n, k))]


def _lists(A, holes=None):
    out = np.empty(A.shape[0], dtype=object)
    out[:] = [[str(t) for t, h in zip(row, hole) if not h]
              for row, hole in zip(A, np.zeros(A.shape, bool) if holes is None else holes)]
    return out


def _columns(A, layout, holes=None):
    """(JAX column, port column) of the token matrix A in one layout; with
    `holes`, the dictionary layouts carry -1 there and the lists drop them."""
    if layout.startswith("dict"):
        uniq = np.unique(A)
        ids = np.searchsorted(uniq, A).astype(np.int32)
        if holes is not None:
            ids[holes] = -1
        port_ids = torch.from_numpy(ids.copy()) if layout == "dict-tensor" else ids.copy()
        return JaxDictTokenMatrix(uniq, jax.device_put(ids)), DictTokenMatrix(uniq, port_ids)
    if layout == "matrix":
        return A, A.copy()
    return _lists(A, holes), _lists(A, holes)


def _stage_pair(jax_module, port_module, cls, **params):
    pair = []
    for module in (jax_module, port_module):
        stage = getattr(module, cls)()
        for name, value in params.items():
            setter = getattr(stage, f"set_{name}")
            setter(*value) if isinstance(value, tuple) else setter(value)
        pair.append(stage)
    return pair


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_sparse(got, want):
    assert isinstance(got, SparseBatch) and isinstance(want, JaxSparseBatch)
    assert got.size == want.size
    on_device = isinstance(want.indices, jax.Array)
    assert isinstance(got.indices, torch.Tensor) == on_device
    gi, gv, wi, wv = _host(got.indices), _host(got.values), _host(want.indices), _host(want.values)
    assert gi.shape == wi.shape and gi.dtype == wi.dtype == np.int32
    assert gv.dtype == wv.dtype == (np.float32 if on_device else np.float64)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)


def _token_rows(col):
    if isinstance(col, (DictTokenMatrix, JaxDictTokenMatrix)):
        return [col.row(i) for i in range(len(col))]
    return [list(r) for r in col]


# -- CountVectorizer --------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("min_tf", [1.0, 2.0, 0.2, 0.25])
@pytest.mark.parametrize("binary", [False, True])
def test_countvectorizer_matches_jax(layout, min_tf, binary):
    A = _matrix(seed=7)
    jc, pc = _columns(A, layout)
    jest, pest = _stage_pair(jax_cv, port_cv, "CountVectorizer", input_col="tok", output_col="vec",
                             min_tf=min_tf, binary=binary, min_df=2.0)
    jm, pm = jest.fit(JaxTable({"tok": jc})), pest.fit(Table({"tok": pc}))
    assert pm.vocabulary == jm.vocabulary
    _assert_same_sparse(pm.transform(Table({"tok": pc}))[0].column("vec"),
                        jm.transform(JaxTable({"tok": jc}))[0].column("vec"))


@pytest.mark.parametrize("layout", ["dict-numpy", "dict-tensor"])
def test_countvectorizer_dict_rows_with_holes_take_a_share_of_their_tokens(layout):
    """A fractional minTF is float32(minTF) * float32(present tokens) a row;
    at 0.25 of 4 present tokens a term seen once stays (1 >= 1.0)."""
    A = _matrix(n=200, k=8, m=6, seed=9)
    holes = np.random.RandomState(10).random_sample(A.shape) < 0.5
    jc, pc = _columns(A, layout, holes)
    jest, pest = _stage_pair(jax_cv, port_cv, "CountVectorizer", input_col="tok", output_col="vec",
                             min_tf=0.25)
    jm, pm = jest.fit(JaxTable({"tok": jc})), pest.fit(Table({"tok": pc}))
    assert pm.vocabulary == jm.vocabulary
    _assert_same_sparse(pm.transform(Table({"tok": pc}))[0].column("vec"),
                        jm.transform(JaxTable({"tok": jc}))[0].column("vec"))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("df", [(1.0, 2**63 - 1.0), (0.3, 0.9), (3.0, 40.0)])
@pytest.mark.parametrize("size", [4, 1 << 18])
def test_countvectorizer_vocabulary_order_and_bounds_match_jax(layout, df, size):
    """Ties in frequency go by the term, then minDF, maxDF and
    vocabularySize cut the list."""
    A = _matrix(n=80, k=6, m=15, seed=11)
    jc, pc = _columns(A, layout)
    jest, pest = _stage_pair(jax_cv, port_cv, "CountVectorizer", input_col="tok", output_col="vec",
                             min_df=df[0], max_df=df[1], vocabulary_size=size)
    assert pest.fit(Table({"tok": pc})).vocabulary == jest.fit(JaxTable({"tok": jc})).vocabulary


@pytest.mark.parametrize("layout", ["dict-numpy", "dict-tensor"])
def test_countvectorizer_dict_vocabulary_leaves_out_unseen_entries(layout):
    A = _matrix(n=30, k=4, m=8, seed=12)
    vocab = np.asarray(sorted(set(A.ravel()) | {"zz", "aa"}))
    ids = np.searchsorted(vocab, A).astype(np.int32)
    port_ids = torch.from_numpy(ids.copy()) if layout == "dict-tensor" else ids
    pm = port_cv.CountVectorizer().set_input_col("tok").fit(Table({"tok": DictTokenMatrix(vocab, port_ids)}))
    jm = jax_cv.CountVectorizer().set_input_col("tok").fit(
        JaxTable({"tok": JaxDictTokenMatrix(vocab, jax.device_put(ids))}))
    assert pm.vocabulary == jm.vocabulary and "zz" not in pm.vocabulary


@pytest.mark.parametrize("layout", ["dict-numpy", "dict-tensor"])
def test_countvectorizer_of_an_empty_vocabulary_gives_no_slots(layout):
    """Only absent tokens: the fitted vocabulary is empty and the output
    is 0 slots wide, as the JAX package's."""
    ids = np.full((3, 4), -1, np.int32)
    vocab = np.zeros(0, "<U1")
    port_ids = torch.from_numpy(ids.copy()) if layout == "dict-tensor" else ids.copy()
    jc, pc = JaxDictTokenMatrix(vocab, jax.device_put(ids)), DictTokenMatrix(vocab, port_ids)
    jest, pest = _stage_pair(jax_cv, port_cv, "CountVectorizer", input_col="tok", output_col="vec")
    jm, pm = jest.fit(JaxTable({"tok": jc})), pest.fit(Table({"tok": pc}))
    assert pm.vocabulary == jm.vocabulary == []
    got = pm.transform(Table({"tok": pc}))[0].column("vec")
    _assert_same_sparse(got, jm.transform(JaxTable({"tok": jc}))[0].column("vec"))
    assert got.indices.shape == (3, 0)


def test_countvectorizer_wide_vocabulary_takes_the_full_width():
    """Above 512 terms the JAX package's output is k slots wide."""
    A = _matrix(n=200, k=9, m=700, seed=13)
    jc, pc = _columns(A, "dict-tensor")
    jest, pest = _stage_pair(jax_cv, port_cv, "CountVectorizer", input_col="tok", output_col="vec")
    jm, pm = jest.fit(JaxTable({"tok": jc})), pest.fit(Table({"tok": pc}))
    assert len(pm.vocabulary) > 512
    got = pm.transform(Table({"tok": pc}))[0].column("vec")
    _assert_same_sparse(got, jm.transform(JaxTable({"tok": jc}))[0].column("vec"))
    assert got.indices.shape == (200, 9)


# -- HashingTF ----------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("num_features", [64, 1 << 18])
@pytest.mark.parametrize("binary", [False, True])
def test_hashingtf_matches_jax(layout, num_features, binary):
    A = _matrix(seed=8, m=30)
    jc, pc = _columns(A, layout)
    jst, pst = _stage_pair(jax_htf, port_htf, "HashingTF", input_col="tok", output_col="vec",
                           num_features=num_features, binary=binary)
    got = pst.transform(Table({"tok": pc}))[0].column("vec")
    _assert_same_sparse(got, jst.transform(JaxTable({"tok": jc}))[0].column("vec"))
    if layout.startswith("dict"):
        assert got.indices.shape[1] == (8 if num_features > 512 else min(8, num_features))


def test_hashingtf_dict_path_with_holes_matches_jax():
    A = _matrix(n=100, k=10, m=50, seed=14)
    holes = np.random.RandomState(15).random_sample(A.shape) < 0.3
    jc, pc = _columns(A, "dict-tensor", holes)
    jst, pst = _stage_pair(jax_htf, port_htf, "HashingTF", input_col="tok", output_col="vec")
    _assert_same_sparse(pst.transform(Table({"tok": pc}))[0].column("vec"),
                        jst.transform(JaxTable({"tok": jc}))[0].column("vec"))


# -- IDF ------------------------------------------------------------------------------------

def _idf_inputs(form):
    """(JAX column, port column) of one IDF input form."""
    rng = np.random.RandomState(16)
    if form in ("sparse-device", "sparse-host"):
        A = _matrix(n=120, k=10, m=40, seed=17)
        jc, pc = _columns(A, "dict-tensor" if form == "sparse-device" else "matrix")
        stage = [s.set_input_col("tok").set_output_col("tf").set_num_features(256)
                 for s in (jax_htf.HashingTF(), port_htf.HashingTF())]
        return (stage[0].transform(JaxTable({"tok": jc}))[0].column("tf"),
                stage[1].transform(Table({"tok": pc}))[0].column("tf"))
    X = rng.random_sample((150, 6)) * (rng.random_sample((150, 6)) < 0.4)
    if form == "dense-host":
        return X, X.copy()
    X = X.astype(np.float32)
    return jax.device_put(X), torch.from_numpy(X.copy())


@pytest.mark.parametrize("form", ["sparse-device", "sparse-host", "dense-host", "dense-device"])
@pytest.mark.parametrize("min_doc_freq", [0, 5])
def test_idf_matches_jax(form, min_doc_freq):
    jc, pc = _idf_inputs(form)
    jest, pest = _stage_pair(jax_idf, port_idf, "IDF", input_col="tf", output_col="o",
                             min_doc_freq=min_doc_freq)
    jm, pm = jest.fit(JaxTable({"tf": jc})), pest.fit(Table({"tf": pc}))
    np.testing.assert_array_equal(pm.doc_freq, np.asarray(jm.doc_freq))
    np.testing.assert_array_equal(pm.idf, np.asarray(jm.idf))
    assert pm.num_docs == jm.num_docs and pm.idf.dtype == np.float64
    got = pm.transform(Table({"tf": pc}))[0].column("o")
    want = jm.transform(JaxTable({"tf": jc}))[0].column("o")
    if form.startswith("sparse"):
        _assert_same_sparse(got, want)
    else:
        assert isinstance(got, torch.Tensor) == (form == "dense-device")
        assert _host(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(_host(got), np.asarray(want))


def test_idf_device_transform_is_one_float32_product():
    _, pc = _idf_inputs("sparse-device")
    pm = port_idf.IDF().set_input_col("tf").fit(Table({"tf": pc}))
    got = pm.transform(Table({"tf": pc}))[0].column("output")
    idx = pc.indices.numpy()
    want = np.where(idx >= 0, pc.values.numpy() * pm.idf.astype(np.float32)[np.maximum(idx, 0)], 0)
    np.testing.assert_array_equal(got.values.numpy(), want.astype(np.float32))


# -- NGram ------------------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [1, 2, 3, 9])
def test_ngram_matches_jax(layout, n):
    A = _matrix(seed=2, k=8)
    jc, pc = _columns(A, layout)
    jst, pst = _stage_pair(jax_ng, port_ng, "NGram", input_col="tok", output_col="g", n=n)
    got = pst.transform(Table({"tok": pc}))[0].column("g")
    want = jst.transform(JaxTable({"tok": jc}))[0].column("g")
    assert type(got).__name__ == type(want).__name__
    assert _token_rows(got) == _token_rows(want)
    if isinstance(got, DictTokenMatrix):
        assert got.vocab.dtype == want.vocab.dtype
        np.testing.assert_array_equal(got.vocab, want.vocab)
        np.testing.assert_array_equal(got.host_ids(), want.host_ids())
        assert isinstance(got.ids, torch.Tensor) and got.ids.dtype == torch.int32
    elif isinstance(got, np.ndarray) and got.ndim == 2:
        assert got.dtype == want.dtype


@pytest.mark.parametrize("m, n", [(300, 2), (50_000, 2)])
def test_ngram_large_code_spaces_match_jax(m, n):
    """300^2 > 65,536 codes: only the observed n-grams decode; 50,000^2 is
    past int32: the JAX package falls back to token lists, and so does
    the port."""
    A = _matrix(n=40, k=5, m=m, seed=18)
    uniq = np.unique(A)
    vocab = np.concatenate([uniq, np.asarray([f"w{i}" for i in range(m - uniq.size)])])
    ids = np.searchsorted(np.sort(vocab), A).astype(np.int32)
    vocab = np.sort(vocab)
    jst, pst = _stage_pair(jax_ng, port_ng, "NGram", input_col="tok", output_col="g", n=n)
    got = pst.transform(Table({"tok": DictTokenMatrix(vocab, torch.from_numpy(ids))}))[0].column("g")
    want = jst.transform(JaxTable({"tok": JaxDictTokenMatrix(vocab, jax.device_put(ids))}))[0].column("g")
    assert type(got).__name__ == type(want).__name__
    assert _token_rows(got) == _token_rows(want)
    if isinstance(got, DictTokenMatrix):
        np.testing.assert_array_equal(got.vocab, want.vocab)
        np.testing.assert_array_equal(got.host_ids(), want.host_ids())


# -- StopWordsRemover -------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case_sensitive", [False, True])
@pytest.mark.parametrize("words", [("1", "5", "Zz"), ("A", "b"), ("qq",)])
def test_stopwordsremover_matches_jax(layout, case_sensitive, words):
    terms = np.asarray(["a", "A", "b", "B", "1", "5", "7", "zz", "Zz", "x", "yy"])
    A = terms[np.random.RandomState(19).randint(0, len(terms), size=(60, 8))]
    jc, pc = _columns(A, layout)
    jst, pst = _stage_pair(jax_sw, port_sw, "StopWordsRemover", input_cols=("tok",),
                           output_cols=("kept",), stop_words=words, case_sensitive=case_sensitive)
    got = pst.transform(Table({"tok": pc}))[0].column("kept")
    want = jst.transform(JaxTable({"tok": jc}))[0].column("kept")
    assert type(got).__name__ == type(want).__name__
    assert _token_rows(got) == _token_rows(want)
    if isinstance(got, DictTokenMatrix):
        np.testing.assert_array_equal(got.host_ids(), want.host_ids())
        np.testing.assert_array_equal(got.vocab, want.vocab)
        if words == ("qq",) and layout == "dict-tensor":  # nothing to drop: no copy
            assert got.ids is pc.ids


@pytest.mark.parametrize("layout", LAYOUTS)
def test_stopwordsremover_default_english_and_two_columns(layout):
    words = np.asarray(["the", "The", "cat", "a", "sat", "On", "mat", "i"])
    A = words[np.random.RandomState(20).randint(0, len(words), size=(40, 6))]
    jc, pc = _columns(A, layout)
    jc2, pc2 = _columns(A[:, ::-1].copy(), layout)
    jst, pst = _stage_pair(jax_sw, port_sw, "StopWordsRemover", input_cols=("a", "b"),
                           output_cols=("x", "y"))
    got = pst.transform(Table({"a": pc, "b": pc2}))[0]
    want = jst.transform(JaxTable({"a": jc, "b": jc2}))[0]
    for name in ("x", "y"):
        assert _token_rows(got.column(name)) == _token_rows(want.column(name))
    assert all(t.lower() not in ("the", "a", "on", "i") for r in _token_rows(got.column("x")) for t in r)


def test_stopwordsremover_lists_and_params_match_jax():
    assert port_sw.StopWordsRemover.load_default_stop_words("danish") == \
        jax_sw.StopWordsRemover.load_default_stop_words("danish")
    for module in (jax_sw, port_sw):
        with pytest.raises(ValueError, match="supported language"):
            module.load_default_stop_words("klingon")
        with pytest.raises(ValueError):
            module.StopWordsRemover().set_stop_words()
    assert port_sw.StopWordsRemover.get_available_locales() == ["en_US"]
    p, j = port_sw.StopWordsRemover(), jax_sw.StopWordsRemover()
    assert p.get_stop_words() == j.get_stop_words()
    assert (p.get_locale(), p.get_case_sensitive()) == (j.get_locale(), j.get_case_sensitive())
    table = Table({"a": _lists(_matrix(n=3))})
    with pytest.raises(ValueError, match="same length"):
        p.set_input_cols("a").set_output_cols("x", "y").transform(table)


# -- Tokenizer and RegexTokenizer --------------------------------------------------------------

STRINGS = ["A b  c", "a B", "", "x\ty z ", "a B", "Aa1 bb2", "c33 D", "e", " lead", "111x1"]


def _string_columns(layout):
    S = np.asarray(STRINGS * 5)
    if layout == "unicode":
        return S, S.copy()
    obj = np.empty(len(S), dtype=object)
    obj[:] = [str(s) for s in S]
    return obj, obj.copy()


@pytest.mark.parametrize("layout", ["unicode", "objects"])
def test_tokenizer_matches_jax(layout):
    jc, pc = _string_columns(layout)
    jst, pst = _stage_pair(jax_tk, port_tk, "Tokenizer", input_col="s", output_col="t")
    got = pst.transform(Table({"s": pc}))[0].column("t")
    assert _token_rows(got) == _token_rows(jst.transform(JaxTable({"s": jc}))[0].column("t"))
    assert got.dtype == object


@pytest.mark.parametrize("layout", ["unicode", "objects"])
@pytest.mark.parametrize("gaps, pattern", [(True, r"\s+"), (False, r"[a-z]+"), (True, "1+"),
                                           (False, r"\w")])
@pytest.mark.parametrize("min_len, lower", [(1, True), (2, False), (0, True)])
def test_regextokenizer_matches_jax(layout, gaps, pattern, min_len, lower):
    jc, pc = _string_columns(layout)
    jst, pst = _stage_pair(jax_rt, port_rt, "RegexTokenizer", input_col="s", output_col="t",
                           gaps=gaps, pattern=pattern, min_token_length=min_len,
                           to_lowercase=lower)
    got = pst.transform(Table({"s": pc}))[0].column("t")
    assert _token_rows(got) == _token_rows(jst.transform(JaxTable({"s": jc}))[0].column("t"))


# -- StringIndexer ---------------------------------------------------------------------------------

ORDERS = ["arbitrary", "alphabetAsc", "alphabetDesc", "frequencyDesc", "frequencyAsc"]


def _indexer_columns(layout):
    rng = np.random.RandomState(21)
    if layout == "unicode":
        return np.asarray(["aa", "b", "cc", "d", "e", "b"])[rng.randint(0, 6, 200)]
    if layout == "objects":
        out = np.empty(200, dtype=object)
        out[:] = [["x", "y", "z", "x"][i] for i in rng.randint(0, 4, 200)]
        return out
    return np.asarray([1.0, 2.5, 1e7, 1e-4, -0.0, 3.0])[rng.randint(0, 6, 200)]


@pytest.mark.parametrize("layout", ["unicode", "objects", "float64"])
@pytest.mark.parametrize("order", ORDERS)
def test_stringindexer_matches_jax(layout, order):
    col = _indexer_columns(layout)
    jest, pest = _stage_pair(jax_si, port_si, "StringIndexer", input_cols=("s",),
                             output_cols=("i",), string_order_type=order)
    jm, pm = jest.fit(JaxTable({"s": col})), pest.fit(Table({"s": col.copy()}))
    assert pm.string_arrays == jm.string_arrays
    got = pm.transform(Table({"s": col.copy()}))[0].column("i")
    want = jm.transform(JaxTable({"s": col}))[0].column("i")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(want))
    back = [s.set_input_cols("i").set_output_cols("r") for s in
            (jax_si.IndexToStringModel(), port_si.IndexToStringModel())]
    back[0].string_arrays, back[1].string_arrays = jm.string_arrays, pm.string_arrays
    assert list(back[1].transform(Table({"i": got}))[0].column("r")) == \
        list(back[0].transform(JaxTable({"i": np.asarray(want)}))[0].column("r"))


def test_stringindexer_takes_a_tensor_column_as_its_host_values():
    col = _indexer_columns("float64")
    pm = port_si.StringIndexer().set_input_cols("s").set_output_cols("i").fit(
        Table({"s": torch.from_numpy(col.copy())}))
    jm = jax_si.StringIndexer().set_input_cols("s").set_output_cols("i").fit(JaxTable({"s": col}))
    assert pm.string_arrays == jm.string_arrays


@pytest.mark.parametrize("layout", ["unicode", "objects"])
@pytest.mark.parametrize("handle", ["error", "skip", "keep"])
def test_stringindexer_unseen_values_match_jax(layout, handle):
    train, test = np.asarray(["a", "b", "b", "c"]), np.asarray(["a", "zz", "b", "yy", "c"])
    if layout == "objects":
        train, test = train.astype(object), test.astype(object)
    jest, pest = _stage_pair(jax_si, port_si, "StringIndexer", input_cols=("s",),
                             output_cols=("i",), handle_invalid=handle)
    jm, pm = jest.fit(JaxTable({"s": train})), pest.fit(Table({"s": train}))
    tables = (JaxTable({"s": test, "x": np.arange(5.0)}), Table({"s": test, "x": np.arange(5.0)}))
    if handle == "error":
        for model, table in zip((jm, pm), tables):
            with pytest.raises(ValueError, match="unseen string: (zz|yy)"):
                model.transform(table)
        return
    want, got = jm.transform(tables[0])[0], pm.transform(tables[1])[0]
    assert got.num_rows == want.num_rows == (3 if handle == "skip" else 5)
    for name in ("i", "x"):
        np.testing.assert_array_equal(got.column(name), np.asarray(want.column(name)))


def test_index_to_string_raises_on_an_unseen_index():
    for module, table in ((jax_si, JaxTable), (port_si, Table)):
        model = module.IndexToStringModel().set_input_cols("i").set_output_cols("r")
        model.string_arrays = [["a", "b"]]
        with pytest.raises(ValueError, match="unseen index: 2"):
            model.transform(table({"i": np.asarray([0.0, 2.0])}))


JAVA_DOUBLES = [(1.0, "1.0"), (-2.5, "-2.5"), (0.001, "0.001"), (9999999.0, "9999999.0"),
                (1e7, "1.0E7"), (12345678.0, "1.2345678E7"), (1e-4, "1.0E-4"), (-1.5e-5, "-1.5E-5"),
                (0.0, "0.0"), (-0.0, "-0.0"), (float("nan"), "NaN"), (float("inf"), "Infinity"),
                (float("-inf"), "-Infinity"), (1.23456789e100, "1.23456789E100"),
                (5e-324, None), (1.7976931348623157e308, None), (0.1 + 0.2, None)]


@pytest.mark.parametrize("value, text", JAVA_DOUBLES)
def test_java_double_to_string_matches_jax(value, text):
    got = port_si._java_double_to_string(value)
    assert got == jax_si._java_double_to_string(value)
    if text is not None:
        assert got == text


@pytest.mark.parametrize("value, text", [(0.1, "0.1"), (1e8, "1.0E8"), (1e-4, "1.0E-4"),
                                         (float("nan"), "NaN"), (0.5, "0.5"), (3.4e38, None),
                                         (1e-45, None), (16777217.0, None)])
def test_java_float_to_string_matches_jax(value, text):
    got = port_si._java_float_to_string(np.float32(value))
    assert got == jax_si._java_float_to_string(np.float32(value))
    if text is not None:
        assert got == text


# -- FeatureHasher ------------------------------------------------------------------------------------

def _hasher_columns(seed=22, n=300):
    rng = np.random.RandomState(seed)
    return {
        "f0": rng.randint(0, 5, n).astype(np.float64),
        "f1": rng.standard_normal(n) * 1e-4,
        "f2": np.round(rng.standard_normal(n) * 1e8),
        "f3": rng.standard_normal(n),
        "f4": rng.random_sample(n).astype(np.float32),
        "s": np.asarray(["red", "green", "blue"])[rng.randint(0, 3, n)],
        "b": rng.random_sample(n) < 0.5,
        "i": rng.randint(-3, 3, n),
    }


@pytest.mark.parametrize("cols, categorical", [
    (("f0", "f1", "f2", "f3", "f4"), ("f0", "f1", "f2")),
    (("f3", "s", "b", "i"), ()),
    (("f4", "i", "f0"), ("f4", "i")),
])
@pytest.mark.parametrize("num_features", [1000, 7])
def test_featurehasher_matches_jax(cols, categorical, num_features):
    data = _hasher_columns()
    jst, pst = _stage_pair(jax_fh, port_fh, "FeatureHasher", input_cols=cols,
                           categorical_cols=categorical, num_features=num_features, output_col="o")
    got = pst.transform(Table({c: data[c] for c in cols}))[0].column("o")
    _assert_same_sparse(got, jst.transform(JaxTable({c: data[c] for c in cols}))[0].column("o"))
    assert got.indices.shape == (300, len(cols))


def test_featurehasher_row_path_matches_jax():
    """An object column takes the per-row path on both sides."""
    data = _hasher_columns(n=50)
    obj = np.empty(50, dtype=object)
    obj[:] = [np.float32(v) for v in data["f4"]]
    jst, pst = _stage_pair(jax_fh, port_fh, "FeatureHasher", input_cols=("o4", "f3"),
                           categorical_cols=("o4",), num_features=1 << 18, output_col="o")
    got = pst.transform(Table({"o4": obj, "f3": data["f3"]}))[0].column("o")
    _assert_same_sparse(got, jst.transform(JaxTable({"o4": obj, "f3": data["f3"]}))[0].column("o"))


def test_featurehasher_validates_as_jax():
    for module, table in ((jax_fh, JaxTable), (port_fh, Table)):
        t = table({"a": np.ones(3), "b": np.ones(3)})
        with pytest.raises(ValueError, match="CategoricalCols must be included"):
            module.FeatureHasher().set_input_cols("a").set_categorical_cols("b").transform(t)
        with pytest.raises(ValueError):
            module.FeatureHasher().set_num_features(0)


# -- params, save and load ------------------------------------------------------------------------------

def _param_defaults(stage):
    return {p.name: v for p, v in stage.get_param_map().items()}


@pytest.mark.parametrize("module_pair, cls", [
    ((jax_cv, port_cv), "CountVectorizer"), ((jax_cv, port_cv), "CountVectorizerModel"),
    ((jax_fh, port_fh), "FeatureHasher"), ((jax_htf, port_htf), "HashingTF"),
    ((jax_idf, port_idf), "IDF"), ((jax_idf, port_idf), "IDFModel"), ((jax_ng, port_ng), "NGram"),
    ((jax_rt, port_rt), "RegexTokenizer"), ((jax_sw, port_sw), "StopWordsRemover"),
    ((jax_si, port_si), "StringIndexer"), ((jax_si, port_si), "StringIndexerModel"),
    ((jax_si, port_si), "IndexToStringModel"), ((jax_tk, port_tk), "Tokenizer"),
])
def test_params_and_validators_match_jax(module_pair, cls):
    jax_stage, port_stage = (getattr(m, cls)() for m in module_pair)
    assert _param_defaults(port_stage) == _param_defaults(jax_stage)
    bad = {"minTF": -1.0, "vocabularySize": 0, "minDF": -0.5, "maxDF": -2.0, "numFeatures": 0,
           "minDocFreq": -1, "n": 0, "minTokenLength": -1, "stringOrderType": "random",
           "handleInvalid": "drop", "stopWords": []}
    for param in port_stage.get_param_map():
        if param.name in bad:
            for stage in (jax_stage, port_stage):
                with pytest.raises(ValueError):
                    stage.set(stage.get_param(param.name), bad[param.name])


def _fitted_models():
    """(JAX model, port model, JAX table, port table, output column) of
    each model and transformer of the slice."""
    A = _matrix(n=40, k=6, m=10, seed=23)
    jd, pd = _columns(A, "dict-tensor")
    out = []
    for jst, pst in [
        _stage_pair(jax_cv, port_cv, "CountVectorizer", input_col="t", output_col="o", min_tf=0.2),
    ]:
        out.append((jst.fit(JaxTable({"t": jd})), pst.fit(Table({"t": pd})), {"t": jd}, {"t": pd}))
    jtf, ptf = _idf_inputs("sparse-host")
    jm, pm = (s.fit(table({"t": c})) for s, table, c in zip(
        _stage_pair(jax_idf, port_idf, "IDF", input_col="t", output_col="o"), (JaxTable, Table),
        (jtf, ptf)))
    out.append((jm, pm, {"t": jtf}, {"t": ptf}))
    col = _indexer_columns("unicode")
    jm, pm = (s.fit(table({"t": col})) for s, table in zip(
        _stage_pair(jax_si, port_si, "StringIndexer", input_cols=("t",), output_cols=("o",),
                    string_order_type="frequencyAsc", handle_invalid="keep"), (JaxTable, Table)))
    out.append((jm, pm, {"t": col}, {"t": col}))
    for jst, pst, jc, pc in [
        (*_stage_pair(jax_htf, port_htf, "HashingTF", input_col="t", output_col="o",
                      num_features=32, binary=True), {"t": jd}, {"t": pd}),
        (*_stage_pair(jax_ng, port_ng, "NGram", input_col="t", output_col="o", n=3), {"t": jd}, {"t": pd}),
        (*_stage_pair(jax_sw, port_sw, "StopWordsRemover", input_cols=("t",), output_cols=("o",),
                      stop_words=("3", "4")), {"t": jd}, {"t": pd}),
        (*_stage_pair(jax_tk, port_tk, "Tokenizer", input_col="t", output_col="o"),
         {"t": np.asarray(STRINGS)}, {"t": np.asarray(STRINGS)}),
        (*_stage_pair(jax_rt, port_rt, "RegexTokenizer", input_col="t", output_col="o",
                      pattern="1+", gaps=False), {"t": np.asarray(STRINGS)}, {"t": np.asarray(STRINGS)}),
        (*_stage_pair(jax_fh, port_fh, "FeatureHasher", input_cols=("a", "b"), categorical_cols=("a",),
                      num_features=99, output_col="o"),
         {"a": np.arange(6.0), "b": np.ones(6)}, {"a": np.arange(6.0), "b": np.ones(6)}),
    ]:
        out.append((jst, pst, jc, pc))
    return out


def _same_output(got, want):
    if isinstance(got, SparseBatch):
        _assert_same_sparse(got, want)
    elif isinstance(got, DictTokenMatrix) or (isinstance(got, np.ndarray) and got.dtype == object):
        assert _token_rows(got) == _token_rows(want)
    else:
        np.testing.assert_array_equal(_host(got), np.asarray(want))


@pytest.mark.parametrize("index", range(9))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_across_packages(tmp_path, index, direction):
    jm, pm, jc, pc = _fitted_models()[index]
    path = str(tmp_path / "stage")
    if direction == "jax_to_port":
        jm.save(path)
        loaded = Stage.load(path)
        assert type(loaded) is type(pm)
        _same_output(loaded.transform(Table(pc))[0].column("o"), jm.transform(JaxTable(jc))[0].column("o"))
    else:
        pm.save(path)
        loaded = type(jm).load(path)
        assert type(loaded) is type(jm)
        _same_output(pm.transform(Table(pc))[0].column("o"), loaded.transform(JaxTable(jc))[0].column("o"))
    assert _param_defaults(loaded) == _param_defaults(pm if direction == "jax_to_port" else jm)


@pytest.mark.parametrize("index", range(3))
def test_model_data_tables_cross_load(index):
    jm, pm, jc, pc = _fitted_models()[index]
    fresh = type(pm)()
    fresh.set_model_data(*[Table({k: list(v) for k, v in
                                  ((name, [row[name] for row in t.collect()]) for name in t.column_names)})
                           for t in jm.get_model_data()])
    for p, v in pm.get_param_map().items():
        fresh.set(fresh.get_param(p.name), v)
    _same_output(fresh.transform(Table(pc))[0].column("o"), jm.transform(JaxTable(jc))[0].column("o"))


def test_load_without_the_npz_container_names_a15(tmp_path):
    pm = _fitted_models()[0][1]
    pm.save(str(tmp_path / "m"))
    data = tmp_path / "m" / "data"
    (data / "model_data.npz").rename(data / "part-0")
    # the reference's binary model data is read now (A.15): an npz is no such part file
    with pytest.raises(IOError, match="Corrupt reference model data file"):
        Stage.load(str(tmp_path / "m"))
