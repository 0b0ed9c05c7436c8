"""The port's token machinery against the JAX package's.

`ops/tokens.py`, `utils/hashing.py`, the native hashing-trick kernels,
`models/feature/_tokens.py`, `_stopwords.py` and the token columns of
`Table` in flink_ml_tpu_torch get the same seeded numpy inputs as
flink_ml_tpu's: host arrays on both sides, or a `jax.Array` against a CPU
tensor (the port under `config.use_device("cpu")`). Every comparison is
exact: ids, counts, widths, dtypes and vocabularies are integers or
strings, and the float32 counts are small integers. The native
`combine_hashed` is held against the numpy `_combine_hashed` on values
whose sums are exact (integers), where both must agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu.models.feature import _stopwords as jax_stopwords
from flink_ml_tpu.models.feature import _tokens as jax_tokens_host
from flink_ml_tpu.models.feature import featurehasher as jax_fh
from flink_ml_tpu.ops import tokens as jax_tokens
from flink_ml_tpu.table import DictTokenMatrix as JaxDictTokenMatrix
from flink_ml_tpu.table import Table as JaxTable
from flink_ml_tpu.utils import hashing as jax_hashing
from flink_ml_tpu_torch import Table, config, native
from flink_ml_tpu_torch.models.feature import _stopwords as port_stopwords
from flink_ml_tpu_torch.models.feature import _tokens as port_tokens_host
from flink_ml_tpu_torch.models.feature import featurehasher as port_fh
from flink_ml_tpu_torch.native import hashkernels as port_native
from flink_ml_tpu_torch.ops import tokens as port_tokens
from flink_ml_tpu_torch.table import DictTokenMatrix
from flink_ml_tpu_torch.utils import hashing as port_hashing
from flink_ml_tpu_torch.utils.datastream import sample


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.use_device("cpu"):
        yield


def _ids(n=500, k=16, u=40, seed=0, holes=0.1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, u, size=(n, k)).astype(np.int32)
    ids[rng.random_sample(ids.shape) < holes] = -1
    return ids


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- device ops ---------------------------------------------------------------------

@pytest.mark.parametrize("u", [40, 700])
@pytest.mark.parametrize("chunk_rows", [97, 1_000_000])
def test_term_counts_match_jax(u, chunk_rows):
    """tf and df, on both of the JAX package's forms (dense compare at
    u <= 512, row sort above), across a chunk boundary at 97 rows."""
    ids = _ids(u=u)
    got = port_tokens.term_counts_chunked(ids, u, chunk_rows=chunk_rows)
    want = jax_tokens.term_counts_chunked(jax.device_put(ids), u, chunk_rows=chunk_rows)
    _equal(got, want)
    _equal(port_tokens.term_counts(torch.from_numpy(ids), u),
           jax_tokens.term_counts(jax.device_put(ids), u))


def _thresholds(ids, kind):
    if kind == "count":
        return np.full(ids.shape[0], 2.0, np.float32)
    valid = (ids >= 0).sum(axis=1)
    return (np.float32(0.2) * valid.astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("thr", ["count", "fraction"])
@pytest.mark.parametrize("binary", [False, True])
def test_row_term_runs_match_jax(thr, binary):
    mapped = _ids(seed=3, u=9)
    t = _thresholds(mapped, thr)
    got = port_tokens.row_term_runs(torch.from_numpy(mapped), torch.from_numpy(t), binary)
    want = jax_tokens.row_term_runs(jax.device_put(mapped), jax.device_put(t), binary=binary)
    for g, w in zip(got, want):
        _equal(g, w)
    got = port_tokens.row_term_counts_dense(torch.from_numpy(mapped), torch.from_numpy(t), 9,
                                            binary)
    want = jax_tokens.row_term_counts_dense(jax.device_put(mapped), jax.device_put(t), 9,
                                            binary=binary)
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[0].shape == (500, 9)


@pytest.mark.parametrize("num_terms", [13, 512, 513, 4096])
@pytest.mark.parametrize("thr", ["count", "fraction"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("lut_form", ["host", "device"])
def test_map_term_runs_chunked_matches_jax(num_terms, thr, binary, lut_form):
    """The padded width is min(k, V) up to V = 512 and k above, as the JAX
    package's dense and sort-run forms give it; across a chunk boundary;
    with a dropped dictionary entry (-1 in the lut) and colliding ids."""
    ids = _ids(seed=5, u=40)
    lut = ((np.arange(40) * 7919) % num_terms).astype(np.int32)
    lut[5] = -1
    t = _thresholds(ids, thr)
    jax_lut = lut if lut_form == "host" else jax.device_put(lut)
    port_lut = lut if lut_form == "host" else torch.from_numpy(lut)
    got = port_tokens.map_term_runs_chunked(torch.from_numpy(ids), port_lut, torch.from_numpy(t),
                                            binary=binary, chunk_rows=97, num_terms=num_terms)
    want = jax_tokens.map_term_runs_chunked(jax.device_put(ids), jax_lut, jax.device_put(t),
                                            binary=binary, chunk_rows=97, num_terms=num_terms)
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert got[0].shape[1] == (min(16, num_terms) if num_terms <= 512 else 16)


def test_map_term_runs_takes_host_ids_a_chunk_at_a_time():
    ids = _ids(seed=6)
    lut = np.arange(40, dtype=np.int32)
    t = np.ones(500, np.float32)
    host = port_tokens.map_term_runs_chunked(ids, lut, t, chunk_rows=64, num_terms=40)
    dev = port_tokens.map_term_runs_chunked(torch.from_numpy(ids), lut, t, num_terms=40)
    for h, d in zip(host, dev):
        assert isinstance(h, torch.Tensor)
        _equal(h, d)


@pytest.mark.parametrize("dropped", [[3, 7, 21], list(range(0, 40, 2))])
@pytest.mark.parametrize("chunk_rows", [77, 1_000_000])
def test_filter_tokens_match_jax(dropped, chunk_rows):
    ids = _ids(seed=8)
    keep = np.ones(40, bool)
    keep[dropped] = False
    got = port_tokens.filter_tokens_chunked(torch.from_numpy(ids), keep, chunk_rows=chunk_rows)
    want = jax_tokens.filter_tokens_chunked(jax.device_put(ids), keep, chunk_rows=chunk_rows)
    _equal(got, want)
    _equal(port_tokens.filter_tokens(torch.from_numpy(ids), torch.from_numpy(keep)),
           jax_tokens.filter_tokens(jax.device_put(ids), jax.device_put(keep)))
    assert got.dtype == torch.int32


def test_filter_tokens_with_nothing_to_drop_returns_the_ids():
    ids = torch.from_numpy(_ids(seed=9))
    assert port_tokens.filter_tokens_chunked(ids, np.ones(40, bool)) is ids
    host = _ids(seed=9)
    out = port_tokens.filter_tokens_chunked(host, np.ones(40, bool))
    assert isinstance(out, torch.Tensor) and np.shares_memory(out.numpy(), host)


@pytest.mark.parametrize("gram", [1, 2, 3])
def test_ngram_codes_match_jax(gram):
    ids = _ids(seed=10, u=12, k=7)
    got = port_tokens.ngram_codes(torch.from_numpy(ids), 12, gram)
    _equal(got, jax_tokens.ngram_codes(jax.device_put(ids), 12, gram))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("gram", [1, 2, 3])
def test_ngram_vocabularies_match_jax(gram):
    vocab = np.asarray(["a", "bb", "c", "dd", "e", "ff"])
    full_p, full_j = port_tokens.ngram_vocab_full(vocab, gram), jax_tokens.ngram_vocab_full(vocab, gram)
    assert full_p.dtype == full_j.dtype
    np.testing.assert_array_equal(full_p, full_j)
    codes = jax_tokens.ngram_codes(jax.device_put(_ids(seed=11, u=6, k=5)), 6, gram)
    got_v, got_c = port_tokens.ngram_vocab_observed(vocab, gram, torch.from_numpy(np.asarray(codes)))
    want_v, want_c = jax_tokens.ngram_vocab_observed(vocab, gram, codes)
    assert got_v.dtype == want_v.dtype
    np.testing.assert_array_equal(got_v, want_v)
    _equal(got_c, want_c)


def test_ngram_vocab_of_no_codes_is_empty():
    codes = torch.full((3, 2), -1, dtype=torch.int32)
    v, c = port_tokens.ngram_vocab_observed(np.asarray(["a"]), 2, codes)
    assert v.shape == (0,) and v.dtype == np.dtype("<U1")
    _equal(c, codes)
    assert port_tokens.ngram_vocab_full(np.zeros(0, "<U1"), 2).dtype == np.dtype("<U1")


def test_random_token_ids_are_seeded_int32_in_range():
    a = port_tokens.random_token_ids(3, 50, 7, 11)
    b = port_tokens.random_token_ids(3, 50, 7, 11)
    assert a.dtype == torch.int32 and a.shape == (50, 7) and a.device.type == "cpu"
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 11
    assert not torch.equal(a, port_tokens.random_token_ids(4, 50, 7, 11))


# -- hashing ------------------------------------------------------------------------

TERMS = ["", "a", "ab", "abc", "hello world", "ünïcødé", "\U0001F600x", "a\x00b", "x" * 37]


@pytest.mark.parametrize("term", TERMS + [0, 1, -1, 2**31, -(2**40), 3.5, -0.0, True, None])
def test_hash_term_matches_jax(term):
    assert port_hashing.hash_term(term) == jax_hashing.hash_term(term)


def test_murmur3_int_long_and_batch_match_jax():
    for v in (0, 1, -7, 2**31 - 1, -(2**31)):
        assert port_hashing.murmur3_hash_int(v) == jax_hashing.murmur3_hash_int(v)
        assert port_hashing.murmur3_hash_long(v * 977) == jax_hashing.murmur3_hash_long(v * 977)
    rng = np.random.RandomState(12)
    strings = np.asarray([f"f{rng.randint(9)}={rng.random_sample()}" for _ in range(300)])
    got = port_hashing.murmur3_batch_unencoded_chars(strings)
    np.testing.assert_array_equal(got, jax_hashing.murmur3_batch_unencoded_chars(strings))
    np.testing.assert_array_equal(got, [port_hashing.murmur3_hash_unencoded_chars(s) for s in strings])
    objects = np.empty(len(TERMS), dtype=object)
    objects[:] = TERMS
    np.testing.assert_array_equal(port_hashing.murmur3_batch_unencoded_chars(objects),
                                  jax_hashing.murmur3_batch_unencoded_chars(objects))


def _hasher_inputs(seed=13, n=2000):
    rng = np.random.RandomState(seed)
    doubles = rng.standard_normal(n) * 10.0 ** rng.randint(-6, 9, n)
    doubles[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e7]
    strings = np.asarray([f"v{i % 97}" for i in range(n)])
    return doubles, strings


@pytest.mark.parametrize("prefix", ["f0=", "long_column_name="])
def test_native_categorical_hashes_match_numpy_and_jax(prefix):
    doubles, strings = _hasher_inputs()
    got = port_native.hash_categorical_doubles(doubles, prefix, 1000)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_fh._hash_categorical_column(doubles, prefix, 1000))
    rendered = port_fh._render_java_doubles(doubles)
    plain = port_hashing.murmur3_batch_unencoded_chars(np.char.add(prefix, rendered))
    plain = np.where(plain == -(2**31), plain, np.abs(plain)) % 1000
    np.testing.assert_array_equal(got, plain)
    got = port_native.hash_categorical_strings(strings, prefix, 1000)
    np.testing.assert_array_equal(got, jax_fh._hash_categorical_column(strings, prefix, 1000))
    plain = port_hashing.murmur3_batch_unencoded_chars(np.char.add(prefix, strings))
    np.testing.assert_array_equal(got, np.where(plain == -(2**31), plain, np.abs(plain)) % 1000)


def test_native_prefix_outside_the_envelope_is_refused():
    assert port_native.hash_categorical_doubles(np.ones(3), "x" * 65, 10) is None
    assert port_native.hash_categorical_strings(np.asarray(["a"]), "\U0001F600=", 10) is None
    assert port_native.combine_hashed(np.zeros((2, 65), np.int64), np.ones((2, 65))) is None


@pytest.mark.parametrize("k", [1, 5, 64])
def test_native_combine_equals_numpy_and_jax(k):
    rng = np.random.RandomState(k)
    idxs = rng.randint(0, 7, size=(400, k)).astype(np.int64)
    vals = rng.randint(-3, 4, size=(400, k)).astype(np.float64)
    got = port_native.combine_hashed(idxs, vals)
    plain = port_fh._combine_hashed(idxs, vals)
    want = jax_fh._combine_hashed(idxs, vals)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float64


def test_hashkernels_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cc"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(native, "HASH_SOURCE", broken)
    monkeypatch.setattr(native, "HASH_LIBRARY", tmp_path / "_build" / "libbroken.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken.cc"):
        native.load_hashkernels()


# -- host helpers and data ---------------------------------------------------------------

def test_stop_words_are_the_jax_package_copy():
    assert port_stopwords.STOP_WORDS == jax_stopwords.STOP_WORDS


def _matrix(n=60, k=8, m=12, seed=0, width=None):
    vocab = np.arange(m).astype(str)
    if width:
        vocab = vocab.astype(f"<U{width}")
    return vocab[np.random.RandomState(seed).randint(0, m, size=(n, k))]


@pytest.mark.parametrize("width", [None, 1, 2, 5])
def test_host_token_helpers_match_jax(width):
    A = _matrix(m=23, width=width)
    (pu, pi), (ju, ji) = port_tokens_host.encode(A), jax_tokens_host.encode(A)
    np.testing.assert_array_equal(pu, ju)
    np.testing.assert_array_equal(pi, ji)
    ids = pi.copy()
    ids[::3, 1] = -1
    for g, w in zip(port_tokens_host.row_run_counts(ids), jax_tokens_host.row_run_counts(ids)):
        np.testing.assert_array_equal(g, w)
    runs = port_tokens_host.row_run_counts(ids)
    got = port_tokens_host.sparse_from_runs(ids.shape[0], 23, *runs)
    want = jax_tokens_host.sparse_from_runs(ids.shape[0], 23, *runs)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.values.dtype == np.float64
    mapping = {"3": 0, "7": 5}
    np.testing.assert_array_equal(port_tokens_host.lookup(pu, mapping),
                                  jax_tokens_host.lookup(ju, mapping))
    S = A[:, 0]
    got = port_tokens_host.map_rows_by_unique(S, lambda s: s * 2)
    assert list(got) == list(jax_tokens_host.map_rows_by_unique(S, lambda s: s * 2))


def _dict_pair(A, form="numpy"):
    uniq, ids = jax_tokens_host.encode(A)
    port_ids = torch.from_numpy(ids.copy()) if form == "tensor" else ids.copy()
    return JaxDictTokenMatrix(uniq, jax.device_put(ids)), DictTokenMatrix(uniq, port_ids)


def _collected(table, name="tok"):
    return [r[name] for r in table.collect()]


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_token_columns_collect_and_take_as_jax(form):
    A = _matrix(n=5, k=3)
    jd, pd = _dict_pair(A, form)
    assert _collected(Table({"tok": A})) == _collected(JaxTable({"tok": A})) == A.tolist()
    assert _collected(Table({"tok": pd})) == _collected(JaxTable({"tok": jd})) == A.tolist()
    rows = np.asarray([4, 0, 2])
    taken = Table({"tok": pd, "x": np.arange(5.0)}).take(rows)
    assert isinstance(taken.column("tok"), DictTokenMatrix)
    assert _collected(taken) == _collected(JaxTable({"tok": jd}).take(rows))
    assert type(taken.column("tok").ids) is type(pd.ids)


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_concat_dict_tokens_of_different_vocabularies_as_jax(form):
    ja, pa = _dict_pair(np.asarray([["a", "b"], ["b", "a"]]), form)
    jb, pb = _dict_pair(np.asarray([["c", "a", "c"], ["a", "c", "b"]]), form)
    got = Table({"tok": pa}).concat(Table({"tok": pb}))
    want = JaxTable({"tok": ja}).concat(JaxTable({"tok": jb}))
    assert _collected(got) == _collected(want) == [["a", "b"], ["b", "a"], ["c", "a", "c"],
                                                   ["a", "c", "b"]]
    col = got.column("tok")
    np.testing.assert_array_equal(col.vocab, want.column("tok").vocab)
    np.testing.assert_array_equal(col.host_ids(), want.column("tok").host_ids())
    assert isinstance(col.ids, torch.Tensor) == (form == "tensor")


def _object(rows):
    out = np.empty(len(rows), dtype=object)
    out[:] = rows
    return out


@pytest.mark.parametrize("pair", ["unicode widths", "matrix object", "object dict",
                                  "unicode same width"])
def test_mixed_token_layouts_concat_as_jax(pair):
    d = np.asarray([["a", "x"]])
    a, b = {
        "unicode widths": (np.asarray([["a", "b"]]), np.asarray([["c", "d", "e"]])),
        "matrix object": (np.asarray([["a", "b"]]), _object([["c"]])),
        "object dict": (_object([["x", "y"], []]), "dict"),
        "unicode same width": (np.asarray([["a", "b"]]), np.asarray([["c", "d"]])),
    }[pair]
    jb, pb = (_dict_pair(d) if isinstance(b, str) else (b, b))
    got = Table({"tok": a}).concat(Table({"tok": pb}))
    want = JaxTable({"tok": a}).concat(JaxTable({"tok": jb}))
    assert _collected(got) == _collected(want)
    assert type(got.column("tok")).__name__ == type(want.column("tok")).__name__


def test_reservoir_sample_of_a_token_table():
    tables = [Table({"tok": _dict_pair(_matrix(n=20, k=3, seed=s))[1]}) for s in range(3)]
    out = sample(tables, 10, seed=0)
    assert out.num_rows == 10 and isinstance(out.column("tok"), DictTokenMatrix)
