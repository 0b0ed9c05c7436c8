"""The port's special functions, statistical tests and the three stats
stages against the JAX package's.

The same seeded numpy inputs go to both packages: the JAX side on a
one-device mesh (a device column is a `jax.Array`), the port under
`config.use_device("cpu")` (a device column is a CPU tensor).
Tolerances:

- `gammainc_p`, `betainc_reg`, `chi2_sf`, `f_sf` and `chi_square_test`
  (host float64 numpy in both packages): bit for bit;
- ANOVA and F-value tests on host columns (float64 in both): rtol 1e-12;
- on device columns (float32; the port sums the float32-centred values in
  float64, the JAX program in float32): F-statistics and p-values rtol
  1e-4, the degrees of freedom exactly;
- the stats stages, both flatten forms: the same column names, values as
  above.
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.stats import anovatest as jax_anova
from flink_ml_tpu.models.stats import chisqtest as jax_chisq
from flink_ml_tpu.models.stats import fvaluetest as jax_fvalue
from flink_ml_tpu.ops import special as jax_special
from flink_ml_tpu.ops import stats as jax_stats
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import Table, config
from flink_ml_tpu_torch.models.stats import anovatest as port_anova
from flink_ml_tpu_torch.models.stats import chisqtest as port_chisq
from flink_ml_tpu_torch.models.stats import fvaluetest as port_fvalue
from flink_ml_tpu_torch.ops import special as port_special
from flink_ml_tpu_torch.ops import stats as port_stats

HOST_TOL = dict(rtol=1e-12, atol=0)
DEVICE_TOL = dict(rtol=1e-4, atol=0)


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


# -- special functions ---------------------------------------------------------

#: (a, x) grids that take gammainc_p through each branch
GAMMA_GRIDS = {
    "series": ([0.5, 1.0, 2.5, 10.0, 150.0], [1e-8, 0.3, 1.4, 9.0, 140.0]),
    "continued_fraction": ([0.5, 1.0, 2.5, 10.0, 150.0], [1.6, 2.0, 3.6, 11.5, 200.0]),
    "non_positive_x": ([0.5, 3.0], [0.0, -1.0]),
}
#: (a, b, x) grids that take betainc_reg through each branch
BETA_GRIDS = {
    "direct": ([0.5, 2.0, 40.0, 5e5], [0.5, 3.0, 4.5, 1.0], [1e-9, 0.2, 0.5, 0.9999]),
    "reflected": ([0.5, 2.0, 4.5, 1.0], [0.5, 3.0, 40.0, 5e5], [0.9, 0.7, 0.5, 1e-7]),
    "edges": ([1.0, 2.0], [1.0, 2.0], [0.0, 1.0]),
}


def _bit_equal(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int64), want.view(np.int64)), (got, want)


@pytest.mark.parametrize("branch", sorted(GAMMA_GRIDS))
def test_gammainc_p_is_bit_equal(branch):
    a, x = GAMMA_GRIDS[branch]
    A, X = np.meshgrid(a, x)
    _bit_equal(port_special.gammainc_p(A, X), jax_special.gammainc_p(A, X))
    for ai, xi in zip(a, x):  # scalars come back as floats in both
        got, want = port_special.gammainc_p(ai, xi), jax_special.gammainc_p(ai, xi)
        assert type(got) is type(want)
        _bit_equal(got, want)


def test_gamma_grids_reach_both_branches():
    for branch, (a, x) in GAMMA_GRIDS.items():
        A, X = np.meshgrid(a, x)
        if branch == "series":
            assert ((X > 0) & (X < A + 1)).any()
        elif branch == "continued_fraction":
            assert (X >= A + 1).any()


@pytest.mark.parametrize("branch", sorted(BETA_GRIDS))
def test_betainc_reg_is_bit_equal(branch):
    a, b, x = BETA_GRIDS[branch]
    A, B, X = np.meshgrid(a, b, x)
    _bit_equal(port_special.betainc_reg(A, B, X), jax_special.betainc_reg(A, B, X))


def test_beta_grids_reach_both_branches():
    for branch in ("direct", "reflected"):
        A, B, X = np.meshgrid(*BETA_GRIDS[branch])
        inside = (X > 0) & (X < 1)
        direct = X < (A + 1) / (A + B + 2)
        assert (inside & (direct if branch == "direct" else ~direct)).any()


@pytest.mark.parametrize("df", [1.0, 4.0, 9.0, 99.0, 1e5])
def test_chi2_sf_is_bit_equal(df):
    x = np.asarray([0.0, 0.5, df, 3 * df + 10, 1e3])
    _bit_equal(port_stats.chi2_sf(x, df), jax_stats.chi2_sf(x, df))


@pytest.mark.parametrize("dfn,dfd", [(1.0, 10.0), (4.0, 95.0), (9.0, 9_990.0), (1.0, 1e7 - 2)])
def test_f_sf_is_bit_equal(dfn, dfd):
    x = np.asarray([-1.0, 0.0, 0.3, 1.0, 2.5, 40.0, 1e4])
    _bit_equal(port_stats.f_sf(x, dfn, dfd), jax_stats.f_sf(x, dfn, dfd))


# -- the tests on data ---------------------------------------------------------


def _categorical(seed=0, n=600, arities=(2, 3, 5, 7, 4, 1)):
    """Integer-valued features of the given arities (one column constant),
    labels of three classes that depend on the first two."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.integers(0, a, n) for a in arities], axis=1).astype(np.float64)
    noise = rng.integers(0, 3, n)
    y = np.where(rng.random(n) < 0.4, (X[:, 0] + X[:, 1]) % 3, noise).astype(np.float64)
    return X, y


def _continuous(seed=0, n=2_000, d=6, classes=4):
    """Float32-exact features with moderate class effects on half the
    columns, a large offset on one (the centring's case), and labels."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.float64)
    X = rng.standard_normal((n, d))
    X[:, : d // 2] += 0.08 * y[:, None]
    X[:, -1] += 1e3
    X = X.astype(np.float32).astype(np.float64)
    target = (X[:, 0] * 0.05 + rng.standard_normal(n)).astype(np.float32).astype(np.float64)
    return X, y, target


@pytest.mark.parametrize("layout", ["host", "tensor"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chi_square_test_is_bit_equal(layout, seed):
    X, y = _categorical(seed)
    want = jax_stats.chi_square_test(X, y)
    Xp, yp = (X, y) if layout == "host" else (torch.from_numpy(X), torch.from_numpy(y))
    got = port_stats.chi_square_test(Xp, yp)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _bit_equal(g, w)
    assert want[1][-1] == 0 and want[0][-1] == 1.0  # the constant column


def test_contingency_tables_count_exactly():
    X, y = _categorical(3)
    for j, table in enumerate(port_stats.contingency_tables(X, y)):
        cats, labels = np.unique(X[:, j]), np.unique(y)
        want = np.asarray([[np.sum((X[:, j] == c) & (y == l)) for l in labels] for c in cats])
        np.testing.assert_array_equal(table, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("test", ["anova", "fvalue"])
def test_host_columns_match_jax_in_float64(test, seed):
    X, y, target = _continuous(seed)
    label = y if test == "anova" else target
    name = "anova_f_test" if test == "anova" else "f_value_test"
    want = getattr(jax_stats, name)(X, label)
    got = getattr(port_stats, name)(X, label)
    np.testing.assert_allclose(got[2], want[2], **HOST_TOL)
    np.testing.assert_allclose(got[0], want[0], **HOST_TOL)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("label_layout", ["device", "host"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("test", ["anova", "fvalue"])
def test_device_columns_match_jax_device_branch(test, seed, label_layout):
    X, y, target = _continuous(seed)
    label = y if test == "anova" else target
    name = "anova_f_test" if test == "anova" else "f_value_test"
    X32 = X.astype(np.float32)
    jax_label = jax.device_put(label.astype(np.float32)) if label_layout == "device" else label
    port_label = torch.from_numpy(label.astype(np.float32)) if label_layout == "device" else label
    want = getattr(jax_stats, name)(jax.device_put(X32), jax_label)
    got = getattr(port_stats, name)(torch.from_numpy(X32), port_label)
    np.testing.assert_allclose(got[2], want[2], **DEVICE_TOL)
    np.testing.assert_allclose(got[0], want[0], **DEVICE_TOL)
    np.testing.assert_array_equal(got[1], want[1])
    assert (want[2][: X.shape[1] // 2] > 3).all() if test == "anova" else want[2][0] > 3


@pytest.mark.parametrize("test", ["anova", "fvalue"])
def test_device_branch_sums_across_chunks(test, monkeypatch):
    """The float64 sums of several row chunks equal those of one chunk to
    float64 rounding."""
    X, y, target = _continuous(4)
    label = torch.from_numpy((y if test == "anova" else target).astype(np.float32))
    fn = port_stats.anova_f_test if test == "anova" else port_stats.f_value_test
    X32 = torch.from_numpy(X.astype(np.float32))
    whole = fn(X32, label)
    monkeypatch.setattr(port_stats, "CHUNK_ROWS", 333)
    chunked = fn(X32, label)
    np.testing.assert_allclose(chunked[2], whole[2], rtol=1e-10)


def test_device_anova_keeps_the_label_classes_on_the_device():
    """Labels of any values (not 0..k-1) are mapped to their classes by a
    sort on the card, as JAX maps them."""
    X, y, _ = _continuous(5)
    y = np.asarray([-3.5, 0.25, 7.0, 1e6])[y.astype(np.int64)]
    X32 = X.astype(np.float32)
    want = jax_stats.anova_f_test(jax.device_put(X32), jax.device_put(y.astype(np.float32)))
    got = port_stats.anova_f_test(torch.from_numpy(X32), torch.from_numpy(y.astype(np.float32)))
    np.testing.assert_allclose(got[2], want[2], **DEVICE_TOL)


# -- the stages ------------------------------------------------------------------

STAGES = {
    "chisq": (jax_chisq.ChiSqTest, port_chisq.ChiSqTest, "statistic", "statistics"),
    "anova": (jax_anova.ANOVATest, port_anova.ANOVATest, "fValue", "fValues"),
    "fvalue": (jax_fvalue.FValueTest, port_fvalue.FValueTest, "fValue", "fValues"),
}


def _stage_tables(name, layout, seed=0):
    if name == "chisq":
        X, y = _categorical(seed)
    else:
        X, y, target = _continuous(seed)
        y = y if name == "anova" else target
    if layout == "host":
        return JaxTable({"features": X, "label": y}), Table({"features": X, "label": y}), "host"
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    return (JaxTable({"features": jax.device_put(X32), "label": jax.device_put(y32)}),
            Table({"features": torch.from_numpy(X32), "label": torch.from_numpy(y32)}),
            "host" if name == "chisq" else "device")


def _rows(table):
    rows = table.collect()
    return [{k: (np.asarray(v.to_array()) if hasattr(v, "to_array") else np.asarray(v))
             for k, v in row.items()} for row in rows]


@pytest.mark.parametrize("flatten", [False, True])
@pytest.mark.parametrize("layout", ["host", "device"])
@pytest.mark.parametrize("name", sorted(STAGES))
def test_stats_stage_matches_jax(name, layout, flatten):
    jax_cls, port_cls, stat, stats_col = STAGES[name]
    jax_table, port_table, branch = _stage_tables(name, layout)
    want = jax_cls().set_flatten(flatten).transform(jax_table)[0]
    got = port_cls().set_flatten(flatten).transform(port_table)[0]
    assert got.column_names == want.column_names
    want_rows, got_rows = _rows(want), _rows(got)
    assert len(got_rows) == len(want_rows) == (6 if flatten else 1)
    exact = name == "chisq"
    tol = HOST_TOL if branch == "host" else DEVICE_TOL
    for g, w in zip(got_rows, want_rows):
        for col in w:
            if col in ("featureIndex", "degreeOfFreedom", "degreesOfFreedom"):
                np.testing.assert_array_equal(g[col], w[col])
            elif exact:
                _bit_equal(g[col], w[col])
            else:
                np.testing.assert_allclose(g[col], w[col], **tol)
    if flatten:
        assert stat in got.column_names
        np.testing.assert_array_equal(got.column("featureIndex"), np.arange(6))
    else:
        assert stats_col in got.column_names


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stats_stage_params_and_save_load(name, tmp_path):
    from flink_ml_tpu_torch.api import Stage

    jax_cls, port_cls, _, _ = STAGES[name]
    stage = port_cls().set_features_col("f").set_label_col("l").set_flatten(True)
    stage.save(str(tmp_path / "s"))
    loaded = Stage.load(str(tmp_path / "s"))
    assert type(loaded) is port_cls and loaded.get_flatten() and loaded.get_features_col() == "f"
    jax_loaded = jax_cls.load(str(tmp_path / "s"))
    assert jax_loaded.get_flatten() and jax_loaded.get_label_col() == "l"
    assert port_cls().get_flatten() is jax_cls().get_flatten() is False
