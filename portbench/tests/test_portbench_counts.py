"""Each count function against a hand count from the shapes."""

from portbench.plugins import data_file, plugin

SPARSE = data_file("configs", "lr_sparse_criteo")
DENSE = data_file("configs", "lr_dense_conf")


def test_sparse_kernels_at_the_fit_batch():
    # 100,000 x 39 slots of int32 + float32 (31.2 MB), the 4 MB coefficient
    # (row dots) or gradient (sparse_grad), 0.4 MB of dots or multipliers
    hand = 100_000 * 39 * 8 + 1_000_000 * 4 + 100_000 * 4
    assert hand == 35_600_000
    for kernel in ("sparse_row_dots", "sparse_grad"):
        nbytes, flops = plugin("counts", kernel).count(100_000, 39, 1_000_000)
        assert nbytes == hand and flops == 2 * 100_000 * 39


def test_fits():
    # 100 epochs (sparse: one pass over its 10M rows) and 20 epochs (dense) of
    # 100,000-row batches, every label once, the coefficient in and out
    sparse = 100 * 100_000 * 39 * 8 + 10_000_000 * 4 + 2 * 1_000_000 * 4
    dense = 20 * 100_000 * (100 * 4 + 4) + 10_000_000 * 4 + 2 * 100 * 4
    assert plugin("counts", "fit").count(SPARSE)[0] == sparse == 3_168_000_000
    assert plugin("counts", "fit").count(DENSE)[0] == dense == 848_000_800


def test_transforms_of_ten_million_rows():
    sparse = 10_000_000 * (39 * 8 + 12) + 1_000_000 * 4
    dense = 10_000_000 * (100 * 4 + 12) + 100 * 4
    assert plugin("counts", "score").count(SPARSE, 10_000_000)[0] == sparse
    assert plugin("counts", "score").count(DENSE, 10_000_000)[0] == dense
