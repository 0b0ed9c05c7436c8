"""sparse_row_dots_roofline.score: `row_dots_kernel`'s share of its
roofline at a transform's rows, from the traced slice. Layer: kernels.
Sparse transform cells."""

from portbench.metrics._kernel import roofline, score_rows


def read(run):
    if run.request != "transform" or "nnz" not in run.cell.config["data"]:
        return None
    return roofline(run, "row_dots_kernel", "sparse_row_dots", score_rows(run))
