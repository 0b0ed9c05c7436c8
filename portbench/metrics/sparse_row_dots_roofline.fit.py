"""sparse_row_dots_roofline.fit: `row_dots_kernel`'s share of its
roofline at the fit's batch, from the traced slice. Layer: kernels.
Sparse fit cells."""

from portbench.metrics._kernel import fit_batch, roofline


def read(run):
    if run.request != "fit" or "nnz" not in run.cell.config["data"]:
        return None
    return roofline(run, "row_dots_kernel", "sparse_row_dots", fit_batch(run))
