"""A kernel's share of its roofline in the traced slice: the least time
the card's peaks allow for the launches found in the trace (bytes and
operations of one launch from `counts/<kernel>.py`), over their measured
device time. None where the trace holds no launch of the kernel."""


def roofline(run, kernel_name, count_name, shape):
    if run.trace is None:
        return None
    seconds, launches = run.trace["kernels"].get(kernel_name, (0.0, 0))
    if not launches or seconds <= 0:
        return None
    floor = run.floor_s(*run.count(count_name, *shape))
    if floor is None:
        return None
    return 100.0 * floor * launches / seconds


def fit_batch(run):
    """(rows, nnz, d) of a sparse fit's batch."""
    data, params = run.cell.config["data"], run.cell.config["estimator"]["params"]
    return (min(int(params["globalBatchSize"]), int(data["numValues"])), int(data["nnz"]),
            int(data["numFeatures"]))


def score_rows(run):
    """(rows, nnz, d) of a sparse transform's request."""
    data, rows = run.cell.config["data"], run.cell.mix.get("rows", "all")
    n = int(data["numValues"]) if rows == "all" else int(rows)
    return n, int(data["nnz"]), int(data["numFeatures"])
