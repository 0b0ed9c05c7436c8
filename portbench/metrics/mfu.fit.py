"""mfu.fit: a whole fit's share of the card's peaks: the least time the
published peaks allow for its bytes and operations (`counts/fit.py`; the
bytes bound it), over the window's ms a fit (fit_ms). Layer: the whole
step. Fit cells."""


def read(run):
    if run.request != "fit" or not run.window.completed:
        return None
    floor = run.floor_s(*run.count("fit", run.cell.config))
    if floor is None:
        return None
    return 100.0 * floor * run.window.completed / run.window.seconds
