"""fit_ms: the window's wall time over the fits completed in it (ms a
fit), host clock. Cells whose requests are fits."""


def read(run):
    if run.request != "fit" or not run.window.completed:
        return None
    return run.window.seconds * 1e3 / run.window.completed
