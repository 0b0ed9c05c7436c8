"""score_rows_per_s: the rows the window's transforms scored over the
window's seconds, host clock. Cells whose requests are transforms."""


def read(run):
    if run.request != "transform" or not run.window.completed:
        return None
    return run.window.rows / run.window.seconds
