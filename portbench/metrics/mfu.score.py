"""mfu.score: a transform's share of the card's peaks: the least time the
published peaks allow for its bytes and operations (`counts/score.py`;
the bytes bound it), over the window's time a transform. Layer: the whole
step. Transform cells."""


def read(run):
    if run.request != "transform" or not run.window.completed:
        return None
    rows = run.window.rows / run.window.completed
    floor = run.floor_s(*run.count("score", run.cell.config, rows))
    if floor is None:
        return None
    return 100.0 * floor * run.window.completed / run.window.seconds
