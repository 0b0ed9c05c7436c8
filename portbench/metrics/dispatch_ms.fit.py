"""dispatch_ms.fit: the program's `iteration.dispatch` timer (the host's
time to enqueue a whole fit, and whatever it waits for there) a fit, over
the window. Layer: SGD engine. Fit cells."""


def read(run):
    timer = run.counters["timers"].get("iteration.dispatch")
    if run.request != "fit" or timer is None or not run.window.completed:
        return None
    return timer["totalMs"] / run.window.completed
