"""The program's phase timers (`flink_ml_tpu_torch.obs.tracing.timed`)
over a run's untraced window. None where the program records no such
timer, as a program older than these timers does."""


def per_request(run, request, *names):
    """The summed totals of the timers `names` in ms over the window's
    completed requests; None on another kind of request or with any of
    them absent."""
    timers = run.counters["timers"]
    if run.request != request or not run.window.completed:
        return None
    if any(name not in timers for name in names):
        return None
    return sum(timers[name]["totalMs"] for name in names) / run.window.completed


def per_sample(run, request, name):
    """A timer's total in ms over its own count: the device timers time
    a sample of the requests and fold a pair once the card has passed
    it, so the count is not the window's requests."""
    timer = run.counters["timers"].get(name)
    if run.request != request or not run.window.completed or timer is None \
            or not timer["count"]:
        return None
    return timer["totalMs"] / timer["count"]
