"""Per cent of the traced window in which the card ran nothing: one minus
the union of every kernel, copy and memset interval in the profiler's
device timeline over the window's length."""


def read(run):
    tl = run.get("timeline")
    if tl is None or tl["window_s"] <= 0 or tl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
