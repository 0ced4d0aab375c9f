"""Kernel launches of the shared coalescer a decision: the engine's
``VerifyStats.launches`` over the window, over the decisions that every
replica committed in it."""


def read(run):
    decisions = run.get("decisions_in_window")
    if not decisions or "launches" not in run:
        return None
    return run["launches"] / decisions
