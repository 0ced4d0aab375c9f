"""Microseconds of the engine a signature in the window: the host wall time
the engine spends around each launch (packing, the launch and the
readback; the program's ``VerifyStats.total_kernel_seconds``) over the
signatures it verified."""


def read(run):
    sigs = run.get("sigs_verified")
    if not sigs or "engine_seconds" not in run:
        return None
    return 1e6 * run["engine_seconds"] / sigs
