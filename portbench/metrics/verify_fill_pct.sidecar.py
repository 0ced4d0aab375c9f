"""Per cent of the launched lanes that carried a signature in the window:
the engine's ``VerifyStats`` signatures over its padded slots."""


def read(run):
    slots = run.get("slots_used")
    if not slots:
        return None
    return 100.0 * run["sigs_verified"] / slots
