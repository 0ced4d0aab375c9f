"""Microseconds of the protocol core a committed transaction: the program's
``PROTOCOL_PLANE`` timers (ingest, route, codec and vote registration,
all replicas) over the window, over the requests committed in it."""


def read(run):
    tx = run.get("tx_in_window")
    if not tx or "protocol_us" not in run:
        return None
    return run["protocol_us"] / tx
