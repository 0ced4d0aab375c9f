"""The measured window, and with ``--trace 1`` the card's timeline over it.

The timeline comes from ``torch.profiler`` (CUPTI): every kernel, copy and
memset the card ran, the kernels of the program's own libraries included.
Busy time is the union of those intervals inside the window; the idle
gaps are what lies between them, each named by the torch call the host
was in at the gap's middle, or as host Python outside torch calls.
"""

from __future__ import annotations

import time

#: the profiler's name of the span that marks the window
WINDOW_MARK = "portbench.window"
#: at most this many entries in each list of the breakdown
TOP = 10


def short_name(name: str) -> str:
    """A kernel's function name without namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].rsplit("::", 1)[-1].strip() or name


class Window:
    """``start()`` opens the window, ``stop()`` closes it; ``seconds`` is
    its length on the host clock.  With ``trace`` the profiler records the
    card over it and ``timeline`` holds the summary after ``stop()``."""

    def __init__(self, trace: bool, cuda: bool):
        self.trace = trace
        self.cuda = cuda
        self.t0 = self.t1 = 0.0
        self.timeline: dict | None = None
        self._prof = None
        self._mark = None

    def start(self) -> None:
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._mark = record_function(WINDOW_MARK)
            self._mark.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self._prof is not None:
            self._mark.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self.timeline = summarize(
                self._prof.profiler.kineto_results.events())
            self._prof = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def summarize(events) -> dict:
    """Busy seconds, kernel seconds and launches by name, the device
    operations that took most time and the longest idle gaps, from the
    profiler's raw events, clipped to the window mark."""
    w0 = w1 = None
    dev, host = [], []
    for e in events:
        kind = str(e.device_type())
        if e.name() == WINDOW_MARK:
            w0, w1 = e.start_ns(), e.start_ns() + e.duration_ns()
        elif "CUDA" in kind:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
        elif e.duration_ns() > 0:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name()))
    if w0 is None:
        raise RuntimeError("the profiler recorded no window mark")
    ops: dict[str, list] = {}
    spans = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        rec = ops.setdefault(short_name(name), [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) * 1e-9
        spans.append((a, b))
    spans.sort()
    busy_ns, gaps, cur_end = 0, [], w0
    for a, b in spans:
        if a > cur_end:
            gaps.append((cur_end, a))
        if b > cur_end:
            busy_ns += b - max(a, cur_end)
            cur_end = b
    if w1 > cur_end:
        gaps.append((cur_end, w1))
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        named.append([_host_at(host, starts, (a + b) // 2), (b - a) * 1e-9])
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "kernels": {k: {"launches": v[0], "seconds": v[1]}
                    for k, v in ops.items()},
        "device_ops": [[k, v[1]] for k, v in top_ops],
        "idle_gaps": named,
    }


def _host_at(host, starts, t) -> str:
    """The innermost torch call the host was in at ``t``."""
    import bisect

    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if host[i][1] > t:
            return "host in " + short_name(host[i][2])
        if t - host[i][0] > 10**9:
            break
    return "host Python outside torch calls"
