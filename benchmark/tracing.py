"""The device trace of a traced run: torch.profiler over a steady part of
the window, reduced to device intervals, busy time, kernel sums and idle
gaps labelled by the benchmark's host spans.

Spans are ``torch.profiler.record_function`` ranges named ``bench.*`` that
the drivers open around their calls into the program.
"""

from __future__ import annotations

import torch

SPAN_PREFIX = "bench."


def session() -> torch.profiler.profile:
    """A profiler of the host's ranges and the card's activity (the host's
    alone where there is no card: the tests)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def warm() -> None:
    """Open and close one short session, so that the profiler's one-time
    start (CUPTI's) falls into set-up and not into the window."""
    with session():
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


class Trace:
    """What one profile recorded: ``device`` [(name, start_us, end_us)] of
    kernels, copies and fills (not user annotations), ``spans`` [(name,
    start_us, end_us)] of the host's ``bench.*`` ranges."""

    def __init__(self, prof: torch.profiler.profile):
        self.device, self.spans = [], []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    self.device.append((e.name, tr.start, tr.end))
            elif e.name.startswith(SPAN_PREFIX):
                self.spans.append((e.name, tr.start, tr.end))
        self.device.sort(key=lambda ev: ev[1])

    def busy(self) -> list:
        """The union of the device intervals, [(start_us, end_us)]."""
        out = []
        for _, s, t in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy()) / 1e6

    def kernel_s(self, patterns) -> tuple:
        """(seconds, launches) of the device events whose name holds any of
        ``patterns``."""
        hits = [t - s for n, s, t in self.device
                if any(p in n for p in patterns)]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the k device operations (by name) that took
        the most time."""
        by = {}
        for n, s, t in self.device:
            by[n[:120]] = by.get(n[:120], 0.0) + (t - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[[span, seconds]]: the device's idle time between its first and
        last event, summed by the innermost ``bench.*`` span the host was in
        when each gap began ("host outside spans" where none), the k
        largest."""
        busy = self.busy()
        by = {}
        for (_, end), (start, _) in zip(busy, busy[1:]):
            inner = [sp for sp in self.spans if sp[1] <= end < sp[2]]
            label = (max(inner, key=lambda sp: sp[1])[0] if inner
                     else "host outside spans")
            by[label] = by.get(label, 0.0) + (start - end) / 1e6
        return [[n, v] for n, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]
