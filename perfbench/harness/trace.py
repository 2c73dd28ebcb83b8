"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` with CPU
and CUDA activity over a few calls in the middle of the window, the
profiler's events kept in memory (no trace file is written).

The profiler starts one call before the stretch, so that its own start-up
falls outside it. The stretch is bounded by two marks (zero-length
``record_function`` spans made here, at the end of the call before the
stretch and at the end of its last call), so its wall time is the time of
whole calls. ``Reading`` holds
what the per-layer metric readers take: every device operation in the
stretch (kernels, copies and sets; the device-side ranges of
``record_function`` spans, such as ``Optimizer.step#Adam.step``, are
spans and not operations, and are left out), the union of their intervals
(the device's busy time), and the host's activity in each idle gap.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

MARK = "perfbench.mark"


@dataclasses.dataclass
class Reading:
    window_s: float        # wall time of the stretch
    busy_s: float          # union of the device operations' intervals
    ops: list              # (name, seconds) of every device operation
    gaps: list             # (host activity, seconds) of every idle gap
    calls: int             # calls in the stretch

    def op_seconds(self, pick=lambda name: True) -> float:
        return sum(s for name, s in self.ops if pick(name))

    def breakdown(self, top: int = 10) -> dict:
        by_op = collections.Counter()
        for name, s in self.ops:
            by_op[name] += s
        by_gap = collections.Counter()
        for name, s in self.gaps:
            by_gap[name] += s
        return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
                "idle_gaps": [[n, s] for n, s in by_gap.most_common(top)]}


class Stretch:
    """``start`` one call before the stretch, ``begin`` before its first
    call, ``end`` after its last (each after a call's result is on the
    host)."""

    def __init__(self, calls: int):
        self.calls = calls
        self.prof = None

    @staticmethod
    def mark():
        with torch.profiler.record_function(MARK):
            pass

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def begin(self):
        self.mark()

    def end(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.mark()
        self.prof.stop()

    def read(self) -> Reading | None:
        """The stretch's reading, or None where the profiler delivered no
        device operation."""
        cuda = torch.autograd.DeviceType.CUDA
        events = self.prof.events()
        marks = sorted(e.time_range.start for e in events if e.name == MARK)
        if len(marks) < 2:
            return None
        w0, w1 = marks[0], marks[-1]
        # a device event that bears a host span's name (or is marked a user
        # annotation) is that span's range on the device, not work
        spans = {e.name for e in events if e.device_type != cuda}
        dev, host = [], []
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                if (getattr(e, "is_user_annotation", False)
                        or e.name in spans):
                    continue
                if b > w0 and a < w1:
                    dev.append((max(a, w0), min(b, w1), e.name))
            elif e.name != MARK and b > w0 and a < w1:
                host.append((a, b, e.name))
        if not dev:
            return None
        dev.sort()
        busy, gaps = 0.0, []
        cur_a, cur_b = w0, w0
        for a, b, _ in dev:
            if a > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a = a
            cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        if w1 > cur_b:
            gaps.append((cur_b, w1))
        return Reading(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                       ops=[(n, (b - a) / 1e6) for a, b, n in dev],
                       gaps=[(_host_activity(host, a, b), (b - a) / 1e6)
                             for a, b in gaps],
                       calls=self.calls)


def _host_activity(host, a, b) -> str:
    """What the host was doing in the idle gap (a, b): the outermost and
    the innermost host span over its middle."""
    mid = (a + b) / 2
    over = [(e - s, name) for s, e, name in host if s <= mid <= e]
    if not over:
        return "python (no traced operation)"
    over.sort()
    inner, outer = over[0][1], over[-1][1]
    return inner if inner == outer else f"{outer} > {inner}"
