"""What every loop of ``perfbench/loops/`` shares: the run's record, the
measured window's clock and the traced stretch's place in it, and the
inputs drawn from the seed.

A loop is a closed loop of the program's calls: the next call starts when
the last one has returned. Set-up (``setup_s``) runs from process start to
the first timed call: the imports, the card's start, the kernel library's
load (its build, in a checkout's first run), the scene build, and the
traffic's ``warmup_calls`` calls, which run the key's eager call, its
capture and a first replay. Then calls run until ``seconds`` have passed;
every call of the window is timed, and the window's length is the time of
its calls. With a stretch (``--trace 1``) the profiler reads
``trace_calls`` calls after ``trace_skip_calls`` calls of the window (at
least 1: the profiler starts a call early), and the window runs on, untraced,
until ``untraced_seconds`` of whole calls (3 at least) have passed after
the call that follows the stretch: those calls' wall time is what
``device_idle_pct`` holds the stretch's device time against.
"""

from __future__ import annotations

import dataclasses

import torch

from .trace import Stretch

MIN_UNTRACED_CALLS = 3


@dataclasses.dataclass
class Run:
    setup_s: float
    call_s: list           # wall seconds of each call of the window
    elapsed_s: float       # the window: from its first call to its last's end
    lanes: int             # pixel samples a call completes
    stretch: Stretch | None
    stretch_calls: list    # per traced call: what the reference redoes
    untraced_s: list       # wall seconds of the untraced calls after it
    outputs: dict          # what the program produced, for the check
    memory_peak_bytes: int
    counters: dict         # the compiled caches' counts: set-up, window
    setup_marks: dict      # seconds from process start to each set-up step


class Schedule:
    """Where the traced stretch and the untraced calls after it lie among
    the window's calls (numbered from 0), and when the window may close."""

    def __init__(self, traffic, trace: bool, seconds: float):
        self.trace = trace
        self.seconds = seconds
        self.first = traffic["trace_skip_calls"]
        self.last = self.first + traffic["trace_calls"]
        self.untraced_seconds = traffic["untraced_seconds"]
        self.untraced = []

    def stretch(self, calls: int) -> Stretch | None:
        return Stretch(calls) if self.trace else None

    def timed(self, k: int, call_s: float):
        """Note the wall time of window call ``k``."""
        if self.trace and k > self.last and not self._untraced_done():
            self.untraced.append(call_s)

    def _untraced_done(self) -> bool:
        return (len(self.untraced) >= MIN_UNTRACED_CALLS
                and sum(self.untraced) >= self.untraced_seconds)

    def closes(self, calls_done: int, elapsed: float,
               more: int = 0) -> bool:
        """Whether the window closes after ``calls_done`` calls, ``elapsed``
        seconds in; ``more``: calls the loop still needs for its check."""
        if elapsed < self.seconds or calls_done < more:
            return False
        return not self.trace or (calls_done >= self.last
                                  and self._untraced_done())


def peak(device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def check_pixels(seed, n_pixels, count) -> torch.Tensor:
    """The pixels whose accumulated radiance is compared: ``count`` drawn
    from the seed, ascending, i32 on the host."""
    g = torch.Generator().manual_seed(int(seed) % 2 ** 63)
    pick = torch.randperm(n_pixels, generator=g)[:count]
    return pick.sort().values.to(torch.int32)


def target_image(seed, spec, height, width, device) -> torch.Tensor:
    """The fit's target, made from the seed: a ``grid`` x ``grid`` field of
    colours drawn in [low, high), blown up to the image."""
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    n = spec["grid"]
    cells = torch.rand((1, 3, n, n), generator=g, device=device)
    cells = spec["low"] + (spec["high"] - spec["low"]) * cells
    img = torch.nn.functional.interpolate(cells, size=(height, width),
                                          mode="nearest")
    return img[0].permute(1, 2, 0).contiguous()
