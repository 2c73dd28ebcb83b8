"""Observability, as ``pbrpathtracer_tpu.utils.observability``: structured
log lines, wavefront diagnostics, a profiler hook, and the program's own
spans and counters.

The reference's only instrumentation is the status bar (samples, average
time per sample, elapsed, triangle count: ``RenderSession.metrics``) and
transient status-text events with a 5 s lifetime. This module keeps those
and adds what a deployment on an accelerator needs: live lanes per bounce
segment, rays per sample, a ``torch.profiler`` trace, rank-0-only logging
for runs over several processes, and a trace of the program's phases.

**Tracing.** It is on while ``torch.profiler`` (or the autograd profiler)
records, and inside ``tracing()``; otherwise a span costs one flag test and
a shared no-op context. The counts move either way.

* ``span(name)``: a flat host phase (a graph replay, a copy into a graph's
  inputs, a blocking read, the update). Under the profiler it is a
  ``record_function`` range, so the profiler's trace names the host's phase
  over each idle gap of the card; while tracing, its wall time adds to the
  record's ``host_ms[name]``. No span encloses a whole pass or fit step.
* ``device_span(name, cuda)``: a host span and two timestamps on the
  current stream around a layer's device work (``pbr.hit``, ``pbr.pack``,
  ``pbr.fetch``, ``pbr.shade``, ``pbr.backward``): one-thread kernels that
  write the card's nanosecond timer into a device buffer
  (``csrc/stamp.cu``). Under stream capture they are captured into the
  graph whether or not tracing is on (``graph_spans`` collects them, with
  ``pbr.graph`` around the whole graph), and the graph's executable keeps
  those kernel nodes disabled, empty, while tracing is off (``replaying``
  switches them before a replay); eagerly on the card they run only while
  tracing. A replay queues its graph's spans, and ``settle()``, at the
  call's own sync point, reads the stamps and turns them into
  milliseconds, **exclusive** by name: a span's time leaves out the spans
  nested in it, and ``pbr.graph``'s is what the graph ran outside every
  named span. A span's time is the card's wall time over it, the launch
  gaps between its kernels included. Inside a backward no device span
  opens (autograd's device thread included): the recompute and K3 count as
  ``pbr.backward``. Where a graph replays more than once between two sync
  points (``render`` at ``spp`` > 1, ``step(n)``), its stamps hold the
  last replay's times, and each of those replays is given them.
* Counts: one table of named counts, always on. ``count(name, n)`` is
  the one way to note a count, and ``counted(fn)`` reads what a call
  noted. The kernel wrappers and their plain versions count their launches
  under their own names (``intersect_dense``, ``intersect_dense_plain``,
  ``intersect_list``, ``gather_rows_t``, ``gather_rows_t_bwd``,
  ``shade_s1`` and so on),
  ``ops.hit.autodiff_intersector`` its queries (``autodiff_queries``) and
  ``ops/shadepack`` its pack builds (``pack_builds``: one per pack a
  sample, or per use where a caller hands none), ``ops/shade`` the
  segments that its fused kernels shade (``fused_shades``). The program counts
  ``graph_launches`` (replays of captured graphs), ``host_reads`` (its
  blocking reads: ``pbr.read.flag``, ``pbr.read.tail``, ``pbr.read.loss``,
  ``pbr.sync.pass``), ``captures`` and ``regrowths`` (of the compiled
  caches) and, of the segments that ``run_segments`` runs while reading
  each flag (passes, eager samples; not the captured fwd+bwd's),
  ``segments``, ``live_lanes`` (the lanes alive on entering each, from the
  count that the flag read already brings) and ``segment_lanes`` (the
  lanes those segments ran over, so ``live_lanes / segment_lanes`` is the
  occupancy). A count noted while a graph is being captured goes to that
  graph and not to the table; ``replaying`` adds the graph's counts, with
  one ``graph_launches``, at each of its replays, which run the counted
  work. A record's ``counts`` are the table's moves, over ``COUNTERS``,
  from the record's start to its last ``call_done`` (or the end of
  tracing), and ``calls`` the session passes and fit steps finished in it.
  ``dead_segments`` (segments a captured fwd+bwd ran over lanes that were
  all dead) alone is read while tracing, by ``settle()``, from the flags
  the graph keeps.
  The record's ``tail_ms`` sums, over the replays of segment graphs entered
  with under ``TAIL_SHARE`` of their lanes alive, each graph's device time
  from its first stamp to its last (``pbr.graph``'s, nested spans
  included).

A record starts at the first span or count after tracing turns on and
gathers until it turns off; ``last_record()`` returns the newest.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import logging
import os
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _profiler

logger = logging.getLogger("pbrpathtracer_tpu_torch")


def is_host0() -> bool:
    """True on rank 0 of an initialised ``torch.distributed`` group, and in
    a single process."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def log_event(event: str, **fields):
    """Rank-0 structured log line (JSON): the status-text analogue."""
    if is_host0():
        logger.info(json.dumps({"event": event, "time": time.time(),
                                **fields}))


class StatusText:
    """Transient status messages with a lifetime, as the reference's."""

    def __init__(self, ttl_s: float = 5.0):
        self.ttl = ttl_s
        self._text = ""
        self._since = 0.0

    def set(self, text: str):
        self._text = text
        self._since = time.monotonic()
        log_event("status", text=text)

    def get(self) -> str:
        if time.monotonic() - self._since > self.ttl:
            return ""
        return self._text


@torch.inference_mode()
def wavefront_occupancy(scene, camera, cfg, sample_idx=0):
    """Live-lane count per bounce segment: the divergence diagnostic behind
    compaction and kernel tuning. Runs one sample on the scene's device
    through the render's own plan (``ops.integrator.SamplePlan``), every
    segment of ``cfg.resolved_max_segments()``, each segment's count being
    the flag that the plan gives it. Returns i64[num_segments] numpy."""
    from ..ops.integrator import SamplePlan
    plan = SamplePlan(scene, camera, cfg.replace(skip_dead_segments=True),
                      sample_idx)
    state, slot, flag = plan.prologue()
    counts = [flag]
    for seg in range(plan.n_segments - 1):
        state, slot, flag = plan.segment(seg, state, slot)
        counts.append(flag)
    return torch.stack(counts).cpu().numpy()


def rays_per_sample(occupancy: np.ndarray) -> int:
    """Issued closest-hit queries per sample: bounce + shadow per live
    lane."""
    return int(occupancy.sum()) * 2


@contextlib.contextmanager
def profile_trace(log_dir: str = "ptx_profile"):
    """Capture a ``torch.profiler`` trace (host, and the card where there is
    one) around a block; on exit a Chrome trace ``trace.json`` is written
    into ``log_dir`` (open it in chrome://tracing or Perfetto), with the
    program's ``pbr.*`` spans on the host's rows. Yields the profiler, whose
    ``key_averages()`` hold the times; the block is traced, so
    ``last_record()`` holds its spans and counters afterwards."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _refresh()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def auto_resolution(base_width: int, base_height: int, aspect: float):
    """Auto-res: keep the pixel budget of (base_width x base_height), match
    the viewport's aspect ratio."""
    budget = base_width * base_height
    w = int(round((budget * aspect) ** 0.5))
    h = max(1, int(round(w / aspect)))
    return max(1, w), h


# ---- tracing: the program's spans and counters (module docstring) ---------

# the counts that a record holds (module docstring)
COUNTERS = ("graph_launches", "host_reads", "dead_segments", "captures",
            "regrowths", "segments", "live_lanes", "segment_lanes",
            "pack_builds", "fused_shades")
TAIL_SHARE = 0.1   # a segment entered with fewer live lanes is in the tail

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()   # per thread: the open device-span group
_table = {}                  # every count so far, by name
_capturing = None            # the group of the graph being captured
_forced = 0                  # open ``tracing()`` contexts
_record = None               # the newest record
_active = False              # whether spans still add to ``_record``
_pending = []                # (group, its replay count) awaiting settle()


def on() -> bool:
    """Whether tracing is on: the profiler records, or ``tracing()`` is
    open."""
    return _profiler._is_profiler_enabled or _forced > 0


class _Record:
    def __init__(self):
        self.calls = 0
        self.table_from = self.table_to = dict(_table)
        self.dead_segments = 0
        self.device_ms = collections.defaultdict(float)
        self.host_ms = collections.defaultdict(float)
        self.graph_gap_ms = 0.0
        self.tail_ms = 0.0

    def as_dict(self) -> dict:
        counts = {k: self.table_to.get(k, 0) - self.table_from.get(k, 0)
                  for k in COUNTERS}
        counts["dead_segments"] = self.dead_segments
        return {"calls": self.calls, "counts": counts,
                "device_ms": dict(self.device_ms),
                "host_ms": dict(self.host_ms),
                "graph_gap_ms": self.graph_gap_ms,
                "tail_ms": self.tail_ms}


def _begin() -> _Record:
    """The record that spans and counts add to, a new one at the first
    span or count after tracing turned on. Call under ``_lock``."""
    global _record, _active
    if not _active:
        _record, _active = _Record(), True
        _pending.clear()
    return _record


def _refresh():
    """Bring the record's counts up to now, while tracing is on."""
    if on():
        with _lock:
            _begin().table_to = dict(_table)


def _close_if_off():
    global _active
    if not on():
        _active = False


class _HostSpan:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter_ns() - self._t0) / 1e6
        if self._range is not None:
            self._range.__exit__(*exc)
        with _lock:
            _begin().host_ms[self.name] += ms
        return False


def span(name: str):
    """A host span (module docstring)."""
    if not (_profiler._is_profiler_enabled or _forced):
        return _NULL
    return _HostSpan(name)


def count(name: str, n: int = 1):
    """Note ``n`` more of ``name`` in the table (module docstring). While
    a graph is being captured the graph keeps it instead, and ``replaying``
    adds it at each of the graph's replays, which run the counted work."""
    group = _capturing
    if group is not None:
        group.counts[name] += n
    else:
        _add((name, n))


def _add(*counts):
    """Add ``counts`` ((name, n) pairs) to the table, beginning a record
    where tracing is on and none is open."""
    with _lock:
        if not _active and (_profiler._is_profiler_enabled or _forced):
            _begin()
        for name, n in counts:
            _table[name] = _table.get(name, 0) + n


def counted(fn):
    """(``fn()``, {name: what the call added to the table}), with only the
    names that moved."""
    with _lock:
        before = dict(_table)
    out = fn()
    with _lock:
        after = dict(_table)
    return out, {k: n - before.get(k, 0) for k, n in after.items()
                 if n != before.get(k, 0)}


def host_read(name: str):
    """One of the program's blocking reads of the card: counted in
    ``host_reads``, and a host span around it."""
    count("host_reads")
    return span(name)


STAMP_SLOTS = 64   # timestamps per device buffer of a group


class _Group:
    """Device spans recorded together: a captured graph's (its root
    ``pbr.graph``), or an eager outermost span's. ``spans`` holds [name,
    index of the enclosing span or -1, start slot, end slot]; each slot is
    a timestamp (``stamp``) in the group's device buffers. A graph's group
    also keeps its stamps' kernel nodes and its executable, which has them
    enabled only while tracing (``replaying``)."""

    def __init__(self, graph: bool):
        self.graph = graph
        self.spans = []
        self.counts = collections.Counter()   # a graph's, noted at capture
        self.flags = []        # the flags entering each captured segment
        self.entered = None    # those flags stacked, a graph output
        self.replays = 0
        self.buffers = []      # int64 device tensors of STAMP_SLOTS
        self.slots = 0
        self.nodes = []        # a graph's stamp kernel nodes
        self.exec = None       # a graph's executable
        self.armed = True      # whether its stamp nodes are enabled

    def stamp(self) -> int:
        """Write the card's nanosecond timer into the next slot, on the
        current stream; the slot's index."""
        i = self.slots
        if i == STAMP_SLOTS * len(self.buffers):
            self.buffers.append(torch.empty(STAMP_SLOTS, dtype=torch.int64,
                                            device="cuda"))
        slot = self.buffers[-1][i % STAMP_SLOTS:]
        node = ctypes.c_void_p()
        lib = _native()
        lib.check(lib.load().pbr_stamp(
            slot.data_ptr(), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(node)), "pbr_stamp")
        if node.value is not None:
            self.nodes.append(node.value)
        self.slots += 1
        return i

    def read(self):
        """The timestamps, ns, on the host."""
        return torch.cat(self.buffers).cpu().numpy()[:self.slots]


def _native():
    from ..kernels import native
    return native


def _arm(group, enable: bool):
    """Enable or disable a graph's stamp nodes for the replays that
    follow."""
    if group.exec is not None and group.nodes:
        lib = _native()
        nodes = (ctypes.c_void_p * len(group.nodes))(*group.nodes)
        lib.check(lib.load().pbr_nodes_enable(
            group.exec, nodes, len(group.nodes), int(enable)),
            "pbr_nodes_enable")
    group.armed = enable


def _thread():
    st = _local
    if not hasattr(st, "group"):
        st.group, st.stack = None, []
    return st


class _DeviceSpan:
    __slots__ = ("name", "tracing", "cuda", "_host", "_group", "_idx",
                 "_opened")

    def __init__(self, name, tracing, cuda):
        self.name, self.tracing, self.cuda = name, tracing, cuda

    def __enter__(self):
        self._host = self._group = None
        if torch._C._current_graph_task_id() != -1:
            return self   # inside a backward: its time is pbr.backward's
        if self.tracing:
            self._host = _HostSpan(self.name).__enter__()
        if not self.cuda:
            return self
        st = _thread()
        self._opened = st.group is None
        if self._opened:
            if torch.cuda.is_current_stream_capturing():
                return self   # a capture that collects no spans
            st.group, st.stack = _Group(graph=False), []
        self._group = st.group
        self._idx = len(self._group.spans)
        self._group.spans.append([self.name, st.stack[-1] if st.stack else -1,
                                  self._group.stamp(), None])
        st.stack.append(self._idx)
        return self

    def __exit__(self, *exc):
        if self._group is not None:
            st = _thread()
            self._group.spans[self._idx][3] = self._group.stamp()
            st.stack.pop()
            if self._opened:
                st.group = None
                with _lock:
                    _begin()
                    _pending.append((self._group, 0, False))
        if self._host is not None:
            self._host.__exit__(*exc)
        return False


def device_span(name: str, cuda: bool):
    """A device span (module docstring) around work on the card where
    ``cuda``, a host span only elsewhere."""
    if _profiler._is_profiler_enabled or _forced:
        return _DeviceSpan(name, True, cuda)
    if cuda and torch.cuda.is_current_stream_capturing():
        return _DeviceSpan(name, False, cuda)
    return _NULL


def graph_group() -> _Group:
    """A captured graph's group, made before ``capture_begin``, with its
    first stamp buffer allocated there, outside the graph's memory pool.
    Where several graphs share a pool (a sample's), a buffer allocated
    while one is captured may lie in memory that an earlier graph uses for
    its temporaries, and that graph's next replay would overwrite the
    stamps before they are read. A sample's graph takes fewer than
    ``STAMP_SLOTS`` stamps; a fwd+bwd's more, in a pool of its own."""
    group = _Group(graph=True)
    group.buffers.append(torch.empty(STAMP_SLOTS, dtype=torch.int64,
                                     device="cuda"))
    return group


@contextlib.contextmanager
def graph_spans(group: _Group):
    """Open right after ``capture_begin``, with the ``graph_group()`` made
    before it: collects the device spans of the graph being captured, under
    ``pbr.graph`` (its first and last node), and the flags that
    ``segment_entered`` notes, stacked into one graph output before the
    last node; every count noted meanwhile, on any thread (autograd's device
    thread runs a captured backward), goes to the group. Yields ``group``,
    which ``instantiated`` and ``replaying`` take."""
    global _capturing
    st = _thread()
    outer = st.group, st.stack
    group.spans.append(["pbr.graph", -1, group.stamp(), None])
    st.group, st.stack = group, [0]
    _capturing = group
    try:
        yield group
        if group.flags:
            group.entered = torch.stack(group.flags)
        group.spans[0][3] = group.stamp()
    finally:
        _capturing = None
        group.flags = []
        st.group, st.stack = outer


def instantiated(group, graph_exec: int):
    """A captured graph's executable: its stamp nodes enabled while tracing
    is on, else disabled."""
    group.exec = graph_exec
    _arm(group, on())


def segment_entered(flag):
    """Note, inside a graph being captured, the flag (the live-lane count)
    that a segment run at a fixed count enters with: 0 means its lanes were
    all dead."""
    group = getattr(_local, "group", None)
    if flag is not None and group is not None and group.graph:
        group.flags.append(flag)


def segment_run(live, lanes: int):
    """Around one segment that ``run_segments`` runs, entered with ``live``
    of its ``lanes`` alive (None where no flag was read): the segment and
    its lanes are counted, and while tracing a graph replayed inside is a
    tail segment's where ``live`` is under ``TAIL_SHARE`` of ``lanes``. Off,
    the shared no-op context."""
    if live is None:
        _add(("segments", 1))
    else:
        _add(("segments", 1), ("live_lanes", live), ("segment_lanes", lanes))
    if not (_profiler._is_profiler_enabled or _forced):
        return _NULL
    return _in_segment(live is not None and live < TAIL_SHARE * lanes)


@contextlib.contextmanager
def _in_segment(tail: bool):
    _local.tail = tail
    try:
        yield
    finally:
        _local.tail = False


def replaying(group):
    """Before a captured graph's replay: one ``graph_launches`` and the
    counts the graph kept at its capture added to the table, the only place
    they are; its stamps enabled while tracing, and disabled otherwise;
    while tracing its spans are queued for ``settle()``, marked where it
    runs a tail segment (``segment_run``)."""
    tracing_on = _profiler._is_profiler_enabled or _forced > 0
    if group.armed != tracing_on:
        _arm(group, tracing_on)
    _add(("graph_launches", 1), *group.counts.items())
    if not tracing_on:
        return
    tail = getattr(_local, "tail", False)
    with _lock:
        group.replays += 1
        _pending.append((group, group.replays, tail))


def settle():
    """Read the queued spans' timestamps into the record: exclusive device
    ms by name, the device gaps between consecutive graphs, the tail
    segments' graph time, and the dead segments that the graphs' flags
    show. Call at a point where the host has waited for the card anyway;
    the reading is itself a host span, ``pbr.settle``, the tracing's own
    cost."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
        rec = _record
    if not pending or rec is None:
        return
    with span("pbr.settle"):
        _settle(rec, pending)


def _settle(rec, pending):
    device_ms = collections.defaultdict(float)
    gap_ms, tail_ms, dead, last_end = 0.0, 0.0, 0, None
    stamps = {}
    for group, replays, tail in pending:
        t = stamps.get(id(group))
        if t is None:
            t = stamps[id(group)] = group.read()
        ms = [(t[b] - t[a]) / 1e6 for _, _, a, b in group.spans]
        own = list(ms)
        for (_, parent, _, _), x in zip(group.spans, ms):
            if parent >= 0:
                own[parent] -= x
        for (name, _, _, _), x in zip(group.spans, own):
            device_ms[name] += x
        if not group.graph:
            continue
        if tail:
            tail_ms += ms[0]
        # a graph replayed again since holds that replay's stamps
        fresh = replays == group.replays
        root = group.spans[0]
        if fresh and last_end is not None:
            gap_ms += (t[root[2]] - last_end) / 1e6
        last_end = t[root[3]] if fresh else None
        if group.entered is not None:
            dead += int((group.entered.cpu() == 0).sum())
    with _lock:
        for name, x in device_ms.items():
            rec.device_ms[name] += float(x)
        rec.graph_gap_ms += float(gap_ms)
        rec.tail_ms += float(tail_ms)
        rec.dead_segments += dead


def call_done(n: int = 1):
    """``n`` of the program's calls (session passes, fit steps) are done,
    their results on the host: while tracing, the queued spans are settled
    and the calls counted."""
    if not on():
        _close_if_off()
        return
    settle()
    with _lock:
        rec = _begin()
        rec.calls += n
        rec.table_to = dict(_table)


@contextlib.contextmanager
def tracing():
    """Trace the block without the profiler: spans time themselves and the
    record gathers the counts; ``last_record()`` reads them afterwards."""
    global _forced, _active
    with _lock:
        if not on():
            _active = False   # a new record
        _forced += 1
    try:
        yield
    finally:
        _refresh()
        with _lock:
            _forced -= 1


def last_record() -> dict | None:
    """The newest record, or None: ``calls`` (finished passes and fit
    steps), ``counts`` (``COUNTERS``), ``device_ms`` (exclusive device
    milliseconds by span name), ``host_ms`` (host milliseconds by span
    name), ``graph_gap_ms`` (device idle time between consecutive graphs
    of a call, summed) and ``tail_ms`` (the tail segments' graphs' device
    time, summed). Spans still queued are settled first."""
    if _record is None:
        return None
    if _pending:
        settle()
    _refresh()
    _close_if_off()
    return _record.as_dict()
