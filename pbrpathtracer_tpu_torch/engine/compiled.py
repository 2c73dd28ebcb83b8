"""Captured samples: the port's counterpart of the JAX package's compiled
forward entries (``ops/integrator._accum_chunk`` under ``render``,
``api._jit_render``, ``engine/session``'s ``one_pass``, the bench's forward
steps).

Where the JAX package compiles a sample with ``jax.jit``, the port captures
it into CUDA graphs and replays them. A sample is split as
``ops.integrator.SamplePlan`` splits it: one graph holds the prologue (the
camera rays and the initial wavefront), one graph each bounce segment
(compaction, the hit queries, shading, and ``alive.any()`` of the new
state), and all of them share one memory pool. ``ops.integrator.drive``
replays them in the eager loop's order: between two segments the host
reads the flag back where the eager loop reads it, so the same segments
run and ``skip_dead_segments`` keeps its meaning. The epilogue (the
scatters that undo compaction and the block pixel order) runs eagerly.
The graphs hold the eager render's kernels and operators in its order, so
a replay equals the eager render bit for bit.

Seed and sample index are 0-d device tensors of the graphs, written before
each replay: a new seed or sample index replays the same graphs.

* **Key.** The ``RenderConfig`` (its ``seed`` and ``spp`` aside: neither
  changes a sample's graphs), the lane count, the device, and the identity
  of every scene and camera leaf (pointer, shape, dtype, stride). Change a
  scene with ``dataclasses.replace``, never in place (the kernels'
  per-geometry preparations say the same).
* **When a key captures.** Its first call renders eagerly on the current
  stream, as ``render_sample`` does, and only notes the key: a one-shot
  render, or the first pass after an edit, costs what the eager render
  costs. The second call runs the sample eagerly on a side stream (where
  every per-geometry preparation has already happened outside capture:
  K1's rows, K4's collapsed tree with its host read-back, K2's one-time
  function attributes), and that eager result is the call's result; then
  the graphs are captured, on the same stream, in ``thread_local`` mode,
  so that another thread may read the card meanwhile (``RenderSession``'s
  ``image()`` while ``run_async`` captures). Every later call replays.
* **Lifetime.** No entry holds its scene. Each key watches every node of
  its scene (the dataclasses, on which the kernels cache their
  preparations, and their tensors) and every tensor of its camera: when
  one of them is collected, the key and its graphs go, so a scene that its
  caller drops is freed, and a pointer of the key cannot come back as
  another scene's. At most ``CACHE_SIZE`` keys are kept; the least
  recently used one goes first.
* **Counting.** The kernel wrappers count at capture, where nothing
  launches: each graph keeps what they counted (``native.launches_during``),
  takes it back, and adds it at every replay.
* **No fallback.** A capture or replay that fails raises; nothing carries
  on eagerly. While ``native.launch_records`` is open the compiled entries
  raise: a replay records no launch shapes (count ``render_sample``).

Nothing here runs on the CPU: ``ops.integrator`` calls in only for CUDA
scenes that record no autograd graph.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
import weakref

import torch

from ..kernels import native
from ..ops.integrator import SamplePlan, _records_graph, drive, unscatter

CACHE_SIZE = 8


def _nodes(obj):
    """Every node of a tree of dataclasses, the dataclasses with the
    leaves, in field order."""
    yield obj
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _nodes(getattr(obj, f.name))


def _leaves(obj):
    return (x for x in _nodes(obj) if not dataclasses.is_dataclass(x))


def _watched(scene, camera) -> list:
    """What a key's graphs depend on staying alive (module docstring,
    "Lifetime"), each object once."""
    objs = [x for x in _nodes(scene)
            if dataclasses.is_dataclass(x) or isinstance(x, torch.Tensor)]
    objs += [x for x in _leaves(camera) if isinstance(x, torch.Tensor)]
    return list({id(x): x for x in objs}.values())


def _identity(x):
    if isinstance(x, torch.Tensor):
        return (x.device, x.data_ptr(), tuple(x.shape), x.dtype, x.stride())
    return x


def sample_key(scene, camera, cfg) -> tuple:
    """What a captured sample depends on (module docstring, "Key")."""
    return (cfg.replace(seed=0, spp=1), cfg.width * cfg.height, scene.device,
            tuple(_identity(x) for x in _leaves(scene)),
            tuple(_identity(x) for x in _leaves(camera)))


def _set(static, value):
    """Write an int or an integer tensor into a 0-d graph input."""
    if isinstance(value, torch.Tensor):
        static.copy_(value)
    else:
        static.fill_(int(value))


class CompiledSample:
    """The graphs of one key: ``prologue``, ``segment`` and ``epilogue``
    as ``SamplePlan`` has them, each graph call a replay, for ``drive``."""

    def __init__(self, scene, camera, cfg):
        dev = scene.device
        self.device = dev
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.sample_idx = torch.zeros((), dtype=torch.int64, device=dev)
        # reads the two tensors above wherever the eager plan reads its ints;
        # dropped after the capture, with its scene
        self.plan = SamplePlan(scene, camera, cfg, self.sample_idx, self.seed)
        self.n_segments = self.plan.n_segments
        # what the graphs and the epilogue read of the plan, kept
        self.camera, self.pixel_idx = self.plan.camera, self.plan.pixel_idx
        self.compacts, self.order = (self.plan.compact is not None,
                                     self.plan.order)
        self.stream = torch.cuda.Stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = []     # prologue, then one per segment
        self.launches = []   # per graph: {counter: launches per replay}
        self.outputs = []    # per graph: its (state, slot, flag)
        self.capture_s = None
        self._last_stream = None

    def first(self, seed, sample_idx):
        """The eager warm-up on the side stream, then the capture. Returns
        the warm-up's radiance, for the current stream."""
        cur = torch.cuda.current_stream(self.device)
        _set(self.seed, seed)
        _set(self.sample_idx, sample_idx)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            radiance = drive(self.plan)
        cur.wait_stream(self.stream)
        radiance.record_stream(cur)
        t0 = time.perf_counter()
        self._capture(self.plan.prologue)
        for seg in range(self.n_segments):
            state, slot, _ = self.outputs[-1]
            self._capture(functools.partial(self.plan.segment, seg, state,
                                            slot))
        self.capture_s = time.perf_counter() - t0
        self._last_stream = cur
        self.plan = None
        return radiance

    def _capture(self, body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                out, delta = native.launches_during(body)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass   # the capture was invalidated by the error
                raise
            graph.capture_end()
        native.add_launches(delta, -1)   # nothing launched at capture
        self.graphs.append(graph)
        self.launches.append(delta)
        self.outputs.append(out)

    def _replay(self, i):
        self.graphs[i].replay()
        native.add_launches(self.launches[i])
        return self.outputs[i]

    def replay(self, seed, sample_idx):
        """The sample at (seed, sample_idx) by the captured graphs; the
        radiance, for the current stream. It may be the pool's own buffer
        (no epilogue): the caller consumes it before the next replay."""
        cur = torch.cuda.current_stream(self.device)
        if cur != self._last_stream:
            cur.wait_stream(self._last_stream)
            self._last_stream = cur
        _set(self.seed, seed)
        _set(self.sample_idx, sample_idx)
        return drive(self)

    # ``drive``'s interface
    def prologue(self):
        return self._replay(0)

    def segment(self, seg, state, slot):
        return self._replay(seg + 1)

    def epilogue(self, state, slot):
        return unscatter(state.radiance, slot if self.compacts else None,
                         self.order)


class SampleCache:
    """Captured samples by key (module docstring), at most ``CACHE_SIZE``
    keys. Thread-safe: one lock covers capture, replay and the caller's use
    of the result."""

    def __init__(self):
        # key -> its CompiledSample, or None after the key's first call
        self._entries = collections.OrderedDict()
        self._watches = {}   # key -> the weakref.finalize of what it watches
        self._lock = threading.RLock()
        self.captures = 0   # keys captured so far

    def __len__(self) -> int:
        """The keys that hold graphs."""
        return sum(e is not None for e in self._entries.values())

    def clear(self):
        with self._lock:
            for key in list(self._entries):
                self._drop(key)

    def entry(self, scene, camera, cfg):
        """The captured sample of this key, or None before its second
        call."""
        return self._entries.get(sample_key(scene, camera, cfg))

    def sample(self, scene, camera, cfg, sample_idx, seed=None,
               consume=torch.clone):
        """``consume(radiance)`` of one sample, f32[N, 3]: eager at the
        first call of a key, eager then captured at the second, replayed
        after (module docstring). ``consume`` runs under the lock, before
        any other replay: the default hands back a fresh tensor, never the
        graphs' buffer. ``seed`` (default ``cfg.seed``) and ``sample_idx``
        are ints or 0-d integer tensors."""
        if scene.device.type != "cuda":
            raise ValueError(f"a captured sample needs a CUDA scene, got "
                             f"{scene.device}")
        if native.launch_records is not None:
            raise RuntimeError(
                "record_launches is open: a replay records no launch "
                "shapes; count the eager render (render_sample)")
        if _records_graph(scene, camera):
            raise ValueError("a captured sample records no autograd graph: "
                             "render eagerly, or turn grad off")
        seed = cfg.seed if seed is None else seed
        key = sample_key(scene, camera, cfg)
        with self._lock, torch.cuda.device(scene.device), \
                torch.inference_mode():
            if key not in self._entries:
                radiance = drive(SamplePlan(scene, camera, cfg, sample_idx,
                                            seed))
                self._note(key, scene, camera)
            elif self._entries[key] is None:
                entry = CompiledSample(scene, camera, cfg)
                radiance = entry.first(seed, sample_idx)
                self._entries[key] = entry
                self._entries.move_to_end(key)
                self.captures += 1
                self._evict()
            else:
                self._entries.move_to_end(key)
                radiance = self._entries[key].replay(seed, sample_idx)
            return consume(radiance)

    def accumulate(self, scene, camera, cfg, accum, sample_start,
                   num_samples: int, seed=None):
        """``ops.integrator.render_accumulate`` by the captured samples."""
        for k in range(num_samples):
            accum = self.sample(scene, camera, cfg, sample_start + k, seed,
                                consume=accum.add)
        return accum

    def _note(self, key, scene, camera):
        """A key's first call: no graphs yet, its scene and camera
        watched."""
        self._entries[key] = None
        watches = self._watches[key] = []
        for x in _watched(scene, camera):
            f = weakref.finalize(x, self._forget, key)
            f.atexit = False   # nothing to free when the process ends
            watches.append(f)
        self._evict()

    def _evict(self):
        while len(self._entries) > CACHE_SIZE:
            self._drop(next(iter(self._entries)))

    def _forget(self, key):
        """A watched object of ``key`` was collected."""
        with self._lock:
            self._drop(key)

    def _drop(self, key):
        for f in self._watches.pop(key, ()):
            f.detach()
        entry = self._entries.pop(key, None)
        if entry is not None:
            # no replay of it in flight when its graphs and pool go
            torch.cuda.synchronize(entry.device)


# The process's cache, used by the port's entry points.
SAMPLES = SampleCache()
