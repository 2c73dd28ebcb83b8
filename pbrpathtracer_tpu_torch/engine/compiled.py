"""Captured samples and captured gradients: the port's counterpart of the
JAX package's compiled entries. The forward ones (``ops/integrator
._accum_chunk`` under ``render``, ``api._jit_render``,
``engine/session``'s ``one_pass``, the bench's forward steps) replay a
captured sample (``SAMPLES``); the gradient ones (``api._jit_grad`` behind
``grad_render``, the fit ``step``, the bench's ``fb_jit``) replay a
captured fwd+bwd (``GRADS``). The sharded ones (``parallel/render.py``'s
``shard_map`` under ``render_sharded`` and the two train steps, and
``dist/multihost.py``'s, which call them) replay captured samples over a
pixel shard and two more captured fwd+bwd programs, the fused step's
(``FUSED``) and the overlapped step's per-sample VJP (``VJPS``); their
collectives run eagerly between the replays.

Where the JAX package compiles a sample with ``jax.jit``, the port captures
it into CUDA graphs and replays them. A sample is split as
``ops.integrator.SamplePlan`` splits it: one graph holds the prologue (the
camera rays and the initial wavefront), one graph each bounce segment
(compaction, the hit queries, shading, and ``alive.sum()`` of the new
state: the flag, a count of live lanes), and all of them share one memory
pool. The prologue graph also builds the scene's shading packs, which the
segment graphs read; the entry holds them, as it holds the graphs'
outputs, so that no later allocation in the pool takes their memory.
``ops.integrator.run_segments`` replays them in the eager loop's order:
between two segments the host reads the flag back where the eager loop
reads it, so the same segments run and ``skip_dead_segments`` keeps its
meaning. The epilogue (the
scatters that undo compaction and the block pixel order) runs eagerly.
The graphs hold the eager render's kernels and operators in its order, so
a replay equals the eager render bit for bit.

A captured fwd+bwd (``CompiledGrad``) is one graph of a program of
``diff.loss``: ``set_params`` of the entry's own leaves, the samples, the
loss and ``torch.autograd.grad``. ``GRADS`` captures ``fwd_bwd`` (the
``cfg.spp`` samples and the L2 loss), ``FUSED`` ``fused_fwd_bwd`` (the
same over a pixel shard, the squared error over the global element count)
and ``VJPS`` ``sample_vjp`` (one sample, its index a graph input, and
its VJP with a cotangent that is a graph input), with the autograd
graph's backward (K3 and every index backward in it, and the recompute of
``remat_segments``) recorded at capture. A backward cannot be cut at the
segments, so nothing is read back inside it: each sample runs as many
segments as the eager warm-up ran (``ops.integrator.run_segments``), which
is safe because a segment over lanes that are all dead is the identity,
bit for bit in value and in gradient. After a replay the host reads one
flag, whether a lane was still alive after any sample's last captured
segment; if one was, the key captures again, each sample's count the
larger of the new warm-up's and the old one, and that call returns the
warm-up's eager result. So no caller sees a result cut short: the fit
updates only after this read. The JAX package tests the same flag on the
device (``lax.cond`` in its scan).

Seed and sample index are 0-d device tensors of the graphs, written before
each replay: a new seed or sample index replays the same graphs. So is a
pixel shard: a sample over the lanes ``pixel_idx`` copies them into its own
tensor before each replay (``render_sharded`` builds a fresh shard at every
call). A captured fwd+bwd also copies the caller's parameters and its
program's inputs (target, shard, cotangent, sample index) into its own
tensors before each replay. A caller that knows how many segments the
samples need (the overlapped step, from its forward pass over the same
samples) passes them as ``need``: a capture with fewer captures again
before it would replay, so no replay is cut short and no flag need be read
before the result is used.

* **Key.** A sample's: the ``RenderConfig`` (its ``seed`` and ``spp``
  aside: neither changes a sample's graphs), the lane count (the image's,
  or a shard's length, dtype and device: never its pointer or values), the
  device, and the identity of every scene and camera leaf (pointer, shape,
  dtype, stride). A fwd+bwd's: the program's name, the ``RenderConfig``
  but its ``seed``, the parameters' names, shapes and dtypes, each input's
  name, shape and dtype, the device, whether deterministic algorithms are
  on (an index backward is recorded as the mode has it), and the
  identity of every scene and camera leaf that is not a parameter.
  Change a scene with
  ``dataclasses.replace``, never in place (the kernels' per-geometry
  preparations say the same).
* **When a key captures.** Its first call runs eagerly on the current
  stream, as ``render_sample`` or ``GradCache.eager`` does, and only
  notes the key: a one-shot render or gradient, or the first pass after an
  edit, costs what the eager one costs. The second call runs eagerly on a
  side stream (where every per-geometry preparation has already happened
  outside capture: K1's rows, K4's collapsed tree with its host read-back,
  K2's one-time function attributes, autograd's device threads), and that
  eager result is the call's result; then the graphs are captured, on the
  same stream, in ``thread_local`` mode, so that another thread may read
  the card meanwhile (``RenderSession``'s ``image()`` while ``run_async``
  captures; autograd's device thread runs the backward into the capture).
  Every later call replays.
* **Lifetime.** No entry holds its scene. Each key watches every node of
  its scene (the dataclasses, on which the kernels cache their
  preparations, and their tensors) and every tensor of its camera, a
  fwd+bwd's key those of them that are not parameters: when one of them
  is collected, the key and its graphs go, so a scene that its caller
  drops is freed, and a pointer of the key cannot come back as another
  scene's. What an entry made outside its capture and its graphs read (a
  camera moved to the card, its own leaves, inputs and seed) it holds. At
  most ``CACHE_SIZE`` keys are kept per cache; the least recently used one
  goes first; each of ``GRADS``, ``FUSED`` and ``VJPS`` keeps its own. A
  key's graphs keep their memory in a pool of their own, which the caching
  allocator hands back only when its cache is emptied, and never while a
  capture is under way: so a dropped key empties the cache, or a session
  that restarts on edited scenes would fill the card with dead pools and
  run out of memory in a capture.
* **Counting.** What the program counts goes into ``observability``'s one
  table. A count noted while a graph is being captured (a kernel launch, a
  pack build, a plain-torch query), where nothing runs, goes to that graph
  instead, and ``observability.replaying`` adds the graph's counts, with
  one graph launch, at each of its replays. A capture and a regrowth are
  counted too (``captures``, ``regrowths``).
* **Tracing.** Each graph carries the timestamps of its device spans
  (``utils/observability.py``: ``pbr.graph`` around it, the layers' spans
  inside), one-thread kernel nodes that its executable keeps disabled
  while tracing is off; the graph is kept (``keep_graph``) for that
  switch. While tracing, a replay is counted and its spans are read at the
  caller's sync point.
* **No fallback.** A capture or replay that fails raises; nothing carries
  on eagerly. While ``native.launch_records`` is open the compiled entries
  raise: a replay records no launch shapes (count ``render_sample`` or
  the eager programs). No cache takes a CPU scene.

Nothing here runs on the CPU: ``ops.integrator`` and ``parallel.render``
call in only for CUDA scenes that record no autograd graph,
``diff.loss.loss_and_grad`` and the train steps only for CUDA scenes; the
CPU runs every entry eagerly.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
import weakref

import torch

from ..diff.loss import fused_fwd_bwd, fwd_bwd, sample_vjp
from ..diff.params import set_params
from ..kernels import native
from ..ops.integrator import (SamplePlan, _records_graph, run_segments,
                              unscatter)
from ..utils import observability

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


def sample_key(scene, camera, cfg, pixel_idx=None) -> tuple:
    """What a captured sample depends on (module docstring, "Key")."""
    lanes = (cfg.width * cfg.height if pixel_idx is None else
             ("shard", pixel_idx.shape[0], pixel_idx.dtype, pixel_idx.device))
    return (cfg.replace(seed=0, spp=1), lanes, scene.device,
            tuple(_identity(x) for x in _leaves(scene)),
            tuple(_identity(x) for x in _leaves(camera)))


def _marked(params, scene, camera):
    """(scene, camera) with the string "param" in place of each parameter
    of ``params``: the leaves that remain are what a fwd+bwd reads as it
    finds them."""
    return set_params(scene, camera, dict.fromkeys(params, "param"))


def _spec(x):
    """An input's part of a key: a tensor's shape and dtype; an int is
    written into a 0-d tensor and has none."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    return "int"


def program_key(program, params, scene, camera, cfg, inputs) -> tuple:
    """What a captured fwd+bwd of ``program`` (a name of ``PROGRAMS``)
    depends on, ``inputs`` being its inputs by name (module docstring,
    "Key")."""
    s, c = _marked(params, scene, camera)
    return (program, cfg.replace(seed=0), scene.device,
            torch.are_deterministic_algorithms_enabled(),
            tuple((k, tuple(v.shape), v.dtype) for k, v in params.items()),
            tuple((k, _spec(v)) for k, v in sorted(inputs.items())),
            tuple(_identity(x) for x in _leaves(s)),
            tuple(_identity(x) for x in _leaves(c)))


def grad_key(params, scene, camera, cfg, target) -> tuple:
    """The key of ``grad_render``'s captured fwd+bwd."""
    return program_key("loss", params, scene, camera, cfg, {"target": target})


def _loss_program(leaves, scene, camera, cfg, seed, counts, target):
    return fwd_bwd(leaves, scene, camera, cfg, target, seed, counts)


def _fused_program(leaves, scene, camera, cfg, seed, counts, target,
                   pixel_idx):
    return fused_fwd_bwd(leaves, scene, camera, cfg, target, pixel_idx, seed,
                         counts)


def _vjp_program(leaves, scene, camera, cfg, seed, counts, cot, sample_idx,
                 pixel_idx):
    return sample_vjp(leaves, scene, camera, cfg, cot, sample_idx, pixel_idx,
                      seed, counts)


# The programs a ``GradCache`` captures, by name: each is called as
# ``program(leaves, scene, camera, cfg, seed, counts, **inputs)`` and
# returns (value or None, grads, segments run per sample, tail flags).
PROGRAMS = {"loss": _loss_program, "fused": _fused_program,
            "vjp": _vjp_program}


def _set(static, value):
    """Write an int or an integer tensor into a 0-d graph input."""
    if isinstance(value, torch.Tensor):
        static.copy_(value)
    else:
        static.fill_(int(value))


def _capture(stream, pool, body):
    """(graph, ``body()``, its group): ``body`` captured on ``stream`` into
    ``pool``, with the timestamps of its device spans and the counts noted
    in it (``observability.graph_spans``); its executable runs the stamps
    only while tracing."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(stream):
        group = observability.graph_group()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            with observability.graph_spans(group) as spans:
                out = body()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass   # the capture was invalidated by the error
            raise
        graph.capture_end()
    graph.instantiate()
    observability.instantiated(spans, graph.raw_cuda_graph_exec())
    return graph, out, spans


def _follow(entry):
    """Before a replay: the current stream waits for the stream that last
    used ``entry``'s tensors."""
    cur = torch.cuda.current_stream(entry.device)
    if cur != entry._last_stream:
        cur.wait_stream(entry._last_stream)
        entry._last_stream = cur


class CompiledSample:
    """The graphs of one key: ``prologue``, ``segment`` and ``epilogue``
    as ``SamplePlan`` has them, each graph call a replay, for
    ``run_segments``. With ``pixel_idx`` the lanes are a shard of that
    length, copied into the entry's own tensor before each run."""

    def __init__(self, scene, camera, cfg, pixel_idx=None):
        dev = scene.device
        self.device = dev
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.sample_idx = torch.zeros((), dtype=torch.int64, device=dev)
        self.shard = None if pixel_idx is None else torch.empty(
            pixel_idx.shape, dtype=pixel_idx.dtype, device=dev)
        # reads the tensors above wherever the eager plan reads its ints and
        # lanes; dropped after the capture, with its scene
        self.plan = SamplePlan(scene, camera, cfg, self.sample_idx, self.seed,
                               self.shard)
        self.n_segments = self.plan.n_segments
        # what the graphs and the epilogue read of the plan, kept
        self.camera, self.pixel_idx = self.plan.camera, self.plan.pixel_idx
        self.compacts, self.order = (self.plan.compact is not None,
                                     self.plan.order)
        self.stream = torch.cuda.Stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = []     # prologue, then one per segment
        self.outputs = []    # per graph: its (state, slot, flag)
        self.packs = None    # the prologue graph's packs, read by the rest
        self.spans = []      # per graph: its group (spans and counts)
        self.capture_s = None
        self._last_stream = None

    def _load(self, seed, sample_idx, pixel_idx):
        with observability.span("pbr.load"):
            _set(self.seed, seed)
            _set(self.sample_idx, sample_idx)
            if self.shard is not None:
                self.shard.copy_(pixel_idx)

    def first(self, seed, sample_idx, pixel_idx=None):
        """The eager warm-up on the side stream, then the capture. Returns
        the warm-up's (radiance, segments run), the radiance for the
        current stream."""
        cur = torch.cuda.current_stream(self.device)
        self._load(seed, sample_idx, pixel_idx)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            radiance, run, _ = run_segments(self.plan)
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
        self.packs = self.plan.packs
        self.plan = None
        return radiance, run

    def _capture(self, body):
        graph, out, spans = _capture(self.stream, self.pool, body)
        self.graphs.append(graph)
        self.outputs.append(out)
        self.spans.append(spans)

    def _replay(self, i):
        observability.replaying(self.spans[i])
        with observability.span("pbr.replay.segment" if i else
                                "pbr.replay.prologue"):
            self.graphs[i].replay()
        return self.outputs[i]

    def replay(self, seed, sample_idx, pixel_idx=None):
        """The sample at (seed, sample_idx) over ``pixel_idx`` by the
        captured graphs; (radiance, segments run), the radiance for the
        current stream. It may be the pool's own buffer (no epilogue): the
        caller consumes it before the next replay."""
        _follow(self)
        self._load(seed, sample_idx, pixel_idx)
        return run_segments(self)[:2]

    # ``run_segments``' interface
    def prologue(self):
        return self._replay(0)

    def segment(self, seg, state, slot):
        return self._replay(seg + 1)

    def epilogue(self, state, slot):
        return unscatter(state.radiance, slot if self.compacts else None,
                         self.order)


class CompiledGrad:
    """The captured fwd+bwd of one key (module docstring): one graph of
    ``program`` over the entry's own parameter leaves, inputs and seed
    word, each sample running ``counts[k]`` segments."""

    def __init__(self, program, params, inputs, device):
        self.program = program
        self.device = device
        with torch.inference_mode(False):
            self.leaves = {k: torch.empty(v.shape, dtype=v.dtype,
                                          device=device).requires_grad_(True)
                           for k, v in params.items()}
            self.inputs = {
                k: torch.empty(v.shape, dtype=v.dtype, device=device)
                if isinstance(v, torch.Tensor) else
                torch.zeros((), dtype=torch.int64, device=device)
                for k, v in inputs.items()}
            self.seed = torch.zeros((), dtype=torch.int64, device=device)
        self.stream = torch.cuda.Stream(device)
        self.counts = None   # segments per sample, as captured
        self.graph = None
        self.outputs = None  # the graph's (value, grads, tail flag or None)
        self.spans = None    # the graph's group (spans and counts)
        self.camera_held = []   # tensors made here that the graph reads
        self.capture_s = None
        self._last_stream = None

    def _load(self, params, inputs, seed):
        with observability.span("pbr.load"), torch.no_grad():
            for k, leaf in self.leaves.items():
                leaf.copy_(params[k])
            for k, buf in self.inputs.items():
                _set(buf, inputs[k])
            _set(self.seed, seed)

    def first(self, params, scene, camera, cfg, inputs, seed, need=None):
        """The eager fwd+bwd on the side stream, then the capture, each
        sample's segment count the largest of the warm-up's, the last
        capture's and ``need``'s. Returns the warm-up's (value, grads), for
        the current stream."""
        cur = torch.cuda.current_stream(self.device)
        if self.graph is not None:   # a regrowth: the old graph goes first
            torch.cuda.synchronize(self.device)
            self.graph = self.outputs = None
        # a camera on the host is moved here, outside the capture, and
        # what the move made is held: the graph reads it
        moved = camera.to(self.device)
        own = {id(x) for x in _leaves(camera)}
        self.camera_held = [x for x in _leaves(moved)
                            if isinstance(x, torch.Tensor) and id(x) not in own]
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self._load(params, inputs, seed)
            value, grads, runs, _ = self.program(
                self.leaves, scene, moved, cfg, self.seed, None,
                **self.inputs)
        cur.wait_stream(self.stream)
        for x in (value, *grads.values()):
            if x is not None:
                x.record_stream(cur)
        self.counts = [max(c) for c in zip(
            runs, self.counts or runs, need or runs)]

        def body():
            out, out_grads, _, tails = self.program(
                self.leaves, scene, moved, cfg, self.seed, self.counts,
                **self.inputs)
            tails = [t for t in tails if t is not None]
            return out, out_grads, (torch.stack(tails).any() if tails
                                    else None)
        t0 = time.perf_counter()
        self.graph, self.outputs, self.spans = _capture(
            self.stream, torch.cuda.graph_pool_handle(), body)
        self.capture_s = time.perf_counter() - t0
        self._last_stream = cur
        return value, grads

    def replay(self, params, inputs, seed, defer=False):
        """(value, grads) by the captured graph, fresh tensors for the
        current stream; None where a sample's last captured segment left a
        lane alive (the caller captures again). With ``defer`` no flag is
        read: (value, grads, a fresh copy of the tail flag or None), for a
        caller that reads the flags of several replays at once."""
        _follow(self)
        self._load(params, inputs, seed)
        value, grads, tail = self.outputs
        observability.replaying(self.spans)
        with observability.span("pbr.replay.fwdbwd"):
            self.graph.replay()
            out = (None if value is None else value.clone(),
                   {k: g.clone() for k, g in grads.items()})
        if defer:
            return (*out, None if tail is None else tail.clone())
        if tail is not None:
            with observability.host_read("pbr.read.tail"):
                cut = bool(tail)
            if cut:
                return None
        return out


class _KeyedCache:
    """Entries by key, at most ``CACHE_SIZE`` keys, each key watching what
    its entry's graphs read (module docstring); the least recently used key
    goes first. Thread-safe: one lock covers capture, replay and the
    caller's use of the result."""

    def __init__(self):
        # key -> its entry, or None after the key's first call
        self._entries = collections.OrderedDict()
        self._watches = {}   # key -> the weakref.finalize of what it watches
        self._lock = threading.RLock()
        self.captures = 0   # captures so far
        self.capture_s = 0.0   # and their seconds

    def __len__(self) -> int:
        """The keys that hold graphs."""
        return sum(e is not None for e in self._entries.values())

    def clear(self):
        with self._lock:
            for key in list(self._entries):
                self._drop(key)

    def _refuse(self, scene, what):
        if native.launch_records is not None:
            raise RuntimeError(
                "record_launches is open: a replay records no launch "
                "shapes; count the eager program (render_sample, "
                "eager_loss_and_grad)")
        if scene.device.type != "cuda":
            raise ValueError(f"a captured {what} needs a CUDA scene, got "
                             f"{scene.device}")

    def _watch(self, key, objs):
        """A key's first call: no graphs yet, ``objs`` watched."""
        self._entries[key] = None
        watches = self._watches[key] = []
        for x in objs:
            f = weakref.finalize(x, self._forget, key)
            f.atexit = False   # nothing to free when the process ends
            watches.append(f)
        self._evict()

    def _captured(self, key, entry):
        self._entries[key] = entry
        self._entries.move_to_end(key)
        self._count_capture(entry)
        self._evict()

    def _count_capture(self, entry):
        self.captures += 1
        self.capture_s += entry.capture_s
        observability.count("captures")

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
            del entry
            torch.cuda.empty_cache()   # its pool (module docstring, "Lifetime")


class SampleCache(_KeyedCache):
    """Captured samples by key (module docstring)."""

    def entry(self, scene, camera, cfg, pixel_idx=None):
        """The captured sample of this key, or None before its second
        call."""
        return self._entries.get(sample_key(scene, camera, cfg, pixel_idx))

    def sample(self, scene, camera, cfg, sample_idx, seed=None,
               consume=torch.clone, pixel_idx=None, runs=None):
        """``consume(radiance)`` of one sample, f32[N, 3]: eager at the
        first call of a key, eager then captured at the second, replayed
        after (module docstring). ``consume`` runs under the lock, before
        any other replay: the default hands back a fresh tensor, never the
        graphs' buffer. ``seed`` (default ``cfg.seed``) and ``sample_idx``
        are ints or 0-d integer tensors. ``pixel_idx`` (default: the whole
        image) are the lanes; a list ``runs`` gets the number of segments
        the sample ran appended."""
        self._refuse(scene, "sample")
        if _records_graph(scene, camera):
            raise ValueError("a captured sample records no autograd graph: "
                             "render eagerly, or turn grad off")
        seed = cfg.seed if seed is None else seed
        key = sample_key(scene, camera, cfg, pixel_idx)
        with self._lock, torch.cuda.device(scene.device), \
                torch.inference_mode():
            if key not in self._entries:
                with observability.span("pbr.eager"):
                    radiance, run, _ = run_segments(SamplePlan(
                        scene, camera, cfg, sample_idx, seed, pixel_idx))
                self._note(key, scene, camera)
            elif self._entries[key] is None:
                entry = CompiledSample(scene, camera, cfg, pixel_idx)
                with observability.span("pbr.capture"):
                    radiance, run = entry.first(seed, sample_idx, pixel_idx)
                self._captured(key, entry)
            else:
                self._entries.move_to_end(key)
                radiance, run = self._entries[key].replay(seed, sample_idx,
                                                          pixel_idx)
            if runs is not None:
                runs.append(run)
            with observability.span("pbr.epilogue"):
                return consume(radiance)

    def accumulate(self, scene, camera, cfg, accum, sample_start,
                   num_samples: int, seed=None, pixel_idx=None):
        """``ops.integrator.render_accumulate`` by the captured samples,
        over the lanes ``pixel_idx`` (default: the whole image)."""
        for k in range(num_samples):
            accum = self.sample(scene, camera, cfg, sample_start + k, seed,
                                consume=accum.add, pixel_idx=pixel_idx)
        return accum

    def _note(self, key, scene, camera):
        self._watch(key, _watched(scene, camera))


def _inputs(target):
    """A program's inputs by name: ``target`` itself where it is a dict,
    else the loss program's ``{"target": target}``."""
    return target if isinstance(target, dict) else {"target": target}


class GradCache(_KeyedCache):
    """Captured fwd+bwd programs of one of ``PROGRAMS`` by key (module
    docstring)."""

    def __init__(self, program="loss"):
        super().__init__()
        self.name = program
        self.program = PROGRAMS[program]
        self.regrowths = 0   # captures again of a key, for more segments

    def entry(self, params, scene, camera, cfg, target):
        """The captured fwd+bwd of this key, or None before its second
        call. ``target``: the program's inputs by name, or the loss
        program's target."""
        return self._entries.get(program_key(self.name, params, scene,
                                             camera, cfg, _inputs(target)))

    def eager(self, params, scene, camera, cfg, inputs, seed=None):
        """The program run eagerly, on any device: (value, grads), with
        ``params`` taken as fresh leaves."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        return self.program(leaves, scene, camera, cfg,
                            cfg.seed if seed is None else seed, None,
                            **inputs)[:2]

    def loss_and_grad(self, params, scene, camera, cfg, target, seed=None):
        """``diff.loss.loss_and_grad`` on a CUDA scene (``GRADS``): ``run``
        of the loss program's target."""
        return self.run(params, scene, camera, cfg, {"target": target}, seed)

    def run(self, params, scene, camera, cfg, inputs, seed=None, need=None,
            defer=False):
        """(value, grads) of the program on a CUDA scene, fresh tensors:
        eager at the first call of a key, eager then captured at the
        second, replayed after, captured again after a replay whose tail
        flag is set, or before one where ``need`` (segments per sample)
        asks for more than the capture runs (module docstring). ``seed``
        (default ``cfg.seed``) is an int or a 0-d integer tensor. With
        ``defer`` a replay reads no flag and (value, grads, tail flag or
        None) comes back: the caller reads it before it uses the
        result."""
        self._refuse(scene, "fwd+bwd")
        seed = cfg.seed if seed is None else seed
        key = program_key(self.name, params, scene, camera, cfg, inputs)
        tail = None
        with self._lock, torch.cuda.device(scene.device):
            entry = self._entries.get(key)
            if key not in self._entries:
                with observability.span("pbr.eager"):
                    out = self.eager(params, scene, camera, cfg, inputs,
                                     seed)
                self._note(key, params, scene, camera)
            elif entry is None:
                entry = CompiledGrad(self.program, params, inputs,
                                     scene.device)
                with observability.span("pbr.capture"):
                    out = entry.first(params, scene, camera, cfg, inputs,
                                      seed, need)
                self._captured(key, entry)
            else:
                self._entries.move_to_end(key)
                out = None
                if need is None or all(
                        n <= c for n, c in zip(need, entry.counts)):
                    out = entry.replay(params, inputs, seed, defer)
                if out is None:
                    try:
                        with observability.span("pbr.capture"):
                            out = entry.first(params, scene, camera, cfg,
                                              inputs, seed, need)
                    except BaseException:
                        self._drop(key)   # no graph left to replay
                        raise
                    self._count_capture(entry)
                    self.regrowths += 1
                    observability.count("regrowths")
                elif defer:
                    *out, tail = out
            value, grads = out
            grads = {k: g if g.device == params[k].device
                     else g.to(params[k].device) for k, g in grads.items()}
            return (value, grads, tail) if defer else (value, grads)

    def _note(self, key, params, scene, camera):
        """Watch the nodes of the caller's scene and camera that are no
        parameter: the marked pair still holds them."""
        kept = {id(x) for x in _watched(*_marked(params, scene, camera))}
        self._watch(key, [x for x in _watched(scene, camera)
                          if id(x) in kept])


# The process's caches, used by the port's entry points.
SAMPLES = SampleCache()
GRADS = GradCache("loss")
FUSED = GradCache("fused")
VJPS = GradCache("vjp")
