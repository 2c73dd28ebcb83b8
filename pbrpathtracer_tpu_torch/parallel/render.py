"""Sharded rendering and training steps, as
``pbrpathtracer_tpu.parallel.render``.

Every per-lane tensor of the integrator is elementwise over the pixel
dimension and every scene access is a gather from replicated tables, so each
rank renders and differentiates its own pixel shard independently, and the
only collectives are explicit: one all-gather at the end of a forward render,
one all-reduce of (loss, gradients) at the end of a training step (or one
per sample, a sample behind, in the overlapped step). None sits inside a
sample, so ranks may leave the segment loop at different segments
(``skip_dead_segments``).

The keyed RNG draws by the pixel's value, not by its lane, so a shard's
lanes compute what the same lanes of the whole wavefront compute, bit for
bit, whatever the world size.

The steps in PyTorch's idiom. JAX's ``step(params, opt_state, scene, camera,
pixel_idx, target, seed) -> (params, opt_state, loss)`` becomes
``step(params, pixel_idx, target_flat, seed) -> loss``: ``params`` (a dict
of float32 tensors that the caller owns, as ``mesh.broadcast_params``
returns them) is updated in place, and the optimizer's state lives in a
torch optimizer that the first call makes by ``optimizer(leaves)`` over the
dict's tensors in sorted-key order (``step.optimizer``); ``optimizer`` is a
factory such as ``functools.partial(torch.optim.Adam, lr=1e-2)``. The scene
and camera are those the step was made with.

Compiled entries: on a CUDA scene the JAX package's ``jax.jit`` programs
become replays of CUDA graphs (``engine/compiled.py``), with every
collective launched eagerly between them, on the current stream. A key's
first call runs eagerly, its second captures, later ones replay; the
result equals the eager program's bit for bit, with the same kernel
launches and the same collectives.

* ``render_local`` (so ``render_sharded`` and ``render_multihost``)
  replays captured samples over the pixel shard (``SAMPLES``);
* the fused step replays its fwd+bwd (``FUSED``: ``diff.loss
  .fused_fwd_bwd``), reads its one tail flag, then all-reduces, updates
  and clips eagerly;
* the overlapped step's pass 1 replays captured samples over the shard,
  and pass 2 one captured VJP per sample (``VJPS``: ``diff.loss
  .sample_vjp``, the cotangent and the sample index graph inputs), each at
  the segment count that pass 1 found the sample to need, so that no
  replay is cut short; the all-reduce of sample k-1 stays in flight while
  sample k replays. The tail flags of all its replays are read once,
  after the last, before the update: a set one is a fault and raises.

The eager programs stay callable by name on any device:
``eager_render_local``, ``eager_render_sharded`` and ``step.eager``. The
CPU runs them and nothing else; on the card nothing falls back to them.
"""

from __future__ import annotations

import torch

from ..diff.loss import fused_fwd_bwd, sample_vjp
from ..diff.params import clip_params, set_params
from ..ops.integrator import block_pixel_order, render_sample
from ..ops.compaction import scatter_to_slots
from ..scene.scene import Camera, Scene
from .mesh import (Mesh, all_gather_rows, all_reduce_flat, local_shard,
                   make_mesh, pad_to_devices)


def mesh_for(scene: Scene, mesh) -> Mesh:
    """``mesh``, or the mesh of the default group on the scene's device; the
    shard is computed where the scene lies."""
    if mesh is None:
        return make_mesh(device=scene.device)
    if mesh.device != scene.device:
        raise ValueError(f"scene on {scene.device}, mesh on {mesh.device}")
    return mesh


def padded_pixels(n_pix: int, mesh: Mesh, base=None):
    """i32[n_pad] pixel ids for the whole mesh: ``base`` (default 0..n_pix-1)
    padded to a multiple of the world size. Padding lanes re-trace pixel 0
    and are dropped when the image is assembled."""
    if base is None:
        base = torch.arange(n_pix, dtype=torch.int32, device=mesh.device)
    pad = pad_to_devices(n_pix, mesh.world_size) - n_pix
    return torch.cat([base, base.new_zeros(pad)])


def eager_render_local(scene, camera, cfg, pixel_idx, seed=None,
                       sample_start=0):
    """``render_local`` run eagerly, on any device: a loop of
    ``render_sample``."""
    with torch.inference_mode():
        acc = torch.zeros((pixel_idx.shape[0], 3), dtype=torch.float32,
                          device=pixel_idx.device)
        for k in range(cfg.spp):
            acc = acc + render_sample(scene, camera, cfg, sample_start + k,
                                      pixel_idx=pixel_idx, seed=seed)
        acc = acc / float(cfg.spp)
    # an inference tensor cannot be a collective's buffer or a loss's target
    return acc.clone()


def render_local(scene, camera, cfg, pixel_idx, seed=None, sample_start=0):
    """Mean radiance f32[n, 3] of the lanes ``pixel_idx`` over samples
    ``sample_start .. sample_start + cfg.spp``: forward only, no
    collective, a fresh tensor. On a CUDA scene by the captured samples
    over the shard, elsewhere ``eager_render_local``."""
    if scene.device.type != "cuda":
        return eager_render_local(scene, camera, cfg, pixel_idx, seed,
                                  sample_start)
    from ..engine.compiled import SAMPLES
    with torch.inference_mode():
        acc = torch.zeros((pixel_idx.shape[0], 3), dtype=torch.float32,
                          device=pixel_idx.device)
        acc = SAMPLES.accumulate(scene, camera, cfg, acc, sample_start,
                                 cfg.spp, seed, pixel_idx) / float(cfg.spp)
    return acc.clone()


def render_sharded(scene: Scene, camera: Camera, cfg, mesh=None, seed=None,
                   sample_start: int = 0):
    """Forward render with the pixel wavefront sharded over the mesh.

    Returns f32[H, W, 3] mean radiance on every rank, equal to ``render``'s
    bit for bit. ``sample_start`` offsets the absolute sample counter, so a
    high-spp render can be made in chunks and averaged: the keyed RNG makes
    chunked accumulation equal to one pass.
    """
    return _render_sharded(render_local, scene, camera, cfg, mesh, seed,
                           sample_start)


def eager_render_sharded(scene: Scene, camera: Camera, cfg, mesh=None,
                         seed=None, sample_start: int = 0):
    """``render_sharded`` by ``eager_render_local``: the same collective
    and result, the samples run eagerly."""
    return _render_sharded(eager_render_local, scene, camera, cfg, mesh, seed,
                           sample_start)


def _render_sharded(local_render, scene, camera, cfg, mesh, seed,
                    sample_start):
    mesh = mesh_for(scene, mesh)
    n_pix = cfg.width * cfg.height
    base = None
    if cfg.resolved_pixel_order() == "block":
        base = torch.from_numpy(
            block_pixel_order(cfg.width, cfg.height)).to(mesh.device)
    shard = local_shard(padded_pixels(n_pix, mesh, base), mesh)
    local = local_render(scene, camera, cfg, shard, seed, sample_start)
    img = all_gather_rows(local, mesh)[:n_pix]
    if base is not None:
        img = scatter_to_slots(img, base)
    return img.reshape(cfg.height, cfg.width, 3)


class _TrainStep:
    """What the two steps share: the leaves, the optimizer made at the first
    call, the update after the reduce, and the choice between the compiled
    step (a CUDA scene) and ``eager``."""

    def __init__(self, scene, camera, cfg, optimizer, mesh):
        mesh = mesh_for(scene, mesh)
        n_pix = cfg.width * cfg.height
        if n_pix % mesh.world_size:
            raise ValueError(f"{n_pix} pixels do not divide over "
                             f"{mesh.world_size} ranks")
        self.scene, self.camera, self.cfg, self.mesh = scene, camera, cfg, mesh
        self.n_elems = n_pix * 3
        self.make_optimizer = optimizer
        self.optimizer = None
        self._leaves = None
        self._posed = None   # (scene, camera) with the leaves in place

    def leaves(self, params: dict):
        """The dict's tensors in sorted-key order, marked as requiring grad;
        they are the optimizer's from the first call on."""
        leaves = [params[k] for k in sorted(params)]
        if self.optimizer is None:
            for p in leaves:
                p.requires_grad_(True)
            self.optimizer = self.make_optimizer(leaves)
            self._leaves = leaves
            self._posed = set_params(self.scene, self.camera,
                                     _by_key(params, leaves))
        elif len(leaves) != len(self._leaves) or any(
                a is not b for a, b in zip(leaves, self._leaves)):
            raise ValueError("the step updates in place the tensors it was "
                             "first called with; pass the same dict")
        return leaves

    def __call__(self, params, pixel_idx, target_flat, seed):
        """The step (module docstring): compiled on a CUDA scene, else
        ``eager``."""
        if self.scene.device.type != "cuda":
            return self.eager(params, pixel_idx, target_flat, seed)
        return self.compiled(params, pixel_idx, target_flat, seed)

    def sample(self, params, pixel_idx, k, seed):
        scene, camera = set_params(self.scene, self.camera, params)
        return render_sample(scene, camera, self.cfg, k, pixel_idx=pixel_idx,
                             seed=seed)

    def update(self, params, leaves, grads):
        """The optimizer's step on the reduced gradients, then the clip into
        the physical ranges, in place. Every rank applies the same reduced
        buffer, so replicated parameters stay equal."""
        for p, g in zip(leaves, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for k, v in clip_params(params).items():
                params[k].copy_(v)


def _by_key(params, leaves):
    return dict(zip(sorted(params), leaves))


class _FusedStep(_TrainStep):
    def eager(self, params, pixel_idx, target_flat, seed):
        """The step with its fwd+bwd run eagerly, on any device."""
        leaves = self.leaves(params)
        loss, grads, _, _ = fused_fwd_bwd(
            _by_key(params, leaves), self.scene, self.camera, self.cfg,
            target_flat, pixel_idx, seed)
        return self._reduce_and_update(params, leaves, loss, grads)

    def compiled(self, params, pixel_idx, target_flat, seed):
        """The step with its fwd+bwd replayed (``engine.compiled.FUSED``),
        its tail flag read before the collective."""
        from ..engine.compiled import FUSED
        leaves = self.leaves(params)
        loss, grads = FUSED.run(
            _by_key(params, leaves), self.scene, self.camera, self.cfg,
            {"target": target_flat, "pixel_idx": pixel_idx}, seed)
        return self._reduce_and_update(params, leaves, loss, grads)

    def _reduce_and_update(self, params, leaves, loss, grads):
        # this shard's part of the global mean (``fused_fwd_bwd``): the sum
        # over the ranks of it, and of its gradients, is the mean loss and
        # its gradients
        grads = [grads[k] for k in sorted(params)]
        all_reduce_flat([loss, *grads], self.mesh)
        self.update(params, leaves, grads)
        return loss


class _OverlappedStep(_TrainStep):
    # False waits for each sample's all-reduce before the next sample
    # starts: the same sums with nothing hidden, to measure the overlap by.
    async_op = True

    def eager(self, params, pixel_idx, target_flat, seed):
        """The step with its samples and VJPs run eagerly, on any
        device."""
        leaves = self.leaves(params)

        def forward(acc, k):
            return acc + self.sample(params, pixel_idx, k, seed)

        def vjp(cot, k):
            return sample_vjp(_by_key(params, leaves), self.scene,
                              self.camera, self.cfg, cot, k, pixel_idx,
                              seed)[1]
        return self._step(params, leaves, target_flat, forward, vjp)

    def compiled(self, params, pixel_idx, target_flat, seed):
        """The step with its samples replayed (``engine.compiled.SAMPLES``
        over the shard) and its VJPs too (``engine.compiled.VJPS``), each
        VJP at the segments that its sample's forward ran; the VJPs' tail
        flags read once, before the update."""
        from ..engine.compiled import SAMPLES, VJPS
        leaves = self.leaves(params)
        scene, camera = self._posed
        runs, tails = [], []

        def forward(acc, k):
            return SAMPLES.sample(scene, camera, self.cfg, k, seed,
                                  consume=acc.add, pixel_idx=pixel_idx,
                                  runs=runs)

        def vjp(cot, k):
            _, g, tail = VJPS.run(
                _by_key(params, leaves), self.scene, self.camera, self.cfg,
                {"cot": cot, "sample_idx": k, "pixel_idx": pixel_idx}, seed,
                need=[max(runs)], defer=True)
            if tail is not None:
                tails.append(tail)
            return g

        def check():
            if tails and bool(torch.stack(tails).any()):
                raise RuntimeError(
                    "a sample's VJP left a lane alive after the segments "
                    "its forward ran: no update from a result cut short")
        return self._step(params, leaves, target_flat, forward, vjp, check)

    def _step(self, params, leaves, target_flat, forward, vjp,
              check=lambda: None):
        spp = self.cfg.spp
        # ---- pass 1: forward only, the mean image and the cotangent ----
        with torch.no_grad():
            acc = torch.zeros_like(target_flat)
            for k in range(spp):
                acc = forward(acc, k)
            diff = acc / float(spp) - target_flat
            cot = diff * (2.0 / (self.n_elems * spp))
            loss = torch.sum(diff * diff)
        all_reduce_flat([loss], self.mesh)
        loss = loss / self.n_elems

        # ---- pass 2: one backward per sample, its all-reduce in flight
        # while the next sample's forward and backward run ----
        total = [torch.zeros_like(p) for p in leaves]

        def land(in_flight, grads):
            in_flight.wait()
            for t, g in zip(total, grads):
                t += g
        pending = None
        for k in range(spp):
            g = vjp(cot, k)
            g = [g[key] for key in sorted(params)]
            if pending is not None:
                land(*pending)
            pending = (all_reduce_flat(g, self.mesh, async_op=self.async_op),
                       g)
        land(*pending)
        check()
        self.update(params, leaves, total)
        return loss


def make_train_step(scene: Scene, camera: Camera, cfg, optimizer, mesh=None):
    """A sharded inverse-rendering step ``step(params, pixel_idx,
    target_flat, seed) -> loss`` (see the module docstring for the
    arguments).

    Per rank: render the shard ``pixel_idx`` (i32[n_pix / world]), take its
    squared error against ``target_flat`` (f32[n_pix / world, 3]) over the
    global element count, and its gradient by autograd; then one all-reduce
    of (loss, every gradient) in one flat buffer, then the optimizer's
    update and the clip. Parameters and optimizer state stay replicated.
    (``make_train_step_overlapped`` hides the all-reduce behind the
    backward.)
    """
    return _FusedStep(scene, camera, cfg, optimizer, mesh)


def make_train_step_overlapped(scene: Scene, camera: Camera, cfg, optimizer,
                               mesh=None):
    """The sharded step with the gradient all-reduce overlapped with the
    backward (``cfg.spp >= 2``).

    The fused step reduces every gradient in one all-reduce that can start
    only when the whole backward is done. This one restructures the
    multi-sample loss so that communication runs beside compute:

      * pass 1: forward only over the samples, for the mean image, the loss
        (one all-reduce of a scalar) and the loss's cotangent
        c = 2 (img - target) / (n_pix * 3 * spp), which is pixelwise and
        needs nothing from another rank;
      * pass 2: one ``autograd.grad(sample_k, params, grad_outputs=c)`` per
        sample, with the all-reduce of sample k-1's flat gradient left in
        flight (``async_op``) and waited for only when sample k's forward
        and backward are done. Exactly ``spp`` gradient all-reduces.

    It costs one more forward pass, and pays when the all-reduce is a
    visible share of the step: fits across hosts, texture gradients of
    megabytes. Gradients equal the fused step's up to summation order.
    """
    if cfg.spp < 2:
        raise ValueError("the overlap needs spp >= 2 (one all-reduce in "
                         "flight)")
    return _OverlappedStep(scene, camera, cfg, optimizer, mesh)
