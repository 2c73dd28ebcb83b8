"""Progressive render session, as ``pbrpathtracer_tpu.engine.session``: the
reference's render-thread state machine as a headless object.

  start()    push the editor scene into tracer tensors, reset accumulation
  pause()    stop issuing passes; the float accumulation buffer and the
             sample counter persist
  resume()   continue, seed-exact (the absolute sample counter keys the RNG)
  stop()     halt and clear the tracer scene
  restart()  re-push the scene and reset accumulation
  step(n)    render n progressive passes (1 spp each); the pass boundary is
             the cooperative-cancel point
  target_samples: auto-pause once reached

``metrics()`` gives the status bar's numbers: samples, average time per
sample, elapsed (pause-aware), triangle count.

The session renders where its scene lies. With an editor, the scene is built
on ``device`` (the card unless the caller names another); with an explicit
(scene, camera) pair, on the scene's device. ``accum`` stays on that device;
``image()`` and ``image_u8()`` copy to the host. Every pass runs under
``torch.inference_mode()``, whatever the scene's leaves require. On the
card the passes go through the captured sample (``engine/compiled.py``),
as the JAX session jits its pass: the first pass after a (re)start renders
eagerly, the second captures, the later ones replay; the result is the
eager render's bit for bit (``render_sample`` is the eager pass).
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import enum
import threading
import time

import numpy as np
import torch

from ..ops.integrator import render_accumulate, tonemap_u8
from ..scene.editor import EditorScene
from ..utils import observability
from .config import DROPPED_FIELDS, RenderConfig


class RenderState(enum.Enum):
    IDLE = "idle"
    RENDERING = "rendering"
    PAUSED = "paused"
    STOPPED = "stopped"


def _on_device(device: torch.device):
    """Context that makes ``device`` the calling thread's current CUDA
    device (the current device is per thread); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class RenderSession:
    def __init__(self, editor: EditorScene | None = None,
                 cfg: RenderConfig | None = None, scene=None, camera=None,
                 device: str | torch.device = "cuda"):
        """Either give an editor (its scene is built on ``device`` at
        start()) or an explicit (scene, camera) pair, which renders on the
        scene's device."""
        self.editor = editor
        self.cfg = cfg or RenderConfig()
        self.device = torch.device(device)
        self._scene = scene
        self._camera = camera
        self.state = RenderState.IDLE
        self.accum = None           # f32[N,3] running sum, on the device
        self.samples = 0
        self.target_samples: int | None = None
        self._time_rendering = 0.0  # accumulated active render time
        self._run_started = None
        self._cancel = threading.Event()
        self._thread = None
        self._step_fn = None

    # -- scene push (SendObjectsToPathTracer path) -------------------------
    def _push_scene(self):
        if self.editor is not None:
            self._scene = self.editor.build_scene(device=self.device)
            self._camera = self.editor.tracer_camera(device=self.device)
        if self._scene is None or self._camera is None:
            raise RuntimeError("no scene: give an editor or (scene, camera)")
        scene, cfg = self._scene, self.cfg
        camera = self._camera.to(scene.device)

        def one_pass(accum, sample_start):
            with torch.inference_mode():
                return render_accumulate(scene, camera, cfg, accum,
                                         sample_start, 1)
        self._step_fn = one_pass

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._push_scene()
        self.reset_image()
        self.state = RenderState.RENDERING
        self._time_rendering = 0.0
        self._run_started = time.perf_counter()

    def reset_image(self):
        n = self.cfg.width * self.cfg.height
        device = self.device if self._scene is None else self._scene.device
        self.accum = torch.zeros((n, 3), dtype=torch.float32, device=device)
        self.samples = 0

    def pause(self):
        if self.state == RenderState.RENDERING:
            self._note_elapsed()
            self.state = RenderState.PAUSED
            self._cancel.set()

    def resume(self):
        if self.state == RenderState.PAUSED:
            self.state = RenderState.RENDERING
            self._run_started = time.perf_counter()
            self._cancel.clear()

    def stop(self):
        """Stop and clear the tracer scene; the accumulation buffer survives
        for export."""
        self._note_elapsed()
        self._cancel.set()
        self.wait()
        self.state = RenderState.STOPPED
        self._step_fn = None
        if self.editor is not None:
            self._scene = None
            self._camera = None

    def restart(self):
        self.stop()
        self._cancel.clear()
        self.start()

    def _note_elapsed(self):
        if self.state == RenderState.RENDERING and self._run_started:
            self._time_rendering += time.perf_counter() - self._run_started
            self._run_started = None

    # -- progressive passes ------------------------------------------------
    def step(self, n_passes: int = 1) -> int:
        """Render up to n_passes progressive 1-spp passes. Returns the
        passes actually run (auto-pauses at target_samples, honours
        cancel)."""
        if self.state != RenderState.RENDERING:
            return 0
        done = 0
        for _ in range(n_passes):
            if self._cancel.is_set():
                break
            if (self.target_samples is not None
                    and self.samples >= self.target_samples):
                self._note_elapsed()
                self.state = RenderState.PAUSED   # auto-pause
                break
            self.accum = self._step_fn(self.accum, self.samples)
            self.samples += 1
            done += 1
        if done and self.accum.is_cuda:
            # the passes are queued, not done: the clock of metrics() reads
            # finished work
            with observability.host_read("pbr.sync.pass"):
                torch.cuda.synchronize(self.accum.device)
        if done:
            observability.call_done(done)
        return done

    def run_async(self, passes_per_chunk: int = 1):
        """Render from a background thread until paused, stopped or at
        target_samples. ``stop()`` and ``wait()`` join it."""
        if self.state != RenderState.RENDERING:
            self.start()
        device = self._scene.device

        def loop():
            # the current CUDA device is per thread (as is inference mode,
            # which each pass enters itself)
            with _on_device(device):
                while (not self._cancel.is_set()
                       and self.state == RenderState.RENDERING):
                    if self.step(passes_per_chunk) == 0:
                        break
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self._thread

    def wait(self, timeout: float | None = None) -> bool:
        """Join the background thread; False if it is still running after
        ``timeout`` seconds."""
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                return False
            self._thread = None
        return True

    # -- output ------------------------------------------------------------
    def image(self) -> np.ndarray:
        """Mean-radiance image f32[H,W,3], on the host."""
        if self.accum is None or self.samples == 0:
            return np.zeros((self.cfg.height, self.cfg.width, 3), np.float32)
        img = self.accum.cpu().numpy() / self.samples
        return img.reshape(self.cfg.height, self.cfg.width, 3)

    def image_u8(self) -> np.ndarray:
        """Display buffer (clamp and truncate, no gamma), on the host."""
        if self.accum is None or self.samples == 0:
            return np.zeros((self.cfg.height, self.cfg.width, 3), np.uint8)
        u8 = tonemap_u8(self.accum, self.samples).cpu().numpy()
        return u8.reshape(self.cfg.height, self.cfg.width, 3)

    def export_png(self, path_or_dir: str) -> str:
        from ..io.png import export_png
        return export_png(path_or_dir, self.image())

    # -- metrics (status bar parity) ---------------------------------------
    def metrics(self) -> dict:
        elapsed = self._time_rendering
        if self.state == RenderState.RENDERING and self._run_started:
            elapsed += time.perf_counter() - self._run_started
        tri_count = (self._scene.num_triangles
                     if self._scene is not None else 0)
        n_rays = self.cfg.width * self.cfg.height * max(self.samples, 0)
        return {
            "state": self.state.value,
            "samples": self.samples,
            "target_samples": self.target_samples,
            "elapsed_s": elapsed,
            "avg_time_per_sample_s": (elapsed / self.samples
                                      if self.samples else 0.0),
            "triangles": tri_count,
            "paths_per_s": (n_rays / elapsed) if elapsed > 0 else 0.0,
        }

    # -- checkpoint / resume -----------------------------------------------
    def save_checkpoint(self, path: str):
        """Serialize (accum, samples, cfg). A resume is seed-exact because
        the RNG is keyed by the absolute sample index. The file has the JAX
        session's keys, so either package's session loads it."""
        np.savez(
            path,
            accum=self.accum.cpu().numpy() if self.accum is not None else
            np.zeros((0, 3), np.float32),
            samples=self.samples,
            cfg=np.array([repr(dataclasses.asdict(self.cfg))]),
        )

    def load_checkpoint(self, path: str):
        """Carry on from a checkpoint of this session or of the JAX
        package's. The JAX config's fields that the port dropped
        (``config.DROPPED_FIELDS``) are ignored; any other unknown field
        raises."""
        # the JAX session stores its config as an object array
        data = np.load(path, allow_pickle=True)
        cfg_dict = ast.literal_eval(str(data["cfg"][0]))
        known = {f.name for f in dataclasses.fields(RenderConfig)}
        unknown = set(cfg_dict) - known - set(DROPPED_FIELDS)
        if unknown:
            raise ValueError(f"{path}: unknown config fields "
                             f"{sorted(unknown)}")
        self.cfg = RenderConfig(**{k: v for k, v in cfg_dict.items()
                                   if k in known})
        self._push_scene()
        self.accum = torch.from_numpy(
            np.asarray(data["accum"], np.float32)).to(self._scene.device)
        self.samples = int(data["samples"])
        self.state = RenderState.RENDERING
        self._run_started = time.perf_counter()
