"""Camera ray generation with thin-lens depth of field, as
``pbrpathtracer_tpu.ops.camera``: rays start at the top-left corner of each
pixel (no half-pixel offset, no jitter), and the lens offset is a uniform disc
sample times the aperture in the (right, up) plane.

Pixel p = row * width + col, with row 0 at the top of the image.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.scene import Camera
from . import rng
from .linalg import cross, dot


def generate_rays(camera: Camera, width: int, height: int, seed, sample_idx,
                  pixel_idx=None):
    """Primary rays for one sample pass.

    ``pixel_idx`` is an optional i32[N] subset of pixels (default: all, on
    the camera's device). Returns (ro f32[N,3], rd f32[N,3]), rd normalized.
    """
    if pixel_idx is None:
        pixel_idx = torch.arange(width * height, dtype=torch.int32,
                                 device=camera.pos.device)
    row = pixel_idx // width
    col = pixel_idx % width

    img_center = camera.pos + camera.dir * camera.focal
    img_height = 2.0 * camera.focal * torch.tan(
        (camera.fovy / 2.0) * float(np.float32(np.pi)) / 180.0)
    aspect = float(np.float32(width) / np.float32(height))
    img_width = img_height * aspect
    dx = img_width / float(width)
    dy = img_height / float(height)
    cam_right = cross(camera.up, camera.dir)
    cam_right = cam_right / torch.sqrt(dot(cam_right, cam_right))

    top_left = (img_center - cam_right * (img_width * 0.5)
                + camera.up * (img_height * 0.5))

    # Pixel corner (no 0.5 offset)
    pixel = (top_left[None, :]
             - camera.up[None, :] * (row.to(torch.float32) * dy)[:, None]
             + cam_right[None, :] * (col.to(torch.float32) * dx)[:, None])

    rd = pixel - camera.pos[None, :]
    rd = rd / torch.sqrt(dot(rd, rd))[:, None]

    # Thin lens: slots 0-1 share one pcg4d group.
    u_angle, u_radius, _, _ = rng.rand_slots4(
        seed, pixel_idx, sample_idx, rng.STREAM_CAMERA,
        rng.SLOT_LENS_ANGLE // 4)
    angle = u_angle * float(np.float32(2.0 * np.pi))
    radius = torch.sqrt(u_radius)
    disc = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1) \
        * radius[:, None]

    focal_point = camera.pos[None, :] + rd * camera.focal_dist
    ro = (camera.pos[None, :]
          + cam_right[None, :] * (disc[:, 0:1] * camera.aperture)
          + camera.up[None, :] * (disc[:, 1:2] * camera.aperture))
    rd = focal_point - ro
    rd = rd / torch.sqrt(dot(rd, rd))[:, None]
    return ro, rd
