"""Texture fetch: nearest neighbour with repeat wrap, as
``pbrpathtracer_tpu.ops.texture``. The wrap is ``torch.remainder`` (the
non-negative ``jnp.mod``), not ``fmod``; texel coordinates truncate."""

from __future__ import annotations

import torch

from ..scene.scene import Textures


def texel_coords(textures: Textures, tex_idx, uv):
    """Wrap uv and truncate to integer texel coords of texture ``tex_idx``
    (i32[N], valid: callers mask). Returns (x i32[N], y i32[N]) clamped into
    the texture's true extent."""
    wh = textures.size[tex_idx.long()]          # i32[N,2] (w, h)
    w = wh[:, 0].to(torch.float32)
    h = wh[:, 1].to(torch.float32)
    u = torch.remainder(uv[:, 0], 1.0)
    v = torch.remainder(uv[:, 1], 1.0)
    x = (w * u).to(torch.int32)
    y = (h * v).to(torch.int32)
    x = torch.minimum(torch.clamp(x, min=0), wh[:, 0] - 1)
    y = torch.minimum(torch.clamp(y, min=0), wh[:, 1] - 1)
    return x, y


def sample_texture(textures: Textures, tex_idx, uv, fallback, mask):
    """RGBA f32[N,4] per lane; lanes with ``mask == False`` get
    ``fallback``."""
    safe_idx = torch.where(mask, tex_idx, 0)
    x, y = texel_coords(textures, safe_idx, uv)
    texel = textures.data[safe_idx.long(), y.long(), x.long()]
    return torch.where(mask[:, None], texel, fallback)
