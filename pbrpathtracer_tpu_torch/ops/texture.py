"""Texture fetch: nearest neighbour with repeat wrap, as
``pbrpathtracer_tpu.ops.texture``. The wrap is ``torch.remainder`` (the
non-negative ``jnp.mod``), not ``fmod``; texel coordinates truncate.

The read is one row gather from the stack seen as a table of texels,
f32[K * PH * PW, 4], through the pack-gather pair (``gather_rows_t``: K2
forward, K3 backward), so the gradient w.r.t. the texels is K3's sorted
reduction rather than torch's index backward, whose cost grows with the
number of lanes that land on one texel. Masked lanes read an
out-of-range row: a zero row forward, dropped backward."""

from __future__ import annotations

import torch

from ..kernels.packgather import gather_rows_t
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
    K, PH, PW, C = textures.data.shape
    n_texels = K * PH * PW
    if n_texels >= 2 ** 31:
        raise ValueError("texel row ids ride as int32: need < 2**31 texels")
    safe_idx = torch.where(mask, tex_idx, 0)
    x, y = texel_coords(textures, safe_idx, uv)
    row = (safe_idx * PH + y) * PW + x
    row = torch.where(mask, row, n_texels).to(torch.int32)
    texel = gather_rows_t(textures.data.reshape(n_texels, C), row).T
    return torch.where(mask[:, None], texel, fallback)
