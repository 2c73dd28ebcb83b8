"""Counter-based RNG: the keyed pcg4d hash of ``pbrpathtracer_tpu.ops.rng``,
bit for bit, on torch tensors.

Every random decision in a render has a fixed key (seed, pixel, sample,
stream, slot), independent of evaluation order, so the port draws exactly
the numbers the JAX package and its CPU oracle draw, and needs no
``torch.Generator``.

Torch has no usable uint32 on the CPU (``+`` and ``>>`` raise), so the
32-bit words ride in int64 and are masked with ``& 0xFFFFFFFF`` after each
``*`` and ``+``. A product of two 32-bit words can wrap int64, but its low
32 bits stay exact.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# Slot layout (identical to the JAX package)
# ---------------------------------------------------------------------------
# Streams: 0 = camera/lens, 1 + b = bounce segment b. The counter passed to
# the hash is  stream * SLOTS_PER_STREAM + slot.

SLOTS_PER_STREAM = 32

STREAM_CAMERA = 0


def bounce_stream(segment):
    """Stream id for bounce segment ``segment`` (0-based)."""
    return 1 + segment


# Camera stream slots.
SLOT_LENS_ANGLE = 0
SLOT_LENS_RADIUS = 1

# Bounce-stream slots; one segment consumes at most one draw per slot.
SLOT_OPACITY_BASE = 0       # 0..3: stochastic alpha re-trace attempts
SLOT_RR = 4                 # Russian roulette
SLOT_LOBE_SELECT = 5        # opaque: Rand() < reflectiveness
SLOT_LOBE_W = 6             # hemisphere/cone sample w
SLOT_LOBE_THETA = 7         # hemisphere/cone sample theta
SLOT_REFRACT_CONE_W = 8     # translucent rough refraction-normal cone
SLOT_REFRACT_CONE_THETA = 9
SLOT_FRESNEL = 10           # Schlick test
SLOT_REFLECTIVENESS = 11    # translucent reflectiveness test
SLOT_TRANSLUCENCY = 12      # refract vs diffuse
SLOT_NEE_LIGHT = 13         # light-triangle pick
SLOT_NEE_U = 14             # triangle sample u
SLOT_NEE_V = 15             # triangle sample v
SLOT_NEE_OPACITY_BASE = 16  # 16..19: shadow-ray alpha re-trace attempts

MAX_OPACITY_ATTEMPTS = 4

_MASK = 0xFFFFFFFF


def pcg4d(a, b, c, d):
    """4-in/4-out pcg4d hash (Jarzynski & Olano, JCGT 2020) on 32-bit words
    carried in int64. Inputs are broadcastable int tensors (a 0-d one may be
    a device value, as a captured render's seed and sample index are) or
    Python ints; outputs are int64 tensors with values in [0, 2**32), on
    the device of the tensor inputs.

    A Python int becomes a 0-d CPU tensor, which torch hands to a device
    kernel by value: no copy to the card, so the hash can be captured in a
    CUDA graph (with that word fixed in it)."""
    device = next((v.device for v in (a, b, c, d)
                   if isinstance(v, torch.Tensor) and v.dim() > 0), None)

    def word(v):
        if not isinstance(v, torch.Tensor):
            return torch.tensor(int(v) & _MASK, dtype=torch.int64)
        if device is not None and (v.dim() > 0 or v.device.type != "cpu"):
            v = v.to(device)   # a 0-d CPU word stays a by-value operand
        return v.to(torch.int64) & _MASK

    m = 1664525
    k = 1013904223
    x = (word(a) * m + k) & _MASK
    y = (word(b) * m + k) & _MASK
    z = (word(c) * m + k) & _MASK
    w = (word(d) * m + k) & _MASK
    x = (x + y * w) & _MASK
    y = (y + z * x) & _MASK
    z = (z + x * y) & _MASK
    w = (w + y * z) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + y * w) & _MASK
    y = (y + z * x) & _MASK
    z = (z + x * y) & _MASK
    w = (w + y * z) & _MASK
    return x, y, z, w


def _to_unit(x):
    # Top 24 bits -> [0, 1); float32 holds all 2^24 values exactly.
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def rand_slots4(seed, pixel, sample, stream, group):
    """Four float32 uniforms for slots (4g, 4g+1, 4g+2, 4g+3) from one
    pcg4d evaluation keyed by (pixel, sample, stream*32 + 4*group, seed).
    ``pixel`` is an int tensor; the result has its shape and device."""
    ctr = (stream * SLOTS_PER_STREAM + group * 4) & _MASK
    x, y, z, w = pcg4d(pixel, sample, ctr, seed)
    return _to_unit(x), _to_unit(y), _to_unit(z), _to_unit(w)


def rand_slot(seed, pixel, sample, stream, slot):
    """Uniform draw for a (stream, slot) address, through the same group hash
    as ``rand_slots4``. ``slot`` is a Python int."""
    return rand_slots4(seed, pixel, sample, stream, slot // 4)[slot % 4]
