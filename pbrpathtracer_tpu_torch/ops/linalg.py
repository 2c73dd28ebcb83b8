"""Small vector helpers on f32[N,3] batches.

Sums over the three components are written out left to right, the order the
CUDA kernels use, so a port result does not depend on how a reduction kernel
orders its adds.
"""

import torch

# Norm² floor of safe_normalize (the JAX package's value).
TINY = 1e-12


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    """a x b over the last axis, in ``jnp.cross``'s operation order."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def safe_normalize(v):
    n2 = dot(v, v)[..., None]
    return v * torch.rsqrt(torch.clamp(n2, min=TINY))


def reflect(rd, n):
    """glm::reflect: rd - 2 dot(rd, n) n."""
    return rd - 2.0 * dot(rd, n)[..., None] * n


def safe_sqrt(x):
    """sqrt(max(x, 0)), zero where x <= 0."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)
