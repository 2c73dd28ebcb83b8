"""Global numeric constants shared by the tracer, oracle and tests.

Parity source: the reference renderer's src/mesh.h:12-13 defines
``EPS = 0.00001f`` and ``INF = (float)0xFFFF``; every epsilon comparison in the
reference renderer uses these exact values, so we reproduce them bit-for-bit.
"""

import numpy as np

# mesh.h:12 — intersection / geometry epsilon.
EPS = np.float32(1e-5)

# mesh.h:13 — "infinity" used for AABB init (0xFFFF = 65535.0f).
INF = np.float32(0xFFFF)

# pathtracer.cpp:618 — the glossy-cone lobe uses FLT_EPSILON for the
# basis-degeneracy test instead of EPS.
FLT_EPSILON = np.float32(np.finfo(np.float32).eps)

# Material types, mesh.h:15-19.
OPAQUE = 0
TRANSLUCENT = 1

# Texture slot order (scene persistence order, main.cpp:407-425 and the
# Set*TextureForElement family, pathtracer.cpp:147-241).
TEX_DIFFUSE = 0
TEX_NORMAL = 1
TEX_EMISSIVE = 2
TEX_ROUGHNESS = 3
TEX_METALLIC = 4
TEX_OPACITY = 5
NUM_TEX_SLOTS = 6
TEX_SLOT_NAMES = ("diffuse", "normal", "emissive", "roughness", "metallic", "opacity")

# No texture sentinel in the per-material texture-index table.
NO_TEXTURE = -1

# Maximum texture dimension: the reference downscales anything larger
# (image.cpp:47-60).
MAX_TEXTURE_DIM = 1024
