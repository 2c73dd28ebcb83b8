"""Scene as tensors: the PyTorch counterpart of ``pbrpathtracer_tpu.scene.scene``.

The same flat SoA layout as the JAX package: triangles reference a flattened
material table via ``mat_id`` and materials reference a padded texture stack
via ``tex_index``. Each container is a frozen dataclass of tensors with a
``.to(device)``; a scene's device is the device of its tensors, and the
renderer runs there.

The host helpers are numpy, as in the JAX package, and end in torch tensors,
so a port scene and a JAX scene built from the same inputs are equal leaf for
leaf. Large scenes carry a BVH built on the host (``Scene.accel``, an
``accel.build.FlatBVH``), as in the JAX package: ``finalize_scene`` builds it
for scenes over ``accel_threshold`` triangles, ``with_accel`` on demand.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.build import FlatBVH
from ..utils.constants import (
    EPS,
    NUM_TEX_SLOTS,
    NO_TEXTURE,
    OPAQUE,
    TEX_OPACITY,
    TRANSLUCENT,
)


def _fields_to(obj, device):
    """Copy of a dataclass of tensors with every tensor moved to ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)})


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Triangle soup in Möller–Trumbore edge form: (v0, e1, e2) with
    e1 = v1 - v0, e2 = v2 - v0."""

    v0: torch.Tensor          # f32[T,3]
    e1: torch.Tensor          # f32[T,3]
    e2: torch.Tensor          # f32[T,3]
    n0: torch.Tensor          # f32[T,3] per-vertex shading normals (may be zero)
    n1: torch.Tensor          # f32[T,3]
    n2: torch.Tensor          # f32[T,3]
    uv0: torch.Tensor         # f32[T,2]
    uv1: torch.Tensor         # f32[T,2]
    uv2: torch.Tensor         # f32[T,2]
    normal: torch.Tensor      # f32[T,3] geometric normal = normalize(e1 x e2)
    tangent: torch.Tensor     # f32[T,3]
    bitangent: torch.Tensor   # f32[T,3]
    smoothing: torch.Tensor   # bool[T]
    mat_id: torch.Tensor      # i32[T] index into the material table
    object_id: torch.Tensor   # i32[T]
    element_id: torch.Tensor  # i32[T]

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    def vertices(self):
        """Return (v0, v1, v2) actual vertex positions."""
        return self.v0, self.v0 + self.e1, self.v0 + self.e2

    def to(self, device) -> "Geometry":
        return _fields_to(self, device)


@dataclasses.dataclass(frozen=True)
class Materials:
    """Flattened (object, element) material table."""

    mat_type: torch.Tensor            # i32[M] 0=OPAQUE 1=TRANSLUCENT
    diffuse: torch.Tensor             # f32[M,3]
    specular: torch.Tensor            # f32[M,3]
    emissive: torch.Tensor            # f32[M,3]
    emissive_intensity: torch.Tensor  # f32[M]
    roughness: torch.Tensor           # f32[M]
    reflectiveness: torch.Tensor      # f32[M]
    translucency: torch.Tensor        # f32[M]
    ior: torch.Tensor                 # f32[M]
    tex_index: torch.Tensor           # i32[M,6] texture-stack index per slot, -1 = none

    @property
    def num_materials(self) -> int:
        return self.diffuse.shape[0]

    def to(self, device) -> "Materials":
        return _fields_to(self, device)


@dataclasses.dataclass(frozen=True)
class Textures:
    """Padded texture stack: ``data`` f32[K, PH, PW, 4] holds each texture in
    its top-left corner; ``size`` i32[K, 2] = (width, height)."""

    data: torch.Tensor
    size: torch.Tensor

    @property
    def num_textures(self) -> int:
        return self.data.shape[0]

    def to(self, device) -> "Textures":
        return _fields_to(self, device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole + thin-lens camera; every field is a float32 tensor."""

    pos: torch.Tensor         # f32[3]
    dir: torch.Tensor         # f32[3] normalized
    up: torch.Tensor          # f32[3] normalized
    focal: torch.Tensor       # f32[] image-plane distance
    fovy: torch.Tensor        # f32[] degrees
    focal_dist: torch.Tensor  # f32[] thin-lens focus distance
    aperture: torch.Tensor    # f32[] lens radius scale

    @classmethod
    def make(cls, pos=(0.0, 0.0, 0.0), dir=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0),
             focal=0.1, fovy=90.0, focal_dist=5.0, aperture=0.0) -> "Camera":
        def f32(x):
            return torch.tensor(x, dtype=torch.float32)

        d = f32(dir)
        u = f32(up)
        return cls(pos=f32(pos), dir=d / torch.linalg.vector_norm(d),
                   up=u / torch.linalg.vector_norm(u), focal=f32(focal),
                   fovy=f32(fovy), focal_dist=f32(focal_dist),
                   aperture=f32(aperture))

    def to(self, device) -> "Camera":
        return _fields_to(self, device)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Complete render-ready scene.

    ``accel`` is None or the scene's BVH; its ``perm`` is the triangle order
    in which the closest-hit queries break exact-t ties. ``lights`` holds the indices of emissive triangles in scene order: a
    triangle is a light iff ``||material.emissive|| >= EPS``. The three flags
    are static facts of the tables, computed once by ``finalize_scene``.
    """

    geom: Geometry
    materials: Materials
    textures: Textures
    lights: torch.Tensor   # i32[L] triangle indices (L may be 0)
    has_opacity_tex: bool = False
    has_any_texture: bool = False
    has_translucent: bool = False
    accel: FlatBVH | None = None

    @property
    def num_triangles(self) -> int:
        return self.geom.num_triangles

    @property
    def num_lights(self) -> int:
        return self.lights.shape[0]

    @property
    def device(self) -> torch.device:
        return self.geom.v0.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self, geom=self.geom.to(device),
            materials=self.materials.to(device),
            textures=self.textures.to(device), lights=self.lights.to(device),
            accel=None if self.accel is None else self.accel.to(device))


# ---------------------------------------------------------------------------
# Host-side construction helpers (numpy in, tensors out)
# ---------------------------------------------------------------------------

def _t(x, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype))


def compute_tbn(v0, v1, v2, uv0, uv1, uv2):
    """Per-triangle (normal, tangent, bitangent), each f32[T,3] normalized.

    Degenerate UVs give a zero tangent and bitangent instead of NaN, as in
    the JAX package.
    """
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(v1, np.float32) - v0
    e2 = np.asarray(v2, np.float32) - v0
    d1 = np.asarray(uv1, np.float32) - np.asarray(uv0, np.float32)
    d2 = np.asarray(uv2, np.float32) - np.asarray(uv0, np.float32)

    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(np.abs(det) > 0, 1.0 / det, 0.0).astype(np.float32)

    tangent = f[:, None] * (d2[:, 1:2] * e1 - d1[:, 1:2] * e2)
    bitangent = f[:, None] * (-d2[:, 0:1] * e1 + d1[:, 0:1] * e2)
    normal = np.cross(e1, e2)

    def _norm(x):
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return np.where(n > 0, x / np.maximum(n, 1e-30), x).astype(np.float32)

    return _norm(normal), _norm(tangent), _norm(bitangent)


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material description with the reference's defaults."""

    mat_type: int = OPAQUE
    diffuse: tuple = (1.0, 1.0, 1.0)
    specular: tuple = (1.0, 1.0, 1.0)
    emissive: tuple = (0.0, 0.0, 0.0)
    emissive_intensity: float = 1.0
    roughness: float = 1.0
    reflectiveness: float = 0.0
    translucency: float = 1.0
    ior: float = 1.5
    # texture-stack indices per slot, NO_TEXTURE = none
    tex_index: tuple = (NO_TEXTURE,) * NUM_TEX_SLOTS


def pack_materials(specs) -> Materials:
    """Pack a list of MaterialSpec into the Materials tables."""
    i32 = np.int32
    return Materials(
        mat_type=_t([s.mat_type for s in specs], i32),
        diffuse=_t([s.diffuse for s in specs]),
        specular=_t([s.specular for s in specs]),
        emissive=_t([s.emissive for s in specs]),
        emissive_intensity=_t([s.emissive_intensity for s in specs]),
        roughness=_t([s.roughness for s in specs]),
        reflectiveness=_t([s.reflectiveness for s in specs]),
        translucency=_t([s.translucency for s in specs]),
        ior=_t([s.ior for s in specs]),
        tex_index=_t([s.tex_index for s in specs], i32),
    )


def pack_geometry(tris) -> Geometry:
    """Pack host triangle arrays into a Geometry.

    ``tris`` is a dict of numpy arrays with keys v0, v1, v2 (f32[T,3]) and
    optional n0, n1, n2, uv0, uv1, uv2, smoothing (bool[T]), mat_id,
    object_id, element_id.
    """
    T = tris["v0"].shape[0]
    f32, i32 = np.float32, np.int32
    v0 = np.asarray(tris["v0"], f32)
    v1 = np.asarray(tris["v1"], f32)
    v2 = np.asarray(tris["v2"], f32)
    zeros3 = np.zeros((T, 3), f32)
    zeros2 = np.zeros((T, 2), f32)
    n0 = tris.get("n0", zeros3)
    n1 = tris.get("n1", zeros3)
    n2 = tris.get("n2", zeros3)
    uv0 = np.asarray(tris.get("uv0", zeros2), f32)
    uv1 = np.asarray(tris.get("uv1", zeros2), f32)
    uv2 = np.asarray(tris.get("uv2", zeros2), f32)
    normal, tangent, bitangent = compute_tbn(v0, v1, v2, uv0, uv1, uv2)
    return Geometry(
        v0=_t(v0), e1=_t(v1 - v0), e2=_t(v2 - v0),
        n0=_t(n0), n1=_t(n1), n2=_t(n2),
        uv0=_t(uv0), uv1=_t(uv1), uv2=_t(uv2),
        normal=_t(normal), tangent=_t(tangent), bitangent=_t(bitangent),
        smoothing=_t(tris.get("smoothing", np.zeros(T, bool)), bool),
        mat_id=_t(tris.get("mat_id", np.zeros(T, i32)), i32),
        object_id=_t(tris.get("object_id", np.zeros(T, i32)), i32),
        element_id=_t(tris.get("element_id", np.zeros(T, i32)), i32),
    )


def empty_textures() -> Textures:
    """A 1-entry dummy stack so texture gathers always have a valid target."""
    return Textures(data=torch.zeros((1, 1, 1, 4), dtype=torch.float32),
                    size=torch.ones((1, 2), dtype=torch.int32))


def pack_textures(images) -> Textures:
    """Pack a list of f32[H,W,4] numpy images into a padded stack; slot k is
    ``images[k]``. An empty list gives the dummy stack of ``empty_textures``.
    """
    if not images:
        return empty_textures()
    ph = max(im.shape[0] for im in images)
    pw = max(im.shape[1] for im in images)
    data = np.zeros((len(images), ph, pw, 4), np.float32)
    size = np.zeros((len(images), 2), np.int32)
    for k, im in enumerate(images):
        h, w = im.shape[:2]
        data[k, :h, :w, :] = im
        size[k] = (w, h)
    return Textures(data=_t(data), size=_t(size, np.int32))


def build_lights(geom: Geometry, materials: Materials) -> torch.Tensor:
    """Light list: triangles whose material emissive has norm >= EPS, in
    triangle order."""
    emissive = materials.emissive.cpu().numpy()
    mat_id = geom.mat_id.cpu().numpy()
    norms = np.linalg.norm(emissive[mat_id], axis=-1)
    idx = np.nonzero(norms >= EPS)[0].astype(np.int32)
    return torch.from_numpy(idx).to(geom.v0.device)


def finalize_scene(geom: Geometry, materials: Materials,
                   textures: Textures | None = None, accel: str = "auto",
                   accel_threshold: int = 4096) -> Scene:
    """Assemble a Scene: the light list, the static texture and translucency
    flags, and the BVH: "auto" builds it for scenes over ``accel_threshold``
    triangles, "always" for any scene, "none" for none."""
    if accel not in ("auto", "always", "none"):
        raise ValueError(f"unknown accel {accel!r}")
    if textures is None:
        textures = empty_textures().to(geom.v0.device)
    tex_index = materials.tex_index.cpu().numpy()
    scene = Scene(
        geom=geom, materials=materials, textures=textures,
        lights=build_lights(geom, materials),
        has_opacity_tex=bool((tex_index[:, TEX_OPACITY] >= 0).any()),
        has_any_texture=bool((tex_index >= 0).any()),
        has_translucent=bool(
            (materials.mat_type.cpu().numpy() == TRANSLUCENT).any()),
    )
    if accel == "always" or (accel == "auto"
                             and geom.num_triangles > accel_threshold):
        scene = with_accel(scene)
    return scene


def with_accel(scene: Scene, leaf_size: int = 8) -> Scene:
    """The scene with a BVH built from its geometry on the host (the C++ SAH
    builder from 20,000 triangles up, the numpy median split below), on the
    scene's device."""
    from ..accel.native import build_bvh_auto
    v0, v1, v2 = (x.cpu().numpy() for x in scene.geom.vertices())
    bvh = build_bvh_auto(v0, v1, v2, leaf_size=leaf_size)
    return dataclasses.replace(scene, accel=bvh.to(scene.device))
