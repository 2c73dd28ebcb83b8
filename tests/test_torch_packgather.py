"""The plain versions of the port's pack-gather kernels against the JAX
Pallas kernel ``gather_rows_t`` in interpret mode, and ``gather_fields``
against the JAX shading fetch. Forward: exact equality, out-of-range ids
included. Backward: against ``jax.grad`` at rtol 1e-6, atol 1e-5
(tests/test_packgather.py's tolerance: each row sums its cotangents in
float32, in another order than the TPU kernel's matmul)."""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.kernels.packgather_pallas import gather_rows_t as j_gather
from pbrpathtracer_tpu.ops import shadepack as jsp
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu_torch import bridge
from pbrpathtracer_tpu_torch.kernels import packgather as K
from pbrpathtracer_tpu_torch.ops import shadepack as psp
from pbrpathtracer_tpu_torch.ops.intersect_vjp import TRI9_FIELDS
from pbrpathtracer_tpu_torch.utils import observability as obs

# The port's scenes live on the card by default; these tests run on the CPU.
from_reference = functools.partial(bridge.from_reference, device="cpu")


def _case(seed, T, W, N, out_of_range=False):
    rs = np.random.RandomState(seed)
    table = rs.randn(T, W).astype(np.float32)
    idx = rs.randint(0, T, N).astype(np.int32)
    if out_of_range:
        idx[::7] = -1
        idx[3::11] = T
        idx[5::13] = T + 100
    return table, idx


@pytest.mark.parametrize("T,W,N", [(36, 55, 1000), (2, 13, 7), (9, 8, 129),
                                   (256, 55, 300)])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_plain_equals_pallas_interpret(T, W, N, out_of_range):
    table, idx = _case(T + W + N, T, W, N, out_of_range)
    ref = np.asarray(j_gather(jnp.asarray(table), jnp.asarray(idx), True))
    out = K.gather_rows_t(torch.tensor(table), torch.tensor(idx))
    assert out.shape == (W, N) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("T,W,N", [(36, 55, 1000), (2, 13, 7), (9, 8, 129),
                                   (256, 55, 300)])
def test_backward_matches_pallas_interpret(T, W, N):
    table, idx = _case(T + W + N, T, W, N, out_of_range=True)
    cot = np.random.RandomState(N).randn(W, N).astype(np.float32)
    ref = np.asarray(jax.grad(lambda t: jnp.sum(
        j_gather(t, jnp.asarray(idx), True) * cot))(jnp.asarray(table)))
    tab = torch.tensor(table, requires_grad=True)
    (K.gather_rows_t(tab, torch.tensor(idx)) * torch.tensor(cot)).sum() \
        .backward()
    np.testing.assert_allclose(tab.grad.numpy(), ref, rtol=1e-6, atol=1e-5)
    direct = K.gather_rows_t_bwd(torch.tensor(idx), torch.tensor(cot), T)
    np.testing.assert_array_equal(direct.numpy(), tab.grad.numpy())


def test_backward_takes_the_plain_version_on_cpu():
    table, idx = _case(4, 36, 55, 64, out_of_range=True)
    tab = torch.tensor(table, requires_grad=True)
    _, moved = obs.counted(
        lambda: K.gather_rows_t(tab, torch.tensor(idx)).sum().backward())
    assert moved.get("gather_rows_t_bwd", 0) == 0
    assert moved["gather_rows_t_bwd_plain"] == 1
    ok = (idx >= 0) & (idx < 36)
    counts = np.bincount(idx[ok], minlength=36).astype(np.float32)
    np.testing.assert_array_equal(tab.grad.numpy(),
                                  np.repeat(counts[:, None], 55, axis=1))


@pytest.mark.parametrize("pack", ["tri", "light", "tri9", "uv_opacity"])
def test_gather_fields_backward_matches_jax(pack):
    """The single-concatenate backward of the one ``autograd.Function``
    against the JAX gather_fields gradient, over every field (integer
    fields included)."""
    rs = np.random.RandomState(5)
    fields = {"tri": jsp.TRI_FIELDS, "light": jsp.LIGHT_FIELDS,
              "tri9": TRI9_FIELDS, "uv_opacity": psp.UV_OPACITY_FIELDS}[pack]
    W = {"tri": jsp.TRI_PACK_WIDTH, "light": jsp.LIGHT_PACK_WIDTH,
         "tri9": 9, "uv_opacity": 7}[pack]
    T, N = 36, 700
    table, idx = _case(W, T, W, N, out_of_range=True)
    cots = [rs.randn(N, s.stop - s.start) if isinstance(s, slice)
            else rs.randn(N) for s in fields]
    cots = [c.astype(np.float32) for c in cots]

    def j_loss(t):
        out = jsp.gather_fields(t, jnp.asarray(idx), fields)
        return sum(jnp.sum(o * c) for o, c in zip(out, cots))

    ref = np.asarray(jax.grad(j_loss)(jnp.asarray(table)))
    tab = torch.tensor(table, requires_grad=True)
    out = psp.gather_fields(tab, torch.tensor(idx), fields)
    assert all(o.grad_fn.name() == "_GatherFieldsBackward" for o in out)
    sum((o * torch.tensor(c)).sum() for o, c in zip(out, cots)).backward()
    np.testing.assert_allclose(tab.grad.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_gather_fields_backward_fills_unused_fields_with_zeros():
    table, idx = _case(6, 36, 55, 100)
    tab = torch.tensor(table, requires_grad=True)
    f = psp.gather_fields(tab, torch.tensor(idx), psp.TRI_FIELDS)
    f[psp.TRI_FIELDS.index(psp.DIFFUSE)].sum().backward()
    counts = np.bincount(idx, minlength=36).astype(np.float32)
    expect = np.zeros((36, 55), np.float32)
    expect[:, psp.DIFFUSE] = counts[:, None]
    np.testing.assert_array_equal(tab.grad.numpy(), expect)


def test_gather_fields_rejects_fields_that_do_not_cover_the_table():
    table, idx = (torch.tensor(x) for x in _case(7, 36, 55, 10))
    with pytest.raises(ValueError):
        psp.gather_fields(table, idx, psp.TRI_FIELDS[:-1])
    with pytest.raises(ValueError):
        psp.gather_fields(table, idx, (slice(0, 3), slice(4, 55)))


FETCHES = {"tri": (psp.TRI_FIELDS, 55), "light": (psp.LIGHT_FIELDS, 13),
           "tri9": (TRI9_FIELDS, 9), "uv_opacity": (psp.UV_OPACITY_FIELDS, 7)}


@pytest.mark.parametrize("pack", sorted(FETCHES))
def test_gather_fields_without_and_with_a_graph_give_identical_fields(pack):
    """No graph (grad off, or a table without grad: plain views of the
    block, no ``autograd.Function``) and a graph (one Function) give the
    same fields, bit for bit, with the same shapes and strides."""
    fields, W = FETCHES[pack]
    table, idx = _case(8, 40, W, 333, out_of_range=True)
    ids = torch.tensor(idx)
    plain = psp.gather_fields(torch.tensor(table), ids, fields)
    with torch.no_grad():
        off = psp.gather_fields(torch.tensor(table, requires_grad=True), ids,
                                fields)
    with torch.inference_mode():
        inf = psp.gather_fields(torch.tensor(table), ids, fields)
    graph = psp.gather_fields(torch.tensor(table, requires_grad=True), ids,
                              fields)
    assert all(o.grad_fn is None for o in (*plain, *off, *inf))
    assert all(o.grad_fn is not None for o in graph)
    ref = jsp.gather_fields(jnp.asarray(table), jnp.asarray(idx), fields)
    for a, b, c, d, r in zip(plain, off, inf, graph, ref):
        assert a.shape == b.shape == c.shape == d.shape == r.shape
        assert a.stride() == b.stride() == c.stride() == d.stride()
        for x in (b, c, d):
            assert torch.equal(a, x.detach())
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_bad_field_specs_raise_on_every_call():
    """A checked spec is kept per (fields, width); a bad one is never kept,
    so it raises on every call, also after a good spec of the same width
    was kept."""
    table, idx = (torch.tensor(x) for x in _case(9, 36, 55, 10))
    psp.gather_fields(table, idx, psp.TRI_FIELDS)
    assert (psp.TRI_FIELDS, 55) in psp._PLANS
    bad = (psp.TRI_FIELDS[:-1], (slice(0, 3), slice(4, 55)),
           psp.TRI_FIELDS + (55,), list(psp.TRI_FIELDS[1:]))
    for _ in range(3):
        for fields in bad:
            with pytest.raises(ValueError):
                psp.gather_fields(table, idx, fields)
        with pytest.raises(ValueError):   # a good spec of another width
            psp.gather_fields(table[:, :13].contiguous(), idx,
                              psp.TRI_FIELDS)
        psp.gather_fields(table, idx, list(psp.TRI_FIELDS))
    assert not [k for k in psp._PLANS
                if k[0] in bad or k == (psp.TRI_FIELDS, 13)]


@pytest.mark.parametrize("graph", [False, True])
def test_launch_counters_count_one_per_call(graph):
    """One forward launch per ``gather_fields`` / ``gather_rows_t`` call on
    either path (here the plain version's counter: CPU tensors), one
    backward launch per backward, and nothing on the kernels' counters."""
    table, idx = _case(10, 36, 55, 256, out_of_range=True)
    tab = torch.tensor(table, requires_grad=graph)
    ids = torch.tensor(idx)
    counters = ("gather_rows_t", "gather_rows_t_plain", "gather_rows_t_bwd",
                "gather_rows_t_bwd_plain")

    def launches(moved):
        return [moved.get(k, 0) for k in counters]

    def forward():
        outs = [psp.gather_fields(tab, ids, psp.TRI_FIELDS)
                for _ in range(3)]
        return outs + [(K.gather_rows_t(tab, ids),)]
    outs, moved = obs.counted(forward)
    assert launches(moved) == [0, 4, 0, 0]
    if graph:
        _, back = obs.counted(
            lambda: sum(o[0].sum() for o in outs).backward())
        assert launches(back) == [0, 0, 0, 4]


@pytest.mark.parametrize("W", [1, 7, 9, 13, 55, 226])
def test_fwd_path_follows_the_table_size(W):
    """The largest staged table (its zero row included) at each width, and
    one row more."""
    t_max = K.FWD_STAGE_BYTES // (4 * W) - 1
    assert K.fwd_path(t_max, W) == "staged"
    assert K.fwd_path(1, W) == "staged"
    assert K.fwd_path(t_max + 1, W) == "in place"
    assert K.fwd_path(10 ** 6, W) == "in place"
    assert 4 * (t_max + 2) * W > K.FWD_STAGE_BYTES


def test_fwd_limits_are_the_kernel_source_s():
    import os
    import re
    src = open(os.path.join(os.path.dirname(K.native.__file__), "..", "csrc",
                            "packgather.cu")).read()
    a, b = re.search(r"kStageMaxBytes = (\d+) \* (\d+);", src).groups()
    assert int(a) * int(b) == K.FWD_STAGE_BYTES


def test_params_from_reference_takes_the_card_unless_told():
    """Like ``from_reference``, the parameters go to the card by default;
    the CPU tests name ``device="cpu"``."""
    import inspect
    sig = inspect.signature(bridge.params_from_reference)
    assert sig.parameters["device"].default == "cuda"
    params = {"mat.diffuse": np.ones((2, 3), np.float32)}
    out = bridge.params_from_reference(params, device="cpu")
    assert out["mat.diffuse"].device.type == "cpu"
    np.testing.assert_array_equal(out["mat.diffuse"].numpy(),
                                  params["mat.diffuse"])
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            bridge.params_from_reference(params)


def test_any_table_height():
    """The TPU kernel was capped at 256 rows; the port takes any T."""
    table, idx = _case(1, 588, 55, 2000, out_of_range=True)
    out = K.gather_rows_t(torch.tensor(table), torch.tensor(idx)).numpy()
    ok = (idx >= 0) & (idx < 588)
    np.testing.assert_array_equal(out[:, ok], table[idx[ok]].T)
    assert (out[:, ~ok] == 0).all()


@pytest.mark.parametrize("pack", ["tri", "light", "uv_opacity"])
def test_packs_and_gather_fields_match_jax(pack):
    js = jb.cornell_spheres_scene()
    ps, _ = from_reference(js)
    build = {"tri": "build_tri_pack", "light": "build_light_pack",
             "uv_opacity": "build_uv_opacity_pack"}[pack]
    fields = {"tri": jsp.TRI_FIELDS, "light": jsp.LIGHT_FIELDS,
              "uv_opacity": (slice(0, 2), slice(2, 4), slice(4, 6), 6)}[pack]
    jt = getattr(jsp, build)(js)
    pt = getattr(psp, build)(ps)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    idx = np.random.RandomState(0).randint(0, jt.shape[0], 500).astype(np.int32)
    ref = jsp.gather_fields(jt, jnp.asarray(idx), fields)
    out = psp.gather_fields(pt, torch.tensor(idx), fields)
    assert len(out) == len(ref)
    for a, b in zip(ref, out):
        assert b.shape == a.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_port_field_layout_matches_jax():
    assert psp.TRI_FIELDS == jsp.TRI_FIELDS
    assert psp.LIGHT_FIELDS == jsp.LIGHT_FIELDS
    assert (psp.TRI_PACK_WIDTH, psp.LIGHT_PACK_WIDTH) == (
        jsp.TRI_PACK_WIDTH, jsp.LIGHT_PACK_WIDTH)


def test_cpu_tensors_take_the_plain_version():
    table, idx = _case(2, 36, 55, 64)
    _, moved = obs.counted(
        lambda: K.gather_rows_t(torch.tensor(table), torch.tensor(idx)))
    assert moved == {"gather_rows_t_plain": 1}


def test_wrapper_rejects_bad_inputs():
    table, idx = (torch.tensor(x) for x in _case(3, 36, 55, 64))
    with pytest.raises(TypeError):
        K.gather_rows_t(table, idx.long())
    with pytest.raises(TypeError):
        K.gather_rows_t(table.double(), idx)
    with pytest.raises(ValueError):
        K.gather_rows_t(table.T, idx)
    with pytest.raises(ValueError):
        K.gather_rows_t(table[0], idx)
    cot = torch.zeros((55, 64))
    with pytest.raises(TypeError):
        K.gather_rows_t_bwd(idx.long(), cot, 36)
    with pytest.raises(ValueError):
        K.gather_rows_t_bwd(idx, cot[:, :10], 36)
    with pytest.raises(ValueError):
        K.gather_rows_t_bwd(idx, cot.T.contiguous().T, 36)


# ---- the backward kernel's host-side plan and the skewed id cases ------------

@pytest.mark.parametrize("T,passes", [(1, 1), (2, 1), (36, 1), (255, 1),
                                      (256, 2), (588, 2), (49_970, 2),
                                      (65_535, 2), (65_536, 3),
                                      (999_956, 3)])
def test_bwd_plan_passes_follow_the_bits_of_T(T, passes):
    """The sort keys are 0..T (T: every dropped id), in 8-bit digits."""
    plan = K.bwd_plan(262_144, T, 55)
    assert plan.passes == passes
    assert T < 1 << (8 * passes)
    assert passes == 1 or T >= 1 << (8 * (passes - 1))


@pytest.mark.parametrize("T", [1, 2, 36, 588, 49_970, 999_956])
@pytest.mark.parametrize("N,W", [(262_144, 55), (262_139, 55), (1000, 13),
                                 (0, 7)])
def test_bwd_plan_scratch_does_not_grow_with_T(T, N, W):
    plan = K.bwd_plan(N, T, W)
    assert plan.sort_blocks == -(-N // K.BWD_SORT_TILE)
    assert plan.chunks == -(-N // K.BWD_CHUNK)
    assert plan.scratch_ints == (4 * N + 256 * (plan.sort_blocks + 1)
                                 + plan.chunks)
    assert plan.scratch_doubles == 2 * plan.chunks * W
    assert plan.scratch_bytes == K.bwd_plan(N, 36, W).scratch_bytes
    # O(N W) bytes: under the cotangent's own size plus 17 bytes a lane
    assert plan.scratch_bytes <= 4 * N * W + 17 * N + 8 * 2 * W + 2048
    if N == 262_144 and W == 55:
        assert plan.scratch_bytes < 5 * 2 ** 20


def _skewed_ids(kind, T, N):
    rs = np.random.RandomState(11)
    if kind == "one_row":
        return np.full(N, T // 2, np.int32)
    if kind == "all_out":
        return np.where(rs.uniform(size=N) < 0.5, -1, T + 3).astype(np.int32)
    if kind == "heavy_row0":    # coherent runs, half the lanes on row 0
        runs = np.repeat(rs.randint(0, T, N // 16 + 1), 16)[:N]
        return np.where(rs.uniform(size=N) < 0.5, 0, runs).astype(np.int32)
    if kind == "sorted":
        return np.sort(rs.randint(-1, T + 1, N)).astype(np.int32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["one_row", "all_out", "heavy_row0",
                                  "sorted"])
@pytest.mark.parametrize("T,W,N", [(1, 7, 3001), (2, 13, 4099),
                                   (36, 55, 8191), (49_970, 55, 4001)])
def test_backward_plain_on_skewed_ids(kind, T, W, N):
    """The plain version against an f64 numpy sum. It adds in float32, one
    lane after the other, so a row that collects all 8,191 unit-normal
    cotangents (a partial sum of ~100) is off by up to ~1e-3; the CUDA
    kernel sums in double and is held to rtol 1e-6, atol 1e-5 on the card."""
    idx = _skewed_ids(kind, T, N)
    cot = np.random.RandomState(N).randn(W, N).astype(np.float32)
    ref = np.zeros((T, W), np.float64)
    ok = (idx >= 0) & (idx < T)
    np.add.at(ref, idx[ok], cot.astype(np.float64).T[ok])
    out = K.gather_rows_t_bwd(torch.tensor(idx), torch.tensor(cot), T)
    assert out.shape == (T, W) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=2e-3)
    if kind == "all_out":
        assert not out.any()
    untouched = np.setdiff1d(np.arange(T), idx[ok])
    assert not out.numpy()[untouched].any()


def _ten_gather_tri_pack(g, m):
    """The tri pack as it was built before the material join went through
    the pack-gather: ten torch gathers by ``mat_id``, one per material
    field (a frozen copy; the oracle of the joined build)."""
    mid = g.mat_id.long()

    def col(x):
        return x.to(torch.float32)[:, None]
    return torch.cat([
        g.normal, g.n0, g.n1, g.n2,
        g.uv0, g.uv1, g.uv2,
        col(g.smoothing),
        m.diffuse[mid], m.specular[mid], m.emissive[mid],
        col(m.emissive_intensity[mid]), col(m.roughness[mid]),
        col(m.reflectiveness[mid]), col(m.translucency[mid]),
        col(m.ior[mid]), col(m.mat_type[mid]),
        m.tex_index[mid].to(torch.float32),
        g.tangent, g.bitangent,
        g.v0, g.e1, g.e2,
    ], dim=1)


def _pack_scene(name):
    if name == "mesh3k":
        from pbrpathtracer_tpu_torch.scene.big_scenes import mesh_scene
        return mesh_scene(3000, device="cpu")
    return from_reference(getattr(jb, name)())[0]


@pytest.mark.parametrize("name", ["cornell_box", "cornell_spheres_scene",
                                  "translucent_scene", "mesh3k"])
def test_tri_pack_from_the_material_table_equals_the_ten_gathers(name):
    """The material join as one pack-gather from ``material_table`` gives
    the ten-gather pack bit for bit, and, under one random cotangent, the
    same gradient w.r.t. every material leaf (one plain K3 per build on
    the CPU, each lane added in order as the index backwards add)."""
    import dataclasses
    from pbrpathtracer_tpu_torch.diff.params import MATERIAL_FIELDS
    scene = _pack_scene(name)
    cot = torch.tensor(np.random.RandomState(2).randn(
        scene.geom.num_triangles, psp.TRI_PACK_WIDTH), dtype=torch.float32)
    results = []
    for build in (psp._tri_pack, _ten_gather_tri_pack):
        leaves = {f: getattr(scene.materials, f).clone().requires_grad_()
                  for f in MATERIAL_FIELDS}
        m = dataclasses.replace(scene.materials, **leaves)
        def built():
            pack = build(scene.geom, m)
            return pack, torch.autograd.grad((pack * cot).sum(),
                                             list(leaves.values()))
        (pack, grads), moved = obs.counted(built)
        results.append((pack, grads, moved.get("gather_rows_t_bwd_plain", 0)))
    (pack, grads, k3), (ref_pack, ref_grads, ref_k3) = results
    assert pack.shape == (scene.geom.num_triangles, psp.TRI_PACK_WIDTH)
    assert torch.equal(pack, ref_pack)
    assert torch.equal(pack, psp.build_tri_pack(scene))
    for f, g, r in zip(MATERIAL_FIELDS, grads, ref_grads):
        assert torch.equal(g, r), f
    assert (k3, ref_k3) == (1, 0)


def test_material_table_holds_the_pack_s_material_columns():
    scene = from_reference(jb.cornell_box())[0]
    table = psp.material_table(scene.materials)
    first, last = psp.DIFFUSE.start, psp.TEX_IDX.stop
    assert table.shape == (scene.materials.num_materials, last - first)
    pack = psp.build_tri_pack(scene)
    assert torch.equal(pack[:, first:last],
                       table[scene.geom.mat_id.long()])
