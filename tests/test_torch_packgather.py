"""The plain versions of the port's pack-gather kernels against the JAX
Pallas kernel ``gather_rows_t`` in interpret mode, and ``gather_fields``
against the JAX shading fetch. Forward: exact equality, out-of-range ids
included. Backward: against ``jax.grad`` at rtol 1e-6, atol 1e-5
(tests/test_packgather.py's tolerance: each row sums its cotangents in
float32, in another order than the TPU kernel's matmul)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrpathtracer_tpu.kernels.packgather_pallas import gather_rows_t as j_gather
from pbrpathtracer_tpu.ops import shadepack as jsp
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu_torch.bridge import from_reference
from pbrpathtracer_tpu_torch.kernels import packgather as K
from pbrpathtracer_tpu_torch.ops import shadepack as psp


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
    kernel = K.gather_rows_t_bwd.launches
    plain = K.gather_rows_t_bwd_plain.launches
    K.gather_rows_t(tab, torch.tensor(idx)).sum().backward()
    assert K.gather_rows_t_bwd.launches == kernel
    assert K.gather_rows_t_bwd_plain.launches == plain + 1
    ok = (idx >= 0) & (idx < 36)
    counts = np.bincount(idx[ok], minlength=36).astype(np.float32)
    np.testing.assert_array_equal(tab.grad.numpy(),
                                  np.repeat(counts[:, None], 55, axis=1))


@pytest.mark.parametrize("pack", ["tri", "light"])
def test_gather_fields_backward_matches_jax(pack):
    """The single-concatenate backward against the JAX gather_fields
    gradient, over every field (integer fields included)."""
    rs = np.random.RandomState(5)
    fields = {"tri": jsp.TRI_FIELDS, "light": jsp.LIGHT_FIELDS}[pack]
    W = {"tri": jsp.TRI_PACK_WIDTH, "light": jsp.LIGHT_PACK_WIDTH}[pack]
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
    kernel, plain = K.gather_rows_t.launches, K.gather_rows_t_plain.launches
    K.gather_rows_t(torch.tensor(table), torch.tensor(idx))
    assert K.gather_rows_t.launches == kernel
    assert K.gather_rows_t_plain.launches == plain + 1


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
