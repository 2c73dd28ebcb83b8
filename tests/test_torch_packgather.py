"""The plain version of the port's pack-gather kernel against the JAX Pallas
kernel ``gather_rows_t`` in interpret mode, and ``gather_fields`` against the
JAX shading fetch: exact equality, out-of-range ids included."""

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
