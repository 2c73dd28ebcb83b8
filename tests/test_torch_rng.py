"""The port's keyed pcg4d RNG is bit-equal to ``pbrpathtracer_tpu.ops.rng``:
the port carries the 32-bit words in int64, and must wrap exactly as uint32
does, including for keys near 2**32 - 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrpathtracer_tpu.ops import rng as jrng
from pbrpathtracer_tpu_torch.ops import rng as prng

U32_MAX = 2 ** 32 - 1


def _bits(x):
    return np.asarray(x).astype(np.float32).view(np.uint32)


def _keys(rs, n):
    """Random uint32 keys, a quarter of them within 1000 of 2**32 - 1."""
    k = rs.randint(0, U32_MAX, n, dtype=np.int64)
    near = rs.uniform(size=n) < 0.25
    k[near] = U32_MAX - rs.randint(0, 1000, int(near.sum()))
    return k


@pytest.mark.parametrize("seed,sample,stream,group", [
    (0, 0, 0, 0), (7, 3, 1, 1), (123, 15, 9, 3),
    (U32_MAX, U32_MAX, U32_MAX, 3), (2 ** 31, 2 ** 31 + 5, 2 ** 27 - 1, 2)])
def test_rand_slots4_bit_equal_scalar_keys(seed, sample, stream, group):
    rs = np.random.RandomState(seed % 1000)
    pixel = _keys(rs, 4096)
    j = jrng.rand_slots4(jnp.uint32(seed), jnp.asarray(pixel, jnp.uint32),
                         jnp.uint32(sample), jnp.uint32(stream),
                         jnp.uint32(group))
    p = prng.rand_slots4(seed, torch.tensor(pixel), sample, stream, group)
    for a, b in zip(j, p):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))


def test_rand_slots4_bit_equal_per_lane_keys():
    rs = np.random.RandomState(1)
    n = 8192
    seed, pixel, sample = _keys(rs, n), _keys(rs, n), _keys(rs, n)
    stream = rs.randint(0, 2 ** 27, n)
    group = rs.randint(0, 8, n)
    j = jrng.rand_slots4(*(jnp.asarray(x, jnp.uint32)
                           for x in (seed, pixel, sample, stream, group)))
    p = prng.rand_slots4(*(torch.tensor(x)
                           for x in (seed, pixel, sample, stream, group)))
    for a, b in zip(j, p):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))


def test_pcg4d_words_bit_equal():
    rs = np.random.RandomState(2)
    words = [_keys(rs, 4096) for _ in range(4)]
    j = jrng.pcg4d(*(jnp.asarray(w, jnp.uint32) for w in words))
    p = prng.pcg4d(*(torch.tensor(w) for w in words))
    for a, b in zip(j, p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("slot", range(20))
def test_rand_slot_every_layout_slot(slot):
    pixel = np.arange(0, 4096 * 97, 97, dtype=np.int32)
    j = jrng.rand_slot(jnp.uint32(5), jnp.asarray(pixel), jnp.uint32(2),
                       jnp.uint32(jrng.bounce_stream(3)), slot)
    p = prng.rand_slot(5, torch.tensor(pixel), 2, prng.bounce_stream(3), slot)
    np.testing.assert_array_equal(_bits(p.numpy()), _bits(j))
    assert float(p.min()) >= 0.0 and float(p.max()) < 1.0


def test_slot_layout_matches():
    names = [n for n in dir(jrng) if n.startswith(("SLOT", "STREAM", "MAX_"))]
    assert names
    for n in names:
        assert getattr(prng, n) == getattr(jrng, n), n
