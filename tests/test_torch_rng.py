"""Parity of the PyTorch port's RNG and vector math with the JAX package.

The RNG streams decide every jitter, Russian-roulette branch and
hemisphere sample, so they must match bit for bit (CLAUDE.md).  Inputs
are made with numpy from a fixed seed and fed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinginonesemester_tpu.core import rng as jrng
from raytracinginonesemester_tpu.core import vecmath as jvm
from raytracinginonesemester_tpu_torch.core import rng as trng
from raytracinginonesemester_tpu_torch.core import vecmath as tvm

from _torch_parity import one_torch_thread, ulp_close


def _seeds(n=4096, seed=0):
    rs = np.random.RandomState(seed)
    s = rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    # the edges of the uint32 range and the int32 sign boundary
    s[:6] = [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    return s


def _t(u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u32.astype(np.int64))


def test_wang_hash_float_bit_exact():
    s = _seeds()
    want = np.asarray(jrng.wang_hash_float(jnp.asarray(s)))
    got = trng.wang_hash_float(_t(s)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_rng_next_chain_bit_exact():
    """Eight chained draws: every state and every float identical."""
    js = jnp.asarray(_seeds(seed=1))
    ts = _t(_seeds(seed=1))
    for _ in range(8):
        js, jf = jrng.rng_next(js)
        ts, tf = trng.rng_next(ts)
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                      np.asarray(js))
        np.testing.assert_array_equal(tf.numpy().view(np.uint32),
                                      np.asarray(jf).view(np.uint32))


@pytest.mark.parametrize("sample", [0, 1, 7, 2**31 + 5])
def test_seed_and_pixel_jitter_bit_exact(sample):
    rs = np.random.RandomState(2)
    x = rs.randint(0, 4096, size=2048).astype(np.int32)
    y = rs.randint(0, 4096, size=2048).astype(np.int32)
    s = np.uint32(sample)
    want = np.asarray(jrng.make_rng_seed(jnp.asarray(x), jnp.asarray(y), s))
    got = trng.make_rng_seed(torch.from_numpy(x), torch.from_numpy(y),
                             int(s)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    jx, jy = jrng.pixel_jitter(jnp.asarray(x), jnp.asarray(y), s)
    tx, ty = trng.pixel_jitter(torch.from_numpy(x), torch.from_numpy(y), int(s))
    np.testing.assert_array_equal(tx.numpy().view(np.uint32),
                                  np.asarray(jx).view(np.uint32))
    np.testing.assert_array_equal(ty.numpy().view(np.uint32),
                                  np.asarray(jy).view(np.uint32))


def test_random_unit_vector_stream_exact():
    """The rejection sampler consumes the same stream per element (states
    bit-exact); the unit vectors agree to 2 ulp (the JAX side scales by
    XLA's rsqrt, the port by 1/sqrt, which may round differently)."""
    s = _seeds(n=2048, seed=3)
    js, jv = jrng.random_unit_vector(jnp.asarray(s))
    ts, tv = trng.random_unit_vector(_t(s))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    assert ulp_close(tv.numpy(), np.asarray(jv), ulps=2, atol=0.0).all()


def test_i32_round_trip():
    s = _seeds(seed=4)
    as_i32 = s.view(np.int32)
    t = trng.to_u32(torch.from_numpy(as_i32))
    np.testing.assert_array_equal(t.numpy().astype(np.uint32), s)
    np.testing.assert_array_equal(trng.to_i32(t).numpy(), as_i32)


def test_vecmath_matches():
    rs = np.random.RandomState(5)
    a = rs.standard_normal((512, 3)).astype(np.float32)
    b = rs.standard_normal((512, 3)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [
        (jvm.dot3(ja, jb), tvm.dot3(ta, tb)),
        (jvm.cross3(ja, jb), tvm.cross3(ta, tb)),
        (jvm.length(ja), tvm.length(ta)),
        (jvm.normalize(ja), tvm.normalize(ta)),
        (jvm.reflect(ja, jvm.normalize(jb)), tvm.reflect(ta, tvm.normalize(tb))),
    ]
    # sums of 3 products: XLA may fuse them into FMAs, so a few ulp
    for want, got in pairs:
        assert ulp_close(got.numpy(), np.asarray(want), ulps=4, atol=1e-6).all()
