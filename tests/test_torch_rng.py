"""PyTorch port: counter-based RNG against the JAX package.

Integers (hashes, scrambles) and the uniforms built from them must match
bit for bit; the warps (which go through sin/cos/sqrt of two different
math libraries) to rtol 1e-5, atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echorenderer_tpu.utils import rng as jrng
from echorenderer_tpu_torch.utils import rng as trng

torch.set_num_threads(1)

N = 4096


def _words(seed, n=N, hi=2**32):
    return np.random.RandomState(seed).randint(0, hi, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


def test_hash_u32_bitwise():
    a, b, c = _words(0), _words(1), _words(2)
    ref = np.asarray(jrng.hash_u32(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), 7))
    got = trng.hash_u32(_t(a), _t(b), _t(c), 7).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_owen_scramble_bitwise():
    bits, key = _words(3), _words(4)
    ref = np.asarray(jrng.owen_scramble(jnp.asarray(bits), jnp.asarray(key)))
    got = trng.owen_scramble(_t(bits), _t(key)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_u32_to_uniform_bitwise():
    bits = _words(5)
    ref = np.asarray(jrng.u32_to_uniform(jnp.asarray(bits)))
    got = trng.u32_to_uniform(_t(bits)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def _streams(seed):
    rs = np.random.RandomState(seed)
    pixel = rs.randint(0, 2**21, N).astype(np.uint32)
    sample = rs.randint(0, 2**16, N).astype(np.uint32)
    dim = rs.randint(0, 300, N).astype(np.uint32)
    run_seed = np.uint32(rs.randint(0, 2**31))
    js = jrng.SampleStream(jnp.asarray(pixel), jnp.asarray(sample), jnp.asarray(run_seed))
    ts = trng.SampleStream(_t(pixel), _t(sample), torch.tensor(int(run_seed)))
    return js, ts, dim


@pytest.mark.parametrize("method", ["next_1d", "next_2d", "white_1d", "white_2d"])
def test_sample_stream_bitwise(method):
    js, ts, dim = _streams(6)
    ref = np.asarray(getattr(js, method)(jnp.asarray(dim)))
    got = getattr(ts, method)(_t(dim)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_sample_stream_constant_dim_bitwise():
    js, ts, _ = _streams(7)
    for dim in (0, 1, 2 + 8 * 3):
        np.testing.assert_array_equal(
            ts.next_2d(dim).numpy().view(np.int32), np.asarray(js.next_2d(dim)).view(np.int32)
        )


@pytest.mark.parametrize(
    "warp",
    ["uniform_sphere", "uniform_hemisphere", "concentric_disk", "cosine_hemisphere",
     "uniform_triangle"],
)
def test_warps_match(warp):
    u = np.random.RandomState(8).uniform(0, 1, (N, 2)).astype(np.float32)
    u[:4] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.9], [0.999, 0.0]]  # the disk's special points
    ref = np.asarray(getattr(jrng, warp)(jnp.asarray(u)))
    got = getattr(trng, warp)(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
