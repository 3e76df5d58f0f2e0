"""The port's Threefry draws against ``jax.random``.

``repro_torch._threefry`` computes ``jax.random``'s bits with torch integer
ops (JAX's default ``jax_threefry_partitionable`` layout): uniforms are
compared bit for bit over seeds, shapes, ranges and float types;
categorical draws over keys and logits in f32 and bf16 are compared index
for index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import _threefry as tf

DTYPES = {"float32": (jnp.float32, torch.float32, np.uint32, torch.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16, torch.int16),
          "float16": (jnp.float16, torch.float16, np.uint16, torch.int16)}
SEEDS = [0, 1, 42, -1, -7, 2**31 - 1]


def _bits(jax_array, np_word):
    return np.asarray(jax_array).view(np_word)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1,), (3,), (8, 20), (2, 3, 7), (1000,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_exact(seed, shape, dtype):
    jd, td, np_word, t_word = DTYPES[dtype]
    want = _bits(jax.random.uniform(jax.random.key(seed), shape, jd), np_word)
    got = tf.uniform(seed, shape, td).view(t_word).numpy().view(np_word)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lo,hi", [(-2.0, 3.0), (0.3, 0.7), (-1e3, 7.5), ("tiny", 1.0)])
def test_uniform_range_bit_exact(lo, hi, dtype):
    """The scale and shift round as XLA rounds them (one fused multiply-add
    in f32 and f16, two roundings in bf16)."""
    jd, td, np_word, t_word = DTYPES[dtype]
    lo = float(torch.finfo(td).tiny) if lo == "tiny" else lo
    for seed in range(8):
        want = _bits(jax.random.uniform(jax.random.key(seed), (9, 31), jd, lo, hi), np_word)
        got = tf.uniform(seed, (9, 31), td, lo, hi).view(t_word).numpy().view(np_word)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_random_bits_equal_jax_bits(bits):
    dtype = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}[bits]
    for seed in (0, 3, -5):
        want = np.asarray(jax.random.bits(jax.random.key(seed), (4, 33), dtype))
        np.testing.assert_array_equal(tf.random_bits(seed, (4, 33), bits=bits).numpy(), want)


def test_key_words_equal_jax():
    for seed in SEEDS:
        assert tf.key(seed) == tuple(int(w) for w in jax.random.key_data(jax.random.key(seed)))
    with pytest.raises(ValueError, match="int32"):
        tf.key(2**31)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab,scale", [(10, 1.0), (1000, 3.0), (4099, 0.3)])
def test_categorical_equals_jax(vocab, scale, dtype):
    jd, td, _, _ = DTYPES[dtype]
    rng = np.random.default_rng(vocab)
    for key in range(12):
        logits = (scale * rng.normal(size=(8, vocab))).astype(np.float32)
        want = np.asarray(jax.random.categorical(jax.random.key(key), jnp.asarray(logits, jd)))
        got = tf.categorical(key, torch.tensor(logits).to(td))
        np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_padded_vocabulary_never_drawn():
    """Padded vocabulary entries (logit -1e30, as the models pad) are never drawn."""
    logits = torch.zeros((4, 64))
    logits[:, 50:] = -1e30
    for key in range(20):
        assert int(tf.categorical(key, logits).max()) < 50


def test_uniform_on_the_data_device_and_type():
    u = tf.uniform(3, (5, 2), torch.bfloat16, device="cpu")
    assert u.dtype == torch.bfloat16 and u.device.type == "cpu" and u.shape == (5, 2)
    with pytest.raises(TypeError, match="float32"):
        tf.uniform(3, (2,), torch.float64)
