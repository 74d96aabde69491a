"""Signal-chain helpers (utils/testsig.py) vs reference semantics.

The AWGN quantisation chain is additionally cross-checked against the
native C++ implementation in test_native.py and against the reference
binary's own BER output in test_ber.py; here we pin the maths and the
simple integer-noise helpers (test_helpers.h:66-93)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from viterbidecodercpp_jax import DecodeType, get_code, get_decode_config
from viterbidecodercpp_jax.utils import testsig


def test_awgn_sigma_math():
    # run_snr_ber.cpp:319-322 for Voyager R=2 at 4 dB.
    sigma = testsig.awgn_sigma(4.0, 2)
    EsNo = 4.0 - 10 * math.log10(2)
    assert sigma == pytest.approx(math.sqrt(10 ** (-(EsNo + 3) / 10)))


def test_round_half_away_from_zero():
    x = jnp.asarray([-1.5, -0.5, 0.5, 1.5, 2.5])
    got = np.asarray(testsig.round_half_away(x))
    # std::round semantics, NOT numpy's half-to-even
    np.testing.assert_array_equal(got, [-2.0, -1.0, 1.0, 2.0, 3.0])


def test_awgn_quantize_noiseless_limit():
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    bits = jnp.asarray(np.random.RandomState(0).randint(0, 2, (2, 32)),
                       jnp.uint8)
    floats = testsig.modulate_encode(code, bits, True)
    q = testsig.awgn_quantize(floats, jax.random.PRNGKey(0), 80.0,
                              code.R, config)
    # at 80 dB the quantiser must hit the rails exactly
    np.testing.assert_array_equal(
        np.asarray(q), np.where(np.asarray(floats) > 0, 127, -127))


def test_add_noise_bounds_and_clamp():
    key = jax.random.PRNGKey(1)
    syms = jnp.full((4, 100), 100, jnp.int32)
    noisy = testsig.add_noise(syms, key, 30)
    d = np.asarray(noisy) - 100
    assert d.min() >= -30 and d.max() <= 30
    assert d.std() > 5  # actually noisy
    clamped = testsig.clamp_vector(noisy, -127, 127)
    assert np.asarray(clamped).max() <= 127


def test_add_binary_noise_flip_rate():
    key = jax.random.PRNGKey(2)
    syms = jnp.full((1, 20000), 1, jnp.int32)
    flipped = testsig.add_binary_noise(syms, key, 0.25, -1, 1)
    rate = float((np.asarray(flipped) == -1).mean())
    assert abs(rate - 0.25) < 0.02
    untouched = testsig.add_binary_noise(syms, key, 0.0, -1, 1)
    np.testing.assert_array_equal(np.asarray(untouched), np.asarray(syms))
