"""Tests for the native C++ host-side signal-chain runtime.

Oracle: ops/numpy_ref.py (itself validated against the reference
semantics) and utils/testsig.py for the AWGN chain maths.
"""

import math

import numpy as np
import pytest

from viterbidecodercpp_jax import COMMON_CODES, get_code
from viterbidecodercpp_jax.codes import DAB_PI_TABLE
from viterbidecodercpp_jax.ops import numpy_ref
from viterbidecodercpp_jax.utils import native

pytestmark = pytest.mark.skipif(
    not native.ensure_built(),   # explicit build opt-in (available() is pure)
    reason="native sigchain library not built")


@pytest.mark.parametrize("code", COMMON_CODES, ids=lambda c: c.name)
def test_encode_bits_matches_numpy(code):
    rng = np.random.RandomState(3)
    data = rng.randint(0, 256, (3, 17), dtype=np.uint8)
    enc = native.NativeEncoder(code.K, code.G)
    got = enc.encode_bits(data)
    for f in range(data.shape[0]):
        expect = numpy_ref.encode_bits(code, numpy_ref.bytes_to_bits(data[f]))
        np.testing.assert_array_equal(got[f], expect)


@pytest.mark.parametrize("terminate", [True, False])
def test_encode_soft_values_and_tail(terminate):
    code = get_code("Voyager")
    rng = np.random.RandomState(4)
    data = rng.randint(0, 256, (2, 9), dtype=np.uint8)
    enc = native.NativeEncoder(code.K, code.G)
    got = enc.encode_soft(data, 127, -127, terminate=terminate)
    for f in range(2):
        expect = numpy_ref.encode_bytes(code, data[f], 127, -127,
                                        terminate=terminate)
        np.testing.assert_array_equal(got[f], expect.astype(np.int16))


def test_encoder_threading_deterministic():
    code = get_code("CDMA 2000")
    data = native.random_bytes(7, 64 * 32).reshape(64, 32)
    one = native.NativeEncoder(code.K, code.G, n_threads=1)
    many = native.NativeEncoder(code.K, code.G, n_threads=8)
    np.testing.assert_array_equal(one.encode_bits(data),
                                  many.encode_bits(data))


def test_encoder_large_k_shift_register_path():
    # K=15 exceeds the byte-LUT bound; exercises the shift-register path.
    code = get_code("Cassini")
    data = native.random_bytes(11, 2 * 8).reshape(2, 8)
    enc = native.NativeEncoder(code.K, code.G)
    got = enc.encode_bits(data)
    for f in range(2):
        expect = numpy_ref.encode_bits(code, numpy_ref.bytes_to_bits(data[f]))
        np.testing.assert_array_equal(got[f], expect)


def test_awgn_quantize_statistics_and_determinism():
    code = get_code("Voyager")
    enc = native.NativeEncoder(code.K, code.G)
    data = native.random_bytes(1, 8 * 256).reshape(8, 256)
    a = enc.encode_awgn_quantize(data, 4.0, 127, -127, seed=5)
    b = enc.encode_awgn_quantize(data, 4.0, 127, -127, seed=5)
    np.testing.assert_array_equal(a, b)  # same seed -> identical
    c = enc.encode_awgn_quantize(data, 4.0, 127, -127, seed=6)
    assert (a != c).any()

    # Statistical sanity: the +1-bit symbol population must match a NumPy
    # Monte-Carlo of the same clipped/quantised chain (different RNG, so
    # compare moments, not samples).
    clean = enc.encode_bits(data)
    EsNo = 4.0 - 10 * math.log10(code.R)
    var = 10 ** (-(EsNo + 3) / 10)
    scale = 127.0 / math.sqrt(1 + var)
    mc = (1.0 + np.random.RandomState(0).normal(
        0.0, math.sqrt(var), 200_000)) * scale
    mc = np.clip(np.where(mc >= 0, np.floor(mc + 0.5), np.ceil(mc - 0.5)),
                 -127, 127)
    ones = a[clean == 1].astype(np.float64)
    assert abs(ones.mean() - mc.mean()) < 1.0
    assert abs(ones.std() - mc.std()) < 1.0


def test_awgn_noiseless_limit_roundtrip():
    # At very high Eb/No the chain must decode error-free end to end.
    import viterbidecodercpp_jax as vt

    code = get_code("Voyager")
    config = vt.get_decode_config(vt.DecodeType.SOFT16, code.R)
    enc = native.NativeEncoder(code.K, code.G)
    data = native.random_bytes(2, 4 * 32).reshape(4, 32)
    syms = enc.encode_awgn_quantize(data, 60.0, config.soft_decision_high,
                                    config.soft_decision_low, seed=1)
    dec = vt.ViterbiDecoder(code, config, backend="xla")
    bits, _, _ = dec.decode(syms.astype(np.int32), total_bits=32 * 8)
    got = np.packbits(np.asarray(bits), axis=-1, bitorder="big")
    np.testing.assert_array_equal(got, data)


def test_puncture_depuncture_roundtrip():
    rng = np.random.RandomState(9)
    pi = DAB_PI_TABLE[15]  # PI_16
    total = pi.period * 6
    mask = pi.mask(total).astype(np.uint8)
    syms = rng.randint(-127, 128, total).astype(np.int16)
    kept = native.puncture(syms, mask)
    assert kept.size == int(mask.sum())
    np.testing.assert_array_equal(kept, syms[mask.astype(bool)])
    full = native.depuncture(kept, mask, neutral=0)
    np.testing.assert_array_equal(full[mask.astype(bool)], kept)
    assert (full[~mask.astype(bool)] == 0).all()


def test_count_bit_errors():
    rng = np.random.RandomState(2)
    a = rng.randint(0, 256, 1001, dtype=np.uint8)
    b = a.copy()
    b[13] ^= 0b1010_0000
    b[999] ^= 0xFF
    assert native.count_bit_errors_bytes(a, b) == 10
    bits_a = np.unpackbits(a)
    bits_b = np.unpackbits(b)
    assert native.count_bit_errors_bits(bits_a, bits_b) == 10


def test_random_bytes_deterministic():
    x = native.random_bytes(42, 100)
    y = native.random_bytes(42, 100)
    z = native.random_bytes(43, 100)
    np.testing.assert_array_equal(x, y)
    assert (x != z).any()


def test_measure_point_host_chain_noiseless_limit():
    """The native host-chain BER path must report zero errors at very
    high Eb/No (exact decode through the C++ channel chain)."""
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax import ber

    code = vt.get_code("Voyager")
    config = vt.get_decode_config(vt.DecodeType.SOFT16, code.R)
    p = ber.measure_point_host_chain(code, config, 40.0, seed=1,
                                     block_bits=256, batch=4,
                                     max_bits=2048)
    assert p.total_bit_errors == 0
    assert p.total_bits >= 2048
