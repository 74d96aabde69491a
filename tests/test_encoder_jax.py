"""Batched JAX encoder and depuncture vs the NumPy oracle."""

import numpy as np
import jax.numpy as jnp

from viterbidecodercpp_jax import DAB_PI_TABLE, get_code
from viterbidecodercpp_jax.ops import encoder as enc
from viterbidecodercpp_jax.ops import numpy_ref as ref


def test_encode_bits_matches_oracle():
    code = get_code("LTE")
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2, (3, 40), dtype=np.uint8)
    out = np.asarray(enc.encode_bits_jax(code, jnp.asarray(bits), True))
    for b in range(3):
        expect = ref.encode_bits(code, bits[b], terminate=True)
        np.testing.assert_array_equal(out[b].reshape(-1), expect)


def test_encode_symbols():
    code = get_code("Voyager")
    bits = np.array([[1, 0, 1, 1]], dtype=np.uint8)
    syms = np.asarray(enc.encode_symbols_jax(code, jnp.asarray(bits), 127, -127, False))
    expect = ref.encode_bits(code, bits[0], terminate=False)
    np.testing.assert_array_equal(
        syms[0].reshape(-1), np.where(expect.astype(bool), 127, -127))


def test_byte_bit_packing_jax():
    data = np.array([[0b10110001, 0xFF, 0x00]], dtype=np.uint8)
    bits = np.asarray(enc.bytes_to_bits_jax(jnp.asarray(data)))
    np.testing.assert_array_equal(bits[0], ref.bytes_to_bits(data[0]))
    back = np.asarray(enc.bits_to_bytes_jax(jnp.asarray(bits)))
    np.testing.assert_array_equal(back, data)


def test_depuncture_inverts_puncture():
    pi = DAB_PI_TABLE[15]  # PI_16
    total = 32 * 4
    mask = pi.mask(total)
    full = np.arange(1, total + 1, dtype=np.int32)[None, :]
    punctured = full[:, mask]
    out = np.asarray(enc.depuncture(jnp.asarray(punctured), mask, 0))
    np.testing.assert_array_equal(out[0][mask], full[0][mask])
    assert (out[0][~mask] == 0).all()


def test_byte_stream_encoder_matches_bulk():
    """consume_byte parity with the bulk encoders: the reference ABC
    emits R bytes per input byte, encoded bits packed LSB-first in
    t*R + j stream order (convolutional_encoder_shift_register.h:40-62).
    """
    from viterbidecodercpp_jax import get_code
    code = get_code("Voyager")
    rng = np.random.RandomState(2)
    data = rng.randint(0, 256, 16, dtype=np.uint8)
    se = enc.ByteStreamEncoder(code)
    out = se.consume_bytes(data)                 # (16, R)
    stream_bits = np.unpackbits(out.reshape(-1), bitorder="little")
    bulk = ref.encode_bits(code, ref.bytes_to_bits(data), terminate=False)
    np.testing.assert_array_equal(stream_bits, bulk)
    # reset() restarts the register: re-encoding gives identical output
    se.reset()
    np.testing.assert_array_equal(se.consume_byte(data[0]), out[0])
