"""Oracle self-consistency: noiseless roundtrips through the NumPy spec.

Mirrors the reference's run_tests matrix oracle: Viterbi on a noiseless,
tail-terminated stream must invert the encoder exactly
(run_tests.cpp:129-142).
"""

import numpy as np
import pytest

from viterbidecodercpp_jax import COMMON_CODES, DecodeType, get_code, get_decode_config
from viterbidecodercpp_jax.ops import numpy_ref as ref


def roundtrip(code, config, nbytes, seed=0):
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 256, nbytes, dtype=np.uint8)
    syms = ref.encode_bytes(code, data, config.soft_decision_high,
                            config.soft_decision_low)
    bits, err, acc = ref.viterbi_decode(code, config, syms, nbytes * 8)
    out = ref.bits_to_bytes(bits)
    return data, out, err


def test_encoder_k3_golden():
    # K=3 G={7,5}, input bits 1,0,1 (byte 0xA0 trimmed):
    # reg: 1 -> y=(p(7&1),p(5&1))=(1,1); 10 -> (p(0b010&7)=1, p(0b000)=0);
    # 101 -> (p(0b101&7)=p(5)=0? parity(101)=0b101 has two ones -> 0, p(0b101&5)=p(5)=0)
    code = get_code(0)
    bits = np.array([1, 0, 1], dtype=np.uint8)
    out = ref.encode_bits(code, bits, terminate=False)
    assert out.tolist() == [1, 1, 1, 0, 0, 0]


def test_encoder_termination_returns_to_zero():
    code = get_code("Voyager")
    bits = np.array([1, 1, 0, 1, 0, 0, 1, 0], dtype=np.uint8)
    out = ref.encode_bits(code, bits, terminate=True)
    assert out.size == (bits.size + code.K - 1) * code.R


def test_bit_packing_msb_first():
    data = np.array([0b10110001], dtype=np.uint8)
    bits = ref.bytes_to_bits(data)
    assert bits.tolist() == [1, 0, 1, 1, 0, 0, 0, 1]
    assert ref.bits_to_bytes(bits)[0] == data[0]


@pytest.mark.parametrize("code_idx", range(8))
@pytest.mark.parametrize("decode_type", [DecodeType.SOFT16, DecodeType.SOFT8,
                                         DecodeType.HARD8])
def test_noiseless_roundtrip_saturating(code_idx, decode_type):
    code = COMMON_CODES[code_idx]
    config = get_decode_config(decode_type, code.R)
    nbytes = 4 if code.K >= 15 else 16
    data, out, err = roundtrip(code, config, nbytes)
    np.testing.assert_array_equal(data, out)


@pytest.mark.parametrize("code_idx", [0, 2, 4])
def test_noiseless_roundtrip_wrapping(code_idx):
    # Scalar-kernel semantics; SOFT8 K=15 R=6 is the reference's known
    # overflow skip (run_tests.cpp:63-65) and is excluded here too.
    code = COMMON_CODES[code_idx]
    config = get_decode_config(DecodeType.SOFT16, code.R, arith="wrapping")
    data, out, err = roundtrip(code, config, 16)
    np.testing.assert_array_equal(data, out)


def test_noisy_roundtrip_corrects_errors():
    # Voyager SOFT16 with mild symbol noise should still decode exactly.
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, 32, dtype=np.uint8)
    syms = ref.encode_bytes(code, data, 127, -127).astype(np.int64)
    noise = rng.randint(-40, 41, syms.shape)
    syms = np.clip(syms + noise, -127, 127)
    bits, _, _ = ref.viterbi_decode(code, config, syms, data.size * 8)
    np.testing.assert_array_equal(ref.bits_to_bytes(bits), data)


def test_incremental_update_equivalence():
    # Chunked ACS must equal one-shot ACS (the streaming contract,
    # run_punctured_decoder.cpp:258-282).
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    rng = np.random.RandomState(2)
    data = rng.randint(0, 256, 8, dtype=np.uint8)
    syms = ref.encode_bytes(code, data, 127, -127)
    m1, d1, a1 = ref.acs_run(code, config, syms)
    # split into chunks of R symbols
    R = code.R
    metrics = None
    decs = []
    acc = 0
    m = None
    for i in range(0, syms.size, R * 5):
        chunk = syms[i:i + R * 5]
        m, d, a = ref.acs_run(code, config, chunk, initial_metrics=m)
        decs.append(d)
        acc += a
    np.testing.assert_array_equal(m, m1)
    np.testing.assert_array_equal(np.concatenate(decs), d1)
    assert acc == a1
