"""JAX XLA path vs the NumPy oracle, plus the public ViterbiDecoder API."""

import numpy as np
import pytest

from viterbidecodercpp_jax import (
    COMMON_CODES,
    DecodeType,
    ViterbiDecoder,
    get_code,
    get_decode_config,
)
from viterbidecodercpp_jax.ops import jax_core, numpy_ref as ref


def make_batch(code, config, nbytes, batch, seed=0, noise=0):
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 256, (batch, nbytes), dtype=np.uint8)
    syms = np.stack([
        ref.encode_bytes(code, d, config.soft_decision_high,
                         config.soft_decision_low) for d in data
    ]).astype(np.int64)
    if noise:
        syms = np.clip(syms + rng.randint(-noise, noise + 1, syms.shape),
                       config.soft_decision_low, config.soft_decision_high)
    return data, syms


@pytest.mark.parametrize("code_idx", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("decode_type", [DecodeType.SOFT16, DecodeType.SOFT8,
                                         DecodeType.HARD8])
def test_acs_matches_oracle(code_idx, decode_type):
    code = COMMON_CODES[code_idx]
    config = get_decode_config(decode_type, code.R)
    spec = jax_core.make_static_spec(code, config)
    data, syms = make_batch(code, config, 6, batch=3, noise=1)
    B = syms.shape[0]
    T = syms.shape[1] // code.R

    m0 = jax_core.initial_metrics(spec, B)
    metrics, packed, acc = jax_core.acs_scan(
        spec, m0, syms.reshape(B, T, code.R))
    metrics = np.asarray(metrics)       # (S, B)
    packed = np.asarray(packed)         # (T, W, B)
    acc = np.asarray(acc)

    for b in range(B):
        em, ed, ea = ref.acs_run(code, config, syms[b])
        np.testing.assert_array_equal(metrics[:, b], em, err_msg=f"frame {b}")
        assert acc[b] == ea
        # unpack packed decisions and compare
        got = np.zeros((T, spec.S), np.uint8)
        for w in range(spec.W):
            width = min(32, spec.S)
            for i in range(width):
                got[:, w * 32 + i] = (packed[:, w, b] >> i) & 1
        np.testing.assert_array_equal(got, ed, err_msg=f"frame {b}")


@pytest.mark.parametrize("code_idx", [0, 2, 4, 6])
def test_chainback_matches_oracle(code_idx):
    code = COMMON_CODES[code_idx]
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    data, syms = make_batch(code, config, 8, batch=2, noise=20)
    B = syms.shape[0]
    T = syms.shape[1] // code.R
    total_bits = 8 * 8

    m0 = jax_core.initial_metrics(spec, B)
    _, packed, _ = jax_core.acs_scan(spec, m0, syms.reshape(B, T, code.R))
    import jax.numpy as jnp
    bits = np.asarray(jax_core.chainback_scan(
        spec, packed, jnp.zeros(B, jnp.int32), total_bits))

    for b in range(B):
        _, ed, _ = ref.acs_run(code, config, syms[b])
        expect = ref.traceback(code, ed, total_bits, 0)
        np.testing.assert_array_equal(bits[b], expect, err_msg=f"frame {b}")


@pytest.mark.parametrize("decode_type", [DecodeType.SOFT16, DecodeType.SOFT8,
                                         DecodeType.HARD8])
def test_decoder_api_roundtrip(decode_type):
    code = get_code("Voyager")
    dec = ViterbiDecoder(code, decode_type, backend="xla")
    config = dec.config
    data, syms = make_batch(code, config, 16, batch=4, noise=0)
    bits, err, acc = dec.decode(syms, 16 * 8)
    out = np.packbits(np.asarray(bits), axis=-1, bitorder="big")
    np.testing.assert_array_equal(out, data)
    assert np.asarray(err).shape == (4,)


def test_decoder_incremental_update():
    code = get_code("DAB Radio")
    dec = ViterbiDecoder(code, DecodeType.SOFT16, backend="xla",
                         traceback_length=8 * 8)
    config = dec.config
    data, syms = make_batch(code, config, 8, batch=2, noise=0)
    state = dec.reset(2)
    # feed R symbols at a time (one decoded bit per call), like the
    # depuncture loop (helpers/puncture_code_helpers.h:51)
    step = code.R
    for i in range(0, syms.shape[1], step * 4):
        state = dec.update(state, syms[:, i:i + step * 4])
    out = dec.chainback_bytes(state, 8 * 8)
    np.testing.assert_array_equal(out, data)


def test_cassini_k15_roundtrip_xla():
    code = get_code("Cassini")
    dec = ViterbiDecoder(code, DecodeType.SOFT16, backend="xla")
    data, syms = make_batch(code, dec.config, 2, batch=1)
    bits, _, _ = dec.decode(syms, 2 * 8)
    out = np.packbits(np.asarray(bits), axis=-1, bitorder="big")
    np.testing.assert_array_equal(out, data)


def test_decoder_state_checkpoint_resume(tmp_path):
    """Save the carry mid-stream, restore in a 'new process', finish the
    decode - the explicit checkpoint/resume capability (SURVEY.md
    section 5)."""
    from viterbidecodercpp_jax.decoder import DecoderState

    code = get_code("Voyager")
    dec = ViterbiDecoder(code, DecodeType.SOFT16, backend="xla",
                         traceback_length=16 * 8)
    data, syms = make_batch(code, dec.config, 16, batch=2, noise=8)
    half = (syms.shape[1] // (2 * code.R)) * code.R

    state = dec.reset(2)
    state = dec.update(state, syms[:, :half])
    ckpt = str(tmp_path / "carry.npz")
    state.save(ckpt)

    resumed = DecoderState.load(ckpt)
    assert resumed.batch == 2
    resumed = dec.update(resumed, syms[:, half:])
    out = dec.chainback_bytes(resumed, 16 * 8)
    np.testing.assert_array_equal(out, data)

    # and the uninterrupted decode agrees
    whole = dec.reset(2)
    whole = dec.update(whole, syms)
    np.testing.assert_array_equal(dec.chainback_bytes(whole, 16 * 8), out)


@pytest.mark.parametrize("unroll", [2, 4])
def test_acs_scan_multi_bit_exact(unroll):
    """The fused multi-step scan (HBM-traffic optimisation for K=15-class
    codes) must match acs_scan bit-for-bit, renorm timing included."""
    import jax.numpy as jnp

    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT8, code.R)
    spec = jax_core.make_static_spec(code, config)
    rng = np.random.RandomState(11)
    T = 48
    syms = jnp.asarray(rng.randint(-3, 4, (3, T, code.R)), jnp.int32)
    m0 = jax_core.initial_metrics(spec, 3)
    a = jax_core.acs_scan(spec, m0, syms)
    b = jax_core.acs_scan_multi(spec, m0, syms, unroll)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # ragged T: internal pad+mask must leave the carry untouched
    a2 = jax_core.acs_scan(spec, m0, syms[:, :T - 1])
    b2 = jax_core.acs_scan_multi(spec, m0, syms[:, :T - 1], unroll)
    for x, y in zip(a2, b2):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_cassini_chainback_xla_k14_k15():
    """The plain XLA traceback at W=256/512 words per row (K=14, K=15),
    noisy frames, against the oracle's traceback."""
    import jax.numpy as jnp

    from viterbidecodercpp_jax import CodeSpec

    for code in (CodeSpec("K14", 14, (0o25621, 0o33527)),
                 get_code("Cassini")):
        config = get_decode_config(DecodeType.SOFT16, code.R)
        spec = jax_core.make_static_spec(code, config)
        data, syms = make_batch(code, config, 2, batch=2, noise=60)
        T = syms.shape[1] // code.R
        m0 = jax_core.initial_metrics(spec, 2)
        _, packed, _ = jax_core.acs_scan(
            spec, m0, jnp.asarray(syms.reshape(2, T, code.R)))
        bits = np.asarray(jax_core.chainback_scan(
            spec, packed, jnp.zeros(2, jnp.int32), 16))
        for b in range(2):
            _, ed, _ = ref.acs_run(code, config, syms[b])
            np.testing.assert_array_equal(bits[b], ref.traceback(code, ed, 16))


@pytest.mark.parametrize("name,dt,arith", [
    ("Basic K=5 R=1/2", DecodeType.SOFT16, "saturating"),
    ("Voyager", DecodeType.SOFT8, "saturating"),
    ("Voyager", DecodeType.SOFT16, "wrapping"),
    ("Cassini", DecodeType.SOFT16, "saturating"),
])
def test_rotated_layout_bit_exact(name, dt, arith):
    """ops/bigstate rotated-layout ACS + traceback vs the standard scan
    (metrics, renorm accumulator, and decoded bits all bit-identical)."""
    import jax.numpy as jnp

    from viterbidecodercpp_jax.ops import bigstate

    code = get_code(name)
    config = get_decode_config(dt, code.R, arith=arith)
    spec = jax_core.make_static_spec(code, config)
    nbytes = 4 if code.K >= 15 else 10
    data, syms = make_batch(code, config, nbytes, batch=2, noise=2)
    sj = jnp.asarray(syms.reshape(2, -1, code.R))
    m0 = jax_core.initial_metrics(spec, 2)
    em, ep, ea = jax_core.acs_scan(spec, m0, sj)
    ends = jnp.zeros(2, jnp.int32)
    eb = jax_core.chainback_scan(spec, ep, ends, nbytes * 8)
    rb, rm, _, ra = bigstate.decode_big(spec, m0, sj, ends, nbytes * 8)
    np.testing.assert_array_equal(np.asarray(em), np.asarray(rm))
    np.testing.assert_array_equal(np.asarray(ea), np.asarray(ra))
    np.testing.assert_array_equal(np.asarray(eb), np.asarray(rb))


def test_update_capacity_overflow_raises():
    """Writing past the decision buffer must raise, not silently clamp
    (mirror of the reference's capacity assert)."""
    code = get_code("Voyager")
    dec = ViterbiDecoder(code, DecodeType.SOFT16, backend="xla",
                         traceback_length=16)
    state = dec.reset(1)
    syms = np.zeros((1, 16 * code.R), np.int32)
    state = dec.update(state, syms)  # fills 16 of 16+K-1 rows
    with pytest.raises(ValueError, match="overflow"):
        dec.update(state, np.zeros((1, 8 * code.R), np.int32))
