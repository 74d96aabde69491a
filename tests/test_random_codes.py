"""Property tests: random valid (K, G) codes beyond the 8-code registry.

The reference supports any K >= 2, rate 1/n with the butterfly
constraints g_0 = g_{K-1} = 1 (README.md:13, codes.py validation); the
framework must round-trip and stay oracle-exact for arbitrary such
codes, not just the canonical ones.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from viterbidecodercpp_jax import (CodeSpec, DecodeType, ViterbiDecoder,
                                   get_decode_config)
from viterbidecodercpp_jax.ops import jax_core, numpy_ref as ref


def random_code(rng, K, R):
    """Random polynomials with the butterfly-required taps set."""
    G = []
    while len(G) < R:
        g = int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
        G.append(g)
    return CodeSpec(f"rand K={K} R=1/{R}", K, tuple(G))


@pytest.mark.parametrize("K,R,seed", [
    (4, 2, 0), (6, 3, 1), (8, 2, 2), (5, 5, 3), (10, 2, 4),
])
def test_random_code_roundtrip_and_oracle(K, R, seed):
    rng = np.random.RandomState(seed)
    code = random_code(rng, K, R)
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)

    nbytes = 12
    data = rng.randint(0, 256, (2, nbytes), dtype=np.uint8)
    syms = np.stack([
        ref.encode_bytes(code, d, 127, -127) for d in data
    ]).astype(np.int64)
    syms = np.clip(syms + rng.randint(-20, 21, syms.shape), -127, 127)
    T = syms.shape[1] // code.R

    # XLA path vs the NumPy oracle, bit-for-bit (metrics + decisions)
    m0 = jax_core.initial_metrics(spec, 2)
    jm, jp, ja = jax_core.acs_scan(spec, m0,
                                   jnp.asarray(syms.reshape(2, T, code.R)))
    for f in range(2):
        om, od, oa = ref.acs_run(code, config, syms[f])
        np.testing.assert_array_equal(np.asarray(jm)[:, f], om)
        assert int(np.asarray(ja)[f]) == oa

    # full decode inverts the encoder through the noise
    dec = ViterbiDecoder(code, config, backend="xla")
    bits, _, _ = dec.decode(syms.reshape(2, -1), nbytes * 8)
    out = np.packbits(np.asarray(bits), axis=-1, bitorder="big")
    np.testing.assert_array_equal(out, data)


def test_random_code_gpu_kernel_interpret_exact():
    rng = np.random.RandomState(9)
    code = random_code(rng, 6, 2)
    config = get_decode_config(DecodeType.SOFT8, code.R)
    spec = jax_core.make_static_spec(code, config)
    syms = jnp.asarray(rng.randint(-3, 4, (2, 20, code.R)), jnp.int32)
    m0 = jax_core.initial_metrics(spec, 2)
    from viterbidecodercpp_jax.ops import triton_kernels
    em, ep, ea = jax_core.acs_scan(spec, m0, syms)
    pm, pp, pa = triton_kernels.acs(spec, m0, syms, interpret=True)
    np.testing.assert_array_equal(np.asarray(em), np.asarray(pm))
    np.testing.assert_array_equal(np.asarray(ep), np.asarray(pp))
    np.testing.assert_array_equal(np.asarray(ea), np.asarray(pa))


def test_random_puncture_pattern_roundtrip():
    """Arbitrary (non-DAB) puncture pattern: noiseless punctured decode
    recovers the data when enough symbols survive."""
    from viterbidecodercpp_jax import PunctureSpec, get_code
    from viterbidecodercpp_jax.ops import encoder

    rng = np.random.RandomState(4)
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    # keep 3 of every 4 symbols (rate 1/2 -> 2/3)
    pat = PunctureSpec("rand", (True, True, True, False))
    nbytes = 32
    data = rng.randint(0, 256, nbytes, dtype=np.uint8)
    full = ref.encode_bytes(code, data, 127, -127)
    mask = pat.mask(full.size)
    kept = full[mask]
    rx = encoder.depuncture(jnp.asarray(kept[None, :]), mask, neutral=0)
    dec = ViterbiDecoder(code, config, backend="xla",
                         traceback_length=nbytes * 8)
    bits, _, _ = dec.decode(np.asarray(rx), nbytes * 8)
    out = np.packbits(np.asarray(bits), axis=-1, bitorder="big")
    np.testing.assert_array_equal(out[0], data)


def test_random_k15_code_xla():
    """A random (non-registry) K=15 R=1/3 code through the decoder's
    big-state XLA path: correct for arbitrary polynomials, not just
    Cassini."""
    rng = np.random.RandomState(11)
    code = random_code(rng, 15, 3)
    config = get_decode_config(DecodeType.SOFT16, code.R)
    T = 31
    syms = rng.randint(-127, 128, (1, T * code.R)).astype(np.int32)
    dec = ViterbiDecoder(code, config, backend="xla")
    bits, err, acc = dec.decode(syms, T - (code.K - 1))
    mr, dr, ar = ref.acs_run(code, config, syms[0])
    assert int(np.asarray(err)[0]) == int(mr[0])
    assert ar == int(np.asarray(acc)[0])
    br = ref.traceback(code, dr, T - (code.K - 1))
    np.testing.assert_array_equal(br, np.asarray(bits)[0])
