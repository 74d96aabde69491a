"""The GPU ACS kernel (ops/triton_kernels.acs) in the Pallas interpreter
against the NumPy oracle: every registry code x decode regime, one-shot
and chunked (the incremental ``update`` contract: metrics carried from
one call to the next).  Small T keeps the interpreter fast."""

import jax.numpy as jnp
import numpy as np
import pytest

from viterbidecodercpp_jax import COMMON_CODES, DecodeType, get_decode_config
from viterbidecodercpp_jax.ops import jax_core, numpy_ref as ref
from viterbidecodercpp_jax.ops import triton_kernels as tk

B = 3          # not a power of two: exercises the frame padding


def noisy_symbols(code, config, seed, T):
    rng = np.random.RandomState(seed)
    lo, hi = config.soft_decision_low, config.soft_decision_high
    return rng.randint(lo, hi + 1, (B, T, code.R)).astype(np.int32)


def unpack_rows(packed, spec, b):
    """(T, W, B) words -> (T, S) decision bits of frame b."""
    T = packed.shape[0]
    got = np.zeros((T, spec.S), np.uint8)
    for s in range(spec.S):
        got[:, s] = (packed[:, s // 32, b] >> (s % 32)) & 1
    return got


@pytest.mark.parametrize("chunked", [False, True], ids=["oneshot", "chunked"])
@pytest.mark.parametrize("decode_type", list(DecodeType), ids=lambda d: d.value)
@pytest.mark.parametrize("code", COMMON_CODES, ids=lambda c: c.name)
def test_acs_kernel_matches_oracle(code, decode_type, chunked):
    config = get_decode_config(decode_type, code.R)
    spec = jax_core.make_static_spec(code, config)
    T = 20 if spec.S <= 256 else 8
    syms = noisy_symbols(code, config, code.K * 7 + len(decode_type.value), T)
    m = jax_core.initial_metrics(spec, B)
    if chunked:
        rows, acc = [], 0
        for lo, hi in ((0, T // 2 - 1), (T // 2 - 1, T)):
            m, p, a = tk.acs(spec, m, jnp.asarray(syms[:, lo:hi]),
                             interpret=True)
            rows.append(np.asarray(p))
            acc = acc + np.asarray(a)
        packed = np.concatenate(rows)
    else:
        m, packed, acc = tk.acs(spec, m, jnp.asarray(syms), interpret=True)
        packed, acc = np.asarray(packed), np.asarray(acc)
    m = np.asarray(m)
    assert packed.shape == (T, spec.W, B) and m.shape == (spec.S, B)
    for b in range(B):
        em, ed, ea = ref.acs_run(code, config, syms[b].reshape(-1))
        np.testing.assert_array_equal(m[:, b], em, err_msg=f"frame {b}")
        assert int(acc[b]) == ea
        np.testing.assert_array_equal(unpack_rows(packed, spec, b), ed,
                                      err_msg=f"frame {b}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["Basic K=3 R=1/2", "Voyager", "CDMA 2000"])
def test_compiled_kernels_match_xla(name):
    """On the card: the compiled ACS and walk kernels against the XLA
    scans at a few hundred frames, bit for bit."""
    from viterbidecodercpp_jax import get_code

    code = get_code(name)
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    rng = np.random.RandomState(1)
    Bg, T = 300, 400
    syms = jnp.asarray(rng.randint(-127, 128, (Bg, T, code.R)), jnp.int32)
    m0 = jax_core.initial_metrics(spec, Bg)
    want = jax_core.acs_scan(spec, m0, syms)
    got = tk.acs(spec, m0, syms)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    ends = jnp.asarray(rng.randint(0, spec.S, Bg), jnp.int32)
    nbits = T - code.K + 1
    np.testing.assert_array_equal(
        np.asarray(jax_core.chainback_scan(spec, want[1], ends, nbits)),
        np.asarray(tk.walk(spec, want[1], ends, code.K - 1, nbits)))
