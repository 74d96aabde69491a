"""The GPU traceback kernel (ops/triton_kernels.walk) in the Pallas
interpreter against the NumPy oracle's traceback: every registry code x
decode regime, one walk over all data rows and a chunked walk (the newer
rows first, then the older rows from the state the first walk reached -
the pattern of the streaming and time-sharded walks)."""

import jax.numpy as jnp
import numpy as np
import pytest

from viterbidecodercpp_jax import COMMON_CODES, DecodeType, get_decode_config
from viterbidecodercpp_jax.ops import jax_core, numpy_ref as ref
from viterbidecodercpp_jax.ops import triton_kernels as tk

B = 5          # not a power of two: exercises the frame padding


@pytest.mark.parametrize("chunked", [False, True], ids=["oneshot", "chunked"])
@pytest.mark.parametrize("decode_type", list(DecodeType), ids=lambda d: d.value)
@pytest.mark.parametrize("code", COMMON_CODES, ids=lambda c: c.name)
def test_walk_kernel_matches_oracle(code, decode_type, chunked):
    config = get_decode_config(decode_type, code.R)
    spec = jax_core.make_static_spec(code, config)
    nbits = 24 if spec.S <= 256 else 32     # each half >= K-1 rows
    T = nbits + code.K - 1
    rng = np.random.RandomState(code.K * 5 + len(decode_type.value))
    lo, hi = config.soft_decision_low, config.soft_decision_high
    syms = rng.randint(lo, hi + 1, (B, T, code.R)).astype(np.int32)
    ends = rng.randint(0, spec.S, B).astype(np.int32)
    _, packed, _ = jax_core.acs_scan(spec, jax_core.initial_metrics(spec, B),
                                     jnp.asarray(syms))
    Kb = code.K - 1
    if chunked:
        # newer half first; the state entering the older half is the
        # shift register of the K-1 oldest bits of the newer half
        n1 = nbits // 2
        newer = np.asarray(tk.walk(spec, packed, jnp.asarray(ends),
                                   Kb + n1, nbits - n1, interpret=True))
        state = np.zeros(B, np.int32)
        for i in range(Kb - 1, -1, -1):
            state = (state >> 1) | (newer[:, i].astype(np.int32) << (Kb - 1))
        older = np.asarray(tk.walk(spec, packed, jnp.asarray(state),
                                   Kb, n1, interpret=True))
        bits = np.concatenate([older, newer], axis=1)
    else:
        bits = np.asarray(tk.walk(spec, packed, jnp.asarray(ends), Kb,
                                  nbits, interpret=True))
    assert bits.shape == (B, nbits) and bits.dtype == np.uint8
    for b in range(B):
        _, ed, _ = ref.acs_run(code, config, syms[b].reshape(-1))
        np.testing.assert_array_equal(
            bits[b], ref.traceback(code, ed, nbits, int(ends[b])),
            err_msg=f"frame {b}")
