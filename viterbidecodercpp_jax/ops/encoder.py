"""Batched convolutional encoding and puncturing on device (JAX).

The replacement for the reference's encoder classes
(convolutional_encoder_shift_register.h:42-62, convolutional_encoder_lookup.h)
and the puncturing helpers (helpers/puncture_code_helpers.h:57-144).

Rather than a stateful shift register, encoding is expressed in closed
form: output bit j at time t is ``parity(G[j] & reg_t)`` and ``reg_t``
holds input bits ``t-K+1 .. t`` (newest at LSB), so

    y[j, t] = XOR_{i : G[j] bit i set} x[t - i]

which vectorises as a sum of shifted copies of the bit stream mod 2 -
pure elementwise work that XLA fuses; there is no sequential dependency
at all (unlike decoding).  This makes on-device test-signal generation
essentially free next to the ACS recursion.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codes import CodeSpec, PunctureSpec

__all__ = [
    "encode_bits_jax",
    "encode_symbols_jax",
    "bytes_to_bits_jax",
    "bits_to_bytes_jax",
    "depuncture",
    "puncture_mask",
    "ByteStreamEncoder",
]


class ByteStreamEncoder:
    """Byte-at-a-time incremental encoder - the reference encoder ABC
    (convolutional_encoder.h:10-29): ``reset()`` clears the shift
    register; ``consume_byte(x)`` returns the R output bytes for one
    input byte, bits packed LSB-first in stream order t*R + j
    (convolutional_encoder_shift_register.h:40-62).

    Host-side convenience for protocol code that feeds bytes as they
    arrive; bulk encoding uses the closed-form device path
    (:func:`encode_bits_jax`) or the native batch runtime
    (utils/native.NativeEncoder), both of which it matches bit-for-bit
    (tests/test_encoder_jax.py).
    """

    def __init__(self, code: CodeSpec):
        self.code = code
        self.K = code.K
        self.R = code.R
        self._mask = (1 << code.K) - 1
        self._reg = 0

    def reset(self) -> None:
        self._reg = 0

    def consume_byte(self, x: int) -> np.ndarray:
        """Encode one input byte (bits MSB-first) -> (R,) uint8 output
        bytes holding the 8*R encoded bits LSB-first."""
        from ..codes import parity

        y = np.zeros(self.R, np.uint8)
        curr_bit = 0
        for i in range(8):
            self._reg = ((self._reg << 1) | ((int(x) >> (7 - i)) & 1)) \
                & self._mask
            for g in self.code.G:
                b = int(parity(g & self._reg))
                y[curr_bit >> 3] |= np.uint8(b << (curr_bit & 7))
                curr_bit += 1
        return y

    def consume_bytes(self, data) -> np.ndarray:
        """Vector convenience: (n,) bytes -> (n, R) output bytes."""
        return np.stack([self.consume_byte(b) for b in np.asarray(data)])


def bytes_to_bits_jax(data: jnp.ndarray) -> jnp.ndarray:
    """(…, N) uint8 bytes -> (…, 8N) bits, MSB first (matching
    convolutional_encoder_shift_register.h:52)."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes_jax(bits: jnp.ndarray) -> jnp.ndarray:
    """(…, 8N) bits -> (…, N) uint8 bytes, MSB first (chainback byte
    convention, viterbi_decoder_core.h:105-112)."""
    n = bits.shape[-1]
    assert n % 8 == 0
    b = bits.reshape(*bits.shape[:-1], n // 8, 8).astype(jnp.uint8)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    return (b << shifts).sum(axis=-1).astype(jnp.uint8)


def _tap_delays(code: CodeSpec) -> Tuple[Tuple[int, ...], ...]:
    """For each polynomial, the set of delays i with tap G bit i set."""
    return tuple(
        tuple(i for i in range(code.K) if (g >> i) & 1) for g in code.G
    )


@functools.partial(jax.jit, static_argnums=(0, 2))
def encode_bits_jax(code: CodeSpec, bits: jnp.ndarray,
                    terminate: bool = True) -> jnp.ndarray:
    """Encode (B, N) data bits -> (B, T, R) output bits, T = N (+ K-1 tail).

    Zero initial state; with ``terminate`` the K-1 zero tail bits are
    appended (helpers/test_helpers.h:54-60).
    """
    B, N = bits.shape
    x = bits.astype(jnp.int32)
    if terminate:
        x = jnp.concatenate([x, jnp.zeros((B, code.K - 1), jnp.int32)], axis=1)
    T = x.shape[1]
    # delayed[i] = x shifted right by i with zero fill (initial state 0)
    pad = jnp.zeros((B, code.K - 1), jnp.int32)
    xp = jnp.concatenate([pad, x], axis=1)            # (B, T + K - 1)
    outs = []
    for taps in _tap_delays(code):
        acc = jnp.zeros((B, T), jnp.int32)
        for i in taps:
            acc = acc + jax.lax.dynamic_slice_in_dim(xp, code.K - 1 - i, T, axis=1)
        outs.append(acc & 1)
    return jnp.stack(outs, axis=-1)                   # (B, T, R)


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4))
def encode_symbols_jax(code: CodeSpec, bits: jnp.ndarray, high: int,
                       low: int, terminate: bool = True) -> jnp.ndarray:
    """Encode data bits to (B, T, R) soft symbols in {low, high}."""
    y = encode_bits_jax(code, bits, terminate)
    return jnp.where(y == 1, jnp.int32(high), jnp.int32(low))


def puncture_mask(spec: PunctureSpec, total_symbols: int,
                  phase: int = 0) -> np.ndarray:
    """Host-side keep-mask for a periodic puncture pattern."""
    return spec.mask(total_symbols, phase)


def depuncture(punctured: jnp.ndarray, keep_mask: np.ndarray,
               neutral: int) -> jnp.ndarray:
    """Re-inflate punctured symbols to the full symbol lattice.

    Positions where ``keep_mask`` is False receive ``neutral`` (default
    midpoint 0 in the harness), matching ``decode_punctured_symbols``
    (helpers/puncture_code_helpers.h:31-50).  ``punctured`` has shape
    (B, total_kept); the output is (B, len(keep_mask)).

    The scatter indices are host-computed constants (the puncture pattern
    is static), so this lowers to a plain XLA scatter with static indices.
    """
    keep_mask = np.asarray(keep_mask, dtype=bool)
    kept_positions = np.nonzero(keep_mask)[0]
    B = punctured.shape[0]
    if punctured.shape[1] != kept_positions.size:
        raise ValueError(
            f"got {punctured.shape[1]} punctured symbols for a mask keeping "
            f"{kept_positions.size}")
    out = jnp.full((B, keep_mask.size), jnp.int32(neutral))
    return out.at[:, jnp.asarray(kept_positions)].set(punctured.astype(jnp.int32))
