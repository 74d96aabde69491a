"""Viterbi ACS and traceback kernels for NVIDIA GPUs (Pallas, Triton route).

The XLA path (:mod:`jax_core`) runs one ``lax.scan`` iteration, and
several small kernel launches, per trellis step, and round-trips the
(S, B) metric vector through device memory every step.  These kernels
keep a block of frames' metrics in registers for all T steps instead:

* :func:`acs` - one program per block of ``bB`` frames holds their
  (bB, S) metrics, loops over time inside the kernel, and writes each
  step's packed decision words straight into the shared
  (T, W, B) state-order decision layout of :func:`jax_core.acs_scan`.
  The butterfly is a split of the metric row into predecessor halves and
  a join of the (even, odd) survivors - the two shape operations the
  Triton lowering has - with states on the last axis.  The add-compare-
  select arithmetic is :func:`jax_core.acs_select` itself.
* :func:`walk` - one program per block of frames walks the decision rows
  newest to oldest, gathering each frame's word directly.

Both are bit-exact with the XLA path (integer arithmetic only).
``interpret=True`` runs them in the Pallas interpreter, which is how the
CPU tests reach them; nothing derives it from the platform.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import jax_core
from .jax_core import DECISION_WORD_BITS, StaticSpec

__all__ = ["acs", "walk", "frames_per_program"]

# Metric elements (frames x states) one ACS program keeps live.  1024 was
# fastest or within 10% of it for every registry code with S <= 256 on
# an H100 (tiles of 512..4096 tried; PERF.md).
_ACS_TILE = 1024
# At most this many frames per program, so small-S codes still spread
# over many programs (K=5: 32 frames/program beat 64 by 16%; PERF.md).
_MAX_FRAMES = 32
# Frames one walk program follows (each step is one gather per frame).
_WALK_FRAMES = 32


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def frames_per_program(S: int, B: int) -> int:
    """Frames per ACS program, a power of two: ``_ACS_TILE // S`` (at
    least 1, at most ``_MAX_FRAMES``), and no more than the batch rounded
    up to a power of two."""
    return min(max(_ACS_TILE // S, 1), _MAX_FRAMES, _next_pow2(B))


def _pad_frames(x: jnp.ndarray, axis: int, Bp: int, value=0) -> jnp.ndarray:
    pad = Bp - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=value)


def _interleave(even: jnp.ndarray, odd: jnp.ndarray) -> jnp.ndarray:
    """(n, H) x2 -> (n, 2H) with even[:, h] at 2h and odd[:, h] at 2h+1
    (a Triton ``join`` of two (..., 1) operands)."""
    n, H = even.shape
    return jnp.concatenate([even[..., None], odd[..., None]],
                           axis=-1).reshape(n, 2 * H)


def _acs_kernel(spec: StaticSpec, T: int, bB: int,
                sym_ref, bt_ref, m_ref, m_out, dec_out, acc_out):
    S, H, W, R = spec.S, spec.H, spec.W, spec.R
    wb = min(S, DECISION_WORD_BITS)              # states per decision word
    cols = pl.ds(pl.program_id(0) * bB, bB)
    bts = [bt_ref[r, :][None, :] for r in range(R)]            # (1, H)
    shifts = jax.lax.broadcasted_iota(jnp.int32, (1, 1, wb), 2)
    state0 = jax.lax.broadcasted_iota(jnp.int32, (1, S), 1) == 0

    def step(t, carry):
        m, acc = carry
        bm = jnp.abs(bts[0] - sym_ref[t, 0, cols][:, None])
        for r in range(1, R):
            bm = bm + jnp.abs(bts[r] - sym_ref[t, r, cols][:, None])
        lo, hi = jnp.split(m, 2, axis=-1)
        new_even, new_odd, dec0, dec1 = jax_core.acs_select(spec, lo, hi, bm)
        m = _interleave(new_even, new_odd)
        dec = _interleave(dec0, dec1).reshape(bB, W, wb)
        # disjoint bits: the sum is the bitwise or (two's complement
        # wrap at bit 31 is exact)
        dec_out[t, :, cols] = jnp.sum(dec << shifts, axis=-1).T
        # renormalisation gated on the state-0 metric
        # (viterbi_decoder_scalar.h:48)
        gate = jnp.sum(jnp.where(state0, m, 0), axis=-1) >= spec.renorm_threshold
        sub = jnp.where(gate, jnp.min(m, axis=-1), 0)
        return m - sub[:, None], acc + sub

    m0 = m_ref[:, cols].T                                       # (bB, S)
    m, acc = jax.lax.fori_loop(0, T, step,
                               (m0, jnp.zeros((bB,), jnp.int32)))
    m_out[:, cols] = m.T
    acc_out[cols] = acc


@functools.partial(jax.jit, static_argnums=(0,),
                   static_argnames=("interpret",))
def acs(spec: StaticSpec, metrics: jnp.ndarray, symbols: jnp.ndarray, *,
        interpret: bool = False
        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Same contract as :func:`jax_core.acs_scan`: metrics (S, B) int32,
    symbols (B, T, R) -> (metrics (S, B), packed (T, W, B) int32,
    accumulated renorm error (B,) int32).  The batch pads to a whole
    number of programs; padded frames are dropped from the outputs."""
    S, W = spec.S, spec.W
    B, T, R = symbols.shape
    bB = frames_per_program(S, B)
    Bp = -(-B // bB) * bB
    sym_t = _pad_frames(jnp.transpose(symbols, (1, 2, 0)).astype(jnp.int32),
                        2, Bp)                                   # (T, R, Bp)
    m_in = _pad_frames(metrics.astype(jnp.int32), 1, Bp, spec.init_other)
    bt = jnp.asarray(np.asarray(spec.bt, np.int32))             # (R, H)
    sds = functools.partial(jax_core.sds_like, sym_t)
    m_out, packed, acc = pl.pallas_call(
        functools.partial(_acs_kernel, spec, T, bB),
        out_shape=(sds((S, Bp), jnp.int32), sds((T, W, Bp), jnp.int32),
                   sds((Bp,), jnp.int32)),
        grid=(Bp // bB,),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=4 if bB * S <= 1024 else 8, num_stages=1),
        interpret=interpret,
        name="viterbi_acs",
    )(sym_t, bt, m_in)
    if Bp != B:
        m_out, packed, acc = m_out[:, :B], packed[..., :B], acc[:B]
    return m_out, packed, acc


def _walk_kernel(spec: StaticSpec, first: int, count: int, B: int, bB: int,
                 rows_ref, start_ref, bits_out):
    b0 = pl.program_id(0) * bB
    # padded frames re-read the last real frame; their bits are dropped
    frames = jnp.minimum(b0 + jax.lax.broadcasted_iota(jnp.int32, (bB,), 0),
                         B - 1)
    top = spec.K - 2

    def step(i, state):
        j = count - 1 - i
        word = rows_ref[first + j, state >> 5, frames]
        d = (word >> (state & (DECISION_WORD_BITS - 1))) & 1
        bits_out[j, pl.ds(b0, bB)] = d.astype(jnp.uint8)
        return (state >> 1) | (d << top)

    # under shard_map a loaded value carries the varying-axes type of its
    # ref and a computed one does not; the loop carry must keep one type
    start = start_ref[pl.ds(b0, bB)] + 0
    jax.lax.fori_loop(0, count, step, start)


@functools.partial(jax.jit, static_argnums=(0, 3, 4),
                   static_argnames=("interpret",))
def walk(spec: StaticSpec, rows: jnp.ndarray, start: jnp.ndarray,
         first: int, count: int, *, interpret: bool = False) -> jnp.ndarray:
    """Trace back through rows ``[first, first + count)`` of packed
    (T, W, B) decisions, newest to oldest, from states ``start`` (B,).
    Returns (B, count) uint8: column j is the decision bit read at row
    ``first + j`` (the :func:`jax_core.walk_scan` recurrence)."""
    T, W, B = rows.shape
    if first + count > T:
        raise ValueError(f"walk over rows [{first}, {first + count}) of {T}")
    bB = min(_WALK_FRAMES, _next_pow2(B))
    Bp = -(-B // bB) * bB
    start = _pad_frames(start.astype(jnp.int32), 0, Bp)
    bits = pl.pallas_call(
        functools.partial(_walk_kernel, spec, first, count, B, bB),
        out_shape=jax_core.sds_like(rows, (count, Bp), jnp.uint8),
        grid=(Bp // bB,),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="viterbi_walk",
    )(rows, start)
    return jnp.swapaxes(bits[:, :B], 0, 1)
