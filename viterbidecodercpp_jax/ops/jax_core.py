"""Batched JAX implementation of the Viterbi trellis (XLA path).

This is the portable compute path: pure ``jnp`` + ``lax.scan``, batched
over frames, running on every platform.  It is the executable
specification the GPU kernels (ops/triton_kernels.py) are verified
against, and the path wherever they do not apply (paths.py).

Design notes (not a translation of the C++):
  * All (K, R, dtype, mode) parameters are static Python values; ``jit``
    specialises on them like the reference's templates
    (README.md:20, SURVEY.md section 5 "config/flag system").
  * Metrics live as an ``(S, B)`` int32 tensor (states x frames); u8/u16
    *semantics* are emulated by clipping
    (saturating mode) or masking (wrapping mode), which XLA fuses into the
    surrounding elementwise work for free.
  * The butterfly interleave ``new[2h], new[2h+1]`` is a reshape of an
    ``(H, 2, B)`` stack - the XLA analogue of the reference's
    ``unpacklo/hi`` lane repacks (x86/viterbi_decoder_sse_u16.h:119-131).
  * Decisions are bit-packed along the state axis into int32 words
    (32 states per word), the stand-in for ``movemask``
    (SURVEY.md section 7): ``word = sum_{s in word} dec_s << (s % 32)``.

Reference semantics matched exactly (see ops/numpy_ref.py for the oracle):
ACS recursion viterbi_decoder_scalar.h:58-135, renormalisation gate on the
state-0 metric viterbi_decoder_scalar.h:48, chainback
viterbi_decoder_core.h:214-236.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codes import CodeSpec, branch_table
from ..config import DecoderConfig

__all__ = [
    "StaticSpec",
    "make_static_spec",
    "acs_scan",
    "chainback_scan",
    "walk_scan",
    "pack_decisions",
    "initial_metrics",
]

DECISION_WORD_BITS = 32

# Above this state count the one-shot XLA decode takes the rotated
# in-place layout of ops.bigstate (no interleave copy per step).
MAX_LANE_STATES = 4096


def sds_like(x, shape, dtype):
    """ShapeDtypeStruct carrying ``x``'s varying-manual-axes type, so that
    pallas_call outputs are well-typed inside shard_map."""
    return jax.ShapeDtypeStruct(shape, dtype, vma=jax.typeof(x).vma)


def needs_big_state(spec: "StaticSpec") -> bool:
    """True above MAX_LANE_STATES (the K=15 class)."""
    return spec.S > MAX_LANE_STATES


class StaticSpec(NamedTuple):
    """Trace-time constants derived from (code, config).

    The branch table rides along as a NumPy constant so it is embedded in
    the compiled program (the shareable-table property of
    viterbi_branch_table.h:17-18 falls out of XLA constant folding).
    """

    K: int
    R: int
    S: int              # 2**(K-1) states
    H: int              # 2**(K-2) half states
    W: int              # ceil(S / 32) packed decision words
    bt: tuple           # (R, H) branch table as nested tuples (hashable)
    max_error: int
    metric_max: int
    renorm_threshold: int
    init_start: int
    init_other: int
    saturating: bool
    soft_low: int       # documented soft-symbol range [low, high]; the
    soft_high: int      # decoder clamps inputs to it (test_helpers.h:88-93)


def make_static_spec(code: CodeSpec, config: DecoderConfig) -> StaticSpec:
    bt = branch_table(code, config.soft_decision_high, config.soft_decision_low)
    S = code.num_states
    return StaticSpec(
        K=code.K,
        R=code.R,
        S=S,
        H=code.num_half_states,
        W=max(S // DECISION_WORD_BITS, 1),
        bt=tuple(tuple(int(v) for v in row) for row in bt),
        max_error=config.soft_decision_max_error,
        metric_max=config.metric_max,
        renorm_threshold=config.renormalisation_threshold,
        init_start=config.initial_start_error,
        init_other=config.initial_non_start_error,
        saturating=config.arith == "saturating",
        soft_low=int(config.soft_decision_low),
        soft_high=int(config.soft_decision_high),
    )


def initial_metrics(spec: StaticSpec, batch: int,
                    starting_state: int = 0) -> jnp.ndarray:
    """(S, B) int32 metric seed - reset() semantics
    (viterbi_decoder_core.h:202-211).

    Layout note: metrics are *state-major* (S, B) throughout the
    framework, the layout the decision rows share.
    """
    m = jnp.full((spec.S, batch), spec.init_other, dtype=jnp.int32)
    return m.at[starting_state & (spec.S - 1), :].set(spec.init_start)


def acs_select(spec: StaticSpec, lo: jnp.ndarray, hi: jnp.ndarray,
               bm: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray,
                                         jnp.ndarray, jnp.ndarray]:
    """The bit-exactness-critical add-compare-select core, shared by
    every path (this scan, ops/bigstate and the GPU kernel in
    ops/triton_kernels).

    ``lo``/``hi``: predecessor metrics, ``bm``: branch metric - all
    (H, B) int32.  Returns (new_even, new_odd, dec0, dec1) with the
    reference's saturation/wrap and tie-break semantics
    (x86/viterbi_decoder_sse_u16.h:106-115 saturating/tie->1;
    viterbi_decoder_scalar.h:113-128 wrapping/tie->0).
    """
    ibm = spec.max_error - bm
    e00 = lo + bm
    e10 = hi + ibm
    e01 = lo + ibm
    e11 = hi + bm
    if spec.saturating:
        cap = spec.metric_max
        e00 = jnp.minimum(e00, cap)
        e10 = jnp.minimum(e10, cap)
        e01 = jnp.minimum(e01, cap)
        e11 = jnp.minimum(e11, cap)
        dec0 = (e10 <= e00).astype(jnp.int32)   # SIMD tie -> predecessor 1
        dec1 = (e11 <= e01).astype(jnp.int32)
    else:
        mask = spec.metric_max
        e00 = jnp.bitwise_and(e00, mask)
        e10 = jnp.bitwise_and(e10, mask)
        e01 = jnp.bitwise_and(e01, mask)
        e11 = jnp.bitwise_and(e11, mask)
        dec0 = (e00 > e10).astype(jnp.int32)    # scalar tie -> predecessor 0
        dec1 = (e01 > e11).astype(jnp.int32)
    new_even = jnp.where(dec0 == 1, e10, e00)
    new_odd = jnp.where(dec1 == 1, e11, e01)
    return new_even, new_odd, dec0, dec1


def _butterfly_step(spec: StaticSpec, metrics: jnp.ndarray,
                    sym: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray,
                                               jnp.ndarray]:
    """One trellis step over a batch, state-major.

    ``metrics``: (S, B) int32; ``sym``: (R, B) int32 soft symbols.
    Returns (new_metrics (S, B), dec0 (H, B), dec1 (H, B)).
    """
    bt = jnp.asarray(np.asarray(spec.bt, dtype=np.int32))   # (R, H)
    # Branch metric per half-state: sum_i |bt[i, h] - sym[i, b]| -> (H, B)
    bm = jnp.abs(bt[:, :, None] - sym[:, None, :]).sum(axis=0)
    lo = metrics[: spec.H]
    hi = metrics[spec.H:]
    new_even, new_odd, dec0, dec1 = acs_select(spec, lo, hi, bm)
    new_metrics = jnp.stack([new_even, new_odd], axis=1).reshape(
        spec.S, -1)
    return new_metrics, dec0, dec1


def _renormalise(spec: StaticSpec, metrics: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-frame renorm, gated on the state-0 metric
    (viterbi_decoder_scalar.h:48, renormalise 139-153).

    metrics: (S, B); returns (renormalised metrics, subtracted (B,))."""
    gate = metrics[0, :] >= spec.renorm_threshold        # (B,)
    mins = metrics.min(axis=0)                            # (B,)
    sub = jnp.where(gate, mins, 0)
    return metrics - sub[None, :], sub


def pack_decisions(spec: StaticSpec, dec0: jnp.ndarray,
                   dec1: jnp.ndarray) -> jnp.ndarray:
    """Pack butterfly decisions (H, B) x2 into (W, B) int32 words.

    State 2h carries dec0[h] at bit (2h % 32); state 2h+1 carries dec1[h]
    at bit (2h+1 % 32) - the ``ViterbiDecisionBits`` layout
    (viterbi_decoder_core.h:49-83) with a fixed 32-bit block size, built
    without materialising the interleaved (S, B) bit tensor.
    """
    H, W = spec.H, spec.W
    if H >= 16:
        g0 = dec0.reshape(W, 16, -1)
        g1 = dec1.reshape(W, 16, -1)
        even = (1 << (2 * jnp.arange(16, dtype=jnp.int32)))[None, :, None]
        odd = even << 1
        return (g0 * even + g1 * odd).sum(axis=1)
    shifts = jax.lax.broadcasted_iota(jnp.int32, (H, 1), 0) * 2
    word = (dec0 * (1 << shifts) + dec1 * (1 << (shifts + 1))).sum(
        axis=0, keepdims=True)
    return word


def _unpack_bit(spec: StaticSpec, words: jnp.ndarray,
                state: jnp.ndarray) -> jnp.ndarray:
    """Read the decision bit for ``state`` (B,) from packed words (W, B)."""
    if spec.W == 1:
        word = words[0]
    else:
        # Select word s >> 5 per frame without gather: small masked sum.
        widx = state >> 5
        sel = (jnp.arange(spec.W, dtype=jnp.int32)[:, None] == widx[None, :])
        word = jnp.sum(jnp.where(sel, words, 0), axis=0)
    return (word >> (state & (DECISION_WORD_BITS - 1))) & 1


@functools.partial(jax.jit, static_argnums=(0,))
def acs_scan(spec: StaticSpec, metrics: jnp.ndarray, symbols: jnp.ndarray
             ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run T trellis steps over a batch of frames (XLA scan path).

    Args:
      metrics: (S, B) int32 carry from ``initial_metrics`` or a previous
        call (the update API is incremental, like the reference's -
        SURVEY.md section 5 "checkpoint/resume").
      symbols: (B, T, R) int32 soft symbols (frame-major, user layout).

    Returns:
      (metrics (S, B), packed decisions (T, W, B) int32,
       accumulated renorm error (B,) int32).
    """
    B = symbols.shape[0]
    sym_t = jnp.transpose(symbols, (1, 2, 0)).astype(jnp.int32)  # (T, R, B)

    def step(carry, sym):
        m, acc = carry
        m, dec0, dec1 = _butterfly_step(spec, m, sym)
        m, sub = _renormalise(spec, m)
        return (m, acc + sub), pack_decisions(spec, dec0, dec1)

    # acc derives from metrics (not a fresh constant) so it inherits the
    # same varying-axis type under shard_map (JAX vma tracking).
    acc0 = metrics[0, :].astype(jnp.int32) * 0
    (metrics, acc), packed = jax.lax.scan(
        step, (metrics.astype(jnp.int32), acc0), sym_t)
    return metrics, packed, acc


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def acs_scan_multi(spec: StaticSpec, metrics: jnp.ndarray,
                   symbols: jnp.ndarray, unroll: int = 2,
                   compact: bool = True
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """:func:`acs_scan` with ``unroll`` trellis steps per scan iteration
    and (by default) *compact metric storage*.

    Bit-identical; exists because for very large state counts (K=15:
    2^14-state metric tensors in HBM) the scan is bandwidth-bound on the
    metric round-trip.  Two levers, both semantics-free:
      * ``unroll``: several butterfly steps per scan iteration.  Any T
        works: the time axis pads internally and padded steps leave the
        carry untouched (tail-terminated frames have T = bits + K - 1,
        which is never a multiple of 4 for byte-aligned data).
      * ``compact``: metrics live in HBM as the emulated unsigned width
        (uint8/uint16 - values are always in [0, metric_max]), widened
        to int32 only inside each step, quartering/halving the dominant
        HBM traffic.
    """
    B, T, R = symbols.shape
    store_dt = jnp.int32
    if compact:
        store_dt = jnp.uint8 if spec.metric_max <= 0xFF else jnp.uint16
    T_pad = -(-T // unroll) * unroll
    sym_t = jnp.transpose(symbols, (1, 2, 0)).astype(jnp.int32)  # (T, R, B)
    sym_t = jnp.pad(sym_t, ((0, T_pad - T), (0, 0), (0, 0)))
    sym_g = sym_t.reshape(T_pad // unroll, unroll, R, B)
    gidx = jnp.arange(T_pad // unroll, dtype=jnp.int32)

    def step(carry, xs):
        m, acc = carry
        sym_group, g = xs
        words = []
        for u in range(unroll):
            live = g * unroll + u < T
            m32, dec0, dec1 = _butterfly_step(spec, m.astype(jnp.int32),
                                              sym_group[u])
            m32, sub = _renormalise(spec, m32)
            m = jnp.where(live, m32, m.astype(jnp.int32)).astype(store_dt)
            acc = acc + jnp.where(live, sub, 0)
            words.append(pack_decisions(spec, dec0, dec1))
        return (m, acc), jnp.stack(words)

    acc0 = metrics[0, :].astype(jnp.int32) * 0
    (m_out, acc), packed = jax.lax.scan(
        step, (metrics.astype(store_dt), acc0), (sym_g, gidx))
    return (m_out.astype(jnp.int32),
            packed.reshape(T_pad, spec.W, B)[:T], acc)


def walk_scan(spec: StaticSpec, rows: jnp.ndarray, start: jnp.ndarray,
              valid: jnp.ndarray = None) -> jnp.ndarray:
    """Trace back through packed decision rows (N, W, B) newest to oldest
    from ``start`` (B,); returns the decision bit read at each row, (N, B)
    uint8, with ``state <- (state >> 1) | (bit << (K-2))``
    (viterbi_decoder_core.h:214-236).

    ``valid`` (N,) bool masks rows to skip (stream padding past the true
    end): a skipped row leaves the state untouched.
    """
    Kb = spec.K - 1

    def step(state, inp):
        words, ok = inp
        d = _unpack_bit(spec, words, state)
        new_state = (state >> 1) | (d << (Kb - 1))
        if ok is not None:
            new_state = jnp.where(ok, new_state, state)
        return new_state, d.astype(jnp.uint8)

    xs = (rows[::-1], None if valid is None else valid[::-1])
    _, bits_rev = jax.lax.scan(step, start.astype(jnp.int32), xs)
    return bits_rev[::-1]


@functools.partial(jax.jit, static_argnums=(0, 3))
def chainback_scan(spec: StaticSpec, packed: jnp.ndarray,
                   end_state: jnp.ndarray, total_bits: int) -> jnp.ndarray:
    """Batched traceback over packed decisions (XLA scan path).

    Args:
      packed: (T, W, B) int32 decision words with T >= total_bits + K - 1;
        rows beyond ``total_bits + K - 1`` are ignored.
      end_state: (B,) int32 states to start the walk from (0 after tail
        termination).
      total_bits: number of data bits to recover.

    Returns (B, total_bits) uint8 data bits: the bit read at row
    ``j + K - 1`` is data bit j (viterbi_decoder_core.h:214-236).
    """
    Kb = spec.K - 1
    return jnp.swapaxes(
        walk_scan(spec, packed[Kb:Kb + total_bits], end_state), 0, 1)
