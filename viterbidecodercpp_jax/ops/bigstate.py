"""Rotated-layout one-shot decode path for huge state counts (K=15).

For S = 2^(K-1) > 4096 each step of the XLA scan moves the whole metric
vector through device memory, and the butterfly interleave
``new[2h], new[2h+1] <- (even, odd)`` materialises as explicit
copy/reshape ops on top of the arithmetic.

This module removes the data movement entirely with a *rotated physical
layout*.  Let n = K-1 and let the physical position of logical state s
after t trellis steps be ``pos_t(s) = rotr_n(s, t)``.  Then for a step at
phase phi = t mod n, with j = (n-1-phi) mod n:

  * the lo/hi halves are the slot pairs ``(p, p | 2^j)`` with
    ``bit_j(p) = 0`` - plain strided views, no gather;
  * the butterfly is IN-PLACE: new state 2s lands exactly at slot p and
    2s+1 at slot ``p | 2^j`` (because ``rotr(2s, t+1) = rotr(s, t)``) -
    the interleave shuffle vanishes, the layout rotation is implicit.

State 0 stays at slot 0 at every phase, so the renormalisation gate
(viterbi_decoder_scalar.h:48) is untouched.  Metrics are carried compact
(uint8/uint16) like :func:`jax_core.acs_scan_multi`.  Decisions are
packed in slot-pair order ("i-order"); the matching chainback recovers
the bit position of logical state s' at row t from the static phase
schedule with a few bit ops per row.

The packed-decision format is therefore *phase-dependent*: use
:func:`chainback_rotated` (or :func:`decode_big`, which pairs them).
Everything is bit-exact vs the NumPy oracle; only the storage order of
decision bits differs from jax_core.acs_scan.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import jax_core
from .jax_core import StaticSpec

__all__ = ["acs_scan_rotated", "chainback_rotated", "decode_big"]


def _rotr(x: np.ndarray, k: int, n: int) -> np.ndarray:
    k %= n
    mask = (1 << n) - 1
    return ((x >> k) | (x << (n - k))) & mask


def _phase_tables(spec: StaticSpec):
    """Per-phase static data.

    For phase phi (layout age t mod n), j = (n-1-phi) mod n and the lo
    slots in physical order are p = a*2^(j+1) + b (b < 2^j); slot index
    i = a*2^j + b; the logical half-state is h = rotl(p, phi).
    Returns [(j, bt_perm (R, H) int32)] for phi = 0..n-1.
    """
    n = spec.K - 1
    H = spec.H
    bt = np.asarray(spec.bt, dtype=np.int32)          # (R, H) logical
    out = []
    for phi in range(n):
        j = (n - 1 - phi) % n
        i = np.arange(H)
        a, b = i >> j, i & ((1 << j) - 1)
        p = (a << (j + 1)) | b
        h = _rotr(p, -phi, n)                          # rotl(p, phi)
        out.append((j, bt[:, h]))
    return out


def _unrotate_perm(spec: StaticSpec, t: int) -> np.ndarray:
    """perm with m_logical[s] = m_phys[perm[s]] after t steps."""
    n = spec.K - 1
    s = np.arange(spec.S)
    return _rotr(s, t, n)


@functools.partial(jax.jit, static_argnums=(0,))
def acs_scan_rotated(spec: StaticSpec, metrics: jnp.ndarray,
                     symbols: jnp.ndarray
                     ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """ACS over (B, T, R) symbols in the rotated layout.

    Same contract as :func:`jax_core.acs_scan` except the packed
    decision rows are in rotated i-order (consume with
    :func:`chainback_rotated`).  T pads internally to a multiple of
    n = K-1 with masked steps.
    """
    n = spec.K - 1
    S, H, W = spec.S, spec.H, spec.W
    B, T, R = symbols.shape
    store_dt = jnp.uint8 if spec.metric_max <= 0xFF else jnp.uint16
    tables = _phase_tables(spec)

    T_pad = -(-T // n) * n
    sym_t = jnp.transpose(symbols, (1, 2, 0)).astype(jnp.int32)  # (T, R, B)
    sym_t = jnp.pad(sym_t, ((0, T_pad - T), (0, 0), (0, 0)))
    sym_g = sym_t.reshape(T_pad // n, n, R, B)
    gidx = jnp.arange(T_pad // n, dtype=jnp.int32)

    def substep(m, sym, phi):
        """One in-place butterfly at static phase phi; m is (S, B) int32
        in the phase-phi layout; returns (new m, packed (W, B))."""
        j, btp = tables[phi]
        btj = jnp.asarray(btp)                        # (R, H) i-order
        mv = m.reshape(S >> (j + 1), 2, 1 << j, B)
        lo = mv[:, 0].reshape(H, B)
        hi = mv[:, 1].reshape(H, B)
        # branch metric: sum_r |bt[r, i] - sym[r, b]|
        bm = jnp.abs(btj[0][:, None] - sym[0][None, :])
        for r in range(1, R):
            bm = bm + jnp.abs(btj[r][:, None] - sym[r][None, :])
        # shared ACS core (tie-break/saturation semantics live in one
        # place): state 2h -> its lo slot p, state 2h+1 -> p | 2^j
        new_lo, new_hi, dec0, dec1 = jax_core.acs_select(spec, lo, hi, bm)
        nm = jnp.stack([new_lo.reshape(S >> (j + 1), 1 << j, B),
                        new_hi.reshape(S >> (j + 1), 1 << j, B)],
                       axis=1).reshape(S, B)
        return nm, jax_core.pack_decisions(spec, dec0, dec1)

    def step(carry, xs):
        m, acc = carry
        sym_group, g = xs
        words = []
        for phi in range(n):
            live = g * n + phi < T
            nm, packed = substep(m.astype(jnp.int32), sym_group[phi], phi)
            # renorm gated on state 0 = slot 0 at every phase (shared
            # with the standard scan)
            nm, sub = jax_core._renormalise(spec, nm)
            acc = acc + jnp.where(live, sub, 0)
            m = jnp.where(live, nm, m.astype(jnp.int32)).astype(store_dt)
            words.append(packed)
        return (m, acc), jnp.stack(words)

    acc0 = metrics[0, :].astype(jnp.int32) * 0
    (m_out, acc), packed = jax.lax.scan(
        step, (metrics.astype(store_dt), acc0), (sym_g, gidx))
    packed = packed.reshape(T_pad, W, B)[:T]

    # back to logical order for the public contract
    perm = jnp.asarray(_unrotate_perm(spec, T))
    m_logical = jnp.take(m_out.astype(jnp.int32), perm, axis=0)
    return m_logical, packed, acc


@functools.partial(jax.jit, static_argnums=(0, 3))
def chainback_rotated(spec: StaticSpec, packed: jnp.ndarray,
                      end_state: jnp.ndarray, total_bits: int) -> jnp.ndarray:
    """Traceback over rotated-order packed rows (acs_scan_rotated output).

    Bit position of the decision for new state s' at row t: with
    phi = t mod n and j = (n-1-phi) mod n, h = s' >> 1 sits at physical
    lo slot p = rotr(h, phi); slot index i drops bit j of p; the bit is
    2i + (s' & 1) (pack_decisions i-order layout).
    """
    n = spec.K - 1
    Kb = n
    rows = packed[Kb:Kb + total_bits]
    T0 = Kb + total_bits                               # rows used: 0..T0-1
    # static per-row (phi, j) schedules for rows T0-1 .. 0
    t_seq = np.arange(T0 - 1, T0 - 1 - total_bits, -1)
    phis = (t_seq % n).astype(np.int32)
    js = ((n - 1 - phis) % n).astype(np.int32)
    mask = (1 << n) - 1

    def step(state, xs):
        words, phi, j = xs
        h = state >> 1
        p = ((h >> phi) | (h << (n - phi))) & mask     # rotr(h, phi)
        low = p & ((1 << j) - 1)
        i = ((p >> (j + 1)) << j) | low
        bitpos = (i << 1) | (state & 1)
        widx = bitpos >> 5
        sel = jnp.where(
            jnp.arange(spec.W, dtype=jnp.int32)[:, None] == widx[None, :],
            words, 0).sum(axis=0)
        d = (sel >> (bitpos & 31)) & 1
        state = (state >> 1) | (d << (Kb - 1))
        return state, d.astype(jnp.uint8)

    # walk newest -> oldest over the data-bit rows
    xs = (rows[::-1], jnp.asarray(phis), jnp.asarray(js))
    _, bits_rev = jax.lax.scan(step, end_state.astype(jnp.int32), xs)
    return jnp.swapaxes(bits_rev[::-1], 0, 1)


def decode_big(spec: StaticSpec, metrics: jnp.ndarray, symbols: jnp.ndarray,
               end_state: jnp.ndarray, total_bits: int
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One-shot decode for huge-S codes: rotated ACS + matching traceback.

    Returns (bits (B, total_bits) uint8, final metrics (S, B) logical
    order, packed (T, W, B) rotated order, acc (B,)).
    """
    m, packed, acc = acs_scan_rotated(spec, metrics, symbols)
    bits = chainback_rotated(spec, packed, end_state, total_bits)
    return bits, m, packed, acc
