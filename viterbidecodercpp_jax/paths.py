"""The one place that picks the decode path for a (code spec, platform).

Every entry point - :class:`~.decoder.ViterbiDecoder`,
:class:`~.streaming.StreamingDecoder`, :mod:`.ber`, the mesh decoders in
:mod:`.parallel` and the benchmark tools - asks :func:`select_path` for a
:class:`DecodePath` and runs its ``update`` / ``walk`` / ``chainback`` /
``decode``.  All paths share one decision layout: (T, W, B) int32 words,
state ``s`` of row ``t`` at bit ``s % 32`` of word ``s // 32``
(:func:`.ops.jax_core.pack_decisions`), so a carry written by one path
can be traced back by any other.

Paths:

* ``"xla"`` - :mod:`.ops.jax_core` scans (and, for the one-shot decode of
  state counts above ``jax_core.MAX_LANE_STATES``, the rotated-layout
  scan of :mod:`.ops.bigstate`).  Runs on every platform.
* ``"pallas"`` - the GPU kernels of :mod:`.ops.triton_kernels`, for
  ``KERNEL_MIN_STATES <= S <= KERNEL_MAX_STATES``: the range in which they
  decode faster than the XLA path on an H100 (PERF.md, kernel-vs-XLA
  table).  They compile only for ``platform == "gpu"``; ``interpret=True``
  runs them in the Pallas interpreter anywhere, and is for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp

from .ops import bigstate, jax_core, triton_kernels
from .ops.jax_core import StaticSpec

__all__ = ["DecodePath", "select_path", "kernel_admits",
           "KERNEL_MIN_STATES", "KERNEL_MAX_STATES"]

# Measured admission range of the GPU kernels: faster than the XLA path
# end to end for every code measured, K=3 (S=4) through K=13 (S=4096),
# on an H100 (PERF.md).  Above it the one-shot XLA decode takes the
# rotated layout of ops/bigstate.
KERNEL_MIN_STATES = 4
KERNEL_MAX_STATES = jax_core.MAX_LANE_STATES


@dataclasses.dataclass(frozen=True)
class DecodePath:
    """The update and traceback functions of one decode path."""

    backend: str                 # "xla" | "pallas"
    interpret: bool = False      # pallas only: run in the interpreter

    def update(self, spec: StaticSpec, metrics: jnp.ndarray,
               symbols: jnp.ndarray
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """(S, B) metrics, (B, T, R) symbols -> (metrics, packed
        (T, W, B), accumulated renorm error (B,))."""
        if self.backend == "pallas":
            return triton_kernels.acs(spec, metrics, symbols,
                                      interpret=self.interpret)
        return jax_core.acs_scan(spec, metrics, symbols)

    def walk(self, spec: StaticSpec, rows: jnp.ndarray, start: jnp.ndarray,
             first: int, count: int) -> jnp.ndarray:
        """Trace back through rows [first, first+count) newest to oldest
        from ``start`` (B,); returns (B, count) uint8 decision bits."""
        if self.backend == "pallas":
            return triton_kernels.walk(spec, rows, start, first, count,
                                       interpret=self.interpret)
        return jnp.swapaxes(
            jax_core.walk_scan(spec, rows[first:first + count], start), 0, 1)

    def chainback(self, spec: StaticSpec, packed: jnp.ndarray,
                  end_state: jnp.ndarray, total_bits: int) -> jnp.ndarray:
        """(B, total_bits) data bits (viterbi_decoder_core.h:214-236):
        data bit j is the decision read at row j + K - 1."""
        return self.walk(spec, packed, end_state, spec.K - 1, total_bits)

    def decode(self, spec: StaticSpec, metrics: jnp.ndarray,
               symbols: jnp.ndarray, end_state: jnp.ndarray,
               total_bits: int
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """One-shot update + chainback; returns (bits (B, total_bits),
        final metrics (S, B), accumulated renorm error (B,))."""
        if self.backend == "xla" and jax_core.needs_big_state(spec):
            bits, m, _, acc = bigstate.decode_big(spec, metrics, symbols,
                                                  end_state, total_bits)
            return bits, m, acc
        m, packed, acc = self.update(spec, metrics, symbols)
        return self.chainback(spec, packed, end_state, total_bits), m, acc


XLA = DecodePath("xla")


def kernel_admits(spec: StaticSpec) -> bool:
    """True when the GPU kernels serve this state count."""
    return KERNEL_MIN_STATES <= spec.S <= KERNEL_MAX_STATES


def select_path(spec: StaticSpec, platform: Optional[str] = None,
                backend: Union[str, DecodePath] = "auto", *,
                interpret: bool = False) -> DecodePath:
    """Pick the decode path for ``spec`` on ``platform`` (default: JAX's
    default backend).

    ``backend="auto"`` takes the GPU kernels on ``"gpu"`` inside their
    admission range and the XLA path everywhere else.  ``"xla"`` always
    takes the XLA path.  ``"pallas"`` takes the kernels and raises where
    they do not apply: outside the admission range, or on a platform
    other than ``"gpu"`` unless ``interpret=True`` asks for the Pallas
    interpreter.  A :class:`DecodePath` passes through unchanged.
    """
    if isinstance(backend, DecodePath):
        return backend
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if platform is None:
        platform = jax.default_backend()
    if backend == "xla":
        return XLA
    if backend == "auto":
        if platform == "gpu" and kernel_admits(spec):
            return DecodePath("pallas")
        return XLA
    if not kernel_admits(spec):
        raise ValueError(
            f"backend='pallas' serves {KERNEL_MIN_STATES} <= S <= "
            f"{KERNEL_MAX_STATES} states; this code has S={spec.S}")
    if platform != "gpu" and not interpret:
        raise ValueError(
            f"backend='pallas' compiles for the 'gpu' platform, not "
            f"{platform!r} (interpret=True runs the Pallas interpreter)")
    return DecodePath("pallas", interpret=interpret)
