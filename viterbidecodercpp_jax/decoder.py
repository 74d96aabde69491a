"""Public decoder API: functional carry + a reference-shaped wrapper.

The reference exposes a stateful core (``ViterbiDecoder_Core``:
``reset`` / ``update`` / ``chainback`` / ``get_error``,
viterbi_decoder_core.h:157-243) whose key property is *incremental
decoding*: ``update`` may be called repeatedly in arbitrary chunks before
one ``chainback`` (proof: per-bit updates in
helpers/puncture_code_helpers.h:51).  This design keeps that
contract but makes the state an explicit pytree (:class:`DecoderState`) so
it can be donated through ``jit``, carried across ``lax.scan`` steps, and
sharded/shipped across hosts (SURVEY.md section 5 "checkpoint/resume").

Everything is batched: a decoder instance processes ``batch`` independent
frames at once (frame data-parallelism - the accelerator's replacement for
the reference's thread-pool task parallelism, SURVEY.md section 2.4).
Which kernels run is decided in one place, :func:`.paths.select_path`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .codes import CodeSpec
from .config import DecoderConfig, DecodeType, get_decode_config
from .ops import jax_core
from .paths import DecodePath, select_path

__all__ = ["DecoderState", "ViterbiDecoder"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DecoderState:
    """The resumable decode carry (a pytree).

    Equivalent of the mutable members of ``ViterbiDecoder_Core``
    (viterbi_decoder_core.h:237-242): the live metric vector, the decision
    history, the renorm-error accumulator and the write cursor.
    """

    metrics: jnp.ndarray        # (S, B) int32 - state-major
    decisions: jnp.ndarray      # (T_cap, W, B) int32 packed decision rows
    accumulated_error: jnp.ndarray  # (B,) int32 renormalisation total
    bit_cursor: jnp.ndarray     # () int32 - next decision row to write

    @property
    def batch(self) -> int:
        return self.metrics.shape[1]

    def save(self, path: str) -> None:
        """Checkpoint the carry to an .npz file.

        The reference's decoder is an implicitly resumable state machine
        (SURVEY.md section 5 "checkpoint/resume"); here the carry is
        explicit data, so a stream can be decoded in chunks across
        process restarts or shipped to another host mid-stream.
        """
        np.savez(path,
                 metrics=np.asarray(self.metrics),
                 decisions=np.asarray(self.decisions),
                 accumulated_error=np.asarray(self.accumulated_error),
                 bit_cursor=np.asarray(self.bit_cursor))

    @classmethod
    def load(cls, path: str) -> "DecoderState":
        """Restore a carry written by :meth:`save`."""
        with np.load(path) as z:
            if "row_rots" in z.files:
                raise ValueError(
                    f"{path}: checkpoint holds slot-order decision rows "
                    "('row_rots') from a decoder version that no longer "
                    "exists; its rows cannot be traced back here - decode "
                    "the stream again from its start")
            return cls(
                metrics=jnp.asarray(z["metrics"]),
                decisions=jnp.asarray(z["decisions"]),
                accumulated_error=jnp.asarray(z["accumulated_error"]),
                bit_cursor=jnp.asarray(z["bit_cursor"]),
            )


class ViterbiDecoder:
    """Batched Viterbi decoder for one (code, config) pair.

    API parity with the reference core plus kernels (SURVEY.md section 1
    L1): ``reset`` ~ viterbi_decoder_core.h:202, ``update`` ~
    viterbi_decoder_scalar.h:29 (and SIMD equivalents), ``chainback`` ~
    viterbi_decoder_core.h:214, ``get_error`` ~ viterbi_decoder_core.h:195,
    ``set_traceback_length`` ~ viterbi_decoder_core.h:180.

    ``backend`` (see :func:`.paths.select_path`):
      * ``"auto"``   - the GPU kernels where they are faster, else XLA.
      * ``"xla"``    - pure jnp + lax.scan (every platform).
      * ``"pallas"`` - the GPU kernels; raises where they do not apply.

    Input contract: soft symbols lie in [soft_decision_low,
    soft_decision_high].  The decoder clamps inputs to that range (the
    same clamp the reference harness applies before every decode,
    helpers/test_helpers.h:88-93), so all paths agree bit-for-bit
    even on out-of-range inputs.
    """

    def __init__(self, code: CodeSpec, config: Union[DecoderConfig, DecodeType, str],
                 *, traceback_length: int = 0,
                 backend: Union[str, DecodePath] = "auto"):
        if not isinstance(config, DecoderConfig):
            config = get_decode_config(DecodeType(config), code.R)
        self.code = code
        self.config = config
        self.spec = jax_core.make_static_spec(code, config)
        self.path = select_path(self.spec, backend=backend)
        self.backend = self.path.backend
        self._traceback_length = int(traceback_length)

    # -- capacity ---------------------------------------------------------
    @property
    def traceback_length(self) -> int:
        """Max data bits the decision buffer can hold (excludes the K-1
        tail rows, like get_traceback_length viterbi_decoder_core.h:189)."""
        return self._traceback_length

    def set_traceback_length(self, length: int) -> None:
        self._traceback_length = int(length)

    @property
    def decision_rows(self) -> int:
        return self._traceback_length + self.code.K - 1

    # -- state ------------------------------------------------------------
    def reset(self, batch: int, starting_state: int = 0) -> DecoderState:
        """Fresh carry for ``batch`` frames (viterbi_decoder_core.h:202-211).

        Decision rows are (rows, W, B) state-order words on every path, so
        carries move freely between decoders of the same code and config.
        """
        state = DecoderState(
            metrics=jax_core.initial_metrics(self.spec, batch, starting_state),
            decisions=jnp.zeros((self.decision_rows, self.spec.W, batch),
                                jnp.int32),
            accumulated_error=jnp.zeros(batch, jnp.int32),
            bit_cursor=jnp.zeros((), jnp.int32),
        )
        state._host_cursor = 0  # host mirror for the capacity check
        return state

    # -- hot path ---------------------------------------------------------
    def update(self, state: DecoderState, symbols) -> DecoderState:
        """Consume (B, N) soft symbols (N a multiple of R); returns the new
        carry with N/R more decision rows written.

        Incremental: call as many times as you like before ``chainback``,
        exactly like the reference's chunked update
        (run_punctured_decoder.cpp:258-282).
        """
        symbols = jnp.asarray(symbols)
        B, N = symbols.shape
        if N % self.code.R:
            raise ValueError("symbol count must be a multiple of R")
        nbits = N // self.code.R
        capacity = state.decisions.shape[0]
        # Mirror of the reference's capacity assert
        # (viterbi_decoder_core.h:180-186): a write past the decision
        # buffer would otherwise silently clamp and corrupt the tail.
        # The cursor is host-determined (reset -> 0, +nbits per update),
        # so track a host-side mirror to avoid a device sync per call;
        # states from elsewhere (load(), user pytree surgery) pay one
        # int() sync the first time. Skipped entirely under tracing.
        cursor = getattr(state, "_host_cursor", None)
        if cursor is None and not isinstance(state.bit_cursor,
                                             jax.core.Tracer):
            cursor = int(state.bit_cursor)
        if cursor is not None and cursor + nbits > capacity:
            raise ValueError(
                f"decision buffer overflow: {cursor} rows used + "
                f"{nbits} new > capacity {capacity} "
                "(set_traceback_length before reset, or chainback "
                "and reset between blocks)")
        new = self._update_jit(self.spec, self.path, state,
                               symbols.reshape(B, nbits, self.code.R))
        if cursor is not None:
            new._host_cursor = cursor + nbits
        return new

    @staticmethod
    @functools.partial(jax.jit, static_argnums=(0, 1), donate_argnums=(2,))
    def _update_jit(spec, path: DecodePath, state: DecoderState,
                    symbols: jnp.ndarray) -> DecoderState:
        # Decoder contract (as the reference harness guarantees before
        # every decode, helpers/test_helpers.h:88-93): soft symbols lie
        # in [low, high].  Clamping here makes every path agree
        # bit-for-bit on out-of-range inputs too.
        symbols = jnp.clip(symbols, spec.soft_low, spec.soft_high)
        metrics, packed, acc = path.update(spec, state.metrics, symbols)
        return DecoderState(
            metrics=metrics,
            decisions=jax.lax.dynamic_update_slice_in_dim(
                state.decisions, packed, state.bit_cursor, axis=0),
            accumulated_error=state.accumulated_error + acc,
            bit_cursor=state.bit_cursor + packed.shape[0],
        )

    # -- readout ----------------------------------------------------------
    def get_error(self, state: DecoderState, end_state: int = 0) -> jnp.ndarray:
        """(B,) normalised path metric at ``end_state``
        (viterbi_decoder_core.h:195-199, incl. its ``% NUMSTATES``
        index wrap)."""
        return state.metrics[end_state & (self.spec.S - 1), :]

    def chainback(self, state: DecoderState, total_bits: int,
                  end_state: int = 0) -> jnp.ndarray:
        """Trace back and return (B, total_bits) decoded data bits
        (viterbi_decoder_core.h:214-236)."""
        if total_bits > self._traceback_length:
            raise ValueError("total_bits exceeds traceback_length")
        ends = jnp.full((state.batch,), end_state, jnp.int32)
        return self.path.chainback(self.spec, state.decisions, ends,
                                   total_bits)

    def chainback_bytes(self, state: DecoderState, total_bits: int,
                        end_state: int = 0) -> np.ndarray:
        """Host-side convenience: decoded bits packed MSB-first to bytes."""
        bits = np.asarray(self.chainback(state, total_bits, end_state))
        return np.packbits(bits, axis=-1, bitorder="big")

    # -- one-shot convenience ----------------------------------------------
    def decode(self, symbols, total_bits: int, *, end_state: int = 0
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """reset + update + chainback in one call.

        Returns (bits (B, total_bits), final_error (B,), accumulated (B,)).

        Capacity note: when ``total_bits`` exceeds the instance's
        traceback capacity this grows it via set_traceback_length - and
        the growth is sticky, exactly like the reference core's
        (viterbi_decoder_core.h:180-186).
        """
        symbols = jnp.asarray(symbols)
        B = symbols.shape[0]
        if symbols.shape[1] % self.code.R:
            raise ValueError("symbol count must be a multiple of R")
        if self._traceback_length < total_bits:
            self.set_traceback_length(total_bits)
        steps = symbols.shape[1] // self.code.R
        if steps > self.decision_rows:
            raise ValueError(
                f"decision buffer overflow: {steps} trellis steps > "
                f"capacity {self.decision_rows}")
        if steps < total_bits + self.code.K - 1:
            raise ValueError(
                f"{steps} trellis steps cannot carry {total_bits} bits "
                f"and the K-1 tail")
        bits, metrics, acc = _decode_jit(
            self.spec, self.path, int(total_bits), int(end_state),
            symbols.reshape(B, -1, self.code.R))
        return bits, metrics[end_state & (self.spec.S - 1), :], acc


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _decode_jit(spec, path: DecodePath, total_bits: int, end_state: int,
                symbols: jnp.ndarray):
    # same input clamp as _update_jit (decoder-wide contract)
    symbols = jnp.clip(symbols, spec.soft_low, spec.soft_high)
    B = symbols.shape[0]
    return path.decode(spec, jax_core.initial_metrics(spec, B), symbols,
                       jnp.full((B,), end_state, jnp.int32), total_bits)
