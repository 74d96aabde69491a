"""Bounded-latency streaming decode (truncated-traceback Viterbi).

The reference's only lever for long streams is bounded decision *memory*
(``set_traceback_length`` + chunked ``update`` + one final ``chainback``,
viterbi_decoder_core.h:180-186) - output still arrives only at the end.
This module adds the classic real-time mode on top of the same kernels:
bits are emitted continuously with a fixed decision delay of ``window``
trellis steps.  Each pushed chunk runs ACS incrementally; traceback
starts from the per-frame minimum-metric state and walks
``window + chunk`` rows; the oldest ``chunk`` bits are committed
(truncated-Viterbi: survivors merge with overwhelming probability within
~5-10 constraint lengths, the same property block_sp's overlap regions
rely on).  With ``window`` >= ~30*K the output is exact on clean-enough
channels and within a hair of maximum-likelihood otherwise.

State is a pytree (ring of the last ``window`` decision rows + the
metric carry), so streams can be jitted, sharded, and checkpointed like
the batch decoder's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple, Union

import jax
import jax.numpy as jnp

from .codes import CodeSpec
from .config import DecoderConfig, DecodeType, get_decode_config
from .ops import jax_core
from .paths import DecodePath, select_path

__all__ = ["StreamingState", "StreamingDecoder"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StreamingState:
    """Carry for a continuous decode: metric vector + the last ``window``
    packed decision rows (newest last) + rows seen so far."""

    metrics: jnp.ndarray    # (S, B) int32
    history: jnp.ndarray    # (window, W, B) int32, newest at the end
    rows_seen: jnp.ndarray  # () int32


class StreamingDecoder:
    """Fixed-latency streaming decoder for one (code, config) pair.

    ``push`` consumes ``chunk`` data bits worth of symbols per call and,
    once the pipeline is primed (after ``window`` rows), emits exactly
    ``chunk`` decided bits per call, delayed by ``window`` trellis steps.

    Example::

        sd = StreamingDecoder(code, "SOFT16", window=256, chunk=64)
        state = sd.reset(batch)
        for block in symbol_blocks:          # (B, chunk*R) each
            state, bits, valid = sd.push(state, block)
            if valid:                        # pipeline primed
                consume(bits)                # (B, chunk)
    """

    def __init__(self, code: CodeSpec,
                 config: Union[DecoderConfig, DecodeType, str], *,
                 window: int, chunk: int,
                 backend: Union[str, DecodePath] = "auto"):
        if not isinstance(config, DecoderConfig):
            config = get_decode_config(DecodeType(config), code.R)
        if window % chunk:
            raise ValueError("window must be a multiple of chunk")
        self.code = code
        self.config = config
        self.spec = jax_core.make_static_spec(code, config)
        self.window = int(window)
        self.chunk = int(chunk)
        self.path = select_path(self.spec, backend=backend)
        self.backend = self.path.backend

    def reset(self, batch: int, starting_state: int = 0) -> StreamingState:
        spec = self.spec
        return StreamingState(
            metrics=jax_core.initial_metrics(spec, batch, starting_state),
            history=jnp.zeros((self.window, spec.W, batch), jnp.int32),
            rows_seen=jnp.zeros((), jnp.int32),
        )

    def push(self, state: StreamingState, symbols
             ) -> Tuple[StreamingState, jnp.ndarray, jnp.ndarray]:
        """Consume (B, chunk*R) symbols; returns (state, bits, valid).

        ``bits`` is (B, chunk) uint8 - the bits decided ``window`` steps
        ago; ``valid`` is a scalar bool, False while the pipeline primes
        (the first window/chunk pushes).
        """
        symbols = jnp.asarray(symbols)
        B, N = symbols.shape
        if N != self.chunk * self.code.R:
            raise ValueError(f"push expects exactly chunk*R = "
                             f"{self.chunk * self.code.R} symbols")
        return _push_jit(self.spec, self.path, self.window, self.chunk,
                         state, symbols.reshape(B, self.chunk, self.code.R))


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3),
                   donate_argnums=(4,))
def _push_jit(spec, path: DecodePath, window, chunk,
              state: StreamingState, symbols: jnp.ndarray):
    # same input clamp as ViterbiDecoder.update (decoder-wide contract)
    symbols = jnp.clip(symbols, spec.soft_low, spec.soft_high)
    metrics, packed, _ = path.update(spec, state.metrics, symbols)

    # ring update: drop the oldest `chunk` rows, append the new ones
    history = jnp.concatenate([state.history[chunk:], packed], axis=0)
    rows_seen = state.rows_seen + chunk

    # traceback from the per-frame best state through the whole window;
    # commit the oldest `chunk` bits (delay = window - chunk .. window-1)
    best = jnp.argmin(metrics, axis=0).astype(jnp.int32)      # (B,)
    bits = path.walk(spec, history, best, 0, window)[:, :chunk]

    new_state = StreamingState(metrics=metrics, history=history,
                               rows_seen=rows_seen)
    valid = rows_seen >= window
    return new_state, bits, valid
