"""Decoder numeric configuration and the three canonical decode regimes.

Mirrors ``ViterbiDecoder_Config`` (viterbi_decoder_config.h:11-18) plus the
SOFT16 / SOFT8 / HARD8 factories (helpers/decode_type.h:21-64).  Here the
metric width is a dtype choice inside one kernel rather than a separate
hand-written kernel per width; the config also records which *arithmetic
semantics* to emulate:

  * ``saturating`` - unsigned saturated adds with ties selecting the
    leading-bit-1 predecessor.  This matches the reference SIMD kernels
    (x86/viterbi_decoder_sse_u16.h:106-115) that produced the committed
    BER ground-truth curves, and is the default.
  * ``wrapping`` - modular adds with ties selecting the leading-bit-0
    predecessor, matching the reference scalar kernel
    (viterbi_decoder_scalar.h:113-128).
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = [
    "DecoderConfig",
    "DecodeType",
    "get_decode_config",
    "DECODE_TYPES",
]


class DecodeType(enum.Enum):
    SOFT16 = "SOFT16"
    SOFT8 = "SOFT8"
    HARD8 = "HARD8"


DECODE_TYPES = (DecodeType.SOFT16, DecodeType.SOFT8, DecodeType.HARD8)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Numeric regime for a decoder instance.

    ``soft_decision_max_error``, ``initial_start_error``,
    ``initial_non_start_error`` and ``renormalisation_threshold`` carry the
    exact meanings of viterbi_decoder_config.h:11-18.  ``metric_bits`` (8 or
    16) sets the emulated unsigned metric width; ``arith`` selects
    saturating (SIMD-exact) or wrapping (scalar-exact) semantics.
    """

    soft_decision_high: int
    soft_decision_low: int
    soft_decision_max_error: int
    initial_start_error: int
    initial_non_start_error: int
    renormalisation_threshold: int
    metric_bits: int = 16
    arith: str = "saturating"

    def __post_init__(self):
        if self.metric_bits not in (8, 16):
            raise ValueError("metric_bits must be 8 or 16")
        if self.arith not in ("saturating", "wrapping"):
            raise ValueError("arith must be 'saturating' or 'wrapping'")

    @property
    def metric_max(self) -> int:
        """Saturation bound of the emulated unsigned metric type."""
        return (1 << self.metric_bits) - 1

    def replace(self, **kw) -> "DecoderConfig":
        return dataclasses.replace(self, **kw)


def get_decode_config(decode_type: DecodeType, code_rate: int, *,
                      arith: str = "saturating") -> DecoderConfig:
    """Build the canonical config for a decode regime.

    Value-for-value port of the three factories in
    helpers/decode_type.h:21-64 (note the margins differ per regime:
    5x max_error for SOFT16, 2x for SOFT8, 3x for HARD8).
    """
    decode_type = DecodeType(decode_type)
    if decode_type is DecodeType.SOFT16:
        high, low, margin_scale, bits = 127, -127, 5, 16
    elif decode_type is DecodeType.SOFT8:
        high, low, margin_scale, bits = 3, -3, 2, 8
    else:  # HARD8
        high, low, margin_scale, bits = 1, -1, 3, 8

    metric_max = (1 << bits) - 1
    max_error = (high - low) * code_rate
    # The reference computes the margin in the (narrow) unsigned metric type,
    # so it wraps for extreme code rates exactly as uint8/uint16 would.
    error_margin = (max_error * margin_scale) & metric_max
    return DecoderConfig(
        soft_decision_high=high,
        soft_decision_low=low,
        soft_decision_max_error=max_error,
        initial_start_error=0,
        initial_non_start_error=error_margin,
        renormalisation_threshold=metric_max - error_margin,
        metric_bits=bits,
        arith=arith,
    )
