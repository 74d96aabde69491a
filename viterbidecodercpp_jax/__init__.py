"""viterbidecodercpp_jax - a batched Viterbi decoding framework in JAX.

A from-scratch JAX framework with the capabilities of the reference C++
library williamyang98/ViterbiDecoderCpp: arbitrary constraint-length /
rate-1/n convolutional codes, shareable branch tables, soft (8/16-bit)
and hard decisions, configurable initial errors and renormalisation,
puncturing, and BER/throughput harnesses - rebuilt around batched frames,
compiled trellis scans, Pallas GPU kernels (paths.py picks them), and
mesh sharding instead of SIMD intrinsics and thread pools.
"""

from .codes import (
    COMMON_CODES,
    DAB_PI_TABLE,
    DAB_PI_X,
    CodeSpec,
    PunctureSpec,
    branch_table,
    get_code,
    parity,
)
from .config import DECODE_TYPES, DecodeType, DecoderConfig, get_decode_config
from .decoder import DecoderState, ViterbiDecoder
from .streaming import StreamingDecoder, StreamingState

__version__ = "0.4.0"

__all__ = [
    "CodeSpec",
    "PunctureSpec",
    "COMMON_CODES",
    "DAB_PI_TABLE",
    "DAB_PI_X",
    "branch_table",
    "get_code",
    "parity",
    "DecoderConfig",
    "DecodeType",
    "DECODE_TYPES",
    "get_decode_config",
    "ViterbiDecoder",
    "DecoderState",
    "StreamingDecoder",
    "StreamingState",
    "__version__",
]
