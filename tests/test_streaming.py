"""Bounded-latency streaming decoder vs the full (batch) decode."""

import numpy as np
import pytest

from viterbidecodercpp_jax import get_code
from viterbidecodercpp_jax.ops import numpy_ref as ref
from viterbidecodercpp_jax.streaming import StreamingDecoder


def test_streaming_matches_full_decode():
    code = get_code("Voyager")
    window, chunk = 256, 64
    sd = StreamingDecoder(code, "SOFT16", window=window, chunk=chunk,
                          backend="xla")
    rng = np.random.RandomState(6)
    nbytes = 256
    data = rng.randint(0, 256, (2, nbytes), dtype=np.uint8)
    syms = np.stack([ref.encode_bytes(code, d, 127, -127) for d in data]
                    ).astype(np.int64)
    syms = np.clip(syms + rng.randint(-10, 11, syms.shape), -127, 127)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    # pad the tail so the last chunks flush through the window
    pad_rows = window + chunk
    sym_stream = np.zeros((2, (T + pad_rows) * code.R), np.int32)
    sym_stream[:, :T * code.R] = syms

    state = sd.reset(2)
    emitted = []
    n_push = (T + pad_rows) // chunk
    for i in range(n_push):
        blk = sym_stream[:, i * chunk * code.R:(i + 1) * chunk * code.R]
        state, bits, valid = sd.push(state, blk)
        if bool(valid):
            emitted.append(np.asarray(bits))
    stream = np.concatenate(emitted, axis=1)

    # emitted bit j (after the first K-1 warmup rows) = data bit j
    got = stream[:, code.K - 1:code.K - 1 + total_bits]
    expect = np.unpackbits(data, axis=1, bitorder="big")
    np.testing.assert_array_equal(got, expect)


def test_streaming_latency_and_priming():
    code = get_code("Basic K=5 R=1/2")
    sd = StreamingDecoder(code, "HARD8", window=64, chunk=16, backend="xla")
    state = sd.reset(1)
    primed_at = None
    for i in range(8):
        blk = np.zeros((1, 16 * code.R), np.int32)
        state, bits, valid = sd.push(state, blk)
        if bool(valid) and primed_at is None:
            primed_at = i
    assert primed_at == 64 // 16 - 1  # valid once window rows are in

    with pytest.raises(ValueError):
        sd.push(state, np.zeros((1, 8), np.int32))  # wrong chunk size
    with pytest.raises(ValueError):
        StreamingDecoder(code, "HARD8", window=60, chunk=16)


def test_streaming_k15_xla():
    """K=15 streams through the XLA path: committed bits must match the
    encoded data, including pushes whose chunk is NOT a multiple of K-1."""
    code = get_code("Cassini")
    window, chunk = 56, 8          # chunk % 14 != 0
    sd = StreamingDecoder(code, "SOFT16", window=window, chunk=chunk,
                          backend="xla")
    rng = np.random.RandomState(7)
    nbytes = 16
    data = rng.randint(0, 256, (1, nbytes), dtype=np.uint8)
    syms = np.stack([ref.encode_bytes(code, d, 127, -127) for d in data]
                    ).astype(np.int64)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    pad_rows = window + chunk
    n_push = -(-(T + pad_rows) // chunk)
    sym_stream = np.zeros((1, n_push * chunk * code.R), np.int32)
    sym_stream[:, :T * code.R] = syms

    state = sd.reset(1)
    emitted = []
    for i in range(n_push):
        blk = sym_stream[:, i * chunk * code.R:(i + 1) * chunk * code.R]
        state, bits, valid = sd.push(state, blk)
        if bool(valid):
            emitted.append(np.asarray(bits))
    stream = np.concatenate(emitted, axis=1)
    got = stream[:, code.K - 1:code.K - 1 + total_bits]
    expect = np.unpackbits(data, axis=1, bitorder="big")
    np.testing.assert_array_equal(got, expect)


def test_streaming_gpu_kernels_match_xla():
    """The GPU kernels (Pallas interpreter) behind StreamingDecoder: the
    committed bits and metrics must match the XLA stream bit-for-bit."""
    from viterbidecodercpp_jax.paths import select_path

    code = get_code("Voyager")
    window, chunk = 72, 9
    sx = StreamingDecoder(code, "SOFT8", window=window, chunk=chunk,
                          backend="xla")
    sp = StreamingDecoder(
        code, "SOFT8", window=window, chunk=chunk,
        backend=select_path(sx.spec, "cpu", "pallas", interpret=True))
    assert sp.backend == "pallas"
    rng = np.random.RandomState(8)
    n_push = 16
    stp, stx = sp.reset(2), sx.reset(2)
    for _ in range(n_push):
        blk = rng.randint(-3, 4, (2, chunk * code.R)).astype(np.int32)
        stp, bp, vp = sp.push(stp, blk)
        stx, bx, vx = sx.push(stx, blk)
        assert bool(vp) == bool(vx)
        if bool(vp):
            np.testing.assert_array_equal(np.asarray(bp), np.asarray(bx))
    np.testing.assert_array_equal(np.asarray(stp.metrics),
                                  np.asarray(stx.metrics))
