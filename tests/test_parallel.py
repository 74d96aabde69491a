"""Mesh-parallel decode tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from viterbidecodercpp_jax import DecodeType, get_code, get_decode_config
from viterbidecodercpp_jax.ops import jax_core, numpy_ref as ref
from viterbidecodercpp_jax.parallel import block_sp, frame_dp
from viterbidecodercpp_jax.paths import select_path


def test_frame_dp_exact_and_psum(mesh_of):
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    mesh = mesh_of((8,), ("data",))
    rng = np.random.RandomState(0)
    B, nbytes = 16, 8
    data = rng.randint(0, 256, (B, nbytes), dtype=np.uint8)
    syms = np.stack([ref.encode_bytes(code, d, 127, -127) for d in data])
    T = syms.shape[1] // code.R
    total_bits = nbytes * 8
    ref_bits = np.unpackbits(data, axis=1, bitorder="big")
    bits, errs = frame_dp.decode_dp(
        spec, mesh, jnp.asarray(syms.reshape(B, T, code.R)), total_bits,
        reference_bits=jnp.asarray(ref_bits))
    assert int(errs) == 0
    np.testing.assert_array_equal(np.asarray(bits), ref_bits)
    # without a reference the error count is the documented 0 (it used
    # to be the popcount of the decoded bits)
    bits2, errs2 = frame_dp.decode_dp(
        spec, mesh, jnp.asarray(syms.reshape(B, T, code.R)), total_bits)
    assert int(errs2) == 0
    np.testing.assert_array_equal(np.asarray(bits2), ref_bits)


def test_block_sp_matches_sequential_with_noise(mesh_of):
    # Noisy stream: time-sharded decode must agree with the sequential
    # decode everywhere (overlap large enough for convergence).
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    ntime = 4
    mesh = mesh_of((ntime,), ("time",))
    rng = np.random.RandomState(3)
    nbytes = 64
    data = rng.randint(0, 256, nbytes, dtype=np.uint8)
    syms = ref.encode_bytes(code, data, 127, -127).astype(np.int64)
    syms = np.clip(syms + rng.randint(-40, 41, syms.shape), -127, 127)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    pad_T = -(-T // ntime) * ntime
    arr = np.zeros((1, pad_T, code.R), np.int32)
    arr[0, :T] = syms.reshape(T, code.R)

    bits, mism = block_sp.decode_stream_sp(spec, mesh, jnp.asarray(arr),
                                           overlap=96, total_rows=T)
    assert int(mism) == 0
    got = np.asarray(bits)[0, code.K - 1:code.K - 1 + total_bits]
    expect_bits, _, _ = ref.viterbi_decode(code, config,
                                           syms, total_bits)
    np.testing.assert_array_equal(got, expect_bits)
    np.testing.assert_array_equal(np.packbits(got, bitorder="big"), data)


def test_dryrun_entrypoints(need_devices):
    import __graft_entry__ as g

    need_devices(8)
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    g.dryrun_multichip(8)


def test_block_sp_cassini_long_stream(mesh_of):
    """BASELINE config 5: K=15 Cassini, a long stream tiled over the
    'time' mesh axis with block traceback (the multi-host long-stream
    pattern), exact vs the sequential oracle on a clean channel."""
    code = get_code("Cassini")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    ntime = 2
    mesh = mesh_of((ntime,), ("time",))
    rng = np.random.RandomState(7)
    nbytes = 24
    data = rng.randint(0, 256, nbytes, dtype=np.uint8)
    syms = ref.encode_bytes(code, data, 127, -127).astype(np.int64)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    pad_T = -(-T // ntime) * ntime
    arr = np.zeros((1, pad_T, code.R), np.int32)
    arr[0, :T] = syms.reshape(T, code.R)

    bits, mism = block_sp.decode_stream_sp(spec, mesh, jnp.asarray(arr),
                                           overlap=64, total_rows=T)
    assert int(mism) == 0
    got = np.asarray(bits)[0, code.K - 1:code.K - 1 + total_bits]
    np.testing.assert_array_equal(np.packbits(got, bitorder="big"), data)


def test_block_sp_2d_mesh_data_x_time(mesh_of):
    """Frame-DP composed with time-SP on one 2-D (data x time) mesh:
    every device decodes a (B/2, T/4) tile; results match sequential."""
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    mesh = mesh_of((2, 4), ("data", "time"))
    rng = np.random.RandomState(13)
    nbytes = 64
    B = 2
    data = rng.randint(0, 256, (B, nbytes), dtype=np.uint8)
    syms = np.stack([ref.encode_bytes(code, d, 127, -127) for d in data])
    syms = np.clip(syms.astype(np.int64)
                   + rng.randint(-30, 31, syms.shape), -127, 127)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    ntime = 4
    pad_T = -(-T // ntime) * ntime
    arr = np.zeros((B, pad_T, code.R), np.int32)
    arr[:, :T] = syms.reshape(B, T, code.R)

    bits, mism = block_sp.decode_stream_sp(spec, mesh, jnp.asarray(arr),
                                           overlap=96, total_rows=T)
    assert int(mism) == 0
    for f in range(B):
        got = np.asarray(bits)[f, code.K - 1:code.K - 1 + total_bits]
        expect, _, _ = ref.viterbi_decode(code, config, syms[f], total_bits)
        np.testing.assert_array_equal(got, expect)


def test_punctured_stream_over_time_mesh(mesh_of):
    """Realistic composition: DAB FIC punctured stream, depunctured and
    decoded with the time axis sharded over the mesh - exact recovery."""
    from viterbidecodercpp_jax import CodeSpec, puncture
    from viterbidecodercpp_jax.ops import encoder

    code = CodeSpec("DAB FIC mother", 7, (109, 79, 83, 109))
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    sched = puncture.dab_fic_schedule(code)
    mask = puncture.schedule_mask(sched)
    total_bits = 32 * 24
    rng = np.random.RandomState(21)
    data = rng.randint(0, 256, total_bits // 8, dtype=np.uint8)
    full = ref.encode_bytes(code, data, 127, -127)
    kept = full[mask.astype(bool)]
    rx = np.asarray(encoder.depuncture(jnp.asarray(kept[None, :]), mask,
                                       neutral=0))
    ntime = 4
    T = total_bits + code.K - 1
    pad_T = -(-T // ntime) * ntime
    arr = np.zeros((1, pad_T, code.R), np.int32)
    arr[0, :T] = rx.reshape(T, code.R)
    mesh = mesh_of((ntime,), ("time",))
    bits, mism = block_sp.decode_stream_sp(spec, mesh, jnp.asarray(arr),
                                           overlap=96, total_rows=T)
    assert int(mism) == 0
    got = np.asarray(bits)[0, code.K - 1:code.K - 1 + total_bits]
    np.testing.assert_array_equal(np.packbits(got, bitorder="big"), data)


def test_frame_dp_cassini_xla(mesh_of):
    """K=15 frames sharded over the mesh run the big-state XLA decode
    (the rotated-layout scan of ops/bigstate) inside shard_map."""
    code = get_code("Cassini")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    mesh = mesh_of((2,), ("data",))
    rng = np.random.RandomState(1)
    B, nbytes = 2, 3
    data = rng.randint(0, 256, (B, nbytes), dtype=np.uint8)
    syms = np.stack([ref.encode_bytes(code, d, 127, -127) for d in data])
    T = syms.shape[1] // code.R
    total_bits = nbytes * 8
    ref_bits = np.unpackbits(data, axis=1, bitorder="big")
    bits, errs = frame_dp.decode_dp(
        spec, mesh, jnp.asarray(syms.reshape(B, T, code.R)), total_bits,
        reference_bits=jnp.asarray(ref_bits))
    assert int(errs) == 0
    np.testing.assert_array_equal(np.asarray(bits), ref_bits)


def test_block_sp_cassini_2d_mesh_with_noise(mesh_of):
    """K=15 time-SP composed with frame-DP on a 2-D data x time mesh,
    noisy HARD8 channel, vs the sequential oracle."""
    code = get_code("Cassini")
    config = get_decode_config(DecodeType.HARD8, code.R)
    spec = jax_core.make_static_spec(code, config)
    mesh = mesh_of((2, 2), ("data", "time"))
    rng = np.random.RandomState(9)
    B, nbytes = 2, 24
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    pad_T = -(-T // 2) * 2
    arr = np.zeros((B, pad_T, code.R), np.int32)
    seq = np.zeros((B, total_bits), np.uint8)
    hi, lo = config.soft_decision_high, config.soft_decision_low
    for b in range(B):
        data = rng.randint(0, 256, nbytes, dtype=np.uint8)
        syms = ref.encode_bytes(code, data, hi, lo).astype(np.int64)
        flip = rng.rand(syms.size) < 0.02
        syms = np.where(flip, hi + lo - syms, syms)
        arr[b, :T] = syms.reshape(T, code.R)
        seq[b], _, _ = ref.viterbi_decode(code, config, syms, total_bits)

    bits, mism = block_sp.decode_stream_sp(spec, mesh, jnp.asarray(arr),
                                           overlap=64, total_rows=T)
    assert int(mism) == 0
    got = np.asarray(bits)[:, code.K - 1:code.K - 1 + total_bits]
    np.testing.assert_array_equal(got, seq)


def test_block_sp_exact_at_stream_head_with_noise(mesh_of):
    """Device 0 decodes from the true reset metrics (no zero-symbol
    warm-up that would erase the prior): with noise confined to the
    first rows, the SP decode must match the sequential decoder
    bit-for-bit even at the stream head."""
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    ntime = 2
    mesh = mesh_of((ntime,), ("time",))
    rng = np.random.RandomState(0)
    nbytes = 64
    data = rng.randint(0, 256, nbytes, dtype=np.uint8)
    syms = ref.encode_bytes(code, data, 127, -127).astype(np.int64)
    # obliterate the head: pure noise for the first 4K trellis steps -
    # on this input a uniform-prior start decodes 4 bits differently
    # from the reset-prior start, so the test discriminates
    head = 4 * code.K * code.R
    syms[:head] = rng.randint(-127, 128, head)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    pad_T = -(-T // ntime) * ntime
    arr = np.zeros((1, pad_T, code.R), np.int32)
    arr[0, :T] = syms.reshape(T, code.R)

    seq_bits, _, _ = ref.viterbi_decode(code, config, syms, total_bits)
    bits, mism = block_sp.decode_stream_sp(spec, mesh, jnp.asarray(arr),
                                           overlap=128, total_rows=T)
    assert int(mism) == 0
    got = np.asarray(bits)[0, code.K - 1:code.K - 1 + total_bits]
    np.testing.assert_array_equal(got, seq_bits)


def test_block_sp_halo_diagnostic_detects_undersized_overlap(mesh_of):
    """A hostile channel with an overlap far below the convergence
    length must surface as nonzero halo mismatches - the silent-wrong-
    interior failure mode becomes observable (VERDICT round-1 weak #5).
    """
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    ntime = 4
    mesh = mesh_of((ntime,), ("time",))
    rng = np.random.RandomState(5)
    total_bits = 1024
    T = total_bits + code.K - 1
    pad_T = -(-T // ntime) * ntime
    # pure noise: survivor paths cannot merge within a tiny overlap
    arr = rng.randint(-127, 128, (1, pad_T, code.R)).astype(np.int32)

    bits, mism = block_sp.decode_stream_sp(spec, mesh, jnp.asarray(arr),
                                           overlap=2, total_rows=T)
    assert int(mism) > 0
    # and a generous overlap on a clean stream reports zero (covered by
    # every exact-decode test above; sanity-check one here)
    data = rng.randint(0, 256, total_bits // 8, dtype=np.uint8)
    syms = ref.encode_bytes(code, data, 127, -127)
    arr2 = np.zeros((1, pad_T, code.R), np.int32)
    arr2[0, :T] = syms.reshape(T, code.R)
    _, mism2 = block_sp.decode_stream_sp(spec, mesh, jnp.asarray(arr2),
                                         overlap=96, total_rows=T)
    assert int(mism2) == 0


def test_ber_point_mesh_data_parallel(mesh_of):
    """measure_point(mesh=...): the BER point runs data-parallel over
    the 8-device mesh (device-folded PRNG streams, psum'd global
    budgets) - the mesh analogue of the reference's thread-pooled
    BER tasks (run_snr_ber.cpp:255-277).  Deterministic for a fixed
    key, statistically consistent with the single-device path, and the
    global bit budget is honoured."""
    from viterbidecodercpp_jax import ber

    code = get_code("Basic K=3 R=1/2")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    mesh = mesh_of((8,), ("data",))
    kw = dict(block_bits=512, batch=8, max_bits=400_000,
              max_errors=1_000_000)
    key = jax.random.PRNGKey(5)
    p1 = ber.measure_point(code, config, 0.0, key=key, mesh=mesh, **kw)
    p2 = ber.measure_point(code, config, 0.0, key=key, mesh=mesh, **kw)
    assert (p1.ber, p1.total_bits) == (p2.ber, p2.total_bits)
    # global budget: stops at the first iteration crossing max_bits
    assert p1.total_bits >= 400_000
    assert p1.total_bits % (8 * 8 * 512) == 0
    # ~0.105 BER at 0 dB for this code; generous statistical window
    single = ber.measure_point(code, config, 0.0,
                               key=jax.random.PRNGKey(6), **kw)
    assert 0.8 < p1.ber / single.ber < 1.25

    # the timeout/slice path re-enters the compiled program with carried
    # totals; totals must keep accumulating exactly
    p3 = ber.measure_point(code, config, 0.0, key=key, mesh=mesh,
                           timeout_seconds=1e9, **kw)
    assert p3.total_bits >= 400_000


def _interpreted_kernels(spec):
    return select_path(spec, "cpu", "pallas", interpret=True)


def test_block_sp_gpu_kernel_voyager_with_noise(mesh_of):
    """The GPU ACS kernel (Pallas interpreter) per time-tile inside
    shard_map: must match the sequential decoder bit-for-bit on a noisy
    channel."""
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    ntime = 4
    mesh = mesh_of((ntime,), ("time",))
    rng = np.random.RandomState(3)
    nbytes = 96
    data = rng.randint(0, 256, nbytes, dtype=np.uint8)
    syms = ref.encode_bytes(code, data, 127, -127).astype(np.int64)
    syms = np.clip(syms + rng.randint(-40, 41, syms.shape), -127, 127)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    pad_T = -(-T // ntime) * ntime
    arr = np.zeros((1, pad_T, code.R), np.int32)
    arr[0, :T] = syms.reshape(T, code.R)

    seq_bits, _, _ = ref.viterbi_decode(code, config, syms, total_bits)
    bits, mism = block_sp.decode_stream_sp(
        spec, mesh, jnp.asarray(arr), overlap=128, total_rows=T,
        backend=_interpreted_kernels(spec))
    assert int(mism) == 0
    got = np.asarray(bits)[0, code.K - 1:code.K - 1 + total_bits]
    np.testing.assert_array_equal(got, seq_bits)


def test_frame_dp_gpu_kernels_k9(mesh_of):
    """K=9 frames over the 'data' mesh through the GPU ACS and walk
    kernels (Pallas interpreter) inside shard_map, noisy channel, vs the
    sequential oracle."""
    code = get_code("CDMA IS-95A")
    config = get_decode_config(DecodeType.SOFT8, code.R)
    spec = jax_core.make_static_spec(code, config)
    mesh = mesh_of((4,), ("data",))
    rng = np.random.RandomState(11)
    B, nbytes = 8, 16
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    arr = np.zeros((B, T, code.R), np.int32)
    seq = np.zeros((B, total_bits), np.uint8)
    hi, lo = config.soft_decision_high, config.soft_decision_low
    for b in range(B):
        data = rng.randint(0, 256, nbytes, dtype=np.uint8)
        syms = ref.encode_bytes(code, data, hi, lo).astype(np.int64)
        syms = np.clip(syms + rng.randint(-1, 2, syms.shape), lo, hi)
        arr[b] = syms.reshape(T, code.R)
        seq[b], _, _ = ref.viterbi_decode(code, config, syms, total_bits)

    bits, errs = frame_dp.decode_dp(
        spec, mesh, jnp.asarray(arr), total_bits,
        backend=_interpreted_kernels(spec), reference_bits=jnp.asarray(seq))
    assert int(errs) == 0
    np.testing.assert_array_equal(np.asarray(bits), seq)
