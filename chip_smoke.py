#!/usr/bin/env python3
"""Smoke test of the decoder on NVIDIA GPUs, through the user's entry points.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh paths only

One card, full size (all 8 registry codes x SOFT16/SOFT8/HARD8 at
B=512 frames x 2048 data bits, plus Voyager SOFT8 at B=1024 x T=2048):

1. device: a GPU must be JAX's first device; prints its kind and count,
   and the card's name and power limit from nvidia-smi;
2. ``ViterbiDecoder.decode`` on the path ``paths.select_path`` picks,
   against the plain XLA scan (``jax_core.acs_scan`` +
   ``chainback_scan``) with tolerance 0 - bits, end-state metric and
   accumulated renormalisation - and 2 frames per cell against
   ``ops/numpy_ref.py``; half the frames carry encoded data with noise
   that must decode exactly, half are random symbols;
3. ``reset -> update`` in chunks ``-> chainback`` equals the one-shot
   decode (Voyager, Cassini);
4. ``StreamingDecoder.push`` over a few windows against the full decode,
   and one ``ber.measure_point`` (Voyager SOFT8) against the reference
   decoder's BER;
5. the ``gpu``-marked tests (``pytest -m gpu``, in this process: a second
   JAX process could not get the card's memory);
6. ``compiled.memory_analysis()`` of the headline decode.

``--four``: ``frame_dp.decode_dp`` on a 4-card 'data' mesh, a mesh
``ber.measure_point`` and ``block_sp.decode_stream_sp`` on a 4-card
'time' mesh (one long Voyager stream, one long Cassini stream), each
bit-exact against the same work on one card.

Every phase must pass; the last line of standard output is the JSON
result, printed only then.  Without a GPU, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

B_CELL, BITS_CELL = 512, 2048          # 256-byte frames
B_HEAD, T_HEAD = 1024, 2048            # headline: Voyager SOFT8


def card_name_and_power_limit() -> str:
    """nvidia-smi's view of the card, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def block(x):
    import jax
    return jax.block_until_ready(x)


# -- inputs -----------------------------------------------------------------

def make_symbols(code, config, B, nbits, seed):
    """(B, (nbits+K-1)*R) int32 symbols and (B, nbits) data bits.

    Frames [0, B/2) are the tail-terminated encoding of random data with
    noise too weak to flip a decision (soft: |noise| < amplitude; hard:
    one flipped symbol in 64), so they must decode exactly.  Frames
    [B/2, B) are uniform random symbols: ties and renormalisations."""
    import jax
    import jax.numpy as jnp
    from viterbidecodercpp_jax.ops import encoder

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    hi, lo = config.soft_decision_high, config.soft_decision_low
    bits = jax.random.bernoulli(k1, 0.5, (B, nbits)).astype(jnp.uint8)
    clean = encoder.encode_symbols_jax(code, bits, hi, lo, True)
    clean = clean.reshape(B, -1)
    if hi - lo > 2:
        amp = (hi - lo) // 4
        noisy = clean + jax.random.randint(k2, clean.shape, -amp, amp + 1)
    else:
        flip = (jnp.arange(clean.shape[1]) % 64) == 17
        noisy = jnp.where(flip[None, :], hi + lo - clean, clean)
    rand = jax.random.randint(k3, clean.shape, lo, hi + 1)
    half = jnp.arange(B)[:, None] < B // 2
    syms = jnp.where(half, jnp.clip(noisy, lo, hi), rand)
    return syms.astype(jnp.int32), bits


def plain_xla(spec, syms, nbits):
    """The plain reference on the card: acs_scan + chainback_scan."""
    import jax
    import jax.numpy as jnp
    from viterbidecodercpp_jax.ops import jax_core

    @jax.jit
    def run(syms):
        B = syms.shape[0]
        m, packed, acc = jax_core.acs_scan(
            spec, jax_core.initial_metrics(spec, B),
            syms.reshape(B, -1, spec.R))
        bits = jax_core.chainback_scan(spec, packed,
                                       jnp.zeros(B, jnp.int32), nbits)
        return bits, m[0], acc

    return block(run(syms))


# -- phases -----------------------------------------------------------------

def phase_decode():
    import jax
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax.ops import numpy_ref

    cells = [(code, dt, B_CELL, BITS_CELL)
             for code in vt.COMMON_CODES for dt in vt.DECODE_TYPES]
    voyager = vt.get_code("Voyager")
    cells.append((voyager, vt.DecodeType.SOFT8, B_HEAD,
                  T_HEAD - (voyager.K - 1)))
    for i, (code, dt, B, nbits) in enumerate(cells):
        config = vt.get_decode_config(dt, code.R)
        dec = vt.ViterbiDecoder(code, config, traceback_length=nbits)
        syms, data = make_symbols(code, config, B, nbits, seed=i)
        t0 = time.perf_counter()
        bits, err, acc = block(dec.decode(syms, nbits))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        block(dec.decode(syms, nbits))
        warm = time.perf_counter() - t0
        rbits, rerr, racc = plain_xla(dec.spec, syms, nbits)
        bits, err, acc = map(np.asarray, (bits, err, acc))
        name = f"{code.name} {dt.value} B={B} bits={nbits}"
        check(np.array_equal(bits, np.asarray(rbits)), f"{name}: bits")
        check(np.array_equal(err, np.asarray(rerr)), f"{name}: metric")
        check(np.array_equal(acc, np.asarray(racc)), f"{name}: renorm")
        check(np.array_equal(bits[:B // 2], np.asarray(data)[:B // 2]),
              f"{name}: noisy encoded frames did not decode exactly")
        syms_h = np.asarray(syms)
        for b in (0, B - 1):
            ob, oerr, oacc = numpy_ref.viterbi_decode(code, config,
                                                      syms_h[b], nbits)
            check(np.array_equal(bits[b], ob) and int(err[b]) == oerr
                  and int(acc[b]) == oacc, f"{name}: frame {b} vs numpy_ref")
        print(f"decode {name} path={dec.backend} first_call_s={first} "
              f"warm_s={warm} exact=yes", flush=True)
        del bits, rbits, syms
    jax.clear_caches()


def phase_chunked():
    import viterbidecodercpp_jax as vt

    for name, dt in (("Voyager", vt.DecodeType.SOFT16),
                     ("Cassini", vt.DecodeType.SOFT8)):
        code = vt.get_code(name)
        config = vt.get_decode_config(dt, code.R)
        dec = vt.ViterbiDecoder(code, config, traceback_length=BITS_CELL)
        syms, _ = make_symbols(code, config, B_CELL, BITS_CELL, seed=100)
        one_bits, one_err, one_acc = block(dec.decode(syms, BITS_CELL))
        state = dec.reset(B_CELL)
        T = BITS_CELL + code.K - 1
        for lo, hi in ((0, 333), (333, 1500), (1500, T)):
            state = dec.update(state, syms[:, lo * code.R:hi * code.R])
        bits = block(dec.chainback(state, BITS_CELL))
        check(np.array_equal(np.asarray(bits), np.asarray(one_bits))
              and np.array_equal(np.asarray(dec.get_error(state)),
                                 np.asarray(one_err))
              and np.array_equal(np.asarray(state.accumulated_error),
                                 np.asarray(one_acc)),
              f"{name}: chunked update + chainback != one-shot decode")
        print(f"chunked {name} {dt.value} path={dec.backend} exact=yes",
              flush=True)
        del state


def phase_streaming_ber():
    import jax
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax import ber

    code = vt.get_code("Voyager")
    config = vt.get_decode_config(vt.DecodeType.SOFT8, code.R)
    window, chunk = 256, 64
    sd = vt.StreamingDecoder(code, config, window=window, chunk=chunk)
    syms, data = make_symbols(code, config, B_CELL, BITS_CELL, seed=200)
    full_bits, _, _ = vt.ViterbiDecoder(code, config).decode(syms,
                                                             BITS_CELL)
    T = BITS_CELL + code.K - 1
    n_push = -(-(T + window + chunk) // chunk)
    stream = np.zeros((B_CELL, n_push * chunk * code.R), np.int32)
    stream[:, :T * code.R] = np.asarray(syms)
    state = sd.reset(B_CELL)
    out = []
    t0 = time.perf_counter()
    for i in range(n_push):
        state, bits, valid = sd.push(
            state, stream[:, i * chunk * code.R:(i + 1) * chunk * code.R])
        if bool(valid):
            out.append(np.asarray(bits))
    dt_push = (time.perf_counter() - t0) / n_push
    got = np.concatenate(out, axis=1)[:, code.K - 1:code.K - 1 + BITS_CELL]
    half = B_CELL // 2
    check(np.array_equal(got[:half], np.asarray(full_bits)[:half]),
          "streaming != full decode on the noisy encoded frames")
    check(np.array_equal(got[:half], np.asarray(data)[:half]),
          "streaming did not recover the data")
    print(f"streaming Voyager SOFT8 B={B_CELL} window={window} "
          f"chunk={chunk} path={sd.backend} pushes={n_push} "
          f"mean_push_s={dt_push} exact=yes", flush=True)

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data_ber_reference_voyager.json")) as f:
        refs = {r["decode_type"]: dict(zip(r["EbNo_dB"], r["ber"]))
                for r in json.load(f) if r["name"] == "Voyager"}
    want = refs["SOFT8"][2.0]
    t0 = time.perf_counter()
    p = ber.measure_point(code, config, 2.0, key=jax.random.PRNGKey(7),
                          block_bits=4096, batch=256, max_bits=1 << 23,
                          max_errors=100_000)
    took = time.perf_counter() - t0
    n = p.total_bit_errors
    slack = max(1.3, 1 + 5 / np.sqrt(max(n, 1)))
    check(p.total_bits >= 1 << 23 and want / slack <= p.ber <= want * slack,
          f"BER {p} vs reference {want}")
    print(f"ber Voyager SOFT8 2.0dB ber={p.ber} errors={n} "
          f"bits={p.total_bits} reference={want} seconds={took}", flush=True)


def phase_marked_tests():
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    check(rc == 0, f"pytest -m gpu exited {rc}")


def phase_memory():
    import jax.numpy as jnp
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax import decoder

    code = vt.get_code("Voyager")
    dec = vt.ViterbiDecoder(code, "SOFT8")
    nbits = T_HEAD - (code.K - 1)
    syms = jnp.zeros((B_HEAD, T_HEAD, code.R), jnp.int32)
    compiled = decoder._decode_jit.lower(dec.spec, dec.path, nbits, 0,
                                         syms).compile()
    print(f"memory_analysis headline decode path={dec.backend}: "
          f"{compiled.memory_analysis()}", flush=True)


def phase_four_cards():
    import jax
    import jax.numpy as jnp
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax import ber
    from viterbidecodercpp_jax.parallel import block_sp, frame_dp
    from viterbidecodercpp_jax.parallel.mesh import make_mesh
    from viterbidecodercpp_jax.paths import select_path
    from viterbidecodercpp_jax.utils import testsig

    one = jax.devices()[0]
    data_mesh = make_mesh((4,), ("data",))
    time_mesh = make_mesh((4,), ("time",))

    # frame-DP: every code's SOFT8 cell over the 'data' mesh
    for i, code in enumerate(vt.COMMON_CODES):
        config = vt.get_decode_config(vt.DecodeType.SOFT8, code.R)
        dec = vt.ViterbiDecoder(code, config)
        syms, _ = make_symbols(code, config, B_CELL, BITS_CELL, seed=300 + i)
        want = np.asarray(dec.decode(jax.device_put(syms, one), BITS_CELL)[0])
        got, _ = frame_dp.decode_dp(dec.spec, data_mesh,
                                    syms.reshape(B_CELL, -1, code.R),
                                    BITS_CELL)
        check(np.array_equal(np.asarray(got), want),
              f"frame_dp {code.name}: 4 cards != 1 card")
        print(f"four frame_dp {code.name} SOFT8 B={B_CELL} "
              f"path={dec.backend} exact=yes", flush=True)

    # mesh BER: one iteration on 4 cards == the same 4 sub-batches decoded
    # on one card
    code = vt.get_code("Voyager")
    config = vt.get_decode_config(vt.DecodeType.SOFT8, code.R)
    spec = vt.ViterbiDecoder(code, config).spec
    key, batch, bb, ebno = jax.random.PRNGKey(11), 256, 2048, 2.0
    p = ber.measure_point(code, config, ebno, key=key, block_bits=bb,
                          batch=batch, max_bits=4 * batch * bb,
                          max_errors=1 << 30, mesh=data_mesh)
    path = select_path(spec, data_mesh.devices.flat[0].platform)
    errors = 0
    for k in jax.random.split(key, 4):
        _, k1, k2 = jax.random.split(k, 3)
        tx = jax.random.bernoulli(k1, 0.5, (batch, bb)).astype(jnp.uint8)
        rx_syms = testsig.awgn_quantize(testsig.modulate_encode(code, tx),
                                        k2, jnp.float32(ebno), code.R, spec)
        rx = ber._decode_for_ber(spec, path, rx_syms, bb)
        errors += int(testsig.count_bit_errors(rx, tx))
    check(p.total_bits == 4 * batch * bb and p.total_bit_errors == errors,
          f"mesh BER {p} != one-card {errors} errors")
    print(f"four ber Voyager SOFT8 errors={errors} bits={p.total_bits} "
          "exact=yes", flush=True)

    # time-SP: one long stream per code over the 'time' mesh
    for name, nbits, overlap in (("Voyager", 1 << 18, 256),
                                 ("Cassini", 1 << 15, 512)):
        code = vt.get_code(name)
        config = vt.get_decode_config(vt.DecodeType.SOFT16, code.R)
        dec = vt.ViterbiDecoder(code, config)
        syms, data = make_symbols(code, config, 2, nbits, seed=400)
        syms = syms[:1]
        want = np.asarray(dec.decode(jax.device_put(syms, one), nbits)[0])
        T = nbits + code.K - 1
        pad_T = -(-T // 4) * 4
        arr = jnp.zeros((1, pad_T, code.R), jnp.int32)
        arr = arr.at[:, :T].set(syms.reshape(1, T, code.R))
        t0 = time.perf_counter()
        bits, mism = block(block_sp.decode_stream_sp(
            dec.spec, time_mesh, arr, overlap=overlap, total_rows=T))
        took = time.perf_counter() - t0
        got = np.asarray(bits)[:, code.K - 1:code.K - 1 + nbits]
        check(int(mism) == 0 and np.array_equal(got, want)
              and np.array_equal(got, np.asarray(data)[:1]),
              f"block_sp {name}: 4 cards != 1 card")
        print(f"four block_sp {name} SOFT16 bits={nbits} overlap={overlap} "
              f"path={dec.backend} seconds={took} exact=yes", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh paths only")
    args = ap.parse_args(argv)

    import jax
    from viterbidecodercpp_jax.utils import compile_cache

    compile_cache.enable()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU; JAX found {devices[0].platform!r} "
                 "devices")
    need = 4 if args.four else 1
    if len(devices) < need:
        sys.exit(f"chip_smoke: need {need} GPUs, have {len(devices)}")
    print(f"device platform={devices[0].platform} "
          f"kind={devices[0].device_kind} count={len(devices)}", flush=True)
    print(card_name_and_power_limit(), flush=True)

    phases = ([phase_four_cards] if args.four else
              [phase_decode, phase_chunked, phase_streaming_ber,
               phase_marked_tests, phase_memory])
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        print(f"phase {phase.__name__} ok seconds="
              f"{time.perf_counter() - t0}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
