#!/usr/bin/env python3
"""Randomized differential fuzz of the whole decode surface.

The reference's correctness strategy is cross-implementation
consistency on fixed cases (run_tests.cpp; SURVEY.md section 4).  This
tool extends it to the random cross-product the fixed matrix cannot
enumerate: random codes (K, R, G), random decode regimes and arithmetic
modes, random frame shapes, noisy channels, random chunk splits, and
random API paths (one-shot decode, chunked update, traced update) -
every path checked bit-for-bit against the NumPy oracle (ops/numpy_ref)
and against each other.

Usage:
  python tools/fuzz_differential.py [--cases N] [--seed S] [--cpu]
  python tools/fuzz_differential.py --minutes 30      # time-bounded

Exit 1 on the first mismatch, printing a standalone reproducer line.
Each case runs the XLA path and, where paths.select_path routes the
code elsewhere on this platform (the GPU kernels), that path too.
"""
import sys

sys.path.insert(0, ".")
sys.path.insert(0, "tools")

import argparse
import time

import numpy as np

from cli_common import apply_platform


def run_case(case_seed: int, verbose: bool = False) -> str:
    """One fuzz case; returns a short description (raises on mismatch)."""
    import jax.numpy as jnp

    from viterbidecodercpp_jax import (CodeSpec, DecodeType, ViterbiDecoder,
                                       get_decode_config)
    from viterbidecodercpp_jax.ops import jax_core
    from viterbidecodercpp_jax.ops import numpy_ref as ref
    from viterbidecodercpp_jax.paths import select_path

    rng = np.random.RandomState(case_seed)
    # codes up to K=11, and a small slice of big-state (K>=14) cases
    big = rng.rand() < 0.15
    K = int(rng.choice([14, 15]) if big else rng.randint(3, 12))
    R = int(rng.randint(2, 5))
    mask = (1 << K) - 1
    # top and bottom taps set => full constraint length actually used
    G = tuple(int(g) | 1 | (1 << (K - 1))
              for g in rng.randint(0, mask + 1, R))
    code = CodeSpec(f"fuzz-K{K}", K, G)
    dt = DecodeType(rng.choice(["SOFT16", "SOFT8", "HARD8"]))
    config = get_decode_config(dt, code.R)
    import dataclasses
    if rng.rand() < 0.3:
        config = dataclasses.replace(config, arith="wrapping")
    spec = jax_core.make_static_spec(code, config)

    B = int(rng.randint(1, 3 if big else 5))
    total_bits = int(rng.randint(8, 30 if big else 80))
    T = total_bits + K - 1
    syms = rng.randint(config.soft_decision_low,
                       config.soft_decision_high + 1,
                       (B, T * R)).astype(np.int32)

    # oracle
    want_bits, want_err = [], []
    for b in range(B):
        rb, re, _ = ref.viterbi_decode(code, config, syms[b], total_bits)
        want_bits.append(rb)
        want_err.append(re)
    want_bits = np.stack(want_bits)

    desc = (f"seed={case_seed} K={K} R={R} G={G} {dt.value} "
            f"{config.arith} B={B} bits={total_bits}")

    backends = sorted({"xla", select_path(spec).backend})
    for backend in backends:
        dec = ViterbiDecoder(code, config, backend=backend,
                             traceback_length=total_bits)
        st = dec.reset(B)
        # random chunking (multiples of R), 1..3 chunks
        nch = int(rng.randint(1, 4))
        cuts = sorted(rng.choice(np.arange(1, T), nch - 1,
                                 replace=False)) if nch > 1 else []
        prev = 0
        for cut in list(cuts) + [T]:
            st = dec.update(st, syms[:, prev * R:cut * R])
            prev = cut
        got = np.asarray(dec.chainback(st, total_bits))
        if not np.array_equal(got, want_bits):
            raise AssertionError(f"MISMATCH bits [{backend}] {desc}")
        gerr = np.asarray(dec.get_error(st))
        if not np.array_equal(gerr, np.asarray(want_err)):
            raise AssertionError(f"MISMATCH error [{backend}] {desc}")
        if rng.rand() < 0.3:
            # traced arm: the same decode with updates under one jit at a
            # random cut
            import jax

            cutb = int(rng.randint(1, T))

            @jax.jit
            def pipeline(st, a, b):
                return dec.update(dec.update(st, a), b)

            jsyms = jnp.asarray(syms)
            st2 = pipeline(dec.reset(B), jsyms[:, :cutb * R],
                           jsyms[:, cutb * R:])
            got2 = np.asarray(dec.chainback(st2, total_bits))
            if not np.array_equal(got2, want_bits):
                raise AssertionError(
                    f"MISMATCH traced [{backend}] {desc} cut={cutb}")
            if not np.array_equal(np.asarray(dec.get_error(st2)),
                                  np.asarray(want_err)):
                raise AssertionError(
                    f"MISMATCH traced error [{backend}] {desc} cut={cutb}")
    if not big and rng.rand() < 0.3:
        # puncture arm: a random periodic pattern at a random phase is
        # applied and undone (depuncture re-inflates with the neutral
        # midpoint, helpers/puncture_code_helpers.h:31-50); every
        # path must match the oracle on the re-inflated stream.
        from viterbidecodercpp_jax.codes import PunctureSpec
        from viterbidecodercpp_jax.ops import encoder as enc_ops
        from viterbidecodercpp_jax.puncture import puncture_np

        p = int(rng.randint(2, 9))
        pattern = rng.rand(p) < 0.7
        pattern[rng.randint(p)] = True
        phase = int(rng.randint(p))
        mask = PunctureSpec("fuzz-pi", tuple(pattern)).mask(T * R, phase)
        dep = np.asarray(enc_ops.depuncture(
            jnp.asarray(puncture_np(syms, mask)), mask, 0))
        dwant = np.stack([
            ref.viterbi_decode(code, config, dep[b], total_bits)[0]
            for b in range(B)])
        pdesc = f"{desc} pi={''.join('1' if x else '0' for x in pattern)}@{phase}"
        for backend in backends:
            dec = ViterbiDecoder(code, config, backend=backend,
                                 traceback_length=total_bits)
            st = dec.update(dec.reset(B), dep)
            got = np.asarray(dec.chainback(st, total_bits))
            if not np.array_equal(got, dwant):
                raise AssertionError(f"MISMATCH puncture [{backend}] {pdesc}")
    if verbose:
        print("ok", desc, flush=True)
    return desc


def main():
    apply_platform()
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=50)
    ap.add_argument("--minutes", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-v", action="store_true")
    args = ap.parse_args()

    t0 = time.time()
    n = 0
    while True:
        if args.minutes is not None:
            if (time.time() - t0) / 60 >= args.minutes:
                break
        elif n >= args.cases:
            break
        run_case(args.seed + n, args.v)
        n += 1
        if n % 10 == 0:
            # every case compiles fresh programs (unique K/R/G); drop
            # them or the in-process LLVM JIT eventually fails with
            # 'Cannot allocate memory' (observed after ~80 cases)
            import jax
            jax.clear_caches()
            print(f"[fuzz] {n} cases clean "
                  f"({(time.time() - t0) / 60:.1f} min)", flush=True)
    print(f"[fuzz] DONE: {n} cases, 0 mismatches")


if __name__ == "__main__":
    main()
