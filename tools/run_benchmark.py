#!/usr/bin/env python3
"""Throughput benchmark (parity with examples/run_benchmark.cpp).

Per (code, decode_type, backend) combination, times the ACS update and
chainback separately and emits JSON rows with the reference's schema
(run_benchmark.cpp:297-327): name, decode_type, simd_type, K, R, G,
total_input_bits, total_symbols, update_symbols_ns, chainback_bits_ns
(lists of per-sample wall times in ns), so the reference's
parse_benchmark.py works unmodified.

Differences from the reference harness, by design:
  * "simd_type" carries the decode path (XLA / PALLAS) - the device has
    one kernel per path, not per-ISA variants; the paths listed for a
    code are the ones paths.select_path can give it on this platform.
  * each sample decodes a *batch* of frames (frame-DP replaces the
    thread pool); rates are aggregate symbols/s per device.
  * each sample is one update (or chainback) call ending in
    block_until_ready, repeated for the duration, like the
    duration-bounded repeat loop of run_benchmark.cpp:267-283.

Flags: -c code_index  -d decode_type  -s backend  -B batch
       -M input_bytes -T seconds_per_combo -o out.json
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def bench_combo(code, decode_type, backend, batch, nbytes, seconds):
    import jax
    import jax.numpy as jnp
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax.ops import jax_core
    from viterbidecodercpp_jax.paths import select_path

    config = vt.get_decode_config(decode_type, code.R)
    spec = jax_core.make_static_spec(code, config)
    path = select_path(spec, backend=backend.lower())
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    rng = np.random.RandomState(0)
    syms = jnp.asarray(rng.randint(config.soft_decision_low,
                                   config.soft_decision_high + 1,
                                   (batch, T, code.R)).astype(np.int32))
    m0 = jax_core.initial_metrics(spec, batch)
    ends = jnp.zeros(batch, jnp.int32)
    update = jax.jit(lambda m, s: path.update(spec, m, s))
    chainback = jax.jit(lambda p, e: path.chainback(spec, p, e, total_bits))

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a))
        return time.perf_counter() - t0, out

    _, (_, packed, _) = timed(update, m0, syms)    # compile
    timed(chainback, packed, ends)
    update_ns, chainback_ns = [], []
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        update_ns.append(int(timed(update, m0, syms)[0] * 1e9))
        chainback_ns.append(int(timed(chainback, packed, ends)[0] * 1e9))

    return {
        "name": code.name,
        "decode_type": decode_type.value,
        "simd_type": backend,
        "K": code.K,
        "R": code.R,
        "G": list(code.G),
        "batch": batch,
        "total_input_bits": batch * total_bits,
        "total_symbols": batch * T * code.R,
        "update_symbols_ns": update_ns,
        "chainback_bits_ns": chainback_ns,
    }


def main():
    from cli_common import (add_list_flag, apply_platform,
                            handle_list_flag)
    apply_platform()   # --cpu, before any backend starts
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax.ops import jax_core
    from viterbidecodercpp_jax.paths import select_path

    ap = argparse.ArgumentParser()
    ap.add_argument("-c", type=int, default=None, help="code index filter")
    ap.add_argument("-d", default=None,
                    choices=["soft16", "soft8", "hard8"])
    ap.add_argument("-s", default=None, choices=["xla", "pallas"])
    ap.add_argument("-B", type=int, default=512, help="frames per batch")
    ap.add_argument("-M", type=int, default=256, help="input bytes/frame")
    ap.add_argument("-T", type=float, default=2.0, help="seconds per combo")
    ap.add_argument("-o", default=None, help="output file (default stdout)")
    add_list_flag(ap)
    args = ap.parse_args()
    if handle_list_flag(args):
        return 0

    rows = []
    for ci, code in enumerate(vt.COMMON_CODES):
        if args.c is not None and ci != args.c:
            continue
        for dt in vt.DECODE_TYPES:
            if args.d and dt.value.lower() != args.d:
                continue
            spec = jax_core.make_static_spec(
                code, vt.get_decode_config(dt, code.R))
            # the routed path, plus XLA as the comparison
            backends = sorted({select_path(spec).backend.upper(), "XLA"})
            if args.s:
                backends = [b for b in backends if b == args.s.upper()]
            for backend in backends:
                print(f"benchmarking {code.name} {dt.value} {backend}...",
                      file=sys.stderr)
                rows.append(bench_combo(code, dt, backend, args.B, args.M,
                                        args.T))
    out = json.dumps(rows, indent=1)
    if args.o:
        with open(args.o, "w") as f:
            f.write(out)
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
