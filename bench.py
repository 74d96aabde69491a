#!/usr/bin/env python3
"""Headline benchmark: decoded symbols/s on one GPU.

Workload: Voyager (K=7 R=1/2) SOFT8, B=1024 frames x T=2048 trellis steps,
through ``ViterbiDecoder.decode`` (update + chainback, the work the
reference's run_benchmark times, run_benchmark.cpp:267-281) on the path
``paths.select_path`` picks.  Each sample is one call ending in
``block_until_ready``; the value is the median of ``--reps`` samples
after a warm-up call that compiles.

Prints the device and card on earlier lines and ONE JSON line last:
{"metric", "value", "unit", "platform", "device_kind", "device_count",
"card", "path"}.  Exits non-zero without a GPU.

    python bench.py [--batch 1024] [--steps 2048] [--reps 20]
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

METRIC = "decoded symbols/s (Voyager K=7 R=1/2 SOFT8, update+chainback)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import jax

    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"device {dev.platform} {dev.device_kind} "
          f"count={len(jax.devices())}", flush=True)
    print(card, flush=True)

    code = vt.get_code("Voyager")
    config = vt.get_decode_config(vt.DecodeType.SOFT8, code.R)
    B, T = args.batch, args.steps
    total_bits = T - (code.K - 1)
    dec = vt.ViterbiDecoder(code, config, traceback_length=total_bits)
    rng = np.random.RandomState(0)
    syms = jax.device_put(rng.randint(
        config.soft_decision_low, config.soft_decision_high + 1,
        (B, T * code.R)).astype(np.int32))

    jax.block_until_ready(dec.decode(syms, total_bits))
    samples = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(dec.decode(syms, total_bits))
        samples.append(time.perf_counter() - t0)
    dt = float(np.median(samples))

    print(json.dumps({
        "metric": METRIC,
        "value": B * T * code.R / dt,
        "unit": "symbols/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "path": dec.backend,
    }))


if __name__ == "__main__":
    main()
