#!/usr/bin/env python3
"""Time ``ViterbiDecoder.decode`` on the XLA path against the GPU kernels.

For every registry code x decode regime at B=512 frames x 2048 data bits,
the headline (Voyager SOFT8, B=1024 x T=2048), and custom codes of
K=10..13 (S=512..4096, outside the registry), one process times the two
paths in turns - XLA, kernel, kernel, XLA - each the median of ``--reps``
calls ending in ``block_until_ready``, after a warm-up call that
compiles.  The kernel path is forced (``DecodePath("pallas")``) so that
state counts outside the routed range are measured too; the big-state
class (S > 4096) is XLA only.  Checks the two paths' bits are equal.

    python tools/compare_paths.py [--reps 5] [--out FILE]

Needs a GPU.  Prints one line per cell and, with --out, writes them as
JSON.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def median_time(fn, reps):
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax.paths import DecodePath
    from viterbidecodercpp_jax.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"compare_paths: needs a GPU, found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"device {dev.device_kind} count={len(jax.devices())} card={card}",
          flush=True)

    cells = [(code, dt, 512, 2048)
             for code in vt.COMMON_CODES for dt in vt.DECODE_TYPES]
    voyager = vt.get_code("Voyager")
    cells.append((voyager, vt.DecodeType.SOFT8, 1024, 2048 - voyager.K + 1))
    for K, G in ((10, (0o1467, 0o1751)), (11, (0o3345, 0o3613)),
                 (12, (0o5723, 0o6277)), (13, (0o17661, 0o11457))):
        cells.append((vt.CodeSpec(f"custom K={K}", K, G),
                      vt.DecodeType.SOFT8, 512, 2048))

    rows = []
    for code, dt, B, nbits in cells:
        config = vt.get_decode_config(dt, code.R)
        xla = vt.ViterbiDecoder(code, config, backend="xla")
        rng = np.random.RandomState(0)
        syms = jax.device_put(rng.randint(
            config.soft_decision_low, config.soft_decision_high + 1,
            (B, (nbits + code.K - 1) * code.R)).astype(np.int32))
        row = {"code": code.name, "K": code.K, "S": xla.spec.S,
               "decode_type": dt.value, "B": B, "bits": nbits,
               "card": card, "device_kind": dev.device_kind}
        decoders = {"xla": xla}
        if xla.spec.S <= 4096:
            decoders["kernel"] = vt.ViterbiDecoder(
                code, config, backend=DecodePath("pallas"))
        out = {}
        for name, dec in decoders.items():
            t0 = time.perf_counter()
            out[name] = np.asarray(jax.block_until_ready(
                dec.decode(syms, nbits))[0])
            row[f"{name}_first_call_s"] = time.perf_counter() - t0
        order = (["xla", "kernel", "kernel", "xla"] if "kernel" in decoders
                 else ["xla", "xla"])
        samples = {k: [] for k in decoders}
        for name in order:
            dec = decoders[name]
            samples[name].append(median_time(
                lambda: dec.decode(syms, nbits), args.reps))
        for name, ts in samples.items():
            row[f"{name}_s"] = float(np.mean(ts))
            row[f"{name}_turns_s"] = ts
        if "kernel" in decoders:
            row["bits_equal"] = bool(np.array_equal(out["xla"],
                                                    out["kernel"]))
            row["speedup"] = row["xla_s"] / row["kernel_s"]
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not row.get("bits_equal", True):
            sys.exit(f"compare_paths: {code.name} {dt.value}: bits differ")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
