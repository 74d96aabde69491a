#!/usr/bin/env python3
"""AWGN BER sweep (parity with examples/run_snr_ber.cpp).

Identical Eb/No math (run_snr_ber.cpp:319-325) and stopping rules
(318-396); the whole inner block loop runs on device (see
viterbidecodercpp_jax/ber.py).  Emits the reference's JSON schema
(run_snr_ber.cpp:402-441) so examples/plot_snr_ber.py-style tooling works
unmodified; stderr progress lines also mirror the reference.

NOTE on ground truth: the *committed* reference curves
(data_snr_ber_x86.txt) were produced with a shifted Eb/No convention
(their sweeps start at -9 dB); the reference binary built from the
current sources produces curves matching this tool point-for-point - see
data_ber_reference_voyager.json, regenerated on this host.

Flags mirror the reference: -L traceback bytes, -n max error bits,
-D max points, -S seed, -k bit-budget scale, -T per-point wall-clock
timeout (run_snr_ber.cpp:361-379), -c/-d/-s filters, -l registry list
(cli_filters.h:143-186), -B batch.
"""

import argparse
import json
import sys

sys.path.insert(0, ".")
sys.path.insert(0, "tools")


def main():
    from cli_common import apply_platform
    apply_platform()   # --cpu, before any backend starts
    from cli_common import add_list_flag, handle_list_flag

    ap = argparse.ArgumentParser()
    ap.add_argument("-L", type=int, default=256, help="traceback bytes/frame")
    ap.add_argument("-n", type=int, default=10000, help="max error bits/point")
    ap.add_argument("-D", type=int, default=24, help="max data points")
    ap.add_argument("-S", type=int, default=0, help="random seed")
    ap.add_argument("-k", type=float, default=1.0, help="bit budget scale")
    ap.add_argument("-T", type=float, default=None,
                    help="per-point wall-clock timeout in seconds")
    ap.add_argument("-B", type=int, default=256, help="frames per device batch")
    ap.add_argument("-c", type=int, default=None, help="code index filter")
    ap.add_argument("-d", default=None, choices=["soft16", "soft8", "hard8"])
    ap.add_argument("-s", default=None, choices=["xla", "pallas"],
                    help="backend filter (the reference's SIMD-kernel "
                         "selector -s; here kernels are backends)")
    add_list_flag(ap)
    ap.add_argument("-o", default=None, help="output file (default stdout)")
    ap.add_argument("--host-chain", action="store_true",
                    help="generate the channel on the native C++ runtime "
                         "(mt19937, reference-identical maths) instead of "
                         "on device")
    ap.add_argument("--dp", type=int, default=None, metavar="N",
                    help="run each point data-parallel over an N-device "
                         "'data' mesh (-B frames per device, psum'd "
                         "global budgets) - the multi-chip replacement "
                         "for the reference's BER thread pool")
    args = ap.parse_args()
    if handle_list_flag(args):
        return 0
    if args.T is not None and args.T <= 0:
        print(f"Timeout must be > 0, got {args.T}", file=sys.stderr)
        return 1

    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax import ber

    from viterbidecodercpp_jax.ops import jax_core
    from viterbidecodercpp_jax.paths import select_path

    mesh = None
    if args.dp:
        from viterbidecodercpp_jax.parallel.mesh import make_mesh
        mesh = make_mesh((args.dp,), ("data",))
    rows = []
    for ci, code in enumerate(vt.COMMON_CODES):
        if args.c is not None and ci != args.c:
            continue
        for dt in vt.DECODE_TYPES:
            if args.d and dt.value.lower() != args.d:
                continue
            config = vt.get_decode_config(dt, code.R)
            # resolved the way ber.measure_point resolves it, so the JSON
            # simd_type records what actually ran
            path = select_path(jax_core.make_static_spec(code, config),
                               backend=args.s or "auto")
            res = ber.sweep(code, config, seed=args.S,
                            max_points=args.D,
                            block_bits=args.L * 8, batch=args.B,
                            max_errors=args.n, bits_scale=args.k,
                            host_chain=args.host_chain,
                            backend=path,
                            timeout_seconds=args.T, mesh=mesh)
            for i, p in enumerate(res.points):
                print(f"name='{code.name}',K={code.K},R={code.R},"
                      f"decode={dt.value},iter={i},EbNo_dB={p.EbNo_dB:.1f},"
                      f"BER={p.ber:.3e}", file=sys.stderr)
            rows.append({
                "name": code.name,
                "decode_type": dt.value,
                "simd_type": (path.backend.upper()
                              + ("+HOSTCHAIN" if args.host_chain else "")),
                "K": code.K,
                "R": code.R,
                "G": list(code.G),
                "EbNo_dB": [p.EbNo_dB for p in res.points],
                "ber": [p.ber for p in res.points],
                "total_bits": [p.total_bits for p in res.points],
                "total_bit_errors": [p.total_bit_errors for p in res.points],
            })
    out = json.dumps(rows, indent=1)
    if args.o:
        with open(args.o, "w") as f:
            f.write(out)
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
