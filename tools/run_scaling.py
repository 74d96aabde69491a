#!/usr/bin/env python
"""Multi-host scaling measurement (the >=80%-linear-scaling protocol).

Measures aggregate frame-DP decode throughput over ALL devices of a
distributed run, so the 2-host scaling efficiency of BASELINE.md is a
two-command measurement:

  host0$ python tools/run_scaling.py --coordinator host0:1234 \
             --num-processes 2 --process-id 0 --platform native
  host1$ python tools/run_scaling.py --coordinator host0:1234 \
             --num-processes 2 --process-id 1 --platform native

then efficiency = rate(2 hosts) / (2 * rate(1 host)).  Frames shard over
one 'data' axis spanning every device (parallel/launch.make_hybrid_mesh;
the only cross-host traffic is the scalar error psum), so this is the
upper-bound workload the >=80% target is stated for.

Without real multi-host hardware, --simulate N spawns N local CPU
processes (gloo collectives) to validate the measurement path end to
end; the printed numbers then characterise the harness, not hardware.

Output: one JSON line on the coordinator:
  {"metric": "dp_symbols_per_sec", "processes": P, "devices": D,
   "value": rate, "per_device": rate/D, ...}

Timing: each timed call synchronises with a device_get of the psum'd
scalar (a full device round-trip); rates are the median over --reps
calls after one warmup.  With ``--platform native`` each host runs one
process that owns all of its local cards.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def worker(args):
    from viterbidecodercpp_jax.parallel import launch

    platform = None if args.platform == "native" else args.platform
    launch.initialize(args.coordinator, args.num_processes, args.process_id,
                      local_device_count=args.local_devices,
                      platform=platform)

    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from viterbidecodercpp_jax import DecodeType, get_code, get_decode_config
    from viterbidecodercpp_jax.ops import jax_core, numpy_ref
    from viterbidecodercpp_jax.parallel import frame_dp

    code = get_code(args.code)
    config = get_decode_config(DecodeType(args.decode), code.R)
    spec = jax_core.make_static_spec(code, config)
    ndev = jax.device_count()
    mesh = launch.make_hybrid_mesh(dcn={"data": ndev})

    B = args.batch * ndev
    nbytes = args.bits // 8
    total_bits = nbytes * 8
    rng = np.random.RandomState(0)
    lo = args.process_id * B // args.num_processes
    hi = (args.process_id + 1) * B // args.num_processes
    data = rng.randint(0, 256, (B, nbytes), dtype=np.uint8)[lo:hi]
    syms = np.stack([
        numpy_ref.encode_bytes(code, d, config.soft_decision_high,
                               config.soft_decision_low) for d in data
    ])
    T = syms.shape[1] // code.R
    ref = np.unpackbits(data, axis=1, bitorder="big")
    sym_g = launch.global_array(mesh, P("data", None, None),
                                syms.reshape(-1, T, code.R).astype(np.int32))
    ref_g = launch.global_array(mesh, P("data", None), ref)

    def run():
        _, errs = frame_dp.decode_dp(spec, mesh, sym_g, total_bits,
                                     reference_bits=ref_g)
        return int(jax.device_get(errs))

    assert run() == 0, "scaling-run decode had bit errors"   # warmup+check
    marginals = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        errs = run()
        marginals.append(time.perf_counter() - t0)
        assert errs == 0
    dt = sorted(marginals)[len(marginals) // 2]
    symbols = B * T * code.R
    if args.process_id == 0:
        print(json.dumps({
            "metric": "dp_symbols_per_sec",
            "processes": args.num_processes,
            "devices": ndev,
            "platform": jax.default_backend(),
            "code": code.name, "decode": args.decode,
            "batch_global": B, "trellis_steps": T,
            "value": symbols / dt,
            "per_device": symbols / dt / ndev,
            "median_call_s": dt,
        }), flush=True)
    jax.distributed.shutdown()


def simulate(args):
    from viterbidecodercpp_jax.parallel import launch

    def cmd(pid, port):
        return [sys.executable, __file__,
                "--coordinator", f"localhost:{port}",
                "--num-processes", str(args.simulate),
                "--process-id", str(pid),
                "--local-devices", str(args.local_devices),
                "--batch", str(args.batch), "--bits", str(args.bits),
                "--reps", str(args.reps), "--code", args.code,
                "--decode", args.decode]

    try:
        outs = launch.spawn_fleet(cmd, args.simulate,
                                  success_token='"metric"')
    except RuntimeError as e:
        sys.exit(f"simulated scaling run failed: {e}")
    for out in outs:            # rank 0 carries the JSON result line
        if out.strip():
            print(out.strip(), flush=True)


def main():
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=2,
                    help="virtual devices per process (cpu platform only)")
    ap.add_argument("--platform", default="cpu",
                    help="'cpu' (simulated) or 'native' (real hardware)")
    ap.add_argument("--simulate", type=int, default=0,
                    help="spawn N local CPU processes and run the whole "
                         "measurement in one command")
    ap.add_argument("--batch", type=int, default=32,
                    help="frames per device")
    ap.add_argument("--bits", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--code", default="Voyager")
    ap.add_argument("--decode", default="SOFT16")
    args = ap.parse_args()
    if args.simulate:
        simulate(args)
    else:
        if args.coordinator is None:
            sys.exit("--coordinator required (or use --simulate N)")
        worker(args)


if __name__ == "__main__":
    main()
