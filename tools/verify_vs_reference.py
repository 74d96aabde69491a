#!/usr/bin/env python3
"""Bit-exactness check against the reference C++ library.

Builds tools/ref_probe.cpp against the (read-only) reference headers at
/root/reference, feeds the reference's AVX kernels and this framework's
decoder identical noisy symbol frames, and requires ZERO output-bit
disagreement.  This is the strongest cross-implementation consistency
check available (SURVEY.md section 4) - statistical BER curves can hide
small semantic drift; this cannot.

Usage: python tools/verify_vs_reference.py [frames] [block_bits]
"""

import os
import subprocess
import sys
import tempfile

sys.path.insert(0, ".")

import numpy as np

REFERENCE = os.environ.get("VITERBI_REFERENCE", "/root/reference")


def build_probe(tmp):
    exe = os.path.join(tmp, "ref_probe")
    subprocess.run(
        ["g++", "-O2", "-march=native", "-std=c++17",
         f"-I{REFERENCE}/include", f"-I{REFERENCE}/examples",
         os.path.join(os.path.dirname(__file__), "ref_probe.cpp"),
         "-o", exe], check=True)
    return exe


def main():
    sys.path.insert(0, os.path.dirname(__file__))
    from cli_common import apply_platform
    apply_platform()   # --cpu, before any backend starts
    import jax
    import jax.numpy as jnp
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax.ops import jax_core
    from viterbidecodercpp_jax.utils import testsig

    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    block_bits = int(sys.argv[2]) if len(sys.argv) > 2 else 2048

    # Voyager exercises the GPU kernels where the platform routes them,
    # Cassini the big-state XLA path - both checked bit-for-bit against
    # the reference's own AVX binaries.
    cases = [("Voyager", "voyager", block_bits,
              [("soft16", 2.0), ("soft8", 2.5), ("hard8", 4.0)]),
             ("Cassini", "cassini", min(block_bits, 512),
              [("soft16", -1.0), ("soft8", 0.0), ("hard8", 2.0)])]
    failures = 0
    with tempfile.TemporaryDirectory() as tmp:
        exe = build_probe(tmp)
        for code_name, probe_code, bbits, mode_list in cases:
          code = vt.get_code(code_name)
          for mode, EbNo in mode_list:
            block_bits = bbits
            dt = vt.DecodeType(mode.upper())
            config = vt.get_decode_config(dt, code.R)
            spec = jax_core.make_static_spec(code, config)
            key = jax.random.PRNGKey(5)
            key, k1, k2 = jax.random.split(key, 3)
            tx = jax.random.bernoulli(k1, 0.5, (frames, block_bits)).astype(
                jnp.uint8)
            floats = testsig.modulate_encode(code, tx, True)
            syms = np.asarray(testsig.awgn_quantize(floats, k2, EbNo,
                                                    code.R, config))
            sin = os.path.join(tmp, "syms.bin")
            sout = os.path.join(tmp, "out.bin")
            syms.reshape(frames, -1).astype("<i2").tofile(sin)
            subprocess.run([exe, mode, sin, sout, str(block_bits),
                            probe_code], check=True)
            ref_bits = np.unpackbits(
                np.fromfile(sout, dtype=np.uint8).reshape(
                    frames, block_bits // 8), axis=1, bitorder="big")

            dec = vt.ViterbiDecoder(code, config)
            bits, _, _ = dec.decode(syms.reshape(frames, -1), block_bits)
            ours = np.asarray(bits)

            disagree = int((ours != ref_bits).sum())
            ref_err = int((ref_bits != np.asarray(tx)).sum())
            our_err = int((ours != np.asarray(tx)).sum())
            status = "OK " if disagree == 0 else "FAIL"
            failures += disagree != 0
            print(f"{status} {code_name:8s} {mode:7s} @ {EbNo} dB: "
                  f"{disagree} disagreement bits / {ours.size}; "
                  f"channel errors ref={ref_err} ours={our_err}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
