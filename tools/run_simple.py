#!/usr/bin/env python3
"""Minimal end-to-end demo (parity with examples/run_simple.cpp).

DAB Radio K=7 R=1/4, 1024 input bytes, noiseless channel; asserts an
exact decode and exits 1 otherwise (run_simple.cpp:90-93).  Adds a light
symbol-noise variant on top (like run_simple's add_noise with
noise_level=0 default, test_helpers.h:66-74).
"""

import sys

sys.path.insert(0, ".")

import numpy as np


def main():
    from cli_common import apply_platform
    apply_platform()   # --cpu, before any backend starts
    import jax.numpy as jnp
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax.ops import encoder

    code = vt.get_code("DAB Radio")
    dec = vt.ViterbiDecoder(code, vt.DecodeType.SOFT16)
    config = dec.config
    nbytes = 1024
    total_bits = nbytes * 8

    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (1, nbytes), dtype=np.uint8)
    bits = encoder.bytes_to_bits_jax(jnp.asarray(data))
    syms = encoder.encode_symbols_jax(code, bits,
                                      config.soft_decision_high,
                                      config.soft_decision_low, True)
    syms = np.asarray(syms).reshape(1, -1)

    out_bits, err, acc = dec.decode(syms, total_bits)
    out = np.packbits(np.asarray(out_bits), axis=-1, bitorder="big")
    bit_errors = int(np.unpackbits(out ^ data, bitorder="big").sum())

    print(f"code={code.name} K={code.K} R={code.R} backend={dec.backend}")
    print(f"decoded {nbytes} bytes, bit errors: {bit_errors}")
    print(f"final path metric: {int(np.asarray(err)[0])}, "
          f"accumulated renorm error: {int(np.asarray(acc)[0])}")
    if bit_errors != 0:
        print("FAILED: noiseless decode must be exact")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
