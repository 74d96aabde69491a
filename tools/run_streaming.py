#!/usr/bin/env python3
"""Bounded-latency streaming decode demo.

Feeds a noisy continuous Voyager stream through
streaming.StreamingDecoder in fixed chunks and checks the continuously
emitted bits against the transmitted data (fixed decision delay =
window trellis steps).  Exit 1 on any bit error.
"""
import argparse
import sys

sys.path.insert(0, ".")

import numpy as np


def main():
    from cli_common import apply_platform
    apply_platform()   # --cpu, before any backend starts
    from viterbidecodercpp_jax import get_code
    from viterbidecodercpp_jax.ops import numpy_ref as ref
    from viterbidecodercpp_jax.streaming import StreamingDecoder

    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="voyager",
                    choices=["voyager", "cassini"])
    args = ap.parse_args()
    if args.code == "cassini":
        code = get_code("Cassini")
        window, chunk, batch, nbytes, noise = 280, 56, 32, 128, 60
    else:
        code = get_code("Voyager")
        window, chunk, batch, nbytes, noise = 256, 64, 8, 512, 25
    sd = StreamingDecoder(code, "SOFT16", window=window, chunk=chunk)

    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, (batch, nbytes), dtype=np.uint8)
    syms = np.stack([ref.encode_bytes(code, d, 127, -127) for d in data]
                    ).astype(np.int64)
    syms = np.clip(syms + rng.randint(-noise, noise + 1, syms.shape),
                   -127, 127)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    pad = window + chunk
    stream_syms = np.zeros((batch, (T + pad) * code.R), np.int32)
    stream_syms[:, :T * code.R] = syms

    state = sd.reset(batch)
    emitted = []
    for i in range((T + pad) // chunk):
        blk = stream_syms[:, i * chunk * code.R:(i + 1) * chunk * code.R]
        state, bits, valid = sd.push(state, blk)
        if bool(valid):
            emitted.append(np.asarray(bits))
    stream = np.concatenate(emitted, axis=1)
    got = stream[:, code.K - 1:code.K - 1 + total_bits]
    expect = np.unpackbits(data, axis=1, bitorder="big")
    errors = int((got != expect).sum())
    print(f"streamed {batch} x {total_bits} bits in {chunk}-bit chunks, "
          f"decision delay {window} steps, backend={sd.backend}: "
          f"{errors} bit errors")
    if errors:
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
