#!/usr/bin/env python3
"""Full correctness matrix (parity with examples/run_tests.cpp).

{SOFT16, SOFT8, HARD8} x all 8 registry codes x available backends x
arithmetic modes: encode 64 random bytes noiselessly, decode, require 0
bit errors (run_tests.cpp:129-142).  Known-bad combos are skipped with a
reason, mirroring SKIP_TESTS (run_tests.cpp:63-65) - the wrapping
(scalar-semantics) SOFT8 Cassini overflow carries over unchanged because
we reproduce the same modular arithmetic.

Exit code 0 iff every non-skipped test passes.
"""

import sys

sys.path.insert(0, ".")

import numpy as np

GREEN, RED, YELLOW, RESET = "\033[32m", "\033[31m", "\033[33m", "\033[0m"


def main():
    from cli_common import apply_platform
    apply_platform()   # --cpu, before any backend starts
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax.ops import jax_core, numpy_ref
    from viterbidecodercpp_jax.paths import select_path

    ariths = ["saturating", "wrapping"]

    # (arith, decode_type, code_name) -> reason  (run_tests.cpp:63-65)
    skip = {
        ("wrapping", vt.DecodeType.SOFT8, "Cassini"):
            "Overflow in metrics due to high code rate and non saturating "
            "arithmetic",
    }

    total = passed = skipped = 0
    failures = []
    rng = np.random.RandomState(0)

    for decode_type in vt.DECODE_TYPES:
        for code in vt.COMMON_CODES:
            nbytes = 16 if code.K >= 15 else 64
            data = rng.randint(0, 256, (2, nbytes), dtype=np.uint8)
            for arith in ariths:
                config = vt.get_decode_config(decode_type, code.R,
                                              arith=arith)
                syms = np.stack([
                    numpy_ref.encode_bytes(code, d,
                                           config.soft_decision_high,
                                           config.soft_decision_low)
                    for d in data])
                # XLA, and the path the code is routed to on this
                # platform when that is another one
                backends = sorted({"xla", select_path(
                    jax_core.make_static_spec(code, config)).backend})
                for backend in backends:
                    total += 1
                    reason = skip.get((arith, decode_type, code.name))
                    if reason:
                        skipped += 1
                        print(f"{YELLOW}SKIP{RESET} {decode_type.value:7s} "
                              f"{code.name:16s} {arith:10s} {backend:6s} "
                              f"- {reason}")
                        continue
                    dec = vt.ViterbiDecoder(code, config, backend=backend)
                    bits, err, acc = dec.decode(
                        syms.reshape(2, -1), nbytes * 8)
                    out = np.packbits(np.asarray(bits), axis=-1,
                                      bitorder="big")
                    ok = np.array_equal(out, data)
                    passed += int(ok)
                    mark = (f"{GREEN}PASS{RESET}" if ok
                            else f"{RED}FAIL{RESET}")
                    print(f"{mark} {decode_type.value:7s} {code.name:16s} "
                          f"{arith:10s} {backend:6s}")
                    if not ok:
                        failures.append(
                            (decode_type.value, code.name, arith, backend))

    print(f"\n{passed}/{total - skipped} passed, {skipped} skipped")
    if failures:
        print(f"{RED}FAILURES:{RESET}", failures)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
