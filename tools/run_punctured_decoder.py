#!/usr/bin/env python3
"""DAB FIC punctured decode demo (parity with run_punctured_decoder.cpp).

Mother code K=7 R=1/4 {109, 79, 83, 109} (ETSI EN 300 401 clause 11.1.1),
puncture sequence 21 x PI_16 + 3 x PI_15 + PI_X tail (clause 11.2,
run_punctured_decoder.cpp:72-76).  Encodes 384 random bytes, punctures,
re-inflates with the neutral mid-point symbol and decodes with every
decode regime; requires 0 bit errors (run_punctured_decoder.cpp:170-190).
"""

import sys

sys.path.insert(0, ".")

import numpy as np

GREEN, RED, RESET = "\033[32m", "\033[31m", "\033[0m"


def main():
    from cli_common import apply_platform
    apply_platform()   # --cpu, before any backend starts
    import jax.numpy as jnp
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax import puncture
    from viterbidecodercpp_jax.ops import encoder, numpy_ref

    code = vt.CodeSpec("DAB FIC mother", 7, (109, 79, 83, 109))
    sched = puncture.dab_fic_schedule(code)
    total_data_bits = 32 * (21 + 3)
    total_data_bytes = total_data_bits // 8
    mask = puncture.schedule_mask(sched)
    assert mask.size == (total_data_bits + code.K - 1) * code.R

    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (1, total_data_bytes), dtype=np.uint8)
    full_syms = None

    total = passed = 0
    for dt in vt.DECODE_TYPES:
        config = vt.get_decode_config(dt, code.R)
        dec = vt.ViterbiDecoder(code, config,
                                traceback_length=total_data_bits)
        full = numpy_ref.encode_bytes(code, data[0],
                                      config.soft_decision_high,
                                      config.soft_decision_low)
        tx_punctured = puncture.puncture_np(full, mask)
        # receiver: re-inflate with the neutral unpunctured value 0
        rx_syms = encoder.depuncture(
            jnp.asarray(tx_punctured[None, :]), mask, neutral=0)
        bits, err, acc = dec.decode(np.asarray(rx_syms), total_data_bits)
        out = np.packbits(np.asarray(bits), axis=-1, bitorder="big")
        errors = int(np.unpackbits(out ^ data, bitorder="big").sum())
        ok = errors == 0
        total += 1
        passed += int(ok)
        mark = f"{GREEN}PASS{RESET}" if ok else f"{RED}FAIL{RESET}"
        rate = mask.size / mask.sum()
        print(f"{mark} {dt.value:7s} backend={dec.backend} "
              f"punctured {mask.size}->{int(mask.sum())} symbols "
              f"(effective rate 1/{code.R} -> {rate:.3f}/4), "
              f"bit errors {errors}/{total_data_bits}, "
              f"traceback_error={int(np.asarray(err)[0]) + int(np.asarray(acc)[0])}")

    print(f"\n{passed}/{total} passed")
    return 0 if passed == total else 1


if __name__ == "__main__":
    sys.exit(main())
