"""Statistical BER regression vs the reference binary's own output,
for all 8 registry codes x 3 decode regimes (the reference commits the
same coverage in data_snr_ber_x86.txt, run_snr_ber.cpp:280-400).

Ground truth: data_ber_reference_voyager.json,
data_ber_reference_k9_k15.json and data_ber_reference_5codes.json,
produced on this host by the reference's run_snr_ber (Release,
-march=native, seed 777; fastest valid kernel per combination; -k 0.2
for Voyager, -k 20 for CDMA IS-95A, -k 500 for Cassini; the 5-code
round-3 sweep used -k {1.2, 5, 29, 38, 154} for {K=3, K=5, LTE, DAB,
CDMA-2000} = ~1.5e8 bits/point, -T 180).  Note the *committed*
data_snr_ber_x86.txt files in the reference repo use an older shifted
Eb/No convention (sweeps starting at -9 dB) and do not match the
current reference sources; the freshly built binary does, and this
framework matches it point-for-point.

These tests are statistical (independent RNG streams), so they assert
agreement within Poisson counting error over a 1.3x ratio window, with
budgets sized for >=300 expected errors per point on our side.  Their
budgets need the GPU to finish in reasonable time, so they are marked
``gpu``: ``python -m pytest tests/ -m gpu`` on the card.
"""

import json
import os

import numpy as np
import pytest
import jax

pytestmark = pytest.mark.gpu

_HERE = os.path.dirname(__file__)

_FILES = {
    "Voyager": "data_ber_reference_voyager.json",
    "CDMA IS-95A": "data_ber_reference_k9_k15.json",
    "Cassini": "data_ber_reference_k9_k15.json",
    "Basic K=3 R=1/2": "data_ber_reference_5codes.json",
    "Basic K=5 R=1/2": "data_ber_reference_5codes.json",
    "LTE": "data_ber_reference_5codes.json",
    "DAB Radio": "data_ber_reference_5codes.json",
    "CDMA 2000": "data_ber_reference_5codes.json",
}


def load_reference(code_name, decode_type):
    with open(os.path.join(_HERE, "..", _FILES[code_name])) as f:
        for rec in json.load(f):
            if (rec["name"] == code_name
                    and rec["decode_type"] == decode_type):
                return dict(zip(rec["EbNo_dB"], rec["ber"]))
    raise KeyError((code_name, decode_type))


def check_point(code_name, decode_type, EbNo, key, *, block_bits=4096,
                host_chain=False, seed=0):
    import viterbidecodercpp_jax as vt
    from viterbidecodercpp_jax import ber

    code = vt.get_code(code_name)
    config = vt.get_decode_config(vt.DecodeType(decode_type), code.R)
    r = load_reference(code_name, decode_type)[EbNo]
    # budget: enough for >=300 expected errors at the reference BER
    want_errors = 300
    max_bits = min(int(want_errors / max(r, 1e-9)), 60_000_000)
    if host_chain:
        p = ber.measure_point_host_chain(
            code, config, EbNo, seed=seed, block_bits=block_bits,
            batch=64, max_bits=max_bits, max_errors=100_000)
    else:
        # block_bits matches the reference harness default frame length
        # (-L 512 bytes -> 4096-bit frames); BER is frame-length
        # dependent through tail-termination edge protection, so compare
        # like for like.
        p = ber.measure_point(code, config, EbNo, key=key,
                              block_bits=block_bits,
                              max_bits=max_bits, max_errors=100_000)
    # Poisson tolerance: 5 sigma on the observed count, floored at a
    # 1.3x ratio window for Monte Carlo slack.
    lo, hi = r / 1.3, r * 1.3
    n = p.total_bit_errors
    sigma_rel = 5.0 / max(np.sqrt(max(n, 1)), 1.0)
    lo = min(lo, r * (1 - sigma_rel))
    hi = max(hi, r * (1 + sigma_rel))
    assert lo <= p.ber <= hi, (
        f"{code_name} {decode_type} @ {EbNo} dB: got BER {p.ber:.3e} "
        f"({n}/{p.total_bits}), reference {r:.3e}")


@pytest.mark.parametrize("decode_type,points", [
    ("SOFT16", [2.0, 3.0]),
    ("SOFT8", [2.0, 3.0]),
    ("HARD8", [3.0, 4.0]),
])
def test_ber_matches_reference_voyager(decode_type, points):
    key = jax.random.PRNGKey(42)
    for EbNo in points:
        key, sub = jax.random.split(key)
        check_point("Voyager", decode_type, EbNo, sub)


@pytest.mark.parametrize("decode_type,points", [
    ("SOFT16", [2.0, 2.5]),
    ("SOFT8", [2.0, 2.5]),
    ("HARD8", [3.0, 3.5]),
])
def test_ber_matches_reference_cdma_k9(decode_type, points):
    key = jax.random.PRNGKey(43)
    for EbNo in points:
        key, sub = jax.random.split(key)
        check_point("CDMA IS-95A", decode_type, EbNo, sub)


@pytest.mark.parametrize("decode_type,points", [
    ("SOFT16", [0.0, 0.5]),
    ("SOFT8", [0.5, 1.0]),
    ("HARD8", [1.5, 2.0]),
])
def test_ber_matches_reference_cassini_k15(decode_type, points):
    # the big-state XLA path end to end, vs the reference's own K=15 AVX
    # sweep
    key = jax.random.PRNGKey(44)
    for EbNo in points:
        key, sub = jax.random.split(key)
        check_point("Cassini", decode_type, EbNo, sub, block_bits=1024)


# gate points for the round-3 5-code extension: two per (code, mode) in
# the 1e-3..3e-2 reference-BER band (budgets stay <= ~3e6 bits/point)
_FIVE_CODE_POINTS = {
    "Basic K=3 R=1/2": {"SOFT16": [2.0, 3.0], "SOFT8": [2.5, 3.5],
                        "HARD8": [3.5, 4.5]},
    "Basic K=5 R=1/2": {"SOFT16": [2.0, 3.0], "SOFT8": [2.5, 3.5],
                        "HARD8": [3.5, 4.5]},
    "LTE":             {"SOFT16": [1.5, 2.5], "SOFT8": [1.5, 2.5],
                        "HARD8": [2.5, 3.5]},
    "DAB Radio":       {"SOFT16": [1.5, 2.5], "SOFT8": [1.5, 2.5],
                        "HARD8": [2.5, 3.5]},
    "CDMA 2000":       {"SOFT16": [1.0, 2.0], "SOFT8": [1.0, 2.0],
                        "HARD8": [2.0, 3.0]},
}


@pytest.mark.parametrize("code_name", sorted(_FIVE_CODE_POINTS))
@pytest.mark.parametrize("decode_type", ["SOFT16", "SOFT8", "HARD8"])
def test_ber_matches_reference_remaining_codes(code_name, decode_type):
    import zlib
    # deterministic per-combination seed (str hash() is salted per run)
    key = jax.random.PRNGKey(
        zlib.crc32(f"{code_name}/{decode_type}".encode()) & 0x7FFFFFFF)
    for EbNo in _FIVE_CODE_POINTS[code_name][decode_type]:
        key, sub = jax.random.split(key)
        check_point(code_name, decode_type, EbNo, sub)


def test_ber_host_chain_cassini_point():
    """Apples-to-apples pipeline: the native C++ runtime generates the
    channel exactly like the reference harness (mt19937 + identical
    quantisation maths) and the device only decodes - one Cassini point
    through measure_point_host_chain."""
    check_point("Cassini", "SOFT16", 0.5, None, block_bits=1024,
                host_chain=True, seed=3)
