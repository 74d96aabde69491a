"""Golden tests for CodeSpec, parity, branch tables and configs."""

import numpy as np
import pytest

from viterbidecodercpp_jax import (
    COMMON_CODES,
    CodeSpec,
    DecodeType,
    branch_table,
    get_code,
    get_decode_config,
    parity,
)


def test_parity_small():
    # parity of 0..7: 0,1,1,0,1,0,0,1
    assert list(parity(np.arange(8))) == [0, 1, 1, 0, 1, 0, 0, 1]


def test_parity_wide():
    assert parity(np.uint64(0xFFFFFFFFFFFFFFFF)) == 0
    assert parity(np.uint64(1) << np.uint64(63)) == 1


def test_registry():
    assert len(COMMON_CODES) == 8
    voyager = get_code("Voyager")
    assert voyager.K == 7 and voyager.G == (109, 79)
    cassini = get_code(7)
    assert cassini.K == 15 and cassini.R == 6
    assert cassini.num_states == 1 << 14


def test_codespec_validates_taps():
    with pytest.raises(ValueError):
        CodeSpec("bad g0", 3, (0b110, 0b101))  # g0 = 0
    with pytest.raises(ValueError):
        CodeSpec("bad gK", 3, (0b011, 0b101))  # g_{K-1} = 0


def test_branch_table_k3():
    # K=3 {7,5}: half-states h in {0,1}; value = parity((h<<1) & G)
    # G=7 (0b111): h=0 -> parity(0)=0 -> low; h=1 -> parity(0b010)=1 -> high
    # G=5 (0b101): h=0 -> 0 -> low;     h=1 -> parity(0b000)=0 -> low
    code = get_code(0)
    bt = branch_table(code, 127, -127)
    assert bt.shape == (2, 2)
    assert bt[0].tolist() == [-127, 127]
    assert bt[1].tolist() == [-127, -127]


def test_branch_table_shape_all_codes():
    for code in COMMON_CODES:
        bt = branch_table(code, 1, -1)
        assert bt.shape == (code.R, code.num_half_states)
        assert set(np.unique(bt)).issubset({-1, 1})


def test_decode_configs_match_reference():
    # helpers/decode_type.h:21-64
    c = get_decode_config(DecodeType.SOFT16, 2)
    assert (c.soft_decision_high, c.soft_decision_low) == (127, -127)
    assert c.soft_decision_max_error == 254 * 2
    assert c.initial_non_start_error == 254 * 2 * 5
    assert c.renormalisation_threshold == 65535 - 254 * 2 * 5
    assert c.metric_bits == 16

    c8 = get_decode_config(DecodeType.SOFT8, 4)
    assert (c8.soft_decision_high, c8.soft_decision_low) == (3, -3)
    assert c8.soft_decision_max_error == 24
    assert c8.initial_non_start_error == 48
    assert c8.renormalisation_threshold == 255 - 48
    assert c8.metric_bits == 8

    h8 = get_decode_config(DecodeType.HARD8, 2)
    assert h8.soft_decision_max_error == 4
    assert h8.initial_non_start_error == 12
    assert h8.renormalisation_threshold == 255 - 12


def test_dab_puncture_tables():
    from viterbidecodercpp_jax import DAB_PI_TABLE, DAB_PI_X

    assert len(DAB_PI_TABLE) == 24
    for i, pi in enumerate(DAB_PI_TABLE):
        assert pi.period == 32
        # PI_n keeps 8 + n symbols per 32 (ETSI EN 300 401 table 13)
        assert pi.kept == 8 + (i + 1)
    assert DAB_PI_X.period == 24 and DAB_PI_X.kept == 12
