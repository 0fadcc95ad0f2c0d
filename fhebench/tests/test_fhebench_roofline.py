"""The frozen work function of the stage kernel."""

import pytest

from fhebench.roofline import stage

REF_Q = [17592186435073] + [17182765057] * 10     # 45 + 10 x 35 bits


def test_ref_wcrt_bound_is_int8():
    # K1 on ref's W-CRT, data [11, 512, 4096]: 0.310 ms at the int8 rate
    call = {"moduli": REF_Q, "table": (11, 512, 512),
            "data_elems": 11 * 512 * 4096, "out_elems": 11 * 512 * 4096}
    w = stage.work(call["moduli"], call["table"], call["data_elems"],
                   call["out_elems"])
    assert w["int8"] == sum(2 * 512 * 4096 * d * 512 * d
                            for d in [6] + [5] * 10)
    assert stage.bound_s(call) * 1e3 == pytest.approx(0.310, abs=5e-4)
    assert w["bytes"] / 3.35e12 < w["int8"] / 1979e12


def test_ref_xntt_bound_is_bytes():
    # K1 on ref's X-NTT rows [11, 32768, 64] with a 64-point table
    call = {"moduli": REF_Q, "table": (11, 64, 64),
            "data_elems": 11 * 32768 * 64, "out_elems": 11 * 32768 * 64,
            "twiddle_elems": 11 * 32768 * 64}
    w = stage.work(call["moduli"], call["table"], call["data_elems"],
                   call["out_elems"], call["twiddle_elems"])
    assert stage.bound_s(call) == pytest.approx(w["bytes"] / 3.35e12)
    assert w["bytes"] == 8 * (3 * 11 * 32768 * 64 + 11 * 64 * 64)


def test_digits():
    assert [stage.digits(q) for q in (255, 256, 2 ** 35 - 1, 2 ** 45)] == \
        [1, 2, 5, 6]
