"""The traced job's reduction: busy time as the union of device intervals
inside the job's span, idle gaps labelled by the innermost host event open
at their middle."""

import pytest

from perfbench.harness import trace


def test_summarize():
    ev = [
        (False, trace.JOB_SPAN, 0, 100),
        (True, "k1", 10, 20),
        (True, "k1", 15, 30),
        (True, "Memcpy DtoD (Device -> Device)", 50, 60),
        (True, "outside", 120, 130),
        (False, "cudaGraphLaunch", 0, 12),
        (False, "aten::outer", 28, 58),
        (False, "aten::inner", 35, 45),
        (True, trace.JOB_SPAN, 0, 100),  # the span's shadow on the card
    ]
    s = trace.summarize(ev, 1.0)
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx(30e-9)
    assert s.kernels["k1"] == (pytest.approx(25e-9), 2)
    gaps = dict(s.idle_gaps)
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-9)
    assert gaps["aten::inner"] == pytest.approx(20e-9)  # mid 40
    assert gaps[trace.NO_OP] == pytest.approx(40e-9)
    assert s.device_ops[0][0] == "k1"


def test_a_job_with_no_device_work_is_idle():
    s = trace.summarize([(False, trace.JOB_SPAN, 5, 25)], 1.0)
    assert s.busy_s == 0 and s.window_s == pytest.approx(20e-9)
    assert s.idle_gaps == [[trace.NO_OP, pytest.approx(20e-9)]]


def test_a_card_trace_with_no_device_work_raises():
    ev = [(False, trace.JOB_SPAN, 5, 25), (True, "k1", 30, 40)]
    with pytest.raises(RuntimeError, match="no device activity"):
        trace.summarize(ev, 1.0, on_card=True)
