"""The reduction of a profiler trace and the host spans to device
numbers, on a trace built by hand."""

import pytest

from benchmark import devtrace


def cal_events(ts_us):
    """``bench.cal`` ranges at trace times ``ts_us`` and their span-clock
    marks 10 ns either side: the two clocks agree."""
    events = [{"name": "bench.cal", "ph": "X", "ts": t, "dur": 1}
              for t in ts_us]
    marks = [(int(t * 1e3) - 10, int(t * 1e3) + 10) for t in ts_us]
    return events, marks


def test_reduce_trace():
    n = devtrace.CAL_N
    cal, marks = cal_events([10 + i for i in range(n)]
                            + [5000 + i for i in range(n)])
    us = 1000  # span-clock ns per trace us
    log = [  # (name, start ns, end ns), as the spans close
        ("tl_paged_attention", 1250 * us, 1320 * us),
        ("paged.step#1", 1200 * us, 1400 * us),
        ("engine.step_chunk", 1150 * us, 1800 * us),
        ("sampler", 1600 * us, 1700 * us),
    ]
    events = cal + [
        {"name": "bench.window", "ph": "X", "ts": 1000, "dur": 1000},
        # a launch inside the attention span and its kernel
        {"name": "cudaLaunchKernel", "ph": "X", "cat": "cuda_runtime",
         "ts": 1300, "dur": 5, "args": {"correlation": 7}},
        {"name": "attend", "ph": "X", "cat": "kernel", "ts": 1400,
         "dur": 100, "args": {"correlation": 7}},
        # a kernel from no known launch, and one before the window
        {"name": "gemm", "ph": "X", "cat": "kernel", "ts": 1450,
         "dur": 150},
        {"name": "gemm", "ph": "X", "cat": "kernel", "ts": 900,
         "dur": 50},
    ]
    out = devtrace.reduce_trace(events, log, marks)
    assert out["window_s"] == pytest.approx(1e-3)
    # busy 1400-1600 (two kernels overlapping)
    assert out["busy_s"] == pytest.approx(200e-6)
    assert out["device_ops"] == [["gemm", pytest.approx(150e-6)],
                                 ["attend", pytest.approx(100e-6)]]
    gaps = dict((n, s) for n, s in out["idle_gaps"])
    # 1000-1400: middle 1200 in paged.step#1; 1600-2000: middle 1800 at
    # the end of engine.step_chunk
    assert gaps == {"paged.step": pytest.approx(400e-6),
                    "engine.step_chunk": pytest.approx(400e-6)}
    assert out["chunks"] == {1: {
        "tl_ragged_paged_attention": 0.0, "tl_ragged_paged_attention.n": 0,
        "tl_paged_attention": pytest.approx(100e-6),
        "tl_paged_attention.n": 1}}


def test_reduce_trace_needs_a_card():
    cal, marks = cal_events(list(range(2 * devtrace.CAL_N)))
    events = cal + [{"name": "bench.window", "ph": "X", "ts": 0,
                     "dur": 10}]
    with pytest.raises(RuntimeError, match="no device kernel"):
        devtrace.reduce_trace(events, [], marks)
