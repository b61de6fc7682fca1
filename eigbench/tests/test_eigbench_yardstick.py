"""The frozen operation and byte counts against hand counts, and the trace
arithmetic on made-up events."""

import pytest

from eigbench import trace as tracing
from eigbench.layer_metrics import (b1_roofline, b11_roofline, b13_roofline,
                                    device_idle_pct, peaks)

HPCG = {"grid": 256, "dtype": "float32"}


def test_peaks_are_the_data_sheet():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.PEAK_FLOPS["float32"] == 67e12
    assert peaks.bound_s(3.35e12, 1.0) == 1.0
    assert peaks.bound_s(1.0, 67e12) == 1.0


def test_b1_counts_27_diagonals_and_two_vectors():
    n = 256 ** 3
    assert n == 16_777_216
    nbytes = 27 * n * 4 + n * 4 + n * 4
    assert nbytes == 1_946_157_056
    assert b1_roofline.least_s(HPCG) == pytest.approx(nbytes / 3.35e12, rel=1e-15)
    assert b1_roofline.least_s(HPCG) == pytest.approx(0.000580942, rel=1e-6)


def test_b11_counts_ten_thirds_n_cubed():
    n = 2048
    flops = 10 / 3 * n ** 3
    assert flops == pytest.approx(28_633_115_306.67, rel=1e-12)
    assert b11_roofline.least_s(n, "float32") == pytest.approx(flops / 67e12, rel=1e-15)
    assert 2 * n * n * 4 / 3.35e12 < flops / 67e12  # operations bound it


def test_b13_counts_a_third_of_the_window_a_sweep():
    n, sweeps = 2048, 3
    nbytes = sweeps * (n * n / 3) * 8  # complex64 entries
    assert nbytes == 33_554_432
    assert b13_roofline.least_s(n, sweeps, "float32") == pytest.approx(nbytes / 3.35e12)


class FakeRun:
    def __init__(self, trace, config=None, iterations=(), completed=1):
        self.trace, self.config, self.iterations, self.completed = (
            trace, config, list(iterations), completed)


def fake_trace(kernels, window_s):
    busy = sum(e - s for s, e in tracing.union((s, e) for _, s, e in kernels)) / 1e9
    return tracing.Trace(kernels=kernels, window_s=window_s, busy_s=busy, breakdown={})


def test_b1_share_from_device_time():
    call_ns = round(b1_roofline.least_s(HPCG) / 0.8 * 1e9)
    kernels = [("dia_il_window_kernel<float, float>", 0, call_ns),
               ("dia_il_window_kernel<float, float>", call_ns, 2 * call_ns),
               ("vectorized_elementwise_kernel<4>", 2 * call_ns, 3 * call_ns)]
    share = b1_roofline.read(FakeRun(fake_trace(kernels, 1.0), HPCG))
    assert share == pytest.approx(80.0, rel=1e-6)


def test_idle_share_counts_overlap_once():
    kernels = [("a", 0, 400_000_000), ("b", 200_000_000, 500_000_000)]
    assert device_idle_pct.read(FakeRun(fake_trace(kernels, 1.0))) == pytest.approx(50.0)


def test_benchmark_events_count_as_busy_but_in_no_layer():
    from eigbench.layer_metrics import power_vector_ms
    program = [("dia_il_window_kernel<float, float>", 0, 100), ("where_kernel", 100, 300)]
    ours = [("distribution_elementwise_grid_stride_kernel", 300, 700)]
    t = tracing.Trace(kernels=program, window_s=1e-6, busy_s=7e-7, breakdown={}, benchmark=ours)
    run = FakeRun(t, HPCG, iterations=[1])
    assert power_vector_ms.read(run) == pytest.approx(1e3 * 200e-9)
    assert device_idle_pct.read(run) == pytest.approx(30.0)


def test_launches_inside_the_input_span():
    spans = [(10, 20), (40, 50)]
    assert [tracing.inside(spans, t) for t in (5, 10, 19, 20, 45, 60)] == [
        False, True, True, False, True, False]
    assert tracing.RUNTIME_CALL.match("cudaLaunchKernel")
    assert tracing.RUNTIME_CALL.match("cuLaunchKernelEx")
    assert not tracing.RUNTIME_CALL.match("aten::cumsum")


def test_readers_find_nothing_without_their_kernels():
    empty = FakeRun(fake_trace([], 1.0), HPCG)
    assert b1_roofline.read(empty) is None
    assert device_idle_pct.read(empty) is None
    assert b11_roofline.read(FakeRun(fake_trace([("x", 0, 1)], 1.0), {"n": 8})) is None


def test_short_kernel_names():
    assert tracing.short_name(
        "void (anonymous namespace)::dia_il_window_kernel<float, float>(float const*, int)"
    ) == "dia_il_window_kernel<float, float>"
    assert tracing.short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"


def test_idle_gaps_named_by_the_host():
    events = [(0, 100, "eigbench.window"), (10, 60, "eigbench.solve"), (20, 30, "aten::item"),
              (70, 90, "eigbench.readback")]
    names = tracing.host_activity(events, [5, 25, 40, 80, 95])
    assert names == ["harness/python", "eigbench.solve/aten::item", "eigbench.solve/eigbench.solve",
                     "eigbench.readback/eigbench.readback", "harness/python"]
