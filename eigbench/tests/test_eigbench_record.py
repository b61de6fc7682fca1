"""The readers of the program's own record (``host_syncs``,
``host_enqueue_ms``, ``program_idle_ms``) on a made-up record and trace,
and on a traced run of each tiny cell. On the card (``TestDeviceClock``,
skipped without one), the device's clock against the spans, as
``program_idle_ms`` takes it:

    python -m pytest eigbench/tests/test_eigbench_record.py -q -s
"""

import statistics

import numpy as np
import pytest

from eigbench import trace as tracing
from eigbench.layer_metrics import host_enqueue_ms, host_syncs, program_idle_ms, program_record
from eigbench.tests import tiny
from pcsc_eigenvalue_solver_project_tpu_torch.utils import timing
from pcsc_eigenvalue_solver_project_tpu_torch.utils.timing import Span

MS = 1_000_000


class FakeRun:
    def __init__(self, trace=None, completed=2):
        self.trace, self.completed = trace, completed


def fake_trace(kernels, benchmark=()):
    return tracing.Trace(kernels=list(kernels), window_s=1.0, busy_s=0.0, breakdown={},
                         benchmark=list(benchmark))


# two solves: [0, 10) ms with a block holding a 2 ms read and a 3 ms wait
# span holding a 1 ms read (counted once, as the outer wait), and [20, 30) ms
SPANS = [
    Span("eigsol.power_method", 0, 10 * MS, None, 0, False),
    Span("eigsol.power.block", 1 * MS, 4 * MS, 0, 0, False),
    Span("eigsol.read", 1 * MS, 3 * MS, 1, 0, True),
    Span("eigsol.qr.sweeps", 5 * MS, 8 * MS, 0, 0, True),
    Span("eigsol.read", 6 * MS, 7 * MS, 3, 0, True),
    Span("eigsol.power_method", 20 * MS, 30 * MS, None, 5, False),
    Span("eigsol.power.block", 21 * MS, 22 * MS, 5, 5, False),
]


@pytest.fixture
def record(monkeypatch):
    def use(spans, counters):
        monkeypatch.setattr(program_record, "read",
                            lambda: (spans, counters) if spans else None)
    return use


def test_solves_and_their_outermost_waits():
    assert program_record.solves(SPANS) == [
        (0, 0, 10 * MS, [(1 * MS, 3 * MS), (5 * MS, 8 * MS)]), (5, 20 * MS, 30 * MS, [])]


def test_host_syncs_a_solve(record):
    record(SPANS, {"host_reads": 9, "host_writes": 3, "dropped_spans": 5})
    assert host_syncs.read(FakeRun()) == pytest.approx(6.0)
    record(SPANS, {"host_reads": 9})
    assert host_syncs.read(FakeRun()) == pytest.approx(4.5)
    record(SPANS, {})
    assert host_syncs.read(FakeRun()) == 0.0


def test_the_harness_counts_the_solves(record):
    # two entry spans, four solves by the harness: each reader's sum over
    # the spans is shared by the four
    record(SPANS, {"host_reads": 8})
    kernels = [("k1", -2 * MS, 2 * MS), ("k3", 9 * MS, 21 * MS)]
    two, four = FakeRun(fake_trace(kernels), 2), FakeRun(fake_trace(kernels), 4)
    for reader in (host_syncs, host_enqueue_ms, program_idle_ms):
        assert reader.read(four) == pytest.approx(reader.read(two) / 2)
    assert host_enqueue_ms.read(FakeRun(completed=0)) is None


def test_enqueue_leaves_out_the_waits_once(record):
    record(SPANS, {})
    # (10 - 2 - 3) + 10 ms over two solves
    assert host_enqueue_ms.read(FakeRun()) == pytest.approx(7.5)


def test_idle_inside_the_solves_counts_overlap_once(record):
    record(SPANS, {})
    kernels = [("k1", -2 * MS, 2 * MS),      # half inside the first solve: 2 ms of it
               ("k2", 1 * MS, 3 * MS),       # overlaps k1: 1 ms more
               ("k3", 9 * MS, 21 * MS)]      # the first's last ms and the second's first
    inputs = [("draw", 25 * MS, 26 * MS)]    # the benchmark's work is busy too
    run = FakeRun(fake_trace(kernels, inputs))
    # first solve: 10 - (3 + 1) = 6 ms idle; second: 10 - (1 + 1) = 8 ms
    assert program_idle_ms.read(run) == pytest.approx(7.0)


def test_idle_follows_the_device_clock_by_the_reads(record, monkeypatch):
    record(SPANS, {})
    kernels = [("k1", -2 * MS, 2 * MS), ("k3", 9 * MS, 21 * MS),
               ("Memcpy DtoH", 3 * MS - 1000, 3 * MS),  # the reads' copies end as they return
               ("Memcpy DtoH", 7 * MS - 1000, 7 * MS)]
    inputs = [("draw", 25 * MS, 26 * MS)]
    early = lambda events: [(n, s - MS, e - MS) for n, s, e in events]  # 1 ms before the host
    on_time = FakeRun(fake_trace(kernels, inputs))
    shifted = FakeRun(fake_trace(early(kernels), early(inputs)))
    assert program_idle_ms.offset(SPANS, kernels) == 0
    assert program_idle_ms.offset(SPANS, early(kernels)) == -MS
    # first solve: 10 - (2 + 0.002 + 1) ms idle; second: 10 - (1 + 1)
    assert program_idle_ms.read(on_time) == pytest.approx((6.998 + 8) / 2)
    assert program_idle_ms.read(shifted) == pytest.approx((6.998 + 8) / 2)
    monkeypatch.setattr(program_idle_ms, "offset", lambda spans, kernels: 0)
    assert program_idle_ms.read(shifted) == pytest.approx((6.998 + 9) / 2)  # taken as they come


def test_offset_pairs_each_read_with_its_own_copy():
    # two reads 80 µs apart, the device 240 µs early: the copy nearest the
    # first read's end is the second read's
    us = 1000
    spans = [Span("eigsol.arnoldi_eigenvalues", 0, 1000 * us, None, 0, False),
             Span("eigsol.read", 500 * us, 540 * us, 0, 0, True),
             Span("eigsol.read", 580 * us, 620 * us, 0, 0, True)]
    copies = [("Memcpy DtoH", e - 247 * us, e - 245 * us) for e in (540 * us, 620 * us)]
    other = [("Memcpy DtoH", 100 * us, 101 * us)]  # a read of the sweeps' launcher
    assert program_idle_ms.offset(spans, copies + other) == -245 * us


def test_overlap_of_disjoint_spans():
    busy = [[0, 10], [20, 30], [40, 50]]
    assert program_idle_ms.overlap(busy, 5, 45) == 5 + 10 + 5
    assert program_idle_ms.overlap(busy, 10, 20) == 0
    assert program_idle_ms.overlap(busy, -5, 100) == 30


def test_readers_find_nothing_without_a_record(record):
    record([], {})
    run = FakeRun(fake_trace([("k", 0, 1)]))
    assert host_syncs.read(run) is None
    assert host_enqueue_ms.read(run) is None
    assert program_idle_ms.read(run) is None
    record(SPANS, {"host_reads": 1})
    assert program_idle_ms.read(FakeRun(None)) is None
    assert program_idle_ms.read(FakeRun(fake_trace([]))) is None


def test_a_program_without_the_record(monkeypatch):
    monkeypatch.delattr(timing, "spans")
    assert program_record.read() is None
    assert host_syncs.read(FakeRun()) is None


@pytest.mark.parametrize("name", tiny.CELLS)
def test_traced_tiny_cells_report_the_record(name):
    timing.reset()
    cell, run = tiny.run(name, trace=True)
    try:
        metrics = {m: plugin.read(run) for m, plugin in
                   (("host_syncs", host_syncs), ("host_enqueue_ms", host_enqueue_ms))}
        solves = program_record.solves(timing.spans())
    finally:
        timing.reset()
    assert len(solves) == run.completed  # one entry span a solve
    assert metrics["host_enqueue_ms"] > 0
    # power: reads at k = 0, 32, 64, 96, 100, three flags and tol uploaded;
    # Arnoldi: the breakdown index and two results' sweep count and flag;
    # the dense solve: its result's. The CPU routes of the QR solves read
    # nothing through host_read.
    assert metrics["host_syncs"] == {"hpcg27-256.power": 9.0, "hpcg27-256.arnoldi": 5.0,
                                     "geev-f32-2048.eigvals": 2.0}[name]


# --------------------------------------------------------------------------
# On the card: the device's clock
# --------------------------------------------------------------------------

CLOCK_NS = 20_000
SLACK_NS = 2_000
# Kineto's device times of cooperative (B13) and cluster (B7) launches can
# lie before their launch call (by up to 0.29 ms on the H100): the device
# clock is checked on the kernels of plain launches.
PLAIN_LAUNCH = "cudaLaunchKernel"


def card_solves(device):
    """``{name: call}``: the benchmark's three solves at sizes that take
    milliseconds, each on fixed inputs."""
    import pcsc_eigenvalue_solver_project_tpu_torch as T
    import torch
    n = 1 << 18
    rng = np.random.default_rng(7)
    offsets = [-65, -1, 0, 1, 65]
    diagonals = [rng.uniform(0.5, 1.0, n) for _ in offsets]
    diagonals[2] = diagonals[2] + 8.0
    M = T.SparseDIA.from_diagonals(diagonals, offsets, n, dtype=np.float32,
                                   device=device).interleaved()
    x0 = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(device)
    dense = T.DenseMatrix.from_array(rng.uniform(-1, 1, (512, 512)).astype(np.float32),
                                     device=device)
    return {
        "power": lambda: T.power_method(M, T.SolverOptions(200, 0.0), x0=x0),
        "arnoldi": lambda: T.arnoldi_eigenvalues(M, k=4, m=20, x0=x0),
        "eigvals": lambda: T.qr_eigenvalues(dense, T.QROptions(
            mode="accelerated", tolerance=3e-6, max_iterations=20 * 512)),
    }


@pytest.mark.cuda
class TestDeviceClock:
    @pytest.fixture(scope="class")
    def solves(self):
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        calls = card_solves(torch.device("cuda"))
        for call in calls.values():
            call()  # builds and loads the kernels
        torch.cuda.synchronize()
        return calls

    @pytest.mark.parametrize("name", ["power", "arnoldi", "eigvals"])
    def test_the_reads_put_the_device_on_the_spans_clock(self, solves, name):
        """Taken onto the spans' clock by ``program_idle_ms.offset``, the
        kernels of plain launches start after their launch call, and each
        wait ends after the device work launched before it."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        timing.reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(tracing.WINDOW_SPAN):
                solves[name]()
                torch.cuda.synchronize()
        spans = timing.spans()
        timing.reset()
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.profiler.kineto_results.events()
        launch = {e.correlation_id(): e for e in events
                  if e.device_type() != cuda and e.name().startswith("cuda")}
        device = [e for e in events if e.device_type() == cuda and not e.is_user_annotation()
                  and e.correlation_id() in launch]
        offset = program_idle_ms.offset(spans, tracing.reduce(prof).kernels)
        after = [e.start_ns() - offset - launch[e.correlation_id()].start_ns() for e in device
                 if launch[e.correlation_id()].name() == PLAIN_LAUNCH]
        early = sum(1 for t in after if t < -SLACK_NS)
        late = 0
        for s in spans:
            if s.wait:
                before = [e.end_ns() - offset for e in device
                          if launch[e.correlation_id()].start_ns() < s.start_ns]
                late = max([late] + [t - s.end_ns for t in before])
        print(f"\n{name}: device clock {offset / 1e3:.2f} us off; a plain launch's kernel "
              f"starts a median {statistics.median(after) / 1e3:.2f} us after its call "
              f"({early} of {len(after)} before it); device end after a wait "
              f"{late / 1e3:.2f} us")
        assert statistics.median(after) >= -SLACK_NS and early <= len(after) // 100
        assert late <= CLOCK_NS
