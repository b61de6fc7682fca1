"""The port's own spans and counters (``utils/timing.py``).

On the CPU: nothing is recorded without a profile; spans nest with their
parent and solve under ``torch.profiler.profile``; a 200-iteration power
run at tolerance 0 records its 8 reads of ``(k, done)``, its 4 uploads and
8 blocks; the Arnoldi steps, the QR driver's reduction and reads and an AED
round record theirs; every public solver opens the outermost span of its
call (``eigsol.<its name>``), so one call is one solve; ``reset()`` and the
cap.

On the card (``TestOnTheCard``, skipped without one; no JAX needed):

    python -m pytest --noconftest tests/test_torch_tracing.py -q -s

each of the benchmark's three solves (power and Arnoldi on a banded
``InterleavedDIA``, accelerated QR eigenvalues of a dense 512 matrix through
B7 and of a 1024 one through B11): the spans' ``time.time_ns`` intervals
against kineto's host events for them (one clock: each of ours inside
kineto's range for it, the median gap within 20 µs); the device events the
same with the spans on and gated off; ``host_reads`` equal to the
device-to-host copies inside the solve, and ``host_reads + host_writes``
to its blocking runtime calls. ``-s`` prints a line a solve with those
counts. The device's clock against the spans is the benchmark's concern
(``eigbench/tests/test_eigbench_record.py``).
"""

import contextlib
import statistics
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_aed
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk
from pcsc_eigenvalue_solver_project_tpu_torch.utils import checkpoint, timing

CPU = [ProfilerActivity.CPU]
CLOCK_NS = 20_000
SLACK_NS = 2_000


@pytest.fixture(autouse=True)
def clean_record():
    timing.reset()
    yield
    timing.reset()


def slow_diagonal(n=64, device="cpu"):
    """Eigenvalues 1 ... 0.9: at tolerance 0 the Rayleigh quotient moves
    every iteration of a 200-iteration run, so none stops early."""
    return T.SparseDIA.from_diagonals([np.linspace(1.0, 0.9, n)], [0], n, dtype=np.float64,
                                      device=device)


def names(spans):
    return Counter(s.name for s in spans)


class TestRecord:
    def test_nothing_recorded_without_a_profile(self):
        null = timing.annotate("eigsol.x")
        assert isinstance(null, contextlib.nullcontext)
        assert timing.annotate("eigsol.y", wait=True) is null
        r = T.power_method(slow_diagonal(), T.SolverOptions(200, 0.0), x0=np.ones(64))
        timing.count("host_reads")
        assert int(r.iterations) == 200
        assert timing.spans() == [] and timing.counters() == {}

    def test_nesting_parent_and_solve(self):
        with profile(activities=CPU):
            with timing.annotate("a"):
                with timing.annotate("b"):
                    with timing.annotate("c", wait=True):
                        pass
                with timing.annotate("d"):
                    pass
            with timing.annotate("e"):
                with timing.annotate("f"):
                    pass
            timing.count("k")
            timing.count("k", 3)
        spans = timing.spans()
        assert [(s.name, s.parent, s.solve, s.wait) for s in spans] == [
            ("a", None, 0, False), ("b", 0, 0, False), ("c", 1, 0, True), ("d", 0, 0, False),
            ("e", None, 4, False), ("f", 4, 4, False)]
        for s in spans:
            assert 0 < s.start_ns <= s.end_ns
            if s.parent is not None:
                p = spans[s.parent]
                assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert spans[0].end_ns <= spans[4].start_ns
        assert timing.counters() == {"k": 4}

    def test_span_closes_on_an_exception(self):
        with profile(activities=CPU):
            with pytest.raises(ValueError):
                with timing.annotate("a"):
                    raise ValueError("x")
            with timing.annotate("b"):
                pass
        assert [(s.name, s.parent) for s in timing.spans()] == [("a", None), ("b", None)]
        assert all(s.end_ns for s in timing.spans())

    def test_spans_are_on_the_profile(self):
        with profile(activities=CPU) as prof:
            T.power_method(slow_diagonal(), T.SolverOptions(200, 0.0), x0=np.ones(64))
        events = sorted((e.name(), e.start_ns(), e.end_ns())
                        for e in prof.profiler.kineto_results.events()
                        if e.name().startswith("eigsol."))
        mine = sorted((s.name, s.start_ns, s.end_ns) for s in timing.spans())
        assert [e[0] for e in events] == [s[0] for s in mine]
        for (_, s0, e0), (_, s1, e1) in zip(events, mine):
            assert s0 <= s1 + 1000 and e1 <= e0 + 1000  # kineto's range holds ours

    def test_power_method_reads_once_a_block(self):
        with profile(activities=CPU):
            r = T.power_method(slow_diagonal(), T.SolverOptions(200, 0.0), x0=np.ones(64))
        assert int(r.iterations) == 200 and not bool(r.converged)
        spans = timing.spans()
        # reads at k = 0, 32, ..., 192, 200; uploads of three flags and tol
        assert timing.counters() == {"host_reads": 8, "host_writes": 4}
        assert names(spans) == {"eigsol.power_method": 1, "eigsol.power.block": 8,
                                "eigsol.read": 8, "eigsol.write": 4}
        assert spans[0].name == "eigsol.power_method" and spans[0].parent is None
        assert all(s.solve == 0 for s in spans)
        blocks = [i for i, s in enumerate(spans) if s.name == "eigsol.power.block"]
        assert all(spans[i].parent == 0 for i in blocks)
        reads = [s for s in spans if s.name == "eigsol.read"]
        assert sorted(s.parent for s in reads) == blocks and all(s.wait for s in reads)
        writes = [s for s in spans if s.name == "eigsol.write"]
        assert all(s.parent == 0 and s.wait for s in writes)

    def test_arnoldi_steps_and_projection(self):
        n, m = 40, 6
        band = [np.full(n, 4.0), np.linspace(1.0, 2.0, n), np.linspace(0.5, 1.0, n)]
        M = T.SparseDIA.from_diagonals(band, [0, 1, -1], n, dtype=np.float64, device="cpu")
        with profile(activities=CPU):
            T.arnoldi_eigenvalues(M, k=2, m=m, x0=np.ones(n))
        spans = timing.spans()
        # uploads: the breakdown index, and the sweep count and flag of the
        # projection's result (on the CPU route) and of the solve's
        assert names(spans) == {"eigsol.arnoldi_eigenvalues": 1, "eigsol.arnoldi.spmv": m,
                                "eigsol.arnoldi.orthogonalize": m,
                                "eigsol.arnoldi.projection": 1, "eigsol.write": 5}
        assert timing.counters() == {"host_writes": 5}
        assert spans[0].name == "eigsol.arnoldi_eigenvalues"
        assert all(s.solve == 0 for s in spans) and spans[0].end_ns >= spans[-1].end_ns

    def test_qr_driver_reduction_and_reads(self):
        n = 24
        a = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (n, n)))
        with profile(activities=CPU):
            eig, sweeps, converged = qk.accelerated_eigenvalues(a, 20 * n, 1e-10)
        assert converged and isinstance(sweeps, int)
        assert names(timing.spans()) == {"eigsol.qr.hessenberg": 1, "eigsol.read": 2}
        assert timing.counters() == {"host_reads": 2}

    def test_qr_eigenvalues_is_a_solve(self):
        M = T.DenseMatrix.from_array(np.diag([3.0, 2.0, 1.0]), device="cpu")
        with profile(activities=CPU):
            T.qr_eigenvalues(M, T.QROptions(mode="accelerated"))
        spans = timing.spans()
        assert spans[0].name == "eigsol.qr_eigenvalues" and spans[0].parent is None

    def test_aed_round_span(self, monkeypatch):
        h = torch.zeros((8, 8), dtype=torch.complex128)
        monkeypatch.setattr(qr_aed, "aed_round", lambda h, hi, tol, w: (h, 2, 0, h[0]))
        monkeypatch.setattr(qr_aed, "qr_eig_blocked_step",
                            lambda h, b, tol, shifts: (h, h[0], torch.tensor(3), torch.tensor(5)))
        with profile(activities=CPU):
            out = qr_aed.aed_sweep_round(h, 8, 4, 1e-6, 4)
        assert out[2:5] == (3, 5, 2)
        assert timing.counters() == {"host_reads": 1}
        assert [(s.name, s.parent) for s in timing.spans()] == [("eigsol.qr.aed_round", None),
                                                                ("eigsol.read", 0)]

    def test_reset_and_cap(self, monkeypatch):
        monkeypatch.setattr(timing, "MAX_SPANS", 3)
        with profile(activities=CPU):
            with timing.annotate("s0"):
                for i in range(1, 5):
                    with timing.annotate(f"s{i}"):
                        pass
            timing.count("host_reads")
        assert [(s.name, s.parent) for s in timing.spans()] == [
            ("s0", None), ("s1", 0), ("s2", 0)]
        assert timing.counters() == {"dropped_spans": 2, "host_reads": 1}
        timing.reset()
        assert timing.spans() == [] and timing.counters() == {}
        with profile(activities=CPU):
            with timing.annotate("again"):
                pass
        assert [s.name for s in timing.spans()] == ["again"]

    def test_host_read_leaves_host_values(self):
        with profile(activities=CPU):
            assert timing.host_read(7) == 7
            assert timing.host_read(torch.tensor([1, 2])) == [1, 2]
        assert timing.counters() == {"host_reads": 1}

    def test_host_write_and_flags(self):
        from pcsc_eigenvalue_solver_project_tpu_torch.utils.loops import flag
        on = torch.tensor(True)
        with profile(activities=CPU):
            t = timing.host_write(3, "cpu", torch.int32)
            f = flag(False, "cpu")
            g = flag(on, "cpu")  # a tensor already: no copy from the host
        assert t.dtype == torch.int32 and int(t) == 3 and t.shape == ()
        assert f.dtype == torch.bool and f.shape == () and not bool(f)
        assert g.dtype == torch.bool and g.shape == () and bool(g)
        assert timing.counters() == {"host_writes": 2}
        assert [(s.name, s.wait) for s in timing.spans()] == [("eigsol.write", True)] * 2


# --------------------------------------------------------------------------
# Every public solver is a solve: its call's outermost span
# --------------------------------------------------------------------------

# public functions of the package that run no solver
NOT_SOLVERS = {"from_coo", "is_close_relative", "read_matrix_from_file",
               "read_matrix_from_text", "suggest_layout", "write_matrix_to_file"}


def public_calls(tmp_path):
    """``{name: call}``: each public solver once, on a small operator."""
    n = 40
    M = T.SparseDIA.from_diagonals([np.linspace(1.0, 4.0, n), np.full(n, 0.5), np.full(n, 0.5)],
                                   [0, 1, -1], n, dtype=np.float64, device="cpu")
    D = T.DenseMatrix.from_array(np.random.default_rng(3).uniform(-1, 1, (12, 12)),
                                 device="cpu")
    x0 = np.linspace(1.0, 2.0, n)
    opts = T.SolverOptions(40, 1e-8)
    shifted = T.ShiftedSolverOptions(max_iterations=10, shift=3.9)
    return {
        "power_method": lambda: T.power_method(M, opts, x0=x0),
        "power_method_ds64": lambda: T.power_method_ds64(M, opts, x0=x0),
        "power_method_split_complex": lambda: T.power_method_split_complex(
            T.SplitComplexDIA.from_complex_dia(M, precision=np.float64), opts),
        "arnoldi_eigenvalues": lambda: T.arnoldi_eigenvalues(M, k=2, m=8, x0=x0),
        "krylov_schur_eigenvalues": lambda: T.krylov_schur_eigenvalues(M, k=2, m=10, restarts=2,
                                                                       x0=x0),
        "lanczos_eigenvalues": lambda: T.lanczos_eigenvalues(M, k=2, m=10, x0=x0),
        "lanczos_eigenpairs": lambda: T.lanczos_eigenpairs(M, k=2, m=10, x0=x0),
        "lanczos_thick_restart": lambda: T.lanczos_thick_restart(M, k=2, m=10, restarts=2,
                                                                 x0=x0),
        "lobpcg_eigenvalues": lambda: T.lobpcg_eigenvalues(M, k=2, opts=T.SolverOptions(8, 1e-6)),
        "subspace_iteration": lambda: T.subspace_iteration(M, k=2, opts=T.SolverOptions(20, 1e-6)),
        "chebyshev_subspace_iteration": lambda: T.chebyshev_subspace_iteration(
            M, k=2, opts=T.SolverOptions(6, 1e-6)),
        "shifted_inverse_power_method": lambda: T.shifted_inverse_power_method(M, shifted, x0=x0),
        "rayleigh_quotient_iteration": lambda: T.rayleigh_quotient_iteration(M, shifted, x0=x0),
        "solve_shifted": lambda: T.solve_shifted(M, 0.3, torch.ones(n, dtype=torch.float64)),
        "qr_eigenvalues": lambda: T.qr_eigenvalues(D, T.QROptions(mode="accelerated")),
        "qr_decompose": lambda: T.qr_decompose(D),
        "to_hessenberg": lambda: T.to_hessenberg(D),
        "power_method_checkpointed": lambda: checkpoint.power_method_checkpointed(
            M, opts, checkpoint_dir=str(tmp_path), chunk=20, x0=x0),
    }


SOLVERS = sorted(public_calls("unused"))


def distributed_entries():
    """The distributed solvers and the checkpointed power runs: every
    public ``distributed_*`` function but the matvecs, the distributed
    shifted solve, ``power_method_checkpointed``."""
    import importlib
    import inspect
    import pkgutil
    from pcsc_eigenvalue_solver_project_tpu_torch import parallel
    modules = [importlib.import_module(f"{parallel.__name__}.{m.name}")
               for m in pkgutil.iter_modules(parallel.__path__)] + [checkpoint]
    found = {}
    for module in modules:
        for name, fn in inspect.getmembers(module, inspect.isfunction):
            if fn.__module__ != module.__name__:
                continue
            if ((name.startswith("distributed_") and not name.endswith("_matvec"))
                    or name in ("solve_shifted_distributed", "power_method_checkpointed")):
                found[f"{module.__name__}.{name}"] = fn
    return found


class TestEntries:
    @pytest.mark.parametrize("name", SOLVERS)
    def test_a_public_solver_is_one_solve(self, name, tmp_path):
        call = public_calls(tmp_path)[name]
        with profile(activities=CPU):
            call()
        spans = timing.spans()
        assert spans[0].name == f"eigsol.{name}" and spans[0].parent is None
        assert all(s.solve == 0 for s in spans), names(s for s in spans if s.solve != 0)
        assert spans[0].end_ns >= max(s.end_ns for s in spans)
        if not name.startswith("power_method"):  # other loops name their own blocks
            assert "eigsol.power.block" not in names(spans)

    def test_every_public_solver_is_listed(self):
        import inspect
        public = {n for n in T.__all__ if inspect.isfunction(getattr(T, n))}
        assert public - NOT_SOLVERS == set(SOLVERS) - {"power_method_checkpointed"}
        assert all(getattr(T, n).span == f"eigsol.{n}" for n in public - NOT_SOLVERS)

    def test_distributed_entries_open_their_span(self):
        entries = distributed_entries()
        assert len(entries) >= 14
        for qualified, fn in entries.items():
            assert getattr(fn, "span", None) == f"eigsol.{fn.__name__}", qualified


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def card_solves(device):
    """``{name: call}``: the benchmark's three solves at sizes that take
    milliseconds, the dense one through B7 (512) and through B11 (1024, as
    the benchmark's 2048), each call on fixed inputs."""
    n = 1 << 18
    rng = np.random.default_rng(7)
    offsets = [-65, -1, 0, 1, 65]
    diagonals = [rng.uniform(0.5, 1.0, n) for _ in offsets]
    diagonals[2] = diagonals[2] + 8.0
    M = T.SparseDIA.from_diagonals(diagonals, offsets, n, dtype=np.float32,
                                   device=device).interleaved()
    x0 = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(device)
    dense = {size: T.DenseMatrix.from_array(rng.uniform(-1, 1, (size, size)).astype(np.float32),
                                            device=device) for size in (512, 1024)}

    def eigvals(size):
        return lambda: T.qr_eigenvalues(dense[size], T.QROptions(
            mode="accelerated", tolerance=3e-6, max_iterations=20 * size))

    return {
        "power": lambda: T.power_method(M, T.SolverOptions(200, 0.0), x0=x0),
        "arnoldi": lambda: T.arnoldi_eigenvalues(M, k=4, m=20, x0=x0),
        "eigvals": eigvals(512),
        "eigvals-b11": eigvals(1024),
    }


CARD_SOLVES = ["power", "arnoldi", "eigvals", "eigvals-b11"]


def profiled(call):
    """The record and the profile of one ``call``."""
    timing.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return prof, timing.spans(), timing.counters()


def split(prof):
    """``(host events, the device's kernels and copies)``, from kineto's
    own list."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() != cuda]
    device = [e for e in events if e.device_type() == cuda and not e.is_user_annotation()
              and not e.name().startswith("eigsol.")]
    return host, device


@pytest.mark.cuda
class TestOnTheCard:
    @pytest.fixture
    def solves(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        calls = card_solves(torch.device("cuda"))
        for call in calls.values():
            call()  # builds and loads the kernels
        torch.cuda.synchronize()
        return calls

    @pytest.mark.parametrize("name", CARD_SOLVES)
    def test_one_clock(self, solves, name):
        prof, spans, _ = profiled(solves[name])
        host, _ = split(prof)
        by_name = {}
        for e in host:
            if e.name().startswith("eigsol."):
                by_name.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
        # ours is read inside kineto's range for the span: on one clock each
        # gap is the range's own entry or exit cost, never negative
        starts, ends = [], []
        for span_name, theirs in by_name.items():
            ours = sorted((s.start_ns, s.end_ns) for s in spans if s.name == span_name)
            assert len(ours) == len(theirs), span_name
            for (s0, e0), (s1, e1) in zip(sorted(theirs), ours):
                starts.append(s1 - s0)
                ends.append(e0 - e1)
        assert len(starts) == len(spans)
        print(f"\n{name}: {len(spans)} spans; time_ns after kineto's start: median "
              f"{statistics.median(starts) / 1e3:.2f} us, least {min(starts) / 1e3:.2f}, most "
              f"{max(starts) / 1e3:.2f}; before its end: median {statistics.median(ends) / 1e3:.2f}"
              f", least {min(ends) / 1e3:.2f}, most {max(ends) / 1e3:.2f}")
        assert min(starts) >= -SLACK_NS and min(ends) >= -SLACK_NS
        assert statistics.median(starts) <= CLOCK_NS and statistics.median(ends) <= CLOCK_NS

    @pytest.mark.parametrize("name", CARD_SOLVES)
    def test_spans_add_no_device_work(self, solves, name, monkeypatch):
        on = [e.name() for e in split(profiled(solves[name])[0])[1]]
        monkeypatch.setattr(timing, "_enabled", lambda: False)
        prof, spans, _ = profiled(solves[name])
        off = [e.name() for e in split(prof)[1]]
        assert spans == [] and on
        assert len(on) == len(off) and Counter(on) == Counter(off)

    @pytest.mark.parametrize("name", CARD_SOLVES)
    def test_counted_transfers_are_the_blocking_calls(self, solves, name):
        prof, spans, counters = profiled(solves[name])
        host, device = split(prof)
        solve_spans = [(s.start_ns, s.end_ns) for s in spans if s.parent is None]
        assert len(solve_spans) == 1
        s0, e0 = solve_spans[0]
        dtoh = {e.correlation_id() for e in device if e.name().startswith("Memcpy DtoH")}
        inside = [e for e in host if s0 <= e.start_ns() < e0]
        reads = sum(1 for e in inside
                    if e.name().startswith("cudaMemcpy") and e.correlation_id() in dtoh)
        syncs = sum(1 for e in inside if e.name() in SYNC_CALLS)
        counted = counters.get("host_reads", 0) + counters.get("host_writes", 0)
        print(f"\n{name}: host_reads {counters.get('host_reads', 0)}, host_writes "
              f"{counters.get('host_writes', 0)}, device-to-host copies {reads}, blocking calls "
              f"{syncs}, spans {dict(names(spans))}")
        assert counters["host_reads"] == reads
        assert counted == syncs
