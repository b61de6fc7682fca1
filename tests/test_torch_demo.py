"""The demo CLI and the rest of the PyTorch port's public surface against the
JAX package, on the CPU: ``demo.py`` (the reference flow and the solvers on
a file), the package's ``__all__``, ``dense_diagonal``, ``utils/logging.py``
and ``utils/timing.py``.

The reference flow on ``--device cpu`` prints the JAX ``--cpu`` run's lines
with the same values (eigenvalues to the 10 digits printed, i.e. within
1e-10 relative); only the power-family iteration counts differ, since the
two packages draw their default start vectors from different generators.
The solvers on a file are held to numpy's spectrum to 1e-8 (QR to the JAX
run's printed values).
"""

import io
import json
import logging
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu import demo as j_demo
from pcsc_eigenvalue_solver_project_tpu.models import generators as j_gen
from pcsc_eigenvalue_solver_project_tpu.utils import logging as j_logging
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch import demo as t_demo
from pcsc_eigenvalue_solver_project_tpu_torch.models import generators as t_gen
from pcsc_eigenvalue_solver_project_tpu_torch.utils import logging as t_logging
from pcsc_eigenvalue_solver_project_tpu_torch.utils import timing as t_timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")


def run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def masked(text):
    """The printed lines with the power-family iteration counts masked."""
    return [re.sub(r"iterations = \d+  converged", "iterations = #  converged", line)
            for line in text.splitlines()]


def values(text, key):
    return np.array([complex(v.replace("i", "j").strip("()"))
                     for v in re.findall(rf"{key}\[\d+\] = (\S+)", text)])


@pytest.fixture(scope="module")
def band_file(tmp_path_factory):
    """A 200-row symmetric band with four separated eigenvalues, written by
    the port's writer (sparse, float64), and its spectrum."""
    rng = np.random.default_rng(5)
    n = 200
    a = np.zeros((n, n))
    for off in range(1, 4):
        v = rng.uniform(-0.5, 0.5, n - off)
        a += np.diag(v, off) + np.diag(v, -off)
    a += np.diag(np.concatenate([[8.0, 7.0, 6.5, 6.0], rng.uniform(-0.5, 0.5, n - 4)]))
    p = str(tmp_path_factory.mktemp("demo") / "band.txt")
    T.write_matrix_to_file(p, T.SparseCSR.from_dense(a, device="cpu"))
    return p, np.linalg.eigvalsh(a)


class TestReferenceFlow:
    def test_prints_the_jax_runs_values(self):
        rc_t, out_t = run(t_demo.main, ["--device", "cpu", "--data-dir", DATA])
        rc_j, out_j = run(j_demo.main, ["--cpu", "--data-dir", DATA])
        assert rc_t == rc_j == 0
        assert masked(out_t) == masked(out_j)
        assert "qr_eigenvalues(B): raised as expected" in out_t

    def test_device_flag(self):
        with pytest.raises(SystemExit):
            run(t_demo.main, ["--device", "tpu"])
        with pytest.raises(SystemExit):  # the JAX flag is not the port's
            run(t_demo.main, ["--cpu"])


class TestSolversOnAFile:
    @pytest.mark.parametrize("solver", ["arnoldi", "lanczos", "trlanczos", "lobpcg",
                                        "subspace"])
    def test_top_four(self, band_file, solver):
        path, ev = band_file
        rc, out = run(t_demo.main, [path, "--device", "cpu", "--solver", solver, "--k", "4"])
        assert rc == 0
        got = np.sort(values(out, "ritz").real)[::-1]
        np.testing.assert_allclose(got, np.sort(ev)[::-1][:4], atol=1e-8)

    @pytest.mark.parametrize("mode", ["parity", "accelerated"])
    def test_qr_matches_jax(self, mode):
        path = os.path.join(DATA, "A.txt")
        argv = [path, "--dtype", "complex128", "--solver", "qr", "--qr-mode", mode]
        rc_t, out_t = run(t_demo.main, argv + ["--device", "cpu"])
        rc_j, out_j = run(j_demo.main, argv + ["--cpu"])
        assert rc_t == rc_j == 0
        np.testing.assert_allclose(np.sort_complex(values(out_t, "lambda")),
                                   np.sort_complex(values(out_j, "lambda")), rtol=1e-10)

    def test_power_and_inverse(self, band_file):
        path, ev = band_file
        rc, out = run(t_demo.main, [path, "--device", "cpu"])
        assert rc == 0 and "converged = True" in out
        lam = complex(re.search(r"eigenvalue = (\S+)", out).group(1).strip("()"))
        assert abs(lam - ev.max()) < 1e-8
        rc, out = run(t_demo.main, [path, "--device", "cpu", "--solver", "inverse",
                                    "--shift", "6.9"])
        lam = complex(re.search(r"eigenvalue = (\S+)", out).group(1).strip("()"))
        assert abs(lam - ev[np.argmin(np.abs(ev - 6.9))]) < 1e-8


class TestPublicSurface:
    def test_all_equals_the_jax_packages(self):
        assert set(T.__all__) == set(J.__all__)
        for name in T.__all__:
            assert hasattr(T, name), name

    def test_dense_diagonal(self):
        d = [3.0, -1.0, 2.5]
        for dt in (np.float32, np.float64, np.complex128):
            got = t_gen.dense_diagonal(d, dtype=dt, device="cpu")
            want = j_gen.dense_diagonal(d, dtype=dt)
            np.testing.assert_array_equal(got.array.numpy(), np.asarray(want.array))
            assert got.array.numpy().dtype == np.asarray(want.array).dtype


@pytest.fixture
def clean_logger():
    """Drop the handlers a test's ``get_logger`` adds (bound to the test's
    captured stderr)."""
    logger = logging.getLogger("eigsol_tpu")
    handlers, level = list(logger.handlers), logger.level
    yield logger
    logger.handlers[:] = handlers
    logger.setLevel(level)


@pytest.mark.usefixtures("clean_logger")
class TestLogging:
    def test_logger_name_and_events(self, capsys):
        assert t_logging.LOGGER_NAME == j_logging.LOGGER_NAME == "eigsol_tpu"
        assert t_logging.get_logger("solver").name == j_logging.get_logger("solver").name
        t_logging.emit_event("bench", value=1.5, name="x")
        rec = json.loads(capsys.readouterr().err.strip())
        assert rec["event"] == "bench" and rec["value"] == 1.5 and rec["name"] == "x"
        assert set(rec) == {"event", "ts", "value", "name"}

    def test_log_result(self, caplog):
        M = T.DenseMatrix.from_array(np.diag([4.0, 1.0]), device="cpu")
        r = T.power_method(M, T.SolverOptions(tolerance=1e-12), x0=np.array([1.0, 1.0]))
        logger = logging.getLogger("eigsol_tpu")
        logger.propagate, old = True, logger.propagate
        try:
            with caplog.at_level(logging.INFO, logger="eigsol_tpu"):
                t_logging.log_result("power", r)
        finally:
            logger.propagate = old
        assert re.search(r"power: eigenvalue=\(\S+\+0j\) iterations=\d+ converged=True",
                         caplog.text)


class TestTiming:
    def test_readback_and_timers(self):
        x = torch.arange(5.0)
        assert t_timing.readback(x * 2) == 0.0
        assert t_timing.readback(torch.tensor([3.0 + 4.0j])) == 3.0

    def test_trace_and_annotate(self, tmp_path):
        with t_timing.trace(str(tmp_path)):
            with t_timing.annotate("eigsol-region"):
                torch.ones(64).sum()
        trace = json.loads((tmp_path / "trace.json").read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert "eigsol-region" in names
