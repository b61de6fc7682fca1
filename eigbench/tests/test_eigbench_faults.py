"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: a step that returns its state unchanged, half
of the rows left out, an answer altered where it is produced. (One chip:
no exchange between chips to leave out.) The sound run is correct."""

import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu_torch as port
from pcsc_eigenvalue_solver_project_tpu_torch.matrix.dia import InterleavedDIA
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import qr_eigenvalues as qe
from eigbench.tests import tiny


def half_rows(y):
    y = y.clone()
    y.view(-1)[y.numel() // 2:] = 0
    return y


def break_spmv(monkeypatch, how):
    matvec = InterleavedDIA.matvec
    if how == "state_unchanged":
        monkeypatch.setattr(InterleavedDIA, "matvec", lambda self, x: x.clone())
    else:
        monkeypatch.setattr(InterleavedDIA, "matvec", lambda self, x: half_rows(matvec(self, x)))


def alter(monkeypatch, name, field):
    call = getattr(port, name)

    def altered(*args, **kwargs):
        result = call(*args, **kwargs)
        value = getattr(result, field).clone()
        value.view(-1)[0] *= 1.01
        setattr(result, field, value)
        return result

    monkeypatch.setattr(port, name, altered)


def break_qr(monkeypatch, how):
    if how == "state_unchanged":  # the sweeps leave H as it is: diag(H) comes out
        def unchanged(h, max_sweeps, tol):
            d = torch.diagonal(h)
            return torch.stack([d, torch.zeros_like(d)]), 0, True
        monkeypatch.setattr(qe, "_qr_eigenvalues_accel_real", unchanged)
    else:
        call = port.qr_eigenvalues

        def half(*args, **kwargs):
            result = call(*args, **kwargs)
            result.eigenvalues = half_rows(result.eigenvalues)
            return result
        monkeypatch.setattr(port, "qr_eigenvalues", half)


FIELDS = {"power_method": "eigenvalue", "arnoldi_eigenvalues": "eigenvalues",
          "qr_eigenvalues": "eigenvalues"}


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_fault_is_not_correct(monkeypatch, name, fault):
    call = tiny.cell(name).mix["call"]
    if fault == "answer_altered":
        alter(monkeypatch, call, FIELDS[call])
    elif call == "qr_eigenvalues":
        break_qr(monkeypatch, fault)
    else:
        break_spmv(monkeypatch, fault)
    _, run = tiny.run(name)
    assert run.completed > 0
    assert run.correct is False, run.checks


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_run_is_correct(name):
    _, run = tiny.run(name, seed=12345)
    assert run.correct is True, run.checks
