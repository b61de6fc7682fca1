"""Demo application — the reference's ``main.cpp`` re-enacted, plus a CLI.

The port of the JAX package's ``demo.py``. The reference demo
(main.cpp:41-149) hardcodes its inputs: read ``data/A.txt`` (dense complex)
and ``data/B.txt`` (sparse complex), run the power method on both, shifted
inverse power with sigma = 3.1 and 2.3, then Hessenberg, QR decomposition,
and QR eigenvalues with error reporting. This module reproduces that flow
and adds the argument parsing the reference lacks. Everything runs on
``--device`` (the card by default), in every dtype the card has, complex128
included.

Run:  python -m pcsc_eigenvalue_solver_project_tpu_torch.demo [--device cpu]
      python -m pcsc_eigenvalue_solver_project_tpu_torch.demo FILE --dtype complex128 \
          --solver qr --shift 2.3 --tolerance 1e-10
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .core.dtypes import dtype_name


def _fmt(z) -> str:
    z = complex(z)
    if z.imag == 0:
        return f"{z.real:.10g}"
    return f"({z.real:.10g}{z.imag:+.10g}i)"


def _print_result(name, res):
    print(f"  {name}: eigenvalue = {_fmt(res.eigenvalue)}  "
          f"iterations = {int(res.iterations)}  converged = {bool(res.converged)}")


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def run_reference_demo(data_dir: str, device) -> int:
    from . import (ShiftedSolverOptions, SolverOptions, power_method, qr_decompose,
                   qr_eigenvalues, read_matrix_from_file, shifted_inverse_power_method,
                   to_hessenberg)

    dt = np.complex128
    a_path = os.path.join(data_dir, "A.txt")
    b_path = os.path.join(data_dir, "B.txt")
    A = read_matrix_from_file(a_path, dt, device=device)
    B = read_matrix_from_file(b_path, dt, device=device)
    print(f"Read A: dense {A.shape[0]}x{A.shape[1]} {dtype_name(A.dtype)}")
    print(f"Read B: sparse {B.shape[0]}x{B.shape[1]} {dtype_name(B.dtype)}, nnz={B.nnz}")

    opts = SolverOptions(max_iterations=1000, tolerance=1e-10)
    print("\nPower method (main.cpp:50-68):")
    _print_result("A", power_method(A, opts))
    _print_result("B", power_method(B, opts))

    print("\nShifted inverse power (main.cpp:71-97, sigma=3.1 / 2.3, tol=1e-12):")
    _print_result("A sigma=3.1", shifted_inverse_power_method(
        A, ShiftedSolverOptions(shift=3.1, tolerance=1e-12)))
    _print_result("B sigma=2.3", shifted_inverse_power_method(
        B, ShiftedSolverOptions(shift=2.3, tolerance=1e-12)))

    print("\nQR stack (main.cpp:100-146):")
    H = to_hessenberg(A)
    print(f"  Hessenberg(A): max |below subdiag| = "
          f"{float(np.abs(np.tril(_host(H), -2)).max()):.3g}")
    Q, R = qr_decompose(A)
    resid = float(np.abs(_host(Q) @ _host(R) - _host(A.array)).max())
    print(f"  QR(A): max |A - QR| = {resid:.3g}")
    qr = qr_eigenvalues(A, opts)
    vals = ", ".join(_fmt(v) for v in _host(qr.eigenvalues))
    print(f"  qr_eigenvalues(A): [{vals}]  iterations = {int(qr.iterations)}"
          f"  converged = {bool(qr.converged)}")
    try:
        qr_eigenvalues(B, opts)
    except ValueError as e:
        print(f"  qr_eigenvalues(B): raised as expected -> {e}")
    return 0


def run_on_file(args, device) -> int:
    from . import (QROptions, ShiftedSolverOptions, SolverOptions, power_method,
                   qr_eigenvalues, read_matrix_from_file, shifted_inverse_power_method)
    from .solvers.arnoldi import arnoldi_eigenvalues

    dt = np.dtype(args.dtype)
    M = read_matrix_from_file(args.file, dt, device=device)
    kind = "dense" if M.is_dense else "sparse"
    print(f"Read {kind} {M.shape[0]}x{M.shape[1]} {dtype_name(M.dtype)}")
    if args.solver == "power":
        res = power_method(M, SolverOptions(args.max_iterations, args.tolerance))
        _print_result("power", res)
    elif args.solver == "inverse":
        res = shifted_inverse_power_method(M, ShiftedSolverOptions(
            max_iterations=args.max_iterations, tolerance=args.tolerance,
            shift=complex(args.shift) if dt.kind == "c" else float(args.shift)))
        _print_result(f"inverse(shift={args.shift})", res)
    elif args.solver == "qr":
        res = qr_eigenvalues(M, QROptions(
            max_iterations=args.max_iterations, tolerance=args.tolerance,
            mode=args.qr_mode))
        for i, v in enumerate(_host(res.eigenvalues)):
            print(f"  lambda[{i}] = {_fmt(v)}")
        print(f"  iterations = {int(res.iterations)} converged = {bool(res.converged)}")
    elif args.solver == "arnoldi":
        res = arnoldi_eigenvalues(M, k=args.k)
        for i, v in enumerate(_host(res.eigenvalues)):
            print(f"  ritz[{i}] = {_fmt(v)}")
    elif args.solver in ("lanczos", "trlanczos", "lobpcg", "subspace"):
        from .solvers.lanczos import lanczos_eigenvalues, lanczos_thick_restart
        from .solvers.lobpcg import lobpcg_eigenvalues
        from .solvers.subspace import subspace_iteration
        opts = SolverOptions(args.max_iterations, args.tolerance)
        if args.solver == "lanczos":
            res = lanczos_eigenvalues(M, k=args.k, which=args.which, opts=opts)
        elif args.solver == "trlanczos":
            res = lanczos_thick_restart(M, k=args.k, opts=opts,
                                        which=args.which if args.which != "LM" else "LA")
        elif args.solver == "lobpcg":
            res = lobpcg_eigenvalues(M, k=args.k, opts=opts,
                                     which=args.which if args.which != "LM" else "LA")
        else:
            res = subspace_iteration(M, k=args.k, opts=opts)
        for i, v in enumerate(_host(res.eigenvalues)):
            print(f"  ritz[{i}] = {_fmt(v)}")
        print(f"  iterations = {int(res.iterations)} converged = {bool(res.converged)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("file", nargs="?", help="matrix file (omit for the reference demo)")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64", "complex64", "complex128"])
    ap.add_argument("--solver", default="power",
                    choices=["power", "inverse", "qr", "arnoldi", "lanczos",
                             "trlanczos", "lobpcg", "subspace"])
    ap.add_argument("--qr-mode", default="parity", choices=["parity", "accelerated"])
    ap.add_argument("--shift", default="0", help="shift (complex ok: '2.3+4j')")
    ap.add_argument("--max-iterations", type=int, default=1000)
    ap.add_argument("--tolerance", type=float, default=1e-10)
    ap.add_argument("--k", type=int, default=6,
                    help="arnoldi/lanczos/lobpcg/subspace: number of eigenvalues")
    ap.add_argument("--which", default="LM", choices=["LM", "LA", "SA"],
                    help="lanczos/lobpcg: spectrum end to target")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the matrices and solvers run (default: the card)")
    args = ap.parse_args(argv)

    if args.file is None:
        return run_reference_demo(args.data_dir, args.device)
    return run_on_file(args, args.device)


if __name__ == "__main__":
    sys.exit(main())
