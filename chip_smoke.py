#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. the card: a CUDA device, its name and power limit, TF32 off;
2. the build: the banded-SpMV CUDA kernels compiled from csrc/ with nvcc;
3. each kernel against its plain PyTorch version on the card, on the bench
   operator (1M rows, 33 diagonals), with its time per call beside the
   plain version's;
4. the main path: ``power_method`` through the public API on interleaved
   and row-major banded operators at 1M rows x 33 diagonals, with a fixed
   budget (held against the loop driven by the plain matvec) and on a
   converging operator (held against scipy's ``eigs`` in float64);
5. the reference data files ``data/A.txt`` (dense) and ``data/B.txt``
   (CSR), complex128 on the card, against ``numpy.linalg.eigvals``.

The kernels' launch counts are zeroed just before phases 4-5 and read just
after; each kernel must have run there. The script then prints one JSON
line with each kernel's numbers, the card's name and power limit, and last
the line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N = 1_000_000
BANDWIDTH = 16  # 33 diagonals: the operator of bench.py --n 1000000
KERNEL_SOURCE = "pcsc_eigenvalue_solver_project_tpu_torch/csrc/dia_spmv.cu"
TPU_KERNELS = "pcsc_eigenvalue_solver_project_tpu/ops/pallas/dia_spmv.py"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def check(cond, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def rel_err(y, y_ref) -> float:
    return float((y - y_ref).abs().max() / y_ref.abs().max())


def time_ms(fn, reps: int = 50) -> float:
    """Mean device time per call over ``reps`` calls, after a warm-up.

    The calls are captured once into a CUDA graph and timed as one replay,
    so the host's speed at launching them does not enter the number."""
    import torch
    for _ in range(3):  # builds, caches, allocator
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(kernel_fn, plain_fn):
    """Kernel and plain time per call, taken in turns (plain, kernel,
    kernel, plain); the lower of each pair."""
    p1 = time_ms(plain_fn)
    k1 = time_ms(kernel_fn)
    k2 = time_ms(kernel_fn)
    p2 = time_ms(plain_fn)
    return min(k1, k2), min(p1, p2)


def planted_band(n, dtype, seed):
    """A 33-diagonal band with a planted dominant diagonal (14, 10, 8 on the
    first three rows, as __graft_entry__.py plants them), as numpy data
    (k, n) in the row-indexed DIA convention."""
    rng = np.random.default_rng(seed)
    k = 2 * BANDWIDTH + 1
    data = rng.uniform(-1, 1, (k, n))
    if np.dtype(dtype).kind == "c":
        data = data + 1j * rng.uniform(-1, 1, (k, n))
    data = data.astype(dtype)
    data[BANDWIDTH, :3] = (14.0, 10.0, 8.0)
    for d, off in enumerate(range(-BANDWIDTH, BANDWIDTH + 1)):
        if off > 0:
            data[d, n - off:] = 0
        elif off < 0:
            data[d, :-off] = 0
    return data


def scipy_dominant(data: np.ndarray, offsets) -> complex:
    """Dominant eigenvalue of the DIA operator by ARPACK in float64."""
    from scipy.sparse.linalg import LinearOperator, eigs
    n = data.shape[1]
    dt = np.complex128 if data.dtype.kind == "c" else np.float64
    vals = data.astype(dt)

    def matvec(x):
        x = np.asarray(x, dt).reshape(-1)
        y = np.zeros(n, dtype=np.result_type(dt, x.dtype))
        for d, off in enumerate(offsets):
            if off >= 0:
                y[:n - off] += vals[d, :n - off] * x[off:]
            else:
                y[-off:] += vals[d, -off:] * x[:off]
        return y

    op = LinearOperator((n, n), matvec=matvec, dtype=dt)
    lam = eigs(op, k=1, which="LM", v0=np.ones(n, dt), return_eigenvectors=False)
    return complex(lam[0])


def main() -> None:
    import torch

    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import banded_full
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
    from pcsc_eigenvalue_solver_project_tpu_torch.solvers.power import (
        norm, power_iteration_loop, vdot)

    # ---- 1. the card -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    print(card)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    dev = torch.device("cuda")

    # ---- 2. the build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.library_path()})")

    # ---- 3. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(0)
    x_np = rng.uniform(-1, 1, N)
    op32 = banded_full(N, bandwidth=BANDWIDTH, dtype=np.float32, seed=0, device=dev)
    offs = op32.offsets
    x32 = torch.from_numpy(x_np).to(dev, torch.float32)
    errors = {}  # kernel -> max abs error at the main shape and dtype
    timings = {}

    def compare(label, kernel_name, y, y_ref, limit, main_case=False):
        torch.cuda.synchronize()
        err = rel_err(y, y_ref)
        print(f"check {label}: rel err {err:.3e} (limit {limit:.0e})")
        check(torch.isfinite(y).all().item(), f"{label}: non-finite output")
        check(err <= limit, f"{label}: rel err {err:.3e} above {limit:.0e}")
        if main_case:
            errors[kernel_name] = float((y - y_ref).abs().max())

    def bytes_rowmajor(vals, x):
        return vals.numel() * vals.element_size() + 2 * x.numel() * x.element_size()

    # B2: f32, bf16, f64 on the bench operator
    for dt, limit in ((torch.float32, 1e-5), (torch.bfloat16, 1e-5),
                      (torch.float64, 1e-12)):
        vals = op32.data.to(dt)
        x = x32.to(ds.acc_dtype(dt))
        compare(f"B2 dia_kernel {dt} n={N}", "B2", ds.dia_matvec(vals, offs, x),
                ds.dia_matvec_plain(vals, offs, x), limit, dt == torch.float32)
        if dt != torch.float64:
            k_ms, p_ms = timed_pair(lambda: ds.dia_kernel(vals, offs, x),
                                    lambda: ds.dia_matvec_plain(vals, offs, x))
            timings[("B2", dt)] = (k_ms, p_ms, bytes_rowmajor(vals, x))
    # B2 on (-130, 0, 129) at a ragged n
    n_r, offs_r = N + 3, (-130, 0, 129)
    vals_r = torch.from_numpy(rng.uniform(-1, 1, (3, n_r))).to(dev, torch.float32)
    vals_r[0, :130] = 0
    vals_r[2, n_r - 129:] = 0
    x_r = torch.from_numpy(rng.uniform(-1, 1, n_r)).to(dev, torch.float32)
    compare(f"B2 dia_kernel offsets {offs_r} n={n_r}", "B2",
            ds.dia_matvec(vals_r, offs_r, x_r),
            ds.dia_matvec_plain(vals_r, offs_r, x_r), 1e-5)
    # B3: complex64
    op64c = banded_full(N, bandwidth=BANDWIDTH, dtype=np.complex64, seed=1, device=dev)
    xc = torch.from_numpy(x_np + 1j * rng.uniform(-1, 1, N)).to(dev, torch.complex64)
    compare(f"B3 dia_complex_kernel complex64 n={N}", "B3",
            ds.dia_matvec(op64c.data, offs, xc),
            ds.dia_matvec_plain(op64c.data, offs, xc), 1e-5, True)
    k_ms, p_ms = timed_pair(lambda: ds.dia_complex_kernel(op64c.data, offs, xc),
                            lambda: ds.dia_matvec_plain(op64c.data, offs, xc))
    timings[("B3", torch.complex64)] = (k_ms, p_ms, bytes_rowmajor(op64c.data, xc))
    # B1: f32 and bf16 diagonals, tile_s 64 and 8
    pr = ds.il_window_halo(offs)
    for dt in (torch.float32, torch.bfloat16):
        for tile_s in (64, 8):
            il = op32.interleaved(tile_s, dtype=dt)
            x_il = il.encode_vec(x32)
            compare(f"B1 dia_il_kernel {dt} tile_s={tile_s} n={N}", "B1",
                    ds.dia_matvec_il(il.data_il, offs, x_il),
                    ds.dia_matvec_il_plain(il.data_il, offs, x_il), 1e-5,
                    dt == torch.float32 and tile_s == 64)
            if tile_s == 64:
                w = ds._il_window(x_il, pr)
                k_ms, p_ms = timed_pair(
                    lambda: ds.dia_il_kernel(il.data_il, offs, w),
                    lambda: ds.dia_matvec_il_window_plain(il.data_il, offs, w))
                nbytes = (il.data_il.numel() * il.data_il.element_size()
                          + (w.numel() + x_il.numel()) * 4)
                timings[("B1", dt)] = (k_ms, p_ms, nbytes)
                k_ms, p_ms = timed_pair(
                    lambda: ds.dia_matvec_il(il.data_il, offs, x_il),
                    lambda: ds.dia_matvec_il_plain(il.data_il, offs, x_il))
                timings[("B1+window", dt)] = (k_ms, p_ms, nbytes)
    # B1 from a window whose halo rows carry values
    il = op32.interleaved()
    w = torch.from_numpy(rng.uniform(-1, 1, (il.R + 2 * pr, ds.LANES))).to(dev, torch.float32)
    compare(f"B1 dia_matvec_il_window with halo values n={N}", "B1",
            ds.dia_matvec_il_window(il.data_il, offs, w),
            ds.dia_matvec_il_window_plain(il.data_il, offs, w), 1e-5)
    for kernel in ds.KERNELS:
        print(f"launches in phase 3: {kernel.__name__} = {kernel.launches}")
        check(kernel.launches > 0, f"{kernel.__name__} never launched")
    card_name, card_limit = (s.strip() for s in card.splitlines()[0].split(","))
    for (kernel, dt), (k_ms, p_ms, nbytes) in timings.items():
        print(f"time {kernel} {dt} {N}x33: kernel {k_ms * 1e3:.1f} us "
              f"({nbytes / (k_ms * 1e-3) / 1e9:.0f} GB/s, "
              f"{nbytes / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s), "
              f"plain {p_ms * 1e3:.1f} us [{card_name}, {card_limit}]")

    # ---- 4/5. the main path ------------------------------------------------
    x0 = np.random.default_rng(1).uniform(-1, 1, N)
    budget = eigsol.SolverOptions(max_iterations=200, tolerance=0.0)
    converge = eigsol.SolverOptions(max_iterations=1000, tolerance=1e-6)
    planted = planted_band(N, np.float32, seed=2)
    planted_c = planted_band(N, np.complex64, seed=3)
    p32 = eigsol.SparseDIA(data=torch.from_numpy(planted).to(dev),
                           offsets=offs, shape=(N, N))
    p64c = eigsol.SparseDIA(data=torch.from_numpy(planted_c).to(dev),
                            offsets=offs, shape=(N, N))
    runs = {  # name -> (operator, options)
        "IL f32 budget": (op32.interleaved(), budget),
        "IL bf16 budget": (op32.interleaved(dtype=torch.bfloat16), budget),
        "DIA f32 budget": (op32, budget),
        "DIA c64 budget": (op64c, budget),
        "IL f32 converge": (p32.interleaved(), converge),
        "IL bf16 converge": (p32.interleaved(dtype=torch.bfloat16), converge),
        "DIA f32 converge": (p32, converge),
        "DIA c64 converge": (p64c, converge),
    }
    for M, _ in runs.values():  # warm-up (allocator, library handles)
        eigsol.power_method(M, eigsol.SolverOptions(max_iterations=3), x0=x0)
    A = eigsol.read_matrix_from_file("data/A.txt", torch.complex128, device=dev)
    B = eigsol.read_matrix_from_file("data/B.txt", torch.complex128, device=dev)
    demo = eigsol.SolverOptions(max_iterations=1000, tolerance=1e-10)
    torch.cuda.synchronize()

    ds.reset_launch_counts()
    results, seconds = {}, {}
    for name, (M, opts) in runs.items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        results[name] = eigsol.power_method(M, opts, x0=x0)
        end.record()
        end.synchronize()
        seconds[name] = start.elapsed_time(end) / 1e3
    files = {"A": eigsol.power_method(A, demo), "B": eigsol.power_method(B, demo)}
    torch.cuda.synchronize()
    launches = {kernel.__name__: kernel.launches for kernel in ds.KERNELS}

    print(f"main-path launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched by the main path")
    # (a) fixed budget: against the loop driven by the plain matvec
    for name in ("IL f32 budget", "IL bf16 budget", "DIA f32 budget", "DIA c64 budget"):
        M, opts = runs[name]
        r = results[name]
        if isinstance(M, eigsol.InterleavedDIA):
            def plain(v, M=M):
                return ds.dia_matvec_il_plain(M.data_il, M.offsets, v)
        else:
            def plain(v, M=M):
                return ds.dia_matvec_plain(M.data, M.offsets, v)
        vec_dt = torch.promote_types(M.dtype, torch.float32)
        xs = torch.from_numpy(x0).to(dev, vec_dt)
        ref = power_iteration_loop(plain, vdot, norm, M.encode_vec(xs / norm(xs)),
                                   opts.max_iterations, opts.tolerance)
        lam, lam_ref = complex(r.eigenvalue), complex(ref.eigenvalue)
        err = abs(lam - lam_ref) / abs(lam_ref)
        per_iter = seconds[name] / int(r.iterations)
        nnz = int(torch.count_nonzero(M.data_il if hasattr(M, "data_il") else M.data))
        print(f"power {name}: lambda {lam:.7g} vs plain loop {lam_ref:.7g} "
              f"(rel {err:.2e}, limit 1e-4), {int(r.iterations)} iterations "
              f"(plain loop {int(ref.iterations)}), {per_iter * 1e6:.1f} us/iteration, {nnz / per_iter / 1e9:.1f} Gnnz/s "
              f"[{card_name}, {card_limit}]")
        check(0 < int(r.iterations) <= opts.max_iterations,
              f"{name}: {int(r.iterations)} iterations")
        check(r.eigenvector.shape == (N,) and torch.isfinite(r.eigenvector).all().item(),
              f"{name}: bad eigenvector")
        check(err <= 1e-4, f"{name}: eigenvalue off the plain loop by {err:.2e}")
    # (b) converging operator: against scipy's eigs in float64
    oracles = {"f32": scipy_dominant(planted, offs),
               "bf16": scipy_dominant(p32.interleaved(dtype=torch.bfloat16)
                                      .to_natural().data.float().cpu().numpy(), offs),
               "c64": scipy_dominant(planted_c, offs)}
    for name, key in (("IL f32 converge", "f32"), ("IL bf16 converge", "bf16"),
                      ("DIA f32 converge", "f32"), ("DIA c64 converge", "c64")):
        r = results[name]
        lam, lam_ref = complex(r.eigenvalue), oracles[key]
        err = abs(lam - lam_ref) / abs(lam_ref)
        print(f"power {name}: lambda {lam:.7g} vs scipy eigs {lam_ref:.7g} "
              f"(rel {err:.2e}, limit 1e-4), {int(r.iterations)} iterations, "
              f"converged={bool(r.converged)}, {seconds[name]:.3f} s")
        check(bool(r.converged), f"{name}: did not converge")
        check(err <= 1e-4, f"{name}: eigenvalue off scipy by {err:.2e}")
    # the reference data files against numpy
    for key, M in (("A", A), ("B", B)):
        r = files[key]
        ev = np.linalg.eigvals(M.to_dense().cpu().numpy())
        lam_ref = complex(ev[np.argmax(np.abs(ev))])
        lam = complex(r.eigenvalue)
        err = abs(lam - lam_ref) / abs(lam_ref)
        print(f"data/{key}.txt ({type(M).__name__}): lambda {lam:.10g} vs numpy "
              f"{lam_ref:.10g} (rel {err:.2e}, limit 1e-6), "
              f"{int(r.iterations)} iterations, converged={bool(r.converged)}")
        check(bool(r.converged), f"data/{key}.txt: did not converge")
        check(err <= 1e-6, f"data/{key}.txt: eigenvalue off numpy by {err:.2e}")

    # ---- report ------------------------------------------------------------
    rows = []
    for kernel, tag, line, dt in ((ds.dia_il_kernel, "B1", 390, torch.float32),
                                  (ds.dia_kernel, "B2", 36, torch.float32),
                                  (ds.dia_complex_kernel, "B3", 73, torch.complex64)):
        k_ms, p_ms, _ = timings[(tag, dt)]
        rows.append({"name": kernel.__name__, "route": "cuda", "source": KERNEL_SOURCE,
                     "replaces": f"{TPU_KERNELS}:{line}",
                     "launches": launches[kernel.__name__],
                     "max_abs_err": errors[tag], "ms": k_ms, "plain_ms": p_ms})
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
