"""Gloo ranks for the distributed tests of the PyTorch port (not a test file).

``run_ranks(target, world, tmp_path, payload)`` spawns ``world`` processes
(spawn, not fork: the pytest process has JAX's threads running), each of
which joins a gloo process group through a ``file://`` store in
``tmp_path`` (no TCP port, so that parallel test workers cannot collide),
with one intra-op thread and a 60 s collective timeout, builds the row
mesh, calls ``target(mesh, payload)`` and sends back its result. The
results come back in rank order. A rank that raises, dies, or is still
running at the deadline fails the call, after every rank is stopped: a
mismatched collective cannot hang the suite.

The targets live in modules that import torch and the port only (the rank
processes never import JAX): the ``*_cases`` functions below. The tests
spawn once per module (a module-scoped fixture) and assert on the returned
results, so each case counts without a spawn of its own.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import queue
import time
import traceback

DEADLINE = 300.0  # seconds for a whole spawn, start-up included


def _rank_main(module: str, name: str, rank: int, world: int, store: str, payload,
               results) -> None:
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=60))
        from pcsc_eigenvalue_solver_project_tpu_torch.parallel.mesh import make_row_mesh

        target = getattr(importlib.import_module(module), name)
        out = target(make_row_mesh(world, device="cpu"), payload)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, "error", traceback.format_exc()))


def run_ranks(target, world: int, tmp_path, payload=None, deadline: float = DEADLINE):
    """``[target(mesh, payload) on rank r for r in range(world)]``."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    # a store file is good for one group only: a fresh name for each spawn
    store = os.path.join(str(tmp_path), f"store-{target.__name__}-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target.__module__, target.__name__, rank, world, store,
                               payload, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out, failure = {}, None
    end = time.monotonic() + deadline
    try:
        while len(out) < world and failure is None:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > end:
                    failure = f"ranks {sorted(set(range(world)) - set(out))} still running " \
                              f"after {deadline:.0f} s"
                elif any(p.exitcode not in (None, 0) for p in procs):
                    failure = "a rank died: exit codes " + str([p.exitcode for p in procs])
                continue
            if status == "ok":
                out[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=0 if failure else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if failure is not None:
        raise RuntimeError(f"{target.__name__} on {world} gloo ranks: {failure}")
    return [out[r] for r in range(world)]


# --------------------------------------------------------------------------
# Rank-side helpers
# --------------------------------------------------------------------------


def host(t):
    """A tensor (or a result's field) as a numpy array."""
    import torch
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def eig_result(r):
    """An EigenResult's fields on the host."""
    return {"eigenvalue": host(r.eigenvalue), "eigenvector": host(r.eigenvector),
            "iterations": int(r.iterations), "converged": bool(r.converged)}


def qr_result(r):
    return {"eigenvalues": host(r.eigenvalues), "iterations": int(r.iterations),
            "converged": bool(r.converged)}


def csr(coo, dtype=None):
    """The port's CPU ``SparseCSR`` of a payload COO triple and shape."""
    from pcsc_eigenvalue_solver_project_tpu_torch import SparseCSR
    r, c, v, shape = coo
    return SparseCSR.from_coo(r, c, v, shape, dtype=dtype, device="cpu")


def raises(fn, exc=Exception):
    """The message of the ``exc`` that ``fn()`` raises, or None."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None



# --------------------------------------------------------------------------
# tests/test_torch_parallel.py: meshes, the ELL partition, its SpMV, the
# power method, Krylov-Schur, load_partitioned
# --------------------------------------------------------------------------


def ell_fields(A):
    return {"data": host(A.data), "indices": host(A.indices), "n_orig": A.n_orig,
            "n_shards": A.n_shards, "n_padded": A.n_padded, "halo_ok": A.halo_ok,
            "nnz": A.nnz}


def parallel_cases(mesh, p):
    import numpy as np
    import torch
    import torch.distributed as dist

    from pcsc_eigenvalue_solver_project_tpu_torch import SolverOptions
    from pcsc_eigenvalue_solver_project_tpu_torch.io.distributed import load_partitioned
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import mesh as pm
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.arnoldi import (
        distributed_arnoldi_eigenvalues, distributed_krylov_schur_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.power import distributed_power_method
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.sharded import (
        distributed_matvec, partition_ell)

    out = {"mesh": (mesh.rank, mesh.world_size, mesh.shape, str(mesh.device), mesh.axis),
           "more_devices": raises(lambda: pm.make_row_mesh(mesh.world_size + 1, device="cpu")),
           "cuda_on_gloo": raises(lambda: pm.make_row_mesh(device="cuda:0")),
           "row_block": host(pm.row_block(np.arange(16).reshape(8, 2), mesh)),
           "row_block_uneven": raises(lambda: pm.row_block(np.arange(6), mesh)),
           "all_reduce": host(pm.all_reduce_sum(torch.tensor([1.0 + mesh.rank, 1j]), mesh)),
           "all_gather": host(pm.all_gather_rows(torch.full((2, 3), mesh.rank), mesh))}
    get_backend = dist.get_backend
    dist.get_backend = lambda group=None: "nccl"
    try:
        out["cpu_on_nccl"] = raises(lambda: pm.make_row_mesh(device="cpu"))
    finally:
        dist.get_backend = get_backend

    parts = {name: partition_ell(csr(p[name]), mesh) for name in p["partitions"]}
    out["partitions"] = {name: ell_fields(A) for name, A in parts.items()}
    A = parts["L96"]
    x = A.local_block(p["x96"], mesh)
    out["matvec"] = {ex: host(distributed_matvec(A, x, mesh, exchange=ex))
                     for ex in ("all_gather", "halo")}
    G = parts["general"]
    out["matvec_general"] = host(distributed_matvec(G, G.local_block(p["x64"], mesh), mesh,
                                                    exchange="all_gather"))
    C = parts["cplx"]
    out["matvec_complex"] = host(distributed_matvec(C, C.local_block(p["xc48"], mesh), mesh))
    out["unknown_exchange"] = raises(lambda: distributed_matvec(A, x, mesh, exchange="ring"))
    out["wrong_axis"] = raises(lambda: distributed_matvec(A, x, mesh, axis="cols"))

    opts = SolverOptions(**p["power_opts"])
    out["power"] = {ex: eig_result(distributed_power_method(A, mesh, opts, exchange=ex,
                                                            x0=p["x0_96"]))
                    for ex in ("all_gather", "halo")}
    out["power_analytic"] = eig_result(distributed_power_method(
        parts["L24"], mesh, SolverOptions(tolerance=1e-12, max_iterations=20000)))
    out["power_padded"] = eig_result(distributed_power_method(parts["B50"], mesh, opts,
                                                              x0=p["x0_50"]))
    gen = torch.Generator().manual_seed(3)
    out["power_generator"] = eig_result(distributed_power_method(
        parts["B50"], mesh, SolverOptions(max_iterations=5), generator=gen))

    K = partition_ell(csr(p["ks"]), mesh)
    kopts = SolverOptions(tolerance=1e-8)
    out["arnoldi_fixed"] = qr_result(distributed_arnoldi_eigenvalues(K, mesh, k=3, m=15,
                                                                     opts=kopts, x0=p["x0_ks"]))
    out["krylov_schur"] = qr_result(distributed_krylov_schur_eigenvalues(
        K, mesh, k=3, m=15, opts=kopts, x0=p["x0_ks"]))
    out["krylov_schur_errors"] = [
        raises(lambda: distributed_krylov_schur_eigenvalues(K, mesh, k=0)),
        raises(lambda: distributed_krylov_schur_eigenvalues(K, mesh, k=3, m=4)),
        raises(lambda: distributed_krylov_schur_eigenvalues(K, mesh, k=3, restarts=0))]

    loaded = load_partitioned(p["sparse_file"], mesh, torch.complex128)
    out["load_partitioned"] = ell_fields(loaded)
    out["load_dense_file"] = raises(lambda: load_partitioned(p["dense_file"], mesh,
                                                             torch.complex128))
    return out


# --------------------------------------------------------------------------
# tests/test_torch_parallel_dia.py: row-major and interleaved DIA partitions,
# their SpMVs and power methods; the split-plane complex partition
# --------------------------------------------------------------------------


def dia(spec):
    """The port's CPU ``SparseDIA`` of a payload (data, offsets) pair."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch import SparseDIA
    data, offsets = spec
    n = data.shape[1]
    return SparseDIA(data=torch.from_numpy(data.copy()), offsets=tuple(offsets), shape=(n, n))


def float_view(t):
    """A tensor on the host as numpy, bf16 widened exactly to float32."""
    import torch
    return host(t.to(torch.float32) if t.dtype == torch.bfloat16 else t)


def dia_cases(mesh, p):
    import numpy as np
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch import SolverOptions
    from pcsc_eigenvalue_solver_project_tpu_torch.matrix.split_complex import SplitComplexDIA
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import dia as pd
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import split_complex as ps

    out = {}
    # row-major
    A = pd.partition_dia(dia(p["L96"]), mesh)
    out["L96"] = {"data": host(A.data), "halo": A.halo, "n_padded": A.n_padded,
                  "nnz": A.nnz, "offsets": A.offsets}
    out["matvec"] = host(pd.distributed_dia_matvec(A, A.local_block(p["x96"], mesh), mesh))
    W = pd.partition_dia(dia(p["wide"]), mesh)
    out["matvec_wide"] = host(pd.distributed_dia_matvec(W, W.local_block(p["x128"], mesh),
                                                        mesh))
    out["too_wide"] = raises(lambda: pd.partition_dia(dia(p["too_wide"]), mesh))
    opts = SolverOptions(**p["power_opts"])
    out["power"] = eig_result(pd.distributed_dia_power_method(A, mesh, opts, x0=p["x0_96"]))
    B = pd.partition_dia(dia(p["B50"]), mesh)
    out["power_padded"] = eig_result(pd.distributed_dia_power_method(B, mesh, opts,
                                                                     x0=p["x0_50"]))

    # interleaved
    band = dia(p["band6000"])
    I = pd.partition_dia_il(band, mesh)
    out["il"] = {"data_il": host(I.data_il), "R": I.R, "tile_s": I.tile_s}
    out["il_bf16"] = float_view(pd.partition_dia_il(band, mesh, dtype=torch.bfloat16).data_il)
    x_il = pd.encode_vec_il_sharded(p["x6000"], I, mesh)
    out["il_encoded"] = host(x_il)
    y_il = pd.distributed_dia_il_matvec(I, x_il, mesh)
    out["il_matvec"] = pd.decode_vec_il_sharded(y_il, I, mesh)
    out["il_matvec_default_group"] = pd.decode_vec_il_sharded(y_il, I)
    C = pd.partition_dia_il(dia(p["band5003"]), mesh)
    out["codec"] = pd.decode_vec_il_sharded(pd.encode_vec_il_sharded(p["x5003"], C, mesh), C,
                                            mesh)
    il_opts = SolverOptions(max_iterations=2000, tolerance=1e-7)
    r_il = pd.distributed_dia_il_power_method(I, mesh, il_opts, x0=p["x0_6000"])
    out["il_power"] = eig_result(r_il)
    out["il_power_vector"] = pd.decode_vec_il_sharded(r_il.eigenvector, I, mesh)
    out["row_power"] = eig_result(pd.distributed_dia_power_method(
        pd.partition_dia(band, mesh), mesh, il_opts, x0=p["x0_6000"]))
    out["il_too_wide"] = raises(lambda: pd.partition_dia_il(dia(p["band600"]), mesh, tile_s=8))

    # split-plane complex
    out["splitc"] = {}
    for name in ("splitc32", "splitc64"):
        planes, offsets = p[name]
        n = planes.shape[2]
        S = ps.partition_splitc_dia(SplitComplexDIA(planes=torch.from_numpy(planes.copy()),
                                                    offsets=tuple(offsets), shape=(n, n)), mesh)
        res = ps.distributed_splitc_power_method(S, mesh, SolverOptions(
            max_iterations=500, tolerance=p["splitc_tol"][name]), x0=p["x0_planes"][name])
        out["splitc"][name] = {"planes": host(S.planes), "halo": S.halo,
                               "n_padded": S.n_padded, **eig_result(res)}
    out["splitc_bad_x0"] = raises(lambda: ps.distributed_splitc_power_method(
        S, mesh, x0=np.zeros((3, n))))
    gen = torch.Generator().manual_seed(1)
    out["splitc_generator"] = eig_result(ps.distributed_splitc_power_method(
        S, mesh, SolverOptions(max_iterations=4), generator=gen))
    return out


# --------------------------------------------------------------------------
# tests/test_torch_parallel_gell.py: the GELL and pruned GELL partitions,
# their SpMVs and power methods, the ELL halo guard
# --------------------------------------------------------------------------


def pack_coo(pack):
    """A GELL pack's entries as host COO, sorted by (row, column)."""
    import numpy as np
    indptr = host(pack.indptr).astype(np.int64)
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return rows, host(pack.indices).astype(np.int64), host(pack.values)


def pruned_fields(A):
    return {"own": pack_coo(A.own), "rem": None if A.rem is None else pack_coo(A.rem),
            "own_shape": A.own.shape, "rem_shape": None if A.rem is None else A.rem.shape,
            "plan": [(host(s), host(r)) for s, r in A.plan], "footprint": A.footprint,
            "max_fp": A.max_fp, "distances": A.distances, "has_remote": A.has_remote,
            "comm": A.comm_bytes_per_matvec, "n_padded": A.n_padded,
            "tile_rows": A.tile_rows}


def gell_cases(mesh, p):
    import numpy as np

    from pcsc_eigenvalue_solver_project_tpu_torch import SolverOptions, SparseCSR
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import gell as pg
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import gell_pruned as pp
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.sharded import (
        distributed_matvec, partition_ell)

    out = {}
    A = pg.partition_gell(csr(p["rand1100"]), mesh, tile_rows=128)
    out["gell"] = {"coo": pack_coo(A.pack), "shape": A.pack.shape, "n_padded": A.n_padded,
                   "rps": A.rows_per_shard,
                   "y": host(pg.distributed_gell_matvec(A, A.local_block(p["x1100"], mesh),
                                                        mesh))}
    out["gell_auto_tile"] = pg.partition_gell(csr(p["rand1100"]), mesh).tile_rows
    S = pg.partition_gell(csr(p["spill1024"]), mesh, tile_rows=128)
    out["spill_y"] = host(pg.distributed_gell_matvec(S, S.local_block(p["x1024"], mesh), mesh))
    D = pg.partition_gell(csr(p["dense512"]), mesh, tile_rows=128)
    out["gell_power"] = eig_result(pg.distributed_gell_power_method(
        D, mesh, SolverOptions(tolerance=1e-6, max_iterations=2000), x0=p["x0_512"]))
    out["gell_non_square"] = raises(lambda: pg.partition_gell(
        SparseCSR.from_coo([0], [1], [np.float32(1.0)], (2, 3), device="cpu"), mesh))
    out["gell_complex"] = raises(lambda: pg.partition_gell(csr(p["cplx"]), mesh))
    out["pruned_complex"] = raises(lambda: pp.partition_gell_pruned(csr(p["cplx"]), mesh))

    E = partition_ell(csr(p["far256"]), mesh)
    xe = E.local_block(p["x256"], mesh)
    out["halo_ok"] = E.halo_ok
    out["halo_misuse"] = raises(lambda: distributed_matvec(E, xe, mesh, exchange="halo"))
    out["halo_auto_y"] = host(distributed_matvec(E, xe, mesh, exchange="auto"))

    out["pruned"] = {}
    for name in ("rand1100", "blr4096", "blr16384", "blockdiag", "oracle2048"):
        B = pp.partition_gell_pruned(csr(p[name]), mesh, tile_rows=128)
        fields = pruned_fields(B)
        fields["y"] = host(pp.pruned_gell_matvec(B, B.local_block(p["x_" + name], mesh), mesh))
        out["pruned"][name] = fields
    out["pruned_power"] = eig_result(pp.distributed_gell_power_pruned(
        B, mesh, SolverOptions(max_iterations=2000, tolerance=1e-10),
        x0=np.ones(B.n_orig, np.float32)))
    out["pruned_non_square"] = raises(lambda: pp.partition_gell_pruned(
        SparseCSR.from_coo([0], [1], [np.float32(1.0)], (2, 3), device="cpu"), mesh))
    return out


# --------------------------------------------------------------------------
# tests/test_torch_parallel_krylov.py: the shifted solves, Lanczos and the
# block iteration on the ranks
# --------------------------------------------------------------------------


def krylov_cases(mesh, p):
    import numpy as np
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch import ShiftedSolverOptions, SolverOptions
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import dia as pd
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.inverse_power import (
        _partitioned_diagonal, distributed_shifted_inverse_power)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.krylov import (
        solve_shifted_distributed)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.lanczos import (
        distributed_lanczos_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.power import reductions
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.sharded import partition_ell
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.subspace import (
        distributed_subspace_iteration)

    out = {}
    A = partition_ell(csr(p["L96"]), mesh)
    out["diag"] = host(_partitioned_diagonal(A, mesh))
    opts = {name: ShiftedSolverOptions(**kw) for name, kw in p["inverse_opts"].items()}
    L48 = partition_ell(csr(p["L48"]), mesh)
    out["inverse"] = {ex: eig_result(distributed_shifted_inverse_power(
        L48, mesh, opts["L48"], exchange=ex, x0=p["x0_48"])) for ex in ("all_gather", "halo")}
    L64 = partition_ell(csr(p["L64"]), mesh)
    out["inverse_target"] = eig_result(distributed_shifted_inverse_power(
        L64, mesh, opts["L64"], x0=p["x0_64"]))
    B = partition_ell(csr(p["B50"]), mesh)
    out["inverse_padded"] = eig_result(distributed_shifted_inverse_power(
        B, mesh, opts["B50"], x0=p["x0_50"]))
    vdot, norm = reductions(mesh)
    matvec = A.local_matvec(mesh)
    b = A.local_block(p["b96"], mesh)
    y = solve_shifted_distributed(matvec, 0.3, b, vdot=vdot, norm=norm,
                                  diag=_partitioned_diagonal(A, mesh), tol=1e-12, maxiter=960)
    out["solve"] = host(y)
    out["solve_residual"] = float(norm(matvec(y) - 0.3 * y - b))
    out["solve_plain"] = host(solve_shifted_distributed(matvec, 0.3, b, vdot=vdot, norm=norm,
                                                        tol=1e-12, maxiter=960))
    out["solve_stopped"] = host(solve_shifted_distributed(matvec, 0.3, b, vdot=vdot, norm=norm,
                                                          stop=torch.tensor(True)))

    lz = {}
    S = partition_ell(csr(p["sym"]), mesh)
    Sd = pd.partition_dia(dia(p["sym_dia"]), mesh)
    Si = pd.partition_dia_il(dia(p["sym_dia"]), mesh, tile_s=8)
    lopts = SolverOptions(tolerance=1e-10)
    for which in ("LM", "LA", "SA"):
        lz[f"ell {which}"] = qr_result(distributed_lanczos_eigenvalues(
            S, mesh, k=3, m=24, which=which, opts=lopts, x0=p["x0_sym"]))
    lz["dia LA"] = qr_result(distributed_lanczos_eigenvalues(
        Sd, mesh, k=3, m=24, which="LA", opts=lopts, x0=p["x0_sym"]))
    lz["il LA"] = qr_result(distributed_lanczos_eigenvalues(
        Si, mesh, k=3, m=24, which="LA", opts=lopts, x0=p["x0_sym"]))
    lz["ell LA noreorth"] = qr_result(distributed_lanczos_eigenvalues(
        S, mesh, k=3, m=24, which="LA", reorth=False, opts=lopts, x0=p["x0_sym"]))
    out["lanczos"] = lz
    out["lanczos_errors"] = [
        raises(lambda: distributed_lanczos_eigenvalues(object(), mesh)),
        raises(lambda: distributed_lanczos_eigenvalues(S, mesh, which="XX")),
        raises(lambda: distributed_lanczos_eigenvalues(S, mesh, k=0)),
        raises(lambda: distributed_lanczos_eigenvalues(S, mesh, k=40, m=30))]

    out["subspace"] = qr_result(distributed_subspace_iteration(
        Si, mesh, k=2, opts=SolverOptions(max_iterations=400, tolerance=1e-6),
        X0=p["X0_sym"]))
    out["subspace_errors"] = [
        raises(lambda: distributed_subspace_iteration(Si, mesh, k=0)),
        raises(lambda: distributed_subspace_iteration(Si, mesh, k=4, block=2)),
        raises(lambda: distributed_subspace_iteration(Si, mesh, k=2, X0=np.zeros((3, 3))))]
    gen = torch.Generator().manual_seed(5)
    out["subspace_generator"] = qr_result(distributed_subspace_iteration(
        Si, mesh, k=2, opts=SolverOptions(max_iterations=20), generator=gen))
    return out


# --------------------------------------------------------------------------
# tests/test_torch_checkpoint.py: the distributed checkpointed power method
# and distributed Arnoldi
# --------------------------------------------------------------------------


def checkpoint_cases(mesh, p):
    import os

    import torch.distributed as dist

    from pcsc_eigenvalue_solver_project_tpu_torch import SolverOptions
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import dia as pd
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.arnoldi import (
        distributed_arnoldi_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.gell_pruned import (
        partition_gell_pruned)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.mesh import make_row_mesh
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.sharded import partition_ell
    from pcsc_eigenvalue_solver_project_tpu_torch.utils.checkpoint import (
        distributed_dia_il_power_checkpointed)

    out = {}
    A = pd.partition_dia_il(dia(p["band6000"]), mesh)
    opts = SolverOptions(max_iterations=500, tolerance=1e-7)
    ref = pd.distributed_dia_il_power_method(A, mesh, opts, x0=p["x0_6000"])
    out["reference"] = eig_result(ref)
    whole = os.path.join(p["dir"], "whole")
    out["uninterrupted"] = eig_result(distributed_dia_il_power_checkpointed(
        A, mesh, opts, checkpoint_dir=whole, chunk=100, x0=p["x0_6000"]))
    split = os.path.join(p["dir"], "split")
    out["stopped"] = eig_result(distributed_dia_il_power_checkpointed(
        A, mesh, SolverOptions(max_iterations=60, tolerance=1e-7), checkpoint_dir=split,
        chunk=25, x0=p["x0_6000"]))
    out["saved"] = os.path.exists(os.path.join(split, "dist_power_state.pt"))
    out["resumed"] = eig_result(distributed_dia_il_power_checkpointed(
        A, mesh, opts, checkpoint_dir=split, chunk=100, x0=p["x0_6000"]))
    out["decoded"] = pd.decode_vec_il_sharded(ref.eigenvector, A, mesh)

    # a checkpoint of 4 ranks restored on 2 raises on both
    pair = dist.new_group([0, 1])
    if mesh.rank < 2:
        half = make_row_mesh(2, group=pair, device="cpu")
        B = pd.partition_dia_il(dia(p["band6000"]), half)
        out["other_world"] = raises(lambda: distributed_dia_il_power_checkpointed(
            B, half, opts, checkpoint_dir=split, chunk=100, x0=p["x0_6000"]), ValueError)

    out["arnoldi"] = {}
    for name in ("B96", "B120", "B50"):
        k, m = p["arnoldi_km"][name]
        E = partition_ell(csr(p[name]), mesh)
        out["arnoldi"][name] = qr_result(distributed_arnoldi_eigenvalues(
            E, mesh, k=k, m=m, x0=p["x0_" + name]))
    band = dia(p["band96"])
    for label, P_ in (("dia", pd.partition_dia(band, mesh)),
                      ("il", pd.partition_dia_il(band, mesh, tile_s=8)),
                      ("pruned", partition_gell_pruned(csr(p["band96_csr"]), mesh,
                                                       tile_rows=128))):
        out["arnoldi"][label] = qr_result(distributed_arnoldi_eigenvalues(
            P_, mesh, k=3, m=20, x0=p["x0_band96"]))
    E = partition_ell(csr(p["B96"]), mesh)
    out["arnoldi_errors"] = [raises(lambda: distributed_arnoldi_eigenvalues(E, mesh, k=0)),
                             raises(lambda: distributed_arnoldi_eigenvalues(E, mesh, k=30,
                                                                            m=20))]
    return out


# --------------------------------------------------------------------------
# tests/test_torch_parallel_dryrun.py: the eight legs of dryrun_multichip
# --------------------------------------------------------------------------


def dryrun_cases(mesh, p):
    import numpy as np
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch import SolverOptions
    from pcsc_eigenvalue_solver_project_tpu_torch.matrix.split_complex import SplitComplexDIA
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import dia as pd
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.arnoldi import (
        distributed_arnoldi_eigenvalues, distributed_krylov_schur_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.gell_pruned import (
        distributed_gell_power_pruned, partition_gell_pruned)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.lanczos import (
        distributed_lanczos_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.power import distributed_power_method
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.sharded import partition_ell
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.split_complex import (
        distributed_splitc_power_method, partition_splitc_dia)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.subspace import (
        distributed_subspace_iteration)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    opts = SolverOptions(max_iterations=500, tolerance=1e-6)
    out = {}
    # 1) general-sparse ELL partition, cyclic halo exchange
    A = partition_ell(csr(p["ell"]), mesh)
    out["halo_ok"] = A.halo_ok
    out["ell"] = eig_result(distributed_power_method(A, mesh, opts, generator=gen(0)))
    # 2) interleaved DIA: seam-lane halos, B1's window entry
    A_il = pd.partition_dia_il(dia(p["il"]), mesh, tile_s=8)
    r_il = pd.distributed_dia_il_power_method(A_il, mesh, opts, generator=gen(0))
    out["il"] = eig_result(r_il)
    out["il_vector"] = pd.decode_vec_il_sharded(r_il.eigenvector, A_il, mesh)
    # 3) split-plane complex
    planes, offsets = p["splitc"]
    n = planes.shape[2]
    sc = SplitComplexDIA(planes=torch.from_numpy(planes.copy()), offsets=offsets, shape=(n, n))
    out["splitc"] = eig_result(distributed_splitc_power_method(
        partition_splitc_dia(sc, mesh), mesh, opts, generator=gen(1)))
    # 4) segment-pruned GELL: own-block pack, per-distance exchange
    A_pr = partition_gell_pruned(csr(p["pruned"]), mesh, tile_rows=128)
    ones = np.ones(A_pr.n_orig, np.float32)
    out["pruned"] = eig_result(distributed_gell_power_pruned(A_pr, mesh, opts, x0=ones))
    # 5) distributed Arnoldi on the pruned operator
    out["arnoldi"] = qr_result(distributed_arnoldi_eigenvalues(A_pr, mesh, k=3, m=16, x0=ones))
    # 6) distributed Krylov-Schur on a clustered spectrum
    out["krylov_schur"] = qr_result(distributed_krylov_schur_eigenvalues(
        partition_ell(csr(p["ks"]), mesh), mesh, k=2, m=14, generator=gen(9),
        opts=SolverOptions(tolerance=1e-5)))
    # 7) distributed Lanczos on the interleaved partition
    A_lz = pd.partition_dia_il(dia(p["lanczos"]), mesh, tile_s=8)
    out["lanczos"] = qr_result(distributed_lanczos_eigenvalues(
        A_lz, mesh, k=3, m=min(40, A_lz.n_orig), which="LA", generator=gen(11),
        opts=SolverOptions(tolerance=1e-5)))
    # 8) distributed block iteration on it (B5's window entry)
    out["subspace"] = qr_result(distributed_subspace_iteration(
        A_lz, mesh, k=2, generator=gen(12), opts=SolverOptions(max_iterations=3000,
                                                               tolerance=1e-6)))
    return out
