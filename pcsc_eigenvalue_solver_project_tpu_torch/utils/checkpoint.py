"""Checkpoint and resume for long-running power solves (the port of the JAX
package's ``utils/checkpoint.py``).

The solver state is the power loop's carry (``solvers/power.py``: k, done,
x, z = A x, lambda and the flags), saved with ``torch.save`` every
``chunk`` iterations so that a preempted job resumes where it stopped
instead of repeating thousands of SpMVs. A save writes a temporary file
beside the checkpoint and ``os.replace``-s it into place, so an interrupted
save never leaves a torn checkpoint; a load is ``torch.load(weights_only=
True)`` onto the operand's device. The carry is the loop's own, and a
block of masked iterations that ends early changes nothing, so a resumed
run lands on the uninterrupted run's iterate, eigenvalue and count bit for
bit.

The distributed form follows JAX's single-controller layout: one file, the
rank blocks of the iterate gathered on rank 0 with the world size beside
them, and scattered back to the ranks on restore; a restore at another
world size raises ``ValueError``.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from ..core.options import SolverOptions
from ..core.results import EigenResult
from ..matrix.protocol import AbstractMatrix, decode_result, require_nonempty, require_square
from ..solvers.power import (carry_to_result, norm, power_carry_loop, power_init_carry,
                             vdot)
from .loops import host_flags
from .prng import default_generator, random_unit_vector
from .timing import spanned

_VECTORS = (2, 3)  # x and z: the carry's rank blocks


def save_state(path: str, state) -> None:
    """Persist a solver state (nested tuples, lists and dicts of tensors and
    numbers) at ``path``, replacing what is there, atomically."""
    path = os.path.abspath(path)
    folder = os.path.dirname(path)
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, prefix=".tmp-", suffix=".pt")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_to_cpu(state), f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _to_cpu(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, (tuple, list)):
        return type(state)(_to_cpu(v) for v in state)
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    return state


def restore_state(path: str, device=None):
    """The solver state saved at ``path`` with its tensors on ``device``
    (default: the CPU), or None if there is none."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location=device or "cpu", weights_only=True)


def _run_chunks(carry, opts: SolverOptions, chunk: int, advance, save):
    """Advance the carry ``chunk`` iterations at a time to the budget or
    ``done``, saving after each chunk."""
    while True:
        k, done = host_flags(carry[0], carry[1])
        if done or k >= opts.max_iterations:
            return carry
        carry = advance(carry, min(k + chunk, opts.max_iterations))
        save(carry)


@spanned
def power_method_checkpointed(M: AbstractMatrix, opts: SolverOptions = SolverOptions(), *,
                              checkpoint_dir: str, chunk: int = 200,
                              generator: torch.Generator | None = None,
                              x0=None) -> EigenResult:
    """Power iteration with a checkpoint after every ``chunk`` iterations and
    resume from one found in ``checkpoint_dir`` (``power_state.pt``).

    The state is the loop carry of ``solvers/power.py`` and nothing else:
    restoring and continuing gives the iterate sequence of an uninterrupted
    ``power_method`` from the same start."""
    require_square(M, "power_method")
    require_nonempty(M, "power_method")
    path = os.path.join(os.path.abspath(checkpoint_dir), "power_state.pt")
    restored = restore_state(path, M.device)
    if restored is not None:
        carry = tuple(restored)
    else:
        vec_dt = torch.promote_types(M.dtype, torch.float32)
        if x0 is None:
            gen = generator if generator is not None else default_generator(M.device)
            x0 = random_unit_vector(gen, M.shape[0], vec_dt, device=M.device)
        else:
            x0 = torch.as_tensor(x0).to(device=M.device, dtype=vec_dt)
            nrm = norm(x0)
            x0 = torch.where(nrm == 0, x0, x0 / torch.where(nrm == 0, 1, nrm).to(vec_dt))
        carry = power_init_carry(M.matvec, M.encode_vec(x0))

    def advance(c, k_end):
        return power_carry_loop(M.matvec, vdot, norm, c, k_end, opts.tolerance)

    carry = _run_chunks(carry, opts, chunk, advance, lambda c: save_state(path, c))
    return decode_result(M, carry_to_result(carry))


# --------------------------------------------------------------------------
# Distributed (interleaved) checkpointed power: the same carry, the chunks
# run on the ranks, the rank blocks of x and z gathered on rank 0 for the
# save and scattered back on restore.
# --------------------------------------------------------------------------


def _save_distributed(path: str, carry, mesh) -> None:
    """Gather the carry's rank blocks on rank 0, which saves one file."""
    gathered = []
    for i in _VECTORS:
        parts = ([torch.empty_like(carry[i]) for _ in range(mesh.world_size)]
                 if mesh.rank == 0 else None)
        dist.gather(carry[i].contiguous(), parts, dst=mesh.global_rank(0), group=mesh.group)
        gathered.append(parts)
    if mesh.rank == 0:
        state = list(carry)
        for i, parts in zip(_VECTORS, gathered):
            state[i] = torch.stack(parts)
        save_state(path, {"world_size": mesh.world_size, "carry": state})
    dist.barrier(group=mesh.group,
                 device_ids=[mesh.device.index] if mesh.device.type == "cuda" else None)


def _restore_distributed(path: str, like, mesh):
    """Rank 0 reads the file and scatters the carry's rank blocks; every rank
    gets the replicated scalars. ``like`` is a fresh carry of this rank
    (shapes, dtypes, device). None when there is no file; a file saved at
    another world size raises ``ValueError`` on every rank."""
    state = restore_state(path) if mesh.rank == 0 else None
    header = torch.tensor([-1 if state is None else state["world_size"]], dtype=torch.int64,
                          device=mesh.device)
    dist.broadcast(header, src=mesh.global_rank(0), group=mesh.group)
    saved_world = int(header.item())
    if saved_world == -1:
        return None
    if saved_world != mesh.world_size:
        raise ValueError(f"distributed_dia_il_power_checkpointed: the checkpoint was saved "
                         f"at world size {saved_world}, this run has {mesh.world_size}")
    carry = list(like)
    for i, t in enumerate(like):
        if i in _VECTORS:
            parts = (list(state["carry"][i].to(mesh.device).unbind(0)) if mesh.rank == 0
                     else None)
            out = torch.empty_like(t)
            dist.scatter(out, parts, src=mesh.global_rank(0), group=mesh.group)
        else:
            out = (state["carry"][i].to(mesh.device) if mesh.rank == 0
                   else torch.empty_like(t))
            dist.broadcast(out.view(torch.uint8) if out.dtype == torch.bool else out,
                           src=mesh.global_rank(0), group=mesh.group)
        carry[i] = out
    return tuple(carry)


@spanned
def distributed_dia_il_power_checkpointed(A, mesh, opts: SolverOptions = SolverOptions(), *,
                                          checkpoint_dir: str, chunk: int = 200,
                                          axis: str = "rows",
                                          generator: torch.Generator | None = None,
                                          x0=None) -> EigenResult:
    """Distributed interleaved power iteration with checkpoints
    (``dist_power_state.pt`` in ``checkpoint_dir``, which rank 0 writes).

    ``A`` is a ``parallel.dia.PartitionedILDIA``; the returned
    ``eigenvector`` is this rank's interleaved block (gather it with
    ``parallel.dia.decode_vec_il_sharded``). Every rank calls this with the
    same arguments. Restoring mid-run reproduces the uninterrupted iterate
    sequence exactly: the checkpoint is the loop carry."""
    from ..parallel.mesh import axis_size
    from ..parallel.power import host_start_vector, reductions

    axis_size(mesh, axis)
    path = os.path.join(os.path.abspath(checkpoint_dir), "dist_power_state.pt")
    matvec = A.local_matvec(mesh)
    xh = host_start_vector(A.n_orig, A.vector_dtype, generator, x0)
    carry = power_init_carry(matvec, A.local_block(xh, mesh))
    restored = _restore_distributed(path, carry, mesh)
    if restored is not None:
        carry = restored
    vdot_d, norm_d = reductions(mesh)

    def advance(c, k_end):
        return power_carry_loop(matvec, vdot_d, norm_d, c, k_end, opts.tolerance)

    carry = _run_chunks(carry, opts, chunk, advance,
                        lambda c: _save_distributed(path, c, mesh))
    return carry_to_result(carry)
