"""Power iteration — dominant eigenpair.

Reference parity (reference src/power_method/power_method.hpp:47-148):

    x_{k+1} = A x_k / ||A x_k||,   lambda_k = x_k^H (A x_k)

with convergence when successive Rayleigh quotients satisfy
``|l_new - l| <= tol * (1 + |l_new|)`` (power_method.hpp:83-91 via
tolerance.hpp:29-33), breakdown (``||Ax|| == 0``) exiting with
``converged=False`` (power_method.hpp:73-76), and ``iterations == k+1`` at
the breaking iteration (power_method.hpp:87,95). As in the JAX package, the
Rayleigh-quotient matvec ``A x_{k+1}`` is carried over as the next
iteration's ``y``: one matvec per iteration.

Loop structure: the JAX package runs the loop as one ``lax.while_loop``
with the ``done`` flag on the device. Here the loop body runs eagerly on
tensors, in blocks of ``BLOCK_ITERATIONS`` iterations (``utils/loops.py``).
Every carry update is masked by ``done`` with ``torch.where``, so the
iterations after ``done`` inside a block change nothing, and the host reads
the flag once per block, not once per matvec. The result and iteration
count are exactly the while-loop's.

An ``InterleavedDIA`` with float32 or bfloat16 diagonals on a CUDA device
runs the same iteration on B1's power-step form (``power_fused_loop``):
each iteration is two launches, the product with the step's vector work and
a one-block finish that updates the carry on the device, so no vector is
masked or copied; after ``done`` both launches change nothing. The
iterations, flags and stopping rule are the loop's; only the summation
order and the scale (``s z`` for ``z / ||z||``) round differently. On the
CPU ``power_method`` keeps ``power_carry_loop``; ``power_fused_loop`` called
there runs the step's plain version.

Split-plane complex operators (``matrix/split_complex.py``) run the same
loop on (2, n) real planes with a (2,) plane eigenvalue
(``power_method_split_complex``, JAX ``_power_loop_split``), and
``power_method_ds64`` runs it in float64 on a ``SparseDIA`` whose diagonals
it widens (the JAX package's double-single loop, which its TPU needs for
want of float64).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import check_scalar_type, real_dtype_of
from ..core.options import SolverOptions
from ..core.results import EigenResult
from ..core.tolerance import is_close_relative
from ..matrix.protocol import (AbstractMatrix, decode_result,
                               require_nonempty, require_square)
from ..matrix.dia import InterleavedDIA
from ..matrix.split_complex import InterleavedSplitComplexDIA, SplitComplexDIA
from ..ops import dia_spmv as ds
from ..ops.split_complex import splitc_is_close_relative, splitc_norm, splitc_vdot
from ..utils.loops import BLOCK_ITERATIONS, count, flag, run_masked
from ..utils.prng import default_generator, random_unit_vector
from ..utils.timing import host_write, spanned


def vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x^H y`` over all elements (``jnp.vdot``: flattens, conjugates x)."""
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def norm(x: torch.Tensor) -> torch.Tensor:
    """2-norm over all elements."""
    return torch.linalg.vector_norm(x)


def power_init_carry(matvec, x0: torch.Tensor):
    """Initial loop carry: (k, done, x, z=A@x, lambda, initialized,
    converged, used_iterations), all tensors on x0's device."""
    dev = x0.device
    return (count(dev), flag(False, dev), x0, matvec(x0),
            torch.zeros((), dtype=x0.dtype, device=dev),
            flag(False, dev), flag(False, dev), count(dev))


def power_carry_loop(matvec, vdot, norm, carry, max_iterations: int, tol,
                     is_close=is_close_relative):
    """Advance the power-iteration carry until ``k == max_iterations`` or
    convergence/breakdown. Generic over the reduction primitives and the
    stopping rule ``is_close(lam_new, lam, tol)``, like the JAX package's.
    ``tol`` is a float, decided in float64, or a 0-d tensor, decided in its
    dtype (the split loop's, as JAX decides it in the planes' dtype)."""
    dtype = carry[2].dtype
    rdt = real_dtype_of(dtype)
    device = carry[2].device
    if not isinstance(tol, torch.Tensor):
        tol = host_write(tol, device, torch.float64)
    one = torch.ones((), dtype=rdt, device=device)

    def body(c):
        k, done, x, z, lam, initialized, converged, used = c
        y = z  # == A @ x, computed at the end of the previous iteration
        norm_y = norm(y).to(rdt)
        breakdown = norm_y == 0
        safe = torch.where(breakdown, one, norm_y).to(dtype)
        x_new = y / safe
        z_new = matvec(x_new)
        lam_new = vdot(x_new, z_new)  # x^H (A x): conjugates first arg like Eigen dot
        conv_now = initialized & is_close(lam_new, lam, tol) & ~breakdown
        # An iteration after ``done`` changes nothing; breakdown keeps the
        # last good x, z and lambda.
        live = ~done
        keep = live & ~breakdown
        k_next = torch.where(live, k + 1, k)
        return (
            k_next,
            done | breakdown | conv_now,
            torch.where(keep, x_new, x),
            torch.where(keep, z_new, z),
            torch.where(keep, lam_new, lam),
            initialized | keep,
            converged | (live & conv_now),
            torch.where(live, k + 1, used),  # usedIters = k+1 (power_method.hpp:87,95)
        )

    return run_masked(body, carry, max_iterations, BLOCK_ITERATIONS,
                      span="eigsol.power.block")


def carry_to_result(carry) -> EigenResult:
    k, done, x, z, lam, initialized, converged, used = carry
    return EigenResult(eigenvalue=lam, eigenvector=x, iterations=used,
                       converged=converged)


def power_iteration_loop(matvec, vdot, norm, x0: torch.Tensor,
                         max_iterations: int, tol) -> EigenResult:
    """Run the full power iteration from a fresh start vector."""
    carry = power_carry_loop(matvec, vdot, norm, power_init_carry(matvec, x0),
                             max_iterations, tol)
    return carry_to_result(carry)


# The diagonals B1's power-step form takes: real, accumulated in float32.
FUSED_DTYPES = (torch.float32, torch.bfloat16)


def fused_route(M) -> bool:
    """Whether ``power_method`` runs ``M`` on B1's power-step form: an
    ``InterleavedDIA`` on a CUDA device with float32 or bfloat16 diagonals
    whose halo fits in a lane's chunk (the condition of its matvec). Every
    other operator, and every other power loop, runs ``power_carry_loop``."""
    return (isinstance(M, InterleavedDIA) and M.data_il.is_cuda
            and M.dtype in FUSED_DTYPES and ds.il_window_halo(M.offsets) <= M.R)


def power_fused_loop(M: InterleavedDIA, x0: torch.Tensor, max_iterations: int,
                     tol) -> EigenResult:
    """The power iteration from the interleaved start ``x0`` (R, 128) on
    B1's power-step form (``ops/dia_spmv.py``: ``dia_il_power_step`` and
    ``power_finish``), with the carry in the step's state on the device:
    one step and one finish an iteration, the host reading ``(k, done)``
    once a block as ``power_carry_loop`` does, and the iterate
    ``x = sx * zz[1 - cur]`` built once at the end. Step t (the start's
    product is step 0) reads half ``t % 2`` of the pair, which is the
    carry's cur whenever it runs. ``tol`` is decided in float64."""
    tol = float(tol)
    st = ds.power_state(x0)
    ds.dia_il_power_step(M.data_il, M.offsets, st, 0)  # z = A x0
    ds.power_finish(st, tol, init=True)

    def step(carry):
        k, done, t = carry
        ds.dia_il_power_step(M.data_il, M.offsets, st, (t + 1) % 2)
        ds.power_finish(st, tol)
        return k, done, t + 1

    run_masked(step, (st.ctl[ds.CTL_K], st.ctl[ds.CTL_DONE], 0), max_iterations,
               BLOCK_ITERATIONS, span="eigsol.power.block")
    prev = 1 - st.ctl[ds.CTL_CUR:ds.CTL_CUR + 1].long()
    x = st.zz.index_select(0, prev)[0] * st.sc[ds.SC_SX]
    return EigenResult(eigenvalue=st.sc[ds.SC_LAM].clone(), eigenvector=x,
                       iterations=st.ctl[ds.CTL_USED].clone(),
                       converged=st.ctl[ds.CTL_CONVERGED].bool())


@spanned
def power_method_split_complex(M, opts: SolverOptions = SolverOptions(), *,
                               generator: torch.Generator | None = None,
                               x0=None) -> EigenResult:
    """Power iteration on a split-plane complex operator
    (``matrix/split_complex.py``), on the device where its planes live.
    ``EigenResult.eigenvalue`` is a (2,) plane scalar and ``eigenvector`` a
    (2, n) plane vector; convert on the host with ``ops.split_complex.from_planes``.

    The planes iterate in ``promote(planes dtype, float32)``, so bf16 planes
    (the bench's complex leg) iterate in float32 as the banded matvec
    accumulates; the stopping rule is decided in that dtype, as the JAX loop
    decides it in the planes' dtype."""
    n = M.shape[0]
    if M.shape[0] != M.shape[1]:
        raise ValueError("power_method: matrix must be square")
    if n == 0:
        raise ValueError("power_method: matrix has zero size")
    rdt = torch.promote_types(M.dtype, torch.float32)
    if x0 is None:
        # uniform [-1, 1] re/im planes (the Eigen Random-complex analogue)
        gen = generator if generator is not None else default_generator(M.device)
        x0 = torch.rand((2, n), generator=gen, dtype=rdt, device=gen.device) * 2 - 1
        x0 = x0.to(M.device)
        nrm = torch.sqrt(torch.sum(x0 * x0))
        x0 = x0 / torch.where(nrm == 0, 1, nrm)
    else:
        x0 = torch.as_tensor(x0).to(device=M.device, dtype=rdt)
        if x0.shape != (2, n):
            raise ValueError("power_method_split_complex: x0 must be (2, n) planes")
        nrm = torch.sqrt(torch.sum(x0 * x0))
        x0 = torch.where(nrm == 0, x0, x0 / torch.where(nrm == 0, 1, nrm))
    x0 = M.encode_vec(x0)  # identity for SplitComplexDIA; interleave otherwise
    carry = power_init_carry(M.matvec, x0)
    carry = carry[:4] + (torch.zeros(2, dtype=rdt, device=x0.device),) + carry[5:]
    tol = host_write(opts.tolerance, x0.device, rdt)
    carry = power_carry_loop(M.matvec, splitc_vdot, splitc_norm, carry,
                             opts.max_iterations, tol, splitc_is_close_relative)
    return decode_result(M, carry_to_result(carry))


@spanned
def power_method(M: AbstractMatrix, opts: SolverOptions = SolverOptions(), *,
                 dtype=None, generator: torch.Generator | None = None,
                 x0=None) -> EigenResult:
    """Dominant-eigenpair power iteration on a dense or sparse matrix, on the
    device where the matrix lives.

    ``dtype`` is the ``Scalar`` template-parameter analogue: when given, a
    mismatch with the stored dtype raises ``TypeError`` (parity with
    power_method.hpp:137-139). ``generator``/``x0`` control the start vector.
    Split-plane complex operators are routed to the plane loop
    (``power_method_split_complex``), as in the JAX package, and an
    ``InterleavedDIA`` with float32 or bfloat16 diagonals on a CUDA device to
    B1's power-step form (``fused_route``).
    """
    if isinstance(M, (SplitComplexDIA, InterleavedSplitComplexDIA)):
        return power_method_split_complex(M, opts, generator=generator, x0=x0)
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "power_method")
    require_square(M, "power_method")
    require_nonempty(M, "power_method")
    # Iterate in at least f32 even when the operator stores bf16 diagonals:
    # the banded matvec accumulates in f32 already.
    vec_dt = torch.promote_types(M.dtype, torch.float32)
    if x0 is None:
        gen = generator if generator is not None else default_generator(M.device)
        x0 = random_unit_vector(gen, M.shape[0], vec_dt, device=M.device)
    else:
        x0 = torch.as_tensor(x0).to(device=M.device, dtype=vec_dt)
        nrm = norm(x0)
        x0 = torch.where(nrm == 0, x0, x0 / torch.where(nrm == 0, 1, nrm).to(vec_dt))
    # Solve in the operator's vector domain (identity for most kinds;
    # lane-major interleaved for InterleavedDIA) — encode once, iterate
    # domain-native, decode the eigenvector once.
    x0 = M.encode_vec(x0)
    if fused_route(M):
        r = power_fused_loop(M, x0, opts.max_iterations, opts.tolerance)
    else:
        r = power_iteration_loop(M.matvec, vdot, norm, x0, opts.max_iterations,
                                 opts.tolerance)
    return decode_result(M, r)


@spanned
def power_method_ds64(M, opts: SolverOptions = SolverOptions(), *,
                      generator: torch.Generator | None = None, x0=None) -> EigenResult:
    """Dominant eigenpair of a real banded ``SparseDIA`` operator in float64
    (JAX ``power_method_ds64``, :295).

    The JAX package runs this loop in two-float compensated arithmetic
    (``ops/ds64.py``) because its TPU has no float64; the card has it, so
    here the diagonals are widened to float64 on the operand's device and
    the masked power loop runs on B2's float64 instance. The stopping rule
    is the JAX loop's: no test on the first iterate, then
    ``|lambda_k - lambda_{k-1}| <= tol (1 + |lambda_k|)`` with ``tol`` taken
    at float32 as JAX takes it; a breakdown keeps the last good iterate and
    ``iterations = k + 1``. ``x0`` is used as given (the loop normalises
    ``A x0``). Returns numpy values, as JAX does: a float64 eigenvalue and
    eigenvector, an int32 count and a bool flag."""
    from ..matrix.dia import SparseDIA
    if not isinstance(M, SparseDIA):
        raise ValueError("power_method_ds64: operator must be a SparseDIA")
    require_square(M, "power_method_ds64")
    require_nonempty(M, "power_method_ds64")
    if M.dtype.is_complex:
        raise ValueError("power_method_ds64: real operators only")
    wide = SparseDIA(data=M.data.to(torch.float64), offsets=M.offsets, shape=M.shape)
    if x0 is None:
        gen = generator if generator is not None else default_generator(M.device)
        x0 = random_unit_vector(gen, M.shape[0], torch.float64, device=M.device)
    else:
        x0 = torch.as_tensor(x0).to(device=M.device, dtype=torch.float64)
    tol = float(np.float32(opts.tolerance))
    r = power_iteration_loop(wide.matvec, vdot, norm, x0, opts.max_iterations, tol)
    return EigenResult(eigenvalue=np.float64(r.eigenvalue.item()),
                       eigenvector=r.eigenvector.cpu().numpy(),
                       iterations=np.int32(int(r.iterations)),
                       converged=np.bool_(bool(r.converged)))
