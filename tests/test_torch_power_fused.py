"""B1's power-step form on the CPU, through its plain version.

On a CUDA device ``power_method`` runs an ``InterleavedDIA`` with float32
or bfloat16 diagonals on the power step
(``solvers/power.py::power_fused_loop``): one step and one finish an
iteration, the carry on the device. On the CPU ``power_method`` keeps the
generic loop, and ``power_fused_loop`` called directly runs the step and
the finish as their plain versions (``ops/dia_spmv.py``), so these tests
hold the route's logic: the partial sums and the ping-pong index against
their definitions, and whole solves on HPCG's 27-point stencil (grids 8-16,
one n not a multiple of 128) against ``power_carry_loop`` on the same
operator and against the JAX package: the same iterations and
``converged``, the eigenvalue to rtol 1e-5 and the eigenvector to 1e-5
(float32; only the summation order and the scale ``s z`` for ``z / ||z||``
round differently).

The kernels themselves, and the route's rule on the card, are held to these
plain versions in ``tests/test_torch_cuda_kernels.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.matrix.protocol import decode_result
from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import power as tpower
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import from_numpy_leaves


def stencil(grid, planted=(), noise=0.0, seed=0):
    """HPCG's 27-point stencil on a grid^3 cube (26 on the diagonal, -1 to
    each neighbour inside the cube) as (27, n) float64 diagonals and their
    offsets; ``noise`` perturbs every stored entry by uniform(-noise, noise),
    ``planted`` is added to the first diagonal entries (a dominant gap)."""
    n = grid ** 3
    i = np.arange(n)
    x, y, z = i % grid, (i // grid) % grid, i // grid ** 2
    offsets, diagonals = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                inside = ((0 <= x + dx) & (x + dx < grid) & (0 <= y + dy) & (y + dy < grid)
                          & (0 <= z + dz) & (z + dz < grid))
                offsets.append(dz * grid * grid + dy * grid + dx)
                diagonals.append(np.where(inside, 26.0 if offsets[-1] == 0 else -1.0, 0.0))
    data = np.stack(diagonals)
    data += noise * np.random.default_rng(seed).uniform(-1, 1, data.shape) * (data != 0)
    data[offsets.index(0), :len(planted)] += planted
    return data, tuple(offsets)


def to_port(m):
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(m)]
    static = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
              if f.metadata.get("static")}
    return from_numpy_leaves(type(m).__name__, leaves, static, device="cpu")


def operators(data, offsets, dtype):
    """The JAX ``InterleavedDIA`` and the port's, R the band's halo (a 27-point
    stencil needs R >= grid^2 + grid + 1: most lanes are padding)."""
    n = data.shape[1]
    tile = ds.il_window_halo(offsets)
    dj = J.SparseDIA(data=jnp.asarray(data.astype(np.float32)), offsets=offsets, shape=(n, n))
    mj = dj.interleaved(tile, dtype=None if dtype == "float32" else jnp.bfloat16)
    return mj, to_port(mj)


def unit_start(mt, x0):
    """``power_method``'s start from ``x0``: float32, unit, interleaved."""
    xs = torch.from_numpy(x0).to(torch.float32)
    return mt.encode_vec(xs / torch.linalg.vector_norm(xs))


def fused_solve(mt, max_iterations, tol, x0):
    """``power_method``'s solve on the power step's route, from ``x0``."""
    return decode_result(mt, tpower.power_fused_loop(mt, unit_start(mt, x0), max_iterations,
                                                     tol))


# (grid, diagonals, planted, noise, max_iterations, tolerance, zero operator)
CASES = {
    "tol0-budget": (12, "float32", (), 0.05, 70, 0.0, False),
    "tol-mid-block": (16, "float32", (80.0, 40.0), 0.05, 1000, 1e-6, False),
    "tol-mid-block-n-ragged": (12, "float32", (80.0, 40.0), 0.05, 1000, 1e-5, False),
    "max-iterations-0": (8, "float32", (), 0.05, 0, 0.0, False),
    "max-iterations-1": (8, "float32", (), 0.05, 1, 0.0, False),
    "breakdown-zero-operator": (8, "float32", (), 0.0, 50, 1e-10, True),
    "bf16-budget": (12, "bfloat16", (), 0.05, 70, 0.0, False),
    "bf16-tol": (12, "bfloat16", (80.0, 40.0), 0.05, 1000, 1e-5, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_route_matches_generic_loop_and_jax(case):
    grid, dtype, planted, noise, max_iterations, tol, zero = CASES[case]
    data, offsets = stencil(grid, planted, noise, seed=grid)
    if zero:
        data = np.zeros_like(data)
    n = data.shape[1]
    mj, mt = operators(data, offsets, dtype)
    x0 = np.random.default_rng(grid + 1).uniform(-1, 1, n)
    opts = (max_iterations, tol)
    r = fused_solve(mt, *opts, x0)
    # the generic loop on the same operator, from the same unit start: what
    # power_method runs on the CPU
    g = tpower.power_iteration_loop(mt.matvec, tpower.vdot, tpower.norm, unit_start(mt, x0),
                                    *opts)
    assert not tpower.fused_route(mt)
    rc = T.power_method(mt, T.SolverOptions(*opts), x0=x0)
    assert torch.equal(rc.eigenvalue, g.eigenvalue)
    assert torch.equal(rc.eigenvector, mt.decode_vec(g.eigenvector))
    rj = J.power_method(mj, J.SolverOptions(*opts), x0=x0)

    iterations = int(r.iterations)
    assert iterations == int(g.iterations) == int(rj.iterations)
    assert bool(r.converged) == bool(g.converged) == bool(rj.converged)
    assert r.eigenvalue.dtype == torch.float32 and r.eigenvector.shape == (n,)
    lam = float(r.eigenvalue)
    np.testing.assert_allclose(lam, float(g.eigenvalue), rtol=1e-5)
    np.testing.assert_allclose(lam, float(rj.eigenvalue), rtol=1e-5)
    np.testing.assert_allclose(r.eigenvector.numpy(), mt.decode_vec(g.eigenvector).numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(r.eigenvector.numpy(), np.asarray(rj.eigenvector),
                               rtol=0, atol=1e-5)
    if zero:
        assert (iterations, bool(r.converged), lam) == (1, False, 0.0)
        np.testing.assert_allclose(r.eigenvector.numpy(), x0 / np.linalg.norm(x0), rtol=1e-6)
    elif tol == 0:
        assert iterations == max_iterations and not bool(r.converged)
    else:
        assert bool(r.converged) and iterations % tpower.BLOCK_ITERATIONS != 0


@pytest.mark.parametrize("block", [1, 5, 64])
def test_fused_route_independent_of_block_length(block, monkeypatch):
    data, offsets = stencil(12, (80.0, 40.0), 0.05, seed=3)
    _, mt = operators(data, offsets, "float32")
    x0 = np.random.default_rng(3).uniform(-1, 1, data.shape[1])
    ref = fused_solve(mt, 1000, 1e-6, x0)
    monkeypatch.setattr(tpower, "BLOCK_ITERATIONS", block)
    r = fused_solve(mt, 1000, 1e-6, x0)
    assert int(r.iterations) == int(ref.iterations) and bool(r.converged)
    assert torch.equal(r.eigenvector, ref.eigenvector)
    assert torch.equal(r.eigenvalue, ref.eigenvalue)


def test_route_rule():
    # no operand takes the power step's route off the card (the rule on the
    # card: tests/test_torch_cuda_kernels.py)
    data, offsets = stencil(8)
    n = data.shape[1]
    tile = ds.il_window_halo(offsets)
    f32 = T.SparseDIA(data=torch.from_numpy(data).float(), offsets=offsets, shape=(n, n))
    assert not tpower.fused_route(f32.interleaved(tile))
    assert not tpower.fused_route(f32.interleaved(tile, dtype=torch.bfloat16))
    assert not tpower.fused_route(f32)
    # a band wider than a lane's chunk keeps the matvec's error
    narrow = f32.interleaved(8)
    with pytest.raises(ValueError, match="bandwidth exceeds chunk size R"):
        T.power_method(narrow, T.SolverOptions(5, 0.0), x0=np.ones(n))


def test_plain_step_partials_carry_and_ping_pong():
    # a band whose last rows fill lane 127 (n = 128 R - 3) and reach |off| = R
    R = 24
    n = ds.LANES * R - 3
    offsets = (-R, -7, -1, 0, 1, 5, R)
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.uniform(-1, 1, (len(offsets), n)).astype(np.float32))
    vals[offsets.index(0)] += 6.0
    for d, off in enumerate(offsets):  # zeros where the column leaves the matrix
        if off > 0:
            vals[d, n - off:] = 0
        elif off < 0:
            vals[d, :-off] = 0
    vals_il = ds.interleave_dia_vals(vals, R)
    x0 = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    x0 = x0 / torch.linalg.vector_norm(x0)
    st = ds.power_state(ds.interleave_vec(x0, R))
    assert st.partials.shape == (2, ds.power_blocks(R)) == (2, R // 4)
    assert st.ctl.tolist() == [0] * 8 and st.sc.tolist() == [1.0, 1.0, 0.0, 0.0]

    def matvec(v_il):
        return ds.interleave_vec(ds.dia_matvec_plain(vals, offsets, ds.deinterleave_vec(v_il, n)),
                                 R)

    def block_sums(a):
        return a.reshape(-1, ds.POWER_BLOCK).sum(1)

    # the start (step 0 reads zz[0]): zz[1] = A x0, then init's finish flips
    # cur and sets s
    ds.dia_il_power_step_plain(vals_il, offsets, st, 0)
    z0 = matvec(st.zz[0])
    torch.testing.assert_close(st.zz[1], z0, rtol=0, atol=1e-5)
    ds.power_finish_plain(st, 0.0, init=True)
    assert st.ctl.tolist() == [0, 0, 0, 0, 0, 1, 0, 0]
    norm0 = float(torch.linalg.vector_norm(st.zz[1].double()))
    assert float(st.sc[ds.SC_SX]) == 1.0 and float(st.sc[ds.SC_LAM]) == 0.0
    np.testing.assert_allclose(float(st.sc[ds.SC_S]), 1 / norm0, rtol=1e-6)

    # iteration 1 reads zz[1] and writes zz[0]: x1 = s zz[1], z1 = A x1
    x1 = st.zz[1] * st.sc[ds.SC_S]
    s1 = float(st.sc[ds.SC_S])
    ds.dia_il_power_step_plain(vals_il, offsets, st, 1)
    z1 = matvec(x1)
    torch.testing.assert_close(st.zz[0], z1, rtol=0, atol=1e-5)
    torch.testing.assert_close(st.partials[0], block_sums(x1 * st.zz[0]).reshape(-1))
    torch.testing.assert_close(st.partials[1], block_sums(st.zz[0] * st.zz[0]).reshape(-1))
    ds.power_finish_plain(st, 0.0)
    assert st.ctl.tolist() == [1, 0, 1, 0, 1, 0, 0, 0]  # k, initialized, used; cur 0
    lam1 = float((x1.double() * st.zz[0].double()).sum())
    np.testing.assert_allclose(float(st.sc[ds.SC_LAM]), lam1, rtol=1e-6)
    assert float(st.sc[ds.SC_SX]) == s1  # the kept x is s1 zz[1]
    np.testing.assert_allclose(float(st.sc[ds.SC_S]),
                               1 / float(torch.linalg.vector_norm(z1.double())), rtol=1e-6)

    # iteration 2 the other way round; a tolerance that holds stops it
    ds.dia_il_power_step_plain(vals_il, offsets, st, 0)
    ds.power_finish_plain(st, 1.0)
    assert st.ctl.tolist() == [2, 1, 1, 1, 2, 1, 0, 0]
    # after done neither the step nor the finish changes anything
    before = [t.clone() for t in st]
    ds.dia_il_power_step_plain(vals_il, offsets, st, 1)
    ds.power_finish_plain(st, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(before, st))


def test_plain_finish_breakdown_keeps_the_last_iterate():
    R = 8
    st = ds.power_state(torch.ones((R, ds.LANES)))
    vals_il = torch.zeros((3, R, ds.LANES))
    ds.dia_il_power_step_plain(vals_il, (-1, 0, 1), st, 0)
    ds.power_finish_plain(st, 0.0, init=True)
    assert st.ctl.tolist() == [0, 0, 0, 0, 0, 1, 1, 0]  # the zero flag: ||A x0|| == 0
    assert st.sc.tolist() == [1.0, 1.0, 0.0, 0.0]
    zz = st.zz.clone()
    ds.dia_il_power_step_plain(vals_il, (-1, 0, 1), st, 1)  # writes nothing
    assert torch.equal(st.zz, zz)
    ds.power_finish_plain(st, 0.0)
    assert st.ctl.tolist() == [1, 1, 0, 0, 1, 1, 1, 0]  # k, done, used; nothing kept
    assert torch.equal(st.zz[0], torch.ones((R, ds.LANES)))  # x = sx zz[1 - cur] = x0


@pytest.mark.parametrize("planted,tol", [((80.0, 40.0), 1e-5), ((), 0.0)])
def test_step_parity_is_the_carry_cur(planted, tol, monkeypatch):
    # the loop passes step t half t % 2 of the pair; while the step runs that
    # is the carry's cur, and after done the steps of the block do nothing
    data, offsets = stencil(8, planted, 0.05, seed=5)
    _, mt = operators(data, offsets, "float32")
    seen = []
    step = ds.dia_il_power_step

    def spy(vals_il, offsets, st, src):
        live = not (int(st.ctl[ds.CTL_DONE]) or int(st.ctl[ds.CTL_ZERO]))
        seen.append((src, int(st.ctl[ds.CTL_CUR]), live))
        step(vals_il, offsets, st, src)

    monkeypatch.setattr(ds, "dia_il_power_step", spy)
    r = fused_solve(mt, 40, tol, np.ones(data.shape[1]))
    assert [src for src, _, _ in seen] == [t % 2 for t in range(len(seen))]
    assert all(src == cur for src, cur, live in seen if live)
    live = sum(1 for *_, alive in seen if alive)
    assert live == int(r.iterations) + 1  # the start's product and each iteration
    # whole blocks of 32 steps are launched until the block where the run stops
    assert len(seen) == (33 if tol else 41) and bool(r.converged) == bool(tol)
