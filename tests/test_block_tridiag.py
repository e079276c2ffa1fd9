"""On-device block-cyclic-reduction direct solver (fem/block_tridiag).

The on-device replacement for the reference's host sparse
factorization (Eigen SimplicialLLT/SparseLU, toolkit/femsolver.h:134-135)
on banded/RCM-orderable problems: parity vs dense solve, AD, RCM
reordering, and the driven-Helmholtz wiring (solver="bcr")."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eggshell_tpu.fem.block_tridiag import (
    BlockTridiagStructure,
    block_tridiag_solve,
)


def _banded_system(rng, n=300, bw=5, complex_sym=True):
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mask = np.abs(ii - jj) <= bw
    A = np.where(mask, rng.normal(size=(n, n)), 0.0)
    if complex_sym:
        A = A + 1j * np.where(mask, rng.normal(size=(n, n)), 0.0)
    A = A + A.T                       # complex SYMMETRIC (not Hermitian)
    A[np.arange(n), np.arange(n)] += np.abs(A).sum(1) + 1.0
    rows, cols = np.nonzero(A)
    return A, rows, cols, A[rows, cols]


def test_bcr_matches_dense_solve():
    rng = np.random.default_rng(0)
    A, rows, cols, vals = _banded_system(rng)
    n = A.shape[0]
    st = BlockTridiagStructure.from_bandwidth(rows, cols, n)
    b = rng.normal(size=n) + 1j * rng.normal(size=n)
    x = block_tridiag_solve(jnp.asarray(vals), jnp.asarray(b), st)
    assert np.abs(A @ np.asarray(x) - b).max() < 1e-8


def test_bcr_duplicate_triplets_accumulate():
    """Triplet semantics: duplicates sum (Eigen setFromTriplets)."""
    rng = np.random.default_rng(1)
    A, rows, cols, vals = _banded_system(rng, n=64, bw=3,
                                         complex_sym=False)
    n = A.shape[0]
    # split every entry into two half-valued triplets
    rows2 = np.concatenate([rows, rows])
    cols2 = np.concatenate([cols, cols])
    vals2 = np.concatenate([vals / 2, vals / 2])
    st = BlockTridiagStructure.from_bandwidth(rows2, cols2, n)
    b = rng.normal(size=n)
    x = block_tridiag_solve(jnp.asarray(vals2), jnp.asarray(b), st)
    assert np.abs(A @ np.asarray(x) - b).max() < 1e-8


def test_bcr_rcm_reordering_unstructured():
    """A scrambled ordering (huge native bandwidth) is solved through
    the automatic reverse-Cuthill-McKee permutation."""
    rng = np.random.default_rng(2)
    A, rows, cols, vals = _banded_system(rng, n=200, bw=4)
    n = A.shape[0]
    perm = rng.permutation(n)
    # scramble node labels: A'[perm[i], perm[j]] = A[i, j]
    rows_s = perm[rows]
    cols_s = perm[cols]
    native_bw = int(np.max(np.abs(rows_s - cols_s)))
    st = BlockTridiagStructure.auto(rows_s, cols_s, n)
    assert st.block_size < native_bw // 2   # RCM actually engaged
    As = np.zeros_like(A)
    As[rows_s, cols_s] = vals
    b = rng.normal(size=n) + 1j * rng.normal(size=n)
    x = block_tridiag_solve(jnp.asarray(vals), jnp.asarray(b), st)
    assert np.abs(As @ np.asarray(x) - b).max() < 1e-8


def test_bcr_gradient_matches_fd():
    rng = np.random.default_rng(3)
    A, rows, cols, vals = _banded_system(rng, n=80, bw=3,
                                         complex_sym=False)
    n = A.shape[0]
    st = BlockTridiagStructure.from_bandwidth(rows, cols, n)
    b = jnp.asarray(rng.normal(size=n))

    def loss(v):
        x = block_tridiag_solve(v, b, st)
        return jnp.sum(x ** 2)

    g = jax.grad(loss)(jnp.asarray(vals))
    eps = 1e-6
    for i0 in (0, 17, len(vals) // 2):
        vp = np.array(vals); vp[i0] += eps
        vm = np.array(vals); vm[i0] -= eps
        fd = (loss(jnp.asarray(vp)) - loss(jnp.asarray(vm))) / (2 * eps)
        np.testing.assert_allclose(float(g[i0]), float(fd), rtol=1e-4,
                                   atol=1e-8)


def test_bcr_rejects_undersized_blocks():
    rng = np.random.default_rng(4)
    _, rows, cols, vals = _banded_system(rng, n=64, bw=6)
    with pytest.raises(ValueError):
        BlockTridiagStructure(rows, cols, 64, block_size=2)


def test_driven_helmholtz_bcr_matches_superlu():
    """solver="bcr" reproduces the host-factorized S-parameters on a
    two-port waveguide, structured AND unstructured (RCM) mesh (the
    driven-solve wiring; ref Solver::Solve, rama/solver.cc:1382-1422)."""
    from eggshell_tpu.fem.helmholtz import FemConfig, solve_driven
    from eggshell_tpu.fem.mesher import mesh_shape, mesh_structured
    from eggshell_tpu.fem.shape import Rectangle

    cfg = FemConfig(type="EZ", frequency=75e9, unit=1e-3, excited_port=1)
    W, H = 20.0, 3.0988
    cd = Rectangle(-W / 2, -H / 2, W / 2, H / 2)
    cd.Port((-W / 2, -H / 2), (-W / 2, H / 2), 1)
    cd.Port((W / 2, -H / 2), (W / 2, H / 2), 2)
    for mesh in (
        mesh_structured(cd, (-W / 2, -H / 2), (W, 0), (0, H), 0.35),
        mesh_shape(cd, 0.4),
    ):
        s_ref = solve_driven(mesh, cfg, solver="sparse")
        s_bcr = solve_driven(mesh, cfg, solver="bcr")
        for p in (1, 2):
            assert abs(s_ref.s_params[p] - s_bcr.s_params[p]) < 1e-8
