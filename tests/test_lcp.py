"""Batch solver certification — mirrors eggshell/lcp.cc:348-528 and
sparse_iterations.cc tests: random SPD box-LCPs, solutions verified
against KKT/complementarity conditions and against each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eggshell_tpu.oracle import lcp_oracle
from eggshell_tpu.ops import lcp, lcp_direct

NUM_TESTS = 30      # ref runs 100 x 50x50; trimmed for CI speed
SIZE = 50


def gen_spd(rng, n, cond_limit=1e7):
    """Random SPD matrix with bounded condition number
    (ref eggshell/utils.cc:203-215 GenerateSPDMatrix)."""
    while True:
        m = rng.uniform(-1, 1, (n, n))
        A = m.T @ m
        s = np.linalg.svd(A, compute_uv=False)
        if s[0] / s[-1] < cond_limit:
            return A


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(NUM_TESTS):
        A = gen_spd(rng, SIZE)
        b = rng.uniform(-1, 1, SIZE)
        out.append((A, b))
    return out


def test_oracle_murty_no_bounds(problems):
    """x in [0, inf) — ref lcp.cc:412-436 (100% must satisfy KKT)."""
    lo = np.zeros(SIZE)
    hi = np.full(SIZE, np.inf)
    is_eq = np.zeros(SIZE, dtype=bool)
    for A, b in problems:
        x, w, ok = lcp_oracle.murty_principal_pivot(A, b, lo, hi)
        assert ok
        assert lcp_oracle.check_lcp_solution(A, b, x, w, is_eq, lo, hi, 1e-8)


def test_oracle_murty_with_bounds(problems):
    """x in [lo, hi] — ref lcp.cc:438-465."""
    rng = np.random.default_rng(1)
    is_eq = np.zeros(SIZE, dtype=bool)
    for A, b in problems:
        lo = np.full(SIZE, -rng.uniform(0, 2))
        hi = np.full(SIZE, rng.uniform(0.01, 2))
        x, w, ok = lcp_oracle.murty_principal_pivot(A, b, lo, hi)
        assert ok
        assert lcp_oracle.check_lcp_solution(A, b, x, w, is_eq, lo, hi, 1e-8)


def test_oracle_mixed_solver(problems):
    """Random equality/inequality splits — ref lcp.cc:467-528."""
    rng = np.random.default_rng(2)
    for A, b in problems[:15]:
        is_eq = rng.uniform(size=SIZE) < 0.5
        lo = np.full(SIZE, -10.0)
        hi = np.full(SIZE, 10.0)
        x, w, ok = lcp_oracle.mixed_constraints_solver(A, b, is_eq, lo, hi)
        assert ok
        assert lcp_oracle.check_lcp_solution(A, b, x, w, is_eq, lo, hi, 1e-7)


def test_jax_murty_matches_oracle(problems):
    lo = jnp.zeros(SIZE)
    hi = jnp.full(SIZE, jnp.inf)
    for A, b in problems[:10]:
        xo, wo, _ = lcp_oracle.murty_principal_pivot(A, b)
        x, w, ok = lcp_direct.murty_principal_pivot(
            jnp.asarray(A), jnp.asarray(b), lo, hi
        )
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(x), xo, atol=1e-7)
        np.testing.assert_allclose(np.asarray(w), wo, atol=1e-7)


def test_jax_mixed_matches_oracle(problems):
    rng = np.random.default_rng(3)
    for A, b in problems[:8]:
        is_eq = rng.uniform(size=SIZE) < 0.4
        lo = np.full(SIZE, -5.0)
        hi = np.full(SIZE, 5.0)
        xo, wo, oko = lcp_oracle.mixed_constraints_solver(A, b, is_eq, lo, hi)
        x, w, ok = lcp_direct.mixed_constraints_solver(
            jnp.asarray(A), jnp.asarray(b), jnp.asarray(is_eq),
            jnp.asarray(lo), jnp.asarray(hi),
        )
        assert bool(ok) == oko
        np.testing.assert_allclose(np.asarray(x), xo, atol=1e-6)


@pytest.mark.parametrize("method", ["pgs", "jacobi", "sor"])
def test_iterative_solvers_equality_only(problems, method):
    """Pure linear solve parity (ref sparse_iterations.cc:230-267 dense
    paths, all-equality C)."""
    # Diagonally dominant for guaranteed Jacobi convergence
    rng = np.random.default_rng(4)
    n = 24
    A = rng.uniform(-1, 1, (n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.uniform(-1, 1, n)
    is_eq = jnp.ones(n, dtype=bool)
    x = lcp.solve_lcp(
        jnp.asarray(A), jnp.asarray(b), is_eq, jnp.zeros(n), jnp.zeros(n),
        iters=500, method=method, check_tol=1e-12,
    )
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-8)


@pytest.mark.parametrize("method", ["pgs", "sor"])
def test_iterative_lcp_matches_direct(problems, method):
    """Projected iterations converge to the pivot solver's solution on
    well-conditioned SPD box LCPs (ref sparse_iterations.cc:515-748
    cross-checks dense vs matrix-free on the same systems)."""
    rng = np.random.default_rng(5)
    n = 30
    for trial in range(8):
        m = rng.uniform(-1, 1, (n, n))
        A = m @ m.T + 0.5 * n * np.eye(n)
        b = rng.uniform(-1, 1, n)
        is_eq = rng.uniform(size=n) < 0.5
        lo = np.where(is_eq, 0.0, -1.0)
        hi = np.where(is_eq, 0.0, 1.0)
        xo, wo, ok = lcp_oracle.mixed_constraints_solver(A, b, is_eq, lo, hi)
        assert ok
        x = lcp.solve_lcp(
            jnp.asarray(A), jnp.asarray(b), jnp.asarray(is_eq),
            jnp.asarray(lo), jnp.asarray(hi),
            iters=3000, method=method, check_tol=1e-11,
        )
        np.testing.assert_allclose(np.asarray(x), xo, atol=1e-6)


def test_residual_error_zero_at_solution(problems):
    A, b = problems[0]
    lo = np.zeros(SIZE)
    hi = np.full(SIZE, np.inf)
    x, w, _ = lcp_oracle.murty_principal_pivot(A, b, lo, hi)
    err = lcp.residual_error(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(x),
        jnp.zeros(SIZE, dtype=bool), jnp.asarray(lo), jnp.asarray(hi),
    )
    assert float(err) < 1e-7


def test_batched_solve(problems):
    B = 8
    A = jnp.stack([jnp.asarray(problems[i][0]) for i in range(B)])
    b = jnp.stack([jnp.asarray(problems[i][1]) for i in range(B)])
    is_eq = jnp.zeros((B, SIZE), dtype=bool)
    lo = jnp.zeros((B, SIZE))
    hi = jnp.full((B, SIZE), jnp.inf)
    xs = lcp.solve_lcp_batched(A, b, is_eq, lo, hi, iters=2000, method="pgs")
    for i in range(B):
        xo, _, _ = lcp_oracle.murty_principal_pivot(problems[i][0], problems[i][1])
        np.testing.assert_allclose(np.asarray(xs[i]), xo, atol=1e-5)


def test_implicit_diff_matches_unrolled():
    """Implicit-function-theorem gradients == unrolled-sweep gradients
    at convergence (checked against each other and finite differences)."""
    rng = np.random.default_rng(7)
    n = 12
    m = rng.uniform(-1, 1, (n, n))
    A = jnp.asarray(m @ m.T + n * np.eye(n))
    b0 = jnp.asarray(rng.uniform(-1, 1, n))
    is_eq = jnp.asarray(rng.uniform(size=n) < 0.3)
    lo = jnp.where(is_eq, 0.0, -0.5)
    hi = jnp.where(is_eq, 0.0, 0.8)

    def loss_unrolled(b):
        x = lcp.solve_lcp(A, b, is_eq, lo, hi, iters=400, method="pgs")
        return jnp.sum(x**3)

    def loss_implicit(b):
        x = lcp.solve_lcp_implicit(A, b, is_eq, lo, hi, 400, "pgs")
        return jnp.sum(x**3)

    g_un = jax.grad(loss_unrolled)(b0)
    g_im = jax.grad(loss_implicit)(b0)
    np.testing.assert_allclose(np.asarray(g_im), np.asarray(g_un), atol=1e-6)

    # finite differences on a few coordinates
    h = 1e-6
    for i in [0, 3, 7]:
        e = jnp.zeros(n).at[i].set(h)
        fd = (float(loss_unrolled(b0 + e)) - float(loss_unrolled(b0 - e))) / (
            2 * h
        )
        np.testing.assert_allclose(float(g_im[i]), fd, rtol=1e-4, atol=1e-6)

    # gradient wrt bounds flows to clamped rows
    def loss_hi(hh):
        x = lcp.solve_lcp_implicit(A, b0, is_eq, lo, hh, 400, "pgs")
        return jnp.sum(x**3)

    ghi = jax.grad(loss_hi)(hi)
    x = lcp.solve_lcp(A, b0, is_eq, lo, hi, iters=400)
    clamped_hi = np.asarray((~np.asarray(is_eq)) & (np.asarray(x) >= np.asarray(hi) - 1e-8))
    if clamped_hi.any():
        assert np.abs(np.asarray(ghi)[clamped_hi]).max() > 0
    assert np.abs(np.asarray(ghi)[~clamped_hi]).max() < 1e-10


def test_murty_fallback_best_so_far():
    """When the pivot budget is exhausted, the solver returns the
    best-so-far iterate by KKT "goodness" and flags it (the reference's
    fallback + lcp_debug.log record, eggshell/lcp.cc:107-137, 233-268)."""
    rng = np.random.default_rng(11)
    n = 40
    G = rng.normal(size=(n, n // 2))
    A = jnp.asarray(G @ G.T + 0.01 * np.eye(n))  # near-singular: many pivots
    b = jnp.asarray(rng.normal(size=n) * 5)
    lo = jnp.full(n, -0.5)
    hi = jnp.full(n, 0.5)

    x_full, _, info_full = lcp_direct.murty_principal_pivot(
        A, b, lo, hi, max_iterations=1024, return_info=True
    )
    assert bool(info_full.converged)
    assert float(info_full.goodness) == 0.0
    assert not bool(info_full.fallback_used)
    assert int(info_full.iterations) > 8  # genuinely hard problem

    budget = 4
    x, w, info = lcp_direct.murty_principal_pivot(
        A, b, lo, hi, max_iterations=budget, return_info=True
    )
    assert not bool(info.converged)
    assert bool(info.fallback_used)
    assert int(info.iterations) == budget
    g = float(info.goodness)
    assert np.isfinite(g) and g > 0
    # The returned solution must be at least as good as EVERY iterate the
    # budgeted run saw — in particular no worse than the first iterate
    # (S0 = all free, ref lcp.cc:176: x = A^-1 b, goodness = sum of
    # bound violations).
    x0 = np.linalg.solve(np.asarray(A, float), np.asarray(b, float))
    g_first = float(
        (np.maximum(-0.5 - x0, 0) + np.maximum(x0 - 0.5, 0)).sum()
    )
    assert g <= g_first + 1e-9

    # The legacy 3-tuple API still returns the fallback solution.
    x2, _, ok = lcp_direct.murty_principal_pivot(
        A, b, lo, hi, max_iterations=budget
    )
    assert not bool(ok)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x))


def test_murty_default_cap_reference_parity():
    """Default pivot budget = min(2^n, 1000) (ref eggshell/lcp.cc:168).

    Murty's exponential family M = I + 2 triu(1), b = 1 needs ~2^(n-1.5)
    pivots under the least-index rule this solver shares with the
    reference (measured: 342 pivots at n=10, 683 at n=11, 1366 at n=12)
    — the old fixed 256 cap gave up on n=10 while the reference oracle
    converged; the reference-parity default must solve it."""
    def murty_family(n):
        M = np.eye(n) + 2 * np.triu(np.ones((n, n)), 1)
        return (jnp.asarray(M), jnp.asarray(np.ones(n)),
                jnp.zeros(n), jnp.full(n, np.inf))

    A, b, lo, hi = murty_family(10)
    x, w, info = lcp_direct.murty_principal_pivot(
        A, b, lo, hi, return_info=True
    )
    assert bool(info.converged)
    assert int(info.iterations) > 256      # the old cap would have failed
    assert float(info.goodness) == 0.0

    # old cap reproduces the pre-fix failure (regression guard)
    _, _, info256 = lcp_direct.murty_principal_pivot(
        A, b, lo, hi, max_iterations=256, return_info=True
    )
    assert not bool(info256.converged)

    # n = 12 needs 1366 pivots > the 1000 cap: the default must stop at
    # the reference's budget and flag the fallback, exactly like the
    # oracle it is certified against.
    A, b, lo, hi = murty_family(12)
    _, _, info12 = lcp_direct.murty_principal_pivot(
        A, b, lo, hi, return_info=True
    )
    assert not bool(info12.converged)
    assert int(info12.iterations) == 1000


def test_mixed_solver_info_passthrough():
    rng = np.random.default_rng(12)
    n = 20
    m = rng.uniform(-1, 1, (n, n))
    A = jnp.asarray(m @ m.T + n * np.eye(n))
    b = jnp.asarray(rng.uniform(-1, 1, n))
    is_eq = jnp.asarray(rng.uniform(size=n) < 0.4)
    lo = jnp.where(is_eq, 0.0, -1.0)
    hi = jnp.where(is_eq, 0.0, 1.0)
    x, w, info = lcp_direct.mixed_constraints_solver(
        A, b, is_eq, lo, hi, return_info=True
    )
    assert bool(info.converged)
    assert float(info.goodness) == 0.0


@pytest.mark.parametrize("cfm", [1e-2, 1e-6])
def test_ift_adjoint_cholesky_matches_lu(cfm):
    """The Cholesky adjoint (the GPU's default) equals the pivoted-LU
    adjoint on a contact-like SPD system with clamped and free rows."""
    rng = np.random.default_rng(7)
    m = 24
    J = rng.normal(size=(m, 12))
    A = J @ J.T + cfm * np.eye(m)
    b = rng.normal(size=m)
    is_eq = np.arange(m) < 3
    lo = np.where(is_eq, -np.inf, np.where(np.arange(m) % 3 == 2, 0.0, -0.2))
    hi = np.where(is_eq, np.inf, np.where(np.arange(m) % 3 == 2, np.inf, 0.2))
    x = lcp.solve_lcp(jnp.asarray(A), jnp.asarray(b), jnp.asarray(is_eq),
                      jnp.asarray(lo), jnp.asarray(hi), iters=400,
                      method="pgs")
    g = jnp.asarray(rng.normal(size=m))
    args = [jnp.asarray(v) for v in (A, b, is_eq, lo, hi)] + [x, g]
    lu = lcp.ift_adjoint(*args, factorization="lu")
    ch = lcp.ift_adjoint(*args, factorization="cholesky")
    default = lcp.ift_adjoint(*args)
    for a, c, d in zip(lu, ch, default):
        np.testing.assert_allclose(np.asarray(c), np.asarray(a),
                                   rtol=1e-8, atol=1e-8)
        np.testing.assert_array_equal(np.asarray(d), np.asarray(a))
