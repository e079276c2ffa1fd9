"""Direct (pivoting) LCP solvers on-device — the reference-accuracy path.

JIT-able Murty principal pivot and Schur-complement mixed solver with
*fixed shapes*: the active set is a boolean mask and the per-pivot
sub-solve A(S,S) x_S = b_S is expressed as a full-size masked linear
system, so every iteration is one n x n `linalg.solve` on the device —
no dynamic index sets (vs. ref eggshell/lcp.cc:202-206 which gathers a
shrinking submatrix).

Intended for moderate n (tens to ~200 rows) where an exact
complementarity solution is wanted on-device: solver certification
tests, stiff scenes where PGS stalls, and accuracy references for the
iterative path.  vmap over a batch of QPs works (each lane runs the
same fixed iteration count).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class LcpInfo(NamedTuple):
    """Solver-failure observability record (ref eggshell/lcp.cc:107-137
    best-so-far "goodness" tracking + :233-268 failure diagnostics).

    converged      exact complementarity solution found
    iterations     pivots spent
    goodness       total KKT violation of the RETURNED solution (0 when
                   converged); the reference's sum-of-negative-parts
    fallback_used  the returned x/w is the best-so-far iterate, not the
                   final one (only possible when not converged)
    """

    converged: jax.Array
    iterations: jax.Array
    goodness: jax.Array
    fallback_used: jax.Array


def _goodness(x, w, S, side, lo, hi):
    """Sum of KKT violation magnitudes (the reference's "goodness" —
    lower is better, 0 = solved; eggshell/lcp.cc:107-137 sums the
    negative parts of the complementarity conditions)."""
    free_viol = jnp.where(S, jnp.maximum(lo - x, 0) + jnp.maximum(x - hi, 0), 0.0)
    at_lo = (~S) & (side == lo)
    at_hi = (~S) & (side == hi)
    clamp_viol = jnp.where(at_lo, jnp.maximum(-w, 0), 0.0) + jnp.where(
        at_hi, jnp.maximum(w, 0), 0.0
    )
    return jnp.sum(free_viol + clamp_viol)


def _masked_solve(A, rhs, S):
    """Solve A_SS x_S = rhs_S embedded in full size: rows/cols outside S
    are replaced by identity with zero rhs."""
    n = A.shape[0]
    SS = S[:, None] & S[None, :]
    eye = jnp.eye(n, dtype=A.dtype)
    M = jnp.where(SS, A, eye)
    return jnp.linalg.solve(M, jnp.where(S, rhs, 0.0))


@functools.partial(
    jax.jit, static_argnames=("max_iterations", "return_info")
)
def murty_principal_pivot(A, b, lo, hi, max_iterations: int = None,
                          return_info: bool = False):
    """Box-LCP principal pivoting (semantics of eggshell/lcp.cc:157-274).

    One offending index is flipped per pivot, scanning rows in order and
    taking the first violation — matching the reference's update rule
    (CheckMurtySolution, lcp.cc:36-62).  Tracks the best-so-far iterate
    by "goodness" and returns it on non-convergence (the reference's
    fallback, lcp.cc:107-137, 233-268) instead of the last iterate.

    `max_iterations=None` (default) uses the reference's pivot budget
    min(2^n, 1000) (eggshell/lcp.cc:168) — n is static under jit.

    Returns (x, w, converged); with return_info=True the third element
    is an `LcpInfo` (converged, iterations, goodness, fallback_used).
    """
    n = b.shape[0]
    if max_iterations is None:
        max_iterations = min(2 ** min(n, 10), 1000)
    dtype = A.dtype

    def compute_xw(S, side):
        xfix = jnp.where(S, 0.0, side)
        rhs = b - A @ xfix
        xs = _masked_solve(A, rhs, S)
        x = jnp.where(S, xs, side)
        w = jnp.where(S, 0.0, A @ x - b)
        return x, w

    def violation(S, side, x, w):
        """First offending index, encoded as (idx, action, value);
        idx = n means no violation."""
        pin_lo = S & (x < lo)
        pin_hi = S & (x > hi)
        free_lo = (~S) & (side == lo) & (w < 0)
        free_hi = (~S) & (side == hi) & (w > 0)
        any_v = pin_lo | pin_hi | free_lo | free_hi
        idx = jnp.argmax(any_v)  # first True (argmax of bool)
        has = jnp.any(any_v)
        idx = jnp.where(has, idx, n)
        return idx, pin_lo, pin_hi

    def body(carry):
        S, side, x, w, best, i, _ = carry
        x, w = compute_xw(S, side)
        g = _goodness(x, w, S, side, lo, hi)
        bx, bw, bg = best
        better = g < bg
        best = (
            jnp.where(better, x, bx),
            jnp.where(better, w, bw),
            jnp.where(better, g, bg),
        )
        idx, pin_lo, pin_hi = violation(S, side, x, w)
        done = idx >= n
        onehot = jnp.arange(n) == idx
        new_S = jnp.where(onehot, ~S, S)
        new_side = jnp.where(
            onehot & pin_lo, lo, jnp.where(onehot & pin_hi, hi, side)
        )
        S = jnp.where(done, S, new_S)
        side = jnp.where(done, side, new_side)
        return S, side, x, w, best, i + 1, done

    def cond(carry):
        _, _, _, _, _, i, done = carry
        return (~done) & (i < max_iterations)

    S0 = jnp.ones(n, dtype=bool)  # ref lcp.cc:176
    side0 = jnp.asarray(jnp.broadcast_to(lo, (n,)), dtype)
    x0 = jnp.zeros(n, dtype)
    w0 = -b
    best0 = (x0, w0, jnp.asarray(jnp.inf, dtype))
    S, side, x, w, best, iters, done = jax.lax.while_loop(
        cond, body, (S0, side0, x0, w0, best0, 0, jnp.asarray(False))
    )
    # Converged: the body's (x, w) is the certified solution.  Not
    # converged: fall back to the best-so-far iterate by goodness
    # (ref lcp.cc:233-268 — "use the best solution found so far").
    bx, bw, bg = best
    xf, wf = compute_xw(S, side)  # last iterate (if loop hit the cap)
    gf = _goodness(xf, wf, S, side, lo, hi)
    last_better = gf < bg
    x_fb = jnp.where(last_better, xf, bx)
    w_fb = jnp.where(last_better, wf, bw)
    g_fb = jnp.where(last_better, gf, bg)
    x = jnp.where(done, x, x_fb)
    w = jnp.where(done, w, w_fb)
    if not return_info:
        return x, w, done
    info = LcpInfo(
        converged=done,
        iterations=iters,
        goodness=jnp.where(done, 0.0, g_fb),
        fallback_used=~done,
    )
    return x, w, info


@functools.partial(
    jax.jit, static_argnames=("max_iterations", "return_info")
)
def mixed_constraints_solver(A, b, is_eq, lo, hi, max_iterations: int = None,
                             return_info: bool = False):
    """Masked Schur-complement mixed solver (semantics of
    eggshell/lcp.cc:276-336) with fixed shapes.

    Equality rows E are eliminated through a masked inverse:
    Schur = A_II - A_IE A_EE^-1 A_EI is computed full-size with
    identity padding on I rows/cols of A_EE.  Returns (x, w, converged).
    """
    n = b.shape[0]
    E = is_eq
    I = ~E
    eye = jnp.eye(n, dtype=A.dtype)

    # Masked A_EE^{-1}: identity on I rows/cols.
    EE = E[:, None] & E[None, :]
    A_ee_full = jnp.where(EE, A, eye)
    # A_EI columns restricted to I, rows to E
    A_ei = jnp.where(E[:, None] & I[None, :], A, 0.0)
    A_ie = jnp.where(I[:, None] & E[None, :], A, 0.0)
    A_ii = jnp.where(I[:, None] & I[None, :], A, 0.0)

    Aee_inv_Aei = jnp.linalg.solve(A_ee_full, A_ei)
    Aee_inv_be = jnp.linalg.solve(A_ee_full, jnp.where(E, b, 0.0))

    schur = A_ii - A_ie @ Aee_inv_Aei
    # I-lanes of the LCP need a nonsingular diagonal on E rows: identity.
    schur = jnp.where(I[:, None] & I[None, :], schur, eye)
    rhs = jnp.where(I, b - A_ie @ Aee_inv_be, 0.0)

    # Box-LCP on the I block; E lanes have lo=hi=0 -> pinned at 0 is a
    # valid solution lane (identity row, rhs 0).
    lo_i = jnp.where(I, lo, -1.0)
    hi_i = jnp.where(I, hi, 1.0)
    x_i, w_i, ok = murty_principal_pivot(
        schur, rhs, lo_i, hi_i, max_iterations=max_iterations,
        return_info=return_info,
    )
    x_i = jnp.where(I, x_i, 0.0)

    # Back-substitute x_E = A_EE^{-1}(b_E - A_EI x_I)
    x_e = jnp.linalg.solve(A_ee_full, jnp.where(E, b - A_ei @ x_i, 0.0))
    x = jnp.where(E, x_e, x_i)
    w = jnp.where(E, 0.0, jnp.where(I, w_i, 0.0))
    return x, w, ok


# ---------------------------------------------------------------------------
# Differentiable wrapper (implicit-function-theorem VJP)


@jax.custom_vjp
def mixed_constraints_solver_implicit(A, b, is_eq, lo, hi):
    """`mixed_constraints_solver` with a reverse-mode VJP.

    The pivoting forward pass runs a lax.while_loop (not reverse-
    differentiable), but at the solution the active set is fixed, so the
    backward pass is the same one-adjoint-solve IFT rule the iterative
    path uses (ops/lcp.ift_adjoint, OptNet-style) — making
    SolverKind.DIRECT usable inside jax.grad like every other solver
    (the reference's my_jet.h has no derivatives through its LCP at all;
    SURVEY §7 step 6 makes the whole step differentiable).  Returns x
    only (use the plain solver for (x, w, info))."""
    x, _, _ = mixed_constraints_solver(A, b, is_eq, lo, hi)
    return x


def _mci_fwd(A, b, is_eq, lo, hi):
    x = mixed_constraints_solver_implicit(A, b, is_eq, lo, hi)
    return x, (A, b, is_eq, lo, hi, x)


def _mci_bwd(res, g):
    from eggshell_tpu.ops import lcp as _lcp

    A, b, is_eq, lo, hi, x = res
    gA, gb, glo, ghi = _lcp.ift_adjoint(A, b, is_eq, lo, hi, x, g)
    return gA, gb, None, glo, ghi


mixed_constraints_solver_implicit.defvjp(_mci_fwd, _mci_bwd)
