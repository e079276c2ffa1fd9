"""Sparse linear algebra for the FEM tier — the scalable-solve analog of
the reference's triplet assembly + SimplicialLLT/SparseLU factorization
(toolkit/femsolver.h:134-135, 255-310; rama/solver.cc HelmholtzFEMProblem
Factorizer = Eigen::SparseLU<SparseMatrix<complex>, COLAMD>).

Design: the sparsity STRUCTURE (rows/cols) is host-side static metadata;
the VALUES are a traced jnp array, so assembly stays a pure, jit-able,
differentiable function of the mesh geometry and materials.  The solve
is `lax.custom_linear_solve` around a host scipy SuperLU factorization
(`jax.pure_callback`) — XLA sees an opaque linear solve with exact
forward- and reverse-mode derivatives via the implicit function theorem
(solve / transpose-solve of the same factorized system), no
differentiation through the factorization itself.

For moderate systems, `coo_to_dense` + `jnp.linalg.solve` keeps the
whole pipeline on-device (the dense path); `sparse_solve` takes over when
N makes the dense (N, N) factor infeasible.  `coo_matvec` supports
on-device iterative solves (jax.scipy BiCGStab/GMRES) where host
round-trips are unwanted.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


def coo_matvec(rows, cols, vals, x, num_rows: int):
    """y = A x for COO (rows, cols, vals); duplicate entries accumulate
    (triplet semantics, like Eigen setFromTriplets)."""
    contrib = vals * x[cols]
    return jax.ops.segment_sum(contrib, rows, num_segments=num_rows)


def coo_to_dense(rows, cols, vals, num_rows: int):
    """Densify the triplets (duplicates accumulate)."""
    A = jnp.zeros((num_rows, num_rows), vals.dtype)
    return A.at[rows, cols].add(vals)


def _host_splu_solve(rows, cols, n):
    """Host factor+solve: scipy SuperLU (the very algorithm family the
    reference's Eigen::SparseLU implements).  rows/cols are captured as
    static numpy metadata; only (vals, b) cross the callback."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    rows = np.asarray(rows)
    cols = np.asarray(cols)

    def solve(vals, b):
        vals = np.asarray(vals)
        b = np.asarray(b)
        # factor in f64/c128 regardless of the traced dtype
        hdtype = np.complex128 if np.iscomplexobj(vals) else np.float64
        A = sp.csc_matrix(
            (vals.astype(hdtype), (rows, cols)), shape=(n, n)
        )
        lu = spla.splu(A)
        return lu.solve(b.astype(hdtype)).astype(b.dtype)

    return solve


def sparse_solve(rows, cols, vals, b, num_rows: int, symmetric: bool = True):
    """Solve A x = b with A given as COO triplets (duplicates accumulate).

    Differentiable in `vals` and `b` (forward and reverse) through
    `lax.custom_linear_solve`: tangents/cotangents re-use solves of the
    same system — the analog of the reference propagating jets
    through its sparse solve (rama/solver.h:272-277).

    `symmetric=True` (our FEM matrices: K, M, and boundary-mass terms are
    all symmetric, even with the sigma_xy cross term) lets the transpose
    solve reuse the forward factorization path.
    """
    return sparse_solve_structured(
        vals, b, SparseStructure(rows, cols, num_rows), symmetric
    )


class SparseStructure:
    """Pre-hashed COO structure so repeated solves with the same sparsity
    don't re-tuple-ify the index arrays (jit cache key = object id via
    static hashing of the tuples is expensive for 100k+ nnz)."""

    def __init__(self, rows, cols, num_rows: int):
        self.rows = np.ascontiguousarray(np.asarray(rows, np.int32))
        self.cols = np.ascontiguousarray(np.asarray(cols, np.int32))
        self.num_rows = int(num_rows)
        self._key = hash(
            (self.rows.tobytes(), self.cols.tobytes(), self.num_rows)
        )

    def __hash__(self):
        return self._key

    def __eq__(self, other):
        return (
            isinstance(other, SparseStructure)
            and self.num_rows == other.num_rows
            and np.array_equal(self.rows, other.rows)
            and np.array_equal(self.cols, other.cols)
        )


@functools.partial(jax.jit, static_argnames=("structure", "symmetric"))
def sparse_solve_structured(vals, b, structure: SparseStructure,
                            symmetric: bool = True):
    """`sparse_solve` keyed on a SparseStructure (fast jit cache hits for
    repeated solves on the same mesh — the sweep/optimize loop)."""
    host_solve = _host_splu_solve(
        structure.rows, structure.cols, structure.num_rows
    )
    host_solve_t = _host_splu_solve(
        structure.cols, structure.rows, structure.num_rows
    )
    rows_j = jnp.asarray(structure.rows)
    cols_j = jnp.asarray(structure.cols)
    n = structure.num_rows

    def matvec(x):
        return coo_matvec(rows_j, cols_j, vals, x, n)

    out_spec = jax.ShapeDtypeStruct(b.shape, b.dtype)

    def solve(_mv, rhs):
        return jax.pure_callback(
            host_solve, out_spec, vals, rhs, vmap_method="sequential"
        )

    def solve_t(_mv, rhs):
        return jax.pure_callback(
            host_solve_t, out_spec, vals, rhs, vmap_method="sequential"
        )

    return jax.lax.custom_linear_solve(
        matvec, b, solve,
        transpose_solve=solve if symmetric else solve_t,
        symmetric=symmetric,
    )


@functools.partial(
    jax.jit, static_argnames=("structure", "tol", "maxiter")
)
def bicgstab_solve_structured(vals, b, structure: SparseStructure,
                              tol: float = 1e-8, maxiter: int = 2000):
    """Fully on-device driven solve: Jacobi-preconditioned BiCGStab on
    the COO matvec, wrapped in `lax.custom_linear_solve` so forward and
    reverse derivatives re-use iterative solves of the same (symmetric)
    system — the no-host-callback counterpart of
    `sparse_solve_structured` (ref factor+solve,
    toolkit/femsolver.h:134-135; our matrices are complex symmetric, so
    the transpose solve is the same solve)."""
    rows_j = jnp.asarray(structure.rows)
    cols_j = jnp.asarray(structure.cols)
    n = structure.num_rows
    diag = jax.ops.segment_sum(
        jnp.where(rows_j == cols_j, vals, 0.0), rows_j, num_segments=n
    )
    diag = jnp.where(jnp.abs(diag) > 0, diag, 1.0)

    def matvec(x):
        return coo_matvec(rows_j, cols_j, vals, x, n)

    def solve(mv, rhs):
        x, _ = jax.scipy.sparse.linalg.bicgstab(
            mv, rhs, M=lambda y: y / diag, tol=tol, maxiter=maxiter
        )
        return x

    return jax.lax.custom_linear_solve(
        matvec, b, solve, transpose_solve=solve, symmetric=True
    )


def bicgstab_solve(rows, cols, vals, b, num_rows: int, tol=1e-8,
                   maxiter=2000):
    """Fully on-device iterative solve (Jacobi-preconditioned BiCGStab)
    for deployments where host callbacks are unavailable; complements the
    factorized path (first-order ABC/port losses keep the Helmholtz
    matrices non-Hermitian but reasonably conditioned at moderate k h)."""
    rows = jnp.asarray(rows)
    cols = jnp.asarray(cols)
    diag = jax.ops.segment_sum(
        jnp.where(rows == cols, vals, 0.0), rows, num_segments=num_rows
    )
    diag = jnp.where(jnp.abs(diag) > 0, diag, 1.0)

    def matvec(x):
        return coo_matvec(rows, cols, vals, x, num_rows)

    x, _ = jax.scipy.sparse.linalg.bicgstab(
        matvec, b, M=lambda x: x / diag, tol=tol, maxiter=maxiter
    )
    return x


def coo_matmat(rows, cols, vals, X, num_rows: int):
    """Y = A X for COO triplets and a block of vectors X (n, k)."""
    contrib = vals[:, None] * X[cols]
    return jax.ops.segment_sum(contrib, rows, num_segments=num_rows)


def lobpcg_generalized(rows, cols, kvals, mvals, num_rows: int,
                       num_modes: int, iters: int = 120, seed: int = 0,
                       cg_iters: int = 25):
    """Sparse generalized LOBPCG: smallest eigenpairs of K x = lambda M x
    entirely from COO matvecs — O(nnz + n*k) memory, never densifies
    (the on-device eigen tier; ref toolkit/eigensolvers.h:66-150 runs
    host ARPACK shift-invert for the same problem).

    Residuals are preconditioned by a FIXED-iteration Jacobi-CG
    approximate solve of K W = R (`cg_iters` sweeps, lax.fori_loop) —
    a polynomial preconditioner that keeps the outer convergence rate
    mesh-size-robust where a bare diag(K) Jacobi preconditioner stalls
    on >10k-node Laplacians (diag(K) is near-constant on a uniform
    mesh, so it preconditions nothing).  Block Rayleigh-Ritz on
    [X, W, P] with M-orthonormalization via eigh of the (3k, 3k) Gram
    matrix.  Fixed iteration counts (compiler-friendly); accuracy of
    the smallest modes is gated by
    tests/test_fem.py::test_modes_lobpcg_matches_arpack and the
    50k-node scale test in tests/test_fem_sparse.py.
    """
    rows = jnp.asarray(rows)
    cols = jnp.asarray(cols)
    kvals = jnp.asarray(kvals)
    mvals = jnp.asarray(mvals)
    n = num_rows
    # guard vectors: iterate a larger block than requested — the extra
    # columns absorb the slow convergence of the highest wanted mode
    # (standard LOBPCG practice)
    k = min(num_modes + max(2, num_modes // 2), max(num_rows - 1, 1))

    diagK = jax.ops.segment_sum(
        jnp.where(rows == cols, kvals, 0.0), rows, num_segments=n
    )
    diagK = jnp.where(jnp.abs(diagK) > 0, diagK, 1.0)
    diagM = jax.ops.segment_sum(
        jnp.where(rows == cols, mvals, 0.0), rows, num_segments=n
    )

    Kmm = lambda X: coo_matmat(rows, cols, kvals, X, n)
    Mmm = lambda X: coo_matmat(rows, cols, mvals, X, n)

    # Neumann/free-mode guard (ADVICE r3): without Dirichlet rows K has
    # a constant nullspace, so the inner system K W = R is inconsistent
    # (R carries a theta*M*X null component) and fixed-iteration CG can
    # amplify the null direction.  Precondition with the strictly-SPD
    # K + sigma*M instead — as a PREconditioner the shift only perturbs
    # the convergence rate, while bounding the solve against null-space
    # blowup; sigma is scaled to sit well below the first nonzero
    # eigenvalue estimate (diag ratio ~ the matrix's spectral scale).
    sigma_pc = 1e-4 * jnp.max(jnp.abs(diagK)) / jnp.maximum(
        jnp.max(jnp.abs(diagM)), jnp.finfo(jnp.asarray(diagM).dtype).tiny
    )
    Amm = lambda X: Kmm(X) + sigma_pc * Mmm(X)
    diagA = diagK + sigma_pc * diagM

    def m_orthonormalize(S):
        # eigh-based M-orthonormalization: robust to rank-deficient
        # blocks (P starts at zero; converged W columns go null).  Dead
        # directions (Gram eigenvalue ~ 0) are zeroed and flagged so the
        # Ritz step can exclude them with a large diagonal penalty —
        # fixed shapes, no dynamic rank.
        G = S.T @ Mmm(S)
        G = 0.5 * (G + G.T)
        w, V = jnp.linalg.eigh(G)
        good = w > 1e-10 * jnp.max(jnp.abs(w))
        scale = jnp.where(good, 1.0 / jnp.sqrt(jnp.where(good, w, 1.0)), 0.0)
        return (S @ V) * scale[None, :], good

    X = jnp.asarray(
        np.random.default_rng(seed).normal(size=(n, k))
    ).astype(kvals.dtype)
    X, _ = m_orthonormalize(X)
    P = jnp.zeros_like(X)

    def precond(R):
        # fixed-iteration Jacobi-preconditioned CG on (K + sigma M) W = R
        # (see sigma_pc above), batched over the block columns.  Safe
        # divisions: a converged (zero) residual column just stops
        # moving.
        x0 = jnp.zeros_like(R)
        r0 = R
        z0 = r0 / diagA[:, None]
        rz0 = jnp.sum(r0 * z0, axis=0)

        def cg_body(i, c):
            x, r, p, rz = c
            Kp = Amm(p)
            pKp = jnp.sum(p * Kp, axis=0)
            alpha = jnp.where(pKp > 0, rz / jnp.where(pKp > 0, pKp, 1.0),
                              0.0)
            x = x + p * alpha[None, :]
            r = r - Kp * alpha[None, :]
            z = r / diagA[:, None]
            rz_new = jnp.sum(r * z, axis=0)
            beta = jnp.where(rz > 0, rz_new / jnp.where(rz > 0, rz, 1.0),
                             0.0)
            p = z + p * beta[None, :]
            return x, r, p, rz_new

        x, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body,
                                       (x0, r0, z0, rz0))
        return x

    def body(i, carry):
        X, P = carry
        KX = Kmm(X)
        MX = Mmm(X)
        theta = jnp.sum(X * KX, axis=0)       # X is M-orthonormal
        R = KX - MX * theta[None, :]
        W = precond(R)
        S = jnp.concatenate([X, W, P], axis=1)
        S, good = m_orthonormalize(S)
        A = S.T @ Kmm(S)
        A = 0.5 * (A + A.T)
        # dead columns -> +inf-ish diagonal so the smallest-k Ritz
        # selection never picks them
        big = 1e30 * jnp.max(jnp.abs(jnp.diagonal(A))) + 1.0
        A = A + jnp.diag(jnp.where(good, 0.0, big))
        evals, Y = jnp.linalg.eigh(A)
        Yk = Y[:, :k]
        Xn = S @ Yk
        # P = the W+P contribution to the new X (Knyazev's update)
        Pn = S[:, k:] @ Yk[k:, :]
        return Xn, Pn

    X, _ = jax.lax.fori_loop(0, iters, body, (X, P))
    KX = Kmm(X)
    theta = jnp.sum(X * KX, axis=0) / jnp.sum(X * Mmm(X), axis=0)
    order = jnp.argsort(theta)
    return theta[order][:num_modes], X[:, order][:, :num_modes]


def shift_invert_modes(rows, cols, kvals, mvals, num_rows: int,
                       num_modes: int, iters: int = 20, seed: int = 0,
                       sigma: float = None, guard: int = None):
    """On-device shift-invert subspace iteration — the direct analog of
    the reference eigensolver (toolkit/eigensolvers.h:66-150: ARPACK
    dsaupd in shift-invert mode around a SimplicialLDLT factorization),
    with the banded BCR direct solve (fem/block_tridiag) playing the
    factorization's role.

    Each sweep applies (K - sigma M)^-1 M to the block via one
    multi-RHS BCR solve, M-orthonormalizes, and Rayleigh-Ritz-rotates
    on K — geometric convergence at ratio lambda_i/lambda_{block+1}
    per sweep, which is what makes it robust for CLUSTERED/DEGENERATE
    higher modes where the polynomial-preconditioned LOBPCG
    (`lobpcg_generalized`) stalls (measured round 5: rectangle modes
    5/6 are near-degenerate; LOBPCG rel err ~1.3 at 6 modes on a 16k
    distmesh, this path < 1e-3 in 20 sweeps).

    Host-side static work: RCM bandwidth reduction (structure.auto).
    Device work: bands scatter, BCR sweeps, COO matvecs, (k, k) eighs.
    Returns (eigenvalues (num_modes,), eigenvectors (n, num_modes)).
    """
    from eggshell_tpu.fem import block_tridiag as bt

    n = int(num_rows)
    k = num_modes + (max(4, num_modes) if guard is None else guard)
    k = min(k, max(n - 1, 1))
    kvals = jnp.asarray(kvals)
    mvals = jnp.asarray(mvals)
    if sigma is None:
        # auto NEGATIVE shift: factor A = K + s M with s well below the
        # first nonzero eigenvalue (diag-ratio spectral scale).  Keeps
        # the factorized operator SPD even when K is singular
        # (dirichlet=False: the constant Neumann nullspace), exactly
        # like the host path's sigma=1e-6 eigsh shift; eigenvectors are
        # unchanged and theta is computed from the UNSHIFTED K below.
        # the diag ratio tracks lambda_max (~1/h^2), NOT lambda_1 —
        # round-5 measurement: s = 1e-3*scale (~8x lambda_6 at a 16k
        # distmesh) compressed the wanted spectrum and stalled
        # convergence at ~4% rel err; 1e-6*scale still dominates the
        # Neumann null eigenvalue (0) for a nonsingular SPD factor
        # while sitting far below lambda_1 (no slowdown).
        diag = np.asarray(rows) == np.asarray(cols)
        scale = float(np.max(np.abs(np.asarray(kvals)[diag]))) / max(
            float(np.max(np.abs(np.asarray(mvals)[diag]))),
            np.finfo(np.float64).tiny,
        )
        sigma = -1e-6 * scale
    avals = kvals - sigma * mvals if sigma else kvals

    structure = bt.BlockTridiagStructure.auto(rows, cols, n)
    nb, b = structure.num_blocks, structure.block_size
    npad = nb * b
    bands = bt.bands_from_coo(avals, structure)
    if npad > n:
        pad_idx = jnp.arange(n, npad)
        bl, rl = pad_idx // b, pad_idx % b
        bands = bands.at[0, bl, rl, rl].add(1.0)

    perm = structure.order          # node order[j] sits at position j
    pos = structure.pos

    def inv_apply(X):               # (n, k) -> (K - sigma M)^-1 X
        Xp = jnp.zeros((npad, X.shape[1]), X.dtype)
        Xp = Xp.at[:n].set(X[perm] if perm is not None else X)
        Y = bt.block_tridiag_solve_bands(bands[0], bands[1], bands[2], Xp)
        Y = Y[:n]
        return Y[pos] if pos is not None else Y

    Kmm = lambda X: coo_matmat(rows, cols, kvals, X, n)
    Mmm = lambda X: coo_matmat(rows, cols, mvals, X, n)

    def m_orthonormalize(S):
        G = S.T @ Mmm(S)
        G = 0.5 * (G + G.T)
        w, V = jnp.linalg.eigh(G)
        good = w > 1e-10 * jnp.max(jnp.abs(w))
        scale = jnp.where(good, 1.0 / jnp.sqrt(jnp.where(good, w, 1.0)),
                          0.0)
        return (S @ V) * scale[None, :]

    X = jnp.asarray(
        np.random.default_rng(seed).normal(size=(n, k))
    ).astype(kvals.dtype)

    with jax.default_matmul_precision("highest"):
        X = m_orthonormalize(X)

        def body(i, X):
            Y = inv_apply(Mmm(X))
            Y = m_orthonormalize(Y)
            A = Y.T @ Kmm(Y)
            A = 0.5 * (A + A.T)
            _, V = jnp.linalg.eigh(A)
            return Y @ V

        X = jax.lax.fori_loop(0, iters, body, X)
        KX = Kmm(X)
        theta = jnp.sum(X * KX, axis=0) / jnp.sum(X * Mmm(X), axis=0)
        order = jnp.argsort(theta)
    return theta[order][:num_modes], X[:, order][:, :num_modes]
