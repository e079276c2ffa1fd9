"""On-device block-tridiagonal direct solver — block cyclic reduction
(BCR) in batched dense block operations.

The reference factors its FEM systems on the host with
Eigen::SimplicialLLT / SparseLU (toolkit/femsolver.h:134-135,
rama/solver.cc:1382-1422).  The on-device answer for banded orderings
(every `mesher.mesh_structured` mesh; any mesh with a small-bandwidth
node order) is to view A as BLOCK TRIDIAGONAL with dense (b, b) blocks
and run cyclic reduction: log2(nb) levels of batched dense block
inverses/matmuls — every operation a batched (b, b)
GEMM/solve, no host round-trip, no sparse gather/scatter in the hot
loop, and trivially batchable over right-hand sides and (via vmap)
frequencies.

Complexity O(nb * b^3 * log nb) FLOPs vs O(nb * b^3) for banded LU —
the log factor buys full per-level parallelism, the right trade on an
accelerator whose batched matrix units far outrun its scalar cores.

Differentiation: `solve` is wrapped in `lax.custom_linear_solve`, so
forward- and reverse-mode derivatives re-use BCR solves of the same
(symmetric) system — same contract as `fem.sparse.sparse_solve`.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


class BlockTridiagStructure:
    """Host-side static plan mapping COO triplets onto dense block
    bands.

    Given (rows, cols, n) and a block size b, nodes are grouped into
    nb = ceil(n / b) consecutive blocks.  Requires every entry to couple
    nodes at most one block apart (true whenever b >= the matrix
    bandwidth).  `from_bandwidth` picks the smallest legal b
    automatically.

    Scatter metadata sends triplet t to flat position `scatter[t]` of a
    (3, nb, b, b) band tensor: band 0 = diagonal D_i, band 1 = lower
    L_i (block i <- i-1), band 2 = upper U_i (block i <- i+1).
    Duplicate triplets accumulate (Eigen setFromTriplets semantics).
    """

    def __init__(self, rows, cols, num_rows: int, block_size: int,
                 order=None):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        n = int(num_rows)
        if order is not None:
            # solve the symmetrically permuted system P A P^T y = P b:
            # node `order[k]` maps to position k
            order = np.asarray(order, np.int64)
            pos = np.empty(n, np.int64)
            pos[order] = np.arange(n)
            rows = pos[rows]
            cols = pos[cols]
            self.order = jnp.asarray(order, jnp.int32)
            self.pos = jnp.asarray(pos, jnp.int32)
        else:
            self.order = None
            self.pos = None
        b = int(block_size)
        nb = -(-n // b)
        br = rows // b
        bc = cols // b
        d = bc - br
        if np.any(np.abs(d) > 1):
            raise ValueError(
                f"block size {b} too small: entries couple blocks "
                f"{int(np.abs(d).max())} apart"
            )
        # band index: 0 = diag, 1 = lower (bc = br-1), 2 = upper (bc = br+1)
        band = np.where(d == 0, 0, np.where(d < 0, 1, 2))
        rl = rows - br * b
        cl = cols - bc * b
        self.block_size = b
        self.num_rows = n
        self.num_blocks = int(nb)
        self.scatter = jnp.asarray(
            ((band * nb + br) * b + rl) * b + cl, jnp.int32
        )
        self._key = hash((rows.tobytes(), cols.tobytes(), n, b))

    @classmethod
    def from_bandwidth(cls, rows, cols, num_rows: int):
        bw = int(np.max(np.abs(np.asarray(rows, np.int64)
                               - np.asarray(cols, np.int64))))
        return cls(rows, cols, num_rows, max(bw, 1))

    @classmethod
    def auto(cls, rows, cols, num_rows: int):
        """Pick the cheaper of (native order, reverse-Cuthill-McKee
        reorder) by resulting bandwidth — RCM makes BCR practical on
        unstructured (distmesh) meshes whose native node order has no
        banded structure; structured meshes keep their native order."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        rows_a = np.asarray(rows, np.int64)
        cols_a = np.asarray(cols, np.int64)
        bw_native = int(np.max(np.abs(rows_a - cols_a)))
        A = sp.csr_matrix(
            (np.ones(len(rows_a)), (rows_a, cols_a)),
            shape=(num_rows, num_rows),
        )
        order = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        pos = np.empty(num_rows, np.int64)
        pos[order] = np.arange(num_rows)
        bw_rcm = int(np.max(np.abs(pos[rows_a] - pos[cols_a])))
        if bw_rcm < bw_native:
            return cls(rows, cols, num_rows, max(bw_rcm, 1), order=order)
        return cls(rows, cols, num_rows, max(bw_native, 1))

    def __hash__(self):
        return self._key

    def __eq__(self, other):
        return (
            isinstance(other, BlockTridiagStructure)
            and self._key == other._key
            and self.num_rows == other.num_rows
            and self.block_size == other.block_size
        )


def bands_from_coo(vals: jax.Array, structure: BlockTridiagStructure):
    """Scatter-accumulate COO values into dense (3, nb, b, b) bands."""
    nb, b = structure.num_blocks, structure.block_size
    flat = jnp.zeros((3 * nb * b * b,), vals.dtype)
    flat = flat.at[structure.scatter].add(vals)
    return flat.reshape(3, nb, b, b)


def _pad_blocks(D, L, U, f):
    """Pad the block count to 2^m - 1 with identity diagonal blocks
    (decoupled trailing equations with zero rhs)."""
    nb, b, _ = D.shape
    m = 1
    while (1 << m) - 1 < nb:
        m += 1
    nbp = (1 << m) - 1
    pad = nbp - nb
    if pad:
        eye = jnp.broadcast_to(jnp.eye(b, dtype=D.dtype), (pad, b, b))
        D = jnp.concatenate([D, eye], axis=0)
        z = jnp.zeros((pad, b, b), D.dtype)
        L = jnp.concatenate([L, z], axis=0)
        U = jnp.concatenate([U, z], axis=0)
        f = jnp.concatenate([f, jnp.zeros((pad,) + f.shape[1:], f.dtype)],
                            axis=0)
    return D, L, U, f, m, nbp


def _bcr_solve_padded(D, L, U, f, m):
    """Cyclic reduction on 2^m - 1 blocks.  f is (nbp, b, k) (k right-
    hand sides).  Returns x (nbp, b, k).

    All matmuls/solves run at HIGHEST precision: a reduced-precision
    product (bf16 passes, or TF32 on the GPU) destroys a direct solve
    (|S21| off by O(1) on a 56k-node Helmholtz system)."""
    with jax.default_matmul_precision("highest"):
        return _bcr_solve_padded_inner(D, L, U, f, m)


def _bcr_solve_padded_inner(D, L, U, f, m):
    # Reduction: at each level, eliminate the odd-position blocks.
    # Store the per-level odd-block data needed for back-substitution.
    levels = []
    for _ in range(m - 1):
        nb = D.shape[0]
        Do, Lo, Uo, fo = D[0::2], L[0::2], U[0::2], f[0::2]   # odd (0-based even idx = level-odd)
        De, Le, Ue, fe = D[1::2], L[1::2], U[1::2], f[1::2]
        # Solve A_odd^{-1} [L_odd | U_odd | f_odd] in one batched solve
        b = D.shape[1]
        k = f.shape[2]
        rhs = jnp.concatenate([Lo, Uo, fo], axis=2)           # (no, b, 2b+k)
        sol = jnp.linalg.solve(Do, rhs)
        AinvL, AinvU, Ainvf = sol[:, :, :b], sol[:, :, b:2 * b], sol[:, :, 2 * b:]
        levels.append((Ainvf, AinvL, AinvU))
        # Even rows couple to odd neighbours i-1 (index j) and i+1 (j+1)
        D = De - Le @ AinvU[:-1] - Ue @ AinvL[1:]
        fnew = fe - Le @ Ainvf[:-1] - Ue @ Ainvf[1:]
        L = -(Le @ AinvL[:-1])
        U = -(Ue @ AinvU[1:])
        f = fnew
    # Single block left
    x = jnp.linalg.solve(D[0], f[0])[None]
    # Back-substitution: eliminated unknowns at each level are
    # x_e = Ainvf - AinvL x_left - AinvU x_right (absent neighbours have
    # structurally zero AinvL[0] / AinvU[-1]).
    for Ainvf, AinvL, AinvU in reversed(levels):
        xo = Ainvf
        xo = xo.at[1:].add(-AinvL[1:] @ x)       # left kept neighbour
        xo = xo.at[:-1].add(-AinvU[:-1] @ x)     # right kept neighbour
        nb_new = xo.shape[0] + x.shape[0]
        merged = jnp.zeros((nb_new,) + xo.shape[1:], xo.dtype)
        merged = merged.at[0::2].set(xo)
        merged = merged.at[1::2].set(x)
        x = merged
    return x


def block_tridiag_solve_bands(D, L, U, rhs):
    """Solve the block-tridiagonal system given bands directly.
    D/L/U (nb, b, b); rhs (nb*b,) or (nb*b, k).  L[0] and U[-1] are
    ignored (no neighbours)."""
    nb, b, _ = D.shape
    single = rhs.ndim == 1
    f = rhs.reshape(nb, b, -1)
    Dp, Lp, Up, fp, m, _ = _pad_blocks(D, L, U, f)
    x = _bcr_solve_padded(Dp, Lp, Up, fp, m)[:nb]
    x = x.reshape(nb * b, -1)
    return x[:, 0] if single else x


@functools.partial(jax.jit, static_argnames=("structure",))
def block_tridiag_solve(vals, rhs, structure: BlockTridiagStructure,
                        vals_transpose=None):
    """Solve A x = rhs with A given as COO triplets on a banded
    ordering — fully on-device, differentiable via
    `lax.custom_linear_solve` (tangents/cotangents re-use BCR solves of
    the same system; our FEM matrices are complex symmetric, so the
    default transpose solve is the forward solve).  For NON-symmetric
    systems pass `vals_transpose` (the values of A^T on the same
    sparsity pattern as seen through `structure`'s scatter) and the
    transpose solve runs BCR on those bands instead.  Pads the trailing
    partial block with unit diagonal entries."""
    nb, b = structure.num_blocks, structure.block_size
    n = structure.num_rows
    npad = nb * b

    # The linear operator for custom_linear_solve runs through the dense
    # bands (identical to the COO operator, already on device).
    def matvec_bands(bands, x):
        xp = jnp.zeros((npad,), x.dtype).at[:n].set(x).reshape(nb, b, 1)
        y = bands[0] @ xp
        y = y.at[1:].add(bands[1][1:] @ xp[:-1])
        y = y.at[:-1].add(bands[2][:-1] @ xp[1:])
        return y.reshape(npad)[:n]

    def padded_bands(v):
        bands = bands_from_coo(v, structure)
        # unit diagonal on padded rows of the last partial block so the
        # padded system is nonsingular
        if npad > n:
            pad_idx = jnp.arange(n, npad)
            bl = pad_idx // b
            rl = pad_idx - bl * b
            bands = bands.at[0, bl, rl, rl].add(1.0)
        return bands

    bands = padded_bands(vals)

    def solve_with(bands_):
        def solve(_mv, rhs_):
            rp = jnp.zeros((npad,), rhs_.dtype).at[:n].set(rhs_)
            x = block_tridiag_solve_bands(
                bands_[0], bands_[1], bands_[2], rp
            )
            return x[:n]

        return solve

    solve = solve_with(bands)
    if vals_transpose is None:
        solve_t = solve
        symmetric = True
    else:
        solve_t = solve_with(padded_bands(vals_transpose))
        symmetric = False

    matvec = functools.partial(matvec_bands, bands)
    if structure.order is None:
        return jax.lax.custom_linear_solve(
            matvec, rhs, solve, transpose_solve=solve_t,
            symmetric=symmetric,
        )
    y = jax.lax.custom_linear_solve(
        matvec, rhs[structure.order], solve, transpose_solve=solve_t,
        symmetric=symmetric,
    )
    return y[structure.pos]
