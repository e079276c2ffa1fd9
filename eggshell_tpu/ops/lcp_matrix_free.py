"""Matrix-free projected iterations for LARGE single scenes.

The reference's sparse_iterations_utils builds each JMJ^T block on the
fly from per-constraint Jacobians and 6x6 M^-1 blocks instead of
forming the dense system (eggshell/sparse_iterations_utils.cc:67-373,
CalculateSparseJMJtX :624-695).  The dense (m, m) formation used by the
batched benchmark scenes is ideal for thousands of SMALL QPs, but a
single scene with hundreds of bodies (the living-room clutter scaled
up) wants the matrix-free form: memory O(K) instead of O(K^2), and the
matvec is two segment-sums plus per-body 6x6 applications.

Representation: compact per-lane blocks — each constraint lane k
contributes 3 rows that touch at most two bodies:

  blocks (K, 3, 12): columns 0:6 = slot0 (body b0) [lin|ang], 6:12 =
  slot1 (body b1); b0/b1 (K,) int32 with -1 = ground/anchor (no body).

All fixed shapes; jit/vmap-able.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from eggshell_tpu.utils.precision import HIGHEST


def compact_blocks(sys, cs, spec):
    """Extract compact (K, 3, 12) blocks + lane bodies from a dense
    ConstraintSystem built by physics.constraints.build_constraints
    (rows ordered joints first, then contacts)."""
    n = spec.num_bodies
    Jn = spec.num_joints
    K = cs.capacity
    J = sys.J  # (m, n, 6)
    lanes_b0 = jnp.concatenate([spec.joint_b0.astype(jnp.int32), cs.b0])
    lanes_b1 = jnp.concatenate([spec.joint_b1.astype(jnp.int32), cs.b1])
    m3 = 3 * (Jn + K)
    rows = J[:m3].reshape(Jn + K, 3, n, 6)
    idx0 = jnp.clip(lanes_b0, 0, n - 1)
    idx1 = jnp.clip(lanes_b1, 0, n - 1)
    blk0 = jnp.take_along_axis(
        rows, idx0[:, None, None, None].repeat(3, 1), axis=2
    )[:, :, 0, :]
    blk1 = jnp.take_along_axis(
        rows, idx1[:, None, None, None].repeat(3, 1), axis=2
    )[:, :, 0, :]
    blk0 = jnp.where((lanes_b0 >= 0)[:, None, None], blk0, 0.0)
    blk1 = jnp.where((lanes_b1 >= 0)[:, None, None], blk1, 0.0)
    return jnp.concatenate([blk0, blk1], axis=-1), lanes_b0, lanes_b1


def jt_x(blocks, b0, b1, x, num_bodies: int):
    """y_body (n, 6) = J^T x from compact blocks (two segment-sums —
    the scatter side of the reference's CalculateSparseJMJtX)."""
    K = blocks.shape[0]
    xl = x.reshape(K, 3)
    c0 = jnp.einsum("krc,kr->kc", blocks[:, :, 0:6], xl)
    c1 = jnp.einsum("krc,kr->kc", blocks[:, :, 6:12], xl)
    seg0 = jnp.where(b0 >= 0, b0, num_bodies)   # ground -> dropped bucket
    seg1 = jnp.where(b1 >= 0, b1, num_bodies)
    y = jax.ops.segment_sum(c0, seg0, num_segments=num_bodies + 1)
    y = y + jax.ops.segment_sum(c1, seg1, num_segments=num_bodies + 1)
    return y[:num_bodies]


def j_v(blocks, b0, b1, v):
    """x (3K,) = J v for per-body generalized velocities v (n, 6)
    (gather side)."""
    n = v.shape[0]
    v0 = jnp.where((b0 >= 0)[:, None], v[jnp.clip(b0, 0, n - 1)], 0.0)
    v1 = jnp.where((b1 >= 0)[:, None], v[jnp.clip(b1, 0, n - 1)], 0.0)
    x0 = jnp.einsum("krc,kc->kr", blocks[:, :, 0:6], v0)
    x1 = jnp.einsum("krc,kc->kr", blocks[:, :, 6:12], v1)
    return (x0 + x1).reshape(-1)


def jmjt_matvec(blocks, b0, b1, Minv, x, cfm: float = 0.0):
    """y = (J M^-1 J^T + cfm I) x without forming the matrix
    (ref CalculateSparseJMJtX, sparse_iterations_utils.cc:624-695)."""
    n = Minv.shape[0]
    y = jt_x(blocks, b0, b1, x, n)
    y = jnp.einsum("nij,nj->ni", Minv, y)
    return j_v(blocks, b0, b1, y) + cfm * x


def jmjt_diagonal(blocks, b0, b1, Minv, cfm: float = 0.0):
    """diag(J M^-1 J^T) + cfm per row, from the compact blocks only."""
    n = Minv.shape[0]
    acc = jnp.zeros(blocks.shape[0] * 3, blocks.dtype)
    for s, bsel in ((0, b0), (1, b1)):
        blk = blocks[:, :, 6 * s:6 * s + 6]           # (K, 3, 6)
        Mb = jnp.where(
            (bsel >= 0)[:, None, None],
            Minv[jnp.clip(bsel, 0, n - 1)],
            0.0,
        )                                             # (K, 6, 6)
        contrib = jnp.einsum("krc,kcd,krd->kr", blk, Mb, blk)
        acc = acc + contrib.reshape(-1)
    return acc + cfm


@functools.partial(
    jax.jit,
    static_argnames=("iters", "omega", "beta", "cfm", "matvec_mode"),
)
def solve_lcp_matrix_free(
    blocks, b0, b1, Minv, rhs, is_eq, lo, hi,
    iters: int = 60,
    omega: float = 0.3,
    beta: float = 0.0,
    cfm: float = 0.0,
    x0: Optional[jax.Array] = None,
    matvec_mode: str = "auto",
):
    """Under-relaxed (heavy-ball) projected Jacobi on the matrix-free
    operator — identical update rule to ops/lcp.solve_lcp(method=
    "jacobi") but with O(K) memory: the matvec never forms JMJ^T
    (ref matrix-free BaseIteration, sparse_iterations.cc:148-226).

    matvec_mode:
      "segment"  per-iteration segment-sum scatter-add
      "onehot"   incidence MATMULS: the per-solve-constant one-hot
                 body-incidence matrices O0/O1 (n, K) turn both the
                 scatter (J^T accumulate) and the gather (J apply) into
                 matrix products (the reference's per-constraint loops,
                 sparse_iterations_utils.cc:624-695), at HIGHEST
                 precision so a TF32 product cannot round them
      "auto"     "onehot" when n * K >= 2**18, else "segment" (a
                 threshold not yet measured on the GPU)

    Intended for one LARGE scene (hundreds of bodies/contacts); for
    thousands of small batched QPs the dense kernels win."""
    diag = jmjt_diagonal(blocks, b0, b1, Minv, cfm)
    diag = jnp.where(diag > 0, diag, 1.0)
    K = blocks.shape[0]
    n = Minv.shape[0]
    if matvec_mode == "auto":
        matvec_mode = "onehot" if n * K >= (1 << 18) else "segment"

    if matvec_mode == "onehot":
        dtype = blocks.dtype
        body_ids = jnp.arange(n, dtype=jnp.int32)
        O0 = (b0[None, :] == body_ids[:, None]).astype(dtype)  # (n, K)
        O1 = (b1[None, :] == body_ids[:, None]).astype(dtype)
        blk0 = blocks[:, :, 0:6]
        blk1 = blocks[:, :, 6:12]

        def matvec(x):
            xl = x.reshape(K, 3)
            c0 = jnp.einsum("krc,kr->kc", blk0, xl)     # (K, 6)
            c1 = jnp.einsum("krc,kr->kc", blk1, xl)
            y = (jnp.matmul(O0, c0, precision=HIGHEST)
                 + jnp.matmul(O1, c1, precision=HIGHEST))       # (n, 6)
            y = jnp.einsum("nij,nj->ni", Minv, y)
            v0 = jnp.matmul(O0.T, y, precision=HIGHEST)          # (K, 6)
            v1 = jnp.matmul(O1.T, y, precision=HIGHEST)
            r0 = jnp.einsum("krc,kc->kr", blk0, v0)
            r1 = jnp.einsum("krc,kc->kr", blk1, v1)
            return (r0 + r1).reshape(-1) + cfm * x
    else:
        def matvec(x):
            return jmjt_matvec(blocks, b0, b1, Minv, x, cfm)

    def project(x):
        return jnp.where(is_eq, x, jnp.clip(x, lo, hi))

    def sweep(carry):
        x, xp = carry
        ax = matvec(x)
        r = rhs - ax + diag * x
        xn = project(
            (1.0 - omega) * x + omega * (r / diag) + beta * (x - xp)
        )
        return xn, x

    x = project(rhs if x0 is None else x0)
    x, _ = jax.lax.fori_loop(0, iters, lambda _, c: sweep(c), (x, x))
    return x
