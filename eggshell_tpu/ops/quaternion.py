"""Quaternion / SO(3) primitives, batched and differentiable.

Batched replacement for the reference's rotation utilities
(eggshell/utils.cc: CrossMat :16, WtoQ :82, GramSchmidt :66,
AlignVectors :233, random rotations :50-64).  Quaternions (w, x, y, z)
are the primary rotation state — the reference stores 3x3 matrices and
round-trips through quaternions for the integrator update
(eggshell/ensembles.cc:557, 588); we invert that choice because a 4-vector
is cheaper to carry through `scan` and renormalise than re-orthonormalising
a 9-element matrix.

All functions broadcast over arbitrary leading batch dimensions and are
safe under `jit`, `vmap`, `grad`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Basic vector helpers


def cross_mat(a: jax.Array) -> jax.Array:
    """Skew-symmetric matrix [a]_x with [a]_x b = a x b.

    Ref: eggshell/utils.cc:16-24 (CrossMat).
    Batched: a (..., 3) -> (..., 3, 3).
    """
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    zero = jnp.zeros_like(ax)
    return jnp.stack(
        [
            jnp.stack([zero, -az, ay], axis=-1),
            jnp.stack([az, zero, -ax], axis=-1),
            jnp.stack([-ay, ax, zero], axis=-1),
        ],
        axis=-2,
    )


def _safe_normalize(v: jax.Array, axis: int = -1, eps: float = 0.0):
    """Return (v/|v|, |v|); zero vectors map to zero (Eigen-normalize
    semantics relied on by WtoQ, ref eggshell/utils.cc:83-86).

    Double-where so reverse-mode stays NaN-free at v = 0 exactly (inactive
    contact lanes carry zero normals): sqrt never sees 0 on a
    gradient-carrying path — d|v|/dv = v/|v| is 0/0 there even under a
    zero cotangent."""
    l2 = jnp.sum(v * v, axis=axis, keepdims=True)
    valid = l2 > eps * eps
    n_safe = jnp.sqrt(jnp.where(valid, l2, 1.0))
    unit = jnp.where(valid, v / n_safe, jnp.zeros_like(v))
    n = jnp.where(valid, n_safe, 0.0)
    return unit, n.squeeze(axis)


# ---------------------------------------------------------------------------
# Quaternion algebra (w, x, y, z convention)


def quat_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_mul(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Hamilton product q1 * q2, (..., 4) x (..., 4) -> (..., 4)."""
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conj(q: jax.Array) -> jax.Array:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q: jax.Array) -> jax.Array:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.where(n > 0, n, 1.0)


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector v by quaternion q (= R(q) @ v).

    Uses the 2-cross-product form: v + 2 w (u x v) + 2 u x (u x v).
    """
    u = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_rotate_inv(q: jax.Array, v: jax.Array) -> jax.Array:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: jax.Array) -> jax.Array:
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        axis=-2,
    )


def mat_to_quat(R: jax.Array) -> jax.Array:
    """(..., 3, 3) -> (..., 4), branchless Shepperd-style extraction.

    Computes all four candidate quaternions (one per dominant component)
    and selects the numerically safest with `where` — no data-dependent
    control flow, so it vectorises under vmap/jit.
    """
    m = R
    t0 = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]  # 4w^2
    t1 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]  # 4x^2
    t2 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]  # 4y^2
    t3 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]  # 4z^2
    eps = jnp.asarray(1e-12, R.dtype)

    def s(t):
        return 0.5 / jnp.sqrt(jnp.maximum(t, eps))

    q0 = jnp.stack(
        [
            0.5 * jnp.sqrt(jnp.maximum(t0, eps)),
            (m[..., 2, 1] - m[..., 1, 2]) * s(t0),
            (m[..., 0, 2] - m[..., 2, 0]) * s(t0),
            (m[..., 1, 0] - m[..., 0, 1]) * s(t0),
        ],
        -1,
    )
    q1 = jnp.stack(
        [
            (m[..., 2, 1] - m[..., 1, 2]) * s(t1),
            0.5 * jnp.sqrt(jnp.maximum(t1, eps)),
            (m[..., 0, 1] + m[..., 1, 0]) * s(t1),
            (m[..., 0, 2] + m[..., 2, 0]) * s(t1),
        ],
        -1,
    )
    q2 = jnp.stack(
        [
            (m[..., 0, 2] - m[..., 2, 0]) * s(t2),
            (m[..., 0, 1] + m[..., 1, 0]) * s(t2),
            0.5 * jnp.sqrt(jnp.maximum(t2, eps)),
            (m[..., 1, 2] + m[..., 2, 1]) * s(t2),
        ],
        -1,
    )
    q3 = jnp.stack(
        [
            (m[..., 1, 0] - m[..., 0, 1]) * s(t3),
            (m[..., 0, 2] + m[..., 2, 0]) * s(t3),
            (m[..., 1, 2] + m[..., 2, 1]) * s(t3),
            0.5 * jnp.sqrt(jnp.maximum(t3, eps)),
        ],
        -1,
    )
    ts = jnp.stack([t0, t1, t2, t3], -1)
    qs = jnp.stack([q0, q1, q2, q3], -2)  # (..., 4, 4)
    idx = jnp.argmax(ts, axis=-1)
    q = jnp.take_along_axis(qs, idx[..., None, None].repeat(4, -1), axis=-2).squeeze(-2)
    # canonicalise sign (w >= 0)
    return quat_normalize(q * jnp.where(q[..., :1] < 0, -1.0, 1.0))


# ---------------------------------------------------------------------------
# Exponential map — the integrator rotation update


def quat_from_scaled_axis(phi: jax.Array) -> jax.Array:
    """exp-map: rotation vector phi = w*dt -> unit quaternion.

    Replaces WtoQ (ref eggshell/utils.cc:82-89, which builds an AngleAxis
    from |w|*dt about w-hat).  Taylor-safe near zero: uses
    sin(t/2)/t -> 1/2 as t -> 0 via a `where` on the squared angle.
    """
    t2 = jnp.sum(phi * phi, axis=-1, keepdims=True)
    small = t2 < jnp.asarray(1e-12, phi.dtype)
    # Double-where: sqrt never sees 0 on the taken branch, keeping grads finite.
    safe_t = jnp.sqrt(jnp.where(small, 1.0, t2))
    k = jnp.where(small, 0.5 - t2 / 48.0, jnp.sin(0.5 * safe_t) / safe_t)
    w = jnp.where(small, 1.0 - t2 / 8.0, jnp.cos(0.5 * safe_t))
    return jnp.concatenate([w, k * phi], axis=-1)


def integrate_quat(q: jax.Array, w: jax.Array, dt) -> jax.Array:
    """R_new = Q(w*dt) * R_old  (ref eggshell/ensembles.cc:588).

    q (..., 4), w (..., 3) global-frame angular velocity.
    """
    dq = quat_from_scaled_axis(w * dt)
    return quat_normalize(quat_mul(dq, q))


# ---------------------------------------------------------------------------
# Frame alignment — the contact-frame rotation


def align_vectors_mat(a: jax.Array, b: jax.Array) -> jax.Array:
    """Rotation matrix R with R @ a-hat = b-hat.

    Ref: eggshell/utils.cc:233-254 (AlignVectors = Quaterniond::FromTwoVectors).
    Branchless antiparallel handling: when a ~ -b the half-way quaternion is
    degenerate, so we rotate 180 degrees about an axis orthogonal to a,
    chosen as the cross with the coordinate axis least aligned with a.
    """
    ah, _ = _safe_normalize(a)
    bh, _ = _safe_normalize(b)
    w = 1.0 + jnp.sum(ah * bh, axis=-1, keepdims=True)
    xyz = jnp.cross(ah, bh)
    q = jnp.concatenate([w, xyz], axis=-1)

    # Antiparallel fallback: axis orthogonal to a.
    absa = jnp.abs(ah)
    # one-hot of the smallest |a| component
    least = jnp.argmin(absa, axis=-1)
    e = jax.nn.one_hot(least, 3, dtype=a.dtype)
    ortho, _ = _safe_normalize(jnp.cross(ah, e))
    q_pi = jnp.concatenate([jnp.zeros_like(w), ortho], axis=-1)

    q = jnp.where(w < 1e-8, q_pi, q)
    return quat_to_mat(quat_normalize(q))


# ---------------------------------------------------------------------------
# Orthonormalisation & random rotations (test fixtures)


def gram_schmidt(m: jax.Array) -> jax.Array:
    """Column-wise Gram-Schmidt (ref eggshell/utils.cc:66-80)."""
    c0 = m[..., :, 0]
    c1 = m[..., :, 1]
    c2 = m[..., :, 2]
    u0, _ = _safe_normalize(c0)
    u1 = c1 - jnp.sum(c1 * u0, -1, keepdims=True) * u0
    u1, _ = _safe_normalize(u1)
    u2 = c2 - jnp.sum(c2 * u0, -1, keepdims=True) * u0
    u2 = u2 - jnp.sum(u2 * u1, -1, keepdims=True) * u1
    u2, _ = _safe_normalize(u2)
    return jnp.stack([u0, u1, u2], axis=-1)


def random_quat(key: jax.Array, shape=(), dtype=jnp.float32) -> jax.Array:
    """Uniform random unit quaternion (ref eggshell/utils.cc:52-55,
    Quaterniond::UnitRandom)."""
    q = jax.random.normal(key, shape + (4,), dtype=dtype)
    return quat_normalize(q)


def random_rotation(key: jax.Array, shape=(), dtype=jnp.float32) -> jax.Array:
    return quat_to_mat(random_quat(key, shape, dtype))


def is_orthonormal(R: jax.Array, tol: float = 1e-9) -> jax.Array:
    """Ref: eggshell/utils.cc:11-14."""
    eye = jnp.eye(3, dtype=R.dtype)
    err = jnp.abs(jnp.swapaxes(R, -1, -2) @ R - eye)
    return jnp.all(err < tol, axis=(-2, -1))


# ---------------------------------------------------------------------------
# Box inertia


def box_inertia(mass: jax.Array, side_lengths: jax.Array) -> jax.Array:
    """Body-frame inertia of a solid box, m/12 * diag(sy^2+sz^2, ...).

    Ref: eggshell/body.cc:19-36 (CalculateInertia).
    mass (...,), side_lengths (..., 3) -> (..., 3, 3).
    """
    s2 = side_lengths * side_lengths
    d = (
        jnp.stack(
            [s2[..., 1] + s2[..., 2], s2[..., 0] + s2[..., 2], s2[..., 0] + s2[..., 1]],
            axis=-1,
        )
        * (mass[..., None] / 12.0)
    )
    return d[..., :, None] * jnp.eye(3, dtype=d.dtype)
