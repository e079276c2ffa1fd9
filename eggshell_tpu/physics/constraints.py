"""Constraint assembly: global Jacobian, position error, and LCP bounds.

Replaces the reference's per-constraint ``ComputeJ`` + conservativeResize
row appending (eggshell/ensembles.cc:38-87) with one fixed-shape scatter:

rows [0, 3J)              ball-and-socket joints (ref joints.cc:13-35)
rows [3J, 3J + 3K)        contacts in the contact frame (ref contact.cc:38-117)

Inactive contact lanes contribute zero J rows, zero error, and equality
type; the system matrix later gets a unit diagonal on those rows so their
multipliers are exactly zero (see stepper.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from eggshell_tpu.ops import quaternion as quat
from eggshell_tpu.physics.contacts import (
    ContactSet, contact_frames, effective_depth,
)
from eggshell_tpu.physics.scene import SceneSpec, State
from eggshell_tpu.utils.config import FrictionModel, SimConfig
from eggshell_tpu.utils.precision import HIGHEST


class ConstraintSystem(NamedTuple):
    J: jax.Array           # (m, n, 6)
    err: jax.Array         # (m,) position constraint error
    is_eq: jax.Array       # (m,) True = equality row
    lo: jax.Array          # (m,) lambda lower bound (inequality rows)
    hi: jax.Array          # (m,)
    row_active: jax.Array  # (m,) False = masked lane
    # Coulomb coupling: row index of the normal row whose impulse caps
    # this (tangential) row, or -1 (FrictionModel.COULOMB_PYRAMID only).
    couple: jax.Array      # (m,) int32

    @property
    def num_rows(self) -> int:
        return self.J.shape[-3]


class CompactConstraintSystem(NamedTuple):
    """Constraint system in compact per-lane block form — the O(K)-memory
    representation for LARGE single scenes (hundreds to thousands of
    bodies), where the dense (m, n, 6) Jacobian of `ConstraintSystem`
    would not fit.  Lane k contributes 3 rows touching at most two
    bodies; the matrix-free solver (ops/lcp_matrix_free) consumes this
    directly (ref sparse_iterations_utils.cc:624-695, the reference's
    matrix-free JMJt machinery built for the same reason).

    blocks (L, 3, 12): columns 0:6 = J rows of slot0 (body b0), 6:12 =
    slot1 (body b1), both [linear | angular]; b0/b1 (L,) with -1 =
    ground/world anchor.  Row-major flattening of (L, 3) matches the
    dense ConstraintSystem's row order (joints first, then contacts).
    """

    blocks: jax.Array      # (L, 3, 12)
    b0: jax.Array          # (L,) int32
    b1: jax.Array          # (L,) int32
    err: jax.Array         # (3L,)
    is_eq: jax.Array       # (3L,)
    lo: jax.Array          # (3L,)
    hi: jax.Array          # (3L,)
    row_active: jax.Array  # (3L,)


def build_compact_constraints(
    spec: SceneSpec, state: State, cs: ContactSet, cfg: SimConfig
) -> CompactConstraintSystem:
    """Assemble joint + contact constraints as compact two-body blocks
    WITHOUT forming the dense Jacobian — same formulas as
    `build_constraints` (ref joints.cc:13-35, contact.cc:38-117), O(K)
    memory.  Supports NO_FRICTION / INFINITE / BOX friction (COULOMB
    coupling is a dense-path feature)."""
    Jn = spec.num_joints
    K = cs.capacity
    dtype = state.p.dtype
    R = state.R()
    eye3 = jnp.eye(3, dtype=dtype)
    inf = jnp.asarray(jnp.inf, dtype)

    # joints: blk0 = [I, -cross(R0 c0)], blk1 = [-I, cross(R1 c1)]
    if Jn > 0:
        r0c0 = jnp.einsum("jik,jk->ji", R[spec.joint_b0], spec.joint_c0)
        jb1 = jnp.where(spec.joint_b1 >= 0, spec.joint_b1, 0)
        r1c1 = jnp.einsum("jik,jk->ji", R[jb1], spec.joint_c1)
        jblk0 = jnp.concatenate(
            [jnp.broadcast_to(eye3, (Jn, 3, 3)), -quat.cross_mat(r0c0)], -1
        )
        jblk1 = jnp.concatenate(
            [jnp.broadcast_to(-eye3, (Jn, 3, 3)), quat.cross_mat(r1c1)], -1
        )
        jblk1 = jnp.where((spec.joint_b1 >= 0)[:, None, None], jblk1, 0.0)
        jblocks = jnp.concatenate([jblk0, jblk1], axis=-1)
        anchored = spec.joint_b1 < 0
        tgt = jnp.where(anchored[:, None], spec.joint_c1, state.p[jb1] + r1c1)
        jerr = (state.p[spec.joint_b0] + r0c0 - tgt).reshape(-1)
    else:
        jblocks = jnp.zeros((0, 3, 12), dtype)
        jerr = jnp.zeros((0,), dtype)

    # contacts: blk0 = [-R, R cross(pos - p0)], blk1 = [R, -R cross(pos - p1)]
    Rcf = contact_frames(cs)
    b0ok = cs.b0 >= 0
    b1ok = cs.b1 >= 0
    sb0 = jnp.where(b0ok, cs.b0, 0)
    sb1 = jnp.where(b1ok, cs.b1, 0)
    c0 = quat.cross_mat(cs.position - state.p[sb0])
    c1 = quat.cross_mat(cs.position - state.p[sb1])
    cblk0 = jnp.concatenate([-Rcf, Rcf @ c0], axis=-1)
    cblk1 = jnp.concatenate([Rcf, -(Rcf @ c1)], axis=-1)

    fm = cfg.friction_model
    if fm == FrictionModel.NO_FRICTION:
        row_on = jnp.stack([jnp.zeros_like(cs.active)] * 2 + [cs.active], -1)
        eq = jnp.zeros((K, 3), bool)
        lo_c = jnp.zeros((K, 3), dtype)
        hi_c = jnp.broadcast_to(jnp.asarray([0.0, 0.0, jnp.inf], dtype), (K, 3))
    elif fm == FrictionModel.INFINITE:
        row_on = jnp.broadcast_to(cs.active[:, None], (K, 3))
        eq = jnp.broadcast_to(jnp.asarray([True, True, False]), (K, 3))
        lo_c = jnp.zeros((K, 3), dtype)
        hi_c = jnp.broadcast_to(jnp.asarray([0.0, 0.0, jnp.inf], dtype), (K, 3))
    elif fm == FrictionModel.BOX:
        mu = cfg.friction_bound
        row_on = jnp.broadcast_to(cs.active[:, None], (K, 3))
        eq = jnp.zeros((K, 3), bool)
        if cfg.ref_app_bounds:
            lo_c = jnp.zeros((K, 3), dtype)
            hi_c = jnp.full((K, 3), inf)
        else:
            lo_c = jnp.broadcast_to(jnp.asarray([-mu, -mu, 0.0], dtype), (K, 3))
            hi_c = jnp.broadcast_to(jnp.asarray([mu, mu, jnp.inf], dtype), (K, 3))
    else:
        raise NotImplementedError(
            "COULOMB_PYRAMID coupling is dense-path only (ops/lcp)"
        )

    mask3 = row_on[..., None]
    cblk0 = jnp.where(mask3 & b0ok[:, None, None], cblk0, 0.0)
    cblk1 = jnp.where(mask3 & b1ok[:, None, None], cblk1, 0.0)
    cblocks = jnp.concatenate([cblk0, cblk1], axis=-1)
    dep_eff = effective_depth(cs.depth, cfg)
    cerr = jnp.stack(
        [jnp.zeros((K,), dtype), jnp.zeros((K,), dtype),
         jnp.where(cs.active, -dep_eff, 0.0)], -1
    )
    cerr = jnp.where(row_on, cerr, 0.0).reshape(-1)

    blocks = jnp.concatenate([jblocks, cblocks], axis=0)
    lane_b0 = jnp.concatenate(
        [spec.joint_b0.astype(jnp.int32),
         jnp.where(cs.active, cs.b0, -1).astype(jnp.int32)]
    )
    lane_b1 = jnp.concatenate(
        [spec.joint_b1.astype(jnp.int32),
         jnp.where(cs.active, cs.b1, -1).astype(jnp.int32)]
    )
    err = jnp.concatenate([jerr, cerr])
    is_eq = jnp.concatenate(
        [jnp.ones((3 * Jn,), bool), jnp.where(row_on, eq, True).reshape(-1)]
    )
    lo = jnp.concatenate([jnp.zeros((3 * Jn,), dtype), lo_c.reshape(-1)])
    hi = jnp.concatenate([jnp.zeros((3 * Jn,), dtype), hi_c.reshape(-1)])
    row_active = jnp.concatenate(
        [jnp.ones((3 * Jn,), bool), row_on.reshape(-1)]
    )
    # Mask inactive lanes out of the blocks so the matrix-free operator
    # sees zero rows there (their multipliers are pinned by lo=hi=0).
    blocks = blocks * row_active.reshape(-1, 3)[:, :, None]
    return CompactConstraintSystem(
        blocks=blocks, b0=lane_b0, b1=lane_b1, err=err, is_eq=is_eq,
        lo=lo, hi=hi, row_active=row_active,
    )


def _blocks_to_rows(bodies, blocks, n):
    """Expand (c, 3, 6) constraint blocks into dense rows (3c, n, 6) via a
    one-hot body matmul at HIGHEST precision (a TF32 product would round
    J to 10 mantissa bits).  -1 bodies contribute nothing."""
    c = bodies.shape[0]
    onehot = (bodies[:, None] == jnp.arange(n)[None, :]).astype(blocks.dtype)
    out = jnp.einsum("cn,crk->crnk", onehot, blocks, precision=HIGHEST)
    return out.reshape(3 * c, n, 6)


def build_constraints(
    spec: SceneSpec, state: State, cs: ContactSet, cfg: SimConfig
) -> ConstraintSystem:
    n = spec.num_bodies
    Jn = spec.num_joints
    K = cs.capacity
    dtype = state.p.dtype
    R = state.R()
    eye3 = jnp.eye(3, dtype=dtype)

    # ------------------------------------------------------------------ joints
    if Jn > 0:
        r0c0 = jnp.einsum("jik,jk->ji", R[spec.joint_b0], spec.joint_c0)
        jb1 = jnp.where(spec.joint_b1 >= 0, spec.joint_b1, 0)
        r1c1 = jnp.einsum("jik,jk->ji", R[jb1], spec.joint_c1)

        # J_b0 = [I, -cross(R0 c0)]; J_b1 = [-I, cross(R1 c1)]
        # (ref joints.cc:21-28)
        blk0 = jnp.concatenate(
            [jnp.broadcast_to(eye3, (Jn, 3, 3)), -quat.cross_mat(r0c0)], axis=-1
        )
        blk1 = jnp.concatenate(
            [jnp.broadcast_to(-eye3, (Jn, 3, 3)), quat.cross_mat(r1c1)], axis=-1
        )
        J_joints = _blocks_to_rows(spec.joint_b0, blk0, n) + _blocks_to_rows(
            spec.joint_b1, blk1, n
        )

        # error = p0 + R0 c0 - (p1 + R1 c1)   [b1 = -1: - world anchor c1]
        # (ref joints.cc:3-11)
        anchored = spec.joint_b1 < 0
        tgt = jnp.where(
            anchored[:, None], spec.joint_c1, state.p[jb1] + r1c1
        )
        jerr = (state.p[spec.joint_b0] + r0c0 - tgt).reshape(-1)
    else:
        J_joints = jnp.zeros((0, n, 6), dtype)
        jerr = jnp.zeros((0,), dtype)

    # ---------------------------------------------------------------- contacts
    Rcf = contact_frames(cs)  # (K, 3, 3)
    b0ok = cs.b0 >= 0
    b1ok = cs.b1 >= 0
    sb0 = jnp.where(b0ok, cs.b0, 0)
    sb1 = jnp.where(b1ok, cs.b1, 0)

    # j0 = [-R, R cross(pos - p0)]; j1 = [R, -R cross(pos - p1)]
    # (ref contact.cc:56-72)
    c0 = quat.cross_mat(cs.position - state.p[sb0])
    c1 = quat.cross_mat(cs.position - state.p[sb1])
    blk0 = jnp.concatenate([-Rcf, Rcf @ c0], axis=-1)
    blk1 = jnp.concatenate([Rcf, -(Rcf @ c1)], axis=-1)

    # Friction model (ref contact.cc:80-116).  NO_FRICTION keeps only the
    # normal row; the tangential lanes are masked instead of removed.
    fm = cfg.friction_model
    inf = jnp.asarray(jnp.inf, dtype)
    if fm == FrictionModel.NO_FRICTION:
        row_on = jnp.stack([jnp.zeros_like(cs.active)] * 2 + [cs.active], -1)
        eq = jnp.zeros((K, 3), bool)
        lo_c = jnp.stack([jnp.zeros(K, dtype)] * 2 + [jnp.zeros(K, dtype)], -1)
        hi_c = jnp.stack([jnp.zeros(K, dtype)] * 2 + [jnp.full((K,), inf)], -1)
    elif fm == FrictionModel.INFINITE:
        row_on = jnp.broadcast_to(cs.active[:, None], (K, 3))
        eq = jnp.broadcast_to(jnp.asarray([True, True, False]), (K, 3))
        lo_c = jnp.zeros((K, 3), dtype)
        hi_c = jnp.broadcast_to(jnp.asarray([0.0, 0.0, jnp.inf], dtype), (K, 3))
    elif fm == FrictionModel.COULOMB_PYRAMID:
        # tangential bounds are dynamic (+-mu lambda_n, applied inside the
        # projected sweeps via `couple`); static placeholders are 0.
        row_on = jnp.broadcast_to(cs.active[:, None], (K, 3))
        eq = jnp.zeros((K, 3), bool)
        lo_c = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.0], dtype), (K, 3))
        hi_c = jnp.broadcast_to(jnp.asarray([0.0, 0.0, jnp.inf], dtype), (K, 3))
    else:  # BOX (default)
        mu = cfg.friction_bound
        row_on = jnp.broadcast_to(cs.active[:, None], (K, 3))
        eq = jnp.zeros((K, 3), bool)
        if cfg.ref_app_bounds:
            # The reference app's production solver discards the box
            # bounds and clamps every inequality row to [0, inf)
            # (eggshell/lcp.cc:276-298; see SimConfig.ref_app_bounds).
            lo_c = jnp.zeros((K, 3), dtype)
            hi_c = jnp.full((K, 3), inf)
        else:
            lo_c = jnp.broadcast_to(jnp.asarray([-mu, -mu, 0.0], dtype), (K, 3))
            hi_c = jnp.broadcast_to(jnp.asarray([mu, mu, jnp.inf], dtype), (K, 3))

    mask3 = row_on[..., None]  # (K, 3, 1)
    blk0 = jnp.where(mask3 & b0ok[:, None, None], blk0, 0.0)
    blk1 = jnp.where(mask3 & b1ok[:, None, None], blk1, 0.0)
    J_contacts = _blocks_to_rows(
        jnp.where(cs.active, cs.b0, -1), blk0, n
    ) + _blocks_to_rows(jnp.where(cs.active, cs.b1, -1), blk1, n)
    J = jnp.concatenate([J_joints, J_contacts], axis=0)

    # error = (0, 0, -depth) (ref contact.cc:14-22); depth saturated per
    # SimConfig.max_correcting_vel (contacts.effective_depth).
    dep_eff = effective_depth(cs.depth, cfg)
    cerr = jnp.stack(
        [jnp.zeros((K,), dtype), jnp.zeros((K,), dtype),
         jnp.where(cs.active, -dep_eff, 0.0)],
        axis=-1,
    )
    cerr = jnp.where(row_on, cerr, 0.0).reshape(-1)

    err = jnp.concatenate([jerr, cerr])
    is_eq = jnp.concatenate(
        [jnp.ones((3 * Jn,), bool), jnp.where(row_on, eq, True).reshape(-1)]
    )
    lo = jnp.concatenate([jnp.zeros((3 * Jn,), dtype), lo_c.reshape(-1)])
    hi = jnp.concatenate([jnp.zeros((3 * Jn,), dtype), hi_c.reshape(-1)])
    row_active = jnp.concatenate(
        [jnp.ones((3 * Jn,), bool), row_on.reshape(-1)]
    )
    if fm == FrictionModel.COULOMB_PYRAMID:
        normal_rows = 3 * Jn + 3 * jnp.arange(K) + 2
        ccontact = jnp.stack(
            [normal_rows, normal_rows, jnp.full((K,), -1, jnp.int32)], -1
        )
        ccontact = jnp.where(row_on, ccontact, -1).reshape(-1)
        couple = jnp.concatenate(
            [jnp.full((3 * Jn,), -1, jnp.int32), ccontact.astype(jnp.int32)]
        )
    else:
        couple = jnp.full((3 * Jn + 3 * K,), -1, jnp.int32)
    return ConstraintSystem(J=J, err=err, is_eq=is_eq, lo=lo, hi=hi,
                            row_active=row_active, couple=couple)
