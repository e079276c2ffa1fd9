"""Scene-level contact assembly: narrowphase fan-out, capacity selection,
and constraint deduplication — all fixed-shape.

Replaces the reference's ``UpdateContacts`` (eggshell/ensembles.cc:445-480,
dynamically sized contact vector) and ``CheckAndCorrectEnsembleState``
(:241-329, constraint dedupe) with masked-lane equivalents:

- every body runs the 8-corner ground test (8 candidate lanes each);
- every candidate pair runs the SAT narrowphase (MAX_CONTACTS_PER_PAIR
  lanes each);
- active candidates are compacted *in original order* (ground contacts
  first, then pairs — the reference's ordering) into a fixed-capacity
  `ContactSet` via a stable argsort;
- contacts closer than `min_constraint_distance` to an earlier same-pair
  constraint (joint or contact) are dropped, mirroring the reference's
  delete-the-later-one rule.  Constraints involving the ground/anchor
  (index -1) are never deduped — the reference's pairwise check loops
  only over real body pairs (ensembles.cc:264-314).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from eggshell_tpu.ops import collision
from eggshell_tpu.ops import quaternion as quat
from eggshell_tpu.physics.scene import SceneSpec, State
from eggshell_tpu.utils.config import SimConfig
from eggshell_tpu.utils.precision import HIGHEST


class ContactSet(NamedTuple):
    """K fixed contact lanes.  b0 = -1 encodes the ground (the reference
    builds ground contacts as Constraint(nullptr, -1, body, i),
    eggshell/contact.h:13-15, so the *body* is slot 1)."""

    b0: jax.Array        # (K,) int32
    b1: jax.Array        # (K,) int32
    position: jax.Array  # (K, 3)
    normal: jax.Array    # (K, 3)
    depth: jax.Array     # (K,)
    active: jax.Array    # (K,) bool

    @property
    def capacity(self) -> int:
        return self.b0.shape[-1]


def _candidates(spec: SceneSpec, state: State, cfg: SimConfig,
                pair_out=None, pair_idx=None):
    """All candidate contacts in reference order: ground (per body, 8
    corner lanes) then box-box pairs (MAX_CONTACTS_PER_PAIR lanes).

    With cfg.pair_capacity > 0 the pair list is first AABB-pruned and
    compacted (broadphase) so the SAT narrowphase only runs on plausible
    pairs.  `pair_idx` = (pi, pj, gate) injects an externally selected
    pair subset matching a precomputed `pair_out`."""
    n = spec.num_bodies
    R = state.R()

    gpos, gnrm, gdep, gact = jax.vmap(collision.collide_box_and_ground)(
        state.p, R, spec.half_extents
    )
    gact = gact & spec.ground_enabled[:, None]
    g_b0 = jnp.full((n, collision.GROUND_CONTACTS), -1, jnp.int32)
    g_b1 = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32)[:, None], (n, collision.GROUND_CONTACTS)
    )

    P = spec.num_pairs
    pair_gate = None
    if pair_idx is not None:
        pi, pj, pair_gate = pair_idx
        P = pi.shape[0]
    elif pair_out is not None:
        pi, pj = spec.pair_i, spec.pair_j
    elif P > 0 and 0 < cfg.pair_capacity < P:
        from eggshell_tpu.ops import broadphase

        pi, pj, pair_gate = broadphase.select_scene_pairs(spec, state, cfg)
        P = cfg.pair_capacity
    else:
        pi, pj = spec.pair_i, spec.pair_j

    if P > 0:
        if pair_out is not None:
            out = pair_out
        else:
            out = jax.vmap(collision.collide_boxes)(
                state.p[pi], R[pi], spec.half_extents[pi],
                state.p[pj], R[pj], spec.half_extents[pj],
            )
        C = collision.MAX_CONTACTS_PER_PAIR
        pact = out.active
        if pair_gate is not None:
            pact = pact & pair_gate[:, None]
        p_b0 = jnp.broadcast_to(pi[:, None], (P, C))
        p_b1 = jnp.broadcast_to(pj[:, None], (P, C))
        b0 = jnp.concatenate([g_b0.reshape(-1), p_b0.reshape(-1)])
        b1 = jnp.concatenate([g_b1.reshape(-1), p_b1.reshape(-1)])
        pos = jnp.concatenate([gpos.reshape(-1, 3), out.position.reshape(-1, 3)])
        nrm = jnp.concatenate([gnrm.reshape(-1, 3), out.normal.reshape(-1, 3)])
        dep = jnp.concatenate([gdep.reshape(-1), out.depth.reshape(-1)])
        act = jnp.concatenate([gact.reshape(-1), pact.reshape(-1)])
    else:
        b0, b1 = g_b0.reshape(-1), g_b1.reshape(-1)
        pos, nrm = gpos.reshape(-1, 3), gnrm.reshape(-1, 3)
        dep, act = gdep.reshape(-1), gact.reshape(-1)
    return b0, b1, pos, nrm, dep, act


def make_contacts(spec: SceneSpec, state: State, cfg: SimConfig,
                  pair_out=None, pair_idx=None) -> ContactSet:
    """Detect, compact, and dedupe contacts into `cfg.contact_capacity`
    masked lanes.  `pair_out` optionally injects precomputed pairwise
    narrowphase results; `pair_idx` the matching broadphase-selected
    pair subset."""
    K = cfg.contact_capacity
    b0, b1, pos, nrm, dep, act = _candidates(spec, state, cfg, pair_out,
                                             pair_idx)
    C = act.shape[0]

    if K * C > (1 << 23):
        # Large-scene tier (piles: K ~ thousands, C ~ tens of
        # thousands): the (K, C) one-hot matmul is tens of GFLOPs per
        # scene; rank-score top_k + an 8-column gather is ~100x less
        # work and keeps the same stable original order.
        score = jnp.where(act, C - jnp.arange(C, dtype=jnp.int32), 0)
        v, order = jax.lax.top_k(score, K)
        active = v > 0
        cs = ContactSet(
            b0=jnp.where(active, b0[order], -1),
            b1=jnp.where(active, b1[order], -1),
            position=jnp.where(active[:, None], pos[order], 0.0),
            normal=jnp.where(active[:, None], nrm[order], 0.0),
            depth=jnp.where(active, dep[order], 0.0),
            active=active,
        )
        return _dedupe(spec, state, cs, cfg)

    # Stable compaction via a one-hot selection matmul: active candidate
    # number o lands in lane o (original order preserved).  Equivalent to
    # a stable argsort-take without a sort.  HIGHEST precision: a TF32
    # product would round the selected positions to 10 mantissa bits.
    offs = jnp.cumsum(act.astype(jnp.int32)) - act.astype(jnp.int32)
    slot = jnp.arange(K)
    sel = ((offs[None, :] == slot[:, None]) & act[None, :])  # (K, C)
    self_f = sel.astype(pos.dtype)
    sel_i = sel.astype(jnp.int32)
    cs = ContactSet(
        b0=sel_i @ b0 - (1 - sel_i.sum(-1)),  # inactive lanes -> -1
        b1=sel_i @ b1 - (1 - sel_i.sum(-1)),
        position=jnp.matmul(self_f, pos, precision=HIGHEST),
        normal=jnp.matmul(self_f, nrm, precision=HIGHEST),
        depth=jnp.matmul(self_f, dep, precision=HIGHEST),
        active=sel.any(axis=-1),
    )
    return _dedupe(spec, state, cs, cfg)


def count_dropped_contacts(spec: SceneSpec, state: State, cfg: SimConfig):
    """Number of active contact candidates that did NOT fit into the
    cfg.contact_capacity lanes, PLUS (scaled) overlapping pairs the
    broadphase gate truncated at cfg.pair_capacity — both are silent
    contact loss (a truncated pair never even reaches the narrowphase;
    in a collapsing pile that is exactly the tunneling-then-ejection
    failure mode).  Zero means both capacities are sufficient for this
    state; surfaced through `stepper.step_diagnostics` so perf tuning
    of the capacity knobs is observable (no reference analog: the
    reference's contact vector is dynamically sized,
    eggshell/ensembles.cc:445-480)."""
    _, _, _, _, _, act = _candidates(spec, state, cfg)
    dropped = jnp.maximum(
        jnp.sum(act.astype(jnp.int32)) - cfg.contact_capacity, 0
    )
    if 0 < cfg.pair_capacity < spec.num_pairs:
        from eggshell_tpu.ops import broadphase

        mask = broadphase.pair_overlap_mask(
            state.p, state.q, spec.half_extents,
            spec.pair_i, spec.pair_j, cfg.broadphase_margin,
        )
        pair_drop = jnp.maximum(
            jnp.sum(mask.astype(jnp.int32)) - cfg.pair_capacity, 0
        )
        # each truncated pair can carry up to MAX_CONTACTS_PER_PAIR lanes
        dropped = dropped + pair_drop * collision.MAX_CONTACTS_PER_PAIR
    return dropped


def _dedupe(spec: SceneSpec, state: State, cs: ContactSet, cfg: SimConfig):
    """Drop contact k when an earlier same-body-pair constraint (any joint,
    or a contact with lower lane index) sits closer than
    `min_constraint_distance` (ref ensembles.cc:289-314, 376-388)."""
    eps2 = cfg.min_constraint_distance**2

    # Normalised body pair per contact; ground pairs (-1) excluded.
    lo_b = jnp.minimum(cs.b0, cs.b1)
    hi_b = jnp.maximum(cs.b0, cs.b1)
    body_pair_ok = lo_b >= 0

    # Contact-contact: same pair, close, earlier index.
    K = cs.capacity
    W = collision.MAX_CONTACTS_PER_PAIR
    if K >= 32 * W:
        # Windowed form: each candidate pair contributes at most
        # MAX_CONTACTS_PER_PAIR candidate lanes, and the stable
        # compaction keeps them CONTIGUOUS — so a same-pair earlier
        # lane is always within W-1 lanes.  O(K*W) instead of O(K^2):
        # at pile capacities (K = 8192) the full pairwise form was a
        # 67M-lane broadcast per scene per step.
        drop_cc = jnp.zeros((K,), bool)
        for s in range(1, W):
            same = (lo_b[s:] == lo_b[:-s]) & (hi_b[s:] == hi_b[:-s])
            ok = body_pair_ok[s:] & body_pair_ok[:-s]
            both = cs.active[s:] & cs.active[:-s]
            d2s = jnp.sum(
                (cs.position[s:] - cs.position[:-s]) ** 2, axis=-1
            )
            hit = same & ok & both & (d2s < eps2)
            drop_cc = drop_cc.at[s:].set(drop_cc[s:] | hit)
    else:
        d2 = jnp.sum(
            (cs.position[:, None, :] - cs.position[None, :, :]) ** 2,
            axis=-1,
        )
        same_pair = (lo_b[:, None] == lo_b[None, :]) & (
            hi_b[:, None] == hi_b[None, :]
        )
        both_ok = body_pair_ok[:, None] & body_pair_ok[None, :]
        both_act = cs.active[:, None] & cs.active[None, :]
        earlier = (
            jnp.arange(K)[None, :] < jnp.arange(K)[:, None]
        )
        drop_cc = jnp.any(
            same_pair & both_ok & both_act & earlier & (d2 < eps2), axis=1
        )

    # Joint-contact: a joint between the same body pair, close => drop the
    # contact (ref :291-300).
    J = spec.num_joints
    if J > 0:
        R = state.R()
        a0 = state.p[spec.joint_b0] + jnp.einsum(
            "jik,jk->ji", R[spec.joint_b0], spec.joint_c0
        )
        anchored = spec.joint_b1 < 0
        jb1 = jnp.where(anchored, 0, spec.joint_b1)
        a1 = jnp.where(
            anchored[:, None],
            spec.joint_c1,
            state.p[jb1] + jnp.einsum("jik,jk->ji", R[jb1], spec.joint_c1),
        )
        jpos = jnp.where(anchored[:, None], a0, 0.5 * (a0 + a1))
        j_lo = jnp.minimum(spec.joint_b0, spec.joint_b1)
        j_hi = jnp.maximum(spec.joint_b0, spec.joint_b1)
        j_ok = j_lo >= 0
        jd2 = jnp.sum((cs.position[:, None, :] - jpos[None, :, :]) ** 2, -1)
        j_same = (lo_b[:, None] == j_lo[None, :]) & (hi_b[:, None] == j_hi[None, :])
        drop_jc = jnp.any(
            j_same & j_ok[None, :] & body_pair_ok[:, None] & (jd2 < eps2),
            axis=1,
        ) & cs.active
        drop = drop_cc | drop_jc
    else:
        drop = drop_cc

    return cs._replace(active=cs.active & ~drop)


def effective_depth(depth: jax.Array, cfg: SimConfig) -> jax.Array:
    """Penetration depth as seen by the ERP correction term, saturated at
    cfg.max_correcting_vel * dt / erp so deep interpenetration is pushed
    out at a bounded velocity (ODE's dWorldSetMaxCorrectingVel analog;
    see SimConfig.max_correcting_vel).  Identity when the cap is inf."""
    import math

    if math.isinf(cfg.max_correcting_vel):
        return depth
    cap = cfg.max_correcting_vel * cfg.dt / max(cfg.erp, 1e-12)
    return jnp.minimum(depth, cap)


def contact_frames(cs: ContactSet) -> jax.Array:
    """Rotation matrices mapping global vectors into the contact frame
    (z = contact normal): R = AlignVectors(normal, z)
    (ref eggshell/contact.cc:50-51).  (K, 3, 3)."""
    z = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], cs.normal.dtype), cs.normal.shape
    )
    return quat.align_vectors_mat(cs.normal, z)


def make_contacts_batched(
    spec: SceneSpec, states: State, cfg: SimConfig
) -> ContactSet:
    """Batched contact generation over a leading scenario axis: the
    per-scene path under vmap, which XLA fuses over scenes x pairs."""
    return jax.vmap(lambda st: make_contacts(spec, st, cfg))(states)
