"""Branchless SAT box-box and box-ground collision, batched.

Fixed-shape re-design of the reference narrowphase
(eggshell/collision.cc:166-432):

- 15 separating axes: 6 face normals + 9 edge x edge (ref :215-276).
- Contact classification codes 1-16 (ref eggshell/collision.h:36-40).
- Face-face polygon clipping with *fixed-capacity* vertex buffers and
  masked lanes instead of std::vector (ref IntersectBoxAndRectangle /
  ClipPolygonByHalfSpace, :84-159).
- Edge-edge closest-approach contact (ref LineClosestApproach :47-62).
- Deep-penetration fallback contact at box2's center, code 16 (ref :380-386).
- Box-ground: 8-vertex z<0 test (ref :408-432).

Everything is `where`-based select code: no data-dependent Python control
flow, so a single `vmap` turns one pair test into thousands of pair tests
per step, and XLA fuses the whole narrowphase into the stepper.

Conventions: `hs` = half side lengths; rotations are 3x3 matrices here
(entering from quaternion state via `quat_to_mat` once per body per step).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from eggshell_tpu.ops import quaternion as quat

# Alignment heuristic for stable stacking (ref eggshell/collision.cc:189).
ALIGNMENT_TOLERANCE = 0.9962
TOL = 1e-9

# Max vertices of the clipped contact polygon: a 4-gon clipped by 6 half
# spaces has <= 10 vertices; 12 gives slack for duplicate crossing points.
MAX_POLY = 12
# Max contacts emitted per box pair (= MAX_POLY; edge-edge/fallback emit 1).
MAX_CONTACTS_PER_PAIR = MAX_POLY
# Contacts per box-ground test: 8 corners.
GROUND_CONTACTS = 8


class PairContacts(NamedTuple):
    """Fixed-capacity contact set for one box pair (masked lanes)."""

    position: jax.Array  # (MAX_CONTACTS_PER_PAIR, 3)
    normal: jax.Array    # (MAX_CONTACTS_PER_PAIR, 3)
    depth: jax.Array     # (MAX_CONTACTS_PER_PAIR,)
    active: jax.Array    # (MAX_CONTACTS_PER_PAIR,) bool
    # CollisionInfo (ref eggshell/collision.h:43-51)
    code: jax.Array             # () int32, 0 = separated
    info_depth: jax.Array       # ()
    separating_axis: jax.Array  # (3,)


def _sign(x):
    """(x >= 0) ? 1 : -1 — ref eggshell/collision.cc:26-28 (not sign(0)=0)."""
    return jnp.where(x >= 0, 1.0, -1.0).astype(x.dtype)


# ---------------------------------------------------------------------------
# Polygon clipping with fixed-size buffers


def _clip_halfspace(poly, count, normal, d):
    """Clip convex polygon by halfspace normal.P + d >= 0.

    Ref: eggshell/collision.cc:84-99 (ClipPolygonByHalfSpace) —
    per input vertex, emit the vertex if inside, then the crossing point of
    the segment to the next vertex if it strictly crosses the line.

    poly (MAX_POLY, 2), count () int32 -> same shapes.
    Emission order is preserved via an exclusive prefix sum of per-vertex
    output counts and a masked scatter.
    """
    dtype = poly.dtype
    idx = jnp.arange(MAX_POLY)
    valid = idx < count
    nxt = jnp.where(idx + 1 >= count, 0, idx + 1)
    p1 = poly
    p2 = poly[nxt]

    k1 = p1 @ normal + d
    k2 = p2 @ normal + d
    inside = (k1 >= 0) & valid
    crosses = (k1 * k2 < 0) & valid
    # Crossing point p1 - (k1/(k2-k1)) (p2-p1)  (ref :76)
    denom = jnp.where(crosses, k2 - k1, 1.0)
    t = k1 / denom
    cross_pt = p1 - t[:, None] * (p2 - p1)

    contrib = inside.astype(jnp.int32) + crosses.astype(jnp.int32)
    offs = jnp.cumsum(contrib) - contrib  # exclusive prefix sum
    new_count = jnp.sum(contrib).astype(jnp.int32)

    # Emit via one-hot selection matrices instead of scatters: two small
    # matmuls, run at HIGHEST precision (utils/precision).
    slots = jnp.arange(MAX_POLY)
    sel_vert = (offs[None, :] == slots[:, None]) & inside[None, :]
    sel_cross = (
        (offs + inside.astype(jnp.int32))[None, :] == slots[:, None]
    ) & crosses[None, :]
    out = sel_vert.astype(dtype) @ p1 + sel_cross.astype(dtype) @ cross_pt.astype(dtype)
    return out, new_count


def _intersect_box_and_rectangle(Ac, AR, Ah, Rc, RR, Rh):
    """Intersection polygon of box A and rectangle R, in R's 2D frame.

    Ref: eggshell/collision.cc:105-159 (IntersectBoxAndRectangle).
    Returns (poly (MAX_POLY, 2), count).
    """
    dtype = Ac.dtype
    Bc = Ac - Rc  # box center relative to rectangle center (ref :112)

    poly = jnp.zeros((MAX_POLY, 2), dtype)
    poly = poly.at[0].set(jnp.array([-1.0, -1.0], dtype) * Rh[:2])
    poly = poly.at[1].set(jnp.array([-1.0, 1.0], dtype) * Rh[:2])
    poly = poly.at[2].set(jnp.array([1.0, 1.0], dtype) * Rh[:2])
    poly = poly.at[3].set(jnp.array([1.0, -1.0], dtype) * Rh[:2])
    count = jnp.asarray(4, jnp.int32)

    Rnormal = RR[:, 2]

    def clip_one(carry, inputs):
        poly, count = carry
        Bnormal, Bd, cross = inputs
        parallel = cross < TOL
        accept = parallel & (Bd <= 0)
        reject = parallel & (Bd > 0)
        Hnormal = jnp.stack([RR[:, 0] @ Bnormal, RR[:, 1] @ Bnormal])
        new_poly, new_count = _clip_halfspace(poly, count, Hnormal, -Bd)
        poly = jnp.where(parallel, poly, new_poly)
        count = jnp.where(
            reject, 0, jnp.where(accept, count, new_count)
        ).astype(jnp.int32)
        return (poly, count), None

    # Stack the 6 halfspaces: for axis i and side j in {-1, +1},
    # halfspace is (-j*Bnormal).P + (-Bd) >= 0 with Bd = -j*BnBc - Ah[i]
    # (ref :129-151).
    axes = []
    ds = []
    crosses = []
    for i in range(3):
        Bn = AR[:, i]
        BnBc = Bn @ Bc
        cr = jnp.linalg.norm(jnp.cross(Bn, Rnormal))
        for j in (-1.0, 1.0):
            Bd = -j * BnBc - Ah[i]
            axes.append(-j * Bn)
            ds.append(Bd)
            crosses.append(cr)
    # Unrolled (6 static halfspaces): lets XLA fuse the whole clip chain
    # into one elementwise program instead of a scan with carried state.
    carry = (poly, count)
    for k in range(6):
        carry, _ = clip_one(carry, (axes[k], ds[k], crosses[k]))
    poly, count = carry
    return poly, count


# ---------------------------------------------------------------------------
# Edge-edge closest approach


def _line_closest_approach(pa, ua, pb, ub):
    """alpha, beta minimising |pa + alpha ua - pb - beta ub|.

    Ref: eggshell/collision.cc:47-62."""
    p = pb - pa
    uaub = ua @ ub
    q1 = ua @ p
    q2 = -(ub @ p)
    d = 1 - uaub * uaub
    degenerate = d == 0
    safe_d = jnp.where(degenerate, 1.0, d)
    alpha = jnp.where(degenerate, 0.0, (q1 + uaub * q2) / safe_d)
    beta = jnp.where(degenerate, 0.0, (uaub * q1 + q2) / safe_d)
    return alpha, beta


# ---------------------------------------------------------------------------
# The SAT narrowphase


def collide_boxes(p1, R1, hs1, p2, R2, hs2) -> PairContacts:
    """Branchless ODE-style SAT box-box collision for one pair.

    Semantics mirror eggshell/collision.cc:166-388; vmap over leading axes
    for batched pair testing.  `hs*` are HALF side lengths.
    """
    dtype = p1.dtype
    H1, H2 = hs1, hs2

    R = R1.T @ R2                # box2 rotation in box1 frame (ref :195)
    p = R1.T @ (p2 - p1)         # box2 center in box1 frame
    Q = jnp.abs(R)

    # Nearly-axis-aligned column count (ref :200-203)
    aacount = jnp.sum(
        (jnp.max(Q, axis=0) > ALIGNMENT_TOLERANCE).astype(jnp.int32)
    )

    # --- 6 face-normal separating axes (ref :215-233) ---
    e1_face = jnp.concatenate([p, R.T @ p])  # (6,)
    r_face = jnp.concatenate([H1 + Q @ H2, Q.T @ H1 + H2])
    sep_face = jnp.abs(e1_face) - r_face      # >0 => separated
    normals_face = jnp.concatenate([R1.T, R2.T], axis=0)  # rows = global axes
    # code i+1; pick max separation (= min depth)
    i_fn = jnp.argmax(sep_face)
    min_depth_FN = sep_face[i_fn]
    sepaxis_FN = _sign(e1_face[i_fn]) * normals_face[i_fn]
    code_FN = (i_fn + 1).astype(jnp.int32)

    # --- 9 edge x edge axes (ref :243-276) ---
    # n_ab = cross(e_a, R[:, b]) in box1 frame, a-major ordering, code 7+3a+b.
    eye = jnp.eye(3, dtype=dtype)
    # (a, b, 3)
    n_ab = jnp.cross(eye[:, None, :], R.T[None, :, :])
    n = n_ab.reshape(9, 3)
    # Double-where so reverse-mode stays NaN-free: parallel edge pairs
    # make n exactly zero (generic for axis-aligned stacks), and
    # d||n||/dn = n/||n|| is 0/0 there even under a zero cotangent.
    l2 = jnp.sum(n * n, axis=-1)
    valid = l2 > TOL * TOL
    length = jnp.sqrt(jnp.where(valid, l2, 1.0))
    e1_ee = n @ p
    # span of box1: H1 . |n|; span of box2: via Q rows (ref :258-275)
    span1 = jnp.abs(n) @ H1
    # |n expressed in box2 frame| pattern: for axis (a,b) the box2-side span
    # is sum_{c != b} H2[c] * Q[a, 3 - b - c]; build it explicitly.
    Qr = Q  # (3,3)
    span2 = jnp.stack(
        [
            H2[1] * Qr[0, 2] + H2[2] * Qr[0, 1],
            H2[0] * Qr[0, 2] + H2[2] * Qr[0, 0],
            H2[0] * Qr[0, 1] + H2[1] * Qr[0, 0],
            H2[1] * Qr[1, 2] + H2[2] * Qr[1, 1],
            H2[0] * Qr[1, 2] + H2[2] * Qr[1, 0],
            H2[0] * Qr[1, 1] + H2[1] * Qr[1, 0],
            H2[1] * Qr[2, 2] + H2[2] * Qr[2, 1],
            H2[0] * Qr[2, 2] + H2[2] * Qr[2, 0],
            H2[0] * Qr[2, 1] + H2[1] * Qr[2, 0],
        ]
    )
    sep_ee_raw = jnp.abs(e1_ee) - (span1 + span2)   # unnormalised
    separated_ee = valid & (sep_ee_raw > 0)
    safe_len = jnp.where(valid, length, 1.0)
    sep_ee = jnp.where(valid, sep_ee_raw / safe_len, -jnp.inf)
    i_ee = jnp.argmax(sep_ee)
    min_depth_EE = sep_ee[i_ee]
    n_best = n[i_ee]
    sepaxis_EE = R1 @ (n_best / (_sign(e1_ee[i_ee]) * safe_len[i_ee]))
    code_EE = (7 + i_ee).astype(jnp.int32)

    separated = jnp.any(sep_face > 0) | jnp.any(separated_ee)

    best_is_FN = min_depth_FN > min_depth_EE
    info_depth = jnp.where(best_is_FN, -min_depth_FN, -min_depth_EE)
    info_axis = jnp.where(best_is_FN, sepaxis_FN, sepaxis_EE)

    # =======================================================================
    # Contact generation — compute BOTH branches, select with `where`.

    # --- Edge-edge contact (ref :295-318) ---
    sa1 = sepaxis_EE @ R1  # components along box1 axes
    sa2 = sepaxis_EE @ R2
    pa = p1 + R1 @ (_sign(sa1) * H1)
    pb = p2 - R2 @ (_sign(sa2) * H2)
    a_idx = (code_EE - 7) // 3
    b_idx = (code_EE - 7) % 3
    ua = R1 @ jax.nn.one_hot(a_idx, 3, dtype=dtype)
    ub = R2 @ jax.nn.one_hot(b_idx, 3, dtype=dtype)
    alpha, beta = _line_closest_approach(pa, ua, pb, ub)
    ee_pos = (pa + ua * alpha + pb + ub * beta) * 0.5
    ee_depth = -min_depth_EE

    # --- Face-something contact (ref :320-372) ---
    A_is_1 = code_FN <= 3
    Ac = jnp.where(A_is_1, p1, p2)
    AR = jnp.where(A_is_1, R1, R2)
    Ah = jnp.where(A_is_1, H1, H2)
    Bc0 = jnp.where(A_is_1, p2, p1)
    BR0 = jnp.where(A_is_1, R2, R1)
    Bh0 = jnp.where(A_is_1, H2, H1)
    Aface_normal = sepaxis_FN * jnp.where(A_is_1, 1.0, -1.0)

    # Incident face of B (ref :334-337)
    nf = BR0.T @ Aface_normal
    nf_idx = jnp.argmax(jnp.abs(nf))
    nf_sel = jax.nn.one_hot(nf_idx, 3, dtype=dtype)
    Bface_normal = -_sign(nf @ nf_sel) * (BR0 @ nf_sel)

    # Rectangle box: permute axes so the face plane is spanned by cols 0,1
    # (ref :342-352)
    perm1 = (nf_idx + 1) % 3
    perm2 = (nf_idx + 2) % 3
    s1 = jax.nn.one_hot(perm1, 3, dtype=dtype)
    s2 = jax.nn.one_hot(perm2, 3, dtype=dtype)
    Rc = Bc0 + Bface_normal * (Bh0 @ nf_sel)
    RRm = jnp.stack([BR0 @ s1, BR0 @ s2, BR0 @ nf_sel], axis=1)
    Rh = jnp.stack([Bh0 @ s1, Bh0 @ s2, jnp.asarray(0.0, dtype)])

    # Reference face plane (ref :356-358)
    face_axis = (code_FN - 1) % 3
    AfaceCenter = Ac + Aface_normal * (Ah @ jax.nn.one_hot(face_axis, 3, dtype=dtype))
    Ad = -(Aface_normal @ AfaceCenter)

    poly, pcount = _intersect_box_and_rectangle(Ac, AR, Ah, Rc, RRm, Rh)
    lane = jnp.arange(MAX_POLY)
    in_poly = lane < pcount
    face_pos = Rc[None, :] + poly[:, :1] * RRm[:, 0][None, :] + poly[:, 1:2] * RRm[:, 1][None, :]
    face_depth = -(face_pos @ Aface_normal + Ad)
    # Heuristic contact filter (ref :367-369): keep zero-depth contacts only
    # when aacount >= 2.
    keep = in_poly & ((jnp.abs(face_depth) > TOL) | (aacount >= 2))
    any_face = jnp.any(keep)

    # Deep-penetration fallback (ref :380-386)
    fb_pos = p2
    fb_depth = -min_depth_FN

    # --- Select branch ---
    use_ee = (aacount == 0) & (~best_is_FN)

    positions = jnp.where(
        use_ee,
        jnp.broadcast_to(ee_pos, (MAX_POLY, 3)),
        jnp.where(any_face, face_pos, jnp.broadcast_to(fb_pos, (MAX_POLY, 3))),
    )
    depths = jnp.where(
        use_ee,
        jnp.full((MAX_POLY,), ee_depth, dtype),
        jnp.where(any_face, face_depth, jnp.full((MAX_POLY,), fb_depth, dtype)),
    )
    normal = jnp.where(use_ee, sepaxis_EE, sepaxis_FN)
    one_lane = lane == 0
    active = jnp.where(use_ee, one_lane, jnp.where(any_face, keep, one_lane))
    active = active & ~separated

    code = jnp.where(
        separated,
        0,
        jnp.where(use_ee, code_EE, jnp.where(any_face, code_FN, 16)),
    ).astype(jnp.int32)

    return PairContacts(
        position=positions,
        normal=jnp.broadcast_to(normal, (MAX_POLY, 3)),
        depth=depths,
        active=active,
        code=code,
        info_depth=jnp.where(separated, 0.0, info_depth),
        separating_axis=info_axis,
    )


def collide_box_and_ground(p, R, hs):
    """8-corner z<0 ground test (ref eggshell/collision.cc:408-432).

    Returns (position (8,3), normal (8,3), depth (8,), active (8,)).
    Corner ordering matches the reference's x-major/y/z sign loops.
    """
    dtype = p.dtype
    signs = jnp.array(
        [[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0) for z in (-1.0, 1.0)],
        dtype,
    )
    corners = p[None, :] + (signs * hs[None, :]) @ R.T
    active = corners[:, 2] < 0
    depth = -corners[:, 2]
    normal = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], dtype), (8, 3))
    return corners, normal, depth, active
