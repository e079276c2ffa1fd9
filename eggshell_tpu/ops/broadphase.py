"""Broadphase collision pruning — toolkit/collision.{h,cc} equivalent.

The reference provides D-dimensional AABBs + a sweep-and-prune that
returns overlapping pairs (toolkit/collision.h:22-45); eggshell itself
tests all pairs (eggshell/ensembles.cc:460-474).  Fixed-shape version:

- `box_aabbs`: world AABBs of oriented boxes (|R| trick, one fused op).
- `pair_overlap_mask`: AABB overlap test for a static candidate pair
  list — fixed shapes, no dynamic pair vectors.
- `select_pairs`: stable compaction of the overlapping pairs into a
  fixed capacity, so the narrowphase only runs on plausible pairs
  (the sort-based analog of sweep-and-prune's active list).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from eggshell_tpu.ops import quaternion as quat


def box_aabbs(p: jax.Array, q: jax.Array, half_extents: jax.Array,
              margin: float = 0.0) -> Tuple[jax.Array, jax.Array]:
    """(lo, hi) world AABBs: extent along each world axis is |R| @ h."""
    R = quat.quat_to_mat(q)
    ext = jnp.einsum("nij,nj->ni", jnp.abs(R), half_extents) + margin
    return p - ext, p + ext


def aabb_overlap(lo1, hi1, lo2, hi2) -> jax.Array:
    """Elementwise AABB overlap predicate (broadcasts)."""
    return jnp.all((lo1 <= hi2) & (lo2 <= hi1), axis=-1)


def pair_overlap_mask(
    p: jax.Array, q: jax.Array, half_extents: jax.Array,
    pair_i: jax.Array, pair_j: jax.Array, margin: float = 0.0,
) -> jax.Array:
    """(P,) bool: candidate pairs whose AABBs overlap.

    Computed as a full (n, n) broadcast overlap matrix followed by ONE
    boolean gather per pair instead of gathering 4 x (P, 3) AABB
    corners per pair."""
    lo, hi = box_aabbs(p, q, half_extents, margin)
    M = aabb_overlap(
        lo[:, None, :], hi[:, None, :], lo[None, :, :], hi[None, :, :]
    )
    return M[pair_i, pair_j]


def select_pairs(
    mask: jax.Array, pair_i: jax.Array, pair_j: jax.Array, capacity: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Compact overlapping pairs into `capacity` lanes (stable order).
    Returns (sel_i, sel_j, active) with inactive lanes pointing at pair 0.

    Uses top_k on a rank score (descending = original pair order) —
    O(P log capacity)-ish versus a full O(P log P) argsort of the mask;
    at P=131k / capacity=4k this is the difference between the
    broadphase being visible in the step profile and not."""
    P = mask.shape[0]
    score = jnp.where(mask, P - jnp.arange(P, dtype=jnp.int32), 0)
    v, order = jax.lax.top_k(score, capacity)
    active = v > 0
    return (
        jnp.where(active, pair_i[order], 0),
        jnp.where(active, pair_j[order], 0),
        active,
    )


def sap_select_pairs(
    p: jax.Array, q: jax.Array, half_extents: jax.Array,
    capacity: int, window: int, margin: float = 0.0,
    num_pairs: int = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Sorted sweep-and-prune pair selection — the actual sorted-list
    analog of the reference broadphase (toolkit/collision.h:22-45,
    sorted AABB endpoints swept along one axis), in fixed shapes.

    Bodies are argsorted by AABB min-x; a pair can only overlap in x if
    their sorted ranks are within `window` of each other (window plays
    the role of the reference's dynamic active list — it bounds how
    many boxes can straddle any x coordinate).  Overlap is then tested
    on the (n, window) candidate strip only: O(n log n + n*window)
    work instead of the O(n^2) broadcast mask, which is what makes it
    win above ~1k bodies (see docs/architecture.md round-5 measurement).

    Returns (pi, pj, active) exactly like select_pairs, in the SAME
    canonical pair order (lanes ranked by the all-pairs lexicographic
    index), so downstream contact lanes and dedupe are bit-identical
    to the mask path whenever window was large enough.
    Assumes the canonical all-pairs i<j enumeration; num_pairs defaults
    to n(n-1)/2.
    """
    lo, hi = box_aabbs(p, q, half_extents, margin)
    n = lo.shape[0]
    if num_pairs is None:
        num_pairs = n * (n - 1) // 2
    order = jnp.argsort(lo[:, 0])
    lo_s = lo[order]
    hi_s = hi[order]
    k = jnp.arange(n, dtype=jnp.int32)[:, None]          # (n, 1)
    d = jnp.arange(1, window + 1, dtype=jnp.int32)[None]  # (1, W)
    jdx = jnp.minimum(k + d, n - 1)                       # (n, W)
    valid = (k + d) < n
    # x sweep: sorted by lo-x, so overlap in x iff lo_x[j] <= hi_x[k]
    ov = lo_s[jdx, 0] <= hi_s[:, 0][:, None]
    # remaining axes: full interval test
    for ax in (1, 2):
        ov &= (lo_s[jdx, ax] <= hi_s[:, ax][:, None]) & (
            lo_s[:, ax][:, None] <= hi_s[jdx, ax]
        )
    ov &= valid
    a = jnp.broadcast_to(order[:, None], (n, window))
    b = order[jdx]
    bi = jnp.minimum(a, b).reshape(-1)
    bj = jnp.maximum(a, b).reshape(-1)
    mask = ov.reshape(-1)
    # canonical lexicographic pair rank (matches make_scene's default
    # pair list) so lane order is identical to select_pairs
    rank = bi * (2 * n - bi - 1) // 2 + (bj - bi - 1)
    score = jnp.where(mask, num_pairs - rank, 0)
    if capacity > score.shape[0]:       # capacity exceeds the strip
        pad = capacity - score.shape[0]
        score = jnp.pad(score, (0, pad))
        bi = jnp.pad(bi, (0, pad))
        bj = jnp.pad(bj, (0, pad))
    v, sel = jax.lax.top_k(score, capacity)
    active = v > 0
    return (
        jnp.where(active, bi[sel], 0),
        jnp.where(active, bj[sel], 0),
        active,
    )


def _canonical_pairs(spec) -> bool:
    """True when spec's pair list is the all-pairs i<j enumeration (the
    make_scene default) — the precondition for the SaP rank mapping."""
    import numpy as np

    n = spec.half_extents.shape[0]
    P = spec.num_pairs
    if P != n * (n - 1) // 2:
        return False
    pi = np.asarray(spec.pair_i)
    pj = np.asarray(spec.pair_j)
    ci, cj = np.triu_indices(n, k=1)
    return bool(np.array_equal(pi, ci) and np.array_equal(pj, cj))


def select_scene_pairs(spec, state, cfg):
    """Per-scene broadphase: AABB-prune spec's candidate pairs and
    compact them into cfg.pair_capacity lanes.  Dispatches on
    cfg.broadphase_kind: "mask" = (n, n) broadcast overlap + top_k
    (the default), "sap" = sorted
    sweep-and-prune strip (wins at larger n; falls back to mask when
    the spec's pair list is not the canonical all-pairs set)."""
    try:
        canonical = cfg.broadphase_kind == "sap" and _canonical_pairs(spec)
    except jax.errors.TracerArrayConversionError:
        canonical = False       # spec traced (not closed over): no
        #                         host-side canonicity check possible
    if canonical:
        return sap_select_pairs(
            state.p, state.q, spec.half_extents, cfg.pair_capacity,
            cfg.sap_window, cfg.broadphase_margin, spec.num_pairs,
        )
    mask = pair_overlap_mask(
        state.p, state.q, spec.half_extents,
        spec.pair_i, spec.pair_j, cfg.broadphase_margin,
    )
    return select_pairs(mask, spec.pair_i, spec.pair_j, cfg.pair_capacity)


def sweep_and_prune_pairs(lo: jax.Array, hi: jax.Array, capacity: int):
    """All-axis AABB pruning over ALL n^2/2 pairs, compacted to a fixed
    capacity — the dense-mask analog of the reference's sweep-and-prune
    (toolkit/collision.cc), without sorted endpoint lists."""
    n = lo.shape[0]
    i = jnp.arange(n)
    pair_mask = (
        aabb_overlap(lo[:, None, :], hi[:, None, :], lo[None, :, :], hi[None, :, :])
        & (i[:, None] < i[None, :])
    )
    pi, pj = jnp.nonzero(pair_mask, size=capacity, fill_value=0)
    active = jnp.arange(capacity) < jnp.sum(pair_mask)
    return pi, pj, active
