"""Scene specification and simulation state — fixed-shape SoA pytrees.

Fixed-shape replacement for the reference's object graph (shared_ptr
``Body``/``Joint``/``Contact`` lists inside ``Ensemble``,
eggshell/ensembles.h:73-89): a `SceneSpec` holds everything static
(masses, inertias, geometry, joint topology, candidate collision pairs)
and a `State` holds the per-step dynamic state (p, v, q, w) as
structure-of-arrays with an optional leading batch dimension.

All counts are fixed at trace time: the dynamically sized
``std::vector<Contact>`` of the reference (ensembles.cc:445-474) becomes
a fixed-capacity masked `ContactSet` (see physics/contacts.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from eggshell_tpu.ops import quaternion as quat


class SceneSpec(NamedTuple):
    """Static description of a scene (a pytree; leaves are arrays).

    Bodies (n):
      inv_mass       (n,)    0 => static/kinematic body (infinite mass)
      inertia_body   (n,3,3) body-frame inertia (ref eggshell/body.h:86)
      inv_inertia_body (n,3,3)
      half_extents   (n,3)   box half side lengths
      ground_enabled (n,)    body participates in ground collision

    Ball-and-socket joints (J) (ref eggshell/joints.h:31-51):
      joint_b0, joint_b1 (J,) int32; -1 in joint_b1 => world anchor
      joint_c0 (J,3) attachment offset in b0's frame
      joint_c1 (J,3) offset in b1's frame, or the world-frame anchor
                     point when joint_b1 == -1 (ref joints.cc:5-8)

    Candidate collision pairs (P):
      pair_i, pair_j (P,) int32 — the all-pairs i<j set by default
      (ref ensembles.cc:460-474); a broadphase may produce a subset.
    """

    inv_mass: jax.Array
    inertia_body: jax.Array
    inv_inertia_body: jax.Array
    half_extents: jax.Array
    ground_enabled: jax.Array
    joint_b0: jax.Array
    joint_b1: jax.Array
    joint_c0: jax.Array
    joint_c1: jax.Array
    pair_i: jax.Array
    pair_j: jax.Array

    @property
    def num_bodies(self) -> int:
        return self.inv_mass.shape[-1]

    @property
    def num_joints(self) -> int:
        return self.joint_b0.shape[-1]

    @property
    def num_pairs(self) -> int:
        return self.pair_i.shape[-1]


class State(NamedTuple):
    """Dynamic state (ref eggshell/body.h:80-86, SoA):
    p (..., n, 3) position, v (..., n, 3) linear velocity,
    q (..., n, 4) orientation quaternion (wxyz),
    w (..., n, 3) angular velocity in the GLOBAL frame."""

    p: jax.Array
    v: jax.Array
    q: jax.Array
    w: jax.Array

    def R(self) -> jax.Array:
        return quat.quat_to_mat(self.q)


def make_scene(
    positions: Sequence,
    *,
    quats: Optional[Sequence] = None,
    velocities: Optional[Sequence] = None,
    angular_velocities: Optional[Sequence] = None,
    masses: Optional[Sequence] = None,
    inertias: Optional[Sequence] = None,
    half_extents: Optional[Sequence] = None,
    static: Optional[Sequence] = None,
    joints: Sequence = (),
    ground: bool = True,
    pairs: Optional[Sequence] = None,
    dtype=jnp.float64,
) -> tuple[SceneSpec, State]:
    """Host-side scene builder (NumPy in, pytrees out).

    joints: iterable of (b0, b1, c0, c1) with b1 = -1 for a world anchor;
    c1 is then the world anchor position (ref eggshell/ensembles.cc:702-707).
    Default box: unit mass, 0.3 side lengths (ref eggshell/body.h:91),
    box inertia (ref eggshell/body.cc:19-36).
    """
    p = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    n = p.shape[0]
    q = (
        np.asarray(quats, np.float64).reshape(n, 4)
        if quats is not None
        else np.tile([1.0, 0, 0, 0], (n, 1))
    )
    v = (
        np.asarray(velocities, np.float64).reshape(n, 3)
        if velocities is not None
        else np.zeros((n, 3))
    )
    w = (
        np.asarray(angular_velocities, np.float64).reshape(n, 3)
        if angular_velocities is not None
        else np.zeros((n, 3))
    )
    m = (
        np.asarray(masses, np.float64).reshape(n)
        if masses is not None
        else np.ones(n)
    )
    he = (
        np.asarray(half_extents, np.float64).reshape(n, 3)
        if half_extents is not None
        else np.full((n, 3), 0.15)
    )
    if inertias is not None:
        I = np.asarray(inertias, np.float64).reshape(n, 3, 3)
    else:
        I = np.asarray(quat.box_inertia(jnp.asarray(m), jnp.asarray(2.0 * he)))
    stat = (
        np.asarray(static, bool).reshape(n)
        if static is not None
        else np.zeros(n, bool)
    )
    inv_mass = np.where(stat, 0.0, 1.0 / m)
    inv_I = np.zeros_like(I)
    inv_I[~stat] = np.linalg.inv(I[~stat])

    joints = list(joints)
    if joints:
        jb0 = np.asarray([j[0] for j in joints], np.int32)
        jb1 = np.asarray([j[1] for j in joints], np.int32)
        jc0 = np.asarray([j[2] for j in joints], np.float64).reshape(-1, 3)
        jc1 = np.asarray([j[3] for j in joints], np.float64).reshape(-1, 3)
    else:
        jb0 = np.zeros((0,), np.int32)
        jb1 = np.zeros((0,), np.int32)
        jc0 = np.zeros((0, 3))
        jc1 = np.zeros((0, 3))

    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    pi = np.asarray([a for a, _ in pairs], np.int32).reshape(-1)
    pj = np.asarray([b for _, b in pairs], np.int32).reshape(-1)

    spec = SceneSpec(
        inv_mass=jnp.asarray(inv_mass, dtype),
        inertia_body=jnp.asarray(I, dtype),
        inv_inertia_body=jnp.asarray(inv_I, dtype),
        half_extents=jnp.asarray(he, dtype),
        ground_enabled=jnp.full((n,), bool(ground)),
        joint_b0=jnp.asarray(jb0),
        joint_b1=jnp.asarray(jb1),
        joint_c0=jnp.asarray(jc0, dtype),
        joint_c1=jnp.asarray(jc1, dtype),
        pair_i=jnp.asarray(pi),
        pair_j=jnp.asarray(pj),
    )
    state = State(
        p=jnp.asarray(p, dtype),
        v=jnp.asarray(v, dtype),
        q=quat.quat_normalize(jnp.asarray(q, dtype)),
        w=jnp.asarray(w, dtype),
    )
    return spec, state


# ---------------------------------------------------------------------------
# Mass matrix / forces


def inv_mass_blocks(spec: SceneSpec, state: State) -> jax.Array:
    """Per-body 6x6 inverse mass-inertia blocks [m^-1 I3; (R I_b R^T)^-1]
    (ref eggshell/ensembles.cc:202-212).  Returns (n, 6, 6)."""
    n = spec.num_bodies
    R = state.R()
    inv_Ig = R @ spec.inv_inertia_body @ jnp.swapaxes(R, -1, -2)
    eye3 = jnp.eye(3, dtype=state.p.dtype)
    top = spec.inv_mass[:, None, None] * eye3
    zero = jnp.zeros((n, 3, 3), state.p.dtype)
    upper = jnp.concatenate([top, zero], axis=-1)
    lower = jnp.concatenate([zero, inv_Ig], axis=-1)
    return jnp.concatenate([upper, lower], axis=-2)


def external_forces(spec: SceneSpec, state: State, gravity) -> jax.Array:
    """Gravity + gyroscopic torque per body, (n, 6)
    (ref eggshell/ensembles.cc:214-222): F = [m g; -w x (I_g w)]."""
    dtype = state.p.dtype
    g = jnp.asarray(gravity, dtype)
    mass = jnp.where(spec.inv_mass > 0, 1.0 / jnp.where(spec.inv_mass > 0, spec.inv_mass, 1.0), 0.0)
    fg = mass[:, None] * g[None, :]
    R = state.R()
    Ig = R @ spec.inertia_body @ jnp.swapaxes(R, -1, -2)
    torque = -jnp.cross(state.w, jnp.einsum("nij,nj->ni", Ig, state.w))
    return jnp.concatenate([fg, torque], axis=-1)


def pack_velocity(state: State) -> jax.Array:
    """(n, 6) [v; w] rows (ref GetVelocities, ensembles.cc:429-436)."""
    return jnp.concatenate([state.v, state.w], axis=-1)


def unpack_velocity(state: State, u: jax.Array) -> State:
    return state._replace(v=u[..., :3], w=u[..., 3:])
