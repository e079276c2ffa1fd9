"""Constraint-based time steppers — the ODE-style velocity stepper.

Batched re-design of the reference's integrators
(eggshell/ensembles.cc:390-666):

  step_ode             ERP/CFM velocity stepping + mixed LCP + midpoint
                       position update (ref StepVelocities_ODE :563-575,
                       StepPositions_ODE :577-591)
  step_explicit_euler  equality-only path (ref :540-561); unlike the
                       reference — whose JDotV for joints is a Panic stub
                       (ensembles.cc:96-97) — the JdotV term is actually
                       implemented here (ref joints.cc:37-47 formulas)
  init_stabilize       position relaxation to the constraint manifold
                       (ref :602-622)
  post_stabilize       position+velocity relaxation (ref :624-657); this
                       build refreshes contact geometry every iteration
                       (the reference reuses the stale contact set)

All functions take one scene; batch with `jax.vmap`, roll out with
`jax.lax.scan`, distribute with `shard_map` (see parallel/).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from eggshell_tpu.ops import lcp, lcp_direct
from eggshell_tpu.ops import quaternion as quat
from eggshell_tpu.physics import scene as scn
from eggshell_tpu.physics.constraints import ConstraintSystem, build_constraints
from eggshell_tpu.physics.contacts import ContactSet, make_contacts
from eggshell_tpu.physics.scene import SceneSpec, State
from eggshell_tpu.utils.config import SimConfig, SolverKind
from eggshell_tpu.utils.precision import HIGHEST, full_precision


# ---------------------------------------------------------------------------
# System matrix


def _flat_J(sys: ConstraintSystem) -> jax.Array:
    m = sys.num_rows
    return sys.J.reshape(m, -1)


def system_matrix(
    spec: SceneSpec, state: State, sys: ConstraintSystem, cfg: SimConfig
) -> jax.Array:
    """A = J M^-1 J^T with CFM and masked-lane unit diagonal.

    Inactive rows have zero J, so they decouple; their diagonal is set to
    the max active diagonal, which keeps cond(A) equal to the active
    block's condition number (max diag <= max eig and >= min eig for PSD).

    CFM policy (ref ensembles.cc:510-521): with `conditional_cfm`, add
    cfg.cfm * I on active rows only when the estimated condition number
    exceeds cfg.good_condition_number; otherwise add cfg.cfm_always
    unconditionally (the batched fast path).
    """
    Minv = scn.inv_mass_blocks(spec, state)
    JM = jnp.einsum("mnk,nkl->mnl", sys.J, Minv, precision=HIGHEST)
    A = jnp.einsum("mnl,onl->mo", JM, sys.J, precision=HIGHEST)

    diag_scale = jnp.max(
        jnp.where(sys.row_active, jnp.diagonal(A), 0.0)
    )
    diag_scale = jnp.where(diag_scale > 0, diag_scale, 1.0)
    A = A + jnp.diag(jnp.where(sys.row_active, 0.0, diag_scale))

    if cfg.conditional_cfm:
        if cfg.cond_estimator == "exact":
            # Exact spectrum — matches the reference's SVD-based
            # CheckMatrixCondition decision bit-for-bit (utils.cc:256-261),
            # required by the golden-parity gate.
            eigs = jnp.linalg.eigvalsh(A)
            lam_max = eigs[-1]
            lam_min = eigs[0]
        else:
            # Cheap estimate (ref's check is advisory, ensembles.cc:514):
            # lambda_max by power iteration, lambda_min by inverse
            # iteration through one Cholesky factor — ~5x cheaper than a
            # full eigendecomposition at these sizes, same O(m^3) solve
            # the DIRECT path performs anyway.
            m = A.shape[0]
            v = jnp.full((m,), 1.0 / jnp.sqrt(m), A.dtype)

            def pow_it(v, _):
                w = A @ v
                return w / jnp.maximum(jnp.linalg.norm(w), 1e-300), None

            v, _ = jax.lax.scan(pow_it, v, None, length=12)
            lam_max = v @ (A @ v)
            L = jnp.linalg.cholesky(A)

            def inv_it(v, _):
                w = jax.scipy.linalg.cho_solve((L, True), v)
                return w / jnp.maximum(jnp.linalg.norm(w), 1e-300), None

            u, _ = jax.lax.scan(inv_it, v, None, length=12)
            lam_min = u @ (A @ u)
            # a failed factorization (singular A) must read as "bad"
            lam_min = jnp.where(jnp.isfinite(lam_min), lam_min, 0.0)
        bad = (lam_min <= 0) | (
            lam_max / jnp.maximum(lam_min, 1e-300)
            > cfg.good_condition_number
        )
        cfm = jnp.where(bad, cfg.cfm, 0.0)
    else:
        cfm = jnp.asarray(cfg.cfm_always, A.dtype)
    return A + jnp.diag(jnp.where(sys.row_active, cfm, 0.0))


def _solve_lambda(A, rhs, sys: ConstraintSystem, cfg: SimConfig):
    if cfg.solver == SolverKind.DIRECT:
        # IFT-VJP wrapper: the pivot loop itself is a while_loop (not
        # reverse-differentiable), but the solution's active set gives
        # the exact adjoint — jax.grad works through the oracle path
        # too (ops/lcp_direct.mixed_constraints_solver_implicit).
        return lcp_direct.mixed_constraints_solver_implicit(
            A, rhs, sys.is_eq, sys.lo, sys.hi
        )
    method = {
        SolverKind.PGS: "pgs",
        SolverKind.JACOBI: "jacobi",
        SolverKind.SOR: "sor",
    }[cfg.solver]
    check_tol = cfg.solver_tol if cfg.solver_tol > 0 else None
    from eggshell_tpu.utils.config import FrictionModel

    coulomb = cfg.friction_model == FrictionModel.COULOMB_PYRAMID
    return lcp.solve_lcp(
        A, rhs, sys.is_eq, sys.lo, sys.hi,
        iters=cfg.solver_iters, method=method, check_tol=check_tol,
        omega=cfg.sor_omega, jacobi_omega=cfg.jacobi_omega,
        jacobi_beta=cfg.jacobi_beta,
        couple=sys.couple if coulomb else None,
        mu=cfg.friction_mu if coulomb else 0.0,
        jacobi_block=bool(cfg.jacobi_block),
    )


# ---------------------------------------------------------------------------
# ODE-style step


def _pre_solve(spec, state, cfg, ext_force):
    """Everything up to the lambda solve: contacts, constraints, rhs, A."""
    dt = cfg.dt
    cs = make_contacts(spec, state, cfg)
    sys = build_constraints(spec, state, cs, cfg)

    u = scn.pack_velocity(state)                 # (n, 6)
    Minv = scn.inv_mass_blocks(spec, state)
    F = scn.external_forces(spec, state, cfg.gravity)
    if ext_force is not None:
        F = F + ext_force
    MinvF = jnp.einsum("nij,nj->ni", Minv, F)

    # rhs = -erp/dt^2 err - J (v/dt + Minv F)   (ref :563-571)
    rhs = -cfg.erp / dt / dt * sys.err - jnp.einsum(
        "mnk,nk->m", sys.J, u / dt + MinvF
    )
    A = system_matrix(spec, state, sys, cfg)
    return cs, sys, A, rhs, u, Minv, F


def _post_solve(state, cfg, sys, lam, u, Minv, F):
    """v_dot = Minv (F + J^T lambda); midpoint position update
    (ref :498-538, :577-591)."""
    dt = cfg.dt
    JTlam = jnp.einsum("mnk,m->nk", sys.J, lam)
    vdot = jnp.einsum("nij,nj->ni", Minv, F + JTlam)
    u_new = u + dt * vdot

    u_mid = 0.5 * (u + u_new)
    p_new = state.p + dt * u_mid[:, :3]
    q_new = quat.integrate_quat(state.q, u_mid[:, 3:], dt)
    return State(p=p_new, v=u_new[:, :3], q=q_new, w=u_new[:, 3:])


def _step_matrix_free(spec, state, cfg, ext_force, cs=None):
    """ODE step for ONE LARGE scene: compact two-body constraint blocks +
    matrix-free projected Jacobi — O(n + K) memory, JMJ^T never formed
    (ref sparse_iterations_utils.cc:624-695 CalculateSparseJMJtX, the
    reference's answer to exactly this scaling problem).  `cs` injects a
    precomputed contact set (the batched path detects contacts for all
    scenes first)."""
    from eggshell_tpu.ops import lcp_matrix_free as mf
    from eggshell_tpu.physics.constraints import build_compact_constraints

    dt = cfg.dt
    n = spec.num_bodies
    if cs is None:
        cs = make_contacts(spec, state, cfg)
    sysc = build_compact_constraints(spec, state, cs, cfg)

    u = scn.pack_velocity(state)
    Minv = scn.inv_mass_blocks(spec, state)
    F = scn.external_forces(spec, state, cfg.gravity)
    if ext_force is not None:
        F = F + ext_force
    MinvF = jnp.einsum("nij,nj->ni", Minv, F)

    rhs = -cfg.erp / dt / dt * sysc.err - mf.j_v(
        sysc.blocks, sysc.b0, sysc.b1, u / dt + MinvF
    )
    lam = mf.solve_lcp_matrix_free(
        sysc.blocks, sysc.b0, sysc.b1, Minv, rhs, sysc.is_eq,
        sysc.lo, sysc.hi,
        iters=cfg.solver_iters, omega=cfg.jacobi_omega,
        beta=cfg.jacobi_beta, cfm=float(cfg.cfm_always),
    )
    JTlam = mf.jt_x(sysc.blocks, sysc.b0, sysc.b1, lam, n)
    vdot = jnp.einsum("nij,nj->ni", Minv, F + JTlam)
    u_new = u + dt * vdot
    u_mid = 0.5 * (u + u_new)
    p_new = state.p + dt * u_mid[:, :3]
    q_new = quat.integrate_quat(state.q, u_mid[:, 3:], dt)
    return State(p=p_new, v=u_new[:, :3], q=q_new, w=u_new[:, 3:]), cs


@functools.partial(jax.jit, static_argnames=("cfg",))
@full_precision
def step_ode(
    spec: SceneSpec,
    state: State,
    cfg: SimConfig,
    ext_force: Optional[jax.Array] = None,
) -> Tuple[State, ContactSet]:
    """One OPEN_DYNAMICS_ENGINE step (ref Ensemble::Step, ensembles.cc:390-427
    with g = OPEN_DYNAMICS_ENGINE).  Returns (new_state, contact_set).

    `ext_force` (n, 6) adds control wrenches [force; torque] per body on
    top of gravity + gyroscopic terms — the MPC control input (a new
    capability; the reference has no actuation).

    With cfg.solver == SolverKind.MATRIX_FREE the step never forms the
    dense Jacobian or JMJ^T — the large-single-scene path (hundreds to
    thousands of bodies, see `_step_matrix_free`)."""
    if cfg.solver == SolverKind.MATRIX_FREE:
        return _step_matrix_free(spec, state, cfg, ext_force)
    cs, sys, A, rhs, u, Minv, F = _pre_solve(spec, state, cfg, ext_force)
    lam = _solve_lambda(A, rhs, sys, cfg)
    return _post_solve(state, cfg, sys, lam, u, Minv, F), cs


def _batched_system(spec, states, cfg, ext_forces):
    """Contacts, constraint rows, A = J M^-1 J^T and rhs for every scene
    of a batch (vmapped XLA).  `ext_forces` is (n, 6), shared by all
    scenes, or (B, n, 6)."""
    from eggshell_tpu.physics.contacts import make_contacts_batched

    with jax.named_scope("contacts"):
        css = make_contacts_batched(spec, states, cfg)
    per_scene = ext_forces is not None and ext_forces.ndim == 3

    def pre(state, cs_one, ext):
        sys = build_constraints(spec, state, cs_one, cfg)
        u = scn.pack_velocity(state)
        Minv = scn.inv_mass_blocks(spec, state)
        F = scn.external_forces(spec, state, cfg.gravity)
        if ext is not None:
            F = F + ext
        MinvF = jnp.einsum("nij,nj->ni", Minv, F)
        rhs = -cfg.erp / cfg.dt / cfg.dt * sys.err - jnp.einsum(
            "mnk,nk->m", sys.J, u / cfg.dt + MinvF
        )
        A = system_matrix(spec, state, sys, cfg)
        return sys, A, rhs, u, Minv, F

    with jax.named_scope("assembly"):
        return jax.vmap(pre, in_axes=(0, 0, 0 if per_scene else None))(
            states, css, ext_forces
        )


def _batched_post(states, cfg, sys, lam, u, Minv, F):
    with jax.named_scope("integrate"):
        return jax.vmap(
            lambda st, s, l, uu, mi, ff: _post_solve(st, cfg, s, l, uu, mi,
                                                     ff)
        )(states, sys, lam, u, Minv, F)


def _coulomb(cfg):
    from eggshell_tpu.utils.config import FrictionModel

    return cfg.friction_model == FrictionModel.COULOMB_PYRAMID


def _jacobi_kernel_forward(spec, states, cfg, ext_forces):
    """JACOBI_KERNEL forward: the batch's LCPs go to
    `ops.lcp_kernel.solve_jacobi_batched` (the fused sweep kernel or the
    XLA sweep, by shape and platform).  Returns (new states, lambda
    (B, m) in `build_constraints` row order)."""
    from eggshell_tpu.ops import lcp_kernel

    sys, A, rhs, u, Minv, F = _batched_system(spec, states, cfg, ext_forces)
    coulomb = _coulomb(cfg)
    with jax.named_scope("lcp"):
        lam = lcp_kernel.solve_jacobi_batched(
            A, rhs, sys.is_eq, sys.lo, sys.hi,
            iters=cfg.solver_iters, omega=cfg.jacobi_omega,
            beta=cfg.jacobi_beta, block=bool(cfg.jacobi_block),
            couple=sys.couple if coulomb else None,
            mu=float(cfg.friction_mu) if coulomb else 0.0,
        )
    return _batched_post(states, cfg, sys, lam, u, Minv, F), lam


def _step_xla_twin(spec, states, cfg, ext_forces, lam_saved):
    """Differentiable twin of `_jacobi_kernel_forward`: the same vmapped
    contacts and assembly, with the forward's impulses `lam_saved`
    adopted through the implicit-function-theorem LCP adjoint
    (ops.lcp.adopt_lcp_solution) — gradients through the solve cost ONE
    adjoint linear solve per scene instead of reverse-unrolling
    cfg.solver_iters sweeps (the reference's my_jet.h threads
    derivatives through its production FEM pipeline; this is the
    dynamics analog)."""
    sys, A, rhs, u, Minv, F = _batched_system(spec, states, cfg, ext_forces)
    lo_t, hi_t = sys.lo, sys.hi
    if _coulomb(cfg):
        # effective bounds at the saved solution (+-mu lambda_n), so the
        # IFT active-set classification sees the same caps the coupled
        # sweeps enforced
        lo_t, hi_t = jax.vmap(
            lambda x, l, h, c: lcp._bounds(x, l, h, c, float(cfg.friction_mu))
        )(lam_saved, sys.lo, sys.hi, sys.couple)
    lam = jax.vmap(lcp.adopt_lcp_solution)(
        A, rhs, sys.is_eq, lo_t, hi_t, lam_saved
    )
    return _batched_post(states, cfg, sys, lam, u, Minv, F)


@functools.lru_cache(maxsize=None)
def _jacobi_kernel_step(cfg: SimConfig):
    """custom_vjp step for SolverKind.JACOBI_KERNEL: forward =
    `_jacobi_kernel_forward`; backward = jax.vjp of `_step_xla_twin`,
    which recomputes contacts and assembly (rematerialisation) and
    adopts the forward's saved impulses.  Cached per SimConfig.

    JAX may trace `fwd` and `bwd` after the enclosing step's body has
    returned, so each carries its own `full_precision` context."""

    @jax.custom_vjp
    @full_precision
    def step(spec, states, ext_forces):
        return _jacobi_kernel_forward(spec, states, cfg, ext_forces)[0]

    @full_precision
    def fwd(spec, states, ext_forces):
        out, lam = _jacobi_kernel_forward(spec, states, cfg, ext_forces)
        return out, (spec, states, ext_forces, lam)

    @full_precision
    def bwd(res, bar_out):
        spec, states, ext_forces, lam = res
        _, vjp = jax.vjp(
            lambda sp, st, ex: _step_xla_twin(sp, st, cfg, ex, lam),
            spec, states, ext_forces,
        )
        return vjp(bar_out)

    step.defvjp(fwd, bwd)
    return step


@functools.partial(jax.jit, static_argnames=("cfg",))
@full_precision
def step_ode_batched(
    spec: SceneSpec,
    states: State,
    cfg: SimConfig,
    ext_forces: Optional[jax.Array] = None,
) -> State:
    """Batched step over a leading scenario axis.  `ext_forces` is (n, 6)
    for all scenes or (B, n, 6).

    With SolverKind.JACOBI_KERNEL the batch's LCPs are solved by
    `ops.lcp_kernel` (one fused sweep kernel on the GPU) and jax.grad
    flows through a custom VJP whose backward is the XLA twin with an
    implicit-function-theorem LCP adjoint (see `_jacobi_kernel_step`)."""
    if cfg.solver == SolverKind.JACOBI_KERNEL:
        return _jacobi_kernel_step(cfg)(spec, states, ext_forces)

    if cfg.solver == SolverKind.MATRIX_FREE:
        # Batched large-scene tier: vmap the O(K)-memory compact-block
        # step (ref sparse_iterations_utils.cc:624-695) — a batch of
        # piles never forms any (3K)^2 matrix.
        from eggshell_tpu.physics.contacts import make_contacts_batched

        css = make_contacts_batched(spec, states, cfg)
        if ext_forces is None:
            return jax.vmap(
                lambda st, cs: _step_matrix_free(spec, st, cfg, None,
                                                 cs=cs)[0]
            )(states, css)
        ext_b = (
            jnp.broadcast_to(ext_forces, states.p.shape[:1] + ext_forces.shape)
            if ext_forces.ndim == 2 else ext_forces
        )
        return jax.vmap(
            lambda st, cs, ex: _step_matrix_free(spec, st, cfg, ex,
                                                 cs=cs)[0]
        )(states, css, ext_b)

    sys, A, rhs, u, Minv, F = _batched_system(spec, states, cfg, ext_forces)
    with jax.named_scope("lcp"):
        lam = jax.vmap(lambda a, r, s: _solve_lambda(a, r, s, cfg))(
            A, rhs, sys
        )
    return _batched_post(states, cfg, sys, lam, u, Minv, F)


@functools.partial(jax.jit, static_argnames=("cfg", "fixed_point_iters"))
@full_precision
def step_implicit_midpoint(
    spec: SceneSpec,
    state: State,
    cfg: SimConfig,
    ext_force: Optional[jax.Array] = None,
    fixed_point_iters: int = 4,
) -> Tuple[State, ContactSet]:
    """Implicit-midpoint step — IMPLEMENTED, unlike the reference whose
    Integrator::IMPLICIT_MIDPOINT is a Panic stub (ensembles.cc:404,
    :593-600; single-body LIM prototypes only, model.cc:178-266).

    Scheme: u_{n+1} = u_n + dt f(x_mid, u_mid), x_{n+1} advanced with
    u_mid, where x_mid = x_n advanced by dt/2 u_mid and
    u_mid = (u_n + u_{n+1})/2.  Solved by fixed-point iteration (the
    contact LCP is re-solved at the midpoint state each sweep) —
    compiler-friendly: a `lax.fori_loop` of fixed trip count, no Newton
    linearization needed at these step sizes.  Contacts are detected once
    at the start state (consistent with the reference's per-step
    UpdateContacts placement, ensembles.cc:407-410)."""
    dt = cfg.dt
    cs = make_contacts(spec, state, cfg)
    u0 = scn.pack_velocity(state)

    def solve_at(st_mid, u_mid):
        sys = build_constraints(spec, st_mid, cs, cfg)
        Minv = scn.inv_mass_blocks(spec, st_mid)
        F = scn.external_forces(spec, st_mid, cfg.gravity)
        if ext_force is not None:
            F = F + ext_force
        MinvF = jnp.einsum("nij,nj->ni", Minv, F)
        rhs = -cfg.erp / dt / dt * sys.err - jnp.einsum(
            "mnk,nk->m", sys.J, u_mid / dt + MinvF
        )
        A = system_matrix(spec, st_mid, sys, cfg)
        lam = _solve_lambda(A, rhs, sys, cfg)
        JTlam = jnp.einsum("mnk,m->nk", sys.J, lam)
        return jnp.einsum("nij,nj->ni", Minv, F + JTlam)

    def sweep(_, u_mid):
        st_mid = state._replace(
            p=state.p + 0.5 * dt * u_mid[:, :3],
            q=quat.integrate_quat(state.q, u_mid[:, 3:], 0.5 * dt),
            v=u_mid[:, :3],
            w=u_mid[:, 3:],
        )
        vdot = solve_at(st_mid, u_mid)
        u_new = u0 + dt * vdot
        return 0.5 * (u0 + u_new)

    u_mid = jax.lax.fori_loop(0, fixed_point_iters, sweep, u0)
    u_new = 2.0 * u_mid - u0
    new_state = State(
        p=state.p + dt * u_mid[:, :3],
        v=u_new[:, :3],
        q=quat.integrate_quat(state.q, u_mid[:, 3:], dt),
        w=u_new[:, 3:],
    )
    return new_state, cs


@functools.partial(jax.jit, static_argnames=("cfg",))
@full_precision
def step_explicit_euler(spec: SceneSpec, state: State, cfg: SimConfig) -> State:
    """Equality-only explicit Euler (ref :540-561): joints only; contacts
    are not supported by this integrator (ref :397-400 CHECKs)."""
    dt = cfg.dt
    # Empty contact set: all lanes inactive.
    K = cfg.contact_capacity
    dtype = state.p.dtype
    cs = ContactSet(
        b0=jnp.full((K,), -1, jnp.int32), b1=jnp.full((K,), -1, jnp.int32),
        position=jnp.zeros((K, 3), dtype), normal=jnp.zeros((K, 3), dtype),
        depth=jnp.zeros((K,), dtype), active=jnp.zeros((K,), bool),
    )
    sys = build_constraints(spec, state, cs, cfg)
    u = scn.pack_velocity(state)
    Minv = scn.inv_mass_blocks(spec, state)
    F = scn.external_forces(spec, state, cfg.gravity)
    MinvF = jnp.einsum("nij,nj->ni", Minv, F)

    jdotv = jnp.concatenate(
        [_joint_jdotv(spec, state), jnp.zeros((3 * K,), dtype)]
    )
    rhs = -jnp.einsum("mnk,nk->m", sys.J, MinvF) - jdotv
    A = system_matrix(spec, state, sys, cfg)
    lam = jnp.linalg.solve(A, rhs)               # equality-only LDLT analog
    JTlam = jnp.einsum("mnk,m->nk", sys.J, lam)
    vdot = jnp.einsum("nij,nj->ni", Minv, F + JTlam)
    u_new = u + dt * vdot

    p_new = state.p + dt * u[:, :3]              # old velocity (ref :553-560)
    q_new = quat.integrate_quat(state.q, u[:, 3:], dt)
    return State(p=p_new, v=u_new[:, :3], q=q_new, w=u_new[:, 3:])


def _joint_jdotv(spec: SceneSpec, state: State) -> jax.Array:
    """JdotV for ball joints (formula of ref joints.cc:37-47):
    Jdot_b0 = [0, -cross(w0 x (R0 c0))], Jdot_b1 = [0, cross(w1 x (R1 c1))].
    Padded with zeros for the (empty) contact rows."""
    Jn = spec.num_joints
    dtype = state.p.dtype
    if Jn == 0:
        joints_part = jnp.zeros((0,), dtype)
    else:
        R = state.R()
        r0c0 = jnp.einsum("jik,jk->ji", R[spec.joint_b0], spec.joint_c0)
        jb1 = jnp.where(spec.joint_b1 >= 0, spec.joint_b1, 0)
        r1c1 = jnp.einsum("jik,jk->ji", R[jb1], spec.joint_c1)
        w0 = state.w[spec.joint_b0]
        w1 = jnp.where(
            (spec.joint_b1 >= 0)[:, None], state.w[jb1], 0.0
        )
        # Jdot_w0 @ w0 = -(w0 x r0) x w0 = +w0 x (w0 x r0); b1 negated.
        term0 = jnp.cross(w0, jnp.cross(w0, r0c0))
        term1 = jnp.where(
            (spec.joint_b1 >= 0)[:, None],
            -jnp.cross(w1, jnp.cross(w1, r1c1)),
            0.0,
        )
        joints_part = (term0 + term1).reshape(-1)
    return joints_part


# ---------------------------------------------------------------------------
# Stabilization


def position_constraint_error(
    spec: SceneSpec, state: State, cfg: SimConfig, cs: Optional[ContactSet] = None
) -> jax.Array:
    """Stacked joint + contact position errors (ref ensembles.cc:156-171)."""
    if cs is None:
        cs = make_contacts(spec, state, cfg)
    sys = build_constraints(spec, state, cs, cfg)
    return sys.err


def _velocity_relaxation(
    spec: SceneSpec, state: State, sys: ConstraintSystem, scale
) -> jax.Array:
    """vc = -scale J^T (J J^T)^-1 err (ref :659-666), with a tiny Tikhonov
    term since redundant contacts make J J^T singular (the reference feeds
    the singular matrix to LDLT).  Returns (n, 6)."""
    Jf = _flat_J(sys)
    m = sys.num_rows
    JJt = Jf @ Jf.T
    JJt = JJt + jnp.diag(
        jnp.where(sys.row_active, 1e-10, 1.0).astype(Jf.dtype)
    )
    lam = jnp.linalg.solve(JJt, sys.err)
    vc = (-scale * (Jf.T @ lam)).reshape(spec.num_bodies, 6)
    # Static bodies must not be relaxed (no reference analog: the
    # reference has no infinite-mass bodies).
    return jnp.where((spec.inv_mass > 0)[:, None], vc, 0.0)


def _advance_positions(state: State, vc: jax.Array, dt) -> State:
    """StepPositions_ExplicitEuler with a velocity-correction field
    (ref :553-560, 647-650)."""
    return state._replace(
        p=state.p + dt * vc[:, :3],
        q=quat.integrate_quat(state.q, vc[:, 3:], dt),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "max_steps"))
@full_precision
def init_stabilize(
    spec: SceneSpec, state: State, cfg: SimConfig, max_steps: int = 100
) -> State:
    """Pre-run position relaxation (ref InitStabilize, ensembles.cc:602-622):
    up to `max_steps` relaxation steps with dt = 500 dt_sim, scale 0.2,
    re-detecting contacts each iteration, until err^2 <= 1e-9."""
    tol = 1e-9

    def err2_of(st):
        e = position_constraint_error(spec, st, cfg)
        return e @ e

    def cond(carry):
        st, e2, i = carry
        return (e2 > tol) & (i < max_steps)

    def body(carry):
        st, _, i = carry
        cs = make_contacts(spec, st, cfg)
        sys = build_constraints(spec, st, cs, cfg)
        vc = _velocity_relaxation(spec, st, sys, 0.2)
        st = _advance_positions(st, vc, cfg.dt * 500)
        return st, err2_of(st), i + 1

    state, _, _ = jax.lax.while_loop(cond, body, (state, err2_of(state), 0))
    return state


@functools.partial(jax.jit, static_argnames=("cfg", "max_steps"))
@full_precision
def post_stabilize(
    spec: SceneSpec, state: State, cfg: SimConfig, max_steps: int = 500
) -> State:
    """Post-step stabilization (ref PostStabilize, ensembles.cc:624-657):
    velocity relaxation applied to both positions (dt = 100 dt_sim) and
    velocities, scale 0.2, until err^2 <= 1e-9.  Deviation from the
    reference: contact geometry is refreshed each iteration instead of
    reusing the pre-step contact set."""
    tol = 1e-9

    def err2_of(st):
        e = position_constraint_error(spec, st, cfg)
        return e @ e

    def cond(carry):
        st, e2, i = carry
        return (e2 > tol) & (i < max_steps)

    def body(carry):
        st, _, i = carry
        cs = make_contacts(spec, st, cfg)
        sys = build_constraints(spec, st, cs, cfg)
        vc = _velocity_relaxation(spec, st, sys, 0.2)
        st = _advance_positions(st, vc, cfg.dt * 100)
        u = scn.pack_velocity(st) + vc
        st = scn.unpack_velocity(st, u)
        return st, err2_of(st), i + 1

    state, _, _ = jax.lax.while_loop(cond, body, (state, err2_of(state), 0))
    return state


# ---------------------------------------------------------------------------
# Diagnostics (SURVEY §5.5 — structured per-step metrics)


@functools.partial(jax.jit, static_argnames=("cfg",))
@full_precision
def step_diagnostics(
    spec: SceneSpec, state: State, cfg: SimConfig,
    ext_force: Optional[jax.Array] = None,
):
    """Structured metrics for one step without advancing the state:
    contact count, max penetration depth, constraint-error norm, solver
    complementarity residual, kinetic energy.  The build's analog of the
    reference's inline solver diagnostics (condition numbers / iteration
    counts, eggshell/sparse_iterations.cc:117-223) — reduce these across
    a mesh with psum for fleet monitoring."""
    from eggshell_tpu.physics.contacts import count_dropped_contacts

    cs, sys, A, rhs, u, Minv, F = _pre_solve(spec, state, cfg, ext_force)
    if cfg.solver == SolverKind.DIRECT:
        lam, _, solver_info = lcp_direct.mixed_constraints_solver(
            A, rhs, sys.is_eq, sys.lo, sys.hi, return_info=True
        )
    else:
        lam = _solve_lambda(A, rhs, sys, cfg)
        solver_info = None
    residual = lcp.residual_error(A, rhs, lam, sys.is_eq, sys.lo, sys.hi)
    mass = jnp.where(spec.inv_mass > 0,
                     1.0 / jnp.where(spec.inv_mass > 0, spec.inv_mass, 1.0),
                     0.0)
    R = state.R()
    Ig = R @ spec.inertia_body @ jnp.swapaxes(R, -1, -2)
    ke = 0.5 * jnp.sum(mass[:, None] * state.v**2) + 0.5 * jnp.sum(
        state.w * jnp.einsum("nij,nj->ni", Ig, state.w)
    )
    out = {
        "num_contacts": jnp.sum(cs.active),
        "dropped_contacts": count_dropped_contacts(spec, state, cfg),
        "max_penetration": jnp.max(jnp.where(cs.active, cs.depth, 0.0)),
        "constraint_error_norm": jnp.linalg.norm(sys.err),
        "solver_residual": residual,
        "kinetic_energy": ke,
        "max_impulse": jnp.max(jnp.abs(lam)),
    }
    if solver_info is not None:
        # Structured solver-failure record (ref eggshell/lcp.cc:233-268
        # lcp_debug.log: iteration count, violation, fallback used).
        out["solver_converged"] = solver_info.converged
        out["solver_iterations"] = solver_info.iterations
        out["solver_goodness"] = solver_info.goodness
        out["solver_fallback_used"] = solver_info.fallback_used
    return out
