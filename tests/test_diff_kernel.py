"""Differentiability of the batched hot path.

jax.grad through step_ode_batched(SolverKind.JACOBI_KERNEL) flows via a
custom VJP (stepper._jacobi_kernel_step): forward = the batched sweep
(ops/lcp_kernel), backward = the XLA twin with an
implicit-function-theorem LCP adjoint (ops/lcp.adopt_lcp_solution).  The reference's my_jet.h threads
derivatives through its production FEM pipeline; this is the dynamics
analog — derivatives through the production contact solver, not a slow
twin.  These tests pin kernel-path gradients to the XLA-path (unrolled
reverse-mode) gradients."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eggshell_tpu.physics import scenes
from eggshell_tpu.physics.stepper import step_ode, step_ode_batched
from eggshell_tpu.utils.config import SimConfig, SolverKind


def _batched(st, B, key, eps=1e-4):
    states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), st
    )
    return states._replace(
        p=states.p + eps * jax.random.normal(key, states.p.shape)
    )


def _cfgs(**kw):
    base = dict(
        conditional_cfm=False, cfm_always=1e-9, solver_iters=30,
        jacobi_omega=0.3, jacobi_beta=0.45, contact_capacity=16,
    )
    base.update(kw)
    kcfg = SimConfig(solver=SolverKind.JACOBI_KERNEL, **base)
    return kcfg, kcfg.replace(solver=SolverKind.JACOBI)


@pytest.mark.parametrize("scene_name", ["box_stack", "cairn"])
def test_kernel_grad_matches_xla_grad_one_step(scene_name):
    if scene_name == "box_stack":
        spec, st = scenes.box_stack(2)
    else:
        spec, st = scenes.cairn(2, seed=4)
    B = 2
    states = _batched(st, B, jax.random.PRNGKey(0))
    kcfg, xcfg = _cfgs()
    ext = jnp.zeros((B, spec.num_bodies, 6))

    def loss(cfg):
        def f(e, s):
            out = step_ode_batched(spec, s, cfg, e)
            return jnp.sum(out.p[:, -1, 2]) + jnp.sum(out.v**2)
        return f

    gk_e, gk_s = jax.grad(loss(kcfg), argnums=(0, 1))(ext, states)
    gx_e, gx_s = jax.grad(loss(xcfg), argnums=(0, 1))(ext, states)

    # Control gradient: the MPC-relevant quantity.
    np.testing.assert_allclose(
        np.asarray(gk_e), np.asarray(gx_e), rtol=0, atol=1e-6
    )
    # State gradients: IFT adjoint vs unrolled reverse — agree to solver
    # convergence.
    for f in ("p", "v", "w", "q"):
        a, b = np.asarray(getattr(gk_s, f)), np.asarray(getattr(gx_s, f))
        assert np.isfinite(a).all(), f"kernel grad {f} not finite"
        assert np.isfinite(b).all(), f"xla grad {f} not finite"
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a, b, atol=5e-4 * scale + 1e-8,
                                   err_msg=f"state.{f}")


def test_kernel_grad_through_rollout():
    """Gradient of a terminal cost through a 5-step kernel-path rollout
    (lax.scan) matches the XLA path — the gradient-MPC configuration."""
    spec, st = scenes.box_stack(2)
    B = 2
    states = _batched(st, B, jax.random.PRNGKey(2))
    kcfg, xcfg = _cfgs()

    def rollout_loss(cfg):
        def f(e):
            def body(s, _):
                return step_ode_batched(spec, s, cfg, e), None
            out, _ = jax.lax.scan(body, states, None, length=5)
            return jnp.sum(out.p[:, -1, 2]) + 0.1 * jnp.sum(e**2)
        return f

    ext = jnp.zeros((B, spec.num_bodies, 6))
    gk = jax.grad(rollout_loss(kcfg))(ext)
    gx = jax.grad(rollout_loss(xcfg))(ext)
    assert np.isfinite(np.asarray(gk)).all()
    # IFT-adjoint vs unrolled-reverse differ by the solver's residual,
    # compounded per step — 1% of the gradient scale over 5 steps.
    scale = max(np.abs(np.asarray(gx)).max(), 1e-6)
    np.testing.assert_allclose(
        np.asarray(gk), np.asarray(gx), atol=1e-2 * scale
    )


@pytest.mark.parametrize(
    "solver",
    [SolverKind.JACOBI, SolverKind.PGS, SolverKind.SOR,
     SolverKind.DIRECT, SolverKind.MATRIX_FREE],
)
def test_all_solver_paths_differentiate(solver):
    """jax.grad flows through the batched step on every solver path, and
    the batched gradient equals the per-scene gradient of `step_ode`
    (the batched contacts and assembly are the per-scene path under
    vmap)."""
    spec, st = scenes.box_stack(2, jitter=0.01, seed=1)
    B = 2
    states = _batched(st, B, jax.random.PRNGKey(7))
    iters = 40 if solver != SolverKind.DIRECT else 0
    cfg = SimConfig(
        conditional_cfm=False, cfm_always=1e-9, solver_iters=iters,
        jacobi_omega=0.3, contact_capacity=16, solver=solver,
    )
    ext = jnp.zeros((B, spec.num_bodies, 6))

    def loss_batched(e):
        out = step_ode_batched(spec, states, cfg, e)
        return jnp.sum(out.p[:, -1, 2]) + jnp.sum(out.v**2)

    def loss_scene(e, s):
        out, _ = step_ode(spec, s, cfg, e)
        return out.p[-1, 2] + jnp.sum(out.v**2)

    gb = jax.grad(loss_batched)(ext)
    gs = jax.vmap(jax.grad(loss_scene))(ext, states)
    assert np.isfinite(np.asarray(gb)).all()
    scale = max(np.abs(np.asarray(gs)).max(), 1e-6)
    np.testing.assert_allclose(
        np.asarray(gb), np.asarray(gs), atol=1e-6 * scale + 1e-10
    )
