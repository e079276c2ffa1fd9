"""The batched SolverKind.JACOBI_KERNEL step: forward parity with the
vmapped SolverKind.JACOBI step, the row order of the impulses its custom
VJP saves, and the backward twin (physics/stepper._jacobi_kernel_step)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eggshell_tpu.ops import lcp
from eggshell_tpu.physics import scenes
from eggshell_tpu.physics import stepper
from eggshell_tpu.physics.scenes import make_scene
from eggshell_tpu.physics.stepper import step_ode_batched
from eggshell_tpu.utils.config import FrictionModel, SimConfig, SolverKind

B = 4


def _batched(st, key, eps=2e-3, dtype=jnp.float32):
    states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape).astype(dtype), st
    )
    return states._replace(
        p=states.p + eps * jax.random.normal(key, states.p.shape, dtype)
    )


def _cfg(**kw):
    base = dict(
        solver=SolverKind.JACOBI_KERNEL, solver_iters=10,
        jacobi_omega=0.3, jacobi_beta=0.45, conditional_cfm=False,
        cfm_always=0.01, contact_capacity=20,
    )
    base.update(kw)
    return SimConfig(**base)


def _jointed_pair():
    c1 = np.array([0.15, 0.15, 0.15])
    c2 = np.array([-0.15, -0.15, -0.15])
    return make_scene(
        [[0.0, 0.0, 0.149], [0.32, 0.32, 0.2]],
        joints=[(0, 1, c1, c2)], ground=True, dtype=jnp.float32,
    )


def _scene(name):
    if name == "box_stack":
        return (*scenes.box_stack(4, dtype=jnp.float32), _cfg())
    if name == "box_drop":
        return (*scenes.box_drop(height=0.1495, dtype=jnp.float32),
                _cfg(contact_capacity=8))
    if name == "pendulum_chain":
        return (*scenes.pendulum_chain(3, dtype=jnp.float32),
                _cfg(contact_capacity=4, solver_iters=8))
    if name == "jointed_pair":
        return (*_jointed_pair(), _cfg(contact_capacity=8))
    spec, st = scenes.living_room(dtype=jnp.float32)
    return spec, st, _cfg(contact_capacity=16, pair_capacity=6,
                          broadphase_margin=0.1, solver_iters=6)


@pytest.mark.parametrize(
    "scene_name",
    ["box_stack", "living_room_bp", "box_drop", "pendulum_chain",
     "jointed_pair"],
)
def test_step_matches_jacobi_step(scene_name):
    """JACOBI_KERNEL equals the vmapped JACOBI step with the same sweeps,
    omega and beta: the broadphase-gated pair subset, the ground-only
    scene, ball joints, and joints beside frictional contacts."""
    spec, st, cfg = _scene(scene_name)
    states = _batched(st, jax.random.PRNGKey(1))
    out_k = step_ode_batched(spec, states, cfg)
    out_x = step_ode_batched(spec, states,
                             cfg.replace(solver=SolverKind.JACOBI))
    for f in ("p", "v", "q", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(out_k, f)), np.asarray(getattr(out_x, f)),
            atol=2e-5, rtol=1e-6, err_msg=f,
        )


@pytest.mark.parametrize(
    "kw",
    [dict(jacobi_block=True, jacobi_beta=0.0, jacobi_omega=0.5),
     dict(friction_model=FrictionModel.COULOMB_PYRAMID, friction_mu=0.2)],
)
def test_block_and_pyramid_steps_match_jacobi(kw):
    """Block-Jacobi and Coulomb-pyramid bounds take the XLA sweep inside
    JACOBI_KERNEL and match JACOBI step for step."""
    spec, st = scenes.box_stack(2, jitter=0.0, seed=0)
    st = st._replace(v=st.v + jnp.asarray([1.5, 0.0, 0.0]),
                     p=st.p - jnp.asarray([0.0, 0.0, 5e-4]))
    states = _batched(st, jax.random.PRNGKey(3), eps=0.0,
                      dtype=jnp.float64)
    cfg = _cfg(contact_capacity=16, **kw)
    out_k = step_ode_batched(spec, states, cfg)
    out_x = step_ode_batched(spec, states,
                             cfg.replace(solver=SolverKind.JACOBI))
    for f in ("p", "v", "q", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(out_k, f)), np.asarray(getattr(out_x, f)),
            atol=1e-12, err_msg=f,
        )


def test_saved_impulses_follow_twin_row_order():
    """The impulses the forward saves for the backward are in the twin's
    `build_constraints` row order (joint rows first, then contact
    lanes): solving the twin's own system reproduces them row for row,
    and integrating them reproduces the forward's step."""
    spec, st, cfg = _scene("jointed_pair")
    states = _batched(st, jax.random.PRNGKey(5))
    out, lam = stepper._jacobi_kernel_forward(spec, states, cfg, None)
    sys, A, rhs, u, Minv, F = stepper._batched_system(spec, states, cfg,
                                                      None)
    assert lam.shape == sys.is_eq.shape == (B, 3 * (1 + 8))
    assert bool(jnp.all(sys.is_eq[:, :3]))            # the joint's rows
    want = jax.vmap(
        lambda a, r, e, l, h: lcp.solve_lcp(
            a, r, e, l, h, iters=cfg.solver_iters, method="jacobi",
            jacobi_omega=cfg.jacobi_omega, jacobi_beta=cfg.jacobi_beta,
        )
    )(A, rhs, sys.is_eq, sys.lo, sys.hi)
    np.testing.assert_allclose(np.asarray(lam), np.asarray(want), atol=1e-6)
    twin = stepper._step_xla_twin(spec, states, cfg, None, lam)
    for f in ("p", "v", "q", "w"):
        np.testing.assert_array_equal(
            np.asarray(getattr(twin, f)), np.asarray(getattr(out, f))
        )


def test_shared_and_per_scene_control_agree():
    """ext_forces (n, 6) applies to every scene like its (B, n, 6)
    broadcast, through the forward and the custom VJP."""
    spec, st, cfg = _scene("box_stack")
    states = _batched(st, jax.random.PRNGKey(6))
    e = 0.3 * jnp.ones((spec.num_bodies, 6), jnp.float32)

    def loss(ext):
        return jnp.sum(step_ode_batched(spec, states, cfg, ext).p[:, :, 2])

    g1 = jax.grad(loss)(e)
    gB = jax.grad(loss)(jnp.broadcast_to(e, (B,) + e.shape))
    np.testing.assert_allclose(np.asarray(g1), np.asarray(gB.sum(0)),
                               rtol=1e-5, atol=1e-9)


def test_grad_through_jointed_contact_step_matches_unrolled():
    """Custom-VJP gradient (IFT adjoint on the saved impulses) against
    reverse-unrolled JACOBI sweeps, on a scene with joint and contact
    rows, f64."""
    spec, st = _jointed_pair()
    states = _batched(st, jax.random.PRNGKey(8), eps=1e-4,
                      dtype=jnp.float64)
    kcfg = _cfg(contact_capacity=8, cfm_always=1e-9, solver_iters=200)
    xcfg = kcfg.replace(solver=SolverKind.JACOBI)
    ext = jnp.zeros((B, spec.num_bodies, 6))

    def loss(cfg):
        def f(e):
            out = step_ode_batched(spec, states, cfg, e)
            return jnp.sum(out.p[:, -1, 2]) + jnp.sum(out.v**2)
        return f

    gk = jax.grad(loss(kcfg))(ext)
    gx = jax.grad(loss(xcfg))(ext)
    assert np.isfinite(np.asarray(gk)).all()
    scale = max(np.abs(np.asarray(gx)).max(), 1e-6)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gx),
                               atol=1e-3 * scale)


def test_grad_traces_every_product_at_highest_precision():
    """Under jax.grad the custom VJP's fwd and bwd are traced after
    step_ode_batched's body has returned; each must still carry HIGHEST
    precision, or a GPU would run their float32 products in TF32."""
    spec, st, cfg = _scene("box_drop")
    states = _batched(st, jax.random.PRNGKey(9))
    ext = jnp.zeros((B, spec.num_bodies, 6), jnp.float32)

    def loss(e):
        return jnp.sum(step_ode_batched(spec, states, cfg, e).p)

    txt = str(jax.make_jaxpr(jax.grad(loss))(ext))
    n_dots = txt.count("dot_general[")
    assert n_dots > 0
    assert txt.count("precision=(Precision.HIGHEST, Precision.HIGHEST)") \
        == n_dots


@pytest.mark.gpu
def test_headline_step_matches_jacobi_on_gpu(gpu):
    """On the card the headline batch's LCPs go to the compiled kernel;
    the step still equals the XLA JACOBI step (HIGHEST precision)."""
    from eggshell_tpu.ops import lcp_kernel

    spec, st = scenes.box_stack(4, dtype=jnp.float32)
    states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (4096,) + x.shape), st
    )
    cfg = _cfg(solver_iters=16)
    assert lcp_kernel.lcp_path(60) == "kernel"
    out_k = step_ode_batched(spec, states, cfg)
    out_x = step_ode_batched(spec, states,
                             cfg.replace(solver=SolverKind.JACOBI))
    for f in ("p", "v", "q", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(out_k, f)), np.asarray(getattr(out_x, f)),
            atol=1e-4, err_msg=f,
        )
