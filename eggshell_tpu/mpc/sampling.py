"""Sampling (MPPI-style) model-predictive control over batched rollouts.

The north-star capability (BASELINE.json): thousands of perturbed
control sequences rolled out per chip, costs reduced across the device
mesh, receding-horizon update of the control mean.  The reference has no
MPC — its optimizers (toolkit/optimizer.h) drive FEM parameter sweeps —
so this engine is new, built on the differentiable stepper.

Controls are per-step wrenches [force; torque] on a designated body
(shape (H, 6)); costs are user functions of the terminal/running state.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from eggshell_tpu.physics.scene import SceneSpec, State
from eggshell_tpu.physics.stepper import step_ode
from eggshell_tpu.utils.config import SimConfig
from eggshell_tpu.utils.precision import full_precision


def rollout_controlled(
    spec: SceneSpec,
    state: State,
    cfg: SimConfig,
    controls: jax.Array,       # (H, 6) wrench on `controlled_body`
    controlled_body: int,
    running_cost: Optional[Callable[[State], jax.Array]] = None,
    substeps: int = 1,
):
    """Roll out with per-step control wrenches; returns (final_state,
    total_running_cost).  `substeps` holds each control for that many
    simulation steps (control period = substeps * cfg.dt), so a
    20-element plan can cover a manipulation-scale horizon without a
    20000-element control vector."""
    n = spec.num_bodies

    def body(carry, ctrl):
        st, acc = carry
        ext = jnp.zeros((n, 6), st.p.dtype).at[controlled_body].set(ctrl)

        def sub(_, s):
            s2, _ = step_ode(spec, s, cfg, ext_force=ext)
            return s2

        st2 = jax.lax.fori_loop(0, substeps, sub, st)
        if running_cost is not None:
            acc = acc + running_cost(st2)
        return (st2, acc), None

    (final, cost), _ = jax.lax.scan(
        body, (state, jnp.asarray(0.0, state.p.dtype)), controls
    )
    return final, cost


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "controlled_body", "cost_fn", "num_samples",
                     "temperature", "noise_mode", "substeps"),
)
@full_precision
def mppi_update(
    spec: SceneSpec,
    state: State,
    cfg: SimConfig,
    mean_controls: jax.Array,      # (H, 6)
    key: jax.Array,
    cost_fn: Callable[[State], jax.Array],   # terminal cost of final state
    controlled_body: int = 0,
    num_samples: int = 256,
    noise_sigma: float = 1.0,
    temperature: float = 1.0,
    noise_mode: str = "white",
    substeps: int = 1,
):
    """One MPPI iteration: sample N perturbed control sequences, roll all
    out (vmap — shard the sample axis over a mesh for multi-chip), and
    exponentially re-weight.  Returns (new_mean_controls, costs).

    noise_mode: "white" draws iid per-step noise; "constant" draws one
    wrench per sample broadcast over the horizon (temporally correlated
    exploration — far more effective for pushing/manipulation where white
    noise self-cancels over the horizon)."""
    H = mean_controls.shape[0]
    if noise_mode == "constant":
        eps = (
            jax.random.normal(key, (num_samples, 1, 6), mean_controls.dtype)
            * noise_sigma
        )
        eps = jnp.broadcast_to(eps, (num_samples, H, 6))
    else:
        eps = (
            jax.random.normal(key, (num_samples, H, 6), mean_controls.dtype)
            * noise_sigma
        )
    ctrls = mean_controls[None] + eps

    def one(c):
        final, run = rollout_controlled(
            spec, state, cfg, c, controlled_body, substeps=substeps
        )
        return cost_fn(final) + run

    costs = jax.vmap(one)(ctrls)
    beta = jnp.min(costs)
    wts = jnp.exp(-(costs - beta) / temperature)
    wts = wts / jnp.sum(wts)
    new_mean = jnp.einsum("s,shc->hc", wts, ctrls)
    return new_mean, costs


def rollout_controlled_batched(
    spec: SceneSpec,
    states: State,              # batched (S, ...) — one row per sample
    cfg: SimConfig,
    controls: jax.Array,        # (S, H, 6) wrench per sample per step
    controlled_body: int,
    running_cost: Optional[Callable[[State], jax.Array]] = None,
    substeps: int = 1,
):
    """Batched controlled rollout on the bench path: every step of every
    sample is one `step_ode_batched` call, so with
    SolverKind.JACOBI_KERNEL the whole sample population's contact QPs
    go to the batched sweep (ops/lcp_kernel) instead of a vmap of
    single-scene solves.  Returns (final_states (S, ...),
    total_running_cost (S,))."""
    from eggshell_tpu.physics.stepper import step_ode_batched

    S = controls.shape[0]
    n = spec.num_bodies
    ctrls_t = jnp.swapaxes(controls, 0, 1)  # (H, S, 6)

    def body(carry, ctrl_t):
        sts, acc = carry
        ext = (
            jnp.zeros((S, n, 6), sts.p.dtype)
            .at[:, controlled_body].set(ctrl_t)
        )

        def sub(_, ss):
            return step_ode_batched(spec, ss, cfg, ext_forces=ext)

        nxt = jax.lax.fori_loop(0, substeps, sub, sts)
        if running_cost is not None:
            acc = acc + jax.vmap(running_cost)(nxt)
        return (nxt, acc), None

    (final, cost), _ = jax.lax.scan(
        body, (states, jnp.zeros((S,), states.p.dtype)), ctrls_t
    )
    return final, cost


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "controlled_body", "cost_fn", "num_samples",
                     "temperature", "noise_mode", "substeps"),
)
@full_precision
def mppi_update_batched(
    spec: SceneSpec,
    state: State,
    cfg: SimConfig,
    mean_controls: jax.Array,      # (H, 6)
    key: jax.Array,
    cost_fn: Callable[[State], jax.Array],
    controlled_body: int = 0,
    num_samples: int = 256,
    noise_sigma: float = 1.0,
    temperature: float = 1.0,
    noise_mode: str = "white",
    substeps: int = 1,
):
    """`mppi_update` on the batched rollout path (see
    `rollout_controlled_batched`) — the configuration the MPC benchmark
    measures (BASELINE config #5)."""
    H = mean_controls.shape[0]
    if noise_mode == "constant":
        eps = (
            jax.random.normal(key, (num_samples, 1, 6), mean_controls.dtype)
            * noise_sigma
        )
        eps = jnp.broadcast_to(eps, (num_samples, H, 6))
    else:
        eps = (
            jax.random.normal(key, (num_samples, H, 6), mean_controls.dtype)
            * noise_sigma
        )
    ctrls = mean_controls[None] + eps
    states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (num_samples,) + x.shape), state
    )
    final, run = rollout_controlled_batched(
        spec, states, cfg, ctrls, controlled_body, substeps=substeps
    )
    costs = jax.vmap(cost_fn)(final) + run
    beta = jnp.min(costs)
    wts = jnp.exp(-(costs - beta) / temperature)
    wts = wts / jnp.sum(wts)
    new_mean = jnp.einsum("s,shc->hc", wts, ctrls)
    return new_mean, costs


class SamplingMPC(NamedTuple):
    """Receding-horizon driver: at each control step, refine the mean
    with `iterations` MPPI updates, apply the first control, shift."""

    spec: SceneSpec
    cfg: SimConfig
    cost_fn: Callable[[State], jax.Array]
    controlled_body: int = 0
    horizon: int = 20
    num_samples: int = 256
    noise_sigma: float = 1.0
    temperature: float = 1.0
    iterations: int = 1
    # Each control is held for `substeps` simulation steps (control
    # period = substeps * cfg.dt) in both planning rollouts and execution.
    substeps: int = 1

    def plan(self, state: State, mean_controls, key):
        def it(carry, k):
            mc, _ = carry
            mc2, costs = mppi_update(
                self.spec, state, self.cfg, mc, k, self.cost_fn,
                self.controlled_body, self.num_samples,
                self.noise_sigma, self.temperature,
                substeps=self.substeps,
            )
            return (mc2, jnp.min(costs)), None

        keys = jax.random.split(key, self.iterations)
        (mc, best), _ = jax.lax.scan(
            it, (mean_controls, jnp.inf), keys
        )
        return mc, best

    def control_step(self, state: State, mean_controls, key):
        """Plan, execute the first control, shift the plan."""
        mc, best = self.plan(state, mean_controls, key)
        n = self.spec.num_bodies
        ext = (
            jnp.zeros((n, 6), state.p.dtype).at[self.controlled_body]
            .set(mc[0])
        )
        state2 = state
        for _ in range(self.substeps):
            state2, _ = step_ode(self.spec, state2, self.cfg, ext_force=ext)
        shifted = jnp.concatenate([mc[1:], jnp.zeros_like(mc[:1])])
        return state2, shifted, best
