"""Sampling MPC on the living-room manipulation task, sharded over the
device mesh — BASELINE config #5 end to end.

The living-room clutter scene (mujoco_scratchpad/living_room.xml,
box-ified) with MPPI pushing the table lamp (a free box on the dining
table) toward a target: the sample axis is sharded over ALL available
devices via `parallel.mesh.sharded_mppi_update` (pmin/psum collectives),
which equals the single-device update for the same key — so this script
runs unchanged on 1 CPU, an 8-device virtual mesh, or several GPUs.

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python examples/living_room_mpc.py

Usage: python examples/living_room_mpc.py [num_samples] [steps]
"""

import sys

import numpy as np

import jax
import jax.numpy as jnp

from eggshell_tpu.parallel import mesh as pmesh
from eggshell_tpu.physics import scenes
from eggshell_tpu.physics.stepper import step_ode
from eggshell_tpu.utils.config import SimConfig, SolverKind

LAMP = 6            # the free "table_lamp" box (scenes.living_room)


def main(num_samples: int = 256, steps: int = 30):
    num_samples, steps = int(num_samples), int(steps)
    # max_correcting_vel: the MJCF spawns the table lamp interpenetrating
    # the dining table (living_room.xml:63 relies on MuJoCo's soft
    # constraints); cap the ERP ejection at 2 m/s so settling is gentle.
    cfg = SimConfig(
        solver=SolverKind.JACOBI, solver_iters=30, jacobi_omega=0.3,
        jacobi_beta=0.45, conditional_cfm=False, cfm_always=0.01,
        contact_capacity=24, max_correcting_vel=2.0,
    )
    spec, state = scenes.living_room()

    # settle: the free boxes are DROPPED into the room (they spawn above
    # their rest heights) — run half a second of passive dynamics first
    @jax.jit
    def settle(st):
        def body(s, _):
            s2, _ = step_ode(spec, s, cfg)
            return s2, None

        return jax.lax.scan(body, st, None, length=500)[0]

    state = settle(state)
    print(f"settled: lamp at ({float(state.p[LAMP, 0]):+.2f}, "
          f"{float(state.p[LAMP, 1]):+.2f}, {float(state.p[LAMP, 2]):+.2f})")

    # slide the lamp across whatever it rests on: plan in x-y only
    target_xy = state.p[LAMP, :2] + jnp.asarray([0.8, 0.6], state.p.dtype)

    def cost(s):
        return jnp.sum((s.p[LAMP, :2] - target_xy) ** 2)

    mesh = pmesh.make_mesh()
    n_dev = mesh.devices.size
    samples = max(num_samples, n_dev) // n_dev * n_dev
    print(f"mesh: {n_dev} device(s); {samples} samples/iteration")

    H = 25
    SUB = 10        # control period = 10 ms (each wrench held 10 sim steps)
    mean = jnp.zeros((H, 6), state.p.dtype)
    key = jax.random.PRNGKey(0)
    c0 = float(cost(state))
    for i in range(steps):
        mean, costs = pmesh.sharded_mppi_update(
            spec, state, cfg, mean, jax.random.fold_in(key, i), cost,
            mesh, controlled_body=LAMP, num_samples=samples,
            noise_sigma=15.0, temperature=3e-4, noise_mode="constant",
            substeps=SUB,
        )
        ext = jnp.zeros((spec.num_bodies, 6), state.p.dtype).at[LAMP].set(
            mean[0]
        )
        for _ in range(SUB):
            state, _ = step_ode(spec, state, cfg, ext_force=ext)
        mean = jnp.concatenate([mean[1:], jnp.zeros_like(mean[:1])])
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}: lamp at "
                  f"({float(state.p[LAMP, 0]):+.2f}, "
                  f"{float(state.p[LAMP, 1]):+.2f}), "
                  f"cost {float(cost(state)):.3f}")
    c1 = float(cost(state))
    print(f"cost {c0:.3f} -> {c1:.3f} "
          f"({'improved' if c1 < c0 else 'NO IMPROVEMENT'})")
    return c0, c1


if __name__ == "__main__":
    main(*sys.argv[1:])
