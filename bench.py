"""Benchmark: contact-rich rollouts/s on one GPU.

Headline metric (the LAST line): a 4096-scenario batch of 4-box
frictional stacks (ground + box-box contacts, ~16 active contacts each)
rolled out for a 50-step horizon on the GPU, on the batched fast path:
f32, fixed-sweep under-relaxed heavy-ball Jacobi (SolverKind.
JACOBI_KERNEL), always-on CFM.

In addition, this run:
  - runs the oracle gate first: 120 steps of the bench path on the card
    against the precomputed DIRECT/f64 oracle trajectory
    (tests/data/oracle_stack4_f64.npz, regenerate with
    tools/golden/gen_oracle_npz.py), asserting the 1e-3 bound on p and v
    at EVERY stored checkpoint (steps 30/60/90/120).  A failed gate
    fails the run;
  - measures the config matrix (box_drop, pendulum_chain(6) joints-only,
    box_stack(8), living_room clutter, a 4096-sample MPPI update on the
    living-room manipulation task, gradient MPC with IFT and unrolled
    arms, 216/512-body matrix-free piles, a batch-scaling series, the
    12-box stack at capacity 48, and the FEM/FDTD tier), writing it to
    BENCH_CONFIGS.json after every config.  A config that fails records
    its error.

Every result names the device: platform, device_kind and device count.
Exits non-zero when JAX finds no GPU.

Prints ONE JSON line last:
  {"metric": ..., "value": N, "unit": "rollouts/s", "device": {...}, ...}
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ARTIFACT = os.path.join(_HERE, "BENCH_CONFIGS.json")


def device_info():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _bench_cfg():
    """The gated bench solver configuration — pinned against the
    DIRECT/f64 oracle by tests/test_bench_parity.py (keep in sync)."""
    from eggshell_tpu.utils.config import SimConfig, SolverKind

    return SimConfig(
        solver=SolverKind.JACOBI_KERNEL,
        solver_iters=16,
        solver_tol=0.0,
        jacobi_omega=0.3,
        jacobi_beta=0.45,
        conditional_cfm=False,
        cfm_always=0.01,
        contact_capacity=20,
    )


def _time_rollout(spec, states, cfg, H, reps=3):
    from eggshell_tpu.parallel.rollout import rollout_batched

    @jax.jit
    def run(sts):
        return rollout_batched(spec, sts, cfg, H)

    out = run(states)                          # compile
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run(states)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _broadcast(state, B, dtype, jitter=1e-3):
    states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(), state
    )
    return states._replace(
        p=states.p + (jnp.linspace(0, jitter, B)[:, None, None]).astype(dtype)
    )


def bench_configs(dtype=jnp.float32, B=4096, H=50, on_config=None):
    """BASELINE.md configs 1-5 (+ gradient MPC + large scene), each on
    its production fast path.  Each config is fault-isolated: one
    failure records an error entry instead of losing the whole matrix;
    `on_config(out)` is invoked after every config so the artifact can
    be persisted incrementally."""
    from eggshell_tpu.physics import scenes
    from eggshell_tpu.utils.config import SimConfig, SolverKind

    base = _bench_cfg()
    out = {}

    def run(name, fn):
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": repr(e)[:500]}
        if on_config is not None:
            on_config(out)

    def timed(spec, st, cfg, jitter=1e-3, b=None):
        b = B if b is None else b
        dt = _time_rollout(spec, _broadcast(st, b, dtype, jitter), cfg, H)
        return {"rollouts_per_s": b / dt, "steps_per_s": b * H / dt,
                "batch": b}

    # 1. Single box resting on the ground plane — 4-contact LCP per step.
    run("box_drop", lambda: timed(
        *scenes.box_drop(height=0.1495, dtype=dtype),
        base.replace(contact_capacity=8), jitter=1e-4,
    ))

    # 2. 6-link pendulum chain — ball joints only (equality rows).
    run("pendulum_chain6", lambda: timed(
        *scenes.pendulum_chain(6, dtype=dtype),
        base.replace(contact_capacity=4), jitter=1e-4,
    ))

    # 3. 8-box stack — frictional contact + stabilization load.
    # capacity 32 = the aligned stack's exact count (4 ground + 7
    # interfaces x 4).
    run("box_stack8", lambda: timed(
        *scenes.box_stack(8, dtype=dtype),
        base.replace(contact_capacity=32), b=B,
    ))

    # 4. living_room clutter — broadphase + narrowphase + mixed LCP.
    run("living_room", lambda: timed(
        *scenes.living_room(dtype=dtype),
        base.replace(contact_capacity=32), b=B,
    ))

    # 5. Sampling MPC on the living-room manipulation task: one full
    #    4096-sample MPPI update (H=20) on the bench path — the exact
    #    BASELINE config #5 scenario count.
    def mpc_config():
        from eggshell_tpu.mpc.sampling import mppi_update_batched

        spec, st = scenes.living_room(dtype=dtype)
        cfg5 = base.replace(contact_capacity=32)
        S, Hm = 4096, 20
        target = jnp.asarray([0.0, 0.0, 0.5], dtype)

        def cost_fn(final):
            return jnp.sum((final.p[4] - target) ** 2)

        mean = jnp.zeros((Hm, 6), dtype)
        key = jax.random.PRNGKey(0)

        def run_mpc():
            return mppi_update_batched(
                spec, st, cfg5, mean, key, cost_fn,
                controlled_body=4, num_samples=S, noise_sigma=5.0,
                temperature=1.0, noise_mode="constant",
            )

        new_mean, costs = run_mpc()
        jax.block_until_ready(new_mean)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            new_mean, costs = run_mpc()
        jax.block_until_ready(new_mean)
        dt = (time.perf_counter() - t0) / reps
        return {
            "mpc_solves_per_s": 1.0 / dt,
            "rollouts_per_s": S / dt,
            "steps_per_s": S * Hm / dt,
            "samples": S,
            "horizon": Hm,
        }

    run("mpc_living_room", mpc_config)

    # 6. Gradient MPC step: value_and_grad of a terminal cost through a
    #    rollout — JACOBI_KERNEL (custom VJP + IFT LCP adjoint) vs XLA
    #    jacobi with unrolled reverse.  Each arm is fault-isolated
    #    separately.
    def grad_config():
        from eggshell_tpu.physics.stepper import step_ode_batched

        spec, st = scenes.box_stack(4, dtype=dtype)
        kcfg = base
        xcfg = base.replace(solver=SolverKind.JACOBI)

        def shape_entry(Bg, Hg):
            states = _broadcast(st, Bg, dtype)
            ext = jnp.zeros((Bg, spec.num_bodies, 6), dtype)

            def make_loss(cfg):
                def loss(e):
                    def body(s, _):
                        return step_ode_batched(spec, s, cfg, e), None
                    out, _ = jax.lax.scan(body, states, None, length=Hg)
                    return jnp.sum(out.p[:, -1, 2]) + jnp.sum(e**2)
                return jax.jit(jax.value_and_grad(loss))

            res = {}
            for name, cfg_i in (("kernel_ift", kcfg),
                                ("xla_unrolled", xcfg)):
                def arm(cfg_arm=cfg_i):
                    f = make_loss(cfg_arm)
                    v, g = f(ext)
                    jax.block_until_ready(g)
                    t0 = time.perf_counter()
                    for _ in range(3):
                        v, g = f(ext)
                    jax.block_until_ready(g)
                    return {
                        "grad_steps_per_s":
                            3 * Bg * Hg / (time.perf_counter() - t0)
                    }
                try:
                    res[name] = arm()
                except Exception as e:
                    res[name] = {"error": repr(e)[:300]}
            if "error" not in res["kernel_ift"] and \
                    "error" not in res["xla_unrolled"]:
                res["speedup"] = (
                    res["kernel_ift"]["grad_steps_per_s"]
                    / res["xla_unrolled"]["grad_steps_per_s"]
                )
            return res

        # Two shapes: the small research shape and the PRODUCTION
        # rollout shape (the bench's own B=4096 x H=50).
        return {
            "small_B256_H20": shape_entry(256, 20),
            "production_B4096_H50": shape_entry(4096, 50),
        }

    run("gradient_mpc", grad_config)

    # 7. Large single scenes on the matrix-free tier: 216- and 512-body
    #    piles, batched step_ode_batched(MATRIX_FREE) — the dense (3K)^2
    #    system at K=2048 would be ~150 MB/scene; the compact-block path
    #    is O(K) (ref sparse_iterations_utils.cc:624-695).
    def large_scene():
        res = {}
        # capacities sized for the SETTLED pile (a collapsed 6^3 pile
        # has ~1400 overlapping pairs / >2k contact lanes; truncation is
        # counted by count_dropped_contacts and gated in
        # tests/test_matrix_free_step.py::test_box_pile216_settles)
        for nb, bl, cap, pc in ((216, 8, 4096, 2048), (512, 4, 8192, 4096)):
            spec, st = scenes.box_pile(nb, dtype=dtype)
            cfg = base.replace(
                solver=SolverKind.MATRIX_FREE,
                solver_iters=60,
                contact_capacity=cap,
                pair_capacity=pc,
                broadphase_margin=0.05,
                max_correcting_vel=2.0,
            )
            dt = _time_rollout(
                spec, _broadcast(st, bl, dtype, 1e-3), cfg, H
            )
            res[f"pile{nb}"] = {
                "batch": bl,
                "steps_per_s": bl * H / dt,
                "body_steps_per_s": bl * H * nb / dt,
                "contact_capacity": cap,
                "pair_capacity": pc,
            }
        return res

    run("large_scene", large_scene)

    # 8. Batch-scaling series on the headline scene.
    def batch_scaling():
        spec, st = scenes.box_stack(4, dtype=dtype)
        res = []
        for b in (4096, 8192, 16384):
            dt = _time_rollout(spec, _broadcast(st, b, dtype), base, H)
            res.append({
                "batch": b,
                "rollouts_per_s": b / dt,
                "per_1k_batch": 1024.0 * (b / dt) / b,
            })
        return res

    run("batch_scaling", batch_scaling)

    # 9. 12-box stack at contact capacity 48: m = 144 rows, above the
    #    sweep kernel's KERNEL_MAX_ROWS, so its LCPs take the XLA sweep
    #    (ops/lcp_kernel.lcp_path).
    run("box_stack12_cap48", lambda: timed(
        *scenes.box_stack(12, dtype=dtype),
        base.replace(contact_capacity=48), b=B,
    ))

    # 10-13. FEM / FDTD tier (bench_fem.py; each entry asserts its own
    # parity gate and names the correctness tests that gate its physics).
    import bench_fem

    run("fem_driven", bench_fem.fem_driven)
    run("fem_sweep", bench_fem.fem_sweep)
    run("fem_modes", bench_fem.fem_modes)
    run("fdtd", bench_fem.fdtd)
    return out


def oracle_gate(dtype=jnp.float32):
    """Run the bench path on the device for 120 steps of the unperturbed
    4-box stack and compare against the precomputed DIRECT/f64 oracle
    trajectory at EVERY stored checkpoint (steps 30/60/90/120 — a
    transient excursion that re-converges fails too).  f32 on the
    device, every matrix product at HIGHEST precision
    (utils/precision).  Regenerate the oracle with
    tools/golden/gen_oracle_npz.py."""
    from eggshell_tpu.parallel.rollout import rollout_batched
    from eggshell_tpu.physics import scenes

    path = os.path.join(_HERE, "tests", "data", "oracle_stack4_f64.npz")
    ref = np.load(path)
    spec, st = scenes.box_stack(4, dtype=dtype)
    B = 8
    states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(), st
    )
    cfg = _bench_cfg()
    gate = {"bound": 1e-3, "checkpoints": {}}
    err_p = err_v = 0.0
    prev_ck = 0
    for ck in [int(s) for s in ref["steps"]]:
        # segment length derived from consecutive checkpoint deltas so a
        # regenerated oracle with different spacing stays in sync
        states = rollout_batched(spec, states, cfg, ck - prev_ck)
        prev_ck = ck
        ep = float(
            np.abs(np.asarray(states.p[0], float) - ref[f"p{ck}"]).max()
        )
        ev = float(
            np.abs(np.asarray(states.v[0], float) - ref[f"v{ck}"]).max()
        )
        gate["checkpoints"][str(ck)] = {"err_p": ep, "err_v": ev}
        err_p, err_v = max(err_p, ep), max(err_v, ev)
    gate["err_p"] = err_p
    gate["err_v"] = err_v
    gate["pass"] = bool(err_p < 1e-3 and err_v < 1e-3)
    return gate


def main():
    from eggshell_tpu.physics import scenes
    from eggshell_tpu.utils.compile_cache import enable_compile_cache

    device = device_info()
    if device["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX found {device}", file=sys.stderr)
        sys.exit(1)
    enable_compile_cache()

    dtype = jnp.float32
    artifact = {"device": device, "oracle_gate": oracle_gate(dtype),
                "configs": {}}

    def persist():
        with open(_ARTIFACT, "w") as f:
            json.dump(artifact, f, indent=1)

    persist()
    gate = artifact["oracle_gate"]
    if not gate["pass"]:
        print(json.dumps({"oracle_gate": gate}), file=sys.stderr)
        sys.exit(1)

    cfg = _bench_cfg()
    spec, state = scenes.box_stack(4, dtype=dtype)
    B = 4096
    H = 50
    dt = _time_rollout(spec, _broadcast(state, B, dtype), cfg, H)
    rollouts_per_s = B / dt
    steps_per_s = B * H / dt
    artifact["headline_rollouts_per_s"] = rollouts_per_s
    persist()

    def on_config(cfgs):
        artifact["configs"] = cfgs
        persist()

    bench_configs(dtype, B=B, H=H, on_config=on_config)

    result = {
        "metric": "contact-rich rollouts/s (4-box stack, H=50, batch=4096)",
        "value": rollouts_per_s,
        "unit": "rollouts/s",
        "device": device,
        "extra": {
            "steps_per_s": steps_per_s,
            "rt_factor": steps_per_s * cfg.dt,
            "oracle_err_p": gate["err_p"],
            "oracle_err_v": gate["err_v"],
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
