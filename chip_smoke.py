"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py               # one card: phases 0-8
    python chip_smoke.py --four-cards  # four cards: the sharded path only

One process drives the card(s).  Every phase prints one line and raises
on failure, so the script exits non-zero unless all of them pass.  It
exits non-zero, and prints no result, when JAX finds no GPU.  The last
line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases (one card):
  0  the card (nvidia-smi name and power limit) and jax.devices()
  1  oracle gate: 120 steps of the bench config at B=8 against the
     DIRECT/f64 oracle, err_p and err_v < 1e-3 at steps 30/60/90/120
  2  headline rollout (4-box stack, B=4096, H=50) on the bench path; a
     64-scene slice against the XLA SolverKind.JACOBI rollout
  3  the LCP sweep kernel against the XLA sweep at m=60, 96 (kernel) and
     144 (routed to the XLA sweep), B=4096
  4  one mppi_update_batched on living_room, 4096 samples, H=20
  5  gradient MPC: IFT arm against unrolled JACOBI (B=256, H=20), and
     the IFT arm at B=4096, H=50
  6  pile216 on MATRIX_FREE: 10 steps at B=8
  7  fem_driven (h=0.15) against host SuperLU; 20 steps of 2D FDTD 512^2
  8  the tests marked `gpu`
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

import bench
from eggshell_tpu.parallel.rollout import rollout_batched
from eggshell_tpu.physics import scenes
from eggshell_tpu.physics.stepper import step_ode_batched
from eggshell_tpu.utils.compile_cache import enable_compile_cache
from eggshell_tpu.utils.config import SolverKind

# The bench batch: headline rollout, LCP sweeps, MPPI samples, gradient
# MPC production shape and the four-card comparisons.
B_FULL = 4096


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().replace("\n", "; ")


def _say(phase, msg):
    print(f"PASS phase {phase}: {msg}", flush=True)


def _finite(tree):
    return all(bool(jnp.all(jnp.isfinite(x)))
               for x in jax.tree_util.tree_leaves(tree))


def _max_abs_diff(a, b):
    return max(float(jnp.max(jnp.abs(x - y))) for x, y in zip(
        jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def _timed(fn, reps=3):
    out = jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def phase_oracle():
    gate = bench.oracle_gate(jnp.float32)
    cks = " ".join(f"{k}:p={v['err_p']:.3e},v={v['err_v']:.3e}"
                   for k, v in gate["checkpoints"].items())
    assert gate["pass"], f"oracle gate failed: {cks}"
    _say(1, f"oracle gate (f32, HIGHEST matmuls, bound 1e-3) {cks}")


def phase_headline(card):
    spec, st = scenes.box_stack(4, dtype=jnp.float32)
    cfg = bench._bench_cfg()
    B, H = B_FULL, 50
    states = bench._broadcast(st, B, jnp.float32)
    run = jax.jit(lambda s: rollout_batched(spec, s, cfg, H))
    dt, out = _timed(lambda: run(states))
    assert _finite(out), "headline rollout not finite"
    assert out.p.shape == states.p.shape
    sl = jax.tree_util.tree_map(lambda x: x[:min(64, B_FULL)], states)
    ref = rollout_batched(spec, sl, cfg.replace(solver=SolverKind.JACOBI), H)
    got = jax.tree_util.tree_map(lambda x: x[:min(64, B_FULL)], out)
    # f32; both sides exact-f32 products, they differ in summation order
    # only, compounded over 50 contact steps
    tol = {"p": 1e-4, "q": 1e-4, "v": 1e-3, "w": 1e-3}
    errs = {f: float(jnp.max(jnp.abs(getattr(got, f) - getattr(ref, f))))
            for f in tol}
    for f, t in tol.items():
        assert errs[f] < t, f"headline slice vs JACOBI: {f} {errs[f]} >= {t}"
    _say(2, f"headline B={B} H={H}: {B * H / dt:.6g} steps/s "
            f"({B / dt:.6g} rollouts/s, information only) on {card}; "
            f"64-scene slice vs JACOBI max err {errs} within {tol}")


def phase_lcp_kernel():
    from eggshell_tpu.ops import lcp, lcp_kernel

    key = jax.random.PRNGKey(0)
    lines = []
    for m in (60, 96, 144):
        k1, k2, k3, key = jax.random.split(key, 4)
        M = jax.random.uniform(k1, (B_FULL, m, m), jnp.float32, -1, 1)
        A = jnp.einsum("bij,bkj->bik", M, M, precision="highest") \
            + m * jnp.eye(m, dtype=jnp.float32)
        b = jax.random.uniform(k2, (B_FULL, m), jnp.float32, -1, 1)
        is_eq = jax.random.uniform(k3, (B_FULL, m)) < 0.1
        lo = jnp.where(is_eq, 0.0, -1.0).astype(jnp.float32)
        hi = jnp.where(is_eq, 0.0, 1.0).astype(jnp.float32)
        kw = dict(iters=16, omega=0.3, beta=0.45)
        ref = jax.jit(jax.vmap(lambda a, r, e, l, h: lcp.solve_lcp(
            a, r, e, l, h, method="jacobi", iters=16, jacobi_omega=0.3,
            jacobi_beta=0.45)))(A, b, is_eq, lo, hi)
        path = lcp_kernel.lcp_path(m)
        got = lcp_kernel.solve_jacobi_batched(A, b, is_eq, lo, hi, **kw)
        err = float(jnp.max(jnp.abs(got - ref)))
        # f32, HIGHEST on the XLA side: summation order only
        assert err < 1e-4, f"m={m} ({path}): err {err}"
        lines.append(f"m={m} {path} err={err:.2e}")
    assert lcp_kernel.lcp_path(60) == lcp_kernel.lcp_path(96) == "kernel"
    _say(3, "LCP sweep vs XLA Jacobi (16 sweeps, omega 0.3, beta 0.45, "
            f"B={B_FULL}, tol 1e-4): " + ", ".join(lines))


def phase_mppi():
    from eggshell_tpu.mpc.sampling import mppi_update_batched

    spec, st = scenes.living_room(dtype=jnp.float32)
    cfg = bench._bench_cfg().replace(contact_capacity=32)
    target = jnp.asarray([0.0, 0.0, 0.5], jnp.float32)

    def cost_fn(final):
        return jnp.sum((final.p[4] - target) ** 2)

    def once():
        return mppi_update_batched(
            spec, st, cfg, jnp.zeros((20, 6), jnp.float32),
            jax.random.PRNGKey(0), cost_fn, controlled_body=4,
            num_samples=B_FULL, noise_sigma=5.0, temperature=1.0,
            noise_mode="constant",
        )

    m1, c1 = jax.block_until_ready(once())
    m2, c2 = jax.block_until_ready(once())
    assert _finite((m1, c1)), "MPPI not finite"
    assert m1.shape == (20, 6) and c1.shape == (B_FULL,)
    diff = _max_abs_diff((m1, c1), (m2, c2))
    assert diff <= 1e-6 * max(float(jnp.abs(m1).max()), 1.0), diff
    _say(4, f"mppi_update_batched living_room S={B_FULL} H=20 finite, "
            f"repeat max diff {diff:.2e}")


def _grad_fn(spec, states, cfg, H):
    def loss(e):
        def body(s, _):
            return step_ode_batched(spec, s, cfg, e), None
        out, _ = jax.lax.scan(body, states, None, length=H)
        return jnp.sum(out.p[:, -1, 2]) + jnp.sum(e**2)
    return jax.jit(jax.value_and_grad(loss))


def phase_grad():
    # (a) B=256, H=20, bench config, on the bench's box_drop scene (one
    # box on four redundant ground contacts): every contact stays well
    # inside its bounds, so the IFT adjoint and the unrolled sweeps
    # differentiate the same smooth map.  Tolerance as
    # tests/test_diff_kernel.py (1e-2 of the gradient scale).  Stacked
    # scenes are not compared: contacts near their bounds make the two
    # arms differ (see PERF.md, open questions).
    spec, st = scenes.box_drop(height=0.1495, dtype=jnp.float32)
    kcfg = bench._bench_cfg().replace(contact_capacity=8)
    states = bench._broadcast(st, 256, jnp.float32, jitter=1e-4)
    ext = jnp.zeros((256, spec.num_bodies, 6), jnp.float32)
    _, gk = _grad_fn(spec, states, kcfg, 20)(ext)
    _, gx = _grad_fn(spec, states, kcfg.replace(solver=SolverKind.JACOBI),
                     20)(ext)
    scale = max(float(jnp.abs(gx).max()), 1e-12)
    rel = float(jnp.abs(gk - gx).max()) / scale
    assert _finite(gk) and rel < 1e-2, f"IFT vs unrolled: rel {rel}"
    # (b) production shape, bench config, 4-box stack
    spec4, st4 = scenes.box_stack(4, dtype=jnp.float32)
    states4 = bench._broadcast(st4, B_FULL, jnp.float32)
    ext4 = jnp.zeros((B_FULL, spec4.num_bodies, 6), jnp.float32)
    t0 = time.perf_counter()
    v, g = jax.block_until_ready(
        _grad_fn(spec4, states4, bench._bench_cfg(), 50)(ext4))
    dt = time.perf_counter() - t0
    assert _finite((v, g)) and g.shape == ext4.shape
    _say(5, f"IFT vs unrolled grad (box_drop B=256 H=20, 16 sweeps) rel err "
            f"{rel:.2e} < 1e-2; B={B_FULL} H=50 IFT grad finite "
            f"(first call incl. compile {dt:.1f} s)")


def phase_pile():
    from eggshell_tpu.physics.contacts import count_dropped_contacts

    spec, st = scenes.box_pile(216, dtype=jnp.float32)
    cfg = bench._bench_cfg().replace(
        solver=SolverKind.MATRIX_FREE, solver_iters=60,
        contact_capacity=4096, pair_capacity=2048, broadphase_margin=0.05,
        max_correcting_vel=2.0,
    )
    out = rollout_batched(spec, bench._broadcast(st, 8, jnp.float32), cfg,
                          10)
    assert _finite(out), "pile216 not finite"
    dropped = jax.vmap(lambda s: count_dropped_contacts(spec, s, cfg))(out)
    _say(6, f"pile216 MATRIX_FREE 10 steps B=8 finite; dropped contacts "
            f"per scene {[int(d) for d in dropped]}")


def phase_fem():
    import bench_fem
    from eggshell_tpu.fem import fdtd as fd

    res = bench_fem.fem_driven(hs=(0.15,))["h0.15"]
    par = res["bcr_device"]["parity_vs_superlu"]
    f = fd.init_2d(512, 512)
    dt = float(fd.courant_dt(1.0, 2))
    f = f._replace(ez=f.ez.at[256, 256].set(1.0))
    out = jax.jit(lambda f: jax.lax.scan(
        lambda c, _: (fd.step_2d(c, dt, 1.0), None), f, None, length=20
    )[0])(f)
    assert _finite(out) and float(jnp.abs(out.ez).max()) > 0
    _say(7, f"fem_driven h=0.15 ({res['num_triangles']} triangles) |S21| "
            f"device BCR vs host SuperLU {par:.2e} < 1e-3; FDTD 2D 512^2 "
            f"x 20 steps finite")


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-n", "0", "-p", "no:cacheprovider", "-m", "gpu",
                      "tests/test_lcp_kernel.py",
                      "tests/test_jacobi_kernel_step.py"])
    assert rc == 0, f"gpu tests: pytest exit code {rc}"
    _say(8, "tests marked gpu")


def four_cards(card):
    from eggshell_tpu.mpc.sampling import mppi_update
    from eggshell_tpu.parallel import mesh as pm

    assert len(jax.devices()) == 4, f"needs 4 GPUs, found {jax.devices()}"
    mesh = pm.make_mesh(4)
    # the per-scene path (step_ode), which the sharded functions vmap
    cfg = bench._bench_cfg().replace(solver=SolverKind.JACOBI,
                                     contact_capacity=32)
    spec, st = scenes.living_room(dtype=jnp.float32)
    target = jnp.asarray([0.0, 0.0, 0.5], jnp.float32)

    def cost_fn(final):
        return jnp.sum((final.p[4] - target) ** 2)

    kw = dict(controlled_body=4, num_samples=B_FULL, noise_sigma=5.0,
              temperature=1.0, noise_mode="constant")
    mean0 = jnp.zeros((20, 6), jnp.float32)
    key = jax.random.PRNGKey(0)
    m_s, c_s = pm.sharded_mppi_update(spec, st, cfg, mean0, key, cost_fn,
                                      mesh, **kw)
    m_l, c_l = mppi_update(spec, st, cfg, mean0, key, cost_fn, **kw)
    # f32, HIGHEST matmuls; per-device shards differ from the one-card
    # program in fusion and reduction order only
    dm = float(jnp.abs(m_s - m_l).max())
    dc = float(jnp.abs(c_s - c_l).max())
    tol_m = 1e-4 * max(float(jnp.abs(m_l).max()), 1.0)
    tol_c = 1e-4 * max(float(jnp.abs(c_l).max()), 1.0)
    assert dm < tol_m and dc < tol_c, (dm, dc)
    print(f"PASS four-cards mppi: sharded vs local S={B_FULL} H=20 max diff "
          f"mean {dm:.2e} (tol {tol_m:.1e}), costs {dc:.2e} "
          f"(tol {tol_c:.1e})", flush=True)

    spec4, st4 = scenes.box_stack(4, dtype=jnp.float32)
    rcfg = bench._bench_cfg().replace(solver=SolverKind.JACOBI)
    states = bench._broadcast(st4, B_FULL, jnp.float32)
    out_s = pm.sharded_rollout(spec4, pm.shard_batch(mesh, states), rcfg,
                               50, mesh)
    out_l = rollout_batched(spec4, states, rcfg, 50)
    dr = _max_abs_diff(out_s, out_l)
    assert _finite(out_s) and dr < 1e-4, dr
    print(f"PASS four-cards rollout: sharded_rollout vs rollout_batched "
          f"B={B_FULL} H=50 max diff {dr:.2e} (tol 1e-4) on {card}",
          flush=True)


def main():
    device = bench.device_info()
    if device["platform"] != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {device}",
              file=sys.stderr)
        sys.exit(1)
    enable_compile_cache()
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"PASS phase 0: jax.devices() = {jax.devices()}", flush=True)
    t0 = time.perf_counter()
    if "--four-cards" in sys.argv[1:]:
        four_cards(card)
    else:
        phases = (phase_oracle, lambda: phase_headline(card),
                  phase_lcp_kernel, phase_mppi, phase_grad, phase_pile,
                  phase_fem, phase_gpu_tests)
        for fn in phases:
            fn()
    print(f"total {time.perf_counter() - t0:.1f} s; card: {card}",
          flush=True)
    print(json.dumps({"ok": True, "device": bench.device_info()}))


if __name__ == "__main__":
    main()
