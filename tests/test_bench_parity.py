"""Gate the bench.py solver configuration on physics parity.

bench.py measures the batched fast path with JACOBI(_KERNEL) iters=16,
omega=0.3, heavy-ball beta=0.45, always-on CFM 0.01, contact capacity
20.  These tests pin THAT exact configuration's trajectories to the
DIRECT (Murty/Schur pivot, f64) oracle path within the 1e-3 north-star
bound (BASELINE.md "control/state parity"), and assert the bench scenes
never overflow the 20-lane contact capacity — so any future perf tuning
of iters/omega/beta/capacity that trades away accuracy fails here
instead of silently inflating the bench number.

The sweep kernel (ops/lcp_kernel) is pinned to this same XLA jacobi
update (equal sweeps/omega/beta) by tests/test_lcp_kernel.py, so
XLA-path parity here transfers to the kernel path measured on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eggshell_tpu.physics import scenes
from eggshell_tpu.physics.contacts import count_dropped_contacts
from eggshell_tpu.physics.stepper import step_ode
from eggshell_tpu.utils.config import SimConfig, SolverKind

# Must match bench.py exactly (keep in sync).  Round-4 sweep-count
# sensitivity scan: 22 -> 16 sweeps moves the DIRECT/f64-oracle
# trajectory error from 2.0e-5 to 2.9e-5 on the 120-step stack (1.4e-4
# -> 1.8e-4 on stack8; 7e-7 -> 6e-6 on the 600-step cairn) — all >= 5x
# inside the 1e-3 bound, re-gated below.
BENCH_SOLVER = dict(
    solver_iters=16,
    solver_tol=0.0,
    jacobi_omega=0.3,
    jacobi_beta=0.45,
    conditional_cfm=False,
    cfm_always=0.01,
    contact_capacity=20,
)


def _bench_cfg():
    return SimConfig(solver=SolverKind.JACOBI, **BENCH_SOLVER)


def _oracle_cfg():
    # Same physical model (same CFM/ERP/dt), exact complementarity solve,
    # ample contact capacity, f64 under the test-suite x64 config.
    return SimConfig(
        solver=SolverKind.DIRECT,
        conditional_cfm=False,
        cfm_always=0.01,
        contact_capacity=64,
    )


def test_bench_config_matches_bench_py():
    """bench.py must use exactly the gated configuration."""
    import ast
    import os

    src = open(
        os.path.join(os.path.dirname(__file__), "..", "bench.py")
    ).read()
    tree = ast.parse(src)
    kwargs = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == (
            "SimConfig"
        ):
            for kw in node.keywords:
                if isinstance(kw.value, ast.Constant):
                    kwargs[kw.arg] = kw.value.value
    for k, v in BENCH_SOLVER.items():
        assert kwargs.get(k) == v, (
            f"bench.py SimConfig({k}={kwargs.get(k)!r}) != gated {v!r}; "
            "update BENCH_SOLVER and re-validate parity"
        )


@pytest.mark.parametrize(
    "scene_name,steps,tol",
    [("box_stack", 120, 1e-3), ("cairn", 100, 1e-3)],
)
def test_bench_config_parity_vs_direct_oracle(scene_name, steps, tol):
    """>=100 steps of the exact bench solver config stay within 1e-3 of
    the DIRECT/f64 oracle trajectory (north-star parity bound), with
    zero contact-capacity overflow."""
    if scene_name == "box_stack":
        spec, state0 = scenes.box_stack(4, dtype=jnp.float64)
    else:
        spec, state0 = scenes.cairn(4, seed=3, dtype=jnp.float64)

    cfg_fast = _bench_cfg()
    cfg_oracle = _oracle_cfg()

    @jax.jit
    def run_fast(st):
        def body(s, _):
            s2, _cs = step_ode(spec, s, cfg_fast)
            dropped = count_dropped_contacts(spec, s, cfg_fast)
            return s2, dropped

        return jax.lax.scan(body, st, None, length=steps)

    @jax.jit
    def run_oracle(st):
        def body(s, _):
            s2, _cs = step_ode(spec, s, cfg_oracle)
            return s2, None

        return jax.lax.scan(body, st, None, length=steps)

    fast_final, dropped = run_fast(state0)
    oracle_final, _ = run_oracle(state0)

    assert int(np.asarray(dropped).max()) == 0, (
        "bench scene overflows contact_capacity=20 — the bench is "
        "silently truncating contacts"
    )

    for name in ("p", "v", "q", "w"):
        a = np.asarray(getattr(fast_final, name), float)
        b = np.asarray(getattr(oracle_final, name), float)
        err = np.max(np.abs(a - b))
        assert err < tol, f"{scene_name}.{name}: |fast - oracle| = {err}"


@pytest.mark.parametrize("jitter", [0.5e-3, 1e-3])
def test_bench_batch_distribution_parity(jitter):
    """bench.py perturbs the 4096-scenario batch positions by up to 1e-3
    (linspace over the batch, bench.py _broadcast).  The oracle gate must
    hold across that distribution, not only at the canonical point —
    this samples the batch midpoint and extreme and re-asserts both the
    1e-3 bound and zero contact-capacity overflow there."""
    spec, state0 = scenes.box_stack(4, dtype=jnp.float64)
    state0 = state0._replace(p=state0.p + jitter)
    steps = 120

    cfg_fast = _bench_cfg()
    cfg_oracle = _oracle_cfg()

    @jax.jit
    def run_fast(st):
        def body(s, _):
            s2, _cs = step_ode(spec, s, cfg_fast)
            return s2, count_dropped_contacts(spec, s, cfg_fast)

        return jax.lax.scan(body, st, None, length=steps)

    @jax.jit
    def run_oracle(st):
        def body(s, _):
            return step_ode(spec, s, cfg_oracle)[0], None

        return jax.lax.scan(body, st, None, length=steps)

    fast_final, dropped = run_fast(state0)
    oracle_final, _ = run_oracle(state0)

    assert int(np.asarray(dropped).max()) == 0
    for name in ("p", "v", "q", "w"):
        a = np.asarray(getattr(fast_final, name), float)
        b = np.asarray(getattr(oracle_final, name), float)
        err = np.max(np.abs(a - b))
        assert err < 1e-3, f"jitter={jitter} {name}: |fast - oracle| = {err}"


def test_bench_config_parity_f32():
    """The parity bound also holds in the f32 the bench actually runs
    (x64 comparison above isolates solver truncation; this catches f32
    accumulation drift on the same horizon)."""
    spec, state0 = scenes.box_stack(4, dtype=jnp.float32)
    spec64, state064 = scenes.box_stack(4, dtype=jnp.float64)
    steps = 120

    cfg_fast = _bench_cfg()
    cfg_oracle = _oracle_cfg()

    def make_run(sp, cfg):
        @jax.jit
        def run(st):
            def body(s, _):
                s2, _ = step_ode(sp, s, cfg)
                return s2, None

            return jax.lax.scan(body, st, None, length=steps)[0]

        return run

    fast = make_run(spec, cfg_fast)(state0)
    oracle = make_run(spec64, cfg_oracle)(state064)
    err = np.max(np.abs(np.asarray(fast.p, float) - np.asarray(oracle.p)))
    assert err < 1e-3, f"f32 bench path drifts from oracle: {err}"
