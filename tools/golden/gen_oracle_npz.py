"""Regenerate tests/data/oracle_stack4_f64.npz — the DIRECT/f64 oracle
trajectory used by bench.py's on-device `oracle_gate`.

Recipe (must match bench.py's gate scenario exactly):
  - scene: scenes.box_stack(4) — the unperturbed canonical 4-box stack
    (BASELINE config #3 at bench size), f64;
  - solver: SolverKind.DIRECT (Murty pivot + mixed Schur solver,
    ref eggshell/lcp.cc:141-336) with the bench's physical model —
    always-on CFM 0.01, ERP 0.2, dt 1e-3 — and ample contact capacity;
  - 120 steps on CPU/f64, recording (p, v) checkpoints at steps
    30/60/90/120.

The committed golden CSVs have tools/golden/build_golden.sh as their
regeneration recipe; this script is the same thing for the binary
oracle blob (round-3 VERDICT weak #3).

Usage:  JAX_PLATFORMS=cpu python tools/golden/gen_oracle_npz.py [out.npz]
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main(out_path: str):
    from eggshell_tpu.physics import scenes
    from eggshell_tpu.physics.stepper import step_ode
    from eggshell_tpu.utils.config import SimConfig, SolverKind

    spec, state = scenes.box_stack(4, dtype=jnp.float64)
    cfg = SimConfig(
        solver=SolverKind.DIRECT,
        conditional_cfm=False,
        cfm_always=0.01,
        contact_capacity=64,
    )

    @jax.jit
    def seg(st):
        def body(s, _):
            return step_ode(spec, s, cfg)[0], None

        return jax.lax.scan(body, st, None, length=30)[0]

    checkpoints = [30, 60, 90, 120]
    data = {"steps": np.asarray(checkpoints, np.int64)}
    for ck in checkpoints:
        state = seg(state)
        data[f"p{ck}"] = np.asarray(state.p, np.float64)
        data[f"v{ck}"] = np.asarray(state.v, np.float64)

    np.savez(out_path, **data)
    print(f"wrote {out_path}: " + ", ".join(sorted(data)))


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    default = os.path.join(here, "..", "..", "tests", "data",
                           "oracle_stack4_f64.npz")
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.normpath(default))
