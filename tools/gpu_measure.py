"""Device measurements behind PERF.md, on one NVIDIA GPU.

    python tools/gpu_measure.py [--out measure/gpu_measure.json]

  lcp_solve    the LCP sweep kernel (ops/lcp_kernel) against the vmapped
               XLA Jacobi sweep, solve only: B=4096, m=60/96/144, 16
               sweeps, omega 0.3, beta 0.45
  rollout      end to end: rollout_batched with SolverKind.JACOBI_KERNEL
               (kernel sweep) against SolverKind.JACOBI (XLA sweep) on
               the headline cell (4-box stack, B=4096, H=50, m=60) and
               box_stack8 (m=96)
  adjoint      batched IFT adjoint (ops/lcp.ift_adjoint) with Cholesky
               against LU at the gradient-MPC shape (B=4096, m=60)
  stages       per-stage device time of one headline step from a
               jax.profiler trace (named scopes contacts / assembly /
               lcp / integrate), plain XLA path and kernel path.  Run it
               with XLA_FLAGS=--xla_gpu_enable_command_buffer= so each
               kernel carries its own HLO op name (inside a CUDA-graph
               command buffer every kernel reads "command_buffer")

Times are host-clock means over `reps` calls ending in
block_until_ready, after a warm-up call; two versions are timed in
turns (a, b, b, a).  Prints one JSON object and writes it to --out.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
from eggshell_tpu.ops import lcp, lcp_kernel  # noqa: E402
from eggshell_tpu.parallel.rollout import rollout_batched  # noqa: E402
from eggshell_tpu.physics import scenes, stepper  # noqa: E402
from eggshell_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from eggshell_tpu.utils.config import SolverKind  # noqa: E402

B = 4096
STAGES = ("contacts", "assembly", "lcp", "integrate")


def _time(fn, reps):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _turns(fa, fb, reps):
    """Mean seconds of fa and fb, timed a, b, b, a."""
    ta = [_time(fa, reps)]
    tb = [_time(fb, reps), _time(fb, reps)]
    ta.append(_time(fa, reps))
    return float(np.mean(ta)), float(np.mean(tb)), ta, tb


def _problems(m, key):
    k1, k2, k3 = jax.random.split(key, 3)
    M = jax.random.uniform(k1, (B, m, m), jnp.float32, -1, 1)
    A = jnp.einsum("bij,bkj->bik", M, M, precision="highest") \
        + m * jnp.eye(m, dtype=jnp.float32)
    b = jax.random.uniform(k2, (B, m), jnp.float32, -1, 1)
    is_eq = jax.random.uniform(k3, (B, m)) < 0.1
    lo = jnp.where(is_eq, 0.0, -1.0).astype(jnp.float32)
    hi = jnp.where(is_eq, 0.0, 1.0).astype(jnp.float32)
    return A, b, is_eq, lo, hi


def lcp_solve(reps):
    kw = dict(iters=16, omega=0.3, beta=0.45)
    xla = jax.jit(jax.vmap(lambda a, r, e, l, h: lcp.solve_lcp(
        a, r, e, l, h, method="jacobi", iters=16, jacobi_omega=0.3,
        jacobi_beta=0.45)))
    out = {}
    for m in (60, 96, 144):
        args = _problems(m, jax.random.PRNGKey(m))
        entry = {}
        try:
            xk = lcp_kernel.jacobi_sweeps_kernel(*args, **kw)
            entry["max_abs_diff"] = float(jnp.max(jnp.abs(xk - xla(*args))))
            tk, tx, _, _ = _turns(
                lambda: lcp_kernel.jacobi_sweeps_kernel(*args, **kw),
                lambda: xla(*args), reps)
            entry.update(kernel_ms=tk * 1e3, xla_ms=tx * 1e3,
                         xla_over_kernel=tx / tk)
        except Exception as e:  # a refused compile is the finding
            entry["kernel_error"] = repr(e)[:400]
            entry["xla_ms"] = _time(lambda: xla(*args), reps) * 1e3
        out[f"m{m}"] = entry
    return out


def rollout(reps):
    out = {}
    for name, nb, cap in (("headline_stack4_m60", 4, 20),
                          ("box_stack8_m96", 8, 32)):
        spec, st = scenes.box_stack(nb, dtype=jnp.float32)
        cfg = bench._bench_cfg().replace(contact_capacity=cap)
        states = bench._broadcast(st, B, jnp.float32)
        fk = jax.jit(lambda s, c=cfg: rollout_batched(spec, s, c, 50))
        xcfg = cfg.replace(solver=SolverKind.JACOBI)
        fx = jax.jit(lambda s, c=xcfg: rollout_batched(spec, s, c, 50))
        tk, tx, ta, tb = _turns(lambda: fk(states), lambda: fx(states), reps)
        out[name] = {
            "kernel_rollouts_per_s": B / tk, "xla_rollouts_per_s": B / tx,
            "kernel_s": ta, "xla_s": tb, "xla_over_kernel": tx / tk,
            "lcp_path": lcp_kernel.lcp_path(3 * cap),
        }
    return out


def adjoint(reps):
    spec, st = scenes.box_stack(4, dtype=jnp.float32)
    cfg = bench._bench_cfg()
    states = bench._broadcast(st, B, jnp.float32)
    states = rollout_batched(spec, states, cfg, 20)
    sys_, A, rhs, *_ = stepper._batched_system(spec, states, cfg, None)
    x = lcp_kernel.solve_jacobi_batched(
        A, rhs, sys_.is_eq, sys_.lo, sys_.hi, iters=16, omega=0.3, beta=0.45)
    g = jax.random.normal(jax.random.PRNGKey(1), x.shape, x.dtype)

    def make(f):
        return jax.jit(jax.vmap(lambda a, b, e, l, h, xx, gg: lcp.ift_adjoint(
            a, b, e, l, h, xx, gg, factorization=f)))

    args = (A, rhs, sys_.is_eq, sys_.lo, sys_.hi, x, g)
    lu, ch = make("lu"), make("cholesky")
    gb_lu, gb_ch = lu(*args)[1], ch(*args)[1]
    rel = float(jnp.max(jnp.abs(gb_lu - gb_ch))
                / jnp.maximum(jnp.max(jnp.abs(gb_lu)), 1e-30))
    tl, tc, _, _ = _turns(lambda: lu(*args), lambda: ch(*args), reps)
    return {"B": B, "m": int(x.shape[1]), "lu_ms": tl * 1e3,
            "cholesky_ms": tc * 1e3, "lu_over_cholesky": tl / tc,
            "max_rel_diff_gb": rel}


def _busy_ns(intervals):
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def hlo_scopes(compiled_text):
    """HLO instruction name -> op_name metadata (the jax.named_scope
    path), from a compiled module's text; keyed both with '.' and '_'
    (GPU kernel names replace the dots)."""
    out = {}
    for line in compiled_text.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = .*op_name=\"([^\"]*)\"",
                     line)
        if m:
            out[m.group(1)] = m.group(2)
            out[m.group(1).replace(".", "_").replace("-", "_")] = m.group(2)
    return out


def _stage(text):
    return next((s for s in STAGES if f"/{s}/" in text
                 or text.endswith(f"/{s}")), None)


def reduce_trace(path, scopes):
    """Device time per named stage, the top kernels, and the idle share
    of the traced window, from the .xplane.pb under `path`.  An event's
    stage comes from its own stats or from `scopes` (hlo_scopes)."""
    files = [os.path.join(r, f) for r, _, fs in os.walk(path) for f in fs
             if f.endswith(".xplane.pb")]
    data = jax.profiler.ProfileData.from_file(files[0])
    per_stage = {s: 0 for s in STAGES + ("other",)}
    per_kernel = {}
    stats_of = {}
    intervals = []
    names = set()
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        names.update(ln.name for ln in lines)
        # kernels run on the "Stream #n" lines; other lines aggregate them
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                vals = [ev.name] + [str(v) for _, v in ev.stats]
                words = re.findall(r"[\w.\-]+", " ".join(vals))
                text = " ".join(vals + [scopes.get(w, "") for w in words])
                stage = _stage(text) or "other"
                per_stage[stage] += ev.duration_ns
                per_kernel[ev.name] = per_kernel.get(ev.name, 0) \
                    + ev.duration_ns
                stats_of.setdefault(ev.name, (stage, [
                    (str(k), str(v)[:120]) for k, v in ev.stats]))
                intervals.append((ev.start_ns, ev.end_ns))
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    return {
        "stage_ms": {k: v / 1e6 for k, v in per_stage.items()},
        "top_kernels_ms": [(k[:80], v / 1e6) for k, v in top],
        "top_kernel_stats": {k[:80]: stats_of[k] for k, _ in top[:5]},
        "window_ms": window / 1e6,
        "idle_share": 1.0 - _busy_ns(intervals) / window,
        "device_lines": sorted(names),
    }


def stages(outdir, steps=5):
    spec, st = scenes.box_stack(4, dtype=jnp.float32)
    out = {}
    for name, solver in (("plain_xla", SolverKind.JACOBI),
                         ("kernel", SolverKind.JACOBI_KERNEL)):
        cfg = bench._bench_cfg().replace(solver=solver)
        states = bench._broadcast(st, B, jnp.float32)
        step = jax.jit(lambda s, c=cfg: stepper.step_ode_batched(spec, s, c))
        scopes = hlo_scopes(step.lower(states).compile().as_text())
        states = jax.block_until_ready(step(states))
        path = os.path.join(outdir, f"trace_{name}")
        with jax.profiler.trace(path):
            for _ in range(steps):
                states = step(states)
            jax.block_until_ready(states)
        res = reduce_trace(path, scopes)
        res["stage_ms"] = {k: v / steps for k, v in res["stage_ms"].items()}
        res["steps"] = steps
        out[name] = res
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="measure/gpu_measure.json")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="lcp_solve,rollout,adjoint,stages")
    args = ap.parse_args()
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {d.platform}")
    enable_compile_cache()
    outdir = os.path.dirname(args.out) or "."
    os.makedirs(outdir, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    res = {"card": card, "device": bench.device_info()}
    todo = args.only.split(",")
    for name, fn in (("lcp_solve", lambda: lcp_solve(args.reps)),
                     ("rollout", lambda: rollout(args.reps)),
                     ("adjoint", lambda: adjoint(args.reps)),
                     ("stages", lambda: stages(outdir))):
        if name in todo:
            t0 = time.perf_counter()
            res[name] = fn()
            res[name + "_wall_s"] = time.perf_counter() - t0
            print(name, json.dumps(res[name]), flush=True)
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
