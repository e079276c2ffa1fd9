"""Weak-scaling harness — the BASELINE.json scaling metric
(rollouts/s at 1 device / N devices, efficiency vs linear).

On several GPUs this measures sharded rollouts; without them, run with
a virtual CPU mesh to validate the sharding path and measure the
collective/sharding overhead shape:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/scaling_bench.py

For multi-host runs, call jax.distributed.initialize() first (one
process per host) — the mesh spans all processes' devices automatically.

Prints one JSON line per device count plus a summary efficiency figure.
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp


def main(per_device_batch: int = 256, horizon: int = 20,
         artifact: str = None):
    import platform

    from eggshell_tpu.parallel import mesh as pmesh
    from eggshell_tpu.physics import scenes
    from eggshell_tpu.utils.config import SimConfig, SolverKind

    dtype = jnp.float32
    cfg = SimConfig(
        solver=SolverKind.JACOBI, solver_iters=30, jacobi_omega=0.3,
        conditional_cfm=False, cfm_always=0.01, contact_capacity=20,
    )
    spec, state = scenes.box_stack(4, dtype=dtype)
    ndev_all = len(jax.devices())
    counts = sorted({1, 2, ndev_all} & set(range(1, ndev_all + 1)))

    def run(nd, B):
        states = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(), state
        )
        m = pmesh.make_mesh(nd)
        states = pmesh.shard_batch(m, states)
        out = pmesh.sharded_rollout(spec, states, cfg, horizon, m)
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(3):          # best-of-3: the host may be shared
            t0 = time.perf_counter()
            out = pmesh.sharded_rollout(spec, states, cfg, horizon, m)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        return B / best

    cpu_count = __import__("os").cpu_count()
    virtual = jax.default_backend() == "cpu" and ndev_all > 1
    results = []
    record = {
        "backend": jax.default_backend(),
        "devices_total": ndev_all,
        "cpu_count": cpu_count,
        "platform": platform.platform(),
        "horizon": horizon,
        "per_device_batch": per_device_batch,
        "interpretation": (
            "virtual CPU mesh: the 1-device baseline already uses every "
            "physical core via XLA intra-op parallelism, so the "
            "weak-scaling rows measure core oversubscription, NOT "
            "sharding cost; the sharding_overhead_control row (fixed "
            "total batch, throughput_sharded / throughput_unsharded; "
            ">=1.0 means the shard_map machinery is free) is the "
            "meaningful machinery metric on this host. The >=0.9 "
            "weak-scaling target is a multi-GPU metric — see "
            "chip_smoke.py --four-cards for the sharded-path "
            "validation."
            if virtual else
            "real device mesh: weak_scaling_efficiency is the "
            "BASELINE.json metric."
        ),
        "weak_scaling": [],
    }
    for nd in counts:
        B = per_device_batch * nd
        rps = run(nd, B)
        results.append((nd, rps))
        row = {
            "devices": nd, "batch": B, "rollouts_per_s": round(rps, 1),
            "per_device": round(rps / nd, 1),
        }
        record["weak_scaling"].append(row)
        print(json.dumps(row))
    if len(results) > 1:
        base = results[0][1] / results[0][0]
        eff = results[-1][1] / results[-1][0] / base
        summary = {
            "metric": "weak-scaling efficiency",
            "devices": results[-1][0],
            "value": round(eff, 3),
            "target": 0.9,
        }
        if virtual:
            summary["host_core_bound"] = True
            summary["note"] = (
                f"{results[-1][0]} virtual devices share {cpu_count} "
                "physical cores and the 1-device baseline is itself "
                "multi-core — this row is a lower bound with no "
                "sharding-cost signal; see sharding_overhead_control"
            )
        record["weak_scaling_efficiency"] = summary
        print(json.dumps(summary))

        # fixed-total-work control: on an oversubscribed virtual-device
        # CPU mesh the 1-device baseline uses ALL cores via XLA intra-op
        # parallelism, so the weak-scaling figure is a LOWER bound; this
        # control isolates the pure sharding/collective overhead (1.0 =
        # sharding is free at equal total compute).  Measured at SEVERAL
        # total batch sizes: a single point can be dominated by how well
        # XLA intra-op happens to parallelize that one shape (r2's 1.75
        # control meant the unsharded baseline was the inefficient side);
        # the MINIMUM over the series is the honest upper bound on the
        # sharding machinery's cost.
        nd_last = counts[-1]
        series = []
        for B_fix in (nd_last * 64, nd_last * per_device_batch,
                      nd_last * 4 * per_device_batch):
            r1 = run(1, B_fix)
            rN = run(nd_last, B_fix)
            series.append({"batch": B_fix, "value": round(rN / r1, 3)})
        ctrl = {
            "metric": "sharding overhead control "
                      "(fixed total batch, t1/tN)",
            "devices": nd_last,
            "series": series,
            "value": min(s["value"] for s in series),
            "note": "1.0 means sharding adds no overhead at equal "
                    "total compute; virtual CPU devices share the "
                    "physical cores so this, not the weak-scaling row, "
                    "measures the sharding machinery itself.  Values "
                    ">1.0 mean the unsharded single-device baseline is "
                    "the inefficient side (XLA intra-op); min over the "
                    "batch series bounds the machinery cost.",
        }
        record["sharding_overhead_control"] = ctrl
        print(json.dumps(ctrl))
    if artifact:
        # lead with the meaningful machinery metric on virtual meshes
        order = [
            "backend", "devices_total", "cpu_count", "platform",
            "horizon", "per_device_batch", "interpretation",
            "sharding_overhead_control", "weak_scaling_efficiency",
            "weak_scaling",
        ]
        record = {k: record[k] for k in order if k in record}
        with open(artifact, "w") as f:
            json.dump(record, f, indent=1)


def control_profile(artifact: str = None, per_device_batch: int = 256,
                    horizon: int = 20, repeats: int = 10):
    """Round-5 investigation of the sharding-control outlier (r3
    artifact: 0.745 / 1.206 / 0.681 across total batch 512/2048/8192).

    The control divides throughput of the 8-virtual-device sharded
    program by the 1-device unsharded program at EQUAL total batch on a
    2-core host.  Two candidate explanations, each directly measured:

    1. *Noise*: best-of-3 on a shared 2-vCPU box — measured here by
       `repeats` interleaved timings of both programs with full spread.
    2. *The denominator moves*: XLA-CPU intra-op parallelization
       efficiency is shape-dependent, so the unsharded baseline's own
       per-rollout cost varies with batch; the ratio then tracks the
       BASELINE's efficiency curve, not the sharding machinery.
       Measured here as unsharded per-rollout time across the batch
       series (B and B/8) — if t(B)/8 != t(B/8) the single-program
       baseline is not shape-neutral and the control ratio inherits
       that non-monotonicity.
    """
    import platform

    from eggshell_tpu.parallel import mesh as pmesh
    from eggshell_tpu.physics import scenes
    from eggshell_tpu.utils.config import SimConfig, SolverKind

    cfg = SimConfig(
        solver=SolverKind.JACOBI, solver_iters=30, jacobi_omega=0.3,
        conditional_cfm=False, cfm_always=0.01, contact_capacity=20,
    )
    spec, state = scenes.box_stack(4, dtype=jnp.float32)
    ndev = len(jax.devices())

    def timed(nd, B):
        states = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(), state
        )
        m = pmesh.make_mesh(nd)
        states = pmesh.shard_batch(m, states)
        out = pmesh.sharded_rollout(spec, states, cfg, horizon, m)
        jax.block_until_ready(out)

        def once():
            t0 = time.perf_counter()
            o = pmesh.sharded_rollout(spec, states, cfg, horizon, m)
            jax.block_until_ready(o)
            return time.perf_counter() - t0

        return once

    B_big = ndev * 4 * per_device_batch          # the outlier point
    one_big = timed(1, B_big)
    shd_big = timed(ndev, B_big)
    t1, tN = [], []
    for _ in range(repeats):                     # interleaved: drift-fair
        t1.append(one_big())
        tN.append(shd_big())
    stats = lambda ts: {
        "min_s": round(min(ts), 4), "max_s": round(max(ts), 4),
        "mean_s": round(sum(ts) / len(ts), 4),
        "spread": round(max(ts) / min(ts), 3),
    }
    ratio_best = min(t1) / min(tN)
    ratios = sorted(a / b for a, b in zip(t1, tN))

    # baseline shape-efficiency curve: unsharded per-rollout time
    curve = []
    for B in (per_device_batch, 2 * per_device_batch,
              4 * per_device_batch, ndev * per_device_batch, B_big):
        f = timed(1, B)
        best = min(f() for _ in range(5))
        curve.append({"batch": B, "best_s": round(best, 4),
                      "us_per_rollout": round(best / B * 1e6, 2)})
    us = [c["us_per_rollout"] for c in curve]
    rec = {
        "backend": jax.default_backend(),
        "devices": ndev,
        "cpu_count": os.cpu_count(),
        "platform": platform.platform(),
        "batch": B_big,
        "repeats": repeats,
        "unsharded": stats(t1),
        "sharded": stats(tN),
        "control_ratio_best": round(ratio_best, 3),
        "control_ratio_median": round(ratios[len(ratios) // 2], 3),
        "unsharded_shape_curve": curve,
        "baseline_shape_efficiency_spread": round(max(us) / min(us), 3),
    }
    # r3 series range: 1.206 / 0.681 = 1.77x swing to explain
    r3_swing = 1.206 / 0.681
    noise = max(rec["unsharded"]["spread"], rec["sharded"]["spread"])
    explainable = rec["baseline_shape_efficiency_spread"] * noise
    if rec["control_ratio_best"] >= 1.0:
        rec["conclusion"] = (
            "REFUTED as machinery cost: re-measured at the same batch, "
            f"the SHARDED program is {rec['control_ratio_best']}x FASTER "
            "than the unsharded baseline (median "
            f"{rec['control_ratio_median']}), the opposite sign of the "
            "r3 0.681 — with identical machinery.  Combined with the "
            f"{noise}x per-run spread and the "
            f"{rec['control_ratio_best'] / 0.681:.2f}x cross-session "
            "swing, the control ratio on this oversubscribed 2-core "
            "virtual mesh measures XLA-CPU scheduling luck, not "
            "shard_map overhead; the r3 outlier was an artifact of the "
            "same instability.  Real machinery validation lives in "
            "dryrun_multichip and chip_smoke.py --four-cards."
        )
    elif explainable >= r3_swing:
        rec["conclusion"] = (
            "EXPLAINED: the unsharded baseline's own per-rollout cost "
            f"varies {rec['baseline_shape_efficiency_spread']}x across "
            "the batch series (XLA-CPU intra-op parallelization is "
            "shape-dependent on this 2-core host) and per-run noise is "
            f"{noise}x; together ({round(explainable, 2)}x) they cover "
            f"the r3 series' {round(r3_swing, 2)}x swing — the control "
            "ratio tracks the DENOMINATOR's shape efficiency, not a "
            "sharding-machinery cost.  On real GPUs the machinery is the "
            "collective set chip_smoke.py --four-cards checks; this "
            "control is a virtual-mesh proxy."
        )
    else:
        rec["conclusion"] = (
            "NOT fully explained by baseline shape-efficiency "
            f"({rec['baseline_shape_efficiency_spread']}x) + noise "
            f"({noise}x) < r3 swing {round(r3_swing, 2)}x — a real "
            "sharded-program overhead remains at this batch; see the "
            "sharded stats above."
        )
    print(json.dumps(rec, indent=1))
    if artifact:
        with open(artifact, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    import sys

    if "--control-profile" in sys.argv:
        args = [a for a in sys.argv[1:] if not a.startswith("--")]
        control_profile(artifact=args[0] if args else None)
    else:
        art = sys.argv[1] if len(sys.argv) > 1 else None
        main(artifact=art)
