"""Multi-process (multi-host-shaped) launcher for sharded rollouts.

The reference is a single-process desktop app (SURVEY.md §2.9 / §5.8:
ParallelFor worker threads are its entire concurrency story); multi-host
scaling is a new first-class component of this build.  This launcher is
the standard `jax.distributed.initialize` pattern: one process per host
(here: per local rank, with single-device CPU backends, so the
cross-process collective path is exercised without accelerators), a
global mesh over every process's devices, and host-local data fed via
`jax.make_array_from_process_local_data`.

Run directly to launch N local processes and verify that a 2-process
sharded rollout matches the single-process result:

    python tools/multihost_launcher.py --nprocs 2 --batch 8

Each worker prints one JSON line; rank 0 additionally runs the
single-process reference and prints the comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worker(rank: int, nprocs: int, coordinator: str, batch: int,
           horizon: int, out_path: str) -> None:
    # one CPU device per process: the multi-HOST topology shape
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=1"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=nprocs,
        process_id=rank,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from eggshell_tpu.parallel import mesh as pmesh
    from eggshell_tpu.physics import scenes
    from eggshell_tpu.utils.config import SimConfig, SolverKind

    cfg = SimConfig(
        solver=SolverKind.JACOBI, solver_iters=30, jacobi_omega=0.3,
        conditional_cfm=False, cfm_always=0.01, contact_capacity=20,
    )
    spec, state = scenes.box_stack(3, dtype=jnp.float64)

    devs = jax.devices()            # all processes' devices, globally
    mesh = Mesh(np.asarray(devs), ("batch",))

    # deterministic global batch; each process materializes its shard
    full = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(
            np.asarray(x), (batch,) + np.asarray(x).shape
        ).copy(),
        state,
    )
    full = full._replace(
        p=full.p + np.linspace(0, 1e-3, batch)[:, None, None]
    )
    sharding = NamedSharding(mesh, P("batch"))
    per = batch // nprocs
    lo = rank * per
    states = jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(
            sharding, np.asarray(x)[lo:lo + per]
        ),
        full,
    )

    out = pmesh.sharded_rollout(spec, states, cfg, horizon, mesh)
    # gather the full result on every process for comparison
    p_final = np.asarray(
        jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(out.p)
        .addressable_data(0)
    )
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"p": p_final.tolist()}, f)
    print(json.dumps({
        "rank": rank, "devices": len(devs),
        "local_shard": per, "finite": bool(np.isfinite(p_final).all()),
    }))
    jax.distributed.shutdown()


def launch(nprocs: int, batch: int, horizon: int, out_path: str,
           port: int = 0) -> None:
    import socket

    if port == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    coordinator = f"127.0.0.1:{port}"
    procs = []
    for r in range(nprocs):
        procs.append(subprocess.Popen([
            sys.executable, os.path.abspath(__file__),
            "--worker", str(r), "--nprocs", str(nprocs),
            "--coordinator", coordinator, "--batch", str(batch),
            "--horizon", str(horizon), "--out", out_path,
        ]))
    codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        raise RuntimeError(f"worker exit codes: {codes}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--worker", type=int, default=-1)
    ap.add_argument("--coordinator", type=str, default="")
    ap.add_argument("--out", type=str, default="/tmp/multihost_rollout.json")
    args = ap.parse_args()

    if args.worker >= 0:
        worker(args.worker, args.nprocs, args.coordinator, args.batch,
               args.horizon, args.out)
        return

    launch(args.nprocs, args.batch, args.horizon, args.out)

    # single-process reference
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from eggshell_tpu.parallel import mesh as pmesh
    from eggshell_tpu.physics import scenes
    from eggshell_tpu.utils.config import SimConfig, SolverKind

    cfg = SimConfig(
        solver=SolverKind.JACOBI, solver_iters=30, jacobi_omega=0.3,
        conditional_cfm=False, cfm_always=0.01, contact_capacity=20,
    )
    spec, state = scenes.box_stack(3, dtype=jnp.float64)
    states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (args.batch,) + x.shape).copy(), state
    )
    states = states._replace(
        p=states.p + jnp.linspace(0, 1e-3, args.batch)[:, None, None]
    )
    m1 = pmesh.make_mesh(1)
    ref = pmesh.sharded_rollout(spec, states, cfg, args.horizon, m1)
    got = np.asarray(json.load(open(args.out))["p"])
    err = float(np.max(np.abs(got - np.asarray(ref.p))))
    print(json.dumps({
        "metric": "2-process vs 1-process rollout max |dp|",
        "value": err, "pass": err < 1e-9,
    }))
    if err >= 1e-9:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
