"""FEM / FDTD benchmark configs.  Called from bench.py's config matrix.

Each device solve runs on the GPU (native complex64); the host-SuperLU
path (the reference's factor+solve shape, toolkit/femsolver.h:134-135)
is timed on the in-process CPU backend.  Every config names the
correctness tests that gate its physics ("gated_by") — perf numbers are
only meaningful next to those.
"""

import time

import numpy as np

import jax
import jax.numpy as jnp


def _cpu():
    return jax.devices("cpu")[0]


def _guide_mesh(h, W=250.0, H=3.0988):
    from eggshell_tpu.fem.mesher import mesh_structured
    from eggshell_tpu.fem.shape import Rectangle

    cd = Rectangle(-W / 2, -H / 2, W / 2, H / 2)
    cd.Port((-W / 2, -H / 2), (-W / 2, H / 2), 1)
    cd.Port((W / 2, -H / 2), (W / 2, H / 2), 2)
    return mesh_structured(cd, (-W / 2, -H / 2), (W, 0), (0, H), h)


def _cfg():
    from eggshell_tpu.fem.helmholtz import FemConfig

    return FemConfig(type="EZ", frequency=75e9, unit=1e-3, excited_port=1)


def _cpu_args(mesh):
    from eggshell_tpu.fem.helmholtz import _cdtype

    dtype = _cdtype()
    with jax.default_device(_cpu()):
        return (
            jnp.asarray(mesh.points),
            jnp.asarray(mesh.epsilon, dtype),
            jnp.asarray(mesh.sigma_xx),
            jnp.asarray(mesh.sigma_yy),
            jnp.asarray(mesh.sigma_xy),
            jnp.asarray(mesh.excitation, dtype),
            jnp.asarray(_cfg().k0, jnp.float32),
        )


def _time(fn, reps=3):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def _s21(s):
    return float(abs(np.asarray(s)[1, 0]))


def fem_driven(hs=(0.4, 0.15, 0.12)):
    """S-parameter driven solves across mesh sizes: host SuperLU
    (reference shape) vs the block-cyclic-reduction solve on the device,
    assembly included.  |S21| parity across the two is asserted at 1e-3.

    gated_by: tests/test_block_tridiag.py (BCR == SuperLU to 1e-8),
    tests/test_conductor_loss.py (same scene family at 0.02 dB)."""
    from eggshell_tpu.fem.helmholtz import make_driven_fn

    cfg = _cfg()
    dev = jax.devices()[0]
    out = {}
    for h in hs:
        mesh = _guide_mesh(h)
        entry = {"num_points": mesh.num_points,
                 "num_triangles": mesh.num_triangles}
        args = _cpu_args(mesh)

        # host SuperLU (factor+solve per call — the reference's shape)
        fn, _ = make_driven_fn(mesh, cfg, solver="sparse")
        with jax.default_device(_cpu()):
            jfn = jax.jit(fn)
            dt, (u, s) = _time(lambda: jfn(*args))
        s21_ref = _s21(s)
        entry["superlu_host"] = {"ms": dt * 1e3, "solves_per_s": 1 / dt,
                                 "s21": s21_ref}

        fnb, _ = make_driven_fn(mesh, cfg, solver="bcr")
        jfnb = jax.jit(fnb)
        dargs = jax.device_put(args, dev)
        dt, (u, s) = _time(lambda: jfnb(*dargs))
        s21 = _s21(s)
        entry["bcr_device"] = {"ms": dt * 1e3, "solves_per_s": 1 / dt,
                               "s21": s21,
                               "parity_vs_superlu": abs(s21 - s21_ref)}
        assert abs(s21 - s21_ref) < 1e-3, "S21 parity gate"
        out[f"h{h}"] = entry
    return out


def fem_sweep():
    """Frequency sweep: the reference solves one thread per frequency
    (rama/solver.h:351-355); here all F systems (assembly + BCR solve)
    run as ONE vmapped device call vs F sequential host factorizations.
    Per-frequency |S21| parity against the host is asserted at 1e-3.

    gated_by: tests/test_fem_fields.py (sweep S-curves),
    tests/test_block_tridiag.py."""
    from eggshell_tpu.fem.helmholtz import make_driven_fn

    cfg = _cfg()
    mesh = _guide_mesh(0.4)
    F = 16
    c0 = 299792458.0
    freqs = np.linspace(70e9, 80e9, F)
    k0s = 2 * np.pi * freqs / c0 * cfg.unit

    fn, _ = make_driven_fn(mesh, cfg, solver="sparse")
    args = _cpu_args(mesh)

    # sequential host path (factor per frequency)
    with jax.default_device(_cpu()):
        jfn = jax.jit(fn)

        def seq():
            return [jfn(*args[:-1], jnp.asarray(k, jnp.float32))[1]
                    for k in k0s]

        dt_seq, s_seq = _time(seq, reps=1)
    out = {
        "num_points": mesh.num_points, "frequencies": F,
        "superlu_sequential": {"ms": dt_seq * 1e3,
                               "freq_solves_per_s": F / dt_seq},
    }

    fnb, _ = make_driven_fn(mesh, cfg, solver="bcr")
    batched = jax.jit(jax.vmap(fnb, in_axes=(None,) * 6 + (0,)))
    dev = jax.devices()[0]
    dargs = jax.device_put(args[:-1], dev)
    k_dev = jax.device_put(jnp.asarray(k0s, jnp.float32), dev)
    dt_b, (_, s_b) = _time(lambda: batched(*dargs, k_dev))
    err = max(abs(_s21(s_b[i]) - _s21(s_seq[i])) for i in range(F))
    out["bcr_batched_device"] = {
        "ms": dt_b * 1e3, "freq_solves_per_s": F / dt_b,
        "speedup_vs_sequential_host": dt_seq / dt_b,
        "max_s21_err_vs_host": err,
    }
    assert err < 1e-3, "sweep S21 parity gate"
    return out


def fem_modes():
    """Eigenmodes: host ARPACK shift-invert (the reference's solver,
    toolkit/eigensolvers.h:66-150) vs the ON-DEVICE shift-invert
    subspace iteration (BCR banded factorization as the inner solve,
    fem/sparse.shift_invert_modes — the round-5 replacement after the
    measured LOBPCG failure on clustered modes 5/6: rel err 1.3-3.4 at
    6 modes regardless of backend/precision; see docs/architecture.md).

    gated_by: tests/test_fem_sparse.py::test_shift_invert_modes_*."""
    from eggshell_tpu.fem.helmholtz import solve_modes
    from eggshell_tpu.fem.mesher import mesh_shape
    from eggshell_tpu.fem.shape import Rectangle

    cd = Rectangle(0.0, 0.0, 2.0, 1.0)
    mesh = mesh_shape(cd, 0.012)          # ~16k nodes
    out = {"num_points": mesh.num_points}
    t0 = time.perf_counter()
    vals_a, _ = solve_modes(mesh, num_modes=6)
    dt_a = time.perf_counter() - t0
    out["arpack_host"] = {"ms": dt_a * 1e3,
                          "eigs": [float(v) for v in vals_a]}
    t0 = time.perf_counter()
    vals_l, _ = solve_modes(mesh, num_modes=6, method="shift_invert")
    dt_l = time.perf_counter() - t0
    t0 = time.perf_counter()            # warm: compiles + RCM plan cached
    vals_w, _ = solve_modes(mesh, num_modes=6, method="shift_invert")
    dt_w = time.perf_counter() - t0
    rel = float(np.max(np.abs(
        (np.asarray(vals_l) - np.asarray(vals_a)) / np.asarray(vals_a))))
    out["shift_invert_device"] = {
        "cold_ms": dt_l * 1e3, "warm_ms": dt_w * 1e3,
        "max_rel_eig_err": rel,
    }
    assert rel < 1e-2, "mode parity gate"
    return out


def fdtd():
    """FDTD cell-steps/s on the device (ref toolkit/fdtd.cc).

    gated_by: tests/test_fdtd.py (CPML -52 dB reflection, energy
    conservation, analytic cavity modes)."""
    from eggshell_tpu.fem import fdtd as fd

    out = {}
    steps = 200
    dt = float(fd.courant_dt(1.0, 2))

    def time_2d(n_):
        f = fd.init_2d(n_, n_)

        @jax.jit
        def run(f):
            def body(fld, _):
                return fd.step_2d(fld, dt, 1.0), None
            o, _ = jax.lax.scan(body, f, None, length=steps)
            return o

        t, _ = _time(lambda: run(f), reps=1)
        return t

    for key, n in (("fdtd_2d", 512), ("fdtd_2d_large", 2048)):
        t = time_2d(n)
        out[key] = {"n": n, "steps": steps,
                    "gcells_per_s": n * n * steps / t / 1e9}

    # 3D CPML (the ref CD configuration)
    n3, steps3 = 128, 50
    f3 = fd.init_3d(n3)
    dt3 = float(fd.courant_dt(1.0, 3))
    cpml, psi = fd.make_cpml_3d((n3, n3, n3), dt3, 1.0)

    @jax.jit
    def run3(f, psi):
        def body(c, _):
            fld, p = c
            fld, p = fd.step_3d(fld, dt3, 1.0, cpml=cpml, psi=p)
            return (fld, p), None
        o, _ = jax.lax.scan(body, (f, psi), None, length=steps3)
        return o

    t3, _ = _time(lambda: run3(f3, psi), reps=1)
    cells = n3 ** 3
    out["fdtd_3d_cpml"] = {
        "n": n3, "steps": steps3,
        "gcells_per_s": cells * steps3 / t3 / 1e9,
        # 48 bytes/cell/step traffic model (12 f32 fields read + written)
        "model_gb_per_s": 48 * 4 * cells * steps3 / t3 / 1e9,
    }
    return out
