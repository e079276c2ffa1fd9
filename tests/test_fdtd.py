"""FDTD core tests (toolkit/fdtd analog): cavity resonance vs analytic,
energy conservation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eggshell_tpu.fem import fdtd


def test_cavity_resonance_frequency():
    """PEC square cavity: TM110 resonance at f = c/(sqrt 2 a) * ...;
    in normalised units omega = pi sqrt(2)/a."""
    n = 64
    dx = 1.0 / (n - 1)          # cavity side a = 1
    dt = float(fdtd.courant_dt(dx, 2, 0.5))
    f = fdtd.init_2d(n, n, jnp.float64)
    # initialise with the TM11 mode shape => oscillation at omega_11
    x = np.linspace(0, 1, n)
    ez0 = np.sin(np.pi * x)[:, None] * np.sin(np.pi * x)[None, :]
    f = f._replace(ez=jnp.asarray(ez0))
    steps = 4000
    _, trace = fdtd.simulate_2d(f, steps, dt, dx, probe_ij=(n // 3, n // 4))
    trace = np.asarray(trace)
    freqs = np.fft.rfftfreq(steps, dt)
    spec = np.abs(np.fft.rfft(trace * np.hanning(steps)))
    peak = freqs[np.argmax(spec)]
    want = np.sqrt(2) / 2  # omega/(2 pi) = sqrt(2)/2 for a=c=1
    assert abs(peak - want) / want < 0.02, (peak, want)


def test_energy_conservation_2d():
    n = 48
    dx = 1.0 / (n - 1)
    dt = float(fdtd.courant_dt(dx, 2, 0.7))
    rng = np.random.default_rng(0)
    f = fdtd.init_2d(n, n, jnp.float64)
    ez0 = np.zeros((n, n))
    ez0[10:38, 10:38] = rng.normal(size=(28, 28))
    f = f._replace(ez=jnp.asarray(ez0))
    # half H step offset means energy oscillates slightly; average drift
    # over many steps must be tiny
    f1, _ = fdtd.simulate_2d(f, 5, dt, dx)
    e_start = float(fdtd.energy_2d(f1, dx))
    f2, _ = fdtd.simulate_2d(f1, 2000, dt, dx)
    e_end = float(fdtd.energy_2d(f2, dx))
    assert abs(e_end - e_start) / e_start < 5e-2


def test_pec_mask_blocks_field():
    n = 64
    dx = 1.0 / (n - 1)
    dt = float(fdtd.courant_dt(dx, 2, 0.7))
    pec = np.zeros((n, n), bool)
    pec[:, n // 2] = True           # metal wall across the middle
    pec[n // 4 : n // 2, n // 2] = False  # with an aperture
    f = fdtd.init_2d(n, n, jnp.float64)

    def src(t):
        return jnp.exp(-((t - 20 * dt * 10) ** 2) / (2 * (5 * dt * 10) ** 2))

    fin, _ = fdtd.simulate_2d(
        f, 400, dt, dx, pec=jnp.asarray(pec),
        source_ij=(n // 4, n // 4), source_fn=src,
    )
    ez = np.asarray(fin.ez)
    assert np.abs(ez[:, n // 2][pec[:, n // 2]]).max() == 0.0
    # some field leaked through the aperture
    assert np.abs(ez[:, n // 2 + 2 :]).max() > 1e-8


def test_energy_conservation_3d():
    n = 16
    dx = 1.0 / (n - 1)
    dt = float(fdtd.courant_dt(dx, 3, 0.5))
    rng = np.random.default_rng(2)
    f = fdtd.init_3d(n, jnp.float64)
    ez0 = np.zeros((n, n, n))
    ez0[4:12, 4:12, 4:12] = rng.normal(size=(8, 8, 8))
    f = f._replace(ez=jnp.asarray(ez0))

    def run(f, k):
        for _ in range(k):
            f = fdtd.step_3d(f, dt, dx)
        return f

    f1 = run(f, 5)
    e0 = float(fdtd.energy_3d(f1, dx))
    f2 = run(f1, 300)
    e1 = float(fdtd.energy_3d(f2, dx))
    assert abs(e1 - e0) / e0 < 0.1


def test_cavity_resonance_3d():
    """PEC cube cavity rung by a pulse: the probe spectrum peaks at the
    lowest resonance f_110 = c sqrt(2) / (2 L) (ref fdtd::CD capability:
    3D Yee + PEC walls, toolkit/fdtd.h:106-205)."""
    n = 28
    dx = 1.0 / (n - 1)          # cavity side L = 1 (rim-pinned E)
    dt = float(fdtd.courant_dt(dx, 3, 0.9))
    f = fdtd.init_3d(n, jnp.float32)

    t0, tau = 30 * dt, 8 * dt

    def src(t):
        return jnp.exp(-((t - t0) ** 2) / (2 * tau**2))

    steps = 4096
    _, trace = fdtd.simulate_3d(
        f, steps, dt, dx,
        source_ijk=(n // 2, n // 3, n // 2), source_fn=src,
        probe_ijk=(n // 3, n // 2, n // 2),
    )
    trace = np.asarray(trace)
    freqs = np.fft.rfftfreq(steps, dt)
    spec = np.abs(np.fft.rfft(trace * np.hanning(steps)))
    # ignore DC / sub-resonance leakage
    lo = freqs > 0.3
    peak = freqs[lo][np.argmax(spec[lo])]
    want = np.sqrt(2) / 2       # f_110 of a unit PEC cube, c = 1
    assert abs(peak - want) / want < 0.05, (peak, want)


def test_cpml_absorbs_outgoing_pulse():
    """With CPML walls (ref Roden–Gedney PML, toolkit/fdtd.h:109-116,
    249-256) the propagating field is absorbed: a soft E point source
    leaves a static (curl-free) E remnant behind, so the clean measure
    is the MAGNETIC energy, which must drop to ~nothing vs the
    PEC-walled run that keeps the pulse bouncing (-40 dB gate; measured
    -52 dB)."""
    n = 48
    dx = 1.0 / (n - 1)
    dt = float(fdtd.courant_dt(dx, 3, 0.9))
    t0, tau = 20 * dt, 6 * dt

    def src(t):
        return jnp.exp(-((t - t0) ** 2) / (2 * tau**2))

    steps = 400
    mid = (n // 2, n // 2, n // 2)

    def h_energy(f):
        return sum(float(jnp.sum(a**2)) for a in (f.hx, f.hy, f.hz))

    f0 = fdtd.init_3d(n, jnp.float32)
    pec_walls, _ = fdtd.simulate_3d(
        f0, steps, dt, dx, source_ijk=mid, source_fn=src)

    cpml, psi = fdtd.make_cpml_3d((n, n, n), dt, dx,
                                  pml=fdtd.PML_ALL, depth=10)
    absorbed, _, _ = fdtd.simulate_3d(
        f0, steps, dt, dx, cpml=cpml, psi=psi,
        source_ijk=mid, source_fn=src)
    ratio = h_energy(absorbed) / h_energy(pec_walls)
    assert ratio < 1e-4, ratio


def test_pec_voxels_3d_block_field():
    """A solid PEC slab (ref CD::PECVoxels, toolkit/fdtd.h:203-205)
    shields the far side."""
    n = 32
    dx = 1.0 / (n - 1)
    dt = float(fdtd.courant_dt(dx, 3, 0.9))
    t0, tau = 20 * dt, 6 * dt

    def src(t):
        return jnp.exp(-((t - t0) ** 2) / (2 * tau**2))

    pec = np.zeros((n, n, n), bool)
    pec[2 * n // 3, :, :] = True
    pec[2 * n // 3 + 1, :, :] = True

    steps = 120
    src_ijk = (n // 3, n // 2, n // 2)
    probe = (5 * n // 6, n // 2, n // 2)

    blocked, tr_b = fdtd.simulate_3d(
        f=fdtd.init_3d(n, jnp.float32), num_steps=steps, dt=dt, dx=dx,
        pec=jnp.asarray(pec), source_ijk=src_ijk, source_fn=src,
        probe_ijk=probe)
    open_, tr_o = fdtd.simulate_3d(
        f=fdtd.init_3d(n, jnp.float32), num_steps=steps, dt=dt, dx=dx,
        source_ijk=src_ijk, source_fn=src, probe_ijk=probe)
    assert np.asarray(blocked.ez)[pec].max() == 0.0
    assert np.abs(np.asarray(tr_b)).max() < 1e-3 * np.abs(
        np.asarray(tr_o)).max()


def test_toroid_3d_translation_invariance():
    """Periodic (toroid) symmetry along x (ref TOROID_X,
    toolkit/fdtd.h:118-123): evolving a field shifted by k cells equals
    shifting the evolved field."""
    n = 16
    dx = 1.0 / n
    dt = float(fdtd.courant_dt(dx, 3, 0.9))
    rng = np.random.default_rng(5)
    ez0 = np.zeros((n, n, n))
    ez0[:, 4:12, 4:12] = rng.normal(size=(n, 8, 8))
    f = fdtd.init_3d(n, jnp.float64)._replace(ez=jnp.asarray(ez0))
    f_sh = f._replace(ez=jnp.roll(f.ez, 3, axis=0))

    def run(f):
        for _ in range(40):
            f = fdtd.step_3d(f, dt, dx, periodic=fdtd.TOROID_X)
        return f

    a = run(f)
    b = run(f_sh)
    np.testing.assert_allclose(
        np.asarray(jnp.roll(a.ez, 3, axis=0)), np.asarray(b.ez),
        atol=1e-12)


def test_efield_change_metric():
    """CD::EFieldChange analog (toolkit/fdtd.h:207-212)."""
    n = 12
    dx = 1.0 / (n - 1)
    dt = float(fdtd.courant_dt(dx, 3, 0.9))
    rng = np.random.default_rng(7)
    ez0 = np.zeros((n, n, n))
    ez0[3:9, 3:9, 3:9] = rng.normal(size=(6, 6, 6))
    f = fdtd.init_3d(n, jnp.float64)._replace(ez=jnp.asarray(ez0))
    assert float(fdtd.efield_change(f, f)) == 0.0
    f2 = fdtd.step_3d(f, dt, dx)
    ch = float(fdtd.efield_change(f2, f))
    assert ch > 0.0
    # as the field converges (tiny step), the change metric shrinks
    f3 = fdtd.step_3d(f, dt * 1e-6, dx)
    assert float(fdtd.efield_change(f3, f)) < 1e-3 * ch


def test_export_fields_3d(tmp_path):
    from eggshell_tpu.utils.mat_file import load_mat

    f = fdtd.init_3d(8, jnp.float32)
    f = f._replace(ez=f.ez.at[4, 4, 4].set(2.0))
    path = str(tmp_path / "fields.mat")
    fdtd.export_fields_3d(path, f, 0.25)
    back = load_mat(path)
    assert back["Ez"][4, 4, 4] == 2.0
    assert np.asarray(back["dx"]).reshape(-1)[0].item() == 0.25
