"""FDTD computational core — toolkit/fdtd.{h,cc} equivalent.

2D TMz Yee scheme (Ez, Hx, Hy) and a minimal 3D Yee scheme, in
normalised units (c = eps0 = mu0 = 1).  PEC voxel masks (ref fdtd
`PEC` masks) zero the tangential E field.  `step_2d` is the plain jnp
stencil update, which XLA fuses into a few kernels.

`simulate_2d` scans the update over time with optional soft source and
probe recording.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp


class Field2D(NamedTuple):
    ez: jax.Array   # (nx, ny)
    hx: jax.Array   # (nx, ny-1)
    hy: jax.Array   # (nx-1, ny)


def init_2d(nx: int, ny: int, dtype=jnp.float32) -> Field2D:
    return Field2D(
        ez=jnp.zeros((nx, ny), dtype),
        hx=jnp.zeros((nx, ny - 1), dtype),
        hy=jnp.zeros((nx - 1, ny), dtype),
    )


def courant_dt(dx: float, dims: int = 2, safety: float = 0.99) -> float:
    return safety * dx / jnp.sqrt(jnp.asarray(float(dims)))


def step_2d(
    f: Field2D,
    dt: float,
    dx: float,
    eps_r: Optional[jax.Array] = None,   # (nx, ny)
    pec: Optional[jax.Array] = None,     # (nx, ny) bool, True = metal
) -> Field2D:
    """One leapfrog step: H half-update then E update (ref fdtd kernels)."""
    c = dt / dx
    hx = f.hx - c * (f.ez[:, 1:] - f.ez[:, :-1])
    hy = f.hy + c * (f.ez[1:, :] - f.ez[:-1, :])

    curl = jnp.zeros_like(f.ez)
    curl = curl.at[1:-1, :].add(hy[1:, :] - hy[:-1, :])
    curl = curl.at[:, 1:-1].add(-(hx[:, 1:] - hx[:, :-1]))
    inv_eps = 1.0 if eps_r is None else 1.0 / eps_r
    ez = f.ez + c * inv_eps * curl
    if pec is not None:
        ez = jnp.where(pec, 0.0, ez)
    # outer boundary is PEC by construction (E on the rim never updated
    # by a full curl; pin it to zero)
    ez = ez.at[0, :].set(0.0).at[-1, :].set(0.0)
    ez = ez.at[:, 0].set(0.0).at[:, -1].set(0.0)
    return Field2D(ez=ez, hx=hx, hy=hy)


def energy_2d(f: Field2D, dx: float) -> jax.Array:
    """Discrete EM energy 0.5 int (E^2 + H^2)."""
    return 0.5 * dx * dx * (
        jnp.sum(f.ez**2) + jnp.sum(f.hx**2) + jnp.sum(f.hy**2)
    )


@functools.partial(
    jax.jit,
    static_argnames=("num_steps", "source_ij", "source_fn", "probe_ij"),
)
def simulate_2d(
    f: Field2D,
    num_steps: int,
    dt: float,
    dx: float,
    eps_r: Optional[jax.Array] = None,
    pec: Optional[jax.Array] = None,
    source_ij: Optional[Tuple[int, int]] = None,
    source_fn=None,
    probe_ij: Optional[Tuple[int, int]] = None,
):
    """Scan the update over time.  Returns (final field, probe trace)."""

    def body(carry, t):
        fld = carry
        fld = step_2d(fld, dt, dx, eps_r, pec)
        if source_ij is not None and source_fn is not None:
            fld = fld._replace(
                ez=fld.ez.at[source_ij].add(source_fn(t * dt))
            )
        out = fld.ez[probe_ij] if probe_ij is not None else jnp.float32(0)
        return fld, out

    return jax.lax.scan(body, f, jnp.arange(num_steps))


# ---------------------------------------------------------------------------
# 3D Yee computational domain — the ref fdtd::CD capability surface
# (toolkit/fdtd.h:106-260): per-wall CPML absorbing boundaries
# (Roden–Gedney filter arrays + Psi convolution state), PEC voxel
# masks, toroidal (periodic) symmetry per axis, material eps grid,
# Courant step, E-field-change convergence metric.


class Field3D(NamedTuple):
    ex: jax.Array
    ey: jax.Array
    ez: jax.Array
    hx: jax.Array
    hy: jax.Array
    hz: jax.Array


def init_3d(n: int, dtype=jnp.float32) -> Field3D:
    z = lambda: jnp.zeros((n, n, n), dtype)
    return Field3D(z(), z(), z(), z(), z(), z())


# Per-wall PML selection bits, mirroring ref fdtd::CD::PML_* and
# TOROID_* (toolkit/fdtd.h:109-123).
PML_XMIN, PML_XMAX = 1, 2
PML_YMIN, PML_YMAX = 4, 8
PML_ZMIN, PML_ZMAX = 16, 32
PML_ALL = 63
TOROID_X, TOROID_Y, TOROID_Z = 1, 2, 4


class Psi3D(NamedTuple):
    """CPML convolution state: one recursive accumulator per (field
    component, transverse derivative axis) pair — the ref Psi array
    (toolkit/fdtd.h:241-247), stored full-grid for XLA-static shapes."""
    hx_y: jax.Array
    hx_z: jax.Array
    hy_z: jax.Array
    hy_x: jax.Array
    hz_x: jax.Array
    hz_y: jax.Array
    ex_y: jax.Array
    ex_z: jax.Array
    ey_z: jax.Array
    ey_x: jax.Array
    ez_x: jax.Array
    ez_y: jax.Array


class CPML3D(NamedTuple):
    """Cached per-axis 'a'/'b' filter constants (ref SetupAB,
    toolkit/fdtd.h:249-256 and the Roden–Gedney CPML recursion
    psi <- b psi + a dF; the update uses dF + psi in place of dF).
    aE/bE sample sigma at cell edges (ofs 0), aH/bH at centers
    (ofs 0.5); entries are 0/1 outside the PML so non-PML cells see
    the plain Yee update."""
    a_e: Tuple[jax.Array, jax.Array, jax.Array]   # per axis, shape (n,)
    b_e: Tuple[jax.Array, jax.Array, jax.Array]
    a_h: Tuple[jax.Array, jax.Array, jax.Array]
    b_h: Tuple[jax.Array, jax.Array, jax.Array]


def _setup_ab(n, dt, dx, depth, lo_on, hi_on, ofs, m=3, dtype=jnp.float32):
    """Polynomial-graded conductivity sigma(u) = sigma_max u^m with
    sigma_max = 0.8 (m+1)/dx (the standard CPML optimum at c=1), then
    b = exp(-sigma dt), a = b - 1 (kappa=1, alpha=0 limit of
    Roden–Gedney eq. 8/13 — ref toolkit/fdtd.h:249-256)."""
    import numpy as np

    x = np.arange(n, dtype=np.float64) + ofs
    u = np.zeros((n,), np.float64)
    if lo_on and depth > 0:
        u = np.maximum(u, (depth - x) / depth)
    if hi_on and depth > 0:
        u = np.maximum(u, (x - (n - 1 - depth)) / depth)
    u = np.clip(u, 0.0, 1.0)
    sigma_max = 0.8 * (m + 1) / dx
    sigma = sigma_max * u**m
    b = np.exp(-sigma * dt)
    a = b - 1.0
    return jnp.asarray(a, dtype), jnp.asarray(b, dtype)


def make_cpml_3d(
    shape: Tuple[int, int, int], dt: float, dx: float,
    pml: int = PML_ALL, depth: int = 8, dtype=jnp.float32,
) -> Tuple[CPML3D, Psi3D]:
    """Build the filter-constant cache and zeroed Psi state for a
    computational domain of `shape` Yee cells (ref CD ctor,
    toolkit/fdtd.h:126-131)."""
    bits = ((PML_XMIN, PML_XMAX), (PML_YMIN, PML_YMAX),
            (PML_ZMIN, PML_ZMAX))
    a_e, b_e, a_h, b_h = [], [], [], []
    for ax in range(3):
        lo, hi = (pml & bits[ax][0]) != 0, (pml & bits[ax][1]) != 0
        ae, be = _setup_ab(shape[ax], dt, dx, depth, lo, hi, 0.0,
                           dtype=dtype)
        ah, bh = _setup_ab(shape[ax], dt, dx, depth, lo, hi, 0.5,
                           dtype=dtype)
        a_e.append(ae)
        b_e.append(be)
        a_h.append(ah)
        b_h.append(bh)
    z = lambda: jnp.zeros(shape, dtype)
    psi = Psi3D(*[z() for _ in range(12)])
    return (
        CPML3D(tuple(a_e), tuple(b_e), tuple(a_h), tuple(b_h)),
        psi,
    )


def _bcast(v: jax.Array, axis: int) -> jax.Array:
    """Broadcast a per-axis (n,) filter array over a 3D grid."""
    shape = [1, 1, 1]
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def step_3d(
    f: Field3D,
    dt: float,
    dx: float,
    eps_r: Optional[jax.Array] = None,     # (n,n,n) relative permittivity
    pec: Optional[jax.Array] = None,       # (n,n,n) bool, True = metal
    cpml: Optional[CPML3D] = None,
    psi: Optional[Psi3D] = None,
    periodic: int = 0,                     # TOROID_* bits
):
    """One 3D Yee leapfrog step (H half-update then E update) on
    collocated padded grids with roll-based differences.

    - `pec` zeroes E inside masked voxels (ref CD::PECVoxels,
      toolkit/fdtd.h:203-205); non-periodic outer walls are PEC.
    - `periodic` axes wrap (rolls are periodic already; the wall pin is
      skipped) — ref toroid symmetry (toolkit/fdtd.h:118-123).
    - With `cpml`/`psi`, each transverse derivative dF is replaced by
      dF + psi with psi <- b psi + a dF (Roden–Gedney recursion) —
      returns (field, psi'); otherwise returns the field alone.
    """
    c = dt / dx
    use_pml = cpml is not None

    def d(a, axis):
        return jnp.roll(a, -1, axis) - a

    def db(a, axis):
        return a - jnp.roll(a, 1, axis)

    def conv_h(dF, axis, p):
        pn = _bcast(cpml.b_h[axis], axis) * p + \
            _bcast(cpml.a_h[axis], axis) * dF
        return dF + pn, pn

    def conv_e(dF, axis, p):
        pn = _bcast(cpml.b_e[axis], axis) * p + \
            _bcast(cpml.a_e[axis], axis) * dF
        return dF + pn, pn

    if use_pml:
        dzy, p_hx_y = conv_h(d(f.ez, 1), 1, psi.hx_y)
        dyz, p_hx_z = conv_h(d(f.ey, 2), 2, psi.hx_z)
        dxz, p_hy_z = conv_h(d(f.ex, 2), 2, psi.hy_z)
        dzx, p_hy_x = conv_h(d(f.ez, 0), 0, psi.hy_x)
        dyx, p_hz_x = conv_h(d(f.ey, 0), 0, psi.hz_x)
        dxy, p_hz_y = conv_h(d(f.ex, 1), 1, psi.hz_y)
    else:
        dzy, dyz = d(f.ez, 1), d(f.ey, 2)
        dxz, dzx = d(f.ex, 2), d(f.ez, 0)
        dyx, dxy = d(f.ey, 0), d(f.ex, 1)

    hx = f.hx - c * (dzy - dyz)
    hy = f.hy - c * (dxz - dzx)
    hz = f.hz - c * (dyx - dxy)

    if use_pml:
        bzy, p_ex_y = conv_e(db(hz, 1), 1, psi.ex_y)
        byz, p_ex_z = conv_e(db(hy, 2), 2, psi.ex_z)
        bxz, p_ey_z = conv_e(db(hx, 2), 2, psi.ey_z)
        bzx, p_ey_x = conv_e(db(hz, 0), 0, psi.ey_x)
        byx, p_ez_x = conv_e(db(hy, 0), 0, psi.ez_x)
        bxy, p_ez_y = conv_e(db(hx, 1), 1, psi.ez_y)
    else:
        bzy, byz = db(hz, 1), db(hy, 2)
        bxz, bzx = db(hx, 2), db(hz, 0)
        byx, bxy = db(hy, 0), db(hx, 1)

    inv_eps = 1.0 if eps_r is None else 1.0 / eps_r
    ex = f.ex + c * inv_eps * (bzy - byz)
    ey = f.ey + c * inv_eps * (bxz - bzx)
    ez = f.ez + c * inv_eps * (byx - bxy)

    def pin(a):
        for ax in range(3):
            if periodic & (1 << ax):
                continue
            a = jnp.moveaxis(a, ax, 0).at[0].set(0.0)
            a = a.at[-1].set(0.0)
            a = jnp.moveaxis(a, 0, ax)
        return a

    ex, ey, ez = pin(ex), pin(ey), pin(ez)
    if pec is not None:
        ex = jnp.where(pec, 0.0, ex)
        ey = jnp.where(pec, 0.0, ey)
        ez = jnp.where(pec, 0.0, ez)

    out = Field3D(ex, ey, ez, hx, hy, hz)
    if use_pml:
        return out, Psi3D(
            p_hx_y, p_hx_z, p_hy_z, p_hy_x, p_hz_x, p_hz_y,
            p_ex_y, p_ex_z, p_ey_z, p_ey_x, p_ez_x, p_ez_y,
        )
    return out


@functools.partial(
    jax.jit,
    static_argnames=("num_steps", "source_ijk", "source_component",
                     "source_fn", "probe_ijk", "periodic",
                     "probe_component"),
)
def simulate_3d(
    f: Field3D,
    num_steps: int,
    dt: float,
    dx: float,
    eps_r: Optional[jax.Array] = None,
    pec: Optional[jax.Array] = None,
    cpml: Optional[CPML3D] = None,
    psi: Optional[Psi3D] = None,
    source_ijk: Optional[Tuple[int, int, int]] = None,
    source_component: str = "ez",
    source_fn=None,
    probe_ijk: Optional[Tuple[int, int, int]] = None,
    periodic: int = 0,
    probe_component: Optional[str] = None,
):
    """Scan the 3D update over time with optional soft source and probe
    (the excitation/measurement layer the ref leaves to callers,
    toolkit/fdtd.h:14-16).  Returns (final field [, final psi], probe
    trace of `probe_component` — defaulting to `source_component`, so one
    can drive e.g. hy while probing ez)."""
    if probe_component is None:
        probe_component = source_component
    use_pml = cpml is not None

    def body(carry, t):
        fld, p = carry
        if use_pml:
            fld, p = step_3d(fld, dt, dx, eps_r, pec, cpml, p, periodic)
        else:
            fld = step_3d(fld, dt, dx, eps_r, pec, periodic=periodic)
        if source_ijk is not None and source_fn is not None:
            comp = getattr(fld, source_component)
            fld = fld._replace(**{
                source_component: comp.at[source_ijk].add(
                    source_fn(t * dt)
                )
            })
        out = (
            getattr(fld, probe_component)[probe_ijk]
            if probe_ijk is not None else jnp.float32(0)
        )
        return (fld, p), out

    (fld, p), trace = jax.lax.scan(
        body, (f, psi), jnp.arange(num_steps)
    )
    if use_pml:
        return fld, p, trace
    return fld, trace


def energy_3d(f: Field3D, dx: float) -> jax.Array:
    return 0.5 * dx**3 * sum(jnp.sum(a**2) for a in f)


def efield_change(f: Field3D, snapshot: Field3D) -> jax.Array:
    """Fractional RMS E-field change vs a snapshot — the ref's
    convergence check (CD::EFieldChange, toolkit/fdtd.h:207-212):
    sqrt(sum((E - E_snap)^2)) / sqrt(sum(E^2))."""
    num = (
        jnp.sum((f.ex - snapshot.ex) ** 2)
        + jnp.sum((f.ey - snapshot.ey) ** 2)
        + jnp.sum((f.ez - snapshot.ez) ** 2)
    )
    den = jnp.sum(f.ex**2) + jnp.sum(f.ey**2) + jnp.sum(f.ez**2)
    return jnp.sqrt(num) / jnp.maximum(jnp.sqrt(den), 1e-30)


def export_fields_3d(path: str, f: Field3D, dx: float) -> None:
    """Write the E/H fields to a MATLAB file (ref CD::GetEMatlab +
    mat_file export, toolkit/fdtd.h:176-179)."""
    from eggshell_tpu.utils.mat_file import MatFile

    with MatFile(path) as m:
        for name in ("ex", "ey", "ez", "hx", "hy", "hz"):
            m.write(name.capitalize(), getattr(f, name))
        m.write_scalar("dx", dx)
