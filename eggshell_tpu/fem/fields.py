"""Field probing and derived quantities — the rama on-demand solution
tier (`_GetField`, `Mesh::FindTriangle`, spatial gradient,
`_GetFieldPoynting`, mode cutoff frequencies, wideband sweeps, matlab
export; ref rama/solver.h:185-243, rama/mesh.h:21-80,
rama/cavity_qt.cc:70-96).

The probe path is host-side NumPy (it serves plotting / test
assertions); the multi-frequency sweep is a single `vmap`-ed complex
solve on device — the batched replacement for the reference's
thread-per-frequency `Solvers::Solve` (rama/solver.h:351-355).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from eggshell_tpu.fem.mesher import Mesh


# ---------------------------------------------------------------------------
# Spatial index / point location (ref Mesh::FindTriangle, rama/mesh.h:21-80)


class TriangleIndex:
    """Uniform-grid spatial index over mesh triangles.  Build once,
    query many — the reference builds an analogous index for its
    dielectric callbacks and field probes."""

    def __init__(self, mesh: Mesh, cells_per_axis: Optional[int] = None):
        self.mesh = mesh
        pts = mesh.points
        tri = mesh.triangles
        self.tri_pts = pts[tri]                      # (T, 3, 2)
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        pad = 1e-9 + 1e-6 * np.max(hi - lo)
        self.lo = lo - pad
        self.hi = hi + pad
        n = cells_per_axis or max(4, int(np.sqrt(len(tri))))
        self.n = n
        self.cell = (self.hi - self.lo) / n
        # bucket triangles by the cells their bbox overlaps
        tmin = self.tri_pts.min(axis=1)
        tmax = self.tri_pts.max(axis=1)
        cmin = np.clip(((tmin - self.lo) / self.cell).astype(int), 0, n - 1)
        cmax = np.clip(((tmax - self.lo) / self.cell).astype(int), 0, n - 1)
        buckets: Dict[Tuple[int, int], list] = {}
        for t in range(len(tri)):
            for i in range(cmin[t, 0], cmax[t, 0] + 1):
                for j in range(cmin[t, 1], cmax[t, 1] + 1):
                    buckets.setdefault((i, j), []).append(t)
        self.buckets = {k: np.asarray(v) for k, v in buckets.items()}

    def _bary(self, t: int, p: np.ndarray) -> np.ndarray:
        a, b, c = self.tri_pts[t]
        m = np.stack([b - a, c - a], axis=1)
        try:
            uv = np.linalg.solve(m, p - a)
        except np.linalg.LinAlgError:
            return np.array([-1.0, -1.0, -1.0])
        return np.array([1.0 - uv[0] - uv[1], uv[0], uv[1]])

    def find(self, p, tol: float = 1e-9) -> Tuple[int, np.ndarray]:
        """Triangle containing point p and its barycentric coordinates;
        (-1, zeros) if outside the mesh."""
        p = np.asarray(p, float)
        ij = np.clip(((p - self.lo) / self.cell).astype(int), 0, self.n - 1)
        cand = self.buckets.get((int(ij[0]), int(ij[1])))
        best_t, best_lam, best_min = -1, np.zeros(3), -np.inf
        if cand is not None:
            for t in cand:
                lam = self._bary(int(t), p)
                m = lam.min()
                if m >= -tol:
                    return int(t), lam
                if m > best_min:
                    best_min, best_t, best_lam = m, int(t), lam
        # nearly-on-an-edge fallback for points within one cell of the hull
        if best_t >= 0 and best_min > -1e-3:
            return best_t, np.clip(best_lam, 0, None) / max(
                np.clip(best_lam, 0, None).sum(), 1e-300
            )
        return -1, np.zeros(3)


def get_field(mesh: Mesh, field, points, index: Optional[TriangleIndex] = None):
    """P1-interpolated field values at arbitrary points (ref `_GetField`,
    rama/cavity_qt.cc:70-96).  Points outside the mesh give NaN."""
    idx = index or TriangleIndex(mesh)
    f = np.asarray(field)
    pts = np.atleast_2d(np.asarray(points, float))
    out = np.full(len(pts), np.nan, dtype=f.dtype if np.iscomplexobj(f) else float)
    if np.iscomplexobj(f):
        out = out.astype(complex)
    for i, p in enumerate(pts):
        t, lam = idx.find(p)
        if t >= 0:
            out[i] = np.sum(f[mesh.triangles[t]] * lam)
    return out


# ---------------------------------------------------------------------------
# Gradients and Poynting flux


def triangle_gradients(mesh: Mesh, field) -> np.ndarray:
    """Per-triangle (constant) P1 gradient of the nodal field
    (ref spatial-gradient accessor, rama/solver.h:272-277)."""
    pts = mesh.points
    tri = mesh.triangles
    f = np.asarray(field)
    p0, p1, p2 = pts[tri[:, 0]], pts[tri[:, 1]], pts[tri[:, 2]]
    area2 = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (
        p1[:, 1] - p0[:, 1]
    ) * (p2[:, 0] - p0[:, 0])
    b = np.stack(
        [p1[:, 1] - p2[:, 1], p2[:, 1] - p0[:, 1], p0[:, 1] - p1[:, 1]], axis=1
    )
    c = np.stack(
        [p2[:, 0] - p1[:, 0], p0[:, 0] - p2[:, 0], p1[:, 0] - p0[:, 0]], axis=1
    )
    ft = f[tri]
    gx = np.sum(ft * b, axis=1) / area2
    gy = np.sum(ft * c, axis=1) / area2
    return np.stack([gx, gy], axis=1)


def get_field_gradient(
    mesh: Mesh, field, points, index: Optional[TriangleIndex] = None
):
    """Field gradient at arbitrary points (piecewise constant per triangle)."""
    idx = index or TriangleIndex(mesh)
    grads = triangle_gradients(mesh, field)
    pts = np.atleast_2d(np.asarray(points, float))
    out = np.full((len(pts), 2), np.nan, dtype=grads.dtype)
    for i, p in enumerate(pts):
        t, _ = idx.find(p)
        if t >= 0:
            out[i] = grads[t]
    return out


def poynting(mesh: Mesh, field, k0: float) -> np.ndarray:
    """Time-averaged in-plane Poynting flux per triangle for a TM (Ez)
    field, up to a constant impedance factor:  S = Im(u grad u*) / k0
    (ref `_GetFieldPoynting`, rama/cavity_qt.cc:70-96).  Returns (T, 2).

    Sign follows the solver's engineering exp(+j w t) convention
    (outgoing port Robin terms are +j beta, helmholtz.solve_driven):
    a +x-travelling wave is u = exp(-j k x) and gives S = +x-hat."""
    f = np.asarray(field)
    g = triangle_gradients(mesh, f)
    tri = mesh.triangles
    u_mid = f[tri].mean(axis=1)
    return np.imag(u_mid[:, None] * np.conj(g)) / k0


# ---------------------------------------------------------------------------
# Mode cutoff frequencies (ref ComputeModeCutoffFrequencies,
# rama/solver.h:240-243)


def mode_cutoff_frequencies(eigenvalues, unit: float = 1.0) -> np.ndarray:
    """Convert generalized eigenvalues lambda = k_c^2 (in mesh units) to
    cutoff frequencies in Hz: f_c = c k_c / (2 pi unit)."""
    c = 299792458.0
    lam = np.maximum(np.asarray(eigenvalues, float), 0.0)
    return c * np.sqrt(lam) / (2 * np.pi * unit)


# ---------------------------------------------------------------------------
# Wideband sweep — the Solvers tier (ref rama/solver.h:315-366), vmapped


def solve_sweep(mesh: Mesh, config, frequencies: Sequence[float],
                num_modes: int = 1):
    """Driven solves at many frequencies in ONE batched device solve.

    The reference runs one thread per frequency (rama/solver.h:351-355);
    here the frequencies ride a `vmap` batch dimension through the
    shared plan/core (helmholtz.make_driven_fn) — dense systems batch on
    the device; large sparse systems factor per-frequency on the host.

    Ports with numerical (dielectric-loaded) mode profiles are frozen at
    the plan frequency and re-planned per frequency instead (matching
    the reference, which solves the waveguide-mode problem per Solver).

    Returns (fields (F, N) complex, s_params {port: (F,) complex}).
    """
    import dataclasses as _dc

    from eggshell_tpu.fem.helmholtz import _cdtype, make_driven_fn

    c = 299792458.0
    fn, plan = make_driven_fn(mesh, config, num_modes=num_modes)
    dtype = _cdtype()
    args = (
        jnp.asarray(mesh.points),
        jnp.asarray(mesh.epsilon, dtype),
        jnp.asarray(mesh.sigma_xx),
        jnp.asarray(mesh.sigma_yy),
        jnp.asarray(mesh.sigma_xy),
        jnp.asarray(mesh.excitation, dtype),
    )

    if all(pp.analytic for pp in plan.ports):
        k0s = jnp.asarray(
            [2 * np.pi * f / c * config.unit for f in frequencies]
        )
        fields, s = jax.jit(
            jax.vmap(lambda k0: fn(*args, k0))
        )(k0s)
        fields = np.asarray(fields)
        s = np.asarray(s)
    else:
        fields = []
        s = []
        for f in frequencies:
            cfg_f = _dc.replace(config, frequency=float(f))
            fn_f, _ = make_driven_fn(mesh, cfg_f, num_modes=num_modes)
            u, sf = jax.jit(fn_f)(*args, jnp.asarray(cfg_f.k0))
            fields.append(np.asarray(u))
            s.append(np.asarray(sf))
        fields = np.stack(fields)
        s = np.stack(s)

    s_params = {
        pp.number: s[:, i, 0] for i, pp in enumerate(plan.ports)
    }
    return fields, s_params


# ---------------------------------------------------------------------------
# Matlab export (ref matlab export of mesh+solution, rama/solver.h:228-231)


def export_solution(path: str, mesh: Mesh, field=None, **extra) -> None:
    """Write mesh (+ optional nodal field and extras) as a MATLAB v7
    .mat file via the toolkit MatFile equivalent."""
    from eggshell_tpu.utils.mat_file import MatFile

    with MatFile(path) as mf:
        mf.write("p", mesh.points.T)                       # 2 x N, matlab style
        mf.write("t", (mesh.triangles + 1).T)              # 3 x T, 1-based
        mf.write("boundary_edges", (mesh.boundary_edges + 1).T)
        mf.write("edge_kind", mesh.edge_kind)
        mf.write("edge_port", mesh.edge_port)
        mf.write("epsilon", mesh.epsilon)
        if field is not None:
            mf.write("field", np.asarray(field))
        for k, v in extra.items():
            mf.write(k, np.asarray(v))


def wideband_pulse(fields, frequencies, times, spectrum=None):
    """Combine per-frequency solutions into time-domain field frames —
    the Solvers wideband field combination (ref rama/solver.h:315-366).

    fields (F, N) complex phasors (engineering exp(+j w t) convention),
    frequencies (F,) Hz, times (T,) seconds; `spectrum` (F,) optional
    weights (default: Hann window over the band, a smooth pulse).
    Returns real frames (T, N): u(t) = Re sum_f s_f field_f exp(j w_f t).
    """
    fields = np.asarray(fields)
    f = np.asarray(frequencies, float)
    t = np.asarray(times, float)
    if spectrum is None:
        x = np.linspace(0, np.pi, len(f))
        spectrum = np.sin(x) ** 2 if len(f) > 1 else np.ones(1)
    s = np.asarray(spectrum, complex)
    phase = np.exp(2j * np.pi * f[None, :] * t[:, None])     # (T, F)
    return np.real(np.einsum("tf,f,fn->tn", phase, s, fields))
