"""P1 FEM Helmholtz solver — the rama solver tier (rama/solver.cc,
toolkit/femsolver.h) rebuilt JAX-native.

Problem types (ScriptConfig analog, ref rama/solver.h:42-126):
  EZ     TM polarisation: (grad^2 + k^2 eps) Ez = 0, PEC walls are
         Dirichlet Ez = 0.
  EXY    TE polarisation: scalar Hz with natural (Neumann) walls; a
         finite out-of-plane `depth` subtracts (pi/depth)^2 from the
         effective k^2 (ref Solver::ComputeKSquared,
         rama/solver.cc:1553-1576).
  ES     electrostatics: Laplace with painted Dirichlet boundaries.
  SCHRODINGER  -grad^2 psi + V psi = E psi eigenproblem.

Boundary conditions on painted segments (ref rama/edge_type.h and the
Robin assembly in rama/solver.cc:142-208):
  port   matched waveguide port: Robin term j*beta1*u where beta1 is the
         FUNDAMENTAL mode's propagation constant computed from the local
         (possibly complex) permittivity; excitation 2j*beta_m*psi_m on
         the excited port/mode.  With num_modes > 1 a DtN correction
         matches modes 2..M as well (beyond the reference, which applies
         the single alpha = i*beta0 to all content).  Mode profiles are
         analytic sin/cos for homogeneous ports and numerical 1D
         eigenmodes for dielectric-loaded ports (the
         WaveguideModeFEMProblem analog, rama/solver.cc:251).
  abc    first-order absorbing: Robin term j*k_local*u
         (ref solver.cc:200-202 uses the local sqrt(k^2)).
  robin  custom complex Robin coefficient alpha (dimensionless, times
         the local k — the reference's port-callback convention,
         rama/solver.cc:155-158); used by the good-conductor wall model
         (fem/metal.py, ref user_script_util.lua PortMetal).
  (default) PEC: Dirichlet (EZ/ES) or natural (EXY).

Architecture: `plan_driven` extracts the static problem STRUCTURE from
the mesh on the host (COO sparsity, port node chains + mode profiles,
Dirichlet masks); `solve_driven_core` is a pure jnp function of
(points, materials, k0) that assembles triplet VALUES, solves, and
projects S-parameters — fully jit-able and differentiable end-to-end
(the analog of the reference's jets threaded through assembly+solve,
rama/my_jet.h, solver.h:272-277).  Small systems densify and solve on
the device; large systems use the host-factorized `fem.sparse.sparse_solve`
(SimplicialLLT/SparseLU analog, toolkit/femsolver.h:134-135) wrapped in
`lax.custom_linear_solve` so AD still works.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from eggshell_tpu.fem import ports as portlib
from eggshell_tpu.fem import sparse as sparselib
from eggshell_tpu.fem.mesher import Mesh


def _cdtype():
    return jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64


@dataclasses.dataclass(frozen=True)
class FemConfig:
    """ScriptConfig analog (ref rama/solver.h:42-126; Lua `config` table,
    rama/tests/test_s11.lua:11-33)."""

    type: str = "EZ"                   # EZ | EXY | ES | SCHRODINGER
    frequency: float = 10e9            # Hz (EZ/EXY)
    excited_port: int = 1
    excited_mode: int = 1              # 1-based mode index on the port
    unit: float = 1.0                  # geometry unit in meters
    depth: float = np.inf              # out-of-plane depth, geometry units
                                       # (EXY effective-k term; inf = 2D)

    @property
    def k0(self) -> float:
        c = 299792458.0
        return 2 * np.pi * self.frequency / c * self.unit

    def k2_eff(self, k0=None):
        """Effective k^2 in geometry units: EXY with finite depth loses
        (pi/depth)^2 (ref ComputeKSquared, rama/solver.cc:1561-1566)."""
        k0 = self.k0 if k0 is None else k0
        if self.type == "EXY" and np.isfinite(self.depth):
            return k0 * k0 - (np.pi / self.depth) ** 2
        return k0 * k0


# ---------------------------------------------------------------------------
# Element assembly (jnp, differentiable in the vertex positions)


def _tri_geometry(pts, tri):
    p0 = pts[tri[:, 0]]
    p1 = pts[tri[:, 1]]
    p2 = pts[tri[:, 2]]
    d1 = p1 - p0
    d2 = p2 - p0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    area = 0.5 * jnp.abs(det)
    b = jnp.stack([p1[:, 1] - p2[:, 1], p2[:, 1] - p0[:, 1],
                   p0[:, 1] - p1[:, 1]], 1)
    c = jnp.stack([p2[:, 0] - p1[:, 0], p0[:, 0] - p2[:, 0],
                   p1[:, 0] - p0[:, 0]], 1)
    return area, b, c


def element_matrices(pts, tri, eps_tri, sigma_xx=None, sigma_yy=None,
                     sigma_xy=None):
    """Per-element stiffness Ke (with anisotropic weights incl. the
    sigma_xy cross term, ref rama/shape.h:64-90) and eps-weighted mass
    Me for P1 triangles: (T, 3, 3) each.  All jnp ops.
    (ref toolkit/femsolver.h per-triangle assembly :255-310.)"""
    area, b, c = _tri_geometry(pts, tri)
    sx = jnp.ones_like(area) if sigma_xx is None else sigma_xx
    sy = jnp.ones_like(area) if sigma_yy is None else sigma_yy
    Ke = (
        sx[:, None, None] * b[:, :, None] * b[:, None, :]
        + sy[:, None, None] * c[:, :, None] * c[:, None, :]
    ) / (4.0 * area)[:, None, None]
    if sigma_xy is not None:
        Ke = Ke + sigma_xy[:, None, None] * (
            b[:, :, None] * c[:, None, :] + c[:, :, None] * b[:, None, :]
        ) / (4.0 * area)[:, None, None]
    Me = (
        (jnp.ones((3, 3)) + jnp.eye(3))[None, :, :]
        * (area / 12.0)[:, None, None]
        * eps_tri[:, None, None]
    )
    return Ke, Me


def vol_structure(triangles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """COO (rows, cols) of the 9 entries per triangle, matching
    element_matrices' (T, 3, 3) flattening."""
    tri = np.asarray(triangles)
    rows = np.repeat(tri, 3, axis=1).reshape(-1)
    cols = np.tile(tri, (1, 3)).reshape(-1)
    return rows, cols


def edge_structure(edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """COO (rows, cols) of the 4 entries per boundary edge, matching
    edge_mass_vals' (E, 2, 2) flattening."""
    e = np.asarray(edges).reshape(-1, 2)
    rows = np.repeat(e, 2, axis=1).reshape(-1)
    cols = np.tile(e, (1, 2)).reshape(-1)
    return rows, cols


def edge_mass_vals(pts, edges, scale=None):
    """P1 line-element mass values per edge: len/6 * [[2,1],[1,2]],
    optionally scaled per edge; (E, 2, 2) traced."""
    e = jnp.asarray(np.asarray(edges).reshape(-1, 2))
    L = jnp.linalg.norm(pts[e[:, 1]] - pts[e[:, 0]], axis=1)
    base = jnp.asarray([[2.0, 1.0], [1.0, 2.0]])
    vals = base[None, :, :] * (L / 6.0)[:, None, None]
    if scale is not None:
        vals = vals * scale[:, None, None]
    return vals


def assemble_matrices(points, triangles, eps_tri, sigma_xx=None,
                      sigma_yy=None, sigma_xy=None):
    """Dense global stiffness K and eps-weighted mass M — retained
    convenience API over the element/COO path (small meshes, tests)."""
    Ke, Me = element_matrices(points, triangles, eps_tri, sigma_xx,
                              sigma_yy, sigma_xy)
    rows, cols = vol_structure(np.asarray(triangles))
    N = points.shape[0]
    K = sparselib.coo_to_dense(
        jnp.asarray(rows), jnp.asarray(cols), Ke.reshape(-1), N
    )
    M = sparselib.coo_to_dense(
        jnp.asarray(rows), jnp.asarray(cols), Me.reshape(-1), N
    )
    return K, M


def _boundary_mass(points, edges, N, dtype=None):
    """Dense boundary-mass matrix over the given edges (legacy dense
    helper, kept for fields.solve_sweep and tests)."""
    dtype = dtype or _cdtype()
    if len(edges) == 0:
        return jnp.zeros((N, N), dtype)
    vals = edge_mass_vals(points, edges).astype(dtype)
    rows, cols = edge_structure(edges)
    return sparselib.coo_to_dense(
        jnp.asarray(rows), jnp.asarray(cols), vals.reshape(-1), N
    )


# ---------------------------------------------------------------------------
# Port geometry / modes


def port_frame(mesh: Mesh, port: int):
    """Port nodes ordered by walking the edge chain (correct for
    diagonal/curved ports), arclength coordinates, and total length."""
    pe = mesh.port_edges(port)
    nodes = portlib.order_edge_chain(pe)
    pts = mesh.points[nodes]
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    t = np.concatenate([[0.0], np.cumsum(seg)])
    width = float(t[-1])
    return nodes, t, width, (pts[0], pts[-1])


def port_beta(k2, width, mode: int = 1):
    """Propagation constant of mode m on a PEC-walled port of width a:
    beta = sqrt(k^2 eps - (m pi / a)^2), with the reference's branch cut
    (evanescent -> -j|.|, rama/solver.cc:186-193)."""
    kc = mode * np.pi / width
    val = jnp.asarray(k2 - kc**2, _cdtype())
    b = jnp.sqrt(val)
    return jnp.where(jnp.real(val) < 0, -b, b)


# ---------------------------------------------------------------------------
# Driven problem plan (host-side static structure)


@dataclasses.dataclass
class PortPlan:
    number: int
    nodes: np.ndarray            # (P,) ordered along the chain
    edges: np.ndarray            # (E, 2)
    adj_tris: np.ndarray         # (E,) triangle adjacent to each edge
    num_modes: int
    dirichlet: bool              # EZ (sin modes) vs EXY (cos modes)
    analytic: bool               # closed-form modes vs numerical profiles
    profiles: Optional[np.ndarray]   # (M, P) numerical mode shapes
    beta2: Optional[np.ndarray]      # (M,) numerical beta^2 at plan k0
    # (P,) per-node normal stiffness weight n^T W n along the port (the
    # weight of beta^2 in the separated transverse problem); None for
    # analytic ports.  Numerical modes' Robin/DtN/flux terms use the
    # wn-WEIGHTED port mass so loaded/anisotropic ports stay
    # flux-consistent (see _port_quantities).
    wn_profile: Optional[np.ndarray] = None


@dataclasses.dataclass
class DrivenPlan:
    config: FemConfig
    N: int
    triangles: np.ndarray
    rows: np.ndarray             # full COO rows (all segments + diag)
    cols: np.ndarray
    seg_slices: Dict[str, slice]
    ports: List[PortPlan]
    abc_edges: np.ndarray
    abc_adj: np.ndarray
    robin_edges: np.ndarray
    robin_alpha: np.ndarray      # (Er,) complex dimensionless coefficients
    robin_adj: np.ndarray
    dirichlet_mask: np.ndarray   # (N,) bool
    dirichlet_values: np.ndarray  # (N,)
    point_source_node: int       # -1 if none
    use_sparse: bool
    structure: sparselib.SparseStructure
    # "bicgstab": solve on-device with Jacobi-preconditioned BiCGStab
    # instead of the host SuperLU callback (use_sparse must be True)
    iterative: bool = False
    # "bcr": on-device block-tridiagonal cyclic-reduction direct solve
    # (fem/block_tridiag.py) — banded/RCM-reordered meshes, batched
    bcr_structure: Optional[object] = None

    @property
    def num_ports(self) -> int:
        return len(self.ports)


def _edge_tri_adjacency(mesh: Mesh, edges: np.ndarray) -> np.ndarray:
    """Triangle adjacent to each boundary edge (unique for boundary
    edges)."""
    emap = {}
    tri = mesh.triangles
    for ti in range(len(tri)):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = (min(tri[ti, a], tri[ti, b]), max(tri[ti, a], tri[ti, b]))
            emap.setdefault(key, ti)
    out = np.zeros(len(edges), dtype=int)
    for i, (a, b) in enumerate(np.asarray(edges).reshape(-1, 2)):
        out[i] = emap.get((min(a, b), max(a, b)), 0)
    return out


DENSE_MAX_N = 1200   # densify below this (one (N,N) complex dense solve)


def plan_driven(
    mesh: Mesh,
    config: FemConfig,
    num_modes: int = 1,
    numerical_modes: str = "auto",
    point_source=None,
    solver: str = "auto",
) -> DrivenPlan:
    """Extract the static structure of the driven problem.

    numerical_modes: "auto" solves the 1D transverse eigenproblem when a
    port's eps profile is non-uniform (dielectric-loaded port) and uses
    the closed-form sin/cos modes otherwise; "always"/"never" force it.
    """
    N = mesh.num_points
    tri = np.asarray(mesh.triangles)
    vr, vc = vol_structure(tri)
    rows = [vr]
    cols = [vc]
    seg_slices = {}
    off = len(vr)
    seg_slices["vol"] = slice(0, off)

    dirichlet = config.type in ("EZ", "ES")

    port_numbers = sorted(
        set(int(p) for p in mesh.edge_port[mesh.edge_kind == 1])
    )
    ports = []
    for p in port_numbers:
        pe = mesh.port_edges(p)
        nodes, t, width, _ = port_frame(mesh, p)
        adj = _edge_tri_adjacency(mesh, pe)
        eps_prof = portlib.port_eps_profile(mesh, p, nodes)

        # Stiffness-weight tensor along the port: W = sigma (EZ) or
        # sigma/eps (EXY, which carries eps in the stiffness) — the
        # weighted 1D eigenproblem then covers loaded EXY and
        # anisotropic-sigma EZ ports (the reference leaves both to its
        # closed forms, rama/solver.cc:175-177, despite intending
        # WaveguideModeFEMProblem at :251).
        sxx = np.asarray(mesh.sigma_xx, complex)
        syy = np.asarray(mesh.sigma_yy, complex)
        sxy = np.asarray(mesh.sigma_xy, complex)
        if config.type == "EXY":
            inv_eps = 1.0 / np.asarray(mesh.epsilon, complex)
            Wxx_t, Wyy_t, Wxy_t = sxx * inv_eps, syy * inv_eps, sxy * inv_eps
        else:
            Wxx_t, Wyy_t, Wxy_t = sxx, syy, sxy
        wt_prof, wn_prof = portlib.port_weight_profiles(
            mesh, nodes, Wxx_t, Wyy_t, Wxy_t
        )
        mass_prof = (
            np.ones_like(eps_prof) if config.type == "EXY" else eps_prof
        )

        def _uniform(prof):
            return np.max(np.abs(prof - prof[0])) < 1e-9 * max(
                1.0, np.max(np.abs(prof))
            )

        uniform = (
            _uniform(eps_prof) and _uniform(wt_prof) and _uniform(wn_prof)
        )
        use_numerical = (
            numerical_modes == "always"
            or (numerical_modes == "auto" and not uniform)
        )
        if config.type == "ES":
            use_numerical = False      # electrostatics has no port modes
        profiles = beta2 = None
        if use_numerical:
            k2p = complex(config.k2_eff())
            tm = portlib.transverse_modes(
                t, mass_prof, k2p, num_modes,
                dirichlet=config.type == "EZ",
                w_stiff=wt_prof, w_beta=wn_prof,
            )
            profiles, beta2 = tm.profiles, tm.beta2
        ports.append(PortPlan(
            number=p, nodes=nodes, edges=np.asarray(pe), adj_tris=adj,
            num_modes=num_modes, dirichlet=config.type == "EZ",
            analytic=not use_numerical, profiles=profiles, beta2=beta2,
            wn_profile=np.asarray(wn_prof) if use_numerical else None,
        ))
        er, ec = edge_structure(pe)
        rows.append(er)
        cols.append(ec)
        seg_slices[f"port{p}_mass"] = slice(off, off + len(er))
        off += len(er)
        if num_modes > 1:
            # DtN correction block: dense over the port nodes
            P = len(nodes)
            rr = np.repeat(nodes, P)
            cc = np.tile(nodes, P)
            rows.append(rr)
            cols.append(cc)
            seg_slices[f"port{p}_dtn"] = slice(off, off + P * P)
            off += P * P

    abc_edges = mesh.boundary_edges[mesh.edge_kind == 2]
    abc_adj = _edge_tri_adjacency(mesh, abc_edges) if len(abc_edges) else (
        np.zeros(0, int)
    )
    if len(abc_edges):
        er, ec = edge_structure(abc_edges)
        rows.append(er)
        cols.append(ec)
        seg_slices["abc"] = slice(off, off + len(er))
        off += len(er)

    kind4 = mesh.edge_kind == 4
    robin_edges = mesh.boundary_edges[kind4]
    robin_alpha = (
        np.asarray(mesh.edge_alpha)[kind4]
        if getattr(mesh, "edge_alpha", None) is not None
        else np.zeros(0, complex)
    )
    robin_adj = (
        _edge_tri_adjacency(mesh, robin_edges) if len(robin_edges)
        else np.zeros(0, int)
    )
    if len(robin_edges):
        er, ec = edge_structure(robin_edges)
        rows.append(er)
        cols.append(ec)
        seg_slices["robin"] = slice(off, off + len(er))
        off += len(er)

    # Dirichlet (PEC for EZ; painted potentials for ES)
    dmask = np.zeros(N, bool)
    dvals = np.zeros(N)
    if dirichlet:
        pec_nodes = np.unique(mesh.boundary_edges[mesh.edge_kind == 0])
        dmask[pec_nodes] = True
        pot = mesh.edge_kind == 3
        if pot.any():
            for e, v in zip(mesh.boundary_edges[pot], mesh.edge_value[pot]):
                dvals[e[0]] = v
                dvals[e[1]] = v
            dmask[np.unique(mesh.boundary_edges[pot])] = True

    # diagonal segment (unit rows for Dirichlet / safety)
    diag_idx = np.arange(N)
    rows.append(diag_idx)
    cols.append(diag_idx)
    seg_slices["diag"] = slice(off, off + N)
    off += N

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)

    node = -1
    if point_source is not None:
        node = int(np.argmin(
            np.linalg.norm(mesh.points - np.asarray(point_source), axis=1)
        ))

    if solver == "auto":
        use_sparse = N > DENSE_MAX_N
    else:
        use_sparse = solver in ("sparse", "bicgstab", "bcr")
    bcr_structure = None
    if solver == "bcr":
        from eggshell_tpu.fem.block_tridiag import BlockTridiagStructure

        bcr_structure = BlockTridiagStructure.auto(rows, cols, N)

    return DrivenPlan(
        config=config, N=N, triangles=tri, rows=rows, cols=cols,
        seg_slices=seg_slices, ports=ports,
        abc_edges=np.asarray(abc_edges), abc_adj=abc_adj,
        robin_edges=np.asarray(robin_edges),
        robin_alpha=np.asarray(robin_alpha, complex), robin_adj=robin_adj,
        dirichlet_mask=dmask, dirichlet_values=dvals,
        point_source_node=node, use_sparse=use_sparse,
        structure=sparselib.SparseStructure(rows, cols, N),
        iterative=solver == "bicgstab",
        bcr_structure=bcr_structure,
    )


# ---------------------------------------------------------------------------
# Driven core (pure jnp; differentiable)


def _port_mass_small(tj, weight=None):
    """(P, P) consistent P1 mass on the port chain from traced arclength
    coords tj; `weight` (P,) optionally weights each element by the
    midpoint of its nodes' values (the wn-weighted mass of numerical
    loaded/anisotropic ports)."""
    h = tj[1:] - tj[:-1]
    P = tj.shape[0]
    if weight is not None:
        h = h * 0.5 * (weight[:-1] + weight[1:])
    diag = (
        jnp.zeros(P, h.dtype).at[:-1].add(h / 3.0).at[1:].add(h / 3.0)
    )
    offd = h / 6.0
    Bp = jnp.diag(diag)
    idx = jnp.arange(P - 1)
    Bp = Bp.at[idx, idx + 1].set(offd).at[idx + 1, idx].set(offd)
    return Bp


def _branch_sqrt(x):
    """sqrt with the reference's branch cut: negative-real arguments give
    -sqrt so evanescent port terms decay (rama/solver.cc:146-151)."""
    b = jnp.sqrt(x)
    return jnp.where(jnp.real(x) < 0, -b, b)


def _dir_weight(Wxx, Wyy, Wxy, d):
    """d^T W d for a unit direction d=(dx, dy) and per-element tensor
    (the reference's anisotropic Robin scale, toolkit/femsolver.h:622-638
    uses sqrt of this along the boundary normal)."""
    return (
        Wxx * d[0] * d[0] + Wyy * d[1] * d[1] + 2.0 * Wxy * d[0] * d[1]
    )


def _port_quantities(pp: PortPlan, pts, eps_tri, Wxx, Wyy, Wxy, k2_eff,
                     is_exy, dtype):
    """Traced per-port quantities: arclength t, length L, mode profiles
    (M, P), Robin coefficients alpha_m (M,), small port mass (P, P).

    alpha_m is flux-consistent with the stiffness-weight tensor W used in
    the volume assembly: the matched condition for the weak form
    W dn(u) + alpha u = 0 against a mode with propagation constant
    beta_m = sqrt(eff_k2_m / W_n) is alpha_m = i W_n beta_m
    = i sqrt(W_n eff_k2_m).  With W = I this reduces to the reference's
    alpha = i beta0 (rama/solver.cc:194); with anisotropic W it
    reproduces the reference's sqrt(n^T sigma n) scale
    (toolkit/femsolver.h:622-638)."""
    nodes = jnp.asarray(pp.nodes)
    ppts = pts[nodes]
    seg = jnp.linalg.norm(ppts[1:] - ppts[:-1], axis=1)
    tj = jnp.concatenate([jnp.zeros((1,), seg.dtype), jnp.cumsum(seg)])
    L = tj[-1]
    adj = jnp.asarray(pp.adj_tris)
    eps_port = jnp.mean(eps_tri[adj])
    # port tangent/normal from the chord (straight ports; the reference
    # makes the same assumption, femsolver.h:627-631)
    that = (ppts[-1] - ppts[0]) / jnp.maximum(
        jnp.linalg.norm(ppts[-1] - ppts[0]), 1e-30
    )
    nvec = jnp.stack([that[1], -that[0]])
    Wn = jnp.mean(_dir_weight(Wxx[adj], Wyy[adj], Wxy[adj], nvec))
    Wt = jnp.mean(_dir_weight(Wxx[adj], Wyy[adj], Wxy[adj], that))
    # mass-term k^2 at the port: EZ carries eps in the mass; the EXY
    # convention here carries eps in the stiffness weight instead
    k2_mass = k2_eff if is_exy else k2_eff * eps_port
    M = pp.num_modes
    if pp.analytic:
        ms = jnp.arange(1, M + 1) if pp.dirichlet else jnp.arange(M)
        x = tj[None, :] * (ms[:, None] * (jnp.pi / L))
        prof = (jnp.sin(x) if pp.dirichlet else jnp.cos(x)).astype(dtype)
        kc2 = ((ms * (jnp.pi / L)) ** 2).astype(dtype)
        eff_k2 = k2_mass - kc2 * Wt
        alphas = 1j * _branch_sqrt(Wn * eff_k2)
        Bp = _port_mass_small(tj).astype(dtype)
        be_scale = None
    else:
        prof = jnp.asarray(pp.profiles, dtype)
        # numerical modes solve the WEIGHTED generalized problem
        # (k2 M_eps - K_wt) psi = beta^2 M_wn psi, so beta2 is the true
        # propagation constant squared; the matched Robin condition
        # W dn(u) = -i beta W_n(y) u makes every port term (fundamental
        # Robin, DtN corrections, excitation, S projection, flux) use
        # the wn-WEIGHTED port mass — one substitution Bp -> Bp_wn with
        # alphas = i beta.  For constant W_n this reduces exactly to the
        # analytic branch's alpha = i sqrt(W_n eff_k2) * M.
        beta2 = jnp.asarray(pp.beta2, dtype)
        alphas = 1j * _branch_sqrt(beta2)
        wn = jnp.asarray(pp.wn_profile, dtype)
        Bp = _port_mass_small(tj, weight=wn).astype(dtype)
        # per-edge scale for the assembled fundamental Robin block —
        # indexed in pp.edges order (not chain order)
        pos = {int(n): i for i, n in enumerate(np.asarray(pp.nodes))}
        e = np.asarray(pp.edges).reshape(-1, 2)
        i0 = np.asarray([pos[int(a)] for a in e[:, 0]])
        i1 = np.asarray([pos[int(b)] for b in e[:, 1]])
        be_scale = 0.5 * (wn[i0] + wn[i1])
    return tj, L, eps_port, prof, alphas, Bp, be_scale


def solve_driven_core(pts, eps_tri, sxx, syy, sxy, exc_tri, k0,
                      plan: DrivenPlan, return_flux: bool = False):
    """Assemble + solve + project S-parameters.  Pure jnp function of the
    traced inputs; static structure from `plan`.

    Returns (u (N,) complex, s (num_ports, num_modes) complex); with
    `return_flux` also the per-port-mode power-flux weights
    Re(beta_w) * int psi^2 dt (num_ports, num_modes) used to convert the
    field-amplitude s into power waves across dissimilar ports
    (the reference computes outgoing POWER separately for the same
    reason, ComputePortOutgoingPower, rama/solver.h:185-197)."""
    cfg = plan.config
    dtype = _cdtype()
    N = plan.N
    tri = jnp.asarray(plan.triangles)
    k0 = jnp.asarray(k0)
    if cfg.type == "EXY" and np.isfinite(cfg.depth):
        k2_eff = (k0 * k0 - (np.pi / cfg.depth) ** 2).astype(dtype)
    else:
        k2_eff = (k0 * k0).astype(dtype)

    eps_tri = eps_tri.astype(dtype)
    # Volume term (ref HelmholtzFEMProblem PointG, rama/solver.cc:101-117;
    # EXY weights the stiffness by sigma/eps):
    is_exy = cfg.type == "EXY"
    if is_exy:
        inv_eps = 1.0 / eps_tri
        Wxx = sxx.astype(dtype) * inv_eps
        Wyy = syy.astype(dtype) * inv_eps
        Wxy = sxy.astype(dtype) * inv_eps
        Ke, Me = element_matrices(
            pts, tri, jnp.ones_like(eps_tri), Wxx, Wyy, Wxy,
        )
        vol_vals = Ke - k2_eff * Me
    elif cfg.type == "ES":
        Wxx = sxx.astype(dtype)
        Wyy = syy.astype(dtype)
        Wxy = sxy.astype(dtype)
        Ke, _ = element_matrices(pts, tri, eps_tri, Wxx, Wyy, Wxy)
        vol_vals = Ke.astype(dtype)
    else:  # EZ
        Wxx = sxx.astype(dtype)
        Wyy = syy.astype(dtype)
        Wxy = sxy.astype(dtype)
        Ke, Me = element_matrices(pts, tri, eps_tri, Wxx, Wyy, Wxy)
        vol_vals = Ke.astype(dtype) - k2_eff * Me
    nnz = len(plan.rows)
    vals = jnp.zeros((nnz,), dtype)
    vals = vals.at[plan.seg_slices["vol"]].set(
        vol_vals.reshape(-1).astype(dtype)
    )

    rhs = jnp.zeros((N,), dtype)

    # Volume excitation (painted source density, ref Material excitation
    # rama/shape.h:64-90): \int s phi = s * area / 3 per vertex.
    area, _, _ = _tri_geometry(pts, tri)
    contrib = (exc_tri.astype(dtype) * area.astype(dtype) / 3.0)
    rhs = rhs.at[tri.reshape(-1)].add(
        jnp.repeat(contrib, 3)
    )

    # Ports
    port_aux = []
    for pp in plan.ports:
        tj, L, eps_port, prof, alphas, Bp, be_scale = _port_quantities(
            pp, pts, eps_tri, Wxx, Wyy, Wxy, k2_eff, is_exy, dtype
        )
        be = edge_mass_vals(pts, pp.edges, scale=be_scale).astype(dtype)
        # fundamental matched-port Robin: + alpha_1 B
        # (ref alpha = i*beta0 with the anisotropic sqrt(n^T sigma n)
        # scale, rama/solver.cc:194 + toolkit/femsolver.h:622-638)
        vals = vals.at[plan.seg_slices[f"port{pp.number}_mass"]].set(
            alphas[0] * be.reshape(-1)
        )
        if pp.num_modes > 1:
            # DtN corrections: sum_m (alpha_m - alpha_1)
            #   (Bp psi_m)(Bp psi_m)^T / (psi_m^T Bp psi_m)
            # matches modes 2..M exactly; reduces to the reference's
            # uniform alpha at M=1.
            Bpm = prof @ Bp                      # (M, P)
            denom = jnp.sum(Bpm * prof, axis=1)  # psi^T Bp psi
            coef = (alphas - alphas[0]) / denom
            dtn = jnp.einsum("m,mp,mq->pq", coef[1:], Bpm[1:], Bpm[1:])
            vals = vals.at[plan.seg_slices[f"port{pp.number}_dtn"]].set(
                dtn.reshape(-1)
            )
        if pp.number == cfg.excited_port:
            m0 = cfg.excited_mode - 1
            # rhs = 2 alpha_m (B psi_m) on the port nodes
            # (ref beta = i*2*sin(dist pi)*|alpha|, rama/solver.cc:195)
            rhs = rhs.at[jnp.asarray(pp.nodes)].add(
                2.0 * alphas[m0] * (Bp @ prof[m0])
            )
        port_aux.append((pp, prof, alphas, Bp))

    def _edge_alphas(edges, adj):
        """Flux-consistent absorbing coefficient per boundary edge:
        alpha_e = i sqrt(W_n k2_mass) with W_n = n^T W n along the edge
        normal (ref solver.cc:200-202 alpha = i k, plus the femsolver
        anisotropic scale)."""
        e = jnp.asarray(np.asarray(edges).reshape(-1, 2))
        adj = jnp.asarray(adj)
        d = pts[e[:, 1]] - pts[e[:, 0]]
        d = d / jnp.maximum(
            jnp.linalg.norm(d, axis=1, keepdims=True), 1e-30
        )
        nv = jnp.stack([d[:, 1], -d[:, 0]], axis=1)
        Wn = (
            Wxx[adj] * nv[:, 0] ** 2 + Wyy[adj] * nv[:, 1] ** 2
            + 2.0 * Wxy[adj] * nv[:, 0] * nv[:, 1]
        )
        k2_mass = k2_eff if is_exy else k2_eff * eps_tri[adj]
        return 1j * _branch_sqrt(Wn * k2_mass), Wn

    # ABC: + i sqrt(W_n k2_mass) B per edge (ref solver.cc:200-202)
    if len(plan.abc_edges):
        a_e, _ = _edge_alphas(plan.abc_edges, plan.abc_adj)
        be = edge_mass_vals(pts, plan.abc_edges, scale=a_e).astype(dtype)
        vals = vals.at[plan.seg_slices["abc"]].set(be.reshape(-1))

    # Custom Robin (metal walls): + W_n * alpha_cb * k_phys * B where
    # k_phys = sqrt(k2_eff eps_local) is the physical local wavenumber
    # (ref boundary_params_ callback * k, rama/solver.cc:155-158; the W_n
    # factor adapts the reference's convention to the eps-in-stiffness
    # EXY weak form used here — identity for EZ).
    if len(plan.robin_edges):
        adj = jnp.asarray(plan.robin_adj)
        eps_e = eps_tri[adj]
        k_phys = _branch_sqrt(k2_eff * eps_e)
        _, Wn_e = _edge_alphas(plan.robin_edges, plan.robin_adj)
        alpha = jnp.asarray(plan.robin_alpha, dtype) * k_phys * Wn_e
        be = edge_mass_vals(pts, plan.robin_edges, scale=alpha).astype(dtype)
        vals = vals.at[plan.seg_slices["robin"]].set(be.reshape(-1))

    # Point source (radiation problems)
    if plan.point_source_node >= 0:
        rhs = rhs.at[plan.point_source_node].add(1.0)

    # Dirichlet elimination with lift (rhs -= A g; unit diag rows)
    dmask = jnp.asarray(plan.dirichlet_mask)
    if plan.dirichlet_mask.any():
        g = jnp.asarray(plan.dirichlet_values, dtype)
        rows_j = jnp.asarray(plan.rows)
        cols_j = jnp.asarray(plan.cols)
        Ag = sparselib.coo_matvec(rows_j, cols_j, vals, g, N)
        rhs = rhs - Ag
        kill = dmask[rows_j] | dmask[cols_j]
        vals = jnp.where(kill, 0.0, vals)
        vals = vals.at[plan.seg_slices["diag"]].add(
            jnp.where(dmask, 1.0, 0.0).astype(dtype)
        )
        rhs = jnp.where(dmask, g, rhs)

    if plan.use_sparse:
        if plan.bcr_structure is not None:
            from eggshell_tpu.fem.block_tridiag import block_tridiag_solve

            u = block_tridiag_solve(vals, rhs, plan.bcr_structure)
        elif plan.iterative:
            u = sparselib.bicgstab_solve_structured(
                vals, rhs, plan.structure
            )
        else:
            u = sparselib.sparse_solve_structured(
                vals, rhs, plan.structure, symmetric=True
            )
    else:
        A = sparselib.coo_to_dense(
            jnp.asarray(plan.rows), jnp.asarray(plan.cols), vals, N
        )
        u = jnp.linalg.solve(A, rhs)

    # S-parameters: unconjugated Bp-weighted projection onto each mode
    # (ref ComputePortOutgoingField2, rama/solver.cc:940-990)
    max_modes = max([pp.num_modes for pp in plan.ports], default=0)
    s = jnp.zeros((plan.num_ports, max_modes), dtype)
    rdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    flux = jnp.zeros((plan.num_ports, max_modes), rdtype)
    for i, (pp, prof, alphas, Bp) in enumerate(port_aux):
        up = u[jnp.asarray(pp.nodes)]
        Bpm = prof @ Bp
        denom = jnp.sum(Bpm * prof, axis=1)
        amp = (Bpm @ up) / denom
        if pp.number == cfg.excited_port:
            amp = amp.at[cfg.excited_mode - 1].add(-1.0)
        s = s.at[i, : pp.num_modes].set(amp)
        # power flux of a unit-amplitude mode: Re(W_n beta_m) int psi^2
        # (zero for evanescent modes — they carry no power)
        fl = jnp.real(-1j * alphas) * jnp.real(denom)
        flux = flux.at[i, : pp.num_modes].set(fl)
    if return_flux:
        return u, s, flux
    return u, s


def make_driven_fn(mesh: Mesh, config: FemConfig, num_modes: int = 1,
                   numerical_modes: str = "auto", point_source=None,
                   solver: str = "auto"):
    """Public differentiable API: returns (fn, plan) where
    fn(points, eps_tri, sxx, syy, sxy, exc_tri, k0) -> (u, s) is a pure,
    jit-able jnp function — `jax.grad` of |S|^2 w.r.t. any of the traced
    inputs works through assembly AND the (dense or sparse) solve.  The
    reference's analog is jet derivatives through its pipeline
    (rama/my_jet.h; rama/solver.h:272-277)."""
    plan = plan_driven(mesh, config, num_modes=num_modes,
                       numerical_modes=numerical_modes,
                       point_source=point_source, solver=solver)

    def fn(pts, eps_tri, sxx, syy, sxy, exc_tri, k0):
        return solve_driven_core(pts, eps_tri, sxx, syy, sxy, exc_tri,
                                 k0, plan)

    return fn, plan


# ---------------------------------------------------------------------------
# Driven solve (convenience wrapper, reference-shaped results)


@dataclasses.dataclass
class DrivenSolution:
    field: jnp.ndarray            # (N,) complex nodal field
    s_params: Dict[int, complex]  # port -> S_{port, excited} (mode 1),
                                  # field-amplitude convention (ref
                                  # mode-fit amplitudes, solver.cc:940-990)
    port_power: Dict[int, float]  # outgoing power fraction per port
                                  # (flux-normalized: sums to 1 lossless
                                  # even across dissimilar port widths)
    k0: float
    s_matrix: Optional[np.ndarray] = None   # (num_ports, num_modes)
    port_numbers: Optional[List[int]] = None
    s_power: Optional[np.ndarray] = None    # power-wave S-matrix:
                                            # s * sqrt(flux/flux_excited)


def solve_driven(
    mesh: Mesh, config: FemConfig, point_source=None, num_modes: int = 1,
    numerical_modes: str = "auto", solver: str = "auto",
) -> DrivenSolution:
    """Single-frequency driven solve with matched ports
    (ref Solver::Solve electrodynamic path, rama/solver.cc:1382-1422).

    `point_source` = (x, y): unit excitation at the nearest mesh node
    (line-current analog) — used for radiation/antenna problems."""
    _, plan = make_driven_fn(
        mesh, config, num_modes=num_modes, numerical_modes=numerical_modes,
        point_source=point_source, solver=solver,
    )
    dtype = _cdtype()

    def fn_flux(*args):
        return solve_driven_core(*args, plan, return_flux=True)

    u, s, flux = jax.jit(fn_flux)(
        jnp.asarray(mesh.points),
        jnp.asarray(mesh.epsilon, dtype),
        jnp.asarray(mesh.sigma_xx),
        jnp.asarray(mesh.sigma_yy),
        jnp.asarray(mesh.sigma_xy),
        jnp.asarray(mesh.excitation, dtype),
        jnp.asarray(config.k0, jnp.float64 if jax.config.jax_enable_x64
                    else jnp.float32),
    )
    s_np = np.asarray(s)
    flux_np = np.asarray(flux)
    ex_i = next(
        (i for i, pp in enumerate(plan.ports)
         if pp.number == config.excited_port),
        None,
    )
    if ex_i is None:   # portless problem (point source / ES)
        fx = 1.0
        s_power = s_np.copy()
    else:
        fx = flux_np[ex_i, config.excited_mode - 1]
        if fx <= 0:
            # The excited mode carries no power (below cutoff /
            # evanescent): power-wave normalization is undefined, so fall
            # back to field-amplitude s (as in the portless branch)
            # rather than silently dividing by ~0.
            import warnings

            warnings.warn(
                f"excited port {config.excited_port} mode "
                f"{config.excited_mode} is evanescent (flux {fx:.3e} <= 0); "
                "s_power falls back to field-amplitude s",
                stacklevel=2,
            )
            s_power = s_np.copy()
        else:
            s_power = s_np * np.sqrt(np.maximum(flux_np, 0.0) / fx)
    s_params = {}
    power = {}
    for i, pp in enumerate(plan.ports):
        s_params[pp.number] = complex(s_np[i, 0])
        power[pp.number] = float(np.sum(np.abs(s_power[i]) ** 2))
    return DrivenSolution(
        field=u, s_params=s_params, port_power=power, k0=config.k0,
        s_matrix=s_np, port_numbers=[pp.number for pp in plan.ports],
        s_power=s_power,
    )


def port_outgoing_rms(mesh: Mesh, config: FemConfig, field) -> Dict[int, float]:
    """Total outgoing power fraction per port by the reference's metric:
    RMS of (u - excitation*mode) over the port (x2 for EZ sin^2
    normalization) — captures ALL mode content, unlike the per-mode
    projection in s_matrix (ref ComputePortOutgoingField2,
    rama/solver.cc:940-990)."""
    f = np.asarray(field)
    out = {}
    port_numbers = sorted(
        set(int(p) for p in mesh.edge_port[mesh.edge_kind == 1])
    )
    for p in port_numbers:
        nodes, t, width, _ = port_frame(mesh, p)
        mode = (
            np.sin(np.pi * t / width) if config.type == "EZ"
            else np.ones_like(t)
        )
        inc = mode if p == config.excited_port else 0.0
        o = f[nodes] - inc
        dt = np.diff(t)
        w = np.zeros_like(t)
        w[:-1] += dt / 2
        w[1:] += dt / 2
        rms2 = np.sum(w * np.abs(o) ** 2) / width
        if config.type == "EZ":
            rms2 *= 2.0
        out[p] = float(rms2)
    return out


def _trapezoid_weights(t: np.ndarray) -> jnp.ndarray:
    dt = np.diff(t)
    w = np.zeros_like(t)
    w[:-1] += dt / 2
    w[1:] += dt / 2
    return jnp.asarray(w)


# ---------------------------------------------------------------------------
# Eigenmodes


def solve_modes(
    mesh: Mesh,
    num_modes: int = 6,
    sigma: Optional[float] = None,
    dirichlet: bool = True,
    potential: Optional[np.ndarray] = None,
    use_lobpcg: bool = False,
    method: Optional[str] = None,
):
    """Generalized eigenproblem K psi = lambda M psi (cavity cutoffs /
    Schrodinger levels).  `method` selects the solver:

    - None / "arpack" (default): SciPy ARPACK shift-invert on a SPARSE
      assembly — the same solver+storage the reference drives
      (toolkit/eigensolvers.h:66-150, SimplicialLDLT inner solves).
    - "shift_invert": ON-DEVICE shift-invert subspace iteration — the
      ARPACK analog with the BCR banded direct solve as the inner
      factorization (fem/sparse.shift_invert_modes); robust for
      clustered higher modes.
    - "lobpcg": on-device sparse generalized LOBPCG with a
      CG-polynomial preconditioner (fem/sparse.lobpcg_generalized) —
      factorization-free O(nnz) memory, best for a few extremal modes
      on very large meshes.  (use_lobpcg=True is the back-compat alias.)

    Returns (eigenvalues (m,), eigenvectors (N, m))."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    pts = jnp.asarray(mesh.points)
    tri = jnp.asarray(mesh.triangles)
    N = mesh.num_points
    rows, cols = vol_structure(np.asarray(mesh.triangles))
    Ke, Me = element_matrices(pts, tri, jnp.ones(mesh.num_triangles))
    kv = np.asarray(Ke, float).reshape(-1)
    mv = np.asarray(Me, float).reshape(-1)
    if potential is not None:
        _, MV = element_matrices(pts, tri, jnp.asarray(potential))
        kv = kv + np.asarray(MV, float).reshape(-1)
    Ks = sp.csr_matrix((kv, (rows, cols)), shape=(N, N))
    Ms = sp.csr_matrix((mv, (rows, cols)), shape=(N, N))

    if dirichlet:
        keep = np.ones(N, bool)
        keep[np.unique(mesh.boundary_edges)] = False
        idx = np.flatnonzero(keep)
        Kr = Ks[idx][:, idx]
        Mr = Ms[idx][:, idx]
    else:
        idx = np.arange(N)
        Kr, Mr = Ks, Ms

    if use_lobpcg and method is None:
        method = "lobpcg"
    if method in ("lobpcg", "shift_invert"):
        # Fully sparse on-device paths on the reduced COO triplets —
        # O(nnz) memory, no densification (r2's dense-transform variant
        # would OOM at exactly the sizes where an on-device path
        # matters).  See sparselib.{lobpcg_generalized,
        # shift_invert_modes}.
        Krc = Kr.tocoo()
        Mrc = Mr.tocoo()
        # merge the two sparsity patterns so K and M share (rows, cols)
        pat = (abs(Krc) + abs(Mrc)).tocoo()
        rr, cc = pat.row, pat.col
        kv2 = np.asarray(Kr.tocsr()[rr, cc]).ravel()
        mv2 = np.asarray(Mr.tocsr()[rr, cc]).ravel()
        solver = (sparselib.lobpcg_generalized if method == "lobpcg"
                  else sparselib.shift_invert_modes)
        vals_j, vecs_j = solver(
            rr, cc, kv2, mv2, Kr.shape[0], num_modes, seed=0,
        )
        vals = np.asarray(vals_j)
        vecs = np.asarray(vecs_j)
    else:
        if sigma is None:
            sigma = 1e-6
        vals, vecs = spla.eigsh(
            Kr.tocsc(), k=num_modes, M=Mr.tocsc(), sigma=sigma, which="LM"
        )
        order = np.argsort(vals)
        vals, vecs = vals[order], vecs[:, order]

    full = np.zeros((N, vals.shape[0]))
    full[idx] = vecs
    return vals, full
