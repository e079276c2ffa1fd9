"""Quality triangulation of SDF shapes — the rama mesh tier
(rama/mesh.cc + vendored Shewchuk Triangle equivalent).

distmesh-style algorithm (Persson & Strang 2004, public method): seed a
hex-packed point cloud inside the shape, then relax it as a truss where
each Delaunay edge pushes with force max(L0 - L, 0); boundary points
project back onto the zero level set via the numerical SDF gradient.
scipy.spatial.Delaunay supplies the triangulation at each retriangulation
step (host-side preprocessing, like the reference's mesher — meshing is
not the device hot path; the FEM solves are).

The resulting `Mesh` carries boundary-edge attributes resolved from the
shape's painted Port/ABC segments (EdgeInfo analog, rama/mesh.h:21-80)
and per-triangle materials from painted regions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial import Delaunay

from eggshell_tpu.fem.shape import Shape


@dataclasses.dataclass
class Mesh:
    points: np.ndarray          # (N, 2)
    triangles: np.ndarray       # (T, 3) int
    boundary_edges: np.ndarray  # (E, 2) int — edges on the boundary
    # per boundary edge: kind 0 = PEC (default), 1 = port, 2 = ABC,
    # 3 = fixed potential (electrostatics conductor), 4 = custom Robin
    # (complex alpha coefficient — lossy conductor walls, fem/metal.py)
    edge_kind: np.ndarray       # (E,)
    edge_port: np.ndarray       # (E,) port number (0 if none)
    epsilon: np.ndarray         # (T,) complex per-triangle permittivity
    sigma_xx: np.ndarray        # (T,)
    sigma_yy: np.ndarray        # (T,)
    sigma_xy: np.ndarray = None  # (T,) anisotropy cross term
    excitation: np.ndarray = None  # (T,) complex volume source density
    edge_value: np.ndarray = None  # (E,) potential for edge_kind 3
    edge_alpha: np.ndarray = None  # (E,) complex Robin alpha for kind 4

    def __post_init__(self):
        if self.sigma_xy is None:
            self.sigma_xy = np.zeros(len(self.triangles))
        if self.excitation is None:
            self.excitation = np.zeros(len(self.triangles), dtype=complex)
        if self.edge_value is None:
            self.edge_value = np.zeros(len(self.boundary_edges))
        if self.edge_alpha is None:
            self.edge_alpha = np.zeros(len(self.boundary_edges),
                                       dtype=complex)

    @property
    def num_points(self) -> int:
        return len(self.points)

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    def port_edges(self, port: int) -> np.ndarray:
        return self.boundary_edges[(self.edge_kind == 1) & (self.edge_port == port)]


def _sdf_grad(shape: Shape, pts: np.ndarray, h: float = 1e-6) -> np.ndarray:
    d0 = shape.distance(pts)
    gx = (shape.distance(pts + [h, 0]) - d0) / h
    gy = (shape.distance(pts + [0, h]) - d0) / h
    return np.stack([gx, gy], axis=1)


def mesh_shape(
    shape: Shape,
    edge_length: float,
    max_iters: int = 60,
    seed: int = 0,
    geps_scale: float = 0.001,
    fh=None,
) -> Mesh:
    """Triangulate `shape` with target edge length `edge_length`
    (config.mesh_edge_length analog, ref rama/solver.h:42-126).

    `fh(pts) -> (N,)` optionally gives a SPATIALLY VARYING desired edge
    length (absolute units; distmesh's size function h(x) — the analog
    of the reference mesher's local refinement, rama/mesh.cc).
    `edge_length` then acts as the minimum/seeding resolution: seeds are
    thinned with probability (min h / fh)^2 and the truss rest lengths
    follow fh at each edge midpoint, so fine regions (lenses, ports,
    conductors) get h ~ fh_min while bulk regions coarsen — the same
    answer at a fraction of the nodes of a uniform fine mesh
    (tests/test_mesh_sizing.py)."""
    assert shape.bbox is not None, "shape must carry a bounding box"
    xmin, ymin, xmax, ymax = shape.bbox
    h0 = edge_length
    geps = geps_scale * h0

    # Hex-packed seeds
    x = np.arange(xmin - h0, xmax + h0, h0)
    y = np.arange(ymin - h0, ymax + h0, h0 * np.sqrt(3) / 2)
    X, Y = np.meshgrid(x, y)
    X[1::2] += h0 / 2
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    pts = pts[shape.distance(pts) < geps]

    if fh is not None:
        # Rejection-thin seeds by the size function (Persson-Strang
        # distmesh step 2): keep with probability (h_min / fh)^2.
        rng = np.random.default_rng(seed)
        hvals = np.maximum(np.asarray(fh(pts), float), h0)
        r0 = 1.0 / hvals**2
        pts = pts[rng.uniform(size=len(pts)) < r0 / r0.max()]

    fixed = np.asarray(
        [p for p in shape.fixed_points if shape.distance([p])[0] < h0],
        dtype=float,
    ).reshape(-1, 2)
    if len(fixed):
        # drop seeds too close to fixed points, then prepend fixed
        d = np.min(
            np.linalg.norm(pts[:, None, :] - fixed[None, :, :], axis=2), axis=1
        )
        pts = np.concatenate([fixed, pts[d > 0.5 * h0]])
    nfix = len(fixed)

    def triangulate(p):
        tri = Delaunay(p).simplices
        cent = p[tri].mean(axis=1)
        keep = shape.distance(cent) < -geps
        return tri[keep]

    Fscale = 1.2
    deltat = 0.2
    old = None
    for _ in range(max_iters):
        if old is None or np.max(
            np.linalg.norm(pts - old, axis=1)
        ) > 0.1 * h0:
            old = pts.copy()
            tri = triangulate(pts)
            edges = np.unique(
                np.sort(
                    np.concatenate(
                        [tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]]
                    ),
                    axis=1,
                ),
                axis=0,
            )
        vec = pts[edges[:, 0]] - pts[edges[:, 1]]
        L = np.linalg.norm(vec, axis=1)
        if fh is None:
            L0 = Fscale * h0 * np.ones_like(L)
        else:
            # rest lengths follow the size function at edge midpoints,
            # rescaled so total truss force balances (distmesh eq. 2.3)
            hbar = np.maximum(
                np.asarray(
                    fh(0.5 * (pts[edges[:, 0]] + pts[edges[:, 1]])), float
                ),
                h0,
            )
            L0 = (
                Fscale * hbar
                * np.sqrt(np.sum(L**2) / np.sum(hbar**2))
            )
        F = np.maximum(L0 - L, 0)
        Fvec = (F / np.maximum(L, 1e-12))[:, None] * vec
        move = np.zeros_like(pts)
        np.add.at(move, edges[:, 0], Fvec)
        np.add.at(move, edges[:, 1], -Fvec)
        move[:nfix] = 0
        pts = pts + deltat * move

        # project exterior points back to the boundary
        d = shape.distance(pts)
        out = d > 0
        if out.any():
            g = _sdf_grad(shape, pts[out])
            gn = np.maximum(np.linalg.norm(g, axis=1), 1e-12)
            pts[out] -= (d[out] / gn**2)[:, None] * g

        # snap points near painted material interfaces onto them, so
        # dielectric boundaries are mesh-conforming (the reference's
        # mesher constrains these edges exactly via Triangle; here the
        # zero level set of each painted region attracts nearby points)
        for mat in shape.materials:
            dm = mat.region.distance(pts)
            near = (np.abs(dm) < 0.35 * h0) & (shape.distance(pts) < -geps)
            near[:nfix] = False
            if near.any():
                g = _sdf_grad(mat.region, pts[near])
                gn = np.maximum(np.linalg.norm(g, axis=1), 1e-12)
                pts[near] -= (dm[near] / gn**2)[:, None] * g

    tri = triangulate(pts)
    # drop unused points, remap
    used = np.unique(tri)
    remap = -np.ones(len(pts), dtype=int)
    remap[used] = np.arange(len(used))
    pts = pts[used]
    tri = remap[tri]

    # Orient triangles CCW
    v1 = pts[tri[:, 1]] - pts[tri[:, 0]]
    v2 = pts[tri[:, 2]] - pts[tri[:, 0]]
    flip = (v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]) < 0
    tri[flip] = tri[flip][:, [0, 2, 1]]

    return _finish_mesh(pts, tri, shape, edge_length)


def _finish_mesh(pts: np.ndarray, tri: np.ndarray, shape: Shape,
                 edge_length: float) -> Mesh:
    """Resolve painted boundary attributes and per-triangle materials
    onto a triangulation (EdgeInfo/Material resolution, the analog of
    the reference's mesher boundary links, rama/mesh.h:21-80)."""
    # Boundary edges: edges belonging to exactly one triangle
    all_e = np.sort(
        np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]]),
        axis=1,
    )
    uniq, counts = np.unique(all_e, axis=0, return_counts=True)
    bedges = uniq[counts == 1]

    # Resolve painted boundary attributes
    kind = np.zeros(len(bedges), dtype=int)
    port = np.zeros(len(bedges), dtype=int)
    value = np.zeros(len(bedges))
    alpha = np.zeros(len(bedges), dtype=complex)
    mids = 0.5 * (pts[bedges[:, 0]] + pts[bedges[:, 1]])
    for seg in shape.boundaries:
        p1 = np.asarray(seg.p1)
        p2 = np.asarray(seg.p2)
        e = p2 - p1
        elen2 = e @ e
        t = np.clip(((mids - p1) @ e) / max(elen2, 1e-300), 0, 1)
        proj = p1[None, :] + t[:, None] * e[None, :]
        dist = np.linalg.norm(mids - proj, axis=1)
        on = dist <= max(seg.tol, 0.3 * edge_length)
        if seg.kind == "port":
            kind[on] = 1
            port[on] = seg.port_number
        elif seg.kind == "abc":
            kind[on] = 2
        elif seg.kind == "potential":
            kind[on] = 3
            value[on] = seg.value
        elif seg.kind == "robin":
            kind[on] = 4
            alpha[on] = seg.alpha

    # Per-triangle materials
    cent = pts[tri].mean(axis=1)
    eps = np.ones(len(tri), dtype=complex)
    sxx = np.ones(len(tri))
    syy = np.ones(len(tri))
    sxy = np.zeros(len(tri))
    exc = np.zeros(len(tri), dtype=complex)
    for mat in shape.materials:
        inside = mat.region.contains(cent)
        eps[inside] = mat.epsilon
        sxx[inside] = mat.sigma_xx
        syy[inside] = mat.sigma_yy
        sxy[inside] = mat.sigma_xy
        exc[inside] = mat.excitation

    return Mesh(
        points=pts, triangles=tri, boundary_edges=bedges,
        edge_kind=kind, edge_port=port, edge_value=value, epsilon=eps,
        sigma_xx=sxx, sigma_yy=syy, sigma_xy=sxy, excitation=exc,
        edge_alpha=alpha,
    )


def mesh_structured(
    shape: Shape,
    origin,
    e1,
    e2,
    edge_length: float,
    material_split: Optional[float] = None,
) -> Mesh:
    """Structured triangulation of the parallelogram origin + s e1 + t e2
    (s, t in [0, 1]) with target edge `edge_length`, with boundary/
    material attributes painted from `shape`.

    The analog of the reference feeding a clean rectangle to Triangle
    with max-edge refinement (rama/mesh.cc) — used for large waveguide
    runs (conductor-loss validation needs ~1e5 triangles where distmesh
    relaxation is unnecessary) and rotated guides (anisotropy tests).

    `material_split`: optional t-coordinate in (0, 1) to align a grid
    line with a material interface at constant t (dielectric-loaded
    guides need the interface mesh-conforming)."""
    origin = np.asarray(origin, float)
    e1 = np.asarray(e1, float)
    e2 = np.asarray(e2, float)
    n1 = max(1, int(np.ceil(np.linalg.norm(e1) / edge_length)))
    n2 = max(1, int(np.ceil(np.linalg.norm(e2) / edge_length)))
    s = np.linspace(0, 1, n1 + 1)
    t = np.linspace(0, 1, n2 + 1)
    if material_split is not None and 0 < material_split < 1:
        k = int(round(material_split * n2))
        k = min(max(k, 1), n2 - 1)
        t = np.concatenate([
            np.linspace(0, material_split, k + 1),
            np.linspace(material_split, 1, n2 - k + 1)[1:],
        ])
    S, T = np.meshgrid(s, t, indexing="ij")
    pts = origin[None, :] + S.reshape(-1, 1) * e1[None, :] + (
        T.reshape(-1, 1) * e2[None, :]
    )
    nt = len(t)

    def vid(i, j):
        return i * nt + j

    tris = []
    for i in range(n1):
        for j in range(len(t) - 1):
            a = vid(i, j)
            b = vid(i + 1, j)
            c = vid(i + 1, j + 1)
            d = vid(i, j + 1)
            if (i + j) % 2 == 0:        # union-jack split (isotropy)
                tris.append((a, b, c))
                tris.append((a, c, d))
            else:
                tris.append((a, b, d))
                tris.append((b, c, d))
    tri = np.asarray(tris, dtype=int)

    # orient CCW
    v1 = pts[tri[:, 1]] - pts[tri[:, 0]]
    v2 = pts[tri[:, 2]] - pts[tri[:, 0]]
    flip = (v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]) < 0
    tri[flip] = tri[flip][:, [0, 2, 1]]
    return _finish_mesh(pts, tri, shape, edge_length)
