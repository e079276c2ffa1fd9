"""2D FEM electromagnetics / quantum tier — the rama-equivalent engine.

- shape:     CSG geometry with the reference's nouns (Rectangle, Circle,
             +/-/&, Paint for materials, Port/ABC boundary painting) —
             implemented as signed-distance CSG instead of polygon
             clipping (ref rama/shape.cc + vendored Clipper).
- mesher:    distmesh-style quality triangulation driven by the SDF
             (ref rama/mesh.cc + vendored Shewchuk Triangle).
- helmholtz: P1 FEM assembly + solves for EZ/TE/TM/electrostatic/
             Schrodinger problems (ref rama/solver.cc, toolkit/femsolver.h).
- ports:     port excitation, outgoing power, S-parameters
             (ref rama/solver.h:185-224).
- eigen:     waveguide modes / cavity eigenfrequencies via LOBPCG
             (ref toolkit/eigensolvers.h ARPACK shift-invert).
- fdtd:      2D TMz and 3D Yee FDTD cores
             (ref toolkit/fdtd.{h,cc}).
"""

from eggshell_tpu.fem.shape import (  # noqa: F401
    Shape, Rectangle, Circle, Polygon, Polyline,
)
from eggshell_tpu.fem.mesher import Mesh, mesh_shape  # noqa: F401
