"""Simulation configuration.

The reference scatters its tuning constants across compile-time
``constexpr``s (eggshell/constants.h:5-13, eggshell/ensembles.cc:14-21,
eggshell/sparse_iterations.cc:15-19, eggshell/contact.cc:11).  Here they
live in one frozen dataclass that is hashable (usable as a static jit
argument) and JSON-serialisable for the benchmark harness.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Tuple


class FrictionModel(enum.IntEnum):
    """Contact friction models (ref: eggshell/contact.h:21-26).

    COULOMB_PYRAMID is declared but unimplemented in the reference
    (eggshell/contact.cc:150-152); this build implements it for real:
    tangential bounds +-mu * lambda_n coupled to the contact's normal
    impulse inside the projected sweeps (supported by the PGS/JACOBI
    solvers).  Default stays BOX for reference parity.
    """

    NO_FRICTION = 0
    INFINITE = 1
    BOX = 2
    COULOMB_PYRAMID = 3


class SolverKind(enum.IntEnum):
    """Contact/LCP solver for the velocity step.

    PGS/JACOBI/SOR mirror the reference's projected splitting iterations
    (eggshell/sparse_iterations.cc:90-144).  The direct pivot solver
    (Murty, eggshell/lcp.cc:157-274) lives in `ops.lcp_direct` and
    `oracle` for reference-accuracy checks.
    """

    PGS = 0      # projected Gauss-Seidel (scan over rows)
    JACOBI = 1   # projected Jacobi (fully parallel sweep)
    SOR = 2      # backward projected SOR, omega=1.5 (ref sparse_iterations.cc:15)
    DIRECT = 3   # Murty pivot + Schur mixed solver (ref lcp.cc:157-336)
    JACOBI_KERNEL = 4  # batched Jacobi: fused sweep kernel on the GPU
    #                    (ops/lcp_kernel) + IFT-adjoint custom VJP
    MATRIX_FREE = 5  # O(K)-memory projected Jacobi on compact two-body
    #                  blocks; never forms JMJ^T — the LARGE-single-scene
    #                  path (ref sparse_iterations_utils.cc:624-695)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters.

    Defaults reproduce the reference's operating point:
      dt                ref eggshell/constants.h:6   (kSimTimeStep = 1e-3)
      gravity           ref eggshell/constants.h:8   ((0, 0, -9.8))
      erp               ref eggshell/ensembles.cc:563 (error_reduction_param=0.2)
      cfm               ref eggshell/ensembles.cc:14 (kCfmCoeff = 0.01); the
                        reference applies it only when cond(JMJt) > 1e7
                        (ensembles.cc:514-519).  `conditional_cfm=True`
                        reproduces that; False applies `cfm_always` every step
                        (the batched fast path — documented deviation,
                        validated by trajectory-parity tests).
      friction bound    ref eggshell/contact.cc:11 (kBoxFrictionBound = 1)
      solver iters      ref eggshell/sparse_iterations.cc:19 (500)
      solver_tol        ref eggshell/constants.h:5 (1e-9)
      sor_omega         ref eggshell/sparse_iterations.cc:15 (1.5)
    """

    dt: float = 1e-3
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.8)
    erp: float = 0.2
    cfm: float = 0.01
    conditional_cfm: bool = True
    cfm_always: float = 0.0
    friction_model: FrictionModel = FrictionModel.BOX
    friction_bound: float = 1.0
    # Coulomb coefficient for FrictionModel.COULOMB_PYRAMID.
    friction_mu: float = 0.5
    solver: SolverKind = SolverKind.PGS
    solver_iters: int = 100
    # solver_tol > 0 enables the reference's early-exit convergence check
    # (a lax.while_loop — NOT reverse-mode differentiable, and a
    # data-dependent exit per sweep).  The default 0.0 runs exactly
    # `solver_iters` fixed sweeps: differentiable end-to-end and the hot
    # path.
    solver_tol: float = 0.0
    sor_omega: float = 1.5
    # Under-relaxation for the JACOBI solver (the parallel sweep);
    # <= ~0.3 is stable on redundant contact systems.
    jacobi_omega: float = 0.3
    # Heavy-ball momentum for the Jacobi sweep: x + w D^-1 r
    # + beta (x - x_prev).  ~0.45 roughly halves the sweeps needed for a
    # given trajectory error (validated vs a 300-sweep reference on the
    # stack and cairn scenes).  0.0 = plain under-relaxed Jacobi.
    jacobi_beta: float = 0.0
    # Block-Jacobi for the Jacobi sweep: solve each 3-row
    # constraint block exactly per sweep (precomputed 3x3 inverses) —
    # converges in roughly half the sweeps of the scalar update on
    # frictional stacks at equal per-sweep cost.
    jacobi_block: bool = False
    # Condition-number threshold above which CFM is applied
    # (ref eggshell/constants.h:12, kGoodConditionNumber).
    good_condition_number: float = 1e7
    # How conditional_cfm estimates cond(A): "exact" = full eigvalsh
    # (bit-matches the reference's SVD check, utils.cc:256-261 — the
    # golden-parity configuration); "power" = power + inverse iteration
    # through one Cholesky factor (~5x cheaper on the f64 oracle tier).
    cond_estimator: str = "exact"
    # Constraints closer than this are deduplicated to avoid a singular J
    # (ref eggshell/ensembles.cc:15, kMinConstraintDistance).
    min_constraint_distance: float = 1e-6
    # Cap on the Baumgarte/ERP position-correction velocity (m/s) for
    # contact penetration — the dWorldSetMaxCorrectingVel analog from the
    # Open Dynamics Engine the reference's stepper is modeled on.  A
    # deeply interpenetrating spawn (e.g. the living-room MJCF's table
    # lamp, mujoco_scratchpad/living_room.xml:63 — MuJoCo absorbs it with
    # soft solref constraints) would otherwise be ejected at
    # erp*depth/dt (~160 m/s); the cap saturates the correction at
    # max_correcting_vel by clamping the effective depth to
    # max_correcting_vel * dt / erp.  inf (default) = reference parity.
    max_correcting_vel: float = float("inf")
    # Reproduce the reference APP's effective contact bounds: its
    # production path Lcp::MixedConstraintsSolver (eggshell/lcp.cc:276-298)
    # forwards inequality rows to the 2-argument MurtyPrincipalPivot,
    # which fixes bounds to [0, inf) — silently DISCARDING the +-1 box
    # friction bounds that Contact::ComputeJ requested
    # (eggshell/contact.cc:104-113).  True makes BOX friction rows use
    # [0, inf) so trajectories match the compiled reference bit-for-bit
    # (the golden-parity gate, tests/test_golden_parity.py); False keeps
    # the reference's *intended* box-bound semantics.
    ref_app_bounds: bool = False
    # Contact capacity: max live contacts per scene (masked lanes).
    contact_capacity: int = 64
    # Broadphase: when > 0, AABB-prune the candidate pair list down to
    # this many lanes before the SAT narrowphase (toolkit/collision.h:40
    # analog; 0 = run the narrowphase on every candidate pair like
    # eggshell/ensembles.cc:460-474).
    pair_capacity: int = 0
    broadphase_margin: float = 0.0
    # Broadphase algorithm: "mask" = (n, n) broadcast overlap + top_k
    # compaction (the default); "sap" =
    # sorted sweep-and-prune strip (ops/broadphase.sap_select_pairs,
    # the toolkit/collision.h:22-45 sorted-list analog; O(n*window)
    # instead of O(n^2), wins at larger n).  sap_window bounds how many
    # bodies may straddle one x coordinate (the sorted active list's
    # max length); overlapping pairs further apart in x-rank are
    # silently dropped, so size it like the other capacity knobs.
    broadphase_kind: str = "mask"
    sap_window: int = 64

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["friction_model"] = int(self.friction_model)
        d["solver"] = int(self.solver)
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "SimConfig":
        d = json.loads(s)
        d["friction_model"] = FrictionModel(d["friction_model"])
        d["solver"] = SolverKind(d["solver"])
        d["gravity"] = tuple(d["gravity"])
        return SimConfig(**d)
