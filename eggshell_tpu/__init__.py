"""eggshell_tpu — a batched, differentiable rigid-body / FEM simulation framework.

A ground-up JAX/XLA re-design of the capabilities of the
`teenylasers/eggshell` C++ workspace:

- ``eggshell_tpu.ops``      — core math kernels: quaternions, SAT box-box
  collision, projected-iteration LCP solvers, direct pivot solvers.
- ``eggshell_tpu.physics``  — batched rigid-body scenes: bodies, joints,
  contacts, the constraint-based ODE-style time stepper.
- ``eggshell_tpu.parallel`` — device-mesh sharding of scenario batches
  (vmap within a device, shard_map across devices/hosts).
- ``eggshell_tpu.mpc``      — sampling / gradient model-predictive control
  on top of differentiable rollouts.
- ``eggshell_tpu.oracle``   — slow-but-sure NumPy re-derivations used as
  ground truth in tests (the analog of the reference's MATLAB prototypes,
  ref: eggshell/lcp/*.m).
- ``eggshell_tpu.fem``      — 2D FEM electromagnetics (rama-equivalent tier).
- ``eggshell_tpu.utils``    — tracing, config, testing, checkpointing.

Design stance (vs. the C++ reference): fixed-shape structure-of-arrays
pytrees instead of an object graph, masked contact lanes instead of
dynamically sized ``std::vector<Contact>``, quaternions as the primary
rotation state, pure-function steppers composed with ``jit`` / ``vmap`` /
``scan`` / ``shard_map``.
"""

__version__ = "0.1.0"

from eggshell_tpu.utils.config import SimConfig  # noqa: F401
