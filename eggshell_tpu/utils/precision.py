"""Matrix-product precision for the physics path.

On the GPU a float32 matrix product may run in TF32, which keeps 10
mantissa bits, unless a precision is asked for.  The physics path has
products that must keep float32 accuracy for the DIRECT/f64 oracle gate
(1e-3 on p and v): one-hot selections and scatters written as matmuls
(contact compaction, body-block assembly, the matrix-free matvec), the
system matrix J M^-1 J^T and the sweep's A x.  Those sites pass
`precision=HIGHEST`; the step entry points also trace their whole body
under `full_precision`, so small geometric products (rotations, frames)
stay float32 as well.  On the CPU the setting changes nothing.
"""

from __future__ import annotations

import functools

import jax

HIGHEST = jax.lax.Precision.HIGHEST


def full_precision(fn):
    """Trace `fn` with every float32 matrix product at HIGHEST precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
