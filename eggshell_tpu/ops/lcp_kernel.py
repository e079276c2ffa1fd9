"""Batched projected-Jacobi LCP sweeps as one Pallas kernel (Triton).

The step solves thousands of small independent contact LCPs, one per
scene: A is (m, m) with m = 3 x contact lanes (24 to 144 in the bench).
The XLA sweep (`ops.lcp.solve_lcp(method="jacobi")` under vmap) is a
`fori_loop` of batched matvecs, so it reads every scene's A from device
memory once per sweep.  This kernel loads each scene's A once into
registers and runs all sweeps there:

    x <- proj((1 - omega) x + omega D^-1 (b - (A - D) x) + beta (x - x_prev))

the exact update of the XLA sweep (heavy-ball momentum `beta`, box
projection onto [lo, hi], equality rows unclamped).

Layout: A (B, mp, mp), vectors (B, mp), mp = m padded to a power of two
(Triton blocks are powers of two).  Each program takes a few scenes
(`_launch_shape`).  A padded row has a zero row and column in A, unit diagonal,
zero rhs and bounds [0, 0], so its x stays 0 and couples to nothing.

`solve_jacobi_batched` is the entry point the stepper calls.  It picks
the kernel or the XLA sweep in the open: `lcp_path` takes the kernel for
the scalar sweep with static bounds and m <= KERNEL_MAX_ROWS (one padded
A of at most 128 x 128 floats, 64 KB, held in the registers of one
block of 8 warps); block-Jacobi and Coulomb-pyramid bounds run the XLA
sweep.  The kernel exists only for CUDA: `lax.platform_dependent`
lowers it where the computation runs on a GPU and the XLA sweep
everywhere else.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from eggshell_tpu.ops import lcp

# Largest (unpadded) row count the kernel takes; above it the padded A
# (256 x 256 floats = 256 KB) exceeds a block's 227 KB of shared memory.
KERNEL_MAX_ROWS = 128


def lcp_path(m: int, *, block: bool = False, coupled: bool = False) -> str:
    """"kernel" or "xla": which sweep solves a batch of m-row LCPs on a
    GPU (elsewhere it is always the XLA sweep)."""
    if block or coupled or m > KERNEL_MAX_ROWS:
        return "xla"
    return "kernel"


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _launch_shape(mp: int) -> tuple[int, int]:
    """(scenes per program, warps): about 8-16k A entries per program."""
    scenes = max(1, 8192 // (mp * mp))
    return scenes, min(16, max(4, scenes * mp * mp // 2048))


def _jacobi_kernel(a_ref, b_ref, d_ref, lo_ref, hi_ref, x_ref, *,
                   iters, omega, beta):
    A = a_ref[...]                       # (S, mp, mp), read once
    b = b_ref[...]                       # (S, mp)
    d = d_ref[...]
    lo = lo_ref[...]
    hi = hi_ref[...]

    def proj(x):
        return jnp.minimum(jnp.maximum(x, lo), hi)

    def sweep(_, carry):
        x, xp = carry
        r = b - jnp.sum(A * x[:, None, :], axis=2) + d * x
        xn = proj((1.0 - omega) * x + omega * (r / d) + beta * (x - xp))
        return xn, x

    x0 = proj(b)
    x, _ = jax.lax.fori_loop(0, iters, sweep, (x0, x0))
    x_ref[...] = x


@functools.partial(
    jax.jit, static_argnames=("iters", "omega", "beta", "interpret")
)
def jacobi_sweeps_kernel(A, b, is_eq, lo, hi, *, iters: int, omega: float,
                         beta: float = 0.0, interpret: bool = False):
    """`iters` projected-Jacobi sweeps for a batch of LCPs in one Pallas
    call.  A (B, m, m), b/lo/hi (B, m), is_eq (B, m) bool.  Returns x
    (B, m), equal to vmapped `lcp.solve_lcp(method="jacobi")` with the
    same iters, omega and beta."""
    B, m = b.shape
    dtype = A.dtype
    mp = _next_pow2(max(m, 16))
    scenes, warps = _launch_shape(mp)
    Bp = -(-B // scenes) * scenes

    inf = jnp.asarray(jnp.inf, dtype)
    lo_e = jnp.where(is_eq, -inf, lo).astype(dtype)
    hi_e = jnp.where(is_eq, inf, hi).astype(dtype)
    d = jnp.diagonal(A, axis1=-2, axis2=-1)

    def pad(v, fill):
        return jnp.pad(v, ((0, Bp - B), (0, mp - m)), constant_values=fill)

    Ap = jnp.pad(A, ((0, Bp - B), (0, mp - m), (0, mp - m)))
    vec_spec = pl.BlockSpec((scenes, mp), lambda i: (i, 0))
    x = pl.pallas_call(
        functools.partial(_jacobi_kernel, iters=iters, omega=omega,
                          beta=beta),
        grid=(Bp // scenes,),
        in_specs=[pl.BlockSpec((scenes, mp, mp), lambda i: (i, 0, 0))]
        + [vec_spec] * 4,
        out_specs=vec_spec,
        out_shape=jax.ShapeDtypeStruct((Bp, mp), dtype),
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=1),
        interpret=interpret,
        name="lcp_jacobi_sweeps",
    )(Ap, pad(b, 0.0), pad(d, 1.0), pad(lo_e, 0.0), pad(hi_e, 0.0))
    return x[:B, :m]


def solve_jacobi_batched(A, b, is_eq, lo, hi, *, iters: int, omega: float,
                         beta: float = 0.0, block: bool = False,
                         couple=None, mu: float = 0.0):
    """Projected Jacobi over a batch of LCPs, on the path `lcp_path`
    picks (the kernel only on a GPU).  `couple`/`mu`: Coulomb-pyramid
    bounds (ops.lcp._bounds)."""

    def one(a, r, e, l, h, c):
        return lcp.solve_lcp(
            a, r, e, l, h, iters=iters, method="jacobi",
            jacobi_omega=omega, jacobi_beta=beta, couple=c, mu=mu,
            jacobi_block=block,
        )

    def xla(A, b, is_eq, lo, hi):
        return jax.vmap(one)(A, b, is_eq, lo, hi, couple)

    def kernel(A, b, is_eq, lo, hi):
        return jacobi_sweeps_kernel(A, b, is_eq, lo, hi, iters=iters,
                                    omega=omega, beta=beta)

    if lcp_path(b.shape[-1], block=block, coupled=couple is not None) \
            == "xla":
        return xla(A, b, is_eq, lo, hi)
    return jax.lax.platform_dependent(A, b, is_eq, lo, hi, default=xla,
                                      cuda=kernel)
