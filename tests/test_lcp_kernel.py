"""The batched Jacobi LCP kernel (ops/lcp_kernel) against the XLA sweep
(ops/lcp.solve_lcp, method="jacobi") in Pallas interpret mode, and the
wrapper's padding and choice of path.  On the card the kernel is
compared at full width by `chip_smoke.py` and by the `gpu`-marked test
below."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eggshell_tpu.ops import lcp, lcp_kernel


def _problems(rng, B, m, eq_frac=0.3):
    M = rng.uniform(-1, 1, (B, m, m))
    A = np.einsum("bij,bkj->bik", M, M) + m * np.eye(m)
    b = rng.uniform(-1, 1, (B, m))
    is_eq = rng.uniform(size=(B, m)) < eq_frac
    lo = np.where(is_eq, 0.0, -1.0)
    hi = np.where(
        is_eq, 0.0, np.where(rng.uniform(size=(B, m)) < 0.5, 1.0, np.inf)
    )
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    return f32(A), f32(b), jnp.asarray(is_eq), f32(lo), f32(hi)


def _xla(A, b, is_eq, lo, hi, iters, omega, beta):
    return jax.vmap(
        lambda a, r, e, l, h: lcp.solve_lcp(
            a, r, e, l, h, iters=iters, method="jacobi",
            jacobi_omega=omega, jacobi_beta=beta,
        )
    )(A, b, is_eq, lo, hi)


@pytest.mark.parametrize("beta", [0.0, 0.45])
@pytest.mark.parametrize("m", [24, 30, 60, 96, 144])
def test_kernel_matches_xla_sweep(m, beta):
    """Bench row counts (box_drop 24, pendulum_chain6 30, headline 60,
    living_room/box_stack8 96, box_stack12_cap48 144) at the bench's
    sweep count and omega, float32 (interpret mode: exact f32 products
    on both sides, so 2e-5 absolute covers summation order only)."""
    rng = np.random.default_rng(m)
    args = _problems(rng, 3, m)
    x_k = lcp_kernel.jacobi_sweeps_kernel(
        *args, iters=16, omega=0.3, beta=beta, interpret=True
    )
    x_x = _xla(*args, 16, 0.3, beta)
    assert x_k.shape == (3, m)
    np.testing.assert_allclose(np.asarray(x_k), np.asarray(x_x), atol=2e-5)


@pytest.mark.parametrize("eq_frac", [0.0, 1.0])
def test_kernel_equality_rows(eq_frac):
    """All-inequality and all-equality batches: equality rows are
    unclamped (bounds +-inf inside the kernel)."""
    rng = np.random.default_rng(11)
    args = _problems(rng, 4, 24, eq_frac=eq_frac)
    x_k = lcp_kernel.jacobi_sweeps_kernel(
        *args, iters=20, omega=0.5, beta=0.2, interpret=True
    )
    np.testing.assert_allclose(
        np.asarray(x_k), np.asarray(_xla(*args, 20, 0.5, 0.2)), atol=2e-5
    )


@pytest.mark.parametrize("B", [1, 5, 9, 13])
def test_kernel_batch_not_multiple_of_block(B):
    """B is padded up to a whole number of programs (8 scenes each at
    m <= 32); padded scenes do not leak into real ones."""
    scenes, _ = lcp_kernel._launch_shape(32)
    assert scenes == 8
    rng = np.random.default_rng(B)
    args = _problems(rng, B, 18)
    x_k = lcp_kernel.jacobi_sweeps_kernel(
        *args, iters=10, omega=0.3, beta=0.45, interpret=True
    )
    assert x_k.shape == (B, 18)
    np.testing.assert_allclose(
        np.asarray(x_k), np.asarray(_xla(*args, 10, 0.3, 0.45)), atol=2e-5
    )


@pytest.mark.parametrize(
    "m,mp,scenes,warps",
    [(3, 16, 32, 4), (24, 32, 8, 4), (60, 64, 2, 4), (96, 128, 1, 8),
     (128, 128, 1, 8)],
)
def test_launch_shape(m, mp, scenes, warps):
    assert lcp_kernel._next_pow2(max(m, 16)) == mp
    assert lcp_kernel._launch_shape(mp) == (scenes, warps)


@pytest.mark.parametrize(
    "kw,path",
    [
        (dict(m=24), "kernel"),
        (dict(m=60), "kernel"),
        (dict(m=128), "kernel"),
        (dict(m=144), "xla"),
        (dict(m=60, block=True), "xla"),
        (dict(m=60, coupled=True), "xla"),
    ],
)
def test_lcp_path(kw, path):
    """On the GPU the kernel takes the scalar sweep with static bounds up
    to KERNEL_MAX_ROWS rows; everything else takes the XLA sweep."""
    m = kw.pop("m")
    assert lcp_kernel.lcp_path(m, **kw) == path


def test_wrapper_lowers_xla_sweep_off_the_gpu():
    """A kernel-eligible batch lowered for the CPU runs the XLA sweep:
    the Triton branch of `lax.platform_dependent` is never lowered."""
    rng = np.random.default_rng(2)
    args = _problems(rng, 3, 60)
    assert lcp_kernel.lcp_path(60) == "kernel"
    got = jax.jit(lambda *a: lcp_kernel.solve_jacobi_batched(
        *a, iters=16, omega=0.3, beta=0.45))(*args)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(jax.jit(_xla, static_argnums=(5, 6, 7))(
            *args, 16, 0.3, 0.45))
    )


def test_wrapper_routes_block_mode_to_xla_block_sweep():
    rng = np.random.default_rng(3)
    args = _problems(rng, 3, 24)
    got = lcp_kernel.solve_jacobi_batched(
        *args, iters=12, omega=0.5, beta=0.0, block=True
    )
    want = jax.vmap(
        lambda a, r, e, l, h: lcp.solve_lcp(
            a, r, e, l, h, iters=12, method="jacobi", jacobi_omega=0.5,
            jacobi_block=True,
        )
    )(*args)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_wrapper_routes_pyramid_bounds_to_xla_sweep():
    rng = np.random.default_rng(4)
    A, b, is_eq, lo, hi = _problems(rng, 2, 24, eq_frac=0.0)
    # contact triplets (t1, t2, n): tangents couple to their normal row
    couple = jnp.broadcast_to(
        jnp.where(jnp.arange(24) % 3 < 2, (jnp.arange(24) // 3) * 3 + 2, -1),
        (2, 24),
    )
    got = lcp_kernel.solve_jacobi_batched(
        A, b, is_eq, lo, hi, iters=12, omega=0.3, beta=0.45,
        couple=couple, mu=0.4,
    )
    want = jax.vmap(
        lambda a, r, e, l, h, c: lcp.solve_lcp(
            a, r, e, l, h, iters=12, method="jacobi", jacobi_omega=0.3,
            jacobi_beta=0.45, couple=c, mu=0.4,
        )
    )(A, b, is_eq, lo, hi, couple)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [24, 60, 96])
def test_compiled_kernel_matches_xla_sweep(gpu, m):
    """The compiled Triton kernel against the XLA sweep at HIGHEST
    precision, full bench batch."""
    rng = np.random.default_rng(m)
    args = _problems(rng, 4096, m)
    x_k = lcp_kernel.jacobi_sweeps_kernel(*args, iters=16, omega=0.3,
                                          beta=0.45)
    x_x = _xla(*args, 16, 0.3, 0.45)
    np.testing.assert_allclose(np.asarray(x_k), np.asarray(x_x), atol=1e-4)
