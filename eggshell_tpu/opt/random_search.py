"""Random-search optimisation — toolkit RandomSearchOptimizer equivalent
(toolkit/optimizer.h:221-247): uniform sampling within bounds, keep the
best.  Fully parallel: all samples evaluate in one vmap."""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class RSResult(NamedTuple):
    x: jax.Array
    fun: jax.Array


@functools.partial(jax.jit, static_argnames=("fn", "num_samples"))
def random_search(
    fn: Callable[[jax.Array], jax.Array],
    lower: jax.Array,
    upper: jax.Array,
    key: jax.Array,
    num_samples: int = 1024,
) -> RSResult:
    n = lower.shape[0]
    u = jax.random.uniform(key, (num_samples, n), lower.dtype)
    xs = lower[None, :] + u * (upper - lower)[None, :]
    fs = jax.vmap(fn)(xs)
    i = jnp.argmin(fs)
    return RSResult(x=xs[i], fun=fs[i])
