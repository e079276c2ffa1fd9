"""Test configuration.

Tests run on a virtual 8-device CPU mesh with float64 enabled — the
fake-backend analog of the reference's oracle-based test strategy
(SURVEY.md §4): numerics are checked at the reference's 1e-9 tolerances
(eggshell/constants.h:5), and multi-device sharding is validated without
accelerators via xla_force_host_platform_device_count.  Tests marked
`gpu` need an NVIDIA GPU: the `gpu` fixture skips them elsewhere, and
`python chip_smoke.py` runs them on the card.
"""

import os

# Tests run on the CPU unless the caller names a platform: the `gpu`
# tests run on the card through chip_smoke.py.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# xdist workers share the machine's cores.  XLA's CPU runtime sizes its
# thread pool to the cores a process may run on, and workers whose pools
# all span every core slow each other down many times over (a 10 s
# rollout test took 150 s beside one other worker).  Give each worker
# its own slice of the cores.
_worker = os.environ.get("PYTEST_XDIST_WORKER", "")
if _worker.startswith("gw") and hasattr(os, "sched_setaffinity"):
    _cores = sorted(os.sched_getaffinity(0))
    _n = max(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")), 1)
    _i = int(_worker[2:]) % _n
    _share = _cores[_i * len(_cores) // _n:(_i + 1) * len(_cores) // _n]
    os.sched_setaffinity(0, _share or [_cores[_i % len(_cores)]])

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite is compile-bound (hundreds of
# jit specializations); cache across runs.
from eggshell_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_worker_memory():
    """Clear jax's in-memory executable/trace caches after every test
    module: a long-lived xdist worker otherwise accumulates hundreds of
    compiled programs and eventually collides with a compile peak on
    the other worker (the round-4 worker crash).  Recompiles hit the
    persistent on-disk cache, so the wall-clock cost is deserialization
    only."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` there")


@pytest.fixture
def rng():
    """Deterministic NumPy RNG — ref toolkit/testing.cc:44 (RandomSeed(0))."""
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
