"""An autouse fixture for the port's tests that run JAX programs: after a
test, JAX's in-memory caches of compiled programs are cleared once the
worker's memory mappings pass MAPPINGS_LIMIT.

Running the JAX package op by op (as the env-step parities do) compiles
thousands of small programs, and each compiled program keeps memory
mappings. A test worker that runs test_torch_env.py and then
test_torch_ppo.py's epochs in one process passes the kernel's limit of
65,530 mappings per process, and XLA aborts the worker while it compiles
or loads the next program (BallBalance's epoch; `--dist load` put them in
one worker). Clearing after every test kept a worker under 14,000, but made
every test compile its programs again. Clearing only past 30,000 (the
lines of /proc/self/maps, read after each test) keeps the programs that
later tests of the worker share, and leaves room below the limit for the
largest single test: with a threshold of 40,000 a worker ended one test at
51,767. Where /proc/self/maps cannot be read, the caches are cleared after
every test. Each test records the count it ended with as the junit
property `jax_mappings`.

Importing this module also sends every program JAX compiles to the
persistent compilation cache that the JAX package configures (its
directory; by default the package caches only programs that take a second
or more to compile), so that the workers of one run share the small
programs of the op-by-op parities instead of each compiling its own.

A test module imports the fixture to apply it to each of its tests."""
import jax
import pytest

import isaacgymenvs_tpu  # noqa: F401 (sets the persistent cache's directory, and its own threshold, on import)

MAPPINGS_LIMIT = 30_000
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def mappings() -> int:
    """The memory mappings of this process, or -1 where they cannot be read."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return -1


@pytest.fixture(autouse=True)
def free_jax_programs(request):
    yield
    n = mappings()
    request.node.user_properties.append(("jax_mappings", n))
    if n < 0 or n > MAPPINGS_LIMIT:
        jax.clear_caches()
