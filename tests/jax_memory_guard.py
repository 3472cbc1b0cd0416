"""An autouse fixture for the port's tests that run JAX programs: after each
test, JAX's in-memory caches of compiled programs are cleared.

Running the JAX package op by op (as the env-step parities do) compiles
thousands of small programs, and each compiled program keeps memory
mappings. A test worker that runs test_torch_env.py and then
test_torch_ppo.py's epochs in one process passes the kernel's limit of
65,530 mappings per process, and XLA aborts the worker while it compiles
or loads the next program (BallBalance's epoch; `--dist load` put them in
one worker). Cleared after each test, a worker stays under 14,000. A test
module imports the fixture to apply it to each of its tests."""
import jax
import pytest


@pytest.fixture(autouse=True)
def free_jax_programs():
    yield
    jax.clear_caches()
