"""One PPO epoch of the Ant on two gloo ranks on the CPU against the JAX
package's epoch over all its envs (tests/test_torch_parallel.py's
`check_two_rank_epochs`); a file of its own for its time: the JAX Ant
steps op by op (its potentials near 6e4 need the op-by-op rounding).
"""
import torch

from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)
from test_torch_parallel import check_two_rank_epochs

torch.set_num_threads(1)


def test_two_rank_epoch_matches_jax_on_the_ant(tmp_path):
    """No episode ends: the Ant stays up, so both sides step the same envs."""
    check_two_rank_epochs("Ant", tmp_path)
