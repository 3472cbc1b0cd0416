"""AMP's `local_shuffle` over two gloo ranks on the CPU against the JAX
package's shard-blocked epoch (isaacgymenvs_tpu/learn/amp.py:96-107 with
ppo.py:523-616): HumanoidAMP at the sizes of tests/test_torch_amp.py, its
JAX epoch assembled there; the checks of tests/test_torch_parallel.py's
`check_local_shuffle`. A file of its own for its time: the JAX env steps
op by op.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_amp as amp_t
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)
from test_torch_parallel import _epoch_inputs, check_local_shuffle, jax_blocked_rows

torch.set_num_threads(1)


def test_local_shuffle_amp_matches_jax_blocked_epoch(tmp_path):
    """The demos are JAX's windows, each on its row of the blocked layout
    (a rank's shard is its half). Each minibatch's discriminator rows, the
    global minibatch's first amp_minibatch_size, lie on both ranks.
    Parameters at tests/test_torch_amp.py's rtol 2e-4 / atol 1e-5, but for
    one element in a thousand of a tensor, which must lie within one Adam
    step (lr) of JAX's: the ReLU networks' elements whose gradient the
    float32 rounding of a unit near its kink decides. Adam divides each
    element's step by its gradient's scale, so such an element moves by up
    to lr per step either way; on these inputs one weight of the
    discriminator's first layer lies 1.4e-4 from JAX's, in one process as
    in the port's global-shuffle epoch over the same rows."""
    from isaacgymenvs_tpu.learn import AMPAgent as JAMP
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.learn import AMPAgent as TAMP
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    cfg = amp_t.CFG
    train = {**amp_t.AMP_TRAIN, "config": {**amp_t.AMP_TRAIN["config"], "local_shuffle": True}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", amp_t.package_asset_root())
        jenv = jtasks["HumanoidAMP"]({"env": dict(cfg["env"]), "sim": {**cfg["sim"], "use_fused": True}})
    tenv = ttasks["HumanoidAMP"]({k: dict(v) for k, v in cfg.items()}, device="cpu")
    jagent, tagent = JAMP(jenv, train, seed=0), TAMP(tenv, train, seed=0)
    jts = amp_t._jax_init(jagent)
    tts = amp_t._port_state_from(tagent, jts)
    rng = np.random.RandomState(10)
    H, n, B, mb = train["config"]["horizon_length"], amp_t.N, jagent.batch_size, jagent.minibatch_size
    assert min(jagent.amp_minibatch_size, mb) > mb // 2  # the discriminator's rows span both shards
    noise = rng.normal(size=(H, n, 28)).astype(np.float32)
    shard_perms = np.stack([rng.permutation(B // 2) for _ in range(2)])
    perms, blocked = jax_blocked_rows(shard_perms, 2, B // mb, mb, T=H, N=n)
    jts, want, demos = amp_t._jax_amp_epoch(jagent, jts, jnp.asarray(noise), perms)
    blocked_demos = torch.tensor(demos[blocked])
    inputs = _epoch_inputs("AMPAgent", tagent, tts, "HumanoidAMP", {k: dict(v) for k, v in cfg.items()}, train, n)
    inputs["epochs"] = [{"noise": torch.tensor(noise), "perms": torch.tensor(shard_perms),
                         "demos": [blocked_demos[:B // 2], blocked_demos[B // 2:]]}]
    check_local_shuffle(tmp_path, tagent, tts, inputs, {"perms": torch.tensor(perms), "demos": torch.tensor(demos)},
                        want, amp_t._jax_params(jts.params), 2e-4, 1e-5, one_kw={"demos": blocked_demos},
                        kink_bound=train["config"]["learning_rate"])
