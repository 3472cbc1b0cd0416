"""One AnymalTerrain PPO epoch of the port against the JAX package, as
tests/test_torch_ppo.py holds Cartpole, Ant and BallBalance: the JAX side
of the epoch is assembled from the JAX package's own env (stepped op by op
with its fused physics math: the merged window, top-K, terrain rows), its
network, running stats, `_gae`, `_loss`, `tx` and `_update_lr`, and both
sides get the same action noise and minibatch permutations. The network is
AnymalTerrainPPO.yaml's shape cut to [32, 16] (a separate critic, a state-free
sigma learnt apart from the observation); the grid is 3 levels x 4 types,
the solver takes 8 APGD iterations a slice (16 in the yaml: the JAX step
runs op by op), the observation noise is off (the two packages' noise
streams differ) and the setup-only friction draw is the JAX package's, put
on the port's state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.learn import ppo as jppo
from isaacgymenvs_tpu_torch.convert import dr_sample_from_jax, train_state_from_jax
from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.engine.dynamics import Terrain as TTerrain
from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics
from isaacgymenvs_tpu_torch import maths
from isaacgymenvs_tpu_torch.learn import ppo as tppo
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from test_torch_ppo import _adam_state, _jax_epoch, _jax_params, _np_tree, _port_params
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

N, HORIZON, MINI_EPOCHS, NUM_MB = 4, 3, 2, 2
ARGS = ["task=AnymalTerrain", f"num_envs={N}", "task.env.terrain.numLevels=3", "task.env.terrain.numTerrains=4",
        "task.env.learn.addNoise=False", "task.sim.physx.num_position_iterations=2"]


def _agents():
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    train = {"network": {"separate": True, "mlp": {"units": [32, 16], "activation": "elu"},
                         "space": {"continuous": {"fixed_sigma": True, "sigma_init": {"val": 0.0}}}},
             "config": {"horizon_length": HORIZON, "mini_epochs": MINI_EPOCHS, "minibatch_size": HORIZON * N // NUM_MB,
                        "truncate_grads": True, "critic_coef": 2, "value_bootstrap": True, "e_clip": 0.2,
                        "entropy_coef": 0.001, "reward_shaper": {"scale_value": 1.0}}}
    jcfg = jload(ARGS)["task"]
    jcfg["sim"]["use_fused"] = True
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["AnymalTerrain"](jcfg)
        tenv = ttasks["AnymalTerrain"](tload(ARGS)["task"], device="cpu")
    return jppo.PPO(jenv, train, seed=0), tppo.PPO(tenv, train, seed=0)


def _port_state_from(tagent, jts):
    """A port train state holding the JAX train state: parameters, running
    stats, lr, Adam moments, and the env state with its task, DR sample and
    counters."""
    adam = _adam_state(jts.opt_state)
    fields = _np_tree({"params": jts.params, "obs_rms": vars(jts.obs_rms), "value_rms": vars(jts.value_rms),
                       "lr": jts.lr, "mu": adam.mu, "nu": adam.nu, "count": adam.count})
    names = [n for n, _ in tagent.network.named_parameters()]
    ts = tagent.load_state(tagent.init(), train_state_from_jax(fields, names))
    t = lambda a: torch.tensor(np.asarray(a))
    js, st = jts.env_state, ts.env_state
    st.sim = SimState(q=t(js.sim.q), qd=t(js.sim.qd))
    st.task = {k: t(v) for k, v in js.task.items()}
    st.task["level"], st.task["type"] = st.task["level"].long(), st.task["type"].long()
    st.dr = dr_sample_from_jax({k: np.asarray(v) for k, v in js.dr.items()})
    st.dyn = tagent.env.pack_dyn(st.dr)
    st.randomize_buf = t(js.randomize_buf).to(torch.int32)
    st.frames = t(js.frames).to(torch.int32)
    ts.obs = t(jts.obs)
    return ts


def test_anymal_terrain_epoch_matches_jax():
    """An epoch from a settled state (fresh network, stats and optimizer):
    metrics to rtol 2e-4 / atol 2e-6, parameters to atol 1e-4 (the first
    layer's weights: see below), the running stats to 1e-4, as for the other
    tasks; the terrain level is logged from the env's extras."""
    jagent, tagent = _agents()
    assert tagent.network.separate
    jts = jagent.init()
    # Near the world origin: the grid is moved so that the corner of its
    # cell (1, 1) lies there, and the robots stand within 2 m of it. (Far
    # from the origin the step's origin-referenced spatial algebra turns
    # float32 rounding of the position into velocity differences of 1e-3,
    # which the 12-sample running stats then blow up.)
    g = tagent.env.grid
    corner = (g.border + round(g.env_length / g.hs)) * g.hs
    jagent.env.terrain = jagent.env.terrain.replace(origin=jnp.asarray([-corner, -corner]))
    tagent.env.terrain = TTerrain(tagent.env.terrain.height, g.hs, origin=(-corner, -corner))
    tts = _port_state_from(tagent, jts)
    st = tts.env_state
    m = tagent.env.model
    q = st.sim.q
    q[:, :2] = torch.tensor(np.random.RandomState(3).uniform(-2, 2, (N, 2)), dtype=torch.float32)
    kin = forward_kinematics(m, q, st.sim.qd)
    cb = torch.tensor(m.cpoint_body)
    x = kin.x[:, cb] + maths.quat_rotate(kin.quat[:, cb], torch.tensor(m.cpoint_pos))
    q[:, 2] -= (x[..., 2] - torch.tensor(m.cpoint_radius) - tagent.env.terrain.sample(x[..., :2])).amin(1) - 0.002
    # a settled start
    for _ in range(5):
        st, _, _, _, _ = tagent.env.step(st, torch.zeros(N, 12))
    js = jts.env_state
    jts = jts.replace(env_state=js.replace(
        sim=js.sim.replace(q=jnp.asarray(st.sim.q.numpy()), qd=jnp.asarray(st.sim.qd.numpy())),
        frames=jnp.asarray(5, jnp.int32)))
    tts = _port_state_from(tagent, jts)
    rng = np.random.RandomState(7)
    B = HORIZON * N
    noise = (0.3 * rng.normal(size=(HORIZON, N, 12))).astype(np.float32)
    perms = np.stack([rng.permutation(B) for _ in range(MINI_EPOCHS)])
    jts, want = _jax_epoch(jagent, jts, jnp.asarray(noise), perms)
    tts, got = tagent.train_epoch(tts, noise=torch.tensor(noise), perms=torch.tensor(perms))
    assert want["n_episodes"] == got["n_episodes"] == 0
    for k in ("a_loss", "c_loss", "entropy", "b_loss", "kl", "lr", "reward_mean_step"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6, err_msg=k)
    jp, tp = _jax_params(jts.params), _port_params(tagent)
    for name in jp:
        if name.endswith("fc0.weight"):
            # Adam turns a near-zero gradient into a whole step of lr whose sign
            # the rounding decides: a weight on an input that barely varies
            # over the batch may land 2 lr from the other package's
            off = np.abs(tp[name] - jp[name]) > 1e-4
            assert off.mean() < 1e-3 and np.abs(tp[name] - jp[name]).max() < 2 * want["lr"] + 1e-4, name
        else:
            np.testing.assert_allclose(tp[name], jp[name], atol=1e-4, err_msg=name)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(tts.value_rms, f).numpy(), np.asarray(getattr(jts.value_rms, f)),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(getattr(tts.obs_rms, f).numpy(), np.asarray(getattr(jts.obs_rms, f)),
                                   rtol=1e-4, atol=1e-4)
    assert "env/terrain_level" in got
