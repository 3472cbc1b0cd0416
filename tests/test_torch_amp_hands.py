"""HumanoidAMPHands in the port against the JAX package: its yaml, the
termination with the hands among the contact bodies, and the generated
cartwheel clip through both motion libraries. The env step is the
HumanoidAMP class's, whose parity tests/test_torch_amp.py holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 32
HAND_KEYS = (0, 1)  # right_hand, left_hand among the key bodies


def _cfg(load_config, task):
    cfg = load_config([f"task={task}", f"num_envs={N}"])["task"]
    cfg["sim"]["use_fused"] = True
    return cfg


@pytest.fixture(scope="module")
def envs():
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["HumanoidAMP"](_cfg(jload, "HumanoidAMPHands"))
        tenv = ttasks["HumanoidAMP"](_cfg(tload, "HumanoidAMPHands"), device="cpu")
        trun = ttasks["HumanoidAMP"](_cfg(tload, "HumanoidAMP"), device="cpu")
    return jenv, tenv, trun


def test_config_matches_jax():
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    want, got = jload(["task=HumanoidAMPHands"]), tload(["task=HumanoidAMPHands"])
    assert got["task"] == want["task"]
    assert got["train"] == want["train"] == {}  # no recipe of its own: the defaults, as in the JAX package
    env = got["task"]["env"]
    assert env["contactBodies"] == ["right_foot", "left_foot", "right_hand", "left_hand"]
    assert env["motion_file"] == "amp_humanoid_cartwheel.npy" and got["task"]["name"] == "HumanoidAMP"


def test_cartwheel_clip_through_both_motion_libraries(envs):
    """Both libraries preprocess the generated clip to the same arrays and
    sample the same frames and AMP demo windows (1e-6); each hand reaches
    the ground in each cartwheel."""
    jenv, tenv, _ = envs
    jl, tl = jenv.motion_lib, tenv.motion_lib
    names = ("root_pos", "root_rot", "dof_pos", "dof_vel", "key_pos", "root_vel", "root_ang_vel")
    for k in names:
        np.testing.assert_allclose(getattr(tl, k).numpy(), np.asarray(getattr(jl, k)), atol=1e-6, err_msg=k)
    key_z = tl.key_pos[..., 2].numpy()  # (frames, 4 key bodies)
    half = key_z.shape[0] // 2
    for turn in (key_z[:half], key_z[half:]):
        for h in HAND_KEYS:
            assert turn[:, h].min() < 0.05, "a hand stays off the ground in a cartwheel"
    ids = np.zeros(16, np.int32)
    times = np.random.RandomState(1).uniform(0, 3.0, 16).astype(np.float32)
    want = jl.get_motion_state(jnp.asarray(ids), jnp.asarray(times))
    got = tl.get_motion_state(torch.tensor(ids, dtype=torch.int64), torch.tensor(times))
    for k, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=k)
    key = jax.random.PRNGKey(7)
    want = jenv.fetch_amp_obs_demo(key, 64)
    k1, k2 = jax.random.split(key)
    mids = jenv.motion_lib.sample_motions(k1, (64,))
    t0 = jenv.motion_lib.sample_time(k2, mids)
    got = tenv.amp_obs_demo_at(torch.tensor(np.asarray(mids), dtype=torch.int64), torch.tensor(np.asarray(t0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _jax_done(jenv, q, qd, body_force, prev_amp, progress):
    from isaacgymenvs_tpu.engine import dynamics as jdyn
    from isaacgymenvs_tpu.envcore.vec_task import Sensors as JSensors

    q, qd = jnp.asarray(q), jnp.asarray(qd)

    def done_of(q, qd, body_force, prev_amp, progress):
        kin = jdyn.forward_kinematics(jenv.model, q, qd)
        sensors = JSensors(body_force, jnp.zeros_like(body_force), jnp.zeros(jenv.model.nv))
        return jenv.reward_done(jnp.zeros(jenv.num_obs), q, qd, kin, sensors, {"prev_amp": prev_amp},
                                jnp.zeros(jenv.num_acts), progress)[1]

    return np.asarray(jax.jit(jax.vmap(done_of))(q, qd, jnp.asarray(body_force), jnp.asarray(prev_amp),
                                                   jnp.asarray(progress)))


def _port_done(tenv, q, qd, body_force, prev_amp, progress):
    from isaacgymenvs_tpu_torch.envcore.vec_task import Sensors

    q, qd = torch.tensor(q), torch.tensor(qd)
    bf = torch.tensor(body_force)
    sensors = Sensors(bf, torch.zeros_like(bf), torch.zeros(q.shape[0], tenv.model.nv))
    obs = torch.zeros(q.shape[0], tenv.num_obs)
    tenv._frame_memo = None
    _, done, _ = tenv.reward_done(obs, q, qd, tenv._kin(q, qd), sensors, {"prev_amp": torch.tensor(prev_amp)},
                                  torch.zeros(q.shape[0], tenv.num_acts), torch.tensor(progress))
    return done.numpy()


def test_noncontact_mask_and_termination_match_jax(envs):
    """At reference states drawn from the cartwheel clip by the port's
    reset (some with a hand on the ground), under contact forces on the
    contact bodies only and on every body: the same non-contact mask and
    the same terminations as JAX's. A hand on the ground ends no episode of HumanoidAMPHands; it
    ends HumanoidAMP's, whose contact bodies are the feet."""
    jenv, tenv, trun = envs
    np.testing.assert_array_equal(tenv.noncontact_mask.numpy(), np.asarray(jenv.noncontact_mask) > 0)
    names = tenv.model.body_names
    hands = [names.index(n) for n in ("right_hand", "left_hand")]
    assert not bool(tenv.noncontact_mask[hands].any()) and bool(trun.noncontact_mask[hands].all())
    # the port's reset (tests/test_torch_amp.py holds it against JAX's)
    state, _ = tenv.reset(3)
    q, qd = state.sim.q.numpy(), state.sim.qd.numpy()
    prev_amp = state.task["prev_amp"].numpy()
    x = tenv._poses(torch.tensor(q))[0].numpy()
    hand_down = (x[:, hands, 2] < 0.1).any(1)
    assert 0 < hand_down.sum() < N, "the drawn states hold both hands-down and other poses"
    rng = np.random.RandomState(0)
    nb = tenv.model.nbody
    contact = np.zeros((N, nb, 3), np.float32)
    for b in [names.index(n) for n in tenv.contact_body_names]:
        contact[:, b, 2] = np.where(x[:, b, 2] < 0.1, 50.0, 0.0)
    anywhere = (rng.normal(size=(N, nb, 3)) * (rng.uniform(size=(N, nb, 1)) < 0.2)).astype(np.float32)
    progress = np.full(N, 5, np.int32)
    progress[:2] = (1, 299)
    for forces in (contact, anywhere):
        want = _jax_done(jenv, q, qd, forces, prev_amp, progress)
        np.testing.assert_array_equal(_port_done(tenv, q, qd, forces, prev_amp, progress), want)
    on_hands = _port_done(tenv, q, qd, contact, prev_amp, progress)
    assert not on_hands[2:].any(), "a contact body on the ground ended an episode"
    on_run = _port_done(trun, q, qd, contact, prev_amp, progress)
    assert on_run[2:][hand_down[2:]].all(), "HumanoidAMP must end the episodes of a hand on the ground"
