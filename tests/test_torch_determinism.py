"""Reproducibility of the port (the counterpart of tests/test_determinism.py):
the same seed gives bitwise-identical env rollouts and training updates,
another seed another trajectory. PPO, recurrent PPO and SAC updates are
checked; the random streams are `torch.Generator`s seeded from the seed."""
import numpy as np
import torch

from isaacgymenvs_tpu_torch.learn import PPO, SAC, PPORecurrent
from isaacgymenvs_tpu_torch.tasks import task_map

torch.set_num_threads(1)


def _rollout(seed, steps=20):
    cfg = {"env": {"numEnvs": 8, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    env = task_map["Ant"](cfg, device="cpu")
    state, obs = env.reset(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    traj = []
    for _ in range(steps):
        state, obs, rew, done, _ = env.step(state, torch.rand(8, 8, generator=gen) * 2 - 1)
        traj.append(torch.cat([obs, rew[:, None]], -1))
    return torch.stack(traj), state.sim.q


def test_trajectories_bitwise_reproducible():
    t1, q1 = _rollout(7)
    t2, q2 = _rollout(7)
    assert torch.equal(t1, t2) and torch.equal(q1, q2)  # bitwise
    t3, _ = _rollout(8)
    assert not torch.equal(t1, t3)  # seeds actually matter


def _train(cls, seed, train, epochs=2):
    cfg = {"env": {"numEnvs": 16, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    agent = cls(task_map["Cartpole"](cfg, device="cpu"), train, seed=seed)
    ts = agent.init()
    for _ in range(epochs):
        ts, metrics = agent.train_epoch(ts)
    modules = [agent.actor, agent.critic, agent.target] if cls is SAC else [agent.network]
    return [p.detach().clone() for m in modules for p in m.state_dict().values()], metrics


def test_training_update_bitwise_reproducible():
    """Two PPO epochs (tests/test_determinism.py's settings), two recurrent
    PPO epochs and two SAC epochs: parameters and metrics equal bit for bit
    for one seed, the parameters differ for another."""
    cases = [
        (PPO, {"network": {"mlp": {"units": [16]}},
               "config": {"horizon_length": 4, "minibatch_size": 64, "mini_epochs": 2}}),
        (PPORecurrent, {"network": {"mlp": {"units": [16]}, "rnn": {"units": 16, "before_mlp": False}},
                        "config": {"horizon_length": 8, "minibatch_size": 32, "mini_epochs": 2, "seq_length": 4}}),
        (SAC, {"network": {"mlp": {"units": [16, 16]}},
               "config": {"batch_size": 32, "num_steps_per_episode": 4, "num_warmup_steps": 2,
                          "num_seed_steps": 1, "replay_buffer_size": 256}}),
    ]
    for cls, train in cases:
        (p1, m1), (p2, m2), (p3, _) = (_train(cls, s, train) for s in (3, 3, 4))
        assert m1 == m2 and all(torch.equal(a, b) for a, b in zip(p1, p2, strict=True)), cls.__name__
        assert any(not torch.equal(a, b) for a, b in zip(p1, p3)), cls.__name__
        assert all(np.isfinite(v) for v in m1.values() if not isinstance(v, str)), cls.__name__
