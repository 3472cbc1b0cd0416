"""`train.main` of the port for HumanoidAMP with the AMP learner
(HumanoidAMPPPO.yaml) and with the HRL override
(`train.params.algo.name=hrl_continuous`), on the CPU at a few envs and
narrow widths: train, checkpoint, resume, play."""
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.learn import AMPTrainState
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

SMALL = ["pipeline=cpu", "num_envs=4", "train.params.config.horizon_length=4",
         "train.params.config.minibatch_size=8", "train.params.network.mlp.units=[32,16]"]


def _run(tmp_path, extra, epochs):
    return ttrain.main(["task=HumanoidAMP", *SMALL, *extra, f"max_iterations={epochs}", f"+train_dir={tmp_path}"])


def test_train_main_humanoid_amp(tmp_path):
    """AMP through train.main: 2 epochs write last_HumanoidAMP.pth with the
    discriminator and amp_rms; a resume continues to epoch 3; play runs 32
    short episodes to the task reward of 1 per step."""
    extra = ["train.params.network.disc.units=[32,16]", "train.params.config.amp_minibatch_size=8"]
    ts, m = _run(tmp_path, extra, 2)
    assert isinstance(ts, AMPTrainState) and m["epoch"] == 2 and m["frames"] == 2 * 4 * 4
    assert all(k in m for k in ("disc_acc", "disc_reward_mean")) and m["disc_reward_mean"] > 0.0
    ckpt = tmp_path / "HumanoidAMP" / "nn" / "last_HumanoidAMP.pth"
    saved = load_checkpoint(str(ckpt))
    assert saved["disc"]["disc_logits.weight"].shape == (1, 16) and saved["amp_rms"]["mean"].shape == (210,)
    _, resumed = _run(tmp_path, [*extra, f"checkpoint={ckpt}"], 3)
    assert resumed["epoch"] == 3
    played = ttrain.main(["task=HumanoidAMP", *SMALL, *extra, "test=True", f"checkpoint={ckpt}",
                          "task.env.episodeLength=4"])
    # a reward of 1 per step: the first episodes end at their 3rd step, later
    # ones at their 4th (the reset step counts), early terminations sooner
    assert 1.0 <= played <= 4.0


def test_train_main_hrl_override(tmp_path):
    """HRL through train.main on HumanoidAMP: the high-level policy's
    actions are 8-wide latents, each held for llc_steps=2 env steps of the
    seeded LLC; train 1 epoch, resume to 2, play."""
    extra = ["train.params.algo.name=hrl_continuous", "+train.params.config.llc_steps=2"]
    ts, m = _run(tmp_path, extra, 1)
    assert m["epoch"] == 1 and ts.env_state.progress.shape == (4,)
    ckpt = tmp_path / "HumanoidAMP" / "nn" / "last_HumanoidAMP.pth"
    saved = load_checkpoint(str(ckpt))
    assert saved["params"]["mu.weight"].shape == (8, 16) and "disc" not in saved
    _, resumed = _run(tmp_path, [*extra, f"checkpoint={ckpt}"], 2)
    assert resumed["epoch"] == 2
    played = ttrain.main(["task=HumanoidAMP", *SMALL, *extra, "test=True", f"checkpoint={ckpt}",
                          "task.env.episodeLength=4"])
    assert 0.0 < played <= 2.0  # the mean reward of a macro step is at most 1, two per episode
