"""`train.main` with `pbt=pbt_default` on the CPU: one member alone, and
two members of one population run one after the other into one
workspace, the second handicapped, so that it adopts the first's weights.
"""
import os

import torch
import yaml

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.learn import PPO
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

# Cartpole at 4 envs: 16 env steps per epoch, every episode over within one epoch
BASE = ["task=Cartpole", "pipeline=cpu", "num_envs=4", "task.env.episodeLength=16", "max_iterations=6",
        "pbt=pbt_default"]
# an interval, a warm-up and a delay of one epoch's frames; any gap to the best is a reason to adopt
POP = ["pbt.num_policies=2", "pbt.interval_steps=64", "pbt.start_after=64", "pbt.initial_delay=64",
       "pbt.replace_threshold_frac_std=0", "pbt.replace_threshold_frac_absolute=0", "pbt.mutation_rate=1.0"]


def _count_epochs(monkeypatch):
    calls = []
    epoch = PPO.train_epoch

    def counted(self, *a, **k):
        calls.append(1)
        return epoch(self, *a, **k)

    monkeypatch.setattr(PPO, "train_epoch", counted)
    return calls


def _records(policy_dir):
    return [yaml.safe_load(open(os.path.join(policy_dir, f)))
            for f in sorted(os.listdir(policy_dir)) if f.endswith(".yaml")]


def test_train_main_pbt_one_member(tmp_path, monkeypatch):
    """The override `pbt=pbt_default` trains: records and weights in the
    workspace, one per epoch with finished episodes; a population of one
    never evolves."""
    calls = _count_epochs(monkeypatch)
    ts, metrics = ttrain.main(BASE + ["pbt.interval_steps=64", f"+train_dir={tmp_path}"])
    assert len(calls) == 6 and metrics["epoch"] == 6
    pdir = tmp_path / "Cartpole_pbt_workspace" / "policy_00"
    recs = _records(pdir)
    assert [r["iteration"] for r in recs] == [1, 2, 3, 4, 5, 6]
    assert all(r["checkpoint"] == str(pdir / "weights.pth") for r in recs)
    assert set(recs[0]["params"]) == {k for k in yaml.safe_load(open(
        os.path.join(os.path.dirname(ttrain.__file__), "cfg", "pbt", "mutation", "default_mutation.yaml")))}
    assert load_checkpoint(str(pdir / "weights.pth"))["frames"] == 6 * 64
    assert not [f for f in os.listdir(pdir) if f.startswith("restart_")]


def test_two_members_the_trailing_one_adopts(tmp_path, monkeypatch):
    ttrain.main(BASE + POP + ["pbt.policy_idx=0", f"+train_dir={tmp_path}"])
    ws = tmp_path / "Cartpole_pbt_workspace"
    donor = ws / "policy_00" / "weights.pth"
    donor_bytes = donor.read_bytes()
    # the second member loses its episodes as soon as the cart moves 5 cm
    calls = _count_epochs(monkeypatch)
    ttrain.main(BASE + POP + ["pbt.policy_idx=1", "task.env.resetDist=0.05", f"+train_dir={tmp_path}"])
    assert len(calls) == 6, "max_iterations counts the epochs of every session"
    pdir = ws / "policy_01"
    restarts = sorted(f for f in os.listdir(pdir) if f.startswith("restart_") and not f.endswith("_restored.pth"))
    assert restarts, "the trailing member never restarted"
    # the first restart read the donor's weights file; the restored state equals it bit for bit
    first = restarts[0][: -len(".pth")]
    assert (pdir / f"{first}.pth").read_bytes() == donor_bytes
    want, got = load_checkpoint(str(donor)), load_checkpoint(str(pdir / f"{first}_restored.pth"))
    for key in ("params", "obs_rms", "value_rms"):
        assert want[key].keys() == got[key].keys()
        for k in want[key]:
            assert torch.equal(want[key][k], got[key][k]), (key, k)
    for i, st in want["opt_state"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, got["opt_state"]["state"][i][k]), ("opt_state", i, k)
    assert got["lr"] == want["lr"]
    # the records after the first restart hold mutated params inside their bounds
    recs = _records(pdir)
    before = [r for r in recs if r["iteration"] < int(first.split("_")[1])][-1]
    after = [r for r in recs if r["iteration"] > int(first.split("_")[1])]
    assert after, "no record after the restart"
    new = after[0]["params"]
    assert new != before["params"]
    assert 0.01 <= new["train.params.config.e_clip"] <= 0.3
    assert 1 <= new["train.params.config.mini_epochs"] <= 8
    assert 0.9 < new["train.params.config.gamma"] < 1.0 and 0.9 < new["train.params.config.tau"] < 1.0
