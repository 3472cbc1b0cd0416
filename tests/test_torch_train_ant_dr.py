"""`train.main task=Ant task.randomize=True pipeline=cpu` (split out of
tests/test_torch_train.py so that test workers share the train tests)."""
import numpy as np

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint


def test_train_main_ant_with_domain_randomization(tmp_path, capsys):
    """`task=Ant task.randomize=True pipeline=cpu`: two epochs, a resume and
    play. The checkpoint carries no DR sample (as in the JAX package): a
    restored run draws its own at reset. The trainer reports its frame count
    to the env every epoch."""
    run = ["task=Ant", "task.randomize=True", "pipeline=cpu", "num_envs=16", f"+train_dir={tmp_path}",
           "train.params.config.minibatch_size=128"]
    ts, metrics = ttrain.main([*run, "max_iterations=2"])
    assert metrics["epoch"] == 2 and metrics["frames"] == 2 * 16 * 16
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    st = ts.env_state
    assert st.dyn.names == ("dof_damping", "dof_stiffness", "dof_limit_lower", "dof_limit_upper", "body_mass")
    assert st.dyn.rows.shape == (65, 16) and int(st.frames) == 32 and st.randomize_buf.tolist() == [32] * 16
    mass = st.dr["ant.rigid_body_properties.mass"]
    assert float(mass.min()) >= 0.5 and float(mass.max()) <= 1.5 and float(mass.std()) > 0.1
    last = str(tmp_path / "Ant" / "nn" / "last_Ant.pth")
    ck = load_checkpoint(last)
    assert set(ck) == {"params", "obs_rms", "value_rms", "lr", "opt_state", "epoch", "frames", "env_task_state"}
    _, resumed = ttrain.main([*run, "max_iterations=3", f"checkpoint={last}"])
    assert resumed["epoch"] == 3
    mean_ret = ttrain.main([*run, "test=True", f"checkpoint={last}"])
    assert np.isfinite(mean_ret) and "played" in capsys.readouterr().out
