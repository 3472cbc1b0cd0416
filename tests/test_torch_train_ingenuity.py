"""`train.main task=Ingenuity pipeline=cpu`: train, checkpoint, resume and play
(split out of tests/test_torch_train.py so that test workers share the
train tests)."""
import pytest
from test_torch_train import train_main_resume_play


@pytest.mark.parametrize("task", ["Ingenuity"])
def test_train_main_procedural_tasks(tmp_path, capsys, task):
    """`train.main task=<name> pipeline=cpu` at 16 envs: two epochs with a
    checkpoint each, a resume for a third, and play from the checkpoint."""
    train_main_resume_play(tmp_path, capsys, task, horizon=16)
