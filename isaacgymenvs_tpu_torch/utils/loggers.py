"""Metric logging: TensorBoard + optional W&B (port of
isaacgymenvs_tpu/utils/loggers.py).

TensorBoard scalars go under <train_dir>/<run>/summaries with the rl_games
scalar names the trainer passes in. Weights & Biases is off unless
`wandb_activate` is set, and is best-effort: no network is assumed.
Under a process group only rank 0 logs (`build_logger` gives the other
ranks None).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

from ..parallel import distributed


class TensorBoardLogger:
    """Writes scalars via torch.utils.tensorboard; silent when the
    tensorboard package is missing."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._w = None
        else:
            self._w = SummaryWriter(logdir)

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if self._w is None:
            return
        for k, v in metrics.items():
            try:
                self._w.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


class WandbLogger:
    """Best-effort W&B logging."""

    def __init__(self, project: str, name: str, group: str = "", entity: str = "", cfg=None):
        self._run = None
        try:
            import wandb

            self._run = wandb.init(
                project=project, name=name,
                group=group or None, entity=entity or None,
                config=cfg, resume="allow",
            )
        except Exception as exc:  # no package, no network, no login: train without it
            print(f"wandb disabled: {exc!r}")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if self._run is not None:
            self._run.log(dict(metrics), step=step)

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()


class MultiLogger:
    """Fan-out to every logger that is on."""

    def __init__(self, *loggers):
        self.loggers = [l for l in loggers if l is not None]

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        for l in self.loggers:
            l.log(metrics, step)

    def close(self) -> None:
        for l in self.loggers:
            l.close()


def build_logger(cfg: Dict[str, Any], run_name: str, train_dir: str = "runs") -> Optional[MultiLogger]:
    """The run's loggers on rank 0; None on the other ranks."""
    if not distributed.is_main_process():
        return None
    loggers = [TensorBoardLogger(os.path.join(train_dir, run_name, "summaries"))]
    if cfg.get("wandb_activate"):
        loggers.append(
            WandbLogger(
                project=str(cfg.get("wandb_project", "isaacgymenvs_tpu")),
                name=str(cfg.get("wandb_name", run_name)),
                group=str(cfg.get("wandb_group", "")),
                entity=str(cfg.get("wandb_entity", "")),
                cfg=cfg,
            )
        )
    return MultiLogger(*loggers)
