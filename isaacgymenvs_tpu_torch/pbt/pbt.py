"""Population-based training, coordinated through a shared directory
(port of isaacgymenvs_tpu/pbt/pbt.py).

Each policy's process writes <workspace>/policy_<idx:02d>/<iteration:06d>.yaml
(its frames, objective, mutable params and the path of its weights file)
after each epoch that closes an interval, reads the newest record of every
policy, ranks them by objective and, when it is among the worst
`replace_fraction_worst` and trails the best by more than
max(frac_std * sigma, frac_abs * |best|), restarts from a random top
policy's weights with mutated hyperparameters. A worst policy within the
threshold restarts from its own weights with mutated hyperparameters.
Every filesystem step is fault-tolerant: a failure skips the PBT step and
training goes on. The sigma of the threshold is taken over the objectives
without the lowest eighth, so that crashed policies do not freeze the
population.

The directory names and yaml keys are the JAX package's, so either package
reads a workspace the other wrote. The weights file is this package's own
checkpoint (`learn.PPO.save`).
"""
from __future__ import annotations

import os
import random
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import yaml

from .mutation import mutate


def _safe(fn, default=None):
    try:
        return fn()
    except Exception:
        return default


class PbtManager:
    """One policy's side of the population. `rng` (a `random.Random`) makes
    every draw: the donor, the choice of params and the mutations."""

    def __init__(
        self,
        workspace: str,
        policy_idx: int,
        num_policies: int,
        params_to_mutate: Dict[str, str],
        mutation_rate: float = 0.15,
        change_min: float = 1.1,
        change_max: float = 1.5,
        interval_steps: int = 10_000_000,
        start_after: int = 10_000_000,
        initial_delay: int = 20_000_000,
        replace_fraction_worst: float = 0.125,
        replace_fraction_best: float = 0.3,
        threshold_frac_std: float = 0.5,
        threshold_frac_abs: float = 0.05,
        dbg_mode: bool = False,
        rng: Optional[random.Random] = None,
    ):
        self.workspace = workspace
        self.policy_idx = int(policy_idx)
        self.num_policies = int(num_policies)
        self.params_to_mutate = dict(params_to_mutate)
        self.mutation_rate = mutation_rate
        self.change_min = change_min
        self.change_max = change_max
        self.interval_steps = int(interval_steps)
        self.start_after = int(start_after)
        self.initial_delay = int(initial_delay)
        self.replace_fraction_worst = replace_fraction_worst
        self.replace_fraction_best = replace_fraction_best
        self.threshold_frac_std = threshold_frac_std
        self.threshold_frac_abs = threshold_frac_abs
        self.dbg_mode = dbg_mode
        self.rng = rng if rng is not None else random.Random()
        self.session_start_frames: Optional[int] = None
        self.last_iteration = -1
        os.makedirs(self._dir(self.policy_idx), exist_ok=True)

    # ---- the filesystem protocol ----------------------------------------
    def _dir(self, idx: int) -> str:
        return os.path.join(self.workspace, f"policy_{idx:02d}")

    def save_checkpoint(self, frames: int, objective: float, params: Dict[str, Any], weights_path: str) -> None:
        """Write <iteration:06d>.yaml, this policy's record at `frames`,
        through a temporary file moved into place."""
        iteration = frames // self.interval_steps
        meta = {
            "iteration": int(iteration),
            "frames": int(frames),
            "true_objective": float(objective),
            "params": params,
            "checkpoint": os.path.abspath(weights_path),
            "timestamp": time.time(),
        }
        path = os.path.join(self._dir(self.policy_idx), f"{iteration:06d}.yaml")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            yaml.safe_dump(meta, f)
        os.replace(tmp, path)

    def _load_population(self, iteration: int) -> List[Optional[Dict]]:
        """Each policy's newest record at or before `iteration` (None where
        it has none or it cannot be read)."""
        out: List[Optional[Dict]] = []
        for idx in range(self.num_policies):
            d = self._dir(idx)
            best = None
            for fn in reversed(_safe(lambda: sorted(os.listdir(d)), []) or []):
                if not fn.endswith(".yaml"):
                    continue
                it = _safe(lambda: int(fn.split(".")[0]), None)
                if it is None or it > iteration:
                    continue
                best = _safe(lambda: yaml.safe_load(open(os.path.join(d, fn))))
                break
            out.append(best)
        return out

    # ---- the decision ---------------------------------------------------
    def maybe_evolve(
        self, frames: int, objective: float, params: Dict[str, Any], weights_path: str
    ) -> Optional[Tuple[Dict[str, Any], Optional[str]]]:
        """Call after each epoch. Returns None (keep training) or
        (mutated params, the weights file to load or None) when this policy
        should restart."""
        if self.session_start_frames is None:
            self.session_start_frames = frames
        iteration = frames // self.interval_steps
        if iteration <= self.last_iteration:
            return None
        self.last_iteration = iteration

        _safe(lambda: self.save_checkpoint(frames, objective, params, weights_path))

        # warm-up gates: start_after from the start of each session, initial_delay from the first frame
        if frames - self.session_start_frames < self.start_after and not self.dbg_mode:
            return None
        if frames < self.initial_delay and not self.dbg_mode:
            return None

        pop = self._load_population(iteration)
        objectives = [(i, p["true_objective"]) for i, p in enumerate(pop) if p is not None]
        if len(objectives) < max(2, self.num_policies // 2) and not self.dbg_mode:
            return None
        objectives.sort(key=lambda t: t[1])
        ranked = [i for i, _ in objectives]
        values = np.asarray([v for _, v in objectives])

        n_worst = max(1, round(self.replace_fraction_worst * self.num_policies))
        n_best = max(1, round(self.replace_fraction_best * self.num_policies))
        worst = ranked[:n_worst]
        best = ranked[-n_best:]

        if self.policy_idx not in worst and not self.dbg_mode:
            return None  # a policy that is doing fine is left alone

        trimmed = values[max(0, len(values) // 8):]
        sigma = float(np.std(trimmed)) if len(trimmed) > 1 else 0.0
        best_obj = float(values[-1])
        threshold = max(self.threshold_frac_std * sigma, self.threshold_frac_abs * abs(best_obj))
        donor = self.rng.choice(best)
        if best_obj - objective <= threshold and not self.dbg_mode:
            # within the threshold a worst policy still mutates, from its own weights
            donor = self.policy_idx
        donor_meta = pop[donor]
        if donor_meta is None:
            return None
        # half the time the donor's params are mutated, else this policy's own
        src_params = donor_meta.get("params", params) if self.rng.random() < 0.5 else params
        new_params = mutate(
            src_params, self.params_to_mutate, self.mutation_rate, self.change_min, self.change_max, self.rng
        )
        weights = donor_meta.get("checkpoint") if donor != self.policy_idx else None
        if weights is not None and not os.path.exists(weights):
            weights = None
        print(
            f"[pbt] policy {self.policy_idx}: objective {objective:.2f} trails best {best_obj:.2f} "
            f"(thr {threshold:.2f}); adopting policy {donor} weights + mutated params"
        )
        # a restart begins a new session: start_after counts from here
        self.session_start_frames = frames
        return new_params, weights
