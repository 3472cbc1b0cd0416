"""Launching a population: many training commands, locally or on Slurm
(port of isaacgymenvs_tpu/pbt/launcher.py).

A parameter grid expands into one command line per policy. `run_local`
runs them as processes beside each other, at most `max_parallel` at once
(on one GPU the members share the card); `run_slurm` writes one sbatch
script per command and submits it. The members coordinate only through
their shared `train_dir`, so a population may span hosts on shared
storage. A population of the port runs

    launcher.run_local(RunDescription("ant_pbt", [Experiment("ant", TRAIN_CMD + " task=Ant pbt=pbt_default "
        "pbt.num_policies=2", ParamGrid([("pbt.policy_idx", [0, 1])]).generate_params())]))
"""
from __future__ import annotations

import itertools
import os
import random
import shlex
import subprocess
import sys
import time
from typing import Dict, Iterable, List, Sequence, Tuple

# the port's training entry point, as the head of an experiment's command
TRAIN_CMD = "-m isaacgymenvs_tpu_torch.train"


class ParamGrid:
    """The product of named value lists, one dict per combination."""

    def __init__(self, grid_tuples: Sequence[Tuple[str, Iterable]]):
        self.grid = list(grid_tuples)

    def generate_params(self, randomize: bool = False) -> List[Dict]:
        names = [n for n, _ in self.grid]
        combos = list(itertools.product(*[list(v) for _, v in self.grid]))
        if randomize:
            random.shuffle(combos)
        return [dict(zip(names, c)) for c in combos]


class Experiment:
    def __init__(self, name: str, cmd: str, param_generator: Iterable[Dict]):
        self.name = name
        self.cmd = cmd
        self.params = list(param_generator)

    def generate_experiments(self):
        for i, p in enumerate(self.params):
            args = " ".join(f"{k}={v}" for k, v in p.items())
            yield f"{self.name}_{i:02d}", f"{self.cmd} {args}"


class RunDescription:
    def __init__(self, run_name: str, experiments: Sequence[Experiment]):
        self.run_name = run_name
        self.experiments = list(experiments)


def run_local(
    run: RunDescription,
    max_parallel: int = 4,
    train_dir: str = "runs",
    python: str = sys.executable,
) -> int:
    """Run every experiment's command as a local process, at most
    `max_parallel` at once, each with its output in
    <train_dir>/<run_name>/<name>.log. Returns the number that failed."""
    queue: List[Tuple[str, str]] = []
    for exp in run.experiments:
        queue.extend(exp.generate_experiments())
    running: List[Tuple[str, subprocess.Popen]] = []
    failures = 0
    logdir = os.path.join(train_dir, run.run_name)
    os.makedirs(logdir, exist_ok=True)
    while queue or running:
        while queue and len(running) < max_parallel:
            name, cmd = queue.pop(0)
            with open(os.path.join(logdir, f"{name}.log"), "w") as log:
                proc = subprocess.Popen([python] + shlex.split(cmd), stdout=log, stderr=subprocess.STDOUT)
            running.append((name, proc))
            print(f"[launcher] started {name}: {cmd}")
        still = []
        for name, proc in running:
            rc = proc.poll()
            if rc is None:
                still.append((name, proc))
            else:
                print(f"[launcher] {name} finished rc={rc}")
                failures += rc != 0
        running = still
        time.sleep(2.0)
    return failures


SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --output={logdir}/{name}.log
#SBATCH --nodes=1
#SBATCH --ntasks=1
#SBATCH --cpus-per-task={cpus}
{extra_directives}
{setup}
srun {python} {cmd}
"""


def run_slurm(
    run: RunDescription,
    train_dir: str = "runs",
    python: str = sys.executable,
    cpus_per_task: int = 16,
    partition: str = "",
    time_limit: str = "",
    setup: str = "",
    sbatch: str = "sbatch",
    submit: bool = True,
) -> List[str]:
    """One sbatch script per experiment command, under
    <train_dir>/<run_name>/, submitted with `sbatch` unless `submit=False`.
    Returns the scripts' paths."""
    logdir = os.path.join(train_dir, run.run_name)
    os.makedirs(logdir, exist_ok=True)
    extra = []
    if partition:
        extra.append(f"#SBATCH --partition={partition}")
    if time_limit:
        extra.append(f"#SBATCH --time={time_limit}")
    scripts = []
    for exp in run.experiments:
        for name, cmd in exp.generate_experiments():
            script = SBATCH_TEMPLATE.format(
                name=name,
                logdir=logdir,
                cpus=cpus_per_task,
                extra_directives="\n".join(extra),
                setup=setup,
                python=python,
                cmd=cmd,
            )
            path = os.path.join(logdir, f"{name}.sbatch")
            with open(path, "w") as f:
                f.write(script)
            scripts.append(path)
            if submit:
                subprocess.check_call([sbatch, path])
                print(f"[launcher] submitted {name} via {sbatch}")
    return scripts
