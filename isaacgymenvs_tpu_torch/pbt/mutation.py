"""PBT hyperparameter mutation (port of isaacgymenvs_tpu/pbt/mutation.py).

A float is multiplied or divided by U[change_min, change_max], with clamps
for e_clip, mini_epochs and the discount factors; a mutation scheme is a
yaml mapping of config path -> function name (cfg/pbt/mutation/*.yaml).

Every draw comes from the `rng` argument, a `random.Random`: a caller that
seeds it gets the same values as the JAX package's functions under
`random.seed` of the same seed, which draw from the module-level `random`.
"""
from __future__ import annotations

import copy
import random
from typing import Any, Dict


def mutate_float(x, change_min=1.1, change_max=1.5, *, rng: random.Random):
    perturb = rng.uniform(change_min, change_max)
    return x / perturb if rng.random() < 0.5 else x * perturb


def mutate_float_min_1(x, *, rng: random.Random, **kwargs):
    return max(1.0, mutate_float(x, rng=rng, **kwargs))


def mutate_eps_clip(x, *, rng: random.Random, **kwargs):
    return min(0.3, max(0.01, mutate_float(x, rng=rng, **kwargs)))


def mutate_mini_epochs(x, *, rng: random.Random, **kwargs):
    new = x + 1 if rng.random() < 0.5 else x - 1
    return int(min(8, max(1, new)))


def mutate_discount(x, *, rng: random.Random, **kwargs):
    """Mutate 1 - gamma, by a factor of at most 1.2."""
    return 1.0 - mutate_float(1.0 - x, change_min=1.1, change_max=1.2, rng=rng)


_FUNCS = {
    "mutate_float": mutate_float,
    "mutate_float_min_1": mutate_float_min_1,
    "mutate_eps_clip": mutate_eps_clip,
    "mutate_mini_epochs": mutate_mini_epochs,
    "mutate_discount": mutate_discount,
}


def get_mutation_func(name: str):
    return _FUNCS[name]


def mutate(
    params: Dict[str, Any],
    mutations: Dict[str, str],
    mutation_rate: float,
    change_min: float,
    change_max: float,
    rng: random.Random,
) -> Dict[str, Any]:
    """A copy of `params` in which each entry is mutated with probability
    `mutation_rate`, by the function `mutations` names for it."""
    out = copy.deepcopy(params)
    for param, value in params.items():
        if rng.random() > mutation_rate:
            continue
        if isinstance(value, str):
            # YAML 1.1 parses bare scientific notation (3e-4) as a string
            try:
                value = float(value)
            except ValueError:
                continue
        fn = get_mutation_func(mutations[param])
        out[param] = fn(value, change_min=change_min, change_max=change_max, rng=rng)
    return out
