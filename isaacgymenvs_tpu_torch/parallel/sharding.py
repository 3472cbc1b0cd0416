"""Data parallelism over the env axis (port of
isaacgymenvs_tpu/parallel/sharding.py).

The JAX package shards its env axis over a `Mesh(('env',))` and lets XLA
compile the gradient all-reduce into one SPMD program. The port runs one
process per rank (`parallel/distributed.py`), and this module holds what
the mesh did:
  * `env_block`: rank r holds the envs [r N/W, (r+1) N/W) of the global
    `num_envs` N; an N that W does not divide raises (the JAX package runs
    such a case unsharded);
  * `env_state_block` and `train_state_block`: a one-process state cut to
    a rank's block (the counterparts of `env_state_sharding` and
    `train_state_sharding`): per-env leaves are sliced, the population-level
    ones (ADR's ranges and queues, the step counter, the generators) kept;
    `portable_state` and `adopt_state` hand such a state to the ranks;
  * the collectives: `broadcast_params` (rank 0's parameters at init and
    at a restore), `all_reduce_sum_` (the gradient with the minibatch's loss
    terms, before the norm clip), `merge_moments` (the running normalizers'
    batch moments: JAX's `pmean`), `all_gather_rows` (ADR's population) and
    `reduce_metrics`.

Each collective is the identity without a process group, so one process
runs the code it ran before. gloo has no CUDA all_gather, so on CUDA
tensors under gloo `all_gather_rows` goes through the host; its all-reduce
and broadcast take CUDA tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from . import distributed


def env_block(num_envs: int) -> slice:
    """The rank's envs of the global `num_envs`."""
    w, r = distributed.process_count(), distributed.rank()
    if num_envs % w:
        raise ValueError(f"num_envs={num_envs} is not divisible by the {w} ranks of the process group")
    n = num_envs // w
    return slice(r * n, (r + 1) * n)


def _tree(x, fn):
    """`fn` on every tensor of a tensor, tuple (named or not) or dict tree."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        vals = [_tree(v, fn) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return x


def env_rows(x, block: slice, n: int):
    """x cut to `block` along its leading axis where that axis is the env
    axis (length n), leaf by leaf; other leaves kept."""
    return _tree(x, lambda t: t[block] if t.dim() > 0 and t.shape[0] == n else t)


def gather_env_rows(x, n: int):
    """The inverse of `env_rows` over the ranks: every leaf whose leading
    axis is the rank's n envs gathered into the global envs, in rank order;
    other leaves kept. A collective: every rank calls it."""
    return _tree(x, lambda t: all_gather_rows(t) if t.dim() > 0 and t.shape[0] == n else t)


def env_state_block(state, block: slice, n: int):
    """An `EnvState` of n envs cut to `block`: the per-env leaves sliced,
    ADR's worker assignment sliced and its ranges, queues and counts kept,
    the per-env leaves sliced (packed for the kernel: env-last; the eager
    engine's dict: env-leading), the step counter and the generators kept."""
    rows = lambda x: env_rows(x, block, n)
    dyn = state.dyn
    if isinstance(dyn, dict):
        dyn = rows(dyn)
    elif dyn is not None:
        dyn = dyn._replace(rows=dyn.rows[:, block])
    adr = state.adr
    if adr is not None:
        adr = dataclasses.replace(adr, worker_boundary=adr.worker_boundary[block])
    return dataclasses.replace(
        state,
        sim=dataclasses.replace(state.sim, q=state.sim.q[block], qd=state.sim.qd[block]),
        progress=rows(state.progress), reset_buf=rows(state.reset_buf), actions=rows(state.actions),
        task=rows(state.task), dr=rows(state.dr), dyn=dyn, randomize_buf=rows(state.randomize_buf), adr=adr,
    )


def train_state_block(ts, block: slice, n: int):
    """A `PPOTrainState` of n envs cut to `block`: the env state, the last
    observation, the episode sums, the privileged states and the recurrent
    carry; the normalizers, the optimizer and the generators kept."""
    rows = lambda x: env_rows(x, block, n)
    return dataclasses.replace(
        ts, env_state=env_state_block(ts.env_state, block, n), obs=rows(ts.obs), ep_return=rows(ts.ep_return),
        ep_len=rows(ts.ep_len), states=rows(ts.states), ep_cum=rows(ts.ep_cum), carry=rows(ts.carry),
    )


def portable_state(agent, ts) -> dict:
    """A one-process train state as ranks can take it (`adopt_state`): the
    agent's trainable parameters by name and the state without its
    generators and optimizer."""
    env_state = dataclasses.replace(ts.env_state, rng=None, shared_rng=None)
    return {"trainables": {n: p.detach().clone() for n, p in agent.named_trainables()},
            "ts": dataclasses.replace(ts, env_state=env_state, generator=None, shuffle_generator=None,
                                      optimizer=None)}


def adopt_state(agent, saved: dict, num_envs: int):
    """The rank's block of a `portable_state` of `num_envs` envs, with the
    rank's own generators and a fresh optimizer over `agent`'s parameters,
    which take the saved values."""
    fresh = agent.init()
    with torch.no_grad():
        for n, p in agent.named_trainables():
            p.copy_(saved["trainables"][n])
    ts = train_state_block(saved["ts"], agent.env.env_block, num_envs)
    env_state = dataclasses.replace(ts.env_state, rng=fresh.env_state.rng, shared_rng=fresh.env_state.shared_rng)
    return dataclasses.replace(ts, env_state=env_state, generator=fresh.generator,
                               shuffle_generator=fresh.shuffle_generator, optimizer=fresh.optimizer)


# ---- collectives ----------------------------------------------------------------


@torch.no_grad()
def broadcast_params(params: Sequence[torch.Tensor]) -> None:
    """Rank 0's values into `params` on every rank."""
    if not distributed.is_initialized():
        return
    for p in params:
        dist.broadcast(p.data, src=0)


def all_reduce_sum_(flat: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `flat`, in place."""
    if distributed.is_initialized():
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return flat


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' `x` (equal shapes) one after another along the leading
    axis, in rank order."""
    if not distributed.is_initialized():
        return x
    if x.dtype == torch.bool:
        return all_gather_rows(x.to(torch.uint8)).bool()
    if x.is_cuda and distributed.backend() == "gloo":  # gloo gathers host tensors only
        return all_gather_rows(x.cpu()).to(x.device)
    parts = [torch.empty_like(x) for _ in range(distributed.process_count())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def merge_moments(mean: torch.Tensor, var: torch.Tensor, count: float):
    """The (mean, var, count) of the global batch from each rank's block's
    moments, merged in rank order by the parallel Welford rule (the same
    result on every rank)."""
    if not distributed.is_initialized():
        return mean, var, count
    vec = torch.cat([mean.reshape(-1), var.reshape(-1), mean.new_tensor([float(count)])])
    g = all_gather_rows(vec[None])
    k = mean.numel()
    m, v, c = g[0, :k], g[0, k:2 * k], g[0, 2 * k]
    for r in range(1, g.shape[0]):
        mr, vr, cr = g[r, :k], g[r, k:2 * k], g[r, 2 * k]
        delta = mr - m
        tot = c + cr
        m, v, c = m + delta * cr / tot, (v * c + vr * cr + delta * delta * c * cr / tot) / tot, tot
    return m.reshape(mean.shape), v.reshape(var.shape), float(c)


def batch_moments(batch: torch.Tensor, d: int = 0):
    """(mean, var, count) of `batch` over all leading axes but its last
    `d`, over the global batch where a process group splits it."""
    red = tuple(range(batch.dim() - d))
    mean = torch.mean(batch, dim=red)
    var = torch.var(batch, dim=red, unbiased=False)
    return merge_moments(mean, var, batch.numel() / max(mean.numel(), 1))


_REDUCE = {"sum": torch.sum, "mean": torch.mean, "min": torch.amin, "max": torch.amax}


def reduce_metrics(values: Dict[str, torch.Tensor], ops: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """Scalar metrics of each rank's block reduced over the ranks, by name:
    `ops[name]` is 'sum', 'mean', 'min' or 'max' (the blocks are of equal
    size, so a mean of the ranks' means is the global mean). One gather of
    all of them, in float64."""
    if not distributed.is_initialized():
        return values
    keys = sorted(values)
    dev = next(v.device for v in values.values() if isinstance(v, torch.Tensor))
    vec = torch.stack([torch.as_tensor(values[k], device=dev).to(torch.float64).reshape(()) for k in keys])
    g = all_gather_rows(vec[None])
    return {k: _REDUCE[ops[k]](g[:, i]) for i, k in enumerate(keys)}


@dataclasses.dataclass
class RowShare:
    """The rank's part of one global minibatch: `total` rows in all, the
    rank's at the minibatch positions `pos` (ascending). A loss divides its
    sums by the global count, and terms of the parameters alone are added
    on the rank with `owner` set."""

    total: int
    pos: torch.Tensor
    owner: bool

    def first(self, k: int) -> int:
        """How many of the rank's rows lie among the minibatch's first k."""
        return int((self.pos < k).sum())

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's share of the mean over the global minibatch of x
        (rows leading): its sum over the global element count."""
        return torch.sum(x) / (self.total * math.prod(x.shape[1:]))
