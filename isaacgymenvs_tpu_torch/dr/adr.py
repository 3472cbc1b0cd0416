"""Automatic Domain Randomization (port of isaacgymenvs_tpu/dr/adr.py),
OpenAI's Algorithm 1, batched over envs.

Each parameter has a range [lo, hi] that evolves with the performance of
BOUNDARY workers, envs that pin one parameter at one edge of its range:
  * a fraction of the envs (`worker_adr_boundary_fraction`) are boundary
    workers, each of one (parameter, lo|hi) boundary; the others are
    rollout workers that draw every parameter from its range;
  * each boundary collects the objectives of its finished episodes in a
    ring of `adr_queue_threshold_length` slots; once full, its mean decides:
    at or above `adr_objective_threshold_high` the edge widens by `delta`,
    below `adr_objective_threshold_low` it narrows, clamped to `limits`;
    the queue then clears and its workers are assigned anew;
  * the range entropy `nats` (the mean log width) tracks progress.

A parameter with a `range_path` ("actor_params.hand.dof_properties.
damping.range") overrides the range of the domain-randomization spec of
that name (`dr_overrides`), its boundary workers pinned at the edge.

Everything stays on the state's device with fixed shapes, so `update` runs
inside the env step without waiting for the device. The queue push sorts
the finishing boundary envs by boundary (a stable sort, as JAX's argsort
is), ranks each within its group and writes its objective to ring slot
(count + rank) mod Q. Where one step pushes more than Q objectives into one
queue, the last Q in env order stay: the rule of sequential pushes, which
the JAX package leaves to XLA's choice among duplicate scatter indices.

Draws come from a `torch.Generator`; `sample` and `update` also take the
draws themselves (`u`, `fresh_workers`), so that a test can hand over the
JAX package's.

Under a process group the population is global, as the JAX package's
sharding keeps it (ranges, queues and counts replicated, worker modes per
env): `num_envs` is the global count, the state holds the rank's `block`
of the worker assignment, and `update` gathers every rank's worker ids,
done flags and objectives, runs the same update on each rank with the
worker assignments drawn from a stream that is the same on every rank, and
keeps the rank's rows; `lo`, `hi`, `queues`, `counts` and `nats` come out
bit-equal on all ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..device import resolve_device
from ..parallel import distributed, sharding


class AdrParamSpec(NamedTuple):
    name: str
    init_lo: float
    init_hi: float
    limit_lo: float
    limit_hi: float
    delta: float
    delta_style: str  # 'additive' | 'multiplicative'
    # dotted DR path of a physics parameter whose range ADR evolves:
    # "actor_params.hand.dof_properties.damping.range" -> DR spec "hand.dof_properties.damping"
    range_path: str = ""


@dataclasses.dataclass
class AdrState:
    lo: torch.Tensor  # (P,)
    hi: torch.Tensor  # (P,)
    queues: torch.Tensor  # (2P, Q) objective samples
    counts: torch.Tensor  # (2P,) int64 pushes since the last evaluation
    worker_boundary: torch.Tensor  # (N,) int64: -1 rollout, else boundary id in [0, 2P)
    nats: torch.Tensor  # () range entropy

    def as_dict(self) -> Dict[str, torch.Tensor]:
        """The fields by name (what a checkpoint holds)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


class ADR:
    def __init__(self, cfg: Dict[str, Any], num_envs: int, device="cuda", block: Optional[slice] = None):
        self.device = resolve_device(device)
        self.block = slice(0, num_envs) if block is None else block  # the rank's envs
        self.enabled = bool(cfg.get("use_adr", False))
        self.update_ranges = bool(cfg.get("update_adr_ranges", True))
        self.boundary_fraction = float(cfg.get("worker_adr_boundary_fraction", 0.4))
        self.queue_len = int(cfg.get("adr_queue_threshold_length", 256))
        self.t_low = float(cfg.get("adr_objective_threshold_low", 5))
        self.t_high = float(cfg.get("adr_objective_threshold_high", 20))
        self.num_envs = num_envs
        self.specs: List[AdrParamSpec] = []
        for name, p in (cfg.get("params") or {}).items():
            init = p.get("init_range", [0.0, 1.0])
            lim = p.get("limits", [0.0, 1.0])
            self.specs.append(AdrParamSpec(
                name=name, init_lo=float(init[0]), init_hi=float(init[1]), limit_lo=float(lim[0]),
                limit_hi=float(lim[1]), delta=float(p.get("delta", 0.01)),
                delta_style=str(p.get("delta_style", "additive")), range_path=str(p.get("range_path", "") or "")))
        self.P = len(self.specs)
        # range_path params: DR spec name -> param index
        self.dr_params = {}
        for i, spec in enumerate(self.specs):
            if spec.range_path:
                name = spec.range_path
                if name.startswith("actor_params."):
                    name = name[len("actor_params."):]
                if name.endswith(".range"):
                    name = name[: -len(".range")]
                self.dr_params[name] = i
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        self._deltas = f32([s.delta for s in self.specs])
        self._lim_lo = f32([s.limit_lo for s in self.specs])
        self._lim_hi = f32([s.limit_hi for s in self.specs])
        self._mult = torch.tensor([s.delta_style == "multiplicative" for s in self.specs], device=self.device)
        self._pidx = torch.arange(self.P, device=self.device)

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator, workers: Optional[torch.Tensor] = None) -> AdrState:
        """The initial ranges, empty queues and a fresh worker assignment of
        the global population (drawn from `generator`, the same stream on
        every rank, or `workers` (num_envs,) where given), of which the
        state keeps the rank's block."""
        P, Q, dev = self.P, self.queue_len, self.device
        lo = torch.tensor([s.init_lo for s in self.specs], dtype=torch.float32, device=dev)
        hi = torch.tensor([s.init_hi for s in self.specs], dtype=torch.float32, device=dev)
        worker = self._assign_workers(generator) if workers is None else workers.to(dev, torch.int64)
        return AdrState(lo=lo, hi=hi, queues=torch.zeros(2 * P, Q, device=dev),
                        counts=torch.zeros(2 * P, dtype=torch.int64, device=dev), worker_boundary=worker[self.block],
                        nats=self._nats(lo, hi))

    def _nats(self, lo, hi):
        return torch.mean(torch.log(torch.clamp(hi - lo, min=1e-9)))

    def _assign_workers(self, generator: torch.Generator) -> torch.Tensor:
        """(N,) boundary id or -1: a boundary worker with probability
        `boundary_fraction`, of a boundary drawn uniformly."""
        N, P = self.num_envs, self.P
        is_boundary = torch.rand(N, generator=generator, device=self.device) < self.boundary_fraction
        b = torch.randint(0, max(2 * P, 1), (N,), generator=generator, device=self.device)
        return torch.where(is_boundary, b, torch.full_like(b, -1))

    # ------------------------------------------------------------------
    def sample(self, state: AdrState, generator: Optional[torch.Generator], n: int,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n, P) parameter values: rollout workers uniform in [lo, hi]
        (from `u`, uniform in [0, 1), where given); boundary workers pin
        their boundary's parameter at its edge."""
        if u is None:
            u = torch.rand(n, self.P, generator=generator, device=self.device)
        vals = state.lo + u * (state.hi - state.lo)
        wb = state.worker_boundary[:, None]
        is_mine = (wb >= 0) & (torch.div(wb, 2, rounding_mode="floor") == self._pidx[None, :])
        pinned = torch.where((wb % 2) == 1, state.hi[None, :], state.lo[None, :])
        return torch.where(is_mine, pinned, vals)

    # ------------------------------------------------------------------
    def push(self, state: AdrState, done: torch.Tensor, objective: torch.Tensor):
        """(queues, counts) after the boundary workers that finished push
        their objectives: each into its boundary's ring at slot (count +
        rank) mod Q, its rank among the boundary's finishers in env order;
        of more than Q in one step the last Q stay."""
        P, Q, N, dev = self.P, self.queue_len, self.num_envs, self.device
        wb = state.worker_boundary
        is_b = (wb >= 0) & done
        seg = torch.where(is_b, wb, torch.full_like(wb, 2 * P))
        order = torch.argsort(seg, stable=True)
        sseg = seg[order]
        rank = torch.arange(N, device=dev) - torch.searchsorted(sseg, sseg, side="left")
        cnts = torch.zeros(2 * P + 1, dtype=torch.int64, device=dev).index_add_(0, seg, is_b.to(torch.int64))
        # the last Q pushes of a group stay (sequential semantics); the rest,
        # and the envs with nothing to push, go to a spare slot that is dropped
        keep = (sseg < 2 * P) & (rank >= cnts[sseg] - Q)
        slot = (state.counts[torch.clamp(sseg, 0, 2 * P - 1)] + rank) % Q
        flat = torch.where(keep, sseg * Q + slot, torch.full_like(slot, 2 * P * Q))
        ring = torch.cat([state.queues.reshape(-1), state.queues.new_zeros(1)])
        ring = ring.index_put((flat,), objective[order].to(ring.dtype))
        return ring[:-1].reshape(2 * P, Q), state.counts + cnts[:2 * P]

    def update(self, state: AdrState, generator: Optional[torch.Generator], done: torch.Tensor,
               objective: torch.Tensor, fresh_workers: Optional[torch.Tensor] = None) -> AdrState:
        """One step: push the objectives of the boundary workers that
        finished, then evolve the edge of every full queue, clear it and
        reassign its workers (a fresh assignment of the global population,
        drawn from `generator`, the same stream on every rank, or
        `fresh_workers` (num_envs,)). `done` and `objective` are the rank's
        envs'; every rank's are gathered first."""
        if not self.update_ranges or not self.P:
            return state
        P, Q, dev = self.P, self.queue_len, self.device
        if distributed.is_initialized():
            # one gather of the worker ids, the done flags and the objectives, exact in float64
            g = sharding.all_gather_rows(torch.stack(
                [state.worker_boundary.to(torch.float64), done.to(torch.float64), objective.to(torch.float64)], 1))
            done, objective = g[:, 1] > 0, g[:, 2].to(objective.dtype)
            state = dataclasses.replace(state, worker_boundary=g[:, 0].to(torch.int64))
        wb = state.worker_boundary
        is_b = (wb >= 0) & done
        queues, counts = self.push(state, done, objective)

        full = counts >= Q
        mean_perf = torch.sum(queues, dim=1) / Q
        d, mult = self._deltas, self._mult

        def evolve(bound, upper: bool):
            b_idx = self._pidx * 2 + (1 if upper else 0)
            f = full[b_idx]
            perf = mean_perf[b_idx]
            widen = f & (perf >= self.t_high)
            narrow = f & (perf < self.t_low)
            step = d if upper else -d
            widened = torch.where(mult, bound * ((1 + d) if upper else 1 / (1 + d)), bound + step)
            narrowed = torch.where(mult, bound * (1 / (1 + d) if upper else (1 + d)), bound - step)
            out = torch.where(widen, widened, torch.where(narrow, narrowed, bound))
            return torch.minimum(torch.maximum(out, self._lim_lo), self._lim_hi), f

        new_lo, full_lo = evolve(state.lo, upper=False)
        new_hi, full_hi = evolve(state.hi, upper=True)
        new_lo = torch.minimum(new_lo, new_hi - 1e-9)

        # clear the queues that were just evaluated
        cleared = torch.repeat_interleave(full_lo | full_hi, 2) & full
        counts = torch.where(cleared, torch.zeros_like(counts), counts)
        queues = torch.where(cleared[:, None], torch.zeros_like(queues), queues)

        # the workers of an evaluated boundary that just finished take a fresh assignment
        fresh = self._assign_workers(generator) if fresh_workers is None else fresh_workers.to(dev, torch.int64)
        needs_recycle = is_b & cleared[torch.clamp(wb, 0, 2 * P - 1)]
        worker = torch.where(needs_recycle, fresh, wb)
        return AdrState(lo=new_lo, hi=new_hi, queues=queues, counts=counts, worker_boundary=worker[self.block],
                        nats=self._nats(new_lo, new_hi))

    def param_names(self):
        return [s.name for s in self.specs]

    # ------------------------------------------------------------------
    def dr_overrides(self, state: AdrState):
        """{dr_spec_name: {"lo", "hi", "pin_mask", "pin_val"}} for the DR
        engine: the evolving ranges of the range_path params and the per-env
        pins of their boundary workers."""
        out = {}
        wb = state.worker_boundary
        for name, i in self.dr_params.items():
            out[name] = {
                "lo": state.lo[i],
                "hi": state.hi[i],
                "pin_mask": (wb >= 0) & (torch.div(wb, 2, rounding_mode="floor") == i),
                "pin_val": torch.where((wb % 2) == 1, state.hi[i], state.lo[i]),
            }
        return out
