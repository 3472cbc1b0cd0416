"""Domain randomization (port of isaacgymenvs_tpu/dr/randomize.py).

The YAML schema is the reference's: groups `observations` / `actions` /
`sim_params` / `actor_params` with `range`, `operation` (additive |
scaling), `distribution` (uniform | loguniform | gaussian), `schedule`
(constant | linear) + `schedule_steps`, a per-reset `frequency` gate and
`setup_only`.

Randomization is a data transform: a sample is a dict name -> (num_envs,
*leaf.shape) of factors or offsets drawn at reset; `batched_model` applies
it to the model's leaves and returns them per env as tensors, which the
fused physics step takes as its `dyn` input. Observation and action noise
are drawn every step.

Randomness comes from an explicit `torch.Generator` on the randomizer's
device. Every draw is split in two: the base draw (`_base_draw`: a standard
normal or a uniform [0, 1) tensor) and the transform (`_transform`: range,
distribution, operation, schedule), so that a test can put another
package's base draw through this transform.

`sample(adr=)` takes the ranges that ADR (`dr/adr.py`) evolves for the
specs it names, and pins its boundary workers' envs at a range edge.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..model.spec import Model

# YAML property path -> Model leaf name
_ACTOR_PARAM_MAP = {
    ("rigid_body_properties", "mass"): "body_mass",
    ("rigid_body_properties", "inertia"): "body_inertia",
    ("dof_properties", "damping"): "dof_damping",
    ("dof_properties", "stiffness"): "dof_stiffness",
    ("dof_properties", "lower"): "dof_limit_lower",
    ("dof_properties", "upper"): "dof_limit_upper",
    ("dof_properties", "armature"): "armature",
    ("dof_properties", "effort"): "dof_max_effort",
    ("dof_properties", "friction"): "dof_friction",  # Coulomb joint friction
    ("rigid_shape_properties", "friction"): "cpoint_friction",
    ("rigid_shape_properties", "restitution"): "cpoint_restitution",
    ("tendon_properties", "stiffness"): "tendon_stiffness",
    ("tendon_properties", "damping"): "tendon_damping",
}
# leaves an actor-scale spec batches
_SCALED_LEAVES = ("cpoint_pos", "geom_size", "body_ipos", "body_mass", "body_inertia")


class DRSpec(NamedTuple):
    name: str  # unique key in the sample dict
    leaf: Optional[str]  # Model leaf name; None for obs/action/gravity specs
    lo: float
    hi: float
    operation: str  # 'additive' | 'scaling'
    distribution: str  # 'uniform' | 'loguniform' | 'gaussian'
    schedule: str  # 'constant' | 'linear'
    schedule_steps: float
    setup_only: bool
    actor: Optional[str] = None  # actor name the spec is scoped to
    # correlated-noise component of obs/action specs: a per-env draw held
    # fixed between re-randomizations (reference range_correlated)
    corr_lo: float = 0.0
    corr_hi: float = 0.0


def _spec_from_dict(name: str, leaf: Optional[str], d: Dict[str, Any], actor: Optional[str] = None) -> DRSpec:
    rng = d.get("range", [0.0, 1.0])
    corr = d.get("range_correlated", [0.0, 0.0])
    return DRSpec(
        name=name,
        leaf=leaf,
        lo=float(rng[0]),
        hi=float(rng[1]),
        corr_lo=float(corr[0]),
        corr_hi=float(corr[1]),
        operation=str(d.get("operation", "additive")),
        distribution=str(d.get("distribution", "uniform")),
        schedule=str(d.get("schedule", "constant")),
        schedule_steps=float(d.get("schedule_steps", 1.0)),
        setup_only=bool(d.get("setup_only", False)),
        actor=actor,
    )


def _identity_value(spec: DRSpec) -> float:
    return 1.0 if spec.operation == "scaling" else 0.0


def _base_draw(spec: DRSpec, generator: torch.Generator, shape) -> torch.Tensor:
    """The raw random tensor of one spec: standard normal for a gaussian
    spec, uniform in [0, 1) otherwise, on the generator's device."""
    draw = torch.randn if spec.distribution == "gaussian" else torch.rand
    return draw(tuple(shape), generator=generator, device=generator.device)


def _transform(spec: DRSpec, base: torch.Tensor, sched_scale, lo=None, hi=None) -> torch.Tensor:
    """Base draw -> the spec's factor or offset.

    The schedule interpolates from identity toward full strength as
    training progresses (linear) or applies full strength (constant).
    `sched_scale` is a float or a 0-d tensor. `lo` / `hi` (0-d tensors on
    the draw's device) replace the spec's range: the evolving ranges of
    ADR."""
    if lo is None:
        lo, hi = spec.lo, spec.hi
    elif spec.distribution == "loguniform":
        llo, lhi = torch.log(torch.clamp(lo, min=1e-12)), torch.log(torch.clamp(hi, min=1e-12))
        v = torch.exp(llo + base * (lhi - llo))
        ident = _identity_value(spec)
        return ident + (v - ident) * sched_scale
    if spec.distribution == "gaussian":
        mu, var = lo, hi
        if spec.operation == "scaling":
            mu = mu + (1.0 - mu) * (1.0 - sched_scale)
        else:
            mu = mu * sched_scale
        return mu + (var * sched_scale) * base
    if spec.distribution == "loguniform":
        llo, lhi = math.log(max(lo, 1e-12)), math.log(max(hi, 1e-12))
        v = torch.exp(llo + base * (lhi - llo))
    else:  # uniform
        v = lo + base * (hi - lo)
    ident = _identity_value(spec)
    return ident + (v - ident) * sched_scale


def _sample_spec(spec: DRSpec, generator: torch.Generator, shape, sched_scale, lo=None, hi=None) -> torch.Tensor:
    """Draw the randomization factor/offset for one spec."""
    return _transform(spec, _base_draw(spec, generator, shape), sched_scale, lo, hi)


def _apply_op(base, factor, operation: str):
    return base * factor if operation == "scaling" else base + factor


class DomainRandomizer:
    """Parses a reference-schema randomization_params dict and produces
    per-env randomization samples and their application."""

    def __init__(
        self,
        model: Model,
        params: Dict[str, Any],
        actor_ranges: Optional[Dict[str, Tuple[int, int]]] = None,
        obs_dim=None,
        act_dim=None,
        obs_slices=None,
        *,
        device,
    ):
        """actor_ranges: optional {actor_name: (body_lo, body_hi)} scoping
        each actor's specs to its own bodies/dofs/points; absent actors fall
        back to the whole-model leaf. obs_dim / act_dim / obs_slices may be
        callables, resolved at sample time. `device` is where the samples
        live (the env's)."""
        self.model = model
        self.device = torch.device(device)
        self.actor_ranges = actor_ranges or {}
        self.frequency = int(params.get("frequency", 1))
        self._obs_dim = obs_dim
        self._act_dim = act_dim
        self._obs_slices = obs_slices
        self.obs_spec = None
        self.obs_key_specs: Dict[str, DRSpec] = {}
        obs_params = params.get("observations")
        if isinstance(obs_params, dict) and obs_params:
            if "range" in obs_params or "operation" in obs_params:
                self.obs_spec = _spec_from_dict("observations", None, obs_params)
            else:
                # per-obs-key noise dicts: each key noises its slice of the
                # flat obs vector, located via the task's obs_spec() view
                self.obs_key_specs = {
                    k: _spec_from_dict(f"observations.{k}", None, v)
                    for k, v in obs_params.items()
                    if isinstance(v, dict)
                }
        self.act_spec = _spec_from_dict("actions", None, params["actions"]) if "actions" in params else None
        self.gravity_spec = None
        sim = params.get("sim_params", {})
        if "gravity" in sim:
            self.gravity_spec = _spec_from_dict("gravity", None, sim["gravity"])

        self.model_specs: List[DRSpec] = []
        self.scale_specs: List[DRSpec] = []
        for actor, groups in params.get("actor_params", {}).items():
            for group, props in groups.items():
                if not isinstance(props, dict):
                    continue  # e.g. color: True
                if group == "scale" and "range" in props:
                    # uniform geometric actor scaling: one factor s per env
                    # scales the actor's contact points and geom sizes by s,
                    # mass by s^3, inertia by s^5, com offset by s
                    if actor not in self.actor_ranges:
                        raise ValueError(
                            f"actor_params.{actor}.scale needs dr_actor_ranges() to scope the actor"
                        )
                    self.scale_specs.append(_spec_from_dict(f"{actor}.scale", None, props, actor=actor))
                    continue
                for prop, cfg in props.items():
                    leaf = _ACTOR_PARAM_MAP.get((group, prop))
                    if leaf is None or not isinstance(cfg, dict):
                        continue
                    self.model_specs.append(_spec_from_dict(f"{actor}.{group}.{prop}", leaf, cfg, actor=actor))
        # the base leaves the specs and the actor scale touch, on the device
        self._base: Dict[str, torch.Tensor] = {
            leaf: torch.as_tensor(np.asarray(self._leaf_base_np(leaf), np.float32), device=self.device)
            for leaf in self.batched_leaf_names()
        }
        # per-spec boolean mask over its leaf (None = whole leaf)
        self.masks: Dict[str, Optional[torch.Tensor]] = {
            spec.name: self._leaf_mask(spec) for spec in self.model_specs
        }
        # external parameter generator: a callable (generator, n) -> (n, P)
        # tensor of factors/offsets laid out per param_info(), replacing the
        # independent per-parameter draws (joint distributions over all
        # physics parameters, see dr.param_generator)
        self.param_generator = None
        self._flat_layout = self._build_flat_layout()

    def _build_flat_layout(self):
        """Per-spec (flat-index tensor, size) into the flattened leaf,
        restricted to the spec's actor mask: the flat vector an external
        generator must produce, in model_specs order."""
        layout = []
        for spec in self.model_specs:
            base = self._base[spec.leaf]
            mask = self.masks[spec.name]
            if mask is None:
                idx = np.arange(base.numel())
            else:
                idx = np.flatnonzero(np.broadcast_to(mask.cpu().numpy(), tuple(base.shape)))
            layout.append((torch.as_tensor(idx, dtype=torch.int64, device=self.device), int(idx.size)))
        return layout

    def param_info(self):
        """Flat layout of externally-generatable physics params: ordered
        {name, leaf, size, lo, hi, operation} dicts, one per actor_params
        spec; an external generator returns (n, sum(size)) with slices in
        this order. lo/hi are the YAML ranges (advisory bounds)."""
        return [
            {"name": spec.name, "leaf": spec.leaf, "size": size, "lo": spec.lo, "hi": spec.hi,
             "operation": spec.operation}
            for spec, (_, size) in zip(self.model_specs, self._flat_layout)
        ]

    def num_extern_params(self) -> int:
        return sum(size for _, size in self._flat_layout)

    def _leaf_base_np(self, leaf: str):
        v = getattr(self.model, leaf)
        if v is not None:
            return v
        if leaf == "cpoint_restitution":
            return np.zeros(self.model.ncp, np.float32)
        if leaf == "dof_friction":
            return np.zeros(self.model.nv, np.float32)
        raise ValueError(f"Model leaf {leaf} is None and has no default")

    def _leaf_mask(self, spec: DRSpec):
        """Boolean mask of spec.leaf selecting the spec's actor."""
        rng = self.actor_ranges.get(spec.actor)
        if rng is None:
            return None
        b0, b1 = rng
        m = self.model
        if spec.leaf.startswith("body_"):
            sel = (np.arange(m.nbody) >= b0) & (np.arange(m.nbody) < b1)
        elif spec.leaf.startswith("dof_") or spec.leaf == "armature":
            db = np.asarray(m.dof_body)
            sel = (db >= b0) & (db < b1)
        elif spec.leaf.startswith("cpoint_"):
            cb = np.asarray(m.cpoint_body)
            sel = (cb >= b0) & (cb < b1)
        else:
            return None
        base = self._base[spec.leaf]
        return torch.as_tensor(sel, device=self.device).reshape(sel.shape + (1,) * (base.dim() - 1))

    # ---- sampling ------------------------------------------------------
    def _sched_scale(self, spec: DRSpec, frames):
        if spec.schedule == "linear":
            return torch.clamp(torch.as_tensor(frames, device=self.device) / spec.schedule_steps, max=1.0)
        return 1.0  # a constant schedule applies full strength

    def _noise_pairs(self):
        """(spec, width, sample name) of every correlated obs/action noise."""
        pairs = [
            (self.obs_spec, self.obs_dim(), "observations_corr"),
            (self.act_spec, self.act_dim(), "actions_corr"),
        ]
        if self.obs_key_specs:
            slices = self._resolved_obs_slices()
            pairs += [
                (spec, slices[kname][1], f"observations_corr.{kname}")
                for kname, spec in self.obs_key_specs.items()
                if kname in slices
            ]
        return [
            (spec, dim, name) for spec, dim, name in pairs
            if spec is not None and dim is not None and not (spec.corr_lo == 0.0 and spec.corr_hi == 0.0)
        ]

    def sample(self, generator: torch.Generator, n: int, frames, adr=None) -> Dict[str, torch.Tensor]:
        """Per-env randomization sample for all model leaves, gravity, actor
        scales and correlated noise: dict name -> (n, *leaf.shape) factors or
        offsets. `frames` is the env-step count (an int or a 0-d tensor) that
        linear schedules read.

        `adr`: {spec_name: {"lo", "hi", "pin_mask", "pin_val"}} from
        `ADR.dr_overrides`: the named specs draw from the evolving range
        [lo, hi], and the envs of `pin_mask` (n,) take `pin_val` (n,)."""
        adr = adr or {}
        out = {}
        gen_vals = None
        gen_off = 0
        if self.param_generator is not None:
            gen_vals = torch.as_tensor(self.param_generator(generator, n), device=self.device)
            want = (n, self.num_extern_params())
            if tuple(gen_vals.shape) != want:
                raise ValueError(
                    f"external param generator returned {tuple(gen_vals.shape)}, expected {want}; "
                    f"columns must follow param_info(): {[p['name'] for p in self.param_info()]}"
                )
        for spec, (flat_idx, size) in zip(self.model_specs, self._flat_layout):
            base = self._base[spec.leaf]
            ov = adr.get(spec.name)
            v = _sample_spec(spec, generator, (n,) + tuple(base.shape), self._sched_scale(spec, frames),
                             *((None, None) if ov is None else (ov["lo"], ov["hi"])))
            if gen_vals is not None:
                # the external joint sample replaces the independent draw on
                # the spec's actor-masked entries (identity elsewhere)
                piece = gen_vals[:, gen_off:gen_off + size]
                gen_off += size
                flat = torch.full((n, base.numel()), _identity_value(spec), dtype=piece.dtype, device=self.device)
                flat[:, flat_idx] = piece
                v = flat.reshape((n,) + tuple(base.shape))
            if ov is not None and ov.get("pin_mask") is not None:
                pin = (n,) + (1,) * base.dim()
                v = torch.where(ov["pin_mask"].reshape(pin), ov["pin_val"].reshape(pin).to(v.dtype), v)
            out[spec.name] = v
        if self.gravity_spec is not None:
            out["gravity"] = _sample_spec(
                self.gravity_spec, generator, (n, 3), self._sched_scale(self.gravity_spec, frames))
        for spec in self.scale_specs:
            out[spec.name] = _sample_spec(spec, generator, (n,), self._sched_scale(spec, frames))
        # correlated obs/action noise: one per-env draw held fixed until the
        # next re-randomization
        for spec, dim, name in self._noise_pairs():
            corr = spec._replace(lo=spec.corr_lo, hi=spec.corr_hi)
            out[name] = _sample_spec(corr, generator, (n, dim), self._sched_scale(spec, frames))
        return out

    def _resolved_obs_slices(self):
        """{key: (offset, size)} from the task (may be a callable); keys of
        obs_key_specs with no slice are inert."""
        sl = self._obs_slices
        sl = sl() if callable(sl) else sl
        return sl or {}

    def obs_dim(self):
        d = self._obs_dim
        return d() if callable(d) else d

    def act_dim(self):
        d = self._act_dim
        return d() if callable(d) else d

    def identity_sample(self, n: int) -> Dict[str, torch.Tensor]:
        """The sample that randomizes nothing."""
        full = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=self.device)
        out = {}
        for spec in self.model_specs:
            out[spec.name] = full((n,) + tuple(self._base[spec.leaf].shape), _identity_value(spec))
        for spec in self.scale_specs:
            out[spec.name] = full((n,), 1.0)
        for spec, dim, name in self._noise_pairs():
            out[name] = full((n, dim), _identity_value(spec))
        if self.gravity_spec is not None:
            out["gravity"] = full((n, 3), _identity_value(self.gravity_spec))
        return out

    # ---- application ---------------------------------------------------
    def batched_leaf_names(self) -> set:
        """Model leaf names that batched_model() gives a leading env axis."""
        leaves = {spec.leaf for spec in self.model_specs}
        if self.scale_specs:
            leaves |= set(_SCALED_LEAVES)
        return leaves

    def batched_model(self, sample: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The randomized leaves per env, {leaf: (num_envs, *leaf.shape)};
        each spec only perturbs its actor's slice of the leaf (self.masks).
        The port's Model holds numpy arrays and stays as it is: the physics
        step takes these leaves beside it."""
        updates: Dict[str, torch.Tensor] = {}
        for spec in self.model_specs:
            base = updates.get(spec.leaf)
            if base is None:
                base = self._base[spec.leaf].expand(sample[spec.name].shape)
            applied = _apply_op(base, sample[spec.name], spec.operation)
            mask = self.masks[spec.name]
            updates[spec.leaf] = applied if mask is None else torch.where(mask[None], applied, base)
        for spec in self.scale_specs:
            b0, b1 = self.actor_ranges[spec.actor]
            m = self.model
            within = lambda owner: (np.asarray(owner) >= b0) & (np.asarray(owner) < b1)
            body_sel, geom_sel, cp_sel = within(np.arange(m.nbody)), within(m.geom_body), within(m.cpoint_body)
            n = sample[spec.name].shape[0]
            s_ = sample[spec.name].reshape(n, 1)

            def scaled(leaf, sel, power, extra_dims):
                base = updates.get(leaf)
                if base is None:
                    base = self._base[leaf].expand((n,) + tuple(self._base[leaf].shape))
                fac = s_.reshape((n, 1) + (1,) * extra_dims) ** power
                mask = torch.as_tensor(sel, device=self.device).reshape((1, -1) + (1,) * extra_dims)
                return torch.where(mask, base * fac, base)

            updates["cpoint_pos"] = scaled("cpoint_pos", cp_sel, 1.0, 1)
            updates["geom_size"] = scaled("geom_size", geom_sel, 1.0, 1)
            updates["body_ipos"] = scaled("body_ipos", body_sel, 1.0, 1)
            updates["body_mass"] = scaled("body_mass", body_sel, 3.0, 0)
            updates["body_inertia"] = scaled("body_inertia", body_sel, 5.0, 2)
        return updates

    def gravity(self, base_gravity, sample: Dict[str, torch.Tensor]):
        """(num_envs, 3) per-env gravity, or None if not randomized."""
        if self.gravity_spec is None:
            return None
        base = torch.as_tensor(np.asarray(base_gravity, np.float32), device=self.device)
        return _apply_op(base[None, :], sample["gravity"], self.gravity_spec.operation)

    def noise(self, spec: Optional[DRSpec], generator, x, frames):
        if spec is None:
            return x
        s = self._sched_scale(spec, frames)
        return _apply_op(x, _sample_spec(spec, generator, x.shape, s), spec.operation)

    def observation_noise(self, generator, obs, frames, dr_sample=None):
        """White + correlated obs noise (the correlated part is re-drawn at
        the DR frequency). With per-key specs each key noises only its slice
        of the flat obs vector."""
        if self.obs_key_specs:
            out = obs.clone()
            slices = self._resolved_obs_slices()
            for kname, spec in sorted(self.obs_key_specs.items()):
                sl = slices.get(kname)
                if sl is None:
                    continue
                off, size = sl
                piece = self.noise(spec, generator, out[..., off:off + size], frames)
                cname = f"observations_corr.{kname}"
                if dr_sample is not None and cname in dr_sample:
                    piece = _apply_op(piece, dr_sample[cname], spec.operation)
                out[..., off:off + size] = piece
            return out
        out = self.noise(self.obs_spec, generator, obs, frames)
        if dr_sample is not None and "observations_corr" in dr_sample:
            out = _apply_op(out, dr_sample["observations_corr"], self.obs_spec.operation)
        return out

    def action_noise(self, generator, actions, frames, dr_sample=None):
        """White + correlated action noise."""
        out = self.noise(self.act_spec, generator, actions, frames)
        if dr_sample is not None and "actions_corr" in dr_sample:
            out = _apply_op(out, dr_sample["actions_corr"], self.act_spec.operation)
        return out
