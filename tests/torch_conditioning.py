"""Float32 conditioning of a physics step, on the CPU, for the port's
comparisons against the JAX package.

A contact state can be ill-conditioned: float32 rounding alone moves its
step by more than the comparison's tolerance, so two correct float32 steps
(the port's and JAX's) may disagree there. `chip_smoke.conditioned` drops
such states from the kernel comparisons on the card; this module holds its
float64 part for the CPU tests, with the same limits:

  * `port_gaps`: the port's plain step in float32, from
    q and from q's first three entries (the base position) one ulp up and
    one ulp down, against the same step in float64; an env is kept where
    the largest gap of the three lies within COND_TOL;
  * `jax_gaps`: the same for JAX `physics_step_fused(use_pallas=False)`,
    its float64 call under `jax.enable_x64`.

A test drops an env only where both packages' float32 steps lie more than
COND_TOL from float64 (`kept`), and compares every other env, those where
only one package is off included: a state is dropped only when it is
ill-conditioned for both, never when only the port is off. `kept` also
holds the port's float64 step against JAX's on every env, the dropped ones
included, within the comparisons' own tolerances (F64_TOL): a port fault
that shows only in an ill-conditioned state still fails there. The two
float64 steps agree to about float32 rounding of their inputs, not to
float64 rounding (the model's constants and derived arrays are float32 in
both packages and are not computed alike), so their gaps grow with the
state's conditioning too: the largest seen in these tests is 5.1e-4 in qd
(an IndustReal peg in its socket), against the tolerance of 2e-3.
"""
from __future__ import annotations

import numpy as np
import torch

# a quarter of the comparisons' tolerances (q 2e-4, qd 2e-3, forces 2e-2);
# chip_smoke.COND_TOL holds the same numbers
COND_TOL = {"q": 5e-5, "qd": 5e-4, "force": 5e-3}
_OUTS = ("q", "qd", "force", "force", "force")
_FIELDS = ("q", "qd", "body_force", "body_torque", "dof_force")
# the port's float64 step against JAX's in every env: the comparisons' tolerances
F64_TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}


def _per_env(gaps):
    """{q, qd, force} -> (N,) largest gap, from five (rows, N) gap arrays."""
    out = {}
    for name, g in zip(_OUTS, gaps):
        g = g.amax(0)
        out[name] = torch.maximum(out[name], g) if name in out else g
    return out


def port_gaps(s, p, q, qd, qfrc, xfrc=None, q_target=None, names=(), dyn=None, terr=None, wre=0, sdf=None):
    """Per env, the largest gap between the port's plain step in float32
    (from q, and from q with its first three entries one ulp up and one
    down) and the same step in float64: {"q", "qd", "force"} -> (N,) float64
    tensors, and under "f64" the float64 step's outputs, env-leading as
    `physics_step_fused` returns them (numpy). Inputs env-leading as `physics_step_fused` takes them: q (N,
    nq), qd and qfrc (N, nv), xfrc (N, nbody, 6) or None, q_target (N, nq)
    or None; `dyn` the packed (rows, N) per-env leaves of `names`, `terr`
    and `sdf` the packed planes, `wre` the merged window's warm reset."""
    from isaacgymenvs_tpu_torch.engine import fused

    rows = lambda t: None if t is None else t.T.contiguous()
    xr = None if xfrc is None else xfrc.permute(2, 1, 0).reshape(6 * s.nbody, q.shape[0]).contiguous()
    ins = [rows(qd), rows(qfrc), xr, rows(q_target), dyn, terr]
    f32 = fused._step_math_torch(s, p, "cpu", names)
    f64 = fused._step_math_torch(s, p, "cpu", names, dtype=torch.float64)
    wide = lambda t: None if t is None else t.double()
    ref = f64(rows(q).double(), *(wide(t) for t in ins), wre, wide(sdf))
    worst = None
    for sign in (0.0, 1e9, -1e9):
        x = q.clone()
        if sign:
            x[:, :3] = torch.nextafter(x[:, :3], torch.full_like(x[:, :3], sign))
        out = f32(rows(x), *ins, wre, sdf)
        g = _per_env([(a.double() - b).abs() for a, b in zip(out, ref)])
        worst = g if worst is None else {k: torch.maximum(worst[k], g[k]) for k in g}
    n, nb = q.shape[0], s.nbody
    env = [ref[0].T, ref[1].T, *(t.reshape(3, nb, n).permute(2, 1, 0) for t in ref[2:4]), ref[4].T]
    return {**worst, "f64": dict(zip(_FIELDS, (t.numpy() for t in env)))}


def within(gaps) -> torch.Tensor:
    """(N,) bool: every gap within COND_TOL."""
    return (gaps["q"] < COND_TOL["q"]) & (gaps["qd"] < COND_TOL["qd"]) & (gaps["force"] < COND_TOL["force"])


def jax_gaps(jm, jp, q, qd, qfrc, xfrc=None, q_target=None, dyn=None, wre=0):
    """Per env, the largest gap between JAX
    `physics_step_fused(use_pallas=False)` in float32 (from q, and from q
    with its first three entries one ulp up and one down, as `port_gaps`)
    and the same call in float64 (inputs as numpy arrays or tensors,
    env-leading; `dyn` JAX's dict of per-env leaves and planes):
    {"q", "qd", "force"} -> (N,) float64 tensors, and under "f64" the
    float64 call's outputs (numpy)."""
    import jax
    import jax.numpy as jnp
    from isaacgymenvs_tpu.engine import fused as jfused

    host = lambda t: None if t is None else np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
    args = [host(t) for t in (q, qd, qfrc, xfrc, q_target)]
    dyn = {k: host(v) for k, v in (dyn or {}).items()}

    def run(dtype, q0):
        cast = lambda a: None if a is None else jnp.asarray(a.astype(dtype) if a.dtype.kind == "f" else a)
        out = jfused.physics_step_fused(jm, jp, cast(q0), *(cast(a) for a in args[1:3]), xfrc=cast(args[3]),
                                        q_target=cast(args[4]), use_pallas=False,
                                        dyn={k: cast(v) for k, v in dyn.items()} or None, warm_reset_every=wre)
        return [np.asarray(getattr(out, k), np.float64) for k in _FIELDS]

    with jax.enable_x64(True):
        ref = run(np.float64, args[0])
    n, worst = args[0].shape[0], None
    for sign in (0.0, 1e9, -1e9):
        x = args[0].astype(np.float32)
        if sign:
            x[:, :3] = np.nextafter(x[:, :3], np.float32(sign))
        g = _per_env([torch.tensor(np.abs(a - b).reshape(n, -1).T) for a, b in zip(run(np.float32, x), ref)])
        worst = g if worst is None else {k: torch.maximum(worst[k], g[k]) for k in g}
    return {**worst, "f64": dict(zip(_FIELDS, ref))}


def kept(port, jax_side) -> torch.Tensor:
    """(N,) bool: the envs a comparison keeps, all but those where the
    port's float32 step and JAX's both lie more than COND_TOL from float64
    (`port_gaps`, `jax_gaps`). First asserts that the port's float64 step
    equals JAX's within F64_TOL on every env, the dropped ones included."""
    for k in _FIELDS:
        np.testing.assert_allclose(port["f64"][k], jax_side["f64"][k], rtol=0, atol=F64_TOL[k],
                                   err_msg=f"float64 {k}, port against JAX")
    return within(port) | within(jax_side)
