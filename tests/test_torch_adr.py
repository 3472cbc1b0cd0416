"""The port's ADR (isaacgymenvs_tpu_torch/dr/adr.py) against the JAX
package's, on the CPU: the counterparts of tests/test_adr.py; `sample`,
`update` and `dr_overrides` from the same state with JAX's draws handed
over (the worker assignment, the uniform draws of the rollout workers, the
fresh assignment of a recycled boundary); the rule for more than Q pushes
into one queue in one step, on its own; and `DomainRandomizer.sample(adr=)`
with JAX's base draws against JAX's.

Tolerances: the ranges, queues, counts and assignments exactly (the same
float32 operations on the same values); the entropy and the DR draws 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.dr import adr as jadr_mod
from isaacgymenvs_tpu.dr import randomize as jdr
from isaacgymenvs_tpu_torch.dr import randomize as tdr
from isaacgymenvs_tpu_torch.dr.adr import ADR, AdrState
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

CFG = {
    "use_adr": True,
    "update_adr_ranges": True,
    "worker_adr_boundary_fraction": 0.5,
    "adr_queue_threshold_length": 4,
    "adr_objective_threshold_low": 5,
    "adr_objective_threshold_high": 20,
    "params": {
        "mass_scale": {"init_range": [0.9, 1.1], "limits": [0.3, 3.0], "delta": 0.05},
        "friction": {"init_range": [0.8, 1.2], "limits": [0.1, 2.0], "delta": 0.1},
    },
}
# three more behaviours of update: an edge clamped at its limit, multiplicative deltas, a range_path param
WIDE_CFG = {**CFG, "params": {
    **CFG["params"],
    "tight": {"init_range": [0.9, 1.1], "limits": [0.85, 1.15], "delta": 0.1},
    "gain": {"init_range": [0.5, 2.0], "limits": [0.1, 10.0], "delta": 0.5, "delta_style": "multiplicative"},
    "obj_mass": {"range_path": "actor_params.object.rigid_body_properties.mass.range", "init_range": [0.7, 1.3],
                 "limits": [0.1, 5.0], "delta": 0.05},
}}


def _port_state(js) -> AdrState:
    t = lambda a: torch.tensor(np.asarray(a))
    return AdrState(lo=t(js.lo), hi=t(js.hi), queues=t(js.queues), counts=t(js.counts).long(),
                    worker_boundary=t(js.worker_boundary).long(), nats=t(js.nats))


def _assert_states_equal(ts: AdrState, js, msg=""):
    for f in ("lo", "hi", "queues", "counts", "worker_boundary"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f"{f} {msg}")
    np.testing.assert_allclose(float(ts.nats), float(js.nats), atol=1e-6, err_msg=f"nats {msg}")


# ---- tests/test_adr.py, the port's counterparts ------------------------------------


def test_boundary_workers_pin_edges():
    adr = ADR(CFG, num_envs=256, device="cpu")
    st = adr.init_state(torch.Generator().manual_seed(0))
    vals = adr.sample(st, torch.Generator().manual_seed(1), 256).numpy()
    wb, lo, hi = st.worker_boundary.numpy(), st.lo.numpy(), st.hi.numpy()
    assert 0 < (wb >= 0).sum() < 256
    for i in range(256):
        if wb[i] >= 0:
            p, edge = wb[i] // 2, wb[i] % 2
            assert abs(vals[i, p] - (hi[p] if edge else lo[p])) < 1e-6
        else:
            assert ((vals[i] >= lo - 1e-6) & (vals[i] <= hi + 1e-6)).all()


def _run(adr, objective, steps=12, seed=2):
    st = adr.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(seed)
    done = torch.ones(adr.num_envs, dtype=torch.bool)
    obj = torch.full((adr.num_envs,), objective)
    first = st
    for _ in range(steps):
        st = adr.update(st, gen, done, obj)
    return first, st


def test_ranges_widen_on_good_performance():
    first, st = _run(ADR(CFG, num_envs=512, device="cpu"), 50.0)
    assert float(st.hi[0]) > float(first.hi[0])
    assert float(st.nats) > float(first.nats)  # the entropy grows as the ranges widen


def test_ranges_narrow_on_poor_performance():
    first, st = _run(ADR(CFG, num_envs=512, device="cpu"), 0.0, seed=3)  # below t_low
    assert float(st.hi[0] - st.lo[0]) < float(first.hi[0] - first.lo[0])


def test_per_env_queue_pushes():
    """Every finishing boundary env pushes its own objective, not one mean
    per boundary per step."""
    adr = ADR(CFG, num_envs=64, device="cpu")
    st = adr.init_state(torch.Generator().manual_seed(0))
    wb = torch.full((64,), -1, dtype=torch.int64)
    wb[:3] = 0  # three envs on boundary 0 (the queue holds 4: no evaluation)
    st.worker_boundary, st.counts = wb, torch.zeros_like(st.counts)
    done = torch.zeros(64, dtype=torch.bool)
    done[:3] = True
    st2 = adr.update(st, torch.Generator().manual_seed(1), done, torch.arange(64, dtype=torch.float32))
    assert int(st2.counts[0]) == 3
    assert sorted(st2.queues[0, :3].tolist()) == [0.0, 1.0, 2.0]


def test_range_path_dr_overrides_and_pins():
    adr = ADR(WIDE_CFG, num_envs=128, device="cpu")
    st = adr.init_state(torch.Generator().manual_seed(0))
    o = adr.dr_overrides(st)["object.rigid_body_properties.mass"]
    assert abs(float(o["lo"]) - 0.7) < 1e-6 and abs(float(o["hi"]) - 1.3) < 1e-6
    wb = st.worker_boundary.numpy()
    mine = (wb >= 0) & (wb // 2 == adr.dr_params["object.rigid_body_properties.mass"])
    mask, val = o["pin_mask"].numpy(), o["pin_val"].numpy()
    assert mine.any() and (mask == mine).all()
    assert np.allclose(val[mine & (wb % 2 == 1)], 1.3) and np.allclose(val[mine & (wb % 2 == 0)], 0.7)


def _one_body_model():
    from isaacgymenvs_tpu_torch.model.spec import FREE, ModelBuilder

    b = ModelBuilder()
    b.add_body(parent=-1, name="obj", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FREE, mass=2.0,
               inertia=np.eye(3) * 1e-3)
    return b.finalize()


MASS_PARAMS = {"actor_params": {"object": {"rigid_body_properties": {
    "mass": {"range": [0.9, 1.1], "operation": "scaling", "distribution": "uniform"}}}}}


def test_physics_param_flows_through_dr_engine():
    """An evolved ADR range reshapes the per-env physics draw: the object's
    mass factors span the ADR range, not the DR spec's, the boundary
    workers sit at its edges, and the batched mass follows the factors."""
    model = _one_body_model()
    rz = tdr.DomainRandomizer(model, MASS_PARAMS, actor_ranges={"object": (0, 1)}, device="cpu")
    adr = ADR({**CFG, "params": {"obj_mass": WIDE_CFG["params"]["obj_mass"]}}, num_envs=512, device="cpu")
    st = adr.init_state(torch.Generator().manual_seed(0))
    st.lo, st.hi = torch.tensor([0.3]), torch.tensor([2.5])  # evolved wider than the DR spec
    sample = rz.sample(torch.Generator().manual_seed(1), 512, 0, adr=adr.dr_overrides(st))
    v = sample["object.rigid_body_properties.mass"].numpy()[:, 0]
    wb = st.worker_boundary.numpy()
    roll = wb < 0
    assert v[roll].min() < 0.5 and v[roll].max() > 2.0
    assert (v[roll] >= 0.3 - 1e-5).all() and (v[roll] <= 2.5 + 1e-5).all()
    assert np.allclose(v[(wb >= 0) & (wb % 2 == 1)], 2.5, atol=1e-5)
    assert np.allclose(v[(wb >= 0) & (wb % 2 == 0)], 0.3, atol=1e-5)
    np.testing.assert_allclose(rz.batched_model(sample)["body_mass"].numpy()[:, 0], 2.0 * v, rtol=1e-5)


# ---- against the JAX package --------------------------------------------------------


def test_init_and_sample_match_jax():
    """From JAX's worker assignment, the initial state equals JAX's; from
    JAX's uniform draws, `sample` equals JAX's exactly (the pins at both
    edges included); `dr_overrides` equals JAX's."""
    n = 96
    jadr, tadr = jadr_mod.ADR(WIDE_CFG, n), ADR(WIDE_CFG, n, "cpu")
    assert tadr.param_names() == jadr.param_names() and tadr.dr_params == jadr.dr_params
    assert [tuple(s) for s in tadr.specs] == [tuple(s) for s in jadr.specs]
    js = jadr.init_state(jax.random.PRNGKey(0))
    ts = tadr.init_state(None, workers=torch.tensor(np.asarray(js.worker_boundary)))
    _assert_states_equal(ts, js)
    wb = np.asarray(js.worker_boundary)
    assert {0, 1} <= set(wb % 2) and (wb < 0).any()
    key = jax.random.PRNGKey(1)
    want = np.asarray(jadr.sample(js, key, n))
    got = tadr.sample(ts, None, n, u=torch.tensor(np.asarray(jax.random.uniform(key, (n, jadr.P))))).numpy()
    np.testing.assert_array_equal(got, want)
    jo, to = jadr.dr_overrides(js), tadr.dr_overrides(ts)
    assert set(jo) == set(to) == {"object.rigid_body_properties.mass"}
    for k in ("lo", "hi", "pin_mask", "pin_val"):
        np.testing.assert_array_equal(np.asarray(to["object.rigid_body_properties.mass"][k]),
                                      np.asarray(jo["object.rigid_body_properties.mass"][k]), err_msg=k)


def _capped_done(wb, done, q):
    """`done` with at most q finishing envs per boundary (the JAX package's
    result is not defined past q)."""
    done = done.copy()
    for b in np.unique(wb[wb >= 0]):
        idx = np.where((wb == b) & done)[0]
        done[idx[q:]] = False
    return done


@pytest.mark.parametrize("update_ranges", [True, False])
def test_update_matches_jax(update_ranges):
    """Sixteen updates from JAX's initial state, each with random done flags
    (at most Q per queue) and objectives, held against JAX's `update`
    with its fresh worker assignment handed over: the ranges widen (four
    steps of objective 50), narrow (four of 0) and clamp at their limits
    (`tight`), the multiplicative edges move by (1 + delta) (`gain`), full
    queues clear and their finished workers are reassigned, exactly as
    JAX's. With update_adr_ranges off the state does not move."""
    n = 64
    cfg = {**WIDE_CFG, "update_adr_ranges": update_ranges}
    jadr, tadr = jadr_mod.ADR(cfg, n), ADR(cfg, n, "cpu")
    js = jadr.init_state(jax.random.PRNGKey(0))
    ts = _port_state(js)
    rng = np.random.RandomState(0)
    key = jax.random.PRNGKey(7)
    widened = narrowed = recycled = clamped = 0
    lo0, hi0 = np.asarray(js.lo), np.asarray(js.hi)
    for step in range(16):
        key, k = jax.random.split(key)
        wb = np.asarray(js.worker_boundary)
        done = _capped_done(wb, rng.uniform(size=n) < 0.6, tadr.queue_len)
        level = (50.0, 0.0)[(step // 4) % 2]  # four steps past t_high (widen), four below t_low (narrow)
        obj = (level + rng.uniform(-1, 1, n)).astype(np.float32)
        fresh = jadr._assign_workers(jax.random.split(k)[1])
        before = ts
        js = jadr.update(js, k, jnp.asarray(done), jnp.asarray(obj))
        ts = tadr.update(ts, None, torch.tensor(done), torch.tensor(obj),
                         fresh_workers=torch.tensor(np.asarray(fresh)))
        _assert_states_equal(ts, js, f"step {step}")
        widened += int(((ts.hi > before.hi) | (ts.lo < before.lo)).sum())
        narrowed += int(((ts.hi < before.hi) | (ts.lo > before.lo)).sum())
        recycled += int((ts.worker_boundary != before.worker_boundary).sum())
        t = tadr.param_names().index("tight")
        clamped += abs(float(ts.hi[t]) - 1.15) < 1e-6 or abs(float(ts.lo[t]) - 0.85) < 1e-6
    if not update_ranges:
        assert widened == narrowed == recycled == 0 and int(ts.counts.sum()) == 0
        return
    assert widened > 0 and narrowed > 0 and recycled > 0 and clamped > 0
    g = tadr.param_names().index("gain")
    ratio = np.log(np.asarray([float(ts.lo[g]) / lo0[g], float(ts.hi[g]) / hi0[g]])) / np.log(1.5)
    np.testing.assert_allclose(ratio, np.round(ratio), atol=1e-4)  # whole multiplicative steps
    assert np.abs(ratio).sum() > 0


def test_more_than_q_pushes_keep_the_last_q():
    """Ten envs of one boundary finish in one step into a queue of 4 that
    already holds one objective: the ring keeps the last four in env order,
    as ten sequential pushes would (slots (1 + rank) mod 4: envs 7, 8, 9
    and 6 in slots 0-3), and the evaluation that follows reads them: the
    first six push 100 (past t_high), the last four 0 (below t_low), and
    the edge narrows."""
    n = 16
    adr = ADR(CFG, n, "cpu")
    st = adr.init_state(torch.Generator().manual_seed(0))
    st.worker_boundary = torch.where(torch.arange(n) < 10, 0, -1)
    st.counts = torch.tensor([1, 0, 0, 0])
    st.queues[0, 0] = 3.0
    done = torch.arange(n) < 10
    obj = torch.arange(n, dtype=torch.float32)
    queues, counts = adr.push(st, done, obj)
    assert queues[0].tolist() == [7.0, 8.0, 9.0, 6.0] and int(counts[0]) == 11
    assert queues[1:].abs().sum() == 0
    obj = torch.where(torch.arange(n) < 6, 100.0, 0.0)
    st2 = adr.update(st, torch.Generator().manual_seed(1), done, obj)
    assert float(st2.lo[0]) == pytest.approx(0.9 + 0.05)  # the lo edge (boundary 0) narrowed
    assert float(st2.hi[0]) == pytest.approx(1.1) and int(st2.counts[0]) == 0 and st2.queues[0].abs().sum() == 0


def test_dr_sample_with_adr_matches_jax(monkeypatch):
    """`DomainRandomizer.sample(adr=)` on the DeXtreme ADR yaml's
    randomization schema and its eleven range_path params, from an evolved
    ADR state (JAX's, ranges moved off the DR spec's), with JAX's base draws
    handed over: every leaf's sample equals JAX's (1e-6): the rollout
    workers' draws from the evolved ranges, the boundary workers pinned at
    both edges of each physics range."""
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.model import load_urdf
    from isaacgymenvs_tpu_torch.utils.assets import package_asset_root

    from isaacgymenvs_tpu.model import load_urdf as jload_urdf

    cfg = jload(["task=AllegroHandDextremeADR", "num_envs=48"])["task"]
    params = cfg["task"]["randomization_params"]
    n = 48
    path = f"{package_asset_root()}/urdf/kuka_allegro_description/allegro_touch_sensor.urdf"
    model = load_urdf(path, fix_base=True)
    ranges = {"hand": (0, model.nbody - 1), "object": (model.nbody - 1, model.nbody)}  # the last link as the object
    jrz = jdr.DomainRandomizer(jload_urdf(path, fix_base=True), params, actor_ranges=ranges)
    trz = tdr.DomainRandomizer(model, params, actor_ranges=ranges, device="cpu")
    jadr, tadr = jadr_mod.ADR(cfg["env"]["adr"], n), ADR(cfg["env"]["adr"], n, "cpu")
    js = jadr.init_state(jax.random.PRNGKey(3))
    js = js.replace(lo=js.lo * 0.8, hi=js.hi * 1.3 + 0.01)
    ts = _port_state(js)
    key = jax.random.PRNGKey(4)
    # JAX's base draws, in its order: one key split per model spec
    draws, k = [], key
    for spec in jrz.model_specs:
        k, sub = jax.random.split(k)
        shape = (n,) + tuple(np.shape(jrz._leaf_base(spec.leaf)))
        draws.append(np.asarray(jax.random.normal(sub, shape) if spec.distribution == "gaussian"
                                else jax.random.uniform(sub, shape)))
    it = iter(draws)
    monkeypatch.setattr(tdr, "_base_draw", lambda spec, g, shape: torch.tensor(next(it)).reshape(shape))
    want = jrz.sample(key, n, jnp.zeros((), jnp.int32), adr=jadr.dr_overrides(js))
    got = trz.sample(None, n, 0, adr=tadr.dr_overrides(ts))
    assert set(got) == set(want) and len(tadr.dr_params) == 11
    pinned = 0
    for name, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[name]), atol=1e-6, err_msg=name)
        if name in tadr.dr_params:
            pinned += int(tadr.dr_overrides(ts)[name]["pin_mask"].sum())
    assert pinned > 0
