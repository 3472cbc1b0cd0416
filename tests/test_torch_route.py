"""The physics route of the port's VecTask (`physics_route`, "kernel" or
"eager") against the JAX package's rule, on the CPU.

The kernel route is taken wherever the port's kernel covers the model and
its per-env leaves (its plain version on the CPU); the eager engine
otherwise, and under `sim.use_fused: False`. Per-env candidate points (an
actor-scale spec) with SDF rows used to raise: they take the eager route,
which equals the JAX env's eager step (its CPU default) on the same DR
sample. `sim.use_fused: True` on what the kernel does not cover raises by
name. Tolerances: env steps q 2e-4, qd 2e-3 (tests/test_fused.py:79-82),
observations 2e-3 (Ant's contact forces scaled into its observation),
rewards 1e-3 (Ant's: one float32 ulp of its potential, 7.8e-3, since its
progress reward is a difference of two potentials near 6.0e4), each step
from the JAX state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.convert import dr_sample_from_jax, env_state_from_arrays
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 4
# the plug scaled per env by 0.95-1.05 (its points, geom, centre of mass, mass and inertia)
PLUG_SCALE = {"actor_params": {"plug": {"scale": {"range": [0.95, 1.05], "operation": "scaling",
                                                  "distribution": "uniform", "setup_only": True}}}}


def _port(task, extra=(), sim=None, randomization=None, cls=None):
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([f"task={task}", f"num_envs={N}", *extra])["task"]
    cfg.setdefault("sim", {}).update(sim or {})
    if randomization is not None:
        cfg["task"] = {"randomize": True, "randomization_params": randomization}
    return (cls or task_map[task])(cfg, device="cpu")


def _jax(task, extra=(), randomization=None, cls=None):
    from isaacgymenvs_tpu.tasks import task_map
    from isaacgymenvs_tpu.utils.config import load_config

    cfg = load_config([f"task={task}", f"num_envs={N}", *extra])["task"]
    if randomization is not None:
        cfg["task"] = {"randomize": True, "randomization_params": randomization}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        return (cls or task_map[task])(cfg)


def _plug_ranges(base):
    """`base` with the plug as an actor of domain randomization."""

    class WithPlug(base):
        def dr_actor_ranges(self):
            b = self.plug_ref.body0
            return {"plug": (b, b + 1)}

    return WithPlug


def _fields(js):
    return {"q": js.sim.q, "qd": js.sim.qd, "progress": js.progress, "reset_buf": js.reset_buf,
            "actions": js.actions, "task": jax.tree.map(np.asarray, js.task)}


def _steps_match(jenv, tenv, jstate, tstate, steps, acts, obs_tol=2e-3, rew_tol=1e-3):
    jstep = jax.jit(jenv.step)
    rng = np.random.RandomState(2)
    for _ in range(steps):
        tstate = env_state_from_arrays(tstate, _fields(jstate), "cpu")
        a = rng.uniform(-1, 1, (N, acts)).astype(np.float32)
        jstate, jobs, jrew, jdone, _ = jstep(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, _ = tenv.step(tstate, torch.tensor(a))
        np.testing.assert_allclose(tstate.sim.q.numpy(), np.asarray(jstate.sim.q), atol=2e-4)
        np.testing.assert_allclose(tstate.sim.qd.numpy(), np.asarray(jstate.sim.qd), atol=2e-3)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=obs_tol)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=rew_tol)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    return jstate, tstate


def test_insertion_under_actor_scale_takes_the_eager_route_and_matches_jax():
    """FactoryTaskInsertion with the plug scaled per env (per-env candidate
    points against the socket's SDF grid, which used to raise): the route is
    eager, naming why; the env state holds the leaves in their model layout;
    on the JAX reset's DR sample and from the plug in the socket's bore or on
    its top face (`contact_states`), three env steps equal the JAX env's
    eager steps, and the plug takes contact force."""
    from isaacgymenvs_tpu.tasks.factory_templates import FactoryTaskInsertion as JIns
    from isaacgymenvs_tpu_torch.tasks.factory_templates import FactoryTaskInsertion as TIns

    jenv = _jax("FactoryTaskInsertion", randomization=PLUG_SCALE, cls=_plug_ranges(JIns))
    tenv = _port("FactoryTaskInsertion", randomization=PLUG_SCALE, cls=_plug_ranges(TIns))
    assert tenv.physics_route == "eager"
    assert "per-env cpoint_pos (actor scale) with terrain or SDF rows" in tenv.kernel_refusals()
    jstate, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    q, qd = tenv.contact_states(N, seed=7, kinds=("bore", "socket_top"))
    jstate = jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q.numpy()), qd=jnp.asarray(qd.numpy())),
                            task={"q_ref": jnp.asarray(q[:, tenv.q_idx].numpy())})
    tstate, _ = tenv.reset(0)
    tstate.dr = dr_sample_from_jax(jstate.dr)
    tstate.dyn = tenv.pack_dyn(tstate.dr)
    assert isinstance(tstate.dyn, dict) and tuple(tstate.dyn["cpoint_pos"].shape) == (N, tenv.model.ncp, 3)
    assert float(tstate.dyn["cpoint_pos"].std(0).max()) > 1e-4  # the points differ per env
    _steps_match(jenv, tenv, jstate, tstate, 3, 12)


def test_use_fused_true_beyond_the_kernel_raises_by_name():
    """`sim.use_fused: True` where the kernel does not cover the env raises
    NotImplementedError naming the reason; a value other than True, False
    or auto is refused."""
    from isaacgymenvs_tpu_torch.tasks.factory_templates import FactoryTaskInsertion as TIns

    env = _port("FactoryTaskInsertion", sim={"use_fused": True}, randomization=PLUG_SCALE, cls=_plug_ranges(TIns))
    with pytest.raises(NotImplementedError, match=r"use_fused=True.*per-env cpoint_pos"):
        env.reset(0)
    with pytest.raises(ValueError, match="use_fused"):
        _port("Cartpole", sim={"use_fused": "yes"})


@pytest.mark.parametrize("task", ["Ant", "Cartpole", "BallBalance", "FactoryTaskInsertion", "AnymalTerrain",
                                  "FactoryTaskGears"])
def test_ported_tasks_keep_the_kernel_route(task):
    """Every ported task the kernel covers keeps the kernel route at its
    yaml's settings (AnymalTerrain: its heightfield, set after VecTask's
    own constructor, and its yaml's DR), and `sim.use_fused: False` takes
    the eager engine."""
    extra = ("task.env.terrain.numLevels=3", "task.env.terrain.numTerrains=4") if task == "AnymalTerrain" else ()
    env = _port(task, extra)
    assert env.physics_route == "kernel" and env.kernel_refusals() == []
    assert _port(task, extra, sim={"use_fused": False}).physics_route == "eager"


def test_ant_on_the_eager_route_matches_jax():
    """Ant under `sim.use_fused: False`: from the JAX reset state, three env
    steps equal the JAX env's eager steps (observations, rewards, done
    flags too); the eager route keeps merged decimation windows off."""
    jenv = _jax("Ant")
    tenv = _port("Ant", sim={"use_fused": False})
    assert tenv.physics_route == "eager"
    jstate, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tstate, _ = tenv.reset(0)
    # the progress reward is a difference of potentials -|target - torso| / dt, about 1000 m / dt = 6.0e4,
    # which float32 holds to one ulp (7.8e-3) in either package, on either route
    ulp = float(np.spacing(np.float32(1000.0 / tenv.dt)))
    _steps_match(jenv, tenv, jstate, tstate, 3, tenv.num_acts, rew_tol=ulp)
