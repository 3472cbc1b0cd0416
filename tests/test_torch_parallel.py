"""The port's data parallelism (isaacgymenvs_tpu_torch/parallel/) against
the JAX package, on the CPU: two gloo ranks (`torch_ranks.run_ranks`), each
stepping its half of the envs, against one JAX epoch over all of them.

  * the global shuffle: two PPO epochs on Cartpole, one on Ant (in
    tests/test_torch_parallel_ant.py, for its time: its JAX env steps op by
    op), at the sizes and tolerances of tests/test_torch_ppo.py, its JAX
    epoch assembled there, every rank handed its half of the action noise
    and the same permutations of the global batch;
  * `local_shuffle`: PPO and PPORecurrent (AMPAgent in
    tests/test_torch_parallel_amp.py) on two ranks, and in one process with
    `_shuffle_shards = 2`, against the JAX package's shard-blocked epoch
    (isaacgymenvs_tpu/learn/ppo.py:523-616, rnn.py:254-300). The blocked
    minibatches are the rows `jax_blocked_rows` takes from JAX's blocked
    layout, so the JAX epochs assembled in tests/test_torch_{ppo,rnn}.py
    run on them, and the port's one-process blocked epoch equals its
    global-shuffle epoch over those rows bit for bit; the ValueError for
    `seq_minibatch % S` is JAX's;
  * the running normalizer's moments over two ranks against JAX's
    `rms_update` over the whole batch; ADR's update over two ranks against
    JAX's on the global arrays with the same recycled workers;
  * what raises by name: `num_envs` that the ranks do not divide, SAC and
    PBT with more than one rank, NCCL with two ranks on one card, and the
    ADR and RNA defaults (the card) without one.

After every epoch the two ranks' parameters must be bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ppo as ppo_t
import test_torch_rnn as rnn_t
from isaacgymenvs_tpu.dr import adr as jadr_mod
from isaacgymenvs_tpu.learn import running_stats as jrs
from isaacgymenvs_tpu_torch.parallel import distributed
from isaacgymenvs_tpu_torch.parallel.sharding import portable_state
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)
from torch_ranks import run_ranks

torch.set_num_threads(1)

EPOCH_WORKER = """
from isaacgymenvs_tpu_torch import learn
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.parallel.sharding import adopt_state


def work(inp):
    env = task_map[inp["task"]](inp["env_cfg"], device="cpu")
    if inp["reset"] is not None:  # every reset lands in one state, as on the JAX side
        q0, qd0 = inp["reset"]
        env.sample_init = lambda gen, n: (q0.repeat(n, 1), qd0.repeat(n, 1), ())
    agent = getattr(learn, inp["agent"])(env, inp["train"], seed=0)
    ts = adopt_state(agent, inp["state"], inp["num_envs"])
    out = []
    for e in inp["epochs"]:
        kw = {"demos": e["demos"][RANK]} if "demos" in e else {}
        ts, metrics = agent.train_epoch(ts, noise=e["noise"][:, env.env_block], perms=e["perms"], **kw)
        out.append({"metrics": metrics, "params": {n: p.detach().clone() for n, p in agent.named_trainables()},
                    "value_rms": [ts.value_rms.mean, ts.value_rms.var, ts.value_rms.count]})
    return out
"""


def _port_params(ranks, epoch):
    """Both ranks' parameters after `epoch`, which must be bit-equal."""
    p0, p1 = ranks[0][epoch]["params"], ranks[1][epoch]["params"]
    assert set(p0) == set(p1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), f"epoch {epoch}: the ranks' {k} differ"
    assert ranks[0][epoch]["metrics"] == ranks[1][epoch]["metrics"]
    for a, b in zip(ranks[0][epoch]["value_rms"], ranks[1][epoch]["value_rms"]):
        assert torch.equal(a, b)
    return {k: v.numpy() for k, v in p0.items()}


def _epoch_inputs(agent, tagent, tts, task, env_cfg, train, n, reset=None):
    return {"task": task, "env_cfg": env_cfg, "agent": agent, "train": train, "num_envs": n, "reset": reset,
            "state": portable_state(tagent, tts)}


def _fixed_reset(tagent):
    q0, qd0, _ = tagent.env.sample_init(None, 1)
    return q0[0], qd0[0]


# ---- the global shuffle -------------------------------------------------------------


def check_two_rank_epochs(task, tmp_path):
    """PPO epochs on two ranks (half the envs each, the same permutations
    of the global batch; two on Cartpole, the second from moved Adam
    moments, normalizers and lr, one on the Ant, whose JAX epoch steps op by
    op) against the JAX epochs over all the envs: metrics at rtol 2e-4 /
    atol 2e-6, parameters at atol 1e-4, as in tests/test_torch_ppo.py; both
    ranks' parameters bit-equal after each epoch, and their metrics equal."""
    jagent, tagent = ppo_t._agents(task)
    n, env_cfg, sim_cfg, train_cfg, scale = ppo_t.TASKS[task]
    jts = jagent.init()
    tts = ppo_t._port_state_from(tagent, jts)
    reset = None
    if task == "Cartpole":
        ppo_t._fix_reset_state(jagent, tagent)
        reset = _fixed_reset(tagent)
    train = {"network": {"mlp": {"units": [32, 16], "activation": "elu"}},
             "config": {"horizon_length": ppo_t.HORIZON, "mini_epochs": ppo_t.MINI_EPOCHS,
                        "minibatch_size": ppo_t.HORIZON * n // ppo_t.NUM_MB, **train_cfg}}
    inputs = _epoch_inputs("PPO", tagent, tts, task, {"env": {"numEnvs": n, **env_cfg}, "sim": dict(sim_cfg)},
                           train, n, reset)
    rng = np.random.RandomState(7)
    wants, inputs["epochs"] = [], []
    for _ in range(2 if task == "Cartpole" else 1):
        noise = (scale * rng.normal(size=(ppo_t.HORIZON, n, jagent.env.num_acts))).astype(np.float32)
        perms = np.stack([rng.permutation(ppo_t.HORIZON * n) for _ in range(ppo_t.MINI_EPOCHS)])
        jts, want = ppo_t._jax_epoch(jagent, jts, jnp.asarray(noise), perms, jit=task != "Ant")
        wants.append((want, ppo_t._jax_params(jts.params)))
        inputs["epochs"].append({"noise": torch.tensor(noise), "perms": torch.tensor(perms)})
    ranks = run_ranks(tmp_path, EPOCH_WORKER, inputs, timeout=150)
    finished = 0
    for epoch, (want, jp) in enumerate(wants):
        got, tp = ranks[0][epoch]["metrics"], _port_params(ranks, epoch)
        assert got["n_episodes"] == want["n_episodes"]
        finished += got["n_episodes"]
        for k in ("a_loss", "c_loss", "entropy", "b_loss", "kl", "lr", "reward_mean_step"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6, err_msg=f"epoch {epoch} {k}")
        for name in jp:
            np.testing.assert_allclose(tp[name], jp[name], atol=1e-4, err_msg=f"epoch {epoch} {name}")
    # Cartpole's epochs run through dones and resets (on both ranks); the Ant stays up
    assert finished > 0 if task == "Cartpole" else finished == 0


def test_two_rank_epochs_match_jax(tmp_path):
    """`check_two_rank_epochs` on Cartpole: two epochs through dones and
    resets."""
    check_two_rank_epochs("Cartpole", tmp_path)


# ---- local_shuffle ------------------------------------------------------------------


def jax_blocked_rows(shard_perms, S: int, nmb: int, mb: int, T: int = 0, N: int = 0, rows: int = 0):
    """The global rows of each mini-epoch's minibatches, in order, of the
    JAX package's shard-blocked epoch with `shard_perms` (mini_epochs, B/S):
    its blocked layout of the flat batch (ppo.py:529-534 for (T, N)
    rollouts; rnn.py:270-274 for `rows` env-major windows), the shared
    permutation of each shard (x[:, perm]), and the minibatch merge of
    (S, mb/S) into mb (ppo.py:580-609, rnn.py:286-300)."""
    if rows:
        g = jnp.arange(rows).reshape(S, rows // S)
    else:
        g = jnp.swapaxes(jnp.arange(T * N).reshape(T, S, N // S), 0, 1).reshape(S, T * (N // S))
    out = []
    for p in shard_perms:
        mbs = jnp.swapaxes(g[:, jnp.asarray(p)].reshape(S, nmb, mb // S), 0, 1)
        out.append(np.asarray(mbs.reshape(nmb * mb)))
    return np.stack(out), np.asarray(g.reshape(-1))


def check_local_shuffle(tmp_path, tagent, tts, inputs, global_kw, want, jp, rtol, atol, one_kw=None,
                        kink_bound=0.0):
    """`inputs`' epoch with local_shuffle on two ranks (one shard each) and
    in one process with `_shuffle_shards = 2`: the one-process epoch equals
    the port's global-shuffle epoch over the same rows (`global_kw`: the
    permutation `jax_blocked_rows` gives, and its demos) bit for bit; both
    against the JAX epoch `want` (its parameters `jp`): metrics at rtol
    2e-4 / atol 2e-6, parameters at `rtol` / `atol`; the ranks bit-equal.
    With `kink_bound`, one element in a thousand of each tensor may lie
    outside `rtol` / `atol` but within `kink_bound`."""
    keys = ("a_loss", "c_loss", "entropy", "b_loss", "kl", "lr", "reward_mean_step")
    e = inputs["epochs"][0]
    saved = inputs["state"]["trainables"]
    tagent._shuffle_shards = 2
    _, one = tagent.train_epoch(tts, noise=e["noise"], perms=e["perms"], **(one_kw or {}))
    one_params = {n: p.detach().clone() for n, p in tagent.named_trainables()}
    tagent._shuffle_shards = 1
    fresh_opt = tagent.init().optimizer
    with torch.no_grad():
        for n, p in tagent.named_trainables():
            p.copy_(saved[n])
    _, flat = tagent.train_epoch(dataclasses.replace(tts, optimizer=fresh_opt), noise=e["noise"], **global_kw)
    assert flat == one
    for n, p in tagent.named_trainables():
        assert torch.equal(p, one_params[n]), n
    ranks = run_ranks(tmp_path, EPOCH_WORKER, inputs, timeout=150)
    got, tp = ranks[0][0]["metrics"], _port_params(ranks, 0)
    for label, m, params in (("one process", one, {k: v.numpy() for k, v in one_params.items()}),
                             ("two ranks", got, tp)):
        for k in keys:
            np.testing.assert_allclose(m[k], want[k], rtol=2e-4, atol=2e-6, err_msg=f"{label} {k}")
        assert set(params) == set(jp)
        for name in jp:
            if not kink_bound:
                np.testing.assert_allclose(params[name], jp[name], rtol=rtol, atol=atol, err_msg=f"{label} {name}")
                continue
            gap = np.abs(params[name] - jp[name])
            outside = gap > atol + rtol * np.abs(jp[name])
            assert outside.mean() <= 1e-3 and gap.max() <= kink_bound, (label, name, int(outside.sum()), gap.max())


def test_local_shuffle_ppo_matches_jax_blocked_epoch(tmp_path):
    """PPO with local_shuffle on Cartpole (tests/test_torch_ppo.py's sizes
    and parameter tolerance, atol 1e-4)."""
    jagent, tagent = ppo_t._agents("Cartpole", local_shuffle=True)
    n, env_cfg, sim_cfg, train_cfg, _ = ppo_t.TASKS["Cartpole"]
    jts = jagent.init()
    tts = ppo_t._port_state_from(tagent, jts)
    ppo_t._fix_reset_state(jagent, tagent)
    train = {"network": {"mlp": {"units": [32, 16], "activation": "elu"}},
             "config": {"horizon_length": ppo_t.HORIZON, "mini_epochs": ppo_t.MINI_EPOCHS, "local_shuffle": True,
                        "minibatch_size": ppo_t.HORIZON * n // ppo_t.NUM_MB, **train_cfg}}
    rng = np.random.RandomState(8)
    B = ppo_t.HORIZON * n
    noise = rng.normal(size=(ppo_t.HORIZON, n, 1)).astype(np.float32)
    shard_perms = np.stack([rng.permutation(B // 2) for _ in range(ppo_t.MINI_EPOCHS)])
    perms, _ = jax_blocked_rows(shard_perms, 2, ppo_t.NUM_MB, B // ppo_t.NUM_MB, T=ppo_t.HORIZON, N=n)
    jts, want = ppo_t._jax_epoch(jagent, jts, jnp.asarray(noise), perms, jit=True)
    inputs = _epoch_inputs("PPO", tagent, tts, "Cartpole", {"env": {"numEnvs": n, **env_cfg}, "sim": dict(sim_cfg)},
                           train, n, _fixed_reset(tagent))
    inputs["epochs"] = [{"noise": torch.tensor(noise), "perms": torch.tensor(shard_perms)}]
    check_local_shuffle(tmp_path, tagent, tts, inputs, {"perms": torch.tensor(perms)}, want,
                        ppo_t._jax_params(jts.params), 0.0, 1e-4)


def test_local_shuffle_recurrent_matches_jax_blocked_epoch(tmp_path):
    """PPORecurrent with local_shuffle on Cartpole's LSTM recipe of
    tests/test_torch_rnn.py (windows env-major, one contiguous block of
    them per shard; its parameter tolerance, rtol 2e-4 / atol 1e-5)."""
    train = {**rnn_t.TRAIN, "config": {**rnn_t.TRAIN["config"], "local_shuffle": True}}
    jagent, tagent = rnn_t._agents(train)
    jts = jagent.init()
    tts = rnn_t._port_state_from(tagent, jts)
    rng = np.random.RandomState(9)
    H, n, S = train["config"]["horizon_length"], rnn_t.N, 2
    noise = rng.normal(size=(H, n, 1)).astype(np.float32)
    shard_perms = np.stack([rng.permutation(tagent.num_seqs // S) for _ in range(2)])
    nmb = tagent.num_seqs // tagent.seq_minibatch
    perms, _ = jax_blocked_rows(shard_perms, S, nmb, tagent.seq_minibatch, rows=tagent.num_seqs)
    jts, want = rnn_t._jax_epoch(jagent, jts, jnp.asarray(noise), perms)
    inputs = _epoch_inputs("PPORecurrent", tagent, tts, "Cartpole", {k: dict(v) for k, v in rnn_t.CFG.items()},
                           train, n, _fixed_reset(tagent))
    inputs["epochs"] = [{"noise": torch.tensor(noise), "perms": torch.tensor(shard_perms)}]
    jp = {k: v.numpy() for k, v in rnn_t.actor_critic_from_flax(rnn_t._np_tree(jts.params)).items()}
    check_local_shuffle(tmp_path, tagent, tts, inputs, {"perms": torch.tensor(perms)}, want, jp, 2e-4, 1e-5)


def test_local_shuffle_window_divisibility_raises_as_jax():
    """A shard count that does not divide the minibatch's windows raises
    the JAX package's ValueError, word for word."""
    train = {**rnn_t.TRAIN, "config": {**rnn_t.TRAIN["config"], "local_shuffle": True}}
    jagent, tagent = rnn_t._agents(train)
    jagent._shuffle_shards = tagent._shuffle_shards = 3  # 8 windows per minibatch
    with pytest.raises(ValueError, match="local_shuffle") as jerr:
        jax.jit(jagent.train_epoch).trace(jagent.init())
    with pytest.raises(ValueError, match="local_shuffle") as terr:
        tagent.train_epoch(tagent.init())
    assert str(terr.value) == str(jerr.value)


# ---- moments and ADR ----------------------------------------------------------------


MOMENTS_WORKER = """
from isaacgymenvs_tpu_torch.learn.running_stats import RunningMeanStd, rms_update


def work(inp):
    out = []
    for rms, batch in inp:
        half = batch.shape[1] // 2
        new = rms_update(RunningMeanStd(*rms), batch[:, RANK * half:(RANK + 1) * half])
        out.append([new.mean, new.var, new.count])
    return out
"""


def test_rms_update_over_two_ranks_matches_jax(tmp_path):
    """The running normalizer updated by two ranks, each with its half of
    the envs of a (T, N, ...) batch, equals JAX's `rms_update` over the
    whole batch (rtol 1e-5; the moments merge in another order) and is
    bit-equal on both ranks: an observation normalizer and a scalar one."""
    rng = np.random.RandomState(3)
    cases = [((5, 8, 3), (3,)), ((4, 6), ())]
    inputs, wants = [], []
    for shape, d in cases:
        batch = rng.normal(1.5, 2.0, shape).astype(np.float32)
        mean, var = rng.normal(size=d).astype(np.float32), rng.uniform(0.5, 2.0, d).astype(np.float32)
        count = np.float32(37.0)
        want = jrs.rms_update(jrs.RunningMeanStd(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(count)),
                              jnp.asarray(batch))
        wants.append([np.asarray(want.mean), np.asarray(want.var), np.asarray(want.count)])
        inputs.append(([torch.tensor(mean), torch.tensor(var), torch.tensor(count)], torch.tensor(batch)))
    r0, r1 = run_ranks(tmp_path, MOMENTS_WORKER, inputs, timeout=60)
    for a, b, want in zip(r0, r1, wants):
        for x, y, w in zip(a, b, want):
            assert torch.equal(x, y)
            np.testing.assert_allclose(x.numpy(), w, rtol=1e-5, atol=1e-6)


ADR_WORKER = """
from isaacgymenvs_tpu_torch.dr.adr import ADR, AdrState
from isaacgymenvs_tpu_torch.parallel import sharding


def work(inp):
    n = inp["num_envs"]
    adr = ADR(inp["cfg"], n, "cpu", block=sharding.env_block(n))
    st = adr.init_state(None, workers=inp["workers"])
    out = []
    for done, obj, fresh in inp["steps"]:
        blk = adr.block
        st = adr.update(st, None, done[blk], obj[blk], fresh_workers=fresh)
        out.append(st.as_dict())
    return out
"""


def test_adr_update_over_two_ranks_matches_jax(tmp_path):
    """Sixteen ADR updates on two ranks, each with its half of the done
    flags and objectives (tests/test_torch_adr.py's schedule: widen, narrow,
    clamp, recycle), the recycled workers drawn alike on both: the ranges,
    queues, counts and entropy are bit-equal on the ranks and equal JAX's
    update on the global arrays exactly (the entropy at 1e-6), and the two
    blocks of the worker assignment are JAX's."""
    import test_torch_adr as adr_t

    n = 64
    cfg = adr_t.WIDE_CFG
    jadr = jadr_mod.ADR(cfg, n)
    js = jadr.init_state(jax.random.PRNGKey(0))
    inputs = {"cfg": cfg, "num_envs": n, "workers": torch.tensor(np.asarray(js.worker_boundary)), "steps": []}
    rng, key, wants = np.random.RandomState(0), jax.random.PRNGKey(7), []
    for step in range(16):
        key, k = jax.random.split(key)
        done = adr_t._capped_done(np.asarray(js.worker_boundary), rng.uniform(size=n) < 0.6, jadr.queue_len)
        obj = ((50.0, 0.0)[(step // 4) % 2] + rng.uniform(-1, 1, n)).astype(np.float32)
        fresh = jadr._assign_workers(jax.random.split(k)[1])
        js = jadr.update(js, k, jnp.asarray(done), jnp.asarray(obj))
        wants.append(js)
        inputs["steps"].append((torch.tensor(done), torch.tensor(obj), torch.tensor(np.asarray(fresh))))
    r0, r1 = run_ranks(tmp_path, ADR_WORKER, inputs, timeout=60)
    moved = 0
    for step, (a, b, js) in enumerate(zip(r0, r1, wants)):
        for f in ("lo", "hi", "queues", "counts", "nats"):
            assert torch.equal(a[f], b[f]), f"step {step}: the ranks' {f} differ"
        for f in ("lo", "hi", "queues", "counts"):
            np.testing.assert_array_equal(a[f].numpy(), np.asarray(getattr(js, f)), err_msg=f"step {step} {f}")
        np.testing.assert_allclose(float(a["nats"]), float(js.nats), atol=1e-6)
        wb = torch.cat([a["worker_boundary"], b["worker_boundary"]]).numpy()
        np.testing.assert_array_equal(wb, np.asarray(js.worker_boundary), err_msg=f"step {step} worker_boundary")
        moved += int(step and not np.array_equal(np.asarray(js.lo), np.asarray(wants[step - 1].lo)))
    assert moved > 0


# ---- what raises by name ------------------------------------------------------------


REFUSALS_WORKER = """
from isaacgymenvs_tpu_torch.learn import SAC
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.pbt_loop import run_pbt_training


def work(inp):
    out = {}
    cfg = {"env": {"numEnvs": 7}, "sim": {"dt": 1 / 60, "substeps": 2}}
    for name, call in (
        ("num_envs", lambda: task_map["Cartpole"](cfg, device="cpu")),
        ("sac", lambda: SAC(task_map["Cartpole"]({**cfg, "env": {"numEnvs": 8}}, device="cpu"), {})),
        ("pbt", lambda: run_pbt_training({}, None, {}, 0, "run", None, {}, inp)),
    ):
        try:
            call()
            out[name] = None
        except (ValueError, NotImplementedError) as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    return out
"""


def test_two_ranks_refuse_by_name(tmp_path):
    """On two ranks: a `num_envs` the ranks do not divide raises naming it,
    as do SAC and the PBT loop, which train in one process (neither takes a
    mesh in the JAX package)."""
    r0, r1 = run_ranks(tmp_path, REFUSALS_WORKER, str(tmp_path), timeout=60)
    for r in (r0, r1):
        assert r["num_envs"] == "ValueError: num_envs=7 is not divisible by the 2 ranks of the process group"
        assert r["sac"].startswith("NotImplementedError: SAC trains in one process")
        assert r["pbt"].startswith("NotImplementedError: PBT trains each member in one process")


def test_process_group_refusals(monkeypatch):
    """Without a launcher's variables `multi_gpu` raises naming them (the
    JAX package's message), and a world size of 1 forms no group; NCCL
    with more ranks on a host than cards raises by name before it would
    join; NCCL is refused on the CPU."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    from isaacgymenvs_tpu.parallel import distributed as jdist

    with pytest.raises(RuntimeError) as terr:
        distributed.maybe_initialize(require=True, device="cpu")
    with pytest.raises(RuntimeError) as jerr:
        jdist.maybe_initialize(require=True)
    assert "multi_gpu=True but no process-group env vars" in str(terr.value) and str(terr.value) == str(jerr.value)
    assert distributed.distributed_spec() is None and jdist.distributed_spec() is None
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": "29511", "RANK": "0", "WORLD_SIZE": "1"}.items():
        monkeypatch.setenv(k, v)
    assert distributed.maybe_initialize(require=True, device="cpu") is False and not distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: pytest.fail("no device is set before the refusal"))
    with pytest.raises(RuntimeError, match="NCCL cannot put two ranks on one device.*dist_backend=gloo"):
        distributed.maybe_initialize(device="cuda")
    with pytest.raises(RuntimeError, match="NCCL backend needs device=cuda"):
        distributed.maybe_initialize(backend="nccl", device="cpu")
    assert not distributed.is_initialized()


def test_adr_and_rna_default_to_the_card():
    """ADR and the RNA take the env's device; their own default is the
    card, which raises without a GPU unless the CPU is asked for."""
    from isaacgymenvs_tpu_torch.dr.adr import ADR
    from isaacgymenvs_tpu_torch.utils.rna import RandomNetworkAdversary

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import test_torch_adr as adr_t

    with pytest.raises(RuntimeError, match="CUDA"):
        ADR(adr_t.CFG, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        RandomNetworkAdversary(23, 16)
    assert ADR(adr_t.CFG, 8, "cpu").device == torch.device("cpu")
    assert RandomNetworkAdversary(23, 16, device="cpu").device == torch.device("cpu")
