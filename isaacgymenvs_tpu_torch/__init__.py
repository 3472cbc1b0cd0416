"""PyTorch/CUDA port of isaacgymenvs_tpu.

The JAX package `isaacgymenvs_tpu` stays the reference. This package
follows its module layout, imports nothing of it (nor JAX), and runs its
hot path -- the fused whole physics step -- through a CUDA kernel written
for Hopper (`engine/csrc/fused_step.cu`). Entry points default to
`device="cuda"`; the CPU runs only when asked for, through each kernel's
plain PyTorch version.
"""
from .device import resolve_device  # noqa: F401


def make(
    seed: int = 0,
    task: str = "Cartpole",
    num_envs: int | None = None,
    sim_device: str = "cuda",
    rl_device: str = "cuda",
    headless: bool = True,
    cfg=None,
    multi_gpu: bool = False,
    **override_kwargs,
):
    """A ready-to-step vectorized env (the IsaacGymEnvs `make()`).

    Composes the task's config (unless `cfg`, a task config dict, is
    given), applies `num_envs`, `seed` and the `key=value` overrides, and
    returns the task's VecTask on `sim_device`. A variant config (e.g.
    `AllegroHandFF`) builds the class its yaml's `name:` names. The device
    defaults to CUDA and raises without a GPU unless `sim_device="cpu"`.
    `rl_device` and `headless` are accepted for the reference's signature.
    With `multi_gpu=True` the process joins the group of its environment
    (torchrun's variables; `parallel.distributed.maybe_initialize`) and the
    env holds the rank's block of `num_envs` on the rank's card.
    """
    from .parallel import distributed
    from .tasks import task_map
    from .utils.config import load_config

    if multi_gpu:
        distributed.maybe_initialize(require=True, device=sim_device)
    device = distributed.rank_device(resolve_device(sim_device))
    overrides = [f"task={task}", f"seed={seed}"]
    if num_envs is not None:
        overrides.append(f"num_envs={num_envs}")
    overrides += [f"{k}={v}" for k, v in override_kwargs.items()]
    full = load_config(overrides) if cfg is None else {"task": cfg}
    name = task
    if name not in task_map:
        # variant configs alias an implemented class through their name: field
        name = full["task"].get("name", name)
    return task_map[name](full["task"], device=device)
