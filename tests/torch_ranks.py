"""The port's multi-rank tests: a script run as the ranks of a gloo process
group on the CPU.

`run_ranks` starts `world` Python processes with torchrun's variables
(MASTER_ADDR/MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK) on a free port of
localhost (`parallel.distributed.start_ranks`). Each joins the group through
`isaacgymenvs_tpu_torch.parallel.distributed.maybe_initialize`, runs torch
on one thread, calls the script's `work(inputs)` and saves what it returns.
A rank that fails or outlives `timeout` fails the caller with its log, and
every rank is killed. The workers import torch and the port, never JAX.
"""
import os
import sys
import textwrap

import torch

from isaacgymenvs_tpu_torch.parallel.distributed import free_port, start_ranks, wait_ranks  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

PRELUDE = """\
import os, sys
sys.path[:0] = [{root!r}, {tests!r}]
import torch
torch.set_num_threads(1)
from isaacgymenvs_tpu_torch.parallel import distributed
if {join}:
    distributed.maybe_initialize(require=True, device="cpu")
RANK = int(os.environ["RANK"])
"""

EPILOGUE = """
try:
    _result = work(torch.load(sys.argv[2], weights_only=False))
finally:
    distributed.shutdown()
torch.save(_result, sys.argv[1].format(RANK))
"""


def run_ranks(tmp_path, body: str, inputs=None, world: int = 2, timeout: float = 120.0, join: bool = True,
              env=None) -> list:
    """Run `body` (which defines `work(inputs) -> result`) as `world` ranks;
    returns their results in rank order. With `join=False` the script joins
    no group itself (it calls `train.main`, which does)."""
    script = tmp_path / "rank_worker.py"
    script.write_text(PRELUDE.format(root=ROOT, tests=TESTS, join=join) + textwrap.dedent(body) + EPILOGUE)
    inp = tmp_path / "rank_inputs.pt"
    torch.save(inputs, inp)
    logs = [tmp_path / f"rank_log_{r}.txt" for r in range(world)]
    procs = start_ranks([sys.executable, str(script), str(tmp_path / "rank_out_{}.pt"), str(inp)], logs,
                        env={"OMP_NUM_THREADS": "1", **(env or {})}, cwd=str(tmp_path))
    for r, code in enumerate(wait_ranks(procs, timeout)):
        assert code == 0, f"rank {r} exited {code}:\n{logs[r].read_text(errors='replace')[-4000:]}"
    return [torch.load(tmp_path / f"rank_out_{r}.pt", weights_only=False) for r in range(world)]
