"""Time the fused-step kernel of two checkouts in turns, on one card.

    python tools/fused_ab.py --parent isaacgymenvs_tpu_torch/_build/_parent \
        [--keys AnymalTerrain Anymal Insertion] [--order parent,new,new,parent]

`--parent` is an unpacked checkout of another commit (for example
`git archive <commit> | tar -x -C isaacgymenvs_tpu_torch/_build/_parent`;
`_build/` is gitignored and copied to the card). Each turn is a process
started in one tree that imports that tree's `chip_smoke.py` and times the
listed instantiations with its own `time_anymal`, `time_insertion`,
`time_ball` or `time_case` (the keys of its ANYMAL_CASES and CASES, and
`Insertion` and `Ball`): CUDA events around the wrapper and the device time
of launches queued back to back, at full width, in the comparison states
both trees draw from the same seeds. So each side builds and runs its own
source. Prints the card's name
and power limit, one `AB` JSON line per turn, and a summary of the device
ms per launch of each side. Needs a CUDA device; exits non-zero without.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, sys
sys.path.insert(0, {tree!r})
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
name = torch.cuda.get_device_name(0)
out = {{}}
for key in {keys!r}:
    if key == "Insertion":
        out[key] = cs.time_insertion(name)
    elif key == "Ball":
        out[key] = cs.time_ball(name)
    elif key in cs.ANYMAL_CASES:
        out[key] = cs.time_anymal(key, name)
    else:  # an entry of chip_smoke.CASES
        out[key] = cs.time_case(key, name)
print("AB_RESULT " + json.dumps(out))
"""


def turn(tree: str, keys: list, timeout: int) -> dict:
    """One process in `tree`: its chip_smoke's times of `keys`."""
    res = subprocess.run([sys.executable, "-c", CHILD.format(tree=tree, keys=keys)], cwd=tree,
                         capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB_RESULT ")]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"turn in {tree} failed ({res.returncode}):\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return json.loads(lines[-1][len("AB_RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="checkout of the commit to compare with")
    ap.add_argument("--keys", nargs="+", default=["AnymalTerrain", "Anymal"])
    ap.add_argument("--order", default="parent,new,new,parent")
    ap.add_argument("--timeout", type=int, default=900, help="seconds per turn")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fused_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(args.parent), "new": HERE}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    seen: dict = {"parent": [], "new": []}
    for side in args.order.split(","):
        res = turn(trees[side], args.keys, args.timeout)
        seen[side].append(res)
        print("AB", json.dumps({"side": side, **res}), flush=True)
    for key in args.keys:
        for field in ("device_ms", "ms", "device_ms_4096", "ms_4096"):
            vals = {side: [r[key][field] for r in runs if field in r[key]] for side, runs in seen.items()}
            if all(vals.values()):
                print(f"{key} {field}: parent {vals['parent']}, new {vals['new']}, "
                      f"new / parent {min(vals['new']) / min(vals['parent']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
