"""Train, checkpoint, resume and play every hand-task variant through
`train.main`, at each yaml's width on the card.

    python tools/hands_train_check.py                      # every variant
    python tools/hands_train_check.py --only ShadowHand    # those whose label starts so
    python tools/hands_train_check.py --only AllegroKuka   # the AllegroKuka names chip_smoke.py leaves out

Per variant, `chip_smoke.train_main_at_width`: `train.main` for EPOCHS
epochs (the kernel's launches must be epochs x horizon x
controlFrequencyInv, every metric finite), a bit-equal restore of the
checkpoint `last_<name>.pth`, a resume from it for one more epoch, and
play (`test=True`) with episodes cut to 16 steps. Prints one line per
variant and, last, a JSON object {"failed": [labels], "launches": {label:
n}}. Exits non-zero if a variant fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

EPOCHS = 2
# label -> the task and further config selections; ShadowHandTest is an evaluation yaml of 256 envs
# without a recipe of its own: it trains with the OpenAI feed-forward recipe, its minibatches cut to its
# batch of 2,048
VARIANTS = {
    "Trifinger": ["Trifinger", "task.task.randomize=True"],
    "ShadowHand": ["ShadowHand"],
    "ShadowHand+PPOAsymm": ["ShadowHand", "train=ShadowHandPPOAsymm"],
    "ShadowHand+PPOLSTM": ["ShadowHand", "train=ShadowHandPPOLSTM"],
    "ShadowHand+PPOAsymmLSTM": ["ShadowHand", "train=ShadowHandPPOAsymmLSTM"],
    "ShadowHand+OpenAIPPO": ["ShadowHand", "train=ShadowHandOpenAIPPO"],
    "ShadowHandOpenAI_FF": ["ShadowHandOpenAI_FF", "task.task.randomize=True"],
    "ShadowHandOpenAI_LSTM": ["ShadowHandOpenAI_LSTM"],
    "ShadowHandTest": ["ShadowHandTest", "train=ShadowHandOpenAI_FFPPO", "train.params.config.minibatch_size=2048",
                       "train.params.config.central_value_config.minibatch_size=2048"],
    "AllegroHand": ["AllegroHand"],
    "AllegroHandFF": ["AllegroHandFF"],
    "AllegroHandLSTM": ["AllegroHandLSTM"],
    "AllegroHandLSTM_Big": ["AllegroHandLSTM_Big"],
    # chip_smoke.py trains AllegroKukaReorientation and the two-arm resolver; these are the other names
    "AllegroKukaRegrasping": ["AllegroKukaRegrasping"],
    "AllegroKukaThrow": ["AllegroKukaThrow"],
    "AllegroKuka+subtask=throw": ["AllegroKuka", "task.env.subtask=throw"],
    "AllegroKukaLSTM": ["AllegroKukaLSTM"],
    "AllegroKukaTwoArmsRegrasping": ["AllegroKukaTwoArmsRegrasping"],
    "AllegroKukaTwoArmsLSTM": ["AllegroKukaTwoArmsLSTM"],
}


def main(argv=None) -> int:
    import chip_smoke
    from isaacgymenvs_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None, help="labels (prefixes) to run")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hands_train_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0))
    launches, failed = {}, []
    for label, (task, *overrides) in VARIANTS.items():
        if a.only and not any(label.startswith(o) for o in a.only):
            continue
        cfg = load_config([f"task={task}", *overrides])
        width, horizon = int(cfg["task"]["env"]["numEnvs"]), int(cfg["train"]["params"]["config"]["horizon_length"])
        try:
            launches[label] = chip_smoke.train_main_at_width(task, width, horizon, EPOCHS, overrides=overrides)
        except Exception as e:  # noqa: BLE001 (report every variant, then fail)
            failed.append(label)
            print(f"{label}: FAILED {type(e).__name__}: {e}", flush=True)
    print(json.dumps({"failed": failed, "launches": launches}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
