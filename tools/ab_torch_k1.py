#!/usr/bin/env python3
"""A/B of harmony_tpu_torch's K1 round between checkouts, on the card.

    python3 tools/ab_torch_k1.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repo. In turn, each runs
in a fresh process from its own root (so it builds and loads its own
kernels) one K1 round (``cuda_estep.block_update_round``) at the main
shape of ``chip_smoke.py`` (500,000 x 50, K = 100, B = 10, seed 1) and
prints the round's time by CUDA events (the wrapper, host work included)
and the device time per round of its assign and commit kernels under
``torch.profiler`` (five rounds). Give the checkouts in turns (parent,
change, change, parent) to see the spread beside the difference.
"""

import subprocess
import sys

_ONE = r'''
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as cs
from harmony_tpu_torch.ops import cuda_estep
dev = torch.device("cuda")
args = cs.problem(torch, 500_000, 50, 100, (10,), 1, dev)
ms = cs.time_ms(torch, "K1 round", lambda: cuda_estep.block_update_round(*args), iters=5)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        cuda_estep.block_update_round(*args)
    torch.cuda.synchronize()
dev_ms = {}
for e in prof.key_averages():
    for name in ("assign_kernel", "commit_kernel"):
        if name in e.key:
            dev_ms[name] = getattr(e, "self_device_time_total", 0.0) / 1e3 / 5
print("RESULT " + json.dumps({"round_ms": ms, "device_ms_per_round": dev_ms}))
'''


def main(trees):
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", _ONE], cwd=tree, capture_output=True,
                             text=True)
        res = [line for line in out.stdout.splitlines() if line.startswith("RESULT")]
        print(tree, res[0][7:] if res else "FAILED\n" + out.stderr[-2000:], flush=True)
        if not res:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
