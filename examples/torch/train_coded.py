"""End-to-end example on the PyTorch port: coded data-parallel training of a
~100M-class LM with per-step faults, elastic throughput re-estimation, and
async checkpoints (the counterpart of ``examples/train_coded.py``).

Default invocation trains a width/depth-reduced llama config for a few
hundred steps on the CUDA card (env SMOKE=1 shrinks further for CI;
``--device cpu`` runs on the CPU), checkpointing under
``build/examples/coded_ckpt`` at the repository root:

  PYTHONPATH=src python examples/torch/train_coded.py [--device cpu]

This is a thin veneer over the port's launcher — the same run via CLI:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
      --steps 300 --scheme heter_aware --s 1 --m 6 --straggler fault \\
      --speeds 1,1,2,2,4,4 --ckpt-dir build/examples/coded_ckpt
"""

import argparse
import os
from pathlib import Path

from repro_torch.launch.train import main

SMOKE = os.environ.get("SMOKE", "0") == "1"
CKPT_DIR = Path(__file__).resolve().parents[2] / "build" / "examples" / "coded_ckpt"

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    main([
        "--arch", "llama3.2-1b",
        "--reduced",
        "--steps", "40" if SMOKE else "300",
        "--scheme", "heter_aware",
        "--s", "1",
        "--m", "6",
        "--part-mb", "2",
        "--seq-len", "64" if SMOKE else "128",
        "--straggler", "fault",
        "--speeds", "1,1,2,2,4,4",
        "--ckpt-dir", str(CKPT_DIR),
        "--ckpt-every", "20",
        "--device", args.device,
    ])
