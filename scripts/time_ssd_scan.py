#!/usr/bin/env python3
"""Time the SSD scan kernel of one or more source trees on one card, in turns.

    python scripts/time_ssd_scan.py [SRC ...]

Each SRC is the ``src`` directory of a tree of this repository (default:
this checkout's ``src``).  Every SRC is timed in a process of its own, in
the order given, by ``chip_smoke.time_ssd`` of this checkout: the kernel at
the training micro-batch, ``generate``'s prefill and the engine's longest
prompt (bf16 B/C, model-drawn dA), beside its bound and the plain version.
So an A/B reading on one card is

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python scripts/time_ssd_scan.py build/parent/src src src build/parent/src

Each run builds its tree's kernels in that tree's own ``build/``.  Prints
the card line, then each run's log and its result as one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(src: str) -> dict:
    """Time the kernel of the tree whose ``src`` is ``src`` (this process)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_ssd_scan: no CUDA device available")
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build

    build.build_all()
    res = chip_smoke.time_ssd(torch)
    return dict(src=src, build_dir=build.BUILD_INFO["dir"], shapes=res["shapes"])


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    srcs = argv or [str(ROOT / "src")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card, flush=True)
    for src in srcs:
        out = subprocess.run([sys.executable, __file__, "--one", src], capture_output=True,
                             text=True, timeout=900)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"time_ssd_scan: {src} exited {out.returncode}", file=sys.stderr)
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
