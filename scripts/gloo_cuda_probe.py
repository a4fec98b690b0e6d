#!/usr/bin/env python3
"""Which gloo collectives take a CUDA tensor, and what staging costs.

    python scripts/gloo_cuda_probe.py [--ranks 4] [--out build/gloo_probe.json]

Needs a CUDA card.  Each collective the spmd backend across processes uses
(``src/repro_torch/launch/mesh.py``) is tried on CUDA tensors by two gloo
ranks sharing the card, each in a ``torch.distributed.run`` of its own (a
refused op may abort the ranks).  Then ``--ranks`` ranks time, at
smollm-360m's flat wire (D = 361,821,120), an f32 ``all_reduce`` of a CUDA
tensor, the same staged by hand through a pinned host buffer, and an int8
``all_gather_into_tensor`` of a CUDA tensor into a flat (ranks * D,) one.
Prints one JSON object (and writes it to ``--out``) with the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

D = 361_821_120
OPS = ("all_reduce", "broadcast", "all_gather_into_tensor_flat", "all_gather_into_tensor_2d",
       "all_gather_list", "gather", "scatter", "send_recv", "barrier", "subgroup_all_reduce")


def _rank(op: str) -> None:
    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out: dict = {"rank": rank}
    if op == "timing":
        big = torch.randn(D, device=dev)
        host = torch.empty(D, pin_memory=True)
        q = torch.randint(-127, 127, (D,), dtype=torch.int8, device=dev)
        q_all = torch.empty(world * D, dtype=torch.int8, device=dev)
        runs = {
            "all_reduce_f32_cuda_s": lambda: dist.all_reduce(big),
            "all_reduce_f32_staged_s": lambda: (host.copy_(big), dist.all_reduce(host),
                                                big.copy_(host)),
            "all_gather_i8_cuda_s": lambda: dist.all_gather_into_tensor(q_all, q),
        }
        for name, fn in runs.items():
            times = []
            for _ in range(3):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[name] = times
    else:
        n = 1000
        x = torch.full((n,), float(rank + 1), device=dev)
        if op == "all_reduce":
            dist.all_reduce(x)
        elif op == "broadcast":
            dist.broadcast(x, src=0)
        elif op == "all_gather_into_tensor_flat":
            dist.all_gather_into_tensor(torch.empty(world * n, device=dev), x)
        elif op == "all_gather_into_tensor_2d":
            dist.all_gather_into_tensor(torch.empty(world, n, device=dev), x)
        elif op == "all_gather_list":
            dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
        elif op == "gather":
            dist.gather(x, [torch.empty_like(x) for _ in range(world)] if rank == 0 else None)
        elif op == "scatter":
            dist.scatter(x, [torch.ones_like(x)] * world if rank == 0 else None)
        elif op == "send_recv":
            if rank == 0:
                dist.send(x, dst=1)
            elif rank == 1:
                dist.recv(x, src=0)
        elif op == "barrier":
            dist.barrier()
        elif op == "subgroup_all_reduce":
            g = dist.new_group([0, 1])
            if rank < 2:
                dist.all_reduce(x, group=g)
        torch.cuda.synchronize()
        out["value"] = float(x[0])
    print("RESULT " + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def _torchrun(nproc: int, op: str) -> tuple[int, list[dict], str]:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(nproc), __file__, "--rank-op", op]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    # the ranks' lines may interleave; each result is one flat JSON object
    found = [json.loads(x) for x in re.findall(r"RESULT (\{[^{}]*\})", proc.stdout)]
    return proc.returncode, found, proc.stderr


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank-op", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_op:
        _rank(args.rank_op)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result: dict = {"card": card, "torch": torch.__version__, "ops": {}}
    for op in OPS:
        rc, found, err = _torchrun(2, op)
        why = next((line.strip() for line in err.splitlines()
                    if "Error" in line or "what()" in line), "")
        result["ops"][op] = "ok" if rc == 0 and len(found) == 2 else f"refused: {why[:200]}"
    rc, found, err = _torchrun(args.ranks, "timing")
    if rc != 0:
        print(err[-4000:], file=sys.stderr)
        return 1
    result["timing"] = {"ranks": args.ranks, "D": D, "per_rank": found}
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
