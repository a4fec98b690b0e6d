"""Kernel-substitution accounting (the port of
``src/repro/launch/kernel_credit.py``).

The dry run runs the models' plain attention (``launch/dryrun.py``), which
writes S×S score tensors to HBM; the flash kernel
(``kernels/csrc/flash_attention.cu``) keeps score tiles on chip.  This tool
makes the substitution measured-then-analytic: it finds the score-family
tensors in the dry run's byte traffic by output shape (``op_cost``'s
``by_shape``: shapes whose trailing dims are q-tile × S or S × S), removes
exactly that counted traffic, and adds the kernel's own HBM traffic (Q, K,
V read and O written, ×3 for forward, backward and remat), priced on the
H100 (``roofline/analysis.py``).  ``--out`` keeps each cell's dry-run row
(``dryrun_row``) beside its record.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.kernel_credit \\
      --cells smollm-360m:train_4k:single:dp_all mamba2-370m:train_4k:single:dp_all \\
              jamba-1.5-large-398b:train_4k:multi:baseline
"""

from __future__ import annotations

import argparse
import json
import os
import re

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import lower_cell
from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS


def score_family(shape_key: str, S: int) -> bool:
    m = re.match(r"\w+\[([0-9,]+)\]", shape_key)
    if not m:
        return False
    dims = [int(d) for d in m.group(1).split(",")]
    if len(dims) < 2:
        return False
    a, b = dims[-2], dims[-1]
    # (…, q_tile, S) / (…, S, S) score blocks and their (…, G*q, S)/(…, S, G*q)
    # transposes — the tensors a fused flash kernel never sends to HBM
    is_tile = lambda x: x == S or (x % 512 == 0 and x <= S)  # noqa: E731
    return (b == S and is_tile(a)) or (a == S and is_tile(b))


def flash_hbm_bytes(cfg, tokens_per_chip: float) -> float:
    """Q,K,V read + O write per attention layer, bf16, x3 (fwd, bwd, remat)."""
    hd = cfg.resolved_head_dim
    width = (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    n_attn = sum(
        1 for l in range(cfg.n_layers)
        if cfg.family not in ("ssm",)
        and (cfg.family != "hybrid" or l % cfg.attn_period == cfg.attn_offset)
    )
    return 3.0 * tokens_per_chip * width * 2 * n_attn


def credit(cell: str, row: dict) -> dict:
    """One cell's record from its dry-run row (``lower_cell``'s, with
    ``by_shape``)."""
    arch, shape_name, _, _ = cell.split(":")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    total = row["bytes_per_chip"]
    # attention-free archs have no score tensors (the shape rule would
    # false-positive on SSD chunk tensors); the SSD kernel's HBM savings are
    # NOT credited here
    if cfg.family == "ssm":
        scores = 0.0
    else:
        scores = sum(v for k, v in row["by_shape"].items() if score_family(k, shape.seq_len))
    chips = row["chips"]
    coded = 2.0 if shape.kind == "train" else 1.0  # s=1 replication
    tokens_per_chip = coded * shape.global_batch * shape.seq_len / chips
    kernel = flash_hbm_bytes(cfg, tokens_per_chip)
    new_bytes = total - scores + kernel
    rec = {
        "cell": cell,
        "bytes_per_chip_xla": total,
        "score_family_bytes": scores,
        "score_share": scores / total,
        "flash_kernel_bytes": kernel,
        "bytes_per_chip_kernelized": new_bytes,
        "t_memory_xla_s": total / HBM_BW,
        "t_memory_kernelized_s": new_bytes / HBM_BW,
        "t_compute_s": row["t_compute_s"],
        "t_collective_s": row["t_collective_s"],
        "step_time_kernelized_s": max(new_bytes / HBM_BW, row["t_compute_s"],
                                      row["t_collective_s"]),
        "model_flops": row["model_flops"],
    }
    rec["mfu_kernelized"] = rec["model_flops"] / (chips * PEAK_FLOPS
                                                  * rec["step_time_kernelized_s"])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", required=True,
                    help="arch:shape:mesh:variant entries")
    ap.add_argument("--out", default="results/perf/kernel_credit.json")
    args = ap.parse_args(argv)

    out = []
    for cell in args.cells:
        arch, shape_name, mesh, variant = cell.split(":")
        row = lower_cell(arch, shape_name, multi_pod=(mesh == "multi"), verbose=False,
                         variant=variant)
        rec = credit(cell, row)
        out.append({**rec, "dryrun_row": {k: v for k, v in row.items() if k != "by_shape"}})
        print(json.dumps(rec, indent=1))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
