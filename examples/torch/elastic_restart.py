"""Elastic restart AND in-place elastic membership, on the PyTorch port
(the counterpart of ``examples/elastic_restart.py``).

Phase 1: train on m=4 heterogeneous workers with transient stragglers,
         checkpointing asynchronously.
Phase 2: "the two fast VMs are reclaimed" — restart from the checkpoint on a
         DIFFERENT cluster (m=6, different speeds).  The coding scheme,
         allocation, and decode tables are rebuilt from scratch in
         milliseconds (Alg. 1 is O(mk^2) host-side); model state restores
         exactly; training continues from the same loss.
Phase 3: no restart at all (DESIGN.md §8) — one VM leaves and two join IN
         PLACE: `trainer.remove_workers` / `add_workers` remap the slot
         plan with bounded data movement (retained workers keep their
         partitions wherever the new load shares allow) and re-solve only
         the disturbed Alg. 1 columns; training never stops.

Runs on the CUDA card; ``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python examples/torch/elastic_restart.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.configs import CodingConfig, TrainConfig, get_config
from repro_torch.core.straggler import TransientStragglers
from repro_torch.data.pipeline import SyntheticData
from repro_torch.models.lm import build_model
from repro_torch.train.trainer import CodedTrainer, TrainerState

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
dev = torch.device(ap.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("--device cuda: no CUDA device is available (pass --device cpu)")

cfg = get_config("smollm-360m").reduced()
model = build_model(cfg)
tc = TrainConfig(lr=1e-3, warmup_steps=3, total_steps=60)
ckdir = tempfile.mkdtemp(prefix="elastic_")

def make(m, speeds, part_mb):
    return CodedTrainer(model, CodingConfig(scheme="heter_aware", s=1), tc,
                        m=m, part_mb=part_mb, straggler_model=TransientStragglers(p=0.1),
                        true_speeds=np.asarray(speeds), device=dev)

# ---- phase 1: m=4 ----
tr = make(4, [1, 2, 4, 4], part_mb=3)
data = SyntheticData(cfg, k=tr.k, part_mb=3, seq_len=32)
state = tr.init_state(0)
ck = AsyncCheckpointer(ckdir)
for step in range(12):
    state, met = tr.step(state, data.batch(step))
    if (step + 1) % 6 == 0:
        ck.save(step + 1, {"params": state.params, "opt": state.opt},
                meta={"m": 4, "loss": met["loss"]})
ck.wait()
print(f"phase 1 (m=4): step 12 loss {met['loss']:.4f}, checkpoint at {ckdir}")

# ---- phase 2: cluster changed to m=6, different speeds ----
tr2 = make(6, [1, 1, 2, 2, 3, 3], part_mb=2)
data2 = SyntheticData(cfg, k=tr2.k, part_mb=2, seq_len=32)
last = latest_step(ckdir)
tmpl = tr2.init_state(1)
restored, meta = restore_checkpoint(ckdir, last, {"params": tmpl.params, "opt": tmpl.opt})
state2 = TrainerState(params=restored["params"], opt=restored["opt"], step=last)
print(f"restored step {last} (saved on m={meta['m']}, resuming on m=6; "
      f"new allocation n_i = {tr2.scheme.allocation.counts})")
for step in range(last, last + 10):
    state2, met2 = tr2.step(state2, data2.batch(step))
print(f"phase 2 (m=6): step {state2.step} loss {met2['loss']:.4f} "
      f"(continued from {meta['loss']:.4f})")
assert met2["loss"] < meta["loss"] * 1.1, "loss should continue falling after elastic restart"
print("elastic restart OK")

# ---- phase 3: in-place membership change, no restart (DESIGN.md §8) ----
stats = tr2.remove_workers([1])                 # a slow VM is reclaimed
stats2 = tr2.add_workers([4.0, 4.0])            # two fast ones join
print(f"phase 3 (m={tr2.m} in place): leave moved {stats.moved} copies "
      f"(bound {stats.bound}), join moved {stats2.moved} "
      f"(re-solved {stats2.changed_columns}/{tr2.k} B columns)")
for step in range(state2.step, state2.step + 6):
    state2, met3 = tr2.step(state2, data2.batch(step))
assert met3["membership_epoch"] == 2.0
print(f"phase 3: step {state2.step} loss {met3['loss']:.4f} — "
      f"in-place elastic membership OK on {dev}")
