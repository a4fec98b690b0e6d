"""Quickstart on the PyTorch port: the paper's scheme through the registry
API in ~40 lines.

Builds a heterogeneity-aware gradient code for a 5-worker cluster (the
paper's Example 1) via ``get_scheme``, shows that any single straggler is
survivable with zero time penalty, and decodes an exact gradient on a toy
model through a ``Codec``: the counterpart of ``examples/quickstart.py``.

Runs on the CUDA card; ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    Codec,
    ClusterSim,
    FixedDelayStragglers,
    get_scheme,
    scheme_names,
    theoretical_optimal_time,
)
from repro_torch.core.aggregator import fused_coded_value_and_grad

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
dev = torch.device(ap.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("--device cuda: no CUDA device is available (pass --device cpu)")

# --- the paper's Example 1: 5 workers with speeds 1:2:3:4:4, one straggler ---
c = np.array([1.0, 2.0, 3.0, 4.0, 4.0])
code = get_scheme("heter_aware", m=5, k=7, s=1, c=c, rng=0)  # any of scheme_names()
print("registered schemes:", ", ".join(scheme_names()))
print("allocation n_i:", code.allocation.counts)  # (1, 2, 3, 4, 4) — Eq. 5
print("C·B == 1:", np.allclose(code.scheme.C @ code.B, 1.0))

# --- any worker may die; iteration time stays at the Thm.5 optimum ---
sim = ClusterSim(code, c)
res = sim.run(FixedDelayStragglers(s=1, delay=np.inf), n_iters=100, rng=0)
print(f"iteration time with a fault every step: {res.mean_T:.4f}s "
      f"(optimum {theoretical_optimal_time(7, 1, c):.4f}s, failures={res.failures})")

# --- exact gradient recovery on real math, on the device ---
def loss_fn(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

rng = np.random.default_rng(0)
params = {"w": torch.as_tensor(rng.normal(size=(8,)), dtype=torch.float32, device=dev)}
batch = {"x": torch.as_tensor(rng.normal(size=(7, 4, 8)), dtype=torch.float32, device=dev),
         "y": torch.as_tensor(rng.normal(size=(7, 4)), dtype=torch.float32, device=dev)}

codec = Codec(code)  # device-feedable slot plan, shape-stable under rebalance
worker_3_died = [0, 1, 2, 4]
weights = codec.slot_weights(codec.decode_vector(worker_3_died))
loss, grads = fused_coded_value_and_grad(loss_fn)(
    params, codec.pack(batch), torch.as_tensor(weights, device=dev))

truth = {k: torch.zeros_like(v) for k, v in params.items()}
for j in range(7):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    g = torch.autograd.grad(loss_fn(leaves, {k: x[j] for k, x in batch.items()}), leaves["w"])
    truth["w"] += g[0] / 7
print("decoded grad == true grad (worker 3 dead):",
      bool(torch.allclose(grads["w"], truth["w"], atol=1e-5)))
print(f"device: {grads['w'].device}")
