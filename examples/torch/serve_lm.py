"""Coded-serving example on the PyTorch port: an arrival trace through the
ServingEngine (the counterpart of ``examples/serve_lm.py``).

A Poisson stream of requests flows through the full DESIGN.md §9 lifecycle:
queue → admission → coded prefill across a heterogeneous replica pool (the
SLO policy answers from the first decodable replica subset; 30% of replicas
straggle) → continuous-batched decode (requests join/leave the running batch
mid-flight) → per-request completions with TTFT/latency records.

Prints the per-request table plus the p50/p99 summary, including the
wait-for-all counterfactual the coded prefill is beating.  Runs on the CUDA
card; ``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python examples/torch/serve_lm.py [arch] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.approx.deadline import SLOPolicy
from repro_torch.configs import get_config
from repro_torch.core.straggler import FixedDelayStragglers
from repro_torch.models.lm import build_model
from repro_torch.serve import ReplicaPool, Request, ServingEngine
from repro_torch.train.serve import LMServer

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("arch", nargs="?", default="mamba2-370m")
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()
dev = torch.device(args.device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("--device cuda: no CUDA device is available (pass --device cpu)")

cfg = get_config(args.arch).reduced()
model = build_model(cfg)
params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
server = LMServer(model)

# heterogeneous replica pool: m=8, speeds 1-4x, 2 stragglers (25%) per request
rng = np.random.default_rng(0)
m, s = 8, 2
pool = ReplicaPool(
    rng.uniform(1.0, 4.0, m), s=s, k=2 * m,
    straggler_model=FixedDelayStragglers(s=s, delay=5.0),
    policy=SLOPolicy.for_slo(ttft_slo_s=np.inf),  # exact-first: earliest decodable subset
    seed=0,
)

engine = ServingEngine(
    server, params, n_slots=4, cache_len=48, replicas=pool, decode_dt=0.01
)

# Poisson arrivals, mixed prompt lengths and budgets
n = 16
arrivals = np.cumsum(rng.exponential(0.3, n))
requests = [
    Request(
        rid=i,
        tokens=rng.integers(0, cfg.vocab, (int(rng.integers(8, 24)),)),
        max_new_tokens=int(rng.integers(6, 14)),
        arrival_t=float(arrivals[i]),
    )
    for i in range(n)
]

completions, metrics = engine.run(requests)

print(f"arch={cfg.name} slots=4 replicas(m={m}, {s} stragglers/request) device={dev}")
print("rid,prompt,new,ttft_s,latency_s,waitall_ttft_s,replicas_used,exact")
for c in completions:
    r = c.record
    waitall_ttft = r.prefill_all_done_t - r.arrival_t + (r.first_token_t - r.prefill_done_t)
    print(f"{c.rid},{len(requests[c.rid].tokens)},{r.n_tokens},"
          f"{r.ttft:.3f},{r.latency:.3f},{waitall_ttft:.3f},"
          f"{r.replicas_used},{r.prefill_exact}")

s_ = metrics.summary()
ttft_all = [r.prefill_all_done_t - r.arrival_t for r in metrics.records]
print(f"\nrequests={int(s_['n_requests'])} tokens={int(s_['total_tokens'])} "
      f"throughput={s_['tokens_per_s']:.1f} tok/s (virtual clock)")
print(f"TTFT    p50={s_['ttft_p50_s']:.3f}s  p99={s_['ttft_p99_s']:.3f}s "
      f"(wait-for-all p99={np.percentile(ttft_all, 99):.3f}s)")
print(f"latency p50={s_['latency_p50_s']:.3f}s  p99={s_['latency_p99_s']:.3f}s  "
      f"queue_wait_mean={s_['queue_wait_mean_s']:.3f}s")
print(f"prefill exact={s_['prefill_exact_fraction']:.2f} "
      f"replicas_used_mean={s_['replicas_used_mean']:.1f}/{m}")
assert len(completions) == n and int(s_["n_requests"]) == n, "every request completes"
