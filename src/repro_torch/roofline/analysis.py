"""Three-term roofline of one step on the NVIDIA H100 (the port of
``src/repro/roofline/analysis.py``).

    compute    = FLOPs_per_rank / peak_FLOPs                      [s]
    memory     = bytes_per_rank / HBM_bw                          [s]
    collective = nvlink_bytes / NVLINK_BW + ib_bytes / IB_BW      [s]

Sources: ``roofline/op_cost.py`` counts one rank's FLOPs, bytes accessed
and collective bytes op by op (the JAX module reads them off the compiled
HLO).  Hardware model, one H100 SXM5 (NVIDIA's datasheet, dense, without
sparsity): 989.4 TFLOP/s bf16, 3.35 TB/s HBM3; NVLink 4 at 450 GB/s a
direction among the 8 GPUs of a node; 50 GB/s a GPU between nodes (one
400 Gb/s InfiniBand NIC a GPU).  A collective over a group that spans more
than one node of 8 is priced at the InfiniBand rate.
"""

from __future__ import annotations

import dataclasses

from repro_torch.roofline.op_cost import Cost

PEAK_FLOPS = 989.4e12  # bf16 dense, per GPU (H100 SXM5 datasheet)
HBM_BW = 3.35e12  # B/s per GPU, HBM3
NVLINK_BW = 450e9  # B/s a direction per GPU, NVLink 4 inside a node of 8
IB_BW = 50e9  # B/s per GPU across nodes, 400 Gb/s InfiniBand


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict[str, int]
    model_flops_total: float  # 6·N·D (or 2·N_active per processed token)
    peak_mem_per_chip: float | None = None
    coll_by_link: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        nv = self.coll_by_link.get("nvlink", 0.0)
        return nv / NVLINK_BW + (self.coll_bytes_per_chip - nv) / IB_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs of all ranks: remat and redundancy."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        t = self.step_time
        return self.model_flops_total / (self.chips * PEAK_FLOPS * t) if t else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_total,
            "hlo_flops_total": self.flops_per_chip * self.chips,
            "useful_ratio": self.useful_flops_ratio, "mfu_at_roofline": self.mfu,
            "coll_breakdown": self.coll_breakdown,
            "peak_mem_per_chip": self.peak_mem_per_chip,
        }


def analyze_cost(
    cost: Cost, *, arch: str, shape: str, mesh_name: str, chips: int, model_flops: float,
) -> RooflineReport:
    """The three terms of one rank's counted cost (JAX's
    ``analyze_compiled``; ``hlo_flops_total`` keeps its name in the row
    and is the counted FLOPs of all ranks).  ``peak_mem_per_chip`` stays
    None: the meta step has no counterpart of XLA's memory analysis."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=cost.flops, bytes_per_chip=cost.bytes,
        coll_bytes_per_chip=cost.coll_bytes,
        coll_breakdown={k: int(v) for k, v in cost.coll.items()},
        model_flops_total=model_flops,
        coll_by_link=dict(cost.coll_by_link),
    )
