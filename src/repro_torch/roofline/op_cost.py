"""Per-rank op cost counter: the counterpart of
``src/repro/roofline/hlo_cost.py``.

The JAX package walks the compiled, SPMD-partitioned HLO of a step.  The
port has no HLO: it runs the step op by op under :class:`CostCounter`, a
``TorchDispatchMode``, usually on the ``meta`` device (shapes only).
Every number is one rank's:

- On a DTensor op the mode returns ``NotImplemented``, so the DTensor
  dispatch runs (sharding propagation, any redistribution, the op on the
  local shards) with the mode still on the stack: the mode then sees the
  LOCAL ops and the collectives the redistribution issues, never the
  global shapes.  (Counting at the DTensor level would count global
  shapes: ``FlopCounterMode`` around DTensor ops on a fake 256-rank mesh
  gives every rank the whole mesh's FLOPs.)  The shape inference that
  sharding propagation runs under ``FakeTensorMode`` is skipped.
- FLOPs: matmuls, batched matmuls, convolutions and attention by
  ``torch.utils.flop_counter``'s formulas (2·M·N·K); a reduction counts its
  input's elements, a view, copy or factory op nothing, and any other op
  its output's elements (the HLO walk's rules for reduce, copy and
  elementwise ops).  FLOPs are also kept by the matmul's input dtype.
- Bytes accessed: every op's tensor inputs and outputs, views excluded.
  Eager PyTorch runs each op as its own kernel, so this is the traffic an
  unfused step moves (the HLO walk counts at fusion boundaries instead).
  ``by_shape`` attributes those bytes to the op's output shape, keyed as
  HLO prints it (``f32[4,32,4096,4096]``), which ``kernel_credit`` reads.
- Collective bytes: the input bytes of each functional collective
  (``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single``), by kind as HLO names them, and by link: a group
  whose ranks all lie in one node of :data:`RANKS_PER_NODE` consecutive
  ranks rides NVLink, any other group InfiniBand.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode
from torch.utils.flop_counter import flop_registry

__all__ = ["RANKS_PER_NODE", "Cost", "CostCounter", "count_cost", "shape_key"]

RANKS_PER_NODE = 8  # GPUs a node joined by NVLink (an H100 HGX board)

_HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.int32: "s32", torch.int64: "s64", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64",
}
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std", "var_mean",
    "logsumexp", "norm", "linalg_vector_norm", "any", "all", "argmax", "argmin", "cumsum",
}
_NO_FLOPS = {
    "clone", "copy_", "copy", "contiguous", "empty", "empty_like", "empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros", "new_empty",
    "new_full", "new_ones", "arange", "scalar_tensor", "lift_fresh", "detach", "alias",
    "fill_", "zero_",
}
_SKIP = {"wait_tensor", "_wrap_tensor_autograd", "detach", "lift_fresh", "alias", "device"}


def shape_key(t: torch.Tensor) -> str:
    """HLO's spelling of a tensor's type: ``bf16[4,4096,2048]``."""
    return f"{_HLO_DTYPE.get(t.dtype, str(t.dtype))}[{','.join(str(d) for d in t.shape)}]"


def _tensors(xs) -> list[torch.Tensor]:
    """The tensors among ``xs`` and in its lists and tuples (an op's
    arguments nest no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict[str, float] = dataclasses.field(default_factory=dict)
    # collective bytes by link: "nvlink" inside a node, "ib" across nodes
    coll_by_link: dict[str, float] = dataclasses.field(default_factory=dict)
    # output shape -> bytes in + out of the ops that wrote it
    by_shape: dict[str, float] = dataclasses.field(default_factory=dict)
    # matmul FLOPs by the dtype of their inputs (the rest in "other")
    mm_flops_by_dtype: dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        """Add ``other`` ``mult`` times (a loop body's cost by its trips)."""
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for mine, theirs in ((self.coll, other.coll), (self.coll_by_link, other.coll_by_link),
                             (self.by_shape, other.by_shape),
                             (self.mm_flops_by_dtype, other.mm_flops_by_dtype)):
            for k, v in theirs.items():
                _add(mine, k, v * mult)

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    def top_shapes(self, n: int = 12) -> list[tuple[str, float]]:
        return sorted(self.by_shape.items(), key=lambda kv: -kv[1])[:n]


def _add(d: dict, k, v: float) -> None:
    d[k] = d.get(k, 0.0) + v


class CostCounter(TorchDispatchMode):
    """Counts one rank's cost of every op run under it into ``self.cost``."""

    def __init__(self) -> None:
        super().__init__()
        self.cost = Cost()
        self._links: dict[str, str] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # the DTensor dispatch runs its local ops under this mode
        out = func(*args, **kwargs)
        if FakeTensor in types or isinstance(_get_current_dispatch_mode(), FakeTensorMode):
            return out  # sharding propagation's shape inference
        self._count(func, args, kwargs, out)
        return out

    def _link(self, group_name: str) -> str:
        if group_name not in self._links:
            from torch.distributed.distributed_c10d import _resolve_process_group

            ranks = dist.get_process_group_ranks(_resolve_process_group(group_name))
            nodes = {r // RANKS_PER_NODE for r in ranks}
            self._links[group_name] = "nvlink" if len(nodes) == 1 else "ib"
        return self._links[group_name]

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        if name in _SKIP:
            return
        c = self.cost
        ins = _tensors((*args, *kwargs.values()))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        in_b = sum(_nbytes(t) for t in ins)
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            _add(c.coll, kind, in_b)
            _add(c.coll_by_link, self._link(args[-1]), in_b)
            c.bytes += in_b + sum(_nbytes(o) for o in outs)
            return
        if func.is_view or not outs:
            return
        out_b = sum(_nbytes(o) for o in outs)
        c.bytes += in_b + out_b
        _add(c.by_shape, shape_key(outs[0]), in_b + out_b)
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            _add(c.mm_flops_by_dtype, _HLO_DTYPE.get(ins[0].dtype, "other"), f)
        elif name in _NO_FLOPS:
            f = 0.0
        elif name.rstrip("_") in _REDUCTIONS:
            f = float(max((t.numel() for t in ins), default=0))
        else:
            f = float(outs[0].numel())
        c.flops += f


def count_cost(fn, *args, **kwargs) -> tuple[object, Cost]:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter`; returns
    (its result, the cost)."""
    counter = CostCounter()
    with counter:
        res = fn(*args, **kwargs)
    return res, counter.cost
