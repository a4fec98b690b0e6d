"""Process groups for the spmd backend across processes (the port of
``src/repro/launch/mesh.py``).

The JAX launcher lays the m coded workers on an ``(m, 1)`` ``("data",
"model")`` mesh, one device a worker.  Here each coded worker is one
``torch.distributed`` rank: worker w runs on rank w, and the coded group is
ranks 0..m-1 of the world (:class:`CodedGroup`).  The model extent stays 1,
so a group at m needs m ranks (:func:`mesh_devices_for_m`); ranks past m
wait outside the group until membership grows.

Transport.  NCCL when every rank of the host has a card of its own, gloo
when ranks share a card (NCCL refuses two ranks on one GPU).  The choice is
made once from the topology, logged, and never changed after a failure.
Gloo moves CUDA tensors through host memory: its ``all_reduce``,
``broadcast``, ``all_gather_into_tensor``, ``gather`` and ``scatter`` take a
CUDA tensor and stage it themselves (torch 2.11, probed on the H100 by
``scripts/gloo_cuda_probe.py``).  Its ``send``/``recv`` do not: they abort
the process (``writev ... Bad address``), so :func:`send_recv_rows` stages
them explicitly through a pinned host buffer (:func:`_p2p_tensor`).
``all_gather_into_tensor`` is called with a flat ``(m·n,)`` output: gloo
refuses a 2-D ``(m, n)`` one.

Every function that builds a group (:func:`remesh_for_m`) must be called by
every rank of the world, members or not, in the same order.

The production mesh of a large-model run (:func:`make_production_mesh`,
:func:`data_axes`, :func:`coded_workers`) is a named ``DeviceMesh`` over
the whole world: 16×16 ``("data", "model")`` or 2×16×16 ``("pod", "data",
"model")``, 256 or 512 ranks, the JAX package's shapes.  ``model`` carries
tensor parallelism, ``data`` (and ``pod``) the coded workers and FSDP.
The dry run builds it over a fake process group of that world size
(``launch/dryrun.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "CodedGroup",
    "launched_by_torchrun",
    "init_coded_group",
    "rank_device",
    "transport_for",
    "coded_axis_size",
    "mesh_devices_for_m",
    "remesh_for_m",
    "all_reduce_sum_",
    "all_gather_flat",
    "broadcast_",
    "broadcast_array",
    "all_gather_objects",
    "send_recv_rows",
    "gather_to_first",
    "scatter_from_first",
    "barrier",
    "make_production_mesh",
    "data_axes",
    "coded_workers",
]

_log = logging.getLogger(__name__)

@dataclasses.dataclass(frozen=True)
class CodedGroup:
    """The coded workers' process group as one rank sees it.

    ``pg`` is the ``torch.distributed`` group of ranks 0..m-1 (the default
    world group when m is the world size), or None on a rank outside it.
    Worker w of the codec is rank w.  ``transport`` is the backend of every
    group of the world (``why`` says what in the topology chose it),
    ``device`` this rank's device."""

    m: int
    pg: object | None
    rank: int
    world_size: int
    transport: str
    device: torch.device
    why: str = ""

    @property
    def member(self) -> bool:
        return self.rank < self.m


def launched_by_torchrun() -> bool:
    """True when the process environment names a rank and a world, as
    ``python -m torch.distributed.run`` sets it."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` (ranks beyond
    the card count share cards), or the CPU when the caller asks for it."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this rank (pass device='cpu')")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def transport_for(device: torch.device, local_world: int) -> tuple[str, str]:
    """(backend, reason) from the topology alone: NCCL when every rank of
    this host has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if cards >= local_world and dist.is_nccl_available():
        return "nccl", f"{local_world} ranks on {cards} cards, one card a rank"
    why = "NCCL is not built" if not dist.is_nccl_available() else "NCCL needs a card a rank"
    return "gloo", f"{local_world} ranks share {cards} card(s) ({why})"


def init_coded_group(device: str = "cuda", init_method: str = "env://") -> CodedGroup:
    """Join the world named by ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
    (``LOCAL_WORLD_SIZE`` for the topology, default the world size) and
    return the group of all its ranks.  ``init_method`` is ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``, as ``torch.distributed.run`` sets
    them) or any other URL ``init_process_group`` takes, e.g. a
    ``file://`` store."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(device)
    backend, reason = transport_for(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    _log.info("coded group: %s transport, %s", backend, reason)
    return CodedGroup(m=world, pg=dist.group.WORLD, rank=rank, world_size=world,
                      transport=backend, device=dev, why=reason)


def coded_axis_size(group: CodedGroup) -> int:
    """The coded-worker extent of ``group``: its size."""
    return group.m


def mesh_devices_for_m(m: int) -> int:
    """Ranks a group at worker count ``m`` needs: one a coded worker (the
    model extent is 1, as in the JAX launcher's ``(m, 1)`` mesh)."""
    return int(m)


def remesh_for_m(group: CodedGroup, m: int) -> CodedGroup:
    """The group of ranks 0..m-1 of ``group``'s world.  Every rank of the
    world must call it (``dist.new_group`` is collective over the world),
    the ranks that leave or stay outside the group too."""
    if m < 1:
        raise ValueError(f"worker count must be positive, got m={m}")
    needed = mesh_devices_for_m(m)
    if needed > group.world_size:
        raise ValueError(
            f"spmd group for m={m} needs {needed} ranks (1 per coded worker), "
            f"only {group.world_size} available"
        )
    if m == group.world_size:
        pg = dist.group.WORLD
    else:
        pg = dist.new_group(list(range(m)))
        if group.rank >= m:
            pg = None
    return dataclasses.replace(group, m=int(m), pg=pg)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _p2p_tensor(t: torch.Tensor, group: CodedGroup, copy_in: bool = True):
    """Yield what gloo's ``send``/``recv`` may touch: ``t`` itself, or, for
    a CUDA tensor, a pinned host copy that is written back into ``t``
    afterwards (gloo's p2p reads the CUDA pointer as a host address)."""
    if t.device.type != "cuda" or group.transport != "gloo":
        yield t
        return
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy_in:
        host.copy_(t)
    yield host
    t.copy_(host)


def _wire_tensor(group: CodedGroup, x: torch.Tensor) -> torch.Tensor:
    """Host values go over NCCL on this rank's card, over gloo on the CPU."""
    return x.to(group.device) if group.transport == "nccl" else x


def all_reduce_sum_(t: torch.Tensor, group: CodedGroup) -> torch.Tensor:
    """In-place sum of ``t`` over the coded group (JAX's ``psum``)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.pg)
    return t


def all_gather_flat(t: torch.Tensor, group: CodedGroup) -> torch.Tensor:
    """Every member's ``t`` (shape (n,) or ()) in rank order, as one flat
    ``(m·n,)`` tensor on ``t``'s device."""
    src = t.reshape(-1).contiguous()
    out = torch.empty((group.m * src.numel(),), dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():  # deprecated on newer torch, for all_gather_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group.pg)
    return out


def broadcast_(t: torch.Tensor) -> torch.Tensor:
    """In-place broadcast of rank 0's ``t`` to every rank of the world (the
    ranks outside the coded group too)."""
    dist.broadcast(t, src=0)
    return t


def broadcast_array(arr, group: CodedGroup) -> np.ndarray:
    """Rank 0's float64 host array, of a shape every rank knows, on every
    rank of the world, bit for bit (NaN included)."""
    x = _wire_tensor(group, torch.from_numpy(np.array(arr, np.float64, copy=True)))
    dist.broadcast(x, src=0)
    return x.cpu().numpy()


def all_gather_objects(obj, group: CodedGroup) -> list:
    """Every world rank's picklable ``obj``, in rank order, on every rank."""
    out = [None] * group.world_size
    dist.all_gather_object(out, obj)
    return out


def send_recv_rows(
    sends: list[tuple[int, torch.Tensor]], recvs: list[tuple[int, torch.Tensor]],
    group: CodedGroup,
) -> None:
    """Point-to-point over the world: each ``(peer, row)`` of ``sends`` goes
    to world rank ``peer``; each ``(peer, row)`` of ``recvs`` is filled from
    it.  All are posted before any is waited on, so a rank may send and
    receive in one exchange."""
    with contextlib.ExitStack() as stack:
        works = []
        for peer, row in sends:
            x = stack.enter_context(_p2p_tensor(row, group))
            works.append(dist.isend(x, dst=peer))
        for peer, row in recvs:
            x = stack.enter_context(_p2p_tensor(row, group, copy_in=False))
            works.append(dist.irecv(x, src=peer))
        for w in works:
            w.wait()


def gather_to_first(t: torch.Tensor, group: CodedGroup) -> torch.Tensor | None:
    """The members' ``t`` stacked ``(m, ...)`` on rank 0 (None elsewhere);
    called by the members only."""
    if group.rank != 0:
        dist.gather(t, None, dst=0, group=group.pg)
        return None
    out = torch.empty((group.m,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.gather(t, list(out.unbind(0)), dst=0, group=group.pg)
    return out


def scatter_from_first(rows: torch.Tensor | None, out: torch.Tensor, group: CodedGroup) -> None:
    """Row w of rank 0's ``(m, ...)`` ``rows`` into member w's ``out``;
    called by the members only."""
    if group.rank != 0:
        dist.scatter(out, None, src=0, group=group.pg)
        return
    dist.scatter(out, list(rows.to(out.device).unbind(0)), src=0, group=group.pg)


def barrier() -> None:
    """Wait for every rank of the world."""
    dist.barrier()


def make_production_mesh(multi_pod: bool = False, shape: tuple[int, ...] | None = None):
    """16×16 ``("data", "model")`` (256 ranks) or 2×16×16 ``("pod", "data",
    "model")`` (512 ranks) over the default process group, whose world size
    must be the mesh's.  ``shape`` replaces the extents (a small mesh for
    tests or one card), keeping the axis names.  The mesh's device type is
    the CPU: the gloo ranks of the tests and the dry run's fake world."""
    from torch.distributed.device_mesh import init_device_mesh

    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = tuple(shape) if shape is not None else ((2, 16, 16) if multi_pod else (16, 16))
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def data_axes(mesh) -> tuple[str, ...]:
    """The coded-worker axes of a production mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def coded_workers(mesh) -> int:
    return int(np.prod([mesh.size(mesh.mesh_dim_names.index(a)) for a in data_axes(mesh)]))
