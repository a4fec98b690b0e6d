"""Activation-sharding anchors and DTensor layouts (the port of
``src/repro/models/sharding.py``).

A layout is a *spec*: a tuple with one entry a tensor dim, each entry a
mesh-axis name, a tuple of names, or None (JAX's ``PartitionSpec``).
:meth:`LM.param_specs` and :meth:`LM.fsdp_specs` give the parameters';
:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` whose dims are named (``("data", "model")`` or ``("pod",
"data", "model")``), and :func:`distribute` places a tensor by it.

``shard_batch`` pins the batch dim of an activation to the data axes, as
JAX's ``with_sharding_constraint(x, P(dp))`` does: the dim sharded over the
data axes and every other mesh axis replicated.  It is a no-op unless the
launcher installed axes (:func:`set_activation_axes`), unless the dim does
not divide by their size, and on a plain tensor, so single-device paths and
the CPU tests never see it.

The other helpers are the explicit redistributions the functional LM needs
where DTensor's own sharding rules fall short (each a no-op on a plain
tensor): :func:`reduce_partial` after a row-parallel output,
:func:`gather_data_shards` for FSDP, :func:`embedding` over vocab-sharded
rows, :func:`split_dim` / :func:`unshard_dim` where a sharded dim cannot be
split or unbound, :func:`on_local_rows` for the SSD scan, and
:func:`on_cache_shards` for one-token decode over a sharded KV cache.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

__all__ = [
    "activation_axes", "distribute", "embedding", "gather_data_shards", "on_cache_shards",
    "on_local_rows",
    "placements", "reduce_partial", "set_activation_axes", "shard_batch", "split_dim",
    "unshard_dim",
]

_ACT_AXES: tuple[str, ...] | None = None
_ACT_SIZE: int = 1


def set_activation_axes(axes: Sequence[str] | None, size: int = 1) -> None:
    global _ACT_AXES, _ACT_SIZE
    _ACT_AXES = tuple(axes) if axes else None
    _ACT_SIZE = size


@contextlib.contextmanager
def activation_axes(axes: Sequence[str] | None, size: int = 1):
    global _ACT_AXES, _ACT_SIZE
    prev, prev_size = _ACT_AXES, _ACT_SIZE
    set_activation_axes(axes, size)
    try:
        yield
    finally:
        _ACT_AXES, _ACT_SIZE = prev, prev_size


def shard_batch(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Redistribute dim ``dim`` of a DTensor to the data axes, every other
    mesh axis replicated, and its gradient with it (no-op if unset, if the
    dim isn't divisible by the axes' total size, or on a plain tensor)."""
    if _ACT_AXES is None or x.shape[dim] % _ACT_SIZE != 0 or x.shape[dim] < _ACT_SIZE:
        return x
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    spec = [None] * x.ndim
    spec[dim] = _ACT_AXES
    mesh = x.device_mesh
    want = placements(tuple(spec), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    # the cotangent is pinned too, as JAX's constraint pins it: a gradient
    # that arrives as a pending sum over 'model' (from the column-parallel
    # projections this activation feeds) is reduced here, Megatron's
    # backward all-reduce, instead of flowing on unreduced
    return DTensor.from_local(x.to_local(grad_placements=want), mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


def unshard_dim(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """A DTensor with dim ``dim`` gathered whole (its other placements
    kept): FSDP shards the stacked-layer dim, which ``unbind`` and the
    per-layer index cannot split.  A plain tensor is returned as it is."""
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Shard) and p.dim == dim for p in x.placements):
        return x
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in x.placements)
    return x.redistribute(x.device_mesh, want)


def gather_data_shards(x: torch.Tensor) -> torch.Tensor:
    """A parameter's FSDP shards gathered for use: ``Shard`` on the data
    axes made whole, its ``model`` shards kept (a no-op unless axes are
    installed, and on a plain tensor).  Its gradient is then reduced and
    scattered back, FSDP's reduce-scatter.  Left sharded over ``data``, a
    weight meets batch-sharded activations on the same mesh dim and DTensor
    picks a partial sum of the activations instead."""
    if _ACT_AXES is None or not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    want = tuple(Replicate() if n in _ACT_AXES and isinstance(p, Shard) else p
                 for n, p in zip(names, x.placements))
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums carried out (``Partial`` -> ``Replicate``),
    its shards kept.  The vocab-sharded embedding's output is such a sum
    under a mask that one reduction consumes: reduced where it is made, a
    checkpointed repeat that recomputes from it never reduces it twice."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x.redistribute(x.device_mesh, want)


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``.  On a table sharded over its vocab
    rows (mesh dim v) every rank looks up the tokens in its own rows, zeros
    elsewhere, and the output is a ``Partial`` sum over v: exactly one rank
    holds each token's row, so the sum is the plain lookup bit for bit.
    The table's other mesh dims are gathered first (FSDP shards its width
    over ``data``); the tokens keep their batch sharding, and the table's
    gradient is a ``Partial`` sum over the mesh dims that split the batch.
    (DTensor's own rule picks a column split that replicates the batch.)"""
    vocab_dims = [i for i, p in enumerate(getattr(table, "placements", ()))
                  if isinstance(p, Shard) and p.dim == 0]
    if not vocab_dims:
        return F.embedding(tokens, table)
    v, mesh = vocab_dims[0], table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if not tokens.placements[v].is_replicate():
        tokens = tokens.redistribute(mesh, [*tokens.placements[:v], Replicate(),
                                            *tokens.placements[v + 1:]])
    tab_pl = [Shard(0) if i == v else Replicate() for i in range(mesh.ndim)]
    grad_pl = [Shard(0) if i == v else (Partial() if tokens.placements[i].is_shard()
                                        else Replicate()) for i in range(mesh.ndim)]
    tab = table.redistribute(mesh, tab_pl).to_local(grad_placements=grad_pl)
    _, start = Shard.local_shard_size_and_offset(table.shape[0], mesh.size(v),
                                                 mesh.get_local_rank(v))
    tok = tokens.to_local().long() - start
    mine = (tok >= 0) & (tok < tab.shape[0])
    out = F.embedding(torch.where(mine, tok, 0), tab).masked_fill(~mine[..., None], 0)
    out_pl = [Partial() if i == v else p for i, p in enumerate(tokens.placements)]
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def split_dim(x: torch.Tensor, dim: int, sizes: tuple[int, ...]) -> torch.Tensor:
    """``x`` with dim ``dim`` reshaped into ``sizes``.  A DTensor sharded on
    that dim over a mesh dim that does not divide ``sizes[0]`` (8 KV heads
    over 16 ranks) has it gathered first: DTensor cannot split it there,
    where GSPMD would reshard."""
    dim = dim % x.ndim
    if isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim == dim and sizes[0] % x.device_mesh.size(i)
            for i, p in enumerate(x.placements)):
        x = unshard_dim(x, dim)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def on_local_rows(fn, *xs: torch.Tensor, n_out: int = 1):
    """``fn(*xs)`` for a function of independent batch rows (leading dim)
    returning ``n_out`` such tensors.  On DTensors it runs on each rank's
    own rows (``local_map``): the inputs redistributed to the batch anchor's
    layout (the leading dim over the data axes, the rest whole), so a long
    loop of small ops (the SSD scan's chunks) pays DTensor's dispatch once."""
    if not isinstance(xs[0], DTensor):
        return fn(*xs)
    from torch.distributed.tensor.experimental import local_map

    mesh = xs[0].device_mesh
    rows = _ACT_AXES is not None and xs[0].shape[0] % _ACT_SIZE == 0 \
        and xs[0].shape[0] >= _ACT_SIZE
    pl = placements((_ACT_AXES,) if rows else (), mesh)
    out_pl = pl if n_out == 1 else (pl,) * n_out
    return local_map(fn, out_placements=out_pl, in_placements=(pl,) * len(xs),
                     redistribute_inputs=True, device_mesh=mesh)(*xs)


def on_cache_shards(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kc: DTensor, vc: DTensor, pos: torch.Tensor) -> DTensor:
    """One-token decode on each rank's own rows of a (B, S_c, K, hd) KV
    cache DTensor, its layout kept: ``fn(q, k, v, kc, vc, pos, start=,
    S_c=, reduce=)`` runs under ``local_map`` on the local shards, with
    ``start`` the first sequence row this rank holds and ``reduce(t, op)``
    an all-reduce (``"max"``, ``"sum"``) over the mesh dims that shard the
    sequence (the identity where none does).  q, k, v and pos are
    redistributed to the cache's batch layout (its batch shards, every
    other mesh dim replicated); ``fn`` writes its new rows into the local
    cache shards in place and returns the (B, 1, ·) output in that layout.

    DTensor's own rules cannot take this cache: its ``index_copy_`` moves
    the cache's model shards from the sequence to the head dim, in place,
    and its einsums then view the uneven local shards of a head dim (2 or
    8 KV heads over 16 ranks) at global shapes.  GSPMD keeps the sequence
    sharded, reduces the softmax across the shards and sums the partial
    outputs, and so does this: three all-reduces a layer, of the (B, K, G)
    max and sum and the (B, H·hd) f32 output, counted by the dry run."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map

    mesh = kc.device_mesh
    if tuple(vc.placements) != tuple(kc.placements):
        raise ValueError(f"k and v caches differ in layout: {kc.placements} / {vc.placements}")
    cache_pl = tuple(kc.placements)
    rows_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
                    for p in cache_pl)
    seq_dims = [i for i, p in enumerate(cache_pl) if isinstance(p, Shard) and p.dim == 1]
    S_c = kc.shape[1]
    n_shards = 1
    for i in seq_dims:
        n_shards *= mesh.size(i)
    if S_c % n_shards:
        raise ValueError(f"cache of {S_c} rows does not split evenly over {n_shards} ranks")
    # the chunk index of this rank's rows: DTensor splits the sequence over
    # its mesh dims in mesh order, the first the major one
    coord, chunk = mesh.get_coordinate(), 0
    for i in seq_dims:
        chunk = chunk * mesh.size(i) + coord[i]

    def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        for i in seq_dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, i)))
        return t

    def local(*xs):
        return fn(*xs, start=chunk * (S_c // n_shards), S_c=S_c, reduce=reduce)

    args = (q, k, v, kc, vc, pos)
    in_pl = tuple(
        None if not isinstance(x, DTensor)
        else cache_pl if x is kc or x is vc
        else rows_pl if x.dim() else (Replicate(),) * mesh.ndim
        for x in args)
    return local_map(local, out_placements=(rows_pl,), in_placements=in_pl,
                     redistribute_inputs=True, device_mesh=mesh)(*args)


def placements(spec: tuple, mesh) -> tuple:
    """A spec's DTensor placements on ``mesh``: ``Shard(i)`` on each mesh
    dim that names tensor dim i, ``Replicate()`` on the rest.  A dim over
    several axes is sharded over them in mesh order (JAX's major-to-minor
    order for the data axes)."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {name!r} names dims {dims} of spec {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def distribute(t: torch.Tensor, spec: tuple, mesh) -> DTensor:
    """Place ``t`` (the same full tensor on every rank) by ``spec``: each
    rank keeps its own slice, nothing is sent (``src_data_rank=None``);
    a dim that does not divide splits as ``torch.chunk`` does, so rank 0
    holds the ceil-divided shard."""
    return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None)
