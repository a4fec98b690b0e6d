"""Multi-pod dry run: run one step of every (arch × shape) cell on the
production mesh, shapes only, and read its roofline terms off the ops (the
port of ``src/repro/launch/dryrun.py``).

The JAX dry run lowers and compiles each cell for 256 or 512 host devices
forced by ``XLA_FLAGS`` and reads per-chip FLOPs, bytes and collectives off
the compiled HLO.  Here each cell runs eagerly on the ``meta`` device (no
storage, no kernel: the models' plain paths) as DTensors on a
``DeviceMesh`` over a fake process group (``FakeStore``, world 256 or 512,
rank 0's view), under ``roofline/op_cost.py``'s counter, which sees rank
0's local ops and the collectives DTensor issues.  A process holds one fake
world, so run the dry run in a process of its own, as the JAX one is for
its device count.

Layouts are the JAX dry run's: TP over ``model`` (``LM.param_specs``),
FSDP over ``data`` for training (``LM.fsdp_specs``; also for the serving
cells of the ``_BIG`` archs), the batch over the data axes, remat as the
config says, ``make_fused_train_step`` with the arch's accumulation, and
the ``dp_all`` variant (batch over every axis, params replicated, bf16
moments and no master past 5e8 parameters).  The step puts its gradients
back on their parameters' specs before AdamW reads them, as the JAX jit's
in/out shardings do, so the collectives of the update are counted.

Fields that differ from the JAX row:

- ``fits_h100_state`` (JAX: ``fits_16GiB_state``, the TPU v5e's HBM):
  ``state_bytes_per_chip`` below :data:`CARD_BYTES`, the ``total_memory``
  that ``torch.cuda.get_device_properties(0)`` reads on an NVIDIA H100
  80GB HBM3.
- ``memory_analysis`` (XLA's compiled argument/output/temp bytes) has no
  counterpart on meta and is left out; ``peak_mem_per_chip`` is None.
- ``state_bytes_per_chip`` holds what the port places: the optimizer's
  step counter is a Python int here, an int32 on the device in JAX (4
  bytes fewer for every training cell).

Usage:
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh multi --out results/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (SHAPES, CodingConfig, TrainConfig, cell_runnable, get_config,
                                 runnable_cells)
from repro_torch.launch.mesh import coded_workers, data_axes, make_production_mesh
from repro_torch.models.lm import LM, build_model
from repro_torch.models.sharding import activation_axes, distribute
from repro_torch.optim.adam import adamw_init
from repro_torch.roofline.analysis import analyze_cost
from repro_torch.roofline.op_cost import Cost, count_cost
from repro_torch.train.steps import (accumulate, apply_update, make_fused_train_step,
                                     value_and_grad)

# Per-arch training memory policy: jamba-398B takes bf16 optimizer moments,
# no f32 master and 4-way grad accumulation (the JAX comment says 8-way; its
# code, copied here, sets 4); everything else the full-precision default.
_BIG = {"jamba-1.5-large-398b": dict(accum=4, state_dtype=torch.bfloat16, master=False)}
_TRAIN_POLICY_DEFAULT = dict(accum=1, state_dtype=torch.float32, master=True)
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB HBM3
CARD_BYTES = 85_017_493_504


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A tensor stand-in: shape, dtype and spec (one mesh-axis entry a dim),
    the counterpart of a sharded ``jax.ShapeDtypeStruct``."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: tuple = ()


def _axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> extent, of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def shard_shape(leaf: Leaf, sizes: dict[str, int]) -> tuple[int, ...]:
    """Rank 0's shard of ``leaf``: each dim ceil-divided by the extents of
    the axes its spec names (JAX's ``NamedSharding.shard_shape``)."""
    out = []
    for i, d in enumerate(leaf.shape):
        e = leaf.spec[i] if i < len(leaf.spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        out.append(-(-d // math.prod(sizes[a] for a in axes)))
    return tuple(out)


def _sharded_bytes_per_chip(sizes: dict[str, int], *trees: dict) -> int:
    """Per-rank resident bytes of the stand-ins, exactly from each leaf's
    shard shape: the structural "does persistent state fit" number."""
    total = 0
    for tree in trees:
        for leaf in tree.values():
            total += math.prod(shard_shape(leaf, sizes)) * leaf.dtype.itemsize
    return total


def _dp_entry(dp: tuple[str, ...]):
    return dp if len(dp) > 1 else dp[0]


def _param_leaves(model: LM, sizes: dict[str, int], *, fsdp: bool) -> dict[str, Leaf]:
    params = model.init(torch.Generator(), "meta")
    specs = model.param_specs(tp_axis="model", tp_size=sizes["model"])
    if fsdp:
        specs = model.fsdp_specs({k: tuple(p.shape) for k, p in params.items()}, specs,
                                 fsdp_axis="data", fsdp_size=sizes["data"])
    return {k: Leaf(tuple(p.shape), p.dtype, specs[k]) for k, p in params.items()}


def _n_active_params(model: LM) -> float:
    """Active params per token: MoE expert weights scaled by top_k/E."""
    cfg = model.cfg
    scale_moe = (cfg.top_k / cfg.n_experts) if cfg.n_experts else 1.0
    total = 0.0
    for key, p in model.init(torch.Generator(), "meta").items():
        parts = key.split(".")
        n = float(p.numel())
        if "moe" in parts and parts[-1] in ("w_gate", "w_up", "w_down"):
            n *= scale_moe
        total += n
    return total


# ---------------------------------------------------------------------------
# input_specs — stand-ins for every model input
# ---------------------------------------------------------------------------


def input_specs(arch: str, shape_name: str, mesh, coding: CodingConfig | None = None,
                dp=None, dp_size=None, global_batch: int | None = None) -> dict:
    """Stand-ins (shape, dtype, spec) of the step's inputs for the cell;
    ``mesh`` is a ``DeviceMesh`` or a mapping of axis extents.
    ``global_batch`` replaces the shape's own."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, global_batch=global_batch or shape.global_batch)
    model = build_model(cfg)
    sizes = _axis_sizes(mesh)
    dp = dp if dp is not None else tuple(a for a in sizes if a != "model")
    dp_size = dp_size if dp_size is not None else math.prod(sizes[a] for a in dp)
    bf16, i32 = torch.bfloat16, torch.int32

    if shape.kind == "train":
        coding = coding or CodingConfig()
        m = dp_size
        ppw = coding.partitions_per_worker
        while m * ppw > shape.global_batch and ppw > 1:
            ppw -= 1
        k = m * ppw
        part_mb = shape.global_batch // k
        if part_mb < 1:
            raise ValueError(f"global batch {shape.global_batch} < {k} partitions")
        n_slots = k * (coding.s + 1) // m  # headroom 1.0 for the dry run
        flat = m * n_slots * part_mb
        ds = (_dp_entry(dp),)
        batch: dict[str, Leaf] = {}
        if cfg.frontend == "audio":
            batch["frames"] = Leaf((flat, shape.seq_len, cfg.d_model), bf16, ds)
            batch["labels"] = Leaf((flat, shape.seq_len), i32, ds)
        elif cfg.frontend == "vision":
            text = shape.seq_len - cfg.n_patches
            batch["patches"] = Leaf((flat, cfg.n_patches, cfg.d_model), bf16, ds)
            batch["tokens"] = Leaf((flat, text), i32, ds)
            batch["labels"] = Leaf((flat, text), i32, ds)
        else:
            batch["tokens"] = Leaf((flat, shape.seq_len), i32, ds)
            batch["labels"] = Leaf((flat, shape.seq_len), i32, ds)
        batch["weight"] = Leaf((flat,), torch.float32, ds)
        return {"batch": batch, "coded_tokens": flat * shape.seq_len,
                "unique_tokens": shape.global_batch * shape.seq_len}

    B = shape.global_batch
    bs = (_dp_entry(dp),) if B % dp_size == 0 else ()
    if shape.kind == "prefill":
        batch = {}
        if cfg.frontend == "audio":
            batch["frames"] = Leaf((B, shape.seq_len, cfg.d_model), bf16, bs)
        elif cfg.frontend == "vision":
            batch["patches"] = Leaf((B, cfg.n_patches, cfg.d_model), bf16, bs)
            batch["tokens"] = Leaf((B, shape.seq_len - cfg.n_patches), i32, bs)
        else:
            batch["tokens"] = Leaf((B, shape.seq_len), i32, bs)
        return {"batch": batch, "tokens_processed": B * shape.seq_len}

    # decode: one new token against a cache of seq_len
    if not cfg.supports_decode:
        raise ValueError(f"{arch} has no decode step")
    cache = {key: Leaf(shp, dt, _cache_spec(key.rsplit(".", 1)[1], shp, sizes, dp, dp_size))
             for key, (shp, dt) in model.cache_shapes(B, shape.seq_len).items()}
    cache["pos"] = Leaf((), i32, ())
    return {"tokens": Leaf((B, 1), i32, bs), "cache": cache, "tokens_processed": B}


def _cache_spec(name: str, shp: tuple, sizes: dict[str, int], dp, dp_size: int) -> tuple:
    """A decode cache leaf's spec (JAX's ``_cache_spec_tree``): the batch dim
    over the data axes where it divides, else the sequence (k, v) or the
    heads (h) take them; the model axis on the sequence (k, v), the heads
    or the state dim (h), or the channels (conv)."""
    tp = sizes["model"]
    dims: list = [None] * len(shp)
    batch_ok = shp[1] % dp_size == 0 and shp[1] >= dp_size
    if name in ("k", "v"):  # (n_rep, B, S_c, K, hd)
        seq_ax = []
        if batch_ok:
            dims[1] = _dp_entry(dp)
        else:
            seq_ax.extend(dp)
        seq_ax.append("model")
        div = math.prod(sizes[a] for a in seq_ax)
        if shp[2] % div == 0 and shp[2] >= div:
            dims[2] = tuple(seq_ax) if len(seq_ax) > 1 else seq_ax[0]
    elif name == "h":  # (n_rep, B, H, P, N)
        if batch_ok:
            dims[1] = _dp_entry(dp)
        elif shp[2] % dp_size == 0:
            dims[2] = _dp_entry(dp)
        if dims[2] is None and shp[2] % tp == 0:
            dims[2] = "model"
        elif shp[4] % tp == 0:
            dims[4] = "model"
    elif name == "conv":  # (n_rep, B, k-1, C)
        if batch_ok:
            dims[1] = _dp_entry(dp)
        if shp[3] % tp == 0:
            dims[3] = "model"
    return tuple(dims)


# ---------------------------------------------------------------------------
# running a cell
# ---------------------------------------------------------------------------


def _register_flip() -> None:
    """A DTensor sharding rule for ``aten.flip``, which the backward of
    ``cumsum`` runs (the SSD scan's segment sums, the MoE's capacity
    positions) and which torch 2.11's DTensor lacks: a flipped dim whole,
    any other dim may stay sharded.  Registered in the dry run's own
    process only."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.flip.default)
    def _flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(x.ndim) if d not in flipped]


def fake_world(world: int) -> None:
    """This process as rank 0 of a fake world of ``world`` ranks (no peer,
    no traffic): the counterpart of forcing the host platform's device
    count."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    else:
        _register_flip()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _place(leaves: dict[str, Leaf], mesh, device: str) -> dict[str, DTensor]:
    return {k: distribute(torch.empty(l.shape, dtype=l.dtype, device=device), l.spec, mesh)
            for k, l in leaves.items()}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool, verbose: bool = True,
               variant: str = "baseline", mesh_shape: tuple[int, ...] | None = None,
               global_batch: int | None = None) -> dict:
    """One cell's row.  variant:
      - "baseline": DP over the data axes, TP over 'model', FSDP optimizer.
      - "dp_all":   batch over EVERY mesh axis, params fully replicated —
        for models too small to use tp=16.
    ``mesh_shape`` replaces the production extents (a small mesh; world =
    its product); ``global_batch`` replaces the cell's."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_runnable(cfg, shape)
    if not ok:
        raise SystemExit(f"SKIP {arch} × {shape_name}: {why}")
    dims = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    chips = math.prod(dims)
    fake_world(chips)
    mesh = make_production_mesh(multi_pod, shape=dims)
    mesh_name = ("pod" if mesh_shape is None else "") + "x".join(map(str, dims))
    model = build_model(cfg, ssd_impl="torch", attn_impl="torch")
    n_active = _n_active_params(model)
    if variant == "dp_all":
        dp, dp_size = tuple(mesh.mesh_dim_names), chips
    else:
        dp, dp_size = data_axes(mesh), coded_workers(mesh)
    t0 = time.time()
    with activation_axes(dp, dp_size):
        row = _run_cell(arch, shape_name, cfg, mesh, model, dp, dp_size, variant,
                        global_batch=global_batch,
                        mesh_name=mesh_name, chips=chips, n_active=n_active)
    row["compile_s"] = time.time() - t0
    if verbose:
        print(json.dumps({k: v for k, v in row.items() if k not in ("coll_breakdown", "by_shape")},
                         indent=1,
                         default=str))
        print("collectives:", row["coll_breakdown"])
    return row


def cell_inputs(arch: str, shape_name: str, sizes: dict[str, int], dp, dp_size: int,
                variant: str = "baseline", *, model: LM | None = None,
                global_batch: int | None = None) -> dict:
    """A cell's stand-ins: ``params``, ``opt`` (training: keys ``mu.<k>``,
    ``nu.<k>``, ``master.<k>``; serving: empty), ``spec`` (its
    :func:`input_specs`), ``policy`` (training's memory policy, else None)
    and ``state``: the per-rank bytes of what the cell places (params,
    optimizer state and batch; params and the batch or decode cache)."""
    model = model or build_model(get_config(arch))
    kind = SHAPES[shape_name].kind
    spec = input_specs(arch, shape_name, sizes, dp=dp, dp_size=dp_size,
                       global_batch=global_batch)
    opt, policy = {}, None
    if kind != "train":
        pleaves = _param_leaves(model, sizes, fsdp=arch in _BIG)
    else:
        policy = dict(_BIG.get(arch, _TRAIN_POLICY_DEFAULT))
        if variant == "dp_all":
            pleaves = {k: dataclasses.replace(l, spec=())
                       for k, l in _param_leaves(model, sizes, fsdp=False).items()}
            # replicated state must fit one GPU: bf16 moments, no master,
            # past ~0.5 B parameters
            if sum(math.prod(l.shape) for l in pleaves.values()) > 5e8:
                policy.update(state_dtype=torch.bfloat16, master=False)
        else:
            pleaves = _param_leaves(model, sizes, fsdp=True)
        for name in ("mu", "nu") + (("master",) if policy["master"] else ()):
            dt = torch.float32 if name == "master" else policy["state_dtype"]
            opt |= {f"{name}.{k}": dataclasses.replace(l, dtype=dt) for k, l in pleaves.items()}
    placed = spec["cache"] if kind == "decode" else spec["batch"]
    return {"params": pleaves, "opt": opt, "spec": spec, "policy": policy,
            "state": _sharded_bytes_per_chip(sizes, pleaves, opt, placed)}


def state_bytes(arch: str, shape_name: str, sizes: dict[str, int],
                variant: str = "baseline") -> int:
    """``state_bytes_per_chip`` of a cell on a mesh of ``sizes``."""
    dp = tuple(sizes) if variant == "dp_all" else tuple(a for a in sizes if a != "model")
    dp_size = math.prod(sizes[a] for a in dp)
    return cell_inputs(arch, shape_name, sizes, dp, dp_size, variant)["state"]


def train_step_cost(model: LM, mesh, params: dict[str, Leaf], batch: dict[str, Leaf], *,
                    state_dtype=torch.float32, master: bool | None = None,
                    accum: int = 1) -> Cost:
    """One rank's counted cost of ``make_fused_train_step`` on meta DTensors
    placed by the stand-ins' specs (the caller installs activation axes).

    With ``accum`` > 1 the chunks are of one shape, so one chunk's forward,
    backward and accumulation are counted once and taken ``accum`` times
    (the HLO walk takes a scan body ``trip_count`` times), the
    accumulators' zeros and the update once; the gather of the batch into
    chunks is left out."""
    tc = TrainConfig()
    p = _place(params, mesh, "meta")
    opt = adamw_init(p, state_dtype=state_dtype, keep_master=master)
    if accum == 1:
        return count_cost(make_fused_train_step(model, tc), p, opt,
                          _place(batch, mesh, "meta"), 0)[1]
    chunk = _place({k: dataclasses.replace(l, shape=(l.shape[0] // accum, *l.shape[1:]))
                    for k, l in batch.items()}, mesh, "meta")
    with implicit_replication():
        acc, cost = count_cost(lambda: [torch.zeros_like(x, dtype=torch.float32)
                                        for x in p.values()])
        acc, body = count_cost(lambda: accumulate(acc, value_and_grad(model, p, chunk)[1]))
        cost.add(body, accum)
        cost.add(count_cost(apply_update, p, opt, acc, 0, tc)[1])
    return cost


def _run_cell(arch, shape_name, cfg, mesh, model, dp, dp_size, variant, *, global_batch,
              mesh_name, chips, n_active) -> dict:
    sizes = _axis_sizes(mesh)
    shape = SHAPES[shape_name]
    t = cell_inputs(arch, shape_name, sizes, dp, dp_size, variant, model=model,
                    global_batch=global_batch)
    spec = t["spec"]
    if shape.kind == "train":
        policy = t["policy"]
        cost = train_step_cost(model, mesh, t["params"], spec["batch"],
                               state_dtype=policy["state_dtype"], master=policy["master"],
                               accum=policy["accum"])
        model_flops = 6.0 * n_active * spec["unique_tokens"]
        extra = {"accum_steps": policy["accum"], "state_dtype": str(policy["state_dtype"]),
                 "master": policy["master"], "coded_tokens": spec["coded_tokens"]}
    else:
        params = _place(t["params"], mesh, "meta")
        # DTensor cannot run under inference_mode (it sets version counters),
        # so the serving functions run undecorated (__wrapped__), under no_grad
        if shape.kind == "prefill":
            batch = _place(spec["batch"], mesh, "meta")
            if cfg.encoder_only:
                def fn():
                    return model.forward(params, batch)[0]
            else:
                def fn():
                    return LM.prefill.__wrapped__(model, params, batch,
                                                  cache_len=shape.seq_len)
        else:
            tokens = _place({"t": spec["tokens"]}, mesh, "meta")["t"]
            cache = _place(spec["cache"], mesh, "meta")

            def fn():
                return LM.decode_step.__wrapped__(model, params, tokens, cache)
        with implicit_replication(), torch.no_grad():
            cost = count_cost(fn)[1]
        model_flops = 2.0 * n_active * spec["tokens_processed"]
        extra = {}
    rep = analyze_cost(cost, arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
                       model_flops=model_flops)
    row = rep.row()
    state = t["state"]
    row.update({
        "variant": variant, "flops_per_chip": cost.flops, "bytes_per_chip": cost.bytes,
        "coll_by_link": {k: int(v) for k, v in cost.coll_by_link.items()},
        "mm_flops_by_dtype": dict(cost.mm_flops_by_dtype),
        "top_shapes": [(k, float(v)) for k, v in cost.top_shapes(10)],
        "by_shape": dict(cost.by_shape),
        "state_bytes_per_chip": state, "card_bytes": CARD_BYTES,
        "fits_h100_state": bool(state < CARD_BYTES), **extra,
    })
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell json results")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "dp_all"])
    ap.add_argument("--mesh-shape", default=None,
                    help="replace the mesh's extents, e.g. 1,1 (one rank) or 4,2")
    ap.add_argument("--global-batch", type=int, default=None)
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape in runnable_cells():
            print(f"{arch} {shape}")
        return 0
    if not args.all and not (args.arch and args.shape):
        ap.error("give --list, --all, or --arch and --shape")
    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    multi = args.mesh == "multi"
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None
    failed = 0
    for arch, shape in cells:
        fn = None
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            suffix = "" if args.variant == "baseline" else f"__{args.variant}"
            fn = os.path.join(args.out, f"{arch}__{shape}__{args.mesh}{suffix}.json")
            if os.path.exists(fn):
                print(f"skip (cached): {fn}", flush=True)
                continue
        print(f"=== dry-run {arch} × {shape} on {'2x16x16' if multi else '16x16'} ===",
              flush=True)
        try:
            row = lower_cell(arch, shape, multi_pod=multi, variant=args.variant,
                             mesh_shape=mesh_shape, global_batch=args.global_batch)
        except Exception as e:  # a failing cell is reported and the sweep goes on
            failed += 1
            print(f"FAILED {arch} × {shape}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
            continue
        if fn:
            with open(fn, "w") as f:
                json.dump({k: v for k, v in row.items() if k != "by_shape"}, f, indent=1,
                          default=str)
            print(f"wrote {fn}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
