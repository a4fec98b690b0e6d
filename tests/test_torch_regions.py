"""The port's device regions and the fused step's host sub-phases, on the
CPU (where a region reads the host clock; the CUDA events are held on the
card in ``tests/test_torch_gpu.py``).

Held, on a tiny dense model and a tiny Mamba2, each under full remat,
driven through the fused ``CodedTrainer``:
  - each step records, per layer, one ``device.mixer`` and (where the
    layer has one) one ``device.mlp`` span in each of the ``fwd``,
    ``recompute`` and ``bwd`` passes, plus ``device.embed`` and
    ``device.head_loss`` forward and backward; each carries its step, layer
    and shape, its parent host phase, lies inside its ``step`` span, and
    the backward spans run in reverse layer order;
  - ``phase.fused`` holds ``phase.forward``, ``phase.backward``,
    ``phase.loss_sync``, ``phase.grad_norm``, ``phase.apply`` and
    ``phase.sync`` in that order, and ``phase.upload`` carries the pass's
    ``rows`` and ``weighted_rows``;
  - with tracing off the model records nothing and adds no autograd node,
    and the gradients and the trained weights are bit-equal on and off;
  - ``NullTracer.device_span`` is a no-op; events are placed on the wall
    clock against the anchor; ``faithful_spmd_step`` records one
    ``phase.spmd.slot`` a (worker, slot) pass; ``obs_report`` aggregates
    the device spans by clock and the Chrome export names their track.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import CodingConfig, TrainConfig, get_config
from repro_torch.core.straggler import FixedDelayStragglers
from repro_torch.launch import obs_report
from repro_torch.models.lm import build_model
from repro_torch.obs import NULL_SPAN, NULL_TRACER, Tracer
from repro_torch.optim.adam import adamw_init
from repro_torch.train.trainer import CodedTrainer, TrainerState

torch.set_num_threads(2)

ARCHS = {"dense": "smollm-360m", "ssm": "mamba2-370m"}
STEPS, M, PART_MB, SEQ = 2, 4, 1, 16
SUB_PHASES = ("phase.forward", "phase.backward", "phase.loss_sync", "phase.grad_norm",
              "phase.apply", "phase.sync")


def _cfg(family):
    return dataclasses.replace(get_config(ARCHS[family]).reduced(), remat="full", n_layers=2)


def _trainer(model, trace, backend="fused"):
    return CodedTrainer(
        model, CodingConfig(scheme="heter_aware", s=1, partitions_per_worker=2), TrainConfig(),
        m=M, part_mb=PART_MB, straggler_model=FixedDelayStragglers(s=1, delay=2.0),
        true_speeds=np.linspace(1.0, 2.0, M), rng=3, backend=backend, trace=trace, device="cpu")


def _batch(cfg, k, step):
    toks = np.random.default_rng(step).integers(0, cfg.vocab, size=(k, PART_MB, SEQ))
    return {"tokens": toks, "labels": toks}


def _train(family, trace, backend="fused"):
    cfg = _cfg(family)
    model = build_model(cfg)
    tr = _trainer(model, trace, backend)
    state = tr.init_state(0)
    for step in range(STEPS):
        state, _ = tr.step(state, _batch(cfg, tr.k, step))
    return model, tr, state


@pytest.fixture(scope="module", params=sorted(ARCHS))
def traced(request):
    tracer = Tracer()
    model, tr, state = _train(request.param, tracer)
    return request.param, model, tr, tracer


def _spans(tracer, prefix=""):
    return [r for r in tracer.records("span") if r["name"].startswith(prefix)]


def _inside(r, outer):
    return outer["t0"] - 1e-9 <= r["t0"] and r["t1"] <= outer["t1"] + 1e-9


# ---------------------------------------------------------------------------
# device regions
# ---------------------------------------------------------------------------


def test_each_step_records_every_region_in_every_pass(traced):
    family, model, tr, tracer = traced
    cfg = model.cfg
    dev = _spans(tracer, "device.")
    assert {r["tid"] for r in dev} == {2} and {r["clock"] for r in dev} == {"wall"}
    assert all(r["args"]["on"] == "device" for r in dev)
    for step in range(STEPS):
        mine = [r for r in dev if r["args"]["step"] == step]
        count = {}
        for r in mine:
            key = (r["name"], r["args"]["pass"], r["args"].get("layer"))
            count[key] = count.get(key, 0) + 1
        want = {("device.embed", p, None): 1 for p in ("fwd", "bwd")}
        want |= {("device.head_loss", p, None): 1 for p in ("fwd", "bwd")}
        for layer in range(cfg.n_layers):
            for p in ("fwd", "recompute", "bwd"):
                want[("device.mixer", p, layer)] = 1
                if family == "dense":
                    want[("device.mlp", p, layer)] = 1
        assert count == want


def test_regions_carry_their_shape_and_parent(traced):
    family, model, tr, tracer = traced
    cfg = model.cfg
    rows = M * tr.n_slots * PART_MB
    for r in _spans(tracer, "device."):
        a = r["args"]
        assert (a["B"], a["S"]) == (rows, SEQ)
        assert a["parent"] == ("phase.forward" if a["pass"] == "fwd" else "phase.backward")
        if r["name"] == "device.mixer" and family == "dense":
            assert a["kind"] == "attn"
            assert (a["d_model"], a["heads"], a["kv_heads"], a["head_dim"], a["window"]) == (
                cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.window)
        elif r["name"] == "device.mixer":
            assert a["kind"] == "ssd"
            assert (a["H"], a["P"], a["G"], a["N"], a["chunk"], a["bc_bytes"]) == (
                cfg.ssm_heads, cfg.ssm_d_inner // cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state,
                cfg.ssm_chunk, 4)
            assert (a["bwd_impl"], a["norm_impl"]) == ("plain", "plain")  # the CPU's routes
        elif r["name"] == "device.mlp":
            assert (a["kind"], a["d_model"], a["d_ff"]) == ("dense", cfg.d_model, cfg.d_ff)
        else:
            assert (a["d_model"], a["vocab"]) == (cfg.d_model, cfg.vocab)


def test_regions_lie_in_their_step_and_backward_runs_in_reverse(traced):
    family, model, tr, tracer = traced
    steps = {r["args"]["step"]: r for r in _spans(tracer, "step") if r["name"] == "step"}
    assert sorted(steps) == list(range(STEPS))
    for step, outer in steps.items():
        mine = sorted((r for r in _spans(tracer, "device.") if r["args"]["step"] == step),
                      key=lambda r: r["t0"])
        assert mine and all(_inside(r, outer) and r["t1"] >= r["t0"] for r in mine)
        # one region at a time: the regions do not overlap
        assert all(a["t1"] <= b["t0"] + 1e-9 for a, b in zip(mine, mine[1:]))
        order = [(r["name"], r["args"]["pass"], r["args"].get("layer")) for r in mine]
        bwd_layers = [layer for name, p, layer in order if name == "device.mixer" and p == "bwd"]
        assert bwd_layers == sorted(bwd_layers, reverse=True)
        assert order[0] == ("device.embed", "fwd", None)
        assert order[-1] == ("device.embed", "bwd", None)
        # the recompute of a layer runs before its backward opens, not inside it
        for layer in bwd_layers:
            re = order.index(("device.mixer", "recompute", layer))
            assert re < order.index(("device.mixer", "bwd", layer))


# ---------------------------------------------------------------------------
# phase.fused's host sub-phases
# ---------------------------------------------------------------------------


def test_phase_fused_holds_its_sub_phases_in_order(traced):
    family, model, tr, tracer = traced
    spans = _spans(tracer, "phase.")
    fused = [r for r in spans if r["name"] == "phase.fused"]
    assert len(fused) == STEPS
    assert {r["args"]["phases"] for r in fused} == {"fwd+bwd+apply"}
    for outer in fused:
        inner = [r for r in spans if r["name"] in SUB_PHASES and _inside(r, outer)]
        assert [r["name"] for r in sorted(inner, key=lambda r: r["t0"])] == list(SUB_PHASES)
    for name in SUB_PHASES:
        assert sum(r["name"] == name for r in spans) == STEPS
    upload = [r for r in spans if r["name"] == "phase.upload"]
    rows = M * tr.n_slots * PART_MB
    for r in upload:
        assert r["args"]["rows"] == rows
        assert 0 < r["args"]["weighted_rows"] < rows
        assert r["args"]["weighted_rows"] % PART_MB == 0


def test_upload_rows_are_the_weights_the_model_sees():
    """``weighted_rows`` (host plan and decode vector) equals the count of
    nonzero weights in the batch the model gets (on the device)."""
    cfg = _cfg("dense")
    model = build_model(cfg)
    seen = []
    inner = model.weighted_loss

    def weighted_loss(params, batch):
        seen.append((int(batch["weight"].numel()), int((batch["weight"] != 0).sum())))
        return inner(params, batch)

    model.weighted_loss = weighted_loss
    tracer = Tracer()
    tr = _trainer(model, tracer)
    state = tr.init_state(0)
    for step in range(3):
        state, _ = tr.step(state, _batch(cfg, tr.k, step))
    got = [(r["args"]["rows"], r["args"]["weighted_rows"])
           for r in tracer.records("span", "phase.upload")]
    assert got == seen


# ---------------------------------------------------------------------------
# tracing off
# ---------------------------------------------------------------------------


def _graph_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo.extend(g for g, _ in f.next_functions)
    return [type(f).__name__ for f in seen]


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_tracing_off_adds_no_node_and_is_bit_equal(family):
    cfg = _cfg(family)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(3, SEQ)))
    batch = {"tokens": toks, "labels": toks, "weight": torch.rand(3)}

    def grads(tracer):
        model.tracer = tracer
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = model.weighted_loss(leaves, batch)
        return loss, _graph_nodes(loss), torch.autograd.grad(loss, list(leaves.values()))

    assert model.tracer is NULL_TRACER
    loss_off, nodes_off, g_off = grads(NULL_TRACER)
    tracer = Tracer()
    loss_on, nodes_on, g_on = grads(tracer)
    markers = [n for n in nodes_on if n in ("OpenBackwardBackward", "CloseBackwardBackward")]
    per_layer = 2 if family == "dense" else 1
    assert len(markers) == 2 * (2 + per_layer * cfg.n_layers)
    assert not any("OpenBackward" in n or "CloseBackward" in n for n in nodes_off)
    assert sorted(nodes_off) == sorted(n for n in nodes_on if n not in markers)
    assert loss_off.detach().numpy().tobytes() == loss_on.detach().numpy().tobytes()
    for a, b in zip(g_off, g_on):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert tracer.sync_device() > 0 and len(tracer.records("span")) > 0


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_trainer_traced_and_untraced_are_bit_equal(family):
    model_off, tr_off, s_off = _train(family, None)
    assert model_off.tracer is NULL_TRACER and tr_off.engine.tracer is NULL_TRACER
    _, _, s_on = _train(family, Tracer())
    for k in s_off.params:
        assert s_off.params[k].numpy().tobytes() == s_on.params[k].numpy().tobytes()
        assert s_off.opt.mu[k].numpy().tobytes() == s_on.opt.mu[k].numpy().tobytes()


def test_null_tracer_device_span_is_a_noop():
    x = torch.ones(3, requires_grad=True)
    span = NULL_TRACER.device_span("device.mixer", device=torch.device("cpu"), layer=0)
    assert span is NULL_SPAN
    with span as s:
        assert s.input(x) is x and s.output(x) is x
    assert NULL_TRACER.device_span("device.mlp") is NULL_SPAN


# ---------------------------------------------------------------------------
# the tracer's placement and export
# ---------------------------------------------------------------------------


class _Event:
    """A stand-in for a completed CUDA event at ``t`` ms on the card."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def test_events_land_at_the_anchor_minus_their_elapsed_time():
    tracer = Tracer()
    tracer.step, tracer.phase = 7, "phase.backward"
    a, b, anchor = _Event(10.0), _Event(12.5), _Event(20.0)
    tracer._device_region("device.mixer", a, b, {"pass": "bwd", "step": 7})
    tracer._device_region("device.embed", 1.0, 1.25, {"pass": "fwd", "step": 7})
    tracer._place(tracer._pending, anchor, 100.0)
    got = {r["name"]: (r["t0"], r["t1"], r["tid"]) for r in tracer.records("span")}
    assert got["device.mixer"] == (pytest.approx(100.0 - 0.010), pytest.approx(100.0 - 0.0075), 2)
    assert got["device.embed"] == (1.0, 1.25, 2)
    assert tracer._events == [a, b, anchor]  # back in the pool


def test_obs_report_and_chrome_take_the_device_spans(traced, tmp_path):
    family, model, tr, tracer = traced
    path = str(tmp_path / "run.jsonl")
    tracer.write_jsonl(path)
    rows = {(r["clock"], r["phase"]): r for r in obs_report.phase_table(obs_report.load_records(path))}
    n_mixer = len(tracer.records("span", "device.mixer"))
    assert rows[("wall", "device.mixer")]["n"] == n_mixer == STEPS * 3 * model.cfg.n_layers
    assert rows[("wall", "phase.loss_sync")]["n"] == STEPS
    doc = tracer.to_chrome()
    names = [e for e in doc["traceEvents"] if e["ph"] == "M" and e["name"] == "thread_name"]
    assert names == [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 2,
                      "args": {"name": "device"}}]
    assert any(e["ph"] == "X" and e["tid"] == 2 for e in doc["traceEvents"])
    json.dumps(doc)


# ---------------------------------------------------------------------------
# per-slot spans of the spmd backend
# ---------------------------------------------------------------------------


class _Toy:
    def weighted_loss(self, params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return ((pred[:, 0] - batch["y"]) ** 2 * batch["weight"]).sum()


def test_faithful_spmd_step_records_one_span_a_slot_pass():
    tracer = Tracer()
    tr = CodedTrainer(_Toy(), CodingConfig(scheme="heter_aware", s=1), TrainConfig(), m=M,
                      part_mb=2, true_speeds=np.linspace(1.0, 2.0, M), rng=0, backend="spmd",
                      trace=tracer, device="cpu")
    r = np.random.default_rng(0)
    p = {"w1": torch.from_numpy(r.normal(size=(4, 8)).astype(np.float32)),
         "w2": torch.from_numpy(r.normal(size=(8, 1)).astype(np.float32))}
    state = TrainerState(p, adamw_init(p), 0)
    for step in range(3):
        x = np.random.default_rng(step).normal(size=(tr.k, 2, 4)).astype(np.float32)
        state, _ = tr.step(state, {"x": x, "y": np.tanh(x.sum(-1))})
    grads = tracer.records("span", "phase.spmd.grads")
    slots = tracer.records("span", "phase.spmd.slot")
    assert len(grads) == 3
    assert len(slots) == 3 * tr.m * tr.n_slots
    for g in grads:
        mine = [s for s in slots if _inside(s, g)]
        assert sorted((s["args"]["worker"], s["args"]["slot"]) for s in mine) == [
            (w, s) for w in range(tr.m) for s in range(tr.n_slots)]
