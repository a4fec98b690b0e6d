"""granite-4.0-h-small on the port, at reduced width in f32 on the CPU,
against the benchmark's plain reference (``chipbench/reference/hybrid.py``,
which imports nothing of the port) on seeded random weights.

Held:
  - the loss and every leaf's gradient of the reduced model (a period of
    ten layers: Mamba2 x5, NoPE attention, Mamba2 x4, each with a dropless
    MoE on a share of the experts and a shared expert) equal the
    reference's;
  - expert parallelism: the MoE outputs of all 8 shares of 16 experts, with
    the shared expert counted once, sum to the uncut reference layer;
  - dropless: under a router biased so that every token picks the same
    experts, every pair is computed (the capacity form drops most of them);
  - the grouped route equals the per-expert loop;
  - per-layer remat is bit-equal to remat off;
  - each multiplier, the 1/128 score scale and NoPE move the loss when
    perturbed, and the reference follows each multiplier;
  - the MoE's ``device.mlp`` span carries the routing's shape and ``pairs``,
    equal to a hand count of the routed pairs;
  - the registry resolves the config outside ``ARCHS`` and the launcher
    trains its reduced form.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the benchmark's reference

from chipbench import weights  # noqa: E402
from chipbench.reference import hybrid  # noqa: E402
from repro_torch.configs import ARCHS, get_config, runnable_cells  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import mlp  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402

torch.set_num_threads(2)

ARCH = "granite-4.0-h-small"
B, S = 2, 24


def _cfg(**kw):
    """The reduced granite, holding experts 1-2 of 4 (top 2)."""
    base = dataclasses.replace(get_config(ARCH).reduced(), experts_held=2, expert_offset=1)
    return dataclasses.replace(base, **kw)


def _weights(cfg, seed=7):
    d = dataclasses.asdict(cfg)
    leaves = hybrid.leaves(d)
    return weights.make(leaves, {leaf.name: "float32" for leaf in leaves}, seed, "cpu")


def _tokens(cfg, seed=0):
    return torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(seed))


def _port(cfg, w, tokens, tracer=None):
    model = build_model(cfg)
    if tracer is not None:
        model.tracer = tracer
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    loss = model.seq_losses(params, {"tokens": tokens, "labels": tokens}).mean()
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in params.items()}


def _reference(cfg, w, tokens):
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    d = dataclasses.asdict(cfg)
    loss = sum(hybrid.seq_loss(params, row, d) for row in tokens) / len(tokens)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in params.items()}


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_loss_and_every_gradient_match_the_reference():
    cfg = _cfg()
    w, tokens = _weights(cfg), _tokens(cfg)
    loss, grads = _port(cfg, w, tokens)
    ref_loss, ref_grads = _reference(cfg, w, tokens)
    assert set(grads) == set(ref_grads) == set(w)
    torch.testing.assert_close(loss, ref_loss.float(), rtol=1e-6, atol=0)
    for k in sorted(w):
        assert ref_grads[k].norm() > 0, k
        assert _rel(grads[k], ref_grads[k]) <= 1e-4, (k, _rel(grads[k], ref_grads[k]))


def _moe_leaves(d, E, n, ff, seed):
    g = torch.Generator().manual_seed(seed)
    return {"router": torch.randn(d, E, generator=g) * d**-0.5,
            "w_gate": torch.randn(n, d, ff, generator=g) * d**-0.5,
            "w_up": torch.randn(n, d, ff, generator=g) * d**-0.5,
            "w_down": torch.randn(n, ff, d, generator=g) * ff**-0.5}


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """16 experts over 8 shares of 2, top 4: each share's dropless output,
    summed, plus the shared expert once, is the reference's whole layer."""
    d, E, ff, k, shares = 32, 16, 24, 4, 8
    whole = _moe_leaves(d, E, E, ff, 1)
    shared = {"w_gate": torch.randn(d, 40) * d**-0.5, "w_up": torch.randn(d, 40) * d**-0.5,
              "w_down": torch.randn(40, d) * 40**-0.5}
    h = torch.randn(3, 10, d)
    total = mlp(shared, h)
    for s in range(shares):
        part = {"router": whole["router"],
                **{n: whole[n][2 * s:2 * s + 2] for n in ("w_gate", "w_up", "w_down")}}
        total = total + moe_mod.moe_apply_dropless(part, h, top_k=k, offset=2 * s)[0]
    cfg = {"top_k": k, "expert_offset": 0}
    expect = torch.stack([hybrid.moe(row, *(whole[n] for n in hybrid.MOE), cfg=cfg)
                          + hybrid._swiglu(row, *(shared[n] for n in hybrid.SWIGLU), hybrid.matmul)
                          for row in h])
    torch.testing.assert_close(total, expect, rtol=1e-5, atol=1e-6)


def test_dropless_computes_every_pair_under_a_biased_router():
    """Every token's top 3 are experts 0-2 (a router that reads a constant
    feature): each expert gets all 40 tokens, past any capacity the
    capacity form sets (it drops most), and the output is the reference's."""
    d, E, ff, k, T = 16, 8, 12, 3, 40
    p = _moe_leaves(d, E, E, ff, 2)
    p["router"][0] = 0.0
    p["router"][0, :k] = 50.0 + torch.arange(k, dtype=torch.float32)
    h = torch.randn(1, T, d)
    h[..., 0] = 1.0
    y, _, counts = moe_mod.moe_apply_dropless(p, h, top_k=k)
    assert counts.tolist() == [T] * k + [0] * (E - k)
    expect = hybrid.moe(h[0], *(p[n] for n in hybrid.MOE), cfg={"top_k": k, "expert_offset": 0})
    torch.testing.assert_close(y[0], expect, rtol=1e-5, atol=1e-6)
    capped, _ = moe_mod.moe_apply(p, h, top_k=k, capacity_factor=1.25)
    assert not torch.allclose(capped, y, atol=1e-3)  # the capacity form drops pairs


def test_the_grouped_route_equals_the_loop():
    p = _moe_leaves(24, 12, 5, 16, 3)
    h = torch.randn(2, 9, 24)
    got = []
    for impl in ("grouped", "loop"):
        leaves = {n: v.clone().requires_grad_() for n, v in p.items()}
        x = h.clone().requires_grad_()
        y, _, counts = moe_mod.moe_apply_dropless(leaves, x, top_k=4, offset=3, impl=impl)
        (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum().backward()
        got.append([y, counts, x.grad] + [leaves[n].grad for n in sorted(leaves)])
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="dropless impl"):
        moe_mod.moe_apply_dropless(p, h, top_k=4, impl="nope")


def test_per_layer_remat_is_bit_equal_to_remat_off():
    cfg = _cfg()
    w, tokens = _weights(cfg), _tokens(cfg)
    off = _port(dataclasses.replace(cfg, remat="none"), w, tokens)
    on = _port(dataclasses.replace(cfg, remat="full"), w, tokens)
    assert torch.equal(off[0], on[0])
    for k in w:
        assert torch.equal(off[1][k], on[1][k]), k


@pytest.mark.parametrize("change", [
    dict(embedding_multiplier=6.0), dict(residual_multiplier=0.5), dict(logits_scaling=4.0),
    dict(attention_multiplier=1.0), dict(attention_multiplier=0.0),
    dict(position_embedding="rope")],
    ids=["embedding_multiplier", "residual_multiplier", "logits_scaling",
         "attention_multiplier", "hd-0.5-scale", "rope"])
def test_each_scalar_and_nope_moves_the_loss(change):
    """Perturbed, each setting moves the port's loss by far more than
    round-off; the reference, which reads the same multipliers (it has no
    rotary embedding), follows.  The attention layer's projections are
    scaled up, so that its scores are peaked and its output counts: at the
    benchmark's distributions a change to attention alone moves the loss
    by a few f32 spacings."""
    cfg = _cfg()
    w, tokens = _weights(cfg), _tokens(cfg)
    j = cfg.attn_offset
    for name, f in (("wq", 4.0), ("wk", 4.0), ("wo", 20.0)):
        w[f"blocks.{j}.attn.{name}"] *= f
    base = _port(cfg, w, tokens)[0]
    moved_cfg = dataclasses.replace(cfg, **change)
    moved = _port(moved_cfg, w, tokens)[0]
    assert abs(float(moved - base)) > 1e-5 * abs(float(base))
    if "position_embedding" not in change and change.get("attention_multiplier") != 0.0:
        torch.testing.assert_close(moved, _reference(moved_cfg, w, tokens)[0].float(),
                                   rtol=1e-6, atol=0)


def test_moe_span_args_pairs_and_load_counter_equal_a_hand_count(monkeypatch):
    cfg = _cfg()
    w, tokens = _weights(cfg), _tokens(cfg)
    seen = []
    inner = moe_mod.moe_apply_dropless

    def spy(params, x, *, top_k, offset=0, act="silu", impl="grouped"):
        ids = (x.detach().float() @ params["router"].detach()).topk(top_k, dim=-1).indices
        n = params["w_gate"].shape[0]
        seen.append(torch.stack([(ids == offset + e).sum() for e in range(n)]))
        return inner(params, x, top_k=top_k, offset=offset, act=act, impl=impl)

    monkeypatch.setattr("repro_torch.models.lm.moe_apply_dropless", spy)
    tr = Tracer()
    _port(cfg, w, tokens, tracer=tr)
    tr.sync_device(None)
    spans = [r for r in tr.records("span") if r["name"] == "device.mlp"]
    fwd = sorted((r for r in spans if r["args"]["pass"] == "fwd"), key=lambda r: r["args"]["layer"])
    assert len(fwd) == cfg.n_layers and len(spans) == 2 * cfg.n_layers  # fwd and bwd, remat off
    hand = seen[:cfg.n_layers]
    for r, counts in zip(fwd, hand):
        a = r["args"]
        assert (a["kind"], a["experts"], a["held"], a["top_k"], a["expert_d_ff"],
                a["shared_d_ff"], a["impl"]) == ("moe", 4, 2, 2, 128, 128, "grouped")
        assert a["pairs"] == int(counts.sum()) and isinstance(a["pairs"], int)
    for r in spans:
        assert isinstance(r["args"]["pairs"], int)


def test_registry_resolves_granite_outside_archs_and_the_launcher_trains_it():
    from repro_torch.launch.train import main

    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.top_k, cfg.ssm_heads) == (
        40, 4096, 72, 10, 128)
    assert cfg.rotary_dim == 0 and cfg.attn_scale == 1 / 128 and cfg.n_held == 72
    assert ARCH not in ARCHS and all(a != ARCH for a, _ in runnable_cells())
    out = main(["--arch", ARCH, "--reduced", "--backend", "fused", "--m", "4", "--straggler",
                "fault", "--steps", "2", "--seq-len", "16", "--device", "cpu"])
    assert out["summary"]["steps_run"] == 2 and len(out["history"]) == 2
    assert all(h["loss"] == pytest.approx(h["loss"]) for h in out["history"])  # finite
