"""The fused pass spreads each partition's weight evenly over its copies
(``core/aggregator.py::spread_copies_device``, applied where
``StepEngine._device_batch`` makes the slot weights, in f64): the same
decoded gradient, the same slots with and without weight, and no
cancellation between copies weighted by nearly opposite large numbers,
which an ill-conditioned decode gives (Tandon's cyclic code at m 4, s 1
reaches weights of thousands for a partition whose total is 1/4) and a
bf16 backward cannot carry."""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import Codec, get_scheme
from repro_torch.core.aggregator import (pack_flat_device, slot_weights, slot_weights_device,
                                         spread_copies_device)
from repro_torch.train.engine import StepEngine

torch.set_num_threads(2)


class _Toy:
    def weighted_loss(self, params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return ((pred[:, 0].float() - batch["y"].float()) ** 2 * batch["weight"]).sum()


def _batch(k, mb=3, d=4, seed=0):
    r = np.random.default_rng(seed)
    return {"x": torch.from_numpy(r.normal(size=(k, mb, d)).astype(np.float32)),
            "y": torch.from_numpy(r.normal(size=(k, mb)).astype(np.float32))}


def _plan_views(codec):
    plan = codec.plan
    B = codec.scheme.B[np.arange(plan.m)[:, None], plan.slot_pids] * plan.slot_mask
    return (torch.as_tensor(plan.slot_pids, dtype=torch.long), torch.as_tensor(plan.slot_mask),
            torch.as_tensor(B, dtype=torch.float64))


def _f64_weights(codec, a, support=None):
    pids, mask, coeff = _plan_views(codec)
    sup = torch.ones((codec.m, codec.k)) if support is None else torch.as_tensor(support).float()
    return slot_weights_device(torch.as_tensor(a, dtype=torch.float64), sup, coeff, mask, pids,
                               codec.k)


@pytest.mark.parametrize("name,c", [("cyclic", None), ("heter_aware", [1.0, 2.0, 3.0, 2.0])])
def test_copies_keep_each_total_and_each_zero(name, c):
    k = 4 if name == "cyclic" else 8
    codec = Codec(get_scheme(name, m=4, k=k, s=1, c=c, rng=5))
    plan = codec.plan
    pids, mask, _ = _plan_views(codec)
    for workers in ([0, 1, 2, 3], [0, 2, 3], [1, 2, 3]):
        w = _f64_weights(codec, codec.decode_vector(workers))
        got = spread_copies_device(w, pids, mask, k)
        assert got.dtype == torch.float32 and got.shape == w.shape
        assert torch.equal(got != 0, w != 0)
        for p in range(k):
            at = torch.from_numpy((plan.slot_pids == p) & (plan.slot_mask > 0))
            assert float(got[at].double().sum()) == pytest.approx(float(w[at].sum()), abs=1e-6)
            live = got[at][got[at] != 0]
            assert torch.all(live == live[0]) if live.numel() else True


def test_spread_totals_are_exact_at_an_ill_conditioned_decode():
    """Made in f64, every partition's spread total is 1/k to f32's
    rounding; the same weights made in f32 are off by 1e-4 or more."""
    codec = Codec(get_scheme("cyclic", m=4, k=4, s=1, rng=100))
    a = codec.decode_vector([0, 2, 3])
    pids, mask, _ = _plan_views(codec)
    got = spread_copies_device(_f64_weights(codec, a), pids, mask, codec.k)
    w32 = slot_weights(codec.plan, a)
    for p in range(codec.k):
        at = (codec.plan.slot_pids == p) & (codec.plan.slot_mask > 0)
        assert abs(float(got[torch.from_numpy(at)].double().sum()) - 0.25) < 1e-7
    assert max(abs(float(w32[(codec.plan.slot_pids == p) & (codec.plan.slot_mask > 0)]
                         .astype(np.float64).sum()) - 0.25) for p in range(codec.k)) > 1e-4


def test_an_ill_conditioned_decode_keeps_a_bf16_gradient():
    """Cyclic at rng 100 without worker 1 weights a partition's two copies
    by about -3440 and +3440: the fused engine's bf16 gradient stays within
    2e-2 of the exact one (f64, every partition once), where the same pass
    on the unspread weights is off by a fifth of it or more."""
    codec = Codec(get_scheme("cyclic", m=4, k=4, s=1, rng=100))
    a = codec.decode_vector([0, 2, 3])
    assert np.abs(slot_weights(codec.plan, a)).max() > 1000
    pb = _batch(codec.k)
    r = np.random.default_rng(1)
    params = {"w1": torch.from_numpy(r.normal(size=(4, 8)).astype(np.float32)),
              "w2": torch.from_numpy(r.normal(size=(8, 1)).astype(np.float32))}
    exact = {n: v.double().requires_grad_() for n, v in params.items()}
    pred = torch.tanh(pb["x"].double().reshape(-1, 4) @ exact["w1"]) @ exact["w2"]
    ((pred[:, 0] - pb["y"].double().reshape(-1)) ** 2 / pb["y"].numel()).sum().backward()
    bf16 = {n: v.bfloat16() for n, v in params.items()}
    batch = {k: v.bfloat16() for k, v in pb.items()}
    eng = StepEngine(_Toy(), TrainConfig(), codec, backend="fused", device="cpu")
    got = eng.gradients(bf16, batch, a)
    pids = torch.as_tensor(codec.plan.slot_pids, dtype=torch.long)
    flat = pack_flat_device(batch, pids, torch.from_numpy(slot_weights(codec.plan, a)))
    leaves = {n: v.clone().requires_grad_() for n, v in bf16.items()}
    raw = dict(zip(leaves, torch.autograd.grad(_Toy().weighted_loss(leaves, flat),
                                               list(leaves.values()))))
    for n in params:
        want = exact[n].grad
        err = float((got[n].double() - want).norm() / want.norm())
        raw_err = float((raw[n].double() - want).norm() / want.norm())
        assert err < 2e-2 and raw_err > 0.2, (n, err, raw_err)
