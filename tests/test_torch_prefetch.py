"""The port's DevicePrefetcher on the CPU: the batches and steps it hands
out, failure propagation (the worker's exception re-raised on the consumer
with its traceback), and the join on abandon, as ``tests/test_resilience.py``
holds the JAX package's.  Also: ``CodedTrainer.run`` through the prefetcher
equals a manual step loop.  The CUDA side-stream path is in
``tests/test_torch_gpu.py``."""

import threading
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import CodingConfig, TrainConfig
from repro_torch.core.straggler import FixedDelayStragglers
from repro_torch.optim.adam import adamw_init
from repro_torch.train.prefetch import DevicePrefetcher
from repro_torch.train.trainer import CodedTrainer, TrainerState

torch.set_num_threads(2)


def _batch(k, step):
    r = np.random.default_rng(1000 + step)
    return {"x": r.normal(size=(k, 2, 4)).astype(np.float32),
            "y": r.normal(size=(k, 2)).astype(np.float32)}


class _Source:
    def __init__(self, k, fail_at=None):
        self.k = k
        self.fail_at = fail_at

    def batch(self, step):
        if step == self.fail_at:
            raise ValueError("boom")
        return _batch(self.k, step)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch" and t.is_alive()]


def test_prefetch_hands_out_every_batch_in_order():
    got = list(DevicePrefetcher(_Source(3), 2, 7, device="cpu"))
    assert [step for step, _ in got] == [2, 3, 4, 5, 6]
    for step, batch in got:
        for key, x in _batch(3, step).items():
            assert isinstance(batch[key], torch.Tensor) and batch[key].device.type == "cpu"
            np.testing.assert_array_equal(batch[key].numpy(), x)
    assert not _prefetch_threads()


def test_prefetch_reraises_original_exception_with_traceback():
    seen = []
    with pytest.raises(ValueError, match="boom") as ei:
        for step, _ in DevicePrefetcher(_Source(2, fail_at=2), 0, 10, device="cpu"):
            seen.append(step)
    assert seen == [0, 1]  # the good prefix is delivered first
    assert "batch" in "".join(traceback.format_tb(ei.value.__traceback__))
    assert not _prefetch_threads()


def test_prefetch_consumer_break_joins_the_worker():
    it = iter(DevicePrefetcher(_Source(2), 0, 10 ** 6, device="cpu"))
    step, _ = next(it)
    assert step == 0
    it.close()  # closing the generator stops and joins the worker
    assert not _prefetch_threads()


def test_prefetch_empty_range():
    assert list(DevicePrefetcher(_Source(2), 5, 5, device="cpu")) == []


class _Toy:
    def weighted_loss(self, params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return ((pred[:, 0] - batch["y"]) ** 2 * batch["weight"]).sum()


def test_trainer_run_matches_stepwise_loop():
    def make():
        tr = CodedTrainer(_Toy(), CodingConfig(scheme="heter_aware", s=1),
                          TrainConfig(lr=1e-2, warmup_steps=2, total_steps=6), m=4, part_mb=2,
                          straggler_model=FixedDelayStragglers(s=1, delay=2.0),
                          true_speeds=np.array([1.0, 2.0, 3.0, 4.0]), backend="spmd",
                          device="cpu")
        r = np.random.default_rng(0)
        p = {"w1": torch.from_numpy(r.normal(size=(4, 8)).astype(np.float32)),
             "w2": torch.from_numpy(r.normal(size=(8, 1)).astype(np.float32))}
        return tr, TrainerState(params=p, opt=adamw_init(p), step=0)

    tr_a, st_a = make()
    seen = []
    st_a, last = tr_a.run(st_a, _Source(tr_a.k), 4,
                          on_step=lambda s, st, met: seen.append((s, met["loss"])))
    assert [s for s, _ in seen] == [0, 1, 2, 3]
    tr_b, st_b = make()
    for step in range(4):
        st_b, met_b = tr_b.step(st_b, _batch(tr_b.k, step))
    assert last["loss"] == met_b["loss"]
    for key in st_a.params:
        torch.testing.assert_close(st_a.params[key], st_b.params[key], rtol=0, atol=0)
