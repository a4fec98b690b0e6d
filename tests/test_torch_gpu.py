"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip with a reason where no CUDA card is present.  On
the H100 run them with ``python -m pytest -m gpu tests/test_torch_gpu.py``
(this file imports neither ``jax`` nor the JAX package, so it runs where
only the port's dependencies are installed).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.coded_reduce import coded_reduce, coded_reduce_torch


def _np(x):
    return x.float().cpu().numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the H100 with: python -m pytest -m gpu tests/")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 5, 130])
@pytest.mark.parametrize("D", [1, 4095, 1_000_003, 4096])
@pytest.mark.parametrize("case", ["f32", "bf16", "bf16->f32", "int8->f32"])
def test_cuda_kernel_matches_plain(cuda_device, P, D, case):
    r = np.random.default_rng(P * 7 + D)
    w = torch.from_numpy(r.normal(size=(P,)).astype(np.float32)).to(cuda_device)
    if case == "int8->f32":
        g = torch.from_numpy(r.integers(-127, 128, size=(P, D)).astype(np.int8))
        out_dtype, tol = torch.float32, 1e-5
    else:
        g = torch.from_numpy(r.normal(size=(P, D)).astype(np.float32))
        g = g.to(torch.float32 if case == "f32" else torch.bfloat16)
        out_dtype = torch.bfloat16 if case == "bf16" else torch.float32
        tol = 5e-2 if case == "bf16" else 1e-5
    g = g.to(cuda_device)
    before = coded_reduce.launches
    out = coded_reduce(g, w, out_dtype)
    torch.cuda.synchronize()
    assert coded_reduce.launches == before + 1
    expect = coded_reduce_torch(g, w, out_dtype)
    scale = max(1.0, float(expect.float().abs().max()))
    np.testing.assert_allclose(_np(out.cpu()), _np(expect.cpu()), atol=tol * scale, rtol=tol)


@pytest.mark.gpu
def test_cuda_nan_weight_poisons(cuda_device):
    g = torch.ones(3, 4096, device=cuda_device)
    w = torch.tensor([0.0, float("nan"), 1.0], device=cuda_device)
    assert torch.isnan(coded_reduce(g, w)).all()


class _Source:
    def batch(self, step):
        r = np.random.default_rng(step)
        return {"tokens": r.integers(0, 1000, size=(4, 2, 4096)).astype(np.int32),
                "x": r.normal(size=(4, 2, 4096)).astype(np.float32)}


@pytest.mark.gpu
def test_cuda_prefetch_side_stream_copies_arrive(cuda_device):
    """Batches copied on the prefetcher's side stream are complete when the
    consumer's stream reads them (it waits on the copy's event)."""
    from repro_torch.train.prefetch import DevicePrefetcher

    src = _Source()
    for step, batch in DevicePrefetcher(src, 0, 6, device=cuda_device):
        for key, x in src.batch(step).items():
            assert batch[key].device.type == "cuda"
            # read on the current stream, where the consumer computes
            np.testing.assert_array_equal((batch[key] * 1).cpu().numpy(), x)
