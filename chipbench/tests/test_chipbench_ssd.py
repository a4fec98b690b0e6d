"""The reference's SSD by blocks equals the quadratic form, its witness
written here straight from the definition, in value and gradient, at
chunk lengths that divide the sequence and one that does not."""

from __future__ import annotations

import pytest
import torch

from chipbench.reference import ssm


def quadratic(x, dt, A, Bm, Cm):
    """y[t] = sum_{s <= t} (C[t] . B[s]) exp(sum_{s < u <= t} dt[u] A) dt[s] x[s]."""
    S, H, _ = x.shape
    G = Bm.shape[1]
    cs = torch.cumsum((dt * A).double(), dim=0)
    seg = (cs[:, None, :] - cs[None, :, :]).float().permute(2, 0, 1)
    causal = torch.ones((S, S), dtype=torch.bool).tril()
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cb = torch.matmul(Cm.transpose(0, 1), Bm.permute(1, 2, 0)).repeat_interleave(H // G, dim=0)
    xdt = (x * dt[..., None]).transpose(0, 1)
    return torch.matmul(cb * decay, xdt).transpose(0, 1)


@pytest.mark.parametrize("S,H,P,G,N,chunk", [(64, 4, 8, 1, 16, 8), (64, 4, 8, 2, 16, 16),
                                             (48, 6, 4, 3, 8, 16), (30, 2, 4, 1, 4, 8)])
def test_blocks_equal_the_quadratic_form(S, H, P, G, N, chunk):
    gen = torch.Generator().manual_seed(S * chunk + G)
    inputs = (torch.randn(S, H, P, generator=gen), torch.rand(S, H, generator=gen) * 0.5,
              -torch.rand(H, generator=gen) * 3, torch.randn(S, G, N, generator=gen),
              torch.randn(S, G, N, generator=gen))
    a = [t.clone().requires_grad_(True) for t in inputs]
    b = [t.clone().requires_grad_(True) for t in inputs]
    want, got = quadratic(*a), ssm.ssd(*b, chunk)
    scale = float(want.detach().abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    g = torch.randn(want.shape, generator=gen)
    (want * g).sum().backward()
    (got * g).sum().backward()
    for ta, tb in zip(a, b):
        torch.testing.assert_close(tb.grad, ta.grad, rtol=1e-5,
                                   atol=1e-5 * float(ta.grad.abs().max()))
