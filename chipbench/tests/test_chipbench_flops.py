"""The FLOP and byte formulas against counts worked out by hand at tiny
shapes, and the trace reduction on made-up intervals."""

from __future__ import annotations

import pytest

from chipbench import devtrace, flops

DENSE = dict(family="dense", n_layers=1, d_model=2, n_heads=1, n_kv_heads=1, head_dim=2,
             d_ff=3, vocab=5)
SSM = dict(family="ssm", n_layers=1, d_model=2, vocab=3, conv_kernel=2, ssm_d_inner=4,
           ssm_heads=2, ssm_state=1, ssm_groups=1, ssm_chunk=2)


def test_dense_forward_by_hand():
    # S = 3: q and o 2*3*2*2 = 24 each, k and v 24 each -> 96; the gated MLP
    # 3 matmuls of 2*3*2*3 = 36 -> 108; 6 kept (q, k) pairs, q.k and p.v of
    # 2*2 each -> 48; the head 2*3*2*5 = 60
    assert flops.dense_forward(DENSE, 3) == 96 + 108 + 48 + 60
    # a second layer adds every per-layer term again, not the head
    assert flops.dense_forward({**DENSE, "n_layers": 2}, 3) == 2 * (96 + 108 + 48) + 60


def test_ssm_forward_by_hand():
    # S = 4, chunk 2: 2 chunks of 3 causal pairs = 6 pairs.  in_proj
    # 2*4*2*(8+2+2) = 192; conv over 6 channels, width 2: 2*4*6*2 = 96;
    # C.B 2*1*6 = 12; y_diag 2 heads * P 2 * 2 * 6 = 48; chunk states and the
    # carried readout 2*2*2*1*4 = 32 each; out_proj 2*4*4*2 = 64; head 2*4*2*3 = 48
    assert flops.ssm_forward(SSM, 4) == 192 + 96 + 12 + 48 + 32 + 32 + 64 + 48


def test_train_step_counts_the_real_coded_rows():
    traffic = dict(s=1, k=8, part_mb=1, seq_len=3)
    assert flops.train_step(DENSE, traffic) == 3 * 16 * flops.dense_forward(DENSE, 3)


def test_ssd_scan_bytes_by_hand():
    # B 1, S 2, H 1, P 2, G 1, N 3, bf16 B/C: x 16 + dA 8 + B and C 2*2*3*2 = 24
    # + y 16 + h 4*2*3 = 24
    assert flops.ssd_scan_bytes(1, 2, 1, 2, 1, 3, 2) == 88


def _trace(events):
    t = devtrace.DeviceTrace()
    t.events = events
    return t


def test_busy_gaps_and_idle_by_span():
    t = _trace([("a", 1.0, 2.0), ("b", 1.5, 3.0), ("a", 4.0, 5.0), ("c", 9.0, 11.0)])
    assert t.busy(0.0, 10.0) == [(1.0, 3.0), (4.0, 5.0), (9.0, 10.0)]
    assert t.busy_s(0.0, 10.0) == pytest.approx(4.0)
    gaps = t.gaps(0.0, 10.0)
    assert gaps == [(0.0, 1.0), (3.0, 4.0), (5.0, 9.0)]
    assert t.by_name(0.0, 10.0) == {"a": 2.0, "b": 1.5, "c": 1.0}
    spans = [("step", 0.0, 8.0, {}), ("step.resolve", 2.5, 3.5, {}), ("phase.fused", 4.5, 8.0, {})]
    assert devtrace.idle_by_span(gaps, spans) == {"step": 1.0, "step.resolve": 1.0,
                                                 "phase.fused": 4.0}
    assert devtrace.top({"x": 1.0, "y": 3.0}, n=1) == [["y", 3.0]]
