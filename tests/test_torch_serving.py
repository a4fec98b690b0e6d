"""The port's serving path against the JAX package, at reduced width (f32)
and equal converted weights: prefill and cached decode of one attention
and one mamba layer, ``LM.prefill`` + teacher-forced ``decode_step`` with
every cache leaf, the slot cache (shapes and dtypes key for key, insert,
evict, a slot-indexed step), ``LMServer.generate`` (EOS, per-request
budgets, the ``cache_len`` clamp), ``ServingEngine`` (continuous batching
bit-equal to the port's own sequential decode; completions and every
``RequestRecord`` field equal to the JAX engine's under a pinned
``decode_dt`` and a seeded ``ReplicaPool``), and the numpy-only
``ReplicaPool`` and ``ServingMetrics`` bit-equal to JAX's.
"""

import dataclasses
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx.deadline import SLOPolicy as JSLOPolicy
from repro.configs import get_config as jget_config
from repro.core.straggler import FixedDelayStragglers as JDelay
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models.lm import build_model as jbuild
from repro.serve import ReplicaPool as JPool
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve import ServingMetrics as JMetrics
from repro.serve.metrics import RequestRecord as JRecord
from repro.train.serve import LMServer as JServer
from repro_torch.approx.deadline import SLOPolicy
from repro_torch.configs import get_config
from repro_torch.core.straggler import FixedDelayStragglers
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models.lm import (build_model, cache_from_numpy, cache_to_numpy, flatten_tree,
                                   params_from_numpy)
from repro_torch.obs.trace import Tracer
from repro_torch.serve import ReplicaPool, Request, ServingEngine, ServingMetrics
from repro_torch.serve.metrics import RequestRecord
from repro_torch.train.serve import LMServer

torch.set_num_threads(2)

ARCHS = ("smollm-360m", "mamba2-370m", "llama3.2-1b")
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def served():
    """Per arch: (cfg, JAX model, JAX params, JAX server, port model, port
    params, port server), the port's weights converted from the JAX ones."""
    out = {}
    for arch in ARCHS:
        cfg = jget_config(arch).reduced()
        jm = jbuild(cfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = build_model(get_config(arch).reduced())
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        out[arch] = (cfg, jm, jp, JServer(jm), tm, tp, LMServer(tm))
    return out


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (s,)).astype(np.int32) for s in lens]


def _close(t, j, rtol=RTOL, atol=ATOL):
    t = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
    np.testing.assert_allclose(t, np.asarray(j, np.float32), rtol=rtol, atol=atol)


def _close_tree(tcache, jcache):
    got = flatten_tree(cache_to_numpy(tcache))
    want = flatten_tree(jax.tree.map(np.asarray, jcache))
    assert list(got) == list(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        _close(got[name], want[name])


# ---------------------------------------------------------------------------
# one layer: prefill with a cache, then cached decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("vector_pos", [False, True])
def test_attention_prefill_and_decode_match_jax(flash, vector_pos):
    d, H, K, hd, S, B, L = 64, 4, 2, 16, 12, 2, 20
    jp = jattn.init_attention(jax.random.PRNGKey(3), d, H, K, hd, False, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    r = np.random.default_rng(0)
    x = r.normal(size=(B, S, d)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=K, head_dim=hd, rotary_dim=hd, rope_theta=1e4)
    jout, jc = jattn.attention_forward(jp, jnp.asarray(x), jnp.arange(S), return_cache=True,
                                       cache_len=L, **kw)
    tout, tc = tattn.attention_forward(tp, torch.from_numpy(x), torch.arange(S),
                                       return_cache=True, cache_len=L, flash=flash, **kw)
    _close(tout, jout)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == (B, L, K, hd)
        _close(tc[name], jc[name])
    # decode two tokens; a (B,) position puts each row at its own place
    pos = np.array([S, S - 3], np.int32) if vector_pos else np.int32(S)
    for step in range(2):
        x1 = r.normal(size=(B, 1, d)).astype(np.float32)
        jo, jc = jattn.attention_decode(jp, jnp.asarray(x1), jc, jnp.asarray(pos + step), **kw)
        to, tc = tattn.attention_decode(tp, torch.from_numpy(x1), tc,
                                        torch.as_tensor(pos + step), **kw)
        _close(to, jo)
        for name in ("k", "v"):
            _close(tc[name], jc[name])


def test_attention_decode_past_the_cache_drops_row_writes():
    """A free serving slot's position runs past the cache: JAX's scatter
    drops that row's write, and so does the port."""
    d, H, K, hd, L = 32, 2, 1, 16, 6
    jp = jattn.init_attention(jax.random.PRNGKey(4), d, H, K, hd, False, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    r = np.random.default_rng(2)
    cache = {n: r.normal(size=(2, L, K, hd)).astype(np.float32) for n in ("k", "v")}
    x1 = r.normal(size=(2, 1, d)).astype(np.float32)
    pos = np.array([3, L + 4], np.int32)
    kw = dict(n_heads=H, n_kv=K, head_dim=hd, rotary_dim=hd, rope_theta=1e4)
    jo, jc = jattn.attention_decode(jp, jnp.asarray(x1), jax.tree.map(jnp.asarray, cache),
                                    jnp.asarray(pos), **kw)
    to, tc = tattn.attention_decode(tp, torch.from_numpy(x1),
                                    {n: torch.from_numpy(v.copy()) for n, v in cache.items()},
                                    torch.from_numpy(pos), **kw)
    _close(to, jo)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
        np.testing.assert_array_equal(tc[name][1].numpy(), cache[name][1])


@pytest.mark.parametrize("S", [16, 13])
def test_mamba_prefill_and_decode_match_jax(S):
    """y, the cache's h and conv, then three decode steps (13 pads to a
    chunk multiple inside the scan)."""
    cfg = jget_config("mamba2-370m").reduced()
    kw = dict(d_inner=cfg.ssm_d_inner, n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
              n_groups=cfg.ssm_groups)
    jp = jssm.init_mamba(jax.random.PRNGKey(5), cfg.d_model, conv_kernel=cfg.conv_kernel,
                         dtype=jnp.float32, **kw)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    r = np.random.default_rng(S)
    x = r.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    jy, jc = jssm.mamba_forward(jp, jnp.asarray(x), chunk=cfg.ssm_chunk, return_cache=True, **kw)
    ty, tc = tssm.mamba_forward(tp, torch.from_numpy(x), chunk=cfg.ssm_chunk,
                                return_cache=True, **kw)
    _close(ty, jy)
    assert tc["h"].dtype == torch.float32 and tc["conv"].dtype == torch.float32
    for name in ("h", "conv"):
        _close(tc[name], jc[name])
    for _ in range(3):
        x1 = r.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jssm.mamba_decode(jp, jnp.asarray(x1), jc, **kw)
        ty, tc = tssm.mamba_decode(tp, torch.from_numpy(x1), tc, **kw)
        _close(ty, jy)
        for name in ("h", "conv"):
            _close(tc[name], jc[name])


# ---------------------------------------------------------------------------
# the LM: prefill + teacher-forced decode, the slot cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_jax(served, arch):
    cfg, jm, jp, _, tm, tp, _ = served[arch]
    tokens = np.stack(_prompts(cfg, (10, 10), seed=4))
    L = 16
    jl, jc = jax.jit(jm.prefill, static_argnames=("cache_len",))(
        jp, {"tokens": jnp.asarray(tokens)}, cache_len=L)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, cache_len=L)
    _close(tl, jl)
    _close_tree(tc, jc)
    follow = np.random.default_rng(9).integers(0, cfg.vocab, (3, 2, 1)).astype(np.int32)
    jstep = jax.jit(jm.decode_step)
    for tok in follow:  # teacher-forced: both sides take the same tokens
        jl, jc = jstep(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc)
        _close(tl, jl)
        _close_tree(tc, jc)
    assert int(tc["pos"]) == 13


def _cache_spec(tree):
    return {k: (tuple(v.shape), str(np.dtype(v.dtype))) for k, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_slot_cache_shapes_match_jax(arch, dtype):
    """Built directly in the port, traced from a prefill in JAX: the same
    keys, shapes and dtypes (bf16 mamba2 keeps h in f32)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype)
    jm = jbuild(jcfg)
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = jax.eval_shape(partial(jm.empty_slot_cache, n_slots=3, cache_len=20), jparams)
    tm = build_model(dataclasses.replace(get_config(arch).reduced(), dtype=dtype))
    got = tm.empty_slot_cache({"embed": torch.zeros(1)}, n_slots=3, cache_len=20)
    spec = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()}
    assert spec == _cache_spec(want)
    assert list(got) == list(flatten_tree(want))
    assert all(not v.any() for v in got.values())


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
def test_insert_evict_and_slot_step_match_jax(served, arch):
    """Insert two prefilled requests into a 3-slot cache, take a
    slot-indexed decode step, evict one slot: every leaf as JAX's."""
    cfg, jm, jp, _, tm, tp, _ = served[arch]
    L = 20
    jcache = jm.empty_slot_cache(jp, 3, L)
    tcache = tm.empty_slot_cache(tp, 3, L)
    jpre = jax.jit(jm.prefill, static_argnames=("cache_len",))
    for slot, p in zip((2, 0), _prompts(cfg, (9, 12), seed=6)):
        _, jc = jpre(jp, {"tokens": jnp.asarray(p[None])}, cache_len=L)
        _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(p[None])}, cache_len=L)
        jcache = jm.cache_insert_slot(jcache, jc, slot)
        tcache = tm.cache_insert_slot(tcache, tc, slot)
        _close_tree(tcache, jcache)
    tok = np.array([[5], [0], [7]], np.int32)
    jl, jcache = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jcache)
    tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache)
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
    _close_tree(tcache, jcache)
    jcache = jm.cache_evict_slot(jcache, 2)
    tcache = tm.cache_evict_slot(tcache, 2)
    _close_tree(tcache, jcache)
    assert all(not v[:, 2].any() for k, v in tcache.items() if k != "pos")
    assert tcache["pos"].tolist() == [13, 1, 0]


def test_cache_converter_round_trip(served):
    cfg, jm, jp, _, tm, tp, _ = served["mamba2-370m"]
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(_prompts(cfg, (8,))[0][None])}, cache_len=8)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    back = cache_to_numpy(tc)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jc))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# LMServer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(served, arch):
    cfg, _, jp, js, _, tp, ts = served[arch]
    toks = np.stack(_prompts(cfg, (10, 10, 10), seed=2))
    want = js.generate(jp, {"tokens": jnp.asarray(toks)}, 6, cache_len=24)
    got = ts.generate(tp, {"tokens": toks}, 6, cache_len=24)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    lim = np.array([2, 6, 4])
    want = js.generate(jp, {"tokens": jnp.asarray(toks)}, 6, cache_len=24,
                       max_new_per_request=lim, pad_id=7)
    got = ts.generate(tp, {"tokens": toks}, 6, cache_len=24, max_new_per_request=lim, pad_id=7)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_eos_and_per_request_budgets_match_jax(served):
    cfg, _, jp, js, _, tp, ts = served["smollm-360m"]
    p = _prompts(cfg, (12,), seed=1)[0][None]
    ref = ts.generate(tp, {"tokens": p}, 8, cache_len=32)[0]
    np.testing.assert_array_equal(ref, np.asarray(js.generate(jp, {"tokens": jnp.asarray(p)}, 8,
                                                              cache_len=32))[0])
    eos = int(ref[3])  # a token the model actually emits mid-stream
    out = ts.generate(tp, {"tokens": p}, 8, cache_len=32, eos_id=eos)[0]
    first = int(np.argmax(ref == eos))
    np.testing.assert_array_equal(out[: first + 1], ref[: first + 1])
    assert (out[first + 1:] == eos).all()  # pad defaults to eos_id
    np.testing.assert_array_equal(
        out, np.asarray(js.generate(jp, {"tokens": jnp.asarray(p)}, 8, cache_len=32,
                                    eos_id=eos))[0])
    out = ts.generate(tp, {"tokens": p}, 8, cache_len=32, max_new_per_request=np.array([3]),
                      pad_id=0)[0]
    np.testing.assert_array_equal(out[:3], ref[:3])
    assert (out[3:] == 0).all()
    with pytest.raises(ValueError, match="max_new_per_request shape"):
        ts.generate(tp, {"tokens": p}, 8, cache_len=32, max_new_per_request=np.array([3, 4]))


def test_cache_len_default_is_clamped_as_jax(served):
    """S + max_new_tokens past the serving max truncates the decode budget
    with a warning, and pads the tail, as the JAX server does."""
    cfg, jm, jp, _, tm, tp, ts0 = served["smollm-360m"]
    ts, js = LMServer(tm, max_cache_len=16), JServer(jm, max_cache_len=16)
    p = _prompts(cfg, (8,), seed=1)[0][None]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = ts.generate(tp, {"tokens": p}, 20)
    assert out.shape == (1, 20)
    assert any("truncated" in str(x.message) for x in w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = js.generate(jp, {"tokens": jnp.asarray(p)}, 20)
    np.testing.assert_array_equal(out, np.asarray(want))
    np.testing.assert_array_equal(out[0, :8], ts0.generate(tp, {"tokens": p}, 8, cache_len=16)[0])
    with pytest.raises(ValueError, match="exceeds cache_len"):
        ts.generate(tp, {"tokens": np.zeros((1, 20), np.int32)}, 4)


# ---------------------------------------------------------------------------
# ServingEngine
# ---------------------------------------------------------------------------


def _sequential(server, params, prompts, new, cache_len):
    return [server.generate(params, {"tokens": p[None]}, new, cache_len=cache_len)[0]
            for p in prompts]


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batch_bit_equal_sequential(served, arch):
    """Mixed-length requests, staggered arrivals, fewer slots than requests
    (admission mid-flight of a running batch): every request's tokens are
    bit-equal to its own B=1 ``LMServer.generate``, and no kernel launches
    on the CPU."""
    cfg, _, _, _, _, tp, ts = served[arch]
    prompts = _prompts(cfg, (8, 14, 11, 9, 16))
    refs = _sequential(ts, tp, prompts, 7, 40)
    before = (flash_attention.launches, ssd_scan.launches)
    eng = ServingEngine(ts, tp, n_slots=2, cache_len=40, decode_dt=0.01)
    comps, metrics = eng.run([Request(rid=i, tokens=p, max_new_tokens=7, arrival_t=0.02 * i)
                              for i, p in enumerate(prompts)])
    assert [c.rid for c in comps] == list(range(len(prompts)))
    for c, ref in zip(comps, refs):
        np.testing.assert_array_equal(c.tokens, ref)
    assert metrics.summary()["n_requests"] == len(prompts)
    assert (flash_attention.launches, ssd_scan.launches) == before


def test_mid_flight_admission_preserves_survivors(served):
    cfg, _, _, _, _, tp, ts = served["smollm-360m"]
    prompts = _prompts(cfg, (10, 13, 9), seed=3)
    refs = _sequential(ts, tp, prompts, 8, 40)
    eng = ServingEngine(ts, tp, n_slots=3, cache_len=40, decode_dt=0.01)
    eng.submit(Request(rid=0, tokens=prompts[0], max_new_tokens=8))
    eng.submit(Request(rid=1, tokens=prompts[1], max_new_tokens=8))
    for _ in range(3):
        eng.step()
    eng.submit(Request(rid=2, tokens=prompts[2], max_new_tokens=8))  # joins mid-flight
    while eng.step():
        pass
    for c, ref in zip(sorted(eng.completions, key=lambda c: c.rid), refs):
        np.testing.assert_array_equal(c.tokens, ref)


def test_eviction_frees_slots_and_zeroes_cache(served):
    cfg, _, _, _, _, tp, ts = served["mamba2-370m"]
    prompts = _prompts(cfg, (8, 8, 8), seed=5)
    eng = ServingEngine(ts, tp, n_slots=1, cache_len=24, decode_dt=0.01)
    comps, _ = eng.run([Request(rid=i, tokens=p, max_new_tokens=4)
                        for i, p in enumerate(prompts)])
    assert len(comps) == 3 and eng.batch.n_active == 0
    for name, leaf in eng.batch.cache.items():
        if name != "pos":
            assert not leaf.abs().sum(), f"evicted slot cache {name} not zeroed"
    for c, ref in zip(comps, _sequential(ts, tp, prompts, 4, 24)):
        np.testing.assert_array_equal(c.tokens, ref)


def _pool(mod_pool, mod_delay, mod_slo, seed):
    speeds = np.random.default_rng(0).uniform(1.0, 4.0, 8)
    return mod_pool(speeds, s=2, k=16, straggler_model=mod_delay(s=2, delay=5.0),
                    policy=mod_slo.for_slo(ttft_slo_s=np.inf), seed=seed)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
def test_engine_completions_and_records_match_jax(served, arch):
    """The trace of examples/serve_lm.py at reduced width: Poisson
    arrivals, mixed prompts and budgets, a seeded coded-prefill pool, EOS on
    some requests, ``decode_dt`` pinned.  Tokens and every RequestRecord
    field equal the JAX engine's; the summaries agree."""
    cfg, _, jp, js, _, tp, ts = served[arch]
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(0.3, 10))
    reqs = [(int(rng.integers(8, 24)), int(rng.integers(6, 14))) for _ in range(10)]
    prompts = _prompts(cfg, [s for s, _ in reqs], seed=12)
    eos = {3: int(_sequential(ts, tp, [prompts[3]], 4, 40)[0][2])}

    def run(engine_cls, req_cls, server, params, pool):
        eng = engine_cls(server, params, n_slots=3, cache_len=40, replicas=pool, decode_dt=0.01)
        return eng.run([req_cls(rid=i, tokens=prompts[i], max_new_tokens=new,
                                arrival_t=float(arrivals[i]), eos_id=eos.get(i))
                        for i, (_, new) in enumerate(reqs)])

    jcomps, jmet = run(JEngine, JRequest, js, jp, _pool(JPool, JDelay, JSLOPolicy, 1))
    tcomps, tmet = run(ServingEngine, Request, ts, tp, _pool(ReplicaPool, FixedDelayStragglers,
                                                             SLOPolicy, 1))
    assert len(tcomps) == len(jcomps) == 10
    for t, j in zip(tcomps, jcomps):
        assert t.rid == j.rid
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert dataclasses.asdict(t.record) == dataclasses.asdict(j.record)
    assert tmet.summary() == jmet.summary()
    assert len(tcomps[3].tokens) < reqs[3][1]  # the EOS request stopped early


def test_engine_trace_spans_follow_the_records(served):
    cfg, _, _, _, _, tp, ts = served["mamba2-370m"]
    tracer = Tracer()
    eng = ServingEngine(ts, tp, n_slots=2, cache_len=24, decode_dt=0.01, trace=tracer,
                        replicas=_pool(ReplicaPool, FixedDelayStragglers, SLOPolicy, 2))
    comps, _ = eng.run([Request(rid=i, tokens=p, max_new_tokens=3, arrival_t=0.1 * i)
                        for i, p in enumerate(_prompts(cfg, (8, 9, 10), seed=13))])
    spans = {(r["name"], r["tid"]): r for r in tracer.records(kind="span")}
    for c in comps:
        rec = c.record
        for name, t0, t1 in (("request", rec.arrival_t, rec.done_t),
                             ("request.queue", rec.arrival_t, rec.admit_t),
                             ("request.prefill", rec.admit_t, rec.prefill_done_t),
                             ("request.decode", rec.prefill_done_t, rec.done_t)):
            span = spans[(name, c.rid)]
            assert (span["t0"], span["t1"], span["clock"]) == (t0, t1, "sim")
    first = {r["tid"]: r["t"] for r in tracer.records(kind="instant", name="request.first_token")}
    assert first == {c.rid: c.record.first_token_t for c in comps}


def test_queue_rejection_and_oversize_prompt(served):
    cfg, _, _, _, _, tp, ts = served["mamba2-370m"]
    eng = ServingEngine(ts, tp, n_slots=1, cache_len=16, max_queue=2, decode_dt=0.01)
    accepted = [eng.submit(Request(rid=i, tokens=p, max_new_tokens=2))
                for i, p in enumerate(_prompts(cfg, (8, 8, 8, 8), seed=7))]
    assert accepted == [True, True, False, False]
    assert eng.metrics.rejected == 2
    eng2 = ServingEngine(ts, tp, n_slots=1, cache_len=16, decode_dt=0.01)
    assert not eng2.submit(Request(rid=0, tokens=_prompts(cfg, (17,), seed=8)[0],
                                   max_new_tokens=2))


# ---------------------------------------------------------------------------
# the numpy-only modules: bit-equal to JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slo", [np.inf, 5.0])
def test_replica_pool_outcomes_bit_equal_jax(slo):
    speeds = np.array([1.0, 2.0, 4.0, 8.0, 3.0, 1.5])
    kw = dict(s=1, k=12, comm_time=0.01, work_ref_tokens=128, seed=3)
    jpool = JPool(speeds, straggler_model=JDelay(s=2, delay=20.0),
                  policy=JSLOPolicy.for_slo(ttft_slo_s=slo), **kw)
    tpool = ReplicaPool(speeds, straggler_model=FixedDelayStragglers(s=2, delay=20.0),
                        policy=SLOPolicy.for_slo(ttft_slo_s=slo), **kw)
    got, want = [], []
    for i, n in enumerate((128, 300, 64, 2048, 128, 17)):
        if i == 3:
            jpool.mark_dead([1])
            tpool.mark_dead([1])
        if i == 5:
            jpool.revive()
            tpool.revive()
        want.append(jpool.prefill(n))
        got.append(tpool.prefill(n))
    assert tpool.dead == jpool.dead
    assert [dataclasses.astuple(o) for o in got] == [dataclasses.astuple(o) for o in want]


def test_metrics_summary_bit_equal_jax():
    r = np.random.default_rng(4)
    jm, tm = JMetrics(), ServingMetrics()
    for i in range(7):
        t = np.sort(r.uniform(0, 10, 5))
        fields = dict(rid=i, arrival_t=t[0], admit_t=t[1], prefill_done_t=t[2],
                      first_token_t=t[3], done_t=t[4], n_tokens=int(r.integers(1, 50)),
                      prefill_exact=bool(i % 3), replicas_used=int(r.integers(1, 8)),
                      prefill_all_done_t=t[2] + 1.0)
        jm.observe(JRecord(**fields))
        tm.observe(RequestRecord(**fields))
        assert RequestRecord(**fields).ttft == JRecord(**fields).ttft
    jm.reject(2)
    tm.reject(2)
    assert tm.summary() == jm.summary()
    empty = ServingMetrics().summary()
    assert empty["n_requests"] == 0.0 and np.isnan(empty["ttft_p50_s"])
