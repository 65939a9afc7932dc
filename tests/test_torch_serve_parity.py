"""repro_torch serving path against the JAX package, on the CPU.

The same JAX params (moved over through numpy with ``params_from_jax``)
and the same token ids go through both packages' ``DecoderLM.forward``,
``prefill`` + teacher-forced ``decode_step`` and the continuous batcher,
at the reduced ``llama3_2_1b`` (2 layers, 4 heads, f32) with GQA groups 4
and 1 and windows 0 and 4. Logits agree to 1e-4 (cross-framework f32
reduction order); greedy tokens agree exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.transformer import DecoderLM as JDecoderLM
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import cache_bytes as jcache_bytes
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve import (ContinuousBatcher, Request, ServeConfig,
                               cache_bytes)

TOL = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _models(n_kv=1, window=0):
    jcfg = dataclasses.replace(jget_config("llama3_2_1b").reduced(),
                               n_kv_heads=n_kv, sliding_window=window,
                               backend="ref")
    jm = JDecoderLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(),
                              n_kv_heads=n_kv, sliding_window=window)
    tm = DecoderLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu"))
    return jm, jp, tm


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _serve_pair(window, kv_dtype="f32"):
    kw = dict(kv_cache="ring" if window else "dense", kv_dtype=kv_dtype)
    return JServeConfig(backend="ref", **kw), ServeConfig(**kw)


def _teacher_forced_jax(jm, jp, toks, s, serve):
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                               max_len=toks.shape[1], serve=serve)
    step = jax.jit(functools.partial(jm.decode_step, serve=serve))
    outs = [logits]
    for i in range(s, toks.shape[1]):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, i]))
        outs.append(lg[:, None])
    return np.asarray(jnp.concatenate(outs, axis=1)), cache


@torch.no_grad()
def _teacher_forced_torch(tm, toks, s, serve):
    t = torch.as_tensor(toks)
    logits, cache = tm.prefill({"tokens": t[:, :s]}, max_len=t.shape[1],
                               serve=serve)
    outs = [logits]
    for i in range(s, t.shape[1]):
        lg, cache = tm.decode_step(cache, t[:, i], serve=serve)
        outs.append(lg[:, None])
    return torch.cat(outs, dim=1).numpy(), cache


def test_reduced_config_matches_jax():
    j = jget_config("llama3_2_1b").reduced()
    t = get_config("llama3_2_1b").reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "rope_theta", "sliding_window", "act",
              "gated_mlp", "norm", "kfac_max_dim", "head_g_kind", "remat",
              "aux_loss_coef"):
        assert getattr(j, f) == getattr(t, f), f
    with pytest.raises(ValueError, match="pallas"):
        dataclasses.replace(t, backend="pallas")
    with pytest.raises(ValueError, match="pallas"):
        ServeConfig(backend="pallas")


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("n_kv", [1, 4])       # GQA group sizes 4 and 1
def test_prefill_decode_logits_match_jax(n_kv, window):
    """forward, prefill and teacher-forced decode (the ring wraps twice at
    window 4) against the JAX package."""
    jm, jp, tm = _models(n_kv, window)
    toks = _tokens(2, 16, tm.cfg.vocab, seed=n_kv + window)
    with torch.no_grad():
        full_t, _ = tm({"tokens": torch.as_tensor(toks)})
    full_j, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j), **TOL)
    js, ts = _serve_pair(window)
    dec_j, cache_j = _teacher_forced_jax(jm, jp, toks, 8, js)
    dec_t, cache_t = _teacher_forced_torch(tm, toks, 8, ts)
    np.testing.assert_allclose(dec_t, dec_j, **TOL)
    np.testing.assert_allclose(cache_t["k"].numpy(), np.asarray(cache_j["k"]),
                               **TOL)
    np.testing.assert_array_equal(cache_t["len"].numpy(),
                                  np.asarray(cache_j["len"]))


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2"])
def test_fp8_ring_decode_logits_match_jax(fmt):
    jm, jp, tm = _models(1, 4)
    toks = _tokens(2, 16, tm.cfg.vocab, seed=7)
    js, ts = _serve_pair(4, fmt)
    dec_j, cache_j = _teacher_forced_jax(jm, jp, toks, 8, js)
    dec_t, cache_t = _teacher_forced_torch(tm, toks, 8, ts)
    np.testing.assert_allclose(dec_t, dec_j, **TOL)
    assert cache_t["k"].dtype == {"fp8_e4m3": torch.float8_e4m3fn,
                                  "fp8_e5m2": torch.float8_e5m2}[fmt]
    np.testing.assert_allclose(cache_t["k_scale"].numpy(),
                               np.asarray(cache_j["k_scale"]), **TOL)


@pytest.mark.parametrize("kv_dtype", ["f32", "fp8_e4m3"])
def test_serve_cache_layout_matches_jax(kv_dtype):
    """Same keys, shapes, dtypes and bytes as the JAX package's cache."""
    jm, _, tm = _models(1, 16)
    js = JServeConfig(kv_dtype=kv_dtype)
    jc = jm.init_cache(2, 64, serve=js)
    tc = tm.init_cache(2, 64, serve=ServeConfig(kv_dtype=kv_dtype))
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert tc[key].element_size() == jc[key].dtype.itemsize, key
    assert cache_bytes(tc) == jcache_bytes(jc)


def _requests(vocab, spec, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (n,)), g) for n, g in spec]


@pytest.mark.parametrize("window", [0, 4])
def test_batcher_greedy_tokens_match_jax(window):
    """Bucketed prefill (3 -> 4, 5 -> 8 where the cache holds it) and slot
    reuse (5 requests through 2 lanes): the same greedy tokens as the JAX
    batcher, and the same prefill buckets."""
    jm, jp, tm = _models(1, window)
    spec = [(5, 4), (3, 6), (7, 3), (4, 5), (6, 2)]
    reqs = _requests(tm.cfg.vocab, spec, seed=5 + window)
    js, ts = _serve_pair(window)
    jb = JBatcher(jm, jp, js, slots=2, max_len=24)
    want = jb.run([JRequest(prompt=p, max_new=g, uid=i)
                   for i, (p, g) in enumerate(reqs)])
    tb = ContinuousBatcher(tm, ts, slots=2, max_len=24)
    got = tb.run([Request(prompt=p, max_new=g, uid=i)
                  for i, (p, g) in enumerate(reqs)])
    assert got == want
    assert tb.buckets == set(jb._prefill)
    assert all(len(got[i]) == g for i, (_, g) in enumerate(spec))


def test_batcher_sampling_deterministic_and_slot_invariant():
    """A sampled request's tokens depend on (seed, uid, prompt, max_new)
    only: the same across reruns and lane counts; another seed moves them."""
    _, _, tm = _models(1, 4)
    serve = ServeConfig(kv_dtype="f32")
    reqs = [Request(prompt=p, max_new=g, uid=i) for i, (p, g) in
            enumerate(_requests(tm.cfg.vocab, [(4, 6)] * 3, seed=21))]
    kw = dict(max_len=16, temperature=0.8, top_k=8, seed=42)
    a = ContinuousBatcher(tm, serve, slots=2, **kw).run(list(reqs))
    assert a == ContinuousBatcher(tm, serve, slots=2, **kw).run(list(reqs))
    assert a == ContinuousBatcher(tm, serve, slots=3, **kw).run(
        list(reversed(reqs)))
    d = ContinuousBatcher(tm, serve, slots=2, max_len=16, temperature=0.8,
                          top_k=8, seed=7).run(list(reqs))
    assert d != a


def test_batcher_temperature_zero_is_greedy():
    _, _, tm = _models(1, 4)
    serve = ServeConfig(kv_dtype="f32")
    reqs = [Request(prompt=p, max_new=g, uid=i) for i, (p, g) in
            enumerate(_requests(tm.cfg.vocab, [(4, 5)] * 2, seed=17))]
    greedy = ContinuousBatcher(tm, serve, slots=2, max_len=16).run(list(reqs))
    t0 = ContinuousBatcher(tm, serve, slots=2, max_len=16, temperature=0.0,
                           seed=123).run(list(reqs))
    k1 = ContinuousBatcher(tm, serve, slots=2, max_len=16, temperature=0.7,
                           top_k=1, seed=5).run(list(reqs))
    assert t0 == greedy == k1


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    cfg = get_config("llama3_2_1b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecoderLM(cfg)
    _, _, tm = _models(1, 0)
    assert tm.device.type == "cpu"
    batcher = ContinuousBatcher(tm, ServeConfig(kv_dtype="f32"), slots=1,
                                max_len=8)
    assert batcher.cache["k"].device.type == "cpu"
    assert tm.init_cache(1, 8)["k"].device.type == "cpu"    # legacy cache
    with pytest.raises(NotImplementedError, match="unknown block_type"):
        DecoderLM(dataclasses.replace(cfg, block_type="mamba"), device="cpu")
    # the serving caches cover attention-only blocks, as repro's: its
    # _init_serve_cache and ContinuousBatcher refuse the recurrent blocks
    for arch in ("rwkv6_7b", "hymba_1_5b"):
        rm = DecoderLM(get_config(arch).reduced(), device="cpu")
        jrm = JDecoderLM(dataclasses.replace(jget_config(arch).reduced(),
                                             backend="ref"))
        for serve, make in ((JServeConfig(kv_dtype="f32"),
                             lambda s: JBatcher(jrm, None, s, slots=1,
                                                max_len=8)),
                            (ServeConfig(kv_dtype="f32"),
                             lambda s: ContinuousBatcher(rm, s, slots=1,
                                                         max_len=8))):
            with pytest.raises(NotImplementedError) as e:
                make(serve)
            assert str(e.value) == (
                f"serve caches cover attention-only blocks (dense/moe); "
                f"got block_type={get_config(arch).block_type!r}")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tm.prefill({"tokens": torch.zeros(1, 4, dtype=torch.long)},
                   max_len=8, serve=ServeConfig(kv_dtype="f32",
                                                backend="cuda"))
