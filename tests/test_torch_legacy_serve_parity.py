"""The legacy serving path of repro_torch (``init_cache`` / ``prefill`` /
``decode_step`` with ``serve=None``) against the JAX package's, on the CPU,
for every block type: reduced ``rwkv6_7b`` (the WKV state and the token
shifts), ``hymba_1_5b`` (K/V beside the SSM state and the conv cache),
``llama3_2_1b`` (dense K/V) and ``mixtral_8x22b`` (K/V, experts, and the
window of 16 below the cache's 24 slots, so its decode steps past
position 16 take the decode-span clamp).

Both packages start from the same JAX ``PRNGKey(0)`` params drawn under
``jax.threefry_partitionable(False)``; the tokens come from numpy with a
seed. Tolerances, relative to the largest entry (f32, another reduction
order): logits and every cache leaf 1e-4; ``len`` exactly equal.
``repro``'s side (its params too) runs in processes of their own on one
CPU (``tests/jax_one_cpu.py``), started with the module.

On the card the legacy attention runs the kernels (the prefill through
``swa_flash_fwd``, each decode step through ``swa_flash_decode`` over the
span a windowed query sees); their route is checked here with their plain
versions in their place: by hand (the span slice, the ``(B, KV, span,
hd)`` view, ``pos = len - start``) against ``repro``'s attention with
``q_offset`` and ``kv_len``, with the clamp binding and not, and through
the model with the dispatcher resolving to ``cuda``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.train import make_prefill_step as jmake_prefill_step
from repro.launch.train import make_serve_step as jmake_serve_step
from repro.models import attention as jattn
from repro.models.transformer import DecoderLM as JDecoderLM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import dispatch
from repro_torch.launch import train
from repro_torch.models import attention as attn_lib
from repro_torch.models.transformer import DecoderLM
import jax_one_cpu
from test_torch_train_parity import _rel

ARCHS = ["rwkv6_7b", "hymba_1_5b", "llama3_2_1b", "mixtral_8x22b"]
LANES, PROMPT, DECODE = 2, 16, 8
MAX_LEN = PROMPT + DECODE
REL = 1e-4
ROUTE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_children: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _jax_children():
    for arch in ARCHS:
        _children[arch] = jax_one_cpu.start(__name__, "jax_serve", arch)
    yield
    for child in _children.values():
        child.close()


def _tokens(vocab):
    return np.random.RandomState(11).randint(
        0, vocab, (LANES, MAX_LEN)).astype(np.int32)


def _jax_model(arch):
    return JDecoderLM(dataclasses.replace(jget_config(arch).reduced(),
                                          backend="ref"))


def jax_serve(arch):
    """repro's legacy path (run in a process of its own on one CPU): its
    params, the prefill's logits and cache, DECODE teacher-forced steps
    through ``make_serve_step`` (their logits, the cache after each), and
    ``make_prefill_step``'s logits over the prompt."""
    jm = _jax_model(arch)
    with jax.threefry_partitionable(False):
        jp = jm.init(jax.random.PRNGKey(0))
    toks = _tokens(jm.cfg.vocab)
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                               MAX_LEN)
    np_cache = lambda c: {k: np.asarray(v) for k, v in c.items()}
    out = {"params": jax.tree.map(np.asarray, jp),
           "prefill": np.asarray(logits), "caches": [np_cache(cache)],
           "decode": []}
    step = jax.jit(jmake_serve_step(jm))
    for i in range(PROMPT, MAX_LEN):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, i]))
        out["decode"].append(np.asarray(lg))
        out["caches"].append(np_cache(cache))
    out["prefill_step"] = np.asarray(jax.jit(jmake_prefill_step(jm))(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT])}))
    return out


@functools.lru_cache(maxsize=None)
def _jax_result(arch):
    return _children[arch].result()


@functools.lru_cache(maxsize=None)
def _port(arch):
    """The port's model on repro's params, and repro's model."""
    cfg = get_config(arch).reduced()
    tm = DecoderLM(cfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(_jax_result(arch)["params"],
                                               cfg, "cpu"))
    return tm, _jax_model(arch)


@torch.no_grad()
def _teacher_forced(tm):
    """The port's prefill and DECODE decode steps: (prefill logits,
    [decode logits], [cache snapshots])."""
    toks = torch.from_numpy(_tokens(tm.cfg.vocab))
    logits, cache = tm.prefill({"tokens": toks[:, :PROMPT]}, MAX_LEN)
    snap = lambda c: {k: v.clone() for k, v in c.items()}
    caches, outs = [snap(cache)], []
    for i in range(PROMPT, MAX_LEN):
        lg, cache = tm.decode_step(cache, toks[:, i])
        outs.append(lg)
        caches.append(snap(cache))
    return logits, outs, caches


def _caches_held(got, want, what):
    assert set(got) == set(want), what
    for key, w in want.items():
        g = got[key]
        assert tuple(g.shape) == w.shape, (what, key)
        if key == "len":
            assert g.dtype == torch.int32 and int(g) == int(w), what
        else:
            assert _rel(g, w) <= REL, (what, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_prefill_and_decode_match_repro(arch):
    """A 16-token prompt, then 8 teacher-forced decode steps: the logits
    of each and every cache leaf after each within 1e-4 of repro's, and
    ``len`` equal."""
    tm, _ = _port(arch)
    logits, outs, caches = _teacher_forced(tm)
    want = _jax_result(arch)
    assert _rel(logits, want["prefill"]) <= REL
    assert len(outs) == len(want["decode"]) == DECODE
    for i, (g, w) in enumerate(zip(outs, want["decode"])):
        assert g.shape == (LANES, tm.cfg.vocab)
        assert _rel(g, w) <= REL, f"decode step {i}"
    for i, (g, w) in enumerate(zip(caches, want["caches"])):
        _caches_held(g, w, f"cache after step {i}")
    assert int(caches[-1]["len"]) == MAX_LEN


@pytest.mark.parametrize("arch", ["rwkv6_7b", "mixtral_8x22b"])
def test_serve_and_prefill_steps_match_repro(arch):
    """``make_serve_step`` decodes against the legacy cache and
    ``make_prefill_step`` returns the forward's logits, as repro's."""
    tm, _ = _port(arch)
    want = _jax_result(arch)
    toks = torch.from_numpy(_tokens(tm.cfg.vocab))
    params = tm.params()
    with torch.no_grad():
        got = train.make_prefill_step(tm)(params,
                                          {"tokens": toks[:, :PROMPT]})
        assert _rel(got, want["prefill_step"]) <= REL
        _, cache = tm.prefill({"tokens": toks[:, :PROMPT]}, MAX_LEN)
        step = train.make_serve_step(tm)
        for i in range(PROMPT, MAX_LEN):
            lg, cache = step(params, cache, toks[:, i])
            assert _rel(lg, want["decode"][i - PROMPT]) <= REL
    _caches_held(cache, want["caches"][-1], "serve_step cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_cache_layout_matches_repro(arch):
    """init_cache(serve=None): repro's keys, shapes and dtypes (cfg.dtype
    or a given one for K/V, conv and the token shifts; f32 for the SSM and
    WKV states; a 0-d int32 len), full width (one layer) and reduced, on
    the model's device."""
    tm, jm = _port(arch)
    full = dataclasses.replace(get_config(arch), n_layers=1)
    jfull = JDecoderLM(dataclasses.replace(jget_config(arch), n_layers=1))
    for t, j, dtype in ((tm, jm, None),
                        (DecoderLM(full, device="meta"), jfull, None),
                        (tm, jm, torch.bfloat16)):
        jdt = None if dtype is None else jnp.bfloat16
        want = jax.eval_shape(lambda: j.init_cache(3, 40, jdt))
        got = t.init_cache(3, 40, dtype)
        assert set(got) == set(want)
        for key, w in want.items():
            assert tuple(got[key].shape) == w.shape, key
            assert got[key].dtype == getattr(torch, str(w.dtype)), key
            assert got[key].device == t.device, key
    assert tm.init_cache(1, 8)["len"].dim() == 0


def _decode_case(seed, b=2, m=24, kv=2, g=3, hd=8):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, kv * g, hd).astype(np.float32)
    k, v = (rng.randn(b, m, kv, hd).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("win,n", [(16, 5), (16, 15), (16, 20), (16, 23),
                                   (0, 20), (24, 20), (32, 9)])
def test_cuda_decode_route_layout_matches_repro_attention(win, n):
    """The legacy decode's kernel route built by hand on the plain decode
    (``dispatch.swa_decode`` with backend "ref"): the span of ``win``
    slots from ``start = clip(n + 1 - win, 0, M - win)`` when 0 < win < M
    (else the whole cache), read as a (B, KV, span, hd) view, the query
    at ``pos = n - start``, window 0; against repro's attention with
    ``q_offset`` and ``kv_len`` over the clamped span (the clamp binding
    at n 20 and 23, not at 5 and 15) and over the whole cache."""
    q, k, v = _decode_case(win * 31 + n)
    b, m, kv, hd = k.shape
    h = q.shape[2]
    start, span = 0, m
    if win and win < m:
        start = max(0, min(n + 1 - win, m - win))
        span = win
    assert (start > 0) == (win == 16 and n >= 16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    pos = torch.full((b * kv,), n - start, dtype=torch.int32)
    og = dispatch.swa_decode(
        tq[:, 0].reshape(b * kv, h // kv, hd).contiguous(),
        tk[:, start:start + span].permute(0, 2, 1, 3),
        tv[:, start:start + span].permute(0, 2, 1, 3), pos, window=0,
        backend="ref")
    got = og.reshape(b, h, hd)[:, None]
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = jattn.attention(jq, jk[:, start:start + span],
                           jv[:, start:start + span], causal=True,
                           window=win, q_offset=jnp.asarray(n - start),
                           kv_len=jnp.asarray(n + 1 - start), backend="ref")
    whole = jattn.attention(jq, jk, jv, causal=True, window=win,
                            q_offset=jnp.asarray(n),
                            kv_len=jnp.asarray(n + 1), backend="ref")
    np.testing.assert_allclose(got, want, rtol=ROUTE_TOL, atol=ROUTE_TOL)
    np.testing.assert_allclose(got, whole, rtol=ROUTE_TOL, atol=ROUTE_TOL)


@pytest.mark.parametrize("arch", ["hymba_1_5b", "mixtral_8x22b"])
def test_model_kernel_route_on_plain_versions_matches_repro(arch,
                                                            monkeypatch):
    """The model's own kernel route of the legacy attention, run on the
    CPU with the dispatcher resolving to ``cuda`` and the plain versions
    registered there: the prefill goes through ``swa_attention_fwd_res``
    once a layer and each decode step through ``swa_decode`` once a layer
    (over mixtral's clamped span from position 16 on), never through the
    plain attention, and the logits and caches match repro's within
    1e-4."""
    tm, _ = _port(arch)
    table = dispatch._TABLE
    monkeypatch.setattr(dispatch, "resolve", lambda backend, device: "cuda")
    for op in ("swa_decode", "swa_attention_fwd_res"):
        monkeypatch.setitem(table[op], "cuda", table[op]["ref"])

    def no_plain(*a, **k):
        raise AssertionError("the plain attention ran on the kernel route")
    monkeypatch.setattr(attn_lib, "attention", no_plain)
    dispatch.reset_calls()
    logits, outs, caches = _teacher_forced(tm)
    n = tm.cfg.n_layers
    assert dispatch.CALLS == {("swa_attention_fwd_res", "cuda"): n,
                              ("swa_decode", "cuda"): n * DECODE}
    want = _jax_result(arch)
    assert _rel(logits, want["prefill"]) <= REL
    for i, (g, w) in enumerate(zip(outs, want["decode"])):
        assert _rel(g, w) <= REL, f"decode step {i}"
    _caches_held(caches[-1], want["caches"][-1], "kernel-route cache")


def test_kernel_route_refuses_a_chunked_prefill(monkeypatch):
    """On the kernel route a call of several tokens after a cached prefix
    has no kernel: it raises instead of taking the plain path."""
    tm, _ = _port("llama3_2_1b")
    monkeypatch.setattr(dispatch, "resolve", lambda backend, device: "cuda")
    cache = tm.init_cache(1, 16)
    kv = {"k": cache["k"][0], "v": cache["v"][0]}
    q = torch.zeros(1, 3, tm.cfg.n_heads, tm.cfg.hd)
    k = torch.zeros(1, 3, tm.cfg.n_kv_heads, tm.cfg.hd)
    with pytest.raises(NotImplementedError, match="legacy-cache call"):
        tm._attn_legacy(q, k, k, kv, 4, 0)
