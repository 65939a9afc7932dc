"""The ``swa_attention`` op of repro_torch against the JAX package, on the
CPU: the (BH, S, hd) causal(-window) attention whose kernel
(``csrc/swa_flash.cu``) replaces ``repro``'s ``swa_flash``.

The port's plain version is held against ``repro.kernels.ref`` and the
interpret-mode Pallas op on the same numpy inputs, the dispatch op against
``repro``'s (``ref`` and ``pallas`` backends), and the op on flattened
heads against the model layer's chunked attention of both packages. The
kernel runs only on the card (``chip_smoke.py``); here its wrapper and the
``cuda`` backend must refuse CPU tensors.

At the head dims the kernels take on another instance's tiles (80, 96,
100 and 256), the plain forwards, lse and gradients are held against
``repro``'s ref and interpret-mode Pallas ops (2e-4; gradients 1e-3 of
the largest entry), and one ad-hoc model (reduced llama3_2_1b, MQA at hd
256, never registered) against ``repro``'s: forward logits, a prefill and
four decode steps on the dense cache, one SP-NGD capture step, at 1e-4.
``repro``'s model runs in a one-CPU child (``tests/jax_side_jobs.py
head_dim_model``).
"""

import dataclasses
import sys
from pathlib import Path


import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.ngd import NGDConfig, SPNGD
from repro_torch.kernels import dispatch, ref, swa_attention
from repro_torch.launch.train import make_train_step
from repro_torch.models import attention
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve import ServeConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
import jax_one_cpu  # noqa: E402
from test_torch_train_parity import _get, _leaves, _rel  # noqa: E402

# the ad-hoc model: reduced llama3_2_1b, two query heads over one KV head of
# 256 (MQA), d_model 128; its batch, prompt and step (the training parity
# fixture's damping, lr and momentum)
WIDE = dict(n_heads=2, n_kv_heads=1, head_dim=256, d_model=128)
DAMP, LR, MOM = 1e-3, 5e-3, 0.9
PROMPT, DECODE = 12, 4
_children: dict = {}
_results: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain ops' small products: the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wide_inputs():
    vocab = get_config("llama3_2_1b").reduced().vocab
    rng = np.random.RandomState(33)
    batch = {"tokens": rng.randint(0, vocab, (2, 16)).astype(np.int32),
             "labels": rng.randint(0, vocab, (2, 16)).astype(np.int32)}
    toks = rng.randint(0, vocab, (2, PROMPT + DECODE)).astype(np.int32)
    return batch, toks


@pytest.fixture(autouse=True, scope="module")
def _jax_child():
    """repro's side of the hd-256 model, started first so that it runs
    beside the module's other tests."""
    batch, toks = _wide_inputs()
    _children["wide"] = jax_one_cpu.start(
        "jax_side_jobs", "head_dim_model", WIDE, batch, toks, PROMPT, DAMP,
        LR, MOM)
    yield
    for child in _children.values():
        child.close()


def _wide():
    if "wide" not in _results:
        _results["wide"] = _children["wide"].result()
    return _results["wide"]


def _qkv(rng, shape, dtype=np.float32):
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


def _jax_ops(q, k, v, window):
    return jops.swa_attention(q, k, v, window=window, bq=16, bk=16,
                              interpret=True)


# ---------------------------------------------------------------------------
# the plain version against repro's ref and its interpret-mode Pallas op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["ref", "pallas"])
@pytest.mark.parametrize("s,window", [(64, 0), (64, 16), (64, 7), (96, 32),
                                      (50, 13)])
def test_swa_attention_plain_matches_jax(s, window, target):
    rng = np.random.default_rng(s + window)
    q, k, v = _qkv(rng, (4, s, 32))
    out = ref.swa_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window)
    fn = jref.swa_attention_ref if target == "ref" else _jax_ops
    want = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("target", ["ref", "pallas"])
def test_swa_attention_plain_matches_jax_bf16(target):
    """bf16 inputs: both sides compute in f32 and round the output once to
    bf16, so they differ by at most one bf16 step of the output."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, (2, 32, 16))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = ref.swa_attention_ref(tq, tk, tv, window=8)
    assert out.dtype == torch.bfloat16
    fn = jref.swa_attention_ref if target == "ref" else _jax_ops
    want = fn(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), window=8)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@settings(deadline=None)
@given(s=st.integers(8, 80), window=st.integers(0, 20),
       hd=st.sampled_from([8, 16, 32]))
def test_swa_attention_plain_property(s, window, hd):
    rng = np.random.default_rng(s * 31 + window + hd)
    q, k, v = _qkv(rng, (2, s, hd))
    out = ref.swa_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window)
    want = _jax_ops(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("window", [1, 70])
def test_swa_attention_plain_edge_windows(window):
    """window 1: each query sees only itself, so the output is v; a window
    at or past S is plain causal attention."""
    rng = np.random.default_rng(window)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, (3, 40, 16)))
    out = ref.swa_attention_ref(q, k, v, window=window)
    want = v if window == 1 else ref.swa_attention_ref(q, k, v)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the dispatch op against repro's, ref and pallas backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,window", [(64, 16), (50, 13), (33, 8)])
def test_swa_attention_op_matches_jax_dispatch(s, window, dtype):
    rng = np.random.default_rng(s + window)
    q, k, v = _qkv(rng, (2, s, 16))
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    dispatch.reset_calls()
    out = dispatch.swa_attention(*(torch.from_numpy(x).to(tdt)
                                   for x in (q, k, v)), window=window)
    assert dispatch.CALLS == {("swa_attention", "ref"): 1}
    assert out.dtype == tdt
    tol = 2e-4 if dtype == "f32" else 1e-2
    for backend in ("ref", "pallas"):
        want = jdispatch.swa_attention(*(jnp.asarray(x, jdt)
                                         for x in (q, k, v)),
                                       window=window, backend=backend)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


# ---------------------------------------------------------------------------
# the op on flattened heads against the model layer's chunked attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [2, 1], ids=["mha", "gqa"])
def test_swa_attention_op_matches_model_attention(kv):
    """(B, S, H, hd) heads flattened to (B*H, S, hd), KV repeated by the
    port's ``_repeat_kv`` as ``repro``'s callers do, against both packages'
    ``attention(..., window=12, chunk=16)`` on the unexpanded KV."""
    rng = np.random.default_rng(9)
    b, s, h, hd, w = 2, 48, 2, 16, 12
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tk_r = attention._repeat_kv(tk, h // kv)
    tv_r = attention._repeat_kv(tv, h // kv)

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, s, hd).contiguous()

    out = dispatch.swa_attention(flat(tq), flat(tk_r), flat(tv_r), window=w)
    out = out.reshape(b, h, s, hd).permute(0, 2, 1, 3)
    port = attention.attention(tq, tk, tv, window=w, chunk=16)
    torch.testing.assert_close(out, port, rtol=2e-4, atol=2e-4)
    jax_out = jattention.attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=w, chunk=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# the device rule: no kernel on CPU tensors, no fallback
# ---------------------------------------------------------------------------

def test_swa_attention_cuda_refuses_cpu_tensors():
    x = torch.zeros(2, 8, 64)
    before = dict(swa_attention.LAUNCHES)
    dispatch.reset_calls()
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.swa_attention(x, x, x, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        swa_attention.swa_flash(x, x, x, window=4)
    assert swa_attention.LAUNCHES == before
    assert dispatch.CALLS == {}
    out = dispatch.swa_attention(x, x, x, backend="ref")
    assert dispatch.CALLS == {("swa_attention", "ref"): 1}
    assert out.shape == x.shape


# ---------------------------------------------------------------------------
# head dims on another instance's tiles, and a whole model at hd 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["ref", "pallas"])
@pytest.mark.parametrize("hd", [80, 96, 100, 256])
def test_plain_attention_matches_jax_at_other_head_dims(hd, target):
    """BKV 2, G 2, S 24, window 7: the (BH, S, hd) forward, the GQA forward
    and its lse at 2e-4 against repro's ref and interpret-mode Pallas ops;
    the gradients from the same (o, lse) at 1e-3 of the largest entry
    against repro's interpret-mode backward (pallas) or JAX's derivative of
    its ref forward (ref)."""
    import jax
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((2, 2, 24, hd)).astype(np.float32)
    k, v = _qkv(rng, (2, 24, hd))[:2]
    do = rng.standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    w = 7
    flat = ref.swa_attention_ref(tq[:, 0], tk, tv, window=w)
    o, lse = ref.swa_attention_fwd_res_ref(tq, tk, tv, window=w)
    grads = ref.swa_attention_bwd_ref(tq, tk, tv, o, lse, tdo, window=w)
    if target == "ref":
        want_flat = jref.swa_attention_ref(jq[:, 0], jk, jv, window=w)
        jo, jl = jref.swa_attention_fwd_res_ref(jq, jk, jv, window=w)
        _, vjp = jax.vjp(lambda a, b, c: jref.swa_attention_fwd_res_ref(
            a, b, c, window=w)[0], jq, jk, jv)
        jgrads = vjp(jdo)
    else:
        want_flat = _jax_ops(jq[:, 0], jk, jv, w)
        jo, jl = jops.swa_attention_fwd_res(jq, jk, jv, window=w, bq=8, bk=8,
                                            interpret=True)
        jgrads = jops.swa_attention_bwd(jq, jk, jv, jnp.asarray(o.numpy()),
                                        jnp.asarray(lse.numpy()), jdo,
                                        window=w, bq=8, bk=8, interpret=True)
    for got, want in ((flat, want_flat), (o, jo), (lse, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-3, name


def test_model_at_head_dim_256_matches_repro():
    """The ad-hoc MQA model at hd 256 (WIDE) from repro's PRNGKey(0)
    params: forward logits, a prefill of PROMPT tokens and DECODE
    teacher-forced steps on the dense f32 cache, and one capture step's
    params and momentum, each within 1e-4 of repro's."""
    res = _wide()
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(**WIDE))
    assert (cfg.head_dim, cfg.n_heads, cfg.n_kv_heads) == (256, 2, 1)
    tm = DecoderLM(cfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(res["params"], cfg, "cpu"))
    batch, toks = _wide_inputs()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = tm.forward(tb)
        assert _rel(logits.numpy(), res["logits"]) <= 1e-4
        serve = ServeConfig(kv_cache="dense", kv_dtype="f32")
        t = torch.from_numpy(toks)
        lg, cache = tm.prefill({"tokens": t[:, :PROMPT]}, max_len=t.shape[1],
                               serve=serve)
        served = [lg]
        for i in range(PROMPT, t.shape[1]):
            lg, cache = tm.decode_step(cache, t[:, i], serve=serve)
            served.append(lg[:, None])
    assert _rel(torch.cat(served, dim=1).numpy(), res["served"]) <= 1e-4
    topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                 NGDConfig(damping=DAMP))
    ts = convert.opt_state_from_jax(res["state"], cfg, "cpu")
    flags = {k: True for k in topt.stat_names()}
    params, ts, m = make_train_step(tm, topt)(tm.params(), ts, tb, flags,
                                              DAMP, LR, MOM)
    assert abs(float(m["loss"]) - res["loss"]) <= 1e-4 * abs(res["loss"])
    jp, js = res["stepped"]
    tp = convert.params_to_jax(params)
    for path, want in _leaves(jp):
        assert _rel(_get(tp, path), want) <= 1e-4, path
    tv = convert.opt_state_to_jax(ts)["velocity"]
    for path, want in _leaves(js["velocity"]):
        assert _rel(_get(tv, path), want) <= 1e-4, path
