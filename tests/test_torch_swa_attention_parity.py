"""The ``swa_attention`` op of repro_torch against the JAX package, on the
CPU: the (BH, S, hd) causal(-window) attention whose kernel
(``csrc/swa_flash.cu``) replaces ``repro``'s ``swa_flash``.

The port's plain version is held against ``repro.kernels.ref`` and the
interpret-mode Pallas op on the same numpy inputs, the dispatch op against
``repro``'s (``ref`` and ``pallas`` backends), and the op on flattened
heads against the model layer's chunked attention of both packages. The
kernel runs only on the card (``chip_smoke.py``); here its wrapper and the
``cuda`` backend must refuse CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro_torch.kernels import dispatch, ref, swa_attention
from repro_torch.models import attention


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
