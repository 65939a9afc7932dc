"""repro_torch tagged sites and the attention backward against the JAX
package, on the CPU.

Each tagged site's (dx, dW, raw statistics) -- the gradients of a random
projection of its output with respect to its operands and its zero
accumulators -- against the JAX package's custom VJPs on the same numpy
inputs (1e-5 relative: one matmul or reduction in another order). The plain
attention backward and the port's autograd route (``_KernelAttention`` with
``backend="ref"``) against ``ops.swa_attention_bwd`` in interpret mode and
``jax.grad`` of the reference forward, at 1e-3 relative to the largest
gradient, the JAX package's own attention-gradient tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tagging as jtag
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro_torch.configs import get_config
from repro_torch.core import tagging
from repro_torch.core.fisher import emp_fisher_grads, flatten
from repro_torch.kernels import dispatch, ref, swa_attention
from repro_torch.models import attention
from repro_torch.models.transformer import DecoderLM


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _acc(shape):
    return torch.zeros((), requires_grad=True).expand(shape)


def _torch_grads(fn, args, r):
    """Gradients of sum(fn(*args) * r) w.r.t. every tensor in ``args`` that
    takes one."""
    args = [a.requires_grad_() if isinstance(a, torch.Tensor)
            and a.is_floating_point() and a.is_leaf else a for a in args]
    out = fn(*args)
    wrt = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
    return torch.autograd.grad((out * r).sum(), wrt)


@pytest.mark.parametrize("a_kind,g_kind", [("full", "full"), ("diag", "full"),
                                           ("full", "diag"), ("full", "none")])
def test_dense_site_matches_jax(a_kind, g_kind):
    rng = np.random.default_rng(1)
    d_in, d_out = 20, 12
    x, w, r = _rand(rng, (2, 5, d_in)), _rand(rng, (d_in, d_out)), \
        _rand(rng, (2, 5, d_out))
    jspec = jtag.FactorSpec(a_kind=a_kind, g_kind=g_kind, max_dim=8,
                            backend="ref")
    tspec = tagging.FactorSpec(a_kind=a_kind, g_kind=g_kind, max_dim=8)
    js = jtag.make_stats(jspec, d_in, d_out)

    def jf(x, w, st):
        return jnp.sum(jtag.dense_site(x, w, st, jspec) * r)
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), js)
    ts = {k: _acc(v.shape) for k, v in js.items()}
    keys = sorted(ts)
    out = _torch_grads(lambda x, w, *accs: tagging.dense_site(
        x, w, dict(zip(keys, accs)), tspec),
        [torch.from_numpy(x), torch.from_numpy(w)] + [ts[k] for k in keys],
        torch.from_numpy(r))
    assert _rel(out[0], jg[0]) <= 1e-5 and _rel(out[1], jg[1]) <= 1e-5
    for k, g in zip(keys, out[2:]):
        assert tuple(g.shape) == js[k].shape
        assert _rel(g, jg[2][k]) <= 1e-5, k


def test_bias_site_matches_jax():
    rng = np.random.default_rng(2)
    x, b, r = _rand(rng, (3, 4, 6)), _rand(rng, (6,)), _rand(rng, (3, 4, 6))
    js = jtag.make_bias_stats(6)
    jg = jax.grad(lambda x, b, s: jnp.sum(jtag.bias_site(x, b, s) * r),
                  argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(b), js)
    out = _torch_grads(lambda x, b, d: tagging.bias_site(x, b, {"d": d}),
                       [torch.from_numpy(x), torch.from_numpy(b), _acc((6,))],
                       torch.from_numpy(r))
    for got, want in zip(out, (jg[0], jg[1], jg[2]["d"])):
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("beta,spatial", [(False, 0), (True, 0), (True, 2)])
def test_scale_bias_site_matches_jax(beta, spatial):
    rng = np.random.default_rng(3)
    shape = (2, 3, 4, 5) if spatial else (2, 7, 5)
    xh, gm, bt, r = _rand(rng, shape), _rand(rng, (5,)), _rand(rng, (5,)), \
        _rand(rng, shape)
    js = jtag.make_scale_bias_stats(5)
    key = "uw"

    def jf(xh, gm, bt, st):
        return jnp.sum(jtag.scale_bias_site(xh, gm, bt if beta else None, st,
                                            spatial=spatial) * r)
    jg = jax.grad(jf, argnums=(0, 1, 2, 3))(jnp.asarray(xh), jnp.asarray(gm),
                                           jnp.asarray(bt), js)
    args = [torch.from_numpy(xh), torch.from_numpy(gm)] + (
        [torch.from_numpy(bt)] if beta else []) + [_acc(js[key].shape)]
    out = _torch_grads(lambda xh, gm, *rest: tagging.scale_bias_site(
        xh, gm, rest[0] if beta else None, {key: rest[-1]}, spatial=spatial),
        args, torch.from_numpy(r))
    want = [jg[0], jg[1]] + ([jg[2]] if beta else []) + [jg[3][key]]
    for got, w in zip(out, want):
        assert _rel(got, w) <= 1e-5


def test_embed_site_matches_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 11, (3, 6)).astype(np.int32)
    ids[0, :3] = 2                                    # repeated rows add up
    table, r = _rand(rng, (11, 10)), _rand(rng, (3, 6, 10))
    jspec = jtag.FactorSpec(a_kind="diag", g_kind="full", max_dim=4,
                            backend="ref")
    js = jtag.make_embed_stats(11, 10, jspec)
    jg = jax.grad(lambda t, s: jnp.sum(jtag.embed_site(
        jnp.asarray(ids), t, s, jspec) * r), argnums=(0, 1))(
        jnp.asarray(table), js)
    tspec = tagging.FactorSpec(a_kind="diag", g_kind="full", max_dim=4)
    ts = tagging.make_embed_stats(11, 10, tspec)
    out = _torch_grads(lambda t, a, g: tagging.embed_site(
        torch.from_numpy(ids).long(), t, {"a": a, "g": g}, tspec),
        [torch.from_numpy(table), _acc(ts["a"].shape), _acc(ts["g"].shape)],
        torch.from_numpy(r))
    assert _rel(out[0], jg[0]) <= 1e-5
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jg[1]["a"]))
    assert _rel(out[2], jg[1]["g"]) <= 1e-5


def test_untagged_sites_are_the_plain_ops():
    x, w = torch.randn(3, 4), torch.randn(4, 5)
    assert torch.equal(tagging.dense_site(x, w), x @ w)
    assert torch.equal(tagging.bias_site(x, w[:, 0]), x + w[:, 0])
    ids = torch.tensor([[1, 0]])
    assert torch.equal(tagging.embed_site(ids, w), w[ids])


# ---------------------------------------------------------------------------
# attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,window,s", [(4, 0, 16), (4, 8, 16), (1, 0, 13),
                                        (1, 8, 13), (4, 8, 13)])
def test_attention_bwd_plain_matches_jax(g, window, s):
    rng = np.random.default_rng(10 * g + window + s)
    hd = 32
    q, k, v = _rand(rng, (2, g, s, hd)), _rand(rng, (2, s, hd)), \
        _rand(rng, (2, s, hd))
    do = _rand(rng, (2, g, s, hd))
    o, lse = jref.swa_attention_fwd_res_ref(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), window=window)
    got = dispatch.swa_attention_bwd(
        *(torch.from_numpy(t) for t in (q, k, v)),
        torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(do), window=window)
    want_pl = jops.swa_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
        jnp.asarray(do), window=window, bq=8, bk=8, interpret=True)

    def fwd(q, k, v):
        return jnp.sum(jref.swa_attention_fwd_res_ref(
            q, k, v, window=window)[0] * do)
    want_ad = jax.grad(fwd, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v))
    for want in (want_pl, want_ad):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            assert _rel(a, b) <= 1e-3


@pytest.mark.parametrize("n_kv,window,s", [(1, 0, 12), (4, 0, 12),
                                           (1, 8, 16), (2, 8, 11)])
def test_kernel_attention_autograd_route_matches_jax(n_kv, window, s):
    """The autograd Function of the kernel route (forward op + backward op)
    on the CPU's plain versions, against jax.grad of the JAX package's
    attention: (B, S, H, hd) q, (B, S, KV, hd) k/v, dk/dv per KV head."""
    rng = np.random.default_rng(n_kv + window + s)
    h, hd = 4, 16
    q, k, v = _rand(rng, (2, s, h, hd)), _rand(rng, (2, s, n_kv, hd)), \
        _rand(rng, (2, s, n_kv, hd))
    r = _rand(rng, (2, s, h, hd))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = attention._kernel_attention(tq, tk, tv, window, backend="ref")
    got = torch.autograd.grad((out * torch.from_numpy(r)).sum(), (tq, tk, tv))

    def jf(q, k, v):
        return jnp.sum(jattention.attention(q, k, v, causal=True,
                                            window=window, backend="ref") * r)
    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jattention.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, backend="ref")),
        atol=2e-4, rtol=2e-4)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-3


def test_attention_bwd_wrapper_refuses_cpu_tensors():
    q = torch.zeros(2, 4, 8, 64)
    kv = torch.zeros(2, 8, 64)
    lse = torch.zeros(2, 4, 8)
    before = dict(swa_attention.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        swa_attention.swa_flash_bwd(q, kv, kv, q, lse, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.swa_attention_bwd(q, kv, kv, q, lse, q, backend="cuda")
    assert swa_attention.LAUNCHES == before


# ---------------------------------------------------------------------------
# the model's stacked families under remat
# ---------------------------------------------------------------------------

def test_remat_runs_each_tagged_backward_once_and_changes_nothing():
    """With ``remat`` every block is recomputed in the backward; the tagged
    sites' backwards still run once each, and the raw families and
    gradients are those of the plain run."""
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(
        kfac_max_dim=32))
    out = {}
    for remat in (False, True):
        m = DecoderLM(dataclasses.replace(cfg, remat=remat), device="cpu")
        m.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
                 for k in ("tokens", "labels")}
        dispatch.reset_calls()
        loss, _, grads, raw = emp_fisher_grads(m.loss, m.params(), m.fstats(),
                                               batch)
        out[remat] = (float(loss), flatten(grads), flatten(raw),
                      dict(dispatch.CALLS))
    (l0, g0, r0, c0), (l1, g1, r1, c1) = out[False], out[True]
    assert l0 == l1
    assert c0 == c1 and c0[("factor_sum", "ref")] == 7 * 2 * cfg.n_layers + 2
    for k in r0:
        assert tuple(r0[k].shape)[0] in (cfg.n_layers, cfg.vocab,
                                         cfg.d_model) or "blk" not in k
        torch.testing.assert_close(r1[k], r0[k], rtol=1e-6, atol=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-6)
