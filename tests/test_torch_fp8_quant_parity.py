"""repro_torch fp8 factor slice against the JAX package, on the CPU: the
rows codec and stat encode/decode, the fp8_pack / fp8_unpack /
factor_sum_wire dispatch ops, the byte accounting, and the SP-NGD
optimizer with an fp8 factor history on the JAX package's MLP fixture
(``tests/test_ngd_optimizer.py``, ``tests/test_quant.py:190-266``).

The JAX side runs its ``ref`` ops and, for fp8_pack/fp8_unpack, its Pallas
kernels in interpret mode (as ``tests/test_quant.py`` runs them). Payloads
and scales are compared bit for bit. pow2 scales are compared only where
XLA's CPU exp2 is exact (ROADMAP Queue 3). factor_sum_wire is held to the
JAX package's ``_factor_sum_wire_ref`` (not to its Pallas output, whose own
parity test fails on this jax): scales within 1e-6 relative, payload bytes
within one fp8 step (the f32 sums in another order). The CUDA kernels
themselves run only on the card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kfac as jkfac
from repro.core import tagging as jtagging
from repro.core.fisher import SiteInfo as JSiteInfo
from repro.core.ngd import NGDConfig as JNGDConfig
from repro.core.ngd import SPNGD as JSPNGD
from repro.core.stale import IntervalController as JController
from repro.core.stale import stat_payload_bytes as jstat_payload_bytes
from repro.kernels import dispatch as jdispatch
from repro.quant import quant as jquant
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import kfac, tagging
from repro_torch.core.fisher import SiteInfo
from repro_torch.core.ngd import NGDConfig, SPNGD
from repro_torch.core.stale import (IntervalController, stat_payload_bytes,
                                    sym_packed_bytes)
from repro_torch.kernels import dispatch
from repro_torch.kernels import quant as qk
from repro_torch.quant import quant

FMTS = ["e4m3", "e5m2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the machine's cores: torch's intra-op threads
    would spin against the other workers' and JAX's, so this module's torch
    ops run on one thread (the models are tiny)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _fp8_ordinal(bits: np.ndarray) -> np.ndarray:
    """fp8 codes as signed ordinals: neighbouring values differ by one."""
    mag = (bits & 0x7F).astype(np.int32)
    return np.where(bits >= 0x80, -mag, mag)


def _sym_blocked(rng, nb, b, lead=()):
    x = rng.randn(*lead, nb, b, b).astype(np.float32)
    return x + np.swapaxes(x, -1, -2)


# ---------------------------------------------------------------------------
# fp8_pack / fp8_unpack: bit-identical to the JAX ref and Pallas ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale_mode", ["fp32", "pow2"])
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("nb,b,lead", [(1, 8, ()), (3, 33, ()),
                                       (2, 16, (2,))])
def test_fp8_pack_unpack_match_jax(nb, b, lead, fmt, scale_mode):
    """Zero blocks included (scale 1); pow2 inside the range where XLA's
    exp2 is exact: the blocks scale with the format's range, so every
    scale lies in 2^-8 .. 2^-4."""
    rng = np.random.RandomState(nb * 10 + b)
    f = _sym_blocked(rng, nb, b, lead) * (quant.FMT_MAX[fmt] / 448.0)
    f[..., 0, :, :] = 0.0
    tp, ts = dispatch.fp8_pack(torch.from_numpy(f), fmt=fmt,
                               scale_mode=scale_mode)
    assert tp.shape == lead + (nb, b * (b + 1) // 2)
    assert ts.shape == lead + (nb,)
    assert (ts[..., 0] == 1.0).all()
    out = dispatch.fp8_unpack(tp, ts, b)
    for backend in ("ref", "pallas"):
        jp, js = jdispatch.fp8_pack(jnp.asarray(f), fmt=fmt,
                                    scale_mode=scale_mode, backend=backend)
        np.testing.assert_array_equal(_bits(tp), _bits(jp))
        np.testing.assert_array_equal(_bits(ts), _bits(js))
        jout = jdispatch.fp8_unpack(jp, js, b, backend=backend)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn",
                                   "float8_e5m2"])
@pytest.mark.parametrize("b,nb,lead", [(1, 1, ()), (7, 2, (3,)),
                                       (33, 1, (2, 2))])
def test_sym_pack_and_unpack_equal_jax(b, nb, lead, dtype):
    """Random bit patterns of every payload dtype through both gathers,
    held against the JAX package's outputs (not against a round-trip
    property, whose JAX test fails on this jax; ROADMAP Queue 3). NaN
    encodings are left out: XLA's gather does not keep their bits."""
    dt = jnp.dtype(dtype)
    t = b * (b + 1) // 2
    rng = np.random.RandomState(b * 7 + nb + len(dtype))

    def rand(shape):
        v = rng.randint(0, 256, size=shape[:-1] + (shape[-1] * dt.itemsize,),
                        dtype=np.uint8).view(dt)
        v[np.isnan(v.astype(np.float32))] = 0
        return jnp.asarray(v)
    jp = rand(lead + (nb, t))
    jf = jkfac.sym_unpack(jp, b)
    tf = kfac.sym_unpack(to_torch(np.asarray(jp)), b)
    np.testing.assert_array_equal(_bits(tf), _bits(jf))
    jd = rand(lead + (nb, b, b))
    tpk = kfac.sym_pack(to_torch(np.asarray(jd)))
    np.testing.assert_array_equal(_bits(tpk), _bits(jkfac.sym_pack(jd)))
    r, c = kfac.tril_indices(b)
    jr, jc = jkfac.tril_indices(b)
    np.testing.assert_array_equal(r.numpy(), jr)
    np.testing.assert_array_equal(c.numpy(), jc)


# ---------------------------------------------------------------------------
# factor_sum_wire: the port's ref vs the JAX package's ref composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("n,d,max_dim,lead", [(64, 32, 32, ()),
                                              (50, 40, 16, ()),
                                              (24, 20, 8, (2,))])
def test_factor_sum_wire_matches_jax_ref(n, d, max_dim, lead, fmt):
    rng = np.random.RandomState(n + d)
    x = rng.randn(*lead, n, d).astype(np.float32)
    tp, ts = dispatch.factor_sum_wire(torch.from_numpy(x), max_dim, fmt=fmt)
    jp, js = jdispatch.factor_sum_wire(jnp.asarray(x), max_dim, fmt=fmt,
                                       backend="ref")
    assert tuple(tp.shape) == jp.shape and tuple(ts.shape) == js.shape
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    steps = np.abs(_fp8_ordinal(_bits(tp)).astype(np.int64)
                   - _fp8_ordinal(_bits(jp)))
    assert steps.max() <= 1
    # the wire decode is the dense factor sum within fp8 rounding
    dec = quant.decode_wire_stat({"payload": tp, "scale": ts})
    want = np.asarray(jkfac.factor_sum(jnp.asarray(x), max_dim,
                                       backend="ref"))
    amax = np.abs(want).max(axis=(-1, -2), keepdims=True)
    assert (np.abs(dec.numpy() - want) <= 0.25 * amax).all()


def test_fp8_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 8)
    before = dict(qk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        qk.quant_rows(x)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        qk.dequant_rows(x.to(torch.float8_e4m3fn), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        qk.factor_syrk_wire(x, 8)
    for op, args in (("fp8_pack", (torch.zeros(1, 4, 4),)),
                     ("factor_sum_wire", (x, 8))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            getattr(dispatch, op)(*args, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.fp8_unpack(x.to(torch.float8_e4m3fn)[:, :6], torch.ones(2),
                            3, backend="cuda")
    assert qk.LAUNCHES == before
    dispatch.reset_calls()
    dispatch.fp8_pack(torch.zeros(1, 4, 4))
    assert dispatch.CALLS == {("fp8_pack", "ref"): 1}


def test_wire_kernel_with_callers_scratch_refuses_cpu_tensors():
    """The internal entry that leaves the kernel's f32 sums in the caller's
    scratch (chip_smoke.py's exact wire check reads them) takes CUDA
    tensors only, scratch included, and counts no launch when it refuses."""
    x = torch.zeros(16, 8)
    before = dict(qk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        qk._factor_syrk_wire(x, 8, "e4m3", "fp32", torch.zeros(1, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        qk._factor_syrk_wire(x.bfloat16(), 4, "e5m2", "pow2",
                             torch.zeros(2, 4, 4))
    assert qk.LAUNCHES == before


# ---------------------------------------------------------------------------
# stat encode/decode and the byte accounting (tests/test_quant.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FMTS)
def test_encode_decode_stats_match_jax(fmt):
    rng = np.random.RandomState(1)
    cases = [(rng.randn(4, 3) * 100, False),                 # diag rows
             (np.asarray([[1.0, 2.0 ** -20]]), False),        # wide range
             (_sym_blocked(rng, 3, 17, (2,)) * 37.0, True),
             (np.zeros((2, 5, 5)), True)]
    for x, sym in cases:
        x = x.astype(np.float32)
        je = jquant.encode_stat(jnp.asarray(x), fmt, symmetric=sym,
                                backend="ref")
        te = quant.encode_stat(torch.from_numpy(x), fmt, symmetric=sym)
        assert quant.is_wire(te) and jquant.is_wire(je)
        for k in ("payload", "scale"):
            np.testing.assert_array_equal(_bits(te[k]), _bits(je[k]))
        jd = jquant.decode_stat(je, x.shape, symmetric=sym, backend="ref")
        td = quant.decode_stat(te, x.shape, symmetric=sym)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert quant.encoded_nbytes(x.shape, sym) == \
            jquant.encoded_nbytes(x.shape, sym)
    wire = {"payload": te["payload"], "scale": te["scale"]}
    assert quant.wire_dense_shape(wire) == jquant.wire_dense_shape(je)
    assert [quant.tri_rows(t) for t in (1, 3, 15, 2098176)] == \
        [jquant.tri_rows(t) for t in (1, 3, 15, 2098176)]
    with pytest.raises(ValueError, match="triangular"):
        quant.tri_rows(5)


def test_stat_payload_bytes_match_jax():
    """tests/test_quant.py:268-277's numbers, and the JAX package's
    function on the same arguments."""
    assert stat_payload_bytes((2, 8, 8), torch.float32) == 2 * 36 * 4
    assert stat_payload_bytes((2, 8, 8), torch.bfloat16) == 2 * 36 * 2
    assert stat_payload_bytes((2, 8, 8), "fp8_e4m3") == 2 * 36 + 2 * 4
    assert stat_payload_bytes((3, 5), torch.float32) == 15 * 4
    assert stat_payload_bytes((3, 5), "fp8_e4m3") == 15 + 3 * 4
    assert stat_payload_bytes((4, 4), torch.float32, symmetric=False) == 64
    for shape, sym in (((2, 8, 8), None), ((3, 5), None), ((4, 4), False),
                       ((16, 4, 2048, 2048), True), ((128256,), False)):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16),
                         ("fp8_e4m3", "fp8_e4m3"), ("fp8_e5m2", "fp8_e5m2")):
            assert stat_payload_bytes(shape, tdt, symmetric=sym) == \
                jstat_payload_bytes(shape, jdt, symmetric=sym)
    assert quant.parse_factor_dtype(torch.float32) is None
    assert quant.parse_factor_dtype("fp8_e5m2") == "e5m2"
    with pytest.raises(ValueError, match="factor_dtype"):
        quant.parse_factor_dtype("fp8")
    assert set(quant.FACTOR_DTYPES) == set(jquant.FACTOR_DTYPES)


# ---------------------------------------------------------------------------
# the optimizer with an fp8 factor history: tests/test_quant.py's MLP
# ---------------------------------------------------------------------------

D_IN, D_H, D_OUT, N = 6, 8, 4, 64
JSPEC = jtagging.FactorSpec(max_dim=64)
TSPEC = tagging.FactorSpec(max_dim=64)


def _jloss(params, fstats, batch):
    h = jtagging.dense_site(batch["x"], params["w1"],
                            fstats["l1"] if fstats else None, JSPEC)
    o = jtagging.dense_site(jnp.tanh(h), params["w2"],
                            fstats["l2"] if fstats else None, JSPEC)
    return jnp.mean((o - batch["y"]) ** 2), {"logits": o}


def _tloss(params, fstats, batch):
    h = tagging.dense_site(batch["x"], params["w1"],
                           fstats["l1"] if fstats else None, TSPEC)
    o = tagging.dense_site(torch.tanh(h), params["w2"],
                           fstats["l2"] if fstats else None, TSPEC)
    return torch.mean((o - batch["y"]) ** 2), {"logits": o}


def _jfstats():
    return {"l1": jtagging.make_stats(JSPEC, D_IN, D_H),
            "l2": jtagging.make_stats(JSPEC, D_H, D_OUT)}


def _tfstats():
    return {"l1": tagging.make_stats(TSPEC, D_IN, D_H),
            "l2": tagging.make_stats(TSPEC, D_H, D_OUT)}


def _counts(batch):
    n = batch["x"].shape[0]
    return {"l1": (n, n), "l2": (n, n)}


def _data(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D_IN).astype(np.float32)
    w_true = rng.randn(D_IN, D_OUT)
    y = (x @ w_true + 0.01 * rng.randn(N, D_OUT)).astype(np.float32)
    return x, y


def _params0(seed=7):
    rng = np.random.RandomState(seed)
    return {"w1": (rng.randn(D_IN, D_H) * 0.4).astype(np.float32),
            "w2": (rng.randn(D_H, D_OUT) * 0.4).astype(np.float32)}


def _jopt(**kw):
    infos = {"l1": JSiteInfo("dense", "w1", D_IN, D_H, JSPEC),
             "l2": JSiteInfo("dense", "w2", D_H, D_OUT, JSPEC)}
    return JSPNGD(_jloss, infos, _jfstats, _counts,
                  JNGDConfig(damping=1e-3, backend="ref", **kw))


def _topt(**kw):
    infos = {"l1": SiteInfo("dense", "w1", D_IN, D_H, TSPEC),
             "l2": SiteInfo("dense", "w2", D_H, D_OUT, TSPEC)}
    return SPNGD(_tloss, infos, _tfstats, _counts, NGDConfig(damping=1e-3,
                                                             **kw))


def _run_jax(steps=20, seed=lambda t: t, **kw):
    opt = _jopt(**kw)
    params = {k: jnp.asarray(v) for k, v in _params0().items()}
    state = opt.init(params)
    ctrl = JController(opt.stat_names(), alpha=0.1,
                       bytes_per_stat=opt.stat_bytes())
    step_j, fast_j = jax.jit(opt.step), jax.jit(opt.step_fast)
    losses, schedule = [], []
    for t in range(1, steps + 1):
        x, y = _data(seed(t))
        batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        flags = ctrl.flags(t)
        schedule.append(tuple(sorted(k for k, v in flags.items() if v)))
        if any(flags.values()):
            jf = {k: jnp.asarray(v) for k, v in flags.items()}
            params, state, m = step_j(params, state, batch, jf, 1e-3, 0.1,
                                      0.9)
            ctrl.update(t, flags, {k: (float(v[0]), float(v[1]))
                                   for k, v in m["sims"].items()})
        else:
            params, state, m = fast_j(params, state, batch, 1e-3, 0.1, 0.9)
            ctrl.update(t, flags, {})
        losses.append(float(m["loss"]))
    return losses, schedule


def _run_torch(steps=20, seed=lambda t: t, **kw):
    opt = _topt(**kw)
    params = {k: torch.from_numpy(v.copy()) for k, v in _params0().items()}
    state = opt.init(params)
    ctrl = IntervalController(opt.stat_names(), alpha=0.1,
                              bytes_per_stat=opt.stat_bytes())
    losses, schedule = [], []
    for t in range(1, steps + 1):
        x, y = _data(seed(t))
        batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        flags = ctrl.flags(t)
        schedule.append(tuple(sorted(k for k, v in flags.items() if v)))
        if any(flags.values()):
            params, state, m = opt.step(params, state, batch, flags, 1e-3,
                                        0.1, 0.9)
            ctrl.update(t, flags, m["sims"])
        else:
            params, state, m = opt.step_fast(params, state, batch, 1e-3, 0.1,
                                             0.9)
            ctrl.update(t, flags, {})
        losses.append(float(m["loss"]))
    return losses, schedule, state


def _history_nbytes(state):
    from repro_torch.core.fisher import flatten
    return sum(v.numel() * v.element_size() for c in state["curv"].values()
               for part in ("prev", "prev2")
               for v in flatten(c[part]).values())


@pytest.mark.parametrize("stream", ["fresh", "fixed"])
def test_fp8_history_optimizer_matches_jax(stream):
    """The same Algorithm-2 schedule as the JAX package's fp8 run, the first
    8 of 20 losses within rtol = atol = 1e-3, and the history at most 0.27x
    the f32 history's bytes (tests/test_quant.py's acceptance). "fresh"
    draws a batch a step, as tests/test_quant.py does (every statistic
    refreshes every step); "fixed" repeats one batch, so intervals grow and
    stale statistics sit beside refreshed ones in a family."""
    seed = (lambda t: t) if stream == "fresh" else (lambda t: 0)
    want, jsched = _run_jax(seed=seed, factor_dtype="fp8_e4m3")
    got, tsched, st8 = _run_torch(seed=seed, factor_dtype="fp8_e4m3")
    assert tsched == jsched
    if stream == "fixed":
        assert len(set(tsched)) > 1                 # not every step refreshes
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:8], want[:8], rtol=1e-3, atol=1e-3)
    _, _, st32 = _run_torch(seed=seed)
    assert _history_nbytes(st8) <= 0.27 * _history_nbytes(st32)
    opt8, opt32 = _topt(factor_dtype="fp8_e4m3"), _topt()
    assert opt8.stat_bytes() == _jopt(factor_dtype="fp8_e4m3").stat_bytes()
    assert opt32.stat_bytes() == {
        f"{fam}.{key}": sym_packed_bytes(tuple(leaf.shape))
        for fam, stats in opt32.fstats_fn().items()
        for key, leaf in stats.items()}


def test_fp8_mixed_flags_keep_the_stale_payload_bits():
    """One statistic refreshes and its sibling does not: the stale one
    keeps its stored payload and scale bit for bit (the select is at the
    encoded level), its decoded X_-1 feeds the family's new inverse, and the
    port's state agrees with the JAX package's."""
    x0, y0 = _data(0)
    x1, y1 = _data(1)
    jopt, topt = _jopt(factor_dtype="fp8_e4m3"), _topt(factor_dtype="fp8_e4m3")
    jp = {k: jnp.asarray(v) for k, v in _params0(3).items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in _params0(3).items()}
    js, ts = jopt.init(jp), topt.init(tp)
    on = {k: True for k in topt.stat_names()}
    mixed = dict(on, **{"l1.g": False})
    step = jax.jit(jopt.step)
    for (x, y), flags in (((x0, y0), on), ((x1, y1), mixed)):
        before = {k: v.clone() for k, v in
                  ts["curv"]["l1"]["prev"]["g"].items()}
        pc_before = ts["curv"]["l1"]["precond"]["g"].clone()
        jp, js, _ = step(jp, js, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                         {k: jnp.asarray(v) for k, v in flags.items()},
                         1e-3, 0.1, 0.9)
        tp, ts, _ = topt.step(tp, ts, {"x": torch.from_numpy(x),
                                       "y": torch.from_numpy(y)}, flags,
                              1e-3, 0.1, 0.9)
    after = ts["curv"]["l1"]["prev"]["g"]
    for k in ("payload", "scale"):
        np.testing.assert_array_equal(_bits(after[k]), _bits(before[k]))
    assert not torch.equal(ts["curv"]["l1"]["precond"]["g"], pc_before)
    for fam in ("l1", "l2"):
        for part in ("prev", "prev2"):
            for key in ("a", "g"):
                je = js["curv"][fam][part][key]
                te = ts["curv"][fam][part][key]
                np.testing.assert_allclose(te["scale"].numpy(),
                                           np.asarray(je["scale"]), rtol=1e-5)
                d = np.abs(_fp8_ordinal(_bits(te["payload"])).astype(np.int64)
                           - _fp8_ordinal(_bits(je["payload"])))
                assert d.max() <= 1, (fam, part, key)


def test_fp8_init_state_is_encoded_zeros_without_a_launch():
    """Zero history as expanded views of payload 0 and scale 1, the bytes
    of the JAX package's encoded zeros; bf16 history a dense bf16 view."""
    topt, jopt = _topt(factor_dtype="fp8_e5m2"), _jopt(factor_dtype="fp8_e5m2")
    params = {k: torch.from_numpy(v) for k, v in _params0().items()}
    dispatch.reset_calls()
    st = topt.init(params)
    assert dispatch.CALLS == {}
    js = jopt.init({k: jnp.asarray(v) for k, v in _params0().items()})
    for fam in ("l1", "l2"):
        for key in ("a", "g"):
            te, je = st["curv"][fam]["prev"][key], js["curv"][fam]["prev"][key]
            assert te["payload"].stride() == (0,) * te["payload"].dim()
            for k in ("payload", "scale"):
                np.testing.assert_array_equal(_bits(te[k]), _bits(je[k]))
    sb = _topt(factor_dtype=torch.bfloat16).init(params)
    assert sb["curv"]["l1"]["prev"]["a"].dtype == torch.bfloat16
