"""repro_torch's ConvNet path against the JAX package's, on the CPU.

* ``tagging.conv_site``: the forward, the input and weight gradients and the
  raw A/G sums, at stride 1 and 2, kernel 1 and 3, even and odd inputs
  (XLA's SAME padding, (0, 1) at stride 2 on an even input);
* the BatchNorm site (``scale_bias_site``, ``spatial=2``) with the unit-wise
  ``uw`` and the full ``uwf`` Fisher;
* ``ConvNet``: logits, loss (hard and soft labels), gradients and raw
  factor sums with ``repro``'s params carried by ``convert``; ``site_infos``,
  ``fstats`` and ``site_counts`` by name and shape; one SP-NGD capture step
  and a fast step (conv preconditioning, the ``uwf`` inverse, Eq. 24's
  conv rescaling) under eigh and Newton-Schulz;
* ``image_batches``, ``RunningMixup`` and ``random_erase`` bit for bit, and
  ``coupled_momentum`` and ``warmup_polynomial`` value for value.

Tolerance: 1e-4 relative to the largest entry of each array (ROADMAP's
factor and preconditioning tolerance; f32 sums in another order). The
optimizer steps run at damping 1e-2: the fixture's full BN Fisher (6
samples, 2C up to 32) is singular, and at 1e-3 its eigh inverse carries
f32 rounding of the gradients (1e-7) to 1.3e-4 of a BatchNorm scale's
momentum (``tests/test_torch_convnet_train_parity.py`` measures the same
at the example's damping).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tagging as jtag
from repro.core.fisher import emp_fisher_grads as jemp_fisher_grads
from repro.core.ngd import NGDConfig as JNGDConfig
from repro.core.ngd import SPNGD as JSPNGD
from repro.data.augment import RunningMixup as JRunningMixup
from repro.data.augment import random_erase as jrandom_erase
from repro.data.synthetic import image_batches as jimage_batches
from repro.models.resnet import ConvNet as JConvNet
from repro.models.resnet import ConvNetConfig as JConvNetConfig
from repro.optim import schedules as jsched
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import tagging
from repro_torch.core.fisher import emp_fisher_grads
from repro_torch.core.ngd import NGDConfig, SPNGD
from repro_torch.data.augment import RunningMixup, random_erase
from repro_torch.data.synthetic import image_batches
from repro_torch.models.resnet import ConvNet, ConvNetConfig
from repro_torch.optim import schedules
from test_torch_train_parity import _rel

TOL = 1e-4
SMALL = dict(widths=(8, 16), blocks_per_stage=1)
DAMP, LR, MOM = 1e-2, 0.05, 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _acc(shape):
    """A zero accumulator that takes a gradient (the tagged sites' dummy)."""
    return torch.zeros((), requires_grad=True).expand(shape)


# ---------------------------------------------------------------------------
# the conv site
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,k,stride,want", [
    (32, 3, 2, (0, 1)), (32, 3, 1, (1, 1)), (32, 1, 2, (0, 0)),
    (15, 3, 2, (1, 1)), (16, 1, 1, (0, 0))])
def test_same_pads_follow_xla(size, k, stride, want):
    assert tagging.same_pads(size, k, stride) == want


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_conv_site_matches_repro(size, k, stride):
    """Forward (tagged and plain), dx, dw and the raw A/G sums of one conv
    site under a random cotangent; A blocked at max_dim 16 so k 3 (d_in 27)
    takes a ragged second block."""
    rng = np.random.RandomState(size * 10 + k + stride)
    cin, cout = 3, 5
    x = rng.randn(2, size, size, cin).astype(np.float32)
    w = rng.randn(k, k, cin, cout).astype(np.float32)
    ho = -(-size // stride)
    cot = rng.randn(2, ho, ho, cout).astype(np.float32)
    jspec = jtag.FactorSpec(max_dim=16)
    spec = tagging.FactorSpec(max_dim=16)
    d_in = cin * k * k
    jstats = jtag.make_stats(jspec, d_in, cout)

    def jloss(x, w, s):
        return jnp.sum(jtag.conv_site(x, w, s, stride=stride, spec=jspec)
                       * cot)
    jy = jtag.conv_site(jnp.asarray(x), jnp.asarray(w), jstats,
                        stride=stride, spec=jspec)
    jgx, jgw, jgs = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jstats)

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))
                          ).requires_grad_(True)
    ta = _acc(tuple(jstats["a"].shape))
    tg = _acc(tuple(jstats["g"].shape))
    ty = tagging.conv_site(tx, tw, {"a": ta, "g": tg}, stride=stride,
                           spec=spec)
    gx, gw, ga, gg = torch.autograd.grad(
        (ty * torch.from_numpy(cot)).sum(), [tx, tw, ta, tg])
    assert ty.shape == jy.shape
    assert _rel(ty.detach(), jy) <= TOL
    with torch.no_grad():
        plain = tagging.conv_site(tx, tw, None, stride=stride)
    assert _rel(plain, jtag.conv_site(jnp.asarray(x), jnp.asarray(w), None,
                                      stride=stride)) <= TOL
    assert _rel(gx, jgx) <= TOL
    assert _rel(gw.permute(2, 3, 1, 0), jgw) <= TOL
    assert ga.shape == jgs["a"].shape and _rel(ga, jgs["a"]) <= TOL
    assert gg.shape == jgs["g"].shape and _rel(gg, jgs["g"]) <= TOL


# ---------------------------------------------------------------------------
# the BatchNorm site
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_bn_site_uw_and_uwf_match_repro(full):
    rng = np.random.RandomState(7 + full)
    c = 6
    xhat = rng.randn(3, 5, 4, c).astype(np.float32)
    gamma = rng.randn(c).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    cot = rng.randn(3, 5, 4, c).astype(np.float32)
    jstats = jtag.make_scale_bias_stats(c, full=full)
    key = "uwf" if full else "uw"
    assert set(tagging.make_scale_bias_stats(c, full=full)) == {key}
    assert tuple(tagging.make_scale_bias_stats(c, full=full)[key].shape) == \
        jstats[key].shape

    def jloss(x, g, b, s):
        return jnp.sum(jtag.scale_bias_site(x, g, b, s, spatial=2) * cot)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(xhat), jnp.asarray(gamma), jnp.asarray(beta), jstats)
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (xhat, gamma, beta)]
    acc = _acc(tuple(jstats[key].shape))
    y = tagging.scale_bias_site(*ts, {key: acc}, spatial=2)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                ts + [acc])
    for got, want in zip(grads[:3], jgrads[:3]):
        assert _rel(got, want) <= TOL
    assert grads[3].shape == jgrads[3][key].shape
    assert _rel(grads[3], jgrads[3][key]) <= TOL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _models(bn="unit", **cfg_kw):
    """Both ConvNets on the JAX package's PRNGKey(0) params."""
    kw = dict(SMALL, bn_fisher=bn, **cfg_kw)
    jm = JConvNet(JConvNetConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = ConvNet(ConvNetConfig(**kw), device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jp), tm.cfg, "cpu"))
    return jm, jp, tm


def _batch(soft: bool, b=4, size=12, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, size, size, 3).astype(np.float32)
    y = rng.randint(0, 10, b)
    if soft:
        y = rng.dirichlet(np.ones(10), b).astype(np.float32)
    return ({"images": jnp.asarray(x), "labels": jnp.asarray(y)},
            {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)})


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("bn", ["unit", "full"])
@pytest.mark.parametrize("soft", [False, True])
def test_logits_loss_grads_and_raw_stats_match_repro(bn, soft):
    jm, jp, tm = _models(bn)
    jb, tb = _batch(soft)
    jl, jaux, jg, jraw = jax.jit(lambda p, b: jemp_fisher_grads(
        jm.loss, p, jm.fstats(), b))(jp, jb)
    tl, taux, tg, traw = emp_fisher_grads(tm.loss, tm.params(), tm.fstats(),
                                          tb)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _rel(taux["logits"], jaux["logits"]) <= TOL
    jraw = jax.tree.map(np.asarray, jraw)
    traw = convert.stats_to_jax(traw)
    assert set(traw) == set(jraw)
    for fam, stats in jraw.items():
        assert set(traw[fam]) == set(stats)
        for key, want in stats.items():
            got = traw[fam][key]
            assert got.shape == want.shape, (fam, key)
            assert _rel(got, want) <= TOL, (fam, key, _rel(got, want))
    tgn = convert.params_to_jax(tg)
    for path, want in _leaves(jax.tree.map(np.asarray, jg)):
        assert _rel(_get(tgn, path), want) <= TOL, path


@pytest.mark.parametrize("bn", ["unit", "full"])
@pytest.mark.parametrize("cfg_kw", [{}, dict(widths=(16, 32, 64),
                                             blocks_per_stage=2)])
def test_site_infos_fstats_and_counts_match_repro(bn, cfg_kw):
    kw = dict(SMALL, bn_fisher=bn, **cfg_kw)
    jm = JConvNet(JConvNetConfig(**kw))
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tm = ConvNet(ConvNetConfig(**kw), device="cpu")
    jinfos, tinfos = jm.site_infos(), tm.site_infos()
    assert list(tinfos) == list(jinfos)
    for fam, ji in jinfos.items():
        ti = tinfos[fam]
        assert (ti.kind, ti.param, ti.d_in, ti.d_out, ti.lead, ti.ksize,
                ti.beta_param) == (ji.kind, ji.param, ji.d_in, ji.d_out,
                                   ji.lead, ji.ksize, ji.beta_param), fam
    jt, tt = jm.fstats(), tm.fstats()
    assert {f: {k: v.shape for k, v in s.items()} for f, s in jt.items()} \
        == {f: {k: tuple(v.shape) for k, v in s.items()}
            for f, s in tt.items()}
    for size in (16, 15):
        jb, tb = _batch(False, b=3, size=size)
        assert tm.site_counts(tb) == jm.site_counts(jb)
    # the state dict and the params tree carry every leaf of repro's
    shapes = {".".join(p): v.shape for p, v in _leaves(jp)}
    assert shapes == {k: (v.permute(2, 3, 1, 0) if v.dim() == 4 else v).shape
                      for k, v in tm.state_dict().items()}


def test_registered_config_matches_repro():
    from repro.configs import get_config as jget_config
    cfg, jcfg = get_config("resnet50"), jget_config("resnet50")
    assert isinstance(cfg, ConvNetConfig)
    assert {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(jcfg)} == dataclasses.asdict(jcfg)
    assert get_config("resnet50") == cfg


def test_convert_round_trips_conv_params_and_state():
    jm, jp, tm = _models("full")
    np_p = jax.tree.map(np.asarray, jp)
    back = convert.params_to_jax(tm.params())
    for path, want in _leaves(np_p):
        np.testing.assert_array_equal(_get(back, path), want)
    jopt = JSPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                  JNGDConfig(damping=DAMP))
    js = jax.tree.map(np.asarray, jopt.init(jp))
    js["velocity"] = np_p                    # a non-zero momentum tree
    ts = convert.opt_state_from_jax(js, tm.cfg, "cpu")
    assert tuple(ts["velocity"]["s0b0/w1"].shape) == tuple(
        tm.params()["s0b0"]["w1"].shape)
    again = convert.opt_state_to_jax(ts)
    for path, want in _leaves(js):
        np.testing.assert_array_equal(_get(again, path), want)


@pytest.mark.parametrize("bn,method", [("unit", "eigh"), ("full", "eigh"),
                                       ("unit", "newton_schulz"),
                                       ("full", "newton_schulz")])
def test_capture_and_fast_step_match_repro(bn, method):
    """A capture step with every flag set, then a fast step, from the same
    state: updated params, momentum, X_-1 and the preconditioners (the conv
    factors' inverses, the uw stats or the uwf inverse), with Eq. 24's
    rescaling of the conv and head weights."""
    jm, jp, tm = _models(bn)
    kw = dict(damping=DAMP, weight_rescale=True, inverse_method=method)
    jopt = JSPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                  JNGDConfig(**kw))
    topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                 NGDConfig(**kw))
    js = jopt.init(jp)
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js), tm.cfg,
                                    "cpu")
    assert topt.stat_names() == jopt.stat_names()
    assert topt.stat_bytes() == jopt.stat_bytes()
    jb, tb = _batch(True, b=6, size=10, seed=1)
    jflags = {k: jnp.asarray(True) for k in jopt.stat_names()}
    tflags = {k: True for k in topt.stat_names()}
    jp, js, jm1 = jax.jit(jopt.step)(jp, js, jb, jflags, DAMP, LR, MOM)
    tp, ts, tm1 = topt.step(tm.params(), ts, tb, tflags, DAMP, LR, MOM)
    assert abs(float(tm1["loss"]) - float(jm1["loss"])) <= 1e-5
    _states_match(jp, js, tp, ts, ("prev", "precond"))
    for name, (d1, d2) in tm1["sims"].items():
        np.testing.assert_allclose([d1, d2], np.asarray(jm1["sims"][name]),
                                   rtol=TOL)
    jb, tb = _batch(True, b=6, size=10, seed=2)
    jp, js, jm2 = jax.jit(jopt.step_fast)(jp, js, jb, DAMP, LR, MOM)
    tp, ts, tm2 = topt.step_fast(tp, ts, tb, DAMP, LR, MOM)
    assert abs(float(tm2["loss"]) - float(jm2["loss"])) <= 1e-4
    _states_match(jp, js, tp, ts, ())


def _states_match(jp, js, tp, ts, slots):
    tpj = convert.params_to_jax(tp)
    for path, want in _leaves(jax.tree.map(np.asarray, jp)):
        assert _rel(_get(tpj, path), want) <= TOL, path
    jst = jax.tree.map(np.asarray, js)
    tst = convert.opt_state_to_jax(ts)
    for path, want in _leaves(jst["velocity"]):
        assert _rel(_get(tst["velocity"], path), want) <= TOL, path
    for fam, entry in jst["curv"].items():
        for slot in slots:
            for key, want in entry[slot].items():
                got = tst["curv"][fam][slot][key]
                assert _rel(got, want) <= TOL, (fam, slot, key)


# ---------------------------------------------------------------------------
# data, augmentation and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,seed", [(16, 0), (32, 3)])
def test_image_batches_bit_identical(size, seed):
    jd = jimage_batches(10, 8, size=size, seed=seed)
    td = image_batches(10, 8, size=size, seed=seed)
    for _ in range(3):
        jb, tb = next(jd), next(td)
        assert tb["images"].dtype == torch.float32
        np.testing.assert_array_equal(tb["images"].numpy(),
                                      np.asarray(jb["images"]))
        np.testing.assert_array_equal(tb["labels"].numpy(),
                                      np.asarray(jb["labels"]))


@pytest.mark.parametrize("p,seed", [(0.5, 0), (1.0, 1), (0.0, 2)])
def test_random_erase_bit_identical(p, seed):
    imgs = np.random.RandomState(9).randn(12, 16, 16, 3).astype(np.float32)
    jrng, trng = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):
        want = jrandom_erase(jrng, imgs, p=p)
        got = random_erase(trng, torch.from_numpy(imgs), p=p)
        np.testing.assert_array_equal(got.numpy(), want)
    # both streams consumed the same draws
    assert trng.rand() == jrng.rand()


def test_running_mixup_bit_identical():
    jmix, tmix = JRunningMixup(0.4, 10, seed=0), RunningMixup(0.4, 10, seed=0)
    data = jimage_batches(10, 8, size=8, seed=5)
    for _ in range(4):
        b = next(data)
        jx, jy = jmix(b["images"], b["labels"])
        tx, ty = tmix(torch.from_numpy(np.array(b["images"])),
                      torch.from_numpy(np.array(b["labels"])))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_schedules_match_repro():
    jc, tc = jsched.coupled_momentum(0.9, 0.05), schedules.coupled_momentum(
        0.9, 0.05)
    jw = jsched.warmup_polynomial(0.1, 2.0, 3.0, 40.0, 4.0)
    tw = schedules.warmup_polynomial(0.1, 2.0, 3.0, 40.0, 4.0)
    jp_, tp_ = jsched.polynomial_decay(0.05, 1, 120, 4.0), \
        schedules.polynomial_decay(0.05, 1, 120, 4.0)
    for e in np.linspace(0.0, 45.0, 91):
        assert tw(float(e)) == jw(float(e))
        assert tp_(float(e)) == jp_(float(e))
        assert tc(tp_(float(e))) == jc(jp_(float(e)))
