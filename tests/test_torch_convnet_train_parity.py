"""The paper's training scheme on the ConvNet, ``repro_torch.launch.
train_convnet.run`` against ``examples/train_convnet_paper.py``'s loop in
the JAX package, on the CPU: 20 steps at widths (8, 16), one block per
stage, 16 x 16 images, batch 32, for the unit-wise and the full BatchNorm
Fisher, from ``repro``'s PRNGKey(0) params carried by ``convert``, at
damping 1e-2.

Both loops draw the same batches (``image_batches``), erase and mix them
with the same draws, and take the capture or the fast step as their own
``IntervalController`` says.

* Free run: the refresh flags and the losses of the first 8 steps agree
  (losses within rtol = atol = 1e-3, ROADMAP's pre-chaos prefix, as
  ``tests/test_torch_train_parity.py``), every loss is finite and the
  clean-data accuracy of step 1 is the same. Later flags may differ: a
  distance within 1e-5 of alpha flips once the free runs have drifted
  apart by that much.
* Step by step: each of ``repro``'s 20 steps, taken by the port from
  ``repro``'s state with ``repro``'s batch and flags, gives the same loss,
  params, momentum, history and preconditioners within 1e-4 of each
  array's largest entry, and the same Algorithm-2 distances within 1e-4
  relative or 1e-6 absolute (a distance is a norm ratio: the stem's A moves
  by 2e-4 a step, and f32 sums in another order move that by 1e-7).

Why 1e-2 and not the example's 2.5e-4: at 2.5e-4 this fixture has no
pre-chaos prefix. ``repro``'s own loop with its init perturbed by 1e-7
relative moves the losses of steps 6-8 by up to 1.4e-2; at 1e-2 it stays
within 3e-7 over all 20 steps. And one step from the same state amplifies
f32 rounding through the ill-conditioned inverses: at 2.5e-4 the full BN
Fisher's eigh inverse differs by up to 1.7e-4 of its largest entry and the
momentum by 1.9e-4, at 1e-3 a conv update by 1.2e-3; at 1e-2 the worst
entry is 6.6e-5.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ngd import NGDConfig as JNGDConfig
from repro.core.ngd import SPNGD as JSPNGD
from repro.core.stale import IntervalController as JController
from repro.data.augment import RunningMixup as JRunningMixup
from repro.data.augment import random_erase as jrandom_erase
from repro.data.synthetic import image_batches as jimage_batches
from repro.models.resnet import ConvNet as JConvNet
from repro.models.resnet import ConvNetConfig as JConvNetConfig
from repro.optim.schedules import polynomial_decay as jpolynomial_decay
from repro_torch import convert
from repro_torch.launch import train_convnet
from repro_torch.models.resnet import ConvNetConfig

STEPS, BATCH, SIZE, LR, ALPHA, DAMP = 20, 32, 16, 0.05, 0.4, 1e-2
CFG = dict(widths=(8, 16), blocks_per_stage=1)
PREFIX = 8
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    """A copy on the host (jax.Array leaves -> numpy)."""
    return jax.tree.map(np.array, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(bn: str):
    """The example's loop (examples/train_convnet_paper.py:main) at the
    fixture's config: (initial params, per-step losses, flags, step-1
    accuracy, per-step records of what went into each step and what came
    out), all numpy."""
    model = JConvNet(JConvNetConfig(bn_fisher=bn, **CFG))
    params = model.init(jax.random.PRNGKey(0))
    p0 = _np(params)
    opt = JSPNGD(model.loss, model.site_infos(), model.fstats,
                 model.site_counts,
                 JNGDConfig(damping=DAMP, weight_rescale=True))
    state = opt.init(params)
    ctrl = JController(opt.stat_names(), alpha=0.1,
                       bytes_per_stat=opt.stat_bytes())
    data = jimage_batches(10, BATCH, size=SIZE, seed=0)
    mixup = JRunningMixup(ALPHA, 10, seed=0)
    rng = np.random.RandomState(0)
    lr_fn = jpolynomial_decay(LR, 1, STEPS, 4.0)
    step_j, fast_j = jax.jit(opt.step), jax.jit(opt.step_fast)
    losses, flag_log, acc1, steps = [], [], None, []
    for t in range(1, STEPS + 1):
        raw = next(data)
        imgs = jnp.asarray(jrandom_erase(rng, np.asarray(raw["images"])))
        x, y = mixup(imgs, raw["labels"])
        batch = {"images": x, "labels": y}
        lr = lr_fn(t - 1)
        mom = 0.9 * lr / LR
        flags = ctrl.flags(t)
        rec = {"params": _np(params), "state": _np(state),
               "batch": _np(batch), "flags": dict(flags), "lr": lr,
               "mom": mom}
        if any(flags.values()):
            jflags = {k: jnp.asarray(v) for k, v in flags.items()}
            params, state, m = step_j(params, state, batch, jflags, DAMP, lr,
                                      mom)
            sims = {k: (float(v[0]), float(v[1]))
                    for k, v in m["sims"].items()}
            ctrl.update(t, flags, sims)
        else:
            params, state, m = fast_j(params, state, batch, DAMP, lr, mom)
            sims = {}
            ctrl.update(t, flags, {})
        rec.update(out_params=_np(params), out_state=_np(state),
                   loss=float(m["loss"]), sims=sims)
        steps.append(rec)
        losses.append(float(m["loss"]))
        flag_log.append(sorted(k for k, v in flags.items() if v))
        if t % 20 == 0 or t == 1:
            probe = next(data)
            logits = model.forward(params, probe["images"])
            acc = float((jnp.argmax(logits, -1) == probe["labels"]).mean())
            acc1 = acc if t == 1 else acc1
    return p0, losses, flag_log, acc1, steps


def _port(bn: str, p0):
    cfg = ConvNetConfig(bn_fisher=bn, **CFG)
    model, opt, _, _ = train_convnet.build(cfg=cfg, damping=DAMP,
                                           device="cpu")
    model.load_state_dict(convert.params_from_jax(p0, cfg, "cpu"))
    return model, opt


@pytest.mark.parametrize("bn", ["unit", "full"])
def test_paper_scheme_matches_repro(bn):
    p0, jlosses, jflags, jacc1, _ = _jax_run(bn)
    model, opt = _port(bn, p0)
    params = model.params()
    _, _, recs = train_convnet.run(
        model, opt, params, opt.init(params), steps=STEPS, batch=BATCH,
        image_size=SIZE, lr=LR, damping=DAMP, alpha_mixup=ALPHA,
        log=lambda m: None)
    assert [r["t"] for r in recs] == list(range(1, STEPS + 1))
    assert [r["refreshed"] for r in recs[:PREFIX]] == jflags[:PREFIX]
    losses = [r["loss"] for r in recs]
    assert all(math.isfinite(x) for x in losses)
    np.testing.assert_allclose(losses[:PREFIX], jlosses[:PREFIX], rtol=1e-3,
                               atol=1e-3)
    assert recs[0]["acc"] == jacc1
    assert 0.0 <= recs[-1]["acc"] <= 1.0


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
def test_paper_scheme_step_by_step_matches_repro(bn):
    p0, _, _, _, steps = _jax_run(bn)
    model, opt = _port(bn, p0)
    cfg = model.cfg
    for t, rec in enumerate(steps, 1):
        model.load_state_dict(convert.params_from_jax(rec["params"], cfg,
                                                      "cpu"))
        state = convert.opt_state_from_jax(rec["state"], cfg, "cpu")
        batch = {k: torch.from_numpy(v) for k, v in rec["batch"].items()}
        flags = {k: bool(v) for k, v in rec["flags"].items()}
        args = (DAMP, rec["lr"], rec["mom"])
        if any(flags.values()):
            params, state, m = opt.step(model.params(), state, batch, flags,
                                        *args)
            for name, (d1, d2) in m["sims"].items():
                np.testing.assert_allclose([d1, d2], rec["sims"][name],
                                           rtol=TOL, atol=1e-6,
                                           err_msg=f"{t} {name}")
        else:
            params, state, m = opt.step_fast(model.params(), state, batch,
                                             *args)
        assert abs(float(m["loss"]) - rec["loss"]) <= 1e-5 * rec["loss"], t
        got = {"params": convert.params_to_jax(params),
               **convert.opt_state_to_jax(state)}
        want = {"params": rec["out_params"], **rec["out_state"]}
        for path, w in _leaves({k: want[k] for k in ("params", "velocity",
                                                     "curv")}):
            g = _get(got, path)
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= TOL, (t, path, err)


def test_cli_runs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train_convnet --device cpu`` on the
    registered config with the full BN Fisher; an LM config is refused."""
    _, state, recs = train_convnet.main(
        ["--device", "cpu", "--arch", "resnet50", "--steps", "2", "--batch",
         "4", "--image-size", "8", "--bn-fisher", "full"])
    assert [r["kind"] for r in recs] == ["capture", "capture"]
    assert all(math.isfinite(r["loss"]) for r in recs) and "acc" in recs[0]
    assert "uwf" in state["curv"]["stem_bn"]["precond"]
    assert "final acc" in capsys.readouterr().out
    with pytest.raises(ValueError, match="ConvNet"):
        train_convnet.build("llama3_2_1b", device="cpu")
