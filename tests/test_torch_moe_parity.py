"""The MoE family of repro_torch against the JAX package, on the CPU:
``models/moe.py`` (router, capacity dispatch, the block), the grouped
expert site's per-expert factors, and reduced ``mixtral_8x22b`` (8 -> 4
experts, top-2, sliding window 16) and ``qwen2_moe_a2_7b`` (60 -> 4
experts, top-4 -> 2, one shared expert), trained and served.

Inputs come from numpy with a seed; the models start from the same JAX
``PRNGKey(0)`` params drawn under ``jax.threefry_partitionable(False)``,
moved over through numpy. The fixture and tolerances are the dense
family's (``tests/test_torch_dense_configs_parity.py``): batch (4, 16),
``NGDConfig(damping=1e-3)``, every refresh flag set, lr 5e-3, momentum
0.9; logits, one capture step's params and state within 1e-4 of the
largest entry, eight losses within rtol = atol = 1e-4. Routing is
discrete, so it is compared exactly: every router call's top-k indices
(recorded in both packages as the models route, ``_recorded_routes``) are
equal at every step. At batch (4, 16) each expert's capacity is 40 of 64
tokens x 2, so some assignments drop; at decode the capacity is 1 (3 lanes
x 2 over 4 experts), and most drop, in both packages lane for lane. The
kernel partitions' leading axis (``kernels/kfac.py syrk_geometry``,
``precond_geometry``, ``precond_item``) is checked here too: the CUDA
kernels run on the card only (``chip_smoke.py check_moe_kernels``).
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jget_config
from repro.core import tagging as jtagging
from repro.core.ngd import NGDConfig as JNGDConfig
from repro.core.ngd import SPNGD as JSPNGD
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import moe as jmoe
from repro.models.transformer import DecoderLM as JDecoderLM
from repro.serve import ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core import kfac, tagging
from repro_torch.core.ngd import NGDConfig, SPNGD
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import kfac as kern
from repro_torch.launch.train import make_train_step
from repro_torch.models import moe
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve import ServeConfig
import jax_one_cpu
from test_torch_train_parity import _get, _leaves, _rel

ARCHS = ["mixtral_8x22b", "qwen2_moe_a2_7b"]
DAMP, LR, MOM = 1e-3, 5e-3, 0.9
BATCH = (4, 16)
STEPS = 8
REL = 1e-4
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# repro's training runs, each in a process of its own on one CPU
# (jax_one_cpu), all started with the module, as the tests that read them
# run later: {key: (fn, args)}
JAX_RUNS = {"mixtral_8x22b": ("jax_runs", ("mixtral_8x22b",)),
            "qwen2_moe_a2_7b": ("jax_runs", ("qwen2_moe_a2_7b",)),
            "rescale": ("jax_step", ("qwen2_moe_a2_7b",
                                     {"weight_rescale": True}))}
_children: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _jax_children():
    for key, (fn, args) in JAX_RUNS.items():
        _children[key] = jax_one_cpu.start(__name__, fn, *args)
    yield
    for child in _children.values():
        child.close()


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------

def _moe_inputs(t=24, d=16, f=8, e=4, shared=1, seed=0):
    """x (T, d) and a moe param dict (numpy f32), HeNormal-like scales."""
    rng = np.random.RandomState(seed)
    p = {"router": rng.randn(d, e) / d ** 0.5,
         "we_up": rng.randn(e, d, f) / d ** 0.5,
         "we_gate": rng.randn(e, d, f) / d ** 0.5,
         "we_down": rng.randn(e, f, d) / f ** 0.5}
    if shared:
        p.update(sh_up=rng.randn(d, shared * f) / d ** 0.5,
                 sh_gate=rng.randn(d, shared * f) / d ** 0.5,
                 sh_down=rng.randn(shared * f, d) / f ** 0.5)
    return (rng.randn(t, d).astype(np.float32),
            {k: v.astype(np.float32) for k, v in p.items()})


@pytest.mark.parametrize("ties", [False, True])
def test_router_probs_and_grads_match_repro(ties):
    """Top-k probabilities, indices and the Switch loss, and the grads of
    a scalar of them; with ``ties`` two router columns are equal, so every
    token meets a tie, which both packages break to the lower index."""
    x, p = _moe_inputs(e=6)
    w = p["router"]
    if ties:
        w[:, 4] = w[:, 1]
    k, e = 3, w.shape[1]
    c = np.random.RandomState(1).randn(x.shape[0], k).astype(np.float32)
    spec = jtagging.FactorSpec(max_dim=64)

    def jloss(x, w):
        tp, _, aux = jmoe.router_probs(x, w, None, e, k, spec)
        return jnp.sum(tp * c) + aux
    jtp, jidx, jaux = jmoe.router_probs(jnp.asarray(x), jnp.asarray(w), None,
                                        e, k, spec)
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ttp, tidx, taux = moe.router_probs(tx, tw, None, e, k,
                                       tagging.FactorSpec(max_dim=64))
    (torch.sum(ttp * torch.from_numpy(c)) + taux).backward()
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if ties:       # column 1 comes before its twin 4 wherever both are in
        rows = [r for r in tidx.tolist() if 1 in r and 4 in r]
        assert rows and all(r.index(1) < r.index(4) for r in rows)
    assert _rel(ttp.detach(), jtp) <= REL
    assert abs(float(taux.detach()) - float(jaux)) <= REL * abs(float(jaux))
    assert _rel(tx.grad, jgx) <= REL and _rel(tw.grad, jgw) <= REL


@pytest.mark.parametrize("capacity", [48, 5])
def test_dispatch_combine_matches_repro(capacity):
    """Slots in the flattened (token, k) order, the combine weighted by the
    probabilities; at capacity 5 of 24 tokens x 2 most assignments drop.
    Outputs and the grads into the tokens and the probabilities."""
    x, p = _moe_inputs()
    rng = np.random.RandomState(2)
    t, e, k = x.shape[0], 4, 2
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    probs = rng.rand(t, k).astype(np.float32)
    wj = jnp.asarray(p["we_up"])
    wt = torch.from_numpy(p["we_up"])

    def jout(x, pr):
        return jmoe.dispatch_combine(x, pr, jnp.asarray(idx), e, capacity,
                                     lambda b: jnp.tanh(jnp.einsum(
                                         "end,edf->enf", b, wj)))
    jy = jout(jnp.asarray(x), jnp.asarray(probs))
    jgx, jgp = jax.grad(lambda a, b: jnp.sum(jout(a, b) ** 2),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(probs))
    tx = torch.tensor(x, requires_grad=True)
    tp = torch.tensor(probs, requires_grad=True)
    ty = moe.dispatch_combine(tx, tp, torch.from_numpy(idx), e, capacity,
                              lambda b: torch.tanh(torch.matmul(b, wt)))
    torch.sum(ty ** 2).backward()
    assert _rel(ty.detach(), jy) <= REL
    assert _rel(tx.grad, jgx) <= REL and _rel(tp.grad, jgp) <= REL
    kept = (np.asarray(jy) != 0).any(-1).sum()
    assert (kept < t) == (capacity < t * k / e)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_block_and_factors_match_repro(shared, capacity_factor):
    """moe_block with every site tagged: output, aux, the grads of every
    param and of x, and the raw factor sums of every site (the experts'
    (E, 1, b, b)), at the reduced configs' capacity factor and at one that
    drops most assignments."""
    x, p = _moe_inputs(shared=shared, seed=3)
    x3 = x.reshape(2, 12, -1)
    kw = dict(n_experts=4, top_k=2, capacity_factor=capacity_factor)
    jspec = jtagging.FactorSpec(max_dim=64, backend="ref")
    tspec = tagging.FactorSpec(max_dim=64, backend="ref")
    shapes = {"router": (16, 4, ()), "we_up": (16, 8, (4,)),
              "we_gate": (16, 8, (4,)), "we_down": (8, 16, (4,))}
    if shared:
        shapes.update(sh_up=(16, 8, ()), sh_gate=(16, 8, ()),
                      sh_down=(8, 16, ()))
    jfs = {n: jtagging.make_stats(jspec, a, b, lead=lead)
           for n, (a, b, lead) in shapes.items()}

    def jloss(x, p, fs):
        y, aux = jmoe.moe_block(x, p, fs, spec=jspec, **kw)
        return jnp.sum(jnp.sin(y)) + aux
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(x3), {k: jnp.asarray(v) for k, v in p.items()}, jfs)
    jy, jaux = jmoe.moe_block(jnp.asarray(x3),
                              {k: jnp.asarray(v) for k, v in p.items()},
                              None, spec=jspec, **kw)
    tx = torch.tensor(x3, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    zero = torch.zeros((), requires_grad=True)
    tfs = {n: {k: zero.expand(v.shape) for k, v in
               tagging.make_stats(tspec, a, b, lead=lead).items()}
           for n, (a, b, lead) in shapes.items()}
    ty, taux = moe.moe_block(tx, tp, tfs, spec=tspec, **kw)
    leaves = [tx] + list(tp.values())
    accs = [tfs[n][k] for n in tfs for k in ("a", "g")]
    grads = torch.autograd.grad(torch.sum(torch.sin(ty)) + taux,
                                leaves + accs)
    assert _rel(ty.detach(), jy) <= REL
    assert abs(float(taux.detach()) - float(jaux)) <= REL * abs(float(jaux))
    assert _rel(grads[0], jg[0]) <= REL
    for name, g in zip(tp, grads[1:len(leaves)]):
        assert _rel(g, jg[1][name]) <= REL, name
    for (n, k), g in zip([(n, k) for n in tfs for k in ("a", "g")],
                         grads[len(leaves):]):
        assert g.shape == jg[2][n][k].shape, (n, k)
        assert _rel(g, jg[2][n][k]) <= REL, (n, k)


def test_grouped_dense_site_per_expert_factors():
    """``tests/test_tagging.py``'s grouped-site check on the port, and the
    same factor sums as repro's: A[e] = x[e]^T x[e], G[e] = gy[e]^T gy[e]
    (two blocks of 4 on the G side), the grads those of the plain product."""
    rng = np.random.RandomState(5)
    e, n, d, f = 3, 8, 4, 8
    x = rng.randn(e, n, d).astype(np.float32)
    w = rng.randn(e, d, f).astype(np.float32)
    jspec = jtagging.FactorSpec(max_dim=4)
    jstats = jtagging.make_stats(jspec, d, f, lead=(e,))

    def jloss(w, s):
        return jnp.sum(jtagging.grouped_dense_site(jnp.asarray(x), w, s,
                                                   jspec) ** 2)
    jgw, jgs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jstats)
    spec = tagging.FactorSpec(max_dim=4)
    stats = tagging.make_stats(spec, d, f, lead=(e,))
    zero = torch.zeros((), requires_grad=True)
    accs = {k: zero.expand(v.shape) for k, v in stats.items()}
    tw = torch.tensor(w, requires_grad=True)
    y = tagging.grouped_dense_site(torch.from_numpy(x), tw, accs, spec)
    gw, ga, gg = torch.autograd.grad(torch.sum(y ** 2),
                                     [tw, accs["a"], accs["g"]])
    assert ga.shape == (e, 1, d, d) and gg.shape == (e, 2, 4, 4)
    gy = 2 * np.einsum("end,edf->enf", x, w)
    for i in range(e):
        np.testing.assert_allclose(ga[i, 0], x[i].T @ x[i], rtol=1e-4)
        full = gy[i].T @ gy[i]
        np.testing.assert_allclose(gg[i, 1], full[4:, 4:], rtol=1e-4)
    assert _rel(ga, jgs["a"]) <= REL and _rel(gg, jgs["g"]) <= REL
    assert _rel(gw, jgw) <= REL
    plain = torch.tensor(w, requires_grad=True)
    torch.sum(tagging.grouped_dense_site(torch.from_numpy(x), plain) ** 2
              ).backward()
    assert _rel(gw, plain.grad) <= 1e-6


# ---------------------------------------------------------------------------
# reduced mixtral_8x22b and qwen2_moe_a2_7b
# ---------------------------------------------------------------------------

def _jax_side(arch, damping=DAMP, **ngd_kw):
    """repro's model, optimizer, params, state, batch and flags."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), backend="ref")
    jm = JDecoderLM(jcfg)
    with jax.threefry_partitionable(False):
        jp = jm.init(jax.random.PRNGKey(0))
    jopt = JSPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                  JNGDConfig(damping=damping, backend="ref", **ngd_kw))
    js = jopt.init(jp)
    jb = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab).items()}
    jflags = {k: jnp.asarray(True) for k in jopt.stat_names()}
    return jm, jopt, jp, js, jb, jflags


def _torch_side(arch, jp, js, damping=DAMP, **ngd_kw):
    """The port's model, optimizer, state, batch and flags, from repro's
    params and state."""
    cfg = get_config(arch).reduced()
    tm = DecoderLM(cfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jp), cfg, "cpu"))
    topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                 NGDConfig(damping=damping, **ngd_kw))
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js), cfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    return tm, topt, ts, tb, {k: True for k in topt.stat_names()}


def _batch(vocab):
    rng = np.random.RandomState(7)
    return {"tokens": rng.randint(0, vocab, BATCH).astype(np.int32),
            "labels": rng.randint(0, vocab, BATCH).astype(np.int32)}


def _setup(arch, damping=DAMP, **ngd_kw):
    """Both packages on the same params, optimizer state and batch:
    ((jm, jopt, jp, js, jb, jflags), (tm, topt, ts, tb, tflags))."""
    j = _jax_side(arch, damping, **ngd_kw)
    return j, _torch_side(arch, j[2], j[3], damping, **ngd_kw)


_shared = functools.lru_cache(maxsize=None)(_setup)


@contextlib.contextmanager
def _recorded_routes():
    """Every router call's top-k indices, as each package routes: repro's
    through an ordered ``jax.debug.callback`` (inside its jitted step and
    layer scan), the port's as they are computed. Yields {"jax": [...],
    "torch": [...]}."""
    rec = {"jax": [], "torch": []}
    jorig, torig = jmoe.router_probs, moe.router_probs

    def jwrap(*a, **k):
        out = jorig(*a, **k)
        jax.debug.callback(lambda i: rec["jax"].append(np.asarray(i)),
                           out[1], ordered=True)
        return out

    def twrap(*a, **k):
        out = torig(*a, **k)
        rec["torch"].append(out[1].detach().numpy().copy())
        return out
    jmoe.router_probs, moe.router_probs = jwrap, twrap
    try:
        yield rec
    finally:
        jmoe.router_probs, moe.router_probs = jorig, torig


def jax_runs(arch):
    """repro's STEPS capture steps (run in a process of its own on one CPU,
    ``jax_one_cpu``): the losses, the params and state after step 1 (numpy),
    the routing indices of every step, and its step 1 from its params
    moved by one f32 ulp (each element times 1 +- 2^-23, signs from a
    seed), the reference's own sensitivity to f32 rounding."""
    jm, jopt, jp, js, jb, jflags = _jax_side(arch)
    rng = np.random.RandomState(3)
    jp_ulp = jax.tree.map(lambda a: a * (1 + 2.0 ** -23 * jnp.asarray(
        rng.choice([-1.0, 1.0], a.shape), a.dtype)), jp)
    with _recorded_routes() as rec:
        jstep = jax.jit(jmake_train_step(jm, jopt))
        jp1, js1, _ = jstep(jp_ulp, js, jb, jflags, DAMP, LR, MOM)
        jax.effects_barrier()
        rec["jax"].clear()
        jmoved = (jax.tree.map(np.array, jp1), jax.tree.map(np.array, js1))
        jlosses, jfirst = [], None
        for _ in range(STEPS):
            jp, js, m = jstep(jp, js, jb, jflags, DAMP, LR, MOM)
            jlosses.append(float(m["loss"]))
            if jfirst is None:
                jfirst = (jax.tree.map(np.array, jp),
                          jax.tree.map(np.array, js))
        jax.effects_barrier()
    return jlosses, jfirst, rec["jax"], jmoved


@functools.lru_cache(maxsize=None)
def _runs(arch):
    """``jax_runs`` (begun with the module) and the port's STEPS capture
    steps from the same start: ((jlosses, jfirst, jroutes), (tlosses,
    tfirst, troutes), jmoved)."""
    _, _, jp, js, _, _ = _shared(arch)[0]
    tm, topt, ts, tb, tflags = _torch_side(arch, jp, js)
    with _recorded_routes() as rec:
        step = make_train_step(tm, topt)
        params, tlosses, tfirst = tm.params(), [], None
        for _ in range(STEPS):
            params, ts, m = step(params, ts, tb, tflags, DAMP, LR, MOM)
            tlosses.append(float(m["loss"]))
            if tfirst is None:
                tfirst = (
                    jax.tree.map(np.array, convert.params_to_jax(params)),
                    jax.tree.map(np.array, convert.opt_state_to_jax(ts)))
    jlosses, jfirst, jroutes, jmoved = _children[arch].result()
    return ((jlosses, jfirst, jroutes), (tlosses, tfirst, rec["torch"]),
            jmoved)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_repro(arch):
    """Every field the port's ArchConfig has equals repro's, full and
    reduced (4 experts at most, 1 shared, top-2); the alias
    ``qwen2-moe-a2.7b``."""
    for j, t in ((jget_config(arch), get_config(arch)),
                 (jget_config(arch).reduced(), get_config(arch).reduced())):
        assert isinstance(t, ArchConfig) and t.block_type == "moe"
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
    r = get_config(arch).reduced()
    assert (r.n_experts, r.top_k, r.dtype) == (4, 2, torch.float32)
    assert get_config("qwen2-moe-a2.7b") == get_config("qwen2_moe_a2_7b")
    with pytest.raises(AssertionError):
        dataclasses.replace(r, top_k=0).validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_stat_names_templates_and_site_counts_match_repro(arch):
    """Statistic names, site order, factor templates ((L, E, nb, b, b) for
    the experts), payload bytes, and every site's counts (the grouped ones
    count all tokens, as repro's)."""
    (jm, jopt, *_, jb, _), (tm, topt, *_, tb, _) = _shared(arch)
    assert topt.stat_names() == jopt.stat_names()
    assert list(tm.site_infos()) == list(jm.site_infos())
    assert tm.site_infos()["blk/moe_we_up"].kind == "grouped"
    jt, tt = jax.eval_shape(jm.fstats), tm.fstats()
    assert set(jt) == set(tt)
    for fam in jt:
        for key in jt[fam]:
            assert tuple(tt[fam][key].shape) == jt[fam][key].shape, (fam, key)
    cfg = tm.cfg
    nb, b = kfac.num_blocks(cfg.d_model, 128), kfac.block_size(cfg.d_model,
                                                                128)
    assert tuple(tt["blk/moe_we_down"]["g"].shape) == (
        cfg.n_layers, cfg.n_experts, nb, b, b)
    assert topt.stat_bytes() == jopt.stat_bytes()
    want, got = jm.site_counts(jb), tm.site_counts(tb)
    assert list(got) == list(want)
    for fam, (na, ng) in want.items():
        assert got[fam] == (int(na), float(ng)), fam


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_loss_match_repro(arch):
    (jm, _, jp, _, jb, _), (tm, _, _, tb, _) = _shared(arch)
    jlogits, jaux = jax.jit(jm.forward)(jp, jb)
    with torch.no_grad():
        tlogits, taux = tm.forward(tb)
        tloss, tparts = tm.loss(tm.params(), None, tb)
    assert _rel(tlogits.numpy(), jlogits) <= REL
    assert abs(float(taux["aux_loss"]) - float(jaux["aux_loss"])) <= \
        REL * abs(float(jaux["aux_loss"]))
    jloss, _ = jax.jit(jm.loss)(jp, None, jb)
    assert abs(float(tloss) - float(jloss)) <= REL * abs(float(jloss))
    assert float(tparts["aux_loss"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_params_and_state_match_repro(arch):
    """One capture step, every statistic refreshed: updated params,
    momentum, X_-1 history and preconditioners within 1e-4 of repro's, or,
    where repro's own step moves further when its params move by one f32
    ulp, within twice that move. One leaf takes the second bound: mixtral's
    ``embed/table`` momentum, 1.1e-4 from repro's, which repro's own
    ulp-moved step moves by 1.3e-4 (the embedding's G factor is rank
    deficient at 64 tokens over 256 columns and its damped inverse
    amplifies f32 rounding; PR 27 met the same at nemotron's
    embedding)."""
    (_, (jp, js), _), (_, (tp, ts), _), (mp, ms) = _runs(arch)

    def bound(moved, want):
        return max(REL, 2 * _rel(moved, want))
    for path, want in _leaves(jp):
        assert _rel(_get(tp, path), want) <= bound(_get(mp, path), want), \
            path
    for path, want in _leaves(js["velocity"]):
        got, moved = _get(ts["velocity"], path), _get(ms["velocity"], path)
        assert _rel(got, want) <= bound(moved, want), path
    for fam, entry in js["curv"].items():
        for slot in ("prev", "precond"):
            for key, want in entry[slot].items():
                got = ts["curv"][fam][slot][key]
                moved = ms["curv"][fam][slot][key]
                assert _rel(got, want) <= bound(moved, want), \
                    (fam, slot, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_eight_step_losses_and_routing_match_repro(arch):
    """Eight losses within 1e-4, and the routing indices of every router
    call (each layer of each step) equal."""
    (jlosses, _, jroutes), (tlosses, _, troutes), _ = _runs(arch)
    assert np.isfinite(tlosses).all()
    np.testing.assert_allclose(tlosses, jlosses, rtol=REL, atol=REL)
    n_layers = get_config(arch).reduced().n_layers
    assert len(troutes) == len(jroutes) == STEPS * n_layers
    for i, (t, j) in enumerate(zip(troutes, jroutes)):
        np.testing.assert_array_equal(t, j, err_msg=f"step {i // n_layers}, "
                                                    f"layer {i % n_layers}")


def jax_step(arch, ngd_kw):
    """repro's params after one capture step (numpy), every statistic
    refreshed (run in a process of its own on one CPU)."""
    jm, jopt, jp, js, jb, jflags = _jax_side(arch, **ngd_kw)
    jp1, _, _ = jax.jit(jmake_train_step(jm, jopt))(jp, js, jb, jflags,
                                                    DAMP, LR, MOM)
    return jax.tree.map(np.asarray, jp1)


def test_weight_rescale_one_norm_per_expert_matches_repro():
    """Eq. 24 with the expert stacks: one capture step of reduced
    qwen2_moe_a2_7b under weight_rescale, every param within 1e-4 and each
    expert's weight at norm sqrt(2 d_out)."""
    _, _, jp, js, _, _ = _shared("qwen2_moe_a2_7b")[0]  # init ignores it
    tm, topt, ts, tb, tflags = _torch_side("qwen2_moe_a2_7b", jp, js,
                                           weight_rescale=True)
    tp1, _, _ = make_train_step(tm, topt)(tm.params(), ts, tb, tflags, DAMP,
                                          LR, MOM)
    got = convert.params_to_jax(tp1)
    for path, want in _leaves(_children["rescale"].result()):
        assert _rel(_get(got, path), want) <= REL, path
    w = tp1["blocks"][0]["moe"]["we_down"]
    norms = torch.sqrt((w.double() ** 2).sum((-2, -1)))
    np.testing.assert_allclose(norms.numpy(), (2.0 * w.shape[-1]) ** 0.5,
                               rtol=1e-5)


def _serve(arch):
    """mixtral on its ring (window 16 < the 24 positions), qwen2_moe on the
    dense cache, f32 payloads: the serve configs of both packages. (On the
    fp8 ring one e4m3 code of the 6,144 of mixtral's layer-1 K after
    prefill differs, -56 against -52: its row's scale differs from repro's
    by 6.1e-7 relative, f32 rounding of the layer's input, and the logits
    by up to 4.1e-3 until the slot is overwritten. The fp8 ring's own
    parity is tests/test_torch_serve_parity.py's; the card holds mixtral's
    fp8 ring to the plain version, chip_smoke.py check_moe_routes.)"""
    kw = (dict(kv_cache="ring", kv_dtype="f32") if arch == "mixtral_8x22b"
          else dict(kv_cache="dense", kv_dtype="f32"))
    return JServeConfig(backend="ref", **kw), ServeConfig(**kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_prefill_and_decode_logits_match_repro(arch):
    """3 lanes: prefill of 18 tokens, then 6 teacher-forced decode steps
    (capacity 1 at decode: most assignments drop, lane for lane the same
    in both packages); every logit within 1e-4 of repro's."""
    (jm, _, jp, *_), (tm, *_) = _shared(arch)
    jserve, tserve = _serve(arch)
    toks = np.random.RandomState(11).randint(0, tm.cfg.vocab, (3, 24)
                                             ).astype(np.int32)
    s = 18
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                        max_len=24, serve=jserve)
    jstep = jax.jit(functools.partial(jm.decode_step, serve=jserve))
    jouts = [np.asarray(jl)]
    for i in range(s, 24):
        lg, jc = jstep(jp, jc, jnp.asarray(toks[:, i]))
        jouts.append(np.asarray(lg)[:, None])
    t = torch.from_numpy(toks)
    with torch.no_grad():
        tl, tc = tm.prefill({"tokens": t[:, :s]}, max_len=24, serve=tserve)
        touts = [tl.numpy()]
        for i in range(s, 24):
            lg, tc = tm.decode_step(tc, t[:, i], serve=tserve)
            touts.append(lg.numpy()[:, None])
    if arch == "mixtral_8x22b":
        assert tc["k"].shape[2] == 16           # the ring: the window
    np.testing.assert_allclose(np.concatenate(touts, 1),
                               np.concatenate(jouts, 1), atol=REL, rtol=REL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_repro_checkpoint_restores_in_the_port(tmp_path, arch):
    """repro's checkpoint after one step (its (L, E, ...) expert leaves,
    velocity and factor families) restores in the port bit for bit, and
    the port writes the same files back."""
    _, (tm, *_) = _shared(arch)
    (_, (jp, js), _), _, _ = _runs(arch)
    jsave(str(tmp_path), 1, jp, js, None)

    def files(path):
        out = {}
        for kind in ("params", "opt"):
            with np.load(f"{path}.{kind}.npz") as z:
                out[kind] = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                             for k in z.files}
        return out
    want = files(str(tmp_path / "ckpt_00000001"))
    assert "blocks|moe|we_up" in want["params"]
    assert "curv|blk/moe_we_up|precond|a" in want["opt"]
    r = restore_checkpoint(str(tmp_path), cfg=tm.cfg, device="cpu")
    assert tuple(r["params"]["blocks.1.moe.we_down"].shape) == (
        tm.cfg.n_experts, tm.cfg.d_ff, tm.cfg.d_model)
    layout = {"params": convert.params_layout(_state_tree(tm, r["params"])),
              "opt": convert.opt_state_layout(r["opt_state"])}
    for kind in ("params", "opt"):
        got = {k: (v.dtype.str, v.shape, v.tobytes())
               for k, v in _flatten(layout[kind]).items()}
        assert got == want[kind], kind
    save_checkpoint(str(tmp_path / "port"), 1, _state_tree(tm, r["params"]),
                    r["opt_state"])
    assert files(str(tmp_path / "port" / "ckpt_00000001")) == want


def _state_tree(tm, state_dict):
    """A params() tree of ``tm``'s structure holding ``state_dict``'s
    tensors."""
    m = DecoderLM(tm.cfg, device="cpu")
    m.load_state_dict(state_dict)
    return m.params()


def test_cli_trains_reduced_mixtral_and_refuses_the_fp8_capture(capsys):
    """``python -m repro_torch.launch.train --device cpu --arch
    mixtral_8x22b`` trains the reduced config on the plain versions; with
    ``--factor-wire`` the fused fp8 capture of the expert sites, which the
    trainer refused until the wire epilogue took the expert axis, trains
    too (``tests/test_torch_moe_wire_parity.py`` holds it against
    repro)."""
    from repro_torch.launch import train
    params, state, recs = train.main(["--device", "cpu", "--arch",
                                      "mixtral_8x22b", "--steps", "3",
                                      "--batch", "2", "--seq", "16"])
    assert len(recs) == 3 and np.isfinite([r["loss"] for r in recs]).all()
    assert params["blocks"][0]["moe"]["we_up"].shape == (4, 256, 256)
    assert state["step"] == 3
    _, _, recs = train.main(["--device", "cpu", "--arch", "qwen2_moe_a2_7b",
                             "--factor-wire", "e4m3", "--steps", "1",
                             "--batch", "2", "--seq", "16"])
    assert "capture e4m3" in capsys.readouterr().out
    assert np.isfinite(recs[0]["loss"])
    m = DecoderLM(dataclasses.replace(get_config("mixtral_8x22b").reduced(),
                                      factor_wire="e4m3"), device="cpu")
    assert set(m.fstats()["blk/moe_we_up"]["a"]) == {"payload", "scale"}


# ---------------------------------------------------------------------------
# the kernels' leading axis: the partitions the CUDA kernels take
# ---------------------------------------------------------------------------

def _tile_pair(bx, tiles):
    """The kernel's upper-triangle tile pair of pair index bx."""
    ti = 0
    while bx >= tiles - ti:
        bx -= tiles - ti
        ti += 1
    return ti, ti + bx


@pytest.mark.parametrize("lead,n,d,max_dim", [
    (60, 341, 2048, 2048),     # qwen2_moe's up/gate A at 4,096 tokens
    (60, 341, 1408, 2048),     # its up/gate G, down A
    (8, 1280, 6144, 4096),     # mixtral's A, 2 blocks of 3072
    (3, 333, 2050, 1024),      # ragged: 3 blocks of 684
    (4, 20, 300, 128),         # few tokens: the stream-K (shared) route
    (1, 4096, 2048, 2048),     # lead 1: the dense sites
])
def test_syrk_geometry_covers_every_expert_block_tile_once(lead, n, d,
                                                           max_dim):
    """factor_syrk's bf16 work over a lead: block w of the grid takes
    [w * per, (w + 1) * per) of the (tile, slice) list, tile q of matrix
    q // pairs // nb and block q // pairs % nb (the kernel's decode); every
    (expert, block, tile pair, slice) exactly once. The f32 body's grid
    spans lead x nb blocks."""
    nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
    tiles, slices, ctas, per = kern.syrk_geometry(n, b, nb, SMS, lead)
    pairs = tiles * (tiles + 1) // 2
    total = lead * nb * pairs * slices
    assert (ctas - 1) * per < total <= ctas * per
    seen = np.zeros((lead, nb, pairs, slices), np.int32)
    for w in range(ctas):
        for g in range(w * per, min(total, (w + 1) * per)):
            q, s = divmod(g, slices)
            blk, pair = divmod(q, pairs)
            e, k = divmod(blk, nb)
            ti, tj = _tile_pair(pair, tiles)
            assert ti <= tj < tiles
            seen[e, k, pair, s] += 1
    assert (seen == 1).all()
    assert kern.syrk_geometry(n, b, lead * nb, SMS) == (tiles, slices,
                                                        ctas, per)
    asked, rows, chunks = kern.syrk_f32_split(n, b, nb, SMS, lead)
    assert 1 <= chunks <= asked and lead * nb <= 65535


def test_syrk_over_a_lead_emulated_matches_the_plain_version():
    """The bf16 partition's arithmetic over a lead, in numpy: each grid
    block's segments summed into the tile of its (expert, block), shared
    tiles added in block order; equal to the plain factor sum."""
    rng = np.random.RandomState(9)
    lead, n, d, max_dim = 3, 150, 300, 128
    x = rng.randn(lead, n, d).astype(np.float32)
    nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
    tiles, slices, ctas, per = kern.syrk_geometry(n, b, nb, SMS, lead)
    pairs = tiles * (tiles + 1) // 2
    t_ = kern.TC_TILE
    xp = np.zeros((lead, slices * kern.TC_SLICE, nb * b), np.float64)
    xp[:, :n, :d] = x
    out = np.zeros((lead, nb, tiles * t_, tiles * t_))
    total = lead * nb * pairs * slices
    for w in range(ctas):
        for g in range(w * per, min(total, (w + 1) * per)):
            q, s = divmod(g, slices)
            blk, pair = divmod(q, pairs)
            e, k = divmod(blk, nb)
            ti, tj = _tile_pair(pair, tiles)
            rows = xp[e, s * kern.TC_SLICE:(s + 1) * kern.TC_SLICE,
                      k * b:(k + 1) * b]
            rows = np.pad(rows, ((0, 0), (0, tiles * t_ - b)))
            a = rows[:, ti * t_:(ti + 1) * t_]
            c = rows[:, tj * t_:(tj + 1) * t_]
            out[e, k, ti * t_:(ti + 1) * t_, tj * t_:(tj + 1) * t_] += a.T @ c
    up = out[..., :b, :b]
    full = np.triu(up) + np.swapaxes(np.triu(up, 1), -1, -2)
    want = ref.factor_sum_ref(torch.from_numpy(x), max_dim).numpy()
    assert _rel(full, want) <= 1e-6


@pytest.mark.parametrize("lead,nb,b,dim,other", [
    (60, 1, 2048, 2048, 1408),   # qwen2_moe's up/gate gradient, A side
    (60, 1, 1408, 1408, 2048),   # its down gradient, A side
    (3, 3, 684, 2050, 300),      # ragged last block
    (2, 3, 97, 290, 70),         # rows off 16-byte alignment
])
@pytest.mark.parametrize("right", [False, True])
def test_precond_items_cover_every_expert_block_tile_once(lead, nb, b, dim,
                                                          other, right):
    """block_precond's items over a lead: item i's k (precond_item) counts
    on across the matrices, matrix k // nb and block k % nb; every
    (expert, block, tile) once, the persistent blocks take every item
    once, and each matrix's tiles cover its output exactly."""
    tiles_r, tiles_c, items, blocks = kern.precond_geometry(
        nb, b, dim, other, right, SMS, lead)
    assert items == lead * nb * tiles_r * tiles_c and blocks == min(items,
                                                                    SMS)
    taken = sorted(i for w in range(blocks)
                   for i in kern.precond_block_items(w, blocks, items))
    assert taken == list(range(items))
    seen, area = set(), np.zeros(lead, np.int64)
    for i in range(items):
        it = kern.precond_item(i, nb, b, dim, other, right)
        if it is None:
            continue
        kf, r0, c0, valid = it
        e, k = divmod(kf, nb)
        assert 0 <= e < lead and valid == min(b, dim - k * b) > 0
        assert (e, k, r0, c0) not in seen
        seen.add((e, k, r0, c0))
        rows, cols = (other, valid) if right else (valid, other)
        area[e] += (min(r0 + kern.PRECOND_TILE, rows) - r0) * \
            (min(c0 + kern.PRECOND_TILE, cols) - c0)
    assert (area == dim * other).all()


def test_precond_over_a_lead_emulated_matches_the_plain_version():
    """The items' arithmetic over a lead, in numpy: each item's tile of
    binv[e, k] times w[e]'s block rows (left) or w[e]'s block columns times
    binv[e, k] (right), written at its place; equal to the plain
    version."""
    rng = np.random.RandomState(10)
    lead, nb, b, dim, other = 3, 2, 145, 289, 200   # the last block ragged
    t_ = kern.PRECOND_TILE
    binv = rng.randn(lead, nb, b, b).astype(np.float32)
    for right in (False, True):
        w = rng.randn(*((lead, other, dim) if right else (lead, dim, other))
                      ).astype(np.float32)
        out = np.zeros(w.shape)
        items = kern.precond_geometry(nb, b, dim, other, right, SMS,
                                      lead)[2]
        for i in range(items):
            it = kern.precond_item(i, nb, b, dim, other, right)
            if it is None:
                continue
            kf, r0, c0, valid = it
            e, k = divmod(kf, nb)
            bi = binv[e, k, :valid, :valid].astype(np.float64)
            if right:                # block k's output: (other, valid)
                u = w[e][:, k * b:k * b + valid] @ bi
                rr, cc = slice(r0, r0 + t_), slice(k * b + c0,
                                                   k * b + min(c0 + t_, valid))
            else:                    # (valid, other)
                u = bi @ w[e][k * b:k * b + valid]
                rr, cc = slice(k * b + r0, k * b + min(r0 + t_, valid)), \
                    slice(c0, c0 + t_)
            out[e, rr, cc] = u[r0:r0 + t_, c0:c0 + t_]
        tb, tw = torch.from_numpy(binv), torch.from_numpy(w)
        want = (dispatch.block_precond_right(tw, tb) if right
                else dispatch.block_precond_left(tb, tw))
        assert _rel(out, want.numpy()) <= 1e-5, right
