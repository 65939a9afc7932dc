"""The recurrent families of repro_torch against the JAX package, on the
CPU: ``models/rwkv.py`` (RWKV-6 time and channel mix, the WKV scan),
``models/ssm.py`` (the selective SSM branch and its scan) and reduced
``rwkv6_7b`` (attention-free, d 256, 4 WKV heads of 64, d_ff 256) and
``hymba_1_5b`` (attention over 4/1 heads beside an SSM of state 8, d_inner
512), each trained by SP-NGD.

Inputs come from numpy with a seed; the models start from the same JAX
``PRNGKey(0)`` params drawn under ``jax.threefry_partitionable(False)``,
moved over through ``convert.params_from_jax``. Fixture: batch (4, 16),
``NGDConfig(damping=1e-3)``, every refresh flag set, lr 5e-3, momentum
0.9 (the dense and MoE families' fixture). Tolerances, relative to the
largest entry: forward logits 1e-4; the chunked scans against the plain
ones 1e-5 (the port's are the same ops: 0 here), the gradients of the
time mix and the SSM branch under ``chunk=8`` against ``repro``'s 1e-3;
one eigh capture step and three fast steps, and one Newton-Schulz
capture step: params, momentum, X_-1
history and preconditioners within 1e-4 of ``repro``'s or, where a
package's own step moves further when its starting params move by one
f32 ulp, within twice the larger of the two packages' moves (the MoE
family's bound, ``tests/test_torch_moe_parity.py``, taken on both
sides): at 64 tokens the A factors of rwkv's 256-wide sites are rank
deficient and their damped inverses amplify f32 rounding (``tm/wo``'s
momentum after the capture step sits 1.1e-4 to 1.3e-4 from ``repro``'s
while the gradients agree within 2.5e-5). Each fast step starts from
``repro``'s state after the step before it (step by step along
``repro``'s trajectory, as the ConvNet and fused-capture tests do): run
freely, rwkv's fixture is chaotic under the fast steps, in ``repro``
itself (by the third, one ulp of the starting params moves ``repro``'s
own ``ln1/gamma`` momentum by 9e-2 of its largest entry).
Every ``repro`` computation (its params, steps, logits and the scans'
references) runs in processes of their own on one CPU
(``tests/jax_one_cpu.py``), started with the module: JAX in a loaded test
worker runs many times slower. The recurrences have no CUDA kernel to
hold here: the scans are loops of torch ops on the card too
(``chip_smoke.py check_recurrent_routes`` holds the families' kernels
there).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jget_config
from repro.core.ngd import NGDConfig as JNGDConfig
from repro.core.ngd import SPNGD as JSPNGD
from repro.launch.train import make_fast_step as jmake_fast_step
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models.transformer import DecoderLM as JDecoderLM
from repro_torch import convert
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core.ngd import NGDConfig, SPNGD
from repro_torch.launch import train
from repro_torch.models import rwkv, ssm
from repro_torch.models.transformer import DecoderLM
import jax_one_cpu
from test_torch_train_parity import _get, _leaves, _rel

ARCHS = ["rwkv6_7b", "hymba_1_5b"]
DAMP, LR, MOM = 1e-3, 5e-3, 0.9
BATCH = (4, 16)
FAST = 3
CHUNK = 8
REL = 1e-4
SCAN_TOL = 1e-5
GRAD_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# repro's side, in processes of their own on one CPU, all started with the
# module: {key: child}
_children: dict = {}
WKV_CASES = [(2, 16), (4, 32), (8, 16), (8, 12)]
SSM_CHUNKS = [2, 8]


@pytest.fixture(autouse=True, scope="module")
def _jax_children():
    for arch in ARCHS:
        for what in ("eigh", "ns"):
            _children[arch, what] = jax_one_cpu.start(__name__,
                                                      f"jax_{what}", arch)
    _children["modules"] = jax_one_cpu.start(__name__, "jax_modules")
    yield
    for child in _children.values():
        child.close()


def _batch(vocab):
    rng = np.random.RandomState(7)
    return {"tokens": rng.randint(0, vocab, BATCH).astype(np.int32),
            "labels": rng.randint(0, vocab, BATCH).astype(np.int32)}


def _jax_objects(arch, method="eigh", **over):
    """repro's model, optimizer and batch (nothing computed yet)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(**over),
                               backend="ref")
    jm = JDecoderLM(jcfg)
    jopt = JSPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                  JNGDConfig(damping=DAMP, backend="ref",
                             inverse_method=method))
    jb = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab).items()}
    return jm, jopt, jb


def _jax_side(arch, method="eigh"):
    """repro's model, optimizer, params, initial state and batch."""
    jm, jopt, jb = _jax_objects(arch, method)
    with jax.threefry_partitionable(False):
        jp = jm.init(jax.random.PRNGKey(0))
    return jm, jopt, jp, jopt.init(jp), jb


def _torch_side(arch, jp, js, method="eigh", **over):
    cfg = get_config(arch).reduced(**over)
    tm = DecoderLM(cfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jp), cfg, "cpu"))
    topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                 NGDConfig(damping=DAMP, inverse_method=method))
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js), cfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    return tm, topt, ts, tb


def _snap(params, state):
    """(params, state) in the JAX layout, numpy copies."""
    return (jax.tree.map(np.array, params), jax.tree.map(np.array, state))


def _ulp_moved(jp):
    """Params (numpy), each element times 1 +- 2^-23 (signs from a seed)."""
    rng = np.random.RandomState(3)
    return jax.tree.map(lambda a: np.asarray(a) * (1 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], a.shape).astype(a.dtype)), jp)


def _jax_steps(side, method):
    """repro's capture step (then, for eigh, FAST fast steps) from
    ``side`` (``_jax_side``), and each step again from the params it
    started from moved by one ulp: (snapshots, moved)."""
    jm, jopt, jp, js, jb = side
    flags = {k: jnp.asarray(True) for k in jopt.stat_names()}
    step = jax.jit(jmake_train_step(jm, jopt))
    fast = jax.jit(jmake_fast_step(jm, jopt))
    snaps, moved = [], []
    for i in range(1 + (FAST if method == "eigh" else 0)):
        if i == 0:
            runs = [step(p, js, jb, flags, DAMP, LR, MOM)
                    for p in (jp, _ulp_moved(jp))]
        else:
            runs = [fast(p, js, jb, DAMP, LR, MOM)
                    for p in (jp, _ulp_moved(jp))]
        (jp, js, _), (mp, ms, _) = runs
        snaps.append(_snap(jp, js))
        moved.append(_snap(mp, ms))
    return snaps, moved


def jax_eigh(arch):
    """repro's side of one family (run in a process of its own on one
    CPU): its params and initial state, the forward's logits and loss, the
    eigh capture step and FAST fast steps."""
    side = _jax_side(arch)
    jm, _, jp, js, jb = side
    logits, _ = jax.jit(jm.forward)(jp, jb)
    loss, _ = jax.jit(jm.loss)(jp, None, jb)
    snaps, moved = _jax_steps(side, "eigh")
    return {"init": _snap(jp, js), "logits": np.asarray(logits),
            "loss": float(loss), "steps": snaps, "moved": moved}


def jax_ns(arch):
    """repro's Newton-Schulz capture step and its initial state (run in a
    process of its own on one CPU)."""
    side = _jax_side(arch, "newton_schulz")
    snaps, moved = _jax_steps(side, "newton_schulz")
    return {"state": _snap(side[2], side[3])[1], "steps": snaps,
            "moved": moved}


def jax_modules():
    """repro's references for the module tests (run in a process of its
    own on one CPU): ``_wkv_scan`` on each of WKV_CASES, ``ssm_branch``
    and ``time_mix`` chunked, with the grads of their test losses."""
    out = {"wkv": {}, "ssm": {}}
    for chunk, s in WKV_CASES:
        a = _wkv_inputs(s, chunk * 100 + s)
        st, y = jrwkv._wkv_scan(*(jnp.asarray(x) for x in a[:5]),
                                jnp.asarray(a[5]), chunk=chunk)
        out["wkv"][chunk, s] = (np.asarray(st), np.asarray(y))
    for chunk in SSM_CHUNKS:
        x, p, h0, conv0 = _ssm_inputs(chunk)

        def fn(p):
            y, st = jssm.ssm_branch(
                jnp.asarray(x), p, None, state=4, chunk=chunk,
                init_state=jnp.asarray(h0), conv_cache=jnp.asarray(conv0),
                return_state=True)
            return jnp.sum(jnp.sin(y)), (y, st)
        (_, (y, (h, conv))), g = jax.value_and_grad(fn, has_aux=True)(
            {k: jnp.asarray(v) for k, v in p.items()})
        out["ssm"][chunk] = (np.asarray(y), np.asarray(h), np.asarray(conv),
                             jax.tree.map(np.asarray, g))
    x, p, last, st0 = _tm_inputs(4)

    def tm_fn(x, p):
        y, (_, st) = jrwkv.time_mix(x, p, None, head_dim=8,
                                    last_x=jnp.asarray(last),
                                    wkv_state=jnp.asarray(st0), chunk=CHUNK,
                                    return_state=True)
        return jnp.sum(jnp.sin(y)) + jnp.sum(st ** 2) * 1e-3, (y, st)
    (_, (y, st)), (gx, gp) = jax.value_and_grad(tm_fn, argnums=(0, 1),
                                                has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    out["tm"] = (np.asarray(y), np.asarray(st), np.asarray(gx),
                 jax.tree.map(np.asarray, gp))
    return out


@functools.lru_cache(maxsize=None)
def _jax_result(*key):
    """A child's result, ``key`` as in ``_children``."""
    return _children[key if len(key) > 1 else key[0]].result()


def _init(arch):
    """repro's params and initial eigh state (numpy)."""
    return _jax_result(arch, "eigh")["init"]


def _torch_step(arch, method, start, capture):
    """The port's capture (or fast) step from ``start``, (params, state) in
    the JAX layout: the snapshot after it, in the JAX layout."""
    tm, topt, ts, tb = _torch_side(arch, *start, method)
    if capture:
        flags = {k: True for k in topt.stat_names()}
        params, ts, _ = train.make_train_step(tm, topt)(
            tm.params(), ts, tb, flags, DAMP, LR, MOM)
    else:
        params, ts, _ = train.make_fast_step(tm, topt)(tm.params(), ts, tb,
                                                       DAMP, LR, MOM)
    return _snap(convert.params_to_jax(params), convert.opt_state_to_jax(ts))


def _torch_steps(arch, method, want):
    """The port's steps along repro's trajectory ``want``: the capture
    step from repro's start, each fast step from repro's snapshot before
    it; each again from its start's params moved by one ulp. Returns
    (snapshots, moved)."""
    jp, js = _init(arch)
    if method != "eigh":
        js = _jax_result(arch, "ns")["state"]
    starts = [(jp, js)] + list(want[:-1])
    got = [_torch_step(arch, method, st, i == 0)
           for i, st in enumerate(starts)]
    moved = [_torch_step(arch, method, (_ulp_moved(p), s), i == 0)
             for i, (p, s) in enumerate(starts)]
    return got, moved


def _held(got, want, moved, tmoved, what):
    """Params, momentum, X_-1 history and preconditioners within REL of
    repro's, or within twice the larger of the two packages' own moves
    under one ulp (``moved``: repro's, ``tmoved``: the port's)."""
    def close(path, pick):
        g, w = pick(got), pick(want)
        bound = max(REL, 2 * _rel(pick(moved), w), 2 * _rel(pick(tmoved), g))
        assert _rel(g, w) <= bound, (what,) + path
    for path, _ in _leaves(want[0]):
        close(("params",) + path, lambda t: _get(t[0], path))
    for path, _ in _leaves(want[1]["velocity"]):
        close(("velocity",) + path,
              lambda t: _get(t[1]["velocity"], path))
    for fam, entry in want[1]["curv"].items():
        for slot in ("prev", "precond"):
            for key in entry[slot]:
                close((fam, slot, key),
                      lambda t: t[1]["curv"][fam][slot][key])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_repro(arch):
    """Every field of the port's ArchConfig equals repro's, full and
    reduced (rwkv: no SSM; hymba: state 16 -> 8, 25/5 heads -> 4/1)."""
    for j, t in ((jget_config(arch), get_config(arch)),
                 (jget_config(arch).reduced(), get_config(arch).reduced())):
        assert isinstance(t, ArchConfig)
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
    r = get_config(arch).reduced()
    assert r.dtype == torch.float32 and r.d_model == 256
    if arch == "hymba_1_5b":
        assert (r.ssm_state, r.n_heads, r.n_kv_heads) == (8, 4, 1)
        assert get_config("hymba-1.5b") == get_config("hymba_1_5b")


def test_validate_and_attention_free_reduction_match_repro():
    """validate() checks heads only for the blocks with attention; an
    attention-free config reduces to no heads and width 128, as repro's."""
    from repro.configs.base import ArchConfig as JArchConfig
    kw = dict(name="x", arch_type="ssm", n_layers=4, d_model=512, n_heads=0,
              n_kv_heads=0, d_ff=1024, vocab=1000, head_dim=64,
              block_type="rwkv")
    t, j = ArchConfig(**kw), JArchConfig(**kw)
    t.validate()
    j.validate()
    tr, jr = t.reduced(), j.reduced()
    assert (tr.n_heads, tr.n_kv_heads, tr.d_model) == (0, 1, 128)
    for f in dataclasses.fields(tr):
        if f.name != "dtype":
            assert getattr(tr, f.name) == getattr(jr, f.name), f.name
    with pytest.raises(AssertionError):
        dataclasses.replace(t, block_type="hymba").validate()


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------

def _wkv_inputs(s, seed):
    rng = np.random.RandomState(seed)
    b, h, hd = 2, 2, 4
    r, k, v = (rng.randn(b, s, h, hd).astype(np.float32) for _ in range(3))
    w = (rng.rand(b, s, h, hd) * 0.5 + 0.4).astype(np.float32)
    u = rng.randn(h, hd).astype(np.float32)
    st0 = rng.randn(b, h, hd, hd).astype(np.float32)
    return r, k, v, w, u, st0


@pytest.mark.parametrize("chunk,s", WKV_CASES)
def test_wkv_scan_chunked_matches_plain_and_repro(chunk, s):
    """The chunked WKV scan against the per-token one (and, at S 12, not
    a multiple of the chunk, the per-token one itself), both against
    repro's _wkv_scan; outputs and final state."""
    a = _wkv_inputs(s, chunk * 100 + s)
    t = [torch.from_numpy(x) for x in a]
    st_a, y_a = rwkv._wkv_scan(*t[:5], t[5], chunk=0)
    st_b, y_b = rwkv._wkv_scan(*t[:5], t[5], chunk=chunk)
    np.testing.assert_allclose(y_b, y_a, rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(st_b, st_a, rtol=SCAN_TOL, atol=SCAN_TOL)
    jst, jy = _jax_result("modules")["wkv"][chunk, s]
    assert _rel(y_b, jy) <= REL and _rel(st_b, jst) <= REL


def _ssm_inputs(seed, s=16, d=32, state=4):
    """x, the branch's params, a carried SSM state and conv cache."""
    rng = np.random.RandomState(seed)
    di, r = 2 * d, max(1, d // 16)
    p = {"in_proj": rng.randn(d, 2 * di) / d ** 0.5,
         "conv_w": rng.randn(4, di) * 0.1,
         "xdb": rng.randn(di, r + 2 * state) / di ** 0.5,
         "dt_proj": rng.randn(r, di) / r ** 0.5,
         "dt_bias": rng.randn(di) * 0.1,
         "a_log": np.log(np.broadcast_to(np.arange(1, state + 1),
                                         (di, state))),
         "d_skip": np.ones(di),
         "out_proj": rng.randn(di, d) / di ** 0.5}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x = rng.randn(2, s, d).astype(np.float32)
    rng = np.random.RandomState(3)
    return (x, p, rng.randn(2, di, state).astype(np.float32),
            rng.randn(2, 3, di).astype(np.float32))


@pytest.mark.parametrize("chunk", SSM_CHUNKS)
def test_ssm_branch_chunked_matches_plain_and_repro(chunk):
    """ssm_branch with the chunked scan against the per-token one, with a
    carried state and conv cache, and both against repro's: outputs, the
    final SSM state and the conv cache; the grads of every param through
    the chunked scan against the per-token scan's (1e-5) and repro's
    chunked branch's (1e-3)."""
    x, p, h0, conv0 = _ssm_inputs(chunk)
    outs = {}
    for c in (0, chunk):
        tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
        y, (h, conv) = ssm.ssm_branch(
            torch.from_numpy(x), tp, None, state=4, chunk=c,
            init_state=torch.from_numpy(h0),
            conv_cache=torch.from_numpy(conv0), return_state=True)
        grads = torch.autograd.grad(torch.sum(torch.sin(y)), list(tp.values()))
        outs[c] = (y.detach(), h.detach(), conv.detach(), grads)
    for a, b in zip(outs[0][:3], outs[chunk][:3]):
        np.testing.assert_allclose(b, a, rtol=SCAN_TOL, atol=SCAN_TOL)
    for ga, gb in zip(outs[0][3], outs[chunk][3]):
        np.testing.assert_allclose(gb, ga, rtol=SCAN_TOL, atol=SCAN_TOL)
    jy, jh, jconv, jg = _jax_result("modules")["ssm"][chunk]
    for got, want in zip(outs[chunk][:3], (jy, jh, jconv)):
        assert _rel(got, want) <= REL
    for name, g in zip(p, outs[chunk][3]):
        assert _rel(g, jg[name]) <= GRAD_REL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_model_grads_under_scan_chunk_match_the_per_token_scan(arch):
    """The loss's grads of every param of the model with scan_chunk=8 (two
    chunks of the 16 positions, each recomputed in the backward) against
    the per-token scan's, within 1e-5 of the largest entry."""
    jp, js = _init(arch)
    got = {}
    for chunk in (0, CHUNK):
        tm, _, _, tb = _torch_side(arch, jp, js, scan_chunk=chunk)
        flat = dict(_flatten_params(tm.params()))
        for t in flat.values():
            t.requires_grad_(True)
        loss, _ = tm.loss(tm.params(), None, tb)
        got[chunk] = dict(zip(flat, torch.autograd.grad(
            loss, list(flat.values()))))
    assert len(got[CHUNK]) == len(list(_leaves(jp["blocks"]))) * \
        tm.cfg.n_layers + len([p for p, _ in _leaves(jp)
                               if p[0] != "blocks"])
    for path, g in got[CHUNK].items():
        assert _rel(g, got[0][path]) <= SCAN_TOL, path


def _tm_inputs(seed, s=16, d=32, hd=8):
    rng = np.random.RandomState(seed)
    h, r = d // hd, 8
    p = {f"mu_{n}": rng.rand(d) for n in "rkvwg"}
    p.update({n: rng.randn(d, d) / d ** 0.5
              for n in ("wr", "wk", "wv", "wg", "wo")})
    p.update(w0=rng.randn(d) * 0.5, w_lora_a=rng.randn(d, r) / d ** 0.5,
             w_lora_b=rng.randn(r, d) * 0.1, u_bonus=rng.randn(h, hd),
             ln_scale=1 + 0.1 * rng.randn(d))
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x = rng.randn(2, s, d).astype(np.float32)
    rng = np.random.RandomState(5)
    return (x, p, rng.randn(2, 1, d).astype(np.float32),
            rng.randn(2, h, hd, hd).astype(np.float32))


def test_time_mix_grads_under_chunk_match_repro():
    """time_mix with chunk=8 over 16 positions, from a carried state: the
    output, the final WKV state, and the grads of every param and of x,
    against repro's chunked time_mix within 1e-3 of the largest entry
    (and the output within 1e-4), and against the port's per-token scan
    within 1e-5."""
    x, p, last, st0 = _tm_inputs(4)
    jy, jst, jgx, jgp = _jax_result("modules")["tm"]
    outs = {}
    for c in (0, CHUNK):
        tx = torch.tensor(x, requires_grad=True)
        tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
        y, (_, st) = rwkv.time_mix(tx, tp, None, head_dim=8,
                                   last_x=torch.from_numpy(last),
                                   wkv_state=torch.from_numpy(st0), chunk=c,
                                   return_state=True)
        loss = torch.sum(torch.sin(y)) + torch.sum(st ** 2) * 1e-3
        outs[c] = (y.detach(), st.detach(),
                   torch.autograd.grad(loss, [tx] + list(tp.values())))
    y, st, grads = outs[CHUNK]
    assert _rel(y, jy) <= REL and _rel(st, jst) <= REL
    assert _rel(grads[0], jgx) <= GRAD_REL
    for name, g in zip(p, grads[1:]):
        assert _rel(g, jgp[name]) <= GRAD_REL, name
    for a, b in zip(outs[0][2], grads):
        assert _rel(b, a) <= SCAN_TOL


def _flatten_params(params):
    """(path, tensor) of every leaf of the port's tree, blocks by layer:
    ("blocks", i, "tm", "wr")."""
    for k, v in params.items():
        if k == "blocks":
            for i, blk in enumerate(v):
                for path, t in _leaves(blk):
                    yield ("blocks", i) + path, t
        else:
            for path, t in _leaves(v):
                yield (k,) + path, t


def _jax_leaf(tree, path):
    """The leaf of a JAX-layout tree (blocks stacked on (L,)) at a path of
    :func:`_flatten_params`."""
    if path[0] == "blocks":
        return _get(tree, ("blocks",) + path[2:])[path[1]]
    return _get(tree, path)


def _jax_shape(tree, path, n_layers):
    """The shape of a layer's leaf at a path of :func:`_flatten_params`
    in a JAX-layout tree of shapes."""
    if path[0] == "blocks":
        w = _get(tree, ("blocks",) + path[2:])
        assert w.shape[0] == n_layers, path
        return w.shape[1:], w.dtype
    w = _get(tree, path)
    return w.shape, w.dtype


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_site_order_stat_names_and_templates_match_repro(arch):
    """site_infos in repro's order (kinds, params, betas, widths),
    stat_names, the factor templates' shapes, payload bytes, and the site
    counts."""
    jm, jopt, jb = _jax_objects(arch)
    tm = DecoderLM(get_config(arch).reduced(), device="cpu")
    topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                 NGDConfig(damping=DAMP))
    tb = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg.vocab).items()}
    assert list(tm.site_infos()) == list(jm.site_infos())
    for fam, j in jm.site_infos().items():
        t = tm.site_infos()[fam]
        assert (t.kind, t.param, t.d_in, t.d_out, t.lead, t.beta_param) == \
            (j.kind, j.param, j.d_in, j.d_out, j.lead, j.beta_param), fam
    assert topt.stat_names() == jopt.stat_names()
    jt, tt = jax.eval_shape(jm.fstats), tm.fstats()
    assert set(tt) == set(jt)
    for fam in jt:
        for key in jt[fam]:
            assert tuple(tt[fam][key].shape) == jt[fam][key].shape, (fam, key)
    assert topt.stat_bytes() == jopt.stat_bytes()
    want, got = jm.site_counts(jb), tm.site_counts(tb)
    assert list(got) == list(want)
    for fam, (na, ng) in want.items():
        assert got[fam] == (int(na), float(ng)), fam


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_matches_repro(arch):
    """The port's parameter tree has repro's leaves, shapes and dtypes
    (f32 for w0, u_bonus, ln_scale, a_log, d_skip; the config's dtype
    elsewhere), reduced and at full width (one layer, on the meta
    device)."""
    for cfg, jcfg in ((get_config(arch).reduced(), _jax_objects(arch)[0].cfg),
                      (dataclasses.replace(get_config(arch), n_layers=1),
                       dataclasses.replace(jget_config(arch), n_layers=1))):
        want = jax.eval_shape(JDecoderLM(jcfg).init, jax.random.PRNGKey(0))
        got = dict(_flatten_params(DecoderLM(cfg, device="meta").params()))
        assert len(got) == len(list(_leaves(want["blocks"]))) * \
            cfg.n_layers + len([p for p, _ in _leaves(want)
                                if p[0] != "blocks"])
        for path, t in got.items():
            shape, dtype = _jax_shape(want, path, cfg.n_layers)
            assert tuple(t.shape) == shape, path
            assert t.dtype == getattr(torch, str(dtype)), path


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_repro(arch):
    want = _jax_result(arch, "eigh")
    tm, _, _, tb = _torch_side(arch, *_init(arch))
    with torch.no_grad():
        tlogits, _ = tm.forward(tb)
        tloss, _ = tm.loss(tm.params(), None, tb)
    assert _rel(tlogits.numpy(), want["logits"]) <= REL
    assert abs(float(tloss) - want["loss"]) <= REL * abs(want["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_eigh_capture_and_fast_steps_match_repro(arch):
    """One capture step (every statistic refreshed) from repro's start
    and three fast steps, each from repro's state before it: after each,
    params, momentum, X_-1 history and preconditioners within 1e-4 of
    repro's (or the ulp bound)."""
    res = _jax_result(arch, "eigh")
    want, moved = res["steps"], res["moved"]
    got, tmoved = _torch_steps(arch, "eigh", want)
    assert len(got) == len(want) == 1 + FAST
    for i, args in enumerate(zip(got, want, moved, tmoved)):
        _held(*args, f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_newton_schulz_capture_step_matches_repro(arch):
    res = _jax_result(arch, "ns")
    want, moved = res["steps"], res["moved"]
    got, tmoved = _torch_steps(arch, "newton_schulz", want)
    _held(got[0], want[0], moved[0], tmoved[0], "ns capture")


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_carry_the_recurrent_leaves_both_ways(tmp_path, arch):
    """A checkpoint of repro's initial state restores in the port with
    every leaf bit for bit (the recurrent blocks' f32 and bf16-free
    leaves, 3-D stacks included), and the port's own save of it writes
    the same npz keys and bytes."""
    jp, js = _init(arch)
    jsave(str(tmp_path), 0, jp, js, None)
    tm = DecoderLM(get_config(arch).reduced(), device="cpu")
    r = restore_checkpoint(str(tmp_path), cfg=tm.cfg, device="cpu")
    tm.load_state_dict(r["params"])
    for name in ("tm|u_bonus", "tm|w0", "cm|wv") if arch == "rwkv6_7b" \
            else ("ssm|a_log", "ssm|conv_w", "ssm|xdb"):
        assert f"blocks|{name}" in set(_flatten(convert.params_layout(
            tm.params())))
    save_checkpoint(str(tmp_path / "port"), 0, tm.params(), r["opt_state"])
    for kind in ("params", "opt"):
        with np.load(tmp_path / f"ckpt_00000000.{kind}.npz") as a, \
                np.load(tmp_path / "port" / f"ckpt_00000000.{kind}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and \
                    a[k].tobytes() == b[k].tobytes(), k
    back = jrestore(str(tmp_path / "port"))
    for x, y in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(jp)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_the_recurrent_family_on_the_cpu(arch):
    """``--arch rwkv6_7b`` / ``hymba_1_5b`` train from token batches, as
    repro's CLI does: finite, falling losses."""
    _, state, recs = train.main(["--device", "cpu", "--arch", arch, "--steps",
                             "4", "--batch", "2", "--seq", "16", "--lr",
                             "5e-3", "--damping", "1e-3"])
    losses = [r["loss"] for r in recs]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert state["step"] == 4
