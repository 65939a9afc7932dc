"""The dense architecture family of repro_torch against the JAX package, on
the CPU: ``llama3_2_3b``, ``qwen1_5_4b`` (QKV bias), ``musicgen_medium``
(gelu, LayerNorm, ungated MLP), ``nemotron_4_340b`` (relu2, LayerNorm,
ungated) and ``llava_next_34b`` (the vision projector ``proj`` over
``pixel_embeds``, whose rows go before the text's), each at ``reduced()``.

Both packages start from the same JAX ``PRNGKey(0)`` params, drawn under
``jax.threefry_partitionable(False)`` (the mode of the committed
benchmark, ``tests/test_torch_train_parity.py``), moved over through
numpy; the batch (and llava's ``pixel_embeds``) comes from numpy with a
seed, batch (4, 16) as in the training parity tests' fixture.
``NGDConfig(damping=1e-3)``, every refresh flag set, lr 5e-3, momentum
0.9 -- that fixture's too. Tolerances, relative to the largest entry (f32,
another reduction order): forward logits, one capture step's params,
momentum, X_-1 history and preconditioners 1e-4; the eight losses of
eight capture steps, the pre-chaos prefix, within rtol = atol = 1e-4 (the
losses fall below 1e-3 by step 7). With fewer rows (batch (2, 16): 16
image rows against llava's 64-wide ``proj`` A) the factors are rank
deficient and amplify f32 rounding in the momenta to about the
tolerance, in either package against a float64 step alike.
The attention runs its plain version in both packages (the
CUDA kernels run on the card only, ``chip_smoke.py``), which also takes
``nemotron_4_340b``'s own head dim 192 through an override of its reduced
config. Last, the trainer's CLI refuses ``llava_next_34b`` (its batches
need ``pixel_embeds``) and trains a reduced ``qwen1_5_4b`` on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.ngd import NGDConfig as JNGDConfig
from repro.core.ngd import SPNGD as JSPNGD
from repro.launch.train import make_train_step as jmake_train_step
from repro.models.transformer import DecoderLM as JDecoderLM
from repro_torch import convert
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core.ngd import NGDConfig, SPNGD
from repro_torch.launch.train import make_train_step
from repro_torch.models.transformer import DecoderLM
from test_torch_train_parity import _get, _leaves, _rel

ARCHS = ["llama3_2_3b", "qwen1_5_4b", "musicgen_medium", "nemotron_4_340b",
         "llava_next_34b"]
# the config-field and template checks take the recurrent families too
CONFIG_ARCHS = ARCHS + ["rwkv6_7b", "hymba_1_5b"]
DAMP, LR, MOM = 1e-3, 5e-3, 0.9
BATCH = (4, 16)
STEPS = 8
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, **overrides):
    """Both packages on the same params, optimizer state and batch:
    ((jm, jopt, jp, js, jb, jflags), (tm, topt, ts, tb, tflags))."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(**overrides),
                               backend="ref")
    jm = JDecoderLM(jcfg)
    with jax.threefry_partitionable(False):
        jp = jm.init(jax.random.PRNGKey(0))
    jopt = JSPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                  JNGDConfig(damping=DAMP, backend="ref"))
    js = jopt.init(jp)
    cfg = get_config(arch).reduced(**overrides)
    tm = DecoderLM(cfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jp), cfg, "cpu"))
    topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                 NGDConfig(damping=DAMP))
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js), cfg, "cpu")
    rng = np.random.RandomState(7)
    batch = {"tokens": rng.randint(0, cfg.vocab, BATCH).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab, BATCH).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["pixel_embeds"] = rng.standard_normal(
            (BATCH[0], cfg.frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jflags = {k: jnp.asarray(True) for k in jopt.stat_names()}
    tflags = {k: True for k in topt.stat_names()}
    return (jm, jopt, jp, js, jb, jflags), (tm, topt, ts, tb, tflags)


# the read-only tests' fixture: one setup per arch, nothing mutates it
_shared = functools.lru_cache(maxsize=None)(_setup)


@functools.lru_cache(maxsize=None)
def _runs(arch):
    """repro's and the port's STEPS capture steps from the same start: each
    one's losses, and its params and optimizer state after step 1 in the
    JAX layout (numpy)."""
    (jm, jopt, jp, js, jb, jflags), (tm, topt, ts, tb, tflags) = _setup(arch)
    # one package after the other: JAX's asynchronous steps would otherwise
    # run beside torch's and the two CPU thread pools slow each other
    jstep = jax.jit(jmake_train_step(jm, jopt))
    jlosses, jfirst = [], None
    for _ in range(STEPS):
        jp, js, m = jstep(jp, js, jb, jflags, DAMP, LR, MOM)
        jlosses.append(float(m["loss"]))
        if jfirst is None:
            jfirst = (jax.tree.map(np.array, jp), jax.tree.map(np.array, js))
    step = make_train_step(tm, topt)
    params, tlosses, tfirst = tm.params(), [], None
    for _ in range(STEPS):
        params, ts, m = step(params, ts, tb, tflags, DAMP, LR, MOM)
        tlosses.append(float(m["loss"]))
        if tfirst is None:
            # copies: the numpy trees share the CPU tensors' memory, which
            # the next steps update in place
            tfirst = (jax.tree.map(np.array, convert.params_to_jax(params)),
                      jax.tree.map(np.array, convert.opt_state_to_jax(ts)))
    return (jlosses, jfirst), (tlosses, tfirst)


@pytest.mark.parametrize("arch", CONFIG_ARCHS)
def test_reduced_config_matches_repro(arch):
    """Every field the port's ArchConfig has equals repro's, full and
    reduced; dtype is torch's float32 where repro's is jnp.float32."""
    for j, t in ((jget_config(arch), get_config(arch)),
                 (jget_config(arch).reduced(), get_config(arch).reduced())):
        assert isinstance(t, ArchConfig)
        for f in dataclasses.fields(t):
            if f.name == "dtype":
                continue
            assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
    assert get_config(arch).reduced().dtype == torch.float32
    assert get_config(arch).dtype == torch.bfloat16


def test_aliases_and_registry_match_repro():
    """The port registers repro's architectures, in repro's order, and
    resolves its aliases (``hymba-1.5b`` too); an unknown name raises."""
    from repro.configs.base import ARCHS as JARCHS
    from repro_torch.configs.base import ARCHS as TARCHS
    assert TARCHS == JARCHS
    assert set(CONFIG_ARCHS) <= set(TARCHS)
    for alias, name in (("qwen1.5-4b", "qwen1_5_4b"),
                        ("llama3.2-3b", "llama3_2_3b"),
                        ("llava-next-34b", "llava_next_34b"),
                        ("hymba-1.5b", "hymba_1_5b"),
                        ("rwkv6-7b", "rwkv6_7b")):
        assert get_config(alias) == get_config(name)
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("gpt5")


@pytest.mark.parametrize("arch", CONFIG_ARCHS)
def test_stat_names_and_templates_match_repro(arch):
    (jm, jopt, *_), (tm, topt, *_) = _shared(arch)
    assert topt.stat_names() == jopt.stat_names()
    assert list(tm.site_infos()) == list(jm.site_infos())
    jt = jax.eval_shape(jm.fstats)
    tt = tm.fstats()
    assert set(jt) == set(tt)
    for fam in jt:
        for key in jt[fam]:
            assert tuple(tt[fam][key].shape) == jt[fam][key].shape, (fam, key)
    assert topt.stat_bytes() == jopt.stat_bytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_site_counts_match_repro(arch):
    (jm, *_, jb, _), (tm, *_, tb, _) = _shared(arch)
    want = jm.site_counts(jb)
    got = tm.site_counts(tb)
    assert list(got) == list(want)
    for fam, (na, ng) in want.items():
        assert got[fam] == (int(na), float(ng)), fam


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_repro(arch):
    """Logits over every position (llava's image rows first), and the
    loss, within 1e-4 of repro's."""
    (jm, _, jp, _, jb, _), (tm, _, _, tb, _) = _shared(arch)
    jlogits, _ = jm.forward(jp, jb)
    with torch.no_grad():
        tlogits, aux = tm.forward(tb)
        tloss, _ = tm.loss(tm.params(), None, tb)
    n_front = tm.cfg.frontend_tokens if tm.cfg.frontend == "vision" else 0
    assert aux["n_front"] == n_front
    assert tlogits.shape == (BATCH[0], BATCH[1] + n_front, tm.cfg.vocab)
    assert _rel(tlogits.numpy(), jlogits) <= REL
    jloss, _ = jm.loss(jp, None, jb)
    assert abs(float(tloss) - float(jloss)) <= REL * abs(float(jloss))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_params_and_state_match_repro(arch):
    """One capture step, every statistic refreshed: updated params,
    momentum, X_-1 history and preconditioners within 1e-4."""
    (_, (jp, js)), (_, (tp, ts)) = _runs(arch)
    for path, want in _leaves(jp):
        assert _rel(_get(tp, path), want) <= REL, path
    assert int(ts["step"]) == int(js["step"]) == 1
    for path, want in _leaves(js["velocity"]):
        assert _rel(_get(ts["velocity"], path), want) <= REL, path
    for fam, entry in js["curv"].items():
        for slot in ("prev", "precond"):
            for key, want in entry[slot].items():
                got = ts["curv"][fam][slot][key]
                assert _rel(got, want) <= REL, (fam, slot, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_eight_step_losses_match_repro(arch):
    (jlosses, _), (tlosses, _) = _runs(arch)
    assert np.isfinite(tlosses).all()
    np.testing.assert_allclose(tlosses, jlosses, rtol=REL, atol=REL)


def test_nemotron_head_dim_192_on_the_plain_versions():
    """reduced nemotron_4_340b at its own head dim 192 (4 query heads of
    192 over 1 KV head, d_model 256): the logits and one capture step's
    params and preconditioners match repro's on both packages' plain
    attention."""
    (jm, jopt, jp, js, jb, jflags), (tm, topt, ts, tb, tflags) = _setup(
        "nemotron_4_340b", head_dim=192)
    assert tm.cfg.hd == 192
    jlogits, _ = jm.forward(jp, jb)
    with torch.no_grad():
        tlogits, _ = tm.forward(tb)
    assert _rel(tlogits.numpy(), jlogits) <= REL
    jp1, js1, jm1 = jax.jit(jmake_train_step(jm, jopt))(
        jp, js, jb, jflags, DAMP, LR, MOM)
    tp1, ts1, tm1 = make_train_step(tm, topt)(tm.params(), ts, tb, tflags,
                                              DAMP, LR, MOM)
    assert abs(float(tm1["loss"]) - float(jm1["loss"])) <= \
        REL * abs(float(jm1["loss"]))
    got = convert.params_to_jax(tp1)
    for path, want in _leaves(jax.tree.map(np.asarray, jp1)):
        assert _rel(_get(got, path), want) <= REL, path
    tst = convert.opt_state_to_jax(ts1)
    for fam, entry in jax.tree.map(np.asarray, js1)["curv"].items():
        for key, want in entry["precond"].items():
            assert _rel(tst["curv"][fam]["precond"][key], want) <= REL, \
                (fam, key)


def test_cli_refuses_llava(capsys):
    """The CLI feeds token batches only, as repro's does: llava_next_34b
    is refused before anything is built, with the reason."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--arch", "llava_next_34b"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "pixel_embeds" in err and "token batches only" in err


def test_cli_trains_reduced_qwen_on_cpu(capsys):
    from repro_torch.launch import train
    torch.manual_seed(0)
    train.main(["--device", "cpu", "--arch", "qwen1_5_4b", "--steps", "2",
                "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "arch=qwen1_5_4b (reduced)" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert [ln.split()[1] for ln in lines] == ["1", "2"]
    assert all(np.isfinite(float(ln.split()[4])) for ln in lines)
