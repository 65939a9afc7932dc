"""Checkpoints of the dense family's new leaves between the packages, on
the CPU: a reduced ``llava_next_34b`` (the vision projector's ``proj/w``,
its factor family and momentum) and a reduced ``qwen1_5_4b`` (the QKV
biases ``bq``/``bk``/``bv`` and their bias families), each after one
SP-NGD capture step. A checkpoint written by ``repro`` restores in the
port with every leaf bit for bit (the port's layout of what it restored
is the file), and one written by the port restores in ``repro`` bit for
bit; both packages write the same npz keys, dtypes and bytes.

Fixture: ``tests/test_torch_dense_configs_parity.py``'s.
"""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.launch.train import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.launch.train import make_train_step
from test_torch_dense_configs_parity import DAMP, LR, MOM, _setup

ARCHS = ["llava_next_34b", "qwen1_5_4b"]
# the leaves each arch brings that no earlier config had
NEW_LEAVES = {"llava_next_34b": ("proj|w",),
              "qwen1_5_4b": ("blocks|attn|bq", "blocks|attn|bk",
                             "blocks|attn|bv")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(tree) -> dict:
    return {k: (v.dtype.str, v.shape, v.tobytes())
            for k, v in _flatten(tree).items()}


def _files(path: str) -> dict:
    out = {}
    for kind in ("params", "opt"):
        with np.load(f"{path}.{kind}.npz") as z:
            out[kind] = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                         for k in z.files}
    return out


def _check_new_leaves(arch, files):
    for leaf in NEW_LEAVES[arch]:
        assert leaf in files["params"], leaf
        assert f"velocity|{leaf}" in files["opt"], leaf
    fams = {k.split("|")[1] for k in files["opt"] if k.startswith("curv|")}
    if arch == "llava_next_34b":
        assert "proj" in fams
    else:
        assert {"blk/attn_bq", "blk/attn_bk", "blk/attn_bv"} <= fams


@pytest.mark.parametrize("arch", ARCHS)
def test_repro_checkpoint_restores_in_the_port(tmp_path, arch):
    (jm, jopt, jp, js, jb, jflags), (tm, topt, _, _, _) = _setup(arch)
    jp, js, _ = jax.jit(jmake_train_step(jm, jopt))(jp, js, jb, jflags, DAMP,
                                                    LR, MOM)
    jsave(str(tmp_path), 1, jp, js, None)
    want = _files(str(tmp_path / "ckpt_00000001"))
    _check_new_leaves(arch, want)
    r = restore_checkpoint(str(tmp_path), cfg=tm.cfg, device="cpu")
    tm.load_state_dict(r["params"])
    assert _bits(convert.params_layout(tm.params())) == want["params"]
    assert _bits(convert.opt_state_layout(r["opt_state"])) == want["opt"]
    # and the port writes the same files from what it restored
    save_checkpoint(str(tmp_path / "port"), 1, tm.params(), r["opt_state"])
    assert _files(str(tmp_path / "port" / "ckpt_00000001")) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_repro(tmp_path, arch):
    _, (tm, topt, ts, tb, tflags) = _setup(arch)
    params, ts, _ = make_train_step(tm, topt)(tm.params(), ts, tb, tflags,
                                              DAMP, LR, MOM)
    save_checkpoint(str(tmp_path), 1, params, ts)
    _check_new_leaves(arch, _files(str(tmp_path / "ckpt_00000001")))
    r = jrestore(str(tmp_path))
    for got, want in ((r["params"], convert.params_to_jax(params)),
                      (r["opt_state"], convert.opt_state_to_jax(ts))):
        got = jax.tree.map(np.asarray, got)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
