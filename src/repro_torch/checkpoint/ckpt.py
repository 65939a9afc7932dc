"""Checkpoints as ``.npz`` files in the JAX package's layout (counterpart
of ``repro/checkpoint/ckpt.py``).

A checkpoint of step ``s`` is ``ckpt_{s:08d}.params.npz``, ``.opt.npz``
(the optimizer state, SP-NGD or momentum SGD) and ``.ctrl.json`` (the
``IntervalController``'s ``state_dict``), with ``LATEST`` naming the last
step saved. The arrays are the JAX layout (``convert.params_layout``,
``opt_state_layout``: blocks stacked on (L,), the velocity a params tree,
``step`` and the pipeline's ``cursor`` int32, its ``valid`` latches bool),
each under its tree path joined by ``|`` in sorted key order. bf16 and fp8
leaves are stored as their unsigned-integer bit views with the dtype's
name appended to the key (``...|payload@float8_e4m3fn``), exactly as the
JAX package stores its ml_dtypes leaves, so a checkpoint crosses between
the packages bit for bit, and this module needs no ``ml_dtypes``.

The refresh pipeline's state (cursor, raw store, valid latches) is saved
like any other, so a checkpoint taken mid-drain resumes at the same chunk;
``SPNGD.upgrade_state`` carries a restored state across the single- and
double-buffer layouts and in or out of the pipeline. Tensors that share
storage in the live state (the active and staged buffers after a flip, the
raw store and X_-1 under f32 history) are saved, and restored, apart.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from repro_torch import convert


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            if "@" in k or "|" in k:
                raise ValueError(f"checkpoint key {k!r} may not contain "
                                 f"'@' or '|' (reserved separators)")
            out.update(_flatten(tree[k], f"{prefix}{k}|"))
    else:
        bits, name = convert.tensor_bits(tree)
        out[prefix[:-1] + (f"@{name}" if name else "")] = bits
    return out


def _unflatten(flat: dict) -> dict:
    root: dict = {}
    for key, v in flat.items():
        key, _, name = key.partition("@")
        parts = key.split("|")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = convert.bits_tensor(v, name or None)
    return root


def _load(path: str) -> dict:
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def save_checkpoint(ckpt_dir: str, step: int, params: dict,
                    opt_state: Optional[dict] = None,
                    controller: Optional[dict] = None) -> str:
    """Write step ``step``'s checkpoint: ``params`` the port's parameter
    tree (``DecoderLM.params()``), ``opt_state`` an SP-NGD or momentum-SGD
    state, ``controller`` a JSON-able dict. Returns the files' path
    prefix."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    np.savez(path + ".params.npz",
             **_flatten(convert.params_layout(params)))
    if opt_state is not None:
        layout = (convert.opt_state_layout if "curv" in opt_state
                  else convert.sgd_state_layout)
        np.savez(path + ".opt.npz", **_flatten(layout(opt_state)))
    if controller is not None:
        with open(path + ".ctrl.json", "w") as f:
            json.dump(controller, f)
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(str(step))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None, *, cfg,
                       device=None) -> Optional[dict]:
    """Read a checkpoint (``LATEST``'s step unless ``step``) written by
    either package, for a model of config ``cfg``: {"step", "params" (a
    ``DecoderLM`` state_dict), "opt_state" (the port's SP-NGD or SGD
    state, or None), "controller" (the dict, or None)}; None when the
    directory holds no checkpoint. Tensors go on the card unless
    ``device`` says otherwise."""
    from repro_torch.models.transformer import resolve_device
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None
    device = resolve_device(device)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    params = convert.params_from_jax(_load(path + ".params.npz"), cfg,
                                     device)
    opt_state = None
    if os.path.exists(path + ".opt.npz"):
        tree = _load(path + ".opt.npz")
        from_jax = (convert.opt_state_from_jax if "curv" in tree
                    else convert.sgd_state_from_jax)
        opt_state = from_jax(tree, cfg, device)
    controller = None
    if os.path.exists(path + ".ctrl.json"):
        with open(path + ".ctrl.json") as f:
            controller = json.load(f)
    return {"step": step, "params": params, "opt_state": opt_state,
            "controller": controller}
