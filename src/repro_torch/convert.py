"""JAX params tree (as numpy arrays) -> the port's module state.

The JAX package's ``DecoderLM.init`` returns a tree whose ``blocks`` leaves
are stacked on a leading ``(L,)`` axis; :func:`params_from_jax` unstacks
them into :class:`repro_torch.models.transformer.DecoderLM`'s per-layer
parameter dicts, so that both packages compute the same function::

    np_params = jax.tree.map(np.asarray, jax_model.init(key))
    model.load_state_dict(params_from_jax(np_params, cfg, "cpu"))
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(a, device=None) -> torch.Tensor:
    """numpy array -> torch tensor, bf16 and fp8 (ml_dtypes) included."""
    a = np.asarray(a)
    name = a.dtype.name
    bitcast = {"bfloat16": (np.int16, torch.bfloat16),
               "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
               "float8_e5m2": (np.uint8, torch.float8_e5m2)}
    if name in bitcast:
        raw, dt = bitcast[name]
        bits = torch.from_numpy(np.array(a).view(raw))
        return bits.view(dt).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def params_from_jax(np_params: dict, cfg, device=None) -> dict:
    """Return a ``state_dict`` for ``DecoderLM(cfg)`` from the JAX params
    tree (numpy leaves, blocks stacked on a leading (L,) axis)."""
    out = {}
    for name, a in _flatten({k: v for k, v in np_params.items()
                             if k != "blocks"}):
        out[name] = to_torch(a, device)
    for name, a in _flatten(np_params["blocks"]):
        if a.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks leaf {name} has leading dim "
                             f"{a.shape[0]}, expected n_layers="
                             f"{cfg.n_layers}")
        for layer in range(cfg.n_layers):
            out[f"blocks.{layer}.{name}"] = to_torch(a[layer], device)
    return out
