"""Between the JAX package's trees (as numpy arrays) and the port's state.

The JAX package's ``DecoderLM.init`` returns a tree whose ``blocks`` leaves
are stacked on a leading ``(L,)`` axis; :func:`params_from_jax` unstacks
them into :class:`repro_torch.models.transformer.DecoderLM`'s per-layer
parameter dicts, so that both packages compute the same function::

    np_params = jax.tree.map(np.asarray, jax_model.init(key))
    model.load_state_dict(params_from_jax(np_params, cfg, "cpu"))

:func:`params_to_jax` goes back. Factor statistics keep the stacked
``{family: {key: (L, ...)}}`` layout in both packages
(:func:`stats_from_jax`, :func:`stats_to_jax`); the SP-NGD optimizer state
differs only in its velocity, a stacked params tree in JAX and a flat
``{"blocks/3/attn/wq": tensor}`` dict in the port
(:func:`opt_state_from_jax`, :func:`opt_state_to_jax`), and so does the
momentum-SGD state (:func:`sgd_state_from_jax`, :func:`sgd_state_to_jax`).
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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy array, bf16 and fp8 as ml_dtypes arrays."""
    t = t.detach().cpu()
    names = {torch.bfloat16: ("bfloat16", torch.int16, np.int16),
             torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
             torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8)}
    if t.dtype in names:
        import ml_dtypes
        name, raw, _ = names[t.dtype]
        return t.contiguous().view(raw).numpy().view(getattr(ml_dtypes, name))
    return t.contiguous().numpy()


def params_to_jax(params: dict) -> dict:
    """The port's parameter tree (``DecoderLM.params()``: ``blocks`` a list
    of per-layer dicts) -> the JAX layout (blocks stacked on (L,)), numpy
    leaves."""
    def rec(node):
        return ({k: rec(v) for k, v in node.items()} if isinstance(node, dict)
                else to_numpy(node))
    out = {k: rec(v) for k, v in params.items() if k != "blocks"}
    layers = [rec(b) for b in params["blocks"]]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)
    out["blocks"] = stack(*layers)
    return out


def stats_from_jax(np_stats: dict, device=None) -> dict:
    """{family: {key: array}} (stacked (L, ...) block families) -> torch,
    the same layout; an encoded entry ({"payload", "scale"}: fp8 history or
    a wire-format capture) keeps its dict, fp8 payload bits included."""
    def rec(node):
        return ({k: rec(v) for k, v in node.items()} if isinstance(node, dict)
                else to_torch(node, device))
    return rec(np_stats)


def stats_to_jax(stats: dict) -> dict:
    def rec(node):
        return ({k: rec(v) for k, v in node.items()} if isinstance(node, dict)
                else to_numpy(node))
    return rec(stats)


def _velocity_from_jax(np_vel: dict, cfg, device=None) -> dict:
    flat = params_from_jax(np_vel, cfg, device)
    return {k.replace(".", "/"): v for k, v in flat.items()}


def opt_state_from_jax(np_state: dict, cfg, device=None) -> dict:
    """JAX ``SPNGD.init``/step state (numpy leaves; a family's staged
    ``precond_next`` kept where ``double_buffer`` put one; no pipeline)
    -> the port's state."""
    return {"step": int(np.asarray(np_state["step"])),
            "velocity": _velocity_from_jax(np_state["velocity"], cfg,
                                           device),
            # a family's {slot: {key: array}} nests like {family: {key}}
            "curv": {fam: stats_from_jax(entry, device)
                     for fam, entry in np_state["curv"].items()}}


def sgd_state_from_jax(np_state: dict, cfg, device=None) -> dict:
    """JAX ``SGD`` state (numpy leaves) -> the port's ``SGD`` state."""
    return {"step": int(np.asarray(np_state["step"])),
            "velocity": _velocity_from_jax(np_state["velocity"], cfg,
                                           device)}


def _velocity_to_jax(velocity: dict) -> dict:
    vel: dict = {}
    for path, t in velocity.items():
        parts = path.split("/")
        node = vel
        if parts[0] == "blocks":
            layer = int(parts[1])
            node = node.setdefault("blocks", {})
            for p in parts[2:-1]:
                node = node.setdefault(p, {})
            node.setdefault(parts[-1], {})[layer] = to_numpy(t)
            continue
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = to_numpy(t)

    def stack(node):
        if isinstance(node, dict) and node and all(
                isinstance(k, int) for k in node):
            return np.stack([node[i] for i in range(len(node))])
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        return node
    return stack(vel)


def opt_state_to_jax(state: dict) -> dict:
    """The port's SP-NGD state (single or double buffer) -> the JAX layout
    (numpy leaves)."""
    return {"step": np.asarray(state["step"], np.int32),
            "velocity": _velocity_to_jax(state["velocity"]),
            "curv": {fam: stats_to_jax(entry)
                     for fam, entry in state["curv"].items()}}


def sgd_state_to_jax(state: dict) -> dict:
    """The port's ``SGD`` state -> the JAX layout (numpy leaves)."""
    return {"step": np.asarray(state["step"], np.int32),
            "velocity": _velocity_to_jax(state["velocity"])}
