"""Between the JAX package's trees (as numpy arrays) and the port's state.

The JAX package's ``DecoderLM.init`` returns a tree whose ``blocks`` leaves
are stacked on a leading ``(L,)`` axis; :func:`params_from_jax` unstacks
them into :class:`repro_torch.models.transformer.DecoderLM`'s per-layer
parameter dicts (an MoE layer's expert stacks, ``(L, E, d, f)`` in JAX,
become its ``(E, d, f)`` tensors; the velocity likewise), so that both
packages compute the same function::

    np_params = jax.tree.map(np.asarray, jax_model.init(key))
    model.load_state_dict(params_from_jax(np_params, cfg, "cpu"))

:func:`params_to_jax` goes back. The ConvNet's trees have no ``blocks``;
its conv weights (the only 4-D leaves of either model) are
``(kh, kw, cin, cout)`` in JAX and ``(cout, cin, kh, kw)`` in the port, and
every function here moves a 4-D leaf between the two (its momentum too).
Factor statistics, ``uw`` and ``uwf`` included, keep the stacked
``{family: {key: (L, ...)}}`` layout in both packages (an MoE expert
family's ``(L, E, nb, b, b)`` too; the model hands each layer its ``(E,
...)`` view)
(:func:`stats_from_jax`, :func:`stats_to_jax`); the SP-NGD optimizer state
differs in its velocity, a stacked params tree in JAX and a flat
``{"blocks/3/attn/wq": tensor}`` dict in the port, and in the refresh
pipeline's cursor and ``valid`` latches, 0-d arrays in JAX and host
``int``/``bool`` in the port (:func:`opt_state_from_jax`,
:func:`opt_state_to_jax`); so does the momentum-SGD state
(:func:`sgd_state_from_jax`, :func:`sgd_state_to_jax`).

The ``*_layout`` functions build the JAX layout with CPU tensor leaves (a
meta tensor stays on meta, so the dry run lays out a model that was never
allocated: ``launch/sharding.py`` keys its specs by this layout); the
checkpoint module writes those through :func:`tensor_bits` (bf16 and fp8 as
unsigned-integer bit views) and reads them back through
:func:`bits_tensor`, so it needs no ``ml_dtypes``. Only :func:`to_numpy`
(ml_dtypes arrays, the JAX package's own) imports it.
"""

from __future__ import annotations

import numpy as np
import torch


# the extension dtypes, by their numpy (ml_dtypes) name
EXT_DTYPES = {"bfloat16": torch.bfloat16,
              "float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}
_EXT_NAMES = {v: k for k, v in EXT_DTYPES.items()}
# the integer views that carry their bits, by element size: the torch view,
# its numpy twin, and the unsigned type the bits are stored as (torch's
# from_numpy takes no uint16)
_BITS = {1: (torch.uint8, np.uint8, np.uint8),
         2: (torch.int16, np.int16, np.uint16)}


def tensor_bits(t: torch.Tensor) -> tuple[np.ndarray, str | None]:
    """torch tensor -> (numpy array on the host, extension dtype name or
    None): bf16 and fp8 come out as their unsigned-integer bit views
    (uint16, uint8), every other dtype as itself."""
    t = t.detach().cpu().contiguous()
    name = _EXT_NAMES.get(t.dtype)
    if name is None:
        return t.numpy(), None
    view, _, stored = _BITS[t.element_size()]
    return t.view(view).numpy().view(stored), name


def bits_tensor(a: np.ndarray, name: str | None = None,
                device=None) -> torch.Tensor:
    """Inverse of :func:`tensor_bits`: a numpy array, or with ``name`` the
    bit view of that extension dtype, -> a torch tensor on ``device``."""
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    if name is None:
        return torch.from_numpy(a).to(device)
    dt = EXT_DTYPES[name]
    view, twin, _ = _BITS[dt.itemsize]
    return torch.from_numpy(a.view(twin)).view(dt).to(device)


def to_torch(a, device=None) -> torch.Tensor:
    """numpy array (bf16 and fp8 as ml_dtypes arrays) or tensor -> torch
    tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name in EXT_DTYPES:
        return bits_tensor(a.view(np.dtype(f"u{a.dtype.itemsize}")),
                           a.dtype.name, device)
    return bits_tensor(a, None, device)


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _conv_from_jax(t: torch.Tensor) -> torch.Tensor:
    """A 4-D (conv) leaf from JAX's (kh, kw, cin, cout) to torch's
    (cout, cin, kh, kw); any other leaf as it is."""
    return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t


def _conv_to_jax(t: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_conv_from_jax`, on the CPU."""
    t = _cpu(t)
    return t.permute(2, 3, 1, 0).contiguous() if t.dim() == 4 else t


def params_from_jax(np_params: dict, cfg, device=None) -> dict:
    """Return a ``state_dict`` for ``DecoderLM(cfg)`` from the JAX params
    tree (numpy leaves, blocks stacked on a leading (L,) axis), or for
    ``ConvNet(cfg)`` (no blocks; conv weights moved to torch's layout)."""
    out = {}
    for name, a in _flatten({k: v for k, v in np_params.items()
                             if k != "blocks"}):
        out[name] = _conv_from_jax(to_torch(a, device))
    for name, a in _flatten(np_params.get("blocks", {})):
        if a.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks leaf {name} has leading dim "
                             f"{a.shape[0]}, expected n_layers="
                             f"{cfg.n_layers}")
        for layer in range(cfg.n_layers):
            out[f"blocks.{layer}.{name}"] = to_torch(a[layer], device)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy array, bf16 and fp8 as ml_dtypes arrays."""
    bits, name = tensor_bits(t)
    if name is None:
        return bits
    import ml_dtypes
    return bits.view(getattr(ml_dtypes, name))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach() if t.is_meta else t.detach().cpu()


def _scalar_device(tree) -> torch.device:
    """Where the layout's 0-d ``step``/``cursor``/``valid`` go: meta beside
    meta leaves, else the CPU."""
    for v in (tree.values() if isinstance(tree, dict) else ()):
        if isinstance(v, dict):
            if v:
                return _scalar_device(v)
        elif isinstance(v, torch.Tensor):
            return torch.device("meta" if v.is_meta else "cpu")
    return torch.device("cpu")


def _stack(*xs):
    if isinstance(xs[0], dict):
        return {k: _stack(*(x[k] for x in xs)) for k in xs[0]}
    return torch.stack(xs)


def params_layout(params: dict) -> dict:
    """The port's parameter tree (``DecoderLM.params()``: ``blocks`` a list
    of per-layer dicts; or ``ConvNet.params()``) -> the JAX layout (blocks
    stacked on (L,), conv weights NHWC), CPU tensor leaves (meta on meta)."""
    out = {k: _map(_conv_to_jax, v) for k, v in params.items()
           if k != "blocks"}
    if "blocks" in params:
        out["blocks"] = _stack(*(_map(_cpu, b) for b in params["blocks"]))
    return out


def params_to_jax(params: dict) -> dict:
    """:func:`params_layout` with numpy leaves."""
    return _map(to_numpy, params_layout(params))


def stats_from_jax(np_stats: dict, device=None) -> dict:
    """{family: {key: array}} (stacked (L, ...) block families) -> torch,
    the same layout; an encoded entry ({"payload", "scale"}: fp8 history or
    a wire-format capture) keeps its dict, fp8 payload bits included."""
    return _map(lambda a: to_torch(a, device), np_stats)


def stats_to_jax(stats: dict) -> dict:
    return _map(to_numpy, stats)


def _velocity_from_jax(np_vel: dict, cfg, device=None) -> dict:
    flat = params_from_jax(np_vel, cfg, device)
    return {k.replace(".", "/"): v for k, v in flat.items()}


def opt_state_from_jax(np_state: dict, cfg, device=None) -> dict:
    """JAX ``SPNGD.init``/step state (numpy or CPU tensor leaves; a
    family's staged ``precond_next`` kept where ``double_buffer`` put one,
    the refresh pipeline's state where ``refresh_chunks`` did) -> the
    port's state."""
    state = {"step": int(np_state["step"]),
             "velocity": _velocity_from_jax(np_state["velocity"], cfg,
                                            device),
             # a family's {slot: {key: array}} nests like {family: {key}}
             "curv": {fam: stats_from_jax(entry, device)
                      for fam, entry in np_state["curv"].items()}}
    if "pipeline" in np_state:
        pipe = np_state["pipeline"]
        state["pipeline"] = {
            "cursor": int(pipe["cursor"]),
            "raw": stats_from_jax(pipe["raw"], device),
            "valid": _map(bool, pipe["valid"])}
    return state


def sgd_state_from_jax(np_state: dict, cfg, device=None) -> dict:
    """JAX ``SGD`` state (numpy or CPU tensor leaves) -> the port's ``SGD``
    state."""
    return {"step": int(np_state["step"]),
            "velocity": _velocity_from_jax(np_state["velocity"], cfg,
                                           device)}


def _velocity_layout(velocity: dict) -> dict:
    vel: dict = {}
    for path, t in velocity.items():
        parts = path.split("/")
        node = vel
        if parts[0] == "blocks":
            layer = int(parts[1])
            node = node.setdefault("blocks", {})
            for p in parts[2:-1]:
                node = node.setdefault(p, {})
            node.setdefault(parts[-1], {})[layer] = _cpu(t)
            continue
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _conv_to_jax(t)

    def stack(node):
        if isinstance(node, dict) and node and all(
                isinstance(k, int) for k in node):
            return torch.stack([node[i] for i in range(len(node))])
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        return node
    return stack(vel)


def opt_state_layout(state: dict) -> dict:
    """The port's SP-NGD state (single or double buffer, with or without
    the refresh pipeline) -> the JAX layout, CPU tensor leaves (meta on
    meta): ``step`` and the pipeline's ``cursor`` int32, its ``valid``
    latches bool, as the JAX package keeps them."""
    dev = _scalar_device(state["velocity"])
    out = {"step": torch.tensor(state["step"], dtype=torch.int32,
                                device=dev),
           "velocity": _velocity_layout(state["velocity"]),
           "curv": _map(_cpu, state["curv"])}
    if "pipeline" in state:
        pipe = state["pipeline"]
        out["pipeline"] = {
            "cursor": torch.tensor(pipe["cursor"], dtype=torch.int32,
                                   device=dev),
            "raw": _map(_cpu, pipe["raw"]),
            "valid": _map(lambda v: torch.tensor(bool(v), device=dev),
                          pipe["valid"])}
    return out


def opt_state_to_jax(state: dict) -> dict:
    """:func:`opt_state_layout` with numpy leaves."""
    return _map(to_numpy, opt_state_layout(state))


def sgd_state_layout(state: dict) -> dict:
    """The port's ``SGD`` state -> the JAX layout, CPU tensor leaves."""
    return {"step": torch.tensor(state["step"], dtype=torch.int32),
            "velocity": _velocity_layout(state["velocity"])}


def sgd_state_to_jax(state: dict) -> dict:
    """:func:`sgd_state_layout` with numpy leaves."""
    return _map(to_numpy, sgd_state_layout(state))
