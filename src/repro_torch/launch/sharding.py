"""Sharding policy of the dry run (counterpart of
``repro/launch/sharding.py``): where every parameter, batch, cache and
factor array of a step would live on the (pod, data, model) mesh.

The policy is ``repro``'s, rule for rule (``DESIGN.md`` section 7):

* batch dims shard over ("pod", "data");
* tensor-parallel: head/ff output dims over "model" (column-parallel up,
  row-parallel down);
* large archs (d_model >= ``fsdp_threshold``) also shard the weight input
  dim over "data" (FSDP-style 2-D sharding);
* K-FAC factor families shard their layer axis over the mesh axes
  flattened (the paper's Stages 3-4);
* optimizer state inherits the same specs.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name or
a tuple of axis names (``repro``'s ``PartitionSpec`` padded with ``None``
to the tensor's rank). A mesh is anything with ``axis_names`` and
``shape`` ({axis: size}): :class:`ShapeMesh` holds only those (the dry
run's ``16x16`` and ``2x16x16`` meshes need no devices), and the Stage-3
reducer takes it too (``mesh_dim_names``, ``mesh``). :func:`shard_shape`
gives a device's share of a tensor, :func:`placements` the DTensor
``Shard``/``Replicate`` list for a real ``DeviceMesh``.

Specs are keyed by ``repro``'s parameter paths: the port's trees are laid
out by ``convert.params_layout`` and ``convert.opt_state_layout`` (blocks
stacked on (L,), conv weights NHWC), which leave meta tensors on meta.

Eager PyTorch has no sharding constraint: :func:`factor_sharding_hook`
returns the spec ``repro``'s hook would constrain a factor array to.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch

Spec = tuple


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh that holds axis names and sizes only."""
    dims: tuple
    names: tuple

    @property
    def axis_names(self) -> tuple:
        return self.names

    @property
    def mesh_dim_names(self) -> tuple:
        return self.names

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.dims))

    @property
    def mesh(self) -> torch.Tensor:
        """The rank grid's shape, as ``DeviceMesh.mesh`` holds it."""
        return torch.empty(self.dims, dtype=torch.int64, device="meta")

    def size(self) -> int:
        return math.prod(self.dims)


def make_mesh(name: str) -> ShapeMesh:
    """``"16x16"`` -> ("data", "model"); ``"2x16x16"`` -> ("pod", "data",
    "model"): ``repro``'s production meshes as logical shapes."""
    dims = tuple(int(d) for d in name.split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]
    return ShapeMesh(dims, names)


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _entry(axes: tuple):
    """A spec entry of mesh axes: one axis by its name, as ``PartitionSpec``
    normalizes it."""
    return axes[0] if len(axes) == 1 else axes


def _mesh_size(mesh, axes) -> int:
    n = 1
    for a in _axes(axes):
        n *= mesh.shape[a]
    return n


def shard_shape(spec: Spec, shape, mesh) -> tuple:
    """One device's share of a tensor of ``shape`` under ``spec``."""
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d if a is None else -(-d // _mesh_size(mesh, a))
                 for d, a in zip(shape, parts))


def shard_bytes(spec: Spec, t: torch.Tensor, mesh) -> int:
    return math.prod(shard_shape(spec, t.shape, mesh)) * t.element_size()


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on a ``DeviceMesh`` (or a
    :class:`ShapeMesh`): per mesh dim, ``Shard(tensor dim)`` where the
    spec names that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(getattr(mesh, "mesh_dim_names", None) or mesh.axis_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in _axes(entry):
            out[names.index(a)] = Shard(dim)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flat_paths(tree: dict, prefix: str = "") -> dict:
    """{"/"-joined path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_paths(v, p + "/"))
        else:
            out[p] = v
    return out


def _unflat(flat: dict, like: dict, prefix: str = "") -> dict:
    return {k: (_unflat(flat, v, f"{prefix}{k}/") if isinstance(v, dict)
                else flat[f"{prefix}{k}"]) for k, v in like.items()}


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# parameter specs by path pattern
# ---------------------------------------------------------------------------

def param_pspec(path: str, ndim: int, cfg, *, fsdp: bool) -> Spec:
    """path: '/'-joined parameter path in repro's layout; the leading (L,)
    axis is handled by ndim."""
    lead = (None,) * (ndim - 2)       # (L,) for blocks, () for top-level
    d_in_axis = "data" if fsdp else None

    def col():                        # (..., d_in, d_out): split d_out
        return (*lead, d_in_axis, "model")

    def row():                        # (..., d_in, d_out): split d_in
        return (*lead, "model", d_in_axis)

    p = path
    if re.search(r"embed/table$", p):
        return (d_in_axis, "model")
    if re.search(r"head/w$", p):
        return (d_in_axis, "model")
    if re.search(r"proj/w$", p):
        return (None, "model")
    if re.search(r"attn/(wq|wk|wv)$", p):
        return col()
    if re.search(r"attn/wo$", p):
        return row()
    if re.search(r"attn/(bq|bk|bv)$", p):
        return (*(None,) * (ndim - 1), "model")
    if re.search(r"mlp/(up|gate)$|moe/sh_(up|gate)$|cm/wk$", p):
        return col()
    if re.search(r"mlp/down$|moe/sh_down$|cm/wv$", p):
        return row()
    if re.search(r"moe/router$", p):
        return (*lead, None, None)
    if re.search(r"moe/we_(up|gate)$", p):   # (L, E, d, ff)
        return (None, None, d_in_axis, "model")
    if re.search(r"moe/we_down$", p):        # (L, E, ff, d)
        return (None, None, "model", d_in_axis)
    if re.search(r"ssm/in_proj$", p):
        return col()
    if re.search(r"ssm/(xdb|out_proj)$", p):
        return row()
    if re.search(r"ssm/dt_proj$", p):
        return col()
    if re.search(r"ssm/(conv_w|dt_bias|d_skip)$", p):
        return (*(None,) * (ndim - 1), "model")
    if re.search(r"ssm/a_log$", p):
        return (*(None,) * (ndim - 2), "model", None)
    if re.search(r"tm/(wr|wk|wv|wg)$|cm/wr$", p):
        return col()
    if re.search(r"tm/wo$", p):
        return row()
    if re.search(r"tm/w_lora_a$", p):
        return (*lead, None, None)
    if re.search(r"tm/w_lora_b$", p):
        return (*lead, None, None)
    return ()                         # norms, mu vectors, small leaves


def _pad(spec: Spec, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _sanitize(spec: Spec, shape, mesh) -> Spec:
    """Drop axis assignments that don't divide the dimension (input
    shardings require exact division; e.g. vocab=32001 can't go 16-way)."""
    out = []
    for dim, axes in zip(shape, _pad(spec, len(shape))):
        if axes is None:
            out.append(None)
            continue
        size = _mesh_size(mesh, axes)
        out.append(axes if dim % size == 0 and dim >= size else None)
    return tuple(out)


def params_pspecs(params_shape: dict, cfg, *, mesh=None,
                  fsdp_threshold: int = 6144) -> dict:
    """Specs matching a params tree in repro's layout
    (``convert.params_layout``)."""
    fsdp = cfg.d_model >= fsdp_threshold
    flat = flat_paths(params_shape)
    out = {}
    for p, v in flat.items():
        spec = _pad(param_pspec(p, v.dim(), cfg, fsdp=fsdp), v.dim())
        if mesh is not None:
            spec = _sanitize(spec, v.shape, mesh)
        out[p] = spec
    return _unflat(out, params_shape)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def _assign(shape, mesh, preferences) -> Spec:
    """Assign each mesh-axis group to the first listed dimension it divides
    evenly. ``preferences``: [(axes, [dim, ...]), ...] in priority order
    (long_500k has batch 1, so the data axes land on the cache's sequence
    dim instead)."""
    spec = [None] * len(shape)
    for axes, dims in preferences:
        size = _mesh_size(mesh, axes)
        for d in dims:
            if spec[d] is None and shape[d] % size == 0 and shape[d] >= size:
                spec[d] = _entry(axes)
                break
    return tuple(spec)


def batch_pspecs(batch_shape: dict, mesh) -> dict:
    dp = dp_axes(mesh)
    out = {}
    for k, v in batch_shape.items():
        if k == "cache":
            out[k] = cache_pspecs(v, mesh)
        elif v.dim() >= 2:
            # (B, S, ...): batch over data, else sequence over data
            out[k] = _assign(v.shape, mesh, [(dp, [0, 1])])
        elif v.dim() == 1:
            out[k] = _assign(v.shape, mesh, [(dp, [0])])
        else:
            out[k] = ()
    return out


def cache_pspecs(cache_shape: dict, mesh) -> dict:
    """KV cache (L, B, M, KV, hd): batch over data + heads over model when
    divisible; otherwise the sequence dim M absorbs the axes."""
    dp = dp_axes(mesh)
    out = {}
    for k, v in cache_shape.items():
        s = v.shape
        if k in ("k", "v"):                   # (L, B, M, KV, hd)
            out[k] = _assign(s, mesh, [(dp, [1, 2]), (("model",), [3, 2, 4])])
        elif k == "ssm_h":                    # (L, B, di, N)
            out[k] = _assign(s, mesh, [(dp, [1, 2]), (("model",), [2])])
        elif k == "conv":                     # (L, B, K, di)
            out[k] = _assign(s, mesh, [(dp, [1, 3]), (("model",), [3])])
        elif k == "wkv":                      # (L, B, h, hd, hd)
            out[k] = _assign(s, mesh, [(dp, [1, 2]), (("model",), [2])])
        elif k in ("tm_x", "cm_x"):           # (L, B, 1, d)
            out[k] = _assign(s, mesh, [(dp, [1, 3]), (("model",), [3])])
        elif k == "len":
            out[k] = ()
        else:
            out[k] = (None,) * len(s)
    return out


# ---------------------------------------------------------------------------
# K-FAC factor sharding (the Stage 3-4 scatter)
# ---------------------------------------------------------------------------

def _lead_axes(dim: int, mesh, exact: bool = False) -> tuple:
    """Largest prefix of mesh axes whose total shard count fits ``dim``;
    with ``exact`` the product must also divide ``dim``."""
    chosen = []
    prod = 1
    for a in mesh.axis_names:
        nxt = prod * mesh.shape[a]
        if nxt <= dim and (not exact or dim % nxt == 0):
            chosen.append(a)
            prod = nxt
    return tuple(chosen)


def factor_sharding_hook(mesh):
    """hook(family, stat_key, tensor) -> the spec repro's hook constrains
    a factor array to (its layer axis over the mesh axes flattened, for
    block families), or None where it leaves the array as it is."""

    def hook(fam, key, x):
        if x.dim() < 1 or not fam.startswith("blk/"):
            return None
        axes = _lead_axes(x.shape[0], mesh)
        if not axes:
            return None
        return (_entry(axes),) + (None,) * (x.dim() - 1)

    return hook


def opt_state_pspecs(opt_state_shape: dict, params_specs: dict, mesh) -> dict:
    """velocity: like params; curvature: layer axis over the mesh. Takes
    the state in repro's layout (``convert.opt_state_layout``)."""

    def curv_spec(x):
        if x.dim() >= 1:
            axes = _lead_axes(x.shape[0], mesh, exact=True)
            if axes:
                return (_entry(axes),) + (None,) * (x.dim() - 1)
        return (None,) * x.dim()

    out = {"step": (),
           "velocity": params_specs,
           "curv": _map(curv_spec, opt_state_shape["curv"])}
    if "pipeline" in opt_state_shape:
        out["pipeline"] = _map(curv_spec, opt_state_shape["pipeline"])
    return out
