"""Stage-3 communication over ``torch.distributed``: the factor reduce
strategies (counterpart of ``repro/comm/comm.py``).

The paper's Algorithm 3 makes Stage 3 ONE ReduceScatterV per factor family
per refresh. :class:`FactorReducer` owns every decision about it -- which
mesh axes a statistic scatters over, the wire layout, the reduce itself --
and :meth:`FactorReducer.gather_stat` owns Stage 4's return leg. The host
side (config, scatter decisions, the byte ledger) is ``repro``'s shape
arithmetic, integer for integer; the collectives run eagerly on process
groups built from a ``torch.distributed`` ``DeviceMesh``:

``dense``
    ``reduce_scatter_tensor`` of the raw f32 blocked array (``repro``'s
    ``psum_scatter(tiled=True)``): group index ``i`` keeps chunk ``i`` of
    the leading dim.
``ring``
    Symmetric blocked factors sym-pack their trailing ``(b, b)`` axes to
    ``t = b(b+1)/2`` rows first, so the wire moves the triangle only. With
    an f32 wire the ring is one ``reduce_scatter_tensor`` over the packed
    rows (the same bytes; ``repro`` takes the same shortcut).
``ring_fp8``
    The hop loop of ``repro``'s ring, order for order: each hop's partial
    sum is quantized per packed row (``dispatch.ring_hop_pack``; the
    ``quant_rows`` kernel on the card), travels as fp8 payload + f32 scale
    by ``batch_isend_irecv`` and is dequantized on arrival
    (``ring_hop_unpack``; ``dequant_rows``) before the local chunk joins in
    f32. Non-symmetric statistics stay on the f32 ring.
``hier``
    Two levels over ``CommConfig.devices_per_host`` (D = gcd with the group
    size): a chunk permutation, an f32 ``reduce_scatter_tensor`` inside
    each host group, then D disjoint fp8 rings over host peers. Chunk
    ownership ends as ``dense``'s.
``fused``
    Statistics captured in the wire format (``{"payload", "scale"}`` from
    ``factor_sum_wire``) cross by ``all_to_all_single`` (payload and
    scales), then dequantize, sum over sources in f32 and unpack. No
    ``ring_hop_pack`` runs. Non-wire statistics take the dense path.

fp8 tensors cross every collective as ``.view(torch.uint8)`` (gloo refuses
fp8 dtypes; NCCL takes the same path, so there is one), bool tensors as
uint8 too. A CUDA tensor under a gloo group raises (gloo would stage it
through the host) and a CPU tensor under NCCL raises.

A statistic whose leading dim no data-axis subset divides is summed by a
plain ``all_reduce`` over the data axes (full replication): the reducer
tallies those at construction and warns once. :meth:`FactorReducer.assemble`
all-gathers the scattered statistics back to their full leading dim, which
is what ``repro``'s shard_map ``out_specs`` hand its optimizer; it is not
part of ``repro``'s ledger.

The byte ledger convention is ``repro``'s: the logical payload one full
reduction moves per device, the ring's (p-1)/p left out; ``hier`` itemizes
its two levels.

Process groups: every rank must create the same groups in the same order,
so a reducer creates all of its groups (over every data-axis subset it can
scatter over, and ``hier``'s host groups) at construction, when a process
group is initialized. Group index ``i`` is the row-major position over the
axes, as in ``repro``; the mesh's ranks must be in row-major order (what
``init_device_mesh`` gives).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Callable, Optional

import torch

logger = logging.getLogger(__name__)

STRATEGIES = ("dense", "ring", "ring_fp8", "hier", "fused")
WIRE_DTYPES = ("f32", "fp8_e4m3", "fp8_e5m2")

# strategies whose inter-host / hop wire defaults to fp8 (make_comm_config)
_FP8_DEFAULT_STRATEGIES = ("ring_fp8", "hier", "fused")


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Stage-3 collective configuration (one per training run)."""
    strategy: str = "dense"       # one of STRATEGIES
    wire_dtype: str = "f32"       # "f32" | "fp8_e4m3" | "fp8_e5m2"
    fp8_scale_mode: str = "fp32"  # per-row scale mode of the fp8 hops
    backend: Optional[str] = None  # kernel backend of the hop codec
    # host-topology model for "hier": local devices per host. None defaults
    # to torchrun's LOCAL_WORLD_SIZE, or the world size without it
    devices_per_host: Optional[int] = None

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown comm strategy {self.strategy!r}; "
                             f"expected {STRATEGIES}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown wire dtype {self.wire_dtype!r}; "
                             f"expected {WIRE_DTYPES}")
        if self.strategy in ("ring_fp8", "fused") \
                and self.wire_dtype == "f32":
            raise ValueError(f"{self.strategy} needs an fp8 wire_dtype "
                             "(fp8_e4m3 | fp8_e5m2); use make_comm_config "
                             "to get the e4m3 default")
        if self.strategy in ("dense", "ring") and self.wire_dtype != "f32":
            raise ValueError(f"strategy {self.strategy!r} moves f32 on the "
                             f"wire; --wire-dtype {self.wire_dtype} only "
                             "applies to ring_fp8 / hier / fused")
        if self.devices_per_host is not None and self.devices_per_host < 1:
            raise ValueError("devices_per_host must be >= 1 (or None to "
                             "default from LOCAL_WORLD_SIZE)")

    @property
    def wire_fmt(self) -> Optional[str]:
        """fp8 format key of the hop codec ("e4m3"/"e5m2"), None for f32."""
        if self.wire_dtype.startswith("fp8_"):
            return self.wire_dtype[4:]
        return None

    def local_devices(self) -> int:
        """Resolved devices-per-host (the "hier" level-1 group width):
        ``devices_per_host``, else torchrun's ``LOCAL_WORLD_SIZE``, else
        the world size (one host), else 1."""
        if self.devices_per_host is not None:
            return self.devices_per_host
        local = os.environ.get("LOCAL_WORLD_SIZE")
        if local:
            return int(local)
        import torch.distributed as dist
        return dist.get_world_size() if dist.is_initialized() else 1


def make_comm_config(strategy: str, wire_dtype: Optional[str] = None,
                     fp8_scale_mode: str = "fp32",
                     backend: Optional[str] = None,
                     devices_per_host: Optional[int] = None) -> CommConfig:
    """CLI-facing constructor: fills the per-strategy default wire dtype
    (f32 for dense/ring, e4m3 for ring_fp8/hier/fused) when ``wire_dtype``
    is None."""
    if wire_dtype is None:
        wire_dtype = ("fp8_e4m3" if strategy in _FP8_DEFAULT_STRATEGIES
                      else "f32")
    return CommConfig(strategy=strategy, wire_dtype=wire_dtype,
                      fp8_scale_mode=fp8_scale_mode, backend=backend,
                      devices_per_host=devices_per_host)


def hier_split(cfg: CommConfig, group_size: int) -> tuple[int, int]:
    """(D, H): intra-host width and host count for a device group of
    ``group_size`` under ``cfg``'s topology model. D divides the group
    evenly (gcd with the configured local width); D*H == group_size."""
    d = math.gcd(max(cfg.local_devices(), 1), group_size)
    return d, group_size // d


def _leaf_shape(leaf) -> tuple:
    """Template-leaf shape in DENSE terms: wire-format dicts report the
    shape their payload decodes to."""
    from repro_torch.quant import quant
    if quant.is_wire(leaf):
        return quant.wire_dense_shape(leaf)
    return tuple(leaf.shape)


def _is_sym(shape: tuple, symmetric: bool) -> bool:
    return symmetric and len(shape) >= 2 and shape[-1] == shape[-2]


# ---------------------------------------------------------------------------
# Wire-volume accounting (the IntervalController's wire-bytes columns)
# ---------------------------------------------------------------------------

def template_wire_bytes(template: dict, sym_fn: Callable[[str, str], bool],
                        cfg: CommConfig,
                        scattered_fn: Optional[Callable] = None,
                        group_size: Optional[int] = None) -> dict[str, int]:
    """Per-statistic wire bytes of a whole ``fstats`` template: mesh-less
    (everything scatters) unless ``scattered_fn(name) -> bool`` says
    otherwise; ``group_size`` models the scatter group for hier's split."""
    out = {}
    for fam, stats in template.items():
        for key, leaf in stats.items():
            name = f"{fam}.{key}"
            scattered = scattered_fn(name) if scattered_fn else True
            out[name] = wire_stat_bytes(_leaf_shape(leaf), sym_fn(fam, key),
                                        cfg, scattered=scattered,
                                        group_size=group_size)
    return out


def template_wire_level_bytes(template: dict,
                              sym_fn: Callable[[str, str], bool],
                              cfg: CommConfig,
                              scattered_fn: Optional[Callable] = None,
                              group_size: Optional[int] = None
                              ) -> dict[str, tuple[int, int]]:
    """Per-statistic (intra-host, inter-host) wire bytes of a whole
    template, with :func:`template_wire_bytes`' assumptions."""
    out = {}
    for fam, stats in template.items():
        for key, leaf in stats.items():
            name = f"{fam}.{key}"
            scattered = scattered_fn(name) if scattered_fn else True
            out[name] = wire_stat_level_bytes(
                _leaf_shape(leaf), sym_fn(fam, key), cfg,
                scattered=scattered, group_size=group_size)
    return out


def wire_stat_bytes(shape: tuple, symmetric: bool, cfg: CommConfig,
                    scattered: bool = True,
                    group_size: Optional[int] = None) -> int:
    """Bytes one full Stage-3 reduction of this statistic moves per device:
    ``dense`` (and any replication fallback) the raw blocked f32 array;
    ``ring`` the sym-packed f32 triangle of a symmetric factor; ``ring_fp8``
    and ``fused`` the fp8 payload + one f32 scale per packed row; ``hier``
    the sum of its two levels (:func:`wire_stat_level_bytes`)."""
    from repro_torch.core.stale import sym_packed_bytes
    from repro_torch.quant import quant
    dense = math.prod(shape) * 4
    if cfg.strategy == "dense" or not scattered:
        return dense
    if cfg.strategy == "hier":
        intra, inter = wire_stat_level_bytes(shape, symmetric, cfg,
                                             scattered=scattered,
                                             group_size=group_size)
        return intra + inter
    if not _is_sym(shape, symmetric):
        return dense
    if cfg.strategy == "ring":
        return sym_packed_bytes(shape, dtype_bytes=4)
    return quant.encoded_nbytes(shape, symmetric=True)


def gather_stat_bytes(shape: tuple, symmetric: bool,
                      scattered: bool = True) -> int:
    """Bytes one Stage-4 preconditioner all-gather moves per device:
    sym-packed f32 triangles for symmetric blocks, dense f32 otherwise,
    never quantized; 0 for a replicated statistic (nothing gathers)."""
    from repro_torch.core.stale import sym_packed_bytes
    if not scattered:
        return 0
    if _is_sym(shape, symmetric):
        return sym_packed_bytes(shape, dtype_bytes=4)
    return math.prod(shape) * 4


def template_gather_bytes(template: dict,
                          sym_fn: Callable[[str, str], bool],
                          scattered_fn: Optional[Callable] = None
                          ) -> dict[str, int]:
    """Per-statistic Stage-4 gather bytes of a whole template: only the
    full-kind "a"/"g" factors gather; every other statistic prices 0."""
    out = {}
    for fam, stats in template.items():
        for key, leaf in stats.items():
            name = f"{fam}.{key}"
            if key not in ("a", "g") or not sym_fn(fam, key):
                out[name] = 0
                continue
            scattered = scattered_fn(name) if scattered_fn else True
            out[name] = gather_stat_bytes(_leaf_shape(leaf), True,
                                          scattered=scattered)
    return out


def wire_stat_level_bytes(shape: tuple, symmetric: bool, cfg: CommConfig,
                          scattered: bool = True,
                          group_size: Optional[int] = None
                          ) -> tuple[int, int]:
    """(intra-host, inter-host) wire bytes of one Stage-3 reduction. Only
    ``hier`` splits; flat strategies return ``(0, 0)``. A replication
    fallback bills its dense f32 all-reduce to the inter-host column. Level
    1 moves the full (sym-packed) f32 array across the D-device host group,
    level 2 each device's 1/D slice around the H-host ring in the wire
    dtype."""
    from repro_torch.core.stale import sym_packed_bytes
    from repro_torch.quant import quant
    if cfg.strategy != "hier":
        return (0, 0)
    dense = math.prod(shape) * 4
    if not scattered:
        return (0, dense)
    if group_size is None:
        group_size = cfg.local_devices()
    d, h = hier_split(cfg, max(group_size, 1))
    if not _is_sym(shape, symmetric):
        return (dense if d > 1 else 0, dense // d if h > 1 else 0)
    packed = sym_packed_bytes(shape, dtype_bytes=4)
    intra = packed if d > 1 else 0
    if h <= 1:
        return (intra, 0)
    if cfg.wire_fmt is not None:
        return (intra, quant.encoded_nbytes(shape, symmetric=True) // d)
    return (intra, packed // d)


# ---------------------------------------------------------------------------
# Process groups and the collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Group:
    """One process group as this rank sees it: ``ranks`` the global ranks
    in group-index order, ``index`` this rank's position."""
    pg: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def _axis_rows(mesh, axes: tuple) -> list[list[int]]:
    """Every group that spans ``axes`` (the other axes fixed), as global
    ranks in group-index order (row-major over ``axes``), enumerated in
    the same order on every rank."""
    names = list(mesh.mesh_dim_names)
    order = ([names.index(a) for a in names if a not in axes]
             + [names.index(a) for a in axes])
    p = math.prod(mesh.mesh.shape[names.index(a)] for a in axes)
    rows = mesh.mesh.permute(order).reshape(-1, p).tolist()
    for row in rows:
        if row != sorted(row):
            raise ValueError(f"mesh ranks must be row-major (as "
                             f"init_device_mesh lays them out); the group "
                             f"over {axes} is {row}")
    return rows


def _new_groups(rows: list[list[int]], me: int) -> Optional[_Group]:
    """``new_group`` for every row, in order (every rank makes the same
    calls); returns this rank's, or None when it is in none."""
    import torch.distributed as dist
    mine = None
    for row in rows:
        pg = dist.new_group(row)
        if me in row:
            mine = _Group(pg, tuple(row), row.index(me))
    return mine


def _check_device(t: torch.Tensor, g: _Group) -> None:
    """No hidden host staging: gloo takes CPU tensors, NCCL CUDA ones."""
    import torch.distributed as dist
    backend = dist.get_backend(g.pg)
    if backend == "gloo" and t.is_cuda:
        raise ValueError("a CUDA tensor under a gloo process group: gloo "
                         "would stage it through the host; use NCCL on the "
                         "card")
    if backend == "nccl" and not t.is_cuda:
        raise ValueError(f"a tensor on {t.device} under an NCCL process "
                         "group: NCCL moves CUDA tensors only")


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as the collectives see it: 1-byte dtypes (fp8, bool) as
    uint8, contiguous."""
    t = t.contiguous()
    if t.dtype.itemsize == 1 and t.dtype not in (torch.uint8, torch.int8):
        return t.view(torch.uint8)
    return t


def all_reduce(t: torch.Tensor, g: _Group) -> torch.Tensor:
    """Sum over the group IN PLACE (``psum``); ``t`` must be a contiguous
    tensor the caller owns. Returns it."""
    import torch.distributed as dist
    _check_device(t, g)
    dist.all_reduce(t, group=g.pg)
    return t


def reduce_scatter(t: torch.Tensor, g: _Group) -> torch.Tensor:
    """Sum over the group, chunk ``index`` of dim 0 kept
    (``psum_scatter(tiled=True)``)."""
    import torch.distributed as dist
    _check_device(t, g)
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // g.size,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, group=g.pg)
    return out


def all_gather(t: torch.Tensor, g: _Group) -> torch.Tensor:
    """Concatenate the members' tensors along dim 0 in group-index order
    (``all_gather(tiled=True)``)."""
    import torch.distributed as dist
    _check_device(t, g)
    w = _wire(t)
    out = w.new_empty((w.shape[0] * g.size,) + tuple(w.shape[1:]))
    dist.all_gather_into_tensor(out, w, group=g.pg)
    return out.view(t.dtype) if out.dtype != t.dtype else out


def all_to_all(t: torch.Tensor, g: _Group) -> torch.Tensor:
    """Chunk ``j`` of dim 0 to member ``j``; member ``j``'s chunk lands at
    position ``j`` (``all_to_all(tiled=True)``)."""
    import torch.distributed as dist
    _check_device(t, g)
    w = _wire(t)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=g.pg)
    return out.view(t.dtype) if out.dtype != t.dtype else out


def _exchange(sends: list[torch.Tensor], dst: int, src: int, g: _Group
              ) -> list[torch.Tensor]:
    """One ring hop (``ppermute``): send each tensor to global rank
    ``dst`` and receive the same shapes from ``src``."""
    import torch.distributed as dist
    ops, recvs = [], []
    for t in sends:
        _check_device(t, g)
        w = _wire(t)
        r = torch.empty_like(w)
        ops.append(dist.P2POp(dist.isend, w, dst, group=g.pg))
        ops.append(dist.P2POp(dist.irecv, r, src, group=g.pg))
        recvs.append(r.view(t.dtype) if r.dtype != t.dtype else r)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


def _ring_reduce_scatter(v: torch.Tensor, g: _Group, p: int, *,
                         fmt: Optional[str], scale_mode: str,
                         backend: Optional[str], index: int, dst: int,
                         src: int, shortcut: bool = True) -> torch.Tensor:
    """p-1-hop ring reduce-scatter along dim 0 (divisible by ``p``), in
    ``repro``'s order: ring position ``index`` seeds with its chunk
    ``(index - 1) mod p``, sends to global rank ``dst``, receives from
    ``src``, and at hop ``s`` adds its chunk ``(index + 2p - 2 - s) mod p``
    to what arrived, ending with chunk ``index`` fully reduced. With
    ``fmt`` every hop's partial sum travels as fp8 payload + per-row f32
    scale; the accumulator stays f32. An f32 wire with ``shortcut`` is one
    ``reduce_scatter_tensor`` (the same bytes); ``hier``'s sub-rings keep
    the hop loop."""
    from repro_torch.kernels import dispatch
    if fmt is None and shortcut:
        return reduce_scatter(v, g)
    c = v.shape[0] // p

    def chunk(k):
        return v[k * c:(k + 1) * c]

    acc = chunk((index + p - 1) % p)
    for s in range(p - 1):
        if fmt is not None:
            payload, scale = dispatch.ring_hop_pack(
                acc, fmt=fmt, scale_mode=scale_mode, backend=backend)
            payload, scale = _exchange([payload, scale], dst, src, g)
            acc = dispatch.ring_hop_unpack(payload, scale, backend=backend)
        else:
            acc, = _exchange([acc], dst, src, g)
        acc = acc + chunk((index + 2 * p - 2 - s) % p)
    return acc


# ---------------------------------------------------------------------------
# The reducer
# ---------------------------------------------------------------------------

class FactorReducer:
    """Owns every Stage-3 decision for one (mesh, manual_axes, CommConfig).

    ``mesh`` is a ``torch.distributed`` ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and a ``mesh`` tensor of global ranks). The scatter
    decision per statistic is shape arithmetic over the ``fstats``
    template, made at construction: the replication tally, the ledger and
    :meth:`assemble` read it. The collectives (:meth:`psum`,
    :meth:`reduce`, :meth:`gather_stat`, :meth:`assemble`) need an
    initialized process group; every rank of the mesh calls them with the
    same statistics in the same order.
    """

    def __init__(self, mesh, *, manual_axes: str = "auto",
                 comm: Optional[CommConfig] = None,
                 template: Optional[dict] = None,
                 sym_fn: Optional[Callable[[str, str], bool]] = None):
        self.mesh = mesh
        self.comm = comm or CommConfig()
        names = tuple(mesh.mesh_dim_names)
        self._size = dict(zip(names, mesh.mesh.shape))
        # "all": every mesh axis is a data axis. "auto"/"dp": the data
        # axes only; ranks that differ in a "model" index hold replicas
        # (the port has no tensor parallelism)
        if manual_axes == "all":
            self.dp = names
        else:
            self.dp = tuple(a for a in ("pod", "data") if a in names)
        self.ndev = math.prod(self._size[a] for a in self.dp)
        self.sym_fn = sym_fn or (lambda fam, key: False)
        self.template = template
        self._decisions: dict[str, tuple] = {}
        self.replicated: list[str] = []
        if template is not None:
            for fam, stats in template.items():
                for key, leaf in stats.items():
                    shape = _leaf_shape(leaf)
                    axes = (self.scatter_axes(shape[0])
                            if len(shape) else ())
                    self._decisions[f"{fam}.{key}"] = axes
                    if len(shape) and not axes:
                        self.replicated.append(f"{fam}.{key}")
            if self.replicated and self.ndev > 1:
                logger.warning(
                    "Stage-3: %d/%d statistics cannot scatter over %s "
                    "(leading dim not divisible) and fall back to fully "
                    "replicated all_reduce: %s", len(self.replicated),
                    len(self._decisions), self.dp,
                    ", ".join(sorted(self.replicated)))
        self._groups: dict[tuple, _Group] = {}
        self._hosts: dict[tuple, _Group] = {}
        import torch.distributed as dist
        if dist.is_initialized():
            self._make_groups(dist.get_rank())

    def _make_groups(self, me: int) -> None:
        """Every process group this reducer can use, in one fixed order:
        the data axes, ``("data",)`` when it is a proper subset, and the
        rest of the data axes beside each; with ``hier`` the host groups of
        each scatter group."""
        scatter = [self.dp]
        if "data" in self.dp and self.dp != ("data",):
            scatter.append(("data",))
        wanted = list(scatter)
        for axes in scatter:
            rest = tuple(a for a in self.dp if a not in axes)
            if rest and rest not in wanted:
                wanted.append(rest)
        for axes in wanted:
            self._groups[axes] = _new_groups(_axis_rows(self.mesh, axes), me)
        if self.comm.strategy != "hier":
            return
        for axes in scatter:
            p = self.group_size(axes)
            d, h = hier_split(self.comm, p)
            if d > 1 and h > 1:
                rows = [row[h0 * d:(h0 + 1) * d]
                        for row in _axis_rows(self.mesh, axes)
                        for h0 in range(h)]
                self._hosts[axes] = _new_groups(rows, me)

    # ---- decisions (host-side, shape-static) ----

    def scatter_axes(self, dim: int) -> tuple:
        """Largest subset of the data axes whose size divides ``dim``."""
        full = self.ndev
        if full and dim % full == 0 and dim >= full:
            return self.dp
        if "data" in self.dp and dim % self._size["data"] == 0 \
                and dim >= self._size["data"]:
            return ("data",)
        return ()

    def group_size(self, axes: tuple) -> int:
        """Number of devices in the scatter group ``axes`` spans."""
        return math.prod(self._size[a] for a in axes)

    def group(self, axes: tuple) -> _Group:
        """This rank's process group over ``axes``."""
        if axes not in self._groups:
            raise RuntimeError(f"no process group over {axes}: the reducer "
                               "was built before torch.distributed was "
                               "initialized")
        return self._groups[axes]

    def scatter_report(self) -> dict:
        """Host-side tally for IntervalController.record_comm / logging."""
        report = {
            "strategy": self.comm.strategy,
            "wire_dtype": self.comm.wire_dtype,
            "dp_axes": list(self.dp),
            "n_stats": len(self._decisions),
            "n_replicated": len(self.replicated),
            "replicated_stats": sorted(self.replicated),
        }
        if self.comm.strategy == "hier":
            d, h = hier_split(self.comm, self.ndev)
            report["hier_topology"] = {"devices_per_host": d, "hosts": h}
        return report

    def _template_walk(self, fn: Callable) -> dict:
        if self.template is None:
            raise ValueError("FactorReducer needs a template for the byte "
                             "ledger")
        out = {}
        for fam, stats in self.template.items():
            for key, leaf in stats.items():
                name = f"{fam}.{key}"
                out[name] = fn(fam, key, _leaf_shape(leaf),
                               self._decisions.get(name, ()))
        return out

    def wire_bytes_per_stat(self) -> dict[str, int]:
        """Per-refresh wire bytes of each statistic under this reducer's
        decisions (replication fallbacks at dense f32, ``hier`` priced for
        each statistic's group size)."""
        return self._template_walk(lambda fam, key, shape, axes:
                                   wire_stat_bytes(
                                       shape, self.sym_fn(fam, key),
                                       self.comm, scattered=bool(axes),
                                       group_size=(self.group_size(axes)
                                                   if axes else None)))

    def gather_bytes_per_stat(self) -> dict[str, int]:
        """Per-refresh Stage-4 all-gather bytes: nonzero only for the
        full-kind "a"/"g" factors that scatter."""
        return self._template_walk(lambda fam, key, shape, axes:
                                   gather_stat_bytes(shape, True,
                                                     scattered=bool(axes))
                                   if key in ("a", "g")
                                   and self.sym_fn(fam, key) else 0)

    def wire_bytes_per_stat_levels(self) -> dict[str, tuple[int, int]]:
        """Per-refresh (intra-host, inter-host) wire bytes per statistic;
        (0, 0) for every statistic of a flat strategy."""
        return self._template_walk(lambda fam, key, shape, axes:
                                   wire_stat_level_bytes(
                                       shape, self.sym_fn(fam, key),
                                       self.comm, scattered=bool(axes),
                                       group_size=(self.group_size(axes)
                                                   if axes else None)))

    # ---- collectives ----

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce over the data axes into a fresh tensor."""
        return all_reduce(x.contiguous().clone(), self.group(self.dp))

    def dp_index(self) -> int:
        """This rank's position over the data axes: its rows of a global
        batch (``P(dp)``)."""
        return self.group(self.dp).index

    def reduce_stat(self, fam: str, key: str, v) -> torch.Tensor:
        """One statistic's Stage-3 reduce: this rank's chunk of the leading
        dim when it scatters (the strategy applies), the full sum
        otherwise. Wire-format dicts take the pre-packed all_to_all path
        and come back as dense f32. Runs in the range
        ``spngd.stage3.reduce[<strategy>:<fam>.<key>]``."""
        from repro_torch.obs import tracing
        from repro_torch.quant import quant
        with tracing.stage_scope(
                f"{tracing.STAGE_REDUCE}[{self.comm.strategy}:{fam}.{key}]"):
            if quant.is_wire(v):
                return self._fused_wire(v)
            axes = self.scatter_axes(v.shape[0]) if v.dim() >= 1 else ()
            if not axes:
                return self.psum(v)
            if self.comm.strategy in ("dense", "fused"):
                v = reduce_scatter(v, self.group(axes))
            elif self.comm.strategy == "hier":
                v = self._hier(v, axes, symmetric=self.sym_fn(fam, key))
            else:
                v = self._ring(v, axes, symmetric=self.sym_fn(fam, key))
            rest = tuple(a for a in self.dp if a not in axes)
            if rest:
                v = all_reduce(v.contiguous(), self.group(rest))
            return v

    def reduce(self, raw: dict) -> dict:
        """Reduce a whole raw-statistics tree ({family: {key: tensor}})."""
        return {fam: {k: self.reduce_stat(fam, k, v)
                      for k, v in stats.items()}
                for fam, stats in raw.items()}

    def assemble_stat(self, fam: str, key: str, v: torch.Tensor
                      ) -> torch.Tensor:
        """All-gather one statistic of :meth:`reduce_stat` back to its full
        leading dim, in f32, over the axes it scattered over (the
        template's decision); a replicated statistic passes through."""
        if self.template is None:
            raise ValueError("FactorReducer needs a template to assemble")
        axes = self._decisions.get(f"{fam}.{key}", ())
        return all_gather(v, self.group(axes)) if axes else v

    def assemble(self, reduced: dict) -> dict:
        """:meth:`assemble_stat` over a whole tree of :meth:`reduce`: the
        full statistics ``repro``'s shard_map ``out_specs`` hand its
        optimizer."""
        return {fam: {k: self.assemble_stat(fam, k, v)
                      for k, v in stats.items()}
                for fam, stats in reduced.items()}

    def gather_stat(self, fam: str, key: str, v: torch.Tensor,
                    axes: tuple) -> torch.Tensor:
        """Stage-4 return leg: all-gather a shard-local preconditioner back
        to the full leading dim over the SAME ``axes`` its statistic
        scattered over. Symmetric blocks move the sym-packed f32 triangle;
        the gather never quantizes. Runs in the range
        ``spngd.stage4.gather[<fam>.<key>]``."""
        from repro_torch.core import kfac
        from repro_torch.obs import tracing
        if not axes:
            return v
        with tracing.stage_scope(f"{tracing.STAGE_GATHER}[{fam}.{key}]"):
            sym = self.sym_fn(fam, key) and v.dim() >= 3 \
                and v.shape[-1] == v.shape[-2]
            b = v.shape[-1] if sym else 0
            if sym:
                v = kfac.sym_pack(v.float())
            v = all_gather(v, self.group(axes))
            return kfac.sym_unpack(v, b) if sym else v

    # ---- the ring ----

    def _ring(self, v: torch.Tensor, axes: tuple, *,
              symmetric: bool) -> torch.Tensor:
        """Ring reduce-scatter of ``v`` along dim 0 over the group
        ``axes``; chunk ownership is ``dense``'s."""
        from repro_torch.core import kfac
        g = self.group(axes)
        p = g.size
        sym = symmetric and v.dim() >= 3 and v.shape[-1] == v.shape[-2]
        b = v.shape[-1] if sym else 0
        v = kfac.sym_pack(v.float()) if sym else v.float()
        if p > 1:
            v = _ring_reduce_scatter(
                v, g, p, fmt=self.comm.wire_fmt if sym else None,
                scale_mode=self.comm.fp8_scale_mode,
                backend=self.comm.backend, index=g.index,
                dst=g.ranks[(g.index + 1) % p],
                src=g.ranks[(g.index - 1) % p])
        return kfac.sym_unpack(v, b) if sym else v

    # ---- the two-level hierarchical reduce ----

    def _hier(self, v: torch.Tensor, axes: tuple, *,
              symmetric: bool) -> torch.Tensor:
        """Two-level reduce-scatter along dim 0: f32 reduce-scatter inside
        each D-device host group, then D disjoint H-host rings (fp8 wire
        for symmetric factors) over host peers. Ownership is ``dense``'s."""
        from repro_torch.core import kfac
        g = self.group(axes)
        p = g.size
        sym = symmetric and v.dim() >= 3 and v.shape[-1] == v.shape[-2]
        b = v.shape[-1] if sym else 0
        v = kfac.sym_pack(v.float()) if sym else v.float()
        if p > 1:
            d_loc, h = hier_split(self.comm, p)
            d0, rest = v.shape[0], tuple(v.shape[1:])
            r = d0 // p
            if d_loc > 1 and h > 1:
                # chunks (h', l) -> (l, h'): after the host-level scatter,
                # device (host h0, local l) holds chunks {h' D + l}, and
                # the ring then lands chunk h0 D + l on its owner
                v = v.reshape((h, d_loc, r) + rest).transpose(0, 1) \
                    .reshape((d0,) + rest)
            if d_loc > 1:
                v = reduce_scatter(v, self._hosts[axes] if h > 1 else g)
            if h > 1:
                h0, loc = divmod(g.index, d_loc)
                v = _ring_reduce_scatter(
                    v, g, h, fmt=self.comm.wire_fmt if sym else None,
                    scale_mode=self.comm.fp8_scale_mode,
                    backend=self.comm.backend, index=h0,
                    dst=g.ranks[((h0 + 1) % h) * d_loc + loc],
                    src=g.ranks[((h0 - 1) % h) * d_loc + loc],
                    shortcut=False)
        return kfac.sym_unpack(v, b) if sym else v

    # ---- the fused pre-packed path ----

    def _fused_wire(self, entry: dict) -> torch.Tensor:
        """Reduce one wire-format statistic (``{"payload", "scale"}``):
        ``all_to_all`` of payload and scales, dequantize, sum over the
        sources in f32, unpack. Quantization happened once, in the
        capture."""
        from repro_torch.core import kfac
        from repro_torch.kernels import dispatch
        from repro_torch.quant import quant
        payload, scale = entry["payload"], entry["scale"]
        b = quant.tri_rows(payload.shape[-1])
        backend = self.comm.backend
        axes = self.scatter_axes(payload.shape[0]) if payload.dim() else ()
        p = self.group_size(axes) if axes else 1
        if not axes or p == 1:
            v = kfac.sym_unpack(
                dispatch.ring_hop_unpack(payload, scale, backend=backend), b)
            return self.psum(v)
        g = self.group(axes)
        payload = all_to_all(payload, g)
        scale = all_to_all(scale, g)
        v = dispatch.ring_hop_unpack(payload, scale, backend=backend)
        c = v.shape[0] // p
        v = kfac.sym_unpack(v.reshape((p, c) + tuple(v.shape[1:])).sum(0), b)
        rest = tuple(a for a in self.dp if a not in axes)
        if rest:
            v = all_reduce(v, self.group(rest))
        return v
