"""Gloo ranks on the CPU for the port's multi-rank parity tests.

:class:`RankPool` spawns ``world`` processes once (a module-scoped fixture
holds it), each on one torch thread with a gloo process group over a
``file://`` store in a temporary directory. ``pool.run("job", *args)``
runs the function ``job`` of this module on every rank with the same
arguments and returns the ranks' results in rank order. A rank that raises
makes ``run`` raise with its traceback, and the pool is closed: the other
ranks may be stuck in a collective until gloo's timeout.

This module imports torch and the port only, never JAX: the spawned ranks
import it. Arguments and results cross as numpy arrays and plain Python
values.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np

# gloo's collective timeout: a rank whose peer died raises after this long
GLOO_TIMEOUT_S = 60
# the longest one job may take on every rank before run() gives up
JOB_TIMEOUT_S = 240


def _rank_main(rank: int, world: int, store: str, jobs, results) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
        results.put((rank, "ready", None))
    except Exception:                     # noqa: BLE001 - reported to run()
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        name, args = job
        try:
            results.put((rank, "ok", globals()[name](*args)))
        except Exception:                 # noqa: BLE001 - reported to run()
            results.put((rank, "error", traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks that run this module's jobs."""

    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        self.world = world
        self._dir = tempfile.mkdtemp(prefix="gloo_ranks_")
        store = f"{self._dir}/store"
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, world, store, self._jobs[r],
                                         self._results), daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._collect("ready")

    def _collect(self, what: str) -> list:
        out, errors, got = [None] * self.world, [], 0
        deadline = time.monotonic() + JOB_TIMEOUT_S
        while got < self.world and not errors:
            try:
                rank, status, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead:
                    errors.append(f"rank(s) {dead} exited")
                elif time.monotonic() > deadline:
                    errors.append(f"no answer within {JOB_TIMEOUT_S} s")
                continue
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
            out[rank] = value
            got += 1
        if errors:
            self.close()
            raise RuntimeError(f"{what} failed on a rank:\n"
                               + "\n".join(errors))
        return out

    def run(self, name: str, *args) -> list:
        """``name(*args)`` on every rank; the results in rank order."""
        for q in self._jobs:
            q.put((name, args))
        return self._collect(name)

    def close(self) -> None:
        for q, p in zip(self._jobs, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# jobs (run on every rank)
# ---------------------------------------------------------------------------

def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _template(shapes: dict, wire: dict) -> dict:
    """{"fam": {key: tensor}} of the given dense shapes; the keys in
    ``wire`` (key -> fp8 dtype name) as wire dicts."""
    import torch
    out = {}
    for k, s in shapes.items():
        if k in wire:
            b = s[-1]
            out[k] = {"payload": torch.empty(
                          s[:-2] + (b * (b + 1) // 2,),
                          dtype=getattr(torch, wire[k])),
                      "scale": torch.empty(s[:-2])}
        else:
            out[k] = torch.empty(s)
    return {"fam": out}


def fails_on(rank: int) -> int:
    """Raises on ``rank``; the others return their rank."""
    import torch.distributed as dist
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return dist.get_rank()


def reduce(mesh_shape, manual_axes, comm_kw, shapes, sym_keys, raw_all,
           wire=None):
    """One ``FactorReducer.reduce`` of ``raw_all[i]`` on the rank with
    data-axis position ``i``: {"index", "out" (this rank's reduced tree),
    "replicated", "report", "wire", "levels", "gather", "assembled"}."""
    import torch
    import torch.distributed as dist

    from repro_torch.comm import FactorReducer, make_comm_config
    from repro_torch.launch.mesh import make_test_mesh
    wire = wire or {}
    mesh = make_test_mesh(*mesh_shape, device_type="cpu")
    red = FactorReducer(mesh, manual_axes=manual_axes,
                        comm=make_comm_config(**comm_kw),
                        template=_template(shapes, wire),
                        sym_fn=lambda fam, key: key in sym_keys)
    i = red.dp_index()
    raw = {"fam": {}}
    for k, v in raw_all.items():
        if k in wire:
            raw["fam"][k] = {
                "payload": torch.from_numpy(v["payload"][i]).view(
                    getattr(torch, wire[k])),
                "scale": torch.from_numpy(v["scale"][i])}
        else:
            raw["fam"][k] = torch.from_numpy(v[i])
    out = red.reduce(raw)
    assembled = red.assemble(out)
    return {"index": i, "rank": dist.get_rank(),
            "out": _numpy_tree(out), "assembled": _numpy_tree(assembled),
            "replicated": red.replicated, "report": red.scatter_report(),
            "wire": red.wire_bytes_per_stat(),
            "levels": red.wire_bytes_per_stat_levels(),
            "gather": red.gather_bytes_per_stat()}


def stage4_invert(mesh_shape, manual_axes, f, damp, method):
    """Stage4Inverter.invert of the full statistic ``f`` ((lead, nb, b,
    b)) beside the replicated inverse on every rank: {"index", "owners",
    "inv", "info", "replicated", "replicated_info", "inverted"}, the last
    the leading rows this rank's damped_inverse calls were given."""
    import torch

    from repro_torch.comm import FactorReducer, Stage4Inverter
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(*mesh_shape, device_type="cpu")
    red = FactorReducer(mesh, manual_axes=manual_axes,
                        template={"fam": {"a": torch.empty(f.shape)}},
                        sym_fn=lambda fam, key: True)
    inv4 = Stage4Inverter(red, method=method)
    stat, d = torch.from_numpy(f), torch.from_numpy(damp)
    seen = []
    real = dispatch.damped_inverse

    def spy(x, damping, **kw):
        # which rows of the full statistic this call inverts
        rows = [i for i in range(stat.shape[0])
                for j in range(x.shape[0]) if torch.equal(stat[i], x[j])]
        seen.append(rows)
        return real(x, damping, **kw)

    dispatch.damped_inverse = spy
    try:
        inv, info = inv4.invert(stat, d, fam="fam", key="a",
                                return_info=True)
    finally:
        dispatch.damped_inverse = real
    rep, rinfo = dispatch.damped_inverse(stat, d[:, None], method=method,
                                         return_info=True)
    axes = red.scatter_axes(stat.shape[0])
    return {"index": red.group(axes).index if axes else -1,
            "owners": inv4.owners(stat.shape[0]), "inv": inv.numpy(),
            "info": _numpy_tree(info), "replicated": rep.numpy(),
            "replicated_info": _numpy_tree(rinfo), "inverted": seen}


def _port_model(cfg_kw: dict, np_params, ngd_kw: dict, seed: int = 0):
    """The reduced llama3_2_1b of ``cfg_kw`` on the CPU with ``repro``'s
    params (numpy) or seed-``seed`` torch weights, its optimizer (damping
    1e-3) and state: (model, opt, params, state)."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    over = dict(cfg_kw)
    wire = over.pop("factor_wire", "")
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(**over),
                              factor_wire=wire)
    model, opt, params, state = train.build(cfg=cfg, device="cpu",
                                            damping=1e-3, seed=seed,
                                            **ngd_kw)
    if np_params is not None:
        model.load_state_dict(convert.params_from_jax(np_params, cfg, "cpu"))
        params = model.params()
    return model, opt, params, state


def _bits(t):
    import torch
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype.itemsize == 1 else t


def _leaves(tree, prefix=""):
    """{path: tensor} of a nested dict/list state, non-tensor leaves
    skipped."""
    import torch
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else ())
    for k, v in items:
        if isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v
        else:
            out.update(_leaves(v, f"{prefix}{k}/"))
    return out


def dist_equals_single(strategy, cfg_kw, ngd_kw, plan, batch):
    """World size 1: the dist steps against the single-device steps from
    the same weights, step kinds from ``plan`` ("capture" | "fast"), every
    flag set. Returns the names of the params and state leaves that differ
    (bit for bit) after each step, and the losses of both."""
    import torch

    from repro_torch.comm import make_comm_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(1, 1, device_type="cpu")
    comm = make_comm_config(strategy)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = []
    for dist_steps in (False, True):
        model, opt, params, state = _port_model(cfg_kw, None, ngd_kw)
        if dist_steps:
            step = train.make_dist_train_step(model, opt, mesh, comm=comm)
            fast = train.make_dist_fast_step(model, opt, mesh, comm=comm)
        else:
            step = train.make_train_step(model, opt)
            fast = train.make_fast_step(model, opt)
        flags = {k: True for k in opt.stat_names()}
        snaps, losses = [], []
        for kind in plan:
            if kind == "capture":
                params, state, m = step(params, state, b, flags, 1e-3, 5e-3,
                                        0.9)
            else:
                params, state, m = fast(params, state, b, 1e-3, 5e-3, 0.9)
            losses.append(float(m["loss"]))
            snaps.append({**{f"params/{k}": v.detach().clone()
                             for k, v in _leaves(params).items()},
                          **{f"state/{k}": v.clone()
                             for k, v in _leaves(state).items()}})
        runs.append((snaps, losses))
    diffs = []
    for s1, s2 in zip(runs[0][0], runs[1][0]):
        assert s1.keys() == s2.keys()
        diffs.append(sorted(k for k in s1 if s1[k].dtype != s2[k].dtype
                            or not torch.equal(_bits(s1[k]), _bits(s2[k]))))
    return {"diffs": diffs, "single": runs[0][1], "dist": runs[1][1]}


def dist_losses(strategy, cfg_kw, np_params, ngd_kw, batch, steps, period,
                offset, lr):
    """The dist steps from ``repro``'s params on a (ranks, 1) mesh: a
    capture on the steps ``t % period == offset``, fast steps between,
    every flag set, damping 1e-3, momentum 0.9. Returns the losses."""
    import torch
    import torch.distributed as dist

    from repro_torch.comm import make_comm_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(dist.get_world_size(), 1, device_type="cpu")
    model, opt, params, state = _port_model(cfg_kw, np_params, ngd_kw)
    comm = make_comm_config(strategy)
    step = train.make_dist_train_step(model, opt, mesh, comm=comm)
    fast = train.make_dist_fast_step(model, opt, mesh, comm=comm)
    assert (opt.stage4 is not None) == bool(ngd_kw.get("inverse_sharding"))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    flags = {k: True for k in opt.stat_names()}
    out = []
    for t in range(steps):
        if t % period == offset:
            params, state, m = step(params, state, b, flags, 1e-3, lr, 0.9)
        else:
            params, state, m = fast(params, state, b, 1e-3, lr, 0.9)
        out.append(float(m["loss"]))
    return out


def run_with_mesh(strategy, cfg_kw, ngd_kw, steps):
    """launch.train.run from the seed-0 weights without a mesh and with the
    (1, 1) mesh under ``strategy``: the losses, step kinds and log lines of
    each."""
    from repro_torch.comm import make_comm_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(1, 1, device_type="cpu")
    out = {}
    for key, m in (("single", None), ("dist", mesh)):
        model, opt, params, state = _port_model(cfg_kw, None, ngd_kw)
        lines = []
        _, _, recs = train.run(model, opt, params, state, steps=steps,
                               batch=2, seq=16, lr=5e-3, damping=1e-3,
                               log=lines.append, mesh=m,
                               comm=make_comm_config(strategy))
        out[key] = {"losses": [r["loss"] for r in recs],
                    "kinds": [r["kind"] for r in recs], "log": lines}
    return out
