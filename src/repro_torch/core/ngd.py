"""SP-NGD optimizer: the paper's update rule (Eq. 6/12/23/24) end to end
(counterpart of ``repro/core/ngd.py``, the parts its default path runs).

The constructor takes

    loss_fn(params, fstats, batch) -> (loss, aux)
    site_infos: {family: SiteInfo}
    fstats_fn() -> zero statistics {family: {"a": ..., ...}}
    counts_fn(batch) -> {family: (n_a, n_g)}

and offers two steps:

* ``step``      -- full step with curvature capture; per-statistic refresh
                   flags (host booleans) gate the inversion work with a
                   plain ``if`` where the JAX package has ``lax.cond``.
* ``step_fast`` -- no capture: a plain backward + the stale-preconditioned
                   update.

Parameters are updated IN PLACE (the model owns them; a functional copy of
a 1.5 B-parameter model per step would double its memory), and so is the
momentum. The curvature state keeps the JAX package's layout: one stacked
``(L, ...)`` f32 array per statistic of a block family. Block-family
gradients are per-layer tensors (``fisher.get_path`` returns the list), so
preconditioning runs once per layer and side; an MoE layer's expert stack
``(E, d_in, d_out)`` (a ``"grouped"`` site, inverses ``(E, nb, b, b)``) is
one call per side for all its experts. With
``factor_dtype="fp8_e4m3"`` (or e5m2) the X_-1/X_-2 history is stored
encoded (``{"payload", "scale"}``, sym-packed for the blocked factors) and
decoded on read; wire-format capture (``FactorSpec.wire_fmt``) is decoded
once per refreshed statistic. With ``double_buffer`` the inverses a
refresh computes are staged (``precond_next``) and activate from the next
step on (the paper's section 5.2 overlap). With ``refresh_chunks`` K > 1
the chunked refresh pipeline (``core/pipeline.py``) takes over: a capture
step runs no inversion, the next K fast steps each invert one chunk, and
the step after them activates the refresh. With ``inverse_sharding`` the
dist step builder (``launch/train.py make_dist_train_step``) attaches a
``comm.Stage4Inverter``: each rank inverts its chunk of every full-kind
factor and the preconditioners all-gather, inline or chunk by chunk.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.core import kfac
from repro_torch.core.fisher import (SiteInfo, emp_fisher_grads, flatten,
                                     get_path, mc_fisher_grads,
                                     value_and_grad)
from repro_torch.obs import tracing


@dataclasses.dataclass(frozen=True)
class NGDConfig:
    damping: float = 2.5e-4          # paper Table 2 lambda
    alpha: float = 0.1               # Frobenius similarity threshold
    estimator: str = "emp"           # "emp" | "1mc"
    inverse_method: str = "eigh"     # "eigh" | "cholesky" | "newton_schulz"
                                     # (newton_schulz: per-block diagnostics
                                     # in metrics["inverse_info"] whatever
                                     # inverse_info says)
    factor_dtype: Any = torch.float32  # storage of the X_-1/X_-2 history:
                                     # a torch dtype (dense), or "fp8_e4m3"
                                     # / "fp8_e5m2" (sym-packed payload +
                                     # per-block scales; repro_torch.quant)
    weight_rescale: bool = False     # Eq. 24
    history: int = 2                 # 2 = full Algorithm 2; 1 = cheap variant
    sgd_fallback_scale: float = 1.0  # lr scale for non-sited params
    backend: str = "auto"            # kernel backend ("ref" | "cuda" |
                                     # "auto"; repro_torch.kernels.dispatch)
    inverse_sharding: bool = False   # Stage-4 distribution: each rank
                                     # inverts only its FactorReducer-owned
                                     # chunk of every full-kind factor and
                                     # the preconditioners all-gather
                                     # (repro_torch.comm.stage4). Takes
                                     # effect under the dist step builders,
                                     # which attach the Stage4Inverter; the
                                     # single-device steps ignore it
    double_buffer: bool = False      # inverses a refresh computes at step t
                                     # are STAGED (precond_next) and
                                     # activate at t+1, while step t still
                                     # applies the previous buffer
    refresh_chunks: int = 1          # chunked refresh pipeline
                                     # (repro_torch.core.pipeline): > 1
                                     # splits every refresh's Stage-4
                                     # inversions into this many chunks, one
                                     # per following fast step, activated
                                     # K+1 steps after the capture. Needs
                                     # double_buffer; the controller runs
                                     # with min_interval = refresh_chunks + 1
                                     # so a drain ends before the next
                                     # capture. 1 = inline refresh
    inverse_info: bool = False       # surface the inline refresh's
                                     # per-block Stage-4 diagnostics
                                     # (ns_res / ns_converged) in
                                     # metrics["inverse_info"] under every
                                     # method; families that did not refresh
                                     # carry ns_res = -1 (repro_torch.obs
                                     # reads it). Off: the metrics tree is
                                     # unchanged


# Eq. 24's guard against a zero weight norm
RESCALE_EPS = 1e-9


def _dense_leaf_shape(leaf) -> tuple:
    """Template-leaf shape in dense f32 terms: a wire-format accumulator
    reports the shape its payload decodes to, so the history and
    preconditioner state do not depend on the capture format."""
    from repro_torch.quant import quant
    if quant.is_wire(leaf):
        return quant.wire_dense_shape(leaf)
    return tuple(leaf.shape)


def _layer_path(param: str, layer: Optional[int]) -> str:
    """Flat path of one layer's leaf: ``blocks/attn/wq`` -> ``blocks/3/attn/wq``."""
    if layer is None:
        return param
    head, rest = param.split("/", 1)
    return f"{head}/{layer}/{rest}"


class SPNGD:
    def __init__(self, loss_fn: Callable, site_infos: dict[str, SiteInfo],
                 fstats_fn: Callable, counts_fn: Callable,
                 cfg: NGDConfig = NGDConfig()):
        self.loss_fn = loss_fn
        self.infos = site_infos
        self.fstats_fn = fstats_fn
        self.counts_fn = counts_fn
        self.cfg = cfg
        from repro_torch.quant.quant import parse_factor_dtype
        self._fp8 = parse_factor_dtype(cfg.factor_dtype)  # fmt key or None
        self.stage4 = None            # Stage4Inverter, set by the dist step
                                      # builder (set_stage4)
        self.pipeline = None          # RefreshPipeline when refresh_chunks>1
        if cfg.refresh_chunks > 1:
            if not cfg.double_buffer:
                raise ValueError("refresh_chunks > 1 needs double_buffer: "
                                 "the drain writes precond_next while the "
                                 "fast path consumes precond")
            from repro_torch.core.pipeline import RefreshPipeline
            self.pipeline = RefreshPipeline(self, cfg.refresh_chunks)

    def set_stage4(self, inverter) -> None:
        """Attach (or detach, with None) a
        :class:`repro_torch.comm.Stage4Inverter`: full-kind factor inverses
        then run shard-locally over the reducer's chunk layout and
        all-gather."""
        self.stage4 = inverter

    def sym_stat(self, fam: str, key: str) -> bool:
        """Whether a stat is a symmetric blocked factor (the fp8 history
        codec and the Stage-3 reducer both ask)."""
        if key in ("a", "g"):
            info = self.infos[fam]
            kind = info.spec.a_kind if key == "a" else info.spec.g_kind
            return kind == "full"
        return key == "uwf"                  # full BN Fisher is symmetric

    # ---- fp8 history codec (dequantize-on-read; repro_torch.quant) ----

    def _encode_hist(self, fam: str, key: str, x: torch.Tensor):
        if self._fp8 is None:
            return x.to(self.cfg.factor_dtype)
        from repro_torch.quant import quant
        return quant.encode_stat(x, self._fp8,
                                 symmetric=self.sym_stat(fam, key),
                                 backend=self.cfg.backend)

    def _decode_hist(self, fam: str, key: str, stored, shape
                     ) -> torch.Tensor:
        if self._fp8 is None:
            return stored.float()
        from repro_torch.quant import quant
        return quant.decode_stat(stored, shape,
                                 symmetric=self.sym_stat(fam, key),
                                 backend=self.cfg.backend)

    def _zero_hist(self, fam: str, key: str, shape: tuple, device):
        """Encoded zero history without a kernel launch: expanded views of
        a zero payload and of scale 1 (what encoding zeros gives)."""
        if self._fp8 is None:
            return torch.zeros((), dtype=self.cfg.factor_dtype,
                               device=device).expand(shape)
        from repro_torch.quant import quant
        if self.sym_stat(fam, key):
            b = shape[-1]
            p_shape, s_shape = shape[:-2] + (b * (b + 1) // 2,), shape[:-2]
        else:
            p_shape, s_shape = shape, shape[:-1]
        return {"payload": torch.zeros((), dtype=quant.FORMATS[self._fp8],
                                       device=device).expand(p_shape),
                "scale": torch.ones((), device=device).expand(s_shape)}

    # ---- statistic naming for the interval controller ----

    def stat_names(self) -> list[str]:
        return sorted(f"{fam}.{key}" for fam, stats in self.fstats_fn().items()
                      for key in stats)

    def stat_bytes(self) -> dict[str, int]:
        """Symmetric-packed payload per statistic (section 5.2), in the
        storage format of ``cfg.factor_dtype`` (f32 / bf16 elements, or the
        fp8 payload + per-block f32 scales)."""
        from repro_torch.core.stale import stat_payload_bytes
        return {f"{fam}.{key}": stat_payload_bytes(
                    _dense_leaf_shape(leaf), self.cfg.factor_dtype,
                    symmetric=self.sym_stat(fam, key))
                for fam, stats in self.fstats_fn().items()
                for key, leaf in stats.items()}

    def wire_bytes(self, comm=None, group_size=None) -> dict[str, int]:
        """Per-statistic Stage-3 collective payload under a
        :class:`repro_torch.comm.CommConfig` (the ledger's wire column):
        dense f32, sym-packed f32 for ``ring``, fp8 payload + per-row scales
        for ``ring_fp8``/``fused``, both levels for ``hier``. Every
        statistic scatters here; a reducer's ``wire_bytes_per_stat()``
        prices its mesh's replication fallbacks."""
        from repro_torch import comm as comm_mod
        return comm_mod.template_wire_bytes(
            self.fstats_fn(), self.sym_stat, comm or comm_mod.CommConfig(),
            group_size=group_size)

    def gather_bytes(self) -> dict[str, int]:
        """Per-statistic Stage-4 preconditioner all-gather payload under
        ``inverse_sharding``: sym-packed f32 triangles of the full-kind
        factors, 0 for everything else (every statistic scatters)."""
        from repro_torch import comm as comm_mod
        return comm_mod.template_gather_bytes(self.fstats_fn(), self.sym_stat)

    def wire_level_bytes(self, comm=None,
                         group_size=None) -> dict[str, tuple[int, int]]:
        """Per-statistic (intra-host, inter-host) Stage-3 wire bytes: the
        ``hier`` split, (0, 0) for the flat strategies."""
        from repro_torch import comm as comm_mod
        return comm_mod.template_wire_level_bytes(
            self.fstats_fn(), self.sym_stat, comm or comm_mod.CommConfig(),
            group_size=group_size)

    # ---- state ----

    def init(self, params) -> dict:
        """Zero history (encoded under fp8), identity preconditioners, zero
        momentum. The zero and identity entries are expanded views (no
        memory): the first refresh replaces them. With ``double_buffer`` the
        staged buffer starts as the same views, so step 1 applies these
        initial preconditioners. With the refresh pipeline the state holds
        an idle one under "pipeline"."""
        curv = {}
        dev = None
        for fam, stats in self.fstats_fn().items():
            info = self.infos[fam]
            entry = {"prev": {}, "prev2": {}, "precond": {}}
            for key, leaf in stats.items():
                shape = _dense_leaf_shape(leaf)
                dev = (leaf["payload"] if isinstance(leaf, dict)
                       else leaf).device
                z = torch.zeros((), device=dev).expand(shape)
                entry["prev"][key] = self._zero_hist(fam, key, shape, dev)
                if self.cfg.history >= 2:
                    entry["prev2"][key] = entry["prev"][key]
                if key in ("a", "g"):
                    kind = info.spec.a_kind if key == "a" else info.spec.g_kind
                    if kind == "full":
                        entry["precond"][key] = torch.eye(
                            shape[-1], device=dev).expand(shape)
                    else:
                        entry["precond"][key] = torch.ones(
                            (), device=dev).expand(shape)
                else:                       # "d" / "uw" / "uwf": zeros
                    entry["precond"][key] = z
            if self.cfg.double_buffer:
                entry["precond_next"] = dict(entry["precond"])
            curv[fam] = entry
        velocity = {path: torch.zeros_like(p)
                    for path, p in flatten(params).items()}
        state = {"step": 0, "velocity": velocity, "curv": curv}
        if self.pipeline is not None:
            state["pipeline"] = self.pipeline.init_state(dev)
        return state

    # ---- curvature refresh (Algorithm 1's on-refresh work) ----

    def _shift_history(self, fam: str, raw: dict, curv: dict, flags: dict,
                       n_a, n_g, park: bool = False):
        """Normalize the raw sums, measure the Algorithm-2 distances of the
        flagged statistics against the decoded history, and shift X_-1/X_-2
        for them. A statistic that does not refresh keeps its stored entry
        as it is (under fp8, payload and scale bit for bit: the select is
        at the encoded level); its decoded X_-1 stands in for it when its
        family recomputes or when ``park`` (the pipeline's capture, which
        parks every family). Returns (normalized, new_prev, new_prev2,
        sims) with sims[name] a (2,) device tensor for a flagged stat and
        None otherwise; normalized holds only what the family's refresh
        reads, every statistic with ``park``."""
        from repro_torch.quant import quant
        cfg = self.cfg
        new_prev, new_prev2, sims, normalized = {}, {}, {}, {}
        recompute = park or any(flags[f"{fam}.{k}"] for k in raw)
        for key, v in raw.items():
            name = f"{fam}.{key}"
            stored = curv["prev"][key]
            shape = tuple(curv["precond"][key].shape)
            if not flags[name]:
                sims[name] = None
                if recompute:
                    normalized[key] = self._decode_hist(fam, key, stored,
                                                        shape)
                new_prev[key] = stored
                if cfg.history >= 2:
                    new_prev2[key] = curv["prev2"][key]
                continue
            if quant.is_wire(v):
                # fused wire capture: ONE decode here, then the refresh
                # math is that of the dense capture
                v = quant.decode_wire_stat(v, backend=cfg.backend)
            norm = (v / n_a) if key == "a" else (v * n_g)
            prev = self._decode_hist(fam, key, stored, shape)
            d1 = kfac.frob_distance(norm, prev)
            if cfg.history >= 2:
                prev2 = self._decode_hist(fam, key, curv["prev2"][key], shape)
                d2 = kfac.frob_distance(norm, prev2)
                new_prev2[key] = stored
                del prev2
            else:
                d2 = d1
            del prev
            sims[name] = torch.stack([d1, d2])
            normalized[key] = norm
            new_prev[key] = self._encode_hist(fam, key, norm)
        if cfg.history < 2:
            new_prev2 = curv["prev2"]
        return normalized, new_prev, new_prev2, sims

    def _refresh_family(self, fam: str, raw: dict, curv: dict, flags: dict,
                        lam, n_a, n_g):
        """Returns (entry, sims, info): with Stage 4 by Newton-Schulz or with
        ``inverse_info``, info maps each blocked a/g factor to its per-block
        {"ns_res", "ns_converged"}, the sentinels -1 and True when the
        family did not refresh; else it is empty. With ``double_buffer``
        the new inverses (or, without a refresh, the staged ones) become
        ``precond_next`` and the staged buffer becomes ``precond``: this
        step applies what the latest earlier refresh computed."""
        info = self.infos[fam]
        cfg = self.cfg
        normalized, new_prev, new_prev2, sims = self._shift_history(
            fam, raw, curv, flags, n_a, n_g)
        info_keys = [k for k in ("a", "g") if k in raw and
                     (info.spec.a_kind if k == "a" else
                      info.spec.g_kind) == "full"] \
            if cfg.inverse_info or cfg.inverse_method == "newton_schulz" \
            else []
        if not any(flags[f"{fam}.{k}"] for k in raw):
            precond = curv["precond_next" if cfg.double_buffer
                           else "precond"]
            inv_info = {k: {"ns_res": torch.full(
                                precond[k].shape[:-2], -1.0,
                                device=precond[k].device),
                            "ns_converged": torch.ones(
                                precond[k].shape[:-2], dtype=torch.bool,
                                device=precond[k].device)}
                        for k in info_keys}
        else:
            precond, inv_info = {}, {}
            a, g = normalized.get("a"), normalized.get("g")
            if a is not None or g is not None:
                with tracing.stage_scope(tracing.STAGE_INVERSE):
                    a_inv, g_inv, blk = kfac.damped_factor_inverses(
                        a, g, lam, info.d_in, info.d_out,
                        a_kind=info.spec.a_kind, g_kind=info.spec.g_kind,
                        invert=functools.partial(self._stat_inverse, fam))
                precond.update({k: v for k, v in (("a", a_inv),
                                                  ("g", g_inv))
                                if v is not None})
                inv_info = {k: blk[k] for k in info_keys}
            for key in ("d", "uw"):
                if key in normalized:
                    precond[key] = normalized[key]
            if "uwf" in normalized:
                # full BN Fisher (2C x 2C): eigh with lam damping, whatever
                # the inverse method
                precond["uwf"] = kfac.damped_inverse(normalized["uwf"], lam)
        if cfg.double_buffer:
            entry = {"precond": curv["precond_next"], "precond_next": precond}
        else:
            entry = {"precond": precond}
        return ({"prev": new_prev, "prev2": new_prev2, **entry}, sims,
                inv_info)

    def _stat_inverse(self, fam: str, key: str, stat: torch.Tensor,
                      kind: str, damp: torch.Tensor):
        """One statistic's Stage-4 inverse, ``(inverse, info)``: shard-local
        and all-gathered when a Stage4Inverter is attached (full-kind
        factors only; its ``owner`` vector is dropped), else
        ``kfac.damped_stat_inverse``. The inline refresh and the refresh
        pipeline's chunks both invert through here."""
        if kind == "full" and self.stage4 is not None:
            inv, info = self.stage4.invert(stat, damp, fam=fam, key=key,
                                           return_info=True)
            return inv, {"ns_res": info["ns_res"],
                         "ns_converged": info["ns_converged"]}
        return kfac.damped_stat_inverse(stat, kind, damp,
                                        method=self.cfg.inverse_method,
                                        backend=self.cfg.backend)

    # ---- preconditioned update for one family ----

    def _apply_precond(self, fam: str, grads, curv: dict, lam) -> dict:
        """{flat param path: update} for the family's parameters; a block
        family is preconditioned layer by layer."""
        info = self.infos[fam]
        pc = curv["precond"]
        layers = range(info.lead[0]) if info.lead else [None]
        out = {}
        for layer in layers:
            pcl = pc if layer is None else {k: v[layer] for k, v in pc.items()}

            def grad(path):
                g = get_path(grads, path)
                return g if layer is None else g[layer]

            out.update(self._precond_one(info, pcl, grad, lam, layer))
        return out

    def _precond_one(self, info: SiteInfo, pc: dict, grad, lam, layer):
        path = _layer_path(info.param, layer)
        if info.kind in ("dense", "grouped", "embed"):
            # grouped: the layer's (E, d_in, d_out) expert stack with its
            # (E, nb, b, b) inverses, every expert in one call per side
            return {path: kfac.precondition(grad(info.param), pc.get("a"),
                                            pc.get("g"),
                                            backend=self.cfg.backend)}
        if info.kind == "conv":
            # (cout, cin, kh, kw) -> the (cin*kh*kw, cout) matrix of the
            # site's matmul: rows contiguous, as block_precond reads them
            dw = grad(info.param)
            cout = dw.shape[0]
            u = kfac.precondition(dw.reshape(cout, -1).t().contiguous(),
                                  pc.get("a"), pc.get("g"),
                                  backend=self.cfg.backend)
            return {path: u.t().reshape(dw.shape)}
        if info.kind == "bias":
            return {path: kfac.diag_solve(pc["d"], grad(info.param), lam)}
        if info.kind == "scale_bias":
            gg = grad(info.param)
            if "uwf" in pc:                    # full BN Fisher baseline
                gcat = torch.cat([gg, grad(info.beta_param)], dim=-1).float()
                u = torch.matmul(pc["uwf"], gcat[..., None])[..., 0]
                c = gg.shape[-1]
                return {path: u[..., :c],
                        _layer_path(info.beta_param, layer): u[..., c:]}
            if info.beta_param is not None:
                ug, ub = kfac.unitwise_solve(pc["uw"], gg,
                                             grad(info.beta_param), lam)
                return {path: ug, _layer_path(info.beta_param, layer): ub}
            return {path: kfac.diag_solve(pc["uw"][..., 0], gg, lam)}
        raise ValueError(info.kind)

    # ---- full update assembly ----

    @torch.no_grad()
    def _finish(self, params, state, grads, curv, lam, lr, mom, loss, aux,
                sims, inverse_info: Optional[dict] = None,
                extra: Optional[dict] = None):
        """Eq. 23 momentum update, in place: per family, precondition, then
        ``v = mom v - lr u`` and ``w = w + v``; the parameters no site
        covers take the plain gradient times ``sgd_fallback_scale``.
        ``extra`` joins the metrics (the pipeline's ``refresh_inflight``)."""
        cfg = self.cfg
        flat_g = flatten(grads)
        flat_p = flatten(params)
        vel = state["velocity"]
        dev = next(iter(flat_p.values())).device
        gsq = torch.zeros((), dtype=torch.float32, device=dev)
        usq = torch.zeros((), dtype=torch.float32, device=dev)

        def apply(path, u):
            nonlocal gsq, usq
            g = flat_g[path]
            gsq = gsq + torch.sum(torch.square(g.float()))
            usq = usq + torch.sum(torch.square(u.float()))
            v = vel[path]
            v.mul_(mom).sub_(lr * u.to(v.dtype))
            flat_p[path].add_(v.to(flat_p[path].dtype))

        done = set()
        for fam, c in curv.items():
            # the range holds the preconditioning alone, as repro's does;
            # the update of the family's parameters follows outside it
            with tracing.stage_scope(tracing.STAGE_PRECOND):
                updates = self._apply_precond(fam, grads, c, lam)
            for path, u in updates.items():
                apply(path, u)
                done.add(path)
        for path, g in flat_g.items():
            if path not in done:
                apply(path, g * cfg.sgd_fallback_scale)

        if cfg.weight_rescale:                 # Eq. 24
            for fam, info in self.infos.items():
                if info.kind not in ("dense", "conv", "grouped"):
                    continue
                layers = range(info.lead[0]) if info.lead else [None]
                for layer in layers:
                    w = flat_p[_layer_path(info.param, layer)]
                    if info.kind == "grouped":  # one norm per expert
                        norm = torch.sqrt(torch.sum(w.float() ** 2,
                                                    dim=(-2, -1),
                                                    keepdim=True))
                    else:
                        norm = torch.sqrt(torch.sum(w.float() ** 2))
                    target = (2.0 * info.d_out) ** 0.5
                    w.copy_((w * (target / (norm + RESCALE_EPS))
                             ).to(w.dtype))

        state_out = {**state, "step": state["step"] + 1, "curv": curv}
        metrics = {"loss": loss, "sims": sims, "grad_norm": torch.sqrt(gsq),
                   "update_norm": torch.sqrt(usq)}
        if inverse_info:
            metrics["inverse_info"] = inverse_info
        if extra:
            metrics.update(extra)
        if isinstance(aux, dict):
            metrics.update({k: v for k, v in aux.items()
                            if isinstance(v, torch.Tensor) and v.dim() == 0})
        return params, state_out, metrics

    def grads_and_raw(self, params, batch,
                      generator: Optional[torch.Generator] = None):
        """One backward pass: (loss, aux, grads, raw factor sums)."""
        fstats = self.fstats_fn()
        with tracing.stage_scope(tracing.STAGE_CAPTURE):
            if self.cfg.estimator == "1mc":
                return mc_fisher_grads(self.loss_fn, params, fstats, batch,
                                       generator)
            return emp_fisher_grads(self.loss_fn, params, fstats, batch)

    def apply_update(self, params, state, grads, raw, counts, flags,
                     lam, lr, mom, loss, aux):
        """Refresh curvature from the raw sums (per ``flags``) and apply the
        update. The flagged statistics' similarities come to the host in
        one transfer: metrics["sims"][name] = (d1, d2), or (-1, -1) for a
        statistic that did not refresh. With Stage 4 by Newton-Schulz, or
        with ``inverse_info``, metrics["inverse_info"]["{fam}.{key}"] holds
        the per-block Stage-4 diagnostics of each blocked factor. With the
        refresh pipeline this is the capture step (:meth:`_apply_capture`).
        """
        if self.pipeline is not None:
            return self._apply_capture(params, state, grads, raw, counts,
                                       flags, lam, lr, mom, loss, aux)
        curv, dev_sims, inv_info = {}, {}, {}
        for fam in raw:
            n_a, n_g = counts[fam]
            curv[fam], s, fi = self._refresh_family(
                fam, raw[fam], state["curv"][fam], flags, lam, n_a, n_g)
            dev_sims.update(s)
            inv_info.update({f"{fam}.{k}": v for k, v in fi.items()})
        del raw
        return self._finish(params, state, grads, curv, lam, lr, mom, loss,
                            aux, _host_sims(dev_sims), inverse_info=inv_info)

    def _apply_capture(self, params, state, grads, raw, counts, flags, lam,
                       lr, mom, loss, aux):
        """The pipeline's capture step: a drain that has ended flips first
        (so it is applied, not lost); then, per family, normalize, measure
        the distances and shift the history as the inline refresh does,
        park every statistic's post-select view (the fresh statistic when
        flagged, the decoded X_-1 otherwise) in the raw store, latch
        ``valid |= flag``, and restart the cursor. No inversion runs here;
        ``refresh_inflight`` is K+1."""
        pipe = state["pipeline"]
        curv_in = self.pipeline.flip(state["curv"], pipe)
        curv, dev_sims, new_raw, new_valid = {}, {}, {}, {}
        for fam in raw:
            n_a, n_g = counts[fam]
            new_raw[fam], new_prev, new_prev2, s = self._shift_history(
                fam, raw[fam], curv_in[fam], flags, n_a, n_g, park=True)
            dev_sims.update(s)
            curv[fam] = {**curv_in[fam], "prev": new_prev,
                         "prev2": new_prev2}
            new_valid[fam] = {k: pipe["valid"][fam][k]
                              or bool(flags[f"{fam}.{k}"]) for k in raw[fam]}
        del raw
        state = {**state, "pipeline": {"cursor": 0, "raw": new_raw,
                                       "valid": new_valid}}
        return self._finish(params, state, grads, curv, lam, lr, mom, loss,
                            aux, _host_sims(dev_sims),
                            extra={"refresh_inflight":
                                   self.pipeline.chunks + 1})

    def fast_curv(self, state, lam):
        """The fast path's curvature view: the stored preconditioners, the
        staged buffer activated first with ``double_buffer``; with the
        refresh pipeline, one drain (flip and/or one chunk). Returns
        (state, curv, extra metrics): ``{"refresh_inflight": n}`` with the
        pipeline, else empty. Every fast-step builder goes through here."""
        if self.pipeline is None:
            return state, self._activate(state["curv"]), {}
        curv, pipe, inflight = self.pipeline.drain(
            state["curv"], state["pipeline"], lam, self._stat_inverse)
        return ({**state, "pipeline": pipe}, curv,
                {"refresh_inflight": inflight})

    def _activate(self, curv: dict) -> dict:
        """Double-buffer activation on a fast step: the buffer the latest
        refresh staged becomes the active preconditioner (``_finish`` keeps
        the swap in the state). Identity without ``double_buffer``, and
        with the refresh pipeline, whose gated flip activates instead (an
        unconditional swap would apply a half-written ``precond_next``)."""
        if not self.cfg.double_buffer or self.pipeline is not None:
            return curv
        return {fam: {**entry, "precond": entry["precond_next"]}
                for fam, entry in curv.items()}

    def upgrade_state(self, state: dict) -> dict:
        """A loaded optimizer state in this config's buffer layout: a
        single-buffer state entering a ``double_buffer`` run seeds the
        staged buffer from the active one (the first activation changes
        nothing); a double-buffered state entering a single-buffer run
        drops the staged buffer. The pipeline state likewise: a state
        without one entering a ``refresh_chunks > 1`` run gets an idle one
        (the next capture starts it), and one entering an inline run loses
        it (and with it a refresh not yet activated; the next inline
        refresh recomputes it). Same-layout states pass through."""
        state = dict(state)
        curv = {}
        for fam, entry in state["curv"].items():
            entry = dict(entry)
            if self.cfg.double_buffer and "precond_next" not in entry:
                entry["precond_next"] = dict(entry["precond"])
            if not self.cfg.double_buffer:
                entry.pop("precond_next", None)
            curv[fam] = entry
        if self.pipeline is None:
            state.pop("pipeline", None)
        elif "pipeline" not in state:
            dev = next(iter(state["velocity"].values())).device
            state["pipeline"] = self.pipeline.init_state(dev)
        return {**state, "curv": curv}

    def step(self, params, state, batch, flags: dict, lam, lr, mom,
             generator: Optional[torch.Generator] = None):
        """Full step with curvature capture; ``flags`` maps stat name ->
        bool."""
        loss, aux, grads, raw = self.grads_and_raw(params, batch, generator)
        counts = self.counts_fn(batch)
        return self.apply_update(params, state, grads, raw, counts, flags,
                                 lam, lr, mom, loss, aux)

    def step_fast(self, params, state, batch, lam, lr, mom):
        """No capture: backward + stale-preconditioned update (plus one
        drain of the refresh pipeline when ``refresh_chunks > 1``)."""
        loss, aux, grads = value_and_grad(self.loss_fn, params, batch)
        state, curv, extra = self.fast_curv(state, lam)
        return self._finish(params, state, grads, curv, lam, lr, mom, loss,
                            aux, {}, extra=extra)


def _host_sims(dev_sims: dict) -> dict:
    """{name: (d1, d2)} on the host in one transfer, (-1, -1) for a
    statistic that did not refresh (None on the device side)."""
    live = [n for n, v in dev_sims.items() if v is not None]
    host = []
    if live:
        stacked = torch.stack([dev_sims[n] for n in live])
        # the dry run's meta tensors hold no values: NaN
        host = ([(math.nan, math.nan)] * len(live) if stacked.is_meta
                else stacked.tolist())
    sims = {n: (-1.0, -1.0) for n in dev_sims}
    sims.update({n: tuple(v) for n, v in zip(live, host)})
    return sims
