"""Chunked refresh pipeline: Stage 4 spread over the fast steps
(counterpart of ``repro/core/pipeline.py``).

A refresh splits into a **capture** step and ``K = NGDConfig.refresh_chunks``
**drain** chunks:

* The capture step runs the tagged backward, the factor sums, the
  normalization, the Algorithm-2 distances the ``IntervalController`` needs
  that step and the X_-1/X_-2 shift, but NO inversion: the normalized f32
  statistics are parked in ``opt_state["pipeline"]["raw"]``.
* Each of the next K fast steps runs one **chunk**, a set of whole
  (family, stat) inversion units balanced by a flop model (LPT), and writes
  them into ``precond_next``.
* The step after the last chunk **flips** ``precond_next -> precond`` per
  statistic, K+1 steps after the capture.

A chunk inverts from the raw store through the inline refresh's own
functions (``kfac.family_pi``, ``kfac.factor_damping`` and the optimizer's
``SPNGD._stat_inverse``, sharded under ``inverse_sharding``, passed to
:meth:`RefreshPipeline.drain`), so a drained inverse is bit-identical to the
inline double-buffered refresh of the same statistics; only the activation
step moves. The controller's ``min_interval = K + 1`` keeps a capture from
arriving before a drain ends; one that does restarts the cursor on the new
statistics.

Eager PyTorch runs a chunk on the step's own stream: the refresh is spread
over the K steps, not hidden behind their compute.

State: ``{"cursor", "raw", "valid"}``. The cursor and the ``valid`` latches
are host ``int`` and ``bool`` (the JAX package keeps them on the device, so
its drain picks the chunk with ``lax.switch``; here the choice is a plain
index and needs no device sync). Cursor semantics:

    0..K-1   the next drain step runs chunk ``cursor``
    K        every chunk written; the next step flips
    K+1      idle (init, or after the flip)

``valid[fam][key]`` latches once a statistic has been captured, and the
flip is gated on it, so a never-captured statistic's initial
preconditioner is never replaced by an inverse of zeros.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import kfac
from repro_torch.obs import tracing


def _unit_cost(shape: tuple, kind: str) -> int:
    """Relative flop cost of one inversion unit (the LPT weight): lead x
    b^3 for a blocked factor, the element count for the elementwise kinds
    (the diagonal inverse and the pass-through stats)."""
    if kind == "full" and len(shape) >= 2:
        return max(1, math.prod(shape[:-2]) * int(shape[-1]) ** 3)
    return max(1, math.prod(shape))


def _stat_kind(info, key: str) -> str:
    if key in ("a", "g"):
        return info.spec.a_kind if key == "a" else info.spec.g_kind
    if key == "uwf":                    # the full BN Fisher: one 2C block
        return "full"
    return "elem"                       # "d" / "uw": stats pass through


class RefreshPipeline:
    """Chunk scheduling for one :class:`repro_torch.core.ngd.SPNGD`: the
    (family, stat) -> chunk assignment is shape arithmetic over the
    ``fstats`` template, fixed at construction. It keeps the optimizer's
    site infos, not the optimizer, which owns it (no reference cycle to
    keep a finished run's model alive): the optimizer passes its inverse
    route to each :meth:`drain`."""

    def __init__(self, opt, chunks: int):
        if chunks < 1:
            raise ValueError("refresh_chunks must be >= 1")
        from repro_torch.core.ngd import _dense_leaf_shape
        self.infos = opt.infos
        self.chunks = int(chunks)
        self._shapes: dict[str, tuple] = {}
        units = []                      # (fam, key, cost)
        for fam, stats in sorted(opt.fstats_fn().items()):
            info = opt.infos[fam]
            for key, leaf in sorted(stats.items()):
                shape = _dense_leaf_shape(leaf)
                self._shapes[f"{fam}.{key}"] = shape
                units.append((fam, key,
                              _unit_cost(shape, _stat_kind(info, key))))
        # LPT: heaviest unit to the lightest chunk, ties by (fam, key)
        units.sort(key=lambda u: (-u[2], u[0], u[1]))
        loads = [0] * self.chunks
        self.schedule: list[list[tuple[str, str]]] = [
            [] for _ in range(self.chunks)]
        for fam, key, cost in units:
            i = loads.index(min(loads))
            self.schedule[i].append((fam, key))
            loads[i] += cost
        self.loads = loads

    def chunk_names(self, i: int) -> list[str]:
        """The statistics chunk ``i`` inverts."""
        return [f"{fam}.{key}" for fam, key in self.schedule[i]]

    def init_state(self, device) -> dict:
        """Idle pipeline: cursor parked at K+1, the raw store zero
        (expanded views of one zero, no memory until the first capture),
        nothing valid."""
        zero = torch.zeros((), device=device)
        raw, valid = {}, {}
        for name, shape in self._shapes.items():
            fam, key = name.split(".", 1)
            raw.setdefault(fam, {})[key] = zero.expand(shape)
            valid.setdefault(fam, {})[key] = False
        return {"cursor": self.chunks + 1, "raw": raw, "valid": valid}

    def flip(self, curv: dict, pipe: dict) -> dict:
        """At cursor == K every valid statistic's ``precond_next`` becomes
        its ``precond`` (whole statistics, never half a chunk); the
        curvature unchanged at any other cursor."""
        if pipe["cursor"] != self.chunks:
            return curv
        valid = pipe["valid"]
        return {fam: {**entry, "precond": {
                    key: entry["precond_next"][key] if valid[fam][key]
                    else cur for key, cur in entry["precond"].items()}}
                for fam, entry in curv.items()}

    def drain(self, curv: dict, pipe: dict, lam, invert):
        """One fast step's pipeline work: flip if the drain has just ended,
        run chunk ``cursor`` (none at K or idle) through ``invert(fam, key,
        stat, kind, damp) -> (inverse, info)``, advance the cursor.
        Returns ``(curv, pipe, inflight)``, ``inflight`` the steps until the
        refresh in flight is live: K+1 on the first drain step, 1 on the
        flip step, 0 when idle."""
        k, cursor = self.chunks, pipe["cursor"]
        curv = self.flip(curv, pipe)
        if cursor < k:
            with tracing.stage_scope(f"{tracing.STAGE_CHUNK}[{cursor}/{k}]"):
                curv = self._run_chunk(cursor, curv, pipe["raw"], lam,
                                       invert)
        inflight = min(max(k + 1 - cursor, 0), k + 1)
        return curv, {**pipe, "cursor": min(cursor + 1, k + 1)}, inflight

    def _pi(self, fam: str, raw: dict) -> torch.Tensor:
        """The family's pi from the raw store (both factors), so it does
        not depend on which chunk holds which factor."""
        info = self.infos[fam]
        return kfac.family_pi(raw[fam].get("a"), raw[fam].get("g"),
                              info.d_in, info.d_out, a_kind=info.spec.a_kind,
                              g_kind=info.spec.g_kind)

    def _run_chunk(self, i: int, curv: dict, raw: dict, lam,
                   invert) -> dict:
        """Invert chunk ``i``'s units from the raw store into
        ``precond_next``, every unit whatever its flag (a stale statistic's
        raw entry is its decoded X_-1, as in the inline refresh); the full
        BN Fisher by eigh with lam damping, as the inline refresh does."""
        curv = dict(curv)
        for fam, key in self.schedule[i]:
            v = raw[fam][key]
            if key in ("a", "g"):
                info = self.infos[fam]
                damp = kfac.factor_damping(self._pi(fam, raw), lam)
                v, _ = invert(fam, key, v, _stat_kind(info, key),
                              damp[key == "g"])
            elif key == "uwf":
                v = kfac.damped_inverse(v, lam)
            curv[fam] = {**curv[fam],
                         "precond_next": {**curv[fam]["precond_next"],
                                          key: v}}
        return curv
