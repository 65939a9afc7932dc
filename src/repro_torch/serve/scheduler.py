"""Continuous batching over a slot-based serving cache (counterpart of
``repro/serve/scheduler.py``).

The batcher owns ``slots`` cache lanes: requests are admitted into free
lanes (a batch-1 prefill scattered into lane ``slot`` of the packed cache),
every lane advances one token per batched decode step, and a lane frees the
moment its request finishes. Inactive lanes still ride through the step on
stale state (their ``len`` keeps growing and their slot wraps); their
outputs are discarded.

Prompts pad to the next power-of-two bucket, clamped to the cache capacity
(a bucket past a ring's capacity would wrap pad writes over real keys, so
such prompts prefill at their exact length); logits are read at the true
last position and the lane's ``len`` is set to the true length.

``temperature > 0`` samples with temperature / top-k from one
``torch.Generator`` per request, seeded from ``(seed, uid)``: a request's
tokens depend only on ``(seed, uid, prompt, max_new)``, never on its lane
or on admission order. Its bits cannot match ``jax.random``.
``temperature == 0`` (the default) is greedy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.serve.config import ServeConfig


@dataclasses.dataclass
class Request:
    """One decode request: prompt token ids + how many tokens to generate."""
    prompt: np.ndarray
    max_new: int
    uid: int = 0


@dataclasses.dataclass
class _Slot:
    uid: int
    remaining: int
    out: list
    gen: Optional[torch.Generator] = None


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _sample(logits: torch.Tensor, temperature: float, top_k: int,
            gen: torch.Generator) -> int:
    """Temperature / top-k draw of one token id from a (V,) logit row;
    ``top_k == 1`` reduces to argmax."""
    lg = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k).values[-1]
        lg = torch.where(lg < kth, torch.full_like(lg, -float("inf")), lg)
    probs = torch.softmax(lg, dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))


def request_seed(seed: int, uid: int) -> int:
    """Seed of a request's sampling stream, a function of (seed, uid) only."""
    return int(np.random.SeedSequence([seed, uid]).generate_state(
        1, np.uint64)[0] >> 1)


class ContinuousBatcher:
    """Continuous batcher over ``model`` (a :class:`DecoderLM`, whose device
    it takes) with ``slots`` cache lanes of ``max_len`` tokens."""

    def __init__(self, model, serve: ServeConfig, *, slots: int, max_len: int,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 bucket_prompts: bool = True):
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        self.model = model
        self.serve = serve
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = seed
        self.bucket_prompts = bucket_prompts
        self.cache = model.init_cache(slots, max_len, serve=serve)
        self.tokens = np.zeros((slots,), np.int64)   # next input per lane
        self.active: list[Optional[_Slot]] = [None] * slots
        self.buckets: set[int] = set()               # prefill lengths run

    def free_slots(self) -> list:
        return [i for i, s in enumerate(self.active) if s is None]

    @torch.no_grad()
    def admit(self, req: Request) -> int:
        """Prefill ``req`` into a free slot; returns the slot index."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot (call step() until one drains)")
        slot = free[0]
        prompt = np.asarray(req.prompt, np.int64).reshape(1, -1)
        s = prompt.shape[1]
        cap = self.cache["k"].shape[2]               # ring capacity / max_len
        sb = _next_pow2(s) if self.bucket_prompts else s
        if sb > cap:
            sb = s    # pad writes past capacity would wrap over real keys
        if sb != s:
            prompt = np.pad(prompt, ((0, 0), (0, sb - s)))
        self.buckets.add(sb)
        logits, sub = self.model.prefill(
            {"tokens": torch.as_tensor(prompt, device=self.device)},
            max_len=self.max_len, serve=self.serve)
        last = logits[0, s - 1]                      # the TRUE last position
        sub["len"].fill_(s)                          # decode resumes there
        for key, lane in self.cache.items():
            if key == "len":
                lane[slot] = sub[key][0]
            else:
                lane[:, slot] = sub[key][:, 0]
        gen = None
        if self.temperature == 0.0:
            first = int(torch.argmax(last))
        else:
            gen = torch.Generator(device=self.device).manual_seed(
                request_seed(self.seed, req.uid))
            first = _sample(last, self.temperature, self.top_k, gen)
        self.tokens[slot] = first
        self.active[slot] = _Slot(uid=req.uid, remaining=req.max_new - 1,
                                  out=[first], gen=gen)
        return slot

    @torch.no_grad()
    def step(self) -> dict:
        """One batched decode step; returns {uid: token list} for requests
        that completed on this step."""
        logits, self.cache = self.model.decode_step(
            self.cache, torch.as_tensor(self.tokens, device=self.device),
            serve=self.serve)
        if self.temperature == 0.0:
            next_tok = torch.argmax(logits, dim=-1).cpu().numpy()
        else:
            next_tok = np.zeros((self.slots,), np.int64)
            for i, st in enumerate(self.active):
                if st is not None and st.remaining > 0:
                    next_tok[i] = _sample(logits[i], self.temperature,
                                          self.top_k, st.gen)
        done = {}
        for i, st in enumerate(self.active):
            if st is None:
                continue
            if st.remaining > 0:
                st.out.append(int(next_tok[i]))
                st.remaining -= 1
                self.tokens[i] = next_tok[i]
            if st.remaining <= 0:
                done[st.uid] = st.out
                self.active[i] = None
        return done

    def run(self, requests: list) -> dict:
        """Serve ``requests`` to completion; returns {uid: generated ids}.
        Every free slot is filled from the queue before each step."""
        queue = list(requests)
        results: dict = {}
        while queue or any(s is not None for s in self.active):
            while queue and self.free_slots():
                self.admit(queue.pop(0))
            results.update(self.step())
        return results
