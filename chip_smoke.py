#!/usr/bin/env python3
"""Smoke run of the repro_torch serving path on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` (into ``build/kernels/``), holds each
kernel against its plain PyTorch version on the card, serves
``llama3_2_1b`` at full width (random weights from a seed) through
``ContinuousBatcher`` -- once on the default dense cache, once on the fp8
ring cache -- and times both kernels beside their bound, their plain
version and the PyTorch library call for the same function. Every failed
check raises, so the exit code is nonzero. Without a CUDA device, or
outside a checkout, it exits nonzero and prints no result.

Output: one line per phase; then the card's name and power limit as
``nvidia-smi`` gives them, one JSON line with the kernels' numbers, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12              # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {                     # dense, without sparsity
    "bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
    "float8_e4m3fn": 1979e12, "float8_e5m2": 1979e12,
}

# bf16 outputs: one bf16 ulp at |out| <= 2 is 7.8e-3; lse is f32 arithmetic
# on both sides in another summation order
FWD_TOL = dict(atol=1e-2, rtol=1e-2)
LSE_TOL = dict(atol=1e-3, rtol=1e-4)
# decode output is f32 on both sides (dequantized payloads are exact)
DEC_TOL = dict(atol=1e-4, rtol=1e-4)
# full-model prefill logits, kernel vs plain attention, bf16 weights and
# activations through 16 layers: relative to the largest logit
LOGIT_REL_TOL = 5e-2
# the same in f32 (4 layers): f32 summation order only
F32_LOGIT_REL_TOL = 1e-3


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main(argv: list[str]) -> int:
    if argv:
        print("usage: chip_smoke.py (no arguments)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    _CARD["line"] = card
    say("device", f"{card} | torch {torch.__version__} cuda "
                  f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    say("build", f"nvcc sm_90a, {len(build.SIGNATURES)} libraries in "
                 f"{time.perf_counter() - t0:.1f} s")

    errs = {"swa_flash_fwd": check_prefill_kernel(torch),
            "swa_flash_decode": check_decode_kernel(torch)}
    main_path = serve_main_path(torch)
    ring = serve_ring_path(torch, main_path["model"])
    check_f32_route(torch)
    times = time_kernels(torch, main_path, ring)
    profile_path(torch, main_path)

    rows = []
    for name, replaces in (("swa_flash_fwd", "src/repro/kernels/swa_attention.py:292"),
                           ("swa_flash_decode", "src/repro/kernels/swa_attention.py:206")):
        t = times[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": replaces,
                     "launches": main_path["launches"][name],
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_prefill_kernel(torch) -> float:
    from repro_torch.kernels import ref, swa_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    cases = [(bkv, 4, s, w) for bkv in (8, 64) for s in (1000, 2048)
             for w in (0, 256)] + [(8, 1, 1000, 0)]
    for bkv, g, s, window in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        q, k, v = rnd(bkv, g, s, 64), rnd(bkv, s, 64), rnd(bkv, s, 64)
        out, lse = swa_attention.swa_flash_fwd(q, k, v, window=window)
        torch.cuda.synchronize()
        ro, rl = ref.swa_attention_fwd_res_ref(q, k, v, window=window)
        torch.testing.assert_close(out.float(), ro.float(), **FWD_TOL)
        torch.testing.assert_close(lse, rl, **LSE_TOL)
        err = _max_err(torch, out, ro)
        worst = max(worst, err)
        say("prefill-kernel", f"BKV={bkv} G={g} S={s} window={window} bf16: "
                              f"max|out err|={err:.3e} max|lse err|="
                              f"{_max_err(torch, lse, rl):.3e} (tol {FWD_TOL}, "
                              f"lse {LSE_TOL})")
        del q, k, v, out, lse, ro, rl
    torch.cuda.empty_cache()
    return worst


def _decode_case(torch, gen, n, c, fmt):
    from repro_torch.quant import quant
    q = torch.randn((n, 4, 64), generator=gen, device="cuda")
    k = torch.randn((n, c, 64), generator=gen, device="cuda")
    v = torch.randn((n, c, 64), generator=gen, device="cuda")
    if fmt is None:
        return q, k, v, None, None
    kp, ks = quant.quantize_rows(k, fmt)
    vp, vs = quant.quantize_rows(v, fmt)
    return q, kp, vp, ks, vs


def check_decode_kernel(torch) -> float:
    from repro_torch.kernels import ref, swa_attention
    from repro_torch.quant import quant
    gen = torch.Generator(device="cuda").manual_seed(2)
    n = 64
    worst = 0.0
    dense_pos = torch.randint(0, 1024, (n,), generator=gen, device="cuda")
    dense_pos[:3] = torch.tensor([0, 1023, 511], device="cuda")
    ring_pos = torch.randint(0, 3000, (n,), generator=gen, device="cuda")
    ring_pos[:5] = torch.tensor([0, 254, 255, 256, 1000], device="cuda")
    cases = [("dense f32 C=1024", 1024, 0, None, dense_pos),
             ("ring e4m3 C=window=256", 256, 256, "e4m3", ring_pos),
             ("ring e5m2 C=window=256", 256, 256, "e5m2", ring_pos)]
    for label, c, window, fmt, pos in cases:
        pos = pos.to(torch.int32)
        q, k, v, ks, vs = _decode_case(torch, gen, n, c, fmt)
        got = swa_attention.swa_flash_decode(q, k, v, pos, window=window,
                                             k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        want = ref.swa_decode_ref(q, k, v, pos, window=window, k_scale=ks,
                                  v_scale=vs)
        torch.testing.assert_close(got, want, **DEC_TOL)
        err = _max_err(torch, got, want)
        worst = max(worst, err)
        say("decode-kernel", f"N={n} G=4 hd=64 {label}: max|err|={err:.3e} "
                             f"(tol {DEC_TOL})")
    # the serving paths' calls: bf16 q and the (B, KV, C, hd) view of the
    # serving cache, read in place through strides -- the dense f32 cache of
    # the main path (B=8, C=1024) and the fp8 e4m3 ring of the ring path
    # (B=4, C=window=256) with its (B, KV, C) scale views
    view_cases = [("dense f32", 8, 1024, 0, None, dense_pos[:8]),
                  ("ring e4m3", 4, 256, 256, "e4m3",
                   torch.tensor([0, 256, 511, 1000], device="cuda"))]
    for label, b, c, window, fmt, lane_pos in view_cases:
        kv = 8
        q = torch.randn((b * kv, 4, 64), generator=gen, device="cuda").to(
            torch.bfloat16)
        k = torch.randn((b, c, kv, 64), generator=gen, device="cuda")
        v = torch.randn((b, c, kv, 64), generator=gen, device="cuda")
        ks = vs = None
        if fmt is not None:                 # (B, C, KV, hd) payload, (B, C, KV)
            (k, ks), (v, vs) = quant.quantize_rows(k, fmt), \
                quant.quantize_rows(v, fmt)
            ks, vs = ks.permute(0, 2, 1), vs.permute(0, 2, 1)
        kview, vview = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        pos = lane_pos.to(torch.int32).repeat_interleave(kv)
        got = swa_attention.swa_flash_decode(q, kview, vview, pos,
                                             window=window, k_scale=ks,
                                             v_scale=vs)
        torch.cuda.synchronize()
        flat = (lambda t: None if t is None else t.reshape(b * kv, c))
        want = ref.swa_decode_ref(
            q.float(), kview.reshape(b * kv, c, 64),
            vview.reshape(b * kv, c, 64), pos, window=window,
            k_scale=flat(ks), v_scale=flat(vs))
        torch.testing.assert_close(got, want, **DEC_TOL)
        err = _max_err(torch, got, want)
        worst = max(worst, err)
        say("decode-kernel", f"cache view ({b}, {kv}, {c}, 64) {label}, "
                             f"bf16 q, positions {lane_pos.tolist()}: "
                             f"max|err|={err:.3e} (tol {DEC_TOL})")
    return worst


# ---------------------------------------------------------------------------
# the serving path at full width
# ---------------------------------------------------------------------------

class _Watch:
    """Wraps the model's prefill/decode_step: counts calls, keeps each
    call's all-finite flag on the device and sums synchronized wall time."""

    def __init__(self, torch, model):
        self.torch = torch
        self.model = model
        self.prefill, self.decode_step = model.prefill, model.decode_step
        self.finite = []
        self.n = {"prefill": 0, "decode": 0}
        self.s = {"prefill": 0.0, "decode": 0.0}
        self.prompt_tokens = 0
        model.prefill = self._wrap("prefill", self.prefill)
        model.decode_step = self._wrap("decode", self.decode_step)

    def _wrap(self, kind, fn):
        def run(*a, **kw):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.s[kind] += time.perf_counter() - t
            self.n[kind] += 1
            if kind == "prefill":
                self.prompt_tokens += a[0]["tokens"].shape[1]
            self.finite.append(self.torch.isfinite(logits).all())
            return logits, cache
        return run

    def close(self):
        del self.model.prefill, self.model.decode_step
        return bool(self.torch.stack(self.finite).all())


def _model(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DecoderLM
    cfg = get_config("llama3_2_1b")
    t = time.perf_counter()
    model = DecoderLM(cfg).init(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    return model, cfg, n, time.perf_counter() - t


def _requests(rng, vocab, lens, max_new):
    from repro_torch.serve import Request
    return [Request(prompt=rng.integers(0, vocab, (int(n),)), max_new=max_new,
                    uid=i) for i, n in enumerate(lens)]


def serve_main_path(torch) -> dict:
    import numpy as np
    from repro_torch.kernels import dispatch, swa_attention
    from repro_torch.serve import ContinuousBatcher, ServeConfig
    model, cfg, n_params, t_init = _model(torch)
    say("main-path", f"llama3_2_1b full width: {cfg.n_layers} layers, d "
                     f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
                     f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, "
                     f"{n_params} params, init {t_init:.1f} s")
    serve = ServeConfig()                   # window 0 -> dense f32 cache
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator), outside the counted run
    ContinuousBatcher(model, serve, slots=8, max_len=1024).run(
        _requests(rng, cfg.vocab, [40, 300], 4))

    lens = rng.integers(24, 601, 16)
    reqs = _requests(rng, cfg.vocab, lens, 32)
    batcher = ContinuousBatcher(model, serve, slots=8, max_len=1024)
    check(batcher.cache["k"].dtype == torch.float32
          and "k_scale" not in batcher.cache,
          "default ServeConfig on llama3_2_1b must give the dense f32 cache")
    watch = _Watch(torch, model)
    swa_attention.reset_launches()
    dispatch.reset_calls()
    out = batcher.run(reqs)
    launches = dict(swa_attention.LAUNCHES)
    calls = dict(dispatch.CALLS)
    finite = watch.close()
    check(sorted(out) == list(range(16)), f"requests served: {sorted(out)}")
    check(all(len(t) == 32 for t in out.values()), "every request returns 32 "
          "tokens")
    check(finite, "all prefill/decode logits finite")
    check(watch.n["prefill"] == 16, f"prefills {watch.n['prefill']}")
    check(launches["swa_flash_fwd"] == cfg.n_layers * watch.n["prefill"],
          f"prefill kernel launches {launches['swa_flash_fwd']} != "
          f"{cfg.n_layers} x {watch.n['prefill']}")
    check(launches["swa_flash_decode"] == cfg.n_layers * watch.n["decode"],
          f"decode kernel launches {launches['swa_flash_decode']} != "
          f"{cfg.n_layers} x {watch.n['decode']}")
    check(not any(b == "ref" for (_, b) in calls), f"ref dispatches: {calls}")
    gen_tokens = sum(len(t) - 1 for t in out.values())   # first from prefill
    say("main-path", f"16 requests, prompts {int(lens.min())}-"
                     f"{int(lens.max())} tokens, 32 new each, 8 slots: "
                     f"{watch.n['prefill']} prefills, {watch.n['decode']} decode "
                     f"steps; launches {launches}; dispatches {calls}")
    prefill_tps = watch.prompt_tokens / watch.s["prefill"]
    decode_tps = gen_tokens / watch.s["decode"]
    say("main-path", f"prefill {prefill_tps:.1f} tokens/s ({watch.prompt_tokens}"
                     f" bucketed prompt tokens in {watch.s['prefill']:.3f} s); "
                     f"decode {decode_tps:.1f} tokens/s at 8 lanes ({gen_tokens}"
                     f" tokens in {watch.s['decode']:.3f} s); {card_note(torch)}")

    # two prompts again, kernel route vs plain attention (backend="ref")
    with torch.no_grad():
        for r in reqs[:2]:
            toks = {"tokens": torch.as_tensor(r.prompt[None], device="cuda")}
            lk, _ = model.prefill(toks, max_len=1024, serve=serve)
            lr, _ = model.prefill(toks, max_len=1024,
                                  serve=ServeConfig(backend="ref"))
            err = _max_err(torch, lk, lr)
            scale = float(lr.float().abs().max())
            agree = float((lk.argmax(-1) == lr.argmax(-1)).float().mean())
            check(err <= LOGIT_REL_TOL * scale,
                  f"prefill logits kernel vs ref: {err} > {LOGIT_REL_TOL} x "
                  f"{scale}")
            say("main-path", f"prompt {len(r.prompt)}: prefill logits kernel "
                             f"vs backend='ref' max|err|={err:.3e} (max|logit| "
                             f"{scale:.2f}, tol {LOGIT_REL_TOL} x that); argmax "
                             f"agreement {agree:.4f}")
    return {"model": model, "launches": launches, "prefill_tps": prefill_tps,
            "decode_tps": decode_tps, "lens": lens, "reqs": reqs}


def check_f32_route(torch) -> None:
    """The kernel route against plain attention at full width in f32 (depth
    cut to 4 layers): here rounding cannot hide a kernel fault the way 16
    bf16 layers of a random network can."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serve import ServeConfig
    cfg = dataclasses.replace(get_config("llama3_2_1b"), n_layers=4,
                              dtype=torch.float32)
    model = DecoderLM(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for n, window in ((600, 0), (500, 256)):
            toks = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)),
                                              device="cuda")}
            serve = ServeConfig(window=window)
            lk, _ = model.prefill(toks, max_len=1024, serve=serve)
            lr, _ = model.prefill(toks, max_len=1024, serve=dataclasses.replace(
                serve, backend="ref"))
            err = _max_err(torch, lk, lr)
            scale = float(lr.abs().max())
            check(err <= F32_LOGIT_REL_TOL * scale,
                  f"f32 prefill logits kernel vs ref: {err} > "
                  f"{F32_LOGIT_REL_TOL} x {scale}")
            say("f32-route", f"llama3_2_1b width, 4 layers, f32, prompt {n}, "
                             f"window {window}: prefill logits kernel vs "
                             f"backend='ref' max|err|={err:.3e} (max|logit| "
                             f"{scale:.2f}, tol {F32_LOGIT_REL_TOL} x that)")
    del model
    torch.cuda.empty_cache()


def serve_ring_path(torch, model) -> dict:
    import numpy as np
    from repro_torch.kernels import dispatch, swa_attention
    from repro_torch.serve import ContinuousBatcher, ServeConfig
    cfg = model.cfg
    serve = ServeConfig(window=256)          # ring, fp8 e4m3 payload
    scaled = []
    cuda_decode = dispatch.lookup("swa_decode", "cuda")

    def spy(q, k, v, pos, window, k_scale, v_scale):
        scaled.append(k_scale is not None and v_scale is not None
                      and window == 256)
        return cuda_decode(q, k, v, pos, window, k_scale, v_scale)

    rng = np.random.default_rng(1)
    lens = [230, 260, 300, 180]
    reqs = _requests(rng, cfg.vocab, lens, 100)
    batcher = ContinuousBatcher(model, serve, slots=4, max_len=1024)
    check(batcher.cache["k"].dtype == torch.float8_e4m3fn
          and batcher.cache["k"].shape[2] == 256
          and "k_scale" in batcher.cache, "ServeConfig(window=256) must give "
          "the fp8 e4m3 ring of 256 slots")
    watch = _Watch(torch, model)
    dispatch.register("swa_decode", "cuda", spy)
    swa_attention.reset_launches()
    dispatch.reset_calls()
    try:
        out = batcher.run(reqs)
    finally:
        dispatch.register("swa_decode", "cuda", cuda_decode)
    launches = dict(swa_attention.LAUNCHES)
    calls = dict(dispatch.CALLS)
    finite = watch.close()
    check(all(len(out[i]) == 100 for i in range(4)), "ring: 100 tokens each")
    check(finite, "ring: all logits finite")
    check(scaled and all(scaled), "ring: decode kernel called with scales")
    check(launches["swa_flash_decode"] == cfg.n_layers * watch.n["decode"]
          and launches["swa_flash_fwd"] == cfg.n_layers * 4,
          f"ring launches {launches}")
    check(not any(b == "ref" for (_, b) in calls), f"ref dispatches: {calls}")
    check(all(n + 100 > 256 for n in lens), "ring wraps")
    gen_tokens = sum(len(t) - 1 for t in out.values())
    say("ring-path", f"fp8 e4m3 ring C=256, 4 requests, prompts {lens} + 100 "
                     f"new (the ring wraps): {watch.n['decode']} decode steps, "
                     f"launches {launches}, decode {gen_tokens / watch.s['decode']:.1f}"
                     f" tokens/s at 4 lanes; {card_note(torch)}")
    return {"cache": batcher.cache}


_CARD = {"line": ""}


def card_note(torch) -> str:
    """The card's name and power limit, printed beside every time."""
    return "card: " + _CARD["line"]


# ---------------------------------------------------------------------------
# times
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Median device time of ``fn`` over ``reps`` CUDA-event timings. The
    L2 (50 MB) is flushed before each, as a layer's fresh operands would
    find it; then the stream sleeps while the host records the start event
    and enqueues ``fn``, so the host's launch overhead stays out of it."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)           # ~1 ms of clock cycles
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _bound(ops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS_PER_S[str(dtype).replace("torch.", "")] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_kernels(torch, main_path, ring) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import ref, swa_attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    res = {}

    # prefill: one prompt of the main path's largest bucket, batch 1
    bkv, g, s, hd = 8, 4, 1024, 64
    q = torch.randn((bkv, g, s, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((bkv, s, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((bkv, s, hd), generator=gen, device="cuda").bfloat16()
    vis = s * (s + 1) // 2
    ops = 4 * hd * g * bkv * vis
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * bkv * g * s
    bound, by = _bound(ops, nbytes, q.dtype)
    qs, ks_, vs_ = q.view(1, bkv * g, s, hd), k.view(1, bkv, s, hd), \
        v.view(1, bkv, s, hd)
    res["swa_flash_fwd"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_fwd(q, k, v)),
        "plain_ms": _time_ms(torch, lambda: ref.swa_attention_fwd_res_ref(
            q, k, v), reps=5),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks_, vs_, is_causal=True, enable_gqa=True)),
        "bound_ms": bound, "bound_by": by}
    say("times", f"swa_flash_fwd BKV={bkv} G={g} S={s} hd={hd} bf16 causal: "
                 f"{res['swa_flash_fwd']}; {card_note(torch)}")
    del q, k, v

    # decode: the main path's step -- 8 lanes x 8 KV heads over the dense
    # f32 cache (C = 1024), read in place as the (B, KV, C, hd) view
    b, kv, c = 8, 8, 1024
    lens = main_path["lens"]
    pos = torch.as_tensor([int(lens[i % len(lens)]) + 16 for i in range(b)],
                          dtype=torch.int32, device="cuda").repeat_interleave(kv)
    cache_k = torch.randn((b, c, kv, hd), generator=gen, device="cuda")
    cache_v = torch.randn((b, c, kv, hd), generator=gen, device="cuda")
    kview, vview = cache_k.permute(0, 2, 1, 3), cache_v.permute(0, 2, 1, 3)
    qd = torch.randn((b * kv, g, hd), generator=gen, device="cuda").bfloat16()
    vis_slots = int(torch.clamp(pos + 1, max=c).sum())
    nbytes = 2 * vis_slots * hd * 4 + qd.numel() * 2 + qd.numel() * 4 + 4 * b * kv
    bound, by = _bound(4 * hd * g * vis_slots, nbytes, cache_k.dtype)
    mask = (torch.arange(c, device="cuda")[None, :]
            <= pos.view(b, kv)[:, :1]).view(b, 1, 1, c)
    qsd = qd.float().view(b, kv * g, 1, hd)
    res["swa_flash_decode"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_decode(
            qd, kview, vview, pos)),
        "plain_ms": _time_ms(torch, lambda: ref.swa_decode_ref(
            qd, kview.reshape(b * kv, c, hd), vview.reshape(b * kv, c, hd),
            pos)),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qsd, kview, vview, attn_mask=mask, enable_gqa=True)),
        "bound_ms": bound, "bound_by": by}
    say("times", f"swa_flash_decode N={b * kv} G={g} hd={hd} dense f32 C={c}, "
                 f"pos {sorted(set(pos.tolist()))}: {res['swa_flash_decode']}; "
                 f"{card_note(torch)}")

    # the same step on the fp8 ring (C = window = 256) of the ring path
    rc = ring["cache"]
    kr, vr = rc["k"][0].permute(0, 2, 1, 3), rc["v"][0].permute(0, 2, 1, 3)
    ksr, vsr = rc["k_scale"][0].permute(0, 2, 1), rc["v_scale"][0].permute(0, 2, 1)
    nb, kv = kr.shape[:2]
    qr = torch.randn((nb * kv, g, hd), generator=gen, device="cuda").bfloat16()
    posr = rc["len"].to(torch.int32).repeat_interleave(kv)
    vis_r = int(torch.clamp(posr + 1, max=256).sum())
    nbytes = 2 * vis_r * (hd + 4) + qr.numel() * 6 + 4 * nb * kv
    bound_r, by_r = _bound(4 * hd * g * vis_r, nbytes, kr.dtype)
    kdq = (kr.float() * ksr[..., None])
    vdq = (vr.float() * vsr[..., None])
    ring_ms = _time_ms(torch, lambda: swa_attention.swa_flash_decode(
        qr, kr, vr, posr, window=256, k_scale=ksr, v_scale=vsr))
    lib_r = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qr.float().view(nb, kv * g, 1, hd), kdq, vdq, enable_gqa=True))
    say("times", f"swa_flash_decode N={nb * kv} G={g} hd={hd} fp8 e4m3 ring "
                 f"C=256: ms {ring_ms:.4f}, bound_ms {bound_r:.6f} ({by_r}), "
                 f"library_ms (SDPA over the dequantized ring) {lib_r:.4f}; "
                 f"{card_note(torch)}")
    say("path", f"prefill {main_path['prefill_tps']:.1f} tokens/s, decode "
                f"{main_path['decode_tps']:.1f} tokens/s at 8 lanes")
    return res



def _device_us(evt) -> float:
    """Time of a device-side event (a kernel, a memset or a copy); host-side
    operator entries count 0, so no kernel is counted twice."""
    from torch.autograd import DeviceType
    if getattr(evt, "device_type", None) != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _group(name: str) -> str:
    low = name.lower()
    if "swa_flash" in low:
        return "attention kernels"
    if any(t in low for t in ("gemm", "gemv", "xmma", "nvjet", "cutlass",
                              "matmul")):
        return "matmuls (cuBLAS)"
    return "other (elementwise, copies, reductions, memsets)"


def _profile(torch, label, fn) -> None:
    """Device time by kernel and by group over ``fn``, and the device's busy
    share of the wall time (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                           # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    evts = [e for e in prof.key_averages() if _device_us(e) > 0]
    total = sum(_device_us(e) for e in evts)
    if not total:
        say("profile", f"{label}: no device time in the trace (not measured)")
        return
    groups: dict = {}
    for e in evts:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + _device_us(e)
    top = sorted(evts, key=_device_us, reverse=True)[:6]
    say("profile", f"{label}: wall {wall_us:.0f} us (profiled), device "
                   f"busy {total:.0f} us ({total / wall_us:.3f} of wall, "
                   f"{sum(e.count for e in evts)} device events); by group "
                   + ", ".join(f"{g} {v:.0f} us ({v / total:.3f})"
                               for g, v in sorted(groups.items(),
                                                  key=lambda kv: -kv[1]))
                   + f"; {card_note(torch)}")
    for e in top:
        say("profile", f"  {_device_us(e):9.0f} us  {e.count:5d} x  "
                       f"{e.key[:90]}")


def profile_path(torch, main_path) -> None:
    from repro_torch.serve import ContinuousBatcher, ServeConfig
    model, reqs = main_path["model"], main_path["reqs"]
    batcher = ContinuousBatcher(model, ServeConfig(), slots=8, max_len=1024)
    longest = max(reqs, key=lambda r: len(r.prompt))
    toks = {"tokens": torch.as_tensor(longest.prompt[None], device="cuda")}
    with torch.no_grad():
        _profile(torch, f"prefill of one {len(longest.prompt)}-token prompt",
                 lambda: model.prefill(toks, max_len=1024,
                                       serve=ServeConfig()))
    for r in reqs[:8]:
        batcher.admit(r)

    def steps():
        for _ in range(8):
            batcher.step()
    _profile(torch, "8 decode steps at 8 lanes", steps)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
