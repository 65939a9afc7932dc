#!/usr/bin/env python3
"""Smoke run of the repro_torch serving and training paths on one NVIDIA
H100.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` (into ``build/kernels/``), holds each
kernel against its plain PyTorch version on the card, serves
``llama3_2_1b`` at full width (random weights from a seed) through
``ContinuousBatcher`` -- once on the default dense cache, once on the fp8
ring cache -- then holds one SP-NGD capture step on the kernels against
``backend="ref"`` (full width, 2 layers, f32) and trains full-width
``llama3_2_1b`` for 4 steps of ``repro_torch.launch.train``'s loop (each a
capture step or a fast step as the staleness controller decides), then
for a warm-up and three timed steps of the fast-step builder. Then the same
for Stage 4 by Newton-Schulz (``inverse_method="newton_schulz"``): a
capture step on the kernels against ``backend="ref"`` (2 layers, f32) and
full-width training for 2 loop steps and the fast-step builder's warm-up
and three timed steps. Then the fp8 factor slice: the quant_rows,
dequant_rows and factor_syrk_wire kernels against their plain versions, a
capture step with the fp8 history and fused e4m3 capture on the kernels
against ``backend="ref"`` (2 layers, f32), and full-width training with
``factor_dtype="fp8_e4m3"`` and ``factor_wire="e4m3"`` for 3 loop steps and
the fast-step builder's warm-up and two timed steps, its history bytes and
peak memory beside the f32 path's. Then the ``swa_attention`` op: its
kernel against the plain version, then one call at llama3_2_1b's heads
(32 over 8 KV heads, repeated, hd 64, bf16) at S 32768 with the 8192
window of ``repro``'s long-context variant, held against the plain version
on every head and, for its layout, against the model layer's GQA kernel
route. It
times all thirteen kernels beside their bound, their plain version and the
PyTorch library call for the same function.
Every failed check raises, so the exit code is nonzero. Without a CUDA
device, or outside a checkout, it exits nonzero and prints no result.

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
# factor sums and block preconditioning: f32 sums in another order, relative
# to the largest entry (the JAX package's own factor/precond tolerance)
KFAC_REL_TOL = 1e-4
# attention gradients: f32 arithmetic on both sides from the same bf16/f32
# inputs, relative to the largest gradient entry
BWD_REL_TOL = 1e-3
# one SP-NGD capture step, kernels vs backend="ref", f32: loss, raw factor
# families and updated params relative to their largest entry
ROUTE_REL_TOL = 1e-4
# the training path: 4 steps of launch.train at its default configuration
TRAIN = dict(steps=4, batch=4, seq=1024, lr=2e-2, damping=2.5e-4)
# make_fast_step steps timed after the loop (and one warm-up before them)
FAST_TIMED = 3
# the Newton-Schulz training path: 2 loop steps (both capture at random init)
TRAIN_NS = dict(TRAIN, steps=2)
# Newton-Schulz, the whole inverse against the plain iteration on the same
# damped blocks, relative to the largest entry of the plain X: the same f32
# products in another summation order (the initial iterate's norms), which
# measured below 1e-6 on the path's shapes; against eigh, the JAX package's
# NS-vs-eigh tolerance (tests/test_inverse_numerics.py:141). The converged
# flags and the trip counts must agree wherever the plain residual is not
# within NS_FLAG_BAND of the tolerance.
NS_REL_TOL = 1e-5
NS_EIGH_REL_TOL = 5e-3
NS_FLAG_BAND = 0.01
# one residual or update launch: f32 sums in another order, relative to the
# largest entry (the factor and preconditioning kernels' tolerance)
NS_PRODUCT_REL_TOL = 1e-4
# the fp8 training path: 3 loop steps (all capture at random init, so X_-2
# holds a real refresh), then a warm-up and FP8_FAST_TIMED fast steps
TRAIN_FP8 = dict(TRAIN, steps=3)
FP8_FAST_TIMED = 2
# fp8 history bytes against the f32 history's (tests/test_quant.py's bound)
FP8_HIST_RATIO = 0.27
# factor_syrk_wire's payload and scales are quant_rows' of its own f32 sums
# bit for bit; those sums differ from the plain version's in summation order
# only, relative to the largest |A| (the route check's scales, one per
# block, are held to the same bound)
WIRE_SCALE_REL_TOL = 2e-5
# swa_flash against its plain version in f32: the attention forward's
# tolerance in the JAX package's ref-vs-Pallas checks
SWA_F32_TOL = dict(atol=2e-4, rtol=2e-4)
# swa_flash's bf16 output against the plain version on the same inputs
# upcast to f32 (its output left in f32): the output's own rounding, at most
# bf16's unit roundoff 2^-8 of |out|, plus f32 sums in another order. At the
# path's window a typical |out| is 0.015, so an element may be off by about
# 8e-5 there, while a key dropped or added at the window's edge moves most
# rows by about 1e-4 (FWD_TOL would let through 1e-2).
SWA_BF16_TOL = dict(atol=2e-5, rtol=2 ** -8)
# two bf16 outputs, each within SWA_BF16_TOL of the same f32 value
SWA_ROUTE_TOL = dict(atol=4e-5, rtol=2 ** -7)
# the swa_attention op's path: the long-context sliding window repro
# documents for llama3_2_1b (SWA_FOR_LONG, src/repro/launch/dryrun.py:48)
# at the prefill_32k length (src/repro/configs/base.py:114)
SWA_PATH = dict(seq=32768, window=8192)


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
    t0 = t_start = time.perf_counter()
    build.build(verbose=True)
    build.load()
    say("build", f"nvcc sm_90a, {len(build.SIGNATURES)} libraries in "
                 f"{time.perf_counter() - t0:.1f} s")

    errs = {"swa_flash_fwd": check_prefill_kernel(torch),
            "swa_flash_decode": check_decode_kernel(torch),
            "factor_syrk": check_factor_kernel(torch),
            "block_precond": check_precond_kernel(torch)}
    errs.update(check_attention_bwd_kernels(torch))
    main_path = serve_main_path(torch)
    ring = serve_ring_path(torch, main_path["model"])
    check_f32_route(torch)
    times = time_kernels(torch, main_path, ring)
    profile_path(torch, main_path)
    launches = dict(main_path.pop("launches"))
    del main_path, ring
    torch.cuda.empty_cache()

    check_train_route(torch)
    check_ns_route(torch)
    train = train_path(torch)
    launches.update({k: train["launches"][k] for k in TRAIN_KERNELS})
    times.update(time_train_kernels(torch))
    times.update(time_factor_sums(torch))
    profile_train(torch, train)

    errs.update(check_ns_kernels(torch))
    ns_path = train_path_ns(torch, train)
    launches.update({k: ns_path["launches"][k] for k in NS_KERNELS})
    times.update(time_ns_kernels(torch))
    t_fp8 = time.perf_counter()

    clock = {}

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        clock[fn.__name__] = time.perf_counter() - t
        return out
    errs.update(timed(check_fp8_kernels, torch))
    timed(check_fp8_route, torch)
    fp8_path = timed(train_path_fp8, torch, train)
    launches.update({k: fp8_path["launches"][k] for k in FP8_KERNELS})
    times.update(timed(time_fp8_kernels, torch))
    del train, ns_path, fp8_path
    t_swa = time.perf_counter()
    errs.update(timed(check_swa_kernel, torch))
    launches["swa_flash"] = timed(swa_path, torch)["launches"]["swa_flash"]
    times.update(timed(time_swa_kernel, torch))
    t_end = time.perf_counter()
    say("clock", f"{t_end - t_start:.1f} s from the build on, the fp8 "
                 f"phases {t_swa - t_fp8:.1f} s and the swa_attention phases "
                 f"{t_end - t_swa:.1f} s of it ("
                 + ", ".join(f"{k} {v:.1f} s" for k, v in clock.items()) + ")")

    rows = []
    for name, source, replaces in KERNEL_ROWS:
        t = times[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{source}.cu",
                     "replaces": replaces,
                     "launches": launches[name],
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


# the thirteen kernels: name, source stem, the TPU kernel it replaces
KERNEL_ROWS = (
    ("swa_flash", "swa_flash", "src/repro/kernels/swa_attention.py:104"),
    ("swa_flash_fwd", "swa_flash_fwd", "src/repro/kernels/swa_attention.py:292"),
    ("swa_flash_decode", "swa_flash_decode",
     "src/repro/kernels/swa_attention.py:206"),
    ("factor_syrk", "kfac_factor", "src/repro/kernels/kfac_factor.py:54"),
    ("block_precond", "kfac_precond", "src/repro/kernels/kfac_precond.py:35"),
    ("swa_flash_bwd_dq", "swa_flash_bwd",
     "src/repro/kernels/swa_attention.py:375"),
    ("swa_flash_bwd_dkdv", "swa_flash_bwd",
     "src/repro/kernels/swa_attention.py:444"),
    ("ns_inverse_blocks", "newton_schulz",
     "src/repro/kernels/newton_schulz.py:91"),
    ("ns_tiled_residual", "newton_schulz",
     "src/repro/kernels/newton_schulz.py:165"),
    ("ns_tiled_update", "newton_schulz",
     "src/repro/kernels/newton_schulz.py:207"),
    ("factor_syrk_wire", "kfac_factor",
     "src/repro/kernels/kfac_factor.py:113"),
    ("quant_rows", "quant_pack", "src/repro/kernels/quant_pack.py:48"),
    ("dequant_rows", "quant_pack", "src/repro/kernels/quant_pack.py:75"),
)
TRAIN_KERNELS = ("factor_syrk", "block_precond", "swa_flash_bwd_dq",
                 "swa_flash_bwd_dkdv")
NS_KERNELS = ("ns_inverse_blocks", "ns_tiled_residual", "ns_tiled_update")
FP8_KERNELS = ("factor_syrk_wire", "quant_rows", "dequant_rows")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_prefill_kernel(torch) -> float:
    from repro_torch.kernels import ref, swa_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    # serving shapes, and the training path's call (32, 4, 1024, causal)
    cases = [(bkv, 4, s, w) for bkv in (8, 64) for s in (1000, 2048)
             for w in (0, 256)] + [(8, 1, 1000, 0), (32, 4, 1024, 0)]
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
    if "swa_" in low:
        return "attention kernels"
    if "factor_syrk" in low or "pack_quant" in low:
        return "factor sums"
    if "block_precond" in low:
        return "block_precond"
    if "ns_inverse_blocks" in low or "ns_tiled" in low:
        return "Stage-4 Newton-Schulz kernels"
    if any(t in low for t in ("syevd", "syevj", "sytrd", "ormtr", "orgtr",
                              "steqr", "stedc", "eig", "cusolver", "lansy",
                              "larf", "potrf")):
        return "Stage-4 eigh (cuSOLVER)"
    if any(t in low for t in ("gemm", "gemv", "xmma", "nvjet", "cutlass",
                              "matmul")):
        return "matmuls (cuBLAS)"
    return "other (elementwise, copies, reductions, memsets)"


def _profile(torch, label, fn, warm: bool = True) -> None:
    """Device time by kernel and by group over ``fn``, and the device's busy
    share of the wall time (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
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

# ---------------------------------------------------------------------------
# the training kernels against their plain versions
# ---------------------------------------------------------------------------

def _rel_err(torch, got, want) -> float:
    return _max_err(torch, got, want) / max(float(want.float().abs().max()),
                                            1e-30)


def check_factor_kernel(torch) -> float:
    """factor_syrk vs the plain blocked einsum at the training path's
    shapes (n 4096 x d 2048 / 8192 / 512 with max_dim 2048), a ragged n and
    a padded last block, bf16 and f32; each case launched twice, the two
    outputs identical."""
    from repro_torch.kernels import kfac, ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    cases = [(4096, 2048, 2048), (4096, 8192, 2048), (4096, 512, 2048),
             (4000, 2048, 2048), (1000, 2050, 1024)]
    for dtype in (torch.bfloat16, torch.float32):
        for n, d, max_dim in cases:
            x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
            got = kfac.factor_syrk(x, max_dim)
            again = kfac.factor_syrk(x, max_dim)
            torch.cuda.synchronize()
            want = ref.factor_sum_ref(x, max_dim)
            check(got.shape == want.shape, f"factor_syrk shape {got.shape}")
            # shared tiles are summed in a fixed order: no run-to-run change
            check(torch.equal(got, again), f"factor_syrk n={n} d={d} "
                                           f"{dtype}: two launches differ")
            err = _rel_err(torch, got, want)
            check(err <= KFAC_REL_TOL, f"factor_syrk n={n} d={d} {dtype}: "
                                       f"rel err {err} > {KFAC_REL_TOL}")
            worst = max(worst, _max_err(torch, got, want))
            say("factor-kernel", f"n={n} d={d} max_dim={max_dim} -> "
                                 f"{tuple(got.shape)} {dtype}: max|err| / "
                                 f"max|A| = {err:.3e} (tol {KFAC_REL_TOL}), "
                                 f"a second launch identical")
    torch.cuda.empty_cache()
    return worst


def check_precond_kernel(torch) -> float:
    """block_precond, both modes, vs the plain blocked einsum: every shape
    of the training path (b 2048; m 512 .. 128256; nb 1 and 4) and a
    ragged last block."""
    from repro_torch.kernels import dispatch, kfac
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    # (mode, nb, b, dim, other)
    cases = [("left", 1, 2048, 2048, m) for m in (512, 2048, 8192, 128256)]
    cases += [("left", 4, 2048, 8192, 2048), ("right", 1, 2048, 2048, 2048),
              ("right", 1, 2048, 2048, 8192), ("right", 1, 2048, 2048, 128256),
              ("right", 4, 2048, 8192, 2048), ("right", 1, 512, 512, 2048),
              ("left", 3, 684, 2050, 300), ("right", 3, 684, 2050, 300)]
    for mode, nb, b, dim, other in cases:
        binv = torch.randn((nb, b, b), generator=gen, device="cuda") / b ** 0.5
        shape = (dim, other) if mode == "left" else (other, dim)
        w = torch.randn(shape, generator=gen, device="cuda")
        right = mode == "right"
        got = kfac.block_precond(binv, w, right=right)
        torch.cuda.synchronize()
        want = (dispatch.lookup("block_precond_right", "ref")(w, binv) if right
                else dispatch.lookup("block_precond_left", "ref")(binv, w))
        err = _rel_err(torch, got, want)
        check(err <= KFAC_REL_TOL, f"block_precond {mode} {shape}: rel err "
                                   f"{err} > {KFAC_REL_TOL}")
        worst = max(worst, _max_err(torch, got, want))
        say("precond-kernel", f"{mode} binv ({nb}, {b}, {b}) w {shape} f32: "
                              f"max|err| / max|U| = {err:.3e} "
                              f"(tol {KFAC_REL_TOL})")
        del binv, w, got, want
    # the dispatch op on an expanded identity (a fresh optimizer state's
    # preconditioner), 3 blocks of 97 over 290 columns
    eye = torch.eye(97, device="cuda").expand(3, 97, 97)
    w = torch.randn((70, 290), generator=gen, device="cuda")
    got = dispatch.block_precond_right(w, eye, backend="cuda")
    err = _rel_err(torch, got, w)
    check(err <= KFAC_REL_TOL, f"dispatch.block_precond_right identity: {err}")
    say("precond-kernel", f"dispatch.block_precond_right w (70, 290) x an "
                          f"expanded identity (3, 97, 97): {err:.3e}")
    torch.cuda.empty_cache()
    return worst


def check_attention_bwd_kernels(torch) -> dict:
    """dq / dk / dv vs the plain backward at the training path's call (BKV
    32, G 4, S 1024, hd 64, bf16; window 0 and 256), plus S 1000, G 1 and
    hd 128, each from the plain forward's (o, lse). At the training call
    the kernel chain (the forward kernel's o and lse into the backward
    kernels, as the training path runs them) is held against the plain
    chain as well."""
    from repro_torch.kernels import ref, swa_attention
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {"swa_flash_bwd_dq": 0.0, "swa_flash_bwd_dkdv": 0.0}
    cases = [(32, 4, 1024, 64, 0, torch.bfloat16),
             (32, 4, 1024, 64, 256, torch.bfloat16),
             (8, 4, 1000, 64, 0, torch.bfloat16),
             (8, 1, 1000, 64, 100, torch.bfloat16),
             (8, 4, 1000, 128, 0, torch.bfloat16),
             (4, 4, 517, 64, 0, torch.float32),
             (4, 2, 517, 128, 64, torch.float32)]
    for bkv, g, s, hd, window, dtype in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        q, k, v, do = rnd(bkv, g, s, hd), rnd(bkv, s, hd), rnd(bkv, s, hd), \
            rnd(bkv, g, s, hd)
        o, lse = ref.swa_attention_fwd_res_ref(q, k, v, window=window)
        want = ref.swa_attention_bwd_ref(q, k, v, o, lse, do, window=window)
        routes = [("plain (o, lse)", o, lse)]
        if (bkv, g, s, hd) == (32, 4, 1024, 64):
            routes.append(("kernel (o, lse)", *swa_attention.swa_flash_fwd(
                q, k, v, window=window)))
        for label, o_, lse_ in routes:
            got = swa_attention.swa_flash_bwd(q, k, v, o_, lse_, do,
                                              window=window)
            torch.cuda.synchronize()
            errs = [_rel_err(torch, a, b_) for a, b_ in zip(got, want)]
            check(max(errs) <= BWD_REL_TOL,
                  f"attention bwd BKV={bkv} G={g} S={s} hd={hd} window="
                  f"{window} {dtype} from the {label}: rel errs {errs} > "
                  f"{BWD_REL_TOL}")
            worst["swa_flash_bwd_dq"] = max(worst["swa_flash_bwd_dq"],
                                            _max_err(torch, got[0], want[0]))
            worst["swa_flash_bwd_dkdv"] = max(
                worst["swa_flash_bwd_dkdv"], _max_err(torch, got[1], want[1]),
                _max_err(torch, got[2], want[2]))
            say("attn-bwd-kernel", f"BKV={bkv} G={g} S={s} hd={hd} window="
                                   f"{window} {dtype} from the {label}: "
                                   f"max|err| / max|grad| dq {errs[0]:.3e} dk "
                                   f"{errs[1]:.3e} dv {errs[2]:.3e} (tol "
                                   f"{BWD_REL_TOL})")
            del got
        del q, k, v, do, o, lse, want, routes
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def _train_batch(torch, vocab, batch, seq, index: int = 0):
    """Batch ``index`` of the trainer's synthetic stream (seed 0)."""
    from repro_torch.data.synthetic import token_batches
    data = token_batches(vocab, batch, seq, seed=0)
    for _ in range(index):
        next(data)
    return {k: v.cuda() for k, v in next(data).items()}


def _route_cfg(torch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3_2_1b"), n_layers=2,
                               dtype=torch.float32)


def _route_step(torch, cfg, batch, backend: str, capture=None,
                **build_kw) -> dict:
    """One SP-NGD capture step, every statistic refreshed, from the seed-0
    model: its loss, raw factor families, updated params, preconditioners,
    encoded history and (with Newton-Schulz) the per-block Stage-4 info,
    all copied out, and under "capture" a copy of the backward's (loss,
    aux, grads, raw). With ``capture`` the step takes that backward's
    output instead, after running its own only to return its loss and
    raw factor families under "own_loss" and "own_raw"."""
    from repro_torch.core.fisher import flatten, unflatten
    from repro_torch.launch import train
    model, opt, params, state = train.build(cfg=cfg, backend=backend,
                                            device="cuda", **build_kw)

    def copy(tree):
        return unflatten({k: v.clone() for k, v in flatten(tree).items()},
                         tree)
    own = (None, None)
    if capture is None:
        loss, aux, grads, raw = opt.grads_and_raw(params, batch)
    else:
        o_loss, _, _, o_raw = opt.grads_and_raw(params, batch)
        own = (float(o_loss), {k: v.clone() for k, v in
                               flatten(o_raw).items()})
        del o_raw
        loss, aux, grads, raw = capture[0], capture[1], copy(capture[2]), \
            copy(capture[3])
    kept = (loss, aux, copy(grads), copy(raw))
    flags = {k: True for k in opt.stat_names()}
    raw_flat = {k: v.clone() for k, v in flatten(raw).items()}
    _, state, m = opt.apply_update(params, state, grads, raw,
                                   model.site_counts(batch), flags,
                                   TRAIN["damping"], TRAIN["lr"], 0.9, loss,
                                   aux)
    out = {"loss": float(loss), "raw": raw_flat,
           "params": {k: v.detach().clone()
                      for k, v in flatten(params).items()},
           "precond": {f"{fam}.{k}": v.clone()
                       for fam, c in state["curv"].items()
                       for k, v in c["precond"].items()},
           "prev": {k: v.clone() for k, v in flatten(
               {fam: c["prev"] for fam, c in state["curv"].items()}).items()},
           "info": m.get("inverse_info", {}), "capture": kept,
           "own_loss": own[0], "own_raw": own[1]}
    del model, opt, params, state, grads, raw, m
    torch.cuda.empty_cache()
    return out


def check_train_route(torch) -> None:
    """One SP-NGD capture step at full width, 2 layers, f32, through the
    kernels and again with backend="ref" on the card: the loss, the raw
    factor families and the updated params agree."""
    cfg = _route_cfg(torch)
    batch = _train_batch(torch, cfg.vocab, 2, 512)
    k, r = (_route_step(torch, cfg, batch, b) for b in ("auto", "ref"))
    lk, lr_ = k["loss"], r["loss"]
    check(abs(lk - lr_) <= ROUTE_REL_TOL * abs(lr_),
          f"route loss {lk} vs {lr_}")
    worst_raw = max(_rel_err(torch, k["raw"][n], r["raw"][n])
                    for n in r["raw"])
    worst_p = max(_rel_err(torch, k["params"][n], r["params"][n])
                  for n in r["params"])
    check(worst_raw <= ROUTE_REL_TOL, f"route raw factors rel err {worst_raw}")
    check(worst_p <= ROUTE_REL_TOL, f"route updated params rel err {worst_p}")
    say("train-route", f"llama3_2_1b width, 2 layers, f32, batch (2, 512): "
                       f"one capture step kernels vs backend='ref': loss "
                       f"{lk:.6f} vs {lr_:.6f}; worst max|err|/max over "
                       f"{len(r['raw'])} raw factor families {worst_raw:.3e}, "
                       f"over {len(r['params'])} updated params {worst_p:.3e} "
                       f"(tol {ROUTE_REL_TOL})")


def check_ns_route(torch) -> None:
    """One capture step at full width, 2 layers, f32, with Stage 4 by
    Newton-Schulz, on the kernels and with backend="ref" (the plain
    iteration): the loss, every preconditioner within ROUTE_REL_TOL of its
    largest entry (the raw factors already differ by the factor kernel's
    summation order), and identical per-block converged flags."""
    from repro_torch.core.kfac import NS_TOL
    cfg = _route_cfg(torch)
    batch = _train_batch(torch, cfg.vocab, 2, 512)
    k, r = (_route_step(torch, cfg, batch, b, inverse_method="newton_schulz")
            for b in ("auto", "ref"))
    check(abs(k["loss"] - r["loss"]) <= ROUTE_REL_TOL * abs(r["loss"]),
          f"NS route loss {k['loss']} vs {r['loss']}")
    worst = max(_rel_err(torch, k["precond"][n], r["precond"][n])
                for n in r["precond"])
    check(worst <= ROUTE_REL_TOL, f"NS route preconditioners rel err {worst}")
    check(set(k["info"]) == set(r["info"]) and r["info"],
          f"NS route info keys {sorted(k['info'])} vs {sorted(r['info'])}")
    blocks = near = fell = 0
    for n, ri in r["info"].items():
        check(torch.equal(k["info"][n]["ns_converged"], ri["ns_converged"]),
              f"NS route {n}: converged flags "
              f"{k['info'][n]['ns_converged'].tolist()} vs "
              f"{ri['ns_converged'].tolist()}")
        blocks += ri["ns_res"].numel()
        near += int(((ri["ns_res"] - NS_TOL).abs()
                     <= NS_FLAG_BAND * NS_TOL).sum())
        fell += int((~ri["ns_converged"]).sum())
    say("ns-route", f"llama3_2_1b width, 2 layers, f32, batch (2, 512): one "
                    f"capture step, inverse_method=newton_schulz, kernels vs "
                    f"backend='ref': loss {k['loss']:.6f} vs {r['loss']:.6f}; "
                    f"worst max|err|/max over {len(r['precond'])} "
                    f"preconditioners {worst:.3e} (tol {ROUTE_REL_TOL}); "
                    f"converged flags equal over {blocks} blocks ({near} "
                    f"within {NS_FLAG_BAND:.0%} of tol, {fell} fell back to "
                    f"eigh in the plain run)")


class _Stage4Timer:
    """Times every damped_inverse dispatch (the batched inverse of one
    factor family: eigh, or Newton-Schulz with its eigh fallback) with a
    synchronized host clock, by wrapping its cuda entry."""

    def __init__(self, torch):
        from repro_torch.kernels import dispatch
        self.torch, self.dispatch = torch, dispatch
        self.inner = dispatch.lookup("damped_inverse", "cuda")
        self.seconds, self.calls, self.blocks = 0.0, 0, 0

    def __enter__(self):
        def timed(f, damping, method):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.inner(f, damping, method)
            self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t
            self.calls += 1
            self.blocks += f.numel() // (f.shape[-1] * f.shape[-2])
            return out
        self.dispatch.register("damped_inverse", "cuda", timed)
        return self

    def __exit__(self, *exc):
        self.dispatch.register("damped_inverse", "cuda", self.inner)


# the dispatch ops of the fp8 slice: capture, history encode, decode
FP8_OPS = ("factor_sum_wire", "fp8_pack", "fp8_unpack")


class _OpTimer:
    """Times every call of the given dispatch ops' cuda entries with a
    synchronized host clock, by wrapping them."""

    def __init__(self, torch, ops):
        from repro_torch.kernels import dispatch
        self.torch, self.dispatch = torch, dispatch
        self.inner = {op: dispatch.lookup(op, "cuda") for op in ops}
        self.seconds = {op: 0.0 for op in ops}
        self.calls = {op: 0 for op in ops}

    def __enter__(self):
        for op, fn in self.inner.items():
            def timed(*a, _op=op, _fn=fn):
                self.torch.cuda.synchronize()
                t = time.perf_counter()
                out = _fn(*a)
                self.torch.cuda.synchronize()
                self.seconds[_op] += time.perf_counter() - t
                self.calls[_op] += 1
                return out
            self.dispatch.register(op, "cuda", timed)
        return self

    def __exit__(self, *exc):
        for op, fn in self.inner.items():
            self.dispatch.register(op, "cuda", fn)


def _train_counts(cfg, kinds) -> dict:
    """Launches reckoned from the code for a run of ``kinds``: per layer 7
    dense sites with a full A and G factor, plus the head's A and the
    embedding's G, give 7*2*L + 2 factor sums per capture step and as many
    block preconditionings per step; the attention forward runs twice per
    layer and step (the block is recomputed under remat), each backward
    kernel once."""
    n_cap = kinds.count("capture")
    sites = 7 * 2 * cfg.n_layers + 2
    return {"factor_syrk": sites * n_cap,
            "block_precond": sites * len(kinds),
            "swa_flash_fwd": 2 * cfg.n_layers * len(kinds),
            "swa_flash_bwd_dq": cfg.n_layers * len(kinds),
            "swa_flash_bwd_dkdv": cfg.n_layers * len(kinds)}


def _fast_steps(torch, model, opt, params, state, recs, spec, phase,
                timed: int = FAST_TIMED):
    """The fast-step builder (make_fast_step, the stale-preconditioned step
    the controller takes once intervals grow) on the stream's next batches
    at the loop's last learning rate and momentum: one warm-up step, then
    ``timed`` timed ones, appended to ``recs``. Returns (params, state)."""
    from repro_torch.launch import train
    from repro_torch.optim.schedules import polynomial_decay
    fast = train.make_fast_step(model, opt)
    lr = polynomial_decay(spec["lr"], 0, spec["steps"], 4.0)(
        spec["steps"] - 1)
    for i in range(1 + timed):
        batch = _train_batch(torch, model.cfg.vocab, spec["batch"],
                             spec["seq"], index=len(recs))
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = fast(params, state, batch, spec["damping"], lr,
                                0.9 * lr / spec["lr"])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        recs.append({"t": len(recs) + 1, "kind": "fast", "loss": loss,
                     "seconds": time.perf_counter() - t, "warm": i == 0})
        say(phase, f"step {len(recs)} fast (make_fast_step on the stale "
                   f"preconditioners{', warm-up' if i == 0 else ''}) loss "
                   f"{loss:.4f} {recs[-1]['seconds']:.3f} s")
    return params, state


def train_path(torch) -> dict:
    """launch.train's step loop at its default configuration, full-width
    llama3_2_1b, 4 steps as the IntervalController decides them; then
    1 + FAST_TIMED steps of the fast-step builder, so both step builders
    run on the card (at random init the controller refreshes at step 4
    too). Every loss finite, the launches as reckoned from the steps taken,
    no ref dispatch."""
    import math
    from repro_torch.kernels import dispatch, kfac, swa_attention
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, opt, params, state = train.build("llama3_2_1b", full_config=True,
                                            device="cuda")
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    say("train-path", f"llama3_2_1b full width: {cfg.n_layers} layers, d "
                      f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
                      f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, remat "
                      f"{cfg.remat}, kfac_max_dim {cfg.kfac_max_dim}, head_g "
                      f"{cfg.head_g_kind}; {n_params} params, "
                      f"{len(opt.stat_names())} statistics; init "
                      f"{time.perf_counter() - t:.1f} s")
    swa_attention.reset_launches()
    kfac.reset_launches()
    dispatch.reset_calls()
    with _Stage4Timer(torch) as s4:
        params, state, recs = train.run(model, opt, params, state,
                                        log=lambda m: say("train-path", m),
                                        **TRAIN)
    for r in recs[1:]:
        d = [v for v in r["sims"].values() if v[0] >= 0]
        say("train-path", f"step {r['t']} ({r['kind']}, {r['n_refreshed']}/"
                          f"{r['n_stats']} refreshed): Algorithm-2 distances "
                          f"to X_-1 {min(x[0] for x in d):.3f}-"
                          f"{max(x[0] for x in d):.3f}, to X_-2 "
                          f"{min(x[1] for x in d):.3f}-"
                          f"{max(x[1] for x in d):.3f} (alpha 0.1)"
                if d else f"step {r['t']} ({r['kind']})")
    params, state = _fast_steps(torch, model, opt, params, state, recs,
                                TRAIN, "train-path")
    kinds = [r["kind"] for r in recs]
    launches = {**swa_attention.LAUNCHES, **kfac.LAUNCHES}
    calls = dict(dispatch.CALLS)
    peak = torch.cuda.max_memory_allocated()
    check(kinds[:3] == ["capture"] * 3 and "fast" in kinds,
          f"step kinds {kinds}: the first three steps capture and one step "
          "takes the fast builder")
    check(all(math.isfinite(r["loss"]) for r in recs),
          f"losses {[r['loss'] for r in recs]}")
    want = _train_counts(cfg, kinds)
    got = {k: launches[k] for k in want}
    check(got == want, f"train launches {got} != reckoned {want}")
    check(launches["swa_flash_decode"] == 0, "no decode kernel in training")
    check(not any(b == "ref" for (_, b) in calls), f"ref dispatches: {calls}")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    cap = [r["seconds"] for r in recs if r["kind"] == "capture"]
    fast_s = [r["seconds"] for r in recs
              if r["kind"] == "fast" and not r.get("warm")]
    say("train-path", f"{len(recs)} steps of batch {TRAIN['batch']} x seq "
                      f"{TRAIN['seq']} ({tokens} tokens/step): losses "
                      f"{[round(r['loss'], 6) for r in recs]}; kinds {kinds}")
    say("train-path", f"capture step wall {[round(x, 3) for x in cap]} s "
                      f"({tokens / statistics.median(cap):.1f} tokens/s at the "
                      f"median), fast step {[round(x, 3) for x in fast_s]} s "
                      f"after a warm-up, median {statistics.median(fast_s):.3f}"
                      f" s, range {min(fast_s):.3f}-{max(fast_s):.3f} s "
                      f"({tokens / statistics.median(fast_s):.1f} tokens/s at "
                      f"the median); "
                      f"Stage-4 eigh {s4.seconds:.3f} s over {s4.calls} batched "
                      f"calls ({s4.blocks} blocks) in {len(cap)} refreshes; "
                      f"peak memory {peak / 2 ** 30:.2f} GiB "
                      f"(torch.cuda.max_memory_allocated); {card_note(torch)}")
    say("train-path", f"launches {got} (reckoned {want}); dispatches {calls}")
    return {"launches": launches, "model": model, "opt": opt,
            "params": params, "state": state, "cfg": cfg,
            "first_loss": recs[0]["loss"], "stage4_s": s4.seconds,
            "refreshes": len(cap), "peak": peak}


def _attn_inputs(torch, gen, bkv, g, s, hd, dtype):
    from repro_torch.kernels import ref
    q = torch.randn((bkv, g, s, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((bkv, s, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((bkv, s, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((bkv, g, s, hd), generator=gen, device="cuda").to(dtype)
    o, lse = ref.swa_attention_fwd_res_ref(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, o, lse, delta


def time_train_kernels(torch) -> dict:
    """block_precond and the attention backward pair at the training path's
    commonest shapes, beside their bound, plain version and one PyTorch
    library call (the factor sums: time_factor_sums)."""
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch, kfac, ref, swa_attention
    gen = torch.Generator(device="cuda").manual_seed(7)
    res = {}

    # block preconditioning: an mlp up/gate A side, (1, 2048, 2048) x
    # (2048, 8192), f32
    b, m = 2048, 8192
    binv = torch.randn((1, b, b), generator=gen, device="cuda") / b ** 0.5
    w = torch.randn((b, m), generator=gen, device="cuda")
    bound, by = _bound(2 * b * b * m, (b * b + 2 * b * m) * 4, w.dtype)
    left_ref = dispatch.lookup("block_precond_left", "ref")
    res["block_precond"] = {
        "ms": _time_ms(torch, lambda: kfac.block_precond(binv, w)),
        "plain_ms": _time_ms(torch, lambda: left_ref(binv, w)),
        "library_ms": _time_ms(torch, lambda: torch.matmul(binv[0], w)),
        "bound_ms": bound, "bound_by": by}
    say("times", f"block_precond left binv (1, {b}, {b}) w ({b}, {m}) f32: "
                 f"{res['block_precond']} (library: cuBLAS f32 matmul, TF32 "
                 f"off); {card_note(torch)}")
    wh = torch.randn((128256, b), generator=gen, device="cuda")
    msh = _time_ms(torch, lambda: kfac.block_precond(binv, wh, right=True),
                   reps=5)
    libh = _time_ms(torch, lambda: torch.matmul(wh, binv[0]), reps=5)
    bh, byh = _bound(2 * b * b * 128256, (b * b + 2 * b * 128256) * 4,
                     wh.dtype)
    say("times", f"block_precond right w (128256, {b}) binv (1, {b}, {b}) "
                 f"(the embedding's G side): ms {msh:.4f}, bound_ms {bh:.6f} "
                 f"({byh}), library_ms {libh:.4f}; {card_note(torch)}")
    del binv, w, wh

    # attention backward: one layer's call, BKV 32 (4 x 8 KV heads), G 4,
    # S 1024, hd 64, bf16, causal
    bkv, g, s, hd = 32, 4, 1024, 64
    q, k, v, do, o, lse, delta = _attn_inputs(torch, gen, bkv, g, s, hd,
                                              torch.bfloat16)
    pairs = bkv * g * s * (s + 1) // 2
    row_bytes = bkv * g * s * 4
    in_bytes = 2 * (2 * q.numel() + 2 * k.numel())
    b_dq, by_dq = _bound(6 * hd * pairs, in_bytes + 2 * row_bytes
                         + q.numel() * 4, q.dtype)
    b_kv, by_kv = _bound(8 * hd * pairs, in_bytes + 2 * row_bytes
                         + 2 * k.numel() * 4, q.dtype)
    plain = _time_ms(torch, lambda: ref.swa_attention_bwd_ref(q, k, v, o, lse,
                                                              do), reps=5)
    # SDPA's layout: (batch 4, heads 32, S, hd) with the 8 KV heads
    qs = q.reshape(4, 8 * g, s, hd).detach().requires_grad_()
    ks_ = k.reshape(4, 8, s, hd).detach().requires_grad_()
    vs_ = v.reshape(4, 8, s, hd).detach().requires_grad_()
    out = F.scaled_dot_product_attention(qs, ks_, vs_, is_causal=True,
                                         enable_gqa=True)
    gout = do.reshape(4, 8 * g, s, hd)
    lib = _time_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks_, vs_), gout, retain_graph=True))
    res["swa_flash_bwd_dq"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_bwd_dq(
            q, k, v, lse, delta, do)),
        "plain_ms": plain, "library_ms": lib, "bound_ms": b_dq,
        "bound_by": by_dq}
    res["swa_flash_bwd_dkdv"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_bwd_dkdv(
            q, k, v, lse, delta, do)),
        "plain_ms": plain, "library_ms": lib, "bound_ms": b_kv,
        "bound_by": by_kv}
    say("times", f"swa_flash_bwd BKV={bkv} G={g} S={s} hd={hd} bf16 causal: "
                 f"dq {res['swa_flash_bwd_dq']}, dkdv "
                 f"{res['swa_flash_bwd_dkdv']} (plain and library are the "
                 f"whole backward: the plain dq/dk/dv from materialized "
                 f"scores, SDPA's backward with enable_gqa); "
                 f"{card_note(torch)}")
    return res


def profile_train(torch, train) -> None:
    """Device time by kernel group over one fast step and one capture step
    (every statistic refreshed) of the trained model, and the device's busy
    share of the wall time."""
    from repro_torch.launch import train as train_lib
    model, opt = train["model"], train["opt"]
    params, state = train["params"], train["state"]
    batch = _train_batch(torch, model.cfg.vocab, TRAIN["batch"], TRAIN["seq"])
    fast = train_lib.make_fast_step(model, opt)
    capture = train_lib.make_train_step(model, opt)
    flags = {k: True for k in opt.stat_names()}
    lr, lam = 1e-4, TRAIN["damping"]
    box = {"state": state}

    def fast_step():
        _, box["state"], _ = fast(params, box["state"], batch, lam, lr, 0.0)

    def capture_step():
        _, box["state"], _ = capture(params, box["state"], batch, flags, lam,
                                     lr, 0.0)
    _profile(torch, "one fast train step (4096 tokens)", fast_step)
    _profile(torch, "one capture train step, every statistic refreshed",
             capture_step, warm=False)
    del train["model"], train["opt"], train["params"], train["state"]
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# Stage 4 by Newton-Schulz
# ---------------------------------------------------------------------------

def _ns_factors(torch, gen, g, b, spread: float, damping: float):
    """Damped symmetric blocks as the training path builds them: Gram
    matrices of bf16 tokens summed in f32 (n = 2b tokens, column scales
    log-spread over ``spread`` decades), plus ``damping`` times their mean
    eigenvalue. Returns (f, d, m): the factors, the damping (g,) and
    M = sym(f) + d I."""
    from repro_torch.core import kfac
    n = 2 * b
    scale = torch.logspace(0, -spread, b, device="cuda")
    x = (torch.randn((g, n, b), generator=gen, device="cuda") * scale).to(
        torch.bfloat16).float()
    f = x.transpose(-1, -2) @ x / n
    del x
    d = damping * torch.diagonal(f, dim1=-2, dim2=-1).mean(-1)
    return f, d, kfac.damped_sym(f, d)


def check_ns_kernels(torch) -> dict:
    """The three Newton-Schulz kernels against their plain versions at the
    training path's shapes: the resident kernel at (16, 512, 512) on blocks
    that converge and on ill-conditioned ones that must fall back to eigh;
    one residual and one update launch at (64, 2048, 2048), with frozen
    blocks; the whole tiled inverse at (16, 2048, 2048); ragged b 1000
    (resident) and 1100 (tiled)."""
    from repro_torch.core import kfac
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import newton_schulz as ns
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = {k: 0.0 for k in NS_KERNELS}
    iters, tol = kfac.NS_ITERS, kfac.NS_TOL

    def whole(label, g, b, spread, damping, expect_conv: bool):
        f, d, m = _ns_factors(torch, gen, g, b, spread, damping)
        x, res, trips = ns.ns_inverse(m, iters, tol)
        torch.cuda.synchronize()
        want, wres, wtrips = ref.ns_inverse_blocks_ref(m, iters, tol)
        conv, wconv = res <= tol, wres <= tol
        # flags and trips equal wherever the plain residual is not within
        # NS_FLAG_BAND of tol
        borderline = (wres - tol).abs() <= NS_FLAG_BAND * tol
        near = int(borderline.sum())
        check(bool(((conv == wconv) | borderline).all()),
              f"NS {label}: converged {conv.tolist()} vs plain "
              f"{wconv.tolist()} (plain res {wres.tolist()})")
        check(bool(((trips == wtrips) | borderline).all()),
              f"NS {label}: trips {trips.tolist()} vs plain "
              f"{wtrips.tolist()}")
        check(bool((wconv == expect_conv).all()),
              f"NS {label}: expected every block to "
              f"{'converge' if expect_conv else 'fail'}; plain res "
              f"{wres.tolist()}")
        kern = "ns_inverse_blocks" if ns.route(b) == "resident" else \
            "ns_tiled_update"
        msg = f"NS {label} ({g}, {b}, {b}) via {ns.route(b)}: trips " \
              f"{int(trips.min())}-{int(trips.max())} (equal to the plain " \
              f"iteration's), res " \
              f"{float(res.min()):.2e}-{float(res.max()):.2e} (plain " \
              f"{float(wres.min()):.2e}-{float(wres.max()):.2e})"
        if expect_conv:
            err = _rel_err(torch, x, want)
            check(err <= NS_REL_TOL, f"NS {label}: rel err {err} > "
                                     f"{NS_REL_TOL}")
            eigh = kfac.damped_inverse(f, d)
            e_err = max(_rel_err(torch, x[i], eigh[i]) for i in range(g))
            check(e_err <= NS_EIGH_REL_TOL, f"NS {label}: vs eigh {e_err}")
            worst[kern] = max(worst[kern], _max_err(torch, x, want))
            msg += (f"; max|err|/max vs plain {err:.3e} (tol {NS_REL_TOL}), "
                    f"vs eigh {e_err:.3e} (tol {NS_EIGH_REL_TOL})")
        else:
            # through the dispatch op: every block re-solved by eigh
            inv, info = dispatch.damped_inverse(
                f, d, method="newton_schulz", backend="cuda",
                return_info=True)
            eigh = kfac.damped_inverse(f, d)
            check(not bool(info["ns_converged"].any()),
                  f"NS {label}: dispatch kept a block {info['ns_res']}")
            e_err = _rel_err(torch, inv, eigh)
            check(e_err <= NS_EIGH_REL_TOL, f"NS {label} fallback vs eigh "
                                            f"{e_err}")
            msg += f"; dispatch fell back on all {g}, vs eigh {e_err:.3e}"
        say("ns-kernel", msg + f" ({near} flags within {NS_FLAG_BAND:.0%} of "
                               f"tol)")
        del f, d, m, x, want

    whole("converging", 16, 512, 1.0, 1e-3, True)
    whole("ill-conditioned", 16, 512, 4.0, 1e-9, False)
    whole("converging", 16, 2048, 1.0, 1e-3, True)
    whole("ragged", 4, 1000, 1.0, 1e-3, True)
    whole("ragged", 4, 1100, 1.0, 1e-3, True)

    # one residual and one update launch at the w1/w3 G family's shape, with
    # every fourth block frozen
    _, _, m = _ns_factors(torch, gen, 64, 2048, 1.0, 1e-3)
    x = ref.ns_x0(m) + 1e-6 * torch.randn(m.shape, generator=gen,
                                          device="cuda")
    active = (torch.arange(64, device="cuda") % 4 != 3).to(torch.int32)
    live = active.bool()
    for label, act in (("all active", None), ("every 4th frozen", active)):
        r, ss = ns.ns_tiled_residual(m, x, act)
        xn = ns.ns_tiled_update(x, r, act)
        torch.cuda.synchronize()
        wr, wss = ref.ns_tiled_residual_ref(m, x)
        wx = ref.ns_tiled_update_ref(x, wr)
        sel = live if act is not None else torch.ones_like(live)
        e_r = _rel_err(torch, r[sel], wr[sel])
        e_ss = _rel_err(torch, ss[sel], wss[sel])
        e_x = _rel_err(torch, xn[sel], wx[sel])
        check(max(e_r, e_ss, e_x) <= NS_PRODUCT_REL_TOL,
              f"NS tiled pair ({label}): rel errs r {e_r} ss {e_ss} x' {e_x}")
        if act is not None:
            check(bool((ss[~live] == 0).all())
                  and torch.equal(xn[~live], x[~live]),
                  "NS tiled pair: a frozen block changed")
        worst["ns_tiled_residual"] = max(worst["ns_tiled_residual"],
                                         _max_err(torch, r[sel], wr[sel]))
        worst["ns_tiled_update"] = max(worst["ns_tiled_update"],
                                       _max_err(torch, xn[sel], wx[sel]))
        say("ns-kernel", f"tiled residual + update (64, 2048, 2048), {label}: "
                         f"max|err|/max r {e_r:.3e}, ss {e_ss:.3e}, x' "
                         f"{e_x:.3e} (tol {NS_PRODUCT_REL_TOL})"
            + ("; frozen blocks: ss 0 and x' == x bit for bit"
               if act is not None else ""))
        del r, ss, xn, wr, wss, wx
    del m, x
    torch.cuda.empty_cache()
    return worst


def train_path_ns(torch, eigh_train) -> dict:
    """launch.train with Stage 4 by Newton-Schulz at full width: 2 loop
    steps (both capture at random init), then a warm-up and
    FAST_TIMED timed steps of the fast-step builder. Prints the step walls,
    Stage-4 seconds a refresh, trips, eigh fallbacks and residuals per
    statistic and the peak memory. Checks: the first loss equals the eigh
    path's (same seed and batch), every loss finite, the launches as
    reckoned from the code and the recorded trips, no ref dispatch, and the
    plain iteration never called."""
    import math
    from repro_torch.core import kfac as kfac_core
    from repro_torch.kernels import dispatch, kfac, ref, swa_attention
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, params, state = train.build(
        "llama3_2_1b", full_config=True, device="cuda",
        inverse_method="newton_schulz")
    cfg = model.cfg
    calls = []                 # (b, trips) of every Newton-Schulz call
    plain = []                 # calls of the plain iteration (must stay [])
    inner = ns.ns_inverse

    def spy_ns(m, iters, tol):
        out = inner(m, iters, tol)
        calls.append((m.shape[-1], out[2].cpu()))
        return out

    def plain_spy(fn):
        def run(*a, **kw):
            plain.append(fn.__name__)
            return fn(*a, **kw)
        return run
    patched = [(ns, "ns_inverse", spy_ns)] + [
        (mod, name, plain_spy(getattr(mod, name)))
        for mod, name in ((kfac_core, "newton_schulz_inverse"),
                          (ref, "ns_inverse_blocks_ref"),
                          (ref, "ns_tiled_residual_ref"),
                          (ref, "ns_tiled_update_ref"))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    for mod, name, fn in patched:
        setattr(mod, name, fn)
    swa_attention.reset_launches()
    kfac.reset_launches()
    ns.reset_launches()
    dispatch.reset_calls()
    try:
        with _Stage4Timer(torch) as s4:
            params, state, recs = train.run(
                model, opt, params, state,
                log=lambda m: say("ns-train-path", m), **TRAIN_NS)
        params, state = _fast_steps(torch, model, opt, params, state, recs,
                                    TRAIN_NS, "ns-train-path")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    kinds = [r["kind"] for r in recs]
    launches = {**swa_attention.LAUNCHES, **kfac.LAUNCHES, **ns.LAUNCHES}
    dcalls = dict(dispatch.CALLS)
    peak = torch.cuda.max_memory_allocated()
    check(kinds == ["capture"] * TRAIN_NS["steps"] + ["fast"] * (
        1 + FAST_TIMED), f"NS step kinds {kinds}")
    check(all(math.isfinite(r["loss"]) for r in recs),
          f"NS losses {[r['loss'] for r in recs]}")
    d_loss = abs(recs[0]["loss"] - eigh_train["first_loss"])
    check(d_loss <= 1e-6 * abs(eigh_train["first_loss"]),
          f"NS first loss {recs[0]['loss']} != eigh path's "
          f"{eigh_train['first_loss']}")
    check(not plain, f"the plain Newton-Schulz iteration ran: {plain}")
    check(not any(b == "ref" for (_, b) in dcalls),
          f"ref dispatches: {dcalls}")
    # the i-th Newton-Schulz call of a capture step is the i-th blocked
    # factor of its inverse info (both go family by family, a then g)
    cap = [r for r in recs if r["kind"] == "capture"]
    names = [n for r in cap for n in r["inverse"]]
    infos = [i for r in cap for i in r["inverse"].values()]
    check(len(calls) == len(names) and all(
        t.numel() == i["ns_res"].numel() for (_, t), i in zip(calls, infos)),
          f"NS calls {len(calls)} vs blocked statistics {len(names)}")
    want = _train_counts(cfg, kinds)
    want["ns_inverse_blocks"] = sum(1 for b, _ in calls
                                    if ns.route(b) == "resident")
    tiled = [int(t.max()) for b, t in calls if ns.route(b) == "tiled"]
    want["ns_tiled_residual"] = sum(n + 1 for n in tiled)
    want["ns_tiled_update"] = sum(tiled)
    got = {k: launches[k] for k in want}
    check(got == want, f"NS train launches {got} != reckoned {want}")
    check(want["ns_inverse_blocks"] > 0 and want["ns_tiled_update"] > 0,
          "the NS path must run both the resident kernel and the tiled pair")
    per_stat: dict = {}
    for (b, t), n, i in zip(calls, names, infos):
        e = per_stat.setdefault(n, {"b": b, "trips": [], "fell": 0,
                                    "res": []})
        e["trips"] += t.tolist()
        e["fell"] += int((~i["ns_converged"]).sum())
        e["res"] += i["ns_res"].flatten().tolist()
    for n, e in per_stat.items():
        tr = e["trips"]
        say("ns-train-path", f"{n}: {len(tr)} blocks of {e['b']} over "
                             f"{len(cap)} refreshes ({ns.route(e['b'])}): "
                             f"trips min {min(tr)} median "
                             f"{statistics.median(tr)} max {max(tr)}; eigh "
                             f"fallback {e['fell']}; res {min(e['res']):.2e}-"
                             f"{max(e['res']):.2e}")
    all_trips = [x for e in per_stat.values() for x in e["trips"]]
    fell = sum(e["fell"] for e in per_stat.values())
    tokens = TRAIN_NS["batch"] * TRAIN_NS["seq"]
    cap_s = [r["seconds"] for r in cap]
    fast_s = [r["seconds"] for r in recs
              if r["kind"] == "fast" and not r.get("warm")]
    say("ns-train-path", f"{len(recs)} steps: losses "
                         f"{[round(r['loss'], 6) for r in recs]}; first loss "
                         f"{recs[0]['loss']:.6f} vs eigh path "
                         f"{eigh_train['first_loss']:.6f}")
    say("ns-train-path", f"capture step wall {[round(x, 3) for x in cap_s]} s,"
                         f" fast step {[round(x, 3) for x in fast_s]} s after "
                         f"a warm-up, median {statistics.median(fast_s):.3f} s "
                         f"({tokens / statistics.median(fast_s):.1f} tokens/s);"
                         f" Stage-4 Newton-Schulz {s4.seconds:.3f} s over "
                         f"{s4.calls} batched calls ({s4.blocks} blocks) in "
                         f"{len(cap)} refreshes, {s4.seconds / len(cap):.3f} s "
                         f"a refresh (eigh path: "
                         f"{eigh_train['stage4_s'] / eigh_train['refreshes']:.3f}"
                         f" s); trips min {min(all_trips)} median "
                         f"{statistics.median(all_trips)} max {max(all_trips)};"
                         f" eigh fallback {fell} of {len(all_trips)} blocks; "
                         f"peak memory {peak / 2 ** 30:.2f} GiB; "
                         f"{card_note(torch)}")
    say("ns-train-path", f"launches {got} (reckoned {want}); dispatches "
                         f"{dcalls}")
    capture = train.make_train_step(model, opt)
    flags = {k: True for k in opt.stat_names()}
    batch = _train_batch(torch, cfg.vocab, TRAIN_NS["batch"], TRAIN_NS["seq"])
    _profile(torch, "one capture train step, Newton-Schulz Stage 4, every "
                    "statistic refreshed",
             lambda: capture(params, state, batch, flags, TRAIN_NS["damping"],
                             1e-4, 0.0), warm=False)
    del model, opt, params, state
    torch.cuda.empty_cache()
    return {"launches": launches}


def time_ns_kernels(torch) -> dict:
    """The three Newton-Schulz kernels at the training path's shapes beside
    their bound, plain version and library call: the resident kernel at
    (16, 512, 512) with tol 0 (exactly NS_ITERS trips), and beside it the
    tiled pair's whole inverse on the same blocks (the route b > 1024
    takes), both again at g 15; one residual and one update launch at
    (64, 2048, 2048)."""
    from repro_torch.core import kfac
    from repro_torch.kernels import ref
    from repro_torch.kernels import newton_schulz as ns
    gen = torch.Generator(device="cuda").manual_seed(9)
    res = {}
    iters = kfac.NS_ITERS
    g, b = 16, 512
    f, d, m = _ns_factors(torch, gen, g, b, 1.0, 1e-3)
    _, _, trips = ns.ns_inverse_blocks(m, iters, 0.0)
    check(bool((trips == iters).all()), f"tol 0: trips {trips.tolist()}")
    bound, by = _bound(4 * b ** 3 * g * iters, 2 * g * b * b * 4 + 8 * g,
                       m.dtype)
    eigh_ms = _time_ms(torch, lambda: kfac.damped_inverse(f, d), reps=5)
    res["ns_inverse_blocks"] = {
        "ms": _time_ms(torch, lambda: ns.ns_inverse_blocks(m, iters, 0.0)),
        "plain_ms": _time_ms(torch, lambda: ref.ns_inverse_blocks_ref(
            m, iters, 0.0), reps=5),
        "library_ms": _time_ms(torch, lambda: torch.linalg.inv(m)),
        "bound_ms": bound, "bound_by": by}
    _, _, trips = ns.ns_inverse_tiled(m, iters, 0.0)
    check(bool((trips == iters).all()), f"tiled, tol 0: {trips.tolist()}")
    tiled_ms = _time_ms(torch, lambda: ns.ns_inverse_tiled(m, iters, 0.0),
                        reps=5)
    # one block fewer: the resident kernel's cluster size follows g
    m15 = m[:g - 1].contiguous()
    ms15 = _time_ms(torch, lambda: ns.ns_inverse_blocks(m15, iters, 0.0),
                    reps=5)
    tiled15 = _time_ms(torch, lambda: ns.ns_inverse_tiled(m15, iters, 0.0),
                       reps=5)
    say("times", f"ns_inverse_blocks ({g}, {b}, {b}) f32, tol 0 ({iters} "
                 f"trips): {res['ns_inverse_blocks']}, "
                 f"{res['ns_inverse_blocks']['ms'] / iters:.4f} ms a trip "
                 f"(library: torch.linalg.inv on the damped blocks; eigh "
                 f"(kfac.damped_inverse) {eigh_ms:.4f} ms); clusters of "
                 f"{ns.resident_cluster(g, b)} blocks; the tiled pair "
                 f"on the same blocks (ns_inverse_tiled, {iters} trips) "
                 f"{tiled_ms:.4f} ms, {tiled_ms / iters:.4f} ms a trip. "
                 f"At g {g - 1}: resident {ms15:.4f} ms (clusters of "
                 f"{ns.resident_cluster(g - 1, b)}), tiled {tiled15:.4f} ms; "
                 f"{card_note(torch)}")
    del f, d, m, m15

    g, b = 64, 2048
    _, _, m = _ns_factors(torch, gen, g, b, 1.0, 1e-3)
    x = ref.ns_x0(m)
    eye = torch.eye(b, device="cuda")
    r, _ = ns.ns_tiled_residual(m, x)
    nbytes = 3 * g * b * b * 4
    bound, by = _bound(2 * b ** 3 * g, nbytes + 4 * g, m.dtype)
    res["ns_tiled_residual"] = {
        "ms": _time_ms(torch, lambda: ns.ns_tiled_residual(m, x)),
        "plain_ms": _time_ms(torch, lambda: ref.ns_tiled_residual_ref(m, x),
                             reps=5),
        "library_ms": _time_ms(torch, lambda: torch.baddbmm(eye, m, x,
                                                            alpha=-1.0)),
        "bound_ms": bound, "bound_by": by}
    bound, by = _bound(2 * b ** 3 * g, nbytes, m.dtype)
    res["ns_tiled_update"] = {
        "ms": _time_ms(torch, lambda: ns.ns_tiled_update(x, r)),
        "plain_ms": _time_ms(torch, lambda: ref.ns_tiled_update_ref(x, r),
                             reps=5),
        "library_ms": _time_ms(torch, lambda: torch.baddbmm(x, x, r)),
        "bound_ms": bound, "bound_by": by}
    say("times", f"ns_tiled_residual ({g}, {b}, {b}) f32: "
                 f"{res['ns_tiled_residual']}; ns_tiled_update: "
                 f"{res['ns_tiled_update']} (library: torch.baddbmm f32, TF32 "
                 f"off); {card_note(torch)}")
    del m, x, r
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# fp8 factor history and fused fp8 capture
# ---------------------------------------------------------------------------

def _fp8_ordinal(torch, payload):
    """fp8 codes as signed ordinals: neighbouring representable values
    differ by one; +0 and -0 are both 0."""
    u = payload.view(torch.uint8).to(torch.int32)
    mag = u & 0x7F
    return torch.where(u >= 0x80, -mag, mag)


def _fp8_steps(torch, a, b) -> int:
    """Largest distance, in fp8 steps, between two payloads of one format."""
    return int((_fp8_ordinal(torch, a) - _fp8_ordinal(torch, b)).abs().max())


def _raw_bytes(torch, t):
    """The bytes of a tensor of any dtype and rank."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _fp8_rows(torch, gen, g, t, zero_rows=(), offset=0):
    """(g, t) f32 rows with magnitudes spread over six decades across the
    rows; ``offset`` elements into a fresh buffer (an offset of 1 leaves the
    rows 4 bytes off 16-byte alignment)."""
    buf = torch.randn((g * t + offset,), generator=gen, device="cuda")
    x = buf[offset:].view(g, t)
    x *= torch.logspace(-3, 3, g, device="cuda")[:, None]
    for r in zero_rows:
        x[r] = 0.0
    return x


def check_fp8_kernels(torch) -> dict:
    """quant_rows and dequant_rows against their plain versions, bit for
    bit: the history rows of the path (64 x 2,098,176 at b 2048, 32 x
    131,328 at b 512), a ragged b 1000 (t 500,500), zero rows, e5m2, pow2
    scales, a clipped outlier and rows off 16-byte alignment (the element
    path). factor_syrk_wire at n 4096, b 512 / 1000 / 1024, bf16 and f32:
    payload and scales bit-identical to quant_rows' plain version on the
    kernel's own f32 sums (its scratch), those sums within
    WIRE_SCALE_REL_TOL of the plain sums, and against the plain composition
    (f32 sum, sym_pack, quantize) the payload within one fp8 step and the
    decode within the e4m3 bound of the f32 sum; and the dispatch op's
    b > 1024 route (factor_syrk, sym_pack, quant_rows) the same way, on
    factor_syrk's sums."""
    from repro_torch.core import kfac
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import quant as qk
    from repro_torch.quant import quant
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = {"quant_rows": 0.0, "dequant_rows": 0.0, "factor_syrk_wire": 0.0}
    cases = [(64, 2098176, "e4m3", "fp32", (), 0),
             (32, 131328, "e4m3", "fp32", (), 0),
             (4, 500500, "e4m3", "fp32", (1,), 0),
             (16, 131328, "e5m2", "fp32", (3,), 0),
             (16, 131328, "e4m3", "pow2", (0,), 0),
             (4, 500500, "e5m2", "pow2", (), 0),
             (3, 561, "e4m3", "fp32", (2,), 1)]
    for g, t, fmt, mode, zero, off in cases:
        x = _fp8_rows(torch, gen, g, t, zero, off)
        if g == 3:
            x[0, 5] = 1e30                # clipped, never NaN
        p, sc = qk.quant_rows(x, fmt, mode)
        d = qk.dequant_rows(p, sc)
        torch.cuda.synchronize()
        rp, rs = ref.quant_rows_ref(x, fmt, mode)
        rd = ref.dequant_rows_ref(rp, rs)
        bad_p = int((p.view(torch.uint8) != rp.view(torch.uint8)).sum())
        bad_s = int((sc.view(torch.int32) != rs.view(torch.int32)).sum())
        check(bad_p == 0 and bad_s == 0,
              f"quant_rows ({g}, {t}) {fmt} {mode}: {bad_p} payload bytes "
              f"and {bad_s} scales differ from the plain version")
        check(torch.equal(d, rd), f"dequant_rows ({g}, {t}) {fmt}: differs "
                                  f"from the plain version")
        check(bool((sc[list(zero)] == 1.0).all()), "zero rows get scale 1")
        if mode == "pow2":
            check(bool((sc.view(torch.int32) & 0x7FFFFF == 0).all()),
                  "pow2 scales are powers of two")
        # quant_rows' own outputs: payload values (in fp8 units) and scales
        worst["quant_rows"] = max(
            worst["quant_rows"], _max_err(torch, p.float(), rp.float()),
            _max_err(torch, sc, rs))
        worst["dequant_rows"] = max(worst["dequant_rows"],
                                    _max_err(torch, d, rd))
        say("fp8-kernel", f"quant_rows + dequant_rows ({g}, {t}) {fmt} {mode}"
                          f"{', zero rows ' + str(list(zero)) if zero else ''}"
                          f"{', 16-byte misaligned' if off else ''}: payload, "
                          f"scales and decode bit-identical to the plain "
                          f"versions")
        del x, p, sc, d, rp, rs, rd
    torch.cuda.empty_cache()

    def wire_case(label, x, max_dim, fmt, mode, route):
        nb = kfac.num_blocks(x.shape[-1], max_dim)
        b = kfac.block_size(x.shape[-1], max_dim)
        if route == "fused":
            own = torch.empty((nb, b, b), dtype=torch.float32, device="cuda")
            p, sc = qk._factor_syrk_wire(x, max_dim, fmt, mode, own)
        else:
            p, sc = dispatch.factor_sum_wire(x, max_dim, fmt=fmt,
                                             scale_mode=mode, backend="cuda")
            # the route's own sums: factor_syrk reduces in a fixed order
            own = kern.factor_syrk(x, max_dim)
        torch.cuda.synchronize()
        op, osc = ref.quant_rows_ref(kfac.sym_pack(own), fmt, mode)
        bad_p = int((p.view(torch.uint8) != op.view(torch.uint8)).sum())
        bad_s = int((sc.view(torch.int32) != osc.view(torch.int32)).sum())
        check(bad_p == 0 and bad_s == 0,
              f"factor_syrk_wire {label}: {bad_p} payload bytes and {bad_s} "
              f"scales differ from quant_rows on the kernel's own f32 sums")
        f = ref.factor_sum_ref(x, max_dim)
        sum_err = _rel_err(torch, own, f)
        check(sum_err <= WIRE_SCALE_REL_TOL, f"factor_syrk_wire {label}: f32 "
                                             f"sums rel err {sum_err}")
        rp, rs = ref.quant_rows_ref(kfac.sym_pack(f), fmt, mode)
        a = kfac.sym_pack(f)
        s_err = float(((sc - rs).abs() / rs).max())
        steps = _fp8_steps(torch, p, rp)
        dk, dr = ref.dequant_rows_ref(p, sc), ref.dequant_rows_ref(rp, rs)
        amax = float(a.abs().max())
        # e4m3 (e5m2): half a step is 2^-4 (2^-3) of the value, 2^-10
        # (2^-17) of the scale below the normal range; plus the f32 sums'
        # order
        rel, sub = (2.0 ** -4, 2.0 ** -10) if fmt == "e4m3" else \
            (2.0 ** -3, 2.0 ** -17)
        bound = rel * a.abs() + sub * sc[..., None] + 1e-5 * amax
        over = int(((dk - a).abs() > bound).sum())
        check(steps <= 1, f"factor_syrk_wire {label}: payload {steps} fp8 "
                          f"steps from the plain composition")
        check(over == 0, f"factor_syrk_wire {label}: {over} decoded entries "
                         f"outside the {fmt} bound")
        err = _max_err(torch, dk, dr)
        worst["factor_syrk_wire"] = max(worst["factor_syrk_wire"], err)
        flips = int((p.view(torch.uint8) != rp.view(torch.uint8)).sum())
        say("fp8-kernel", f"factor_sum_wire {label} ({route}) -> "
                          f"{tuple(p.shape)} {fmt} {mode}: payload and scales "
                          f"bit-identical to quant_rows on the kernel's own "
                          f"f32 sums, which are within {sum_err:.2e} of the "
                          f"plain sums (tol {WIRE_SCALE_REL_TOL}); against the "
                          f"plain composition: scale rel err {s_err:.2e}, "
                          f"{flips} of {p.numel()} payload bytes one fp8 step "
                          f"off, max |decode err| {err:.3e} (max|A| "
                          f"{amax:.3e}); decode within the {fmt} bound of the "
                          f"f32 sum")
        del p, sc, f, rp, rs, a, dk, dr, own, op, osc

    for b in (512, 1000, 1024):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((4096, b), generator=gen, device="cuda").to(dtype)
            wire_case(f"n=4096 b={b} {dtype}", x, 2048, "e4m3", "fp32",
                      "fused")
    x = torch.randn((4000, 2050), generator=gen, device="cuda")
    wire_case("n=4000 d=2050 max_dim=1024 (3 blocks of 684)", x, 1024,
              "e5m2", "fp32", "fused")
    x = torch.randn((4096, 512), generator=gen, device="cuda").bfloat16()
    wire_case("n=4096 b=512 bf16", x, 2048, "e4m3", "pow2", "fused")
    x = torch.randn((4096, 8192), generator=gen, device="cuda").bfloat16()
    wire_case("n=4096 d=8192 bf16 (4 blocks of 2048)", x, 2048, "e4m3",
              "fp32", "dispatch")
    del x
    torch.cuda.empty_cache()
    return worst


def _flat_fp8_state(torch, tree) -> dict:
    from repro_torch.core.fisher import flatten
    return {k: v.clone() for k, v in flatten(tree).items()}


def check_fp8_route(torch) -> None:
    """One capture step at full width, 2 layers, f32, with the fp8 history
    and fused e4m3 capture on, through the kernels and with backend="ref".
    The two backwards agree: the loss, the wire payloads within one fp8
    step (the f32 sums in another order), the scales and the other raw
    stats within the factor sums' tolerance. Then the ref optimizer step
    takes the kernel run's own backward, so the rest of the step is held
    tightly: the encoded history bit for bit (the fp8 kernels are
    bit-identical to their plain versions) and the updated params within
    ROUTE_REL_TOL."""
    import dataclasses
    cfg = dataclasses.replace(_route_cfg(torch), factor_wire="e4m3")
    batch = _train_batch(torch, cfg.vocab, 2, 512)
    kw = dict(factor_dtype="fp8_e4m3")
    k = _route_step(torch, cfg, batch, "auto", **kw)
    r = _route_step(torch, cfg, batch, "ref", capture=k["capture"], **kw)
    steps = flips = total = 0
    s_err = other = 0.0
    for n, want in r["own_raw"].items():
        got = k["raw"][n]
        if want.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            steps = max(steps, _fp8_steps(torch, got, want))
            flips += int((got.view(torch.uint8)
                          != want.view(torch.uint8)).sum())
            total += want.numel()
        elif n.endswith("/scale"):
            s_err = max(s_err, float(((got - want).abs()
                                      / want.abs()).max()))
        else:
            other = max(other, _rel_err(torch, got, want))
    lk, lr_ = k["loss"], r["own_loss"]
    check(abs(lk - lr_) <= ROUTE_REL_TOL * abs(lr_),
          f"fp8 route loss {lk} vs {lr_}")
    hist_bad = sum(int((_raw_bytes(torch, got)
                        != _raw_bytes(torch, r["prev"][n])).sum())
                   for n, got in k["prev"].items())
    worst_p = max(_rel_err(torch, k["params"][n], r["params"][n])
                  for n in r["params"])
    say("fp8-route", f"llama3_2_1b width, 2 layers, f32, batch (2, 512), "
                     f"factor_dtype fp8_e4m3, factor_wire e4m3, kernels vs "
                     f"backend='ref': loss {lk:.6f} vs {lr_:.6f}; wire "
                     f"payloads {flips} of {total} "
                     f"bytes differ, by at most {steps} fp8 step(s); scales "
                     f"rel err {s_err:.2e}, other raw stats {other:.3e} (tol "
                     f"{WIRE_SCALE_REL_TOL}); from the same backward: "
                     f"{hist_bad} history bytes differ, updated params "
                     f"max|err|/max {worst_p:.3e} (tol {ROUTE_REL_TOL})")
    check(steps <= 1, f"fp8 route payloads {steps} fp8 steps apart")
    check(s_err <= WIRE_SCALE_REL_TOL, f"fp8 route scales rel err {s_err}")
    check(other <= ROUTE_REL_TOL, f"fp8 route raw stats rel err {other}")
    check(hist_bad == 0, f"fp8 route: {hist_bad} bytes of the encoded "
                         f"history differ from the same backward's ref step")
    check(worst_p <= ROUTE_REL_TOL, f"fp8 route updated params rel err "
                                    f"{worst_p} > {ROUTE_REL_TOL}")


def _fp8_counts(opt, cfg, recs) -> dict:
    """Launches of the fp8 kernels reckoned from the code for the steps of
    ``recs``. A capture step captures every full-kind statistic through
    factor_sum_wire, one call per layer: factor_syrk_wire where b <= 1024,
    else factor_syrk + quant_rows. Each refreshed blocked statistic then
    decodes its wire sums, X_-1 and X_-2 (3 dequant_rows) and encodes the
    new X_-1 (1 quant_rows); one that does not refresh, in a family that
    does, decodes X_-1 for the family's inverse (1 dequant_rows)."""
    import math
    from repro_torch.kernels.dispatch import FACTOR_WIRE_MAX_DIM
    from repro_torch.quant import quant
    n = {"factor_syrk_wire": 0, "factor_syrk": 0, "quant_rows": 0,
         "dequant_rows": 0}
    fams = opt.fstats_fn()
    for r in recs:
        if r["kind"] != "capture":
            continue
        done = {name for name, d in r["sims"].items() if d[0] >= 0}
        for fam, stats in fams.items():
            recompute = any(f"{fam}.{k}" in done for k in stats)
            for key, leaf in stats.items():
                if not opt.sym_stat(fam, key):
                    continue
                check(quant.is_wire(leaf), f"{fam}.{key} is not wire-captured")
                calls = math.prod(leaf["payload"].shape[:-2])
                if quant.tri_rows(leaf["payload"].shape[-1]) <= \
                        FACTOR_WIRE_MAX_DIM:
                    n["factor_syrk_wire"] += calls
                else:
                    n["factor_syrk"] += calls
                    n["quant_rows"] += calls
                if f"{fam}.{key}" in done:
                    n["dequant_rows"] += 3
                    n["quant_rows"] += 1
                elif recompute:
                    n["dequant_rows"] += 1
    return n


def _history_bytes(torch, opt, state) -> tuple[int, int]:
    """(bytes of the X_-1/X_-2 entries in ``state``, bytes of the same
    history held dense in f32 as the f32 path holds it)."""
    import math
    from repro_torch.core.fisher import flatten
    from repro_torch.core.ngd import _dense_leaf_shape
    held = sum(v.numel() * v.element_size()
               for c in state["curv"].values() for part in ("prev", "prev2")
               for v in flatten(c[part]).values())
    f32 = sum(2 * 4 * math.prod(_dense_leaf_shape(leaf))
              for stats in opt.fstats_fn().values()
              for leaf in stats.values())
    return held, f32


def train_path_fp8(torch, eigh_train) -> dict:
    """launch.train at full width with the fp8 factor history
    (factor_dtype "fp8_e4m3") and fused e4m3 capture (factor_wire), eigh
    Stage 4: TRAIN_FP8 loop steps (all capture at random init, so X_-2
    holds a real refresh), then a warm-up and FP8_FAST_TIMED timed steps of
    the fast-step builder. Checks: every loss finite, the first equal to
    the eigh path's, the launches as reckoned from the steps, no ref
    dispatch, the history at most FP8_HIST_RATIO of the f32 history's
    bytes. Prints the step walls, the seconds spent in the fp8 dispatch
    ops, the history bytes and the peak memory beside the f32 path's."""
    import math
    from repro_torch.kernels import dispatch, kfac, swa_attention
    from repro_torch.kernels import quant as qk
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, params, state = train.build(
        "llama3_2_1b", full_config=True, device="cuda",
        factor_dtype="fp8_e4m3", factor_wire="e4m3")
    cfg = model.cfg
    swa_attention.reset_launches()
    kfac.reset_launches()
    qk.reset_launches()
    dispatch.reset_calls()
    with _Stage4Timer(torch) as s4, _OpTimer(torch, FP8_OPS) as ops:
        params, state, recs = train.run(
            model, opt, params, state,
            log=lambda m: say("fp8-train-path", m), **TRAIN_FP8)
    hist, hist_f32 = _history_bytes(torch, opt, state)
    params, state = _fast_steps(torch, model, opt, params, state, recs,
                                TRAIN_FP8, "fp8-train-path",
                                timed=FP8_FAST_TIMED)
    kinds = [r["kind"] for r in recs]
    launches = {**swa_attention.LAUNCHES, **kfac.LAUNCHES, **qk.LAUNCHES}
    calls = dict(dispatch.CALLS)
    peak = torch.cuda.max_memory_allocated()
    check(kinds == ["capture"] * TRAIN_FP8["steps"] + ["fast"] * (
        1 + FP8_FAST_TIMED), f"fp8 step kinds {kinds}")
    check(all(math.isfinite(r["loss"]) for r in recs),
          f"fp8 losses {[r['loss'] for r in recs]}")
    d_loss = abs(recs[0]["loss"] - eigh_train["first_loss"])
    check(d_loss <= 1e-6 * abs(eigh_train["first_loss"]),
          f"fp8 first loss {recs[0]['loss']} != the eigh path's "
          f"{eigh_train['first_loss']}")
    check(not any(b == "ref" for (_, b) in calls), f"ref dispatches: {calls}")
    want = _train_counts(cfg, kinds)
    want.update(_fp8_counts(opt, cfg, recs))
    got = {k: launches[k] for k in want}
    check(got == want, f"fp8 train launches {got} != reckoned {want}")
    check(all(want[k] > 0 for k in FP8_KERNELS),
          f"the fp8 path must run every fp8 kernel: {want}")
    check(hist <= FP8_HIST_RATIO * hist_f32,
          f"fp8 history {hist} B > {FP8_HIST_RATIO} x f32 {hist_f32} B")
    tokens = TRAIN_FP8["batch"] * TRAIN_FP8["seq"]
    cap = [r["seconds"] for r in recs if r["kind"] == "capture"]
    fast_s = [r["seconds"] for r in recs
              if r["kind"] == "fast" and not r.get("warm")]
    say("fp8-train-path", f"{len(recs)} steps: losses "
                          f"{[round(r['loss'], 6) for r in recs]}; first loss "
                          f"{recs[0]['loss']:.6f} vs eigh path "
                          f"{eigh_train['first_loss']:.6f}")
    say("fp8-train-path", f"capture step wall {[round(x, 3) for x in cap]} s,"
                          f" fast step {[round(x, 3) for x in fast_s]} s after "
                          f"a warm-up, median {statistics.median(fast_s):.3f} s "
                          f"({tokens / statistics.median(fast_s):.1f} "
                          f"tokens/s); Stage-4 eigh {s4.seconds:.3f} s over "
                          f"{s4.calls} batched calls in {len(cap)} refreshes, "
                          f"{s4.seconds / len(cap):.3f} s a refresh (f32 path: "
                          f"{eigh_train['stage4_s'] / eigh_train['refreshes']:.3f}"
                          f" s); {card_note(torch)}")
    say("fp8-train-path", "synchronized seconds in the fp8 ops over the "
                          f"{len(cap)} capture steps: "
                          + ", ".join(f"{op} {ops.seconds[op]:.3f} s in "
                                      f"{ops.calls[op]} calls"
                                      for op in FP8_OPS)
                          + " (factor_sum_wire includes the factor sums)")
    say("fp8-train-path", f"history X_-1 + X_-2: {hist} B ({hist / 2 ** 30:.3f}"
                          f" GiB) = {hist / hist_f32:.4f} of the f32 "
                          f"history's {hist_f32} B ({hist_f32 / 2 ** 30:.3f} "
                          f"GiB; bound {FP8_HIST_RATIO}); peak memory "
                          f"{peak / 2 ** 30:.2f} GiB against the f32 path's "
                          f"{eigh_train['peak'] / 2 ** 30:.2f} GiB "
                          f"(torch.cuda.max_memory_allocated, same call)")
    say("fp8-train-path", f"launches {got} (reckoned {want}); dispatches "
                          f"{calls}")
    del model, opt, params, state
    torch.cuda.empty_cache()
    return {"launches": launches}


def time_fp8_kernels(torch) -> dict:
    """The three fp8 kernels at the training path's shapes beside their
    bound, plain version and library call: quant_rows and dequant_rows on
    the largest history family (64 rows of 2,098,176: mlp up/gate G, 16
    layers x 4 blocks of 2048), and on the b 512 family (16 x 131,328)
    (factor_syrk_wire: time_factor_sums)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import quant as qk
    gen = torch.Generator(device="cuda").manual_seed(11)
    res = {}
    g, t = 64, 2098176
    x = _fp8_rows(torch, gen, g, t)
    p, sc = qk.quant_rows(x, "e4m3")
    nbytes = g * t * (4 + 1) + 4 * g
    bound, by = _bound(0, nbytes, x.dtype)
    res["quant_rows"] = {
        "ms": _time_ms(torch, lambda: qk.quant_rows(x, "e4m3")),
        "plain_ms": _time_ms(torch, lambda: ref.quant_rows_ref(x, "e4m3"),
                             reps=5),
        "library_ms": None, "bound_ms": bound, "bound_by": by}
    res["dequant_rows"] = {
        "ms": _time_ms(torch, lambda: qk.dequant_rows(p, sc)),
        "plain_ms": _time_ms(torch, lambda: ref.dequant_rows_ref(p, sc),
                             reps=5),
        "library_ms": None, "bound_ms": bound, "bound_by": by}
    say("times", f"quant_rows ({g}, {t}) f32 -> e4m3: {res['quant_rows']}; "
                 f"dequant_rows: {res['dequant_rows']} (no single PyTorch "
                 f"call computes either); {card_note(torch)}")
    del x, p, sc
    g, t = 16, 131328
    x = _fp8_rows(torch, gen, g, t)
    p, sc = qk.quant_rows(x, "e4m3")
    b_s, _ = _bound(0, g * t * 5 + 4 * g, x.dtype)
    q_s = _time_ms(torch, lambda: qk.quant_rows(x, "e4m3"))
    d_s = _time_ms(torch, lambda: qk.dequant_rows(p, sc))
    say("times", f"quant_rows ({g}, {t}): ms {q_s:.4f}; dequant_rows ms "
                 f"{d_s:.4f}; bound_ms {b_s:.6f} (bytes); {card_note(torch)}")
    del x, p, sc
    torch.cuda.empty_cache()
    return res


def _syrk_ops_bytes(n, nb, b, out_bytes):
    """Operations and bytes of one blocked factor sum: every block's b(b+1)/2
    distinct sums of n products, x read once, the output written once."""
    return nb * n * b * (b + 1), n * nb * b * 2 + out_bytes


def time_factor_sums(torch) -> dict:
    """factor_syrk and factor_syrk_wire at the training path's shapes,
    beside their bound, plain version and the library call for the same
    function (cuBLAS bf16 x^T x with f32 output: torch.mm, torch.bmm over
    blocks, out_dtype); factor_syrk at n 4096 x d 2048 (nb 1, its row), 512
    and 8192 (nb 4); factor_syrk_wire at b 512 (its row) and both wire
    routes at b 2048, where dispatch caps the fused kernel
    (FACTOR_WIRE_MAX_DIM 1024)."""
    from repro_torch.core import kfac
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import quant as qk
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(12)
    f32 = torch.float32
    res = {}
    n = 4096
    for d, max_dim in ((2048, 2048), (512, 2048), (8192, 2048)):
        x = torch.randn((n, d), generator=gen, device="cuda").bfloat16()
        nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
        xb = x.view(n, nb, b).transpose(0, 1)
        ops, nbytes = _syrk_ops_bytes(n, nb, b, nb * b * b * 4)
        bound, by = _bound(ops, nbytes, x.dtype)
        if nb == 1:
            def lib(x=x):
                return torch.mm(x.t(), x, out_dtype=f32)
        else:
            def lib(xb=xb):
                return torch.bmm(xb.transpose(1, 2), xb, out_dtype=f32)
        try:
            lib_ms = _time_ms(torch, lib)
        except RuntimeError as e:            # no bf16 -> f32 bmm here
            say("times", f"library call for nb={nb} not timed: {e}")
            lib_ms = None
        row = {"ms": _time_ms(torch, lambda: kern.factor_syrk(x, max_dim)),
               "plain_ms": _time_ms(torch, lambda: ref.factor_sum_ref(
                   x, max_dim)),
               "library_ms": lib_ms, "bound_ms": bound, "bound_by": by}
        if d == 2048:
            res["factor_syrk"] = row
        say("times", f"factor_syrk n={n} d={d} nb={nb} bf16 -> f32: {row} "
                     f"(library: cuBLAS bf16 x^T x, f32 output, "
                     f"{'torch.mm' if nb == 1 else 'torch.bmm over blocks'});"
                     f" {card_note(torch)}")
        del x, xb

    for b in (512, 2048):
        x = torch.randn((n, b), generator=gen, device="cuda").bfloat16()
        tri = b * (b + 1) // 2
        ops, nbytes = _syrk_ops_bytes(n, 1, b, tri + 4)
        bound, by = _bound(ops, nbytes, x.dtype)
        fused = _time_ms(torch, lambda: qk.factor_syrk_wire(x, 2048, "e4m3"))
        lib = _time_ms(torch, lambda: torch.mm(x.t(), x, out_dtype=f32))
        if b == 512:
            res["factor_syrk_wire"] = {
                "ms": fused,
                "plain_ms": _time_ms(torch, lambda: ref.factor_sum_wire_ref(
                    x, 2048, "e4m3")),
                "library_ms": lib, "bound_ms": bound, "bound_by": by}
            say("times", f"factor_syrk_wire n={n} b={b} bf16 -> e4m3 "
                         f"sym-packed: {res['factor_syrk_wire']} (library: "
                         f"cuBLAS bf16 x^T x with f32 output, torch.mm "
                         f"out_dtype; the floor of the SYRK part); "
                         f"{card_note(torch)}")
        else:
            unfused = _time_ms(torch, lambda: qk.quant_rows(kfac.sym_pack(
                kern.factor_syrk(x, 2048)), "e4m3"))
            say("times", f"wire routes at n={n} b={b} bf16 -> e4m3: fused "
                         f"factor_syrk_wire ms {fused:.6f}, factor_syrk + "
                         f"sym_pack + quant_rows (dispatch's route above "
                         f"b 1024) ms {unfused:.6f}; bound_ms {bound:.6f} "
                         f"({by}), library_ms {lib:.6f}; {card_note(torch)}")
        del x
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the swa_attention op: (BH, S, hd) causal(-window) attention
# ---------------------------------------------------------------------------

def _visible_pairs(s: int, window: int) -> int:
    """Visible (query, key) pairs of one head: query i sees
    min(i + 1, window) keys (window 0: i + 1)."""
    w = window if 0 < window < s else s
    return w * (w + 1) // 2 + (s - w) * w


def _swa_bound(bh, s, hd, window, dtype) -> tuple[float, str]:
    """Two products of 2 * hd operations per visible pair; q, k, v and out
    each moved once."""
    return _bound(4 * hd * bh * _visible_pairs(s, window),
                  4 * bh * s * hd * dtype.itemsize, dtype)


def check_swa_kernel(torch) -> dict:
    """swa_flash against its plain version: BH 4 over S {64, 50, 1000} x
    window {0, 1, 7, 13, 32, S + 5} x hd {64, 128}, f32 at SWA_F32_TOL and
    bf16 at FWD_TOL; then bf16 at (32, 1024, 64) causal and (32, 4096, 64)
    at window 1024. Every bf16 case is also held at SWA_BF16_TOL against the
    plain version on its inputs upcast to f32."""
    from repro_torch.kernels import ref, swa_attention
    gen = torch.Generator(device="cuda").manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    grid = [(4, s, hd, w, dt) for s in (64, 50, 1000)
            for w in (0, 1, 7, 13, 32, s + 5) for hd in (64, 128)
            for dt in (f32, bf16)]
    cases = grid + [(32, 1024, 64, 0, bf16), (32, 4096, 64, 1024, bf16)]
    worst = {f32: 0.0, bf16: 0.0}
    worst_f32_ref = 0.0
    for bh, s, hd, window, dt in cases:
        q, k, v = (torch.randn((bh, s, hd), generator=gen,
                               device="cuda").to(dt) for _ in range(3))
        out = swa_attention.swa_flash(q, k, v, window=window)
        torch.cuda.synchronize()
        want = ref.swa_attention_ref(q, k, v, window=window)
        check(out.dtype == dt and out.shape == q.shape,
              f"swa_flash output {out.dtype} {tuple(out.shape)}")
        torch.testing.assert_close(out.float(), want.float(),
                                   **(SWA_F32_TOL if dt == f32 else FWD_TOL))
        err = _max_err(torch, out, want)
        worst[dt] = max(worst[dt], err)
        if dt == bf16:
            want = ref.swa_attention_ref(q.float(), k.float(), v.float(),
                                         window=window)
            torch.testing.assert_close(out.float(), want, **SWA_BF16_TOL)
            worst_f32_ref = max(worst_f32_ref, _max_err(torch, out, want))
        if bh == 32:
            say("swa-kernel", f"BH={bh} S={s} hd={hd} window={window} bf16: "
                              f"max|err|={err:.3e} (tol {FWD_TOL}); against "
                              f"the f32 plain version "
                              f"{_max_err(torch, out, want):.3e} (tol "
                              f"{SWA_BF16_TOL})")
        del q, k, v, out, want
    say("swa-kernel", f"{len(grid)} cases BH=4, S 64/50/1000, window 0/1/7/"
                      f"13/32/S+5, hd 64/128: max|err| f32 {worst[f32]:.3e} "
                      f"(tol {SWA_F32_TOL}), bf16 {worst[bf16]:.3e} (tol "
                      f"{FWD_TOL}); every bf16 case against the f32 plain "
                      f"version {worst_f32_ref:.3e} (tol {SWA_BF16_TOL})")
    torch.cuda.empty_cache()
    return {"swa_flash": max(worst.values())}


def swa_path(torch) -> dict:
    """One dispatch.swa_attention call at llama3_2_1b's heads: q (1, S, 32,
    64) and k, v (1, S, 8, 64) bf16 from a seed, KV repeated by the model
    layer's _repeat_kv and the heads flattened to (32, S, 64), S and the
    window from SWA_PATH, default backend. Checks: one cuda dispatch and no
    ref, one swa_flash launch, every head against the plain version on the
    inputs upcast to f32 at SWA_BF16_TOL (one head at a time: a
    whole-tensor plain call would hold 32 heads' f32 scores), and, as a
    check of the layout and the KV repeat only, the whole result against
    attention(q, k, v, window) on its kernel route (swa_flash_fwd on the
    unexpanded KV, which runs the same tile body). Prints the synchronized
    wall time and the peak memory of the call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch, ref, swa_attention
    from repro_torch.models import attention
    torch.cuda.empty_cache()
    cfg = get_config("llama3_2_1b")
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s, window = SWA_PATH["seq"], SWA_PATH["window"]
    gen = torch.Generator(device="cuda").manual_seed(17)
    q = torch.randn((1, s, h, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((1, s, kvh, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((1, s, kvh, hd), generator=gen, device="cuda").bfloat16()

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(h, s, hd).contiguous()
    qf = flat(q)
    kf = flat(attention._repeat_kv(k, h // kvh))
    vf = flat(attention._repeat_kv(v, h // kvh))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    swa_attention.reset_launches()
    dispatch.reset_calls()
    t = time.perf_counter()
    out = dispatch.swa_attention(qf, kf, vf, window=window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(swa_attention.LAUNCHES)
    calls = dict(dispatch.CALLS)
    peak = torch.cuda.max_memory_allocated()
    check(calls == {("swa_attention", "cuda"): 1},
          f"swa_attention dispatches {calls}")
    check(launches["swa_flash"] == 1 and sum(launches.values()) == 1,
          f"swa_flash launches {launches}")
    check(out.shape == qf.shape and out.dtype == torch.bfloat16
          and bool(torch.isfinite(out).all()),
          f"swa_attention output {out.dtype} {tuple(out.shape)}")
    say("swa-path", f"llama3_2_1b heads {h}/{kvh} (KV repeated), hd {hd}, "
                    f"bf16, S {s}, window {window}: dispatch.swa_attention "
                    f"{wall * 1e3:.3f} ms synchronized wall, peak memory "
                    f"{peak / 2 ** 30:.3f} GiB; launches {launches}; "
                    f"dispatches {calls}; {card_note(torch)}")
    errs, used, typical = [], 0.0, 0.0
    for i in range(h):
        want = ref.swa_attention_ref(qf[i:i + 1].float(), kf[i:i + 1].float(),
                                     vf[i:i + 1].float(), window=window)
        got = out[i:i + 1].float()
        torch.testing.assert_close(got, want, **SWA_BF16_TOL)
        errs.append(_max_err(torch, got, want))
        limit = SWA_BF16_TOL["atol"] + SWA_BF16_TOL["rtol"] * want.abs()
        used = max(used, float(((got - want).abs() / limit).max()))
        typical = max(typical, float(want.abs().median()))
        del want, got, limit
    say("swa-path", f"every head against the plain version on the inputs "
                    f"upcast to f32, one head at a time: max|err| "
                    f"{max(errs):.3e} (head {errs.index(max(errs))}; heads 0 "
                    f"and {h - 1}: {errs[0]:.3e}, {errs[-1]:.3e}), at most "
                    f"{used:.3f} of the limit (tol {SWA_BF16_TOL}); median "
                    f"|out| per head at most {typical:.3e}")
    with torch.no_grad():
        route = attention.attention(q, k, v, window=window)
    route = route.permute(0, 2, 1, 3).reshape(h, s, hd)
    torch.testing.assert_close(out.float(), route.float(), **SWA_ROUTE_TOL)
    say("swa-path", f"layout and KV repeat: all {h} heads against attention("
                    f"q, k, v, window={window}) on its kernel route "
                    f"(swa_flash_fwd on the unexpanded KV, the same tile "
                    f"body): max|err|={_max_err(torch, out, route):.3e} (tol "
                    f"{SWA_ROUTE_TOL})")
    del q, k, v, qf, kf, vf, out, route
    torch.cuda.empty_cache()
    return {"launches": launches}


def time_swa_kernel(torch) -> dict:
    """swa_flash beside its bound, its plain version and one SDPA call at
    (a) BH 32, S 1024, hd 64, bf16, causal and (b) the path's BH 32,
    S 32768, hd 64, bf16, window 8192; (b) is the row's."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ref, swa_attention
    gen = torch.Generator(device="cuda").manual_seed(19)
    bh, hd = 32, 64

    def rnd(s):
        return [torch.randn((bh, s, hd), generator=gen,
                            device="cuda").bfloat16() for _ in range(3)]

    s = 1024
    q, k, v = rnd(s)
    bound, by = _swa_bound(bh, s, hd, 0, q.dtype)
    q4, k4, v4 = (x.view(1, bh, s, hd) for x in (q, k, v))
    a = {"ms": _time_ms(torch, lambda: swa_attention.swa_flash(q, k, v)),
         "plain_ms": _time_ms(torch, lambda: ref.swa_attention_ref(q, k, v),
                              reps=5),
         "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
             q4, k4, v4, is_causal=True)),
         "bound_ms": bound, "bound_by": by}
    say("times", f"swa_flash BH={bh} S={s} hd={hd} bf16 causal: {a} "
                 f"(library: SDPA, is_causal); {card_note(torch)}")
    del q, k, v, q4, k4, v4

    s, window = SWA_PATH["seq"], SWA_PATH["window"]
    q, k, v = rnd(s)
    bound, by = _swa_bound(bh, s, hd, window, q.dtype)
    ms = _time_ms(torch, lambda: swa_attention.swa_flash(q, k, v,
                                                         window=window),
                  reps=10, warmup=2)
    out = swa_attention.swa_flash(q, k, v, window=window)
    one = _time_ms(torch, lambda: ref.swa_attention_ref(
        q[:1], k[:1], v[:1], window=window), reps=5, warmup=1)
    plain = _time_ms(torch, lambda: [ref.swa_attention_ref(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], window=window)
        for i in range(bh)], reps=2, warmup=1)
    pos = torch.arange(s, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    q4, k4, v4 = (x.view(1, bh, s, hd) for x in (q, k, v))

    def sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band)
    lib, why = None, "SDPA (memory-efficient backend, boolean band mask)"
    try:
        lib_out = sdpa().view(bh, s, hd)
    except RuntimeError as e:
        why += f" raised: {str(e).splitlines()[0]}"
    else:
        err = _max_err(torch, lib_out, out)
        why += f", max|err| against the kernel {err:.3e}"
        if torch.allclose(lib_out.float(), out.float(), **FWD_TOL):
            lib = _time_ms(torch, sdpa, reps=5, warmup=1)
        else:
            why += f": beyond {FWD_TOL}, so not timed"
        del lib_out
    b = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
         "bound_by": by}
    say("times", f"swa_flash BH={bh} S={s} hd={hd} bf16 window={window}: {b}"
                 f" (plain: {bh} calls of one head each; one head alone "
                 f"{one:.4f} ms); library: {why}; {card_note(torch)}")
    del q, k, v, q4, k4, v4, out, band
    torch.cuda.empty_cache()
    return {"swa_flash": b}


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
