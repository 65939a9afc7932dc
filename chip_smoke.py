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
``backend="ref"`` (full width, 2 layers, f32), the same with Stage 4 by
Newton-Schulz, and two capture steps and a fast step of the double-buffered
optimizer (``NGDConfig(double_buffer=True)``), with the staged and active
buffers' identities; trains full-width ``llama3_2_1b`` for 4 steps of
``repro_torch.launch.train``'s loop (each a capture step or a fast step as
the staleness controller decides), then for a warm-up and three timed steps
of the fast-step builder; then a warm-up and three timed steps of momentum
SGD (``repro_torch.optim.SGD``) on a fresh model, beside the fast step.
The profiled fast and capture steps are split by the SP-NGD stage range
(``repro_torch.obs``) each launch fell in, and three overhead ratios are
timed: the metrics stream enabled over disabled on the fast-step loop, and
the stage and kernel ranges live over a null context on the fast step and
on 8 decode steps. Then the trainer's CLI at full width with the metrics
stream, the overhead probe and a one-step trace (``obs_path``), its stream
read back and its overhead decomposition printed by
``experiments/make_report.py``. Then Stage 4 by Newton-Schulz
(``inverse_method="newton_schulz"``): its kernels against the plain
iteration, full-width training for 2 loop steps and the fast-step
builder's warm-up and three timed steps, and again with
the double buffer (2 loop + 2 fast steps), its walls and peak memory beside
the single-buffer run's. Then the chunked refresh pipeline
(``refresh_chunks``) and checkpoints: the pipeline's capture, drain and
flip steps on the kernels against ``backend="ref"`` (2 layers, f32, fp8
history), a checkpoint saved mid-drain, restored on the card and resumed
bit for bit, and full-width training with the pipeline (K 4) under
Newton-Schulz and eigh, each step's wall beside the inline capture step.
Then the paper's own model: the ConvNet (``models/resnet.py``: conv K-FAC
through im2col, the unit-wise and the full BatchNorm Fisher) on the kernels
against ``backend="ref"`` for eigh and Newton-Schulz with either BatchNorm
Fisher (2 stages, f32, batch 16 at 16 x 16, 2 capture steps and a fast
step), and ``resnet50`` at full width trained by
``repro_torch.launch.train_convnet`` (the section 6 scheme: random erasing,
running mixup, polynomial decay, coupled momentum, weight rescaling) at
batch 1024 of 32 x 32 images for 8 steps, then its fast step beside
momentum SGD on the same batch, both steps split by SP-NGD stage, and a
capture step with the full BatchNorm Fisher; the factor-sum and
preconditioning kernels are also checked and timed at its conv shapes. Then the fp8 factor slice: the quant_rows,
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
route. Then multi-GPU Stage 3 and Stage 4 (``repro_torch.comm``) under an
NCCL group of one rank: the dist steps of each of the five reduce
strategies bit for bit equal to the single-device steps (2 layers, f32),
and so for the ConvNet route (the unit-wise and the full BatchNorm
Fisher), ``qwen2_moe_a2_7b`` at its route size (every strategy, the fused
capture over the expert axis) and reduced ``rwkv6_7b``; the ring's fp8
hop codec on the kernels against its plain version at llama3_2_1b's hop
shapes, and full-width training through the dist steps (dense and
ring_fp8), their walls beside the single-device path's, then ``resnet50``
at batch 1024 x 32^2 (dense, ring_fp8) and ``qwen2_moe_a2_7b`` at full
width (2 layers, fused at kfac_max_dim 1024) through the dist steps, beside
the ConvNet and MoE wire paths. Last, factor blocks aligned to 16
tensor-parallel shards (``tp_shards``: 128- and 512-wide blocks on the
sharded sides): a capture and a fast step of the route config on the
kernels against ``backend="ref"``, full-width training (2 capture steps,
a warm-up and three fast steps) beside ``train_path``'s walls, Stage-4
seconds and peak, and both kernels timed at the aligned shapes. Before
those, the dense architecture family: the five attention kernels at head
dim 192 (nemotron_4_340b's 96/8 heads, S 4096, bf16 and f32) against their
plain versions and timed beside SDPA; the same at public models' other
widths (check_attention_widths: hd 256, 96, 80 and, through the padded
copy, 100; the decode at G up to 71), hd 264 refused with no launch; each
new config (llama3_2_3b, qwen1_5_4b, musicgen_medium,
nemotron_4_340b, llava_next_34b) at a route size with its own head dim and
GQA group, a capture and a fast step on the kernels against
``backend="ref"``, then served; and llava_next_34b at full width (4
layers, its vision projector over 2880 image rows): SP-NGD under
Newton-Schulz, momentum SGD on the same batches, an eigh capture step,
prefill and decode, and its kernels timed at its shapes. Then the MoE
family (``models/moe.py``, grouped expert sites whose factor sums and
preconditioning take the expert axis in one launch): factor_syrk and
block_precond on expert stacks against their plain versions (qwen2_moe's
and mixtral's shapes, f32, a lead of 1, ragged blocks); each MoE config at
a route size (mixtral with its 8 experts and G 6, qwen2_moe with its 60
experts, top-4 and a shared expert), eigh and Newton-Schulz capture and
fast steps on the kernels against ``backend="ref"`` with equal routing,
then served (mixtral on the fp8 ring, qwen2_moe on the dense cache);
mixtral's attention at its own widths (S 8192, window 4096, G 6);
``qwen2_moe_a2_7b`` at full width (2 layers) trained with Newton-Schulz
beside momentum SGD and served; and both kernels timed at its expert
shapes. Then the MoE fused fp8 capture: factor_syrk_wire over all 60
experts in one launch against quant_rows' plain version on its own sums,
the b > 1024 wire route over the expert axis, and ``qwen2_moe_a2_7b`` at
full width trained with ``factor_wire="e4m3"`` (the b > 1024 route at
kfac_max_dim 2048, the fused kernel at 1024); and the launch layer's dry
run (``repro_torch.launch.dryrun``) on meta tensors, its argument bytes held
to the card's allocation of the same state and its Stage-4 report timed on
the card. Then the recurrent families and the legacy serving path
(``init_cache`` / ``prefill`` / ``decode_step`` with ``serve=None``):
``rwkv6_7b`` and ``hymba_1_5b`` reduced (f32, 2 layers), eigh and
Newton-Schulz capture and fast steps on the kernels against
``backend="ref"``; the legacy path of rwkv6_7b, hymba_1_5b, llama3_2_1b
and mixtral_8x22b (whose decode passes its window and takes the
decode-span clamp), kernels against ref, the prefill through
swa_flash_fwd and every decode step through swa_flash_decode; both
families at full width (2 layers) trained with Newton-Schulz beside
momentum SGD, split by stage with the scan apart, and served on the
legacy cache; and the kernels timed at their shapes. It times all
thirteen kernels beside their bound, their plain version and the PyTorch
library call for the same function, and again at the dense family's, the
MoE family's, the recurrent families' and the aligned blocks' shapes
(rows named ``kernel[hd192]``, ``kernel[hd256]``, ``kernel[hd96]``,
``kernel[hd80]``, ``kernel[g48]``, ``kernel[g71]``, ``kernel[llava]``,
``kernel[moe]``, ``kernel[rwkv]``, ``kernel[hymba]`` and
``kernel[tp16]``). factor_syrk (bf16, f32 and the fp8 wire),
ns_inverse_blocks and block_precond each run one case past 65,535
blocks in one launch.
Every failed check raises, so the exit code is nonzero. Without a CUDA
device, or outside a checkout, it exits nonzero and prints no result.

Output: one line per phase; then the card's name and power limit as
``nvidia-smi`` gives them, one JSON line with the kernels' numbers, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's peak rates (NVIDIA H100 80GB HBM3, 700 W, data sheet), read
# from repro_torch/launch/roofline.py by load_rates() (one source): the
# memory rate, the dense peak by dtype, and f32-accurate products on the
# tensor cores (each f32 operand split in two TF32 parts, three TF32
# products at 495 TFLOP/s: 165 TFLOP/s of f32 work), the bound of the f32
# product kernels (block_precond and the three Newton-Schulz kernels)
HBM_BYTES_PER_S = PEAK_OPS_PER_S = PEAK_SPLIT_F32_OPS_PER_S = None


def load_rates() -> None:
    """Set the peak rates from ``repro_torch.launch.roofline`` (``src`` on
    ``sys.path``); main calls it, a script calling phases one by one calls
    it first."""
    global HBM_BYTES_PER_S, PEAK_OPS_PER_S, PEAK_SPLIT_F32_OPS_PER_S
    from repro_torch.launch import roofline
    HBM_BYTES_PER_S = roofline.HBM_BW
    PEAK_OPS_PER_S = dict(roofline.PEAK_OPS_PER_S)
    PEAK_SPLIT_F32_OPS_PER_S = roofline.PEAK_SPLIT_F32_OPS_PER_S


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
# momentum-SGD steps timed on a fresh model (and one warm-up before them)
SGD_TIMED = 3
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
    load_rates()
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

    clock = {}

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        clock[fn.__name__] = time.perf_counter() - t
        return out

    single = check_train_route(torch)
    check_ns_route(torch)
    timed(check_db_route, torch, single)
    del single
    train = train_path(torch)
    train_walls = {k: train[k] for k in ("cap_s", "fast_median", "peak",
                                         "stage4_s", "refreshes")}
    launches.update({k: train["launches"][k] for k in TRAIN_KERNELS})
    times.update(time_train_kernels(torch))
    times.update(time_factor_sums(torch))
    time_conv_precond(torch)
    train_walls["fast_busy_us"] = profile_train(torch, train)
    timed(sgd_path, torch, train)
    t_obs = time.perf_counter()
    timed(obs_path, torch)
    t_obs = time.perf_counter() - t_obs

    errs.update(check_ns_kernels(torch))
    ns_path = train_path_ns(torch, train)
    train_walls["ns_stage4"] = ns_path["stage4_per_refresh"]
    launches.update({k: ns_path["launches"][k] for k in NS_KERNELS})
    ns_db = timed(train_path_ns_db, torch, ns_path)
    t_pipe = time.perf_counter()
    timed(check_pipeline_route, torch)
    timed(check_checkpoint_route, torch)
    timed(train_path_pipeline, torch, ns_path, ns_db)
    timed(train_path_pipeline_eigh, torch, train)
    t_pipe = time.perf_counter() - t_pipe
    del ns_db
    times.update(time_ns_kernels(torch))
    t_conv = time.perf_counter()
    timed(check_convnet_route, torch)
    conv_walls = timed(convnet_path, torch)
    t_fp8 = time.perf_counter()
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
    t_dense = time.perf_counter()
    hd192 = timed(check_attention_hd192, torch)
    widths = timed(check_attention_widths, torch)
    routes = timed(check_dense_routes, torch)
    llava = timed(llava_path, torch)
    llava_times = timed(time_llava_kernels, torch)
    t_moe = time.perf_counter()
    moe_errs = timed(check_moe_kernels, torch)
    timed(check_moe_routes, torch)
    moe = timed(moe_path, torch)
    moe_times = timed(time_moe_kernels, torch)
    t_new = time.perf_counter()
    moe_wire = timed(moe_wire_path, torch)
    timed(dryrun_path, torch)
    t_rec = time.perf_counter()
    timed(check_recurrent_routes, torch)
    rec = timed(recurrent_path, torch)
    rec_times, rec_errs = timed(time_recurrent_kernels, torch)
    t_dist = time.perf_counter()
    timed(check_dist_route, torch)
    timed(check_ring_hop, torch)
    timed(dist_path, torch, train_walls, conv_walls, moe_wire["runs"])
    t_tp = time.perf_counter()
    timed(check_tp_route, torch)
    tp = timed(tp_path, torch, train_walls)
    tp_times = timed(time_tp_kernels, torch)
    t_end = time.perf_counter()
    say("clock", f"{t_end - t_start:.1f} s from the build on, the "
                 f"observability phase obs_path {t_obs:.1f} s, the "
                 f"pipeline and checkpoint phases {t_pipe:.1f} s, the "
                 f"ConvNet phases {t_fp8 - t_conv:.1f} s, the fp8 "
                 f"phases {t_swa - t_fp8:.1f} s, the swa_attention phases "
                 f"{t_dense - t_swa:.1f} s, the dense-family phases "
                 f"{t_moe - t_dense:.1f} s, the MoE phases "
                 f"{t_new - t_moe:.1f} s, the MoE wire and dry-run phases "
                 f"{t_rec - t_new:.1f} s, the recurrent phases "
                 f"{t_dist - t_rec:.1f} s, the multi-GPU phases "
                 f"{t_tp - t_dist:.1f} s and the tensor-parallel-alignment "
                 f"phases {t_end - t_tp:.1f} s of it; by phase ("
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
    # the same kernels at the dense family's shapes: the hd-192 instances
    # at nemotron_4_340b's widths (launches: the nemotron route's training
    # and serving, and the op's path call) and llava_path's (its launches)
    where = {name: (source, replaces) for name, source, replaces in KERNEL_ROWS}
    nem = routes["nemotron_4_340b"]
    extra = [(f"{k}[hd192]", k, hd192["times"][k], hd192["errs"][k],
              {**nem, **hd192["launches"]}.get((k, HD192["hd"]), 0))
             for k in hd192["times"]]
    # and at public models' other widths (check_attention_widths: hd 256,
    # 96 and 80, the decode at G 48 and 71), the launches of its checks at
    # those widths, by the true hd
    extra += [(f"{k}[{label}]", k, widths["times"][label][k],
               widths["errs"][label][k],
               widths["launches"].get((k, WIDTHS[name][2]), 0))
              for label, (name, kernels) in WIDTH_ROWS.items()
              for k in kernels]
    extra += [(f"{k}[llava]", k, llava_times[k],
               llava_times[k]["max_abs_err"], llava["launches"][k])
              for k in LLAVA_KERNELS]
    # and at qwen2_moe_a2_7b's expert stacks: the worst error over
    # check_moe_kernels' cases, moe_path's launches
    extra += [(f"{k}[moe]", k, moe_times[f"{k}[moe]"], moe_errs[f"{k}[moe]"],
               moe["launches"][k]) for k in MOE_KERNELS]
    # factor_syrk_wire over the expert axis: the error of check_moe_wire's
    # one-launch case, the kernel's launches in moe_wire_path's capture step
    # at kfac_max_dim 1024 (its counts set to 0 just before)
    extra.append(("factor_syrk_wire[moe]", "factor_syrk_wire",
                  moe_times["factor_syrk_wire[moe]"],
                  moe_errs["factor_syrk_wire[moe]"],
                  moe_wire["launches"]["factor_syrk_wire"]))
    # and at the recurrent families' shapes: recurrent_path's launches
    extra += [(f"{k}[{fam}]", k, rec_times[f"{k}[{fam}]"],
               rec_errs[f"{k}[{fam}]"], rec[arch]["launches"][k])
              for fam, arch, kernels in (
                  ("rwkv", "rwkv6_7b", MOE_KERNELS),
                  ("hymba", "hymba_1_5b", MOE_KERNELS + ATTN_KERNELS
                   + ("swa_flash_decode",)))
              for k in kernels]
    # and at the factor blocks aligned to 16 tensor-parallel shards: the sums
    # over the 128- and 512-wide shapes, tp_path's launches
    extra += [(f"{k}[tp16]", k, tp_times[f"{k}[tp16]"],
               tp_times[f"{k}[tp16]"]["max_abs_err"], tp["launches"][k])
              for k in MOE_KERNELS]
    # and at the ConvNet path's f32 shapes (the narrow and wide routes):
    # convnet_path's launches at each (n, b), 32 a capture step in all
    extra += [(f"factor_syrk[conv {n}x{d}]", "factor_syrk",
               times[f"factor_syrk[conv {n}x{d}]"],
               times[f"factor_syrk[conv {n}x{d}]"]["max_abs_err"],
               conv_walls["f32_launches"].get((n, d), 0))
              for n, d in CONV_SYRK_TIMED]
    for label, name, t, err, n in extra:
        source, replaces = where[name]
        rows.append({"name": label, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{source}.cu",
                     "replaces": replaces, "launches": n,
                     "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # the decode past 16 query heads or at an hd that is not an instance's
    # runs the general instances, built from their own source
    for r in rows:
        label = r["name"].partition("[")[2].rstrip("]")
        if r["name"].startswith("swa_flash_decode[") and label in WIDTH_ROWS:
            heads, kv, hd = WIDTHS[WIDTH_ROWS[label][0]]
            if heads // kv > 16 or hd not in (64, 128, 192, 256):
                r["source"] = ("src/repro_torch/kernels/csrc/"
                               "swa_flash_decode_wide.cu")
    check(all(r["launches"] > 0 for r in rows),
          f"kernels with no launch on their path: "
          f"{[r['name'] for r in rows if not r['launches']]}")
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
    """swa_flash_fwd (bf16, the tensor-core walk) against its plain version
    at the serving shapes and the training path's call, output at FWD_TOL
    and lse at LSE_TOL; each case launched twice, the two identical."""
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
        out2, lse2 = swa_attention.swa_flash_fwd(q, k, v, window=window)
        torch.cuda.synchronize()
        check(torch.equal(out, out2) and torch.equal(lse, lse2),
              f"swa_flash_fwd BKV={bkv} G={g} S={s} window={window}: two "
              f"launches on the same inputs differ")
        ro, rl = ref.swa_attention_fwd_res_ref(q, k, v, window=window)
        torch.testing.assert_close(out.float(), ro.float(), **FWD_TOL)
        torch.testing.assert_close(lse, rl, **LSE_TOL)
        err = _max_err(torch, out, ro)
        worst = max(worst, err)
        say("prefill-kernel", f"BKV={bkv} G={g} S={s} window={window} bf16: "
                              f"max|out err|={err:.3e} max|lse err|="
                              f"{_max_err(torch, lse, rl):.3e} (tol {FWD_TOL}, "
                              f"lse {LSE_TOL}); a second launch identical")
        del q, k, v, out, lse, ro, rl, out2, lse2
    torch.cuda.empty_cache()
    return worst


def _decode_case(torch, gen, n, g, hd, c, kind, offset=0):
    """q (n, g, hd) f32 and the cache (n, c, hd) in ``kind``: f32, bf16, or
    an fp8 payload with its (n, c) row scales; an f32 cache ``offset``
    elements into a fresh buffer (1: rows off 16-byte boundaries)."""
    from repro_torch.quant import quant
    q = torch.randn((n, g, hd), generator=gen, device="cuda")

    def rows():
        buf = torch.randn((n * c * hd + offset,), generator=gen,
                          device="cuda")
        return buf[offset:].view(n, c, hd)
    k, v = rows(), rows()
    if kind == "bf16":
        return q, k.bfloat16(), v.bfloat16(), None, None
    if kind == "f32":
        return q, k, v, None, None
    kp, ks = quant.quantize_rows(k, kind)
    vp, vs = quant.quantize_rows(v, kind)
    return q, kp, vp, ks, vs


def _split_positions(torch, gen, n, c, window, per):
    """(n,) positions: 0, c - 1, both sides of every split boundary (the
    last slot of split s - 1 and the first of split s), for a ring also
    each of those one lap on (wrapped), the rest random."""
    edges = [0, c - 1] + [e for b in range(per, c, per) for e in (b - 1, b)]
    if window:
        edges += [c + e for e in edges]
    check(len(edges) <= n, f"{len(edges)} boundary positions > {n} lanes")
    pos = torch.randint(0, 3 * c, (n,), generator=gen, device="cuda")
    pos[:len(edges)] = torch.tensor(edges, device="cuda")
    return pos.to(torch.int32)


def check_decode_kernel(torch) -> float:
    """swa_flash_decode against its plain version at DEC_TOL: the dense f32
    cache and the fp8 rings at the paths' shapes, then hd 128, a bf16
    cache, G 1 and G 16, rows off 16-byte boundaries (the element loads),
    each with a query at both sides of every split boundary
    (``decode_splits``) and at 0 and C - 1 (unwrapped and wrapped on a
    ring), so that splits with nothing visible occur; every case launched
    twice, the two bit-identical."""
    from repro_torch.kernels import ref, swa_attention
    from repro_torch.quant import quant
    gen = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = 64
    worst = 0.0
    cases = [(4, 64, 1024, 0, "f32", 0), (4, 64, 256, 256, "e4m3", 0),
             (4, 64, 256, 256, "e5m2", 0), (4, 128, 1024, 0, "bf16", 0),
             (1, 64, 1024, 0, "f32", 0), (16, 128, 1024, 0, "f32", 0),
             (16, 64, 512, 512, "bf16", 0), (1, 128, 256, 256, "e4m3", 0),
             (16, 128, 256, 256, "e5m2", 0), (4, 64, 1024, 0, "f32", 1)]
    for g, hd, c, window, kind, off in cases:
        splits, per = swa_attention.decode_splits(n, c, hd, sms)
        pos = _split_positions(torch, gen, n, c, window, per)
        q, k, v, ks, vs = _decode_case(torch, gen, n, g, hd, c, kind, off)
        got = swa_attention.swa_flash_decode(q, k, v, pos, window=window,
                                             k_scale=ks, v_scale=vs)
        again = swa_attention.swa_flash_decode(q, k, v, pos, window=window,
                                               k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"swa_flash_decode G={g} hd={hd} "
              f"{kind} C={c}: two launches on the same inputs differ")
        want = ref.swa_decode_ref(q, k, v, pos, window=window, k_scale=ks,
                                  v_scale=vs)
        torch.testing.assert_close(got, want, **DEC_TOL)
        err = _max_err(torch, got, want)
        worst = max(worst, err)
        say("decode-kernel", f"N={n} G={g} hd={hd} "
                             f"{'ring' if window else 'dense'} {kind} C={c}"
                             f"{', rows off 16-byte boundaries' if off else ''}, "
                             f"{splits} splits of {per} slots, positions on "
                             f"every split boundary: max|err|={err:.3e} (tol "
                             f"{DEC_TOL}); a second launch identical")
    # the serving paths' calls: bf16 q and the (B, KV, C, hd) view of the
    # serving cache, read in place through strides -- the dense f32 cache of
    # the main path (B=8, C=1024) and the fp8 e4m3 ring of the ring path
    # (B=4, C=window=256) with its (B, KV, C) scale views
    view_cases = [("dense f32", 8, 1024, 0, None,
                   torch.tensor([0, 1023, 511, 63, 64, 700, 128, 300],
                                device="cuda")),
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
        again = swa_attention.swa_flash_decode(q, kview, vview, pos,
                                               window=window, k_scale=ks,
                                               v_scale=vs)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"swa_flash_decode cache view "
                                       f"{label}: two launches differ")
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
                             f"max|err|={err:.3e} (tol {DEC_TOL}); a second "
                             f"launch identical")
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


def _bound(ops: float, nbytes: float, dtype, rate: float | None = None
           ) -> tuple[float, str]:
    """The least time for ``ops`` operations at the peak of ``dtype`` (or
    ``rate`` operations a second) and ``nbytes`` at the memory rate."""
    rate = rate or PEAK_OPS_PER_S[str(dtype).replace("torch.", "")]
    t_ops = ops / rate * 1e3
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
                 f"C=256: ms {ring_ms:.6f}, bound_ms {bound_r:.6f} ({by_r}), "
                 f"library_ms (SDPA over the dequantized ring) {lib_r:.6f}; "
                 f"{card_note(torch)}")
    # the least any launch reads as in this harness: an empty kernel
    floor = _time_ms(torch, lambda: torch.cuda._sleep(0))
    say("times", f"an empty launch (torch.cuda._sleep(0)) reads ms "
                 f"{floor:.6f} in _time_ms (L2 flushed, launch latency "
                 f"included); {card_note(torch)}")
    say("path", f"prefill {main_path['prefill_tps']:.1f} tokens/s, decode "
                f"{main_path['decode_tps']:.1f} tokens/s at 8 lanes")
    return res



def _group(name: str) -> str:
    low = name.lower()
    if "swa_bwd" in low:
        return "attention backward"
    if "swa_" in low:
        return "attention forward"
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


def _kineto_device(prof) -> dict:
    """{kernel name: [device us, events]} from the trace's raw kineto
    events: kernels, memsets and copies, without the ranges' device
    projections. One pass over the events; ``key_averages()`` builds the
    whole operator tree first, about 85 us an event (a 12.5 s wait for a
    scan loop's 147,490 CPU events)."""
    from torch.autograd import DeviceType
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        annotation = getattr(e, "is_user_annotation", None)
        if name.startswith(RANGE_PREFIXES) or (annotation and annotation()):
            continue
        rec = out.setdefault(name, [0.0, 0])
        rec[0] += _ns(e, "duration") / 1e3
        rec[1] += 1
    return out


def _profile(torch, label, fn, warm: bool = True, split: bool = False):
    """Device time by kernel and by group over ``fn``, and the device's busy
    share of the wall time (torch.profiler, CUPTI, read from the raw kineto
    events: :func:`_kineto_device`); with ``split``, also by the SP-NGD
    stage and kernel range each launch fell in (:func:`_stage_split`).
    Returns the device-busy us (None when the trace holds no device
    time)."""
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
    evts = [(name, us, n) for name, (us, n) in _kineto_device(prof).items()]
    total = sum(us for _, us, _ in evts)
    if not total:
        say("profile", f"{label}: no device time in the trace (not measured)")
        return None
    groups: dict = {}
    for name, us, _ in evts:
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + us
    top = sorted(evts, key=lambda e: -e[1])[:6]
    say("profile", f"{label}: wall {wall_us:.0f} us (profiled), device "
                   f"busy {total:.0f} us ({total / wall_us:.3f} of wall, "
                   f"{sum(n for _, _, n in evts)} device events); by group "
                   + ", ".join(f"{g} {v:.0f} us ({v / total:.3f})"
                               for g, v in sorted(groups.items(),
                                                  key=lambda kv: -kv[1]))
                   + f"; {card_note(torch)}")
    for name, us, n in top:
        say("profile", f"  {us:9.0f} us  {n:5d} x  {name[:90]}")
    if split:
        _stage_split(torch, label, prof, total)
    return total


# the observability ranges (repro_torch.obs.tracing): stage, kernel, and
# the recurrent scans' forward (a loop of torch ops, no kernel range)
RANGE_PREFIXES = ("spngd.", "repro.kernels.", "repro.scan.")
# host API records of a launch, copy or memset (CUDA runtime and CUDA
# driver API calls: cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel,
# cudaMemcpyAsync, ...)
LAUNCH_PREFIX = "cu"
UNSCOPED_BEFORE = "unscoped, before the first precond range"
UNSCOPED_AFTER = "unscoped, between and after the precond ranges"
# the stage split must hold a trace's device time, and at most this share
# of it may lack its launch record
SPLIT_REL_TOL = 0.01


def _window(wins, starts, t):
    """The window of ``wins`` (sorted (start, end, name)) holding host time
    ``t``, the innermost of up to four nested ones, else None."""
    import bisect
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4, -1), -1):
        if wins[j][1] >= t:
            return wins[j]
    return None


def _ns(e, what: str) -> int:
    """``start`` or ``duration`` of a kineto event in ns (the ns accessors
    where this torch has them)."""
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def _stage_split(torch, label, prof, busy_us) -> None:
    """Device time of a profiled step by where its launch fell: each device
    event (kernel, copy, memset) goes to the ``spngd.*`` stage range whose
    host window holds its launch record (the CUDA API call of the same
    CUPTI correlation), on any thread: backward kernels launch on autograd's worker thread,
    outside the main thread's ranges in the profiler's tree but inside
    their windows. Outside every stage range it goes to the
    forward/backward side (before the first ``spngd.stage4.precond``) or
    the update side (between and after them). Inside each bucket the time
    is split by the ``repro.kernels.*[cuda]`` or ``repro.scan.*`` range
    holding the launch (with its launch count), the rest by kernel group.
    The buckets must sum to ``busy_us`` (the device events' sum) within
    SPLIT_REL_TOL."""
    from torch.autograd import DeviceType
    from repro_torch.obs import tracing
    launch, stages, kranges, dev = {}, [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        ranged = name.startswith(RANGE_PREFIXES)
        if e.device_type() == DeviceType.CUDA:
            annotation = getattr(e, "is_user_annotation", None)
            if not ranged and not (annotation and annotation()):
                dev.append((name, _ns(e, "duration") / 1e3,
                            e.correlation_id()))
            continue
        start = _ns(e, "start")
        if name.startswith(LAUNCH_PREFIX):
            launch[e.correlation_id()] = (start, name)
        elif ranged:
            win = (start, start + _ns(e, "duration"), name)
            if name.startswith("spngd."):
                stages.append(win)
            elif name.endswith("[cuda]") or name.startswith("repro.scan."):
                kranges.append(win)
    stages.sort()
    kranges.sort()
    s_starts = [w[0] for w in stages]
    k_starts = [w[0] for w in kranges]
    precond = [w[0] for w in stages if w[2] == tracing.STAGE_PRECOND]
    first_precond = min(precond) if precond else None
    buckets: dict = {}
    by_range: dict = {}
    range_n: dict = {}
    launch_names = set()
    for name, us, corr in dev:
        rec = launch.get(corr)
        t = None if rec is None else rec[0]
        if t is None:
            bucket = "launch not found"
        else:
            launch_names.add(rec[1])
            st = _window(stages, s_starts, t)
            if st is not None:
                bucket = st[2].split("[")[0]
            elif first_precond is None or t < first_precond:
                bucket = UNSCOPED_BEFORE
            else:
                bucket = UNSCOPED_AFTER
        b = buckets.setdefault(bucket, {"us": 0.0, "ranges": {},
                                        "groups": {}})
        b["us"] += us
        kr = _window(kranges, k_starts, t) if t is not None else None
        if kr is not None:
            b["ranges"][kr[2]] = b["ranges"].get(kr[2], 0.0) + us
            by_range[kr[2]] = by_range.get(kr[2], 0.0) + us
            range_n[kr[2]] = range_n.get(kr[2], 0) + 1
        else:
            g = _group(name)
            b["groups"][g] = b["groups"].get(g, 0.0) + us
    split = sum(b["us"] for b in buckets.values())
    say("stage-split", f"{label}: {split:.0f} us of device work by launch "
                       f"window against {busy_us:.0f} us busy "
                       f"({split / busy_us:.4f}); {len(stages)} "
                       f"stage and {len(kranges)} kernel ranges; launch "
                       f"records {sorted(launch_names)}; "
                       f"{card_note(torch)}")
    say("stage-split", "  by kernel range: " + ", ".join(
        f"{k} {v:.0f} us ({range_n[k]} device events)"
        for k, v in sorted(by_range.items(), key=lambda kv: -kv[1])))
    for bucket, b in sorted(buckets.items(), key=lambda kv: -kv[1]["us"]):
        say("stage-split", f"  {bucket}: {b['us']:.0f} us "
                           f"({b['us'] / busy_us:.3f}); in kernel ranges "
                           + (", ".join(f"{k} {v:.0f}" for k, v in sorted(
                               b["ranges"].items(), key=lambda kv: -kv[1]))
                              or "none")
                           + "; outside them by group "
                           + ", ".join(f"{g} {v:.0f}" for g, v in sorted(
                               b["groups"].items(), key=lambda kv: -kv[1])))
    check(abs(split - busy_us) <= SPLIT_REL_TOL * busy_us,
          f"{label}: the stage split holds {split:.0f} us, the trace "
          f"{busy_us:.0f} us busy")
    lost = buckets.get("launch not found", {"us": 0.0})["us"]
    check(lost <= SPLIT_REL_TOL * busy_us,
          f"{label}: {lost:.0f} us of device work without a launch record")


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
    _decode_scope_overhead(torch, model, reqs)


def _decode_scope_overhead(torch, model, reqs) -> None:
    """OBS_DECODE decode steps at 8 lanes with the kernel and stage ranges
    live against swapped for a null context (:func:`_scope_overhead`)."""
    import numpy as np
    from repro_torch.serve import ContinuousBatcher, ServeConfig
    batcher = ContinuousBatcher(model, ServeConfig(), slots=8, max_len=1024)
    rng = np.random.default_rng(5)
    # a warm-up sample, the counted one and the turns, all decoding
    for r in _requests(rng, model.cfg.vocab,
                       [len(r.prompt) for r in reqs[:8]],
                       OBS_DECODE * (4 * OBS_ROUNDS + 3)):
        batcher.admit(r)

    def steps():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(OBS_DECODE):
            batcher.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t
    _scope_overhead(torch, f"{OBS_DECODE} decode steps at 8 lanes", steps,
                    OBS_SCOPE_DECODE_BOUND)

# ---------------------------------------------------------------------------
# the training kernels against their plain versions
# ---------------------------------------------------------------------------

def _rel_err(torch, got, want) -> float:
    return _max_err(torch, got, want) / max(float(want.float().abs().max()),
                                            1e-30)


def check_factor_kernel(torch) -> float:
    """factor_syrk vs the plain blocked einsum at the training path's
    shapes (n 4096 x d 2048 / 8192 / 512 with max_dim 2048), a ragged n and
    a padded last block, bf16 and f32, at the ConvNet path's f32 shapes
    (CONV_SYRK_SHAPES: d 10 .. 576, n up to 1,048,576), and on both sides
    of the f32 bodies' switch at F32_SPLIT_ROWS rows, with nb > 1 and a
    lead (F32_EDGE_CASES); each case launched twice, the two outputs
    identical."""
    from repro_torch.core import kfac as ckfac
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
    shapes = [((n, d), 2048) for n, d in CONV_SYRK_SHAPES] + F32_EDGE_CASES
    for shape, max_dim in shapes:
        x = torch.randn(shape, generator=gen, device="cuda")
        n, d = shape[-2:]
        b = ckfac.block_size(d, max_dim)
        got = kfac.factor_syrk(x, max_dim)
        check(torch.equal(got, kfac.factor_syrk(x, max_dim)),
              f"factor_syrk f32 {shape}: two launches differ")
        want = ref.factor_sum_ref(x, max_dim)
        err = _rel_err(torch, got, want)
        check(got.shape == want.shape and err <= KFAC_REL_TOL
              and torch.equal(got, got.transpose(-1, -2)),
              f"factor_syrk f32 {shape} max_dim {max_dim}: "
              f"{tuple(got.shape)}, rel err {err} > {KFAC_REL_TOL} or not "
              f"symmetric")
        worst = max(worst, _max_err(torch, got, want))
        say("factor-kernel", f"f32 {shape} max_dim {max_dim} -> "
                             f"{tuple(got.shape)} ({kfac.syrk_f32_route(n, b)} "
                             f"route): max|err| / max|A| = {err:.3e} (tol "
                             f"{KFAC_REL_TOL}), exactly symmetric, a second "
                             f"launch identical")
        del x, got, want
    # past grid y's 65,535 (matrix, block) items in one launch (each grid
    # folds them into x): the bf16 body and f32's one-accumulator tile at
    # 66,000 matrices, f32's narrow route and its reduce at 66,000 blocks
    # of one column, and the fp8 wire's SYRK and pack at 66,000 matrices
    for shape, max_dim, dt in MANY_BLOCKS_SYRK:
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        n, d = shape[-2:]
        b = ckfac.block_size(d, max_dim)
        blocks = math.prod(shape[:-2]) * ckfac.num_blocks(d, max_dim)
        kfac.reset_launches()
        got = kfac.factor_syrk(x, max_dim)
        check(kfac.LAUNCHES["factor_syrk"] == 1, "factor_syrk: one launch")
        check(torch.equal(got, kfac.factor_syrk(x, max_dim)),
              f"factor_syrk {dtype} {shape}: two launches differ")
        want = ref.factor_sum_ref(x, max_dim)
        err = _rel_err(torch, got, want)
        check(got.shape == want.shape and err <= KFAC_REL_TOL
              and torch.equal(got, got.transpose(-1, -2)),
              f"factor_syrk {dtype} {shape} max_dim {max_dim}: rel err {err} "
              f"> {KFAC_REL_TOL} or not symmetric")
        worst = max(worst, _max_err(torch, got, want))
        route = kfac.syrk_f32_route(n, b) if dtype == torch.float32 else "tc"
        say("factor-kernel", f"{dtype} {shape} max_dim {max_dim}: {blocks} "
                             f"blocks of {b} in one launch ({route} route): "
                             f"max|err| / max|A| = {err:.3e} (tol "
                             f"{KFAC_REL_TOL}), exactly symmetric, a second "
                             f"launch identical")
        del got, want
        if len(shape) == 3:
            wire = {}
            _wire_case(torch, wire, "many", f"{shape} {dtype}, {blocks} "
                       f"blocks", x, max_dim, "e4m3", "fp32", "fused")
            check(torch.equal(*(_wire_bytes(torch, x, max_dim)
                                for _ in range(2))),
                  f"factor_syrk_wire {dtype} {shape}: two launches differ")
        del x
    torch.cuda.empty_cache()
    return worst


def _wire_bytes(torch, x, max_dim):
    """factor_syrk_wire's payload bytes and scales as one u8 tensor."""
    from repro_torch.kernels import quant as qk
    p, sc = qk.factor_syrk_wire(x, max_dim)
    return torch.cat([p.view(torch.uint8).flatten(),
                      sc.view(torch.uint8).flatten()])


# factor_syrk past 65,535 (matrix, block) items: (shape, max_dim, dtype)
MANY_BLOCKS_SYRK = [((66000, 64, 16), 2048, "bf16"),
                    ((66000, 64, 16), 2048, "f32"),
                    ((16384, 66000), 1, "f32")]


# f32 factor_syrk on both sides of F32_SPLIT_ROWS (16,384 rows) at the
# stem's A (27, narrow from there) and stage 0's (144, wide), and from there
# with nb > 1 or a lead: (shape, max_dim)
F32_EDGE_CASES = [((16383, 27), 2048), ((16384, 27), 2048),
                  ((16383, 144), 2048), ((16384, 144), 2048),
                  ((16384, 100), 64),      # nb 2 of 50: narrow, strided rows
                  ((16384, 2050), 1024),   # nb 3 of 684, ragged, rows off
                                           # 16 bytes: wide, element loads
                  ((2, 16384, 144), 2048),   # a lead: wide
                  ((3, 20000, 27), 2048)]    # a lead: narrow


# the ConvNet path's factor sums (resnet50, batch 1024 x 32^2, f32): (pixel
# positions, width) of the stem's A and G, stage 0's A (B x 32^2 x 144),
# stage 1's (16^2: A 144 and 288, G 32), stage 2's (8^2: A 288 and 576, G
# 64) and the head's A and G (1024 samples x 64 and 10)
CONV_SYRK_SHAPES = ((1048576, 27), (1048576, 16), (1048576, 144),
                    (262144, 144), (262144, 288), (262144, 32),
                    (65536, 288), (65536, 576), (65536, 64), (1024, 64),
                    (1024, 10))
# the path's block_precond calls (mode, nb, b, dim, other): each conv
# weight's (cin*k*k, cout) matrix from the left by A^-1 and from the right
# by G^-1, the head's (64, 10)
CONV_PRECOND_CASES = (
    ("left", 1, 27, 27, 16), ("right", 1, 16, 16, 27),
    ("left", 1, 144, 144, 16), ("right", 1, 16, 16, 144),
    ("left", 1, 144, 144, 32), ("left", 1, 288, 288, 32),
    ("right", 1, 32, 32, 288), ("left", 1, 16, 16, 32),
    ("left", 1, 288, 288, 64), ("left", 1, 576, 576, 64),
    ("right", 1, 64, 64, 576), ("left", 1, 32, 32, 64),
    ("left", 1, 64, 64, 10), ("right", 1, 10, 10, 64))


def check_precond_kernel(torch) -> float:
    """block_precond, both modes, vs the plain blocked einsum: every shape
    of the training path (b 2048; m 512 .. 128256; nb 1 and 4), a ragged
    last block, and the ConvNet path's (b 10 .. 576, CONV_PRECOND_CASES);
    a second launch on the same inputs gives the same bits."""
    from repro_torch.kernels import dispatch, kfac
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    # (mode, nb, b, dim, other)
    cases = [("left", 1, 2048, 2048, m) for m in (512, 2048, 8192, 128256)]
    cases += [("left", 4, 2048, 8192, 2048), ("right", 1, 2048, 2048, 2048),
              ("right", 1, 2048, 2048, 8192), ("right", 1, 2048, 2048, 128256),
              ("right", 4, 2048, 8192, 2048), ("right", 1, 512, 512, 2048),
              ("left", 3, 684, 2050, 300), ("right", 3, 684, 2050, 300)]
    cases += list(CONV_PRECOND_CASES)
    # past 65,535 blocks: the persistent walk over (block, tile) items was
    # never bound by a grid's y (66,000 blocks of 4)
    cases += [("left", 66000, 4, 264000, 16), ("right", 66000, 4, 264000, 16)]
    for mode, nb, b, dim, other in cases:
        binv = torch.randn((nb, b, b), generator=gen, device="cuda") / b ** 0.5
        shape = (dim, other) if mode == "left" else (other, dim)
        w = torch.randn(shape, generator=gen, device="cuda")
        right = mode == "right"
        got = kfac.block_precond(binv, w, right=right)
        again = kfac.block_precond(binv, w, right=right)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"block_precond {mode} {shape}: two "
                                       f"launches differ")
        del again
        want = (dispatch.lookup("block_precond_right", "ref")(w, binv) if right
                else dispatch.lookup("block_precond_left", "ref")(binv, w))
        err = _rel_err(torch, got, want)
        check(err <= KFAC_REL_TOL, f"block_precond {mode} {shape}: rel err "
                                   f"{err} > {KFAC_REL_TOL}")
        worst = max(worst, _max_err(torch, got, want))
        say("precond-kernel", f"{mode} binv ({nb}, {b}, {b}) w {shape} f32: "
                              f"max|err| / max|U| = {err:.3e} "
                              f"(tol {KFAC_REL_TOL}); two launches "
                              f"bit-identical")
        del binv, w, got, want
    # the dispatch op on an expanded identity (a fresh optimizer state's
    # preconditioner), 3 blocks of 97 over 290 columns
    eye = torch.eye(97, device="cuda").expand(3, 97, 97)
    w = torch.randn((70, 290), generator=gen, device="cuda")
    got = dispatch.block_precond_right(w, eye, backend="cuda")
    check(torch.equal(got, dispatch.block_precond_right(w, eye,
                                                        backend="cuda")),
          "dispatch.block_precond_right identity: two launches differ")
    err = _rel_err(torch, got, w)
    check(err <= KFAC_REL_TOL, f"dispatch.block_precond_right identity: {err}")
    say("precond-kernel", f"dispatch.block_precond_right w (70, 290) x an "
                          f"expanded identity (3, 97, 97): {err:.3e}")
    torch.cuda.empty_cache()
    return worst


def check_attention_bwd_kernels(torch) -> dict:
    """dq / dk / dv vs the plain backward at the training path's call (BKV
    32, G 4, S 1024, hd 64, bf16; window 0 and 256), plus S 1000, G 1 and
    hd 128, and S 517 (its f32 lse/delta rows are 2,068 bytes apart, a
    stride TMA cannot take) in bf16 and f32, each from the plain forward's
    (o, lse). At the training call the kernel chain (the forward kernel's o
    and lse into the backward kernels, as the training path runs them) is
    held against the plain chain as well. Each bf16 call is launched twice
    and the two must agree bit for bit."""
    from repro_torch.kernels import ref, swa_attention
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {"swa_flash_bwd_dq": 0.0, "swa_flash_bwd_dkdv": 0.0}
    cases = [(32, 4, 1024, 64, 0, torch.bfloat16),
             (32, 4, 1024, 64, 256, torch.bfloat16),
             (8, 4, 1000, 64, 0, torch.bfloat16),
             (8, 1, 1000, 64, 100, torch.bfloat16),
             (8, 4, 1000, 128, 0, torch.bfloat16),
             (4, 4, 517, 64, 0, torch.bfloat16),
             (4, 2, 517, 128, 64, torch.bfloat16),
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
            same = ""
            if dtype == torch.bfloat16:
                again = swa_attention.swa_flash_bwd(q, k, v, o_, lse_, do,
                                                    window=window)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                      f"attention bwd BKV={bkv} G={g} S={s} hd={hd} window="
                      f"{window} from the {label}: two launches on the same "
                      f"inputs differ")
                same = "; a second launch identical"
                del again
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
                                   f"{BWD_REL_TOL}){same}")
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


def check_train_route(torch) -> dict:
    """One SP-NGD capture step at full width, 2 layers, f32, through the
    kernels and again with backend="ref" on the card: the loss, the raw
    factor families and the updated params agree. Returns the kernel
    run's preconditioners ({"fam.key": tensor})."""
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
    return k["precond"]


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
        if "refresh_inflight" in m:
            recs[-1]["refresh_inflight"] = m["refresh_inflight"]
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
    base = torch.cuda.memory_allocated()
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
            "refreshes": len(cap), "peak": peak, "cap_s": cap, "base": base,
            "fast_median": statistics.median(fast_s)}


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
    bound, by = _bound(2 * b * b * m, (b * b + 2 * b * m) * 4, w.dtype,
                       PEAK_SPLIT_F32_OPS_PER_S)
    left_ref = dispatch.lookup("block_precond_left", "ref")
    res["block_precond"] = {
        "ms": _time_ms(torch, lambda: kfac.block_precond(binv, w)),
        "plain_ms": _time_ms(torch, lambda: left_ref(binv, w)),
        "library_ms": _time_ms(torch, lambda: torch.matmul(binv[0], w)),
        "bound_ms": bound, "bound_by": by}
    core, _ = _bound(2 * b * b * m, (b * b + 2 * b * m) * 4, w.dtype)
    say("times", f"block_precond left binv (1, {b}, {b}) w ({b}, {m}) f32: "
                 f"{res['block_precond']} (library: cuBLAS f32 matmul, TF32 "
                 f"off; the bound at the f32 CUDA cores' rate {core:.6f}); "
                 f"{card_note(torch)}")
    wh = torch.randn((128256, b), generator=gen, device="cuda")
    msh = _time_ms(torch, lambda: kfac.block_precond(binv, wh, right=True),
                   reps=5)
    libh = _time_ms(torch, lambda: torch.matmul(wh, binv[0]), reps=5)
    bh, byh = _bound(2 * b * b * 128256, (b * b + 2 * b * 128256) * 4,
                     wh.dtype, PEAK_SPLIT_F32_OPS_PER_S)
    say("times", f"block_precond right w (128256, {b}) binv (1, {b}, {b}) "
                 f"(the embedding's G side): ms {msh:.4f}, bound_ms {bh:.6f} "
                 f"({byh}; at the f32 CUDA cores' rate "
                 f"{_bound(2 * b * b * 128256, 0, wh.dtype)[0]:.6f}), "
                 f"library_ms {libh:.4f}; {card_note(torch)}")
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
    # the wrapper's delta = rowsum(do * o) pass, outside the kernels
    delta_ms = _time_ms(torch, lambda: (do.float() * o.float()).sum(-1))
    say("times", f"swa_flash_bwd BKV={bkv} G={g} S={s} hd={hd} bf16 causal: "
                 f"dq {res['swa_flash_bwd_dq']}, dkdv "
                 f"{res['swa_flash_bwd_dkdv']} (plain and library are the "
                 f"whole backward: the plain dq/dk/dv from materialized "
                 f"scores, SDPA's backward with enable_gqa); the wrapper's "
                 f"delta pass {delta_ms:.6f} ms; {card_note(torch)}")

    # the attention forward at the same call: the training path's 32
    # launches a step (16 layers, the forward run again under remat)
    del qs, ks_, vs_, out, gout
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + row_bytes
    b_fwd, by_fwd = _bound(4 * hd * pairs, nbytes, q.dtype)
    q4, k4, v4 = (q.reshape(4, 8 * g, s, hd), k.reshape(4, 8, s, hd),
                  v.reshape(4, 8, s, hd))
    fwd = {"ms": _time_ms(torch, lambda: swa_attention.swa_flash_fwd(q, k, v)),
           "plain_ms": _time_ms(torch, lambda: ref.swa_attention_fwd_res_ref(
               q, k, v), reps=5),
           "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
               q4, k4, v4, is_causal=True, enable_gqa=True)),
           "bound_ms": b_fwd, "bound_by": by_fwd}
    say("times", f"swa_flash_fwd BKV={bkv} G={g} S={s} hd={hd} bf16 causal "
                 f"(the training call): {fwd} (library: SDPA, is_causal, "
                 f"enable_gqa); {card_note(torch)}")
    return res


def profile_train(torch, train) -> float:
    """Device time by kernel group over one fast step and one capture step
    (every statistic refreshed) of the trained model, and the device's busy
    share of the wall time; each split by stage range
    (:func:`_stage_split`); then the fast step's overhead ratios
    (:func:`_fast_step_overheads`). Returns the fast step's device-busy
    us."""
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
    busy = _profile(torch, "one fast train step (4096 tokens)", fast_step,
                    split=True)
    _profile(torch, "one capture train step, every statistic refreshed",
             capture_step, warm=False, split=True)
    _fast_step_overheads(torch, opt, fast, params, box, batch, lam, lr)
    del train["model"], train["opt"], train["params"], train["state"]
    torch.cuda.empty_cache()
    return busy


# the overhead ratios: OBS_ROUNDS rounds of samples in turns (a, b, b, a),
# a sample one fast step or OBS_DECODE decode steps
OBS_ROUNDS = 6
OBS_DECODE = 8
# the bounds: the stream enabled over disabled (repro's own bound for
# obs.enabled_over_disabled), the ranges live over a null context
OBS_STREAM_BOUND = 1.03
OBS_SCOPE_FAST_BOUND = 1.01
OBS_SCOPE_DECODE_BOUND = 1.03


@contextlib.contextmanager
def _scopes_swapped(make):
    """The stage and kernel ranges swapped for ``make(live)(*args)`` (every
    call site reaches them through ``repro_torch.obs.tracing``)."""
    from repro_torch.obs import tracing
    live = tracing.stage_scope, tracing.kernel_scope
    tracing.stage_scope, tracing.kernel_scope = map(make, live)
    try:
        yield
    finally:
        tracing.stage_scope, tracing.kernel_scope = live


def _scopes_off():
    """The ranges swapped for a null context."""
    return _scopes_swapped(lambda f: lambda *a: contextlib.nullcontext())


def _ranges_in(fn) -> int:
    """How many stage and kernel ranges ``fn()`` opens."""
    n = [0]

    def counted(f):
        def g(*a):
            n[0] += 1
            return f(*a)
        return g
    with _scopes_swapped(counted):
        fn()
    return n[0]


def _in_turns(a, b, b_ctx=contextlib.nullcontext) -> tuple:
    """``a()`` and ``b()`` (the latter under ``b_ctx()``) in turns a, b, b,
    a for OBS_ROUNDS rounds: their values, as two lists."""
    got = {"a": [], "b": []}
    for _ in range(OBS_ROUNDS):
        for arm in "abba":
            if arm == "a":
                got["a"].append(a())
            else:
                with b_ctx():
                    got["b"].append(b())
    return got["a"], got["b"]


def _say_ratio(torch, what, on, off, bound, direct_s, how) -> None:
    """The ratio of the two arms' median walls, the spread of the ``off``
    arm's own samples (quartile distance over its median: a ratio inside
    it is not resolved), and the same ratio from the host work measured
    directly (``direct_s`` seconds a sample, ``how`` says what)."""
    med_on, med_off = statistics.median(on), statistics.median(off)
    r = med_on / med_off
    q = statistics.quantiles(off, n=4)
    spread = (q[2] - q[0]) / med_off
    est = 1.0 + direct_s / med_off
    verdict = (f"within the bound {bound}" if r <= bound else
               f"above the bound {bound} by less than the noise: unresolved"
               if r - 1.0 <= spread else f"MISSES the bound {bound}")
    say("obs-overhead", f"{what}: {r:.4f} ({verdict}; "
                        f"medians {med_on:.4f} / {med_off:.4f} s over "
                        f"{len(on)} samples each, the off arm's quartiles "
                        f"{spread:.4f} of its median apart); measured "
                        f"directly {1e3 * direct_s:.4f} ms a sample ({how})"
                        f" -> {est:.5f} ({'within' if est <= bound else 'MISSES'}"
                        f" the bound); {card_note(torch)}")


def _range_cost(torch, n: int = 5000) -> dict:
    """Host microseconds a range's enter and exit cost, no profiler on:
    ``torch.profiler.record_function`` itself, the kernel range as
    ``repro_torch.obs`` opens it (a null context while nothing records),
    and a null context."""
    from repro_torch.obs import tracing
    cost = {}
    for what, make in (
            ("record_function", lambda: torch.profiler.record_function(
                "repro.kernels.x[cuda]")),
            ("kernel_scope", lambda: tracing.kernel_scope("x", "cuda")),
            ("nullcontext", contextlib.nullcontext)):
        for _ in range(n // 10):
            with make():
                pass
        t = time.perf_counter()
        for _ in range(n):
            with make():
                pass
        cost[what] = (time.perf_counter() - t) / n * 1e6
    say("obs-overhead", "host us per range enter and exit, no profiler on: "
                        + ", ".join(f"{k} {v:.3f}" for k, v in cost.items())
                        + f"; {card_note(torch)}")
    return cost


def _scope_overhead(torch, what, sample, bound) -> None:
    """``sample()`` (a synchronized wall) with the ranges live against a
    null context, and the ranges' host cost reckoned from their count in
    one sample and :func:`_range_cost`."""
    sample()
    n = _ranges_in(sample)
    cost = _range_cost(torch)
    live, null = _in_turns(sample, sample, _scopes_off)
    extra = (cost["kernel_scope"] - cost["nullcontext"]) * 1e-6
    _say_ratio(torch, f"{what}, scopes live over null", live, null, bound,
               n * extra, f"{n} ranges x {1e6 * extra:.3f} us, their cost "
               "over a null context while nothing records; record_function "
               f"itself would be {n} x {cost['record_function']:.3f} us")


def _fast_step_overheads(torch, opt, fast, params, box, batch, lam,
                         lr) -> None:
    """One fast step with the metrics stream enabled against disabled (each
    step what ``train.run`` reads and writes for it), and with the ranges
    live against a null context: synchronized walls, samples in turns,
    medians."""
    from repro_torch.core.stale import IntervalController
    from repro_torch.obs import MetricsLogger
    names = opt.stat_names()
    none = {n: False for n in names}
    ctrl = IntervalController(names, bytes_per_stat=opt.stat_bytes())
    emitted = []
    step = [0]

    def sample(logger=MetricsLogger()):
        step[0] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, box["state"], m = fast(params, box["state"], batch, lam, lr, 0.0)
        ctrl.update(step[0], none, {})
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if logger.enabled:
            te = time.perf_counter()
            logger.log_step(step[0], loss=loss, dt=dt, kind="fast", lr=lr,
                            mom=0.0, n_refreshed=0, n_stats=len(none),
                            refreshed=[], grad_norm=float(m["grad_norm"]),
                            update_norm=float(m["update_norm"]),
                            comm=ctrl.drain())
            emitted.append(time.perf_counter() - te)
        return time.perf_counter() - t0

    out = ROOT / "build" / "obs"
    out.mkdir(parents=True, exist_ok=True)
    with MetricsLogger(str(out / "overhead.jsonl")) as logger:
        sample()
        on, off = _in_turns(lambda: sample(logger), sample)
    _say_ratio(torch, "fast step, metrics stream enabled over disabled", on,
               off, OBS_STREAM_BOUND, statistics.median(emitted),
               "the step event's reads and write, median")
    _scope_overhead(torch, "fast step", sample, OBS_SCOPE_FAST_BOUND)

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
    blocks, each launched twice; the whole tiled inverse at (16, 2048,
    2048); ragged b 1000 (resident) and 1100 (tiled); b 250 (resident) and
    1030 (tiled), rows off 16-byte alignment: the element loads. Every
    whole inverse is launched twice, and every launch must give the same
    bits as its twin."""
    from repro_torch.core import kfac
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import newton_schulz as ns
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = {k: 0.0 for k in NS_KERNELS}
    iters, tol = kfac.NS_ITERS, kfac.NS_TOL

    def whole(label, g, b, spread, damping, expect_conv: bool):
        f, d, m = _ns_factors(torch, gen, g, b, spread, damping)
        x, res, trips = ns.ns_inverse(m, iters, tol)
        again = ns.ns_inverse(m, iters, tol)
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip((x, res, trips), again)),
              f"NS {label} ({g}, {b}, {b}): two launches differ")
        del again
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
        msg = f"NS {label} ({g}, {b}, {b}) via {ns.route(b)}, two launches " \
              f"bit-identical: trips " \
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
    whole("unaligned", 4, 250, 1.0, 1e-3, True)
    whole("unaligned", 2, 1030, 1.0, 1e-3, True)

    # past grid y's 65,535 factor blocks: 66,000 blocks of 8 in one launch
    # of 66,000 clusters (folded into grid x), bit for bit the launches of
    # its slices below the old limit, and against the plain iteration
    g = 66000
    _, _, m = _ns_factors(torch, gen, g, 8, 1.0, 1e-3)
    ns.reset_launches()
    got = ns.ns_inverse_blocks(m, iters, tol)
    check(ns.LAUNCHES["ns_inverse_blocks"] == 1, "ns_inverse_blocks: one "
                                                 "launch")
    check(all(torch.equal(u, v) for u, v in
              zip(got, ns.ns_inverse_blocks(m, iters, tol))),
          f"NS ({g}, 8, 8): two launches differ")
    parts = [ns.ns_inverse_blocks(m[i:i + 33000].contiguous(), iters, tol)
             for i in (0, 33000)]
    check(all(torch.equal(torch.cat([p[j] for p in parts]), got[j])
              for j in range(3)),
          f"NS ({g}, 8, 8): one launch differs from two of 33,000 blocks")
    want = ref.ns_inverse_blocks_ref(m, iters, tol)
    # a block whose residual lands within the flag band of tol on either
    # side may stop a trip apart (the band is checked on the kernel's
    # residual too: at 66,000 blocks some reach 0.9990 tol, where the
    # plain iteration reads just above tol and takes one more trip)
    borderline = (((want[1] - tol).abs() <= NS_FLAG_BAND * tol)
                  | ((got[1] - tol).abs() <= NS_FLAG_BAND * tol))
    check(bool(((got[2] == want[2]) | borderline).all()),
          f"NS ({g}, 8, 8): trips differ from the plain iteration's off the "
          f"flag band")
    same = (got[2] == want[2]) & (got[1] <= tol) & (want[1] <= tol)
    err = _rel_err(torch, got[0][same], want[0][same])
    check(err <= NS_REL_TOL, f"NS ({g}, 8, 8): rel err {err} > {NS_REL_TOL}")
    worst["ns_inverse_blocks"] = max(worst["ns_inverse_blocks"],
                                     _max_err(torch, got[0][same],
                                              want[0][same]))
    say("ns-kernel", f"NS ({g}, 8, 8) in one launch of {g} clusters, bit "
                     f"for bit two launches of 33,000 and a twin: trips "
                     f"{int(got[2].min())}-{int(got[2].max())}, "
                     f"{int((got[2] != want[2]).sum())} a trip apart from "
                     f"the plain iteration's, each with a residual within "
                     f"{NS_FLAG_BAND:.0%} of tol; {int(same.sum())} alike "
                     f"and converged: max|err|/max {err:.3e} (tol "
                     f"{NS_REL_TOL})")
    del m, got, want, parts

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
        r2, ss2 = ns.ns_tiled_residual(m, x, act)
        xn2 = ns.ns_tiled_update(x, r, act)
        torch.cuda.synchronize()
        sel = live if act is not None else torch.ones_like(live)
        check(torch.equal(r[sel], r2[sel]) and torch.equal(ss, ss2)
              and torch.equal(xn, xn2),
              f"NS tiled pair ({label}): two launches differ")
        del r2, ss2, xn2
        wr, wss = ref.ns_tiled_residual_ref(m, x)
        wx = ref.ns_tiled_update_ref(x, wr)
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
                         f"{e_x:.3e} (tol {NS_PRODUCT_REL_TOL}); two launches "
                         f"bit-identical"
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
        held = _precond_bytes(state)
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
    return {"launches": launches, "peak": peak, "held": held,
            "cap_s": cap_s, "fast_s": fast_s,
            "stage4_per_refresh": s4.seconds / len(cap)}


def _precond_bytes(state) -> int:
    """Bytes of the distinct storages behind the preconditioner buffers
    (precond and, double-buffered, precond_next) of an SP-NGD state: an
    initial identity view costs its one row, two buffers holding the same
    tensors count once."""
    return sum(_storages(v for c in state["curv"].values()
                         for slot in ("precond", "precond_next")
                         for v in c.get(slot, {}).values()).values())


def _storages(tensors) -> dict:
    """{storage address: bytes} of the distinct storages behind
    ``tensors``."""
    out = {}
    for v in tensors:
        st = v.untyped_storage()
        out[st.data_ptr()] = st.nbytes()
    return out


def _db_route(torch, cfg) -> dict:
    """Two capture steps (every statistic refreshed) and one fast step of
    the double-buffered optimizer from the seed-0 model on the batches 0,
    1, 2 of the stream, on the kernels; before each, a second optimizer
    with backend="ref" takes the kernel run's params and state as they
    stand and runs the same step. Returns, per step, the kernel run's
    copies of both buffers, whether they hold the same tensors, both
    losses, and the worst max|err|/max of the buffers and of the params
    between the two runs; and the initial active buffer."""
    from repro_torch.core.fisher import flatten
    from repro_torch.launch import train
    runs = {b: train.build(cfg=cfg, backend=b, device="cuda",
                           double_buffer=True) for b in ("auto", "ref")}
    steps = {b: (train.make_train_step(m, o), train.make_fast_step(m, o))
             for b, (m, o, _, _) in runs.items()}
    _, kopt, kparams, kstate = runs["auto"]
    rparams = runs["ref"][2]
    init = {f"{fam}.{k}": v.clone() for fam, c in kstate["curv"].items()
            for k, v in c["precond"].items()}
    flags = {k: True for k in kopt.stat_names()}
    lam, lr = TRAIN["damping"], TRAIN["lr"]

    def snap(params, state, m):
        return {"loss": float(m["loss"]),
                "precond": {f"{fam}.{k}": v.clone()
                            for fam, c in state["curv"].items()
                            for k, v in c["precond"].items()},
                "next": {f"{fam}.{k}": v.clone()
                         for fam, c in state["curv"].items()
                         for k, v in c["precond_next"].items()},
                "same": all(c["precond"][k] is c["precond_next"][k]
                            for c in state["curv"].values()
                            for k in c["precond"])}
    out = {"auto": [], "init": init}
    for i in range(3):
        batch = _train_batch(torch, cfg.vocab, 2, 512, index=i)
        # the ref step starts where the kernel run stands: the same params
        # and state (the steps update only params and velocity in place)
        with torch.no_grad():
            for k, v in flatten(kparams).items():
                flatten(rparams)[k].copy_(v)
        rstate = {**kstate, "velocity": {k: v.clone() for k, v in
                                         kstate["velocity"].items()}}
        got = {}
        for b, params, state in (("ref", rparams, rstate),
                                 ("auto", kparams, kstate)):
            capture, fast = steps[b]
            if i < 2:
                params, state, m = capture(params, state, batch, flags, lam,
                                           lr, 0.9)
            else:
                params, state, m = fast(params, state, batch, lam, lr, 0.9)
            got[b] = snap(params, state, m)
            if b == "auto":
                kparams, kstate = params, state
            else:
                rstate = state
        k, r = got["auto"], got["ref"]
        k["ref_loss"] = r["loss"]
        k["worst"] = max(_rel_err(torch, k[key][n], want)
                         for key in ("precond", "next")
                         for n, want in r[key].items())
        rflat = flatten(rparams)
        k["worst_p"] = max(_rel_err(torch, v, rflat[n])
                           for n, v in flatten(kparams).items())
        out["auto"].append(k)
        del got, r, rstate
    del runs, steps, kopt, kparams, kstate, rparams
    torch.cuda.empty_cache()
    return out


def check_db_route(torch, single: dict) -> None:
    """The double buffer (NGDConfig.double_buffer) at full width, 2 layers,
    f32: two capture steps and a fast step on the kernels, each step also
    run with backend="ref" from the kernel run's params and state as they
    stand before it. Per step, the losses, both buffers and the params
    after it agree within ROUTE_REL_TOL (step by step, as check_fp8_route
    feeds the ref the kernel run's backward: the double buffer's stale
    inverses make large updates, through which a free-running pair of runs
    drifts apart by more than one step's kernel arithmetic). On the
    kernels: after capture step 1 the active buffer is still the initial
    one (identity blocks, ones, zero stats) and the staged one equals what
    the single-buffer kernel run's step 1 (``check_train_route``, the same
    batch) made active; capture step 2 applies the staged step-1
    inverses; the fast step activates step 2's, both buffers then the
    same tensors."""
    out = _db_route(torch, _route_cfg(torch))
    k = out["auto"]
    for i, x in enumerate(k):
        check(abs(x["loss"] - x["ref_loss"]) <= ROUTE_REL_TOL * abs(
            x["ref_loss"]), f"double-buffer route step {i + 1} loss "
                            f"{x['loss']} vs {x['ref_loss']}")
    worst = max(x["worst"] for x in k)
    worst_p = max(x["worst_p"] for x in k)
    check(worst <= ROUTE_REL_TOL,
          f"double-buffer route buffers rel err {worst}")
    check(worst_p <= ROUTE_REL_TOL,
          f"double-buffer route params rel err {worst_p}")
    check(all(torch.equal(k[0]["precond"][n], v)
              for n, v in out["init"].items()),
          "double buffer: capture step 1 must apply the initial buffer")
    stage = max(_rel_err(torch, k[0]["next"][n], v)
                for n, v in single.items())
    same = sum(int(torch.equal(k[0]["next"][n], v))
               for n, v in single.items())
    check(set(single) == set(k[0]["next"]) and stage <= ROUTE_REL_TOL,
          f"double buffer: staged step-1 inverses vs the single-buffer "
          f"step 1's, rel err {stage}")
    check(all(torch.equal(k[1]["precond"][n], v)
              for n, v in k[0]["next"].items()),
          "double buffer: capture step 2 must apply step 1's inverses")
    check(all(torch.equal(k[2]["precond"][n], v)
              for n, v in k[1]["next"].items())
          and [x["same"] for x in k] == [False, False, True],
          f"double buffer: the fast step must activate step 2's inverses "
          f"(both buffers the same tensors: {[x['same'] for x in k]})")
    by_step = "; ".join(f"step {i + 1} buffers {x['worst']:.3e}, params "
                        f"{x['worst_p']:.3e}" for i, x in enumerate(k))
    say("db-route", f"llama3_2_1b width, 2 layers, f32, batch (2, 512), "
                    f"double_buffer: 2 capture steps + 1 fast step on the "
                    f"kernels, each step also with backend='ref' from the "
                    f"kernel run's state: losses "
                    f"{[round(x['loss'], 6) for x in k]} vs "
                    f"{[round(x['ref_loss'], 6) for x in k]}; worst "
                    f"max|err|/max by step: {by_step} (tol {ROUTE_REL_TOL})")
    say("db-route", f"staged/active identities on the kernels: after "
                    f"capture step 1 the active buffer is the initial one "
                    f"({len(out['init'])} entries equal) and the staged one "
                    f"is the single-buffer step 1's ({same} of {len(single)} "
                    f"bit-identical, worst max|err|/max {stage:.3e}); "
                    f"capture step 2 applies step 1's; the fast step "
                    f"activates step 2's (both buffers the same tensors)")


def train_path_ns_db(torch, ns_path) -> dict:
    """launch.train at full width with Stage 4 by Newton-Schulz and the
    double buffer (``build(double_buffer=True)``, the CLI's
    ``--double-buffer``): 2 loop steps (both capture at random init), then
    a warm-up and one timed step of the fast-step builder. Prints the step
    walls, the bytes of both preconditioner buffers after the captures and
    the peak memory beside the single-buffer NS path's. Checks: every loss
    finite, the step kinds, the launches of the training kernels as
    reckoned, every NS kernel launched, no ref dispatch, and the fast step
    activating the staged buffer."""
    import math
    from repro_torch.kernels import dispatch, kfac, swa_attention
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, opt, params, state = train.build(
        "llama3_2_1b", full_config=True, device="cuda",
        inverse_method="newton_schulz", double_buffer=True)
    check(opt.cfg.double_buffer, "build(double_buffer=True) must reach "
                                 "NGDConfig")
    swa_attention.reset_launches()
    kfac.reset_launches()
    ns.reset_launches()
    dispatch.reset_calls()
    params, state, recs = train.run(
        model, opt, params, state,
        log=lambda m: say("db-train-path", m), **TRAIN_NS)
    held = _precond_bytes(state)
    params, state = _fast_steps(torch, model, opt, params, state, recs,
                                TRAIN_NS, "db-train-path", timed=1)
    kinds = [r["kind"] for r in recs]
    launches = {**swa_attention.LAUNCHES, **kfac.LAUNCHES, **ns.LAUNCHES}
    dcalls = dict(dispatch.CALLS)
    peak = torch.cuda.max_memory_allocated()
    check(kinds == ["capture"] * TRAIN_NS["steps"] + ["fast"] * 2,
          f"double-buffer NS step kinds {kinds}")
    check(all(math.isfinite(r["loss"]) for r in recs),
          f"double-buffer NS losses {[r['loss'] for r in recs]}")
    check(all(c["precond"][k] is c["precond_next"][k]
              for c in state["curv"].values() for k in c["precond"]),
          "double-buffer NS path: the fast steps must activate the staged "
          "buffer")
    check(not any(b == "ref" for (_, b) in dcalls),
          f"ref dispatches: {dcalls}")
    want = _train_counts(model.cfg, kinds)
    got = {k: launches[k] for k in want}
    check(got == want, f"double-buffer NS launches {got} != reckoned {want}")
    check(all(launches[k] > 0 for k in NS_KERNELS),
          f"the double-buffer NS path must run every NS kernel: {launches}")
    cap_s = [r["seconds"] for r in recs if r["kind"] == "capture"]
    fast_s = [r["seconds"] for r in recs if r["kind"] == "fast"]
    gib = 2 ** 30
    say("db-train-path", f"{len(recs)} steps (NS Stage 4, double buffer): "
                         f"losses {[round(r['loss'], 6) for r in recs]}; "
                         f"capture step wall {[round(x, 3) for x in cap_s]} s "
                         f"(single buffer {[round(x, 3) for x in ns_path['cap_s']]}"
                         f" s), fast step {[round(x, 3) for x in fast_s]} s "
                         f"(warm-up first; single buffer median "
                         f"{statistics.median(ns_path['fast_s']):.3f} s); "
                         f"{card_note(torch)}")
    say("db-train-path", f"preconditioner buffers after the 2 captures "
                         f"{held / gib:.3f} GiB (single buffer "
                         f"{ns_path['held'] / gib:.3f} GiB, difference "
                         f"{(held - ns_path['held']) / gib:.3f} GiB); peak "
                         f"memory {peak / gib:.2f} GiB (single buffer "
                         f"{ns_path['peak'] / gib:.2f} GiB, difference "
                         f"{(peak - ns_path['peak']) / gib:.2f} GiB; "
                         f"torch.cuda.max_memory_allocated, same call)")
    say("db-train-path", f"launches {got} (reckoned {want}), NS kernels "
                         f"{ {k: launches[k] for k in NS_KERNELS} }; "
                         f"dispatches {dcalls}")
    del model, opt, params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "peak": peak, "base": base}


# ---------------------------------------------------------------------------
# the refresh pipeline and checkpoints
# ---------------------------------------------------------------------------

# the route checks of the refresh pipeline and of checkpoints: the route
# config with the fp8 history, K 2
ROUTE_PIPE = dict(factor_dtype="fp8_e4m3", refresh_chunks=2)
# the family whose flags are off in the pipeline route's second capture
PIPE_IDLE = "blk/mlp_up"
# the full-width pipeline paths, K 4. Newton-Schulz: 7 loop steps (a
# capture, 4 drains, a capture at cursor K that flips first, a drain), then
# the fast-step builder's warm-up and FAST_TIMED steps (the last 3 chunks
# and the flip). eigh: 6 loop steps (a capture, 4 drains, a capture).
PIPE_K = 4
TRAIN_PIPE_NS = dict(TRAIN, steps=7)
TRAIN_PIPE_EIGH = dict(TRAIN, steps=6)


def _bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bytes (an expanded view compared by its
    elements)."""
    def raw(t):
        flat = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        return flat.copy_(t).reshape(-1).view(torch.uint8)
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(raw(a), raw(b)))


def _pipe_snap(params, state) -> dict:
    """Copies of the params, both buffers and the raw store, by name."""
    from repro_torch.core.fisher import flatten
    out = {f"params/{k}": v.detach().clone()
           for k, v in flatten(params).items()}
    for fam, c in state["curv"].items():
        for slot in ("precond", "precond_next"):
            out.update({f"{slot}/{fam}.{k}": v.clone()
                        for k, v in c[slot].items()})
    for fam, stats in state["pipeline"]["raw"].items():
        out.update({f"raw/{fam}.{k}": v.clone() for k, v in stats.items()})
    return out


def _expected_inflight(kinds, k) -> list:
    """refresh_inflight as the pipeline's state machine gives it for a run
    of step kinds from an idle pipeline (tests/test_refresh_pipeline.py's
    sequence): K+1 on a capture and on the first drain step, down to 1 on
    the flip step, 0 when idle."""
    cursor, out = k + 1, []
    for kind in kinds:
        if kind == "capture":
            out.append(k + 1)
            cursor = 0
        else:
            out.append(min(max(k + 1 - cursor, 0), k + 1))
            cursor = min(cursor + 1, k + 1)
    return out


def check_pipeline_route(torch) -> None:
    """The refresh pipeline (``refresh_chunks`` 2) at full width, 2 layers,
    f32, with the fp8 history: a capture with every statistic flagged, two
    drains, a capture with PIPE_IDLE's flags off (at cursor K, so it flips
    first), one drain, on the kernels; before each step a backend="ref"
    optimizer starts from the kernel run's params and state and runs the
    same step. Per step the losses, both buffers, the raw store and the
    params agree within ROUTE_REL_TOL, and refresh_inflight follows the
    state machine. On the kernels: PIPE_IDLE's encoded history passes the
    second capture bit for bit (payload and scale), that capture applies
    the drained buffer, and the drained inverses are bit-identical to the
    inline double-buffered refresh of the same statistics (one backward
    feeding both)."""
    from repro_torch.core.fisher import flatten
    from repro_torch.launch import train
    cfg = _route_cfg(torch)
    k = ROUTE_PIPE["refresh_chunks"]
    runs = {b: train.build(cfg=cfg, backend=b, device="cuda", **ROUTE_PIPE)
            for b in ("auto", "ref")}
    model, kopt, kparams, kstate = runs["auto"]
    _, ropt, rparams, _ = runs["ref"]
    inline = train.build(cfg=cfg, device="cuda", double_buffer=True,
                         factor_dtype=ROUTE_PIPE["factor_dtype"])
    flags = {n: True for n in kopt.stat_names()}
    mixed = {n: not n.startswith(PIPE_IDLE + ".") for n in flags}
    seq = [("capture", flags), ("fast", None), ("fast", None),
           ("capture", mixed), ("fast", None)]
    lam, lr = TRAIN["damping"], TRAIN["lr"]
    rows, same_inline, n_stale, flipped = [], None, 0, None
    for i, (kind, fl) in enumerate(seq):
        batch = _train_batch(torch, cfg.vocab, 2, 512, index=i)
        with torch.no_grad():
            rflat = flatten(rparams)
            for n, v in flatten(kparams).items():
                rflat[n].copy_(v)
        rstate = {**kstate, "velocity": {n: v.clone() for n, v in
                                         kstate["velocity"].items()}}
        if kind == "capture":
            at_k = kstate["pipeline"]["cursor"] == k
            staged = {fam: dict(c["precond_next"])
                      for fam, c in kstate["curv"].items()}
            hist = {(slot, key, part): v.clone()
                    for slot in ("prev", "prev2")
                    for key, enc in kstate["curv"][PIPE_IDLE][slot].items()
                    for part, v in enc.items()}
            _, rstate, rm = ropt.step(rparams, rstate, batch, fl, lam, lr,
                                      0.9)
            loss, aux, grads, raw = kopt.grads_and_raw(kparams, batch)
            counts = model.site_counts(batch)
            if i == 0:
                _, imodel_state, _ = inline[1].apply_update(
                    inline[2], inline[3], grads, raw, counts, fl, lam, lr,
                    0.9, loss, aux)
            kparams, kstate, km = kopt.apply_update(
                kparams, kstate, grads, raw, counts, fl, lam, lr, 0.9, loss,
                aux)
            del grads, raw
            if fl is mixed:
                check(at_k, "pipeline route: the second capture must come "
                            "at cursor K")
                for (slot, key, part), v in hist.items():
                    for st in (kstate, rstate):
                        check(_bits_equal(torch, st["curv"][PIPE_IDLE][slot]
                                          [key][part], v),
                              f"pipeline route: {PIPE_IDLE}.{key} {slot} "
                              f"{part} changed though not flagged")
                    n_stale += 1
                valid = kstate["pipeline"]["valid"]
                flipped = all(kstate["curv"][fam]["precond"][key]
                              is staged[fam][key]
                              for fam in staged for key in staged[fam]
                              if valid[fam][key])
                check(flipped, "pipeline route: a capture at cursor K must "
                               "apply the drained buffer")
        else:
            _, rstate, rm = ropt.step_fast(rparams, rstate, batch, lam, lr,
                                           0.9)
            kparams, kstate, km = kopt.step_fast(kparams, kstate, batch,
                                                 lam, lr, 0.9)
        got, want = _pipe_snap(kparams, kstate), _pipe_snap(rparams, rstate)
        by = {}
        for n, v in want.items():
            part = n.split("/", 1)[0]
            by[part] = max(by.get(part, 0.0), _rel_err(torch, got[n], v))
        rows.append({"kind": kind, "loss": float(km["loss"]),
                     "ref_loss": float(rm["loss"]), "by": by,
                     "inflight": km["refresh_inflight"],
                     "ref_inflight": rm["refresh_inflight"],
                     "cursor": kstate["pipeline"]["cursor"]})
        del got, want, rstate
        if i == 2:
            # every chunk drained: precond_next against the inline refresh
            n_same = sum(
                int(_bits_equal(torch, v, imodel_state["curv"][fam]
                                ["precond_next"][key]))
                for fam, c in kstate["curv"].items()
                for key, v in c["precond_next"].items())
            same_inline = (n_same, len(flags))
            del inline, imodel_state
            torch.cuda.empty_cache()
    want_inf = _expected_inflight([kd for kd, _ in seq], k)
    for i, x in enumerate(rows):
        check(abs(x["loss"] - x["ref_loss"]) <= ROUTE_REL_TOL * abs(
            x["ref_loss"]), f"pipeline route step {i + 1} loss {x['loss']} "
                            f"vs {x['ref_loss']}")
        check(x["inflight"] == x["ref_inflight"] == want_inf[i],
              f"pipeline route step {i + 1} refresh_inflight "
              f"{x['inflight']} / ref {x['ref_inflight']}, want "
              f"{want_inf[i]}")
        for part, err in x["by"].items():
            check(err <= ROUTE_REL_TOL, f"pipeline route step {i + 1} "
                                        f"{part} rel err {err}")
    check(same_inline[0] == same_inline[1],
          f"pipeline route: drained inverses bit-identical to the inline "
          f"double-buffered refresh for {same_inline[0]} of "
          f"{same_inline[1]} statistics")
    by_step = "; ".join(
        f"{i + 1} {x['kind']} (inflight {x['inflight']}, cursor after "
        f"{x['cursor']}): " + ", ".join(f"{p} {e:.2e}"
                                        for p, e in x["by"].items())
        for i, x in enumerate(rows))
    say("pipeline-route", f"llama3_2_1b width, 2 layers, f32, batch (2, 512),"
                          f" fp8_e4m3 history, refresh_chunks {k}: capture, "
                          f"2 drains, capture with {PIPE_IDLE} unflagged, "
                          f"drain, on the kernels, each step also with "
                          f"backend='ref' from the kernel run's state: losses "
                          f"{[round(x['loss'], 6) for x in rows]} vs "
                          f"{[round(x['ref_loss'], 6) for x in rows]}; worst "
                          f"max|err|/max by step: {by_step} (tol "
                          f"{ROUTE_REL_TOL})")
    say("pipeline-route", f"on the kernels: {PIPE_IDLE}'s encoded history "
                          f"({n_stale} payload and scale tensors of X_-1 and "
                          f"X_-2) unchanged bit for bit through the capture "
                          f"that did not flag it, in the kernel and the ref "
                          f"step; the capture at cursor {k} applied the "
                          f"drained buffer; drained inverses bit-identical "
                          f"to the inline double-buffered refresh of the "
                          f"same statistics for {same_inline[0]} of "
                          f"{same_inline[1]}")
    del runs, model, kopt, kparams, kstate, ropt, rparams
    torch.cuda.empty_cache()


def _run_leaves(model, state) -> dict:
    """A run's params and optimizer state by path: tensors, and the host
    step, cursor and latches."""
    from repro_torch.core.fisher import flatten
    out = {f"params/{k}": v for k, v in model.state_dict().items()}
    out.update({f"state/{k}": v for k, v in flatten(state).items()})
    return out


def _leaf_gap(torch, a, b) -> float:
    """0 when two leaves are the same bits, else their max |difference|
    (inf for a host value or a shape that differs)."""
    if not isinstance(a, torch.Tensor):
        return 0.0 if a == b else float("inf")
    if _bits_equal(torch, a, b):
        return 0.0
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    return float((a.float() - b.float()).abs().max())


def check_checkpoint_route(torch) -> None:
    """Checkpoints on the card: the pipeline route's config (full width, 2
    layers, f32, fp8 history, refresh_chunks 2) after a capture and one
    drain (mid-drain, 0 < cursor < K), saved with
    ``repro_torch.checkpoint.save_checkpoint`` into a temporary directory
    under ``build/`` (removed after) and restored on the card. Every leaf
    (fp8 payload bits included), the cursor, the valid latches and the
    controller's state_dict restore bit for bit. Then the run goes on 2
    steps (a drain and the flip) three ways: as it stands, from a copy
    made on the card before the save, and from the restore; the restored
    run's leaves must equal the uninterrupted run's bit for bit, or, where
    the two uninterrupted runs differ (a library call that does not repeat
    its bits), lie within their measured spread."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.fisher import flatten, unflatten
    from repro_torch.core.stale import IntervalController
    from repro_torch.launch import train
    cfg = _route_cfg(torch)
    k = ROUTE_PIPE["refresh_chunks"]
    lam, lr = TRAIN["damping"], TRAIN["lr"]
    model, opt, params, state = train.build(cfg=cfg, device="cuda",
                                            **ROUTE_PIPE)
    ctrl = IntervalController(opt.stat_names(), alpha=opt.cfg.alpha,
                              min_interval=k + 1,
                              bytes_per_stat=opt.stat_bytes())
    for t in (1, 2):
        flags = ctrl.flags(t)
        batch = _train_batch(torch, cfg.vocab, 2, 512, index=t - 1)
        if any(flags.values()):
            params, state, m = opt.step(params, state, batch, flags, lam, lr,
                                        0.9)
        else:
            params, state, m = opt.step_fast(params, state, batch, lam, lr,
                                             0.9)
        ctrl.update(t, flags, m["sims"])
    cursor = state["pipeline"]["cursor"]
    check(0 < cursor < k, f"checkpoint route: cursor {cursor} is not "
                          f"mid-drain (0 < cursor < {k})")
    # the second uninterrupted run: a copy on the card of the run as it
    # stands
    twin = train.build(cfg=cfg, device="cuda", **ROUTE_PIPE)
    twin[0].load_state_dict(model.state_dict())
    flat = flatten(state)
    twin_state = unflatten(
        {n: v.clone() if isinstance(v, torch.Tensor) else v
         for n, v in flat.items()}, state)
    live = _run_leaves(model, state)
    need = sum(v.numel() * v.element_size() for v in live.values()
               if isinstance(v, torch.Tensor))
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    free = shutil.disk_usage(build_dir).free
    check(free >= 2 * need, f"checkpoint route: {free / 2 ** 30:.2f} GiB "
                            f"free under {build_dir}, the checkpoint needs "
                            f"about {need / 2 ** 30:.2f} GiB (twice that "
                            f"asked for)")
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt-", dir=build_dir)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(ckpt_dir, 2, params, state, ctrl.state_dict())
        t_save = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                      for f in os.listdir(ckpt_dir))
        t0 = time.perf_counter()
        r = restore_checkpoint(ckpt_dir, cfg=cfg)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir)
    model3, opt3, _, _ = train.build(cfg=cfg, device="cuda", **ROUTE_PIPE)
    model3.load_state_dict(r["params"])
    state3 = opt3.upgrade_state(r["opt_state"])
    back = _run_leaves(model3, state3)
    check(set(back) == set(live), "checkpoint route: restored leaves "
                                  f"{sorted(set(back) ^ set(live))[:4]} "
                                  "differ from the saved ones")
    bad = [n for n, v in live.items() if _leaf_gap(torch, back[n], v)]
    check(not bad, f"checkpoint route: {len(bad)} leaves not restored bit "
                   f"for bit, e.g. {bad[:3]}")
    on_card = all(v.is_cuda for v in back.values()
                  if isinstance(v, torch.Tensor))
    check(on_card, "checkpoint route: the restore must put every tensor on "
                   "the card")
    check(state3["pipeline"]["cursor"] == cursor and r["controller"]
          == ctrl.state_dict() and IntervalController.from_state_dict(
              r["controller"]).state_dict() == ctrl.state_dict(),
          "checkpoint route: cursor or controller not restored")
    n_fp8 = sum(1 for v in back.values() if isinstance(v, torch.Tensor)
                and v.dtype == torch.float8_e4m3fn)
    del back, r
    runs = {"uninterrupted": (model, opt, params, state),
            "copy": (twin[0], twin[1], twin[0].params(), twin_state),
            "restored": (model3, opt3, model3.params(), state3)}
    out = {}
    for name, (m_, o_, p_, s_) in runs.items():
        for t in (3, 4):
            batch = _train_batch(torch, cfg.vocab, 2, 512, index=t - 1)
            p_, s_, _ = o_.step_fast(p_, s_, batch, lam, lr, 0.9)
        check(s_["pipeline"]["cursor"] == k + 1, f"checkpoint route: the "
              f"{name} run did not flip after 2 steps")
        out[name] = _run_leaves(m_, s_)
    u, c, rr = out["uninterrupted"], out["copy"], out["restored"]
    spread = {n: _leaf_gap(torch, c[n], v) for n, v in u.items()}
    gap = {n: _leaf_gap(torch, rr[n], v) for n, v in u.items()}
    over = [n for n in u if gap[n] > spread[n]]
    check(not over, f"checkpoint route: the resumed run leaves the "
                    f"uninterrupted runs' spread at {len(over)} leaves, "
                    f"e.g. {[(n, gap[n], spread[n]) for n in over[:3]]}")
    n_spread = sum(1 for v in spread.values() if v)
    n_gap = sum(1 for v in gap.values() if v)
    say("checkpoint-route", f"llama3_2_1b width, 2 layers, f32, fp8_e4m3 "
                            f"history, refresh_chunks {k}, saved at step 2 "
                            f"mid-drain (cursor {cursor}): {written} bytes "
                            f"({written / 2 ** 30:.3f} GiB) in "
                            f"{len(live)} leaves ({n_fp8} fp8), save "
                            f"{t_save:.2f} s, restore onto the card "
                            f"{t_restore:.2f} s; every leaf, the cursor, the "
                            f"valid latches and the controller restored bit "
                            f"for bit")
    say("checkpoint-route", f"2 more steps (a drain, the flip): the copy on "
                            f"the card differs from the uninterrupted run at "
                            f"{n_spread} of {len(u)} leaves, the restored "
                            f"run at {n_gap} (bit for bit where 0); "
                            f"{card_note(torch)}")
    del runs, out, u, c, rr, model, opt, params, state, twin, twin_state
    del model3, opt3, state3, live
    torch.cuda.empty_cache()


def _pipeline_path(torch, phase, spec, timed, patches=(), **build_kw):
    """launch.train at full width with the refresh pipeline (PIPE_K
    chunks) for ``spec``'s loop steps, then (``timed`` > 0) the fast-step
    builder's warm-up and ``timed`` steps. Records per step the
    Newton-Schulz launches and the torch.linalg.eigh calls made inside the
    capture (``apply_update``) or the drain (``fast_curv``); ``patches``
    (module, name, function) are set for the run. Checks: every loss
    finite, no capture within K steps of a capture, refresh_inflight as the
    state machine gives it, no Stage-4 work on a capture step and some on
    every drain step (none on the flip), the training kernels' launches as
    reckoned, no ref dispatch. Prints the schedule and each step."""
    import math
    from repro_torch.kernels import dispatch, kfac, swa_attention
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, opt, params, state = train.build(
        "llama3_2_1b", full_config=True, device="cuda",
        refresh_chunks=PIPE_K, **build_kw)
    pipe = opt.pipeline
    check(opt.cfg.double_buffer and pipe is not None and
          pipe.chunks == PIPE_K, "build(refresh_chunks=) must reach "
                                 "NGDConfig and set the double buffer")
    say(phase, f"refresh_chunks {PIPE_K}: LPT loads (lead x b^3 a blocked "
               f"factor) {pipe.loads}; "
               + "; ".join(f"chunk {i}: {pipe.chunk_names(i)}"
                           for i in range(PIPE_K)))
    eigh_calls = [0]
    real_eigh = torch.linalg.eigh

    def eigh_spy(*a, **kw):
        eigh_calls[0] += 1
        return real_eigh(*a, **kw)

    # per step: NS launches, eigh calls, and the peak allocation since the
    # previous step's watched call (its update, then this step's forward,
    # backward and capture or chunk)
    work = []

    def watch(fn):
        def run(*a, **kw):
            n0, e0 = sum(ns.LAUNCHES.values()), eigh_calls[0]
            out = fn(*a, **kw)
            work.append((sum(ns.LAUNCHES.values()) - n0,
                         eigh_calls[0] - e0,
                         torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            return out
        return run
    opt.apply_update = watch(opt.apply_update)
    opt.fast_curv = watch(opt.fast_curv)
    patches = [(torch.linalg, "eigh", eigh_spy), *patches]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    swa_attention.reset_launches()
    kfac.reset_launches()
    ns.reset_launches()
    dispatch.reset_calls()
    try:
        params, state, recs = train.run(
            model, opt, params, state, log=lambda m: say(phase, m), **spec)
        if timed:
            params, state = _fast_steps(torch, model, opt, params, state,
                                        recs, spec, phase, timed=timed)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        del opt.apply_update, opt.fast_curv     # the wrappers hold opt
    peak = max([torch.cuda.max_memory_allocated()]
               + [w[2] for w in work])
    raw = _storages(v for stats in state["pipeline"]["raw"].values()
                    for v in stats.values())
    hist = _storages(v for c in state["curv"].values()
                     for slot in ("prev", "prev2")
                     for v in c[slot].values() if not isinstance(v, dict))
    kinds = [r["kind"] for r in recs]
    launches = {**swa_attention.LAUNCHES, **kfac.LAUNCHES, **ns.LAUNCHES}
    calls = dict(dispatch.CALLS)
    check(all(math.isfinite(r["loss"]) for r in recs),
          f"{phase} losses {[r['loss'] for r in recs]}")
    caps = [i for i, kd in enumerate(kinds) if kd == "capture"]
    check(len(caps) >= 2 and all(b - a > PIPE_K
                                 for a, b in zip(caps, caps[1:])),
          f"{phase}: captures at steps {[i + 1 for i in caps]}, within "
          f"{PIPE_K} steps of each other")
    want_inf = _expected_inflight(kinds, PIPE_K)
    got_inf = [r.get("refresh_inflight") for r in recs]
    check(got_inf == want_inf, f"{phase} refresh_inflight {got_inf} != "
                               f"{want_inf}")
    check(len(work) == len(recs), f"{phase}: {len(work)} watched calls for "
                                  f"{len(recs)} steps")
    for r, inf, (n_ns, n_eigh, top) in zip(recs, want_inf, work):
        r["ns"], r["eigh"], r["peak"] = n_ns, n_eigh, top
        drain = r["kind"] == "fast" and inf >= 2
        check(drain == (n_ns + n_eigh > 0),
              f"{phase} step {r['t']} ({r['kind']}, inflight {inf}): "
              f"{n_ns} NS launches, {n_eigh} eigh calls")
    want = _train_counts(model.cfg, kinds)
    got = {k: launches[k] for k in want}
    check(got == want, f"{phase} launches {got} != reckoned {want}")
    check(not any(b == "ref" for (_, b) in calls), f"ref dispatches: {calls}")
    def what(r, inf):
        if r["kind"] == "capture":
            return "capture"
        return (f"drain chunk {PIPE_K + 1 - inf}" if inf >= 2
                else "flip" if inf == 1 else "fast")
    say(phase, "steps: " + "; ".join(
        f"{r['t']} {what(r, inf)} inflight {inf} {r['seconds']:.3f} s (NS "
        f"launches {r['ns']}, eigh {r['eigh']}, peak "
        f"{r['peak'] / 2 ** 30:.2f} GiB)"
        for r, inf in zip(recs, want_inf)))
    say(phase, f"launches {got} (reckoned {want}), NS kernels "
               f"{ {k: launches[k] for k in NS_KERNELS} }; dispatches "
               f"{calls}")
    out = {"recs": recs, "peak": peak, "base": base,
           "raw": sum(raw.values()),
           "raw_shared": sum(v for p, v in raw.items() if p in hist),
           "launches": launches}
    del model, opt, params, state
    torch.cuda.empty_cache()
    return out


def _pipeline_walls(recs) -> dict:
    """Walls of the capture steps, of the drain steps by chunk, and of the
    flip steps; a drain step is a fast step with inflight >= 2, its chunk
    K + 1 - inflight."""
    walls = {"capture": [], "drain": {}, "flip": []}
    for r in recs:
        inf = r["refresh_inflight"]
        if r["kind"] == "capture":
            walls["capture"].append(r["seconds"])
        elif inf >= 2:
            walls["drain"].setdefault(PIPE_K + 1 - inf, []).append(
                r["seconds"])
        elif inf == 1:
            walls["flip"].append(r["seconds"])
    return walls


def _say_pipeline(torch, phase, p, inline_cap, fast_median, peak_ref,
                  ref_name) -> None:
    w = _pipeline_walls(p["recs"])
    # the first drain step of a run pays the chunk's first calls: its
    # walls are listed, the peak surcharge takes the worst of all
    drains = [x for v in w["drain"].values() for x in v]
    worst = max(drains)
    gib = 2 ** 30
    say(phase, f"walls: capture {[round(x, 3) for x in w['capture']]} s "
               f"(inline capture step "
               f"{[round(x, 3) for x in inline_cap]} s); drain by chunk "
               + ", ".join(f"{i}: {[round(x, 3) for x in v]}"
                           for i, v in sorted(w["drain"].items()))
               + f" s; flip {[round(x, 3) for x in w['flip']]} s; fast "
               f"step median {fast_median:.3f} s (inline run, same call); "
               f"peak drain-step surcharge over the fast step "
               f"{worst - fast_median:.3f} s ({worst / fast_median:.2f}x "
               f"the fast step); {card_note(torch)}")
    say(phase, f"raw store {p['raw'] / gib:.3f} GiB, {p['raw_shared'] / gib:.3f}"
               f" GiB of it the X_-1 history's own storage (f32 history: "
               f"the parked statistic is X_-1); peak memory "
               f"{p['peak'] / gib:.2f} GiB, {(p['peak'] - p['base']) / gib:.2f}"
               f" GiB above the {p['base'] / gib:.2f} GiB allocated at the "
               f"phase's start ({ref_name} {peak_ref[0] / gib:.2f} GiB, "
               f"{(peak_ref[0] - peak_ref[1]) / gib:.2f} GiB above its "
               f"start; torch.cuda.max_memory_allocated, same call)")


def train_path_pipeline(torch, ns_path, ns_db) -> None:
    """The refresh pipeline at full width with Stage 4 by Newton-Schulz:
    ``_pipeline_path`` over TRAIN_PIPE_NS's 7 loop steps and the fast-step
    builder's warm-up and FAST_TIMED steps. Also checks the launches of
    the three NS kernels as reckoned from the recorded trips, and that the
    plain iteration never runs. Prints the walls beside the inline NS
    path's capture step and fast-step median, the peak drain-step
    surcharge, the raw store's bytes and the peak memory beside the
    double-buffered NS path's."""
    from repro_torch.core import kfac as kfac_core
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import ref
    calls, plain = [], []
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
    patches = [(ns, "ns_inverse", spy_ns)] + [
        (mod, name, plain_spy(getattr(mod, name)))
        for mod, name in ((kfac_core, "newton_schulz_inverse"),
                          (ref, "ns_inverse_blocks_ref"),
                          (ref, "ns_tiled_residual_ref"),
                          (ref, "ns_tiled_update_ref"))]
    p = _pipeline_path(torch, "pipe-train-path", TRAIN_PIPE_NS, FAST_TIMED,
                       patches, inverse_method="newton_schulz")
    check(not plain, f"the plain Newton-Schulz iteration ran: {plain}")
    want = {"ns_inverse_blocks": sum(1 for b, _ in calls
                                     if ns.route(b) == "resident")}
    tiled = [int(t.max()) for b, t in calls if ns.route(b) == "tiled"]
    want["ns_tiled_residual"] = sum(n + 1 for n in tiled)
    want["ns_tiled_update"] = sum(tiled)
    got = {k: p["launches"][k] for k in want}
    check(got == want and all(want.values()),
          f"pipeline NS launches {got} != reckoned {want}")
    _say_pipeline(torch, "pipe-train-path", p, ns_path["cap_s"],
                  statistics.median(ns_path["fast_s"]),
                  (ns_db["peak"], ns_db["base"]), "double-buffered NS path")


def train_path_pipeline_eigh(torch, train) -> None:
    """The refresh pipeline at full width with eigh Stage 4 (the CLI's
    default): ``_pipeline_path`` over TRAIN_PIPE_EIGH's 6 loop steps (no
    torch.linalg.eigh on a capture step). Prints the walls beside the
    inline eigh path's capture step and fast-step median, the surcharge,
    the raw store and the peak memory beside the inline eigh path's."""
    p = _pipeline_path(torch, "pipe-eigh-train-path", TRAIN_PIPE_EIGH, 0)
    _say_pipeline(torch, "pipe-eigh-train-path", p, train["cap_s"],
                  train["fast_median"], (train["peak"], train["base"]),
                  "inline eigh path")


def sgd_path(torch, train) -> None:
    """Momentum SGD (repro_torch.optim.SGD) on a fresh full-width
    llama3_2_1b from the training path's seed, batch 4 x seq 1024: one
    warm-up and SGD_TIMED timed steps at the fast steps' learning rate and
    momentum. Prints the median wall, tokens/s and the eigh fast step's
    median over SGD's (the paper's claim: the fast step runs near SGD's
    cost), then profiles one SGD step by the same groups as profile_train.
    Checks: every loss finite, the first equal to the training path's,
    the attention kernels launched as reckoned, nothing else, no ref
    dispatch."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch, kfac, swa_attention
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.optim import SGD
    from repro_torch.optim.schedules import polynomial_decay
    model = DecoderLM(get_config("llama3_2_1b"), device="cuda").init(
        torch.Generator().manual_seed(0))
    params = model.params()
    opt = SGD(model.loss)
    state = opt.init(params)
    lr = polynomial_decay(TRAIN["lr"], 0, TRAIN["steps"], 4.0)(
        TRAIN["steps"] - 1)
    mom = 0.9 * lr / TRAIN["lr"]
    swa_attention.reset_launches()
    kfac.reset_launches()
    dispatch.reset_calls()
    recs = []
    for i in range(1 + SGD_TIMED):
        batch = _train_batch(torch, model.cfg.vocab, TRAIN["batch"],
                             TRAIN["seq"], index=i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = opt.step(params, state, batch, lr, mom)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        recs.append((loss, time.perf_counter() - t))
    kinds = ["sgd"] * len(recs)
    launches = {**swa_attention.LAUNCHES, **kfac.LAUNCHES}
    calls = dict(dispatch.CALLS)
    check(all(math.isfinite(x) for x, _ in recs),
          f"SGD losses {[x for x, _ in recs]}")
    d_loss = abs(recs[0][0] - train["first_loss"])
    check(d_loss <= 1e-6 * abs(train["first_loss"]),
          f"SGD first loss {recs[0][0]} != the training path's "
          f"{train['first_loss']}")
    want = {k: v for k, v in _train_counts(model.cfg, kinds).items()
            if k.startswith("swa_")}
    want.update(factor_syrk=0, block_precond=0)
    got = {k: launches[k] for k in want}
    check(got == want, f"SGD launches {got} != reckoned {want}")
    check(not any(b == "ref" for (_, b) in calls), f"ref dispatches: {calls}")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    walls = [w for _, w in recs[1:]]
    med = statistics.median(walls)
    say("sgd-path", f"momentum SGD, llama3_2_1b full width, batch "
                    f"{TRAIN['batch']} x seq {TRAIN['seq']}: losses "
                    f"{[round(x, 6) for x, _ in recs]}; step wall "
                    f"{[round(w, 3) for w in walls]} s after a {recs[0][1]:.3f}"
                    f" s warm-up, median {med:.3f} s ({tokens / med:.1f} "
                    f"tokens/s); eigh fast step median "
                    f"{train['fast_median']:.3f} s = {train['fast_median'] / med:.3f}"
                    f" x SGD's median; {card_note(torch)}")
    say("sgd-path", f"launches {got} (reckoned {want}); dispatches {calls}")
    batch = _train_batch(torch, model.cfg.vocab, TRAIN["batch"], TRAIN["seq"])
    box = {"state": state}

    def sgd_step():
        _, box["state"], _ = opt.step(params, box["state"], batch, lr, 0.0)
    _profile(torch, "one SGD step (4096 tokens)", sgd_step)
    del model, opt, params, state, box
    torch.cuda.empty_cache()


# the observability path: repro_torch.launch.train's CLI at full width with
# the metrics stream, the overhead probe and a one-step trace, at
# train_path's lr and damping
OBS_DIR = ROOT / "build" / "obs"
OBS_STEPS_CLI = 8
OBS_ARGS = ["--full-config", "--batch", str(TRAIN["batch"]), "--seq",
            str(TRAIN["seq"]), "--steps", str(OBS_STEPS_CLI),
            "--inverse-method", "newton_schulz", "--lr", str(TRAIN["lr"]),
            "--damping", str(TRAIN["damping"]),
            "--metrics-jsonl", str(OBS_DIR / "experiments" /
                                   "metrics_torch.jsonl"),
            "--profile-dir", str(OBS_DIR / "trace"), "--profile-steps", "1"]
# ranges the one-step trace (a capture step) must hold
OBS_TRACE_NAMES = ("spngd.stage2.capture", "spngd.stage4.inverse",
                   "spngd.stage4.precond", "repro.kernels.factor_sum[cuda]")


def obs_path(torch) -> None:
    """``train.main(OBS_ARGS)``: the stream's schema (``v``, ``type``,
    ``t_wall`` on every event; one run_config, one probe, a step per step,
    one summary), finite losses, the comm drains summing to the summary,
    the trace's stage and kernel ranges; then ``experiments/make_report.py``
    (loaded by path, stdlib only) prints its overhead decomposition from
    the stream. First, the ranges open under ``emit_nvtx`` (as NVTX
    ranges) and not while nothing records."""
    import importlib.util
    import io
    import math
    import shutil
    from repro_torch.launch import train
    from repro_torch.obs import tracing
    with torch.autograd.profiler.emit_nvtx():
        nvtx = [tracing.kernel_scope("factor_sum", "cuda"),
                tracing.stage_scope(tracing.STAGE_PRECOND)]
    check(all(isinstance(r, torch.profiler.record_function) for r in nvtx)
          and not isinstance(tracing.kernel_scope("factor_sum", "cuda"),
                             torch.profiler.record_function),
          f"ranges under emit_nvtx: {nvtx}")
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    (OBS_DIR / "experiments").mkdir(parents=True)
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        _, _, recs = train.main(OBS_ARGS)
    wall = time.perf_counter() - t
    for line in out.getvalue().splitlines():
        say("obs-path", line)
    torch.cuda.empty_cache()
    evts = [json.loads(line) for line in
            (OBS_DIR / "experiments" / "metrics_torch.jsonl").read_text()
            .splitlines()]
    check(all({"v", "type", "t_wall"} <= set(e) for e in evts),
          "every event carries v, type and t_wall")
    kinds = {}
    for e in evts:
        kinds[e["type"]] = kinds.get(e["type"], 0) + 1
    check(all(kinds.get(k) == n for k, n in (
        ("run_config", 1), ("probe", 1), ("step", OBS_STEPS_CLI),
        ("summary", 1))), f"event counts {kinds}")
    steps = [e for e in evts if e["type"] == "step"]
    check(all(math.isfinite(e["loss"]) for e in steps),
          f"stream losses {[e['loss'] for e in steps]}")
    check([e["loss"] for e in steps] == [r["loss"] for r in recs],
          "stream losses are run's records'")
    summary = next(e for e in evts if e["type"] == "summary")
    totals: dict = {}
    for e in steps:
        for k, v in e["comm"].items():
            totals[k] = totals.get(k, 0) + v
    check(totals and all(summary[k] == v for k, v in totals.items()),
          f"comm drains {totals} against the summary {summary}")
    trace = (OBS_DIR / "trace" / "trace.json").read_text()
    missing = [n for n in OBS_TRACE_NAMES if f'"{n}"' not in trace]
    precond = [n for n in ("repro.kernels.block_precond_left[cuda]",
                           "repro.kernels.block_precond_right[cuda]")
               if f'"{n}"' in trace]
    check(not missing and precond, f"ranges missing from the trace: "
                                   f"{missing}, block_precond {precond}")
    probe = next(e for e in evts if e["type"] == "probe")
    say("obs-path", f"{OBS_STEPS_CLI} steps, kinds "
                    f"{[e['kind'] for e in steps]}, losses "
                    f"{[round(e['loss'], 6) for e in steps]}; {kinds}; probe "
                    + ", ".join(f"{k} {v:.0f}" for k, v in probe.items()
                                if k.endswith("_us"))
                    + f" us; trace {len(trace)} B with every stage and "
                      f"kernel range asked for; main() {wall:.1f} s; "
                      f"{card_note(torch)}")
    spec = importlib.util.spec_from_file_location(
        "make_report", ROOT / "experiments" / "make_report.py")
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    out = io.StringIO()
    with contextlib.chdir(OBS_DIR), contextlib.redirect_stdout(out):
        report.overhead_section()
    check("| forward/backward |" in out.getvalue(),
          "make_report printed no decomposition table")
    for line in out.getvalue().splitlines():
        if line.strip():
            say("obs-report", line)
    say("obs-report", "random init: nearly every step captures, so r above "
                      "is not a trained run's refresh frequency")


# ---------------------------------------------------------------------------
# the ConvNet path: the paper's own model and training scheme
# (repro_torch.launch.train_convnet)
# ---------------------------------------------------------------------------

# the route check: a 2-stage ConvNet, one block per stage, f32, batch 16 at
# 16 x 16, two capture steps and a fast step; damping 1e-2, where the
# factors' damped inverses are well conditioned, so that what the check
# holds is the kernels' summation order and not its amplification by an
# ill-conditioned inverse (tests/test_torch_convnet_train_parity.py
# measured that amplification at 2.5e-4 on the CPU)
CONV_ROUTE = dict(widths=(8, 16), blocks_per_stage=1)
CONV_ROUTE_BATCH = dict(batch=16, size=16)
CONV_ROUTE_DAMPING = 1e-2
# the ConvNet path: resnet50 at full width, batch 1024 of 32 x 32 images
# (1,048,576 pixel positions a step), the example's lr and damping
CONV_PATH = dict(steps=8, batch=1024, image_size=32, lr=0.05,
                 damping=2.5e-4)
CONV_FAST_TIMED = 3
CONV_KERNELS = ("factor_syrk", "block_precond", "ns_inverse_blocks")


def _conv_batches(torch, batch: int, size: int, n: int) -> list:
    """The first n batches of train_convnet.run's stream on the card:
    image_batches (seed 0), random erasing, running mixup."""
    import numpy as np
    from repro_torch.data.augment import RunningMixup, random_erase
    from repro_torch.data.synthetic import image_batches
    data = image_batches(10, batch, size=size, seed=0, device="cuda")
    mixup = RunningMixup(0.4, 10, seed=0)
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        raw = next(data)
        x, y = mixup(random_erase(rng, raw["images"]), raw["labels"])
        out.append({"images": x, "labels": y})
    return out


def _conv_launches(torch) -> dict:
    from repro_torch.kernels import kfac, newton_schulz
    return {**kfac.LAUNCHES, **newton_schulz.LAUNCHES}


def _conv_reset(torch) -> None:
    from repro_torch.kernels import dispatch, kfac, newton_schulz
    kfac.reset_launches()
    newton_schulz.reset_launches()
    dispatch.reset_calls()


def check_convnet_route(torch) -> None:
    """The ConvNet (CONV_ROUTE, f32) on the kernels against
    backend="ref", for eigh and Newton-Schulz, each with the unit-wise and
    the full BatchNorm Fisher: two capture steps (every statistic flagged)
    and a fast step on the scheme's batches; before each step the ref
    optimizer starts from the kernel run's params and state. Per step the
    losses, the updated params and every preconditioner (the conv and head
    factors' inverses, the uw statistics or the uwf inverse) agree within
    ROUTE_REL_TOL of each array's largest entry. The kernel runs launched
    factor_syrk and block_precond, and ns_inverse_blocks under
    Newton-Schulz (the ref runs launch none)."""
    from repro_torch.core.fisher import flatten
    from repro_torch.launch import train_convnet
    from repro_torch.models.resnet import ConvNetConfig
    cfg = ConvNetConfig(**CONV_ROUTE)
    batches = _conv_batches(torch, CONV_ROUTE_BATCH["batch"],
                            CONV_ROUTE_BATCH["size"], 3)
    lam, lr, mom = CONV_ROUTE_DAMPING, CONV_PATH["lr"], 0.9

    def snap(params, state):
        out = {f"params/{k}": v.detach().clone()
               for k, v in flatten(params).items()}
        out.update({f"precond/{fam}.{k}": v.clone()
                    for fam, c in state["curv"].items()
                    for k, v in c["precond"].items()})
        return out

    for method in ("eigh", "newton_schulz"):
        for bn in ("unit", "full"):
            runs = {b: train_convnet.build(cfg=cfg, bn_fisher=bn, backend=b,
                                           damping=lam, inverse_method=method,
                                           device="cuda")
                    for b in ("auto", "ref")}
            _, kopt, kp, ks = runs["auto"]
            _, ropt, rp, _ = runs["ref"]
            flags = {n: True for n in kopt.stat_names()}
            _conv_reset(torch)
            rows = []
            for i, b in enumerate(batches):
                with torch.no_grad():
                    rflat = flatten(rp)
                    for n, v in flatten(kp).items():
                        rflat[n].copy_(v)
                rs = {**ks, "velocity": {n: v.clone() for n, v in
                                         ks["velocity"].items()}}
                if i < 2:
                    _, rs, rm = ropt.step(rp, rs, b, flags, lam, lr, mom)
                    kp, ks, km = kopt.step(kp, ks, b, flags, lam, lr, mom)
                else:
                    _, rs, rm = ropt.step_fast(rp, rs, b, lam, lr, mom)
                    kp, ks, km = kopt.step_fast(kp, ks, b, lam, lr, mom)
                got, want = snap(kp, ks), snap(rp, rs)
                by = {}
                for n, v in want.items():
                    part = n.split("/", 1)[0]
                    by[part] = max(by.get(part, 0.0),
                                   _rel_err(torch, got[n], v))
                rows.append((float(km["loss"]), float(rm["loss"]), by))
                del got, want, rs
            launches = dict(_conv_launches(torch))
            from repro_torch.kernels import dispatch
            calls = dict(dispatch.CALLS)
            label = f"{method}, bn_fisher {bn}"
            for i, (lk, lr_, by) in enumerate(rows):
                check(abs(lk - lr_) <= ROUTE_REL_TOL * abs(lr_),
                      f"convnet route {label} step {i + 1}: loss {lk} vs "
                      f"{lr_}")
                for part, err in by.items():
                    check(err <= ROUTE_REL_TOL,
                          f"convnet route {label} step {i + 1}: {part} rel "
                          f"err {err}")
            want_k = ["factor_syrk", "block_precond"]
            if method == "newton_schulz":
                want_k.append("ns_inverse_blocks")
            for k in want_k:
                check(launches[k] > 0, f"convnet route {label}: {k} never "
                                       f"launched ({launches})")
            check(launches["ns_tiled_residual"] == 0,
                  "convnet route: every block is <= 576, no tiled NS")
            say("convnet-route",
                f"ConvNet widths {cfg.widths} x {cfg.blocks_per_stage} "
                f"block, f32, batch {CONV_ROUTE_BATCH['batch']} at "
                f"{CONV_ROUTE_BATCH['size']}^2, damping {lam}, {label}: 2 "
                f"capture steps + 1 fast step, kernels vs backend='ref' from "
                f"the kernel run's state: losses "
                f"{[round(r[0], 6) for r in rows]} vs "
                f"{[round(r[1], 6) for r in rows]}; worst max|err|/max by "
                f"step " + "; ".join(
                    f"{i + 1}: " + ", ".join(f"{p} {e:.2e}"
                                             for p, e in r[2].items())
                    for i, r in enumerate(rows))
                + f" (tol {ROUTE_REL_TOL}); kernel launches "
                + str({k: launches[k] for k in CONV_KERNELS})
                + f"; dispatches {calls}")
            del runs, kopt, kp, ks, ropt, rp
    torch.cuda.empty_cache()


def _conv_counts(model, kinds) -> dict:
    """Launches reckoned from the code: every conv and dense site has a
    blocked A and G (one block each at kfac_max_dim 2048), so a capture step
    sums 2 factors per site and every SP-NGD step preconditions 2 sides per
    site; eigh runs no Newton-Schulz kernel."""
    sites = sum(1 for i in model.site_infos().values()
                if i.kind in ("conv", "dense"))
    return {"factor_syrk": 2 * sites * kinds.count("capture"),
            "block_precond": 2 * sites * len(kinds),
            "ns_inverse_blocks": 0}


def convnet_path(torch) -> dict:
    """The paper's training scheme on ``resnet50`` at full width (widths
    16/32/64, 2 blocks per stage, 10 classes, f32) through
    ``launch.train_convnet``: CONV_PATH's 8 steps as the controller decides
    them (random erasing, running mixup, polynomial decay, coupled
    momentum, weight rescaling), then 1 + CONV_FAST_TIMED fast steps and as
    many momentum-SGD steps (a fresh SGD state on the same weights) on the
    scheme's first batch, the im2col copies timed, a capture, a fast and an
    SGD step profiled (the first two by SP-NGD stage), and one capture
    step with ``bn_fisher="full"`` on a fresh model. Prints the walls, the
    stage split, the fast step over SGD, peak memory, the launches per
    kernel and the f32 body each factor sum took. Checks: every loss
    finite, the launches as reckoned, every factor sum counted by its
    route, no ref dispatch. Returns the capture and timed fast walls, the
    peak and the factor_syrk launches by (n, b)."""
    import math
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import kfac as kfac_kern
    from repro_torch.launch import train_convnet
    from repro_torch.optim import SGD
    spec = CONV_PATH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model, opt, params, state = train_convnet.build(
        "resnet50", damping=spec["damping"], device="cuda")
    cfg = model.cfg
    say("convnet-path", f"resnet50: widths {cfg.widths} x "
                        f"{cfg.blocks_per_stage} blocks, {cfg.n_classes} "
                        f"classes, f32, "
                        f"{sum(p.numel() for p in model.parameters())} "
                        f"params, {len(opt.stat_names())} statistics; init "
                        f"{time.perf_counter() - t:.1f} s")
    _conv_reset(torch)
    params, state, recs = train_convnet.run(
        model, opt, params, state, log=lambda m: say("convnet-path", m),
        **spec)
    kinds = [r["kind"] for r in recs]
    batch = _conv_batches(torch, spec["batch"], spec["image_size"], 1)[0]
    lr = recs[-1]["lr"]
    mom = 0.9 * lr / spec["lr"]
    fast_s, fast_losses = [], []
    for i in range(1 + CONV_FAST_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = opt.step_fast(params, state, batch,
                                         spec["damping"], lr, mom)
        fast_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        fast_s.append(time.perf_counter() - t)
        kinds.append("fast")
    launches = dict(_conv_launches(torch))
    routes = dict(kfac_kern.F32_ROUTES)
    calls = dict(dispatch.CALLS)
    peak = torch.cuda.max_memory_allocated() - base
    losses = [r["loss"] for r in recs] + fast_losses
    check(all(math.isfinite(x) for x in losses), f"convnet losses {losses}")
    want = _conv_counts(model, kinds)
    got = {k: launches[k] for k in want}
    check(got == want, f"convnet launches {got} != reckoned {want}")
    check(not any(b == "ref" for (_, b) in calls), f"ref dispatches: {calls}")
    px = spec["batch"] * spec["image_size"] ** 2
    cap = [r["seconds"] for r in recs if r["kind"] == "capture"]
    loop_fast = [r["seconds"] for r in recs if r["kind"] == "fast"]
    fast_med = statistics.median(fast_s[1:])
    say("convnet-path", f"{len(recs)} loop steps, batch {spec['batch']} x "
                        f"{spec['image_size']}^2 ({px} pixel positions a "
                        f"step): kinds {[r['kind'] for r in recs]}, refreshed "
                        f"{[len(r['refreshed']) for r in recs]} of "
                        f"{recs[0]['n_stats']}, losses "
                        f"{[round(r['loss'], 6) for r in recs]}, "
                        f"accuracy probe {recs[0]['acc']:.3f} at step 1")
    say("convnet-path", f"capture step wall {[round(x, 4) for x in cap]} s "
                        f"(median {statistics.median(cap):.4f} s, "
                        f"{spec['batch'] / statistics.median(cap):.1f} "
                        f"images/s), loop fast steps "
                        f"{[round(x, 4) for x in loop_fast]} s; fast step "
                        f"(opt.step_fast on the scheme's first batch) "
                        f"{[round(x, 4) for x in fast_s[1:]]} s after a "
                        f"{fast_s[0]:.4f} s warm-up, median {fast_med:.4f} s "
                        f"({spec['batch'] / fast_med:.1f} images/s), losses "
                        f"{[round(x, 6) for x in fast_losses]}; peak memory "
                        f"{peak / 2 ** 30:.2f} GiB above the "
                        f"{base / 2 ** 30:.2f} GiB already allocated "
                        f"(torch.cuda.max_memory_allocated); "
                        f"{card_note(torch)}")
    say("convnet-path", f"launches {got} (reckoned {want}); dispatches "
                        f"{calls}")
    # the f32 body each factor sum took: from F32_SPLIT_ROWS rows on the
    # narrow (b <= 64) or the wide route, below it the one-accumulator tile
    # (the kernels' names in the capture step's profile below show the same)
    n_cap = kinds.count("capture")
    by_route = {}
    for (route, _, _), c in routes.items():
        by_route[route] = by_route.get(route, 0) + c
    check(sum(by_route.values()) == launches["factor_syrk"],
          f"convnet f32 routes {by_route} against {launches['factor_syrk']} "
          f"factor_syrk launches")
    say("convnet-path", f"factor_syrk by route over {n_cap} capture steps: "
                        f"{by_route}, a capture step "
                        f"{ {k: v // max(n_cap, 1) for k, v in by_route.items()} }"
                        f" of {launches['factor_syrk'] // max(n_cap, 1)}; by "
                        f"(route, n, b) a capture step "
                        f"{ {k: v // max(n_cap, 1) for k, v in sorted(routes.items())} }")
    # the im2col layout copies: stage 0's 3x3 patches (four of the path's
    # sixteen conv sites take this shape) and the stem's
    from repro_torch.core import tagging
    gen = torch.Generator(device="cuda").manual_seed(26)
    for c, k in ((cfg.widths[0], 3), (cfg.in_channels, 3)):
        x = torch.randn((spec["batch"], spec["image_size"],
                         spec["image_size"], c), generator=gen,
                        device="cuda")
        out_bytes = x.numel() * k * k * 4
        bound, _ = _bound(0, x.numel() * 4 + out_bytes, torch.float32)
        ms = _time_ms(torch, lambda: tagging.conv_patches(x, k, k))
        say("convnet-path", f"im2col of a {tuple(x.shape)} input, {k}x{k} "
                            f"SAME (F.pad, the window view, the copy to rows): ms "
                            f"{ms:.6f}, bound_ms {bound:.6f} (bytes: x "
                            f"read once, {out_bytes / 1e6:.1f} MB of "
                            f"patches written once); {card_note(torch)}")
        del x

    sgd = SGD(model.loss)
    sstate = sgd.init(params)
    sgd_s = []
    for i in range(1 + CONV_FAST_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, sstate, m = sgd.step(params, sstate, batch, lr, mom)
        check(math.isfinite(float(m["loss"])), "convnet SGD loss")
        torch.cuda.synchronize()
        sgd_s.append(time.perf_counter() - t)
    sgd_med = statistics.median(sgd_s[1:])
    say("convnet-path", f"momentum SGD on the same batch and weights: "
                        f"{[round(x, 4) for x in sgd_s[1:]]} s after a "
                        f"{sgd_s[0]:.4f} s warm-up, median {sgd_med:.4f} s "
                        f"({spec['batch'] / sgd_med:.1f} images/s); SP-NGD "
                        f"fast step median {fast_med:.4f} s = "
                        f"{fast_med / sgd_med:.3f} x SGD's; capture step "
                        f"median {statistics.median(cap) / sgd_med:.3f} x "
                        f"SGD's; {card_note(torch)}")
    flags = {k: True for k in opt.stat_names()}
    lam = spec["damping"]
    box = {"state": state}

    def capture_step():
        _, box["state"], _ = opt.step(params, box["state"], batch, flags,
                                      lam, lr, 0.0)

    def fast_step():
        _, box["state"], _ = opt.step_fast(params, box["state"], batch, lam,
                                           lr, 0.0)

    def sgd_step():
        _, box["sgd"], _ = sgd.step(params, box.get("sgd", sstate), batch,
                                    lr, 0.0)
    _profile(torch, f"resnet50 capture step, batch {spec['batch']} x "
                    f"{spec['image_size']}^2, every statistic refreshed",
             capture_step, split=True)
    _profile(torch, f"resnet50 fast step, batch {spec['batch']} x "
                    f"{spec['image_size']}^2", fast_step, split=True)
    _profile(torch, f"resnet50 momentum-SGD step, batch {spec['batch']} x "
                    f"{spec['image_size']}^2", sgd_step)
    del model, opt, params, state, sgd, sstate, box
    torch.cuda.empty_cache()

    # one capture step of the full BN Fisher baseline on a fresh model
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, opt, params, state = train_convnet.build(
        "resnet50", bn_fisher="full", damping=spec["damping"], device="cuda")
    _conv_reset(torch)
    params, state, frecs = train_convnet.run(
        model, opt, params, state, log=lambda m: None,
        **{**spec, "steps": 1})
    fl = frecs[0]
    check(fl["kind"] == "capture" and math.isfinite(fl["loss"]),
          f"convnet full-BN step {fl}")
    peak_full = torch.cuda.max_memory_allocated() - base
    flaunch = {k: _conv_launches(torch)[k] for k in CONV_KERNELS}
    check(flaunch == _conv_counts(model, ["capture"]),
          f"convnet full-BN launches {flaunch}")
    uwf = {f: tuple(s["uwf"].shape) for f, s in model.fstats().items()
           if "uwf" in s}
    say("convnet-path", f"bn_fisher full: one capture step (step 1 of the "
                        f"scheme, a cold first call) wall "
                        f"{fl['seconds']:.4f} s, loss {fl['loss']:.6f}, "
                        f"{len(uwf)} uwf statistics of "
                        f"{sorted(set(uwf.values()))}, peak memory "
                        f"{peak_full / 2 ** 30:.2f} GiB; launches {flaunch}; "
                        f"{card_note(torch)}")
    box = {"state": state}

    def full_capture():
        _, box["state"], _ = opt.step(params, box["state"], batch,
                                      {k: True for k in opt.stat_names()},
                                      lam, lr, 0.0)
    _profile(torch, "resnet50 bn_fisher full capture step", full_capture,
             split=True)
    del model, opt, params, state, box, batch
    torch.cuda.empty_cache()
    return {"cap_s": cap, "fast_s": fast_s[1:], "peak": peak,
            "f32_launches": {(n, b): c for (_, n, b), c in routes.items()}}


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
                       m.dtype, PEAK_SPLIT_F32_OPS_PER_S)
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
                 f"{res['ns_inverse_blocks']['ms'] / iters:.4f} ms a trip, "
                 f"the bound at the f32 CUDA cores' rate "
                 f"{_bound(4 * b ** 3 * g * iters, 0, m.dtype)[0]:.6f} "
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
    bound, by = _bound(2 * b ** 3 * g, nbytes + 4 * g, m.dtype,
                       PEAK_SPLIT_F32_OPS_PER_S)
    res["ns_tiled_residual"] = {
        "ms": _time_ms(torch, lambda: ns.ns_tiled_residual(m, x)),
        "plain_ms": _time_ms(torch, lambda: ref.ns_tiled_residual_ref(m, x),
                             reps=5),
        "library_ms": _time_ms(torch, lambda: torch.baddbmm(eye, m, x,
                                                            alpha=-1.0)),
        "bound_ms": bound, "bound_by": by}
    bound, by = _bound(2 * b ** 3 * g, nbytes, m.dtype,
                       PEAK_SPLIT_F32_OPS_PER_S)
    res["ns_tiled_update"] = {
        "ms": _time_ms(torch, lambda: ns.ns_tiled_update(x, r)),
        "plain_ms": _time_ms(torch, lambda: ref.ns_tiled_update_ref(x, r),
                             reps=5),
        "library_ms": _time_ms(torch, lambda: torch.baddbmm(x, x, r)),
        "bound_ms": bound, "bound_by": by}
    say("times", f"the tiled pair's bound at the f32 CUDA cores' rate "
                 f"{_bound(2 * b ** 3 * g, 0, m.dtype)[0]:.6f} ms a launch")
    shares = "; ".join(
        f"{k} {v['bound_ms'] / v['ms']:.1%} of the bound, "
        f"{v['library_ms'] / v['ms']:.3f}x faster than baddbmm"
        for k, v in res.items() if k.startswith("ns_tiled"))
    say("times", f"ns_tiled_residual ({g}, {b}, {b}) f32: "
                 f"{res['ns_tiled_residual']}; ns_tiled_update: "
                 f"{res['ns_tiled_update']} (library: torch.baddbmm f32, TF32 "
                 f"off); {shares}; {card_note(torch)}")
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


def _wire_case(torch, worst: dict, key: str, label: str, x, max_dim: int,
               fmt: str, mode: str, route: str) -> None:
    """factor_sum_wire on x (..., n, d), its leading axes in the one call:
    ``route`` "fused" through the kernel with a scratch of its own (the
    kernel's f32 sums), "dispatch" through the op's b > 1024 route
    (factor_syrk, sym_pack, quant_rows; its sums factor_syrk's). Payload and
    scales bit-identical to quant_rows' plain version on those sums, the
    sums within WIRE_SCALE_REL_TOL of the plain ones, and against the plain
    composition the payload within one fp8 step and the decode within the
    format's bound; worst[key] takes the largest decode error."""
    from repro_torch.core import kfac
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import quant as qk
    nb = kfac.num_blocks(x.shape[-1], max_dim)
    b = kfac.block_size(x.shape[-1], max_dim)
    if route == "fused":
        own = torch.empty((*x.shape[:-2], nb, b, b), dtype=torch.float32,
                          device="cuda")
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
    worst[key] = max(worst.get(key, 0.0), err)
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


def check_fp8_kernels(torch) -> dict:
    """quant_rows and dequant_rows against their plain versions, bit for
    bit: the history rows of the path (64 x 2,098,176 at b 2048, 32 x
    131,328 at b 512), a ragged b 1000 (t 500,500), zero rows, e5m2, pow2
    scales, a clipped outlier, rows off 16-byte alignment (the element
    path), the wire route's 1 and 4 rows of 2,098,176 and a row longer
    than the resident route takes (the long-row route); quant_rows
    launched twice, the two bit-identical. factor_syrk_wire at n 4096, b
    512 / 1000 / 1024, bf16 and f32:
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
    grid = qk.resident_grid(torch.device("cuda"))
    cases = [(64, 2098176, "e4m3", "fp32", (), 0),
             (32, 131328, "e4m3", "fp32", (), 0),
             (4, 500500, "e4m3", "fp32", (1,), 0),
             (16, 131328, "e5m2", "fp32", (3,), 0),
             (16, 131328, "e4m3", "pow2", (0,), 0),
             (4, 500500, "e5m2", "pow2", (), 0),
             (3, 561, "e4m3", "fp32", (2,), 1),
             (1, 2098176, "e4m3", "fp32", (), 0),
             (4, 2098176, "e5m2", "pow2", (2,), 0),
             (5, 100003, "e4m3", "fp32", (4,), 1),
             (2, 2600000, "e4m3", "fp32", (), 0)]
    check(cases[-1][1] > grid * qk.QUANT_SLICE_MAX,
          f"the last case must take the long-row route on {grid} blocks")
    for g, t, fmt, mode, zero, off in cases:
        slice_ = qk.quant_slice(g, t, grid)
        route = (f"resident route, items of {slice_}" if slice_ else
                 "long-row route")
        check(bool(slice_) != (t > grid * qk.QUANT_SLICE_MAX),
              f"quant_rows ({g}, {t}): {route} on {grid} blocks")
        x = _fp8_rows(torch, gen, g, t, zero, off)
        if g == 3:
            x[0, 5] = 1e30                # clipped, never NaN
        p, sc = qk.quant_rows(x, fmt, mode)
        p2, sc2 = qk.quant_rows(x, fmt, mode)
        d = qk.dequant_rows(p, sc)
        torch.cuda.synchronize()
        check(torch.equal(p.view(torch.uint8), p2.view(torch.uint8))
              and torch.equal(sc, sc2), f"quant_rows ({g}, {t}): two "
                                        f"launches on the same rows differ")
        del p2, sc2
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
                          f"{', 16-byte misaligned' if off else ''}, {route}:"
                          f" payload, scales and decode bit-identical to the "
                          f"plain versions; a second quant_rows launch "
                          f"identical")
        del x, p, sc, d, rp, rs, rd
    # payloads that are views off 4-byte alignment (words read as bytes),
    # on rows whose starts are off 16-byte alignment too
    for g, t, fmt, poff in ((3, 561, "e5m2", 1), (4, 2098176, "e4m3", 3)):
        x = _fp8_rows(torch, gen, g, t)
        p, sc = ref.quant_rows_ref(x, fmt, "fp32")
        buf = torch.empty((g * t + poff,), dtype=torch.uint8, device="cuda")
        pv = buf[poff:].view(g, t)
        pv.copy_(p.view(torch.uint8))
        pv = pv.view(p.dtype)
        d, rd = qk.dequant_rows(pv, sc), ref.dequant_rows_ref(pv, sc)
        torch.cuda.synchronize()
        check(torch.equal(d, rd), f"dequant_rows ({g}, {t}) {fmt}, payload "
                                  f"{poff} bytes off: differs from the plain "
                                  f"version")
        worst["dequant_rows"] = max(worst["dequant_rows"],
                                    _max_err(torch, d, rd))
        say("fp8-kernel", f"dequant_rows ({g}, {t}) {fmt}, the payload a view "
                          f"{poff} byte(s) off 4-byte alignment: bit-identical "
                          f"to the plain version")
        del x, p, sc, buf, pv, d, rd
    attrs = qk.dequant_attrs(torch.device("cuda"))
    say("fp8-kernel", "dequant_rows instances (fmt, payload words aligned or "
                      "read as bytes): registers, local bytes a thread (ptxas "
                      "stack frame, spills included; cudaFuncGetAttributes) "
                      + ", ".join(f"{n} {r}/{b} B" for n, (r, b) in
                                  attrs.items()))
    torch.cuda.empty_cache()

    for b in (512, 1000, 1024):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((4096, b), generator=gen, device="cuda").to(dtype)
            _wire_case(torch, worst, "factor_syrk_wire",
                       f"n=4096 b={b} {dtype}", x, 2048, "e4m3", "fp32",
                       "fused")
    x = torch.randn((4000, 2050), generator=gen, device="cuda")
    _wire_case(torch, worst, "factor_syrk_wire",
               "n=4000 d=2050 max_dim=1024 (3 blocks of 684)", x, 1024,
               "e5m2", "fp32", "fused")
    x = torch.randn((4096, 512), generator=gen, device="cuda").bfloat16()
    _wire_case(torch, worst, "factor_syrk_wire", "n=4096 b=512 bf16", x,
               2048, "e4m3", "pow2", "fused")
    x = torch.randn((4096, 8192), generator=gen, device="cuda").bfloat16()
    _wire_case(torch, worst, "factor_syrk_wire",
               "n=4096 d=8192 bf16 (4 blocks of 2048)", x, 2048, "e4m3",
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
    else factor_syrk + quant_rows; the embedding's G, which the template
    keeps dense (as repro's), through factor_sum (factor_syrk). Each
    refreshed blocked statistic then decodes its wire sums (if wire), X_-1
    and X_-2 (dequant_rows) and encodes the new X_-1 (1 quant_rows); one
    that does not refresh, in a family that does, decodes X_-1 for the
    family's inverse (1 dequant_rows)."""
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
                wire = quant.is_wire(leaf)
                check(wire or fam == "embed",
                      f"{fam}.{key} is not wire-captured")
                if not wire:
                    n["factor_syrk"] += math.prod(leaf.shape[:-3])
                elif quant.tri_rows(leaf["payload"].shape[-1]) <= \
                        FACTOR_WIRE_MAX_DIM:
                    n["factor_syrk_wire"] += math.prod(
                        leaf["payload"].shape[:-2])
                else:
                    calls = math.prod(leaf["payload"].shape[:-2])
                    n["factor_syrk"] += calls
                    n["quant_rows"] += calls
                if f"{fam}.{key}" in done:
                    n["dequant_rows"] += 3 if wire else 2
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
    layers x 4 blocks of 2048), and on the b 512 family (16 x 131,328);
    quant_rows at the b > 1024 wire route's 1 and 4 rows of 2,098,176
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
    # the copy yardstick: the same bytes (1 B in, 4 B out), no scale
    copy_ms = _time_ms(torch, lambda: p.to(torch.float32))
    say("times", f"quant_rows ({g}, {t}) f32 -> e4m3: {res['quant_rows']}; "
                 f"dequant_rows: {res['dequant_rows']} (no single PyTorch "
                 f"call computes either; payload.to(torch.float32), the same "
                 f"bytes without the scale, ms {copy_ms:.6f}); "
                 f"{card_note(torch)}")
    del x, p, sc
    g, t = 16, 131328
    x = _fp8_rows(torch, gen, g, t)
    p, sc = qk.quant_rows(x, "e4m3")
    b_s, _ = _bound(0, g * t * 5 + 4 * g, x.dtype)
    q_s = _time_ms(torch, lambda: qk.quant_rows(x, "e4m3"))
    d_s = _time_ms(torch, lambda: qk.dequant_rows(p, sc))
    c_s = _time_ms(torch, lambda: p.to(torch.float32))
    say("times", f"quant_rows ({g}, {t}): ms {q_s:.6f}; dequant_rows ms "
                 f"{d_s:.6f}; bound_ms {b_s:.6f} (bytes); "
                 f"payload.to(torch.float32) ms {c_s:.6f}; {card_note(torch)}")
    del x, p, sc
    # the b > 1024 wire route's shapes: one block of 2048 (nb 1) and the
    # mlp down projection's four (d 8192)
    for g in (1, 4):
        x = _fp8_rows(torch, gen, g, 2098176)
        b_w, _ = _bound(0, x.numel() * 5 + 4 * g, x.dtype)
        q_w = _time_ms(torch, lambda: qk.quant_rows(x, "e4m3"))
        say("times", f"quant_rows ({g}, 2098176) f32 -> e4m3 (wire route): "
                     f"ms {q_w:.6f}; bound_ms {b_w:.6f} (bytes); "
                     f"{card_note(torch)}")
        del x
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
    (FACTOR_WIRE_MAX_DIM 1024); then factor_syrk in f32 at the ConvNet
    path's shapes (CONV_SYRK_TIMED) beside f32 torch.mm and the bound."""
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
    # the ConvNet path's f32 sums (the rows factor_syrk[conv ...]): the
    # narrow route (b <= 64) beside its bound by bytes (CUDA-core f32 rate),
    # the wide one (3xTF32 on the tensor cores) at the split-f32 rate; next
    # to cuBLAS's f32 x^T x (TF32 off: chip_smoke sets allow_tf32 = False)
    for n, d in CONV_SYRK_TIMED:
        x = torch.randn((n, d), generator=gen, device="cuda")
        route = kern.syrk_f32_route(n, d)
        bound, by = _bound(n * d * (d + 1), 4 * (n * d + d * d), f32,
                           PEAK_SPLIT_F32_OPS_PER_S if route == "wide"
                           else None)
        want = ref.factor_sum_ref(x, 2048)
        err = _max_err(torch, kern.factor_syrk(x, 2048), want)
        row = {"ms": _time_ms(torch, lambda: kern.factor_syrk(x, 2048)),
               "plain_ms": _time_ms(torch, lambda: ref.factor_sum_ref(
                   x, 2048)),
               "library_ms": _time_ms(torch, lambda: torch.mm(x.t(), x)),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        res[f"factor_syrk[conv {n}x{d}]"] = row
        say("times", f"factor_syrk ConvNet shape n={n} d={d} f32 -> f32 "
                     f"(1 block, {route} route): {row} (library: "
                     f"torch.mm(x.t(), x), cuBLAS f32; bound at "
                     f"{'the split-f32 rate' if route == 'wide' else 'the f32 CUDA cores rate'}"
                     f"); ms/bound {row['ms'] / bound:.2f}, ms/library "
                     f"{row['ms'] / row['library_ms']:.2f}; {card_note(torch)}")
        del x, want
    torch.cuda.empty_cache()
    return res


def time_conv_precond(torch) -> None:
    """block_precond at the ConvNet path's shapes (CONV_PRECOND_TIMED), one
    launch each, beside its plain version, cuBLAS's f32 product (TF32 off)
    and the bound at the split-f32 rate (its products are 3xTF32)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import kfac as kern
    gen = torch.Generator(device="cuda").manual_seed(27)
    for mode, b, other in CONV_PRECOND_TIMED:
        right = mode == "right"
        binv = torch.randn((1, b, b), generator=gen, device="cuda") / b ** 0.5
        w = torch.randn((other, b) if right else (b, other), generator=gen,
                        device="cuda")
        plain = dispatch.lookup(f"block_precond_{mode}", "ref")
        bound, by = _bound(2 * b * b * other, 4 * (b * b + 2 * b * other),
                           torch.float32, PEAK_SPLIT_F32_OPS_PER_S)
        row = {"ms": _time_ms(torch, lambda: kern.block_precond(
                   binv, w, right=right)),
               "plain_ms": _time_ms(torch, lambda: plain(w, binv) if right
                                    else plain(binv, w)),
               "library_ms": _time_ms(torch, lambda: torch.mm(w, binv[0])
                                      if right else torch.mm(binv[0], w)),
               "bound_ms": bound, "bound_by": by}
        say("times", f"block_precond ConvNet shape {mode} binv (1, {b}, {b}) "
                     f"w {tuple(w.shape)} f32: {row} (library: torch.mm, "
                     f"cuBLAS f32); {card_note(torch)}")
        del binv, w


# block_precond's ConvNet calls timed: the widest A (stage 2's w2, 576)
# and G (64) sides, stage 0's A (144), the stem's A (27), the head's G (10)
CONV_PRECOND_TIMED = (("left", 576, 64), ("right", 64, 576),
                      ("left", 144, 16), ("left", 27, 16), ("right", 10, 64))


# the ConvNet path's f32 factor sums timed beside torch.mm: the stem's A,
# stage 0's A (the largest patch matrix, 604 MB), stage 1's and stage 2's
# widest A, and a G over the most positions
CONV_SYRK_TIMED = ((1048576, 27), (1048576, 144), (262144, 288),
                   (65536, 576), (1048576, 16))


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
    plain version on its inputs upcast to f32, and launched twice: the
    tensor-core walk gives the same bits on the same inputs."""
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
        if dt == bf16:
            check(torch.equal(out, swa_attention.swa_flash(q, k, v,
                                                           window=window)),
                  f"swa_flash BH={bh} S={s} hd={hd} window={window} bf16: "
                  f"two launches on the same inputs differ")
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
                      f"version {worst_f32_ref:.3e} (tol {SWA_BF16_TOL}); "
                      f"every bf16 case launched twice, identical")
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



# ---------------------------------------------------------------------------
# multi-GPU Stage 3 and Stage 4 (repro_torch.comm) under NCCL, world size 1
# ---------------------------------------------------------------------------

# the ring's hop rows at llama3_2_1b's b 2048 (t = 2,098,176 packed) over
# p 4: a chunk of 4 layers of a one-block statistic, of four-block ones
RING_HOP_SHAPES = ((4, 2098176), (16, 2098176))
# the modelled ledger's group: 4 ranks, 2 hosts of 2 for hier
LEDGER_P, LEDGER_DPH = 4, 2
# dist_path's fast steps after its capture: a warm-up of each builder, then
# the dist and the single-device step alternated on the same state
DIST_FAST_ORDER = ("dist", "single", "dist", "single", "single", "dist")
# the MoE config of the dist phases (check_dist_route at its route size,
# dist_path at full width)
DIST_MOE = "qwen2_moe_a2_7b"


@contextlib.contextmanager
def _nccl_world_one(torch):
    """A world of one NCCL rank on card 0 over a ``file://`` store in a
    temporary directory, its (1, 1) ``DeviceMesh``; torn down after."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    tmp = tempfile.mkdtemp(prefix="nccl_store_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_test_mesh(1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _dist_route_run(torch, build, batches, mesh, comm, lam, lr):
    """A capture step and a fast step from the model ``build()`` returns
    ((model, opt, params, state), seed 0), every flag set, damping ``lam``:
    through the dist steps over ``mesh`` under ``comm``, or the
    single-device steps without a mesh. Returns (losses, copies of every
    param and state leaf by path)."""
    from repro_torch.launch import train
    model, opt, params, state = build()
    if mesh is None:
        step, fast = (train.make_train_step(model, opt),
                      train.make_fast_step(model, opt))
    else:
        step = train.make_dist_train_step(model, opt, mesh, comm=comm)
        fast = train.make_dist_fast_step(model, opt, mesh, comm=comm)
    flags = {k: True for k in opt.stat_names()}
    params, state, m = step(params, state, batches[0], flags, lam, lr, 0.9)
    losses = [float(m["loss"])]
    params, state, m = fast(params, state, batches[1], lam, lr, 0.9)
    losses.append(float(m["loss"]))
    snap = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in _run_leaves(model, state).items()}
    del model, opt, params, state, m, step, fast
    torch.cuda.empty_cache()
    return losses, snap


def _dist_routes(torch) -> list:
    """check_dist_route's cases: (label, build(**kw) -> (model, opt,
    params, state), batches, damping, lr, [(strategy, build kw of both
    arms, build kw of the dist arm only)]). The LM route config and
    reduced qwen2_moe_a2_7b at its route size (MOE_ROUTES; Stage 4 by
    Newton-Schulz, one launch a family where eigh would take its ~2,000
    blocks of 128 one by one) under every strategy (fused on the e4m3
    capture, inverse_sharding against the double buffer); the ConvNet route (CONV_ROUTE, f32, the scheme's
    optimizer) with the unit-wise and the full BN Fisher, and reduced
    rwkv6_7b, under dense and ring_fp8."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train, train_convnet
    from repro_torch.models.resnet import ConvNetConfig
    every = [(s, {}, {}) for s in ("dense", "ring", "ring_fp8", "hier")] + [
        ("fused", dict(factor_wire="e4m3"), {}),
        ("dense", dict(double_buffer=True), dict(inverse_sharding=True))]
    two = [("dense", {}, {}), ("ring_fp8", {}, {})]
    lam, lr = TRAIN["damping"], TRAIN["lr"]

    def lm(cfg, **fixed):
        return lambda **kw: train.build(cfg=cfg, device="cuda", **fixed,
                                        **kw)
    cfg = _route_cfg(torch)
    cases = [("llama3_2_1b", lm(cfg),
              [_train_batch(torch, cfg.vocab, 2, 512, index=i)
               for i in range(2)], lam, lr, every)]
    conv_batches = _conv_batches(torch, CONV_ROUTE_BATCH["batch"],
                                 CONV_ROUTE_BATCH["size"], 2)
    for bn in ("unit", "full"):
        ccfg = ConvNetConfig(**CONV_ROUTE, bn_fisher=bn)
        cases.append((f"convnet {bn}", lambda ccfg=ccfg: train_convnet.build(
            cfg=ccfg, damping=CONV_ROUTE_DAMPING, device="cuda"),
            conv_batches, CONV_ROUTE_DAMPING, CONV_PATH["lr"], two))
    mcfg = get_config(DIST_MOE).reduced(**MOE_ROUTES[DIST_MOE])
    cases.append((DIST_MOE, lm(mcfg, inverse_method="newton_schulz"),
                  [_dense_batch(torch, mcfg, 2, 512, index=i)
                   for i in range(2)], lam, lr, every))
    rcfg = get_config("rwkv6_7b").reduced()
    cases.append(("rwkv6_7b", lm(rcfg),
                  [_dense_batch(torch, rcfg, *RECURRENT_ROUTE_BATCH, index=i)
                   for i in range(2)], lam, lr, two))
    return cases


def check_dist_route(torch) -> None:
    """[dist-route] The dist steps (make_dist_train_step /
    make_dist_fast_step) under NCCL at world size 1 (_dist_routes): for
    the LM route config and the MoE route every Stage-3 strategy, for the
    ConvNet route (uw and uwf) and reduced rwkv6_7b dense and ring_fp8,
    one capture and one fast step bit for bit equal to make_train_step /
    make_fast_step (fused against the e4m3 wire capture, inverse_sharding
    against the double buffer); no ref dispatch; fused launches
    ring_hop_unpack[cuda], and on the MoE route factor_syrk_wire over the
    expert axis; a CPU tensor under the NCCL group raises."""
    from repro_torch import comm as comm_lib
    from repro_torch.kernels import dispatch
    t = time.perf_counter()
    with _nccl_world_one(torch) as mesh:
        say("dist-route", f"NCCL group of one rank up in "
                          f"{time.perf_counter() - t:.1f} s")
        red = comm_lib.FactorReducer(mesh)
        try:
            red.psum(torch.ones(2))
        except ValueError:
            pass
        else:
            raise AssertionError("a CPU tensor under NCCL did not raise")
        for name, build, batches, lam, lr, runs in _dist_routes(torch):
            want = {}
            for strategy, ref_kw, dist_kw in runs:
                key = tuple(sorted(ref_kw.items()))
                if key not in want:
                    t = time.perf_counter()
                    want[key] = _dist_route_run(
                        torch, lambda: build(**ref_kw), batches, None, None,
                        lam, lr) + (time.perf_counter() - t,)
                want_loss, want_leaves, ref_s = want[key]
                dispatch.reset_calls()
                t = time.perf_counter()
                with _wire_launches() as wired:
                    got_loss, got = _dist_route_run(
                        torch, lambda: build(**ref_kw, **dist_kw), batches,
                        mesh, comm_lib.make_comm_config(strategy), lam, lr)
                dist_s = time.perf_counter() - t
                calls = dict(dispatch.CALLS)
                differ = sorted(k for k in want_leaves
                                if _leaf_gap(torch, want_leaves[k],
                                             got[k]) != 0)
                label = f"{name} {strategy}" + "".join(
                    f" {k}" for k in {**ref_kw, **dist_kw})
                check(got_loss == want_loss and not differ,
                      f"dist-route {label}: losses {got_loss} vs "
                      f"{want_loss}; {len(differ)} leaves differ "
                      f"{differ[:6]}")
                check(not any(b == "ref" for (_, b) in calls),
                      f"dist-route {label}: ref dispatches {calls}")
                expert = sorted({ld for k, ld in wired
                                 if k == "factor_syrk_wire" and len(ld) == 1})
                if strategy == "fused":
                    check(calls.get(("ring_hop_unpack", "cuda"), 0) > 0,
                          f"fused took no ring_hop_unpack[cuda]: {calls}")
                    if name == DIST_MOE:
                        e = MOE_ROUTES[DIST_MOE]["n_experts"]
                        check(expert == [(e,)],
                              f"dist-route {label}: factor_syrk_wire over "
                              f"the expert axis {expert}, want [({e},)]")
                say("dist-route", f"{label}: capture + fast step bit for bit "
                                  f"equal to the single-device steps ("
                                  f"{len(want_leaves)} param and state "
                                  f"leaves, losses {got_loss}); "
                                  f"{dist_s:.1f} s (single-device "
                                  f"{ref_s:.1f} s); ring_hop dispatches "
                                  f"{ {k: v for k, v in calls.items() if k[0].startswith('ring_hop')} }"
                                  + (f"; factor_syrk_wire leads {expert}"
                                     if expert else ""))
                del got
            del want
            torch.cuda.empty_cache()


def check_ring_hop(torch) -> None:
    """[ring-hop] The hop codec's cuda route (quant_rows / dequant_rows over
    the rows) against ref at llama3_2_1b's hop shapes, payload and scales
    bit for bit, then timed beside ref."""
    from repro_torch.kernels import dispatch
    gen = torch.Generator(device="cuda").manual_seed(0)
    for g, t in RING_HOP_SHAPES:
        x = torch.randn((g, t), generator=gen, device="cuda")
        x *= torch.logspace(-3, 3, g, device="cuda")[:, None]
        x[-1] = 0.0                                 # a zero row: scale 1
        dispatch.reset_calls()
        pc, sc = dispatch.ring_hop_pack(x, backend="cuda")
        pr, sr = dispatch.ring_hop_pack(x, backend="ref")
        check(torch.equal(pc.view(torch.uint8), pr.view(torch.uint8))
              and torch.equal(sc, sr),
              f"ring_hop_pack ({g}, {t}): cuda != ref")
        uc = dispatch.ring_hop_unpack(pc, sc, backend="cuda")
        check(torch.equal(uc, dispatch.ring_hop_unpack(pr, sr,
                                                       backend="ref")),
              f"ring_hop_unpack ({g}, {t}): cuda != ref")
        check(dispatch.CALLS.get(("ring_hop_pack", "cuda")) == 1,
              f"dispatches {dispatch.CALLS}")
        ms = {name: _time_ms(torch, fn, reps=10, warmup=2) for name, fn in (
            ("pack", lambda: dispatch.ring_hop_pack(x, backend="cuda")),
            ("pack ref", lambda: dispatch.ring_hop_pack(x, backend="ref")),
            ("unpack", lambda: dispatch.ring_hop_unpack(pc, sc,
                                                        backend="cuda")),
            ("unpack ref", lambda: dispatch.ring_hop_unpack(
                pc, sc, backend="ref")))}
        bound = _bound(0, g * t * 5 + g * 4, torch.float32)[0]
        say("ring-hop", f"({g}, {t}) e4m3: payload and scales bit for bit, "
                        f"unpack bit for bit; ms {ms} (bound of each "
                        f"{bound:.6f} ms, bytes); {card_note(torch)}")
        del x, pc, sc, pr, sr, uc
    torch.cuda.empty_cache()


def _modelled_ledger(torch, opt) -> None:
    """The Stage-3 wire bytes per refresh of the full-width template at
    LEDGER_P ranks, each strategy, from the port's ledger: every statistic
    scattering (SPNGD.wire_bytes) and with a one-axis reducer's fallbacks
    (leading dim not divisible by LEDGER_P), beside the Stage-4 gather and
    the assembly's dense f32 all-gather (not in repro's ledger)."""
    import math
    from repro_torch import comm as comm_lib
    from repro_torch.comm.comm import _leaf_shape
    template = opt.fstats_fn()
    shapes = {f"{fam}.{k}": _leaf_shape(leaf)
              for fam, stats in template.items() for k, leaf in stats.items()}

    def scat(n):
        return shapes[n][0] % LEDGER_P == 0

    for s in comm_lib.STRATEGIES:
        c = comm_lib.make_comm_config(s, devices_per_host=LEDGER_DPH)
        every = sum(opt.wire_bytes(c, group_size=LEDGER_P).values())
        real = comm_lib.template_wire_bytes(template, opt.sym_stat, c,
                                            scattered_fn=scat,
                                            group_size=LEDGER_P)
        lv = comm_lib.template_wire_level_bytes(
            template, opt.sym_stat, c, scattered_fn=scat,
            group_size=LEDGER_P)
        say("dist-path", f"modelled Stage-3 wire per refresh, llama3_2_1b, "
                         f"p {LEDGER_P}, {s}/{c.wire_dtype}"
                         + (f" (D {LEDGER_DPH})" if s == "hier" else "")
                         + f": {every} B all scattering; {sum(real.values())}"
                         f" B with the fallbacks (intra {sum(a for a, _ in lv.values())}"
                         f", inter {sum(b for _, b in lv.values())})")
    gather = comm_lib.template_gather_bytes(template, opt.sym_stat, scat)
    assemble = sum(math.prod(v) * 4 for n, v in shapes.items() if scat(n))
    say("dist-path", f"modelled per refresh at p {LEDGER_P}: Stage-4 gather "
                     f"{sum(opt.gather_bytes().values())} B all scattering, "
                     f"{sum(gather.values())} B with the fallbacks; "
                     f"assemble (dense f32 all-gather, not in the ledger) "
                     f"{assemble} B; {sum(map(scat, shapes))} of "
                     f"{len(shapes)} statistics scatter")


def dist_path(torch, train_walls, conv_walls, wire_walls) -> None:
    """[dist-path] Full-width llama3_2_1b at TRAIN through the dist steps
    under NCCL at world size 1, dense and ring_fp8, each on a fresh seed-0
    model: one capture step of launch.train.run(mesh=...), then
    make_dist_fast_step alternated with make_fast_step on the same state
    (DIST_FAST_ORDER, a warm-up of each first); walls beside train_path's,
    the grads' all_reduce alone, peak memory, the kernels launched, no ref
    dispatch; at world size 1 no hop runs, so the two strategies' losses
    are the same bits. First the modelled Stage-3 ledger at p 4. Then the
    families (_dist_families): resnet50 and qwen2_moe_a2_7b."""
    import math

    from repro_torch import comm as comm_lib
    from repro_torch.core.fisher import flatten, value_and_grad
    from repro_torch.kernels import dispatch, kfac
    from repro_torch.launch import train
    from repro_torch.optim.schedules import polynomial_decay
    spec, losses = TRAIN, {}
    with _nccl_world_one(torch) as mesh:
        for strategy in ("dense", "ring_fp8"):
            model, opt, params, state = train.build(
                "llama3_2_1b", full_config=True, device="cuda")
            if strategy == "dense":
                _modelled_ledger(torch, opt)
            comm = comm_lib.make_comm_config(strategy)
            kfac.reset_launches()
            dispatch.reset_calls()
            torch.cuda.reset_peak_memory_stats()
            params, state, recs = train.run(
                model, opt, params, state, steps=1, batch=spec["batch"],
                seq=spec["seq"], lr=spec["lr"], damping=spec["damping"],
                comm=comm, mesh=mesh,
                log=lambda m: say("dist-path", f"{strategy}: {m}"))
            check(recs[0]["kind"] == "capture", f"step kinds {recs}")
            fast = train.make_dist_fast_step(model, opt, mesh, comm=comm)
            steps = {"dist": fast, "single": train.make_fast_step(model, opt)}
            walls = {k: [] for k in steps}
            run_losses = [recs[0]["loss"]]
            # train_path's fast steps' lr and momentum (its loop's last),
            # which keep six fast steps after a capture finite
            lr = polynomial_decay(spec["lr"], 0, spec["steps"], 4.0)(
                spec["steps"] - 1)
            # a warm-up of each, then the two alternated on the same state
            for i, kind in enumerate(DIST_FAST_ORDER):
                batch = _train_batch(torch, model.cfg.vocab, spec["batch"],
                                     spec["seq"], index=1 + i)
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, state, m = steps[kind](params, state, batch,
                                               spec["damping"], lr,
                                               0.9 * lr / spec["lr"])
                run_losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                walls[kind].append(time.perf_counter() - t)
            peak = torch.cuda.max_memory_allocated()
            launches, calls = dict(kfac.LAUNCHES), dict(dispatch.CALLS)
            check(all(math.isfinite(x) for x in run_losses),
                  f"losses {run_losses}")
            check(launches["factor_syrk"] > 0 and launches["block_precond"]
                  > 0, f"kernel launches {launches}")
            check(not any(b == "ref" for (_, b) in calls),
                  f"ref dispatches: {calls}")
            losses[strategy] = run_losses
            loss, _, grads = value_and_grad(opt.loss_fn, params, batch)
            n = sum(g.numel() * g.element_size()
                    for g in flatten(grads).values())
            ar = _time_ms(torch, lambda: train.all_reduce_grads(
                fast.reducer, loss, grads, 1), reps=5, warmup=1)
            say("dist-path", f"{strategy}: capture step {recs[0]['seconds']:.3f}"
                             f" s (train_path's {[round(x, 3) for x in train_walls['cap_s']]}"
                             f" s); fast steps in the order {DIST_FAST_ORDER}, "
                             f"dist {[round(x, 3) for x in walls['dist']]} s, "
                             f"single-device {[round(x, 3) for x in walls['single']]}"
                             f" s, each's first a warm-up (train_path's "
                             f"median {train_walls['fast_median']:.3f} s); "
                             f"losses {[round(x, 6) for x in run_losses]}; the "
                             f"grads' all_reduce ({n} B, one bucket per "
                             f"dtype: concatenate, NCCL all_reduce, divide) "
                             f"{ar:.3f} ms; peak memory {peak / 2 ** 30:.2f} "
                             f"GiB (train_path's over 4 captures "
                             f"{train_walls['peak'] / 2 ** 30:.2f}); launches "
                             f"{launches}; {card_note(torch)}")
            del model, opt, params, state, fast, steps, loss, grads, m
            torch.cuda.empty_cache()
        check(losses["ring_fp8"] == losses["dense"],
              f"world size 1: ring_fp8 losses {losses['ring_fp8']} != dense "
              f"{losses['dense']}")
        _dist_families(torch, mesh, conv_walls, wire_walls)


# dist_path's families: resnet50 at CONV_PATH's batch (1024 x 32^2) under
# dense and ring_fp8, one capture step and 3 fast steps; qwen2_moe_a2_7b at
# full width, MOE_PATH's 2 layers and batch, under fused at kfac_max_dim
# 1024 with Stage 4 by Newton-Schulz (moe_wire_path's second run), one
# capture step and 2 fast steps
DIST_CONV_FAST = 3
DIST_MOE_PATH = dict(max_dim=1024, fast=2)


def _dist_walls(torch, model, opt, mesh, comm, batch, flags, lam, lr, mom,
                n_fast) -> tuple:
    """One dist capture step then ``n_fast`` dist fast steps on ``batch``:
    (walls, losses), synchronized host clock."""
    from repro_torch.launch import train
    step = train.make_dist_train_step(model, opt, mesh, comm=comm)
    fast = train.make_dist_fast_step(model, opt, mesh, comm=comm)
    params, state = model.params(), opt.init(model.params())
    walls, losses = [], []
    for i in range(1 + n_fast):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 0:
            params, state, m = step(params, state, batch, flags, lam, lr,
                                    mom)
        else:
            params, state, m = fast(params, state, batch, lam, lr, mom)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    del params, state, m
    return walls, losses


def _dist_families(torch, mesh, conv_walls, wire_walls) -> None:
    """The ConvNet and MoE families through the dist steps over ``mesh``
    (NCCL at world size 1; DIST_CONV_FAST, DIST_MOE_PATH): walls beside
    convnet_path's and moe_wire_path's, peaks, the kernels launched,
    finite losses, no ref dispatch; the fused MoE capture launches
    factor_syrk_wire over the expert axis."""
    import dataclasses
    import math

    from repro_torch import comm as comm_lib
    from repro_torch.kernels import dispatch, kfac
    from repro_torch.kernels import quant as qk
    from repro_torch.launch import train, train_convnet
    spec = CONV_PATH
    batch = _conv_batches(torch, spec["batch"], spec["image_size"], 1)[0]
    for strategy in ("dense", "ring_fp8"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, opt, _, _ = train_convnet.build(
            "resnet50", damping=spec["damping"], device="cuda")
        _conv_reset(torch)
        flags = {k: True for k in opt.stat_names()}
        walls, losses = _dist_walls(
            torch, model, opt, mesh, comm_lib.make_comm_config(strategy),
            batch, flags, spec["damping"], spec["lr"], 0.9,
            DIST_CONV_FAST)
        peak = torch.cuda.max_memory_allocated()
        launches, calls = dict(_conv_launches(torch)), dict(
            dispatch.CALLS)
        check(all(math.isfinite(x) for x in losses),
              f"dist-path resnet50 {strategy}: losses {losses}")
        check(launches["factor_syrk"] > 0
              and launches["block_precond"] > 0,
              f"dist-path resnet50 {strategy}: launches {launches}")
        check(not any(b == "ref" for (_, b) in calls),
              f"dist-path resnet50 {strategy}: ref dispatches {calls}")
        say("dist-path", f"resnet50 {strategy}, batch {spec['batch']} x "
                         f"{spec['image_size']}^2: capture step "
                         f"{walls[0]:.4f} s, fast steps "
                         f"{[round(x, 4) for x in walls[1:]]} s "
                         f"(convnet_path's capture "
                         f"{[round(x, 4) for x in conv_walls['cap_s']]}"
                         f" s, fast {[round(x, 4) for x in conv_walls['fast_s']]}"
                         f" s); losses {[round(x, 6) for x in losses]}; "
                         f"peak {peak / 2 ** 30:.2f} GiB; launches "
                         f"{ {k: v for k, v in launches.items() if v} }; "
                         f"{card_note(torch)}")
        del model, opt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mspec = MOE_PATH
    cfg = dataclasses.replace(_moe_cfg(), factor_wire="e4m3",
                              kfac_max_dim=DIST_MOE_PATH["max_dim"])
    model, opt, _, _ = train.build(cfg=cfg, device="cuda",
                                   inverse_method="newton_schulz",
                                   damping=mspec["damping"])
    kfac.reset_launches()
    qk.reset_launches()
    dispatch.reset_calls()
    mbatch = _train_batch(torch, cfg.vocab, mspec["batch"], mspec["seq"])
    with _wire_launches() as wired:
        walls, losses = _dist_walls(
            torch, model, opt, mesh, comm_lib.make_comm_config("fused"),
            mbatch, {k: True for k in opt.stat_names()},
            mspec["damping"], mspec["lr"], 0.9, DIST_MOE_PATH["fast"])
    peak = torch.cuda.max_memory_allocated()
    calls = dict(dispatch.CALLS)
    expert = sum(1 for k, ld in wired if k == "factor_syrk_wire"
                 and ld == (cfg.n_experts,))
    check(all(math.isfinite(x) for x in losses),
          f"dist-path {DIST_MOE} fused: losses {losses}")
    check(expert > 0 and calls.get(("ring_hop_unpack", "cuda"), 0) > 0,
          f"dist-path {DIST_MOE} fused: factor_syrk_wire over the "
          f"expert axis {expert}, dispatches {calls}")
    check(not any(b == "ref" for (_, b) in calls),
          f"dist-path {DIST_MOE} fused: ref dispatches {calls}")
    w = wire_walls[DIST_MOE_PATH["max_dim"]]
    say("dist-path", f"{DIST_MOE} full width, {cfg.n_layers} layers, "
                     f"fused e4m3 capture, kfac_max_dim {cfg.kfac_max_dim}, "
                     f"NS, batch {mspec['batch']} x {mspec['seq']}: "
                     f"capture step {walls[0]:.3f} s, fast steps "
                     f"{[round(x, 3) for x in walls[1:]]} s "
                     f"(moe_wire_path's capture at "
                     f"{DIST_MOE_PATH['max_dim']} "
                     f"{[round(x, 3) for x in w['walls']]} s, peak "
                     f"{w['peak'] / 2 ** 30:.2f} GiB); losses "
                     f"{[round(x, 6) for x in losses]}; peak "
                     f"{peak / 2 ** 30:.2f} GiB; factor_syrk_wire "
                     f"launches {qk.LAUNCHES['factor_syrk_wire']} "
                     f"({expert} over the {cfg.n_experts} experts), "
                     f"ring_hop_unpack[cuda] "
                     f"{calls.get(('ring_hop_unpack', 'cuda'), 0)}; "
                     f"{card_note(torch)}")
    del model, opt
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# factor blocks aligned to tensor-parallel shards (ArchConfig.tp_shards)
# ---------------------------------------------------------------------------

# the dry run's 16x16 mesh's "model" axis
TP_SHARDS = 16
# tp_path: TRAIN's batch, 2 capture steps (the loop at random init), then a
# warm-up and FAST_TIMED fast steps
TRAIN_TP = dict(TRAIN, steps=2)
# the aligned blocks at llama3_2_1b's widths, 2048 / 16 = 128 (attn_wq's G,
# attn_wo's A) and 8192 / 16 = 512 (mlp_up/gate's G, mlp_down's A): the
# factor sums of n 4096 tokens (n, d, block) and the preconditioning of
# attn_wq's dW from the right and mlp_down's from the left (side, dW, nb, b)
TP_SYRK_SHAPES = ((4096, 2048, 128), (4096, 8192, 512))
TP_PRECOND_SHAPES = (("right", (2048, 2048), 16, 128),
                     ("left", (8192, 2048), 16, 512))


def _block_widths(model) -> dict:
    """{b: blocks of width b per layer} over the block sites' full-kind
    factors."""
    out = {}
    for fam, info in model.site_infos().items():
        if not fam.startswith("blk/") or info.kind not in ("dense",
                                                           "grouped"):
            continue
        for kind, shape in ((info.spec.a_kind, info.spec.a_shape(info.d_in)),
                            (info.spec.g_kind,
                             info.spec.g_shape(info.d_out))):
            if kind == "full":
                out[shape[-1]] = out.get(shape[-1], 0) + shape[0]
    return dict(sorted(out.items()))


def check_tp_route(torch) -> None:
    """[tp-route] The route config (_route_cfg: full width, 2 layers, f32)
    at tp_shards=TP_SHARDS: the aligned sites' statistics at the shard's
    width, then one capture and one fast step through the kernels against
    backend="ref" from the same seed-0 model and batches: the losses, every
    param and the momentum within ROUTE_REL_TOL of the largest entry; the
    kernel run dispatches no ref op and launches factor_syrk and
    block_precond."""
    import dataclasses
    from repro_torch.kernels import dispatch, kfac
    from repro_torch.launch import train
    cfg = dataclasses.replace(_route_cfg(torch), tp_shards=TP_SHARDS)
    batches = [_train_batch(torch, cfg.vocab, 2, 512, index=i)
               for i in range(2)]
    runs, walls = {}, {}
    for backend in ("auto", "ref"):
        kfac.reset_launches()
        dispatch.reset_calls()
        t = time.perf_counter()
        runs[backend] = _dist_route_run(
            torch, lambda: train.build(cfg=cfg, backend=backend,
                                       device="cuda"),
            batches, None, None, TRAIN["damping"], TRAIN["lr"])
        walls[backend] = time.perf_counter() - t
        if backend == "auto":
            calls, launches = dict(dispatch.CALLS), dict(kfac.LAUNCHES)
    (kl, k), (rl, r) = runs["auto"], runs["ref"]
    want = {"state/curv/blk/attn_wq/prev/g": (2, 16, 128, 128),
            "state/curv/blk/attn_wo/prev/a": (2, 16, 128, 128),
            "state/curv/blk/mlp_up/prev/g": (2, 16, 512, 512),
            "state/curv/blk/mlp_down/prev/a": (2, 16, 512, 512),
            "state/curv/blk/attn_wk/prev/g": (2, 1, 512, 512)}
    got = {n: tuple(k[n].shape) for n in want}
    check(got == want, f"tp-route statistic shapes {got}, want {want}")
    check(all(abs(a - b) <= ROUTE_REL_TOL * abs(b) for a, b in zip(kl, rl)),
          f"tp-route losses {kl} vs {rl}")
    names = [n for n in r if n.startswith("params/")
             or n.startswith("state/velocity/")]
    worst = max(_rel_err(torch, k[n], r[n]) for n in names)
    check(worst <= ROUTE_REL_TOL, f"tp-route params/momentum rel err {worst}")
    check(not any(b == "ref" for (_, b) in calls),
          f"tp-route ref dispatches: {calls}")
    check(launches["factor_syrk"] > 0 and launches["block_precond"] > 0,
          f"tp-route launches {launches}")
    say("tp-route", f"llama3_2_1b width, 2 layers, f32, tp_shards "
                    f"{TP_SHARDS}, batch (2, 512): statistics {got}; one "
                    f"capture + one fast step kernels vs backend='ref': "
                    f"losses {kl} vs {rl}; worst max|err|/max over "
                    f"{len(names)} params and momenta {worst:.3e} (tol "
                    f"{ROUTE_REL_TOL}); launches {launches}; "
                    f"{walls['auto']:.1f} s (ref {walls['ref']:.1f} s)")
    del runs, k, r
    torch.cuda.empty_cache()


def tp_path(torch, train_walls) -> dict:
    """[tp-path] launch.train's loop on full-width llama3_2_1b (16 layers,
    bf16, remat, TRAIN's batch 4 x 1024) with tp_shards=TP_SHARDS under
    eigh: TRAIN_TP's 2 steps (both capture at random init), then a warm-up
    and FAST_TIMED fast steps; the capture, fast and Stage-4 seconds and
    the peak beside train_path's, and one fast step profiled (device busy
    time, split by stage) beside profile_train's; the blocks by width
    beside the unaligned model's; launches counted from 0 just before. Then a fresh model at
    the same alignment takes one capture step with Stage 4 by
    Newton-Schulz, its Stage-4 seconds beside train_path_ns's a refresh.
    Checks: the kinds, finite losses, no ref dispatch. Returns
    {"launches"} of the eigh run."""
    import dataclasses
    import math
    from repro_torch.kernels import dispatch, kfac, swa_attention
    from repro_torch.launch import train
    from repro_torch.models.transformer import DecoderLM
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, params, state = train.build(
        "llama3_2_1b", full_config=True, device="cuda", tp_shards=TP_SHARDS)
    plain = _block_widths(DecoderLM(dataclasses.replace(model.cfg,
                                                        tp_shards=0),
                                    device="meta"))
    widths = _block_widths(model)
    swa_attention.reset_launches()
    kfac.reset_launches()
    dispatch.reset_calls()
    with _Stage4Timer(torch) as s4:
        params, state, recs = train.run(model, opt, params, state,
                                        log=lambda m: say("tp-path", m),
                                        **TRAIN_TP)
    params, state = _fast_steps(torch, model, opt, params, state, recs,
                                TRAIN_TP, "tp-path")
    launches = {**swa_attention.LAUNCHES, **kfac.LAUNCHES}
    batch = _train_batch(torch, model.cfg.vocab, TRAIN["batch"], TRAIN["seq"])
    fast, box = train.make_fast_step(model, opt), {"state": state}

    def fast_step():
        _, box["state"], _ = fast(params, box["state"], batch,
                                  TRAIN["damping"], 1e-4, 0.0)
    busy = _profile(torch, f"one fast train step at tp_shards {TP_SHARDS}",
                    fast_step, split=True)
    calls = dict(dispatch.CALLS)
    peak = torch.cuda.max_memory_allocated()
    kinds = [r["kind"] for r in recs]
    check(kinds[:2] == ["capture"] * 2 and kinds.count("fast") == 1
          + FAST_TIMED, f"tp-path step kinds {kinds}")
    check(all(math.isfinite(r["loss"]) for r in recs),
          f"tp-path losses {[r['loss'] for r in recs]}")
    check(not any(b == "ref" for (_, b) in calls),
          f"tp-path ref dispatches: {calls}")
    cap = [r["seconds"] for r in recs if r["kind"] == "capture"]
    fast_s = [r["seconds"] for r in recs
              if r["kind"] == "fast" and not r.get("warm")]
    say("tp-path", f"llama3_2_1b full width, tp_shards {TP_SHARDS}: blocks "
                   f"per model by width {widths} (unaligned {plain}); losses "
                   f"{[round(r['loss'], 6) for r in recs]}; capture step "
                   f"{[round(x, 3) for x in cap]} s (train_path's "
                   f"{[round(x, 3) for x in train_walls['cap_s']]} s); "
                   f"Stage-4 eigh {s4.seconds:.3f} s over {s4.calls} calls "
                   f"({s4.blocks} blocks) in {len(cap)} refreshes "
                   f"(train_path's {train_walls['stage4_s']:.3f} s in "
                   f"{train_walls['refreshes']}); fast step "
                   f"{[round(x, 3) for x in fast_s]} s, median "
                   f"{statistics.median(fast_s):.3f} s (train_path's "
                   f"{train_walls['fast_median']:.3f} s), device busy "
                   f"{_us(busy)} profiled (train_path's "
                   f"{_us(train_walls['fast_busy_us'])}); peak "
                   f"{peak / 2 ** 30:.2f} GiB (train_path's "
                   f"{train_walls['peak'] / 2 ** 30:.2f}); launches "
                   f"{ {k: v for k, v in launches.items() if v} }; "
                   f"{card_note(torch)}")
    del model, opt, params, state, fast, box
    torch.cuda.empty_cache()
    model, opt, params, state = train.build(
        "llama3_2_1b", full_config=True, device="cuda", tp_shards=TP_SHARDS,
        inverse_method="newton_schulz")
    dispatch.reset_calls()
    with _Stage4Timer(torch) as s4:
        params, state, recs = train.run(model, opt, params, state,
                                        log=lambda m: say("tp-path", m),
                                        **dict(TRAIN_TP, steps=1))
    calls = dict(dispatch.CALLS)
    check(recs[0]["kind"] == "capture" and math.isfinite(recs[0]["loss"])
          and not any(b == "ref" for (_, b) in calls),
          f"tp-path NS capture {recs}, dispatches {calls}")
    say("tp-path", f"Newton-Schulz, tp_shards {TP_SHARDS}: one capture step "
                   f"{recs[0]['seconds']:.3f} s, Stage 4 {s4.seconds:.3f} s "
                   f"over {s4.calls} calls ({s4.blocks} blocks) "
                   f"(train_path_ns's {train_walls['ns_stage4']:.3f} s a "
                   f"refresh unaligned); {card_note(torch)}")
    del model, opt, params, state
    torch.cuda.empty_cache()
    return {"launches": launches}


def _us(us) -> str:
    """A profiled device time, or why there is none."""
    return f"{us:.0f} us" if us else "not measured (no device time traced)"


def time_tp_kernels(torch) -> dict:
    """factor_syrk and block_precond at the aligned blocks' shapes
    (TP_SYRK_SHAPES, TP_PRECOND_SHAPES): each called twice, one launch a
    call and the same bits both times, held to its plain version within
    KFAC_REL_TOL of the largest entry, then timed beside the plain
    version, the bound and the library call (cuBLAS bf16 x^T x with f32
    output over the blocks, torch.bmm out_dtype; torch.bmm f32 over the
    blocks, TF32 off). Returns
    the rows "factor_syrk[tp16]" and "block_precond[tp16]": each the sum
    over its two shapes (one launch each) of the times and bounds, the
    worst error."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(31)
    f32 = torch.float32
    rows = {"factor_syrk[tp16]": [], "block_precond[tp16]": []}
    for n, d, b in TP_SYRK_SHAPES:
        x = torch.randn((n, d), generator=gen, device="cuda").bfloat16()
        nb = d // b
        xb = x.view(n, nb, b).transpose(0, 1)
        ops, nbytes = _syrk_ops_bytes(n, nb, b, nb * b * b * 4)
        bound, by = _bound(ops, nbytes, x.dtype)
        got, same = _launched_once(torch, lambda: kern.factor_syrk(x, b),
                                   "factor_syrk")
        want = ref.factor_sum_ref(x, b)
        err = _rel_err(torch, got, want)
        check(same and got.shape == (nb, b, b) and err <= KFAC_REL_TOL,
              f"factor_syrk[tp16] ({n}, {d}) b {b}: same bits {same}, "
              f"shape {tuple(got.shape)}, max|err|/max {err}")
        row = {"ms": _time_ms(torch, lambda: kern.factor_syrk(x, b)),
               "plain_ms": _time_ms(torch, lambda: ref.factor_sum_ref(x, b)),
               "library_ms": _time_ms(torch, lambda: torch.bmm(
                   xb.transpose(1, 2), xb, out_dtype=f32)),
               "bound_ms": bound, "bound_by": by,
               "max_abs_err": _max_err(torch, got, want)}
        rows["factor_syrk[tp16]"].append(row)
        say("times", f"factor_syrk[tp16] n={n} d={d} nb={nb} b={b} bf16 -> "
                     f"f32: {row}, max|err|/max {err:.3e} (tol "
                     f"{KFAC_REL_TOL}; library: torch.bmm over the blocks, "
                     f"f32 output); {card_note(torch)}")
        del x, xb, got, want
    for side, shape, nb, b in TP_PRECOND_SHAPES:
        right = side == "right"
        binv = torch.randn((nb, b, b), generator=gen, device="cuda") / b ** 0.5
        w = torch.randn(shape, generator=gen, device="cuda")
        other = shape[0] if right else shape[1]
        plain = dispatch.lookup(f"block_precond_{side}", "ref")
        if right:
            wb = w.view(other, nb, b).transpose(0, 1)

            def lib():
                return torch.bmm(wb, binv)
        else:
            wb = w.view(nb, b, other)

            def lib():
                return torch.bmm(binv, wb)
        bound, by = _bound(2 * nb * b * b * other,
                           4 * (nb * b * b + 2 * nb * b * other), f32,
                           PEAK_SPLIT_F32_OPS_PER_S)
        got, same = _launched_once(
            torch, lambda: kern.block_precond(binv, w, right=right),
            "block_precond")
        want = plain(w, binv) if right else plain(binv, w)
        err = _rel_err(torch, got, want)
        check(same and got.shape == w.shape and err <= KFAC_REL_TOL,
              f"block_precond[tp16] {side} {shape} b {b}: same bits "
              f"{same}, max|err|/max {err}")
        row = {"ms": _time_ms(torch, lambda: kern.block_precond(
                   binv, w, right=right)),
               "plain_ms": _time_ms(torch, lambda: plain(w, binv) if right
                                    else plain(binv, w)),
               "library_ms": _time_ms(torch, lib),
               "bound_ms": bound, "bound_by": by,
               "max_abs_err": _max_err(torch, got, want)}
        rows["block_precond[tp16]"].append(row)
        say("times", f"block_precond[tp16] {side} binv ({nb}, {b}, {b}) w "
                     f"{shape} f32: {row}, max|err|/max {err:.3e} (tol "
                     f"{KFAC_REL_TOL}; library: torch.bmm over the blocks, "
                     f"TF32 off); {card_note(torch)}")
        del binv, w, wb, got, want
    torch.cuda.empty_cache()
    out = {}
    for name, rs in rows.items():
        out[name] = {k: sum(r[k] for r in rs) for k in
                     ("ms", "plain_ms", "library_ms", "bound_ms")}
        out[name]["bound_by"] = max(rs, key=lambda r: r["bound_ms"])[
            "bound_by"]
        out[name]["max_abs_err"] = max(r["max_abs_err"] for r in rs)
    return out


# ---------------------------------------------------------------------------
# the dense architecture family: the attention kernels at head dim 192,
# each new config on the kernels against backend="ref", and llava_next_34b
# at full width
# ---------------------------------------------------------------------------

# nemotron_4_340b's attention widths (src/repro/configs/nemotron_4_340b.py):
# 96 query heads over 8 KV heads (G 12), hd 192; batch 1 x S 4096, causal
HD192 = dict(heads=96, kv=8, hd=192, seq=4096)
# f32 attention gradients on the CUDA cores against the f32 plain version,
# relative to the largest gradient entry (f32 sums in another order)
BWD_F32_REL_TOL = 2e-4


def _sdpa_ms(torch, fn):
    """SDPA's time, or None with the reason where it refuses the shapes."""
    try:
        fn()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, f"SDPA raised: {str(e).splitlines()[0][:120]}"
    return _time_ms(torch, fn, reps=10, warmup=2), "SDPA"


def _bwd_ref_by_kv(torch, ref, q, k, v, o, lse, do, window=0):
    """The plain backward one KV head at a time (a whole (8, 12, 4096,
    4096) score tensor in f32 would hold 6.4 GB several times over)."""
    outs = [ref.swa_attention_bwd_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                      o[i:i + 1], lse[i:i + 1], do[i:i + 1],
                                      window=window)
            for i in range(q.shape[0])]
    return tuple(torch.cat([x[j] for x in outs]) for j in range(3))


def _fwd_ref_by_kv(torch, ref, q, k, v, window=0):
    outs = [ref.swa_attention_fwd_res_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                          window=window)
            for i in range(q.shape[0])]
    return torch.cat([x[0] for x in outs]), torch.cat([x[1] for x in outs])


def _twice(torch, name, fn, label):
    """fn's result, after a second call on the same inputs gave the same
    bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    flat = (lambda x: x if isinstance(x, tuple) else (x,))
    check(all(torch.equal(x, y) for x, y in zip(flat(a), flat(b))),
          f"{name} {label}: two launches on the same inputs differ")
    return a


def _rnd(torch, gen, dt, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(dt)


def _attn_fwd_bwd(torch, gen, errs, phase, bkv, g, s, hd, window, dt,
                  by_kv=False):
    """swa_flash_fwd, then swa_flash_bwd from the plain forward's
    residuals, against their plain versions: the forward at FWD_TOL (bf16;
    lse at LSE_TOL) or SWA_F32_TOL (f32), the gradients at BWD_REL_TOL
    (bf16) or BWD_F32_REL_TOL (f32); bf16 calls twice, bit-identical.
    errs takes each kernel's largest error."""
    from repro_torch.kernels import ref, swa_attention
    bf16 = torch.bfloat16
    label = f"BKV={bkv} G={g} S={s} hd={hd} window={window} {dt}"
    q = _rnd(torch, gen, dt, bkv, g, s, hd)
    k, v = _rnd(torch, gen, dt, bkv, s, hd), _rnd(torch, gen, dt, bkv, s, hd)
    fn = (lambda: swa_attention.swa_flash_fwd(q, k, v, window=window))
    out, lse = _twice(torch, "swa_flash_fwd", fn, label) if dt == bf16 \
        else fn()
    torch.cuda.synchronize()
    ro, rl = (_fwd_ref_by_kv(torch, ref, q, k, v, window) if by_kv else
              ref.swa_attention_fwd_res_ref(q, k, v, window=window))
    tol = FWD_TOL if dt == bf16 else SWA_F32_TOL
    torch.testing.assert_close(out.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rl, **(LSE_TOL if dt == bf16
                                           else SWA_F32_TOL))
    err = _max_err(torch, out, ro)
    errs["swa_flash_fwd"] = max(errs["swa_flash_fwd"], err)
    do = _rnd(torch, gen, dt, bkv, g, s, hd)
    fn = (lambda: swa_attention.swa_flash_bwd(q, k, v, ro, rl, do,
                                              window=window))
    got = _twice(torch, "swa_flash_bwd", fn, label) if dt == bf16 else fn()
    torch.cuda.synchronize()
    want = (_bwd_ref_by_kv(torch, ref, q, k, v, ro, rl, do, window)
            if by_kv else ref.swa_attention_bwd_ref(q, k, v, ro, rl, do,
                                                    window=window))
    rel = [_rel_err(torch, a, b) for a, b in zip(got, want)]
    btol = BWD_REL_TOL if dt == bf16 else BWD_F32_REL_TOL
    check(max(rel) <= btol, f"attention bwd {label}: rel errs {rel} > "
                            f"{btol}")
    errs["swa_flash_bwd_dq"] = max(errs["swa_flash_bwd_dq"],
                                   _max_err(torch, got[0], want[0]))
    errs["swa_flash_bwd_dkdv"] = max(errs["swa_flash_bwd_dkdv"],
                                     _max_err(torch, got[1], want[1]),
                                     _max_err(torch, got[2], want[2]))
    say(phase, f"swa_flash_fwd {label}: max|out err| {err:.3e} (tol "
               f"{tol}), max|lse err| {_max_err(torch, lse, rl):.3e}; "
               f"bwd max|err|/max|grad| dq {rel[0]:.3e} dk {rel[1]:.3e} "
               f"dv {rel[2]:.3e} (tol {btol})"
               + ("; bf16 calls twice, identical" if dt == bf16 else ""))
    del q, k, v, out, lse, ro, rl, do, got, want


def _attn_flash(torch, gen, errs, phase, bh, s, hd, window, dt,
                per_head=False):
    """swa_flash against its plain version (8 heads a call when
    ``per_head``), at FWD_TOL (bf16, twice, bit-identical) or SWA_F32_TOL."""
    from repro_torch.kernels import ref, swa_attention
    bf16 = torch.bfloat16
    label = f"BH={bh} S={s} hd={hd} window={window} {dt}"
    q = _rnd(torch, gen, dt, bh, s, hd)
    k, v = _rnd(torch, gen, dt, bh, s, hd), _rnd(torch, gen, dt, bh, s, hd)
    fn = (lambda: swa_attention.swa_flash(q, k, v, window=window))
    out = _twice(torch, "swa_flash", fn, label) if dt == bf16 else fn()
    torch.cuda.synchronize()
    tol = FWD_TOL if dt == bf16 else SWA_F32_TOL
    err = 0.0
    step = 8 if per_head else bh
    for i in range(0, bh, step):
        want = ref.swa_attention_ref(q[i:i + step], k[i:i + step],
                                     v[i:i + step], window=window)
        torch.testing.assert_close(out[i:i + step].float(), want.float(),
                                   **tol)
        err = max(err, _max_err(torch, out[i:i + step], want))
    errs["swa_flash"] = max(errs["swa_flash"], err)
    say(phase, f"swa_flash {label}: max|err| {err:.3e} (tol {tol})")


def _attn_decode(torch, gen, errs, phase, n, g, hd, kind, window, cap,
                 rounds=3):
    """swa_flash_decode against its plain version at DEC_TOL over ``rounds``
    rounds of n positions on both sides of its split boundaries (and one
    lap on for the ring), 0 and C - 1; every call twice, bit-identical."""
    from repro_torch.kernels import ref, swa_attention
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, per = swa_attention.decode_splits(n, cap, hd, sms)
    edges = [0, cap - 1] + [e for b in range(per, cap, per)
                            for e in (b - 1, b)]
    if window:
        edges += [cap + e for e in edges]
    order = torch.randperm(len(edges), generator=gen, device="cuda")
    picks = [edges[0], edges[1]] + [edges[i] for i in order.tolist()
                                    if i > 1][:rounds * n - 2]
    q, kc, vc, ks, vs = _decode_case(torch, gen, n, g, hd, cap, kind)
    err = 0.0
    for r in range(0, len(picks), n):
        chunk = (picks[r:r + n] + [cap - 1] * n)[:n]
        pos = torch.tensor(chunk, dtype=torch.int32, device="cuda")
        fn = (lambda: swa_attention.swa_flash_decode(
            q, kc, vc, pos, window=window, k_scale=ks, v_scale=vs))
        got = _twice(torch, "swa_flash_decode", fn, f"{kind} C={cap}")
        want = ref.swa_decode_ref(q, kc, vc, pos, window=window,
                                  k_scale=ks, v_scale=vs)
        torch.testing.assert_close(got, want, **DEC_TOL)
        err = max(err, _max_err(torch, got, want))
    errs["swa_flash_decode"] = max(errs["swa_flash_decode"], err)
    say(phase, f"swa_flash_decode N={n} G={g} hd={hd} "
               f"{'ring' if window else 'dense'} {kind} C={cap}, {splits} "
               f"splits of {per} slots, {len(picks)} positions on split "
               f"boundaries, 0 and C - 1: max|err| {err:.3e} (tol "
               f"{DEC_TOL}); every call twice, identical")
    del q, kc, vc, ks, vs


def _attn_times(torch, gen, phase, kv, g, s, hd, kernels) -> dict:
    """The bf16 forwards and backward pair at (BKV kv, G g, S s, hd),
    causal, timed beside their bound (at this hd), their plain version and
    SDPA: swa_flash_fwd, swa_flash_bwd_dq, swa_flash_bwd_dkdv and swa_flash
    (on the KV repeated to every head), those of ``kernels``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref, swa_attention
    bf16 = torch.bfloat16
    times = {}
    q, k, v, do, o, lse, delta = _attn_inputs(torch, gen, kv, g, s, hd, bf16)
    del o
    pairs = kv * g * s * (s + 1) // 2
    row_bytes = kv * g * s * 4
    q4 = q.reshape(1, kv * g, s, hd)
    k4, v4 = k.reshape(1, kv, s, hd), v.reshape(1, kv, s, hd)
    if "swa_flash_fwd" in kernels:
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + row_bytes
        bound, by = _bound(4 * hd * pairs, nbytes, bf16)
        lib, why = _sdpa_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True))
        times["swa_flash_fwd"] = {
            "ms": _time_ms(torch, lambda: swa_attention.swa_flash_fwd(q, k, v),
                           reps=10),
            "plain_ms": _time_ms(torch, lambda: _fwd_ref_by_kv(
                torch, ref, q, k, v), reps=2, warmup=1),
            "library_ms": lib, "bound_ms": bound, "bound_by": by}
        say(phase, f"swa_flash_fwd BKV={kv} G={g} S={s} hd={hd} bf16 "
                   f"causal: {times['swa_flash_fwd']} (plain: one KV head at "
                   f"a time; library: {why}, is_causal, enable_gqa); "
                   f"{card_note(torch)}")
    if "swa_flash_bwd_dq" in kernels:
        in_bytes = 2 * (2 * q.numel() + 2 * k.numel())
        b_dq, by_dq = _bound(6 * hd * pairs, in_bytes + 2 * row_bytes
                             + q.numel() * 4, bf16)
        b_kv, by_kv = _bound(8 * hd * pairs, in_bytes + 2 * row_bytes
                             + 2 * k.numel() * 4, bf16)
        ro, rl = swa_attention.swa_flash_fwd(q, k, v)
        plain = _time_ms(torch, lambda: _bwd_ref_by_kv(
            torch, ref, q, k, v, ro, rl, do), reps=2, warmup=1)
        qg = q4.detach().requires_grad_()
        kg, vg = k4.detach().requires_grad_(), v4.detach().requires_grad_()
        lib = None
        try:
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                 enable_gqa=True)
            gout = do.reshape(1, kv * g, s, hd)
            lib = _time_ms(torch, lambda: torch.autograd.grad(
                out, (qg, kg, vg), gout, retain_graph=True), reps=10,
                warmup=2)
            why = "SDPA's whole backward"
        except RuntimeError as e:
            why = f"SDPA raised: {str(e).splitlines()[0][:120]}"
        times["swa_flash_bwd_dq"] = {
            "ms": _time_ms(torch, lambda: swa_attention.swa_flash_bwd_dq(
                q, k, v, lse, delta, do), reps=10),
            "plain_ms": plain, "library_ms": lib, "bound_ms": b_dq,
            "bound_by": by_dq}
        times["swa_flash_bwd_dkdv"] = {
            "ms": _time_ms(torch, lambda: swa_attention.swa_flash_bwd_dkdv(
                q, k, v, lse, delta, do), reps=10),
            "plain_ms": plain, "library_ms": lib, "bound_ms": b_kv,
            "bound_by": by_kv}
        say(phase, f"swa_flash_bwd BKV={kv} G={g} S={s} hd={hd} bf16 "
                   f"causal: dq {times['swa_flash_bwd_dq']}, dkdv "
                   f"{times['swa_flash_bwd_dkdv']} (plain and library the "
                   f"whole backward; library: {why}); {card_note(torch)}")
        del qg, kg, vg, ro, rl
    if "swa_flash" in kernels:
        # on the KV repeated to every head: (kv g, S, hd)
        qf = q.reshape(kv * g, s, hd).contiguous()
        kf = k.repeat_interleave(g, 0)
        vf = v.repeat_interleave(g, 0)
        bound, by = _swa_bound(kv * g, s, hd, 0, bf16)
        lib, why = _sdpa_ms(torch, lambda: F.scaled_dot_product_attention(
            qf[None], kf[None], vf[None], is_causal=True))
        times["swa_flash"] = {
            "ms": _time_ms(torch, lambda: swa_attention.swa_flash(qf, kf, vf),
                           reps=10),
            "plain_ms": _time_ms(torch, lambda: [ref.swa_attention_ref(
                qf[i:i + 8], kf[i:i + 8], vf[i:i + 8])
                for i in range(0, kv * g, 8)], reps=2, warmup=1),
            "library_ms": lib, "bound_ms": bound, "bound_by": by}
        say(phase, f"swa_flash BH={kv * g} S={s} hd={hd} bf16 causal: "
                   f"{times['swa_flash']} (plain: 8 heads a call; library: "
                   f"{why}, is_causal); {card_note(torch)}")
        del qf, kf, vf
    del q, k, v, do, lse, delta, q4, k4, v4
    torch.cuda.empty_cache()
    return times


def _decode_times(torch, gen, phase, n, g, hd, c) -> dict:
    """swa_flash_decode over n (lane, KV head) rows of G g query heads and a
    dense bf16 cache of c slots at its last position, beside its bound (the
    bytes of the cache, q and out), the plain version and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref, swa_attention
    bf16 = torch.bfloat16
    qd = _rnd(torch, gen, bf16, n, g, hd)
    kd, vd = _rnd(torch, gen, bf16, n, c, hd), _rnd(torch, gen, bf16, n, c, hd)
    pos = torch.full((n,), c - 1, dtype=torch.int32, device="cuda")
    nbytes = 2 * n * c * hd * 2 + qd.numel() * 2 + qd.numel() * 4 + 4 * n
    bound, by = _bound(4 * hd * g * n * c, nbytes, bf16)
    lib, why = _sdpa_ms(torch, lambda: F.scaled_dot_product_attention(
        qd.view(1, n * g, 1, hd), kd.view(1, n, c, hd), vd.view(1, n, c, hd),
        enable_gqa=True))
    t = {"ms": _time_ms(torch, lambda: swa_attention.swa_flash_decode(
             qd, kd, vd, pos)),
         "plain_ms": _time_ms(torch, lambda: ref.swa_decode_ref(qd, kd, vd,
                                                                pos)),
         "library_ms": lib, "bound_ms": bound, "bound_by": by}
    say(phase, f"swa_flash_decode N={n} G={g} hd={hd} dense bf16 C={c}, pos "
               f"{c - 1}: {t} (library: {why}, enable_gqa); "
               f"{card_note(torch)}")
    del qd, kd, vd
    return t


ATTN5 = ("swa_flash", "swa_flash_fwd", "swa_flash_decode", "swa_flash_bwd_dq",
         "swa_flash_bwd_dkdv")


def check_attention_hd192(torch) -> dict:
    """The five attention kernels at head dim 192 against their plain
    versions: first small cases (ragged S, windows, f32 and bf16, G 1-12),
    then nemotron_4_340b's widths (HD192: 96/8 heads, S 4096, causal) in
    bf16 and f32, the forwards at FWD_TOL (bf16; lse at LSE_TOL) and
    SWA_F32_TOL (f32), the gradients at BWD_REL_TOL (bf16) and
    BWD_F32_REL_TOL (f32), the decode at N 8, G 12 on a 4096-slot cache in
    f32, bf16 and e4m3 at DEC_TOL; every bf16 call twice, bit-identical.
    Then the bf16 kernels timed at those widths beside their bound, their
    plain version and SDPA. Returns {"errs", "times"} keyed by kernel."""
    from repro_torch.kernels import dispatch, swa_attention
    gen = torch.Generator(device="cuda").manual_seed(27)
    f32, bf16 = torch.float32, torch.bfloat16
    hd = HD192["hd"]
    errs = {k: 0.0 for k in ATTN5}
    swa_attention.reset_launches()

    # small cases: ragged S, windows, every group size of the family
    for bkv, g, s, window, dt in [(2, 3, 1000, 0, bf16), (2, 3, 517, 64, bf16),
                                  (1, 12, 300, 0, bf16), (2, 1, 130, 7, bf16),
                                  (2, 3, 517, 64, f32), (1, 12, 300, 0, f32)]:
        _attn_fwd_bwd(torch, gen, errs, "hd192", bkv, g, s, hd, window, dt)
    for bh, s, window, dt in [(4, 50, 0, bf16), (4, 1000, 7, bf16),
                              (4, 1000, 1005, bf16), (4, 1000, 7, f32),
                              (4, 50, 0, f32)]:
        _attn_flash(torch, gen, errs, "hd192", bh, s, hd, window, dt)
    # nemotron's widths
    kv, g, s = HD192["kv"], HD192["heads"] // HD192["kv"], HD192["seq"]
    for dt in (bf16, f32):
        _attn_fwd_bwd(torch, gen, errs, "hd192", kv, g, s, hd, 0, dt,
                      by_kv=True)
        _attn_flash(torch, gen, errs, "hd192", kv * g, s, hd, 0, dt,
                    per_head=True)
        torch.cuda.empty_cache()

    # the decode at N 8 (a lane's 8 KV heads), G 12, a 4096-slot cache
    for kind, window, cap in (("f32", 0, s), ("bf16", 0, s), ("e4m3", 0, s),
                              ("e4m3", 512, 512)):
        _attn_decode(torch, gen, errs, "hd192", kv, g, hd, kind, window, cap)
    torch.cuda.empty_cache()

    # one dispatch.swa_attention call at nemotron's widths, KV repeated to
    # every head: the op's path at hd 192 (its launch is the row's count)
    qp = _rnd(torch, gen, bf16, kv * g, s, hd)
    kp = _rnd(torch, gen, bf16, kv, s, hd).repeat_interleave(g, 0)
    vp = _rnd(torch, gen, bf16, kv, s, hd).repeat_interleave(g, 0)
    swa_attention.reset_launches()
    dispatch.reset_calls()
    outp = dispatch.swa_attention(qp, kp, vp)
    torch.cuda.synchronize()
    path_launches = dict(swa_attention.LAUNCHES_HD)
    check(path_launches == {("swa_flash", hd): 1}
          and dict(dispatch.CALLS) == {("swa_attention", "cuda"): 1},
          f"swa_attention at hd {hd}: launches {path_launches}, dispatches "
          f"{dispatch.CALLS}")
    check(bool(torch.isfinite(outp).all()), "swa_attention hd 192 output")
    del qp, kp, vp, outp

    # times at nemotron's widths, bf16
    times = _attn_times(torch, gen, "hd192-times", kv, g, s, hd, ATTN5)
    times["swa_flash_decode"] = _decode_times(torch, gen, "hd192-times", kv,
                                              g, hd, s)
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times, "launches": path_launches}


# public models' attention widths, run as shapes only (none is a registered
# config): name -> (query heads, KV heads, hd), from each model's
# config.json (google/gemma-7b, google/gemma-2b,
# microsoft/Phi-3-mini-4k-instruct, microsoft/phi-2, bigcode/starcoder,
# tiiuae/falcon-7b); causal at S 4096, batch 1, the decode over a 4096-slot
# cache
WIDTHS = {"gemma_7b": (16, 16, 256), "gemma_2b": (8, 1, 256),
          "phi3_mini": (32, 32, 96), "phi_2": (32, 32, 80),
          "starcoder": (48, 1, 128), "falcon_7b": (71, 1, 64)}
WIDTHS_SEQ = 4096
# the kernels line's rows at those widths: label -> (width, kernels)
WIDTH_ROWS = {"hd256": ("gemma_7b", ATTN5), "hd96": ("phi3_mini", ATTN5),
              "hd80": ("phi_2", ATTN5),
              "g48": ("starcoder", ("swa_flash_decode",)),
              "g71": ("falcon_7b", ("swa_flash_decode",))}


def check_attention_widths(torch) -> dict:
    """The five attention kernels at head dims other than 64, 128 and 192
    and the decode past 16 query heads per KV head, against their plain
    versions at the tolerances of check_attention_hd192. Small cases first:
    ragged S, windows, f32 and bf16 at hd 80, 96, 100 (bf16 through the
    wrapper's zero-padded copy) and 256, the decode at G 1 to 71 on f32,
    bf16 and e4m3 caches; then the public widths of WIDTHS (the forwards
    and backward in bf16, gemma_2b's also in f32; the decode on a bf16
    cache, starcoder's and falcon_7b's on all three), whose launches are the
    rows' counts; then hd 264 refused with no launch; then the WIDTH_ROWS
    timed beside their bound at the true hd, their plain version and SDPA.
    Every bf16 call twice, bit-identical. Returns {"errs", "times",
    "launches"}, errs and times keyed by row label and kernel."""
    from repro_torch.kernels import dispatch, swa_attention
    gen = torch.Generator(device="cuda").manual_seed(33)
    f32, bf16 = torch.float32, torch.bfloat16
    s = WIDTHS_SEQ
    errs = {label: {k: 0.0 for k in ATTN5} for label in WIDTH_ROWS}
    by_hd = {256: errs["hd256"], 96: errs["hd96"], 80: errs["hd80"],
             128: errs["g48"], 64: errs["g71"]}

    # small cases
    for hd in (80, 96, 100, 256):
        e = by_hd.get(hd, {k: 0.0 for k in ATTN5})
        for bkv, g, ss, window, dt in [(2, 3, 517, 64, bf16),
                                       (1, 5, 300, 0, bf16),
                                       (2, 1, 130, 7, bf16),
                                       (2, 3, 517, 64, f32)]:
            _attn_fwd_bwd(torch, gen, e, "widths", bkv, g, ss, hd, window, dt)
        for bh, ss, window, dt in [(4, 50, 0, bf16), (4, 1000, 7, bf16),
                                   (4, 1000, 7, f32)]:
            _attn_flash(torch, gen, e, "widths", bh, ss, hd, window, dt)
        for g, kind in ((1, "f32"), (17, "bf16"), (71, "e4m3")):
            _attn_decode(torch, gen, e, "widths", 2, g, hd, kind, 0, 1000,
                         rounds=1)
        _attn_decode(torch, gen, e, "widths", 2, 33, hd, "e4m3", 512, 512,
                     rounds=1)
    torch.cuda.empty_cache()

    # the public widths: their launches are the rows' counts
    swa_attention.reset_launches()
    for name in ("gemma_7b", "gemma_2b", "phi3_mini", "phi_2"):
        heads, kv, hd = WIDTHS[name]
        e = by_hd[hd]
        dts = (bf16, f32) if name == "gemma_2b" else (bf16,)
        for dt in dts:
            _attn_fwd_bwd(torch, gen, e, f"widths {name}", kv, heads // kv,
                          s, hd, 0, dt, by_kv=True)
            _attn_flash(torch, gen, e, f"widths {name}", heads, s, hd, 0, dt,
                        per_head=True)
            torch.cuda.empty_cache()
        _attn_decode(torch, gen, e, f"widths {name}", kv, heads // kv, hd,
                     "bf16", 0, s, rounds=1)
    for name in ("starcoder", "falcon_7b"):
        heads, kv, hd = WIDTHS[name]
        for kind in ("f32", "bf16", "e4m3"):
            _attn_decode(torch, gen, by_hd[hd], f"widths {name}", kv, heads,
                         hd, kind, 0, s, rounds=4)
    torch.cuda.synchronize()
    launches = dict(swa_attention.LAUNCHES_HD)
    say("widths", f"launches at the public widths by (kernel, hd): "
                  f"{launches}")
    torch.cuda.empty_cache()

    # above hd 256 every wrapper, and dispatch under "auto", raises before
    # any launch: no plain version, no SDPA
    x3, x4 = _rnd(torch, gen, bf16, 2, 64, 264), _rnd(torch, gen, bf16, 2, 2,
                                                        64, 264)
    refused = []
    for label, fn in (
            ("swa_flash", lambda: swa_attention.swa_flash(x3, x3, x3)),
            ("swa_flash_fwd", lambda: swa_attention.swa_flash_fwd(x4, x3,
                                                                  x3)),
            ("swa_flash_bwd", lambda: swa_attention.swa_flash_bwd(
                x4, x3, x3, x4, x4[..., 0].float(), x4)),
            ("swa_flash_decode", lambda: swa_attention.swa_flash_decode(
                x4[0].reshape(2, 64, 264)[:, :4].contiguous(), x3, x3,
                torch.zeros(2, dtype=torch.int32, device="cuda"))),
            ("dispatch.swa_attention", lambda: dispatch.swa_attention(
                x3, x3, x3)),
            ("dispatch.swa_attention_fwd_res",
             lambda: dispatch.swa_attention_fwd_res(x4, x3, x3))):
        swa_attention.reset_launches()
        try:
            fn()
        except ValueError as err:
            check("head dim 264" in str(err), f"{label}: {err}")
            refused.append(label)
        else:
            raise AssertionError(f"{label} took head dim 264 on the card")
        check(not any(swa_attention.LAUNCHES.values()),
              f"{label}: launches at hd 264 {swa_attention.LAUNCHES}")
    say("widths", f"head dim 264 on CUDA tensors raises with no launch: "
                  f"{', '.join(refused)}")
    del x3, x4

    times = {}
    for label, (name, kernels) in WIDTH_ROWS.items():
        heads, kv, hd = WIDTHS[name]
        times[label] = _attn_times(torch, gen, "widths-times", kv,
                                   heads // kv, s, hd, kernels)
        if "swa_flash_decode" in kernels:
            times[label]["swa_flash_decode"] = _decode_times(
                torch, gen, "widths-times", kv, heads // kv, hd, s)
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times, "launches": launches}



# the new configs at a route size: reduced() (2 layers, d_model <= 256,
# d_ff 256, vocab 512, factor blocks of 128, f32) with each config's own
# head dim and GQA group restored
DENSE_ROUTES = {
    "llama3_2_3b": dict(head_dim=128, n_heads=6, n_kv_heads=2),
    "qwen1_5_4b": dict(head_dim=128, n_heads=4, n_kv_heads=4),
    "musicgen_medium": dict(head_dim=64, n_heads=4, n_kv_heads=4),
    "nemotron_4_340b": dict(head_dim=192, n_heads=12, n_kv_heads=1,
                            kfac_max_dim=128),
    "llava_next_34b": dict(head_dim=128, n_heads=7, n_kv_heads=1),
}
ATTN_KERNELS = ("swa_flash_fwd", "swa_flash_bwd_dq", "swa_flash_bwd_dkdv")


def _dense_batch(torch, cfg, batch, seq, index=0, seed=0):
    """Batch ``index`` of the trainer's stream, with ``pixel_embeds`` from
    ``seed`` under the vision frontend (in cfg.dtype)."""
    out = _train_batch(torch, cfg.vocab, batch, seq, index=index)
    if cfg.frontend == "vision":
        gen = torch.Generator(device="cuda").manual_seed(seed + index)
        out["pixel_embeds"] = torch.randn(
            (batch, cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
            device="cuda").to(cfg.dtype)
    return out


def _dense_serve(torch, model, cfg) -> float:
    """2 lanes of a 64-token prompt (after their image rows under the
    vision frontend) through DecoderLM.prefill and 4 decode steps on the
    kernels and again with ServeConfig(backend="ref"), the same tokens fed
    to both: the worst max|err| / max|logit| over the 5 logit tensors,
    held to F32_LOGIT_REL_TOL."""
    from repro_torch.serve import ServeConfig
    batch = _dense_batch(torch, cfg, 2, 64, index=5)
    batch.pop("labels")
    n_front = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    max_len = n_front + 64 + 4
    logits, caches = {}, {}
    with torch.no_grad():
        for b in ("auto", "ref"):
            lg, caches[b] = model.prefill(batch, max_len,
                                          serve=ServeConfig(backend=b))
            logits[b] = [lg[:, -1]]
        tok = logits["ref"][0].argmax(-1)
        for _ in range(4):
            for b in ("auto", "ref"):
                lg, caches[b] = model.decode_step(
                    caches[b], tok, serve=ServeConfig(backend=b))
                logits[b].append(lg)
            tok = logits["ref"][-1].argmax(-1)
    worst = 0.0
    for got, want in zip(logits["auto"], logits["ref"]):
        check(bool(torch.isfinite(got).all()), f"{cfg.name} serving logits")
        worst = max(worst, _rel_err(torch, got, want))
    check(worst <= F32_LOGIT_REL_TOL,
          f"{cfg.name} serving logits kernels vs ref: {worst}")
    return worst


def check_dense_routes(torch) -> dict:
    """Each new config at the route size (DENSE_ROUTES: reduced, with its
    own head dim and GQA group), batch (2, 512) (llava: and 8 image rows
    of dim 64): a capture step (every statistic refreshed) and a fast step
    from the seed-0 model on the kernels; before each, a second optimizer
    with backend="ref" takes the kernel run's params and state as they
    stand and runs the same step. The losses, the preconditioners and the
    params after each step within ROUTE_REL_TOL; the three training
    attention kernels launched at the config's head dim and at no other.
    Then the trained kernel model serves (_dense_serve), the decode kernel
    launched at the config's head dim. Returns {arch: the kernel run's
    attention launches by (kernel, head dim)}."""
    from repro_torch.configs import get_config
    from repro_torch.core.fisher import flatten
    from repro_torch.kernels import swa_attention
    from repro_torch.launch import train
    out = {}
    lam, lr = TRAIN["damping"], TRAIN["lr"]
    for arch, over in DENSE_ROUTES.items():
        cfg = get_config(arch).reduced(**over)
        runs = {b: train.build(cfg=cfg, backend=b, device="cuda")
                for b in ("auto", "ref")}
        steps = {b: (train.make_train_step(m, o), train.make_fast_step(m, o))
                 for b, (m, o, _, _) in runs.items()}
        kmodel, kopt, kparams, kstate = runs["auto"]
        rparams = runs["ref"][2]
        flags = {k: True for k in kopt.stat_names()}
        swa_attention.reset_launches()
        worst, losses = {}, []
        for i, kind in enumerate(("capture", "fast")):
            batch = _dense_batch(torch, cfg, 2, 512, index=i)
            with torch.no_grad():
                for k, v in flatten(kparams).items():
                    flatten(rparams)[k].copy_(v)
            rstate = {**kstate, "velocity": {k: v.clone() for k, v in
                                             kstate["velocity"].items()}}
            got = {}
            for b, params, state in (("ref", rparams, rstate),
                                     ("auto", kparams, kstate)):
                capture, fast = steps[b]
                if kind == "capture":
                    params, state, m = capture(params, state, batch, flags,
                                               lam, lr, 0.9)
                else:
                    params, state, m = fast(params, state, batch, lam, lr,
                                            0.9)
                got[b] = (float(m["loss"]), {
                    f"{fam}.{k}": v.clone() for fam, c in
                    state["curv"].items() for k, v in c["precond"].items()})
                if b == "auto":
                    kparams, kstate = params, state
                    hd_launches = dict(swa_attention.LAUNCHES_HD)
            (lk, pk), (lr_, pr) = got["auto"], got["ref"]
            losses.append((lk, lr_))
            check(abs(lk - lr_) <= ROUTE_REL_TOL * abs(lr_),
                  f"{arch} {kind} loss {lk} vs ref {lr_}")
            worst[kind, "precond"] = max(_rel_err(torch, pk[n], pr[n])
                                         for n in pr)
            rflat = flatten(rparams)
            worst[kind, "params"] = max(_rel_err(torch, v, rflat[n])
                                        for n, v in flatten(kparams).items())
            for what in ("precond", "params"):
                check(worst[kind, what] <= ROUTE_REL_TOL,
                      f"{arch} {kind} step {what} rel err "
                      f"{worst[kind, what]} > {ROUTE_REL_TOL}")
            del got, rstate, pk, pr
            # the kernel run's attention launches, counted after its step
            swa_attention.reset_launches()
            if i == 0:
                launches = hd_launches
            else:
                for key, n in hd_launches.items():
                    launches[key] = launches.get(key, 0) + n
        hd = cfg.hd
        check(all(launches.get((name, hd), 0) > 0 for name in ATTN_KERNELS)
              and all(h == hd for (_, h) in launches),
              f"{arch}: attention launches by head dim {launches}")
        # serving on the trained kernel run: prefill and 4 decode steps on
        # the kernels against the same on backend="ref" (f32: within
        # F32_LOGIT_REL_TOL of the largest logit)
        serve_err = _dense_serve(torch, kmodel, cfg)
        for key, n in swa_attention.LAUNCHES_HD.items():
            launches[key] = launches.get(key, 0) + n
        check(launches.get(("swa_flash_decode", hd), 0) == 4 * cfg.n_layers,
              f"{arch}: decode launches {launches}")
        swa_attention.reset_launches()
        out[arch] = launches
        say("dense-route", f"{arch} reduced, {cfg.n_heads}/{cfg.n_kv_heads} "
                           f"heads of hd {hd}, d {cfg.d_model}, "
                           f"{cfg.n_layers} layers, f32, batch (2, 512)"
                           + (f" + {cfg.frontend_tokens} image rows of dim "
                              f"{cfg.frontend_dim}" if cfg.frontend ==
                              "vision" else "")
                           + f": losses (kernels, ref) {losses}; worst "
                           f"max|err|/max, capture step: preconditioners "
                           f"{worst['capture', 'precond']:.3e}, params "
                           f"{worst['capture', 'params']:.3e}; fast step: "
                           f"params {worst['fast', 'params']:.3e} (tol "
                           f"{ROUTE_REL_TOL}); serving 2 lanes, prefill and "
                           f"4 decode steps, kernels vs ref: max|err| / "
                           f"max|logit| {serve_err:.3e} (tol "
                           f"{F32_LOGIT_REL_TOL}); attention launches by "
                           f"(kernel, hd) {launches}")
        del runs, steps, kmodel, kopt, kparams, kstate, rparams
        torch.cuda.empty_cache()
    return out



# llava_next_34b at full width (d 7168, 56/8 heads of hd 128, d_ff 20480,
# vocab 64000, frontend 2880 x 1152, factor blocks up to 4096, bf16,
# remat), depth cut: a layer holds 557.8 M parameters (params, grads and
# velocity: 3.35 GB in bf16) and 1.94 GB of factors a copy (~4.5 copies at a
# capture step's peak), ~12 GB a layer; the embedding, head and projector,
# the 4096 x 64000 logits and the Newton-Schulz workspace of the (4 L, 4096,
# 4096) blocks ~16 GB beside. 4 layers peak near 62 GiB, 5 near 75: LLAVA
# keeps 4, under 70 GiB. One step is batch 1 x (2880 image rows + 1216 text
# tokens) = 4096 positions.
# lr and damping: at the LM path's lr 2e-2 and damping 2.5e-4 this
# random-weight model's fast steps diverged (losses 12.1 -> 2703 in 4 fast
# steps after 2 captures, chip_smoke on an H100); the parity tests' damping
# 1e-3 and a tenth of that lr keep them finite
LLAVA = dict(layers=4, text=1216, capture=2, fast=4, lr=2e-3,
             damping=1e-3)
LLAVA_SERVE = dict(lanes=4, prompts=(64, 512), decode=16)
# the path's eigh capture step runs only if the phase is below this many
# seconds before it
LLAVA_EIGH_BUDGET_S = 75.0
LLAVA_KERNELS = ("factor_syrk", "block_precond", "ns_tiled_residual",
                 "ns_tiled_update", "swa_flash_decode", "swa_flash_fwd",
                 "swa_flash_bwd_dq", "swa_flash_bwd_dkdv")


def _llava_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llava_next_34b"),
                               n_layers=LLAVA["layers"])


def llava_path(torch) -> dict:
    """llava_next_34b at full width (LLAVA: depth cut to 4 layers), random
    weights from seed 0: SP-NGD with Stage 4 by Newton-Schulz, LLAVA's 2
    capture steps (every statistic refreshed, as at random init) and 4 fast
    steps (the first a warm-up) on batch 1 x (2880 image rows from seed 0 +
    1216 text tokens of the trainer's stream); one capture and one fast
    step profiled and split by SP-NGD stage; then momentum SGD on the same
    model and batches (1 warm-up + 3 timed); an eigh capture step if the
    phase's budget allows; then serving through DecoderLM.prefill /
    decode_step with a ServeConfig (the dense f32 cache: neither package
    has a bf16 one): 4 lanes of 2880 image rows + a 64- and a 512-token
    prompt, 16 decode steps. Checks: finite losses and logits, every NS
    block converged or re-solved by eigh as counted, no ref dispatch, the
    plain iteration never called, the peak under 70 GiB, the attention
    kernels launched as reckoned. Returns the path's kernel launches."""
    import math
    from repro_torch.core.ngd import NGDConfig, SPNGD
    from repro_torch.kernels import dispatch, kfac, swa_attention
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.launch import train
    from repro_torch.optim import SGD
    from repro_torch.serve import ServeConfig
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = _llava_cfg()
    model, opt, params, state = train.build(
        cfg=cfg, device="cuda", inverse_method="newton_schulz",
        damping=LLAVA["damping"])
    n_params = sum(p.numel() for p in model.parameters())
    say("llava-path", f"llava_next_34b full width, {cfg.n_layers} layers "
                      f"(depth cut), d {cfg.d_model}, {cfg.n_heads}/"
                      f"{cfg.n_kv_heads} heads of hd {cfg.hd}, d_ff "
                      f"{cfg.d_ff}, vocab {cfg.vocab}, frontend "
                      f"{cfg.frontend_tokens} x {cfg.frontend_dim}, "
                      f"kfac_max_dim {cfg.kfac_max_dim}, {cfg.dtype}, remat "
                      f"{cfg.remat}: {n_params} params, "
                      f"{len(opt.stat_names())} statistics, "
                      f"{sum(opt.stat_bytes().values())} B of statistics "
                      f"a copy, sym-packed")
    calls = []                 # (b, trips) of every Newton-Schulz call
    inner = ns.ns_inverse

    def spy_ns(m, iters, tol):
        out = inner(m, iters, tol)
        calls.append((m.shape[-1], out[2].cpu()))
        return out
    batches = [_dense_batch(torch, cfg, 1, LLAVA["text"], index=i)
               for i in range(LLAVA["capture"] + LLAVA["fast"])]
    capture = train.make_train_step(model, opt)
    fast = train.make_fast_step(model, opt)
    flags = {k: True for k in opt.stat_names()}
    lam, lr, mom = LLAVA["damping"], LLAVA["lr"], 0.9
    swa_attention.reset_launches()
    kfac.reset_launches()
    ns.reset_launches()
    dispatch.reset_calls()
    recs = []
    ns.ns_inverse = spy_ns
    try:
        with _Stage4Timer(torch) as s4:
            for i, batch in enumerate(batches):
                kind = "capture" if i < LLAVA["capture"] else "fast"
                torch.cuda.synchronize()
                t = time.perf_counter()
                if kind == "capture":
                    params, state, m = capture(params, state, batch, flags,
                                               lam, lr, mom)
                else:
                    params, state, m = fast(params, state, batch, lam, lr,
                                            mom)
                loss = float(m["loss"])
                torch.cuda.synchronize()
                recs.append({"kind": kind, "loss": loss,
                             "seconds": time.perf_counter() - t,
                             "inverse": m.get("inverse_info", {})})
    finally:
        ns.ns_inverse = inner
    peak = torch.cuda.max_memory_allocated()
    launches = {**swa_attention.LAUNCHES, **kfac.LAUNCHES, **ns.LAUNCHES}
    dcalls = dict(dispatch.CALLS)
    check(all(math.isfinite(r["loss"]) for r in recs),
          f"llava losses {[r['loss'] for r in recs]}")
    check(not any(b == "ref" for (_, b) in dcalls),
          f"ref dispatches: {dcalls}")
    check(peak < 70 * 2 ** 30, f"llava peak {peak / 2 ** 30:.2f} GiB >= 70")
    steps = len(recs)
    check(launches["swa_flash_fwd"] == 2 * cfg.n_layers * steps
          and launches["swa_flash_bwd_dq"] == cfg.n_layers * steps
          and launches["swa_flash_bwd_dkdv"] == cfg.n_layers * steps,
          f"llava attention launches {launches}")
    check(all(launches[k] > 0 for k in ("factor_syrk", "block_precond",
                                        "ns_tiled_residual",
                                        "ns_tiled_update")),
          f"llava kernel launches {launches}")
    cap = [r for r in recs if r["kind"] == "capture"]
    infos = [i for r in cap for i in r["inverse"].values()]
    check(len(calls) == len(infos), f"NS calls {len(calls)} vs blocked "
                                    f"statistics {len(infos)}")
    trips = [x for _, t in calls for x in t.tolist()]
    fell = sum(int((~i["ns_converged"]).sum()) for i in infos)
    by_b: dict = {}
    for b, t in calls:
        by_b[b] = by_b.get(b, 0) + t.numel()
    cap_s = [r["seconds"] for r in cap]
    fast_s = [r["seconds"] for r in recs if r["kind"] == "fast"][1:]
    fast_med = statistics.median(fast_s)
    tokens = cfg.frontend_tokens + LLAVA["text"]
    say("llava-path", f"Newton-Schulz: {LLAVA['capture']} capture + "
                      f"{LLAVA['fast']} fast steps, losses "
                      f"{[round(r['loss'], 6) for r in recs]}; capture walls "
                      f"{[round(x, 3) for x in cap_s]} s, fast walls "
                      f"{[round(r['seconds'], 3) for r in recs if r['kind'] == 'fast']}"
                      f" s (the first a warm-up; median {fast_med:.4f} s, "
                      f"{tokens / fast_med:.1f} positions/s); Stage 4 "
                      f"{s4.seconds:.3f} s over {len(cap)} refreshes "
                      f"({s4.seconds / len(cap):.3f} s a refresh, "
                      f"{s4.blocks} blocks); NS blocks by size {by_b}, trips "
                      f"min {min(trips)} median {statistics.median(trips)} "
                      f"max {max(trips)}, eigh fallback {fell} of "
                      f"{len(trips)} blocks; peak memory "
                      f"{peak / 2 ** 30:.2f} GiB; launches {launches}; "
                      f"{card_note(torch)}")

    # one capture and one fast step, profiled and split by stage
    box = {"p": params, "s": state}
    pb = batches[-1]

    def cap_step():
        box["p"], box["s"], _ = capture(box["p"], box["s"], pb, flags, lam,
                                        lr, mom)

    def fast_step():
        box["p"], box["s"], _ = fast(box["p"], box["s"], pb, lam, lr, mom)
    _profile(torch, "llava fast step (4096 positions)", fast_step, warm=False,
             split=True)
    _profile(torch, "llava capture step (4096 positions)", cap_step,
             warm=False, split=True)
    params = box["p"]
    del box, state, opt, capture, fast, m
    torch.cuda.empty_cache()

    # momentum SGD on the same model and batches
    sgd = SGD(model.loss)
    sstate = sgd.init(params)
    sgd_s, sgd_l = [], []
    for i, batch in enumerate(batches[LLAVA["capture"]:]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, sstate, m = sgd.step(params, sstate, batch, lr, mom)
        sgd_l.append(float(m["loss"]))
        torch.cuda.synchronize()
        sgd_s.append(time.perf_counter() - t)
    check(all(math.isfinite(x) for x in sgd_l), f"llava SGD losses {sgd_l}")
    sgd_med = statistics.median(sgd_s[1:])
    say("llava-path", f"momentum SGD on the same model and the fast steps' "
                      f"batches: losses {[round(x, 6) for x in sgd_l]}, walls "
                      f"{[round(x, 4) for x in sgd_s]} s (the first a "
                      f"warm-up; median {sgd_med:.4f} s); the NS fast step "
                      f"median {fast_med:.4f} s = {fast_med / sgd_med:.3f} x "
                      f"SGD's; {card_note(torch)}")
    del sgd, sstate
    torch.cuda.empty_cache()

    # one eigh capture step, when the budget allows
    spent = time.perf_counter() - t_phase
    if spent < LLAVA_EIGH_BUDGET_S:
        eopt = SPNGD(model.loss, model.site_infos(), model.fstats,
                     model.site_counts, NGDConfig(damping=lam))
        estate = eopt.init(params)
        torch.cuda.reset_peak_memory_stats()
        with _Stage4Timer(torch) as s4e:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, estate, m = train.make_train_step(model, eopt)(
                params, estate, batches[0], flags, lam, lr, mom)
            eloss = float(m["loss"])
            torch.cuda.synchronize()
            ewall = time.perf_counter() - t
        check(math.isfinite(eloss), f"llava eigh loss {eloss}")
        say("llava-path", f"one eigh capture step: {ewall:.3f} s, Stage 4 "
                          f"{s4e.seconds:.3f} s ({s4e.blocks} blocks), loss "
                          f"{eloss:.6f}, peak "
                          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
                          f" GiB; {card_note(torch)}")
        del eopt, estate, m
        torch.cuda.empty_cache()
    else:
        say("llava-path", f"eigh capture step not timed: the phase had "
                          f"spent {spent:.1f} s of its {LLAVA_EIGH_BUDGET_S}"
                          f" s budget for it")

    # serving: prefill and decode on the kernels
    serve = ServeConfig()                   # window 0 -> the dense f32 cache
    lanes, steps_d = LLAVA_SERVE["lanes"], LLAVA_SERVE["decode"]
    max_len = cfg.frontend_tokens + max(LLAVA_SERVE["prompts"]) + steps_d
    gen = torch.Generator(device="cuda").manual_seed(0)
    swa_attention.reset_launches()
    dispatch.reset_calls()
    pre = {}
    with torch.no_grad():
        for plen in LLAVA_SERVE["prompts"]:
            req = {"tokens": torch.randint(0, cfg.vocab, (lanes, plen),
                                           generator=gen, device="cuda"),
                   "pixel_embeds": torch.randn(
                       (lanes, cfg.frontend_tokens, cfg.frontend_dim),
                       generator=gen, device="cuda").to(cfg.dtype)}
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = model.prefill(req, max_len, serve=serve)
            torch.cuda.synchronize()
            pre[plen] = time.perf_counter() - t
            check(logits.shape == (lanes, cfg.frontend_tokens + plen,
                                   cfg.vocab)
                  and bool(torch.isfinite(logits[:, -1]).all()),
                  f"llava prefill logits {tuple(logits.shape)}")
            check(cache["len"].tolist() == [cfg.frontend_tokens + plen]
                  * lanes, f"cache len {cache['len'].tolist()}")
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps_d):
            out, cache = model.decode_step(cache, tok, serve=serve)
            tok = out.argmax(-1)
        torch.cuda.synchronize()
        dec = time.perf_counter() - t
        check(bool(torch.isfinite(out).all()), "llava decode logits")
    slaunch = dict(swa_attention.LAUNCHES)
    check(slaunch["swa_flash_fwd"] == cfg.n_layers * len(pre)
          and slaunch["swa_flash_decode"] == cfg.n_layers * steps_d,
          f"llava serving launches {slaunch}")
    check(not any(b == "ref" for (_, b) in dispatch.CALLS),
          f"ref dispatches: {dispatch.CALLS}")
    say("llava-path", f"serving {lanes} lanes, dense f32 cache of {max_len} "
                      f"slots: prefill of {cfg.frontend_tokens} image rows + "
                      + ", ".join(f"{p}-token prompts {pre[p]:.3f} s "
                                  f"({lanes * (cfg.frontend_tokens + p) / pre[p]:.1f}"
                                  f" positions/s)" for p in pre)
                      + f"; {steps_d} decode steps {dec:.3f} s "
                      f"({lanes * steps_d / dec:.1f} tokens/s); launches "
                      f"{slaunch}; {card_note(torch)}")
    for k in ("swa_flash_fwd", "swa_flash_decode"):
        launches[k] = launches.get(k, 0) + slaunch[k]
    del model, params, cache, logits, out
    torch.cuda.empty_cache()
    say("llava-path", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def time_llava_kernels(torch) -> dict:
    """The kernels of llava_path at its shapes, each against its plain
    version (max|err|) and timed beside its bound, the plain version and
    the library call: factor_syrk of mlp_down's A (4096 positions x 20480,
    5 blocks of 4096) and of a 7168-wide A (2 blocks of 3584), block_precond
    of mlp_down's A side ((5, 4096, 4096) x (20480, 7168)), one tiled
    Newton-Schulz residual and update on mlp_up's G blocks over the path's
    layers ((4 L, 4096, 4096)), the attention trio at (8 KV heads, G 7,
    S 4096, hd 128) causal, and the decode at the serving step (32 rows of
    G 7 over the dense f32 cache). Returns {kernel: row}."""
    import torch.nn.functional as F
    from repro_torch.core import kfac
    from repro_torch.kernels import dispatch, ref, swa_attention
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import newton_schulz as ns
    cfg = _llava_cfg()
    gen = torch.Generator(device="cuda").manual_seed(29)
    f32, bf16 = torch.float32, torch.bfloat16
    res = {}
    n, md = 4096, cfg.kfac_max_dim
    for d in (cfg.d_ff, cfg.d_model):
        x = torch.randn((n, d), generator=gen, device="cuda").bfloat16()
        nb, b = kfac.num_blocks(d, md), kfac.block_size(d, md)
        got, want = kern.factor_syrk(x, md), ref.factor_sum_ref(x, md)
        err = _max_err(torch, got, want)
        check(_rel_err(torch, got, want) <= KFAC_REL_TOL,
              f"factor_syrk ({n}, {d}): rel err {_rel_err(torch, got, want)}")
        ops, nbytes = _syrk_ops_bytes(n, nb, b, nb * b * b * 4)
        bound, by = _bound(ops, nbytes, x.dtype)
        xb = x.view(n, nb, b).transpose(0, 1)
        row = {"ms": _time_ms(torch, lambda: kern.factor_syrk(x, md)),
               "plain_ms": _time_ms(torch, lambda: ref.factor_sum_ref(x, md),
                                    reps=5),
               "library_ms": _time_ms(torch, lambda: torch.bmm(
                   xb.transpose(1, 2), xb, out_dtype=f32)),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        if d == cfg.d_ff:
            res["factor_syrk"] = row
        say("llava-times", f"factor_syrk n={n} d={d} nb={nb} b={b} bf16 -> "
                           f"f32: {row} (library: torch.bmm over blocks, f32 "
                           f"out); {card_note(torch)}")
        del x, xb, got, want

    b, nb = 4096, cfg.d_ff // 4096
    binv = torch.randn((nb, b, b), generator=gen, device="cuda") / b ** 0.5
    w = torch.randn((cfg.d_ff, cfg.d_model), generator=gen, device="cuda")
    left_ref = dispatch.lookup("block_precond_left", "ref")
    got, want = kern.block_precond(binv, w), left_ref(binv, w)
    check(_rel_err(torch, got, want) <= KFAC_REL_TOL,
          f"block_precond: rel err {_rel_err(torch, got, want)}")
    bound, by = _bound(2 * b * w.shape[0] * w.shape[1],
                       (binv.numel() + 2 * w.numel()) * 4, f32,
                       PEAK_SPLIT_F32_OPS_PER_S)
    wb = w.view(nb, b, -1)
    res["block_precond"] = {
        "ms": _time_ms(torch, lambda: kern.block_precond(binv, w), reps=10),
        "plain_ms": _time_ms(torch, lambda: left_ref(binv, w), reps=5),
        "library_ms": _time_ms(torch, lambda: torch.bmm(binv, wb), reps=10),
        "bound_ms": bound, "bound_by": by,
        "max_abs_err": _max_err(torch, got, want)}
    say("llava-times", f"block_precond left binv ({nb}, {b}, {b}) w "
                       f"({cfg.d_ff}, {cfg.d_model}) f32: "
                       f"{res['block_precond']} (library: torch.bmm f32, TF32"
                       f" off); {card_note(torch)}")
    del binv, w, wb, got, want
    torch.cuda.empty_cache()

    g = cfg.d_ff // b * cfg.n_layers          # mlp_up's G: 5 blocks a layer
    _, _, m = _ns_factors(torch, gen, g, b, 1.0, 1e-3)
    x = ref.ns_x0(m)
    eye = torch.eye(b, device="cuda")
    r, _ = ns.ns_tiled_residual(m, x)
    r_ref, _ = ref.ns_tiled_residual_ref(m, x)
    u, u_ref = ns.ns_tiled_update(x, r), ref.ns_tiled_update_ref(x, r)
    errs = (_max_err(torch, r, r_ref), _max_err(torch, u, u_ref))
    check(_rel_err(torch, r, r_ref) <= NS_PRODUCT_REL_TOL
          and _rel_err(torch, u, u_ref) <= NS_PRODUCT_REL_TOL,
          f"NS tiled pair at ({g}, {b}, {b}): rel errs "
          f"{_rel_err(torch, r, r_ref)}, {_rel_err(torch, u, u_ref)}")
    del r_ref, u_ref, u
    nbytes = 3 * g * b * b * 4
    bound, by = _bound(2 * b ** 3 * g, nbytes + 4 * g, f32,
                       PEAK_SPLIT_F32_OPS_PER_S)
    res["ns_tiled_residual"] = {
        "ms": _time_ms(torch, lambda: ns.ns_tiled_residual(m, x), reps=5),
        "plain_ms": _time_ms(torch, lambda: ref.ns_tiled_residual_ref(m, x),
                             reps=3),
        "library_ms": _time_ms(torch, lambda: torch.baddbmm(eye, m, x,
                                                            alpha=-1.0),
                               reps=5),
        "bound_ms": bound, "bound_by": by, "max_abs_err": errs[0]}
    bound, by = _bound(2 * b ** 3 * g, nbytes, f32, PEAK_SPLIT_F32_OPS_PER_S)
    res["ns_tiled_update"] = {
        "ms": _time_ms(torch, lambda: ns.ns_tiled_update(x, r), reps=5),
        "plain_ms": _time_ms(torch, lambda: ref.ns_tiled_update_ref(x, r),
                             reps=3),
        "library_ms": _time_ms(torch, lambda: torch.baddbmm(x, x, r), reps=5),
        "bound_ms": bound, "bound_by": by, "max_abs_err": errs[1]}
    say("llava-times", f"ns_tiled_residual ({g}, {b}, {b}) f32: "
                       f"{res['ns_tiled_residual']}; ns_tiled_update: "
                       f"{res['ns_tiled_update']} (library: torch.baddbmm "
                       f"f32, TF32 off); {card_note(torch)}")
    del m, x, r, eye
    torch.cuda.empty_cache()

    # the attention trio at one training layer's call
    kv, gq, s, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, 4096, cfg.hd
    q, k, v, do, o, lse, delta = _attn_inputs(torch, gen, kv, gq, s, hd, bf16)
    out, lse_k = swa_attention.swa_flash_fwd(q, k, v)
    err_f = _max_err(torch, out, o)
    torch.testing.assert_close(out.float(), o.float(), **FWD_TOL)
    grads = swa_attention.swa_flash_bwd(q, k, v, o, lse, do)
    want = ref.swa_attention_bwd_ref(q, k, v, o, lse, do)
    rel = [_rel_err(torch, a, b_) for a, b_ in zip(grads, want)]
    check(max(rel) <= BWD_REL_TOL, f"llava attention bwd rel errs {rel}")
    err_dq = _max_err(torch, grads[0], want[0])
    err_kv = max(_max_err(torch, grads[1], want[1]),
                 _max_err(torch, grads[2], want[2]))
    del out, lse_k, grads, want
    pairs = kv * gq * s * (s + 1) // 2
    row_bytes = kv * gq * s * 4
    q4 = q.reshape(1, kv * gq, s, hd)
    k4, v4 = k.reshape(1, kv, s, hd), v.reshape(1, kv, s, hd)
    bound, by = _bound(4 * hd * pairs, 2 * (2 * q.numel() + k.numel()
                                            + v.numel()) + row_bytes, bf16)
    res["swa_flash_fwd"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_fwd(q, k, v)),
        "plain_ms": _time_ms(torch, lambda: ref.swa_attention_fwd_res_ref(
            q, k, v), reps=3),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)),
        "bound_ms": bound, "bound_by": by, "max_abs_err": err_f}
    in_bytes = 2 * (2 * q.numel() + 2 * k.numel())
    b_dq, by_dq = _bound(6 * hd * pairs, in_bytes + 2 * row_bytes
                         + q.numel() * 4, bf16)
    b_kv, by_kv = _bound(8 * hd * pairs, in_bytes + 2 * row_bytes
                         + 2 * k.numel() * 4, bf16)
    plain = _time_ms(torch, lambda: ref.swa_attention_bwd_ref(q, k, v, o,
                                                              lse, do),
                     reps=3)
    qg = q4.detach().requires_grad_()
    kg, vg = k4.detach().requires_grad_(), v4.detach().requires_grad_()
    sd = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                        enable_gqa=True)
    gout = do.reshape(1, kv * gq, s, hd)
    lib = _time_ms(torch, lambda: torch.autograd.grad(
        sd, (qg, kg, vg), gout, retain_graph=True))
    res["swa_flash_bwd_dq"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_bwd_dq(
            q, k, v, lse, delta, do)),
        "plain_ms": plain, "library_ms": lib, "bound_ms": b_dq,
        "bound_by": by_dq, "max_abs_err": err_dq}
    res["swa_flash_bwd_dkdv"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_bwd_dkdv(
            q, k, v, lse, delta, do)),
        "plain_ms": plain, "library_ms": lib, "bound_ms": b_kv,
        "bound_by": by_kv, "max_abs_err": err_kv}
    say("llava-times", f"attention BKV={kv} G={gq} S={s} hd={hd} bf16 causal:"
                       f" fwd {res['swa_flash_fwd']} (library: SDPA, "
                       f"enable_gqa); dq {res['swa_flash_bwd_dq']}; dkdv "
                       f"{res['swa_flash_bwd_dkdv']} (plain and library the "
                       f"whole backward); {card_note(torch)}")
    del q, k, v, do, o, lse, delta, q4, k4, v4, qg, kg, vg, sd, gout

    # the decode: 4 lanes x 8 KV heads over the serving path's dense f32
    # cache, positions near its end
    nl = LLAVA_SERVE["lanes"] * kv
    c = cfg.frontend_tokens + max(LLAVA_SERVE["prompts"]) + \
        LLAVA_SERVE["decode"]
    qd = torch.randn((nl, gq, hd), generator=gen, device="cuda").bfloat16()
    kc = torch.randn((nl, c, hd), generator=gen, device="cuda")
    vc = torch.randn((nl, c, hd), generator=gen, device="cuda")
    pos = torch.full((nl,), c - 1, dtype=torch.int32, device="cuda")
    got = swa_attention.swa_flash_decode(qd, kc, vc, pos)
    want = ref.swa_decode_ref(qd.float(), kc, vc, pos)
    torch.testing.assert_close(got, want, **DEC_TOL)
    nbytes = 2 * nl * c * hd * 4 + qd.numel() * 6 + 4 * nl
    bound, by = _bound(4 * hd * gq * nl * c, nbytes, f32)
    res["swa_flash_decode"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_decode(
            qd, kc, vc, pos)),
        "plain_ms": _time_ms(torch, lambda: ref.swa_decode_ref(qd, kc, vc,
                                                               pos)),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd.float().view(1, nl * gq, 1, hd), kc.view(1, nl, c, hd),
            vc.view(1, nl, c, hd), enable_gqa=True)),
        "bound_ms": bound, "bound_by": by,
        "max_abs_err": _max_err(torch, got, want)}
    say("llava-times", f"swa_flash_decode N={nl} G={gq} hd={hd} dense f32 "
                       f"C={c}: {res['swa_flash_decode']} (library: SDPA, "
                       f"enable_gqa); {card_note(torch)}")
    del qd, kc, vc, got, want
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the MoE family: mixtral_8x22b and qwen2_moe_a2_7b, whose expert sites sum
# and precondition (E, ...) stacks in one launch per call
# ---------------------------------------------------------------------------

# factor_syrk on expert stacks (lead, n, d, max_dim, dtype): qwen2_moe's
# up/gate A and G at 4,096 tokens (capacity 341 of 60 experts), mixtral's
# at 4,096 tokens (capacity 1280 of 8: A 6144 in 2 blocks of 3072, the
# down projection's 16384 in 4 of 4096); f32 with the tokens in chunks; a
# lead of 1; a ragged last block (2050 in 3 blocks of 684, rows off 16
# bytes: the element loads)
MOE_SYRK_CASES = (
    (60, 341, 2048, 2048, "bfloat16"), (60, 341, 1408, 2048, "bfloat16"),
    (8, 1280, 6144, 4096, "bfloat16"), (8, 1280, 16384, 4096, "bfloat16"),
    (4, 20000, 96, 2048, "float32"), (6, 333, 300, 128, "float32"),
    (1, 4096, 2048, 2048, "bfloat16"), (3, 333, 2050, 1024, "bfloat16"),
)
# block_precond on expert stacks (mode, lead, nb, b, dim, other):
# qwen2_moe's up/gate (d_in 2048, d_out 1408) and down (1408 -> 2048)
# gradients from both sides; a ragged last block; rows off 16 bytes
MOE_PRECOND_CASES = (
    ("left", 60, 1, 2048, 2048, 1408), ("right", 60, 1, 1408, 1408, 2048),
    ("left", 60, 1, 1408, 1408, 2048), ("right", 60, 1, 2048, 2048, 1408),
    ("left", 3, 3, 684, 2050, 300), ("right", 3, 3, 684, 2050, 300),
    ("left", 2, 3, 97, 290, 70),
)


def _launched_once(torch, fn, name, counts=None):
    """Call ``fn`` twice; each call must launch kernel ``name`` once (the
    wrapper's count in ``counts``, by default ``kernels/kfac.py``'s): the
    output of the first and whether the second gave the same bits."""
    from repro_torch.kernels import kfac as kern
    counts = kern.LAUNCHES if counts is None else counts
    before = counts[name]
    got = fn()
    again = fn()
    torch.cuda.synchronize()
    check(counts[name] - before == 2,
          f"{name}: {counts[name] - before} launches for 2 calls")
    same = torch.equal(got, again)
    del again
    return got, same


def check_moe_wire(torch, gen, worst: dict) -> None:
    """factor_syrk_wire over the expert axis (_wire_case): qwen2_moe's
    up/gate A (60, 341, 2048) bf16 at max_dim 1024, 2 blocks of 1024 for
    each of the 60 experts, in one launch; then the op's b > 1024 route at
    max_dim 2048 (one factor_syrk launch over the lead, one quant_rows over
    the flattened rows) on the same stack; then a lead of 65,536 matrices
    of one block, past grid y's 65,535 (which refused it until the blocks
    were folded into grid x), in one launch."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import quant as qk
    x = torch.randn((60, 341, 2048), generator=gen, device="cuda").bfloat16()
    before = dict(qk.LAUNCHES)
    _wire_case(torch, worst, "factor_syrk_wire[moe]",
               "(60, 341, 2048) bf16 max_dim 1024 (60 x 2 blocks of 1024)",
               x, 1024, "e4m3", "fp32", "fused")
    wire = qk.LAUNCHES["factor_syrk_wire"] - before["factor_syrk_wire"]
    check(wire == 1, f"factor_syrk_wire over 60 experts: {wire} launches")
    before = dict(qk.LAUNCHES)
    syrk = kern.LAUNCHES["factor_syrk"]
    dispatch.reset_calls()
    # held to the same checks; its error is not the kernel's, so it goes
    # under a key of its own, outside the kernels line
    _wire_case(torch, worst, "factor_sum_wire[moe, b > 1024]",
               "(60, 341, 2048) bf16 max_dim 2048 (60 x 1 block of 2048)",
               x, 2048, "e4m3", "fp32", "dispatch")
    # the route's factor_syrk and quant_rows, and _wire_case's factor_syrk
    # of the route's own sums
    got = (kern.LAUNCHES["factor_syrk"] - syrk,
           qk.LAUNCHES["quant_rows"] - before["quant_rows"],
           qk.LAUNCHES["factor_syrk_wire"] - before["factor_syrk_wire"])
    check(got == (2, 1, 0) and dispatch.CALLS == {("factor_sum_wire",
                                                    "cuda"): 1},
          f"the b > 1024 wire route over 60 experts: launches (syrk, quant, "
          f"wire) {got}, dispatches {dispatch.CALLS}")
    del x
    big = torch.randn((65536, 16, 8), generator=gen,
                      device="cuda").bfloat16()
    before = dict(qk.LAUNCHES)
    _wire_case(torch, worst, "factor_sum_wire[moe, lead 65536]",
               "(65536, 16, 8) bf16 max_dim 8 (65,536 x 1 block of 8)", big,
               8, "e4m3", "fp32", "fused")
    wire = qk.LAUNCHES["factor_syrk_wire"] - before["factor_syrk_wire"]
    check(wire == 1, f"factor_syrk_wire over 65,536 matrices: {wire} "
                     f"launches")
    say("moe-kernels", f"factor_syrk_wire over the expert axis: one launch "
                       f"for 60 x 2 blocks (max|err| of the decode "
                       f"{worst['factor_syrk_wire[moe]']:.3e}), the b > 1024 "
                       f"route one factor_syrk + one quant_rows launch "
                       f"({worst['factor_sum_wire[moe, b > 1024]']:.3e}); a "
                       f"lead of 65,536 in one launch ("
                       f"{worst['factor_sum_wire[moe, lead 65536]']:.3e})")
    del big
    torch.cuda.empty_cache()


def check_moe_kernels(torch) -> dict:
    """factor_syrk and block_precond on expert stacks (MOE_SYRK_CASES,
    MOE_PRECOND_CASES) against the plain versions (which broadcast over the
    leading axes), at KFAC_REL_TOL of the largest entry; each call one
    launch, two calls bit-identical; a strided lead (a view of fewer tokens
    than its matrices hold) and the dispatch ops on a stack (one launch per
    call). Returns {"factor_syrk[moe]": max|err|, "block_precond[moe]":
    max|err|}, the worst over the cases."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import kfac as kern
    gen = torch.Generator(device="cuda").manual_seed(28)
    worst = {"factor_syrk[moe]": 0.0, "block_precond[moe]": 0.0,
             "factor_syrk_wire[moe]": 0.0}

    def syrk_case(x, max_dim, what):
        got, same = _launched_once(torch, lambda: kern.factor_syrk(x, max_dim),
                                   "factor_syrk")
        want = ref.factor_sum_ref(x, max_dim)
        check(got.shape == want.shape, f"factor_syrk {what}: {got.shape}")
        check(same, f"factor_syrk {what}: two launches differ")
        err = _rel_err(torch, got, want)
        check(err <= KFAC_REL_TOL, f"factor_syrk {what}: rel err {err} > "
                                   f"{KFAC_REL_TOL}")
        worst["factor_syrk[moe]"] = max(worst["factor_syrk[moe]"],
                                        _max_err(torch, got, want))
        say("moe-kernels", f"factor_syrk {what} -> {tuple(got.shape)}: "
                           f"max|err| / max|A| = {err:.3e} (tol "
                           f"{KFAC_REL_TOL}), one launch a call, two "
                           f"bit-identical")

    for lead, n, d, max_dim, dt in MOE_SYRK_CASES:
        x = torch.randn((lead, n, d), generator=gen, device="cuda").to(
            getattr(torch, dt))
        syrk_case(x, max_dim, f"({lead}, {n}, {d}) max_dim {max_dim} {dt}")
        del x
        torch.cuda.empty_cache()
    x = torch.randn((4, 341, 512), generator=gen, device="cuda").bfloat16()
    syrk_case(x[:, :300], 2048, "(4, 300 of 341, 512) bf16, strided lead")
    dispatch.reset_calls()
    before = kern.LAUNCHES["factor_syrk"]
    got = dispatch.factor_sum(x, 2048, backend="cuda")
    check(kern.LAUNCHES["factor_syrk"] - before == 1
          and dispatch.CALLS == {("factor_sum", "cuda"): 1},
          f"dispatch.factor_sum on a stack: {dispatch.CALLS}")
    check(_rel_err(torch, got, ref.factor_sum_ref(x, 2048)) <= KFAC_REL_TOL,
          "dispatch.factor_sum on a stack")
    del x, got
    check_moe_wire(torch, gen, worst)

    for mode, lead, nb, b, dim, other in MOE_PRECOND_CASES:
        right = mode == "right"
        binv = torch.randn((lead, nb, b, b), generator=gen,
                           device="cuda") / b ** 0.5
        shape = (lead, other, dim) if right else (lead, dim, other)
        w = torch.randn(shape, generator=gen, device="cuda")
        got, same = _launched_once(
            torch, lambda: kern.block_precond(binv, w, right=right),
            "block_precond")
        check(same, f"block_precond {mode} {shape}: two launches differ")
        want = (dispatch.lookup("block_precond_right", "ref")(w, binv)
                if right else
                dispatch.lookup("block_precond_left", "ref")(binv, w))
        err = _rel_err(torch, got, want)
        check(got.shape == w.shape and err <= KFAC_REL_TOL,
              f"block_precond {mode} {shape}: rel err {err} > "
              f"{KFAC_REL_TOL}")
        worst["block_precond[moe]"] = max(worst["block_precond[moe]"],
                                          _max_err(torch, got, want))
        say("moe-kernels", f"block_precond {mode} binv ({lead}, {nb}, {b}, "
                           f"{b}) w {shape} f32: max|err| / max|U| = "
                           f"{err:.3e} (tol {KFAC_REL_TOL}), one launch a "
                           f"call, two bit-identical")
        del binv, w, got, want
        torch.cuda.empty_cache()
    # the dispatch ops on a fresh state's expanded identity stack, both
    # sides: one launch each
    eye = torch.eye(97, device="cuda").expand(2, 3, 97, 97)
    w = torch.randn((2, 70, 290), generator=gen, device="cuda")
    before = kern.LAUNCHES["block_precond"]
    u = dispatch.block_precond_left(eye, w.transpose(1, 2).contiguous(),
                                    backend="cuda")
    v = dispatch.block_precond_right(w, eye, backend="cuda")
    check(kern.LAUNCHES["block_precond"] - before == 2
          and _rel_err(torch, v, w) <= KFAC_REL_TOL
          and _rel_err(torch, u, w.transpose(1, 2)) <= KFAC_REL_TOL,
          "dispatch.block_precond_{left,right} on an identity stack")
    del eye, w, u, v
    torch.cuda.empty_cache()
    return worst


def time_moe_kernels(torch) -> dict:
    """factor_syrk and block_precond at qwen2_moe_a2_7b's expert shapes
    (4,096 tokens, capacity 341 of 60 experts): the SYRK of the up/gate A
    (60, 341, 2048) -> (60, 1, 2048, 2048) and the left preconditioning of
    the up/gate gradient (60, 1, 2048, 2048) x (60, 2048, 1408), each
    beside its bound, its plain version and the library call (torch.bmm,
    bf16 with f32 output for the SYRK, f32 with TF32 off for the
    preconditioner); and factor_syrk_wire over the same stack at max_dim
    1024 (moe_wire_path's blocks: 60 x 2 of 1024), its bound by count (the
    sums' operations, x read once, payload and scales written once) beside
    torch.bmm's f32-out time for the same sums. Returns {"factor_syrk[moe]":
    row, "block_precond[moe]": row, "factor_syrk_wire[moe]": row}."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import kfac as kern
    gen = torch.Generator(device="cuda").manual_seed(280)
    f32 = torch.float32
    res = {}
    lead, n, d = 60, 341, 2048
    x = torch.randn((lead, n, d), generator=gen, device="cuda").bfloat16()
    ops, nbytes = _syrk_ops_bytes(n, 1, d, d * d * 4)
    bound, by = _bound(lead * ops, lead * nbytes, x.dtype)
    res["factor_syrk[moe]"] = {
        "ms": _time_ms(torch, lambda: kern.factor_syrk(x, 2048), reps=10),
        "plain_ms": _time_ms(torch, lambda: ref.factor_sum_ref(x, 2048),
                             reps=5),
        "library_ms": _time_ms(torch, lambda: torch.bmm(
            x.transpose(1, 2), x, out_dtype=f32), reps=10),
        "bound_ms": bound, "bound_by": by}
    say("moe-times", f"factor_syrk ({lead}, {n}, {d}) bf16 -> ({lead}, 1, "
                     f"{d}, {d}) f32: {res['factor_syrk[moe]']} (library: "
                     f"torch.bmm, bf16 in, f32 out); {card_note(torch)}")
    del x
    torch.cuda.empty_cache()
    b, m = 2048, 1408
    binv = torch.randn((lead, 1, b, b), generator=gen, device="cuda") / b ** .5
    w = torch.randn((lead, b, m), generator=gen, device="cuda")
    left_ref = dispatch.lookup("block_precond_left", "ref")
    bound, by = _bound(2 * lead * b * b * m,
                       (binv.numel() + 2 * w.numel()) * 4, f32,
                       PEAK_SPLIT_F32_OPS_PER_S)
    bv = binv.view(lead, b, b)
    res["block_precond[moe]"] = {
        "ms": _time_ms(torch, lambda: kern.block_precond(binv, w), reps=10),
        "plain_ms": _time_ms(torch, lambda: left_ref(binv, w), reps=5),
        "library_ms": _time_ms(torch, lambda: torch.bmm(bv, w), reps=10),
        "bound_ms": bound, "bound_by": by}
    say("moe-times", f"block_precond left binv ({lead}, 1, {b}, {b}) w "
                     f"({lead}, {b}, {m}) f32: {res['block_precond[moe]']} "
                     f"(library: torch.bmm f32, TF32 off); "
                     f"{card_note(torch)}")
    del binv, w, bv
    torch.cuda.empty_cache()
    from repro_torch.kernels import quant as qk
    nb, b = 2, 1024
    t = b * (b + 1) // 2
    x = torch.randn((lead, n, d), generator=gen, device="cuda").bfloat16()
    xb = x.view(lead, n, nb, b).permute(0, 2, 1, 3).reshape(lead * nb, n, b)
    ops, nbytes = _syrk_ops_bytes(n, nb, b, nb * (t + 4))
    bound, by = _bound(lead * ops, lead * nbytes, x.dtype)
    res["factor_syrk_wire[moe]"] = {
        "ms": _time_ms(torch, lambda: qk.factor_syrk_wire(x, 1024), reps=10),
        "plain_ms": _time_ms(torch, lambda: ref.factor_sum_wire_ref(x, 1024),
                             reps=3),
        "library_ms": _time_ms(torch, lambda: torch.bmm(
            xb.transpose(1, 2), xb, out_dtype=f32), reps=10),
        "bound_ms": bound, "bound_by": by}
    say("moe-times", f"factor_syrk_wire ({lead}, {n}, {d}) bf16 max_dim 1024 "
                     f"-> payload ({lead}, {nb}, {t}) e4m3: "
                     f"{res['factor_syrk_wire[moe]']} (library: torch.bmm "
                     f"over the {lead * nb} blocks, bf16 in, f32 out, the "
                     f"same sums unpacked); {card_note(torch)}")
    del x, xb
    torch.cuda.empty_cache()
    return res


# each MoE config at a route size (reduced, f32): mixtral with its 8
# experts and its own GQA group (48/8 heads: G 6) at hd 128; qwen2_moe with
# its 60 experts, top-4 and one shared expert, MHA at hd 128
MOE_ROUTES = {
    "mixtral_8x22b": dict(n_experts=8, head_dim=128, n_heads=6,
                          n_kv_heads=1),
    "qwen2_moe_a2_7b": dict(n_experts=60, top_k=4, n_shared_experts=1,
                            head_dim=128, n_heads=4, n_kv_heads=4),
}
# the MoE serve check's ref arm on a cache of its own (chip_smoke
# _moe_serve): at most this share of the fp8 ring's codes may sit one e4m3
# step from the ref arm's (the CPU test met one of 6,144 in reduced
# mixtral's layer-1 K, f32 rounding of the layer's input), and that arm's
# logits within this of the kernel arm's (that one code moved reduced
# mixtral's logits by up to 4.1e-3, 6.7e-4 of their largest, 6.15)
MOE_CODE_FLIP_FRAC = 1e-3
MOE_OWN_LOGIT_REL_TOL = 1e-2
# mixtral's attention at its own widths through the training kernels: a
# 4,096-token window over 8,192 positions, 48 query heads over 8 KV heads
MIXTRAL_ATTN = dict(kv=8, g=6, seq=8192, hd=128, window=4096)


@contextlib.contextmanager
def _expert_launches():
    """The (kernel, lead) of every factor_syrk and block_precond launch
    with a leading axis (an expert stack), by spies on the wrappers that
    dispatch calls: yields the list."""
    from repro_torch.kernels import kfac as kern
    calls, inner = [], (kern.factor_syrk, kern.block_precond)

    def syrk_spy(x, max_dim):
        if x.dim() == 3:
            calls.append(("factor_syrk", x.shape[0]))
        return inner[0](x, max_dim)

    def precond_spy(binv, w, right=False):
        if w.dim() == 3:
            calls.append(("block_precond", w.shape[0]))
        return inner[1](binv, w, right=right)
    kern.factor_syrk, kern.block_precond = syrk_spy, precond_spy
    try:
        yield calls
    finally:
        kern.factor_syrk, kern.block_precond = inner


def _check_expert_launches(calls, want: dict, e: int, what: str) -> dict:
    """Each kernel launched ``want[kernel]`` times with the expert axis,
    every launch over all ``e`` experts (no loop over them). Returns the
    counts."""
    seen = {k: sum(1 for n, _ in calls if n == k) for k in want}
    check(seen == want and all(ld == e for _, ld in calls),
          f"{what}: expert-axis launches {seen} (want {want}), leads "
          f"{sorted({ld for _, ld in calls})}")
    return seen


@contextlib.contextmanager
def _routes_recorded():
    """Every router call's top-k indices, as the model routes (a spy on
    ``models.moe.router_probs``): yields the list, one (T, k) tensor a
    call."""
    from repro_torch.models import moe
    rec, inner = [], moe.router_probs

    def spy(*a, **k):
        out = inner(*a, **k)
        rec.append(out[1].detach().clone())
        return out
    moe.router_probs = spy
    try:
        yield rec
    finally:
        moe.router_probs = inner


def _moe_serve(torch, model, cfg) -> dict:
    """2 lanes of a 64-token prompt through DecoderLM.prefill on the kernels
    and with ServeConfig(backend="ref"), then 4 decode steps in three arms
    fed the same tokens (the own ref arm's argmax): the kernels on their
    cache; backend="ref" from a copy of the kernel arm's cache as it stands
    before each step (the same fp8 codes: "shared", the worst max|err| /
    max|logit| over the 5 logit tensors, held to F32_LOGIT_REL_TOL); and
    backend="ref" on a cache of its own, written by its own prefill and
    steps ("own"). The own arm holds the kernel arm's cache writes: after
    the prefill and after each step both caches are compared, the fp8 ring
    code by code (every code within one e4m3 step of the ref arm's, at most
    MOE_CODE_FLIP_FRAC of them one step off: f32 rounding of a layer's
    input can put a value on the other side of a rounding boundary, as the
    CPU test found; the scales within KFAC_REL_TOL), the dense f32 cache
    within ROUTE_REL_TOL; and its logits within MOE_OWN_LOGIT_REL_TOL.
    mixtral's window 16 gives the fp8 e4m3 ring, which the 64 + 4
    positions wrap; qwen2_moe's 0 the dense f32 cache."""
    from repro_torch.serve import ServeConfig
    batch = _dense_batch(torch, cfg, 2, 64, index=5)
    batch.pop("labels")
    kern_s, ref_s = ServeConfig(), ServeConfig(backend="ref")
    ring = cfg.sliding_window > 0
    res = {"shared": 0.0, "own": 0.0, "flips": 0, "codes": 0,
           "cache_err": 0.0}

    def held(cache, own):
        """The kernel arm's cache writes against the own ref arm's."""
        check(bool(torch.equal(cache["len"], own["len"])),
              f"{cfg.name} cache len")
        for key in ("k", "v"):
            if ring:
                d = (_fp8_ordinal(torch, cache[key])
                     - _fp8_ordinal(torch, own[key])).abs()
                check(int(d.max()) <= 1, f"{cfg.name} cache {key}: a code "
                      f"{int(d.max())} e4m3 steps from the ref arm's")
                res["flips"] += int((d > 0).sum())
                res["codes"] += d.numel()
                err = _rel_err(torch, cache[key + "_scale"],
                               own[key + "_scale"])
                check(err <= KFAC_REL_TOL,
                      f"{cfg.name} cache {key}_scale: {err}")
            else:
                err = _rel_err(torch, cache[key], own[key])
                check(err <= ROUTE_REL_TOL, f"{cfg.name} cache {key}: {err}")
            res["cache_err"] = max(res["cache_err"], err)

    with torch.no_grad():
        lk, cache = model.prefill(batch, 68, serve=kern_s)
        lr, own = model.prefill(batch, 68, serve=ref_s)
        held(cache, own)
        triples = [(lk[:, -1], lr[:, -1], lr[:, -1])]
        tok = lr[:, -1].argmax(-1)
        for _ in range(4):
            rcache = {k: v.clone() for k, v in cache.items()}
            ls, _ = model.decode_step(rcache, tok, serve=ref_s)
            lo, own = model.decode_step(own, tok, serve=ref_s)
            lk, cache = model.decode_step(cache, tok, serve=kern_s)
            held(cache, own)
            triples.append((lk, ls, lo))
            tok = lo.argmax(-1)
    check(ring == (cache["k"].dtype == torch.float8_e4m3fn),
          f"{cfg.name} serve cache {cache['k'].dtype}")
    for got, shared, mine in triples:
        check(bool(torch.isfinite(got).all()), f"{cfg.name} serving logits")
        res["shared"] = max(res["shared"], _rel_err(torch, got, shared))
        res["own"] = max(res["own"], _rel_err(torch, got, mine))
    check(res["shared"] <= F32_LOGIT_REL_TOL,
          f"{cfg.name} serving logits kernels vs ref: {res['shared']}")
    check(res["flips"] <= MOE_CODE_FLIP_FRAC * res["codes"],
          f"{cfg.name} cache: {res['flips']} of {res['codes']} codes one "
          f"e4m3 step off")
    check(res["own"] <= MOE_OWN_LOGIT_REL_TOL,
          f"{cfg.name} serving logits kernels vs ref on its own cache: "
          f"{res['own']}")
    return res


def check_moe_routes(torch) -> None:
    """Each MoE config at its route size (MOE_ROUTES: reduced, f32), batch
    (2, 512): for Stage 4 by eigh and by Newton-Schulz, a capture step
    (every statistic refreshed) and a fast step from the seed-0 model on
    the kernels; before each, a second optimizer with backend="ref" takes
    the kernel run's params and state as they stand and runs the same
    step. Losses, preconditioners and params after each step within
    ROUTE_REL_TOL; every router call's indices equal in both arms; the
    expert sites' factor sums and preconditioning one launch a call over
    all experts. Then the kernel model serves (_moe_serve). Last,
    mixtral's attention at its own widths (MIXTRAL_ATTN: BKV 8, G 6, hd
    128, S 8192, window 4096, bf16) through swa_flash_fwd and the backward
    pair against the plain versions (one KV head at a time)."""
    from repro_torch.configs import get_config
    from repro_torch.core.fisher import flatten
    from repro_torch.kernels import ref, swa_attention
    from repro_torch.launch import train
    lam, lr = TRAIN["damping"], TRAIN["lr"]
    for arch, over in MOE_ROUTES.items():
        cfg = get_config(arch).reduced(**over)
        for method in ("eigh", "newton_schulz"):
            runs = {b: train.build(cfg=cfg, backend=b, device="cuda",
                                   inverse_method=method)
                    for b in ("auto", "ref")}
            steps = {b: (train.make_train_step(m, o),
                         train.make_fast_step(m, o))
                     for b, (m, o, _, _) in runs.items()}
            _, kopt, kparams, kstate = runs["auto"]
            rparams = runs["ref"][2]
            flags = {k: True for k in kopt.stat_names()}
            worst, losses, n_routes = {}, [], 0
            lead_calls = []          # (kernel, lead) of every expert call
            for i, kind in enumerate(("capture", "fast")):
                batch = _dense_batch(torch, cfg, 2, 512, index=i)
                with torch.no_grad():
                    for k, v in flatten(kparams).items():
                        flatten(rparams)[k].copy_(v)
                rstate = {**kstate, "velocity": {
                    k: v.clone() for k, v in kstate["velocity"].items()}}
                got, routes = {}, {}
                for b, params, state in (("ref", rparams, rstate),
                                         ("auto", kparams, kstate)):
                    capture, fast = steps[b]
                    spied = (_expert_launches() if b == "auto"
                             else contextlib.nullcontext([]))
                    with spied as calls, _routes_recorded() as rec:
                        if kind == "capture":
                            params, state, m = capture(
                                params, state, batch, flags, lam, lr, 0.9)
                        else:
                            params, state, m = fast(params, state, batch,
                                                    lam, lr, 0.9)
                    lead_calls += calls
                    routes[b] = rec
                    got[b] = (float(m["loss"]), {
                        f"{fam}.{k}": v.clone() for fam, c in
                        state["curv"].items()
                        for k, v in c["precond"].items()})
                    if b == "auto":
                        kparams, kstate = params, state
                (lk, pk), (lr_, pr) = got["auto"], got["ref"]
                losses.append((lk, lr_))
                check(len(routes["auto"]) == len(routes["ref"])
                      == cfg.n_layers
                      and all(torch.equal(a, r) for a, r in
                              zip(routes["auto"], routes["ref"])),
                      f"{arch} {method} {kind}: routing differs between "
                      f"the kernels and ref")
                n_routes += len(routes["auto"])
                check(abs(lk - lr_) <= ROUTE_REL_TOL * abs(lr_),
                      f"{arch} {method} {kind} loss {lk} vs ref {lr_}")
                worst[kind, "precond"] = max(_rel_err(torch, pk[n], pr[n])
                                             for n in pr)
                rflat = flatten(rparams)
                worst[kind, "params"] = max(
                    _rel_err(torch, v, rflat[n])
                    for n, v in flatten(kparams).items())
                for what in ("precond", "params"):
                    check(worst[kind, what] <= ROUTE_REL_TOL,
                          f"{arch} {method} {kind} step {what} rel err "
                          f"{worst[kind, what]} > {ROUTE_REL_TOL}")
                del got, rstate, pk, pr
            e = cfg.n_experts
            # a capture: A and G of 3 expert sites a layer; every step: 2
            # sides of 3 expert sites a layer; each call all E experts
            seen = _check_expert_launches(
                lead_calls, {"factor_syrk": 6 * cfg.n_layers,
                             "block_precond": 2 * 6 * cfg.n_layers}, e,
                f"{arch} {method}")
            say("moe-route", f"{arch} reduced, {e} experts top-{cfg.top_k}"
                             f" (+{cfg.n_shared_experts} shared), "
                             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of hd "
                             f"{cfg.hd}, d {cfg.d_model}, d_ff {cfg.d_ff}, "
                             f"{cfg.n_layers} layers, f32, batch (2, 512), "
                             f"Stage 4 {method}: losses (kernels, ref) "
                             f"{losses}; worst max|err|/max, capture step: "
                             f"preconditioners "
                             f"{worst['capture', 'precond']:.3e}, params "
                             f"{worst['capture', 'params']:.3e}; fast step: "
                             f"params {worst['fast', 'params']:.3e} (tol "
                             f"{ROUTE_REL_TOL}); routing equal in both arms "
                             f"({n_routes} router calls); expert-axis "
                             f"launches {seen}, each over all {e} experts")
            if method == "eigh":
                kmodel = runs["auto"][0]
                swa_attention.reset_launches()
                sv = _moe_serve(torch, kmodel, cfg)
                dec = swa_attention.LAUNCHES["swa_flash_decode"]
                check(dec == 4 * cfg.n_layers,
                      f"{arch}: decode launches {dec}")
                where = (f"fp8 e4m3 ring of {cfg.sliding_window} slots"
                         if cfg.sliding_window else "dense f32 cache")
                writes = (f"{sv['flips']} of {sv['codes']} codes one e4m3 "
                          f"step off (at most {MOE_CODE_FLIP_FRAC:g}), "
                          f"scales {sv['cache_err']:.3e} (tol "
                          f"{KFAC_REL_TOL})" if cfg.sliding_window else
                          f"{sv['cache_err']:.3e} (tol {ROUTE_REL_TOL})")
                say("moe-route", f"{arch} serving 2 lanes on the {where}, "
                                 f"prefill of 64 and 4 decode steps, kernels "
                                 f"vs ref, max|err| / max|logit|: from the "
                                 f"same cache {sv['shared']:.3e} (tol "
                                 f"{F32_LOGIT_REL_TOL}), ref on its own "
                                 f"cache {sv['own']:.3e} (tol "
                                 f"{MOE_OWN_LOGIT_REL_TOL}); the kernel "
                                 f"arm's cache writes vs the own arm's: "
                                 f"{writes}; decode launches {dec}")
                del kmodel
            del runs, steps, kopt, kparams, kstate, rparams
            torch.cuda.empty_cache()

    # mixtral's attention at its own widths, bf16
    a = MIXTRAL_ATTN
    gen = torch.Generator(device="cuda").manual_seed(2808)
    bf16 = torch.bfloat16
    q = torch.randn((a["kv"], a["g"], a["seq"], a["hd"]), generator=gen,
                    device="cuda").to(bf16)
    k, v = (torch.randn((a["kv"], a["seq"], a["hd"]), generator=gen,
                        device="cuda").to(bf16) for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
    out, lse = swa_attention.swa_flash_fwd(q, k, v, window=a["window"])
    ro, rl = _fwd_ref_by_kv(torch, ref, q, k, v, a["window"])
    torch.testing.assert_close(out.float(), ro.float(), **FWD_TOL)
    torch.testing.assert_close(lse, rl, **LSE_TOL)
    grads = swa_attention.swa_flash_bwd(q, k, v, ro, rl, do,
                                        window=a["window"])
    want = _bwd_ref_by_kv(torch, ref, q, k, v, ro, rl, do, a["window"])
    rel = [_rel_err(torch, x, y) for x, y in zip(grads, want)]
    check(max(rel) <= BWD_REL_TOL, f"mixtral attention bwd rel errs {rel}")
    say("moe-route", f"mixtral attention BKV={a['kv']} G={a['g']} "
                     f"S={a['seq']} hd={a['hd']} window={a['window']} bf16: "
                     f"swa_flash_fwd max|out err| "
                     f"{_max_err(torch, out, ro):.3e} (tol {FWD_TOL}), "
                     f"max|lse err| {_max_err(torch, lse, rl):.3e}; bwd "
                     f"max|err|/max|grad| dq {rel[0]:.3e} dk {rel[1]:.3e} "
                     f"dv {rel[2]:.3e} (tol {BWD_REL_TOL})")
    del q, k, v, do, out, lse, ro, rl, grads, want
    torch.cuda.empty_cache()


# qwen2_moe_a2_7b at full width (d 2048, 16/16 heads of hd 128, 60 routed
# experts of d_ff 1408 with top-4, 4 shared (one MLP of 5632), vocab
# 151936, bf16, remat), depth cut: by count a layer holds 570.5 M
# parameters (params, grads and velocity 3.42 GB as bf16) and 4.78 GB of
# factors a copy (4.45 GB of it the experts': A and G of 60 experts at b
# 2048 and 1408 for each of 3 sites), about 5 copies at a capture step's
# peak; the embedding and head hold 3.73 GB, the f32 logits 2.49 GB. So 2
# layers, under 70 GiB. One step is batch 4 x seq 1024 = 4,096 positions
# (capacity 341 of each expert's 1.25 x 4096 x 4 / 60 assignments); lr and
# damping those of llava_path, under which its random-weight model trains
MOE_PATH = dict(layers=2, batch=4, seq=1024, capture=2, fast=4, lr=2e-3,
                damping=1e-3)
MOE_SERVE = dict(lanes=4, prompts=(64, 512), decode=16)
MOE_KERNELS = ("factor_syrk", "block_precond")


def _moe_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2_moe_a2_7b"),
                               n_layers=MOE_PATH["layers"])


def moe_path(torch) -> dict:
    """qwen2_moe_a2_7b at full width (MOE_PATH: 2 layers), random weights
    from seed 0: SP-NGD with Stage 4 by Newton-Schulz, 2 capture steps
    (every statistic refreshed) and 4 fast steps (the first a warm-up) on
    batch 4 x 1024 of the trainer's stream; the fast step profiled and
    split by SP-NGD stage; momentum SGD on the same model and the fast
    steps' batches (1 warm-up + 3 timed); then serving through
    DecoderLM.prefill / decode_step on the dense f32 cache: 4 lanes of a
    64- and a 512-token prompt, 16 decode steps (capacity 1 at 4 lanes).
    Checks: finite losses and logits; every factor sum and preconditioning
    of an expert site one launch over all 60 experts (6 a layer a capture,
    6 a layer a step); no ref dispatch; every NS block converged or
    re-solved by eigh as counted; the peak under 70 GiB. Returns the
    path's launches of MOE_KERNELS."""
    import math
    from repro_torch.kernels import dispatch, swa_attention
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.launch import train
    from repro_torch.optim import SGD
    from repro_torch.serve import ServeConfig
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = _moe_cfg()
    spec = MOE_PATH
    model, opt, params, state = train.build(
        cfg=cfg, device="cuda", inverse_method="newton_schulz",
        damping=spec["damping"])
    n_params = sum(p.numel() for p in model.parameters())
    e = cfg.n_experts
    say("moe-path", f"qwen2_moe_a2_7b full width, {cfg.n_layers} layers "
                    f"(depth cut), d {cfg.d_model}, {cfg.n_heads}/"
                    f"{cfg.n_kv_heads} heads of hd {cfg.hd}, {e} experts of "
                    f"d_ff {cfg.d_ff} top-{cfg.top_k} + "
                    f"{cfg.n_shared_experts} shared, vocab {cfg.vocab}, "
                    f"{cfg.dtype}, remat {cfg.remat}: {n_params} params, "
                    f"{len(opt.stat_names())} statistics, "
                    f"{sum(opt.stat_bytes().values())} B of statistics a "
                    f"copy, sym-packed")
    calls = []                 # (b, trips) of every Newton-Schulz call
    inner_ns = ns.ns_inverse

    def spy_ns(m, iters, tol):
        out = inner_ns(m, iters, tol)
        calls.append((m.shape[-1], out[2].cpu()))
        return out
    batches = [_train_batch(torch, cfg.vocab, spec["batch"], spec["seq"],
                            index=i)
               for i in range(spec["capture"] + spec["fast"])]
    capture = train.make_train_step(model, opt)
    fast = train.make_fast_step(model, opt)
    flags = {k: True for k in opt.stat_names()}
    lam, lr, mom = spec["damping"], spec["lr"], 0.9
    swa_attention.reset_launches()
    kern.reset_launches()
    ns.reset_launches()
    dispatch.reset_calls()
    recs = []
    ns.ns_inverse = spy_ns
    try:
        with _Stage4Timer(torch) as s4, _expert_launches() as lead_calls:
            for i, batch in enumerate(batches):
                kind = "capture" if i < spec["capture"] else "fast"
                torch.cuda.synchronize()
                t = time.perf_counter()
                if kind == "capture":
                    params, state, m = capture(params, state, batch, flags,
                                               lam, lr, mom)
                else:
                    params, state, m = fast(params, state, batch, lam, lr,
                                            mom)
                loss = float(m["loss"])
                torch.cuda.synchronize()
                recs.append({"kind": kind, "loss": loss,
                             "aux": float(m.get("aux_loss", float("nan"))),
                             "seconds": time.perf_counter() - t,
                             "inverse": m.get("inverse_info", {})})
    finally:
        ns.ns_inverse = inner_ns
    peak = torch.cuda.max_memory_allocated()
    launches = {k: kern.LAUNCHES[k] for k in MOE_KERNELS}
    dcalls = dict(dispatch.CALLS)
    check(all(math.isfinite(r["loss"]) for r in recs),
          f"qwen2_moe losses {[r['loss'] for r in recs]}")
    check(not any(b == "ref" for (_, b) in dcalls),
          f"ref dispatches: {dcalls}")
    check(peak < 70 * 2 ** 30, f"qwen2_moe peak {peak / 2 ** 30:.2f} GiB >= "
                               f"70")
    n_cap = spec["capture"]
    seen = _check_expert_launches(
        lead_calls, {"factor_syrk": 6 * cfg.n_layers * n_cap,
                     "block_precond": 6 * cfg.n_layers * len(recs)}, e,
        "qwen2_moe")
    cap = [r for r in recs if r["kind"] == "capture"]
    infos = [i for r in cap for i in r["inverse"].values()]
    check(len(calls) == len(infos), f"NS calls {len(calls)} vs blocked "
                                    f"statistics {len(infos)}")
    trips = [x for _, t in calls for x in t.tolist()]
    fell = sum(int((~i["ns_converged"]).sum()) for i in infos)
    by_b: dict = {}
    for b, t in calls:
        by_b[b] = by_b.get(b, 0) + t.numel()
    cap_s = [r["seconds"] for r in cap]
    fast_all = [r["seconds"] for r in recs if r["kind"] == "fast"]
    fast_med = statistics.median(fast_all[1:])
    tokens = spec["batch"] * spec["seq"]
    say("moe-path", f"Newton-Schulz: {n_cap} capture + {spec['fast']} fast "
                    f"steps at lr {lr}, damping {lam}: losses "
                    f"{[round(r['loss'], 6) for r in recs]} (aux "
                    f"{[round(r['aux'], 4) for r in recs]}); capture walls "
                    f"{[round(x, 3) for x in cap_s]} s, fast walls "
                    f"{[round(x, 4) for x in fast_all]} s (the first a "
                    f"warm-up; median {fast_med:.4f} s, "
                    f"{tokens / fast_med:.1f} tokens/s); Stage 4 "
                    f"{s4.seconds:.3f} s over {len(cap)} refreshes "
                    f"({s4.seconds / len(cap):.3f} s a refresh, {s4.blocks} "
                    f"blocks); NS blocks by size {by_b}, trips min "
                    f"{min(trips)} median {statistics.median(trips)} max "
                    f"{max(trips)}, eigh fallback {fell} of {len(trips)} "
                    f"blocks; peak memory {peak / 2 ** 30:.2f} GiB; "
                    f"launches {launches}, of them with the expert axis "
                    f"{seen} (each over all {e} experts); "
                    f"{card_note(torch)}")

    box = {"p": params, "s": state}
    pb = batches[-1]

    def fast_step():
        box["p"], box["s"], _ = fast(box["p"], box["s"], pb, lam, lr, mom)
    _profile(torch, "qwen2_moe fast step (4096 tokens)", fast_step,
             warm=False, split=True)
    params = box["p"]
    del box, state, opt, capture, fast, m
    torch.cuda.empty_cache()

    sgd = SGD(model.loss)
    sstate = sgd.init(params)
    sgd_s, sgd_l = [], []
    for batch in batches[n_cap:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, sstate, m = sgd.step(params, sstate, batch, lr, mom)
        sgd_l.append(float(m["loss"]))
        torch.cuda.synchronize()
        sgd_s.append(time.perf_counter() - t)
    check(all(math.isfinite(x) for x in sgd_l),
          f"qwen2_moe SGD losses {sgd_l}")
    sgd_med = statistics.median(sgd_s[1:])
    say("moe-path", f"momentum SGD on the same model and the fast steps' "
                    f"batches: losses {[round(x, 6) for x in sgd_l]}, walls "
                    f"{[round(x, 4) for x in sgd_s]} s (the first a warm-up;"
                    f" median {sgd_med:.4f} s); the NS fast step median "
                    f"{fast_med:.4f} s = {fast_med / sgd_med:.3f} x SGD's; "
                    f"{card_note(torch)}")
    del sgd, sstate
    torch.cuda.empty_cache()

    serve = ServeConfig()                   # window 0 -> the dense f32 cache
    lanes, steps_d = MOE_SERVE["lanes"], MOE_SERVE["decode"]
    max_len = max(MOE_SERVE["prompts"]) + steps_d
    gen = torch.Generator(device="cuda").manual_seed(0)
    swa_attention.reset_launches()
    dispatch.reset_calls()
    pre = {}
    with torch.no_grad():
        for plen in MOE_SERVE["prompts"]:
            req = {"tokens": torch.randint(0, cfg.vocab, (lanes, plen),
                                           generator=gen, device="cuda")}
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = model.prefill(req, max_len, serve=serve)
            torch.cuda.synchronize()
            pre[plen] = time.perf_counter() - t
            check(logits.shape == (lanes, plen, cfg.vocab)
                  and bool(torch.isfinite(logits[:, -1]).all()),
                  f"qwen2_moe prefill logits {tuple(logits.shape)}")
        check(cache["k"].dtype == torch.float32 and "k_scale" not in cache,
              "qwen2_moe serves on the dense f32 cache")
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps_d):
            out, cache = model.decode_step(cache, tok, serve=serve)
            tok = out.argmax(-1)
        torch.cuda.synchronize()
        dec = time.perf_counter() - t
        check(bool(torch.isfinite(out).all()), "qwen2_moe decode logits")
    slaunch = dict(swa_attention.LAUNCHES)
    check(slaunch["swa_flash_fwd"] == cfg.n_layers * len(pre)
          and slaunch["swa_flash_decode"] == cfg.n_layers * steps_d,
          f"qwen2_moe serving launches {slaunch}")
    check(not any(b == "ref" for (_, b) in dispatch.CALLS),
          f"ref dispatches: {dispatch.CALLS}")
    say("moe-path", f"serving {lanes} lanes, dense f32 cache of {max_len} "
                    f"slots: prefill "
                    + ", ".join(f"{p}-token prompts {pre[p]:.3f} s "
                                f"({lanes * p / pre[p]:.1f} tokens/s)"
                                for p in pre)
                    + f"; {steps_d} decode steps {dec:.3f} s "
                    f"({lanes * steps_d / dec:.1f} tokens/s; capacity "
                    f"{max(1, int(cfg.capacity_factor * lanes * cfg.top_k / e))} "
                    f"an expert a step); launches {slaunch}; "
                    f"{card_note(torch)}")
    del model, params, cache, logits, out
    torch.cuda.empty_cache()
    say("moe-path", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


# the MoE fused fp8 capture at full width: moe_path's model and batch with
# factor_wire e4m3 and Newton-Schulz; 2 capture + 2 fast steps on one batch
# at kfac_max_dim 2048 (every wire capture but the router's G over 1024:
# the factor_syrk + sym_pack + quant_rows route, the expert axis in each
# launch), then one capture step at 1024 (every block <= 1024: one
# factor_syrk_wire launch a statistic, the experts' over all 60)
MOE_WIRE_PATH = dict(capture=2, fast=2, max_dims=(2048, 1024))


@contextlib.contextmanager
def _wire_launches():
    """The leading shape of every factor_syrk_wire and factor_syrk call
    (spies on the wrappers the dispatch calls): yields [(kernel, lead)]."""
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import quant as qk
    calls, inner = [], (qk.factor_syrk_wire, kern.factor_syrk)

    def wire_spy(x, max_dim, fmt="e4m3", scale_mode="fp32"):
        calls.append(("factor_syrk_wire", tuple(x.shape[:-2])))
        return inner[0](x, max_dim, fmt, scale_mode)

    def syrk_spy(x, max_dim):
        calls.append(("factor_syrk", tuple(x.shape[:-2])))
        return inner[1](x, max_dim)
    qk.factor_syrk_wire, kern.factor_syrk = wire_spy, syrk_spy
    try:
        yield calls
    finally:
        qk.factor_syrk_wire, kern.factor_syrk = inner


def _wire_expected(opt, cfg) -> dict:
    """Per capture step, from the template: the wire captures by route
    (b <= FACTOR_WIRE_MAX_DIM: one factor_syrk_wire launch; above: one
    factor_syrk and one quant_rows), the expert sites' among them, the
    wire statistics (one fp8_unpack decode each), and the full-kind
    statistics captured dense (the embedding's G: one factor_syrk)."""
    from repro_torch.kernels import dispatch
    from repro_torch.quant import quant
    out = {"fused": 0, "unfused": 0, "expert": 0, "stats": 0, "dense": 0}
    for fam, stats in opt.fstats_fn().items():
        for key, leaf in stats.items():
            calls = cfg.n_layers if fam.startswith("blk/") else 1
            if not quant.is_wire(leaf):
                out["dense"] += calls if opt.sym_stat(fam, key) else 0
                continue
            b = quant.tri_rows(leaf["payload"].shape[-1])
            out["fused" if b <= dispatch.FACTOR_WIRE_MAX_DIM
                else "unfused"] += calls
            out["expert"] += calls if leaf["payload"].dim() == 4 else 0
            out["stats"] += 1
    return out


def moe_wire_path(torch) -> dict:
    """qwen2_moe_a2_7b at full width (MOE_PATH: 2 layers, batch 4 x 1024,
    random weights from seed 0) with the fused fp8 capture (factor_wire
    e4m3) and Stage 4 by Newton-Schulz (MOE_WIRE_PATH): at kfac_max_dim
    2048, 2 capture + 2 fast steps on one batch; then a fresh model at 1024
    and one capture step. Checks: finite losses, the last of the four below
    the first; every wire capture one factor_sum_wire dispatch on the card
    and the launches its route makes (_wire_expected), the experts' with
    the lead (60,) in each launch; every wire statistic decoded once (one
    fp8_unpack, one dequant_rows launch); no ref dispatch; the peak under
    70 GiB. Returns {"launches": {"factor_syrk_wire": the kernel's count
    over the 1024 step, set to 0 just before it}, "runs": ...}."""
    import dataclasses
    import math
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import quant as qk
    from repro_torch.launch import train
    spec = MOE_PATH
    batch = _train_batch(torch, _moe_cfg().vocab, spec["batch"], spec["seq"])
    lam, lr, mom = spec["damping"], spec["lr"], 0.9
    out = {}
    for max_dim in MOE_WIRE_PATH["max_dims"]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(_moe_cfg(), factor_wire="e4m3",
                                  kfac_max_dim=max_dim)
        model, opt, params, state = train.build(
            cfg=cfg, device="cuda", inverse_method="newton_schulz",
            damping=lam)
        want = _wire_expected(opt, cfg)
        capture = train.make_train_step(model, opt)
        fast = train.make_fast_step(model, opt)
        flags = {k: True for k in opt.stat_names()}
        n_cap = MOE_WIRE_PATH["capture"] if max_dim == 2048 else 1
        n_fast = MOE_WIRE_PATH["fast"] if max_dim == 2048 else 0
        kern.reset_launches()
        qk.reset_launches()
        dispatch.reset_calls()
        losses, walls = [], []
        with _wire_launches() as calls:
            for i in range(n_cap + n_fast):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if i < n_cap:
                    params, state, m = capture(params, state, batch, flags,
                                               lam, lr, mom)
                else:
                    params, state, m = fast(params, state, batch, lam, lr,
                                            mom)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        dcalls = dict(dispatch.CALLS)
        check(all(math.isfinite(x) for x in losses),
              f"moe wire path at {max_dim}: losses {losses}")
        check(not any(b == "ref" for (_, b) in dcalls),
              f"moe wire path at {max_dim}: ref dispatches {dcalls}")
        check(peak < 70 * 2 ** 30, f"moe wire path at {max_dim}: peak "
                                   f"{peak / 2 ** 30:.2f} GiB")
        got = {"factor_sum_wire": dcalls.get(("factor_sum_wire", "cuda"), 0),
               "fp8_unpack": dcalls.get(("fp8_unpack", "cuda"), 0),
               "factor_syrk_wire": qk.LAUNCHES["factor_syrk_wire"],
               "factor_syrk": kern.LAUNCHES["factor_syrk"],
               "quant_rows": qk.LAUNCHES["quant_rows"],
               "dequant_rows": qk.LAUNCHES["dequant_rows"]}
        exp = {"factor_sum_wire": n_cap * (want["fused"] + want["unfused"]),
               "fp8_unpack": n_cap * want["stats"],
               "factor_syrk_wire": n_cap * want["fused"],
               "factor_syrk": n_cap * (want["unfused"] + want["dense"]),
               "quant_rows": n_cap * want["unfused"],
               "dequant_rows": n_cap * want["stats"]}
        check(got == exp, f"moe wire path at {max_dim}: dispatches and "
                          f"launches {got}, want {exp}")
        e = cfg.n_experts
        expert = [c for c in calls if c[1] and c[1][0] == e]
        check(len(expert) == n_cap * want["expert"]
              and all(c[1] == (e,) for c in expert),
              f"moe wire path at {max_dim}: expert-axis launches "
              f"{len(expert)}, want {n_cap * want['expert']}")
        kind = {k for k, _ in expert}
        say("moe-wire-path", f"qwen2_moe_a2_7b full width, {cfg.n_layers} "
                             f"layers, factor_wire e4m3, kfac_max_dim "
                             f"{max_dim}, NS, lr {lr}, damping {lam}, one "
                             f"batch {spec['batch']} x {spec['seq']}: "
                             f"{n_cap} capture + {n_fast} fast steps, losses "
                             f"{[round(x, 6) for x in losses]}, walls "
                             f"{[round(x, 3) for x in walls]} s; dispatches "
                             f"and launches {got} (as the template has them); "
                             f"{len(expert)} of them over all {e} experts "
                             f"({sorted(kind)}); peak {peak / 2 ** 30:.2f} "
                             f"GiB; {card_note(torch)}")
        out[max_dim] = {"losses": losses, "walls": walls, "peak": peak,
                        "expert": len(expert),
                        "wire": got["factor_syrk_wire"]}
        del model, opt, params, state, capture, fast, m
    first = out[2048]["losses"]
    check(first[-1] < first[0], f"moe wire path: loss {first[0]} -> "
                                f"{first[-1]} does not fall")
    torch.cuda.empty_cache()
    return {"launches": {"factor_syrk_wire": out[1024]["wire"]},
            "runs": out}


# the launch layer's dry run (repro_torch.launch.dryrun) on meta: two cases
# at the production 16x16 mesh; llama3_2_1b at a 1x1 mesh and the training
# path's batch, held to the card's allocation of the same state
DRYRUN_CASES = (("llama3_2_1b", "train_4k"), ("qwen2_moe_a2_7b", "train_4k"))
DRYRUN_ARG_REL_TOL = 0.01


def dryrun_path(torch) -> None:
    """The dry run beside the card. DRYRUN_CASES on the 16x16 mesh (meta
    tensors, no card): status ok. llama3_2_1b train at a 1x1 mesh and
    TRAIN's batch (4 x 1024), Newton-Schulz: its argument bytes within
    DRYRUN_ARG_REL_TOL of torch.cuda.memory_allocated() once the same
    params, SP-NGD state and batch are built on the card (the state's
    expanded zero and identity entries materialized, as a step's inputs
    hold them after the first refreshes); then one capture step on the
    card, and the dry run's argument plus peak live bytes over the step's
    max_memory_allocated() printed without a bound (the meta run counts the
    plain attention, whose scores the kernels never materialize). Last,
    stage4_report on the card for llama3_2_1b's shardmap case (NS)."""
    import dataclasses
    from repro_torch.configs import InputShape
    from repro_torch.core.fisher import flatten, unflatten
    from repro_torch.launch import dryrun, train
    from repro_torch.launch import sharding as shd
    for arch, shape in DRYRUN_CASES:
        rec = dryrun.run_case(arch, shape, False)
        check(rec["status"] == "ok", f"dry run {arch} {shape}: "
                                     f"{rec.get('error')}")
        mem = rec["memory_analysis"]
        say("dryrun-path", f"{arch} {shape} at {rec['mesh']} on meta: "
                           f"{rec['label']}, {rec['n_params']} params, "
                           f"{rec['hlo_flops']:.4g} FLOPs, {rec['hlo_bytes']:.4g} "
                           f"B (unfused), model FLOPs {rec['model_flops']:.4g}, "
                           f"argument bytes a device "
                           f"{mem['argument_size_in_bytes']}, roofline "
                           f"compute {rec['compute_s']:.4g} s, memory "
                           f"{rec['memory_s']:.4g} s ({rec['bottleneck']}); "
                           f"counted in {rec['count_s']} s of "
                           f"{rec['wall_s']} s")
    shape = InputShape("train_path", TRAIN["seq"], TRAIN["batch"], "train")
    rec = dryrun.run_case("llama3_2_1b", "train_4k", mesh="1x1", shape=shape,
                          inverse_method="newton_schulz")
    check(rec["status"] == "ok", f"dry run at 1x1: {rec.get('error')}")
    args = rec["memory_analysis"]["argument_size_in_bytes"]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model, opt, params, state = train.build(
        "llama3_2_1b", full_config=True, device="cuda",
        inverse_method="newton_schulz")
    flat = flatten(state["curv"])
    # an expanded view (no memory of its own) becomes a tensor
    state["curv"] = unflatten({k: v.contiguous() for k, v in flat.items()},
                              state["curv"])
    del flat
    batch = _train_batch(torch, model.cfg.vocab, TRAIN["batch"],
                         TRAIN["seq"])
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - base
    rel = abs(args - alloc) / alloc
    check(rel <= DRYRUN_ARG_REL_TOL,
          f"dry run at 1x1: argument bytes {args} vs allocated {alloc} "
          f"(rel {rel:.4f} > {DRYRUN_ARG_REL_TOL})")
    torch.cuda.reset_peak_memory_stats()
    step = train.make_train_step(model, opt)
    flags = {k: True for k in opt.stat_names()}
    params, state, m = step(params, state, batch, flags, TRAIN["damping"],
                            TRAIN["lr"], 0.9)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    live = rec["peak_live_bytes"]
    say("dryrun-path", f"llama3_2_1b at 1x1, batch {TRAIN['batch']} x "
                       f"{TRAIN['seq']}, NS: argument bytes {args} (dry run) "
                       f"vs {alloc} allocated on the card for the same "
                       f"params, state and batch: rel {rel:.2e} (tol "
                       f"{DRYRUN_ARG_REL_TOL}); a capture step's peak {peak} "
                       f"B (loss {float(m['loss']):.6f}) vs the dry run's "
                       f"arguments + peak live {args + live} B: ratio "
                       f"{(args + live) / peak:.4f}, peak live alone "
                       f"{live} vs {peak - alloc} above the arguments: "
                       f"{live / (peak - alloc):.4f} (no bound); "
                       f"{card_note(torch)}")
    del model, opt, params, state, batch, m, step
    torch.cuda.empty_cache()
    case = dryrun.build_case("llama3_2_1b", "train_4k",
                             shd.make_mesh("16x16"), schedule="shardmap")
    t = time.perf_counter()
    rep = dryrun.stage4_report(case.reducer, False, "newton_schulz",
                               device="cuda")
    wall = time.perf_counter() - t
    check(rep["stats"] and all(v["us_per_layer"] > 0
                               for v in rep["stats"].values()),
          f"stage4_report on the card: {rep}")
    per = {k: round(v["us_per_layer"], 1) for k, v in rep["stats"].items()}
    say("dryrun-path", f"stage4_report (llama3_2_1b train_4k shardmap at "
                       f"16x16, NS, on {rep['device']}): us a layer by "
                       f"statistic {per}; replicated "
                       f"{sum(v['replicated_us_per_device'] for v in rep['stats'].values()):.1f}"
                       f" us a device, sharded "
                       f"{sum(v['sharded_us_per_device'] for v in rep['stats'].values()):.1f}"
                       f" us; {wall:.1f} s; {card_note(torch)}")
    del case
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the recurrent families (rwkv6_7b, hymba_1_5b) and the legacy serving path
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("rwkv6_7b", "hymba_1_5b")
# the recurrent route checks: reduced widths (f32, 2 layers), batch 2 x 64,
# a capture and two fast steps on the kernels against backend="ref" on the
# same card, losses, preconditioners and params within ROUTE_REL_TOL of the
# largest entry (rwkv's Newton-Schulz preconditioners sit 1.3e-5 from
# ref's: the iteration stops at its 1e-4 residual in either arm)
RECURRENT_ROUTE_BATCH = (2, 64)
# the legacy serving path (init_cache / prefill / decode_step, serve=None)
# of every block type, reduced and f32: a prompt, then decode steps past
# mixtral's reduced window of 16 (the decode-span clamp); the kernel arm's
# logits and caches within LEGACY_TOL of the ref arm's
LEGACY_ARCHS = ("rwkv6_7b", "hymba_1_5b", "llama3_2_1b", "mixtral_8x22b")
LEGACY_ROUTE = dict(lanes=2, prompt=64, decode=24)
LEGACY_TOL = 1e-4
# the full-width recurrent path. By count, rwkv6_7b's layer holds 218 M
# parameters (params, grads and momentum 1.75 GB) and 0.77 GB of factors a
# copy; its embedding and head 4.3 GB; the WKV loop's backward keeps three
# (4, 64, 64, 64) f32 tensors a token, 12.6 GB for one layer of 4,096
# positions under remat; hymba_1_5b's layer holds 48 M parameters. Both
# fit 4 layers (rwkv peaked at 30.45 GiB, hymba 8.84). The depth is cut by
# the phase's time instead: the scans are host-bound loops, ~1.6 s a layer
# a fast step at 4,096 positions, and 4 layers of both families took 585 s
# with 2 capture + 4 fast + 4 SGD steps each. So 2 layers. NS at the lr
# and damping of PRs 27-28's paths
RECURRENT_PATH = dict(layers=2, batch=4, seq=1024, capture=2, fast=4,
                      lr=2e-3, damping=1e-3, sgd=4)
RECURRENT_SERVE = dict(lanes=4, prompt=512, decode=32)
# hymba's attention at its own widths: 4 lanes x 5 KV heads, G 5 (its 25
# query heads), S 1024, hd 64
HYMBA_ATTN = dict(lanes=4, kv=5, g=5, seq=1024, hd=64)


def _legacy_serve(torch, kmodel, rmodel, spec) -> dict:
    """The legacy path in two arms with the same weights: ``kmodel`` on the
    kernels, ``rmodel`` with backend="ref"; a prompt of ``spec["prompt"]``
    tokens, then ``spec["decode"]`` decode steps fed the ref arm's argmax.
    After the prefill and after each step the kernel arm's logits and every
    cache leaf within LEGACY_TOL of the ref arm's, ``len`` equal. Returns
    the worst errors and the kernel arm's attention launches (prefill,
    decode)."""
    from repro_torch.kernels import swa_attention
    cfg = kmodel.cfg
    lanes, plen, steps = spec["lanes"], spec["prompt"], spec["decode"]
    gen = torch.Generator(device="cuda").manual_seed(29)
    toks = torch.randint(0, cfg.vocab, (lanes, plen), generator=gen,
                         device="cuda")
    res = {"logits": 0.0, "cache": 0.0}

    def held(lk, lr_, kc, rc, what):
        check(bool(torch.isfinite(lk).all()), f"{cfg.name} {what} logits")
        res["logits"] = max(res["logits"], _rel_err(torch, lk, lr_))
        check(set(kc) == set(rc) and torch.equal(kc["len"], rc["len"]),
              f"{cfg.name} {what}: cache keys or len")
        for key in rc:
            if key != "len":
                res["cache"] = max(res["cache"],
                                   _rel_err(torch, kc[key], rc[key]))

    swa_attention.reset_launches()
    with torch.no_grad():
        lk, kc = kmodel.prefill({"tokens": toks}, plen + steps)
        pre = dict(swa_attention.LAUNCHES)
        lr_, rc = rmodel.prefill({"tokens": toks}, plen + steps)
        held(lk, lr_, kc, rc, "prefill")
        tok = lr_[:, -1].argmax(-1)
        for i in range(steps):
            lk, kc = kmodel.decode_step(kc, tok)
            lr_, rc = rmodel.decode_step(rc, tok)
            held(lk, lr_, kc, rc, f"decode step {i}")
            tok = lr_.argmax(-1)
    dec = dict(swa_attention.LAUNCHES)
    check(int(kc["len"]) == plen + steps and kc["len"].dim() == 0,
          f"{cfg.name} legacy len {kc['len']}")
    for what in ("logits", "cache"):
        check(res[what] <= LEGACY_TOL, f"{cfg.name} legacy {what} kernels "
                                       f"vs ref: {res[what]}")
    res["launches"] = (pre["swa_flash_fwd"], dec["swa_flash_decode"])
    return res


def check_recurrent_routes(torch) -> None:
    """rwkv6_7b and hymba_1_5b reduced (f32, 2 layers), batch 2 x 64: for
    Stage 4 by eigh and by Newton-Schulz, a capture step (every statistic
    refreshed) and two fast steps from the seed-0 model on the kernels;
    before each, a second optimizer with backend="ref" takes the kernel
    run's params and state as they stand and runs the same step. Losses,
    preconditioners and params after each within ROUTE_REL_TOL; the
    factor-sum kernel launched on the capture step and block_precond on
    every step, hymba's three training attention kernels on every step.
    Then the legacy serving path of rwkv6_7b, hymba_1_5b, llama3_2_1b and
    mixtral_8x22b (_legacy_serve, LEGACY_ROUTE), the kernel arm against
    the ref arm, swa_flash_fwd once a layer on the prefill and
    swa_flash_decode once a layer a decode step (the decode kernel on the
    legacy cache's span view, launched once a call, twice bit-identical,
    by _launched_once)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.fisher import flatten
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import swa_attention
    from repro_torch.launch import train
    from repro_torch.models.transformer import DecoderLM
    lam, lr = TRAIN["damping"], TRAIN["lr"]
    served = {}
    for arch in RECURRENT_ARCHS:
        cfg = get_config(arch).reduced()
        for method in ("eigh", "newton_schulz"):
            runs = {b: train.build(cfg=cfg, backend=b, device="cuda",
                                   inverse_method=method)
                    for b in ("auto", "ref")}
            steps = {b: (train.make_train_step(m, o),
                         train.make_fast_step(m, o))
                     for b, (m, o, _, _) in runs.items()}
            kmodel, kopt, kparams, kstate = runs["auto"]
            rparams = runs["ref"][2]
            flags = {k: True for k in kopt.stat_names()}
            worst, losses, launched = {}, [], []
            for i, kind in enumerate(("capture", "fast", "fast")):
                batch = _dense_batch(torch, cfg, *RECURRENT_ROUTE_BATCH,
                                     index=i)
                with torch.no_grad():
                    for k, v in flatten(kparams).items():
                        flatten(rparams)[k].copy_(v)
                rstate = {**kstate, "velocity": {
                    k: v.clone() for k, v in kstate["velocity"].items()}}
                got = {}
                for b, params, state in (("ref", rparams, rstate),
                                         ("auto", kparams, kstate)):
                    capture, fast = steps[b]
                    kern.reset_launches()
                    swa_attention.reset_launches()
                    if kind == "capture":
                        params, state, m = capture(params, state, batch,
                                                   flags, lam, lr, 0.9)
                    else:
                        params, state, m = fast(params, state, batch, lam,
                                                lr, 0.9)
                    got[b] = (float(m["loss"]), {
                        f"{fam}.{k}": v.clone() for fam, c in
                        state["curv"].items()
                        for k, v in c["precond"].items()})
                    if b == "auto":
                        kparams, kstate = params, state
                        launched.append({**kern.LAUNCHES,
                                         **swa_attention.LAUNCHES})
                (lk, pk), (lr_, pr) = got["auto"], got["ref"]
                losses.append((lk, lr_))
                check(abs(lk - lr_) <= ROUTE_REL_TOL * abs(lr_),
                      f"{arch} {method} {kind} {i} loss {lk} vs ref {lr_}")
                w_pre = max(_rel_err(torch, pk[n], pr[n]) for n in pr)
                rflat = flatten(rparams)
                w_par = max(_rel_err(torch, v, rflat[n])
                            for n, v in flatten(kparams).items())
                worst[f"{kind} {i}"] = (w_pre, w_par)
                check(max(w_pre, w_par) <= ROUTE_REL_TOL,
                      f"{arch} {method} {kind} step {i}: preconditioners "
                      f"{w_pre}, params {w_par} > {ROUTE_REL_TOL}")
                del got, rstate, pk, pr
            attn = ("swa_flash_fwd", "swa_flash_bwd_dq", "swa_flash_bwd_dkdv")
            for i, n in enumerate(launched):
                check((n["factor_syrk"] > 0) == (i == 0)
                      and n["block_precond"] > 0
                      and all((n[a] > 0) == (arch == "hymba_1_5b")
                              for a in attn),
                      f"{arch} {method} step {i} launches {n}")
            say("recurrent-route",
                f"{arch} reduced, d {cfg.d_model}, {cfg.n_heads}/"
                f"{cfg.n_kv_heads} heads of hd {cfg.hd}, d_ff {cfg.d_ff}, "
                f"ssm_state {cfg.ssm_state}, {cfg.n_layers} layers, f32, "
                f"batch {RECURRENT_ROUTE_BATCH}, Stage 4 {method}: losses "
                f"(kernels, ref) {losses}; worst max|err|/max "
                f"(preconditioners, params) "
                + ", ".join(f"{k} ({a:.3e}, {b:.3e})"
                            for k, (a, b) in worst.items())
                + f" (tol {ROUTE_REL_TOL}); kernel launches by step "
                + str([{k: v for k, v in n.items() if v} for n in launched]))
            if method == "eigh":
                served[arch] = kmodel
            del runs, steps, kopt, kparams, kstate, rparams
            torch.cuda.empty_cache()
    for arch in LEGACY_ARCHS[2:]:
        served[arch] = train.build(cfg=get_config(arch).reduced(),
                                   device="cuda")[0]
    for arch in LEGACY_ARCHS:
        kmodel = served.pop(arch)
        cfg = kmodel.cfg
        rmodel = DecoderLM(dataclasses.replace(cfg, backend="ref"),
                           device="cuda")
        rmodel.load_state_dict(kmodel.state_dict())
        sv = _legacy_serve(torch, kmodel, rmodel, LEGACY_ROUTE)
        n, steps_d = cfg.n_layers, LEGACY_ROUTE["decode"]
        want = (0, 0) if cfg.block_type == "rwkv" else (n, n * steps_d)
        check(sv["launches"] == want,
              f"{arch} legacy launches (swa_flash_fwd on the prefill, "
              f"swa_flash_decode on the steps) {sv['launches']}, want {want}")
        win, m = cfg.sliding_window, LEGACY_ROUTE["prompt"] + steps_d
        span = (f"the clamped span of {win} slots" if 0 < win < m else
                f"the whole cache of {m} slots" if cfg.block_type != "rwkv"
                else "no attention: the WKV state and token shifts")
        say("recurrent-route",
            f"{arch} legacy serving (serve=None), reduced f32, "
            f"{LEGACY_ROUTE['lanes']} lanes, prompt {LEGACY_ROUTE['prompt']}, "
            f"{steps_d} decode steps over {span}: kernels vs ref max|err| / "
            f"max, logits {sv['logits']:.3e}, caches {sv['cache']:.3e} (tol "
            f"{LEGACY_TOL}); launches (swa_flash_fwd, swa_flash_decode) "
            f"{sv['launches']}")
        del kmodel, rmodel
        torch.cuda.empty_cache()
    # the decode kernel on a legacy cache's span view, as the path calls it
    gen = torch.Generator(device="cuda").manual_seed(291)
    b, m, kv, g, hd = 2, 88, 1, 4, 64
    ck, cv = (torch.randn((b, m, kv, hd), generator=gen, device="cuda")
              for _ in range(2))
    q = torch.randn((b * kv, g, hd), generator=gen, device="cuda")
    start, n = 72, 87                         # window 16, len 87: clamped
    pos = torch.full((b * kv,), n - start, dtype=torch.int32, device="cuda")
    kview = ck[:, start:start + 16].permute(0, 2, 1, 3)
    vview = cv[:, start:start + 16].permute(0, 2, 1, 3)
    got, same = _launched_once(
        torch, lambda: swa_attention.swa_flash_decode(q, kview, vview, pos),
        "swa_flash_decode", swa_attention.LAUNCHES)
    from repro_torch.kernels import ref
    want = ref.swa_decode_ref(q, kview.reshape(b * kv, 16, hd),
                              vview.reshape(b * kv, 16, hd), pos)
    err = _max_err(torch, got, want)
    check(same and err <= DEC_TOL["atol"] + DEC_TOL["rtol"] * float(
        want.abs().max()), f"swa_flash_decode on a span view: {err}")
    say("recurrent-route", f"swa_flash_decode on the legacy cache's span "
                           f"view (B 2, slots {start}..{start + 15} of {m}, "
                           f"pos {n - start}): max|err| {err:.3e}, one launch "
                           f"a call, two bit-identical")
    del ck, cv, q, kview, vview, got, want


def _busy(torch, fn) -> tuple:
    """(device-busy us, device events, wall us) of one call of ``fn``
    under torch.profiler (the raw kineto events, :func:`_kineto_device`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e6
    evts = _kineto_device(prof).values()
    return (sum(us for us, _ in evts), sum(n for _, n in evts), wall)


def _scan_cost(torch, arch, cfg, batch, seq) -> dict:
    """One layer's recurrent scan at the path's shapes, alone: its forward
    (no grad) and its forward + backward, each the device-busy us, device
    events (launches) and wall us. A remat'd layer runs the forward twice
    and the backward once a training step."""
    from repro_torch.models import rwkv, ssm
    gen = torch.Generator(device="cuda").manual_seed(292)

    def rand(*shape, lo=None):
        t = torch.randn(shape, generator=gen, device="cuda")
        if lo is not None:
            t = lo + 0.5 * torch.rand(shape, generator=gen, device="cuda")
        return t.requires_grad_()
    if arch == "rwkv6_7b":
        h, hd = cfg.d_model // cfg.hd, cfg.hd
        ins = [rand(batch, seq, h, hd) for _ in range(3)]
        ins += [rand(batch, seq, h, hd, lo=0.45), rand(h, hd)]
        st0 = torch.zeros((batch, h, hd, hd), device="cuda")

        def run():
            return rwkv._wkv_scan(*ins, st0)[1]
    else:
        di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
        ins = [rand(batch, seq, di), rand(batch, seq, di, lo=0.01),
               rand(batch, seq, n), rand(batch, seq, n), rand(di, n, lo=-1.0)]
        h0 = torch.zeros((batch, di, n), device="cuda")

        def run():
            return ssm._ssm_scan(*ins, h0)[1]

    def fwd():
        with torch.no_grad():
            run()

    def fwd_bwd():
        y = run()
        torch.autograd.grad(y.sum(), ins)
    out = {"fwd": _busy(torch, fwd), "fwd_bwd": _busy(torch, fwd_bwd)}
    del ins
    torch.cuda.empty_cache()
    return out


def _recurrent_cfg(arch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch),
                               n_layers=RECURRENT_PATH["layers"])


def recurrent_path(torch) -> dict:
    """rwkv6_7b and hymba_1_5b at full width (RECURRENT_PATH: 2 layers,
    bf16, remat), random weights from seed 0, one after the other: SP-NGD
    with Stage 4 by Newton-Schulz, 2 capture steps (every statistic
    refreshed) and 4 fast steps (the first a warm-up) on batch 4 x 1024 of
    the trainer's stream; the fast step profiled and split by SP-NGD stage
    (the scan's forward under its repro.scan range), and one layer's scan
    alone (forward, forward + backward: device time and launches);
    momentum SGD on the same model and the fast steps' batches (1 warm-up
    + 3 timed); then the legacy serving path at 4 lanes: a 512-token
    prompt, 32 decode steps. Checks: finite losses and logits; no ref
    dispatch; the kernels launched (hymba's attention kernels on every
    step and on serving); the peak under 70 GiB. Returns {arch:
    {"launches": {kernel: launches on the path}}}."""
    import math
    from repro_torch.kernels import dispatch, swa_attention
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.launch import train
    from repro_torch.optim import SGD
    spec = RECURRENT_PATH
    out = {}
    for arch in RECURRENT_ARCHS:
        t_phase = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = _recurrent_cfg(arch)
        model, opt, params, state = train.build(
            cfg=cfg, device="cuda", inverse_method="newton_schulz",
            damping=spec["damping"])
        n_params = sum(p.numel() for p in model.parameters())
        say("recurrent-path",
            f"{arch} full width, {cfg.n_layers} layers (depth cut), d "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of hd "
            f"{cfg.hd}, d_ff {cfg.d_ff}, ssm_state {cfg.ssm_state}, vocab "
            f"{cfg.vocab}, {cfg.dtype}, remat {cfg.remat}: {n_params} "
            f"params, {len(opt.stat_names())} statistics, "
            f"{sum(opt.stat_bytes().values())} B of statistics a copy, "
            f"sym-packed")
        batches = [_train_batch(torch, cfg.vocab, spec["batch"],
                                spec["seq"], index=i)
                   for i in range(spec["capture"] + spec["fast"])]
        capture = train.make_train_step(model, opt)
        fast = train.make_fast_step(model, opt)
        flags = {k: True for k in opt.stat_names()}
        lam, lr, mom = spec["damping"], spec["lr"], 0.9
        swa_attention.reset_launches()
        kern.reset_launches()
        ns.reset_launches()
        dispatch.reset_calls()
        recs = []
        with _Stage4Timer(torch) as s4:
            for i, batch in enumerate(batches):
                kind = "capture" if i < spec["capture"] else "fast"
                torch.cuda.synchronize()
                t = time.perf_counter()
                if kind == "capture":
                    params, state, m = capture(params, state, batch, flags,
                                               lam, lr, mom)
                else:
                    params, state, m = fast(params, state, batch, lam, lr,
                                            mom)
                loss = float(m["loss"])
                torch.cuda.synchronize()
                recs.append({"kind": kind, "loss": loss,
                             "seconds": time.perf_counter() - t})
        peak = torch.cuda.max_memory_allocated()
        launches = {**{k: kern.LAUNCHES[k] for k in MOE_KERNELS},
                    **{k: ns.LAUNCHES[k] for k in NS_KERNELS},
                    **{k: swa_attention.LAUNCHES[k] for k in ATTN_KERNELS}}
        dcalls = dict(dispatch.CALLS)
        check(all(math.isfinite(r["loss"]) for r in recs),
              f"{arch} losses {[r['loss'] for r in recs]}")
        check(not any(b == "ref" for (_, b) in dcalls),
              f"ref dispatches: {dcalls}")
        check(launches["factor_syrk"] > 0 and launches["block_precond"] > 0
              and all((launches[k] > 0) == (arch == "hymba_1_5b")
                      for k in ATTN_KERNELS),
              f"{arch} launches {launches}")
        check(peak < 70 * 2 ** 30, f"{arch} peak {peak / 2 ** 30:.2f} GiB "
                                   f">= 70")
        cap_s = [r["seconds"] for r in recs if r["kind"] == "capture"]
        fast_all = [r["seconds"] for r in recs if r["kind"] == "fast"]
        fast_med = statistics.median(fast_all[1:])
        tokens = spec["batch"] * spec["seq"]
        say("recurrent-path",
            f"{arch} Newton-Schulz: {spec['capture']} capture + "
            f"{spec['fast']} fast steps at lr {lr}, damping {lam}: losses "
            f"{[round(r['loss'], 6) for r in recs]}; capture walls "
            f"{[round(x, 3) for x in cap_s]} s, fast walls "
            f"{[round(x, 4) for x in fast_all]} s (the first a warm-up; "
            f"median {fast_med:.4f} s, {tokens / fast_med:.1f} tokens/s); "
            f"Stage 4 {s4.seconds:.3f} s over {len(cap_s)} refreshes "
            f"({s4.blocks} blocks); peak memory {peak / 2 ** 30:.2f} GiB; "
            f"launches {launches}; {card_note(torch)}")

        box = {"p": params, "s": state}
        pb = batches[-1]

        def fast_step():
            box["p"], box["s"], _ = fast(box["p"], box["s"], pb, lam, lr,
                                         mom)
        busy = _profile(torch, f"{arch} fast step ({tokens} tokens)",
                        fast_step, warm=False, split=True)
        params = box["p"]
        del box, state, opt, capture, fast, m
        torch.cuda.empty_cache()

        sgd = SGD(model.loss)
        sstate = sgd.init(params)
        sgd_s, sgd_l = [], []
        for batch in batches[:spec["sgd"]]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, sstate, m = sgd.step(params, sstate, batch, lr, mom)
            sgd_l.append(float(m["loss"]))
            torch.cuda.synchronize()
            sgd_s.append(time.perf_counter() - t)
        check(all(math.isfinite(x) for x in sgd_l),
              f"{arch} SGD losses {sgd_l}")
        sgd_med = statistics.median(sgd_s[1:])
        say("recurrent-path",
            f"{arch} momentum SGD on the same model: losses "
            f"{[round(x, 6) for x in sgd_l]}, walls "
            f"{[round(x, 4) for x in sgd_s]} s (the first a warm-up; median "
            f"{sgd_med:.4f} s, {tokens / sgd_med:.1f} tokens/s); the NS fast "
            f"step median {fast_med:.4f} s = {fast_med / sgd_med:.3f} x "
            f"SGD's; {card_note(torch)}")
        del sgd, sstate
        torch.cuda.empty_cache()

        sv = RECURRENT_SERVE
        lanes, steps_d = sv["lanes"], sv["decode"]
        gen = torch.Generator(device="cuda").manual_seed(0)
        req = {"tokens": torch.randint(0, cfg.vocab, (lanes, sv["prompt"]),
                                       generator=gen, device="cuda")}
        swa_attention.reset_launches()
        dispatch.reset_calls()
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = model.prefill(req, sv["prompt"] + steps_d)
            torch.cuda.synchronize()
            pre = time.perf_counter() - t
            check(bool(torch.isfinite(logits[:, -1]).all()),
                  f"{arch} prefill logits")
            tok = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps_d):
                lg, cache = model.decode_step(cache, tok)
                tok = lg.argmax(-1)
            torch.cuda.synchronize()
            dec = time.perf_counter() - t
            check(bool(torch.isfinite(lg).all()), f"{arch} decode logits")
        slaunch = dict(swa_attention.LAUNCHES)
        want = ((0, 0) if arch == "rwkv6_7b"
                else (cfg.n_layers, cfg.n_layers * steps_d))
        check((slaunch["swa_flash_fwd"], slaunch["swa_flash_decode"]) == want
              and not any(b == "ref" for (_, b) in dispatch.CALLS),
              f"{arch} serving launches {slaunch}, calls {dispatch.CALLS}")
        launches["swa_flash_decode"] = slaunch["swa_flash_decode"]
        cache_b = sum(v.numel() * v.element_size() for v in cache.values())
        say("recurrent-path",
            f"{arch} legacy serving {lanes} lanes, cache of "
            f"{sv['prompt'] + steps_d} positions ({cache_b} B, "
            f"{sorted(k for k in cache if k != 'len')}): prefill of "
            f"{sv['prompt']} tokens {pre:.3f} s ({lanes * sv['prompt'] / pre:.1f}"
            f" tokens/s); {steps_d} decode steps {dec:.3f} s "
            f"({lanes * steps_d / dec:.1f} tokens/s); launches "
            f"{ {k: v for k, v in slaunch.items() if v} }; "
            f"{card_note(torch)}")
        del model, params, cache, logits, lg
        torch.cuda.empty_cache()

        sc = _scan_cost(torch, arch, cfg, spec["batch"], spec["seq"])
        (f_us, f_n, f_wall), (b_us, b_n, b_wall) = sc["fwd"], sc["fwd_bwd"]
        step_us = cfg.n_layers * (f_us + b_us)
        share = f"{step_us / busy:.3f}" if busy else "not measured"
        say("recurrent-path",
            f"{arch} the {'WKV' if arch == 'rwkv6_7b' else 'SSM'} scan alone, "
            f"one layer at ({spec['batch']}, {spec['seq']}): forward "
            f"{f_us:.0f} us of device work in {f_n} launches (wall "
            f"{f_wall:.0f} us); forward + backward {b_us:.0f} us in {b_n} "
            f"launches (wall {b_wall:.0f} us); a remat'd training step runs "
            f"{cfg.n_layers} x (forward + forward + backward) = "
            f"{step_us:.0f} us, {share} of the fast step's device-busy "
            f"time, {cfg.n_layers * (f_n + b_n)} launches; "
            f"{card_note(torch)}")
        say("recurrent-path", f"{arch} phase "
                              f"{time.perf_counter() - t_phase:.1f} s")
        out[arch] = {"launches": launches}
    return out


def _attn_rows(torch, spec, gen) -> tuple:
    """swa_flash_fwd and the backward pair at ``spec`` (BKV = lanes x KV,
    G, S, hd, bf16, causal) against their plain versions, each timed beside
    its bound, the plain version and SDPA (the whole backward for the
    pair). Returns (rows, errs)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref, swa_attention
    nb, kvh = spec["lanes"], spec["kv"]
    bkv, g, s, hd = nb * kvh, spec["g"], spec["seq"], spec["hd"]
    q, k, v, do, o, lse, delta = _attn_inputs(torch, gen, bkv, g, s, hd,
                                              torch.bfloat16)
    out, lse_k = swa_attention.swa_flash_fwd(q, k, v)
    torch.testing.assert_close(out.float(), o.float(), **FWD_TOL)
    torch.testing.assert_close(lse_k, lse, **LSE_TOL)
    dq, dk, dv = swa_attention.swa_flash_bwd(q, k, v, o, lse, do)
    rq, rk, rv = ref.swa_attention_bwd_ref(q, k, v, o, lse, do)
    rel = [_rel_err(torch, a, b) for a, b in ((dq, rq), (dk, rk), (dv, rv))]
    check(max(rel) <= BWD_REL_TOL, f"hymba attention bwd rel errs {rel}")
    errs = {"swa_flash_fwd": _max_err(torch, out, o),
            "swa_flash_bwd_dq": _max_err(torch, dq, rq),
            "swa_flash_bwd_dkdv": max(_max_err(torch, dk, rk),
                                      _max_err(torch, dv, rv))}
    pairs = bkv * g * s * (s + 1) // 2
    row_bytes = bkv * g * s * 4
    in_bytes = 2 * (2 * q.numel() + 2 * k.numel())
    q4 = q.reshape(nb, kvh * g, s, hd)
    k4, v4 = k.reshape(nb, kvh, s, hd), v.reshape(nb, kvh, s, hd)
    qs = q4.detach().requires_grad_()
    ks_, vs_ = k4.detach().requires_grad_(), v4.detach().requires_grad_()
    lib_out = F.scaled_dot_product_attention(qs, ks_, vs_, is_causal=True,
                                             enable_gqa=True)
    gout = do.reshape(nb, kvh * g, s, hd)
    lib = _time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qs, ks_, vs_), gout, retain_graph=True))
    plain = _time_ms(torch, lambda: ref.swa_attention_bwd_ref(
        q, k, v, o, lse, do), reps=5)
    rows = {}
    b_fwd, by_fwd = _bound(4 * hd * pairs, 2 * (2 * q.numel() + k.numel()
                                                + v.numel()) + row_bytes,
                           q.dtype)
    rows["swa_flash_fwd"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_fwd(q, k, v)),
        "plain_ms": _time_ms(torch, lambda: ref.swa_attention_fwd_res_ref(
            q, k, v), reps=5),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)),
        "bound_ms": b_fwd, "bound_by": by_fwd}
    b_dq, by_dq = _bound(6 * hd * pairs, in_bytes + 2 * row_bytes
                         + q.numel() * 4, q.dtype)
    b_kv, by_kv = _bound(8 * hd * pairs, in_bytes + 2 * row_bytes
                         + 2 * k.numel() * 4, q.dtype)
    rows["swa_flash_bwd_dq"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_bwd_dq(
            q, k, v, lse, delta, do)),
        "plain_ms": plain, "library_ms": lib, "bound_ms": b_dq,
        "bound_by": by_dq}
    rows["swa_flash_bwd_dkdv"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_bwd_dkdv(
            q, k, v, lse, delta, do)),
        "plain_ms": plain, "library_ms": lib, "bound_ms": b_kv,
        "bound_by": by_kv}
    say("recurrent-times",
        f"hymba attention BKV={bkv} G={g} S={s} hd={hd} bf16 causal: fwd "
        f"{rows['swa_flash_fwd']}, dq {rows['swa_flash_bwd_dq']}, dkdv "
        f"{rows['swa_flash_bwd_dkdv']} (plain and library of the pair: the "
        f"whole backward); max|err| {errs}, bwd max|err|/max {rel} (tol "
        f"{BWD_REL_TOL}); {card_note(torch)}")
    del q, k, v, do, o, lse, qs, ks_, vs_, lib_out, gout
    torch.cuda.empty_cache()
    return rows, errs


def time_recurrent_kernels(torch) -> tuple:
    """The kernels at the recurrent families' shapes, each against its
    plain version (max|err|) and timed beside its bound, its plain version
    and a PyTorch library call: factor_syrk at rwkv6_7b's cm_wk G side
    (4,096 tokens x 14,336 bf16 -> (7, 2048, 2048)) and block_precond on
    its gradient from the G side (f32, (4096, 14336) x (7, 2048, 2048));
    at hymba_1_5b's odd blocks, the pair of each (ssm_xdb's G, 132 wide,
    and ssm_dt_proj's A, 100 wide: factor_syrk on 4,096 bf16 rows of each;
    block_precond on the (3200, 132) gradient from the G side and the
    (100, 3200) gradient from the A side); hymba's three training
    attention kernels (HYMBA_ATTN: BKV 4 x 5, G 5, S 1024, hd 64); and
    swa_flash_decode over hymba's bf16 legacy cache (4 lanes, 544 slots,
    5 KV heads, the (B, KV, C, hd) view, the path's last step). Returns
    ({row name: times}, {row name: max|err|})."""
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch, ref, swa_attention
    from repro_torch.kernels import kfac as kern
    gen = torch.Generator(device="cuda").manual_seed(293)
    f32 = torch.float32
    rows, errs = {}, {}
    left_ref = dispatch.lookup("block_precond_left", "ref")
    right_ref = dispatch.lookup("block_precond_right", "ref")

    # rwkv: cm_wk's G side
    n, d, bs = 4096, 14336, 2048
    nb = d // bs
    x = torch.randn((n, d), generator=gen, device="cuda").bfloat16()
    got, same = _launched_once(torch, lambda: kern.factor_syrk(x, bs),
                               "factor_syrk")
    want = ref.factor_sum_ref(x, bs)
    err = _rel_err(torch, got, want)
    check(same and err <= KFAC_REL_TOL, f"factor_syrk[rwkv]: {err}")
    errs["factor_syrk[rwkv]"] = _max_err(torch, got, want)
    ops, nbytes = _syrk_ops_bytes(n, nb, bs, nb * bs * bs * 4)
    bound, by = _bound(ops, nbytes, x.dtype)
    xb = x.view(n, nb, bs).transpose(0, 1)
    rows["factor_syrk[rwkv]"] = {
        "ms": _time_ms(torch, lambda: kern.factor_syrk(x, bs), reps=10),
        "plain_ms": _time_ms(torch, lambda: ref.factor_sum_ref(x, bs),
                             reps=5),
        "library_ms": _time_ms(torch, lambda: torch.bmm(
            xb.transpose(1, 2), xb, out_dtype=f32), reps=10),
        "bound_ms": bound, "bound_by": by}
    say("recurrent-times", f"factor_syrk[rwkv] ({n}, {d}) bf16 -> ({nb}, "
                           f"{bs}, {bs}) f32: {rows['factor_syrk[rwkv]']}, "
                           f"max|err|/max {err:.3e} (library: torch.bmm over "
                           f"the blocks, bf16 in, f32 out); "
                           f"{card_note(torch)}")
    del x, xb, got, want
    binv = torch.randn((nb, bs, bs), generator=gen, device="cuda") / bs ** .5
    w = torch.randn((n, d), generator=gen, device="cuda")
    got, same = _launched_once(
        torch, lambda: kern.block_precond(binv, w, right=True),
        "block_precond")
    want = right_ref(w, binv)
    err = _rel_err(torch, got, want)
    check(same and err <= KFAC_REL_TOL, f"block_precond[rwkv]: {err}")
    errs["block_precond[rwkv]"] = _max_err(torch, got, want)
    bound, by = _bound(2 * n * d * bs, (binv.numel() + 2 * w.numel()) * 4,
                       f32, PEAK_SPLIT_F32_OPS_PER_S)
    wb = w.view(n, nb, bs).transpose(0, 1)
    rows["block_precond[rwkv]"] = {
        "ms": _time_ms(torch, lambda: kern.block_precond(binv, w, right=True),
                       reps=10),
        "plain_ms": _time_ms(torch, lambda: right_ref(w, binv), reps=5),
        "library_ms": _time_ms(torch, lambda: torch.bmm(wb, binv), reps=10),
        "bound_ms": bound, "bound_by": by}
    say("recurrent-times", f"block_precond[rwkv] right w ({n}, {d}) binv "
                           f"({nb}, {bs}, {bs}) f32: "
                           f"{rows['block_precond[rwkv]']}, max|err|/max "
                           f"{err:.3e} (library: torch.bmm over the blocks, "
                           f"f32, TF32 off); {card_note(torch)}")
    del binv, w, wb, got, want
    torch.cuda.empty_cache()

    # hymba: ssm_xdb's G (132) and ssm_dt_proj's A (100)
    gx = torch.randn((n, 132), generator=gen, device="cuda").bfloat16()
    xa = torch.randn((n, 100), generator=gen, device="cuda").bfloat16()
    worst = 0.0
    for t in (gx, xa):
        got, same = _launched_once(torch, lambda: kern.factor_syrk(t, 2048),
                                   "factor_syrk")
        want = ref.factor_sum_ref(t, 2048)
        err = _rel_err(torch, got, want)
        check(same and got.shape == (1, t.shape[1], t.shape[1])
              and err <= KFAC_REL_TOL,
              f"factor_syrk[hymba] {tuple(t.shape)}: {err}")
        worst = max(worst, _max_err(torch, got, want))
    errs["factor_syrk[hymba]"] = worst
    ops = sum(_syrk_ops_bytes(n, 1, t.shape[1], t.shape[1] ** 2 * 4)[0]
              for t in (gx, xa))
    nbytes = sum(_syrk_ops_bytes(n, 1, t.shape[1], t.shape[1] ** 2 * 4)[1]
                 for t in (gx, xa))
    bound, by = _bound(ops, nbytes, gx.dtype)
    rows["factor_syrk[hymba]"] = {
        "ms": _time_ms(torch, lambda: (kern.factor_syrk(gx, 2048),
                                       kern.factor_syrk(xa, 2048))),
        "plain_ms": _time_ms(torch, lambda: (ref.factor_sum_ref(gx, 2048),
                                             ref.factor_sum_ref(xa, 2048))),
        "library_ms": _time_ms(torch, lambda: (
            torch.mm(gx.t(), gx, out_dtype=f32),
            torch.mm(xa.t(), xa, out_dtype=f32))),
        "bound_ms": bound, "bound_by": by}
    say("recurrent-times", f"factor_syrk[hymba] the pair ({n}, 132) and "
                           f"({n}, 100) bf16 -> (1, 132, 132), (1, 100, 100) "
                           f"f32: {rows['factor_syrk[hymba]']}, max|err| "
                           f"{worst:.3e} (library: torch.mm, bf16 in, f32 "
                           f"out); {card_note(torch)}")
    del gx, xa
    bg = torch.randn((1, 132, 132), generator=gen, device="cuda") / 132 ** .5
    wg = torch.randn((3200, 132), generator=gen, device="cuda")
    ba = torch.randn((1, 100, 100), generator=gen, device="cuda") / 10.0
    wa = torch.randn((100, 3200), generator=gen, device="cuda")
    worst = 0.0
    for right, bi, wt in ((True, bg, wg), (False, ba, wa)):
        got, same = _launched_once(
            torch, lambda: kern.block_precond(bi, wt, right=right),
            "block_precond")
        want = right_ref(wt, bi) if right else left_ref(bi, wt)
        err = _rel_err(torch, got, want)
        check(same and err <= KFAC_REL_TOL,
              f"block_precond[hymba] {tuple(wt.shape)}: {err}")
        worst = max(worst, _max_err(torch, got, want))
    errs["block_precond[hymba]"] = worst
    bound, by = _bound(2 * 3200 * 132 * 132 + 2 * 100 * 100 * 3200,
                       (bg.numel() + ba.numel() + 2 * wg.numel()
                        + 2 * wa.numel()) * 4, f32, PEAK_SPLIT_F32_OPS_PER_S)
    rows["block_precond[hymba]"] = {
        "ms": _time_ms(torch, lambda: (kern.block_precond(bg, wg, right=True),
                                       kern.block_precond(ba, wa))),
        "plain_ms": _time_ms(torch, lambda: (right_ref(wg, bg),
                                             left_ref(ba, wa))),
        "library_ms": _time_ms(torch, lambda: (torch.mm(wg, bg[0]),
                                               torch.mm(ba[0], wa))),
        "bound_ms": bound, "bound_by": by}
    say("recurrent-times", f"block_precond[hymba] the pair right w (3200, "
                           f"132) binv (1, 132, 132) and left binv (1, 100, "
                           f"100) w (100, 3200) f32: "
                           f"{rows['block_precond[hymba]']}, max|err| "
                           f"{worst:.3e} (library: torch.mm f32, TF32 off); "
                           f"{card_note(torch)}")
    del bg, wg, ba, wa

    attn, aerr = _attn_rows(torch, HYMBA_ATTN, gen)
    for k in attn:
        rows[f"{k}[hymba]"] = attn[k]
        errs[f"{k}[hymba]"] = aerr[k]

    # the decode over hymba's bf16 legacy cache: 4 lanes x 5 KV heads, G 5,
    # the path's last step (pos 543 of 544 slots)
    b, c, kv, g, hd = 4, 544, 5, 5, 64
    cache_k, cache_v = (torch.randn((b, c, kv, hd), generator=gen,
                                    device="cuda").bfloat16()
                        for _ in range(2))
    kview, vview = cache_k.permute(0, 2, 1, 3), cache_v.permute(0, 2, 1, 3)
    qd = torch.randn((b * kv, g, hd), generator=gen, device="cuda").bfloat16()
    pos = torch.full((b * kv,), c - 1, dtype=torch.int32, device="cuda")
    got, same = _launched_once(
        torch, lambda: swa_attention.swa_flash_decode(qd, kview, vview, pos),
        "swa_flash_decode", swa_attention.LAUNCHES)
    kf, vf = kview.reshape(b * kv, c, hd), vview.reshape(b * kv, c, hd)
    want = ref.swa_decode_ref(qd.float(), kf, vf, pos)
    err = _max_err(torch, got, want)
    check(same and err <= DEC_TOL["atol"] + DEC_TOL["rtol"] * float(
        want.abs().max()), f"swa_flash_decode[hymba]: {err}")
    errs["swa_flash_decode[hymba]"] = err
    nbytes = 2 * b * kv * c * hd * 2 + qd.numel() * 2 + qd.numel() * 4 \
        + 4 * b * kv
    bound, by = _bound(4 * hd * g * b * kv * c, nbytes, cache_k.dtype)
    qsd = qd.view(b, kv * g, 1, hd)
    rows["swa_flash_decode[hymba]"] = {
        "ms": _time_ms(torch, lambda: swa_attention.swa_flash_decode(
            qd, kview, vview, pos)),
        "plain_ms": _time_ms(torch, lambda: ref.swa_decode_ref(
            qd, kview.reshape(b * kv, c, hd), vview.reshape(b * kv, c, hd),
            pos)),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qsd, kview, vview, enable_gqa=True)),
        "bound_ms": bound, "bound_by": by}
    say("recurrent-times", f"swa_flash_decode[hymba] N={b * kv} G={g} "
                           f"hd={hd} over the bf16 legacy cache C={c} "
                           f"((B, KV, C, hd) view), pos {c - 1}: "
                           f"{rows['swa_flash_decode[hymba]']}, max|err| "
                           f"{err:.3e} (library: SDPA with enable_gqa, every "
                           f"slot visible); {card_note(torch)}")
    del cache_k, cache_v, kview, vview, qd, got, want, kf, vf
    torch.cuda.empty_cache()
    return rows, errs


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
