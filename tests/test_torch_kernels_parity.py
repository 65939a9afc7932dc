"""repro_torch kernel modules against the JAX package, on the CPU.

The plain PyTorch versions of the two attention kernels are held against
``repro.kernels.ref`` and the interpret-mode Pallas ops on the same numpy
inputs; the fp8 rows codec must match bit for bit. The CUDA kernels
themselves run only on the card (``chip_smoke.py``); here the checks are
that their wrappers and the build refuse to run without one, and that the
dispatch follows the device rule.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattention
from repro.kernels import ref as jref
from repro.quant import quant as jquant
from repro.serve import cache as jcache
from repro_torch.convert import to_torch
from repro_torch.kernels import build, dispatch, ref, swa_attention
from repro_torch.models import attention
from repro_torch.quant import quant
from repro_torch.serve import cache

ROOT = Path(__file__).resolve().parents[1]


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# swa_attention_fwd_res: plain version vs JAX ref and interpret Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,window,s", [
    (4, 0, 16), (4, 4, 16), (1, 0, 16), (1, 4, 16), (4, 3, 13),
])
def test_swa_fwd_res_plain_matches_jax(g, window, s):
    rng = np.random.default_rng(100 * g + 10 * window + s)
    hd = 32
    q, k, v = _rand(rng, (2, g, s, hd)), _rand(rng, (2, s, hd)), \
        _rand(rng, (2, s, hd))
    out, lse = dispatch.swa_attention_fwd_res(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=window)
    for fn in (jref.swa_attention_fwd_res_ref,
               lambda *a, window: jops.swa_attention_fwd_res(
                   *a, window=window, bq=8, bk=8, interpret=True)):
        jo, jl = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    window=window)
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=2e-4,
                                   rtol=2e-4)


# ---------------------------------------------------------------------------
# swa_decode: plain version (dense, ring, fp8 ring) vs JAX ref and Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "ring", "e4m3", "e5m2"])
def test_swa_decode_plain_matches_jax(mode):
    rng = np.random.default_rng({"dense": 1, "ring": 2, "e4m3": 3,
                                 "e5m2": 4}[mode])
    n, g, hd = 3, 4, 32
    window = 0 if mode == "dense" else 8
    c = window or 16
    q, k, v = _rand(rng, (n, g, hd)), _rand(rng, (n, c, hd)), \
        _rand(rng, (n, c, hd))
    pos = np.asarray([0, 7, 29] if window else [0, 5, 15], np.int32)
    kw_j, kw_t = {}, {}
    if mode in ("e4m3", "e5m2"):
        kp, ks = jquant.quantize_rows(jnp.asarray(k), mode)
        vp, vs = jquant.quantize_rows(jnp.asarray(v), mode)
        kw_j = dict(k_scale=ks, v_scale=vs)
        kw_t = dict(k_scale=to_torch(ks), v_scale=to_torch(vs))
        kt, vt = to_torch(kp), to_torch(vp)
        assert kt.dtype == quant.FORMATS[mode]
        kj, vj = kp, vp
    else:
        kt, vt = torch.from_numpy(k), torch.from_numpy(v)
        kj, vj = jnp.asarray(k), jnp.asarray(v)
    got = dispatch.swa_decode(torch.from_numpy(q), kt, vt,
                              torch.from_numpy(pos), window=window, **kw_t)
    args = (jnp.asarray(q), kj, vj, jnp.asarray(pos))
    for want in (jref.swa_decode_ref(*args, window=window, **kw_j),
                 jops.swa_decode(*args, window=window, interpret=True,
                                 **kw_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_swa_decode_reads_cache_view_like_flat_layout():
    """The (B, KV, C, hd) view of the serving cache gives what the flat
    (N, C, hd) copy gives."""
    rng = np.random.default_rng(7)
    b, kv, c, g, hd = 2, 3, 8, 2, 16
    cache_k = torch.from_numpy(_rand(rng, (b, c, kv, hd)))
    cache_v = torch.from_numpy(_rand(rng, (b, c, kv, hd)))
    scale = torch.from_numpy(rng.uniform(0.5, 2, (b, c, kv)).astype(np.float32))
    q = torch.from_numpy(_rand(rng, (b * kv, g, hd)))
    pos = torch.tensor([3, 3, 3, 11, 11, 11], dtype=torch.int32)
    view = dispatch.swa_decode(q, cache_k.permute(0, 2, 1, 3),
                               cache_v.permute(0, 2, 1, 3), pos, window=c,
                               k_scale=scale.permute(0, 2, 1),
                               v_scale=scale.permute(0, 2, 1))
    flat = ref.swa_decode_ref(
        q, cache_k.permute(0, 2, 1, 3).reshape(b * kv, c, hd),
        cache_v.permute(0, 2, 1, 3).reshape(b * kv, c, hd), pos, window=c,
        k_scale=scale.permute(0, 2, 1).reshape(b * kv, c),
        v_scale=scale.permute(0, 2, 1).reshape(b * kv, c))
    torch.testing.assert_close(view, flat, atol=0, rtol=0)


@pytest.mark.parametrize("q_offset,kv_len,window", [
    (0, None, 0), (0, None, 5), (6, 10, 0), (6, 10, 4),
])
def test_chunked_attention_matches_naive_and_jax(q_offset, kv_len, window):
    """The plain attention path (chunks smaller than the keys, GQA group 2):
    decode-style offsets and valid-key counts included."""
    rng = np.random.default_rng(q_offset + 3 * window)
    q, k, v = (_rand(rng, (2, 4, 4, 32)) if q_offset else
               _rand(rng, (2, 12, 4, 32))), _rand(rng, (2, 12, 2, 32)), \
        _rand(rng, (2, 12, 2, 32))
    kw = dict(causal=True, window=window, q_offset=q_offset, kv_len=kv_len)
    got = attention.attention(*map(torch.from_numpy, (q, k, v)), chunk=5,
                              **kw)
    naive = attention.attention_naive(*map(torch.from_numpy, (q, k, v)), **kw)
    want = jattention.attention(*map(jnp.asarray, (q, k, v)), chunk=5,
                                backend="ref", **kw)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# fp8 rows codec and cache index helpers: exactly the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("scale_mode", ["fp32", "pow2"])
def test_quantize_rows_bit_identical(fmt, scale_mode):
    """fp32 scales over any range. pow2 scales only where XLA's CPU exp2 is
    exact (|exponent| < 13): beyond that the JAX package's "power of two"
    is not one, while the port's stays exact (asserted below)."""
    rng = np.random.default_rng(11)
    lo, hi = (1e-3, 1e3) if scale_mode == "fp32" else (0.5, 100.0)
    x = (rng.standard_normal((6, 64))
         * rng.uniform(lo, hi, (6, 1))).astype(np.float32)
    x[2] = 0.0                                  # all-zero row: scale 1
    if scale_mode == "fp32":
        x[3, 5] = 1e30                          # clip keeps e4m3 out of NaN
    jp, js = jquant.quantize_rows(jnp.asarray(x), fmt, scale_mode)
    tp, ts = quant.quantize_rows(torch.from_numpy(x), fmt, scale_mode)
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(tp.view(torch.uint8).numpy(),
                                  np.asarray(jp).view(np.uint8))
    np.testing.assert_array_equal(
        quant.dequantize_rows(tp, ts).numpy(),
        np.asarray(jquant.dequantize_rows(jp, js)))
    if scale_mode == "pow2":
        big = quant.compute_scale(torch.tensor([1e30, 1e-30, 3.0]), fmt,
                                  "pow2")
        assert (big.numpy().view(np.uint32) & 0x7FFFFF == 0).all()


def test_prefill_gather_index_and_slot_positions_equal_jax():
    for s, c in [(1, 4), (3, 4), (4, 4), (13, 4), (16, 16), (600, 1024)]:
        np.testing.assert_array_equal(cache.prefill_gather_index(s, c),
                                      jcache.prefill_gather_index(s, c))
    pos = np.asarray([0, 3, 7, 8, 21, 1000], np.int32)
    for c in (1, 4, 8, 256):
        np.testing.assert_array_equal(
            ref.swa_decode_slot_positions(torch.from_numpy(pos), c).numpy(),
            np.asarray(jref.swa_decode_slot_positions(jnp.asarray(pos), c)))


# ---------------------------------------------------------------------------
# device rule: CPU tensors take the plain version, nothing falls back on CUDA
# ---------------------------------------------------------------------------

def test_dispatch_device_rule():
    cpu = torch.device("cpu")
    assert dispatch.resolve(None, cpu) == "ref"
    assert dispatch.resolve("auto", cpu) == "ref"
    assert dispatch.resolve("ref", "cuda") == "ref"
    assert dispatch.resolve("auto", "cuda") == "cuda"
    assert dispatch.resolve("cuda", "cuda") == "cuda"
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.resolve("cuda", cpu)
    with pytest.raises(ValueError, match="pallas"):
        dispatch.resolve("pallas", cpu)
    with pytest.raises(KeyError):
        dispatch.lookup("swa_decode", "triton")
    q = torch.zeros(2, 1, 4, 64)
    kv = torch.zeros(2, 4, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.swa_attention_fwd_res(q, kv, kv, backend="cuda")
    dispatch.reset_calls()
    dispatch.swa_attention_fwd_res(q, kv, kv)
    assert dispatch.CALLS == {("swa_attention_fwd_res", "ref"): 1}


@pytest.mark.parametrize("q_offset,kv_len,sq", [(2, None, 4), (0, 6, 8),
                                                (0, None, 4)])
def test_attention_on_cuda_route_refuses_calls_the_kernel_lacks(
        monkeypatch, q_offset, kv_len, sq):
    """Where the backend resolves to the kernel, a decode offset, a kv_len
    or Sq != Sk raises instead of running the plain path on the card."""
    monkeypatch.setattr(dispatch, "resolve", lambda backend, device: "cuda")
    q = torch.zeros(1, sq, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    dispatch.reset_calls()
    with pytest.raises(NotImplementedError, match="backend='ref'"):
        attention.attention(q, kv, kv, q_offset=q_offset, kv_len=kv_len)
    assert dispatch.CALLS == {}


def test_kernel_wrappers_and_build_refuse_without_card():
    q = torch.zeros(2, 4, 8, 64)
    kv = torch.zeros(2, 8, 64)
    before = dict(swa_attention.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        swa_attention.swa_flash_fwd(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        swa_attention.swa_flash_decode(q[:, :, 0], kv, kv,
                                       torch.zeros(2, dtype=torch.int32))
    assert swa_attention.LAUNCHES == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build.load()


def test_kernel_sources_and_build_flags():
    """Every kernel is built from sources in the package for sm_90a, with a
    plain C interface (no PyTorch headers) and no library kernels: the
    (BH, S, hd) attention forward, the two attention kernels of the serving
    path, the factor-sum, block-preconditioning and attention-backward
    kernels of the training path, the three Newton-Schulz kernels of Stage 4 and the fp8 rows and
    wire-capture kernels, each entry point of ``build.SIGNATURES`` defined
    in its source."""
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert set(build.SIGNATURES) == {"swa_flash", "swa_flash_fwd",
                                     "swa_flash_decode",
                                     "swa_flash_bwd", "kfac_factor",
                                     "kfac_precond", "newton_schulz",
                                     "quant_pack"}
    for stem, entries in build.SIGNATURES.items():
        src = (build.CSRC / f"{stem}.cu").read_text()
        for fn in entries:
            assert f'extern "C" int {fn}(' in src
        assert "cudaGetLastError()" in src
        for banned in ("torch/extension.h", "cublas", "cudnn", "cutlass"):
            assert banned not in src.lower()
        assert "Replaces the TPU kernel" in src and "Bound:" in src
    for header in build.CSRC.glob("*.cuh"):
        assert "torch/extension.h" not in header.read_text()
    assert len(build.source_hash()) == 16


def _imported_modules(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    return mods


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        bad = _imported_modules(f) & {"jax", "jaxlib", "repro", "flax"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
