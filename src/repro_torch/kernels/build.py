"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). All sources compile in parallel, one ``nvcc`` each, into
``build/kernels/<hash>/`` at the root of the checkout, keyed on a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
is reused. Every pointer and the stream cross the interface as
``ctypes.c_void_p``; every entry point returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# element dtype -> code of csrc/common.cuh DTypeCode
DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float8_e4m3fn: 2,
    torch.float8_e5m2: 3,
}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# library (= source stem) -> {entry point: argtypes}
SIGNATURES = {
    "swa_flash_fwd": {
        # q, k, v, out, lse, bkv, G, S, hd, window, bq, bk, blocks, dtype,
        # scale, stream
        "swa_flash_fwd": [_P] * 5 + [_I] * 9 + [_F, _P],
    },
    "swa_flash": {
        # q, k, v, out, BH, S, hd, window, bq, bk, blocks, dtype, scale,
        # stream
        "swa_flash": [_P] * 4 + [_I] * 8 + [_F, _P],
    },
    "swa_flash_decode": {
        # q, k, v, k_scale, v_scale, pos, out, part, counters, N, G, C, hd,
        # window, q_dtype, kv_dtype, splits, per, scale, kvh, s_b, s_h, s_c,
        # sc_b, sc_h, sc_c, stream
        "swa_flash_decode": [_P] * 9 + [_I] * 9 + [_F, _I] + [_L] * 6 + [_P],
    },
    "swa_flash_decode_wide": {
        # the same arguments: any G, any hd up to 256
        "swa_flash_decode_wide": [_P] * 9 + [_I] * 9 + [_F, _I] + [_L] * 6
        + [_P],
    },
    "swa_flash_bwd": {
        # q, k, v, lse, delta, do, dq, bkv, G, S, hd, window, bq, bk,
        # blocks, dtype, scale, stream
        "swa_flash_bwd_dq": [_P] * 7 + [_I] * 9 + [_F, _P],
        # q, k, v, lse, delta, do, dk, dv, bkv, G, S, hd, window, bkey, bqs,
        # blocks, dtype, scale, stream
        "swa_flash_bwd_dkdv": [_P] * 8 + [_I] * 9 + [_F, _P],
    },
    "kfac_factor": {
        # x, out, ws, arrived, lead, lstride, n, ld, d, nb, b, dtype, ctas,
        # stream
        "factor_syrk": [_P] * 4 + [_I, _L] + [_I] * 7 + [_P],
        # x, scratch, amax, ws, arrived, payload, scale, lead, lstride, n,
        # ld, d, nb, b, dtype, ctas, fmt, pow2, inv_max, stream
        "factor_syrk_wire": [_P] * 7 + [_I, _L] + [_I] * 9 + [_F, _P],
    },
    "quant_pack": {
        # x, payload, scale, scratch, g, t, fmt, pow2, inv_max, grid, slice,
        # sms, stream
        "quant_rows": [_P] * 4 + [_L] * 2 + [_I] * 2 + [_F] + [_I] * 3 + [_P],
        # -> the resident route's grid on the current device
        "quant_rows_grid": [],
        # payload, scale, out, g, t, fmt, tiles, stream
        "dequant_rows": [_P] * 3 + [_L] * 2 + [_I] * 2 + [_P],
        # attrs (int[8]) -> registers and local bytes of each instance
        "dequant_rows_attrs": [_P],
    },
    "kfac_precond": {
        # binv, w, out, lead, lb, lw, lo, b, dim, other, ldw, ldo, nb, right,
        # blocks, stream
        "block_precond": [_P] * 3 + [_I] + [_L] * 3 + [_I] * 8 + [_P],
    },
    "newton_schulz": {
        # m, x, alt, r, res, trips, g, b, iters, tol, stream
        "ns_inverse_blocks": [_P] * 6 + [_I] * 3 + [_F, _P],
        # g, b -> the cluster size ns_inverse_blocks launches with
        "ns_resident_cluster": [_I] * 2,
        # m, x, active, r, partials, counter, ss, g, b, blocks, stream
        "ns_tiled_residual": [_P] * 7 + [_I] * 3 + [_P],
        # x, r, active, out, g, b, blocks, stream
        "ns_tiled_update": [_P] * 4 + [_I] * 3 + [_P],
    },
}

_LIBS: dict[str, ctypes.CDLL] | None = None


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``,
    else the toolkit PyTorch itself located."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    from torch.utils import cpp_extension
    if cpp_extension.CUDA_HOME:
        cands.append(os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the repro_torch kernels are built from "
                       f"{CSRC} at first use")


def _sources() -> list[Path]:
    return sorted(CSRC / f"{stem}.cu" for stem in SIGNATURES)


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc(cmd: list[str]) -> tuple[int, str, float]:
    """(exit code, output, seconds) of one nvcc run."""
    t = time.perf_counter()
    run = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    return run.returncode, run.stdout, time.perf_counter() - t


def build(verbose: bool = False) -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    returns {library name: path}. With ``verbose``, each library compiled
    here prints its kernels' registers, shared memory, spills, any
    compiler warning and any wgmma serialization ptxas reports, and the
    seconds its nvcc took; a cached library prints nothing."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {p.stem: out_dir / f"lib{p.stem}.so" for p in _sources()}
    jobs = []
    for src in _sources():
        dst = libs[src.stem]
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        jobs.append((src, dst, tmp, cmd))
    # one nvcc per source, all started together, each timed on its own
    with ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        runs = list(pool.map(_nvcc, [cmd for *_, cmd in jobs]))
    failed = []
    for (src, dst, tmp, _), (returncode, log, secs) in zip(jobs, runs):
        if returncode:
            failed.append(f"{src.name}:\n{log}")
            continue
        if verbose:
            entry = ""
            for line in log.splitlines():
                for mark in ("Compiling entry function '",
                             "Function properties for "):
                    if mark in line:
                        entry = line.split(mark)[1].split("'")[0].strip()
                if any(k in line for k in ("Used", "spill", "warning",
                                           "Performance Loss")):
                    print(f"[nvcc {src.name}] {entry}: {line.strip()}",
                          flush=True)
            print(f"[nvcc {src.name}] built in {secs:.1f} s", flush=True)
        os.replace(tmp, dst)
    if failed:
        raise RuntimeError("nvcc failed to build the repro_torch kernels:\n"
                           + "\n".join(failed))
    return libs


def load() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; raises when there is
    no CUDA device or no ``nvcc``."""
    global _LIBS
    if _LIBS is not None:
        return _LIBS
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the repro_torch kernels run only "
                           "on the card")
    libs = {}
    for name, path in build().items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        libs[name] = lib
    _LIBS = libs
    return libs


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
