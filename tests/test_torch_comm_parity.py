"""repro_torch.comm (Stage 3 over torch.distributed) against repro.comm, on
gloo ranks on the CPU.

* ``CommConfig`` / ``make_comm_config`` / ``hier_split``: the same
  ValueErrors for the same combinations, the same defaults and splits;
* every byte-ledger function equal to ``repro``'s integers;
* the hop codec (``dispatch.ring_hop_pack`` / ``ring_hop_unpack``) against
  ``repro``'s ``ref`` bit for bit;
* on 8 gloo ranks (``tests/torch_dist_ranks.py``), with the inputs of
  ``tests/test_comm.py::test_reduce_parity_dense_ring_ring_fp8`` (``a``
  (8, 2, 16, 16) symmetric, ``d`` (8, 6), ``uw`` (3, 4)), every strategy
  under ``manual_axes`` "auto" and "all" on a (4, 2) mesh against
  ``repro``'s reducer on conftest's 8 host devices: the same replicated
  tally, report and bytes per statistic, and each rank's chunk equal to
  ``repro``'s chunk of that rank within rtol = atol = 1e-5 (f32 sums in
  another order). The fp8 hops (``ring_fp8``, ``hier`` across hosts) are
  held to ``repro``'s same strategy within 1e-5 of the largest entry, not
  to ``dense``. ``hier`` also at devices_per_host 2 and 4, and ``fused`` on
  wire payloads made by the port's ``sym_pack`` + quantize.

The ledger's ``hier`` default width is a property of the process (JAX's 8
virtual devices, the test process's world size of 1), so the host-side
ledger comparisons pass ``devices_per_host`` or ``group_size``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import comm as jcomm
from repro.kernels import dispatch as jdispatch
from repro.launch import compat
from repro_torch import comm as tcomm
from repro_torch.core import kfac
from repro_torch.kernels import dispatch
from repro_torch.quant import quant
from torch_dist_ranks import RankPool

MESH = (4, 2)
SHAPES = {"a": (8, 2, 16, 16),      # symmetric: rides the ring packed
          "d": (8, 6),              # non-symmetric: f32 ring
          "uw": (3, 4)}             # indivisible: replicated all_reduce
SYM = ("a",)
TOL = dict(rtol=1e-5, atol=1e-5)
# fp8 strategies: the port against repro's same strategy, relative to the
# largest entry of repro's output
FP8_REL = 1e-5

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8,
                                   reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def pool():
    ranks = RankPool(MESH[0] * MESH[1])
    yield ranks
    ranks.close()


# ---------------------------------------------------------------------------
# config, splits and the byte ledger (host side)
# ---------------------------------------------------------------------------

CONFIGS = [
    dict(), dict(strategy="tree"), dict(wire_dtype="f16"),
    dict(strategy="ring_fp8"), dict(strategy="fused"),
    dict(strategy="dense", wire_dtype="fp8_e4m3"),
    dict(strategy="ring", wire_dtype="fp8_e5m2"),
    dict(strategy="hier"), dict(strategy="hier", wire_dtype="fp8_e5m2",
                                devices_per_host=0),
    dict(strategy="hier", wire_dtype="fp8_e4m3", devices_per_host=4),
    dict(strategy="ring_fp8", wire_dtype="fp8_e5m2"),
    dict(strategy="fused", wire_dtype="fp8_e4m3", fp8_scale_mode="pow2"),
]


def _construct(cls, kw):
    try:
        return dataclass_fields(cls(**kw))
    except ValueError:
        return "ValueError"


def dataclass_fields(c) -> dict:
    return {f: getattr(c, f) for f in ("strategy", "wire_dtype",
                                       "fp8_scale_mode", "backend",
                                       "devices_per_host")}


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_comm_config_validation_matches_repro(kw):
    assert _construct(tcomm.CommConfig, kw) == _construct(jcomm.CommConfig,
                                                          kw)


@pytest.mark.parametrize("strategy", tcomm.STRATEGIES)
def test_make_comm_config_defaults_match_repro(strategy):
    assert tcomm.STRATEGIES == jcomm.STRATEGIES
    assert tcomm.WIRE_DTYPES == jcomm.WIRE_DTYPES
    for wire in (None, "fp8_e5m2"):
        if wire and strategy in ("dense", "ring"):
            continue
        t = tcomm.make_comm_config(strategy, wire, devices_per_host=2)
        j = jcomm.make_comm_config(strategy, wire, devices_per_host=2)
        assert dataclass_fields(t) == dataclass_fields(j)
        assert t.wire_fmt == j.wire_fmt


@pytest.mark.parametrize("dph", [1, 2, 3, 4, 8])
def test_hier_split_matches_repro(dph):
    t = tcomm.make_comm_config("hier", devices_per_host=dph)
    j = jcomm.make_comm_config("hier", devices_per_host=dph)
    for p in (1, 2, 4, 6, 8, 16):
        assert tcomm.hier_split(t, p) == jcomm.hier_split(j, p), (dph, p)


LEDGER_SHAPES = [(8, 2, 16, 16), (8, 6), (3, 4), (16, 1, 2048, 2048),
                 (1, 4, 512, 512), (16, 4, 5, 5)]


@pytest.mark.parametrize("strategy", tcomm.STRATEGIES)
def test_ledger_functions_equal_repro(strategy):
    """wire_stat_bytes, wire_stat_level_bytes and gather_stat_bytes over
    shapes, symmetry, the fallback and group sizes; the template walks over
    a template of the same shapes, with and without a scattered_fn."""
    for dph in (1, 2, 4):
        t = tcomm.make_comm_config(strategy, devices_per_host=dph)
        j = jcomm.make_comm_config(strategy, devices_per_host=dph)
        for shape in LEDGER_SHAPES:
            for sym in (True, False):
                for scattered in (True, False):
                    for gs in (1, 2, 4, 6, 8):
                        args = (shape, sym)
                        kw = dict(scattered=scattered, group_size=gs)
                        assert tcomm.wire_stat_bytes(*args, t, **kw) == \
                            jcomm.wire_stat_bytes(*args, j, **kw)
                        assert tcomm.wire_stat_level_bytes(*args, t, **kw) \
                            == jcomm.wire_stat_level_bytes(*args, j, **kw)
                    assert tcomm.gather_stat_bytes(
                        shape, sym, scattered=scattered) == \
                        jcomm.gather_stat_bytes(shape, sym,
                                                scattered=scattered)
        keys = ("a", "g", "d", "uw", "x", "y")
        ttemp = {"fam": {k: torch.empty(s, device="meta")
                         for k, s in zip(keys, LEDGER_SHAPES)}}
        jtemp = {"fam": {k: jax.ShapeDtypeStruct(s, jnp.float32)
                         for k, s in zip(keys, LEDGER_SHAPES)}}
        sym_fn = lambda fam, key: key in ("a", "g", "x")   # noqa: E731
        for scattered_fn in (None, lambda n: n.endswith(("a", "d"))):
            for gs in (2, 8):
                assert tcomm.template_wire_bytes(
                    ttemp, sym_fn, t, scattered_fn, gs) == \
                    jcomm.template_wire_bytes(jtemp, sym_fn, j,
                                              scattered_fn, gs)
                assert tcomm.template_wire_level_bytes(
                    ttemp, sym_fn, t, scattered_fn, gs) == \
                    jcomm.template_wire_level_bytes(jtemp, sym_fn, j,
                                                    scattered_fn, gs)
            assert tcomm.template_gather_bytes(ttemp, sym_fn, scattered_fn) \
                == jcomm.template_gather_bytes(jtemp, sym_fn, scattered_fn)


# ---------------------------------------------------------------------------
# the hop codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("shape", [(4, 36), (2, 3, 130)])
def test_ring_hop_codec_matches_repro_ref(shape, fmt):
    rng = np.random.RandomState(0)
    rows = (rng.randn(*shape) * 7).astype(np.float32)
    rows[0, ..., :] = 0.0                        # an all-zero row: scale 1
    jp, js = jdispatch.ring_hop_pack(jnp.asarray(rows), fmt=fmt,
                                     backend="ref")
    tp, ts = dispatch.ring_hop_pack(torch.from_numpy(rows), fmt=fmt)
    assert tp.dtype == quant.FORMATS[fmt] and tuple(ts.shape) == shape[:-1]
    np.testing.assert_array_equal(tp.view(torch.uint8).numpy(),
                                  np.asarray(jp).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jout = jdispatch.ring_hop_unpack(jp, js, backend="ref")
    tout = dispatch.ring_hop_unpack(tp, ts)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_ring_hop_codec_cuda_refuses_cpu_tensors():
    rows = torch.ones(2, 6)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.ring_hop_pack(rows, backend="cuda")
    p, s = dispatch.ring_hop_pack(rows)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.ring_hop_unpack(p, s, backend="cuda")


# ---------------------------------------------------------------------------
# the reducer on 8 gloo ranks against repro's on 8 host devices
# ---------------------------------------------------------------------------

def _inputs(manual_axes: str) -> dict:
    """tests/test_comm.py's inputs: one raw tree per data-axis position."""
    ndev = 4 if manual_axes == "auto" else 8
    rng = np.random.RandomState(0)
    f = rng.randn(ndev, 8, 2, 16, 16).astype(np.float32)
    return {"a": f + np.swapaxes(f, -1, -2),
            "d": rng.randn(ndev, 8, 6).astype(np.float32),
            "uw": rng.randn(ndev, 3, 4).astype(np.float32)}


def _wire_inputs(raw: dict, fmt: str = "e4m3") -> dict:
    """``a`` as the port's capture would send it: sym-packed, quantized
    per block. Payload bits as uint8."""
    p, s = quant.quantize_rows(kfac.sym_pack(torch.from_numpy(raw["a"])),
                               fmt)
    return dict(raw, a={"payload": p.view(torch.uint8).numpy(),
                        "scale": s.numpy()})


@functools.lru_cache(maxsize=None)
def _repro(manual_axes: str, strategy: str, dph=None, wire: bool = False):
    """repro's reducer over the (4, 2) mesh: (its full outputs, reducer)."""
    mesh = compat.make_mesh(MESH, ("data", "model"))
    raw = _inputs(manual_axes)
    template = {"fam": {k: jax.ShapeDtypeStruct(s, jnp.float32)
                        for k, s in SHAPES.items()}}
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    if wire:
        w = _wire_inputs(raw)["a"]
        jraw["a"] = {"payload": jnp.asarray(w["payload"]).view(
                         jnp.float8_e4m3fn),
                     "scale": jnp.asarray(w["scale"])}
        template["fam"]["a"] = {
            "payload": jax.ShapeDtypeStruct(w["payload"].shape[1:],
                                            jnp.float8_e4m3fn),
            "scale": jax.ShapeDtypeStruct(w["scale"].shape[1:],
                                          jnp.float32)}
    red = jcomm.FactorReducer(
        mesh, manual_axes=manual_axes,
        comm=jcomm.make_comm_config(strategy, devices_per_host=dph),
        template=template, sym_fn=lambda fam, key: key in SYM)

    def body(r):
        return red.reduce(jax.tree.map(lambda x: x[0], r))

    raw_all = {"fam": jraw}
    in_specs = jax.tree.map(lambda _: P(red.dp), raw_all)
    fn = compat.shard_map(body, mesh=mesh, in_specs=(in_specs,),
                          out_specs=red.out_specs(),
                          axis_names=set(red.dp))
    out = jax.tree.map(np.asarray, jax.jit(fn)(raw_all))
    return out["fam"], red


def _port(pool, manual_axes, strategy, dph=None, wire=False):
    raw = _inputs(manual_axes)
    if wire:
        raw = _wire_inputs(raw)
    return pool.run("reduce", MESH, manual_axes,
                    {"strategy": strategy, "devices_per_host": dph},
                    SHAPES, SYM, raw,
                    {"a": "float8_e4m3fn"} if wire else None)


def _check(results, want, red, fp8_keys=()):
    """Each rank's chunk (and its assembled tree) against repro's; the
    ledger and tally equal. Returns the largest gap seen per key."""
    gaps = {}
    indices = sorted(r["index"] for r in results)
    assert indices == sorted(np.repeat(np.arange(red.ndev),
                                       len(results) // red.ndev))
    for r in results:
        assert r["replicated"] == red.replicated
        assert r["report"] == red.scatter_report()
        assert r["wire"] == red.wire_bytes_per_stat()
        assert r["levels"] == red.wire_bytes_per_stat_levels()
        assert r["gather"] == red.gather_bytes_per_stat()
        for key, full in want.items():
            got = r["out"]["fam"][key]
            c = got.shape[0]
            chunk = full if c == full.shape[0] else \
                full[r["index"] * c:(r["index"] + 1) * c]
            assert got.shape == chunk.shape, key
            gap = float(np.abs(got - chunk).max())
            gaps[key] = max(gaps.get(key, 0.0), gap)
            if key in fp8_keys:
                assert gap <= FP8_REL * np.abs(full).max(), (key, gap)
            else:
                np.testing.assert_allclose(got, chunk, **TOL, err_msg=key)
            np.testing.assert_allclose(r["assembled"]["fam"][key], full,
                                       **(TOL if key not in fp8_keys else
                                          dict(rtol=0, atol=FP8_REL *
                                               np.abs(full).max())),
                                       err_msg=key)
    return gaps


@needs_devices
@pytest.mark.parametrize("strategy", tcomm.STRATEGIES)
@pytest.mark.parametrize("manual_axes", ["auto", "all"])
def test_reduce_matches_repro_per_chunk(pool, manual_axes, strategy):
    want, red = _repro(manual_axes, strategy)
    assert red.replicated == ["fam.uw"]
    fp8 = ("a",) if strategy == "ring_fp8" else ()
    gaps = _check(_port(pool, manual_axes, strategy), want, red, fp8)
    print(f"{manual_axes}/{strategy}: largest gap {gaps}")


@needs_devices
@pytest.mark.parametrize("dph", [2, 4])
@pytest.mark.parametrize("manual_axes", ["auto", "all"])
def test_hier_reduce_matches_repro_per_chunk(pool, manual_axes, dph):
    want, red = _repro(manual_axes, "hier", dph)
    d, h = jcomm.hier_split(red.comm, red.ndev)
    assert red.scatter_report()["hier_topology"] == {
        "devices_per_host": d, "hosts": h}
    gaps = _check(_port(pool, manual_axes, "hier", dph), want, red,
                  ("a",) if h > 1 else ())
    print(f"{manual_axes}/hier D {d} x H {h}: largest gap {gaps}")


@needs_devices
@pytest.mark.parametrize("manual_axes", ["auto", "all"])
def test_fused_wire_payloads_match_repro(pool, manual_axes):
    """The symmetric statistic arrives as the port's sym_pack + quantize
    payload; both reducers all_to_all the same bits, dequantize and sum."""
    want, red = _repro(manual_axes, "fused", wire=True)
    results = _port(pool, manual_axes, "fused", wire=True)
    gaps = _check(results, want, red)
    print(f"{manual_axes}/fused on wire payloads: largest gap {gaps}")
    # the reduced statistic is the sum of the dequantized payloads
    raw = _wire_inputs(_inputs(manual_axes))["a"]
    deq = quant.dequantize_rows(
        torch.from_numpy(raw["payload"]).view(torch.float8_e4m3fn),
        torch.from_numpy(raw["scale"])).sum(0)
    np.testing.assert_allclose(results[0]["assembled"]["fam"]["a"],
                               kfac.sym_unpack(deq, 16).numpy(), **TOL)


def test_ring_order_is_repros(pool):
    """An off-by-one in the ring's chunk indices still sums to the right
    total; only the per-hop rounding shows it. With an fp8 wire and a
    sparse input whose chunks differ by orders of magnitude, the port's
    chunks equal the ring re-enacted in numpy in repro's order, hop for
    hop, bit for bit (the dequantized partial sum plus the local chunk,
    in f32)."""
    p, c = 8, 1
    rng = np.random.RandomState(5)
    mag = 10.0 ** rng.randint(-3, 4, size=(p, p, 1, 1, 1))
    f = (rng.randn(p, p * c, 1, 4, 4) * mag).astype(np.float32)
    raw = {"a": f + np.swapaxes(f, -1, -2)}
    results = pool.run("reduce", MESH, "all", {"strategy": "ring_fp8"},
                       {"a": raw["a"].shape[1:]}, SYM, raw)
    packed = kfac.sym_pack(torch.from_numpy(raw["a"]))      # (p, p, 1, t)
    for r in results:
        idx = r["index"]
        # the hop s partial arriving at idx left ring position idx - 1 - s
        # ... re-enact every position's accumulator in lock step
        acc = {j: packed[j][(j + p - 1) % p] for j in range(p)}
        for s in range(p - 1):
            new = {}
            for j in range(p):
                src = (j - 1) % p
                pay, sc = quant.quantize_rows(acc[src], "e4m3")
                new[j] = quant.dequantize_rows(pay, sc) + \
                    packed[j][(j + 2 * p - 2 - s) % p]
            acc = new
        want = kfac.sym_unpack(acc[idx], 4).numpy()
        np.testing.assert_array_equal(r["out"]["fam"]["a"][0], want)


def test_a_failing_rank_fails_the_run():
    pool = RankPool(2)
    try:
        with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
            pool.run("fails_on", 1)
    finally:
        pool.close()
