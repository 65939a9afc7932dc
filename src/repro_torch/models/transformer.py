"""Config-driven decoder-only LM: dense, MoE, hybrid attention + SSM
(hymba) and RWKV-6 blocks (counterpart of ``repro/models/transformer.py``).

Weights keep the JAX package's layout -- dense weights ``(d_in, d_out)``
applied as ``x @ w``, per-layer trees ``ln1/ln2/attn/mlp`` -- held as
parameter dicts (``blocks[i]["attn"]["wq"]`` is the JAX package's
``params["blocks"]["attn"]["wq"][i]``). The serving cache keeps the layout
``(L, B, C, KV, hd)`` with ``(L, B, C, KV)`` scales.

Surface: ``init(generator)``, ``forward(batch, fstats)``, the training
objective ``loss(params, fstats, batch)``, the SP-NGD wiring
``params()`` / ``site_infos()`` / ``fstats()`` / ``site_counts(batch)``,
and serving: ``init_cache(batch, max_len, serve=...)``, ``prefill(batch,
max_len, serve=...)``, ``decode_step(cache, tokens, serve=...)``. The
parameter tree of ``params()`` is the JAX package's, with ``blocks`` a list
of the L per-layer dicts instead of leaves stacked on a leading axis;
factor-statistic families keep the stacked ``(L, ...)`` layout. With
``cfg.remat`` each block is recomputed in the backward
(``torch.utils.checkpoint``, non-reentrant). With ``cfg.frontend ==
"vision"`` (the VLM backbone) a ``proj`` site maps the batch's precomputed
patch embeddings ``pixel_embeds`` (B, frontend_tokens, frontend_dim) to
``d_model`` and their rows go before the text's; the loss and the logits
it returns cover the text rows only. An MoE block (``block_type ==
"moe"``, ``models/moe.py``) takes the MLP's place: per layer ``moe`` holds
``router (d, E)``, ``we_up``/``we_gate (E, d, f)``, ``we_down (E, f, d)``
and the shared experts' ``sh_*``; its expert sites' factor families are
``(L, E, nb, b, b)`` and the blocks' auxiliary losses average into the
loss. A hymba block (``models/ssm.py``) runs attention and a selective
SSM side by side on the same normed input and adds their mean; an RWKV
block (``models/rwkv.py``) has no attention: LayerNorm (with a beta
whatever ``cfg.norm`` says), the time mix, LayerNorm, the channel mix.

Without a ``serve`` config the cache is the JAX package's legacy layout
(``init_cache(serve=None)``): a 0-d ``len``, dense ``(L, B, max_len, KV,
hd)`` K/V in ``cfg.dtype`` for the blocks with attention, and the
recurrent state (``ssm_h``, ``conv``; ``tm_x``, ``cm_x``, ``wkv``). It is
written in place too. On the card its attention runs the hand-written
kernels: the prompt's causal(-window) attention through the training
forward kernel, and each decode step's query through the single-query
decode kernel over the span of the cache a windowed query can see.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tagging
from repro_torch.core.fisher import SiteInfo
from repro_torch.core.tagging import FactorSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import apply_rope, he_normal, layernorm, rmsnorm
from repro_torch.models.mlp import init_mlp, mlp

_KV_KEYS = ("k", "v", "k_scale", "v_scale")
BLOCK_TYPES = ("dense", "moe", "hymba", "rwkv")


def resolve_device(device) -> torch.device:
    """The card unless the caller asks for another device; never a silent
    move to the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: repro_torch runs on the card "
                           "unless the caller passes device='cpu'")
    return dev


def _param_tree(tree: dict) -> nn.Module:
    """Nested {name: tensor | dict} -> ParameterDict / ModuleDict (frozen:
    the serving slice computes no gradients)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _param_tree(v) for k, v in tree.items()})


def _device_generator(generator: torch.Generator,
                      device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``generator`` (a CPU generator
    cannot draw on the card): deterministic in the caller's seed."""
    if generator.device.type == device.type:
        return generator
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if cfg.block_type not in BLOCK_TYPES:
            raise NotImplementedError(
                f"unknown block_type {cfg.block_type!r}; repro_torch has "
                f"{BLOCK_TYPES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        # factor specs (transformer.py:48-57 of the JAX package); its
        # per-site specs differ only under tensor-parallel alignment, which
        # one device does not use
        self.spec = FactorSpec(max_dim=cfg.kfac_max_dim, backend=cfg.backend,
                               wire_fmt=cfg.factor_wire)
        self.head_spec = FactorSpec(g_kind=cfg.head_g_kind,
                                    max_dim=cfg.kfac_max_dim,
                                    backend=cfg.backend,
                                    wire_fmt=cfg.factor_wire)
        self.embed_spec = FactorSpec(a_kind="diag", g_kind="full",
                                     max_dim=cfg.kfac_max_dim,
                                     backend=cfg.backend,
                                     wire_fmt=cfg.factor_wire)

        def empty(*shape, dtype=cfg.dtype):
            return torch.empty(shape, dtype=dtype, device=self.device)

        def ones(n):
            return torch.ones(n, dtype=torch.float32, device=self.device)

        self.embed = _param_tree({"table": empty(cfg.vocab, d)})
        self.final_norm = _param_tree({"gamma": ones(d)})
        self.head = _param_tree({"w": empty(d, cfg.vocab)})
        if cfg.frontend == "vision":
            self.proj = _param_tree({"w": empty(cfg.frontend_dim, d)})
        f32 = torch.float32
        bt, ff = cfg.block_type, cfg.d_ff
        blocks = []
        for _ in range(cfg.n_layers):
            p = {"ln1": {"gamma": ones(d)}, "ln2": {"gamma": ones(d)}}
            if cfg.norm == "layernorm" or bt == "rwkv":
                p["ln1"]["beta"] = torch.zeros(d, device=self.device)
                p["ln2"]["beta"] = torch.zeros(d, device=self.device)
            if bt in ("dense", "moe", "hymba"):
                p["attn"] = {"wq": empty(d, h * hd), "wk": empty(d, kv * hd),
                             "wv": empty(d, kv * hd), "wo": empty(h * hd, d)}
                if cfg.qkv_bias:
                    p["attn"].update(bq=empty(h * hd), bk=empty(kv * hd),
                                     bv=empty(kv * hd))
            if bt in ("dense", "hymba"):
                p["mlp"] = {"up": empty(d, ff), "down": empty(ff, d)}
                if cfg.gated_mlp:
                    p["mlp"]["gate"] = empty(d, ff)
            if bt == "moe":
                e = cfg.n_experts
                p["moe"] = {"router": empty(d, e), "we_up": empty(e, d, ff),
                            "we_gate": empty(e, d, ff),
                            "we_down": empty(e, ff, d)}
                if cfg.n_shared_experts:
                    sf = cfg.n_shared_experts * ff
                    p["moe"].update(sh_up=empty(d, sf), sh_gate=empty(d, sf),
                                    sh_down=empty(sf, d))
            if bt == "hymba":
                di, n = cfg.ssm_expand * d, cfg.ssm_state
                r = max(1, d // 16)
                p["ssm"] = {"in_proj": empty(d, 2 * di),
                            "conv_w": empty(ssm_lib.CONV_K, di),
                            "xdb": empty(di, r + 2 * n),
                            "dt_proj": empty(r, di), "dt_bias": empty(di),
                            "a_log": empty(di, n, dtype=f32),
                            "d_skip": empty(di, dtype=f32),
                            "out_proj": empty(di, d)}
            if bt == "rwkv":
                lr = rwkv_lib.LORA_R
                p["tm"] = {f"mu_{n}": empty(d) for n in "rkvwg"}
                p["tm"].update({n: empty(d, d)
                                for n in ("wr", "wk", "wv", "wg", "wo")})
                p["tm"].update(w0=empty(d, dtype=f32),
                               w_lora_a=empty(d, lr), w_lora_b=empty(lr, d),
                               u_bonus=empty(d // hd, hd, dtype=f32),
                               ln_scale=empty(d, dtype=f32))
                p["cm"] = {"mu_k": empty(d), "mu_r": empty(d),
                           "wk": empty(d, ff), "wv": empty(ff, d),
                           "wr": empty(d, d)}
            blocks.append(_param_tree(p))
        self.blocks = nn.ModuleList(blocks)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "DecoderLM":
        """Random weights with the JAX package's distributions
        (``transformer.py:141-202``): embedding N(0, 0.02), HeNormal dense
        weights (the vision projector's and the experts' too), unit norm
        scales, zero biases, and the recurrent branches' own
        (``models/ssm.py init_ssm``, ``models/rwkv.py init_rwkv_tm`` /
        ``init_rwkv_cm``). Deterministic in the generator's seed (its bits
        cannot match ``jax.random``)."""
        cfg = self.cfg
        g = _device_generator(generator, self.device)
        dev = self.device
        table = torch.randn((cfg.vocab, cfg.d_model), generator=g,
                            device=dev) * 0.02
        self.embed["table"].copy_(table.to(cfg.dtype))
        del table
        self.head["w"].copy_(he_normal(g, (cfg.d_model, cfg.vocab), cfg.dtype,
                                       device=dev))
        if cfg.frontend == "vision":
            self.proj["w"].copy_(he_normal(g, (cfg.frontend_dim, cfg.d_model),
                                           cfg.dtype, device=dev))
        d, bt = cfg.d_model, cfg.block_type
        for blk in self.blocks:
            if "attn" in blk:
                a = blk["attn"]
                for name in ("wq", "wk", "wv", "wo"):
                    a[name].copy_(he_normal(g, tuple(a[name].shape),
                                            cfg.dtype, device=dev))
                for name in ("bq", "bk", "bv"):
                    if name in a:
                        a[name].zero_()
            parts = []
            if bt in ("dense", "hymba"):
                parts.append(("mlp", init_mlp(g, d, cfg.d_ff, cfg.gated_mlp,
                                              cfg.dtype, device=dev)))
            if bt == "moe":
                parts.append(("moe", moe_lib.init_moe(
                    g, d, cfg.d_ff, cfg.n_experts, cfg.n_shared_experts,
                    cfg.dtype, device=dev)))
            if bt == "hymba":
                parts.append(("ssm", ssm_lib.init_ssm(
                    g, d, cfg.ssm_state, cfg.dtype, expand=cfg.ssm_expand,
                    device=dev)))
            if bt == "rwkv":
                parts.append(("tm", rwkv_lib.init_rwkv_tm(
                    g, d, cfg.hd, cfg.dtype, device=dev)))
                parts.append(("cm", rwkv_lib.init_rwkv_cm(
                    g, d, cfg.d_ff, cfg.dtype, device=dev)))
            for key, m in parts:
                for name, w in m.items():
                    blk[key][name].copy_(w)
            del parts
            for ln in ("ln1", "ln2"):
                blk[ln]["gamma"].fill_(1.0)
                if "beta" in blk[ln]:
                    blk[ln]["beta"].zero_()
        self.final_norm["gamma"].fill_(1.0)
        return self

    # ------------------------------------------------------------------
    # norms / attention
    # ------------------------------------------------------------------

    def _norm(self, x, p, fs_key=None, fs=None):
        stats = fs.get(fs_key) if fs else None
        if "beta" in p:
            return layernorm(x, p["gamma"], p["beta"], stats)
        return rmsnorm(x, p["gamma"], stats)

    def _attn(self, x, p, fs=None, *, positions, cache_kv=None,
              cache_len=None, window=None, serve=None):
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

        def g(n):
            return fs.get(f"attn_{n}") if fs else None

        sp = self.spec
        q = tagging.dense_site(x, p["wq"], g("wq"), sp)
        k = tagging.dense_site(x, p["wk"], g("wk"), sp)
        v = tagging.dense_site(x, p["wv"], g("wv"), sp)
        if cfg.qkv_bias:
            q = tagging.bias_site(q, p["bq"], g("bq"))
            k = tagging.bias_site(k, p["bk"], g("bk"))
            v = tagging.bias_site(v, p["bv"], g("bv"))
        q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
        k = apply_rope(k.reshape(b, s, kv, hd), positions, cfg.rope_theta)
        v = v.reshape(b, s, kv, hd)
        win = cfg.sliding_window if window is None else window
        if cache_kv is not None and serve is not None:
            out = self._attn_serve(q, k, v, cache_kv, cache_len, serve,
                                   serve.resolved_window(cfg))
        elif cache_kv is not None:
            out = self._attn_legacy(q, k, v, cache_kv, cache_len, win)
        else:
            out = attn_lib.attention(q, k, v, causal=True, window=win,
                                     backend=cfg.backend)
        return tagging.dense_site(out.reshape(b, s, h * hd), p["wo"], g("wo"),
                                  sp)

    def _attn_legacy(self, q, k, v, cache_kv, cache_len: int, win: int):
        """The legacy dense cache (``transformer.py:238-264`` of the JAX
        package). q (B, S, H, hd); k/v (B, S, KV, hd); ``cache_kv`` this
        layer's (B, M, KV, hd) views in ``cfg.dtype``, written IN PLACE;
        ``cache_len`` the host int of the positions already cached. The
        step's k/v go into slots [len, len + S) (the start clamped so they
        fit, as ``dynamic_update_slice`` clamps); a windowed decode query
        (S == 1, 0 < win < M) sees the span of ``win`` slots from ``start =
        clip(len + 1 - win, 0, M - win)``, rebased into the span.

        Where the backend resolves to ``"cuda"``: a prefill (len 0, S > 1)
        runs the prompt's own k/v through the forward kernel (the cache's
        keys past S are masked in the plain path, so this is the same
        function); a decode step (S == 1) runs the decode kernel over the
        span as a (B, KV, span, hd) view, at ``pos = len - start``, window
        0; any other call raises. Elsewhere the plain attention with
        ``q_offset`` and ``kv_len``, as the JAX package computes it."""
        from repro_torch.kernels import dispatch
        cfg = self.cfg
        b, s, h, hd = q.shape
        kv = k.shape[2]
        ck, cv = cache_kv["k"], cache_kv["v"]
        m = ck.shape[1]
        at = max(0, min(cache_len, m - s))
        ck[:, at:at + s] = k.to(ck.dtype)
        cv[:, at:at + s] = v.to(cv.dtype)
        start, span = 0, m
        if s == 1 and win and win < m:
            start = max(0, min(cache_len + 1 - win, m - win))
            span = win
        if dispatch.resolve(cfg.backend, q.device) == "cuda":
            if cache_len == 0 and s > 1:
                return attn_lib._kernel_attention(q, k, v, win)
            if s != 1:
                raise NotImplementedError(
                    f"no CUDA kernel for a legacy-cache call of {s} tokens "
                    f"after {cache_len} cached (the kernels cover a prefill "
                    f"from an empty cache and one-token decode steps); pass "
                    f"backend='ref' for the plain path")
            pos = torch.full((b * kv,), cache_len - start, dtype=torch.int32,
                             device=q.device)
            og = dispatch.swa_decode(
                q[:, 0].reshape(b * kv, h // kv, hd).contiguous(),
                ck[:, start:start + span].permute(0, 2, 1, 3),
                cv[:, start:start + span].permute(0, 2, 1, 3), pos,
                window=0, backend=cfg.backend)
            return og.reshape(b, h, hd)[:, None].to(q.dtype)
        return attn_lib.attention(
            q, ck[:, start:start + span], cv[:, start:start + span],
            causal=True, window=win, q_offset=cache_len - start,
            kv_len=cache_len + s - start, backend=cfg.backend)

    def _attn_serve(self, q, k, v, cache_kv, cache_len, serve, win):
        """Serving cache paths: ring (fp8 or f32 payload) or the dense-f32
        ``window=0`` fallback, both decoding through ``swa_decode``.

        q (B, S, H, hd); k/v (B, S, KV, hd); ``cache_kv`` this layer's cache
        views (B, C, KV, hd) [+ (B, C, KV) scales], written IN PLACE;
        cache_len (B,) i32. S > 1 is prefill (windowed attention over the
        prompt, then pack the last C post-rope positions into their slots);
        S == 1 is one decode step (write slot ``pos % C``, then flash-decode
        over the cache)."""
        from repro_torch.kernels import dispatch
        from repro_torch.serve import cache as cache_lib
        cfg = self.cfg
        b, s, h, hd = q.shape
        kv = k.shape[2]
        ck, cv = cache_kv["k"], cache_kv["v"]
        cap = ck.shape[1]
        ring = serve.is_ring(cfg)
        fmt = serve.quant_fmt if ring else None
        backend = serve.backend or cfg.backend
        kern_win = cap if ring else 0
        scaled = "k_scale" in cache_kv

        if s > 1:
            out = attn_lib.attention(q, k, v, causal=True, window=win,
                                     backend=backend)
            idx = cache_lib.prefill_gather_index(s, cap)
            live = torch.as_tensor(idx >= 0, device=k.device)[None, :, None,
                                                              None]
            sel = torch.as_tensor(idx.clip(min=0), device=k.device)
            zero = torch.zeros((), dtype=k.dtype, device=k.device)
            gk = torch.where(live, k[:, sel], zero)
            gv = torch.where(live, v[:, sel], zero)
            kp, ks = cache_lib.encode_rows(gk, fmt, serve.scale_mode)
            vp, vs = cache_lib.encode_rows(gv, fmt, serve.scale_mode)
            ck.copy_(kp.to(ck.dtype))
            cv.copy_(vp.to(cv.dtype))
            if scaled:
                cache_kv["k_scale"].copy_(ks)
                cache_kv["v_scale"].copy_(vs)
            return out

        kp, ks = cache_lib.encode_rows(k, fmt, serve.scale_mode)
        vp, vs = cache_lib.encode_rows(v, fmt, serve.scale_mode)
        slot = (cache_len % cap).to(torch.int32)
        cache_lib.write_slot(ck, kp, slot)
        cache_lib.write_slot(cv, vp, slot)
        ksg = vsg = None
        if scaled:
            cache_lib.write_slot(cache_kv["k_scale"], ks, slot)
            cache_lib.write_slot(cache_kv["v_scale"], vs, slot)
            ksg = cache_kv["k_scale"].permute(0, 2, 1)     # (B, KV, C) view
            vsg = cache_kv["v_scale"].permute(0, 2, 1)
        # GQA kernel layout: query head c*G + r under KV head c; the cache
        # is handed over as a (B, KV, C, hd) view and read in place
        qg = q[:, 0].reshape(b * kv, h // kv, hd).contiguous()
        pos = cache_len.to(torch.int32).repeat_interleave(kv)
        og = dispatch.swa_decode(qg, ck.permute(0, 2, 1, 3),
                                 cv.permute(0, 2, 1, 3), pos, window=kern_win,
                                 k_scale=ksg, v_scale=vsg, backend=backend)
        return og.reshape(b, h, hd)[:, None].to(q.dtype)

    # ------------------------------------------------------------------
    # block / embedding / forward
    # ------------------------------------------------------------------

    def _block(self, x, p, fs=None, *, positions, cache=None,
               cache_len=None, serve=None):
        """Returns (y, aux): aux the MoE block's auxiliary loss, None for
        the other blocks. ``cache`` is this layer's cache views, written IN
        PLACE (its K/V and, for the recurrent blocks, their state)."""
        cfg = self.cfg
        if cfg.block_type == "rwkv":
            return self._rwkv_block(x, p, fs, cache), None
        h1 = self._norm(x, p["ln1"], "ln1", fs)
        kv_cache = (None if cache is None else
                    {k: cache[k] for k in _KV_KEYS if k in cache})
        attn_out = self._attn(h1, p["attn"], fs, positions=positions,
                              cache_kv=kv_cache, cache_len=cache_len,
                              serve=serve)
        if cfg.block_type == "hymba":
            out = ssm_lib.ssm_branch(
                h1, p["ssm"], _sub(fs, "ssm_"), state=cfg.ssm_state,
                spec=self.spec, chunk=cfg.scan_chunk,
                init_state=None if cache is None else cache["ssm_h"],
                conv_cache=None if cache is None else cache["conv"],
                return_state=cache is not None)
            if cache is not None:
                out, (new_h, new_conv) = out
                cache["ssm_h"].copy_(new_h)
                cache["conv"].copy_(new_conv)
            # parallel heads: the mean of the two branches (Hymba)
            x = x + 0.5 * (attn_out + out)
        else:
            x = x + attn_out
        h2 = self._norm(x, p["ln2"], "ln2", fs)
        if cfg.block_type == "moe":
            y, aux = moe_lib.moe_block(
                h2, p["moe"], _sub(fs, "moe_"), n_experts=cfg.n_experts,
                top_k=cfg.top_k, act=cfg.act,
                capacity_factor=cfg.capacity_factor, spec=self.spec)
            return x + y, aux
        return x + mlp(h2, p["mlp"], _sub(fs, "mlp_"), act=cfg.act,
                       gated=cfg.gated_mlp, spec=self.spec), None

    def _rwkv_block(self, x, p, fs, cache):
        """LayerNorm, time mix, LayerNorm, channel mix, each mix added to
        the residual; with ``cache`` the mixes start from its state
        (``tm_x``, ``wkv``, ``cm_x``) and write theirs back."""
        cfg = self.cfg
        h1 = self._norm(x, p["ln1"], "ln1", fs)
        out = rwkv_lib.time_mix(
            h1, p["tm"], _sub(fs, "tm_"), head_dim=cfg.hd, spec=self.spec,
            last_x=None if cache is None else cache["tm_x"],
            wkv_state=None if cache is None else cache["wkv"],
            chunk=cfg.scan_chunk, return_state=cache is not None)
        if cache is not None:
            out, (new_last, new_wkv) = out
            cache["tm_x"].copy_(new_last)
            cache["wkv"].copy_(new_wkv)
        x = x + out
        h2 = self._norm(x, p["ln2"], "ln2", fs)
        out = rwkv_lib.channel_mix(
            h2, p["cm"], _sub(fs, "cm_"), spec=self.spec,
            last_x=None if cache is None else cache["cm_x"],
            return_state=cache is not None)
        if cache is not None:
            out, new_last = out
            cache["cm_x"].copy_(new_last)
        return x + out

    def _embed_inputs(self, batch, params=None, fs=None):
        """Returns (h (B, S_total, d), positions (S_total,), n_front): the
        text's embedded tokens, after the projected ``pixel_embeds`` rows
        (n_front of them) under the vision frontend."""
        cfg = self.cfg
        params = params or {"embed": self.embed,
                            "proj": getattr(self, "proj", None)}
        tok = batch["tokens"].to(self.device, torch.long)
        h = tagging.embed_site(tok, params["embed"]["table"],
                               fs.get("embed") if fs else None,
                               self.embed_spec)
        n_front = 0
        if cfg.frontend == "vision":
            pe = batch["pixel_embeds"].to(self.device, cfg.dtype)
            img = tagging.dense_site(pe, params["proj"]["w"],
                                     fs.get("proj") if fs else None,
                                     self.spec)
            h = torch.cat([img, h], dim=1)
            n_front = pe.shape[1]
        return h, torch.arange(h.shape[1], device=self.device), n_front

    def _head(self, h, params=None, fs=None):
        params = params or {"final_norm": self.final_norm, "head": self.head}
        h = self._norm(h, params["final_norm"], "final_norm", fs)
        return tagging.dense_site(h, params["head"]["w"],
                                  fs.get("head") if fs else None,
                                  self.head_spec)

    def forward(self, batch: dict, fstats: dict | None = None,
                params: dict | None = None):
        """batch {"tokens": (B, S)} (+ "pixel_embeds" (B, Tf, frontend_dim)
        under the vision frontend) -> (logits (B, Tf + S, V), aux), aux's
        "n_front" the Tf image rows before the text and "aux_loss" the
        blocks' auxiliary losses over n_layers (zero for dense blocks). With
        ``fstats`` (the accumulators of :meth:`fstats`) every site is tagged;
        ``params`` defaults to the model's own tree (:meth:`params`)."""
        params = params if params is not None else self.params()
        h, positions, n_front = self._embed_inputs(batch, params, fstats)
        per_layer = _blk_stats(fstats, self.cfg.n_layers)
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux_loss = torch.zeros((), device=self.device)
        for p, fs_l in zip(params["blocks"], per_layer):
            if remat:
                h, a = checkpoint(self._block, h, p, fs_l,
                                  positions=positions, use_reentrant=False)
            else:
                h, a = self._block(h, p, fs_l, positions=positions)
            if a is not None:
                aux_loss = aux_loss + a
        aux = {"aux_loss": aux_loss / self.cfg.n_layers, "n_front": n_front}
        return self._head(h, params, fstats), aux

    def loss(self, params: dict, fstats: dict | None, batch: dict):
        """Mean next-token NLL (+ ``aux_loss_coef`` x the blocks' auxiliary
        loss): (loss, {"logits", "nll", "aux_loss"})."""
        cfg = self.cfg
        logits, aux = self.forward(batch, fstats, params)
        n_front = aux["n_front"]
        logits_text = logits[:, n_front:, :] if n_front else logits
        labels = batch["labels"].to(self.device, torch.long)
        logp = F.log_softmax(logits_text.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        mask = batch.get("mask")
        if mask is not None:
            mask = mask.to(self.device, torch.float32)
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            loss = nll.mean()
        total = loss + cfg.aux_loss_coef * aux["aux_loss"]
        return total, {"logits": logits_text, "nll": loss,
                       "aux_loss": aux["aux_loss"]}

    # ------------------------------------------------------------------
    # SP-NGD wiring: parameter tree, site registry, factor templates,
    # token counts (transformer.py:635-745 of the JAX package)
    # ------------------------------------------------------------------

    def params(self) -> dict:
        """The parameter tree: plain dicts of the model's own tensors, with
        ``blocks`` the list of per-layer dicts (and ``proj`` under the
        vision frontend)."""
        def tree(m):
            if isinstance(m, nn.ParameterDict):
                return {k: v for k, v in m.items()}
            return {k: tree(v) for k, v in m.items()}
        out = {"embed": tree(self.embed), "final_norm": tree(self.final_norm),
               "head": tree(self.head)}
        if self.cfg.frontend == "vision":
            out["proj"] = tree(self.proj)
        out["blocks"] = [tree(b) for b in self.blocks]
        return out

    def site_infos(self) -> dict[str, SiteInfo]:
        cfg = self.cfg
        lead = (cfg.n_layers,)
        d, h, kv, hd, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, cfg.d_ff, cfg.vocab)
        infos = {
            "embed": SiteInfo("embed", "embed/table", v, d, self.embed_spec),
            "head": SiteInfo("dense", "head/w", d, v, self.head_spec),
            "final_norm": SiteInfo("scale_bias", "final_norm/gamma", d, d),
        }
        if cfg.frontend == "vision":
            infos["proj"] = SiteInfo("dense", "proj/w", cfg.frontend_dim, d,
                                     self.spec)

        def blk(name, kind, path, d_in, d_out, beta=None, lead=lead):
            infos[f"blk/{name}"] = SiteInfo(
                kind, f"blocks/{path}", d_in, d_out, self.spec, lead=lead,
                beta_param=beta)

        bt = cfg.block_type
        beta = cfg.norm == "layernorm" or bt == "rwkv"
        blk("ln1", "scale_bias", "ln1/gamma", d, d,
            beta="blocks/ln1/beta" if beta else None)
        blk("ln2", "scale_bias", "ln2/gamma", d, d,
            beta="blocks/ln2/beta" if beta else None)
        if bt in ("dense", "moe", "hymba"):
            blk("attn_wq", "dense", "attn/wq", d, h * hd)
            blk("attn_wk", "dense", "attn/wk", d, kv * hd)
            blk("attn_wv", "dense", "attn/wv", d, kv * hd)
            blk("attn_wo", "dense", "attn/wo", h * hd, d)
            if cfg.qkv_bias:
                blk("attn_bq", "bias", "attn/bq", 0, h * hd)
                blk("attn_bk", "bias", "attn/bk", 0, kv * hd)
                blk("attn_bv", "bias", "attn/bv", 0, kv * hd)
        if bt in ("dense", "hymba"):
            blk("mlp_up", "dense", "mlp/up", d, ff)
            if cfg.gated_mlp:
                blk("mlp_gate", "dense", "mlp/gate", d, ff)
            blk("mlp_down", "dense", "mlp/down", ff, d)
        if bt == "moe":
            # the experts' sites are grouped: factors (L, E, nb, b, b)
            experts = lead + (cfg.n_experts,)
            blk("moe_router", "dense", "moe/router", d, cfg.n_experts)
            blk("moe_we_up", "grouped", "moe/we_up", d, ff, lead=experts)
            blk("moe_we_gate", "grouped", "moe/we_gate", d, ff, lead=experts)
            blk("moe_we_down", "grouped", "moe/we_down", ff, d, lead=experts)
            if cfg.n_shared_experts:
                sf = cfg.n_shared_experts * ff
                blk("moe_sh_up", "dense", "moe/sh_up", d, sf)
                blk("moe_sh_gate", "dense", "moe/sh_gate", d, sf)
                blk("moe_sh_down", "dense", "moe/sh_down", sf, d)
        if bt == "hymba":
            di, r = cfg.ssm_expand * d, max(1, d // 16)
            blk("ssm_in_proj", "dense", "ssm/in_proj", d, 2 * di)
            blk("ssm_xdb", "dense", "ssm/xdb", di, r + 2 * cfg.ssm_state)
            blk("ssm_dt_proj", "dense", "ssm/dt_proj", r, di)
            blk("ssm_out_proj", "dense", "ssm/out_proj", di, d)
        if bt == "rwkv":
            for nm in ("wr", "wk", "wv", "wg", "wo"):
                blk(f"tm_{nm}", "dense", f"tm/{nm}", d, d)
            blk("tm_w_lora_a", "dense", "tm/w_lora_a", d, rwkv_lib.LORA_R)
            blk("tm_w_lora_b", "dense", "tm/w_lora_b", rwkv_lib.LORA_R, d)
            for nm in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
                blk(f"tm_{nm}", "scale_bias", f"tm/{nm}", d, d)
            blk("tm_ln_scale", "scale_bias", "tm/ln_scale", d, d)
            blk("cm_wk", "dense", "cm/wk", d, ff)
            blk("cm_wv", "dense", "cm/wv", ff, d)
            blk("cm_wr", "dense", "cm/wr", d, d)
            blk("cm_cm_mu_k", "scale_bias", "cm/mu_k", d, d)
            blk("cm_cm_mu_r", "scale_bias", "cm/mu_r", d, d)
        return infos

    def fstats(self) -> dict:
        """Zero factor-statistic accumulators, flat {family: stats}, block
        families stacked (L, ...); views of one zero scalar each."""
        out = {}
        dev = self.device
        for fam, info in self.site_infos().items():
            if info.kind in ("dense", "grouped"):
                out[fam] = tagging.make_stats(info.spec, info.d_in,
                                              info.d_out, lead=info.lead,
                                              device=dev)
            elif info.kind == "embed":
                out[fam] = tagging.make_embed_stats(info.d_in, info.d_out,
                                                    info.spec, lead=info.lead,
                                                    device=dev)
            elif info.kind == "bias":
                out[fam] = tagging.make_bias_stats(info.d_out, lead=info.lead,
                                                   device=dev)
            elif info.kind == "scale_bias":
                out[fam] = tagging.make_scale_bias_stats(
                    info.d_out, lead=info.lead, device=dev)
        return out

    def site_counts(self, batch) -> dict:
        """{family: (n_a, n_g)}: tokens through each site (the text's
        through ``embed``, the image rows' through ``proj``, both through
        every other site, the experts' grouped sites included, as
        ``repro`` counts them), and the samples the loss averages over."""
        cfg = self.cfg
        tok = batch["tokens"]
        b = tok.shape[0]
        s_text = tok.shape[1] if tok.dim() > 1 else 1
        n_front = cfg.frontend_tokens if cfg.frontend == "vision" else 0
        n_total = b * (s_text + n_front)
        mask = batch.get("mask")
        n_loss = float(mask.sum()) if mask is not None else float(b * s_text)
        counts = {}
        for fam in self.site_infos():
            if fam == "embed":
                counts[fam] = (b * s_text, n_loss)
            elif fam == "proj":
                counts[fam] = (b * n_front, n_loss)
            else:
                counts[fam] = (n_total, n_loss)
        return counts

    # ------------------------------------------------------------------
    # serving: cache init / prefill / single-token decode
    # ------------------------------------------------------------------

    def init_cache(self, batch_size: int, max_len: int, dtype=None, *,
                   serve=None) -> dict:
        """With ``serve``, the serving cache (:meth:`_init_serve_cache`);
        without, the legacy layout (``transformer.py:511-532`` of the JAX
        package): ``len`` a 0-d int32, K/V ``(L, B, max_len, KV, hd)`` in
        ``dtype`` (default ``cfg.dtype``) for the blocks with attention;
        hymba's ``ssm_h`` (L, B, di, N) f32 and ``conv`` (L, B, 3, di);
        rwkv's ``tm_x`` / ``cm_x`` (L, B, 1, d) and ``wkv`` (L, B, h, hd,
        hd) f32. On the model's device."""
        if serve is not None:
            return self._init_serve_cache(batch_size, max_len, serve)
        cfg = self.cfg
        dtype = dtype or cfg.dtype
        n, b, d, hd = cfg.n_layers, batch_size, cfg.d_model, cfg.hd

        def zeros(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        c = {"len": zeros(dtype=torch.int32)}
        if cfg.block_type in ("dense", "moe", "hymba"):
            c["k"] = zeros(n, b, max_len, cfg.n_kv_heads, hd)
            c["v"] = zeros(n, b, max_len, cfg.n_kv_heads, hd)
        if cfg.block_type == "hymba":
            di = cfg.ssm_expand * d
            c["ssm_h"] = zeros(n, b, di, cfg.ssm_state, dtype=torch.float32)
            c["conv"] = zeros(n, b, ssm_lib.CONV_K - 1, di)
        if cfg.block_type == "rwkv":
            c["tm_x"] = zeros(n, b, 1, d)
            c["cm_x"] = zeros(n, b, 1, d)
            c["wkv"] = zeros(n, b, d // hd, hd, hd, dtype=torch.float32)
        return c

    def _init_serve_cache(self, b: int, max_len: int, serve) -> dict:
        """Ring buffer sized to the window (fp8 payload + per-row f32
        scales, or f32), or the dense-f32 fallback when the resolved window
        is 0. ``len`` is a per-sequence (B,) position vector. Attention-only
        blocks (dense, moe) only, as the JAX package's."""
        from repro_torch.quant import quant
        from repro_torch.serve import cache as cache_lib
        cfg = self.cfg
        if cfg.block_type not in ("dense", "moe"):
            raise NotImplementedError(
                f"serve caches cover attention-only blocks (dense/moe); "
                f"got block_type={cfg.block_type!r}")
        win = serve.resolved_window(cfg)
        ring = serve.is_ring(cfg)
        if not ring and win:
            raise ValueError(
                "serve kv_cache='dense' supports window == 0 only (a "
                "windowed dense decode belongs to the legacy serve=None "
                "path or the ring cache)")
        cap = cache_lib.ring_capacity(win, max_len) if ring else max_len
        shape = (cfg.n_layers, b, cap, cfg.n_kv_heads, cfg.hd)
        dev = self.device
        c = {"len": torch.zeros((b,), dtype=torch.int32, device=dev)}
        fmt = serve.quant_fmt if ring else None
        pdt = torch.float32 if fmt is None else quant.FORMATS[fmt]
        c["k"] = torch.zeros(shape, dtype=pdt, device=dev)
        c["v"] = torch.zeros(shape, dtype=pdt, device=dev)
        if fmt is not None:
            c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
            c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        return c

    def decode_step(self, cache: dict, tokens: torch.Tensor, *, serve=None,
                    params: dict | None = None):
        """tokens (B,) -> (logits (B, V), cache). One decode position; the
        cache is updated IN PLACE (and returned), so a step never copies it.
        With ``serve`` the cache is the serving layout (per-sequence ``len``
        (B,)); without it the legacy layout (0-d ``len``, read to the host
        once a step). ``params`` defaults to the model's own tree."""
        params = params if params is not None else self.params()
        tok = tokens.to(self.device, torch.long)[:, None]
        h = tagging.embed_site(tok, params["embed"]["table"])
        pos = cache["len"]
        if serve is not None:
            positions, cache_len = pos[:, None], pos    # (B, 1) per-seq rope
        else:
            positions = pos + torch.arange(1, device=self.device)
            # the dry run's meta cache holds no length: a step at a full
            # cache, the span repro's static-shape decode attends over
            cache_len = (cache["k"].shape[2] - 1 if "k" in cache else 0) \
                if pos.is_meta else int(pos)
        for layer, p in enumerate(params["blocks"]):
            sub = {k: t[layer] for k, t in cache.items() if k != "len"}
            h, _ = self._block(h, p, positions=positions, cache=sub,
                               cache_len=cache_len, serve=serve)
        cache["len"] = pos + 1
        return self._head(h, params)[:, 0, :], cache

    def prefill(self, batch: dict, max_len: int, *, serve=None):
        """Forward over the prompt + cache fill: (logits (B, S, V), cache)
        with ``len`` = S for every sequence. Under the vision frontend the
        batch's ``pixel_embeds`` rows come first: S counts them, and so do
        the logits and ``len``. Without ``serve`` the legacy cache, its
        ``len`` a 0-d S."""
        b = batch["tokens"].shape[0]
        cache = self.init_cache(b, max_len, serve=serve)
        h, positions, _ = self._embed_inputs(batch)
        len0 = (torch.zeros((b,), dtype=torch.int32, device=self.device)
                if serve is not None else 0)
        for layer, p in enumerate(self.blocks):
            sub = {k: t[layer] for k, t in cache.items() if k != "len"}
            h, _ = self._block(h, p, positions=positions, cache=sub,
                               cache_len=len0, serve=serve)
        slen = torch.tensor(h.shape[1], dtype=torch.int32, device=self.device)
        cache["len"] = slen.expand(b).clone() if serve is not None else slen
        return self._head(h), cache

    # ------------------------------------------------------------------
    # dry-run input stand-ins (transformer.py:751-771 of the JAX package)
    # ------------------------------------------------------------------

    def input_specs(self, shape) -> dict:
        """The batch of a ``configs.base.InputShape`` as meta tensors (no
        allocation), ``repro``'s shapes: train ``tokens``/``labels`` (B, S)
        int32, prefill ``tokens``, and ``pixel_embeds`` (B, frontend_tokens,
        frontend_dim) bf16 under the vision frontend; decode one token
        (B,) and the legacy cache of length S (:meth:`init_cache`, on the
        model's device: this is meant for a model built on meta)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind in ("train", "prefill"):
            batch = {"tokens": _meta((b, s), i32)}
            if shape.kind == "train":
                batch["labels"] = _meta((b, s), i32)
            if cfg.frontend == "vision":
                batch["pixel_embeds"] = _meta(
                    (b, cfg.frontend_tokens, cfg.frontend_dim),
                    torch.bfloat16)
            return batch
        return {"tokens": _meta((b,), i32),
                "cache": self.init_cache(b, s)}


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _sub(fs, prefix: str):
    """Sub-view of a block's stats dict by key prefix."""
    if fs is None:
        return None
    return {k[len(prefix):]: v for k, v in fs.items() if k.startswith(prefix)}


def _blk_stats(fstats, n_layers: int) -> list:
    """Block families ("blk/<name>", stacked (L, ...)) -> one
    {"<name>": {key: (...)}} dict per layer. ``unbind`` hands the layers
    views of each accumulator, and its backward stacks the per-layer raw
    sums back into the (L, ...) family in one copy; a wire-format
    accumulator ({"payload", "scale"}) is split part by part."""
    if fstats is None:
        return [None] * n_layers
    out = [{} for _ in range(n_layers)]
    for fam, stats in fstats.items():
        if not fam.startswith("blk/"):
            continue
        for key, t in stats.items():
            if isinstance(t, dict):
                parts = {k: v.unbind(0) for k, v in t.items()}
                per_layer = [{k: v[layer] for k, v in parts.items()}
                             for layer in range(n_layers)]
            else:
                per_layer = t.unbind(0)
            for layer, t_l in enumerate(per_layer):
                out[layer].setdefault(fam[4:], {})[key] = t_l
    return out
