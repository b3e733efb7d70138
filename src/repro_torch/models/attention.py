"""Attention blocks: GQA/MQA/MHA, full/causal/local, prefill + decode paths.

The port of ``repro.models.attention``. Two execution paths, one semantics:

  * prefill/train — :func:`repro_torch.kernels.flash_attention.ops.flash_attention`
    over the whole sequence: the hand-written CUDA flash kernel on the card
    (where the JAX model calls its pure-JAX ``chunked_attention``, the XLA
    equivalent of the Pallas flash kernel), its plain version on the CPU;
  * decode — :func:`decode_attention`, one query token against a cache,
    plain PyTorch as in the JAX package.

Caches are updated in place (the JAX code returns new arrays): a cache
passed to :func:`attention_block` is the one it returns, written. A cache
may be stored in fp8 (``cfg.cache_dtype="float8_e4m3fn"``): it is written
through uint8 views of its storage (:func:`as_bits`), and the prefill's
flash attention reads the fp8-rounded K/V upcast to q's dtype, which is
exact, as the JAX ``chunked_attention`` upcasts them to fp32.
Cross-attention (the encoder-decoder family, whisper) runs flash attention
without a mask against K/V computed once from the encoder's output. With
``cfg.qk_norm`` (olmoe) the q and k projections each pass an RMSNorm over
their whole width before RoPE: the RMSNorm kernel, forward and backward.

Under a sharding context (:mod:`repro_torch.models.sharding`) q, k and v are
constrained as the JAX package constrains them, and the attention core (the
flash kernel, or :func:`decode_attention`) runs once per position on its
(batch slab, head slab) of q and the kv heads those heads read under GQA
(:func:`_per_position`); the result is gathered. The projections run per
position in ``backend.matmul``. Cross-attention carries no constraint in the
JAX package and runs on the global tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.mesh import P, Sharded, fetch, gather, shard, spec_axes
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Linear, Norm, init_linear, linear, rmsnorm
from repro_torch.models.rope import apply_mrope, apply_rope

__all__ = [
    "Attention",
    "init_attention",
    "attention_block",
    "decode_attention",
    "init_kv_cache",
    "init_cross_attention",
    "cross_attention_block",
    "encode_cross_kv",
    "as_bits",
]

_NEG_INF = -1e30


class Attention(nn.Module):
    """Projections ``wq``, ``wk``, ``wv`` (d, n*hd) and ``wo`` (n*hd, d), stored flat;
    with ``cfg.qk_norm`` also ``q_norm`` (h*hd) and ``k_norm`` (hkv*hd), RMSNorms
    over the whole q and k projections."""

    def __init__(self, wq: Linear, wk: Linear, wv: Linear, wo: Linear,
                 q_norm: Optional[Norm] = None, k_norm: Optional[Norm] = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        if q_norm is not None:
            self.q_norm, self.k_norm = q_norm, k_norm


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Attention:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    norms = ((Norm("rmsnorm", h * hd, dtype, gen.device), Norm("rmsnorm", hkv * hd, dtype, gen.device))
             if cfg.qk_norm else ())
    return Attention(
        init_linear(gen, d, (h * hd,), dtype, bias=cfg.qkv_bias),
        init_linear(gen, d, (hkv * hd,), dtype, bias=cfg.qkv_bias),
        init_linear(gen, d, (hkv * hd,), dtype, bias=cfg.qkv_bias),
        init_linear(gen, h * hd, (d,), dtype, scale=(h * hd) ** -0.5),
        *norms,
    )


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype, device) -> dict:
    cache_dtype = getattr(torch, cfg.cache_dtype) if cfg.cache_dtype else dtype
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cache_dtype, device=device),
        "v": torch.zeros(shape, dtype=cache_dtype, device=device),
    }


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention against a cache: q (B, Hq, 1, d), cache (B, Hkv, S, d).

    Positions > pos (unwritten cache) and, with a window, <= pos - window
    are masked. ``pos`` is a scalar (lockstep batch) or (B,) per-row
    positions (continuous-batching slots). q is scaled and rounded to the
    cache's dtype, the products accumulate in fp32 (the JAX code's
    ``preferred_element_type``), and the probabilities are rounded to the
    cache's dtype before the product with v.
    """
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    scale = scale if scale is not None else d**-0.5
    pos = torch.as_tensor(pos, device=q.device)
    pos = pos[:, None] if pos.ndim == 1 else pos.reshape(1, 1)  # (B or 1, 1)
    qg = (q.reshape(b, hkv, g, d).float() * scale).to(k_cache.dtype)
    scores = torch.matmul(qg.float(), k_cache.float().transpose(-1, -2))  # (B, Hkv, g, S)
    cols = torch.arange(s, device=q.device)[None, :]
    live = cols <= pos  # (B or 1, S)
    if window is not None:
        live = live & (cols > pos - window)
    scores = torch.where(live[:, None, None, :], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p.to(v_cache.dtype).float(), v_cache.float())  # (B, Hkv, g, d)
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _project_qkv(params: Attention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    backend = cfg.matmul_backend
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(params.wq, x, backend, w_logical=("fsdp", "heads"), site="attn.wq")
    k = linear(params.wk, x, backend, w_logical=("fsdp", "heads"), site="attn.wk")
    if cfg.qk_norm:
        q, k = rmsnorm(params.q_norm, q, cfg.norm_eps), rmsnorm(params.k_norm, k, cfg.norm_eps)
    q, k = q.reshape(b, s, h, hd), k.reshape(b, s, hkv, hd)
    v = linear(params.wv, x, backend, w_logical=("fsdp", "heads"), site="attn.wv").reshape(b, s, hkv, hd)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)  # (B, H, S, hd)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = sharding.constrain(q, *_Q_LOGICAL)
    k = sharding.constrain(k, *_KV_LOGICAL)
    v = sharding.constrain(v, *_KV_LOGICAL)
    return q, k, v


_Q_LOGICAL = ("batch", "heads", "seq", "head_dim")
_KV_LOGICAL = ("batch", "kv_heads", "seq", "head_dim")
_CACHE_LOGICAL = ("batch", "kv_heads", "cache_seq", None)  # launch/specs.py's cache rule


def _local_core(core, q, k, v, pos, kv_dtype, h0: int, h1: int, group: int):
    """One position's attention: q heads [h0, h1) against the kv heads they
    read. Whole GQA groups keep the grouped layout; a slab that cuts a group
    reads one kv head per q head (group 1)."""
    if q.numel() == 0:
        return torch.empty_like(q)
    if k.dtype != kv_dtype:  # an fp8 cache's bits (a dtype view records no gradient)
        k, v = k.view(kv_dtype), v.view(kv_dtype)
    if h0 % group or (h1 - h0) % group:
        idx = torch.arange(h0, h1, device=q.device) // group - h0 // group
        k, v = k.index_select(1, idx), v.index_select(1, idx)
    return core(q, k, v, pos)


def _per_position(core, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos=None,
                  kv_logical=_KV_LOGICAL) -> torch.Tensor:
    """``core(q, k, v, pos)``: on the global tensors with no sharding
    context; under one, once per position on its slabs.

    q (B, Hq, Sq, d) is cut by ``("batch", "heads", ...)``; each position
    fetches, from k and v laid out by ``kv_logical``, its batch rows and the
    kv heads its q heads read (a ``reshard`` in ``mesh.traffic``: zero bytes
    where its own kv slab holds them, as when the kv heads shard alongside
    the q heads or are replicated). A per-row ``pos`` (B,) is cut with the
    batch. An fp8 cache moves as its uint8 bits (:func:`as_bits`). Positions
    with the same slabs share one call, so the kernel launches once per
    distinct (batch slab, head slab).
    """
    ctx = sharding.current()
    if ctx is None:
        return core(q, k, v, pos)
    mesh, rules = ctx
    group = q.shape[1] // k.shape[1]
    q_spec = rules.spec(mesh, _Q_LOGICAL, tuple(q.shape), allow_uneven=True)
    kv_spec = rules.spec(mesh, kv_logical, tuple(k.shape), allow_uneven=True)
    sharding.note(mesh, kv_spec)
    q_sh = shard(q, mesh, q_spec)

    def kv_box(p):
        (b0, b1), (h0, h1) = q_sh.slab(p)[:2]
        heads = slice(0, 0) if h0 == h1 else slice(h0 // group, (h1 - 1) // group + 1)
        return [(slice(b0, b1), heads)]

    kv_axes = spec_axes(kv_spec)
    k_loc, v_loc = (
        fetch(shard(as_bits(t), mesh, kv_spec), kv_box, then=lambda p, got: got[0], axes=kv_axes)
        for t in (k, v)
    )
    if pos is not None and torch.as_tensor(pos).ndim == 1:
        pos_loc = shard(pos, mesh, P(q_spec[0])).locals
    else:
        pos_loc = mesh.run(lambda p: pos)
    heads, seen = np.empty(mesh.devices.shape, dtype=object), {}
    for p in mesh.positions():
        h = tuple(q_sh.slab(p)[1])
        heads[p] = seen.setdefault(h, h)  # one object per head slab, for map's grouping
    out = mesh.map(lambda qp, kp, vp, pp, h: _local_core(core, qp, kp, vp, pp, k.dtype, *h, group),
                   q_sh.locals, k_loc, v_loc, pos_loc, heads)
    return gather(Sharded(mesh, q_spec, tuple(q.shape), out, q.dtype))


_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """``t``, or for an fp8 tensor a uint8 view of the same storage.

    Index ops that move cache entries without arithmetic (``index_copy_``,
    indexed reads and writes, ``roll``, ``where``) run on the view: not every
    one has an fp8 kernel (``index_copy_`` has none on the CPU, neither
    ``index_copy_`` nor ``roll`` on the card in torch 2.11), and a copy of
    the bits is a copy of the values.
    """
    return t.view(torch.uint8) if t.dtype in _FP8 else t


def _cache_write(cache: torch.Tensor, kv: torch.Tensor, pos: torch.Tensor, vec: bool) -> torch.Tensor:
    """Write one token's K/V at ``pos``, in place: lockstep (scalar pos) or
    per-row (vector pos, each batch row at its own sequence position)."""
    dst, src = as_bits(cache), as_bits(kv.to(cache.dtype))
    if not vec:
        dst.index_copy_(2, pos.reshape(1).long(), src)
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        dst[rows, :, pos.long(), :] = src[:, :, 0, :]
    return cache


def _prefix_write(cache: torch.Tensor, kv: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write a whole K/V prefix at scalar ``pos``, in place."""
    idx = pos.reshape(1).long() + torch.arange(kv.shape[2], device=cache.device)
    as_bits(cache).index_copy_(2, idx, as_bits(kv.to(cache.dtype)))
    return cache


def _roll(t: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll`` along the sequence axis, of the bits for fp8."""
    return torch.roll(as_bits(t), shift, dims=2).view(t.dtype)


def attention_block(
    params: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    cache: Optional[dict] = None,
    cache_pos: Optional[torch.Tensor] = None,
    ring: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full attention sub-block (pre-norm residual handled by caller).

    Train/prefill: flash attention over the whole sequence (the cache, if
    given, gets the K/V prefix at ``cache_pos``). Decode: cache given and
    S == 1 -> cache update + :func:`decode_attention`. ring: sliding-window
    ring-buffer cache of size == window (token t lives in slot t % W).
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)

    new_cache = None
    if cache is not None:
        # cache storage dtype may be quantized (cfg.cache_dtype)
        k = k.to(cache["k"].dtype)
        v = v.to(cache["v"].dtype)
    if cache is not None and s == 1:
        vec = cache_pos.ndim == 1  # per-row write positions (slot batch)
        if ring:
            w_size = cache["k"].shape[2]
            slot = cache_pos % w_size
            kc = _cache_write(cache["k"], k, slot, vec)
            vc = _cache_write(cache["v"], v, slot, vec)
            # every resident token is in-window by construction; mask only
            # the not-yet-written slots before the first wrap.
            pos_eff = torch.clamp(cache_pos, max=w_size - 1)
            out = _per_position(_decode_core(None), q, kc, vc, pos_eff, _CACHE_LOGICAL)
        else:
            kc = _cache_write(cache["k"], k, cache_pos, vec)
            vc = _cache_write(cache["v"], v, cache_pos, vec)
            out = _per_position(_decode_core(window), q, kc, vc, cache_pos, _CACHE_LOGICAL)
        new_cache = {"k": kc, "v": vc}
    else:
        # an fp8 cache: attend over the fp8-rounded K/V, upcast exactly
        out = _per_position(_flash_core(causal, window), q, k.to(q.dtype), v.to(q.dtype))
        if cache is not None and ring:
            w_size = cache["k"].shape[2]
            if s >= w_size:
                # keep only the last W tokens; token t -> slot t % W.
                shift = (s - w_size) % w_size
                kc = _roll(k[:, :, -w_size:], shift)
                vc = _roll(v[:, :, -w_size:], shift)
            else:
                kc = _prefix_write(cache["k"], k, cache_pos)
                vc = _prefix_write(cache["v"], v, cache_pos)
            new_cache = {"k": kc, "v": vc}
        elif cache is not None:
            new_cache = {
                "k": _prefix_write(cache["k"], k, cache_pos),
                "v": _prefix_write(cache["v"], v, cache_pos),
            }

    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    out = linear(params.wo, out, cfg.matmul_backend, w_logical=("heads", "fsdp"), site="attn.wo")
    return sharding.constrain(out, "batch", "seq", "d_model"), new_cache


def _flash_core(causal: bool, window: Optional[int]):
    return lambda q, k, v, _pos: flash_attention(q, k, v, causal=causal, window=window)


def _decode_core(window: Optional[int]):
    return lambda q, k, v, pos: decode_attention(q, k, v, pos, window=window)


# ------------------------------------------------------------ cross-attention


def init_cross_attention(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Attention:
    return init_attention(gen, cfg, dtype)


def cross_attention_block(
    params: Attention,
    x: torch.Tensor,
    enc_kv: Tuple[torch.Tensor, torch.Tensor],
    cfg: ModelConfig,
) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (whisper):
    flash attention without a mask, in the prefill and at every decode step."""
    b, s, _ = x.shape
    backend = cfg.matmul_backend
    q = linear(params.wq, x, backend, site="xattn.wq").reshape(b, s, cfg.n_heads, cfg.head_dim)
    k, v = enc_kv  # (B, Hkv, S_enc, hd)
    out = flash_attention(q.transpose(1, 2), k, v, causal=False)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return linear(params.wo, out, backend, site="xattn.wo")


def encode_cross_kv(params: Attention, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V (B, Hkv, S_enc, hd) from the encoder output (no RoPE)."""
    backend = cfg.matmul_backend
    b, s, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    k = linear(params.wk, enc_out, backend, site="xattn.wk").reshape(b, s, hkv, hd)
    v = linear(params.wv, enc_out, backend, site="xattn.wv").reshape(b, s, hkv, hd)
    return k.transpose(1, 2), v.transpose(1, 2)
