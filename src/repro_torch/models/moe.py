"""Mixture-of-Experts FFN: top-k routing with capacity, shared experts.

The port of ``repro.models.moe``: the Switch/MaxText-style "dropping"
implementation. Token->expert assignments get a position-in-expert from a
cumulative sum over the one-hot assignment matrix; assignments past the
expert capacity are dropped (their tokens pass through the residual
unchanged). Dispatch and return are an indexed write and a gather, and the
expert FFN is one batched product over each group's (E, C, D) buffer. Names
are the JAX package's, so ``convert.params_from_jax`` maps them by name.

qwen2-moe also has shared experts that see every token; olmoe does not. The
router's aux (load-balancing) loss follows Switch: E * sum_e f_e * p_e.

Precision and order follow the JAX code, so that the same inputs pick the
same experts and drop the same assignments:

* the router is an fp32 product with TF32 off, through the naive backend
  whatever ``cfg.matmul_backend`` says, so kind ``auto`` never sees it as a
  call site (a flipped top-k pick changes the output discontinuously);
* the top-k gates are renormalized to sum to 1;
* each dispatch slot below capacity receives exactly one token, so the
  dispatch is a plain indexed write; the overflow slot is never read;
* the combine adds a token's k weighted expert outputs in ascending k from
  zero, one rounding to the activation dtype per add, as the JAX scatter-add
  does on the CPU (``index_add_`` on the card adds in no fixed order), and
  the gate is cast to the activation dtype before it multiplies.

Under a sharding context (:mod:`repro_torch.models.sharding`) the block
constrains its input and output as the JAX package does, and the expert FFN
runs once per position (:func:`_expert_ffn_sharded`): the dispatch groups
over ``"batch"``, and the experts over ``"model"`` where the JAX layout puts
them there (the global dispatch group, and ``cfg.moe_expert_parallel``).
Then the token dispatch and the combine are ``reshard``s of the (G, E, C, D)
buffer between the token layout (experts whole) and the expert layout, and
their logical bytes are added to :data:`RESHARD_BYTES`. Without expert
parallelism the experts are replicated over ``"model"``, the JAX default:
each position all-gathers the expert weights it lacks. Routing, dispatch
and combine run on the global tensors.

**Dropless, over a share of the experts** (``cfg.moe_dropless``; the port's
own route, which the JAX package lacks). Every top-k assignment to a held
expert is computed and none is dropped, as OLMoE trains. The layer holds
experts ``[cfg.expert_first, cfg.expert_first + cfg.held_experts)`` of the
router's ``n_experts`` (one chip's share under expert parallelism; all by
default): it routes over all of them, as does the aux loss, and computes
the part of the result its own experts give. The held assignments are
sorted by expert (stable), gathered into one buffer of T*k rows (the most a
step can hold, so that no size is read on the host) and run as grouped
products over each expert's contiguous rows (``torch._grouped_mm``, which
leaves the rows past the last offset as they fall: NaN on the card); those
rows are never read. The combine
adds each token's k terms in ascending k as above; the backward of the
dispatch adds each token's k rows as one sum over k, and that of the
combine's gather gathers by the inverse permutation: no atomics.
``cfg.norm_topk_prob`` False keeps the top-k gates as the router gave them.

With the tracer on (``repro_torch.obs``) the block records the spans
``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``, each
with ``layer`` and ``tokens``; with its profiler annotations on, a
``torch.profiler`` trace attributes each span's device time to it. The
dropless route adds ``held_assignments`` and ``max_expert_load`` to them
and counts the routed load in ``obs.get_metrics()`` (the ``MOE_*`` names
of ``obs.metrics``), which reads the counts on the host; with
the tracer off it touches no counter and reads nothing back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core.mesh import Sharded, gather, reshard, shard
from repro_torch.core.precision import matmul_precision
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Linear, init_linear, linear
from repro_torch.models.mlp import _ACTS, MLP, init_mlp, mlp_block
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.tracer import get_tracer

__all__ = ["MoE", "init_moe", "moe_block", "RESHARD_BYTES"]

_F32 = torch.float32

# Logical bytes of the sharded expert FFN's token dispatch and combine
# reshards since the process started (zero them to read one run's).
RESHARD_BYTES = {"dispatch": 0, "combine": 0}


class MoE(nn.Module):
    """``router`` (d, E) in fp32 without bias, batched expert weights
    ``w_gate``, ``w_up`` (held, D, F) and ``w_down`` (held, F, D) of the
    ``cfg.held_experts`` experts this layer holds, and ``shared``
    (an MLP of width d_expert * n_shared_experts) when the config has shared
    experts."""

    def __init__(self, router: Linear, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, shared: Optional[MLP] = None):
        super().__init__()
        self.router = router
        self.w_gate = nn.Parameter(w_gate, requires_grad=False)
        self.w_up = nn.Parameter(w_up, requires_grad=False)
        self.w_down = nn.Parameter(w_down, requires_grad=False)
        self.shared = shared


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> MoE:
    """Normal draws in fp32, scaled, then cast, as the JAX package does."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    held = cfg.held_experts

    def draw(shape, scale):
        w = torch.randn(shape, generator=gen, device=gen.device, dtype=_F32)
        return (w * scale).to(dtype)

    router = init_linear(gen, d, (e,), _F32)
    w_gate, w_up = draw((held, d, f), d**-0.5), draw((held, d, f), d**-0.5)
    w_down = draw((held, f, d), f**-0.5)
    shared = None
    if cfg.n_shared_experts:
        shared = init_mlp(gen, cfg, dtype, d_ff=cfg.d_expert * cfg.n_shared_experts)
    return MoE(router, w_gate, w_up, w_down, shared)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cap, cfg.top_k)


def _route(params: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """Router top-k (fp32): returns (gates (T, k), experts (T, k), aux)."""
    e, k = cfg.n_experts, cfg.top_k
    with matmul_precision("highest"):  # TF32 off
        logits = linear(params.router, xt.to(_F32), site="moe.router")  # (T, E), naive backend
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # descending, as lax.top_k
    if cfg.norm_topk_prob:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    # aux load-balance loss (Switch eq. 4)
    me = probs.mean(dim=0)
    frac = F.one_hot(expert_idx, e).to(_F32).sum(dim=1).mean(dim=0)
    aux = e * (me * frac).sum() * cfg.router_aux_coef
    return gate_vals, expert_idx, aux


def _slots(expert_idx: torch.Tensor, cfg: ModelConfig, cap: int):
    """Position-in-expert of each assignment, over the flattened (t, k) order
    of the last dim: (keep, slot) with dropped assignments in slot ``cap``.
    The one-hot matrix is scanned along its last dim, (E, T*k): on the card
    PyTorch scans an outer dim with one thread per column walking all T*k
    rows, which took most of a prefill's MoE time; an integer cumsum is
    exact in either layout."""
    onehot = F.one_hot(expert_idx, cfg.n_experts).transpose(-1, -2).contiguous()  # (..., E, T*k)
    counts = onehot.cumsum(dim=-1)
    pos_in_e = torch.gather(counts, -2, expert_idx.unsqueeze(-2)).squeeze(-2) - 1
    keep = pos_in_e < cap
    return keep, torch.where(keep, pos_in_e, cap)


def _ffn(expert_in, w_gate, w_up, w_down, act) -> torch.Tensor:
    """(..., E, C, D) -> (..., E, C, D): the three batched expert products."""
    gate = torch.einsum("...ecd,edf->...ecf", expert_in, w_gate)
    up = torch.einsum("...ecd,edf->...ecf", expert_in, w_up)
    return torch.einsum("...ecf,efd->...ecd", act(gate) * up, w_down)


def _expert_ffn(params: MoE, expert_in: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(G, E, C, D) -> (G, E, C, D), per position under a sharding context."""
    act = _ACTS[cfg.act]
    weights = (params.w_gate, params.w_up, params.w_down)
    ctx = sharding.current()
    if ctx is None:
        return _ffn(expert_in, *weights, act)
    return _expert_ffn_sharded(expert_in, weights, act, cfg, ctx)


def _expert_ffn_sharded(expert_in, weights, act, cfg: ModelConfig, ctx) -> torch.Tensor:
    """The expert FFN as one local phase per position.

    The layouts are the JAX package's constraints on (G, E, C, D): the
    global dispatch group pins ``(None, "experts", None, "d_model")``
    (``moe.py:92``), a per-row group ``("batch", "experts" with
    moe_expert_parallel else None, None, None)`` (``moe.py:162``), and the
    weights ``("experts", None, None)`` (``moe.py:100-102,167-169``). The
    buffer arrives in the token layout (experts whole); a dispatch
    ``reshard`` moves it to the expert layout and the combine ``reshard``
    moves the products back. A position whose expert slab is not its
    weight slab all-gathers the weights over their axes.
    """
    mesh, rules = ctx
    rows = "batch" if cfg.moe_group_dispatch else None
    shape = tuple(expert_in.shape)
    if cfg.moe_group_dispatch:
        exp_logical = (rows, "experts" if cfg.moe_expert_parallel else None, None, None)
    else:
        exp_logical = (None, "experts", None, "d_model")
    tok_spec = rules.spec(mesh, (rows, None, None, None), shape, allow_uneven=True)
    exp_spec = rules.spec(mesh, exp_logical, shape, allow_uneven=True)
    sharding.note(mesh, exp_spec)
    xs = shard(expert_in, mesh, tok_spec)
    if exp_spec != tok_spec:
        before = mesh.logical_bytes
        xs = reshard(xs, exp_spec)
        RESHARD_BYTES["dispatch"] += mesh.logical_bytes - before
    w_locals = []
    for w in weights:
        w_spec = rules.spec(mesh, ("experts", None, None), tuple(w.shape), allow_uneven=True)
        sharding.note(mesh, w_spec)
        loc = shard(w, mesh, w_spec).locals
        if w_spec[0] is not None and exp_spec[1] is None:  # experts replicated over the axes
            loc = mesh.all_gather(loc, w_spec[0])
        w_locals.append(loc)
    out = mesh.map(lambda x, a, b, c: _ffn(x, a, b, c, act), xs.locals, *w_locals)
    out_sh = Sharded(mesh, exp_spec, shape, out, expert_in.dtype)
    if exp_spec != tok_spec:
        before = mesh.logical_bytes
        out_sh = reshard(out_sh, tok_spec)
        RESHARD_BYTES["combine"] += mesh.logical_bytes - before
    return gather(out_sh)


def _combine(weighted: torch.Tensor, k: int) -> torch.Tensor:
    """(..., T*k, D) -> (..., T, D): each token's k terms added in ascending k
    from zero, rounding to the dtype after each add."""
    w = weighted.unflatten(-2, (-1, k))
    out = torch.zeros_like(w[..., 0, :])
    for j in range(k):
        out = out + w[..., j, :]
    return out


def _grouped_moe(params: MoE, x: torch.Tensor, cfg: ModelConfig,
                 layer: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch -> batched expert FFN -> weighted combine over
    (G, S, D): G dispatch groups of S tokens, threaded through every op as a
    leading axis. Indices are group-local and capacity is enforced per group;
    the router and its aux loss see all G*S tokens."""
    g, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, cfg)
    tracer = get_tracer()
    at = {"layer": layer, "tokens": g * s}

    if cfg.moe_group_dispatch:
        x = sharding.constrain(x, "batch", None, None)
    with tracer.span("moe.route", cat="moe", **at):
        gate_vals, expert_idx, aux = _route(params, x.reshape(g * s, d), cfg)
    with tracer.span("moe.dispatch", cat="moe", **at):
        gv = gate_vals.reshape(g, s * k)  # fp32
        ei = expert_idx.reshape(g, s * k)
        keep, slot = _slots(ei, cfg, cap)  # position-in-expert WITHIN each group
        # flat buffer (G*E*(C+1), D); index = ((g*E)+e)*(C+1)+slot. Kept slots
        # are unique; the overflow slot is never read.
        token_of = torch.arange(s, device=x.device).repeat_interleave(k)
        flat_idx = ((torch.arange(g, device=x.device)[:, None] * e + ei) * (cap + 1) + slot).reshape(-1)
        buf = torch.zeros((g * e * (cap + 1), d), dtype=x.dtype, device=x.device)
        buf[flat_idx] = x[:, token_of].reshape(-1, d)
    with tracer.span("moe.experts", cat="moe", **at):
        expert_out = _expert_ffn(params, buf.reshape(g, e, cap + 1, d)[:, :, :cap], cfg)
    with tracer.span("moe.combine", cat="moe", **at):
        padded = torch.cat([expert_out, expert_out.new_zeros((g, e, 1, d))], dim=2).reshape(-1, d)  # overflow reads 0
        gathered = padded[flat_idx].reshape(g, s * k, d)
        weighted = gathered * (gv * keep.to(_F32)).to(x.dtype)[..., None]
        return _combine(weighted, k), aux


class _Dispatch(torch.autograd.Function):
    """The rows of ``x`` that ``token`` names, in its order. The backward
    gathers each token's k rows back (``slot_of``, (T, k)) and adds those of
    held assignments as one sum over k: no atomics, and the rows that were
    never computed (past the held ones) are never read."""

    @staticmethod
    def forward(ctx, x, token, slot_of, held):
        ctx.save_for_backward(slot_of, held)
        return x.index_select(0, token)

    @staticmethod
    def backward(ctx, g):
        slot_of, held = ctx.saved_tensors
        rows = g.index_select(0, slot_of.reshape(-1)).unflatten(0, slot_of.shape)
        return torch.where(held[..., None], rows, 0).sum(1), None, None, None


class _Permute(torch.autograd.Function):
    """``rows[index]`` for a permutation ``index`` whose inverse is
    ``inverse``: the backward gathers by the inverse, with no atomics."""

    @staticmethod
    def forward(ctx, rows, index, inverse):
        ctx.save_for_backward(inverse)
        return rows.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        return g.index_select(0, inverse), None, None


def _record_load(offs: torch.Tensor, cfg: ModelConfig, layer, tokens: int) -> dict:
    """With the tracer on: count the layer's load and return its span
    attributes (reads the offsets on the host). Called before the expert
    products: a rematerialization's recompute stops after the last op whose
    result the backward keeps, and would skip a count made after them."""
    ends = offs.tolist()
    loads = [b - a for a, b in zip([0] + ends, ends)]
    held = ends[-1]
    reg = obs_metrics.get_metrics()
    reg.counter(obs_metrics.MOE_TOKENS_ROUTED).inc(tokens)
    reg.counter(obs_metrics.MOE_ASSIGNMENTS_HELD).inc(held)
    reg.counter(obs_metrics.MOE_ASSIGNMENTS_ELSEWHERE).inc(tokens * cfg.top_k - held)
    for i, n in enumerate(loads):
        reg.counter(f"{obs_metrics.MOE_EXPERT_LOAD}{cfg.expert_first + i}").inc(n)
    return {"layer": layer, "tokens": tokens, "held_assignments": held,
            "max_expert_load": max(loads)}


def _dropless_moe(params: MoE, x: torch.Tensor, cfg: ModelConfig,
                  layer: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, D) -> (T, D): every top-k assignment to a held expert, computed
    as grouped products over the held experts' sorted rows (see the module's
    docstring), and the router's aux loss over all ``n_experts``."""
    if sharding.current() is not None:
        raise NotImplementedError("the dropless route runs without a sharding context")
    t = x.shape[0]
    k, n_held, first = cfg.top_k, cfg.held_experts, cfg.expert_first
    tracer = get_tracer()
    with tracer.span("moe.route", cat="moe") as route:
        gate_vals, expert_idx, aux = _route(params, x, cfg)
    with tracer.span("moe.dispatch", cat="moe") as dispatch:
        local = expert_idx - first
        held = (local >= 0) & (local < n_held)  # (T, k)
        key = torch.where(held, local, n_held).reshape(-1)  # elsewhere sorts last
        sorted_key, order = torch.sort(key, stable=True)
        offs = torch.searchsorted(
            sorted_key, torch.arange(1, n_held + 1, device=x.device)).to(torch.int32)
        slot_of = torch.empty_like(order).scatter_(
            0, order, torch.arange(t * k, device=x.device)).view(t, k)
        rows = _Dispatch.apply(x, order // k, slot_of, held)  # (T*k, D)
    at = {}
    if tracer.enabled:
        at = _record_load(offs, cfg, layer, t)
        route.set(**at)
        dispatch.set(**at)
    with tracer.span("moe.experts", cat="moe", **at):
        gate = torch._grouped_mm(rows, params.w_gate, offs=offs)
        up = torch._grouped_mm(rows, params.w_up, offs=offs)
        out_rows = torch._grouped_mm(_ACTS[cfg.act](gate) * up, params.w_down, offs=offs)
    with tracer.span("moe.combine", cat="moe", **at):
        terms = _Permute.apply(out_rows, slot_of.reshape(-1), order)  # (T*k, D) in (t, k) order
        terms = torch.where(held.reshape(-1, 1), terms, 0)
        out = _combine(terms * gate_vals.reshape(-1).to(x.dtype)[:, None], k)
    return out, aux


def moe_block(params: MoE, x: torch.Tensor, cfg: ModelConfig,
              layer: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> (B, S, D), plus the scalar router aux loss. ``layer`` is
    the block's index, for the spans.

    Default: one GLOBAL dispatch group of all B*S tokens (exact Switch
    semantics; capacity counts the whole batch). ``moe_group_dispatch``: one
    group per batch row, capacity per row. ``moe_expert_parallel`` picks the
    JAX package's expert-parallel layout, which differs from the per-row
    route only in its sharding constraints: both are this grouped
    computation, and under a sharding context the flag decides whether the
    expert FFN shards its experts over ``"model"``. ``moe_dropless``: no
    capacity, over the held experts (:func:`_dropless_moe`).
    """
    b, s, d = x.shape
    if cfg.moe_dropless:
        out, aux = _dropless_moe(params, x.reshape(b * s, d), cfg, layer)
    else:
        groups = x if cfg.moe_group_dispatch else x.reshape(1, b * s, d)
        out, aux = _grouped_moe(params, groups, cfg, layer)
    out = out.reshape(b, s, d)
    if params.shared is not None:
        out = out + mlp_block(params.shared, x, cfg)
    return sharding.constrain(out, "batch", "seq", "d_model"), aux
