"""Model configuration shared by all 10 assigned architectures (a copy of
``repro.models.config``; ``matmul_backend`` is the port's MatmulBackend).

A single frozen dataclass describes every family (dense / moe / ssm /
audio / vlm / hybrid); the block_pattern drives which layer kinds are
instantiated. Frozen and hashable, so a config can key a cache.

The fields after the JAX package's (``qk_norm``, ``norm_topk_prob``,
``moe_dropless``, ``experts_held``, ``expert_first``) are the port's own;
their defaults are the JAX package's behaviour.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.backend import MatmulBackend, NAIVE_BACKEND

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "silu"  # silu | gelu
    glu: bool = True  # gated MLP (SwiGLU / GeGLU)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False  # qwen2-vl multimodal RoPE (3 position streams)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w head_dim split
    norm_eps: float = 1e-6
    norm: str = "rmsnorm"  # rmsnorm | layernorm (whisper)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0  # gemma-style final-logit softcap (0 = off)

    # Layer pattern, cycled over n_layers: attn | local_attn | mlstm | slstm | rglru
    # Every block is followed by an MLP unless the kind manages its own FFN.
    block_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 0  # for local_attn blocks

    # MoE (olmoe / qwen2-moe)
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0  # per-expert FFN width
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # Grouped dispatch (perf): scatter/gather stay LOCAL to each batch row
    # (= data shard), so MoE routing induces no cross-shard collectives;
    # capacity is enforced per group (slightly different drop pattern).
    moe_group_dispatch: bool = False
    # canonical expert parallelism (token all-to-all) vs model-axis
    # replicated expert compute; see models/moe.py for the measured trade
    moe_expert_parallel: bool = False

    # mLSTM / sLSTM (xlstm)
    mlstm_qk_dim: int = 0  # defaults to d_model // 2
    mlstm_v_dim: int = 0  # defaults to d_model
    mlstm_chunk: int = 0  # 0 = sequential scan; >0 = chunkwise-parallel (perf)
    conv_width: int = 4  # short conv in recurrent blocks (griffin/xlstm)

    # RG-LRU (recurrentgemma)
    rglru_c: float = 8.0
    rnn_width: int = 0  # recurrent branch width (defaults to d_model)

    # Encoder-decoder (whisper): if enc_layers > 0, model is enc-dec.
    enc_layers: int = 0
    enc_seq: int = 1500  # fixed encoder frames (whisper stub frontend)

    # Modality frontend stub: none | audio_stub | vision_stub
    frontend: str = "none"

    dtype: str = "bfloat16"
    cache_dtype: str = ""  # KV-cache storage dtype ("" = model dtype;
    #                        "float8_e4m3fn" halves serving cache memory)
    # The paper's technique as a first-class feature: matmul routing.
    matmul_backend: MatmulBackend = NAIVE_BACKEND
    # Turn on the calibrated autotune dispatcher for every dense projection:
    # rewrites matmul_backend to kind='auto' (keeping its min_dim/precision/
    # cache settings), so each projection shape picks naive-vs-Strassen from
    # the cost model instead of a hand-set kind/depth.
    matmul_autotune: bool = False

    # Training-time knobs used by train_step lowering.
    remat: bool = True
    # chunked-attention tile sizes (per-perf-iteration tunables)
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024

    # The port's own fields; the defaults keep the JAX package's behaviour.
    # RMSNorm over the whole q and k projections before RoPE (olmoe).
    qk_norm: bool = False
    # False: the top-k gates are the router's probabilities as they are.
    norm_topk_prob: bool = True
    # Every top-k assignment to a held expert is computed (no capacity).
    moe_dropless: bool = False
    # One chip's share of expert parallelism: this layer holds experts
    # [expert_first, expert_first + experts_held) of the router's n_experts
    # (0 = all) and computes only their part of the result. Dropless only.
    experts_held: int = 0
    expert_first: int = 0

    def __post_init__(self):
        if self.matmul_autotune and self.matmul_backend.kind != "auto":
            object.__setattr__(
                self,
                "matmul_backend",
                dataclasses.replace(self.matmul_backend, kind="auto", depth=3),
            )
        if self.n_heads and self.d_model and self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family in ("ssm", "hybrid") or "mlstm" in self.block_pattern:
            if not self.mlstm_qk_dim:
                object.__setattr__(self, "mlstm_qk_dim", max(self.d_model // 2, 1))
            if not self.mlstm_v_dim:
                object.__setattr__(self, "mlstm_v_dim", self.d_model)
        if not self.rnn_width:
            object.__setattr__(self, "rnn_width", self.d_model)
        if self.is_moe:
            first, held = self.expert_first, self.held_experts
            if held < 1 or first < 0 or first + held > self.n_experts:
                raise ValueError(f"experts [{first}, {first + held}) are not among the "
                                 f"router's {self.n_experts}")
            if held < self.n_experts and not self.moe_dropless:
                raise ValueError("a share of the experts needs moe_dropless")

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def held_experts(self) -> int:
        """How many experts this layer holds: ``experts_held``, or all."""
        return self.experts_held or self.n_experts

    def block_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    @property
    def sub_quadratic(self) -> bool:
        """True when no block needs a full-length dense KV cache (long_500k OK)."""
        kinds = set(self.block_pattern)
        return "attn" not in kinds and not self.is_encdec

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math."""
        d, v = self.d_model, self.vocab
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        hd = self.head_dim or (d // max(self.n_heads, 1))
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind in ("attn", "local_attn"):
                total += d * self.n_heads * hd  # q
                total += 2 * d * self.n_kv_heads * hd  # k, v
                total += self.n_heads * hd * d  # o
                if self.qk_norm:
                    total += (self.n_heads + self.n_kv_heads) * hd
                total += self._ffn_params()
            elif kind == "mlstm":
                qk, vd = self.mlstm_qk_dim, self.mlstm_v_dim
                total += d * (2 * qk + 2 * vd) + vd * d + 2 * d  # q,k,v,gate,out,if-gates
                total += self._ffn_params()
            elif kind == "slstm":
                total += 4 * d * d + 4 * d * (d // max(self.n_heads, 1))  # W, R per head
                total += self._ffn_params()
            elif kind == "rglru":
                w = self.rnn_width
                total += 2 * d * w + w * d + 2 * w * self.conv_width + 2 * w
                total += self._ffn_params()
            total += 2 * d  # norms
        if self.is_encdec:
            # encoder blocks (self-attn + mlp)
            per = d * self.n_heads * hd * 2 + 2 * d * self.n_kv_heads * hd + self._ffn_params()
            total += self.enc_layers * per
            total += self.n_layers * (d * self.n_heads * hd * 2 + 2 * d * self.n_kv_heads * hd)  # cross-attn
        return total

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.is_moe:
            e = self.held_experts + self.n_shared_experts
            return e * 3 * d * self.d_expert + d * self.n_experts
        if self.d_ff == 0:
            return 0
        mult = 3 if self.glu else 2
        return mult * d * self.d_ff

    def active_param_count(self) -> int:
        """Params active per token (MoE: only routed top_k + shared)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        # subtract inactive experts (of a share, a token's expected picks here)
        held = self.held_experts
        inactive = held - self.top_k * held // self.n_experts
        total -= self.n_layers * inactive * 3 * d * self.d_expert
        return total
