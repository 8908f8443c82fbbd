"""Unified model configuration covering all ten assigned architectures
(port of ``repro.models.config``: every dataclass copied field for field,
so a reference config carries over unchanged).

One dataclass, optional sections: dense / MoE / SSM / RG-LRU hybrid /
encoder-decoder / VLM.  Per-layer heterogeneity (gemma2 local-global,
recurrentgemma 2:1 rec:attn) is expressed with ``block_pattern`` applied
cyclically over the layer stack.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # deepseek shared experts
    d_ff_shared: int = 0
    first_k_dense: int = 0         # first k layers use a dense MLP
    d_ff_dense: int = 0            # ... of this width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:                   # Mamba-1 (falcon-mamba)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:                 # RecurrentGemma
    lru_width: int = 0             # 0 -> d_model
    conv_width: int = 4
    block_width: int = 0           # recurrent block expansion (0 -> 3/2 ff)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:                # Whisper
    n_enc_layers: int = 6
    enc_seq: int = 1500            # encoder frames after conv stub
    cross_attn: bool = True


@dataclasses.dataclass(frozen=True)
class VLMConfig:                   # InternVL: ViT-stub -> projector -> LM
    n_patches: int = 1024          # patch embeddings per image (stub input)
    vit_dim: int = 3200            # InternViT-6B hidden (stub output dim)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # block pattern, cycled over layers:
    #   "attn" full causal | "local" sliding window | "rec" RG-LRU |
    #   "ssm" mamba | "moe_attn" attention feeding an MoE MLP
    block_pattern: tuple = ("attn",)
    window: int = 4096              # sliding window for "local" blocks
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    softcap_attn: float = 0.0       # gemma2: 50.0
    softcap_final: float = 0.0      # gemma2: 30.0
    query_scale: float = 0.0        # 0 -> 1/sqrt(head_dim)
    # mlp / norm
    mlp_kind: str = "swiglu"        # swiglu | geglu | gelu
    norm_kind: str = "rms"          # rms | ln
    norm_eps: float = 1e-6
    post_block_norm: bool = False   # gemma2 post-norms
    tie_embeddings: bool = False
    embed_scale: bool = False       # gemma: scale embeds by sqrt(d_model)
    # optional sections
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # runtime
    dtype: str = "bfloat16"
    remat: str = "none"             # none | full | dots (activation ckpt)
    use_pallas: bool = False        # route attention through the kernels
    #   (in the port: the CUDA C++ flash_attention / decode_attention on a
    #   CUDA tensor, their plain PyTorch versions on a CPU tensor)
    attn_impl: str = "dense"        # dense | blockwise (online-softmax scan,
    #   the XLA-compilable twin of the Pallas flash kernel; §Perf)
    attn_block_k: int = 2048        # kv block for blockwise attention
    loss_chunk: int = 0             # >0: seq-chunked CE head (§Perf)
    ssm_chunk: int = 0              # >0: chunked selective-scan (§Perf —
    #   bounds the [b, t, d_inner, d_state] scan temporaries to t=chunk)
    moe_impl: str = "onehot"        # onehot | sort (§Perf: gather/scatter
    #   dispatch — no [b,t,e,c] one-hot matmuls, flops -> 6·N_active·D)
    moe_tokens: str = "sharded"     # sharded | gathered (§Perf: gather the
    #   seq axis at MoE entry / reduce-scatter at exit — one AG+RS of
    #   [b,t,d] replaces the per-layer [b,e,c,d] dispatch all-reduces)
    ssm_shard: str = "seq"          # seq | channel (§Perf: the recurrence
    #   is elementwise in channels, so sharding d_inner instead of time
    #   keeps the associative scan collective-free)
    ssm_scan_dtype: str = "float32"  # float32 | bfloat16 scan pairs (§Perf:
    #   halves the dominant [b,t,d_inner,d_state] HBM traffic; the carried
    #   inter-chunk state stays f32)
    scan_layers: bool = True
    # which shapes this arch supports (see DESIGN.md §6 for skips)
    supports_decode: bool = True
    subquadratic: bool = False      # may run long_500k

    # -- derived ------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.pattern_period

    @property
    def n_tail_layers(self) -> int:
        return self.n_layers - self.n_groups * self.pattern_period

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % self.pattern_period]

    @property
    def dt_rank(self) -> int:
        assert self.ssm is not None
        return self.ssm.dt_rank or math.ceil(self.d_model / 16)

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def lru_width(self) -> int:
        assert self.rglru is not None
        return self.rglru.lru_width or self.d_model

    def param_count(self) -> int:
        """Parameter count of the port's own param tree (embeddings +
        blocks), from its ``ParamDef`` leaves."""
        from . import transformer  # lazy, avoids cycle
        from .layers import def_leaves
        return sum(math.prod(d.shape)
                   for d in def_leaves(transformer.param_defs(self)))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k experts)."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        per_expert = 3 * self.d_model * m.d_ff_expert
        n_moe_layers = self.n_layers - m.first_k_dense
        inactive = per_expert * (m.n_experts - m.top_k) * n_moe_layers
        return total - inactive
