"""Model configuration.

One config dataclass covers the decoder-only archetype family the reference
patches per-architecture (reference: unsloth/models/{llama,mistral,qwen2,
qwen3,qwen3_moe,gemma,gemma2,cohere,granite}.py — SURVEY §2c). Instead of one
hand-patched class per arch, architectural differences are expressed as
config knobs consumed by a single functional forward:

  * GQA             — num_kv_heads < num_heads (llama/mistral/qwen)
  * q/k norm        — qk_norm=True (qwen3, gemma3)
  * MLP activation  — "silu" (SwiGLU) vs "gelu_tanh"/"gelu" (GEGLU, gemma)
  * embedding scale — embed_scale = sqrt(D) (gemma family)
  * logit softcap   — final_softcap (gemma2), attn_softcap (gemma2 attention)
  * logit scale     — cohere's logit_scale
  * sliding window  — sliding_window + layer pattern (mistral, gemma2/3)
  * RoPE scaling    — none / linear / dynamic-NTK / llama3 / yarn / longrope
  * MoE             — num_experts / num_experts_per_tok (qwen3-moe, gpt-oss)
  * tied embeddings — tie_word_embeddings

`from_hf_config` maps a HuggingFace ``config.json`` dict onto this dataclass,
which is the TPU-native analog of the reference's per-arch dispatch table
(reference: models/loader.py:820-897).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """RoPE scaling config (reference: models/llama.py:1760-2149 implements
    vanilla/linear/extended-NTK/LongRoPE rotary classes)."""

    rope_type: str = "default"  # default|linear|dynamic|llama3|yarn|longrope
    factor: float = 1.0
    # llama3
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    # yarn
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None
    mscale: Optional[float] = None
    mscale_all_dim: Optional[float] = None
    # longrope
    long_factor: Optional[Tuple[float, ...]] = None
    short_factor: Optional[Tuple[float, ...]] = None

    @classmethod
    def from_hf(cls, d: Optional[Dict[str, Any]], max_pos: int) -> "RopeScaling":
        if not d:
            return cls()
        rope_type = d.get("rope_type", d.get("type", "default"))
        lf = d.get("long_factor")
        sf = d.get("short_factor")
        return cls(
            rope_type=rope_type,
            factor=float(d.get("factor", 1.0)),
            low_freq_factor=float(d.get("low_freq_factor", 1.0)),
            high_freq_factor=float(d.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                d.get("original_max_position_embeddings", max_pos)
            ),
            beta_fast=float(d.get("beta_fast", 32.0)),
            beta_slow=float(d.get("beta_slow", 1.0)),
            attention_factor=d.get("attention_factor"),
            mscale=d.get("mscale"),
            mscale_all_dim=d.get("mscale_all_dim"),
            long_factor=tuple(lf) if lf else None,
            short_factor=tuple(sf) if sf else None,
        )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # Identity
    model_type: str = "llama"
    name: str = ""

    # Core dims
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads

    # Attention
    # qwen3/gemma3: True = weighted rms-norm before rope;
    # llama4: "l2" = weightless L2 norm after rope (rope layers only)
    qk_norm: Any = False
    attn_softcap: Optional[float] = None   # gemma2
    attn_logit_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    sliding_window: Optional[int] = None
    # per-layer attention kind pattern, repeated over layers:
    #   "global" or "sliding". None => all global.
    layer_pattern: Optional[Tuple[str, ...]] = None
    attention_bias: bool = False
    o_proj_bias: bool = False
    attn_sinks: bool = False               # gpt-oss learned sink logits

    # MLP
    hidden_act: str = "silu"  # silu|gelu|gelu_tanh|relu2
    mlp_bias: bool = False
    # starcoder2/nemotron: plain act(up)->down MLP, no gate projection
    mlp_gated: bool = True

    # Norm
    rms_norm_eps: float = 1e-6
    # rmsnorm | layernorm | layernorm1p (nemotron: LayerNorm with 1+w)
    norm_type: str = "rmsnorm"
    norm_bias: bool = False         # starcoder2/nemotron: biased norms
    gemma_norm: bool = False        # (1 + w) scale convention, fp32 norm
    # gemma2/3 sandwich norms: pre/post attention + pre/post mlp
    use_post_norms: bool = False

    # Embedding / output
    embed_scale: Optional[float] = None     # gemma: sqrt(D); granite: mult
    residual_multiplier: Optional[float] = None   # granite
    tie_word_embeddings: bool = False
    final_softcap: Optional[float] = None   # gemma2 final logit softcapping
    logit_scale: Optional[float] = None     # cohere

    # RoPE
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling = dataclasses.field(default_factory=RopeScaling)
    max_position_embeddings: int = 4096
    partial_rotary_factor: float = 1.0
    # gemma3: different theta for sliding layers
    rope_local_theta: Optional[float] = None
    # qwen2.5-vl M-RoPE: rope channels (half-dim) split across the
    # temporal/height/width position streams
    mrope_section: Optional[Tuple[int, ...]] = None
    mrope_interleaved: bool = False  # qwen3-vl channel-interleaved mrope

    # MoE (qwen3-moe / mixtral / gpt-oss)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = False
    # layers that are MoE (None => all layers MoE if num_experts>0)
    moe_layer_pattern: Optional[Tuple[bool, ...]] = None
    shared_expert_intermediate_size: Optional[int] = None
    router_bias: bool = False               # gpt-oss has router bias
    moe_mlp_bias: bool = False              # gpt-oss expert bias
    moe_act: Optional[str] = None           # override act for experts
    # llama4: top-k on logits -> sigmoid -> scale the expert INPUT, plus a
    # shared expert that always runs ("softmax_topk" = qwen/mixtral/gpt-oss)
    moe_routing: str = "softmax_topk"
    moe_shared_expert: bool = False
    # deepseek-v3 group-limited routing
    moe_n_group: int = 1
    moe_topk_group: int = 1
    moe_routed_scaling: float = 1.0
    # qwen2-moe/qwen3-next: shared expert scaled by sigmoid(x @ gate)
    moe_shared_gate: bool = False

    # llama4 text specifics
    rope_interleaved: bool = False          # pairwise (complex) rotation
    # per-layer rope on/off (llama4 NoPE layers); None => all layers rope
    rope_layers: Optional[Tuple[bool, ...]] = None
    attention_chunk_size: Optional[int] = None  # chunked local attention
    attn_temperature_tuning: bool = False   # NoPE-layer q scaling
    floor_scale: float = 8192.0
    attn_scale: float = 0.1

    # cohere/cohere2: attention and MLP both read the SAME normed input
    # and add into the residual together
    parallel_residual: bool = False
    # olmo2: no pre-norms; sublayer OUTPUTS are normed before the add
    post_norm_only: bool = False

    # text-diffusion (masked-diffusion LM): bidirectional attention
    causal: bool = True
    mask_token_id: Optional[int] = None

    # falcon-h1: parallel attention + mamba2 per layer
    hybrid_mamba: bool = False
    mamba: Optional["MambaConfig"] = None

    # deepseek-v3 multi-head latent attention
    mla: Optional["MLAConfig"] = None

    # qwen3-next: gated DeltaNet linear-attention layers + output-gated
    # full attention
    gdn: Optional["GDNConfig"] = None
    gated_attention: bool = False

    # gemma-3n: AltUp multi-stream hiddens + Laurel + per-layer embeddings
    altup: Optional["AltUpConfig"] = None

    # lfm2: gated short-conv mixer layers (layer_pattern kind "conv")
    short_conv_l: int = 0
    short_conv_bias: bool = False

    # minimax: lightning (decayed linear) attention layers + weighted
    # normed residuals
    lightning: Optional["LightningConfig"] = None

    # zamba2: shared transformer blocks over an all-mamba stack
    zamba: Optional["ZambaConfig"] = None

    # Special tokens
    bos_token_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    pad_token_id: Optional[int] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_kind(self, layer_idx: int) -> str:
        """'global', 'sliding', 'chunked' or 'linear' for a given layer."""
        if self.layer_pattern is None:
            return "global"
        kind = self.layer_pattern[layer_idx % len(self.layer_pattern)]
        if kind == "sliding" and self.sliding_window is None:
            return "global"
        if kind == "chunked" and self.attention_chunk_size is None:
            return "global"
        return kind

    def layer_uses_rope(self, layer_idx: int) -> bool:
        if self.rope_layers is None:
            return True
        return bool(self.rope_layers[layer_idx % len(self.rope_layers)])

    def layer_is_moe(self, layer_idx: int) -> bool:
        if not self.is_moe:
            return False
        if self.moe_layer_pattern is None:
            return True
        return self.moe_layer_pattern[layer_idx % len(self.moe_layer_pattern)]

    # ------------------------------------------------------------------
    # HF interop
    # ------------------------------------------------------------------

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any], name: str = "") -> "ModelConfig":
        """Build from a HuggingFace config.json dict.

        Covers the arch dispatch the reference does per-file
        (reference: models/loader.py:820-897 dispatch table).
        """
        model_type = hf.get("model_type", "llama")
        # Multimodal configs nest the text config.
        if "text_config" in hf and isinstance(hf["text_config"], dict):
            text = dict(hf["text_config"])
            text.setdefault("model_type", model_type)
            merged = dict(hf)
            merged.update(text)
            hf = merged
            # dispatch on the TEXT architecture when the wrapper type has
            # no builder of its own (e.g. aya_vision -> cohere2)
            if model_type not in _HF_BUILDERS:
                model_type = hf.get("model_type", model_type)

        builder = _HF_BUILDERS.get(model_type, _build_llama_like)
        return builder(cls, hf, model_type, name)


# ---------------------------------------------------------------------------
# Per-family HF config builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims (reference supports
    deepseek through its mapper; HF DeepseekV3Attention semantics)."""

    q_lora_rank: Optional[int] = None     # None => plain q_proj
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_rope_head_dim + self.qk_nope_head_dim


def _build_deepseek_v3(cls, hf, model_type, name):
    """DeepSeek-V3/R1: MLA attention (low-rank q/kv with a shared rope
    head), sigmoid router with bias-corrected group-limited top-k and
    routed scaling, shared experts, first_k_dense_replace dense layers."""
    kw = _common(hf)
    n_layers = kw["num_layers"]
    mla = MLAConfig(
        q_lora_rank=hf.get("q_lora_rank"),
        kv_lora_rank=int(hf.get("kv_lora_rank", 512)),
        qk_rope_head_dim=int(hf.get("qk_rope_head_dim", 64)),
        qk_nope_head_dim=int(hf.get("qk_nope_head_dim", 128)),
        v_head_dim=int(hf.get("v_head_dim", 128)),
    )
    first_dense = int(hf.get("first_k_dense_replace", 0))
    scale = mla.qk_head_dim ** -0.5
    rs = hf.get("rope_scaling") or {}
    if rs and rs.get("mscale_all_dim"):
        factor = float(rs.get("factor", 1.0))
        md = float(rs["mscale_all_dim"])
        if factor > 1.0:
            mscale = 0.1 * md * __import__("math").log(factor) + 1.0
            scale = scale * mscale * mscale
    kw.update(
        mla=mla,
        head_dim=mla.qk_head_dim,
        attn_logit_scale=scale,
        rope_interleaved=bool(hf.get("rope_interleave", True)),
        num_experts=int(hf.get("n_routed_experts", 0)),
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 8)),
        moe_intermediate_size=int(hf.get("moe_intermediate_size", 2048)),
        moe_layer_pattern=tuple(i >= first_dense
                                for i in range(n_layers)),
        norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        moe_routing="deepseek",
        moe_shared_expert=int(hf.get("n_shared_experts", 0) or 0) > 0,
        moe_n_group=int(hf.get("n_group", 1)),
        moe_topk_group=int(hf.get("topk_group", 1)),
        moe_routed_scaling=float(hf.get("routed_scaling_factor", 1.0)),
    )
    return cls(model_type="deepseek_v3", name=name, **kw)


@dataclasses.dataclass(frozen=True)
class GDNConfig:
    """Qwen3-Next gated DeltaNet (linear attention) dims."""

    num_k_heads: int = 16
    num_v_heads: int = 32
    k_head_dim: int = 128
    v_head_dim: int = 128
    conv_kernel: int = 4
    chunk_size: int = 64

    @property
    def key_dim(self) -> int:
        return self.num_k_heads * self.k_head_dim

    @property
    def value_dim(self) -> int:
        return self.num_v_heads * self.v_head_dim


def _build_qwen3_next(cls, hf, model_type, name):
    """Qwen3-Next: hybrid gated-DeltaNet (linear attention) / gated full
    attention, qwen-MoE with a sigmoid-gated shared expert, partial
    rotary, per-head qk-norm."""
    kw = _common(hf)
    n_layers = kw["num_layers"]
    types = hf.get("layer_types")
    if not types:
        interval = int(hf.get("full_attention_interval", 4))
        types = ["full_attention" if (i + 1) % interval == 0
                 else "linear_attention" for i in range(n_layers)]
    sparse_step = int(hf.get("decoder_sparse_step", 1) or 0)
    mlp_only = set(hf.get("mlp_only_layers") or ())
    n_experts = int(hf.get("num_experts", 0))
    kw.update(
        qk_norm=True,
        gated_attention=True,
        gemma_norm=True,   # Qwen3NextRMSNorm is the (1 + w) convention
        layer_pattern=tuple(
            "linear" if t == "linear_attention" else "global"
            for t in types),
        gdn=GDNConfig(
            num_k_heads=int(hf.get("linear_num_key_heads", 16)),
            num_v_heads=int(hf.get("linear_num_value_heads", 32)),
            k_head_dim=int(hf.get("linear_key_head_dim", 128)),
            v_head_dim=int(hf.get("linear_value_head_dim", 128)),
            conv_kernel=int(hf.get("linear_conv_kernel_dim", 4)),
        ),
        num_experts=n_experts,
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 8)),
        moe_intermediate_size=int(hf.get("moe_intermediate_size", 512)),
        norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        moe_layer_pattern=tuple(
            bool(n_experts) and sparse_step and ((i + 1) % sparse_step
                                                 == 0) and i not in
            mlp_only for i in range(n_layers)),
        moe_shared_expert=True,
        moe_shared_gate=True,
        shared_expert_intermediate_size=int(
            hf.get("shared_expert_intermediate_size", 512)),
    )
    return cls(model_type="qwen3_next", name=name, **kw)


def _build_glm4_moe(cls, hf, model_type, name):
    """GLM-4.5-MoE: llama-style GQA attention (partial rotary, optional
    per-head qk-norm) + deepseek-style sigmoid group-limited routing with
    shared experts and first_k_dense_replace dense layers."""
    kw = _common(hf)
    n_layers = kw["num_layers"]
    first_dense = int(hf.get("first_k_dense_replace", 0))
    kw.update(
        qk_norm=bool(hf.get("use_qk_norm", False)),
        num_experts=int(hf.get("n_routed_experts", 0)),
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 8)),
        moe_intermediate_size=int(hf.get("moe_intermediate_size", 1408)),
        moe_layer_pattern=tuple(i >= first_dense
                                for i in range(n_layers)),
        norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        moe_routing="deepseek",
        moe_shared_expert=int(hf.get("n_shared_experts", 0) or 0) > 0,
        moe_n_group=int(hf.get("n_group", 1)),
        moe_topk_group=int(hf.get("topk_group", 1)),
        moe_routed_scaling=float(hf.get("routed_scaling_factor", 1.0)),
    )
    return cls(model_type="glm4_moe", name=name, **kw)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """falcon-h1 hybrid-mamba mixer dims + muP multipliers (reference:
    models/falcon_h1.py; HF FalconH1Config mamba_* fields)."""

    d_ssm: int = 0
    n_heads: int = 0
    head_dim: int = 0
    n_groups: int = 1
    d_state: int = 16
    d_conv: int = 4
    chunk_size: int = 256
    conv_bias: bool = True
    proj_bias: bool = False
    rms_norm: bool = False
    time_step_min: float = 0.0
    time_step_max: float = float("inf")
    # muP multipliers
    ssm_in_multiplier: float = 1.0
    ssm_out_multiplier: float = 1.0
    attention_in_multiplier: float = 1.0
    attention_out_multiplier: float = 1.0
    key_multiplier: float = 1.0
    ssm_multipliers: Tuple[float, ...] = (1.0,) * 5   # z, x, B, C, dt
    mlp_multipliers: Tuple[float, ...] = (1.0, 1.0)   # gate, down

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "MambaConfig":
        hidden = int(hf.get("hidden_size", 4096))
        expand = int(hf.get("mamba_expand", 2))
        d_ssm = int(hf.get("mamba_d_ssm") or expand * hidden)
        n_heads = int(hf.get("mamba_n_heads", 128))
        limit = hf.get("time_step_limit") or (0.0, float("inf"))
        return cls(
            d_ssm=d_ssm,
            n_heads=n_heads,
            head_dim=int(hf.get("mamba_d_head") or d_ssm // n_heads),
            n_groups=int(hf.get("mamba_n_groups", 1)),
            d_state=int(hf.get("mamba_d_state", 256)),
            d_conv=int(hf.get("mamba_d_conv", 4)),
            chunk_size=int(hf.get("mamba_chunk_size", 256)),
            conv_bias=bool(hf.get("mamba_conv_bias", True)),
            proj_bias=bool(hf.get("mamba_proj_bias", False)),
            rms_norm=bool(hf.get("mamba_rms_norm", False)),
            time_step_min=float(limit[0]),
            time_step_max=float(limit[1]),
            ssm_in_multiplier=float(hf.get("ssm_in_multiplier", 1.0)),
            ssm_out_multiplier=float(hf.get("ssm_out_multiplier", 1.0)),
            attention_in_multiplier=float(
                hf.get("attention_in_multiplier", 1.0)),
            attention_out_multiplier=float(
                hf.get("attention_out_multiplier", 1.0)),
            key_multiplier=float(hf.get("key_multiplier", 1.0)),
            ssm_multipliers=tuple(
                float(v) for v in (hf.get("ssm_multipliers")
                                   or (1.0,) * 5)),
            mlp_multipliers=tuple(
                float(v) for v in (hf.get("mlp_multipliers")
                                   or (1.0, 1.0))),
        )


def _build_falcon_h1(cls, hf, model_type, name):
    """falcon-h1: every layer runs attention AND a mamba2 (SSD) mixer in
    parallel on the same normed input, with muP multipliers everywhere
    (reference: models/falcon_h1.py:1-756)."""
    kw = _common(hf)
    kw.update(
        hybrid_mamba=True,
        mamba=MambaConfig.from_hf(hf),
        embed_scale=float(hf.get("embedding_multiplier", 1.0)) or None,
        logit_scale=float(hf.get("lm_head_multiplier", 1.0)) or None,
    )
    if kw["embed_scale"] == 1.0:
        kw["embed_scale"] = None
    if kw["logit_scale"] == 1.0:
        kw["logit_scale"] = None
    return cls(model_type="falcon_h1", name=name, **kw)


def _common(hf: Dict[str, Any]) -> Dict[str, Any]:
    max_pos = int(hf.get("max_position_embeddings", 4096))
    num_heads = int(hf.get("num_attention_heads", 32))
    hidden = int(hf.get("hidden_size", 4096))
    eos = hf.get("eos_token_id")
    if isinstance(eos, list):
        eos = eos[0] if eos else None
    return dict(
        vocab_size=int(hf.get("vocab_size", 32000)),
        hidden_size=hidden,
        intermediate_size=int(hf.get("intermediate_size", 4 * hidden)),
        num_layers=int(hf.get("num_hidden_layers", 32)),
        num_heads=num_heads,
        num_kv_heads=int(hf.get("num_key_value_heads", num_heads)),
        head_dim=hf.get("head_dim"),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=RopeScaling.from_hf(hf.get("rope_scaling"), max_pos),
        max_position_embeddings=max_pos,
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
        hidden_act=hf.get("hidden_act", hf.get("hidden_activation", "silu")),
        attention_bias=bool(hf.get("attention_bias", False)),
        o_proj_bias=bool(hf.get("attention_bias", False)),
        mlp_bias=bool(hf.get("mlp_bias", False)),
        partial_rotary_factor=float(hf.get("partial_rotary_factor", 1.0)),
        bos_token_id=hf.get("bos_token_id"),
        eos_token_id=eos,
        pad_token_id=hf.get("pad_token_id"),
    )


def _build_llama_like(cls, hf, model_type, name):
    kw = _common(hf)
    if model_type in ("mistral",) and hf.get("sliding_window"):
        kw["sliding_window"] = int(hf["sliding_window"])
        kw["layer_pattern"] = ("sliding",)
    if model_type == "qwen2" and hf.get("use_sliding_window") and hf.get("sliding_window"):
        kw["sliding_window"] = int(hf["sliding_window"])
        kw["layer_pattern"] = ("sliding",)
    if model_type in ("qwen3", "qwen3_moe", "qwen3_vl_text",
                      "qwen3_vl_moe_text"):
        kw["qk_norm"] = True
    if model_type == "qwen2_moe":
        # Qwen1.5/2-MoE: qwen2 attention (qkv bias) + softmax-then-topk
        # routing (norm_topk_prob False by default) + always-on shared
        # expert with a sigmoid gate (HF Qwen2MoeSparseMoeBlock)
        n_layers = kw["num_layers"]
        sparse_step = int(hf.get("decoder_sparse_step", 1) or 0)
        mlp_only = set(hf.get("mlp_only_layers") or ())
        kw.update(
            num_experts=int(hf.get("num_experts", 60)),
            num_experts_per_tok=int(hf.get("num_experts_per_tok", 4)),
            moe_intermediate_size=int(
                hf.get("moe_intermediate_size", 1408)),
            norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
            moe_layer_pattern=tuple(
                bool(sparse_step) and ((i + 1) % sparse_step == 0)
                and i not in mlp_only for i in range(n_layers)),
            moe_shared_expert=True,
            moe_shared_gate=True,
            shared_expert_intermediate_size=int(
                hf.get("shared_expert_intermediate_size", 5632)),
        )
    if model_type in ("qwen3_moe", "qwen3_vl_moe_text"):
        kw.update(
            num_experts=int(hf.get("num_experts", 128)),
            num_experts_per_tok=int(hf.get("num_experts_per_tok", 8)),
            moe_intermediate_size=int(hf.get("moe_intermediate_size", 768)),
            norm_topk_prob=bool(hf.get("norm_topk_prob", True)),
        )
    if model_type in ("qwen3_vl_text", "qwen3_vl_moe_text"):
        # qwen3-vl text: channel-INTERLEAVED M-RoPE (T default, H/W claim
        # offset-1/-2 channels — HF Qwen3VLTextRotaryEmbedding)
        rs = hf.get("rope_scaling") or {}
        kw["mrope_section"] = tuple(rs.get("mrope_section", (24, 20, 20)))
        kw["mrope_interleaved"] = True
        kw["rope_scaling"] = RopeScaling()
    if model_type == "mixtral":
        kw.update(
            num_experts=int(hf.get("num_local_experts", 8)),
            num_experts_per_tok=int(hf.get("num_experts_per_tok", 2)),
            norm_topk_prob=True,  # mixtral always renormalizes top-k
        )
    if model_type == "cohere":
        kw["logit_scale"] = float(hf.get("logit_scale", 0.0625))
        kw["norm_type"] = "layernorm"
        kw["parallel_residual"] = True
        kw["rms_norm_eps"] = float(hf.get("layer_norm_eps", 1e-5))
        kw["tie_word_embeddings"] = bool(
            hf.get("tie_word_embeddings", True))
    if model_type == "cohere2":
        # cohere2: parallel residual + alternating sliding/global layers,
        # rope ONLY on the sliding layers (global layers are NoPE)
        kw["logit_scale"] = float(hf.get("logit_scale", 0.0625))
        kw["norm_type"] = "layernorm"
        kw["parallel_residual"] = True
        kw["rms_norm_eps"] = float(hf.get("layer_norm_eps", 1e-5))
        kw["tie_word_embeddings"] = bool(
            hf.get("tie_word_embeddings", True))
        n_l = kw["num_layers"]
        types = hf.get("layer_types") or [
            "sliding_attention" if (i + 1) % int(
                hf.get("sliding_window_pattern", 4)) else "full_attention"
            for i in range(n_l)]
        kw["sliding_window"] = int(hf.get("sliding_window", 4096))
        kw["layer_pattern"] = tuple(
            "sliding" if t == "sliding_attention" else "global"
            for t in types)
        kw["rope_layers"] = tuple(t == "sliding_attention" for t in types)
    if model_type == "smollm3":
        no_rope = hf.get("no_rope_layers")
        if no_rope:
            kw["rope_layers"] = tuple(bool(v) for v in no_rope)
        kw["tie_word_embeddings"] = bool(
            hf.get("tie_word_embeddings", True))
    if model_type == "olmo2":
        kw["post_norm_only"] = True
        kw["qk_norm"] = "full"  # rms over the full projection width
    if model_type == "hunyuan_v1_dense":
        # per-head weighted rms-norm AFTER rope (HF HunYuanDenseV1Attention
        # applies query/key_layernorm post-rotary)
        kw["qk_norm"] = "post_rope"
    if model_type == "olmo3":
        # olmo2 structure + sliding/full pattern; sliding layers use
        # UNSCALED default rope, full layers apply config rope_scaling
        # (HF Olmo3Model keeps two rotary tables).
        kw["post_norm_only"] = True
        kw["qk_norm"] = "full"
        types = hf.get("layer_types") or []
        if types:
            kw["sliding_window"] = int(hf.get("sliding_window", 4096))
            kw["layer_pattern"] = tuple(
                "sliding" if t == "sliding_attention" else "global"
                for t in types)
            kw["rope_local_theta"] = float(hf.get("rope_theta", 10000.0))
    if model_type == "exaone4":
        # post-norm-only residual structure (like olmo2) + per-head
        # qk-norm before rope; hybrid models rope ONLY the sliding
        # layers (HF Exaone4Attention: rope iff sliding_window is None
        # or is_sliding).
        kw["post_norm_only"] = True
        kw["qk_norm"] = True
        types = hf.get("layer_types") or []
        if types and hf.get("sliding_window"):
            kw["sliding_window"] = int(hf["sliding_window"])
            kw["layer_pattern"] = tuple(
                "sliding" if t == "sliding_attention" else "global"
                for t in types)
            kw["rope_layers"] = tuple(
                t == "sliding_attention" for t in types)
    if model_type == "apertus":
        # Apertus (Swiss AI): per-head qk-norm before rope, NON-gated MLP
        # with the learnable xIELU activation (HF ApertusDecoderLayer;
        # norm names attention_layernorm / feedforward_layernorm)
        kw["qk_norm"] = True
        kw["mlp_gated"] = False
        kw["hidden_act"] = "xielu"
    if model_type in ("granitemoe", "granitemoeshared"):
        kw["embed_scale"] = float(hf.get("embedding_multiplier", 1.0))
        kw["attn_logit_scale"] = float(hf.get("attention_multiplier",
                                              kw["hidden_size"] ** -0.5))
        kw["residual_multiplier"] = float(hf.get("residual_multiplier",
                                                 1.0))
        ls = float(hf.get("logits_scaling", 1.0))
        if ls != 1.0:
            kw["logit_scale"] = 1.0 / ls
        kw.update(
            num_experts=int(hf.get("num_local_experts", 8)),
            num_experts_per_tok=int(hf.get("num_experts_per_tok", 2)),
            moe_intermediate_size=int(hf.get("intermediate_size", 1024)),
            moe_routing="topk_softmax",
        )
        if model_type == "granitemoeshared":
            # granite-3.1-a*: granitemoe + an always-on fused shared MLP
            # added to the routed output (HF GraniteMoeSharedMLP)
            kw["moe_shared_expert"] = True
            kw["intermediate_size"] = int(
                hf.get("shared_intermediate_size", 1024))
    if model_type == "granite":
        # granite = llama + scalar multipliers (attention/embedding/
        # residual/logits) — the reference disables its granite path
        # (loader.py:895-897); here they are plain config knobs.
        kw["embed_scale"] = float(hf.get("embedding_multiplier", 1.0))
        kw["attn_logit_scale"] = float(hf.get("attention_multiplier",
                                              kw["hidden_size"] ** -0.5))
        kw["residual_multiplier"] = float(hf.get("residual_multiplier",
                                                 1.0))
        ls = float(hf.get("logits_scaling", 1.0))
        if ls != 1.0:
            kw["logit_scale"] = 1.0 / ls
    if model_type == "phi3":
        kw["partial_rotary_factor"] = float(
            hf.get("partial_rotary_factor", 1.0))
    if model_type == "starcoder2":
        # gelu act(c_fc)->c_proj MLP (no gate), biased LayerNorms,
        # bias on every linear, tied embeddings.
        kw["mlp_gated"] = False
        kw["norm_type"] = "layernorm"
        kw["norm_bias"] = True
        kw["rms_norm_eps"] = float(hf.get("norm_epsilon", 1e-5))
        act = hf.get("hidden_act", "gelu_pytorch_tanh")
        kw["hidden_act"] = {"gelu_pytorch_tanh": "gelu_tanh"}.get(act, act)
        bias = bool(hf.get("use_bias", True))
        kw["attention_bias"] = bias
        kw["o_proj_bias"] = bias
        kw["mlp_bias"] = bias
        kw["tie_word_embeddings"] = bool(
            hf.get("tie_word_embeddings", True))
        if hf.get("sliding_window"):
            kw["sliding_window"] = int(hf["sliding_window"])
            kw["layer_pattern"] = ("sliding",)
    if model_type == "nemotron":
        # relu^2 act(up)->down MLP (no gate), LayerNorm1P ((1+w) scale,
        # biased), partial rotary.
        kw["mlp_gated"] = False
        kw["norm_type"] = "layernorm1p"
        kw["norm_bias"] = True
        kw["rms_norm_eps"] = float(hf.get("norm_eps", 1e-5))
        kw["partial_rotary_factor"] = float(
            hf.get("partial_rotary_factor", 0.5))
    if model_type in ("qwen2_5_vl", "qwen2_vl"):
        rs = hf.get("rope_scaling") or {}
        if rs.get("mrope_section"):
            kw["mrope_section"] = tuple(rs["mrope_section"])
        kw["rope_scaling"] = RopeScaling()  # mrope handled separately
    return cls(model_type=model_type, name=name, **kw)


def _build_gemma(cls, hf, model_type, name):
    kw = _common(hf)
    hidden = kw["hidden_size"]
    kw["gemma_norm"] = True
    kw["embed_scale"] = float(hidden) ** 0.5
    kw["tie_word_embeddings"] = bool(hf.get("tie_word_embeddings", True))
    # HF gemma's hidden_act key history is messy; gemma uses gelu_tanh.
    act = hf.get("hidden_activation") or hf.get("hidden_act") or "gelu_pytorch_tanh"
    kw["hidden_act"] = {"gelu_pytorch_tanh": "gelu_tanh"}.get(act, act)

    if model_type == "gemma2":
        kw["attn_softcap"] = float(hf.get("attn_logit_softcapping", 50.0))
        kw["final_softcap"] = float(hf.get("final_logit_softcapping", 30.0))
        kw["sliding_window"] = int(hf.get("sliding_window", 4096))
        kw["layer_pattern"] = ("sliding", "global")  # alternating, even=sliding
        kw["use_post_norms"] = True
        if hf.get("query_pre_attn_scalar"):
            kw["attn_logit_scale"] = float(hf["query_pre_attn_scalar"]) ** -0.5
    elif model_type == "gemma3_text" or model_type == "gemma3":
        kw["qk_norm"] = True
        kw["use_post_norms"] = True
        kw["sliding_window"] = int(hf.get("sliding_window", 1024))
        pattern_len = int(hf.get("sliding_window_pattern", 6))
        # gemma3: 5 sliding then 1 global
        kw["layer_pattern"] = tuple(
            "global" if (i + 1) % pattern_len == 0 else "sliding"
            for i in range(pattern_len)
        )
        kw["rope_local_theta"] = float(hf.get("rope_local_base_freq", 10000.0))
        if hf.get("query_pre_attn_scalar"):
            kw["attn_logit_scale"] = float(hf["query_pre_attn_scalar"]) ** -0.5
    return cls(model_type=model_type, name=name, **kw)


@dataclasses.dataclass(frozen=True)
class AltUpConfig:
    """gemma-3n text extras (HF Gemma3nTextConfig; the reference reaches
    gemma-3n through FastModel's auto path — loader.py dispatch):
    AltUp multi-stream hiddens, Laurel low-rank residual, per-layer
    embeddings, activation sparsity, KV-shared tail layers."""

    num_inputs: int = 4
    active_idx: int = 0
    coef_clip: Optional[float] = None
    correct_scale: bool = True
    laurel_rank: int = 64
    hidden_per_layer: int = 256
    vocab_per_layer: int = 262144
    num_kv_shared_layers: int = 0
    activation_sparsity: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class ZambaConfig:
    """Zamba2 shared-transformer extras (HF Zamba2Config): every layer is
    a mamba2 mixer; `hybrid_ids` layers ALSO run one of `num_mem_blocks`
    SHARED attention+MLP blocks over concat([h, embeddings]) (block
    g % num_mem_blocks for the g-th hybrid layer), project it with a
    per-layer linear and add it to the mamba input. The shared blocks
    carry per-hybrid-layer low-rank adapters ("LoRA in the base model")
    on qkv and gate_up."""

    num_mem_blocks: int = 1
    hybrid_ids: Tuple[int, ...] = ()
    use_rope: bool = False
    adapter_rank: int = 0     # 0 => no adapters
    use_attn_adapter: bool = False  # q/k/v adapters (gate_up always on)


@dataclasses.dataclass(frozen=True)
class LightningConfig:
    """MiniMax lightning-attention extras (HF MiniMaxConfig): block size
    for the chunked decayed linear attention plus the per-sublayer
    residual alpha/beta weights (the residual stream is the NORMED
    hidden, re-weighted each sublayer)."""

    block_size: int = 256
    linear_alpha: float = 1.0
    linear_beta: float = 1.0
    full_alpha: float = 1.0
    full_beta: float = 1.0
    mlp_alpha: float = 1.0
    mlp_beta: float = 1.0


def _build_minimax(cls, hf, model_type, name):
    """MiniMax-Text/M1: alternating lightning (decayed linear) attention
    and full rope attention, mixtral-style MoE, weighted normed
    residuals (HF MiniMaxDecoderLayer)."""
    kw = _common(hf)
    n_layers = kw["num_layers"]
    types = hf.get("layer_types") or [
        "full_attention" if i % 2 == 1 else "linear_attention"
        for i in range(n_layers)]
    kw.update(
        layer_pattern=tuple("linear" if t == "linear_attention"
                            else "global" for t in types),
        num_experts=int(hf.get("num_local_experts", 8)),
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 2)),
        norm_topk_prob=True,  # mixtral-style renormalize
        lightning=LightningConfig(
            block_size=int(hf.get("block_size", 256)),
            linear_alpha=float(hf.get("linear_attn_alpha_factor", 1.0)),
            linear_beta=float(hf.get("linear_attn_beta_factor", 1.0)),
            full_alpha=float(hf.get("full_attn_alpha_factor", 1.0)),
            full_beta=float(hf.get("full_attn_beta_factor", 1.0)),
            mlp_alpha=float(hf.get("mlp_alpha_factor", 1.0)),
            mlp_beta=float(hf.get("mlp_beta_factor", 1.0)),
        ),
    )
    return cls(model_type="minimax", name=name, **kw)


def _build_dots1(cls, hf, model_type, name):
    """dots1 (rednote-hilab dots.llm1): standard attention with per-head
    qk-norm + DeepSeek-V3-style MoE (sigmoid router, bias-corrected
    group-limited top-k, routed scaling, shared experts, first-k dense)."""
    kw = _common(hf)
    n_layers = kw["num_layers"]
    first_dense = int(hf.get("first_k_dense_replace", 0))
    kw.update(
        qk_norm=True,
        num_experts=int(hf.get("n_routed_experts") or 0),
        num_experts_per_tok=int(hf.get("num_experts_per_tok") or 0),
        moe_intermediate_size=int(hf.get("moe_intermediate_size", 1408)),
        moe_layer_pattern=tuple(i >= first_dense
                                for i in range(n_layers)),
        moe_routing="deepseek",
        moe_shared_expert=bool(hf.get("n_shared_experts")),
        moe_n_group=int(hf.get("n_group", 1)),
        moe_topk_group=int(hf.get("topk_group", 1)),
        moe_routed_scaling=float(hf.get("routed_scaling_factor", 1.0)),
        norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
    )
    return cls(model_type="dots1", name=name, **kw)


def _build_bamba(cls, hf, model_type, name):
    """Bamba (IBM/CMU/Princeton): SERIAL hybrid — each layer is either a
    mamba2 (SSD) mixer or partial-rotary attention (HF BambaDecoderLayer;
    cf. falcon-h1 where both run in PARALLEL per layer). The mamba2 math
    and checkpoint names are shared with falcon-h1 (`mamba.*`, gated
    rms-norm always on)."""
    kw = _common(hf)
    kw["partial_rotary_factor"] = float(
        hf.get("partial_rotary_factor", 0.5))
    mc = dict(hf)
    mc.setdefault("mamba_rms_norm", True)  # BambaRMSNormGated always
    kw["mamba"] = MambaConfig.from_hf(mc)
    n_layers = kw["num_layers"]
    attn_idx = set(int(i) for i in (hf.get("attn_layer_indices") or []))
    kw["layer_pattern"] = tuple(
        "global" if i in attn_idx else "mamba" for i in range(n_layers))
    kw["tie_word_embeddings"] = bool(hf.get("tie_word_embeddings", False))
    return cls(model_type="bamba", name=name, **kw)


def _build_zamba2(cls, hf, model_type, name):
    """Zamba2 (Zyphra): all-mamba2 stack with cycled SHARED transformer
    blocks on the `hybrid` layers, per-hybrid-layer adapters and linear
    projections, optional rope over the concat width (HF Zamba2Model;
    beyond the reference's catalog — shared-block hybrid family)."""
    kw = _common(hf)
    n_layers = kw["num_layers"]
    hidden = kw["hidden_size"]
    types = hf.get("layers_block_type") or ["mamba"] * n_layers
    hybrid_ids = [i for i, t in enumerate(types) if t == "hybrid"]
    kw.update(
        head_dim=int(hf.get("attention_head_dim", 2 * hidden // max(
            1, kw["num_heads"]))),
        # HF Zamba2Attention: scaling = (head_dim/2)^-0.5
        attn_logit_scale=(int(hf.get(
            "attention_head_dim", 2 * hidden // max(1, kw["num_heads"])))
            / 2) ** -0.5,
        layer_pattern=tuple("hybrid" if t == "hybrid" else "mamba"
                            for t in types),
        zamba=ZambaConfig(
            num_mem_blocks=int(hf.get("num_mem_blocks", 1)),
            hybrid_ids=tuple(hybrid_ids),
            use_rope=bool(hf.get("use_mem_rope", False)),
            adapter_rank=int(hf.get("adapter_rank", 128)),
            use_attn_adapter=bool(
                hf.get("use_shared_attention_adapter", False)),
        ),
    )
    mc = MambaConfig(
        d_ssm=int(hf.get("mamba_expand", 2)) * hidden,
        n_heads=int(hf.get("n_mamba_heads", 8)),
        head_dim=int(hf.get("mamba_headdim", 64)),
        n_groups=int(hf.get("mamba_ngroups", 1)),
        d_state=int(hf.get("mamba_d_state", 64)),
        d_conv=int(hf.get("mamba_d_conv", 4)),
        chunk_size=int(hf.get("chunk_size", 256)),
        conv_bias=bool(hf.get("use_conv_bias", True)),
        proj_bias=bool(hf.get("add_bias_linear", False)),
        rms_norm=True,  # Zamba2RMSNormGated always (eps hardcoded 1e-5)
        # HF clamps dt to time_step_min only (max is commented out)
        time_step_min=float(hf.get("time_step_min", 0.001)),
        time_step_max=float("inf"),
    )
    kw["mamba"] = mc
    kw["hidden_act"] = hf.get("hidden_act", "gelu")
    kw["tie_word_embeddings"] = bool(hf.get("tie_word_embeddings", True))
    return cls(model_type="zamba2", name=name, **kw)


def _build_granitemoehybrid(cls, hf, model_type, name):
    """granite-4.0-h: SERIAL mamba2/attention hybrid (layers_block_type
    picks the mixer per layer, like bamba) with granite's scalar
    multipliers, granitemoe fused-expert MoE (0 experts allowed) and an
    always-on fused shared MLP added to the routed output; NoPE unless
    position_embedding_type == "rope" (HF GraniteMoeHybridDecoderLayer;
    reference catalogs granite-4.0-h via mapper.py)."""
    kw = _common(hf)
    kw["embed_scale"] = float(hf.get("embedding_multiplier", 1.0))
    kw["attn_logit_scale"] = float(hf.get("attention_multiplier",
                                          kw["hidden_size"] ** -0.5))
    kw["residual_multiplier"] = float(hf.get("residual_multiplier", 1.0))
    ls = float(hf.get("logits_scaling", 1.0))
    if ls != 1.0:
        kw["logit_scale"] = 1.0 / ls
    mc = dict(hf)
    mc.setdefault("mamba_rms_norm", True)  # gated RMSNorm always on
    kw["mamba"] = MambaConfig.from_hf(mc)
    n_layers = kw["num_layers"]
    # serialized as layer_types; constructor kwarg is layers_block_type
    types = (hf.get("layer_types") or hf.get("layers_block_type")
             or ["mamba"] * n_layers)
    kw["layer_pattern"] = tuple(
        "global" if t == "attention" else "mamba" for t in types)
    if hf.get("position_embedding_type") != "rope":
        kw["rope_layers"] = (False,) * n_layers  # NoPE
    n_experts = int(hf.get("num_local_experts", 0) or 0)
    kw.update(
        num_experts=n_experts,
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 0) or 0),
        moe_intermediate_size=int(hf.get("intermediate_size", 1024)),
        moe_routing="topk_softmax",
        moe_shared_expert=bool(n_experts),
        # the dense/shared MLP dims are shared_intermediate_size; the
        # routed experts use intermediate_size
        intermediate_size=int(hf.get("shared_intermediate_size", 1024)),
    )
    kw["tie_word_embeddings"] = bool(hf.get("tie_word_embeddings", True))
    return cls(model_type="granitemoehybrid", name=name, **kw)


def _build_lfm2(cls, hf, model_type, name):
    """LFM2 (LiquidAI): hybrid stack of gated short-conv mixer layers and
    full-attention layers (per-head qk-norm before rope); SwiGLU MLP with
    auto-adjusted width; final 'embedding_norm'."""
    kw = _common(hf)
    kw["rms_norm_eps"] = float(hf.get("norm_eps", 1e-5))
    kw["qk_norm"] = True
    kw["tie_word_embeddings"] = bool(hf.get("tie_word_embeddings", True))
    inter = int(hf.get("intermediate_size", 4 * kw["hidden_size"]))
    if hf.get("block_auto_adjust_ff_dim", True):
        inter = int(2 * inter / 3)
        mult = hf.get("block_ffn_dim_multiplier")
        if mult is not None:
            inter = int(float(mult) * inter)
        m_of = int(hf.get("block_multiple_of", 256))
        inter = m_of * ((inter + m_of - 1) // m_of)
    kw["intermediate_size"] = inter
    types = hf.get("layer_types") or []
    if types:
        kw["layer_pattern"] = tuple(
            "global" if t == "full_attention" else "conv" for t in types)
    kw.update(
        short_conv_l=int(hf.get("conv_L_cache", 3)),
        short_conv_bias=bool(hf.get("conv_bias", False)),
    )
    return cls(model_type="lfm2", name=name, **kw)


def _build_gemma3n(cls, hf, model_type, name):
    """gemma-3n text: AltUp (4-stream hiddens with learned predict/correct
    mixing), Laurel block, per-layer input embeddings, gaussian-topk
    activation sparsity in early layers, sliding/full pattern with local
    rope, v-norm, attention scale 1.0."""
    inter = hf.get("intermediate_size", 16384)
    if isinstance(inter, (list, tuple)):
        inter = inter[0]
    hf = dict(hf, intermediate_size=int(inter))
    kw = _common(hf)
    n_layers = kw["num_layers"]
    kw["tie_word_embeddings"] = bool(hf.get("tie_word_embeddings", True))
    act = (hf.get("hidden_activation") or hf.get("hidden_act")
           or "gelu_pytorch_tanh")
    kw["hidden_act"] = {"gelu_pytorch_tanh": "gelu_tanh"}.get(act, act)
    layer_types = hf.get("layer_types") or [
        "full_attention" if (i + 1) % 5 == 0 else "sliding_attention"
        for i in range(n_layers)]
    sparsity = hf.get("activation_sparsity_pattern")
    if sparsity is None:
        sparsity = [0.0] * n_layers
    kw.update(
        intermediate_size=int(inter),
        qk_norm=True,
        use_post_norms=True,
        embed_scale=float(kw["hidden_size"]) ** 0.5,
        final_softcap=float(hf["final_logit_softcapping"])
        if hf.get("final_logit_softcapping") else None,
        attn_logit_scale=1.0,  # HF Gemma3nTextAttention scaling=1.0
        sliding_window=int(hf.get("sliding_window", 512)),
        layer_pattern=tuple(
            "sliding" if t == "sliding_attention" else "global"
            for t in layer_types),
        rope_local_theta=float(hf.get("rope_local_base_freq", 10000.0)),
        altup=AltUpConfig(
            num_inputs=int(hf.get("altup_num_inputs", 4)),
            active_idx=int(hf.get("altup_active_idx", 0)),
            coef_clip=(float(hf["altup_coef_clip"])
                       if hf.get("altup_coef_clip") else None),
            correct_scale=bool(hf.get("altup_correct_scale", True)),
            laurel_rank=int(hf.get("laurel_rank", 64)),
            hidden_per_layer=int(hf.get("hidden_size_per_layer_input",
                                        256)),
            vocab_per_layer=int(hf.get("vocab_size_per_layer_input",
                                       262144)),
            num_kv_shared_layers=int(hf.get("num_kv_shared_layers", 0)),
            activation_sparsity=tuple(float(s) for s in sparsity),
        ),
    )
    return cls(model_type="gemma3n", name=name, **kw)


def _build_llama4(cls, hf, model_type, name):
    """Llama-4 text (reference: models/llama4.py): interleaved RoPE with
    NoPE layers, chunked local attention, L2 qk-norm, temperature-tuned
    NoPE queries, sigmoid-routed MoE scaling the expert INPUT, plus an
    always-on shared expert. Dense (non-MoE) layers use
    intermediate_size_mlp; experts/shared expert use intermediate_size."""
    if "text_config" in hf:
        hf = dict(hf["text_config"])
    kw = _common(hf)
    n_layers = kw["num_layers"]
    step = int(hf.get("interleave_moe_layer_step", 1) or 1)
    moe_layers = hf.get("moe_layers")
    if moe_layers is None:
        moe_layers = [i for i in range(n_layers) if (i + 1) % step == 0]
    moe_set = set(int(i) for i in moe_layers)
    no_rope = hf.get("no_rope_layers")
    if not no_rope:
        # HF default: every 4th layer is NoPE
        no_rope = [0 if (i + 1) % 4 == 0 else 1 for i in range(n_layers)]
    rope_layers = tuple(bool(v) for v in no_rope)
    layer_types = hf.get("layer_types") or [
        "chunked_attention" if rope_layers[i] else "full_attention"
        for i in range(n_layers)]
    kw.update(
        intermediate_size=int(hf.get("intermediate_size_mlp",
                                     hf.get("intermediate_size", 16384))),
        num_experts=int(hf.get("num_local_experts", 0)),
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 1)),
        moe_intermediate_size=int(hf.get("intermediate_size", 8192)),
        moe_layer_pattern=tuple(i in moe_set for i in range(n_layers)),
        moe_routing="llama4",
        moe_shared_expert=True,
        rope_interleaved=True,
        rope_layers=rope_layers,
        qk_norm="l2" if hf.get("use_qk_norm", True) else False,
        attention_chunk_size=hf.get("attention_chunk_size"),
        layer_pattern=tuple(
            {"chunked_attention": "chunked",
             "full_attention": "global"}[t] for t in layer_types),
        attn_temperature_tuning=bool(
            hf.get("attn_temperature_tuning", False)),
        floor_scale=float(hf.get("floor_scale", 8192)),
        attn_scale=float(hf.get("attn_scale", 0.1)),
    )
    return cls(model_type="llama4", name=name, **kw)


def _build_gpt_oss(cls, hf, model_type, name):
    kw = _common(hf)
    kw.update(
        num_experts=int(hf.get("num_local_experts", 32)),
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 4)),
        moe_intermediate_size=int(hf.get("intermediate_size", 2880)),
        sliding_window=int(hf.get("sliding_window", 128)),
        layer_pattern=("sliding", "global"),
        attention_bias=True,
        o_proj_bias=True,
        attn_sinks=True,
        router_bias=True,
        moe_mlp_bias=True,
        moe_act="gpt_oss_glu",  # clamped glu with alpha=1.702
        norm_topk_prob=True,
    )
    return cls(model_type=model_type, name=name, **kw)


_HF_BUILDERS = {
    "qwen2_5_vl": _build_llama_like,
    "qwen2_vl": _build_llama_like,
    "llama": _build_llama_like,
    "mistral": _build_llama_like,
    "qwen2": _build_llama_like,
    "qwen3": _build_llama_like,
    "qwen3_moe": _build_llama_like,
    "mixtral": _build_llama_like,
    "granite": _build_llama_like,
    "phi3": _build_llama_like,
    "cohere": _build_llama_like,
    "cohere2": _build_llama_like,
    "smollm3": _build_llama_like,
    "olmo2": _build_llama_like,
    "gemma": _build_gemma,
    "gemma2": _build_gemma,
    "gemma3": _build_gemma,
    "gemma3n": _build_gemma3n,
    "gemma3n_text": _build_gemma3n,
    "lfm2": _build_lfm2,
    "bamba": _build_bamba,
    "granitemoehybrid": _build_granitemoehybrid,
    "zamba2": _build_zamba2,
    "dots1": _build_dots1,
    "minimax": _build_minimax,
    "gemma3_text": _build_gemma,
    "gpt_oss": _build_gpt_oss,
    "llama4": _build_llama4,
    "llama4_text": _build_llama4,
    "falcon_h1": _build_falcon_h1,
    "deepseek_v3": _build_deepseek_v3,
    "glm4_moe": _build_glm4_moe,
    "qwen3_next": _build_qwen3_next,
}


def load_hf_config(path: str) -> Dict[str, Any]:
    cfg_path = os.path.join(path, "config.json") if os.path.isdir(path) else path
    with open(cfg_path) as f:
        return json.load(f)
