"""HF architecture registry and named presets (port of
``tensorlink_tpu/models/registry.py``).

Each supported family declares how its Hugging Face config maps onto the
unified core (:func:`config_from_hf`) and how its checkpoint tensor names
map onto the parameter tree (:func:`hf_name_map`, :func:`hf_prefix`,
read by ``engine/loader.py``). The parsers, name maps and the preset
table carry the JAX package's values, so a checkpoint or a preset names
the same architecture and the same leaves in both packages.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .base import ModelConfig

# tlint: disable=TL006(family registry: populated at import, read-only after)
_FAMILY_BUILDERS: dict[str, Callable[[dict], ModelConfig]] = {}


def register_family(model_type: str):
    """Decorator: register ``fn(hf_config_dict) -> ModelConfig`` as the
    parser of ``model_type``."""

    def deco(fn):
        _FAMILY_BUILDERS[model_type] = fn
        return fn

    return deco


def config_from_hf(hf_config: Any,
                   dtype: torch.dtype = torch.bfloat16) -> ModelConfig:
    """Build a ModelConfig from a ``transformers`` config object (anything
    with ``to_dict``) or a dict; an unknown ``model_type`` raises."""
    d = hf_config if isinstance(hf_config, dict) else hf_config.to_dict()
    mt = d.get("model_type")
    if mt not in _FAMILY_BUILDERS:
        raise ValueError(
            f"unsupported model_type {mt!r}; supported: "
            f"{sorted(_FAMILY_BUILDERS)}"
        )
    return _FAMILY_BUILDERS[mt](d).with_(dtype=dtype)


@register_family("gpt2")
def _gpt2(d: dict) -> ModelConfig:
    n_embd = d["n_embd"]
    return ModelConfig(
        family="gpt2",
        vocab_size=d["vocab_size"],
        d_model=n_embd,
        n_layers=d["n_layer"],
        n_heads=d["n_head"],
        n_kv_heads=d["n_head"],
        head_dim=n_embd // d["n_head"],
        d_ff=d.get("n_inner") or 4 * n_embd,
        max_seq_len=d["n_positions"],
        norm_eps=d.get("layer_norm_epsilon", 1e-5),
        act="gelu",
        pos="learned",
        attn_bias=True,
        mlp="fused",
        norm="layernorm",
        tie_embeddings=True,
    )


def _llama_like(d: dict, **overrides) -> ModelConfig:
    n_heads = d["num_attention_heads"]
    head_dim = d.get("head_dim") or d["hidden_size"] // n_heads
    kw: dict[str, Any] = dict(
        family="llama",
        vocab_size=d["vocab_size"],
        d_model=d["hidden_size"],
        n_layers=d["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=d.get("num_key_value_heads") or n_heads,
        head_dim=head_dim,
        d_ff=d["intermediate_size"],
        max_seq_len=d.get("max_position_embeddings", 4096),
        norm_eps=d.get("rms_norm_eps", 1e-6),
        act="silu",
        pos="rope",
        rope_theta=d.get("rope_theta", 10000.0),
        mlp="gated",
        norm="rmsnorm",
        tie_embeddings=d.get("tie_word_embeddings", False),
        attn_bias=d.get("attention_bias", False),
        mlp_bias=d.get("mlp_bias", False),
    )
    kw.update(overrides)
    return ModelConfig(**kw)


@register_family("llama")
def _llama(d: dict) -> ModelConfig:
    return _llama_like(d)


@register_family("mistral")
def _mistral(d: dict) -> ModelConfig:
    return _llama_like(
        d, family="mistral", sliding_window=d.get("sliding_window")
    )


@register_family("qwen2")
def _qwen2(d: dict) -> ModelConfig:
    # Qwen2/2.5: llama core + qkv biases
    return _llama_like(d, family="qwen2", attn_bias=True)


@register_family("qwen3")
def _qwen3(d: dict) -> ModelConfig:
    # Qwen3: llama core + per-head q/k RMSNorm, no biases
    return _llama_like(d, family="qwen3", qk_norm=True, attn_bias=False)


@register_family("mixtral")
def _mixtral(d: dict) -> ModelConfig:
    return _llama_like(
        d,
        family="mixtral",
        n_experts=d["num_local_experts"],
        n_experts_per_tok=d["num_experts_per_tok"],
        sliding_window=d.get("sliding_window"),
    )


@register_family("gemma")
def _gemma(d: dict) -> ModelConfig:
    # Gemma: llama layout + sqrt(d_model)-scaled embeddings, (1+w) rmsnorm,
    # tanh-approx gelu, always-tied embeddings, explicit head_dim
    return _llama_like(
        d,
        family="gemma",
        act="gelu",
        embed_scale=True,
        norm_plus_one=True,
        tie_embeddings=True,
    )


@register_family("phi3")
def _phi3(d: dict) -> ModelConfig:
    # Phi-3: llama compute with fused qkv_proj / gate_up_proj checkpoints
    if d.get("rope_scaling"):
        # longrope rescales rotary frequencies at every context length —
        # loading such a checkpoint with plain rope would generate fluent
        # garbage; refuse instead (128k-context Phi-3 variants)
        raise ValueError(
            "phi3 rope_scaling (longrope) is not supported; use a "
            "non-rope-scaled Phi-3 checkpoint"
        )
    return _llama_like(
        d, family="phi3", sliding_window=d.get("sliding_window")
    )


@register_family("olmo2")
def _olmo2(d: dict) -> ModelConfig:
    # OLMo-2: llama layout reordered — RMSNorm on sublayer OUTPUTS
    # (post_attention / post_feedforward), full-projection-dim q/k norms
    return _llama_like(
        d, family="olmo2", norm_position="post", qk_norm_full=True
    )


@register_family("gpt_neox")
def _gpt_neox(d: dict) -> ModelConfig:
    # GPT-NeoX / Pythia: layernorm with biases, parallel attn+mlp residual,
    # partial rotary (rotary_pct), fused-mlp with biases, exact gelu
    n_heads = d["num_attention_heads"]
    return ModelConfig(
        family="gpt_neox",
        vocab_size=d["vocab_size"],
        d_model=d["hidden_size"],
        n_layers=d["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=n_heads,
        head_dim=d["hidden_size"] // n_heads,
        d_ff=d["intermediate_size"],
        max_seq_len=d.get("max_position_embeddings", 2048),
        norm_eps=d.get("layer_norm_eps", 1e-5),
        act="gelu_exact" if d.get("hidden_act", "gelu") == "gelu" else "gelu",
        pos="rope",
        rope_theta=d.get("rotary_emb_base", 10000.0),
        rope_pct=d.get("rotary_pct", 0.25),
        attn_bias=d.get("attention_bias", True),
        attn_out_bias=d.get("attention_bias", True),
        mlp="fused",
        norm="layernorm",
        parallel_residual=d.get("use_parallel_residual", True),
        tie_embeddings=d.get("tie_word_embeddings", False),
    )


# ---------------------------------------------------------------------------
# Checkpoint tensor-name mapping (engine/loader.py)
# ---------------------------------------------------------------------------
# Our tree path -> HF tensor name template ({i} = layer). "~T" marks weights
# stored transposed in HF (torch Linear stores [out, in]; we use [in, out]).
# GPT-2's Conv1D already stores [in, out] (no ~T) and fuses qkv (split rule).


def hf_name_map(cfg: ModelConfig) -> dict[str, Any]:
    if cfg.family == "gpt2":
        return {
            "embed.tok": "wte.weight",
            "embed.pos": "wpe.weight",
            "layers.ln1.scale": "h.{i}.ln_1.weight",
            "layers.ln1.bias": "h.{i}.ln_1.bias",
            "layers.attn.wq": ("split3.0", "h.{i}.attn.c_attn.weight"),
            "layers.attn.wk": ("split3.1", "h.{i}.attn.c_attn.weight"),
            "layers.attn.wv": ("split3.2", "h.{i}.attn.c_attn.weight"),
            "layers.attn.bq": ("split3.0", "h.{i}.attn.c_attn.bias"),
            "layers.attn.bk": ("split3.1", "h.{i}.attn.c_attn.bias"),
            "layers.attn.bv": ("split3.2", "h.{i}.attn.c_attn.bias"),
            "layers.attn.wo": "h.{i}.attn.c_proj.weight",
            "layers.attn.bo": "h.{i}.attn.c_proj.bias",
            "layers.ln2.scale": "h.{i}.ln_2.weight",
            "layers.ln2.bias": "h.{i}.ln_2.bias",
            "layers.mlp.w_up": "h.{i}.mlp.c_fc.weight",
            "layers.mlp.b_up": "h.{i}.mlp.c_fc.bias",
            "layers.mlp.w_down": "h.{i}.mlp.c_proj.weight",
            "layers.mlp.b_down": "h.{i}.mlp.c_proj.bias",
            "final_norm.scale": "ln_f.weight",
            "final_norm.bias": "ln_f.bias",
        }

    if cfg.family == "phi3":
        # fused qkv_proj ([q+2kv, d]) and gate_up_proj ([2f, d]) checkpoints
        q, kv, f = cfg.q_dim, cfg.kv_dim, cfg.d_ff
        qkv = "layers.{i}.self_attn.qkv_proj.weight"
        gu = "layers.{i}.mlp.gate_up_proj.weight"
        m = {
            "embed.tok": "embed_tokens.weight",
            "layers.ln1.scale": "layers.{i}.input_layernorm.weight",
            "layers.attn.wq": (f"rowsT.0.{q}", qkv),
            "layers.attn.wk": (f"rowsT.{q}.{q + kv}", qkv),
            "layers.attn.wv": (f"rowsT.{q + kv}.{q + 2 * kv}", qkv),
            "layers.attn.wo": "~T layers.{i}.self_attn.o_proj.weight",
            "layers.ln2.scale": "layers.{i}.post_attention_layernorm.weight",
            "layers.mlp.w_gate": (f"rowsT.0.{f}", gu),
            "layers.mlp.w_up": (f"rowsT.{f}.{2 * f}", gu),
            "layers.mlp.w_down": "~T layers.{i}.mlp.down_proj.weight",
            "final_norm.scale": "norm.weight",
        }
        if not cfg.tie_embeddings:
            m["lm_head"] = "~T ^lm_head.weight"
        return m

    if cfg.family == "gpt_neox":
        # fused query_key_value with per-head-interleaved q/k/v rows
        qkv_w = "layers.{i}.attention.query_key_value.weight"
        qkv_b = "layers.{i}.attention.query_key_value.bias"
        m = {
            "embed.tok": "embed_in.weight",
            "layers.ln1.scale": "layers.{i}.input_layernorm.weight",
            "layers.ln1.bias": "layers.{i}.input_layernorm.bias",
            "layers.attn.wq": ("neox_qkv.0", qkv_w),
            "layers.attn.wk": ("neox_qkv.1", qkv_w),
            "layers.attn.wv": ("neox_qkv.2", qkv_w),
            "layers.attn.bq": ("neox_qkvb.0", qkv_b),
            "layers.attn.bk": ("neox_qkvb.1", qkv_b),
            "layers.attn.bv": ("neox_qkvb.2", qkv_b),
            "layers.attn.wo": "~T layers.{i}.attention.dense.weight",
            "layers.attn.bo": "layers.{i}.attention.dense.bias",
            "layers.ln2.scale": "layers.{i}.post_attention_layernorm.weight",
            "layers.ln2.bias": "layers.{i}.post_attention_layernorm.bias",
            "layers.mlp.w_up": "~T layers.{i}.mlp.dense_h_to_4h.weight",
            "layers.mlp.b_up": "layers.{i}.mlp.dense_h_to_4h.bias",
            "layers.mlp.w_down": "~T layers.{i}.mlp.dense_4h_to_h.weight",
            "layers.mlp.b_down": "layers.{i}.mlp.dense_4h_to_h.bias",
            "final_norm.scale": "final_layer_norm.weight",
            "final_norm.bias": "final_layer_norm.bias",
        }
        if not cfg.tie_embeddings:
            m["lm_head"] = "~T ^embed_out.weight"
        return m

    m = {
        "embed.tok": "embed_tokens.weight",
        "layers.ln1.scale": "layers.{i}.input_layernorm.weight",
        "layers.attn.wq": "~T layers.{i}.self_attn.q_proj.weight",
        "layers.attn.wk": "~T layers.{i}.self_attn.k_proj.weight",
        "layers.attn.wv": "~T layers.{i}.self_attn.v_proj.weight",
        "layers.attn.wo": "~T layers.{i}.self_attn.o_proj.weight",
        "layers.ln2.scale": "layers.{i}.post_attention_layernorm.weight",
        "final_norm.scale": "norm.weight",
    }
    if cfg.attn_bias:
        m |= {
            "layers.attn.bq": "layers.{i}.self_attn.q_proj.bias",
            "layers.attn.bk": "layers.{i}.self_attn.k_proj.bias",
            "layers.attn.bv": "layers.{i}.self_attn.v_proj.bias",
        }
    if cfg.qk_norm or cfg.qk_norm_full:
        m |= {
            "layers.attn.q_norm": "layers.{i}.self_attn.q_norm.weight",
            "layers.attn.k_norm": "layers.{i}.self_attn.k_norm.weight",
        }
    if cfg.family == "olmo2":
        # post-norm reordering: our ln1 holds post_attention_layernorm, ln2
        # holds post_feedforward_layernorm (no input norms exist)
        m["layers.ln1.scale"] = "layers.{i}.post_attention_layernorm.weight"
        m["layers.ln2.scale"] = "layers.{i}.post_feedforward_layernorm.weight"
    if cfg.moe:
        m |= {
            "layers.mlp.router": "~T layers.{i}.block_sparse_moe.gate.weight",
            "layers.mlp.w_gate": (
                "stackE",
                "~T layers.{i}.block_sparse_moe.experts.{e}.w1.weight",
            ),
            "layers.mlp.w_down": (
                "stackE",
                "~T layers.{i}.block_sparse_moe.experts.{e}.w2.weight",
            ),
            "layers.mlp.w_up": (
                "stackE",
                "~T layers.{i}.block_sparse_moe.experts.{e}.w3.weight",
            ),
        }
    else:
        m |= {
            "layers.mlp.w_gate": "~T layers.{i}.mlp.gate_proj.weight",
            "layers.mlp.w_up": "~T layers.{i}.mlp.up_proj.weight",
            "layers.mlp.w_down": "~T layers.{i}.mlp.down_proj.weight",
        }
        if cfg.mlp_bias:
            m |= {
                "layers.mlp.b_gate": "layers.{i}.mlp.gate_proj.bias",
                "layers.mlp.b_up": "layers.{i}.mlp.up_proj.bias",
                "layers.mlp.b_down": "layers.{i}.mlp.down_proj.bias",
            }
    if not cfg.tie_embeddings:
        m["lm_head"] = "~T ^lm_head.weight"  # ^ = top-level, outside prefix
    return m


# Prefix inside the checkpoint for the backbone tensors, e.g. HF llama stores
# "model.layers.0...." and "lm_head.weight" at top level.
def hf_prefix(cfg: ModelConfig) -> str:
    if cfg.family == "gpt2":
        return "transformer."
    if cfg.family == "gpt_neox":
        return "gpt_neox."
    return "model."


def config_presets() -> dict[str, ModelConfig]:
    """Named presets for tests and benchmarks (no network access)."""
    return {
        "gpt2-small": ModelConfig(
            family="gpt2",
            vocab_size=50257,
            d_model=768,
            n_layers=12,
            n_heads=12,
            n_kv_heads=12,
            head_dim=64,
            d_ff=3072,
            max_seq_len=1024,
            norm_eps=1e-5,
            act="gelu",
            pos="learned",
            attn_bias=True,
            mlp="fused",
            norm="layernorm",
            tie_embeddings=True,
        ),
        "qwen3-8b": ModelConfig(
            family="qwen3",
            vocab_size=151936,
            d_model=4096,
            n_layers=36,
            n_heads=32,
            n_kv_heads=8,
            head_dim=128,
            d_ff=12288,
            max_seq_len=40960,
            norm_eps=1e-6,
            rope_theta=1e6,
            qk_norm=True,
            tie_embeddings=False,
        ),
        "qwen3-4b": ModelConfig(
            family="qwen3",
            vocab_size=151936,
            d_model=2560,
            n_layers=36,
            n_heads=32,
            n_kv_heads=8,
            head_dim=128,
            d_ff=9728,
            max_seq_len=40960,
            norm_eps=1e-6,
            rope_theta=1e6,
            qk_norm=True,
            tie_embeddings=True,
        ),
        "qwen3-0p6b": ModelConfig(
            family="qwen3",
            vocab_size=151936,
            d_model=1024,
            n_layers=28,
            n_heads=16,
            n_kv_heads=8,
            head_dim=128,
            d_ff=3072,
            max_seq_len=40960,
            norm_eps=1e-6,
            rope_theta=1e6,
            qk_norm=True,
            tie_embeddings=True,
        ),
        "qwen3-1p7b": ModelConfig(
            family="qwen3",
            vocab_size=151936,
            d_model=2048,
            n_layers=28,
            n_heads=16,
            n_kv_heads=8,
            head_dim=128,
            d_ff=6144,
            max_seq_len=40960,
            norm_eps=1e-6,
            rope_theta=1e6,
            qk_norm=True,
            tie_embeddings=True,
        ),
        "qwen2p5-7b": ModelConfig(
            family="qwen2",
            vocab_size=152064,
            d_model=3584,
            n_layers=28,
            n_heads=28,
            n_kv_heads=4,
            head_dim=128,
            d_ff=18944,
            max_seq_len=32768,
            norm_eps=1e-6,
            rope_theta=1e6,
            attn_bias=True,
        ),
        "llama3-70b": ModelConfig(
            family="llama",
            vocab_size=128256,
            d_model=8192,
            n_layers=80,
            n_heads=64,
            n_kv_heads=8,
            head_dim=128,
            d_ff=28672,
            max_seq_len=8192,
            norm_eps=1e-5,
            rope_theta=5e5,
        ),
        "gemma-7b": ModelConfig(
            family="gemma",
            vocab_size=256000,
            d_model=3072,
            n_layers=28,
            n_heads=16,
            n_kv_heads=16,
            head_dim=256,
            d_ff=24576,
            max_seq_len=8192,
            act="gelu",
            embed_scale=True,
            norm_plus_one=True,
            tie_embeddings=True,
        ),
        "phi3-mini": ModelConfig(
            family="phi3",
            vocab_size=32064,
            d_model=3072,
            n_layers=32,
            n_heads=32,
            n_kv_heads=32,
            head_dim=96,
            d_ff=8192,
            max_seq_len=4096,
            norm_eps=1e-5,
        ),
        "pythia-1b": ModelConfig(
            family="gpt_neox",
            vocab_size=50304,
            d_model=2048,
            n_layers=16,
            n_heads=8,
            n_kv_heads=8,
            head_dim=256,
            d_ff=8192,
            max_seq_len=2048,
            norm_eps=1e-5,
            act="gelu_exact",
            rope_pct=0.25,
            attn_bias=True,
            attn_out_bias=True,
            mlp="fused",
            norm="layernorm",
            parallel_residual=True,
        ),
        "olmo2-7b": ModelConfig(
            family="olmo2",
            vocab_size=100352,
            d_model=4096,
            n_layers=32,
            n_heads=32,
            n_kv_heads=32,
            head_dim=128,
            d_ff=11008,
            max_seq_len=4096,
            norm_eps=1e-6,
            rope_theta=5e5,
            norm_position="post",
            qk_norm_full=True,
        ),
        "mixtral-8x7b": ModelConfig(
            family="mixtral",
            vocab_size=32000,
            d_model=4096,
            n_layers=32,
            n_heads=32,
            n_kv_heads=8,
            head_dim=128,
            d_ff=14336,
            max_seq_len=32768,
            norm_eps=1e-5,
            rope_theta=1e6,
            n_experts=8,
            n_experts_per_tok=2,
        ),
    }


__all__ = ["config_from_hf", "config_presets", "hf_name_map", "hf_prefix",
           "register_family"]
