"""Decoder-only text LLM (llama / mistral family) over a parameter dict.

Parameters keep the JAX package's layout (per-layer weights stacked on a
leading axis, kernels as (in, out)); the KV cache is (L, B, S_max, Hkv, Dh).
Unlike the JAX package's immutable arrays, the cache is updated in place:
``decoder_forward`` writes the new k/v rows into the cache it is given and
returns that same object.

Gemma / Qwen-3 family features (logit softcaps, qk-norm, post-norms, local
rope bases, embedding scaling) raise ``NotImplementedError``; they are a
later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ultravox_torch.models.config import DecoderConfig
from ultravox_torch.models.lora import proj_apply
from ultravox_torch.ops.attention import NEG_INF, mha
from ultravox_torch.ops.kernels.fused_attention import fused_attention
from ultravox_torch.ops.norms import rms_norm
from ultravox_torch.ops.rope import apply_rope, rope_cos_sin, rope_frequencies

Params = Dict[str, Any]


@dataclasses.dataclass
class KVCache:
    """Static-shape per-layer KV cache: k, v of (L, B, S_max, Hkv, Dh)."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @classmethod
    def zeros(cls, cfg: DecoderConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


def check_supported(cfg: DecoderConfig) -> None:
    """Raise for the family features this port does not run yet."""
    unsupported = {
        "attn_logit_softcapping": cfg.attn_logit_softcapping is not None,
        "final_logit_softcapping": bool(cfg.final_logit_softcapping),
        "qk_norm": cfg.qk_norm,
        "use_post_norms": cfg.use_post_norms,
        "rope_local_base_freq": cfg.rope_local_base_freq is not None,
        "scale_embeddings": cfg.scale_embeddings,
        "query_pre_attn_scalar": cfg.query_pre_attn_scalar is not None,
    }
    bad = [k for k, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(f"decoder features not ported yet: {bad}")


def is_local_layer(cfg: DecoderConfig) -> np.ndarray:
    """(L,) bool: which layers use sliding-window attention."""
    if cfg.layer_is_local is not None:
        if len(cfg.layer_is_local) != cfg.num_layers:
            raise ValueError("layer_is_local must have one entry per layer")
        return np.asarray(cfg.layer_is_local, dtype=bool)
    if cfg.sliding_window is None:
        return np.zeros(cfg.num_layers, dtype=bool)
    if cfg.sliding_window_pattern is None:
        return np.ones(cfg.num_layers, dtype=bool)
    return (np.arange(cfg.num_layers) + 1) % cfg.sliding_window_pattern != 0


def init_params(cfg: DecoderConfig, generator: torch.Generator, dtype=torch.float32, device=None) -> Params:
    """Seeded random init in the JAX package's tree layout."""
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def dn(*shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers: Params = {
        "input_ln": ones(L, D),
        "q_proj": {"kernel": dn(L, D, Hq * Dh)},
        "k_proj": {"kernel": dn(L, D, Hkv * Dh)},
        "v_proj": {"kernel": dn(L, D, Hkv * Dh)},
        "o_proj": {"kernel": dn(L, Hq * Dh, D)},
        "post_attn_ln": ones(L, D),
        "gate_proj": {"kernel": dn(L, D, I)},
        "up_proj": {"kernel": dn(L, D, I)},
        "down_proj": {"kernel": dn(L, I, D)},
    }
    if cfg.attention_bias:
        for name, width in (("q_proj", Hq * Dh), ("k_proj", Hkv * Dh), ("v_proj", Hkv * Dh)):
            layers[name]["bias"] = torch.zeros((L, width), dtype=dtype, device=device)
    params: Params = {"embed_tokens": dn(cfg.vocab_size, D), "layers": layers, "norm": ones(D)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": dn(D, cfg.vocab_size)}
    return params


def _act(cfg: DecoderConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.hidden_act == "silu":
        return F.silu(x)
    if cfg.hidden_act in ("gelu_pytorch_tanh", "gelu"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unsupported activation {cfg.hidden_act}")


def _qkv(cfg: DecoderConfig, h: torch.Tensor, p: Params):
    B, T, _ = h.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "qkv_proj" in p:
        qkv = proj_apply(h, p["qkv_proj"])
        q = qkv[..., : Hq * Dh]
        k = qkv[..., Hq * Dh : (Hq + Hkv) * Dh]
        v = qkv[..., (Hq + Hkv) * Dh :]
    else:
        q, k, v = (proj_apply(h, p[n]) for n in ("q_proj", "k_proj", "v_proj"))
    return q.reshape(B, T, Hq, Dh), k.reshape(B, T, Hkv, Dh), v.reshape(B, T, Hkv, Dh)


def _mlp(cfg: DecoderConfig, h: torch.Tensor, p: Params) -> torch.Tensor:
    if "gateup_proj" in p:
        gate, up = proj_apply(h, p["gateup_proj"]).chunk(2, dim=-1)
    else:
        gate, up = proj_apply(h, p["gate_proj"]), proj_apply(h, p["up_proj"])
    return proj_apply(_act(cfg, gate) * up, p["down_proj"])


def _layer(layers: Params, l: int) -> Params:
    return {k: _layer(v, l) if isinstance(v, dict) else v[l] for k, v in layers.items()}


def make_attention_bias(
    cfg: DecoderConfig,
    q_positions: torch.Tensor,  # (B, T) absolute query positions
    kv_len: int,
    kv_valid_len: torch.Tensor,  # (B,) valid key count
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Additive (B, 1, T, S) causal bias, plus the sliding-window bias when
    the config has a window: key j is visible to query i iff j <= i and
    j < kv_valid_len (and i - j < window for the local bias)."""
    dev = q_positions.device
    kpos = torch.arange(kv_len, device=dev)[None, None, :]
    qpos = q_positions.long()[:, :, None]
    ok = (kpos <= qpos) & (kpos < kv_valid_len.long()[:, None, None])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias_global = torch.where(ok, zero, NEG_INF)[:, None]
    bias_local = None
    if cfg.sliding_window is not None:
        ok_l = ok & (qpos - kpos < cfg.sliding_window)
        bias_local = torch.where(ok_l, zero, NEG_INF)[:, None]
    return bias_global, bias_local


def embed_lookup(params: Params, ids: torch.Tensor) -> torch.Tensor:
    """Token-embedding rows."""
    if "embed_tokens_q" in params:
        raise NotImplementedError("int8 embeddings are not ported yet")
    return params["embed_tokens"][ids.long()]


def compute_logits(params: Params, cfg: DecoderConfig, hidden: torch.Tensor) -> torch.Tensor:
    """LM head: hidden (..., D) -> fp32 logits (..., V). The product runs in
    the weights' dtype and is then widened, as in the reference."""
    head = params.get("lm_head")
    if head is not None and "kernel_q" in head:
        raise NotImplementedError("int8 LM heads are not ported yet")
    if head is None or cfg.tie_word_embeddings:
        return (hidden @ params["embed_tokens"].T).float()
    return (hidden @ head["kernel"]).float()


def fuse_inference_params(params: Params, cfg: DecoderConfig) -> Params:
    """Inference tree with q/k/v and gate/up concatenated into ``qkv_proj``
    and ``gateup_proj``. Returns the input unchanged when it is already fused
    or carries LoRA adapters."""
    ly = params["layers"]
    if "qkv_proj" in ly or "kernel" not in ly.get("q_proj", {}):
        return params
    if any("lora_a" in ly.get(n, {}) for n in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")):
        return params
    new = dict(ly)
    qkv = {"kernel": torch.cat([ly[n]["kernel"] for n in ("q_proj", "k_proj", "v_proj")], dim=-1)}
    if "bias" in ly["q_proj"]:
        qkv["bias"] = torch.cat([ly[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")], dim=-1)
    new["qkv_proj"] = qkv
    new["gateup_proj"] = {
        "kernel": torch.cat([ly["gate_proj"]["kernel"], ly["up_proj"]["kernel"]], dim=-1)
    }
    for n in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        del new[n]
    out = dict(params)
    out["layers"] = new
    return out


def _cache_slots(cache: KVCache, write_pos: torch.Tensor, T: int):
    """Where ``_write_cache`` puts a step's T tokens: (batch index, slot,
    token index into the flattened (B * T) step) of each token that lands
    inside the cache. Positions past S_max drop, as in the reference."""
    B = write_pos.shape[0]
    dev = write_pos.device
    tpos = (write_pos.long()[:, None] + torch.arange(T, device=dev)[None]).flatten()
    sel = torch.nonzero(tpos < cache.max_len).squeeze(1)  # one host sync per forward
    return sel // T, tpos[sel], sel


def _write_cache(cache: KVCache, l: int, k, v, slots) -> None:
    """cache[l, b, write_pos[b] + t] = k/v[b, t] at the ``_cache_slots``."""
    bidx, tpos, sel = slots
    cache.k[l, bidx, tpos] = k.flatten(0, 1)[sel].to(cache.k.dtype)
    cache.v[l, bidx, tpos] = v.flatten(0, 1)[sel].to(cache.v.dtype)


def decoder_forward(
    params: Params,
    cfg: DecoderConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,  # (B, T)
    inputs_embeds: Optional[torch.Tensor] = None,  # (B, T, D)
    positions: torch.Tensor,  # (B, T) absolute positions
    kv_valid_len: torch.Tensor,  # (B,) valid key count incl. the current tokens
    cache: Optional[KVCache] = None,
    write_pos: Optional[torch.Tensor] = None,  # (B,) cache write offset
    return_hidden: bool = False,
    prefill_kernel: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (logits (B, T, V) fp32, cache), or with ``return_hidden`` the
    final hidden states (B, T, D). With a cache the current k/v are written
    at ``write_pos`` first and attention runs over the whole cache; without
    one it is causal self-attention over the T inputs.

    ``prefill_kernel`` runs attention of multi-token steps into a cache
    through the ``fused_attention`` kernel (causal, valid-length and
    absolute-position masks from scalars) when the config has no sliding
    window; other steps use ``mha`` with an additive bias."""
    check_supported(cfg)
    x = embed_lookup(params, input_ids) if inputs_embeds is None else inputs_embeds
    B, T, _ = x.shape
    dev = x.device
    kv_len = cache.max_len if cache is not None else T
    use_prefill_kernel = (
        prefill_kernel and cache is not None and T > 1 and cfg.sliding_window is None
    )
    if not use_prefill_kernel:
        bias_global, bias_local = make_attention_bias(cfg, positions, kv_len, kv_valid_len)
    local = is_local_layer(cfg)
    inv_freq = torch.as_tensor(
        rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling), device=dev
    )
    cos, sin = rope_cos_sin(positions, inv_freq)
    eps = cfg.rms_norm_eps
    layers = params["layers"]
    slots = _cache_slots(cache, write_pos, T) if cache is not None else None

    for l in range(cfg.num_layers):
        p = _layer(layers, l)
        h = rms_norm(x, p["input_ln"], eps)
        q, k, v = _qkv(cfg, h, p)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cache is not None:
            _write_cache(cache, l, k, v, slots)
            k, v = cache.k[l], cache.v[l]
        if use_prefill_kernel:
            attn = fused_attention(
                q, k, v, kv_valid_len, write_pos, causal=True, scale=cfg.attn_scale
            )
        else:
            bias = bias_local if (bias_local is not None and local[l]) else bias_global
            attn = mha(q, k, v, bias=bias, scale=cfg.attn_scale)
        x = x + proj_apply(attn.reshape(B, T, -1), p["o_proj"])
        h = rms_norm(x, p["post_attn_ln"], eps)
        x = x + _mlp(cfg, h, p)

    x = rms_norm(x, params["norm"], eps)
    if return_hidden:
        return x, cache
    return compute_logits(params, cfg, x), cache
