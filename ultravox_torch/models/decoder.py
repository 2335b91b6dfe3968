"""Decoder-only text LLM (llama / mistral / gemma-2/3 / qwen-2/3 families)
over a parameter dict.

Parameters keep the JAX package's layout (per-layer weights stacked on a
leading axis, kernels as (in, out)); the KV cache is (L, B, S_max, Hkv, Dh),
or a ``PagedKVCache`` pool of pages read through a (B, pages_per_seq) page
table. Unlike the JAX package's immutable arrays, the cache is updated in
place: ``decoder_forward`` writes the new k/v rows into the cache it is
given and returns that same object. Writes the JAX package drops with
``mode="drop"`` land in write-only storage instead (see ``KVCache.spare``
and ``PagedKVCache``).

Family differences are config flags, as in the JAX package: gemma's
plus-one RMSNorm, embedding scaling, post-attention/FFN norms, qk-norm,
alternating local (sliding-window) / global layers with their own rope
bases, attention and final logit softcaps; qwen-2's attention bias and
qwen-3's qk-norm.

``segmented_decode_scan`` is the one-call decode loop: a read-only prompt
cache plus a small carried tail of the new tokens' k/v.
``segmented_spec_scan`` is its speculative form: rounds of K drafted tokens
verified in one (K+1)-token forward against the same two segments.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ultravox_torch.models.config import DecoderConfig
from ultravox_torch.models.lora import int8_scale, proj_apply
from ultravox_torch.models.remat import remat as checkpoint_remat
from ultravox_torch.ops.attention import NEG_INF, mha
from ultravox_torch.ops.kernels.decode_attention import decode_attention
from ultravox_torch.ops.kernels.flash_attention import flash_attention
from ultravox_torch.ops.kernels.fused_attention import fused_attention
from ultravox_torch.ops.kernels.paged_attention import (
    gather_pages_plain,
    paged_decode_attention,
)
from ultravox_torch.ops.kernels.segment_attention import (
    paged_segment_tail_attention,
    segment_tail_attention,
)
from ultravox_torch.ops.norms import rms_norm
from ultravox_torch.ops.rope import apply_rope, rope_cos_sin, rope_frequencies
from ultravox_torch.parallel.sharding import gather_layer, gather_whole, split_of, to_tensor

Params = Dict[str, Any]


@dataclasses.dataclass
class KVCache:
    """Static-shape per-layer KV cache: k, v of (L, B, S_max + spare, Hkv, Dh).

    ``spare`` trailing positions of each row take the writes that the JAX
    package drops (``mode="drop"``, positions >= S_max): such a write lands
    there and no read ever sees it, so no write needs a host-side check. A
    cache without spare positions (``spare=0``) drops them by selecting the
    in-range writes, which reads a count back from the card."""

    k: torch.Tensor
    v: torch.Tensor
    spare: int = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[2] - self.spare

    def live(self, l: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Views of the S_max live positions: (L, B, S_max, Hkv, Dh), or
        layer ``l``'s (B, S_max, Hkv, Dh)."""
        S = self.max_len
        if l is None:
            return self.k[:, :, :S], self.v[:, :, :S]
        return self.k[l, :, :S], self.v[l, :, :S]

    @classmethod
    def zeros(cls, cfg: DecoderConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
              spare: int = 0, kv_heads: Optional[int] = None):
        """``kv_heads``: a tensor rank's local KV heads (default all)."""
        shape = (cfg.num_layers, batch, max_len + spare, kv_heads or cfg.num_kv_heads,
                 cfg.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            spare=spare,
        )


@dataclasses.dataclass
class PagedKVCache:
    """Paged per-layer KV cache: pools of ``num_pages`` pages of ``page_size``
    tokens, shared by every sequence through an external (B, pages_per_seq)
    int32 page table: entry i of row b is the pool page of logical block i
    of sequence b, and unallocated entries hold the sentinel ``num_pages``.

    ``k`` and ``v`` are (L, num_pages + 1, page_size, Hkv, Dh): the last
    page is write-only. Every write the JAX package drops (sentinel entries,
    positions past the table, inactive rows) lands in it; every read clamps
    page ids to ``num_pages - 1``, as the JAX package's gathers clip, so it
    is never read. ``pool()`` gives the (L, num_pages, ...) views."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1] - 1

    @property
    def max_len(self) -> int:
        # tokens resident if one sequence owned the whole pool
        return self.num_pages * self.page_size

    def pool(self) -> Tuple[torch.Tensor, torch.Tensor]:
        P = self.num_pages
        return self.k[:, :P], self.v[:, :P]

    @classmethod
    def zeros(cls, cfg: DecoderConfig, num_pages: int, page_size: int, dtype=torch.bfloat16,
              device=None, kv_heads: Optional[int] = None):
        """``kv_heads``: a tensor rank's local KV heads (default all)."""
        shape = (cfg.num_layers, num_pages + 1, page_size, kv_heads or cfg.num_kv_heads,
                 cfg.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


def paged_write_indices(
    page_table: torch.Tensor,  # (B, pages_per_seq) int32, sentinel-padded
    write_pos: torch.Tensor,  # (B,) first logical position to write
    T: int,
    page_size: int,
    num_pages: int,
):
    """(write_page, write_off), each (B, T) int64: pool page and in-page
    offset of the T new tokens. Out-of-range logical positions and positions
    in unallocated table entries go to the write-only page ``num_pages``."""
    pos = write_pos.long()[:, None] + torch.arange(T, device=write_pos.device)[None]
    return paged_positions_to_indices(page_table, pos, page_size, num_pages)


def paged_positions_to_indices(
    page_table: torch.Tensor,  # (B, pages_per_seq) int32, sentinel-padded
    pos: torch.Tensor,  # (B, T) logical positions; negative = drop
    page_size: int,
    num_pages: int,
):
    """Arbitrary-position form of :func:`paged_write_indices`."""
    n_per = page_table.shape[1]
    pos = pos.long()
    blk = torch.div(pos, page_size, rounding_mode="floor")
    in_range = (pos >= 0) & (blk < n_per)
    pid = torch.gather(page_table.long(), 1, blk.clamp(0, n_per - 1))
    valid = in_range & (pid >= 0) & (pid < num_pages)
    return torch.where(valid, pid, num_pages), torch.remainder(pos, page_size)


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
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, Dh)
        layers["k_norm"] = ones(L, Dh)
    if cfg.use_post_norms:
        layers["pre_ffn_ln"] = ones(L, D)
        layers["post_ffn_ln"] = ones(L, D)
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
    """The (B, T, heads, Dh) q, k, v: a tensor rank's own heads under a
    split (the widths of its slices say how many)."""
    B, T, _ = h.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "qkv_proj" in p:
        qkv = proj_apply(h, p["qkv_proj"])
        q = qkv[..., : Hq * Dh]
        k = qkv[..., Hq * Dh : (Hq + Hkv) * Dh]
        v = qkv[..., (Hq + Hkv) * Dh :]
    else:
        q, k, v = (proj_apply(h, p[n]) for n in ("q_proj", "k_proj", "v_proj"))
    return q.reshape(B, T, -1, Dh), k.reshape(B, T, -1, Dh), v.reshape(B, T, -1, Dh)


def _split(p: Params, name: str):
    """The tensor split of projection ``name``'s kernel, None unsplit."""
    return split_of(p[name].get("kernel")) if name in p else None


def _mlp(cfg: DecoderConfig, h: torch.Tensor, p: Params) -> torch.Tensor:
    h = to_tensor(h, _split(p, "gate_proj"))
    if "gateup_proj" in p:
        gate, up = proj_apply(h, p["gateup_proj"]).chunk(2, dim=-1)
    else:
        gate, up = proj_apply(h, p["gate_proj"]), proj_apply(h, p["up_proj"])
    return proj_apply(_act(cfg, gate) * up, p["down_proj"])


def _layer(layers: Params, l: int) -> Params:
    """Layer l's parameters, each fsdp-sharded leaf gathered whole."""
    return {k: _layer(v, l) if isinstance(v, dict) else gather_layer(v, l)
            for k, v in layers.items()}


def _plus_one(cfg: DecoderConfig) -> bool:
    """Gemma's ``(1 + w)`` RMSNorm convention."""
    return cfg.arch in ("gemma2", "gemma3")


def _scale_embeddings(cfg: DecoderConfig, x: torch.Tensor) -> torch.Tensor:
    """Gemma's embedding scaling by sqrt(hidden), the factor in x's dtype."""
    if not cfg.scale_embeddings:
        return x
    return x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freqs(cfg: DecoderConfig, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rope inverse frequencies of the global and the local layers (the same
    tensor when the config has no local rope base). Made once per config and
    device: a copy from host memory waits for the card's queue to drain, so
    it must not run on every step."""
    with torch.inference_mode(False):
        inv_g = torch.as_tensor(
            rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling), device=device)
        if cfg.rope_local_base_freq is None:
            return inv_g, inv_g
        return inv_g, torch.as_tensor(
            rope_frequencies(cfg.head_dim, cfg.rope_local_base_freq), device=device)


def _window(cfg: DecoderConfig, is_local: bool) -> int:
    """A layer's sliding window as the kernels take it: 0 means none."""
    return cfg.sliding_window if (is_local and cfg.sliding_window is not None) else 0


def _layer_forward(
    cfg: DecoderConfig,
    x: torch.Tensor,  # (B, T, D)
    p: Params,  # one layer's parameters
    cos: torch.Tensor,
    sin: torch.Tensor,
    attend: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """One decoder layer. ``attend(q, k, v)`` takes the roped (B, T, H|Hkv,
    Dh) heads, stores k/v wherever its caller keeps them and returns the
    attention output (B, T, H, Dh). Under a tensor split the heads are the
    rank's own, the normed input enters them through ``to_tensor`` and
    ``o_proj`` / ``down_proj`` all-reduce (``proj_apply``), inside this
    function, so a recompute under remat issues them again in order."""
    B, T, _ = x.shape
    eps, plus_one = cfg.rms_norm_eps, _plus_one(cfg)
    sp = _split(p, "q_proj")
    h = to_tensor(rms_norm(x, p["input_ln"], eps, plus_one=plus_one), sp)
    q, k, v = _qkv(cfg, h, p)
    if cfg.qk_norm:  # per head, on the rank's own heads
        q = rms_norm(q, to_tensor(p["q_norm"], sp), eps, plus_one=plus_one)
        k = rms_norm(k, to_tensor(p["k_norm"], sp), eps, plus_one=plus_one)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = proj_apply(attend(q, k, v).reshape(B, T, -1), p["o_proj"])
    if cfg.use_post_norms:
        x = x + rms_norm(attn, p["post_attn_ln"], eps, plus_one=plus_one)
        h = rms_norm(x, p["pre_ffn_ln"], eps, plus_one=plus_one)
    else:
        x = x + attn
        h = rms_norm(x, p["post_attn_ln"], eps, plus_one=plus_one)
    mlp = _mlp(cfg, h, p)
    if cfg.use_post_norms:
        mlp = rms_norm(mlp, p["post_ffn_ln"], eps, plus_one=plus_one)
    return x + mlp


def _gathered_layer_forward(cfg, x, layers, l, cos, sin, attend):
    """``_layer_forward`` on layer l, gathered inside: under remat only
    the shards are kept for the backward, which gathers again."""
    return _layer_forward(cfg, x, _layer(layers, l), cos, sin, attend)


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
    """Token-embedding rows, dequantized (in the scales' dtype) from int8
    storage when the tree has it."""
    ids = ids.long()
    if "embed_tokens_q" in params:
        scales = params["embed_scale"][ids]
        return params["embed_tokens_q"][ids].to(scales.dtype) * scales[..., None]
    return gather_whole(params["embed_tokens"])[ids]


def gathered_head(params: Params, cfg: DecoderConfig) -> Params:
    """``params`` with the leaf ``compute_logits`` reads gathered whole
    once (over fsdp and ``tensor``), for a caller that projects chunk after
    chunk: the processes of an fsdp group then gather the same number of
    times, whatever their chunk counts."""
    head = params.get("lm_head")
    if head is not None and (not cfg.tie_word_embeddings or "kernel_q" in head):
        if "kernel" not in head:
            return params
        return dict(params, lm_head=dict(head, kernel=gather_whole(head["kernel"])))
    if "embed_tokens" not in params:
        return params
    return dict(params, embed_tokens=gather_whole(params["embed_tokens"]))


def compute_logits(params: Params, cfg: DecoderConfig, hidden: torch.Tensor) -> torch.Tensor:
    """LM head: hidden (..., D) -> fp32 logits (..., V), with gemma's final
    softcap. The product runs in the weights' dtype and is then widened, as
    in the reference. A tied model uses the embedding, except an int8 tree,
    which carries a pretransposed int8 head (``quantize_decoder_int8``)."""
    head = params.get("lm_head")
    use_head = head is not None and (not cfg.tie_word_embeddings or "kernel_q" in head)
    if not use_head:
        if "embed_tokens_q" in params:
            logits = proj_apply(hidden, {
                "kernel_q": params["embed_tokens_q"].T, "scale": params["embed_scale"][None],
            }).float()
        else:
            logits = (hidden @ gather_whole(params["embed_tokens"]).T).float()
    elif "kernel_q" in head:
        logits = proj_apply(hidden, head).float()
    else:
        logits = (hidden @ gather_whole(head["kernel"])).float()
    if cfg.final_logit_softcapping:
        cap = cfg.final_logit_softcapping
        logits = torch.tanh(logits / cap) * cap
    return logits


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


def _quantize_kernel(kernel: torch.Tensor, axis: int = -2):
    """Per-output-channel symmetric int8 over the contraction axis: (int8
    values, bf16 scales with the axis kept)."""
    k32 = kernel.float()
    scale = int8_scale(k32.abs().amax(dim=axis, keepdim=True).clamp(min=1e-8))
    q = torch.round(k32 / scale).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _quantize_embedding(emb: torch.Tensor):
    """Per-row symmetric int8 for the token embedding: (int8 (V, D), bf16
    scales (V,))."""
    q, scale = _quantize_kernel(emb, axis=-1)
    return q, scale[..., 0]


def quantize_decoder_int8(params: Params) -> Params:
    """Weight-only int8 for the decoder: projection kernels, the token
    embedding and the LM head become int8 with bf16 per-channel scales; LoRA
    leaves ride on top of the int8 base. A tied model gets a materialised
    (D, V) int8 head (``compute_logits`` prefers it)."""
    out = dict(params)
    layers = {}
    for name, leaf in params["layers"].items():
        if isinstance(leaf, dict) and "kernel" in leaf:
            q, scale = _quantize_kernel(leaf["kernel"])
            new = {"kernel_q": q, "scale": scale}
            for k in ("bias", "lora_a", "lora_b", "lora_scale"):
                if k in leaf:
                    new[k] = leaf[k]
            layers[name] = new
        else:
            layers[name] = leaf
    out["layers"] = layers
    out["embed_tokens_q"], out["embed_scale"] = _quantize_embedding(params["embed_tokens"])
    del out["embed_tokens"]
    if "lm_head" in params:
        q, scale = _quantize_kernel(params["lm_head"]["kernel"])
        out["lm_head"] = {"kernel_q": q, "scale": scale}
    else:
        out["lm_head"] = {
            "kernel_q": out["embed_tokens_q"].T.contiguous(),
            "scale": out["embed_scale"][None],
        }
    return out


def _cache_slots(cache: KVCache, write_pos: torch.Tensor, T: int):
    """Where ``_write_cache`` puts a step's T tokens: (batch index, slot,
    token index into the flattened (B * T) step). Positions past S_max drop,
    as in the reference: into the spare positions when the cache has them,
    else by selecting the in-range tokens (one host sync per forward)."""
    B = write_pos.shape[0]
    dev = write_pos.device
    tpos = (write_pos.long()[:, None] + torch.arange(T, device=dev)[None]).flatten()
    if cache.spare:
        flat = torch.arange(B * T, device=dev)
        return flat // T, tpos.clamp(max=cache.k.shape[2] - 1), flat
    sel = torch.nonzero(tpos < cache.max_len).squeeze(1)
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
    cache: Optional[KVCache | PagedKVCache] = None,
    page_table: Optional[torch.Tensor] = None,  # (B, pages_per_seq), with a PagedKVCache
    write_pos: Optional[torch.Tensor] = None,  # (B,) cache write offset
    remat: bool = False,
    return_hidden: bool = False,
    decode_kernel: bool = False,
    prefill_kernel: bool = False,
    attn_impl: str = "xla",  # "flash" = the differentiable kernel (cache-less)
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (logits (B, T, V) fp32, cache), or with ``return_hidden`` the
    final hidden states (B, T, D). With a cache the current k/v are written
    at ``write_pos`` first and attention runs over the whole cache; without
    one it is causal self-attention over the T inputs.

    ``decode_kernel`` runs T=1 steps into a cache through the
    ``decode_attention`` kernel, or the ``paged_decode_attention`` kernel for
    a PagedKVCache (valid length and each layer's window from scalars).
    ``prefill_kernel`` runs multi-token steps into a contiguous cache through
    the ``fused_attention`` kernel (causal, valid-length and absolute-position
    masks) when the config has no sliding window. Neither kernel softcaps, so
    both are taken only without an attention softcap; other steps use
    ``mha`` with an additive bias, over the gathered (pages_per_seq *
    page_size) view of each row's pages for a PagedKVCache.

    ``attn_impl="flash"`` runs the cache-less forward (T > 1, no attention
    softcap) through the differentiable ``flash_attention`` kernel: causal,
    ``kv_valid_len`` as the key lengths and each layer's window, with the
    query row index as the absolute position. Gemma-2's softcap keeps
    ``mha``. ``remat`` checkpoints each layer of the cache-less forward: its
    activations are recomputed in the backward."""
    if attn_impl not in ("xla", "flash"):
        raise ValueError(f"unknown attn_impl={attn_impl!r}")
    x = embed_lookup(params, input_ids) if inputs_embeds is None else inputs_embeds
    x = _scale_embeddings(cfg, x)
    B, T, _ = x.shape
    paged = isinstance(cache, PagedKVCache)
    if paged:
        if page_table is None:
            raise ValueError("a PagedKVCache needs a page_table")
        kv_len = page_table.shape[1] * cache.page_size
        write_page, write_off = paged_write_indices(
            page_table, write_pos, T, cache.page_size, cache.num_pages
        )
    else:
        kv_len = cache.max_len if cache is not None else T
    no_softcap = cfg.attn_logit_softcapping is None
    use_decode_kernel = decode_kernel and cache is not None and T == 1 and no_softcap
    use_prefill_kernel = (
        prefill_kernel and cache is not None and not paged and T > 1
        and cfg.sliding_window is None and no_softcap
    )
    # the kernel runs at any T (it loops over key tiles), so unlike the JAX
    # package's VMEM fit test only the conditions that change the function
    # gate it
    use_flash = attn_impl == "flash" and cache is None and T > 1 and no_softcap
    if use_decode_kernel or use_flash:
        lengths = kv_valid_len.to(torch.int32).contiguous()
    elif not use_prefill_kernel:
        bias_global, bias_local = make_attention_bias(cfg, positions, kv_len, kv_valid_len)
    local = is_local_layer(cfg)
    inv_g, inv_l = _inv_freqs(cfg, x.device)
    rope_g = rope_cos_sin(positions, inv_g)
    rope_l = rope_cos_sin(positions, inv_l) if inv_l is not inv_g else rope_g
    layers = params["layers"]
    slots = _cache_slots(cache, write_pos, T) if cache is not None and not paged else None

    for l in range(cfg.num_layers):

        def attend(q, k, v, l=l):  # l bound now: remat calls it again in the backward
            if paged:
                cache.k[l, write_page, write_off] = k.to(cache.k.dtype)
                cache.v[l, write_page, write_off] = v.to(cache.v.dtype)
                P = cache.num_pages
                pool_k, pool_v = cache.k[l, :P], cache.v[l, :P]
                if use_decode_kernel:
                    return paged_decode_attention(
                        q[:, 0], pool_k, pool_v, page_table, lengths, _window(cfg, local[l]),
                        scale=cfg.attn_scale,
                    )[:, None]
                k, v = gather_pages_plain(pool_k, page_table), gather_pages_plain(pool_v, page_table)
            elif cache is not None:
                _write_cache(cache, l, k, v, slots)
                k, v = cache.live(l)
            if use_decode_kernel:
                return decode_attention(
                    q[:, 0], k, v, lengths, _window(cfg, local[l]), scale=cfg.attn_scale
                )[:, None]
            if use_prefill_kernel:
                return fused_attention(
                    q, k, v, kv_valid_len, write_pos, causal=True, scale=cfg.attn_scale
                )
            if use_flash:
                return flash_attention(
                    q, k, v, lengths, causal=True, window=_window(cfg, local[l]),
                    scale=cfg.attn_scale,
                )
            bias = bias_local if (bias_local is not None and local[l]) else bias_global
            return mha(q, k, v, bias=bias, scale=cfg.attn_scale, softcap=cfg.attn_logit_softcapping)

        args = (cfg, x, layers, l, *(rope_l if local[l] else rope_g), attend)
        if remat and cache is None:
            x = checkpoint_remat(_gathered_layer_forward, *args)
        else:
            x = _gathered_layer_forward(*args)

    x = rms_norm(x, params["norm"], cfg.rms_norm_eps, plus_one=_plus_one(cfg))
    if return_hidden:
        return x, cache
    return compute_logits(params, cfg, x), cache


# --------------------------------------------------------------------------
# Segmented decode (read-only prompt cache + small carried tail)
# --------------------------------------------------------------------------


def _merged_attention(q, kp, vp, bias_p, kt, vt, bias_t, scale, softcap=None):
    """Attention over two KV segments without concatenating them: the
    (large, read-only) prompt cache ``kp/vp`` and the (small) decode tail
    ``kt/vt``. Their fp32 logits are softmaxed jointly, the probabilities
    rounded to v's dtype, and the two PV products summed.
    q (B, T, H, D); kp (B, S, Hkv, D); kt (B, Ts, Hkv, D); bias_*
    broadcastable to (B, 1, S*). Returns (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    Hkv = kp.shape[2]
    qf = (q * scale).reshape(B, T, Hkv, H // Hkv, D).float()
    lp = torch.einsum("bthgd,bshd->bhgts", qf, kp.float())
    lt = torch.einsum("bthgd,bshd->bhgts", qf, kt.float())
    if softcap is not None:  # gemma-2: softcap before masking
        lp = torch.tanh(lp / softcap) * softcap
        lt = torch.tanh(lt / softcap) * softcap
    lp = lp + bias_p[:, None, None].float()
    lt = lt + bias_t[:, None, None].float()
    probs = torch.softmax(torch.cat([lp, lt], dim=-1), dim=-1)
    S = kp.shape[1]
    pp = probs[..., :S].to(vp.dtype).float()
    pt = probs[..., S:].to(vt.dtype).float()
    out = torch.einsum("bhgts,bshd->bthgd", pp, vp.float()) + torch.einsum(
        "bhgts,bshd->bthgd", pt, vt.float()
    )
    return out.reshape(B, T, H, D).to(q.dtype)


def _segment_kernel_attention(
    cfg: DecoderConfig, q, prompt_cache, page_table, layer: int, prompt_lens, tail_k_l,
    tail_v_l, written, is_local: bool,
):
    """One layer's segmented attention through the ``segment_tail_attention``
    kernel, which reads the stacked cache at ``layer`` in place (no per-layer
    slice is made), or with a page table through
    ``paged_segment_tail_attention``, which reads the stacked pool's pages.
    q is (B, T, H, D)."""
    window = _window(cfg, is_local)
    if page_table is not None:
        pool_k, pool_v = prompt_cache.pool()
        return paged_segment_tail_attention(
            q, pool_k, pool_v, layer, page_table, prompt_lens, tail_k_l, tail_v_l, written,
            window, scale=cfg.attn_scale,
        )
    k, v = prompt_cache.live()
    return segment_tail_attention(
        q, k, v, layer, prompt_lens, tail_k_l, tail_v_l, written, window, scale=cfg.attn_scale,
    )


def segmented_decode_scan(
    params: Params,
    cfg: DecoderConfig,
    prompt_cache,  # KVCache (L, B, S, Hkv, Dh), read-only here, or with
    # ``page_table`` a PagedKVCache pool read by the kernel
    prompt_lens: torch.Tensor,  # (B,) valid prompt positions in the cache
    first_tokens: torch.Tensor,  # (B,) int32, already sampled
    *,
    n_steps: int,
    sample_fn: Callable[[torch.Tensor], torch.Tensor],  # logits (B, V) -> (B,) int32
    return_tail: bool = False,
    attn_impl: str = "xla",  # "kernel" = the segment_tail_attention kernel
    page_table: Optional[torch.Tensor] = None,  # kernel-only paged mode
):
    """``n_steps`` decode steps with segmented KV. The prompt cache is only
    read; each step's new k/v go to slot ``step`` of an (L, B, n_steps, Hkv,
    Dh) tail, the same slot for every row. Sampling stays on the device (the
    caller's ``sample_fn`` draws from its own generator, one call per step)
    and the loop never synchronises with the host.

    ``attn_impl="xla"`` attends with ``_merged_attention`` (additive masks,
    probabilities rounded to v's dtype); ``"kernel"`` runs each layer's
    attention in ``segment_tail_attention``, which does not softcap, or with
    ``page_table`` in ``paged_segment_tail_attention``, which reads each
    row's live pool pages (the XLA form takes a gathered contiguous view
    instead, so a page table with ``attn_impl="xla"`` raises ValueError).

    Returns the (B, n_steps + 1) token matrix: column 0 is ``first_tokens``,
    then the sampled tokens. With ``return_tail`` also the tail KVCache,
    whose slot t holds the k/v of token column t."""
    if attn_impl not in ("xla", "kernel"):
        raise ValueError(f"unknown attn_impl={attn_impl!r}")
    use_kernel = attn_impl == "kernel"
    if use_kernel and cfg.attn_logit_softcapping is not None:
        raise ValueError("the segment kernel does not softcap; use attn_impl='xla'")
    if page_table is not None:
        if not use_kernel:
            raise ValueError(
                "the paged segmented scan needs attn_impl='kernel'; the XLA form takes a "
                "gathered contiguous view"
            )
        L, _, _, Hkv, Dh = prompt_cache.k.shape
        B = first_tokens.shape[0]
        S = page_table.shape[1] * prompt_cache.page_size
    else:
        L, B, _, Hkv, Dh = prompt_cache.k.shape
        S = prompt_cache.max_len
    dev = prompt_cache.k.device
    local = is_local_layer(cfg)
    inv_g, inv_l = _inv_freqs(cfg, dev)
    layers = params["layers"]
    tail = KVCache(
        k=torch.zeros((L, B, n_steps, Hkv, Dh), dtype=prompt_cache.k.dtype, device=dev),
        v=torch.zeros((L, B, n_steps, Hkv, Dh), dtype=prompt_cache.v.dtype, device=dev),
    )
    toks = torch.empty((B, n_steps + 1), dtype=torch.int32, device=dev)
    toks[:, 0] = first_tokens
    lens = prompt_lens.to(device=dev, dtype=torch.int32).contiguous()
    steps = torch.arange(n_steps, dtype=torch.int32, device=dev)
    if use_kernel:
        written = steps[:, None].expand(n_steps, B).contiguous()  # row i: step i
    else:
        kpos = torch.arange(S, device=dev)[None]  # (1, S)
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        def bias(ok):
            return torch.where(ok, zero, NEG_INF)[:, None]

    for i in range(n_steps):
        x = _scale_embeddings(cfg, embed_lookup(params, toks[:, i])[:, None])  # (B, 1, D)
        positions = (lens + i)[:, None]
        rope_g = rope_cos_sin(positions, inv_g)
        rope_l = rope_cos_sin(positions, inv_l) if inv_l is not inv_g else rope_g
        if not use_kernel:
            # prompt key j visible iff j < prompt_len; tail slot t iff t <= i
            ok_p = kpos < lens[:, None]
            ok_t = steps[None] <= i
            biases = {False: (bias(ok_p), bias(ok_t))}
            if cfg.sliding_window is not None:
                w = cfg.sliding_window
                biases[True] = (
                    bias(ok_p & (lens[:, None] + i - kpos < w)), bias(ok_t & (i - steps[None] < w))
                )

        for l in range(L):
            is_loc = bool(local[l])

            def attend(q, k, v):
                tail.k[l, :, i] = k[:, 0]
                tail.v[l, :, i] = v[:, 0]
                if use_kernel:
                    return _segment_kernel_attention(
                        cfg, q, prompt_cache, page_table, l, lens, tail.k[l], tail.v[l],
                        written[i], is_loc,
                    )
                b_p, b_t = biases[is_loc and cfg.sliding_window is not None]
                kp, vp = prompt_cache.live(l)
                return _merged_attention(
                    q, kp, vp, b_p, tail.k[l], tail.v[l], b_t,
                    cfg.attn_scale, softcap=cfg.attn_logit_softcapping,
                )

            x = _layer_forward(cfg, x, _layer(layers, l), *(rope_l if is_loc else rope_g), attend)

        x = rms_norm(x, params["norm"], cfg.rms_norm_eps, plus_one=_plus_one(cfg))
        toks[:, i + 1] = sample_fn(compute_logits(params, cfg, x[:, 0]))
    if return_tail:
        return toks, tail
    return toks


def append_accepted(hist: torch.Tensor, hist_len: torch.Tensor, out: torch.Tensor,
                    accepted: torch.Tensor) -> None:
    """hist[b, hist_len[b] + i] = out[b, i] for i < accepted[b], in place.
    Positions past the history are dropped, as the JAX package's
    ``mode="drop"`` scatter drops them; a select over the (B, S) history,
    so no write needs a spare column or a host-side check."""
    S, T = hist.shape[1], out.shape[1]
    rel = torch.arange(S, device=hist.device)[None] - hist_len.long()[:, None]  # (B, S)
    sel = (rel >= 0) & (rel < accepted.long()[:, None])
    vals = out.to(hist.dtype).gather(1, rel.clamp(0, T - 1))
    hist.copy_(torch.where(sel, vals, hist))


def segmented_spec_scan(
    params: Params,
    cfg: DecoderConfig,
    prompt_cache,  # KVCache (L, B, S, Hkv, Dh), read-only here, or with
    # ``page_table`` a PagedKVCache pool read by the kernel
    prompt_lens: torch.Tensor,  # (B,) valid positions in the cache
    first_tokens: torch.Tensor,  # (B,) int32, pending (sampled, not written)
    hist: torch.Tensor,  # (B, S_hist) int32 token history (prompt + sampled), updated in place
    draft_fn: Callable,  # (hist, hist_len (B,)) -> (B, K) int32 drafts
    accept_fn: Callable,  # (logits (B, T, V), drafts, positions (B,)) ->
    #   (out (B, T) int32 emitted tokens, accepted (B,) in [1, T])
    *,
    n_rounds: int,
    K: int,
    attn_impl: str = "xla",  # "kernel" = the segment_tail_attention kernel
    page_table: Optional[torch.Tensor] = None,  # kernel-only paged mode
):
    """``n_rounds`` speculative draft + verify rounds in one call. Each round
    drafts K tokens from the carried history (``draft_fn``), verifies
    ``[pending, draft_0 .. draft_{K-1}]`` in one (K+1)-token forward against
    the read-only prompt cache plus a carried KV tail, and emits the tokens
    ``accept_fn`` keeps. A row's tail holds its accepted tokens' k/v
    contiguously: a round writes its K+1 tokens at ``written + i`` and the
    next round overwrites the rejected ones.

    ``attn_impl="xla"`` attends with ``_merged_attention``; ``"kernel"``
    runs each layer's attention in ``segment_tail_attention`` with q of
    (B, K+1, H, D), or with ``page_table`` in
    ``paged_segment_tail_attention`` (the XLA form takes a gathered view, so
    a page table with ``attn_impl="xla"`` raises ValueError). Sliding-window
    layers mask by absolute distance in both forms.

    Returns ``(outs (n_rounds, B, K+1), accepts (n_rounds, B), tail
    KVCache (L, B, n_rounds * (K+1), Hkv, Dh), written (B,), last (B,),
    hist)``: round r of row b emitted ``outs[r, b, :accepts[r, b]]``; tail
    slots [0, written[b]) hold row b's accepted tokens' k/v; ``last`` is
    each row's new pending token; ``hist`` (the argument, updated) carries
    the accepted tokens appended."""
    if attn_impl not in ("xla", "kernel"):
        raise ValueError(f"unknown attn_impl={attn_impl!r}")
    use_kernel = attn_impl == "kernel"
    if use_kernel and cfg.attn_logit_softcapping is not None:
        raise ValueError("the segment kernel does not softcap; use attn_impl='xla'")
    if page_table is not None:
        if not use_kernel:
            raise ValueError("the paged segmented spec scan needs attn_impl='kernel'")
        L, _, _, Hkv, Dh = prompt_cache.k.shape
        B = first_tokens.shape[0]
        S = page_table.shape[1] * prompt_cache.page_size
    else:
        L, B, _, Hkv, Dh = prompt_cache.k.shape
        S = prompt_cache.max_len
    T = K + 1
    Ts = n_rounds * T
    dev = prompt_cache.k.device
    local = is_local_layer(cfg)
    inv_g, inv_l = _inv_freqs(cfg, dev)
    layers = params["layers"]
    bidx = torch.arange(B, device=dev)[:, None]
    seg_i = torch.arange(T, dtype=torch.int32, device=dev)  # in-segment query index
    tail = KVCache(
        k=torch.zeros((L, B, Ts, Hkv, Dh), dtype=prompt_cache.k.dtype, device=dev),
        v=torch.zeros((L, B, Ts, Hkv, Dh), dtype=prompt_cache.v.dtype, device=dev),
    )
    lens = prompt_lens.to(device=dev, dtype=torch.int32).contiguous()
    written = torch.zeros((B,), dtype=torch.int32, device=dev)
    tok = first_tokens.to(torch.int32)
    window = cfg.sliding_window
    if not use_kernel:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        kpos = torch.arange(S, device=dev)[None]  # (1, S)
        tail_t = torch.arange(Ts, device=dev)  # tail key slot
        # every query sits after the prompt: the prompt mask is the same
        # for all of them
        ok_p = kpos < lens[:, None]  # (B, S)
        bias_p = torch.where(ok_p, zero, NEG_INF)[:, None]  # (B, 1, S)
    outs, accepts = [], []
    for _ in range(n_rounds):
        hl = lens + written + 1  # known tokens, the pending one included
        drafts = draft_fn(hist, hl)  # (B, K)
        seg = torch.cat([tok[:, None], drafts.to(torch.int32)], dim=1)  # (B, T)
        x = _scale_embeddings(cfg, embed_lookup(params, seg))
        positions = (lens + written)[:, None] + seg_i[None]  # (B, T)
        rope_g = rope_cos_sin(positions, inv_g)
        rope_l = rope_cos_sin(positions, inv_l) if inv_l is not inv_g else rope_g
        tpos_w = (written[:, None] + seg_i[None]).long()  # (B, T), in bounds
        if not use_kernel:
            # tail slot t visible to query i iff t <= written + i: the
            # accepted tokens and in-segment causality; slots past it hold
            # rejected drafts
            q_slot = (written[:, None] + seg_i[None])[:, :, None]  # (B, T, 1)
            ok_t = tail_t[None, None] <= q_slot  # (B, T, Ts)
            biases = {False: (bias_p, torch.where(ok_t, zero, NEG_INF))}
            if window is not None:
                d_p = positions[:, :, None] - kpos[:, None]  # (B, T, S)
                biases[True] = (
                    torch.where(ok_p[:, None] & (d_p < window), zero, NEG_INF),
                    torch.where(ok_t & (q_slot - tail_t < window), zero, NEG_INF),
                )

        for l in range(L):
            is_loc = bool(local[l])

            def attend(q, k, v):
                tail.k[l, bidx, tpos_w] = k.to(tail.k.dtype)
                tail.v[l, bidx, tpos_w] = v.to(tail.v.dtype)
                if use_kernel:
                    return _segment_kernel_attention(
                        cfg, q, prompt_cache, page_table, l, lens, tail.k[l], tail.v[l],
                        written, is_loc,
                    )
                b_p, b_t = biases[is_loc and window is not None]
                kp, vp = prompt_cache.live(l)
                return _merged_attention(
                    q, kp, vp, b_p, tail.k[l], tail.v[l], b_t, cfg.attn_scale,
                    softcap=cfg.attn_logit_softcapping,
                )

            x = _layer_forward(cfg, x, _layer(layers, l), *(rope_l if is_loc else rope_g), attend)

        x = rms_norm(x, params["norm"], cfg.rms_norm_eps, plus_one=_plus_one(cfg))
        out, acc = accept_fn(compute_logits(params, cfg, x), drafts, hl)
        acc = acc.to(torch.int32)
        append_accepted(hist, hl, out, acc)
        tok = out.gather(1, (acc - 1).long()[:, None])[:, 0].to(torch.int32)
        written = (written + acc).contiguous()
        outs.append(out)
        accepts.append(acc)
    return torch.stack(outs), torch.stack(accepts), tail, written, tok, hist
