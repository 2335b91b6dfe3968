"""Whisper-style audio encoder over a parameter dict.

Parameters keep the JAX package's layout: per-layer weights stacked on a
leading axis (``layers/<name>`` of shape (L, ...)), linear kernels as
(in, out), conv kernels as (K, C_in, C_out). Three paths:

- ``attn_impl="xla"``: the plain path (exact-erf GELU, additive-bias masks,
  ``mha``), the differentiable reference;
- ``attn_impl="flash"``: the training path, the plain path with attention
  in the differentiable ``flash_attention`` kernel (length and latency
  masks from scalars, no bias tensor); q/k/v stay unfused, so LoRA trees
  run here;
- ``attn_impl="fused"``: the forward-only inference path. With a fused
  ``qkv_proj`` tree (``fuse_encoder_inference_params``) every layer runs
  ``ln_qkv_head_fused`` -> ``attention_headmajor`` -> out-projection read
  from the head-major output, and the FFN LayerNorm is ``fused_layer_norm``;
  GELU is the tanh form throughout, as in the reference's fused path. The
  reference pads T to a multiple of 128 for the TPU's tiling; the CUDA
  kernels mask ragged tiles themselves, so the port runs at T unpadded.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ultravox_torch.models.config import WhisperEncoderConfig
from ultravox_torch.models.lora import proj_apply
from ultravox_torch.models.remat import remat as checkpoint_remat
from ultravox_torch.ops.attention import block_causal_bias, length_mask_bias, mha
from ultravox_torch.ops.kernels.flash_attention import flash_attention
from ultravox_torch.ops.kernels.fused_attention import (
    attention_headmajor,
    fused_attention,
    ln_qkv_head_fused,
)
from ultravox_torch.ops.kernels.layer_norm import fused_layer_norm
from ultravox_torch.ops.norms import layer_norm

Params = Dict[str, Any]


def feat_extract_output_length(mel_len):
    """Mel frames -> encoder positions (conv2 stride 2): (n - 1) // 2 + 1."""
    return (mel_len - 1) // 2 + 1


def init_params(
    cfg: WhisperEncoderConfig, generator: torch.Generator, dtype=torch.float32, device=None
) -> Params:
    """Seeded random init in the JAX package's tree layout."""
    d, f, L = cfg.d_model, cfg.ffn_dim, cfg.num_layers

    def dn(*shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ln():
        return {"scale": torch.ones((L, d), dtype=dtype, device=device), "bias": zeros(L, d)}

    return {
        "conv1": {"kernel": dn(3, cfg.num_mel_bins, d), "bias": zeros(d)},
        "conv2": {"kernel": dn(3, d, d), "bias": zeros(d)},
        "embed_positions": dn(cfg.max_source_positions, d),
        "layers": {
            "attn_ln": ln(),
            "q_proj": {"kernel": dn(L, d, d), "bias": zeros(L, d)},
            "k_proj": {"kernel": dn(L, d, d)},
            "v_proj": {"kernel": dn(L, d, d), "bias": zeros(L, d)},
            "out_proj": {"kernel": dn(L, d, d), "bias": zeros(L, d)},
            "final_ln": ln(),
            "fc1": {"kernel": dn(L, d, f), "bias": zeros(L, f)},
            "fc2": {"kernel": dn(L, f, d), "bias": zeros(L, d)},
        },
        "layer_norm": {"scale": torch.ones(d, dtype=dtype, device=device), "bias": zeros(d)},
    }


def _conv1d(x, kernel, bias, stride: int, transpose_out: bool = False):
    """x (B, C_in, T); kernel (K, C_in, C_out); padding 1. The product runs in
    fp32 and the bias is added in fp32 before the cast back to x's dtype."""
    w = kernel.permute(2, 1, 0).float()  # (C_out, C_in, K)
    out = F.conv1d(x.to(kernel.dtype).float(), w, stride=stride, padding=1)
    out = (out + bias.float()[None, :, None]).to(x.dtype)
    return out.transpose(1, 2) if transpose_out else out


def _layer(layers: Params, l: int) -> Params:
    return {k: _layer(v, l) if isinstance(v, dict) else v[l] for k, v in layers.items()}


def _encoder_layer(cfg, x, bias, p, *, attn_fn=None, attn_qkv_fn=None, ln_fn=None, approx_gelu=False):
    """One pre-norm transformer layer on x (B, T, D)."""
    B, T, D = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    ln = ln_fn or layer_norm
    if "qkv_proj" in p and attn_qkv_fn is not None:
        qp = p["qkv_proj"]
        if "kernel" not in qp:
            raise NotImplementedError("int8 encoder trees are not ported yet")
        if "lora_a" in qp:
            raise NotImplementedError("LoRA encoder trees are not ported yet")
        qb = qp.get("bias")
        if qb is None:
            qb = torch.zeros(qp["kernel"].shape[-1], dtype=x.dtype, device=x.device)
        qkv_t = ln_qkv_head_fused(
            x, p["attn_ln"]["scale"], p["attn_ln"]["bias"], qp["kernel"], qb, Dh
        )
        attn_t = attn_qkv_fn(qkv_t)  # (B, H, T, Dh)
        op = p["out_proj"]
        if "lora_a" in op or "kernel" not in op:
            raise NotImplementedError("only float out_proj trees are ported")
        out = torch.einsum("bhtd,hdm->btm", attn_t, op["kernel"].reshape(H, Dh, D))
        if "bias" in op:
            out = out + op["bias"]
        x = x + out
        return _encoder_ffn(x, p, ln, approx_gelu)
    h = ln(x, p["attn_ln"]["scale"], p["attn_ln"]["bias"])
    if "qkv_proj" in p:
        qkv = proj_apply(h, p["qkv_proj"]).reshape(B, T, 3, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = (proj_apply(h, p[n]) for n in ("q_proj", "k_proj", "v_proj"))
    q, k, v = (t.reshape(B, T, H, Dh) for t in (q, k, v))
    if attn_fn is not None:
        attn = attn_fn(q, k, v)
    else:
        attn = mha(q, k, v, bias=bias, scale=Dh**-0.5)
    x = x + proj_apply(attn.reshape(B, T, D), p["out_proj"])
    return _encoder_ffn(x, p, ln, approx_gelu)


def _encoder_ffn(x, p, ln, approx_gelu):
    h = ln(x, p["final_ln"]["scale"], p["final_ln"]["bias"])
    h = F.gelu(proj_apply(h, p["fc1"]), approximate="tanh" if approx_gelu else "none")
    return x + proj_apply(h, p["fc2"])


def fuse_encoder_inference_params(params: Params) -> Params:
    """Inference tree for the fused path. The layers' LayerNorm scales and
    biases become fp32, the dtype the LayerNorm kernels read, so that no
    launch casts them. q/k/v are concatenated into one ``qkv_proj`` (the k
    third of the bias is zeros: Whisper's k_proj has none), unless they are
    already fused or carry LoRA."""
    ly = dict(params["layers"])
    for n in ("attn_ln", "final_ln"):
        ly[n] = {k: v.float() for k, v in ly[n].items()}
    names = ("q_proj", "k_proj", "v_proj")
    if "qkv_proj" not in ly and not any("lora_a" in ly.get(n, {}) for n in names):
        q, k, v = (ly.pop(n) for n in names)
        if "kernel" not in q:
            raise NotImplementedError("int8 encoder trees are not ported yet")
        fused = {"kernel": torch.cat([q["kernel"], k["kernel"], v["kernel"]], dim=-1)}
        if "bias" in q:
            kb = k.get("bias", torch.zeros_like(q["bias"]))
            fused["bias"] = torch.cat([q["bias"], kb, v["bias"]], dim=-1)
        ly["qkv_proj"] = fused
    out = dict(params)
    out["layers"] = ly
    return out


def encoder_forward(
    params: Params,
    cfg: WhisperEncoderConfig,
    mel: torch.Tensor,  # (B, n_mels, T_mel)
    mel_lens: Optional[torch.Tensor] = None,  # (B,) valid mel frames
    *,
    latency_block_size: Optional[int] = None,
    remat: bool = False,
    attn_impl: str = "xla",
) -> torch.Tensor:
    """Mel features -> (B, T_out, d_model) hidden states. Positions past a
    row's ``feat_extract_output_length(mel_lens)`` are finite garbage that
    the audio token count excludes downstream. ``remat`` checkpoints each
    layer: its activations are recomputed in the backward."""
    if mel.shape[-1] > cfg.max_context_length:
        raise ValueError(
            f"mel length {mel.shape[-1]} exceeds encoder context "
            f"{cfg.max_context_length}; chunk the audio first."
        )
    if attn_impl not in ("xla", "fused", "flash"):
        raise NotImplementedError(f"encoder attn_impl={attn_impl!r} is not ported yet")
    fused = attn_impl == "fused"
    gelu = "tanh" if fused else "none"
    x = F.gelu(
        _conv1d(mel, params["conv1"]["kernel"], params["conv1"]["bias"], cfg.conv1_stride),
        approximate=gelu,
    )
    x = F.gelu(
        _conv1d(x, params["conv2"]["kernel"], params["conv2"]["bias"], cfg.conv2_stride,
                transpose_out=True),
        approximate=gelu,
    )
    B, T, _ = x.shape
    x = x + params["embed_positions"][:T][None].to(x.dtype)
    layers = params["layers"]
    lat = latency_block_size or 0
    scale = cfg.head_dim**-0.5

    bias = attn_fn = attn_qkv_fn = ln_fn = None
    if attn_impl == "flash":
        feat_lens = (
            feat_extract_output_length(mel_lens).to(x.device)
            if mel_lens is not None else None
        )
        attn_fn = lambda q, k, v: flash_attention(  # noqa: E731
            q, k, v, feat_lens, scale=scale, latency_block=lat
        )
    elif fused:
        feat_lens = (
            feat_extract_output_length(mel_lens).to(x.device)
            if mel_lens is not None else None
        )
        ln_fn = fused_layer_norm
        if "qkv_proj" in layers:
            if feat_lens is None:
                feat_lens = torch.full((B,), T, dtype=torch.int32, device=x.device)
            attn_qkv_fn = lambda qkv_t: attention_headmajor(  # noqa: E731
                qkv_t, feat_lens, n_heads=cfg.num_heads, scale=scale, latency_block=lat
            )
        else:
            attn_fn = lambda q, k, v: fused_attention(  # noqa: E731
                q, k, v, feat_lens, scale=scale, latency_block=lat
            )
    else:
        if mel_lens is not None:
            bias = length_mask_bias(feat_extract_output_length(mel_lens).to(x.device), T)
        if lat:
            blk = block_causal_bias(T, lat, device=x.device)
            bias = blk if bias is None else torch.minimum(bias, blk)

    def layer_fn(x, p):
        return _encoder_layer(
            cfg, x, bias, p,
            attn_fn=attn_fn, attn_qkv_fn=attn_qkv_fn, ln_fn=ln_fn, approx_gelu=fused,
        )

    for l in range(cfg.num_layers):
        p = _layer(layers, l)
        if remat:
            x = checkpoint_remat(layer_fn, x, p)
        else:
            x = layer_fn(x, p)
    return layer_norm(x, params["layer_norm"]["scale"], params["layer_norm"]["bias"])
