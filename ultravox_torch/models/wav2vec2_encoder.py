"""Wav2Vec2-family audio encoder (the raw-waveform tower) over a parameter dict.

    raw waveform -> conv feature extractor (strided 1-D convs, ~320x
    downsample) -> feature projection -> grouped conv positional embedding
    -> transformer encoder.

Both norm styles: ``feat_extract_norm="group"`` with post-norm encoder
blocks (wav2vec2-base) and ``"layer"`` with ``do_stable_layer_norm``
pre-norm blocks and a final LayerNorm (wav2vec2-large-lv60).

Parameters keep the JAX package's layout, so ``weights.from_jax_params``
reshapes nothing: ``feature_extractor`` is a list with one dict per conv,
conv kernels are (K, C_in / groups, C_out), linear kernels (in, out), and
the encoder layers' weights are stacked on a leading (L, ...) axis. Conv
kernels are transposed to torch's (C_out, C_in / groups, K) where they are
used. The arithmetic is the JAX package's: LayerNorm and GroupNorm in the
input dtype, exact-erf GELU, the plain ``mha`` with a length mask. No
kernel of the port runs here; the JAX tower reaches no Pallas kernel
either, and its engines neither fuse nor quantise it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ultravox_torch.models.config import Wav2Vec2EncoderConfig
from ultravox_torch.models.whisper_encoder import _layer
from ultravox_torch.ops.attention import length_mask_bias, mha

__all__ = ["Wav2Vec2EncoderConfig", "init_params", "feature_extractor", "encoder_forward"]

Params = Dict[str, Any]


def init_params(
    cfg: Wav2Vec2EncoderConfig, generator: torch.Generator, dtype=torch.float32, device=None
) -> Params:
    """Seeded random init in the JAX package's tree layout (normal * 0.02
    matrices, unit norm scales, zero biases). The generator must live on
    ``device``; the draws differ from the JAX package's."""
    D, Fd, L = cfg.hidden_size, cfg.ffn_dim, cfg.num_layers

    def dn(*shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    convs = []
    in_dim = 1
    for i, (out_dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        conv: Params = {"kernel": dn(k, in_dim, out_dim)}
        if cfg.conv_bias:
            conv["bias"] = zeros(out_dim)
        if cfg.feat_extract_norm == "layer" or (cfg.feat_extract_norm == "group" and i == 0):
            conv["norm"] = {"scale": ones(out_dim), "bias": zeros(out_dim)}
        convs.append(conv)
        in_dim = out_dim

    def ln():
        return {"scale": ones(L, D), "bias": zeros(L, D)}

    def lin(d_in, d_out):
        return {"kernel": dn(L, d_in, d_out), "bias": zeros(L, d_out)}

    C = cfg.conv_dim[-1]
    return {
        "feature_extractor": convs,
        "feature_projection": {
            "ln": {"scale": ones(C), "bias": zeros(C)},
            "projection": {"kernel": dn(C, D), "bias": zeros(D)},
        },
        "pos_conv": {
            "kernel": dn(cfg.num_conv_pos_embeddings, D // cfg.num_conv_pos_embedding_groups, D),
            "bias": zeros(D),
        },
        "encoder_ln": {"scale": ones(D), "bias": zeros(D)},
        "layers": {
            "attn_ln": ln(),
            "q_proj": lin(D, D),
            "k_proj": lin(D, D),
            "v_proj": lin(D, D),
            "out_proj": lin(D, D),
            "final_ln": ln(),
            "fc1": lin(D, Fd),
            "fc2": lin(Fd, D),
        },
    }


def _layer_norm(x, p, eps, dim: int = -1):
    """LayerNorm over ``dim`` in x's dtype, as the JAX package computes it
    (a bf16 input keeps bf16 arithmetic; the means accumulate in fp32)."""
    mean = x.mean(dim, keepdim=True)
    var = (x - mean).square().mean(dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"].reshape(shape) + p["bias"].reshape(shape)


def _group_norm(x, p, num_groups: int, eps):
    """GroupNorm of x (B, C, T) over groups of channels and the whole time
    axis, padding included (as the JAX package and HF take it); wav2vec2
    uses one group per channel."""
    B, C, T = x.shape
    xg = x.reshape(B, num_groups, C // num_groups, T)
    mean = xg.mean((2, 3), keepdim=True)
    var = (xg - mean).square().mean((2, 3), keepdim=True)
    x = ((xg - mean) * torch.rsqrt(var + eps)).reshape(B, C, T)
    return x * p["scale"][:, None] + p["bias"][:, None]


def _conv(x, kernel, stride: int = 1, padding: int = 0, groups: int = 1):
    """x (B, C_in, T) through a (K, C_in / groups, C_out) kernel in x's dtype."""
    w = kernel.permute(2, 1, 0).to(x.dtype)
    return F.conv1d(x, w, stride=stride, padding=padding, groups=groups)


def feature_extractor(params: Params, cfg: Wav2Vec2EncoderConfig, audio: torch.Tensor):
    """Raw waveform (B, T_samples) -> conv features (B, T_frames, C)."""
    x = audio[:, None, :]  # (B, 1, T): channels first for conv1d
    for i, conv in enumerate(params["feature_extractor"]):
        x = _conv(x, conv["kernel"], stride=cfg.conv_stride[i])
        if "bias" in conv:
            x = x + conv["bias"][:, None]
        if "norm" in conv:
            if cfg.feat_extract_norm == "group" and i == 0:
                x = _group_norm(x, conv["norm"], cfg.conv_dim[0], cfg.layer_norm_eps)
            else:
                x = _layer_norm(x, conv["norm"], cfg.layer_norm_eps, dim=1)
        x = F.gelu(x)
    return x.transpose(1, 2)


def pos_conv_embedding(params: Params, cfg: Wav2Vec2EncoderConfig, h: torch.Tensor):
    """The grouped conv positional embedding of h (B, T, D): kernel K in
    ``num_conv_pos_embedding_groups`` groups, K // 2 zeros on each side,
    the last frame dropped for an even K, exact GELU."""
    k = cfg.num_conv_pos_embeddings
    pos = _conv(h.transpose(1, 2), params["pos_conv"]["kernel"], padding=k // 2,
                groups=cfg.num_conv_pos_embedding_groups)
    pos = pos + params["pos_conv"]["bias"][:, None]
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    return F.gelu(pos).transpose(1, 2)


def _check_no_lora(layers: Params) -> None:
    adapted = sorted(k for k, v in layers.items() if isinstance(v, dict) and "lora_a" in v)
    if adapted:
        raise ValueError(
            f"the wav2vec2 tower carries LoRA leaves on {adapted}: its projections multiply the "
            "kernel alone (as in the JAX package, where such adapters are silently ignored)")


def encoder_forward(
    params: Params,
    cfg: Wav2Vec2EncoderConfig,
    audio: torch.Tensor,  # (B, T_samples) raw waveform
    sample_lens: Optional[torch.Tensor] = None,  # (B,) valid samples per row
) -> torch.Tensor:
    """Encoder hidden states (B, T_frames, D) in the audio's dtype. With
    ``sample_lens`` the frames past each row's ``feature_lengths`` are
    zeroed before the positional conv and masked out of attention; they
    come out as finite garbage that the audio token count excludes."""
    layers = params["layers"]
    _check_no_lora(layers)
    feats = feature_extractor(params, cfg, audio)
    B, T, _ = feats.shape
    fp = params["feature_projection"]
    h = _layer_norm(feats, fp["ln"], cfg.layer_norm_eps)
    h = h @ fp["projection"]["kernel"] + fp["projection"]["bias"]

    bias = None
    if sample_lens is not None:
        feat_lens = cfg.feature_lengths(sample_lens.to(h.device).long())
        valid = torch.arange(T, device=h.device)[None, :] < feat_lens[:, None]
        h = torch.where(valid[..., None], h, 0.0)
        bias = length_mask_bias(feat_lens, T)

    h = h + pos_conv_embedding(params, cfg, h)
    stable = cfg.do_stable_layer_norm
    eps = cfg.layer_norm_eps
    if not stable:
        h = _layer_norm(h, params["encoder_ln"], eps)
    H, Dh = cfg.num_heads, cfg.head_dim
    scale = Dh**-0.5

    def lin(x, p):
        return x @ p["kernel"] + p["bias"]

    for l in range(cfg.num_layers):
        p = _layer(layers, l)
        a = _layer_norm(h, p["attn_ln"], eps) if stable else h
        q = lin(a, p["q_proj"]).reshape(B, T, H, Dh)
        k = lin(a, p["k_proj"]).reshape(B, T, H, Dh)
        v = lin(a, p["v_proj"]).reshape(B, T, H, Dh)
        attn = mha(q, k, v, bias=bias, scale=scale).reshape(B, T, -1)
        h = h + lin(attn, p["out_proj"])
        if stable:
            f = _layer_norm(h, p["final_ln"], eps)
        else:
            h = f = _layer_norm(h, p["attn_ln"], eps)
        h = h + lin(F.gelu(lin(f, p["fc1"])), p["fc2"])
        if not stable:
            h = _layer_norm(h, p["final_ln"], eps)
    if stable:
        h = _layer_norm(h, params["encoder_ln"], eps)
    return h
