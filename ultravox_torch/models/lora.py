"""Projection helper shared by the encoder, decoder and projector, LoRA and
multi-LoRA banks.

Target projection dicts gain stacked ``lora_a`` (L, in, r), ``lora_b``
(L, r, out) and ``lora_scale`` (L,) leaves, applied inside ``proj_apply`` as
``y += (x @ lora_a) @ lora_b * scale``; freezing is a trainable-pattern
selection (``.*lora_[ab]$``), and ``merge_lora`` folds the update into the
kernel. For multi-LoRA serving, ``build_lora_banks`` stacks several adapters
per target (slot 0 is the base model), ``fuse_lora_banks`` re-expresses them
over fused q/k/v and gate/up projections, and ``apply_lora_banks`` gathers
one adapter per row (or per request) into a tree. Int8 projections
(``kernel_q`` + per-output-channel ``scale``) run in ``proj_apply`` as the
JAX package runs them: w8a16 for at most ``W8A16_MAX_ROWS`` activation rows,
else w8a8 with per-row dynamic activation scales.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from ultravox_torch.models.config import LoraConfig
from ultravox_torch.parallel.sharding import (
    from_tensor,
    split_of,
    tensor_cols,
    tensor_rows,
    to_tensor,
)

Params = Dict[str, Any]

# module name -> parameter-tree key, per tower
DECODER_TARGETS = {
    "q_proj": "q_proj",
    "k_proj": "k_proj",
    "v_proj": "v_proj",
    "o_proj": "o_proj",
    "gate_proj": "gate_proj",
    "up_proj": "up_proj",
    "down_proj": "down_proj",
}
ENCODER_TARGETS = {
    "q_proj": "q_proj",
    "k_proj": "k_proj",
    "v_proj": "v_proj",
    "out_proj": "out_proj",
    "fc1": "fc1",
    "fc2": "fc2",
}
# the default target_modules include wav2vec-style linear_k/linear_q
_ALIASES = {"linear_q": "q_proj", "linear_k": "k_proj"}


def lora_scale(cfg: LoraConfig) -> float:
    return cfg.lora_alpha / max(cfg.r, 1)


def add_lora(
    tower_params: Params,
    cfg: LoraConfig,
    generator: torch.Generator,
    targets: Dict[str, str],
    dtype=torch.float32,
) -> Params:
    """Add stacked lora_a/lora_b/lora_scale leaves to the targeted
    projections of one tower's ``layers`` subtree, on the generator's
    device. A is gaussian / r, B zeros, so the adapter starts as identity.
    The draws differ from the JAX package's."""
    if cfg.r <= 0:
        return tower_params
    layers = dict(tower_params["layers"])
    wanted = {_ALIASES.get(t, t) for t in (cfg.target_modules or targets.keys())}
    for mod, tree_key in sorted(targets.items()):
        if mod not in wanted or tree_key not in layers:
            continue
        proj = dict(layers[tree_key])
        L, d_in, d_out = proj["kernel"].shape
        dev = generator.device
        a = torch.randn((L, d_in, cfg.r), generator=generator, device=dev, dtype=torch.float32)
        proj["lora_a"] = (a * (1.0 / cfg.r)).to(dtype)
        proj["lora_b"] = torch.zeros((L, cfg.r, d_out), dtype=dtype, device=dev)
        # a per-layer scale leaf, so the projection helper needs no config
        proj["lora_scale"] = torch.full((L,), lora_scale(cfg), dtype=dtype, device=dev)
        layers[tree_key] = proj
    out = dict(tower_params)
    out["layers"] = layers
    return out


def apply_lora_to_model(
    params: Params,
    text_lora: LoraConfig,
    audio_lora: LoraConfig,
    generator: torch.Generator,
    dtype=torch.float32,
) -> Params:
    out = dict(params)
    if text_lora.r > 0 and "language_model" in out:
        out["language_model"] = add_lora(out["language_model"], text_lora, generator,
                                         DECODER_TARGETS, dtype)
    if audio_lora.r > 0 and "audio_tower" in out:
        if "feature_extractor" in out["audio_tower"]:
            # the JAX package adds such adapters, and its wav2vec2 tower
            # multiplies the kernels alone: they would train nothing
            raise ValueError("audio LoRA (r > 0) is not supported on a wav2vec2 audio tower")
        out["audio_tower"] = add_lora(out["audio_tower"], audio_lora, generator,
                                      ENCODER_TARGETS, dtype)
    return out


# the JAX package's switch between its int8 regimes, on activation rows
W8A16_MAX_ROWS = 32


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127, correctly rounded on every device. PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, which can be
    an ulp off and then moves a quantized value by one; a 0-dim tensor
    divisor on the same device is a true division."""
    return amax / torch.full((), 127.0, dtype=amax.dtype, device=amax.device)


def _w8a16(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) float activations times (K, N) int8 weights, fp32 accumulation
    and result. The weight is cast to the activation's dtype first, which is
    exact (|q| <= 127), and costs one copy of it per call. On the card a bf16
    product keeps its fp32 sums through ``out_dtype``."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        return torch.mm(x, wq.to(x.dtype), out_dtype=torch.float32)
    return x.float() @ wq.float()


def int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 times (K, N) int8 -> (M, N) int32, exact. The card's
    ``torch._int_mm`` takes M > 16 and K, N multiples of 8 (either weight
    layout); it raises on any other shape, and nothing falls back to a
    float product."""
    if xq.device.type != "cuda":
        return xq.int() @ wq.int()
    return torch._int_mm(xq, wq)


def _int8_apply(x: torch.Tensor, p: Params) -> torch.Tensor:
    """The int8 projection of ``proj_apply``, in x's dtype."""
    wq, scale = p["kernel_q"], p["scale"].float()
    K, N = wq.shape
    x2 = x.reshape(-1, K)
    if x2.shape[0] <= W8A16_MAX_ROWS:  # decode-shaped: w8a16
        out = _w8a16(x2, wq) * scale
    else:  # batch-shaped: w8a8, the activation quantized per row
        xf = x2.float()
        sx = int8_scale(xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6))
        xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
        out = int8_mm(xq, wq).float() * sx * scale
    return out.to(x.dtype).reshape(*x.shape[:-1], N)


def _lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale, like):
    # the delta runs in the promoted dtype, as JAX promotes a bf16 x fp32
    # product, and is cast to the base output's dtype: fp32 adapters over a
    # bf16 or int8 base must not promote the residual stream
    dt = torch.promote_types(x.dtype, a.dtype)
    return (((x.to(dt) @ a.to(dt)) @ b.to(dt)) * scale).to(like.dtype)


def _split_proj(x: torch.Tensor, p: Params, sp) -> torch.Tensor:
    """``proj_apply`` of a kernel split over ``tensor`` (Megatron). A row
    split (dim -2) takes this rank's slice of the input, its partial sum
    (with its LoRA's: ``lora_a``'s rows) is all-reduced and the bias added
    once after; a column split (dim -1) gives this rank's output columns,
    of the bias and of ``lora_b`` too; a kept leaf (``cols``) gives the
    columns its K/V heads. The caller passes a column split's input
    through ``to_tensor``; the whole LoRA factors and biases pass through
    it here, so their gradients are whole on every tensor rank."""
    if sp.dim == -2:
        out = x @ p["kernel"]
        if "lora_a" in p:
            out = out + _lora_delta(x, tensor_rows(p["lora_a"], sp), to_tensor(p["lora_b"], sp),
                                    p["lora_scale"], out)
        out = from_tensor(out, sp)
        return out + p["bias"] if "bias" in p else out
    kernel = p["kernel"] if sp.dim is not None else tensor_cols(p["kernel"], sp)
    out = x @ kernel
    if "bias" in p:
        bias = p["bias"]
        out = out + (bias if split_of(bias) is not None else tensor_cols(bias, sp))
    if "lora_a" in p:
        out = out + _lora_delta(x, to_tensor(p["lora_a"], sp), tensor_cols(p["lora_b"], sp),
                                p["lora_scale"], out)
    return out


def proj_apply(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Linear projection with optional bias (added in the product's dtype),
    int8 storage and LoRA path, as the reference computes them. LoRA leaves
    may be per layer ((in, r), a scalar scale), per request from a bank
    ((in, r), scale (1, 1)) or per row from a bank ((B, in, r), scale (B, 1,
    1) against x (B, T, in)). A kernel split over ``tensor`` runs its
    slice (``_split_proj``)."""
    sp = split_of(p.get("kernel"))
    if sp is not None:
        return _split_proj(x, p, sp)
    out = _int8_apply(x, p) if "kernel_q" in p else x @ p["kernel"]
    if "bias" in p:
        out = out + p["bias"]
    if "lora_a" in p:
        out = out + _lora_delta(x, p["lora_a"], p["lora_b"], p["lora_scale"], out)
    return out


def merge_lora(
    params: Params,
    towers: Sequence[str] = ("language_model", "audio_tower"),
) -> Params:
    """Fold LoRA into the kernels and drop the adapter leaves."""

    def merge_tower(tower: Params) -> Params:
        layers = {}
        for key, leaf in tower["layers"].items():
            if isinstance(leaf, dict) and "lora_a" in leaf:
                new = dict(leaf)
                a, b = new.pop("lora_a"), new.pop("lora_b")
                scale = new.pop("lora_scale")[:, None, None]
                delta = torch.einsum("lir,lro->lio", a, b) * scale
                new["kernel"] = new["kernel"] + delta.to(new["kernel"].dtype)
                layers[key] = new
            else:
                layers[key] = leaf
        out = dict(tower)
        out["layers"] = layers
        return out

    out = dict(params)
    for tower in towers:
        if tower in out and "layers" in out.get(tower, {}):
            out[tower] = merge_tower(out[tower])
    return out


def lora_trainable_patterns() -> Tuple[str, ...]:
    return (r".*lora_[ab]$",)


def build_lora_banks(adapters: Dict[str, Params]) -> Tuple[Params, Dict[str, int]]:
    """Stack several adapters into per-target banks for multi-LoRA serving.

    ``adapters``: name -> a tower's tree whose ``layers`` carry
    ``lora_a``/``lora_b``/``lora_scale`` on some projections. Returns
    ``(banks, index)``: ``banks[target] = {"a": (L, N+1, in, r), "b": (L,
    N+1, r, out), "scale": (L, N+1, 1, 1)}`` with slot 0 all zeros (the base
    model, an exact no-op) and ``index[name]`` = 1..N in sorted-name order.
    Adapters may target different projections (missing ones are zero slots)
    but must share the rank within a target. The banks take the first
    adapter leaf's dtype and device."""
    index = {name: i + 1 for i, name in enumerate(sorted(adapters))}
    n_banks = len(index) + 1
    targets: Dict[str, Tuple[int, int, int, int]] = {}
    like = None
    for name, tree in adapters.items():
        for tgt, proj in tree["layers"].items():
            if isinstance(proj, dict) and "lora_a" in proj:
                L, d_in, r = proj["lora_a"].shape
                d_out = proj["lora_b"].shape[-1]
                like = proj["lora_a"] if like is None else like
                prev = targets.get(tgt)
                if prev is not None and prev != (L, d_in, r, d_out):
                    raise ValueError(
                        f"adapter {name!r} target {tgt!r} shape {(L, d_in, r, d_out)} != {prev} of "
                        "another adapter: multi-LoRA banks need matching ranks per target"
                    )
                targets[tgt] = (L, d_in, r, d_out)
    if not targets:
        raise ValueError("no lora_a leaves found in any adapter")
    kw = dict(dtype=like.dtype, device=like.device)
    banks = {}
    for tgt, (L, d_in, r, d_out) in targets.items():
        a = torch.zeros((L, n_banks, d_in, r), **kw)
        b = torch.zeros((L, n_banks, r, d_out), **kw)
        sc = torch.zeros((L, n_banks, 1, 1), **kw)
        for name, tree in adapters.items():
            proj = tree["layers"].get(tgt)
            if not (isinstance(proj, dict) and "lora_a" in proj):
                continue
            i = index[name]
            a[:, i] = proj["lora_a"].to(**kw)
            b[:, i] = proj["lora_b"].to(**kw)
            sc[:, i] = proj["lora_scale"].to(**kw)[:, None, None]
        banks[tgt] = {"a": a, "b": b, "scale": sc}
    return banks, index


def fuse_lora_banks(
    banks: Params, qkv_dims: Tuple[int, ...], gateup_dims: Tuple[int, ...]
) -> Params:
    """Banks over the fused ``qkv_proj`` / ``gateup_proj`` projections. A
    fused adapter is exact block algebra: A = [A_q | A_k | A_v] over B =
    blockdiag(s_q B_q, s_k B_k, s_v B_v), so ``x @ A @ B`` is the
    concatenation of the members' updates; the fused scale is 1 and members
    an adapter does not target are zero blocks."""
    out = dict(banks)
    for fused_name, members, dims in (
        ("qkv_proj", ("q_proj", "k_proj", "v_proj"), qkv_dims),
        ("gateup_proj", ("gate_proj", "up_proj"), gateup_dims),
    ):
        if not any(m in out for m in members):
            continue
        parts, off = [], 0  # (bank, output offset, output width) of each member
        for m, d_out in zip(members, dims):
            if m in out:
                parts.append((out.pop(m), off, d_out))
            off += d_out
        a_f = torch.cat([bk["a"] for bk, _, _ in parts], dim=-1)
        L, N = a_f.shape[:2]
        b_f = a_f.new_zeros((L, N, a_f.shape[-1], off))
        r_off = 0
        for bk, o, d_out in parts:
            r = bk["a"].shape[-1]
            b_f[:, :, r_off:r_off + r, o:o + d_out] = bk["b"] * bk["scale"]
            r_off += r
        out[fused_name] = {"a": a_f, "b": b_f, "scale": a_f.new_ones((L, N, 1, 1))}
    return out


def apply_lora_banks(tower_params: Params, banks: Params, idx: torch.Tensor) -> Params:
    """The tree with each banked target's adapter gathered from the banks:
    a (B,) ``idx`` gives per-row (L, B, in, r) leaves, so every sequence of
    one dispatch runs its own adapter; a 0-dim ``idx`` gives the request-wide
    (L, in, r) leaves. Slot 0 is the base model. The gather is an
    ``index_select`` on the index's device, with no read back to the host."""
    flat = idx.reshape(-1).long()
    layers = dict(tower_params["layers"])
    for tgt, bank in banks.items():
        proj = dict(layers[tgt])
        for key, leaf in (("lora_a", "a"), ("lora_b", "b"), ("lora_scale", "scale")):
            g = bank[leaf].index_select(1, flat)
            proj[key] = g.squeeze(1) if idx.dim() == 0 else g
        layers[tgt] = proj
    out = dict(tower_params)
    out["layers"] = layers
    return out
