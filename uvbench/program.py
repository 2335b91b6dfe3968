"""The benchmark's weights and configuration as the program takes them:
``ultravox_torch``'s tree layout and ``UltravoxConfig``."""

from __future__ import annotations

from typing import Any, Dict

import torch

from uvbench.weights import dims


def program_tree(w: Dict[str, torch.Tensor], c: Dict[str, Any]) -> Dict[str, Any]:
    """``w`` in ultravox_torch's tree layout (the tensors themselves, no
    copy): fused decoder leaves where ``w`` holds them."""
    m = dims(c)
    layers: Dict[str, Any] = {"input_ln": w["dec.ln1"], "post_attn_ln": w["dec.ln2"],
                              "o_proj": {"kernel": w["dec.o"]},
                              "down_proj": {"kernel": w["dec.down"]}}
    if "dec.qkv" in w:
        layers["qkv_proj"] = {"kernel": w["dec.qkv"]}
        layers["gateup_proj"] = {"kernel": w["dec.gateup"]}
    else:
        for n in ("q", "k", "v", "gate", "up"):
            layers[f"{n}_proj"] = {"kernel": w[f"dec.{n}"]}
    if m.qk_norm:
        layers["q_norm"], layers["k_norm"] = w["dec.q_norm"], w["dec.k_norm"]
    lm: Dict[str, Any] = {"embed_tokens": w["dec.embed"], "layers": layers, "norm": w["dec.norm"]}
    if "dec.head" in w:
        lm["lm_head"] = {"kernel": w["dec.head"]}

    def proj(n: str, bias: bool) -> Dict[str, Any]:
        p = {"kernel": w[f"enc.{n}.w"]}
        if bias:
            p["bias"] = w[f"enc.{n}.b"]
        if f"enc.{n}.lora_a" in w:
            p["lora_a"], p["lora_b"] = w[f"enc.{n}.lora_a"], w[f"enc.{n}.lora_b"]
            p["lora_scale"] = torch.full((m.Le,), m.lora_alpha / m.lora_r,
                                         dtype=p["lora_a"].dtype, device=p["lora_a"].device)
        return p

    tower = {
        "conv1": {"kernel": w["enc.conv1.w"], "bias": w["enc.conv1.b"]},
        "conv2": {"kernel": w["enc.conv2.w"], "bias": w["enc.conv2.b"]},
        "embed_positions": w["enc.pos"],
        "layers": {
            "attn_ln": {"scale": w["enc.ln1.w"], "bias": w["enc.ln1.b"]},
            "q_proj": proj("q", True), "k_proj": proj("k", False), "v_proj": proj("v", True),
            "out_proj": proj("o", True),
            "final_ln": {"scale": w["enc.ln2.w"], "bias": w["enc.ln2.b"]},
            "fc1": {"kernel": w["enc.fc1.w"], "bias": w["enc.fc1.b"]},
            "fc2": {"kernel": w["enc.fc2.w"], "bias": w["enc.fc2.b"]},
        },
        "layer_norm": {"scale": w["enc.lnf.w"], "bias": w["enc.lnf.b"]},
    }
    projector: Dict[str, Any] = {"ln_pre": w["proj.ln_pre"], "linear_1": {"kernel": w["proj.w1"]},
                                 "linear_2": {"kernel": w["proj.w2"]}}
    if "proj.ln_mid" in w:
        projector["ln_mid"] = w["proj.ln_mid"]
    else:
        projector["ln_post"] = w["proj.ln_post"]
    return {"language_model": lm, "audio_tower": tower, "projector": projector}


def program_config(c: Dict[str, Any]):
    """The program's ``UltravoxConfig`` for configuration file ``c``."""
    from ultravox_torch.models.config import UltravoxConfig

    p = c["projector"]
    text = {k: v for k, v in c.items() if k not in ("audio_config", "projector", "assumed")}
    return UltravoxConfig.from_hf_dict({
        "audio_config": c["audio_config"], "text_config": text,
        "hidden_size": p["hidden_size"], "stack_factor": p["stack_factor"],
        "projector_act": p["projector_act"], "projector_ln_mid": p["projector_ln_mid"],
        "norm_init": p["norm_init"],
    })
