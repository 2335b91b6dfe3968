"""Seeded random weights, made on the device in the type they are served
or trained in, one large call per stacked leaf.

``make`` returns a flat dict of the benchmark's own names. The same seed
gives the same tensors on the same device, so the reference makes them
again after the program's state is freed and never reads the program's
copies. ``program.py`` arranges them in ``ultravox_torch``'s tree
layout. In the serving layout the decoder's q/k/v and gate/up are made as
one fused buffer each (the layout the engine serves), and the separate
names are views of it. Pure torch: nothing here imports the program."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Dims:
    """The sizes a configuration file states."""

    D: int
    I: int
    L: int
    Hq: int
    Hkv: int
    Dh: int
    V: int
    rope_theta: float
    eps: float
    qk_norm: bool
    tied: bool
    n_mels: int
    d: int
    f: int
    Le: int
    He: int
    max_pos: int
    proj_hidden: int
    stack: int
    ln_mid: bool
    norm_init: float
    lora_r: int
    lora_alpha: float
    lora_targets: tuple

    @property
    def de(self) -> int:  # encoder head size
        return self.d // self.He

    @property
    def audio_compression(self) -> int:  # mel frames per LLM position
        return 2 * self.stack


def dims(c: Dict[str, Any]) -> Dims:
    a, p = c["audio_config"], c["projector"]
    lora = c.get("audio_lora") or {}
    return Dims(
        D=c["hidden_size"], I=c["intermediate_size"], L=c["num_hidden_layers"],
        Hq=c["num_attention_heads"], Hkv=c["num_key_value_heads"],
        Dh=c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"],
        V=c["vocab_size"], rope_theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
        qk_norm=c["model_type"] == "qwen3", tied=bool(c.get("tie_word_embeddings", False)),
        n_mels=a["num_mel_bins"], d=a["d_model"], f=a["encoder_ffn_dim"], Le=a["encoder_layers"],
        He=a["encoder_attention_heads"], max_pos=a["max_source_positions"],
        proj_hidden=p["hidden_size"], stack=p["stack_factor"], ln_mid=bool(p["projector_ln_mid"]),
        norm_init=float(p["norm_init"]), lora_r=int(lora.get("r", 0)),
        lora_alpha=float(lora.get("lora_alpha", 8.0)),
        lora_targets=tuple(lora.get("target_modules", ())),
    )


def make(c: Dict[str, Any], seed: int, device, *, fused: bool, dtype=None) -> Dict[str, torch.Tensor]:
    """Every weight of configuration ``c`` from ``seed``, in a fixed order."""
    m = dims(c)
    dt = dtype or DTYPES[c.get("dtype", "bfloat16")]
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))

    def normal(*shape, std=0.02):
        return torch.empty(shape, dtype=dt, device=device).normal_(0.0, std, generator=g)

    def uniform(fan_in, fan_out):
        return torch.empty((fan_in, fan_out), dtype=dt, device=device).uniform_(
            -fan_in**-0.5, fan_in**-0.5, generator=g)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dt, device=device)

    w: Dict[str, torch.Tensor] = {}
    L, D, I = m.L, m.D, m.I
    nq, nkv = m.Hq * m.Dh, m.Hkv * m.Dh
    w["dec.embed"] = normal(m.V, D)
    if fused:
        w["dec.qkv"] = normal(L, D, nq + 2 * nkv)
        w["dec.q"], w["dec.k"], w["dec.v"] = w["dec.qkv"].split((nq, nkv, nkv), dim=-1)
    else:
        w["dec.q"], w["dec.k"], w["dec.v"] = normal(L, D, nq), normal(L, D, nkv), normal(L, D, nkv)
    w["dec.o"] = normal(L, nq, D)
    if fused:
        w["dec.gateup"] = normal(L, D, 2 * I)
        w["dec.gate"], w["dec.up"] = w["dec.gateup"].split((I, I), dim=-1)
    else:
        w["dec.gate"], w["dec.up"] = normal(L, D, I), normal(L, D, I)
    w["dec.down"] = normal(L, I, D)
    w["dec.ln1"], w["dec.ln2"], w["dec.norm"] = full(1.0, L, D), full(1.0, L, D), full(1.0, D)
    if m.qk_norm:
        w["dec.q_norm"], w["dec.k_norm"] = full(1.0, L, m.Dh), full(1.0, L, m.Dh)
    if not m.tied:
        w["dec.head"] = normal(D, m.V)

    d, f, Le = m.d, m.f, m.Le
    w["enc.conv1.w"], w["enc.conv1.b"] = normal(3, m.n_mels, d), full(0.0, d)
    w["enc.conv2.w"], w["enc.conv2.b"] = normal(3, d, d), full(0.0, d)
    w["enc.pos"] = normal(m.max_pos, d)
    for n in ("ln1", "ln2"):
        w[f"enc.{n}.w"], w[f"enc.{n}.b"] = full(1.0, Le, d), full(0.0, Le, d)
    for n in ("q", "k", "v", "o"):
        w[f"enc.{n}.w"] = normal(Le, d, d)
    for n in ("q", "v", "o"):
        w[f"enc.{n}.b"] = full(0.0, Le, d)
    w["enc.fc1.w"], w["enc.fc1.b"] = normal(Le, d, f), full(0.0, Le, f)
    w["enc.fc2.w"], w["enc.fc2.b"] = normal(Le, f, d), full(0.0, Le, d)
    w["enc.lnf.w"], w["enc.lnf.b"] = full(1.0, d), full(0.0, d)

    dim_in, hid = d * m.stack, m.proj_hidden
    w["proj.ln_pre"] = full(m.norm_init, dim_in)
    w["proj.w1"] = uniform(dim_in, hid)
    w["proj.w2"] = uniform(hid // 2, D)
    if m.ln_mid:
        w["proj.ln_mid"] = full(m.norm_init, hid // 2)
    else:
        w["proj.ln_post"] = full(m.norm_init, D)

    for t in m.lora_targets if m.lora_r > 0 else ():
        n = {"q_proj": "q", "k_proj": "k", "v_proj": "v"}[t]
        w[f"enc.{n}.lora_a"] = normal(Le, d, m.lora_r, std=1.0 / m.lora_r)
        w[f"enc.{n}.lora_b"] = full(0.0, Le, m.lora_r, d)
    return w

