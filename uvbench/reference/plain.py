"""The plain reference: Whisper's encoder, Ultravox's projector, the
``mistral`` and ``qwen3`` decoders and the KL distillation loss, in float32
PyTorch operations as the published models define them, one sequence and
one layer at a time. It imports nothing of the program: it reads the
benchmark's own weights (``uvbench/weights.py``) and upcasts each layer's
to float32 when it runs it.

Departures from the published models, each also the program's: the
encoder runs on the valid mel frames alone (the benchmark's audio lengths
are multiples of 16 frames, so no projector frame stacks padding); the
decoders' rope angles are computed in float64.

``Precision`` decides how every product rounds: ``EXACT`` is float32 with
TF32 off; ``FP8`` rounds each weight to float8 e4m3 with a per-output-
channel scale and each activation row to e4m3 with a per-row scale
(W8A8, the step below bfloat16 that a faster program would take). It is
the control of the correctness check."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from uvbench.weights import Dims

E4M3_MAX = 448.0


class Precision:
    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def w(self, W: torch.Tensor) -> torch.Tensor:
        """A weight (..., in, out) as the products read it, float32."""
        W = W.float()
        if not self.fp8:
            return W
        s = W.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / E4M3_MAX
        return (W / s).to(torch.float8_e4m3fn).float() * s

    def x(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, x: torch.Tensor, W: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.x(x) @ self.w(W)
        return y if b is None else y + b.float()


EXACT = Precision(False)
FP8 = Precision(True)


def exact_float32() -> None:
    """Full float32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def _attend(q, k, v, causal: bool, head_block: int = 8):
    """softmax(q k^T / sqrt(d)) v over (T, H, Dh) q and (S, Hkv, Dh) k, v,
    the key heads shared by groups of query heads; ``head_block`` query
    heads at a time."""
    T, H, Dh = q.shape
    S, Hkv, _ = k.shape
    G = H // Hkv
    out = torch.empty_like(q)
    mask = None
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool, device=q.device).tril(S - T)
    for h0 in range(0, H, head_block):
        hs = range(h0, min(H, h0 + head_block))
        qh = q[:, hs].transpose(0, 1)  # (h, T, Dh)
        kh = k[:, [h // G for h in hs]].transpose(0, 1)
        vh = v[:, [h // G for h in hs]].transpose(0, 1)
        s = qh @ kh.transpose(1, 2) * Dh**-0.5
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        out[:, hs] = (torch.softmax(s, dim=-1) @ vh).transpose(0, 1)
    return out


def encoder(w: Dict[str, torch.Tensor], m: Dims, mel: torch.Tensor, p: Precision = EXACT,
            lora: bool = False) -> torch.Tensor:
    """mel (n_mels, T) -> (T // 2, d): Whisper's conv stem, sinusoid-free
    learned positions, pre-norm layers with exact GELU, final LayerNorm.
    ``lora`` adds the q/v adapters' (a @ b) * alpha / r."""
    x = F.gelu(F.conv1d(mel.float()[None], p.w(w["enc.conv1.w"]).permute(2, 1, 0),
                        w["enc.conv1.b"].float(), stride=1, padding=1))
    x = F.gelu(F.conv1d(x, p.w(w["enc.conv2.w"]).permute(2, 1, 0), w["enc.conv2.b"].float(),
                        stride=2, padding=1))[0].T
    T = x.shape[0]
    x = x + w["enc.pos"][:T].float()
    for l in range(m.Le):
        x = encoder_layer(w, m, x, l, p, lora)
    return layer_norm(x, w["enc.lnf.w"], w["enc.lnf.b"])


def _enc_proj(w, m, h, n, l, p, lora):
    y = p.mm(h, w[f"enc.{n}.w"][l], w[f"enc.{n}.b"][l] if f"enc.{n}.b" in w else None)
    if lora and f"enc.{n}.lora_a" in w:
        y = y + (h @ w[f"enc.{n}.lora_a"][l].float() @ w[f"enc.{n}.lora_b"][l].float()) * (
            m.lora_alpha / m.lora_r)
    return y


def encoder_layer(w, m: Dims, x, l: int, p: Precision = EXACT, lora: bool = False):
    T = x.shape[0]
    h = layer_norm(x, w["enc.ln1.w"][l], w["enc.ln1.b"][l])
    q, k, v = (_enc_proj(w, m, h, n, l, p, lora).reshape(T, m.He, m.de) for n in ("q", "k", "v"))
    x = x + p.mm(_attend(q, k, v, causal=False).reshape(T, m.d), w["enc.o.w"][l], w["enc.o.b"][l])
    h = layer_norm(x, w["enc.ln2.w"][l], w["enc.ln2.b"][l])
    h = F.gelu(p.mm(h, w["enc.fc1.w"][l], w["enc.fc1.b"][l]))
    return x + p.mm(h, w["enc.fc2.w"][l], w["enc.fc2.b"][l])


def projector(w, m: Dims, enc: torch.Tensor, p: Precision = EXACT) -> torch.Tensor:
    """(T_enc, d) -> (ceil(T_enc / stack), D): stack, RMSNorm, linear,
    SwiGLU (first half the value, second the gate), [RMSNorm], linear,
    [RMSNorm]; the norms' epsilon 1e-6."""
    T = enc.shape[0]
    pad = -T % m.stack
    x = F.pad(enc, (0, 0, 0, pad)).reshape(-1, m.d * m.stack)
    x = rms_norm(x, w["proj.ln_pre"], 1e-6)
    val, gate = p.mm(x, w["proj.w1"]).chunk(2, dim=-1)
    x = F.silu(gate) * val
    if "proj.ln_mid" in w:
        x = rms_norm(x, w["proj.ln_mid"], 1e-6)
    x = p.mm(x, w["proj.w2"])
    if "proj.ln_post" in w:
        x = rms_norm(x, w["proj.ln_post"], 1e-6)
    return x


def audio_tokens(w, m: Dims, mel: torch.Tensor, p: Precision = EXACT, lora: bool = False):
    return projector(w, m, encoder(w, m, mel, p, lora), p)


def embed(w, m: Dims, ids: torch.Tensor, audio: Optional[torch.Tensor], start: int) -> torch.Tensor:
    """Token embeddings (T, D) float32 with the audio tokens written over
    their placeholders from ``start``."""
    x = w["dec.embed"][ids.long()].float()
    if audio is not None:
        x = torch.cat([x[:start], audio, x[start + audio.shape[0]:]])
    return x


def rope(m: Dims, T: int, device):
    inv = 1.0 / (m.rope_theta ** (torch.arange(0, m.Dh, 2, dtype=torch.float64, device=device) / m.Dh))
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


def _rotate(x, cos, sin):
    h = x.shape[-1] // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def decoder_layer(w, m: Dims, x: torch.Tensor, l: int, cos, sin, p: Precision = EXACT):
    T = x.shape[0]
    h = rms_norm(x, w["dec.ln1"][l], m.eps)
    q = p.mm(h, w["dec.q"][l]).reshape(T, m.Hq, m.Dh)
    k = p.mm(h, w["dec.k"][l]).reshape(T, m.Hkv, m.Dh)
    v = p.mm(h, w["dec.v"][l]).reshape(T, m.Hkv, m.Dh)
    if m.qk_norm:
        q, k = rms_norm(q, w["dec.q_norm"][l], m.eps), rms_norm(k, w["dec.k_norm"][l], m.eps)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    x = x + p.mm(_attend(q, k, v, causal=True).reshape(T, -1), w["dec.o"][l])
    h = rms_norm(x, w["dec.ln2"][l], m.eps)
    return x + p.mm(F.silu(p.mm(h, w["dec.gate"][l])) * p.mm(h, w["dec.up"][l]), w["dec.down"][l])


def decoder_hidden(w, m: Dims, x: torch.Tensor, p: Precision = EXACT) -> torch.Tensor:
    """Causal forward of embeddings (T, D) through every layer and the
    final norm."""
    cos, sin = rope(m, x.shape[0], x.device)
    for l in range(m.L):
        x = decoder_layer(w, m, x, l, cos, sin, p)
    return rms_norm(x, w["dec.norm"], m.eps)


def head(w, m: Dims, h: torch.Tensor, p: Precision = EXACT) -> torch.Tensor:
    W = w["dec.embed"].T if m.tied else w["dec.head"]
    return p.mm(h, W)


def served_logits(w, m: Dims, ids: torch.Tensor, mel: Optional[torch.Tensor], start: int,
                  served: torch.Tensor, p: Precision = EXACT) -> torch.Tensor:
    """Logits (n, V) at the positions that predict each of the ``n`` served
    tokens: the prompt ``ids`` (audio from ``mel`` over its placeholders at
    ``start``) followed by the served tokens but the last."""
    audio = audio_tokens(w, m, mel, p) if mel is not None else None
    seq = torch.cat([ids.long(), served[:-1].long()])
    hid = decoder_hidden(w, m, embed(w, m, seq, audio, start), p)
    P = ids.shape[0]
    return head(w, m, hid[P - 1:], p)


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's
    best, per position."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tokens.long()[:, None])[:, 0]


def kl_rows(s_logits: torch.Tensor, t_logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """KL(teacher || student) per row at ``temperature``."""
    s = torch.log_softmax(s_logits / temperature, dim=-1)
    t = torch.log_softmax(t_logits / temperature, dim=-1)
    return (t.exp() * (t - s)).sum(dim=-1)
