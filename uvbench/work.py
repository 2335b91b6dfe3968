"""Operations and bytes that the inputs need, from shapes and lengths: the
work each MFU and roofline share divides by. Counts are the same whichever
kernel or library call does the work, count real tokens and valid frames
(never padding) and count each input byte read once and each output byte
written once. Products are two operations per multiply-add; attention's
QK^T and PV are 4 * heads * head_size operations per visible (query, key)
pair forward, 8 backward (dQ, dK, dV and dP). bfloat16 weights and caches:
2 bytes an element."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

from uvbench.peaks import least_s
from uvbench.weights import Dims

BYTES = 2  # bfloat16


@dataclass
class Work:
    flops: float = 0.0
    nbytes: float = 0.0

    def __iadd__(self, o: "Work") -> "Work":
        self.flops += o.flops
        self.nbytes += o.nbytes
        return self

    def least_s(self) -> float:
        return least_s(self.flops, self.nbytes)


# -- parameter counts ---------------------------------------------------------


def dec_layer_params(m: Dims) -> int:
    nq, nkv = m.Hq * m.Dh, m.Hkv * m.Dh
    return m.D * (nq + 2 * nkv) + nq * m.D + 3 * m.D * m.I


def enc_layer_params(m: Dims) -> int:
    return 4 * m.d * m.d + 2 * m.d * m.f


def proj_params(m: Dims) -> int:
    return m.d * m.stack * m.proj_hidden + m.proj_hidden // 2 * m.D


def kv_bytes_per_token(m: Dims) -> int:
    """Keys and values of one position in every decoder layer."""
    return m.L * 2 * m.Hkv * m.Dh * BYTES


def dec_weight_bytes(m: Dims) -> int:
    """The decoder's layers and head (the embedding rows read are few)."""
    return (m.L * dec_layer_params(m) + m.D * m.V) * BYTES


# -- serving ------------------------------------------------------------------


def encoder_call(m: Dims, frames: int) -> Work:
    """Audio tower and projector over ``frames`` valid mel frames."""
    T = frames // 2
    conv = 2 * 3 * (frames * m.n_mels * m.d + T * m.d * m.d)
    layers = m.Le * (2 * T * enc_layer_params(m) + 4 * T * T * m.d)
    proj = 2 * (-(-T // m.stack)) * proj_params(m)
    weights = (m.Le * enc_layer_params(m) + 3 * m.d * (m.n_mels + m.d) + proj_params(m)) * BYTES
    io = (frames * m.n_mels + (-(-T // m.stack)) * m.D) * BYTES
    return Work(conv + layers + proj, weights + io)


def attn_pairs(start: int, n: int) -> int:
    """Visible (query, key) pairs of ``n`` causal queries at positions
    start .. start + n - 1 (each sees itself and everything before)."""
    return n * start + n * (n + 1) // 2


def prefill(m: Dims, start: int, n: int, chunk: int) -> Work:
    """The decoder over ``n`` new prompt positions after ``start`` reused
    ones, in chunks of ``chunk``: products and attention, the head on the
    last position; the weights read once a chunk, the visible keys and
    values once a chunk, the new keys and values written once."""
    w = Work()
    for c0 in range(0, n, chunk):
        c = min(chunk, n - c0)
        w += Work(2 * m.L * dec_layer_params(m) * c + 4 * m.L * m.Hq * m.Dh * attn_pairs(start + c0, c),
                  m.L * dec_layer_params(m) * BYTES + (start + c0 + c) * kv_bytes_per_token(m))
    w += Work(2 * m.D * m.V, m.D * m.V * BYTES)
    return w


def prefill_attention(m: Dims, start: int, n: int, chunk: int) -> float:
    """Least seconds of the prefill attention kernel's calls (one a layer a
    chunk): each call bound by its own operations or bytes."""
    s = 0.0
    for c0 in range(0, n, chunk):
        c = min(chunk, n - c0)
        kv = start + c0 + c
        flops = 4 * m.Hq * m.Dh * attn_pairs(start + c0, c)
        nbytes = (2 * c * m.Hq * m.Dh + 2 * kv * m.Hkv * m.Dh) * BYTES
        s += m.L * least_s(flops, nbytes)
    return s


def decode_tokens(m: Dims, contexts: Iterable[int]) -> Work:
    """Per decoded token (``contexts``: the keys each one attends to): its
    products, head and attention operations and its keys and values read;
    the weights are counted per step apart (``decode_steps``)."""
    w = Work()
    per_tok = 2 * m.L * dec_layer_params(m) + 2 * m.D * m.V
    for c in contexts:
        w += Work(per_tok + 4 * m.L * m.Hq * m.Dh * c, c * kv_bytes_per_token(m))
    return w


def decode_steps(m: Dims, steps: int) -> Work:
    return Work(0.0, steps * dec_weight_bytes(m))


def decode_attention_bytes(m: Dims, contexts: Iterable[int]) -> float:
    return float(sum(contexts)) * kv_bytes_per_token(m)


# -- training -----------------------------------------------------------------


@dataclass
class Row:
    """One training row: valid mel frames, student and teacher tokens, and
    the positions the KL loss predicts (labelled tokens, shared by both
    streams)."""

    frames: int
    student: int
    teacher: int
    predicted: int


def train_micro_step(m: Dims, rows: Sequence[Row]) -> float:
    """Model operations of one KL micro-step (no remat recompute, no
    padding): the encoder forward and its input gradient (frozen weights,
    LoRA adapters trained), the projector forward and both gradients, the
    student decoder forward and input gradient, the teacher forward, the
    student's head forward and input gradient and the teacher's head
    forward over the predicted positions (and the end-of-turn row the loss
    adds), attention at its visible pairs."""
    lin_e, lin_d = enc_layer_params(m), dec_layer_params(m)
    lora = 2 * 2 * m.d * m.lora_r * len(m.lora_targets) if m.lora_r else 0
    total = 0.0
    for r in rows:
        T = r.frames // 2
        enc_f = 2 * T * (m.Le * lin_e) + 2 * 3 * (r.frames * m.n_mels * m.d + T * m.d * m.d)
        enc_a = m.Le * 4 * T * T * m.d
        total += 2 * enc_f + 3 * enc_a + 3 * T * m.Le * lora
        total += 3 * 2 * (-(-T // m.stack)) * proj_params(m)
        s_a = m.L * 4 * m.Hq * m.Dh * attn_pairs(0, r.student)
        t_a = m.L * 4 * m.Hq * m.Dh * attn_pairs(0, r.teacher)
        total += 2 * (2 * r.student * m.L * lin_d) + 3 * s_a
        total += 2 * r.teacher * m.L * lin_d + t_a
        heads = r.predicted + 1
        total += 3 * 2 * m.D * m.V * heads
    return total

