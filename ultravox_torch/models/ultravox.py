"""The composite model: encoder -> projector -> embedding splice -> LLM,
and the training losses (cross-entropy, or KL distillation against the
text-only teacher, each dense or with the vocabulary projected in chunks).

The losses use fixed-shape masked reductions: masked rows are compacted by
index writes into a buffer with one spare slot that is dropped, never by
selecting with a boolean mask (which would make the host wait for the
card). The chunked losses checkpoint each chunk, so only one chunk's
(chunk, V) fp32 logits live at a time, in the forward and in the backward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ultravox_torch.models import decoder as decoder_lib
from ultravox_torch.models import projector as projector_lib
from ultravox_torch.models import whisper_encoder as encoder_lib
from ultravox_torch.models.config import LossConfig, LossFunction, UltravoxConfig
from ultravox_torch.models.remat import remat as _remat

Params = Dict[str, Any]


def init_params(
    cfg: UltravoxConfig, generator: torch.Generator, dtype=torch.float32, device=None
) -> Params:
    """Seeded random parameters in the JAX package's tree layout
    (``language_model``, ``audio_tower``, ``projector``). The generator must
    live on ``device``; the draws differ from the JAX package's."""
    params: Params = {
        "language_model": decoder_lib.init_params(cfg.text_config, generator, dtype, device),
    }
    if not cfg.llm_only_training:
        params["audio_tower"] = encoder_lib.init_params(cfg.audio_config, generator, dtype, device)
        params["projector"] = projector_lib.init_params(cfg, generator, dtype, device)
    return params


def splice_audio_embeds(
    inputs_embeds: torch.Tensor,  # (B, T, D)
    audio_embeds: torch.Tensor,  # (N, T_a, D), N audio chunks across the batch
    audio_token_start_idx: torch.Tensor,  # (N,)
    audio_token_len: torch.Tensor,  # (N,)
    audio_chunk_batch_idx: torch.Tensor,  # (N,) batch row of each chunk
) -> torch.Tensor:
    """Overwrite each chunk's placeholder span with its first
    ``audio_token_len`` audio embeddings. Destinations outside the batch are
    dropped: they land in one spare row past the batch, so the write needs no
    host-side selection (which would wait for the card). The reference
    writes the same values through a one-hot matmul."""
    B, T, D = inputs_embeds.shape
    N, Ta, _ = audio_embeds.shape
    dev = inputs_embeds.device
    t = torch.arange(Ta, device=dev)
    dest = (
        audio_chunk_batch_idx.long()[:, None] * T
        + audio_token_start_idx.long()[:, None]
        + t[None]
    )
    valid = (t[None] < audio_token_len.long()[:, None]) & (dest >= 0) & (dest < B * T)
    out = torch.cat([inputs_embeds.reshape(B * T, D), inputs_embeds.new_zeros((1, D))])
    out[torch.where(valid, dest, B * T).reshape(-1)] = audio_embeds.reshape(N * Ta, D).to(out.dtype)
    return out[: B * T].reshape(B, T, D)


def encode_audio(
    params: Params,
    cfg: UltravoxConfig,
    audio_values: torch.Tensor,  # (N, n_mels, T_mel)
    audio_lens: torch.Tensor,  # (N,) valid mel frames
    *,
    remat: bool = False,
    encoder_attn_impl: str = "xla",
) -> torch.Tensor:
    """Audio token embeddings (N, T_a, D) of each chunk: audio tower +
    projector, in ``audio_values``' dtype (what ``ServingEngine.submit``
    takes as precomputed ``audio_embeds``)."""
    enc = encoder_lib.encoder_forward(
        params["audio_tower"],
        cfg.audio_config,
        audio_values,
        mel_lens=audio_lens,
        latency_block_size=cfg.audio_latency_block_size,
        remat=remat,
        attn_impl=encoder_attn_impl,
    )
    return projector_lib.projector_forward(params["projector"], cfg, enc)


def prepare_audio_embeds(
    params: Params,
    cfg: UltravoxConfig,
    inputs_embeds: torch.Tensor,
    audio_values: torch.Tensor,  # (N, n_mels, T_mel)
    audio_lens: torch.Tensor,  # (N,) valid mel frames
    audio_token_start_idx: torch.Tensor,
    audio_token_len: torch.Tensor,
    audio_chunk_batch_idx: torch.Tensor,
    *,
    remat: bool = False,
    encoder_attn_impl: str = "xla",
) -> torch.Tensor:
    """Audio tower + projector + splice."""
    audio_embeds = encode_audio(
        params, cfg, audio_values.to(inputs_embeds.dtype), audio_lens,
        remat=remat, encoder_attn_impl=encoder_attn_impl,
    )
    return splice_audio_embeds(
        inputs_embeds, audio_embeds, audio_token_start_idx, audio_token_len,
        audio_chunk_batch_idx,
    )


def ultravox_embed(
    params: Params,
    cfg: UltravoxConfig,
    input_ids: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    *,
    remat: bool = False,
    encoder_attn_impl: str = "xla",
) -> torch.Tensor:
    """Token embeddings with audio spliced in when the batch carries audio."""
    inputs_embeds = decoder_lib.embed_lookup(params["language_model"], input_ids)
    if batch.get("audio_values") is not None:
        inputs_embeds = prepare_audio_embeds(
            params, cfg, inputs_embeds,
            batch["audio_values"], batch["audio_lens"],
            batch["audio_token_start_idx"], batch["audio_token_len"],
            batch["audio_chunk_batch_idx"],
            remat=remat, encoder_attn_impl=encoder_attn_impl,
        )
    return inputs_embeds


def ultravox_forward(
    params: Params,
    cfg: UltravoxConfig,
    batch: Dict[str, torch.Tensor],
    *,
    remat: bool = False,
    attn_impl: str = "xla",  # "flash" = the differentiable kernel in both towers
    return_hidden: bool = False,  # final hidden states instead of logits
    pipe_mesh=None,
) -> torch.Tensor:
    """Full-sequence forward: fp32 logits (B, T, V), or with
    ``return_hidden`` the final hidden states (B, T, D) for the chunked
    losses. ``batch``: input_ids, attention_mask (right-padded) and
    optionally the audio fields of ``ultravox_embed``."""
    if pipe_mesh is not None:
        raise NotImplementedError("pipeline-parallel decoders are not ported yet")
    input_ids = batch["input_ids"]
    inputs_embeds = ultravox_embed(
        params, cfg, input_ids, batch, remat=remat,
        encoder_attn_impl="flash" if attn_impl == "flash" else "xla",
    )
    B, T = input_ids.shape
    positions = torch.arange(T, device=inputs_embeds.device)[None].expand(B, T)
    seq_lens = batch["attention_mask"].sum(dim=-1).to(torch.int32)
    out, _ = decoder_lib.decoder_forward(
        params["language_model"], cfg.text_config, inputs_embeds=inputs_embeds,
        positions=positions, kv_valid_len=seq_lens, remat=remat, attn_impl=attn_impl,
        return_hidden=return_hidden,
    )
    return out


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def _detached(tree):
    """The parameter tree cut from autograd (the reference's stop_gradient)."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def causal_lm_loss(
    logits: torch.Tensor,  # (B, T, V) fp32
    labels: torch.Tensor,  # (B, T) with -100 = ignored
) -> torch.Tensor:
    """Mean next-token cross-entropy over the non-ignored positions."""
    shift_labels = labels[:, 1:]
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, 0).long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def _chunks(x: torch.Tensor, chunk: int, fill) -> torch.Tensor:
    """(N, ...) -> (n_chunks, chunk, ...), the tail padded with ``fill``."""
    N = x.shape[0]
    n = -(-N // chunk)
    if n * chunk != N:
        pad = x.new_full((n * chunk - N, *x.shape[1:]), fill)
        x = torch.cat([x, pad])
    return x.reshape(n, chunk, *x.shape[1:])


def chunked_nll_sums(
    lm_params: Params,
    tc,
    hidden: torch.Tensor,  # (B, T, D) final hidden states
    labels: torch.Tensor,  # (B, T) with -100 = ignored
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of next-token NLL, count of supervised positions) from hidden
    states, projecting to the vocabulary ``chunk`` positions at a time
    (each chunk checkpointed): the (B, T, V) logits never exist. The same
    fp32 logsumexp as the dense loss."""
    D = hidden.shape[-1]
    hs = _chunks(hidden[:, :-1].reshape(-1, D), chunk, 0)
    lbl = _chunks(labels[:, 1:].reshape(-1), chunk, -100)

    def body(h_c, l_c):
        logits = decoder_lib.compute_logits(lm_params, tc, h_c)  # (chunk, V)
        lse = torch.logsumexp(logits, dim=-1)
        valid = l_c != -100
        safe = torch.where(valid, l_c, 0).long()
        lbl_logit = torch.gather(logits, -1, safe[:, None])[:, 0]
        return torch.where(valid, lse - lbl_logit, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(hs.shape[0]):
        total = total + _remat(body, hs[i], lbl[i])
    return total, (lbl != -100).sum()


def causal_lm_loss_chunked(lm_params: Params, tc, hidden, labels, *, chunk: int = 128):
    """Mean next-token CE over supervised positions (see chunked_nll_sums)."""
    s, c = chunked_nll_sums(lm_params, tc, hidden, labels, chunk=chunk)
    return s / c.clamp(min=1)


def prediction_masks(labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred_mask, eot_mask): positions predicting a labelled token, and the
    last such position per row, as fixed-shape boolean arrays."""
    label_mask = labels != -100
    pred_mask = torch.cat([label_mask[:, 1:], torch.zeros_like(label_mask[:, :1])], dim=1)
    idx = torch.arange(labels.shape[1], device=labels.device)[None]
    last = torch.where(pred_mask, idx, -1).amax(dim=1)  # (B,)
    eot_mask = (idx == last[:, None]) & (last[:, None] >= 0)
    return pred_mask, eot_mask


def _compact_rows(x: torch.Tensor, mask: torch.Tensor, length: int) -> torch.Tensor:
    """Stable compaction of masked rows: the k-th True position of row b
    lands at [b, k], in x's dtype. Unmasked positions and those past
    ``length`` go to one spare slot, which is dropped. (B, T, D) -> (B,
    length, D)."""
    B = mask.shape[0]
    order = torch.cumsum(mask.long(), dim=1) - 1
    slots = torch.where(mask, order, length).clamp(max=length)
    bidx = torch.arange(B, device=mask.device)[:, None].expand_as(slots)
    out = x.new_zeros((B, length + 1, x.shape[-1]))
    return out.index_put((bidx, slots), x, accumulate=True)[:, :length]


def _common_rows(s_mask: torch.Tensor, t_mask: torch.Tensor, length: int) -> torch.Tensor:
    """(B, length) bool: compacted slots that both streams fill. The
    reference assumes equal masked counts; a mismatch must not pair student
    rows with all-zero teacher rows."""
    n_common = torch.minimum(s_mask.sum(dim=1), t_mask.sum(dim=1))
    return torch.arange(length, device=s_mask.device)[None] < n_common[:, None]


def _kl_rows(s_logits, t_logits, temperature: float) -> torch.Tensor:
    s_logp = torch.log_softmax(s_logits / temperature, dim=-1)
    t_logp = torch.log_softmax(t_logits / temperature, dim=-1)
    return (torch.exp(t_logp) * (t_logp - s_logp)).sum(dim=-1)


def _masked_kl(
    student_logits: torch.Tensor,  # (B, T, V)
    teacher_logits: torch.Tensor,  # (B, T2, V)
    s_mask: torch.Tensor,  # (B, T) bool
    t_mask: torch.Tensor,  # (B, T2) bool
    temperature: float,
) -> torch.Tensor:
    """KL(teacher || student) with torch kl_div 'batchmean' semantics: the
    sum of per-position KLs over the number of masked positions, the two
    streams realigned to a common compacted index."""
    R = min(student_logits.shape[1], teacher_logits.shape[1])
    s = _compact_rows(student_logits.float(), s_mask, R)
    t = _compact_rows(teacher_logits.float(), t_mask, R)
    row_valid = _common_rows(s_mask, t_mask, R)
    kl = torch.where(row_valid, _kl_rows(s, t, temperature), 0.0)
    return kl.sum() / row_valid.sum().clamp(min=1)


def _masked_kl_chunked(
    lm_s: Params,
    lm_t: Params,
    tc,
    h_s: torch.Tensor,  # (B, T, D) student hidden
    h_t: torch.Tensor,  # (B, T2, D) teacher hidden
    s_mask: torch.Tensor,
    t_mask: torch.Tensor,
    temperature: float,
    *,
    rows: Optional[int] = None,
    chunk: int = 128,
) -> torch.Tensor:
    """``_masked_kl`` with the vocabulary projected lazily: both streams'
    hidden states are compacted to the common masked rows (B, rows, D),
    and the logits exist one checkpointed ``chunk`` of rows at a time."""
    D = h_s.shape[-1]
    R = min(h_s.shape[1], h_t.shape[1]) if rows is None else rows
    sf = _compact_rows(h_s, s_mask, R).reshape(-1, D)
    tf = _compact_rows(h_t, t_mask, R).reshape(-1, D)
    row_valid = _common_rows(s_mask, t_mask, R).reshape(-1)
    ch = min(chunk, sf.shape[0])
    sf, tf, rv = _chunks(sf, ch, 0), _chunks(tf, ch, 0), _chunks(row_valid, ch, False)

    def body(s_c, t_c, v_c):
        kl = _kl_rows(decoder_lib.compute_logits(lm_s, tc, s_c),
                      decoder_lib.compute_logits(lm_t, tc, t_c), temperature)
        return torch.where(v_c, kl, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=h_s.device)
    for i in range(sf.shape[0]):
        total = total + _remat(body, sf[i], tf[i], rv[i])
    return total / row_valid.sum().clamp(min=1)


def kl_distillation_loss_chunked(
    lm_params: Params,
    tc,
    student_hidden: torch.Tensor,  # (B, T, D)
    labels: torch.Tensor,
    teacher_hidden: torch.Tensor,  # (B, T2, D), computed without gradient
    alt_labels: torch.Tensor,
    loss_config: LossConfig,
    *,
    chunk: int = 128,
) -> torch.Tensor:
    """``kl_distillation_loss`` from hidden states (see _masked_kl_chunked);
    the EOT term compacts to one row per sequence. The teacher's head
    projection takes detached weights."""
    lm_teacher = _detached(lm_params)
    pred_mask, eot_mask = prediction_masks(labels)
    alt_pred_mask, alt_eot_mask = prediction_masks(alt_labels)
    temp = loss_config.kl_temperature
    loss = _masked_kl_chunked(lm_params, lm_teacher, tc, student_hidden, teacher_hidden,
                              pred_mask, alt_pred_mask, temp, chunk=chunk)
    if loss_config.eot_loss_weight > 0:
        loss = loss + loss_config.eot_loss_weight * _masked_kl_chunked(
            lm_params, lm_teacher, tc, student_hidden, teacher_hidden, eot_mask, alt_eot_mask,
            temp, rows=1, chunk=chunk,
        )
    return loss


def kl_distillation_loss(
    student_logits: torch.Tensor,
    labels: torch.Tensor,
    teacher_logits: torch.Tensor,
    alt_labels: torch.Tensor,
    loss_config: LossConfig,
) -> torch.Tensor:
    """Audio-student vs text-teacher loss: batchmean KL at ``kl_temperature``
    over prediction positions, plus ``eot_loss_weight`` times the same KL
    restricted to the EOT position."""
    pred_mask, eot_mask = prediction_masks(labels)
    alt_pred_mask, alt_eot_mask = prediction_masks(alt_labels)
    temp = loss_config.kl_temperature
    loss = _masked_kl(student_logits, teacher_logits, pred_mask, alt_pred_mask, temp)
    if loss_config.eot_loss_weight > 0:
        loss = loss + loss_config.eot_loss_weight * _masked_kl(
            student_logits, teacher_logits, eot_mask, alt_eot_mask, temp)
    return loss


def ultravox_loss(
    params: Params,
    cfg: UltravoxConfig,
    batch: Dict[str, torch.Tensor],
    loss_config: LossConfig,
    *,
    remat: bool = False,
    attn_impl: str = "xla",
    vocab_chunk: Optional[int] = None,
    pipe_mesh=None,
) -> torch.Tensor:
    """Training loss: CE, or KL distillation against the text-only teacher
    (the same LLM weights on the alt_* token stream, run without gradient).
    ``vocab_chunk`` computes the loss from hidden states, projecting to the
    vocabulary ``vocab_chunk`` positions at a time; the same value and
    gradients as the dense path."""
    chunked = vocab_chunk is not None and vocab_chunk > 0
    out = ultravox_forward(params, cfg, batch, remat=remat, attn_impl=attn_impl,
                           return_hidden=chunked, pipe_mesh=pipe_mesh)
    lm = params["language_model"]
    if loss_config.loss_function == LossFunction.CROSS_ENTROPY:
        if chunked:
            return causal_lm_loss_chunked(lm, cfg.text_config, out, batch["labels"],
                                          chunk=vocab_chunk)
        return causal_lm_loss(out, batch["labels"])

    alt_ids = batch["alt_input_ids"]
    B, T2 = alt_ids.shape
    with torch.no_grad():
        teacher_out, _ = decoder_lib.decoder_forward(
            _detached(lm), cfg.text_config, input_ids=alt_ids,
            positions=torch.arange(T2, device=alt_ids.device)[None].expand(B, T2),
            kv_valid_len=batch["alt_attention_mask"].sum(dim=-1).to(torch.int32),
            remat=remat, attn_impl=attn_impl, return_hidden=chunked,
        )
    if chunked:
        return kl_distillation_loss_chunked(lm, cfg.text_config, out, batch["labels"],
                                            teacher_out, batch["alt_labels"], loss_config,
                                            chunk=vocab_chunk)
    return kl_distillation_loss(out, batch["labels"], teacher_out, batch["alt_labels"],
                                loss_config)
