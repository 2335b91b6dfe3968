"""The composite model: encoder -> projector -> embedding splice -> LLM,
and the training losses (cross-entropy, or KL distillation against the
text-only teacher, each dense or with the vocabulary projected in chunks).

In a multi-process run each process holds its own rows of the global
batch (``parallel/multihost.py``): given the processes' ``batch_group``, a
loss divides its local sum by the count summed over the group, so the
processes' losses (and gradients) add up to the one loss over the global
batch, as the JAX package computes it. Tensor and pipe peers hold the
same rows and are not in that group, so they are counted once. The processes of the group
run the audio tower's collectives (its fsdp gathers and reduce-scatters)
alike whatever their own rows carry: when any of them has audio, one without
runs the tower and the projector on a dummy chunk whose output enters
nothing but a zero (``ultravox_embed``).

With ``pipe_mesh`` the decoder layer stack runs over the mesh's pipeline
stages (``parallel/pipeline.py``), the student's and the KL teacher's.
The encoder, projector and embedding stay outside the pipeline and run on
every stage (pipe peers hold the same rows); only stage 0's enter it. The
final hidden states are the last stage's, and so is the loss: the other
stages' loss is a zero tied to their pipeline output, so that their
backward schedule runs; the train step sums the metrics over ``pipe``.

The losses use fixed-shape masked reductions: masked rows are compacted by
index writes into a buffer with one spare slot that is dropped, never by
selecting with a boolean mask (which would make the host wait for the
card). The chunked losses checkpoint each chunk, so only one chunk's
(chunk, V) fp32 logits live at a time, in the forward and in the backward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ultravox_torch.models import decoder as decoder_lib
from ultravox_torch.models import projector as projector_lib
from ultravox_torch.models import wav2vec2_encoder as w2v_lib
from ultravox_torch.models import whisper_encoder as encoder_lib
from ultravox_torch.models.config import LossConfig, LossFunction, UltravoxConfig
from ultravox_torch.models.remat import remat as _remat
from ultravox_torch.parallel.pipeline import pipelined_decoder_hidden
from ultravox_torch.parallel.sharding import all_reduce_, carry_shard

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
        tower_lib = w2v_lib if cfg.audio_arch == "wav2vec2" else encoder_lib
        params["audio_tower"] = tower_lib.init_params(cfg.audio_config, generator, dtype, device)
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
    audio_values: torch.Tensor,  # (N, n_mels, T_mel), or (N, 1, T_samples) for wav2vec2
    audio_lens: torch.Tensor,  # (N,) valid mel frames (samples for wav2vec2)
    *,
    remat: bool = False,
    encoder_attn_impl: str = "xla",
) -> torch.Tensor:
    """Audio token embeddings (N, T_a, D) of each chunk: audio tower +
    projector, in ``audio_values``' dtype (what ``ServingEngine.submit``
    takes as precomputed ``audio_embeds``). The wav2vec2 tower takes raw
    samples and ignores ``remat`` and ``encoder_attn_impl``, as in the JAX
    package: its attention is the plain ``mha``."""
    if cfg.audio_arch == "wav2vec2":
        if cfg.audio_latency_block_size:
            raise ValueError("only the whisper audio tower supports latency masking")
        enc = w2v_lib.encoder_forward(
            params["audio_tower"], cfg.audio_config, audio_values[:, 0, :], sample_lens=audio_lens)
    else:
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
    audio_values: torch.Tensor,  # (N, n_mels, T_mel), or (N, 1, T_samples)
    audio_lens: torch.Tensor,  # (N,) valid mel frames (or samples)
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


def _any_audio(has_audio: bool, device, group) -> bool:
    """Whether any process of ``group`` has audio in its rows."""
    flag = torch.tensor([int(has_audio)], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def dummy_audio_chunk(cfg: UltravoxConfig, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One short chunk of zeros as the tower takes it: (1, n_mels, 16) mel
    frames, or (1, 1, 800) samples for wav2vec2, and its length."""
    if cfg.audio_arch == "wav2vec2":
        values = torch.zeros((1, 1, 800), dtype=dtype, device=device)
    else:
        values = torch.zeros((1, cfg.audio_config.num_mel_bins, 16), dtype=dtype, device=device)
    return values, torch.full((1,), values.shape[-1], dtype=torch.int32, device=device)


def ultravox_embed(
    params: Params,
    cfg: UltravoxConfig,
    input_ids: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    *,
    remat: bool = False,
    encoder_attn_impl: str = "xla",
    batch_group=None,
) -> torch.Tensor:
    """Token embeddings with audio spliced in when the batch carries audio.
    With ``batch_group``, a process without audio whose group has some
    runs the tower and the projector on ``dummy_audio_chunk``, so that it
    issues the same collectives as the others; the output is not spliced
    and adds exactly zero to the embeddings (and so to the loss and every
    gradient), times 0 so that the backward still runs through it."""
    inputs_embeds = decoder_lib.embed_lookup(params["language_model"], input_ids)
    has_audio = batch.get("audio_values") is not None
    dummy = (batch_group is not None and "audio_tower" in params
             and _any_audio(has_audio, inputs_embeds.device, batch_group) and not has_audio)
    if has_audio:
        inputs_embeds = prepare_audio_embeds(
            params, cfg, inputs_embeds,
            batch["audio_values"], batch["audio_lens"],
            batch["audio_token_start_idx"], batch["audio_token_len"],
            batch["audio_chunk_batch_idx"],
            remat=remat, encoder_attn_impl=encoder_attn_impl,
        )
    elif dummy:
        values, lens = dummy_audio_chunk(cfg, inputs_embeds.dtype, inputs_embeds.device)
        out = encode_audio(params, cfg, values, lens, remat=remat,
                           encoder_attn_impl=encoder_attn_impl)
        inputs_embeds = inputs_embeds + (out.sum() * 0).to(inputs_embeds.dtype)
    return inputs_embeds


def ultravox_forward(
    params: Params,
    cfg: UltravoxConfig,
    batch: Dict[str, torch.Tensor],
    *,
    remat: bool = False,
    attn_impl: str = "xla",  # "flash" = the differentiable kernel in both towers
    return_hidden: bool = False,  # final hidden states instead of logits
    pipe_mesh=None,  # a Mesh with pipe > 1: GPipe the decoder layer stack
    pipe_micro: Optional[int] = None,
    batch_group=None,  # the processes splitting the batch (ultravox_embed)
) -> torch.Tensor:
    """Full-sequence forward: fp32 logits (B, T, V), or with
    ``return_hidden`` the final hidden states (B, T, D) for the chunked
    losses. ``batch``: input_ids, attention_mask (right-padded) and
    optionally the audio fields of ``ultravox_embed``. With ``pipe_mesh``
    (every stage calls it) the output is the last stage's; the other
    stages get the head applied to zeros (see the module docstring)."""
    input_ids = batch["input_ids"]
    inputs_embeds = ultravox_embed(
        params, cfg, input_ids, batch, remat=remat,
        encoder_attn_impl="flash" if attn_impl == "flash" else "xla", batch_group=batch_group,
    )
    B, T = input_ids.shape
    positions = torch.arange(T, device=inputs_embeds.device)[None].expand(B, T)
    seq_lens = batch["attention_mask"].sum(dim=-1).to(torch.int32)
    if _pipelined(pipe_mesh):
        hidden = pipelined_decoder_hidden(
            params["language_model"], cfg.text_config, inputs_embeds, positions, seq_lens,
            mesh=pipe_mesh, n_micro=pipe_micro, remat=remat)
        if return_hidden:
            return hidden
        return decoder_lib.compute_logits(params["language_model"], cfg.text_config, hidden)
    out, _ = decoder_lib.decoder_forward(
        params["language_model"], cfg.text_config, inputs_embeds=inputs_embeds,
        positions=positions, kv_valid_len=seq_lens, remat=remat, attn_impl=attn_impl,
        return_hidden=return_hidden,
    )
    return out


def _pipelined(pipe_mesh) -> bool:
    return pipe_mesh is not None and pipe_mesh.shape.get("pipe", 1) > 1


def computes_loss(pipe_mesh) -> bool:
    """Whether this process computes the loss: every process without
    pipeline stages, else the last stage alone."""
    return not _pipelined(pipe_mesh) or pipe_mesh.stage == pipe_mesh.n_stages - 1


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def _detached(tree):
    """The parameter tree cut from autograd (the reference's stop_gradient),
    fsdp shards still tagged as shards."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return carry_shard(tree, tree.detach())


def _global(count: torch.Tensor, group) -> torch.Tensor:
    """``count`` summed over the processes of ``group`` (those splitting
    the batch); ``count`` itself without one."""
    return count if group is None else all_reduce_(count.clone(), group)


def causal_lm_loss(
    logits: torch.Tensor,  # (B, T, V) fp32
    labels: torch.Tensor,  # (B, T) with -100 = ignored
    batch_group=None,
) -> torch.Tensor:
    """Mean next-token cross-entropy over the non-ignored positions (of
    the global batch, with ``batch_group``)."""
    shift_labels = labels[:, 1:]
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, 0).long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / _global(valid.sum(), batch_group).clamp(min=1)


def _chunks(x: torch.Tensor, chunk: int, fill) -> torch.Tensor:
    """(N, ...) -> (n_chunks, chunk, ...), the tail padded with ``fill``."""
    N = x.shape[0]
    n = -(-N // chunk)
    if n * chunk != N:
        pad = x.new_full((n * chunk - N, *x.shape[1:]), fill)
        x = torch.cat([x, pad])
    return x.reshape(n, chunk, *x.shape[1:])


# --- the chunked losses on this rank's vocabulary slice ---------------------
#
# With the head split over ``tensor`` (Megatron's vocabulary-parallel
# losses) each rank holds logits of its slice alone: a row's max, its sum of
# exponentials and the label's logit are all-reduced over the group, and
# the loss is a value every peer holds alike. The gradient of the local
# logits needs no collective: the head's product (``to_tensor``) adds the
# peers' parts of the hidden state's gradient once. A rank that holds the
# whole vocabulary takes autograd's path through the same formulas, so its
# gradients round as they always have.


def _log_softmax(x: torch.Tensor, group) -> torch.Tensor:
    """log-softmax over the whole vocabulary of this rank's slice ``x``
    (rows, V_local), from the max and the sum of exponentials all-reduced."""
    m = all_reduce_(x.amax(dim=-1), group, op=dist.ReduceOp.MAX)
    shifted = x - m[:, None]
    z = all_reduce_(torch.exp(shifted).sum(dim=-1), group)
    return shifted - torch.log(z)[:, None]


class _VocabNLL(torch.autograd.Function):
    """Per-row NLL of ``labels`` (-100 = none) from this rank's slice of
    the logits (rows, V_local), whose first id is ``offset``; the
    gradient is softmax - onehot on the slice."""

    @staticmethod
    def forward(ctx, logits, labels, offset: int, group):
        logp = _log_softmax(logits, group)
        valid = labels != -100
        local = labels.long() - offset
        mine = valid & (local >= 0) & (local < logits.shape[-1])
        local = torch.where(mine, local, 0)[:, None]
        picked = torch.where(mine, torch.gather(logp, -1, local)[:, 0], 0.0)
        nll = -all_reduce_(picked, group)
        ctx.save_for_backward(logp, local, mine, valid)
        return torch.where(valid, nll, 0.0)

    @staticmethod
    def backward(ctx, g):
        logp, local, mine, valid = ctx.saved_tensors
        g = torch.where(valid, g, 0.0)
        grad = torch.exp(logp) * g[:, None]
        grad.scatter_add_(-1, local, -torch.where(mine, g, 0.0)[:, None])
        return grad, None, None, None


class _VocabKL(torch.autograd.Function):
    """Per-row KL(teacher || student) at ``temperature`` from this rank's
    slices of both streams' logits; the teacher takes no gradient, the
    student's slice (p_s * sum(p_t) - p_t) / T."""

    @staticmethod
    def forward(ctx, s_logits, t_logits, temperature: float, group):
        s_logp = _log_softmax(s_logits / temperature, group)
        t_logp = _log_softmax(t_logits / temperature, group)
        p_t = torch.exp(t_logp)
        both = all_reduce_(torch.stack([(p_t * (t_logp - s_logp)).sum(dim=-1),
                                        p_t.sum(dim=-1)]), group)
        ctx.save_for_backward(s_logp, p_t, both[1])
        ctx.temperature = temperature
        return both[0]

    @staticmethod
    def backward(ctx, g):
        s_logp, p_t, p_sum = ctx.saved_tensors
        grad = (torch.exp(s_logp) * p_sum[:, None] - p_t) * (g / ctx.temperature)[:, None]
        return grad, None, None, None


def _nll_rows(logits, labels, offset: int = 0, group=None) -> torch.Tensor:
    """Per-row NLL of ``labels`` (-100 = none, 0) from fp32 logits of the
    whole vocabulary, or with ``group`` of this rank's slice."""
    if group is not None:
        return _VocabNLL.apply(logits, labels, offset, group)
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    lbl_logit = torch.gather(logits, -1, safe[:, None])[:, 0]
    return torch.where(valid, lse - lbl_logit, 0.0)


def _head_group(lm_params: Params, tc):
    """(tensor group, first vocabulary id) of this rank's head slice;
    (None, 0) for a whole head."""
    split = decoder_lib.head_split(lm_params, tc)
    if split is None:
        return None, 0
    return split.group, split.index * (split.full_shape[split.dim] // split.size)


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
    (each chunk checkpointed): the (B, T, V) logits never exist, and with
    a head split over ``tensor`` each rank projects its slice alone
    (``_VocabNLL``)."""
    lm_params = decoder_lib.gathered_head(lm_params, tc)
    group, offset = _head_group(lm_params, tc)
    D = hidden.shape[-1]
    hs = _chunks(hidden[:, :-1].reshape(-1, D), chunk, 0)
    lbl = _chunks(labels[:, 1:].reshape(-1), chunk, -100)

    def body(h_c, l_c):
        logits = decoder_lib.local_logits(lm_params, tc, h_c)  # (chunk, V_local)
        return _nll_rows(logits, l_c, offset, group).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(hs.shape[0]):
        total = total + _remat(body, hs[i], lbl[i])
    return total, (lbl != -100).sum()


def causal_lm_loss_chunked(lm_params: Params, tc, hidden, labels, *, chunk: int = 128,
                           batch_group=None):
    """Mean next-token CE over supervised positions (see chunked_nll_sums)."""
    s, c = chunked_nll_sums(lm_params, tc, hidden, labels, chunk=chunk)
    return s / _global(c, batch_group).clamp(min=1)


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


def _kl_rows(s_logits, t_logits, temperature: float, group=None) -> torch.Tensor:
    """Per-row KL(teacher || student) at ``temperature`` from fp32 logits
    of the whole vocabulary, or with ``group`` of this rank's slice."""
    if group is not None:
        return _VocabKL.apply(s_logits, t_logits, temperature, group)
    s_logp = torch.log_softmax(s_logits / temperature, dim=-1)
    t_logp = torch.log_softmax(t_logits / temperature, dim=-1)
    return (torch.exp(t_logp) * (t_logp - s_logp)).sum(dim=-1)


def _masked_kl(
    student_logits: torch.Tensor,  # (B, T, V)
    teacher_logits: torch.Tensor,  # (B, T2, V)
    s_mask: torch.Tensor,  # (B, T) bool
    t_mask: torch.Tensor,  # (B, T2) bool
    temperature: float,
    batch_group=None,
) -> torch.Tensor:
    """KL(teacher || student) with torch kl_div 'batchmean' semantics: the
    sum of per-position KLs over the number of masked positions, the two
    streams realigned to a common compacted index."""
    R = min(student_logits.shape[1], teacher_logits.shape[1])
    s = _compact_rows(student_logits.float(), s_mask, R)
    t = _compact_rows(teacher_logits.float(), t_mask, R)
    row_valid = _common_rows(s_mask, t_mask, R)
    kl = torch.where(row_valid, _kl_rows(s, t, temperature), 0.0)
    return kl.sum() / _global(row_valid.sum(), batch_group).clamp(min=1)


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
    batch_group=None,
) -> torch.Tensor:
    """``_masked_kl`` with the vocabulary projected lazily: both streams'
    hidden states are compacted to the common masked rows (B, rows, D),
    and the logits exist one checkpointed ``chunk`` of rows at a time, of
    this rank's vocabulary slice. ``lm_s`` and ``lm_t`` carry their heads
    gathered over fsdp (``gathered_head``)."""
    D = h_s.shape[-1]
    R = min(h_s.shape[1], h_t.shape[1]) if rows is None else rows
    sf = _compact_rows(h_s, s_mask, R).reshape(-1, D)
    tf = _compact_rows(h_t, t_mask, R).reshape(-1, D)
    row_valid = _common_rows(s_mask, t_mask, R).reshape(-1)
    ch = min(chunk, sf.shape[0])
    sf, tf, rv = _chunks(sf, ch, 0), _chunks(tf, ch, 0), _chunks(row_valid, ch, False)

    group, _ = _head_group(lm_s, tc)

    def body(s_c, t_c, v_c):
        kl = _kl_rows(decoder_lib.local_logits(lm_s, tc, s_c),
                      decoder_lib.local_logits(lm_t, tc, t_c), temperature, group)
        return torch.where(v_c, kl, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=h_s.device)
    for i in range(sf.shape[0]):
        total = total + _remat(body, sf[i], tf[i], rv[i])
    return total / _global(row_valid.sum(), batch_group).clamp(min=1)


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
    batch_group=None,
) -> torch.Tensor:
    """``kl_distillation_loss`` from hidden states (see _masked_kl_chunked);
    the EOT term compacts to one row per sequence. The teacher's head
    projection takes detached weights."""
    lm_params = decoder_lib.gathered_head(lm_params, tc)
    lm_teacher = _detached(lm_params)
    pred_mask, eot_mask = prediction_masks(labels)
    alt_pred_mask, alt_eot_mask = prediction_masks(alt_labels)
    temp = loss_config.kl_temperature
    loss = _masked_kl_chunked(lm_params, lm_teacher, tc, student_hidden, teacher_hidden,
                              pred_mask, alt_pred_mask, temp, chunk=chunk,
                              batch_group=batch_group)
    if loss_config.eot_loss_weight > 0:
        loss = loss + loss_config.eot_loss_weight * _masked_kl_chunked(
            lm_params, lm_teacher, tc, student_hidden, teacher_hidden, eot_mask, alt_eot_mask,
            temp, rows=1, chunk=chunk, batch_group=batch_group,
        )
    return loss


def kl_distillation_loss(
    student_logits: torch.Tensor,
    labels: torch.Tensor,
    teacher_logits: torch.Tensor,
    alt_labels: torch.Tensor,
    loss_config: LossConfig,
    batch_group=None,
) -> torch.Tensor:
    """Audio-student vs text-teacher loss: batchmean KL at ``kl_temperature``
    over prediction positions, plus ``eot_loss_weight`` times the same KL
    restricted to the EOT position."""
    pred_mask, eot_mask = prediction_masks(labels)
    alt_pred_mask, alt_eot_mask = prediction_masks(alt_labels)
    temp = loss_config.kl_temperature
    loss = _masked_kl(student_logits, teacher_logits, pred_mask, alt_pred_mask, temp,
                      batch_group)
    if loss_config.eot_loss_weight > 0:
        loss = loss + loss_config.eot_loss_weight * _masked_kl(
            student_logits, teacher_logits, eot_mask, alt_eot_mask, temp, batch_group)
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
    pipe_micro: Optional[int] = None,
    batch_group=None,
) -> torch.Tensor:
    """Training loss: CE, or KL distillation against the text-only teacher
    (the same LLM weights on the alt_* token stream, run without gradient).
    ``vocab_chunk`` computes the loss from hidden states, projecting to the
    vocabulary ``vocab_chunk`` positions at a time; the same value and
    gradients as the dense path. With ``batch_group`` (the processes that
    split the batch) the loss is this process's share of the global
    batch's: its local sum over the global count. With ``pipe_mesh`` the
    student and the teacher run pipelined and the loss is the last
    stage's; the other stages return a zero tied to their pipeline."""
    chunked = vocab_chunk is not None and vocab_chunk > 0
    pipe = _pipelined(pipe_mesh)
    out = ultravox_forward(params, cfg, batch, remat=remat, attn_impl=attn_impl,
                           return_hidden=chunked or pipe, pipe_mesh=pipe_mesh,
                           pipe_micro=pipe_micro, batch_group=batch_group)
    lm = params["language_model"]
    last = computes_loss(pipe_mesh)
    if pipe and not chunked and last:
        out = decoder_lib.compute_logits(lm, cfg.text_config, out)
    if loss_config.loss_function == LossFunction.CROSS_ENTROPY:
        if not last:
            return out.float().sum() * 0
        if chunked:
            return causal_lm_loss_chunked(lm, cfg.text_config, out, batch["labels"],
                                          chunk=vocab_chunk, batch_group=batch_group)
        return causal_lm_loss(out, batch["labels"], batch_group)

    alt_ids = batch["alt_input_ids"]
    B, T2 = alt_ids.shape
    positions = torch.arange(T2, device=alt_ids.device)[None].expand(B, T2)
    alt_lens = batch["alt_attention_mask"].sum(dim=-1).to(torch.int32)
    with torch.no_grad():
        if pipe:
            teacher_lm = _detached(lm)
            teacher_out = pipelined_decoder_hidden(
                teacher_lm, cfg.text_config, decoder_lib.embed_lookup(teacher_lm, alt_ids),
                positions, alt_lens, mesh=pipe_mesh, n_micro=pipe_micro, remat=remat)
            if not chunked and last:
                teacher_out = decoder_lib.compute_logits(teacher_lm, cfg.text_config,
                                                         teacher_out)
        else:
            teacher_out, _ = decoder_lib.decoder_forward(
                _detached(lm), cfg.text_config, input_ids=alt_ids, positions=positions,
                kv_valid_len=alt_lens, remat=remat, attn_impl=attn_impl, return_hidden=chunked,
            )
    if not last:
        return out.float().sum() * 0
    if chunked:
        return kl_distillation_loss_chunked(lm, cfg.text_config, out, batch["labels"],
                                            teacher_out, batch["alt_labels"], loss_config,
                                            chunk=vocab_chunk, batch_group=batch_group)
    return kl_distillation_loss(out, batch["labels"], teacher_out, batch["alt_labels"],
                                loss_config, batch_group)
