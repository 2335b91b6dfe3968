"""Continuous-batching serving engine with chunked prefill.

The PyTorch counterpart of the JAX package's ``ServingEngine``: the same
scheduler, requests, events and finish reasons. A fixed pool of
``num_slots`` sequences decodes together; a background thread runs the
serving loop, and each iteration

1. retires cancelled requests;
2. admits pending requests to free slots: the prompt is embedded once
   (audio tower + projector + splice) and queued as a chunked prefill job;
3. dispatches one decode call for every active slot (a single step, or a
   K-step block in steady state), with per-slot greedy / temperature /
   top-k / top-p / min-p sampling on the card;
4. runs up to ``prefill_tokens_per_tick`` prompt tokens of the head prefill
   job through the LLM, straight into its cache row (or, in paged mode, a
   contiguous scratch row that is published to the pool's pages once the
   prompt is complete).

``cache_mode="slots"`` gives each slot a ``max_seq_len`` cache row;
``"paged"`` shares a pool of pages through per-slot page tables, reserved at
admission, with copy-on-adopt conversation-prefix caching and backpressure
when the pool runs out. Decode dispatches are pipelined: up to two are in
flight, and their tokens are read back one to two dispatches behind.

Unlike the JAX package, which donates its buffers to jitted programs, the
device programs here are eager functions that update the caches in place.
All device work runs on one CUDA stream (the loop enters it), so freed pages
that a later admission reuses are safe by in-order execution (see
``_decode_tick``). Nothing inside a dispatch reads a value back from the
card: sampling branches, masks and tables are decided on the host, and host
arrays reach the card through pinned, non-blocking copies of private
buffers (``_upload``).

Multi-LoRA serving (``lora_adapters``): one base model and N adapters,
each request naming one (``submit(lora=...)``) or none. Each tower's
adapters are banked over one sorted-name index (``lora.build_lora_banks``;
slot 0 is the base model) and, where the base projections are fused,
re-expressed over them (``lora.fuse_lora_banks``). Every prefill chunk and
decode dispatch gathers its rows' adapters from the decoder banks
(``_with_lora``); the encoder's adapter is gathered once per admission.
``quantize="int8"`` serves an int8 decoder, adapters riding on top.

Request options, as in the JAX package: presence / frequency / repetition
penalties (vLLM semantics) and ``logit_bias`` run through a single-step
program that carries per-slot output-token counts and the prompt's token
mask on the card (``_decode_all_slots`` with ``out_counts``); logprobs come
from the same single step (``with_logprobs``); a seeded request at a
temperature above 0 draws its noise from a hash of (seed, position)
(``ops.sampling.seeded_exponential``). While any active request needs one
of these (``_needs_single_step``), decode runs single steps only: no
K-step blocks. Precomputed ``audio_embeds`` (the streaming voice path)
skip the audio tower: the text is embedded and the embeddings spliced in.

Prompt-lookup speculative decoding (``spec_decode="ngram"``): in steady
state a dispatch drafts ``spec_k`` tokens per slot from the slot's token
history on the card (``_ngram_drafts``: the continuation of the most recent
earlier occurrence of the history's last n-gram), verifies them in one
(K+1)-token forward and emits the accepted run (``_spec_accept``: an argmax
match for greedy rows, rejection sampling for sampled ones), 1 to K+1
tokens a slot a round. With cache headroom a dispatch runs several rounds
(``_spec_decode_block``: ``decoder.segmented_spec_scan``, the segment
kernels #11 / #12 with ``block_attn_impl="kernel"``); otherwise one round
(``_spec_decode_all_slots``: ``decoder_forward`` at T = K+1 against the
cache, with the plain ``mha`` attention, over the gathered view of the
pages in paged mode). A health guard pauses speculation while the windowed
acceptance is below ``spec_min_accept`` tokens a round a slot and re-probes
every ``spec_probe_period`` dispatches, backing off after failed probes;
the engine starts in that probe mode (single rounds). Requests that need
single steps (``_needs_single_step``) disengage it, as they do blocks.

A mesh (``mesh``, a ``parallel.Mesh`` of data 1): one engine a process,
each holding its fsdp and tensor parts of the model (``parallel/``; the
decoder's products unfused, as in the JAX engine; ``quantize`` raises),
every one running the same device programs in the same order, since each
product's all-reduce and each layer's gather meets the other processes
there. Requests enter at the mesh's rank 0 (``submit`` and ``cancel``
elsewhere raise): each tick, before any dispatch, rank 0 broadcasts the
tick's new requests (their options and inputs), its cancellations and
whether it still runs (``_sync_plan``). Every later decision (admission,
pages, the prefix cache, speculation, sampling) then follows from the same
state and the same tokens on every rank; the other ranks' copies of the
requests are in ``mirrored``, their events in their queues. ``stop()`` on
rank 0 ends every rank's loop; on another rank it waits for that.

What the loop did and when: each request carries marks of its way to the
first token (``admit_time`` ... ``first_emit_time``), the engine counters of
host time (``stat_*``), and while ``spans`` holds a ``SpanRecorder`` the
loop records its spans (``spans.py``), each counter summing its spans.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ultravox_torch.inference.engine import (
    _to_device,
    cache_kv_heads,
    is_whisper_tower,
    place_params,
    resolve_device,
)
from ultravox_torch.inference.serving.spans import SpanRecorder
from ultravox_torch.models import decoder as decoder_lib
from ultravox_torch.models import lora as lora_lib
from ultravox_torch.models import ultravox as uv
from ultravox_torch.models.config import UltravoxConfig
from ultravox_torch.models.whisper_encoder import (
    ENCODER_ATTN_IMPLS,
    fuse_encoder_inference_params,
)
from ultravox_torch.ops.kernels.paged_gather import gather_pages
from ultravox_torch.ops.sampling import (
    MAX_TOP_LOGPROBS,
    apply_penalties,
    sample_slots,
    sampling_flags,
    spec_accept_slots,
    token_logprobs,
)
from ultravox_torch.parallel.collectives import process_count, process_index
from ultravox_torch.parallel.sharding import full_shape, split_of

logger = logging.getLogger(__name__)

# the batch keys the prompt embedding reads
_EMBED_KEYS = (
    "input_ids", "audio_values", "audio_lens", "audio_token_start_idx", "audio_token_len",
    "audio_chunk_batch_idx",
)


@dataclasses.dataclass
class Request:
    request_id: int
    batch: Dict[str, np.ndarray]  # single-row collated features
    max_tokens: int = 256
    temperature: float = 0.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    min_p: float = 0.0  # 0 = disabled
    presence_penalty: float = 0.0  # 0 = disabled (output tokens)
    frequency_penalty: float = 0.0  # 0 = disabled (output counts)
    repetition_penalty: float = 1.0  # 1 = disabled (prompt + output)
    logit_bias: Tuple[Tuple[int, float], ...] = ()  # (token_id, bias) pairs
    seed: Optional[int] = None  # batch-independent reproducible sampling
    lora: Optional[str] = None  # adapter name (multi-LoRA serving)
    logprobs: bool = False  # emit per-token logprobs (OpenAI logprobs)
    top_logprobs: int = 0  # alternatives per token (0..MAX_TOP_LOGPROBS)
    cancelled: bool = False  # set via ServingEngine.cancel()
    stop_token_ids: Tuple[int, ...] = ()
    out_queue: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    submit_time: float = dataclasses.field(default_factory=time.monotonic)
    # filled by the engine
    slot: int = -1
    prompt_len: int = 0
    generated: int = 0
    # the way to the first token, each a time.monotonic() mark: the start of
    # the _admit call that queued the prefill (a deferred request is still
    # queued), the prefill job queued (tower and splice dispatched), the
    # first chunk's dispatch begun, the first token sampled (on _inflight),
    # the first event handed to out_queue. The engine's TTFT is
    # first_emit_time - submit_time
    admit_time: Optional[float] = None
    admitted_time: Optional[float] = None
    prefill_start_time: Optional[float] = None
    first_token_time: Optional[float] = None
    first_emit_time: Optional[float] = None
    finish_time: Optional[float] = None  # when the terminal event was emitted
    emitted_ids: List[int] = dataclasses.field(default_factory=list)
    reused_prefix: int = 0  # tokens served from a retained slot cache
    token_ids: Any = None  # (prompt_len,) np.int32, filled at admission
    audio_spans: Tuple = ()
    # precomputed audio token embeddings (N_chunks, Ta, D), host numpy: the
    # admission skips the audio tower and only embeds and splices
    audio_embeds: Any = None


@dataclasses.dataclass
class RetainedCache:
    """A finished request's slot cache, kept for conversation-prefix reuse."""

    token_ids: np.ndarray  # tokens whose k/v live in the slot cache
    # audio chunks inside those tokens: (start_idx, token_len, sha1-hex)
    audio_spans: Tuple[Tuple[int, int, str], ...]
    lora: Optional[str] = None  # the adapter the k/v were computed under


@dataclasses.dataclass
class StreamEvent:
    token_id: Optional[int]  # None => end of stream
    finish_reason: Optional[str] = None
    ttft_s: Optional[float] = None
    # filled only for requests with logprobs=True
    logprob: Optional[float] = None  # logprob of token_id
    top_ids: Optional[Tuple[int, ...]] = None  # top_logprobs alternatives
    top_logprobs: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass
class PrefillJob:
    """A request whose prompt is being prefilled chunk by chunk into its
    cache row (decode steps interleave between chunks)."""

    req: Request
    embeds: Any  # (1, T_padded, D) prompt embeddings (audio spliced in)
    chunk: int  # chunk size ((T_padded - start) is a multiple of it)
    pos: int = 0  # next position to prefill (starts at the reused prefix)
    # paged mode: the reused prefix lives in pool pages and is loaded into
    # the contiguous prefill scratch before the first chunk runs
    needs_scratch_load: bool = False
    # multi-LoRA: the request's (1,) decoder-bank index on the card
    lora_idx: Any = None
    # copy-on-adopt prefix caching: when >= 0 the prefix loads from this
    # (still retained) slot's pages; the request's own slot gets a copy
    # through the end-of-prefill page scatter, so the retained conversation
    # survives for further reuse
    prefix_src_slot: int = -1


def _request_tokens_and_spans(batch: Dict[str, np.ndarray], audio_embeds=None):
    """Valid prompt token ids + audio-chunk fingerprints (start_idx,
    token_len, sha1) for prefix matching. A request with precomputed
    ``audio_embeds`` and no audio is fingerprinted by its embeddings' bytes
    (the JAX package leaves such a request's spans empty unless the caller
    supplies them, so placeholder tokens alone could match another audio's
    cached prefix)."""
    ids = np.asarray(batch["input_ids"]).reshape(-1)
    n = int(np.asarray(batch["attention_mask"]).sum())
    ids = np.ascontiguousarray(ids[:n])
    spans = []
    vals = batch.get("audio_values")
    if vals is None:
        vals = audio_embeds
    if vals is not None:
        vals = np.asarray(vals)
        zeros = np.zeros((vals.shape[0],), np.int32)
        starts = np.asarray(batch.get("audio_token_start_idx", zeros)).reshape(-1)
        lens = np.asarray(batch.get("audio_token_len", zeros)).reshape(-1)
        for i in range(vals.shape[0]):
            sha = hashlib.sha1(np.ascontiguousarray(vals[i]).tobytes()).hexdigest()
            spans.append((int(starts[i]), int(lens[i]), sha))
    return ids, tuple(spans)


def _match_prefix(tokens, spans, retained: RetainedCache) -> int:
    """Longest reusable prefix: common token ids, never splitting or
    mismatching an audio chunk on either side (audio placeholder tokens are
    identical repeats, so token equality alone would match different audio;
    hence the content fingerprints)."""
    a, b = tokens, retained.token_ids
    lim = min(len(a), len(b))
    neq = np.nonzero(a[:lim] != b[:lim])[0]
    m = int(neq[0]) if len(neq) else lim
    both = set(spans) & set(retained.audio_spans)
    changed = True
    while changed and m > 0:
        changed = False
        for s, l, sha in tuple(spans) + tuple(retained.audio_spans):
            if s < m and ((s, l, sha) not in both or s + l > m):
                m = s
                changed = True
    return m


MAX_LOGIT_BIAS = 32
# the default buckets of the tower's padded input: 4, 10, 20 and 30 s of
# audio in mel frames (100 a second) or, for wav2vec2, in samples at 16 kHz
MEL_LEN_BUCKETS = (400, 1000, 2000, 3000)
SAMPLE_LEN_BUCKETS = (64000, 160000, 320000, 480000)


def _lp_row(lp, row: int):
    """Host view of one slot's logprob stats from a program's fetched
    (chosen, top_ids, top_logprobs) arrays; None passes through."""
    if lp is None:
        return None
    chosen, ids, vals = lp
    return (
        float(chosen[row]),
        tuple(int(t) for t in ids[row]),
        tuple(float(v) for v in vals[row]),
    )


def _normalize_logit_bias(bias) -> Tuple[Tuple[int, float], ...]:
    items = bias.items() if hasattr(bias, "items") else bias
    out = tuple(sorted((int(t), float(b)) for t, b in items))
    if len(out) > MAX_LOGIT_BIAS:
        raise ValueError(f"logit_bias supports at most {MAX_LOGIT_BIAS} entries")
    return out


def _uses_penalties(req: Request) -> bool:
    """True when the request needs the stateful decode program: penalties
    and/or logit_bias."""
    return bool(
        req.presence_penalty
        or req.frequency_penalty
        or req.repetition_penalty != 1.0
        or req.logit_bias
    )


def _needs_single_step(req: Request) -> bool:
    """Penalties and bias need per-step count state, a sampled seed the
    per-position noise, logprobs the per-step statistics: all exact only on
    the single-step program, so decode blocks disengage while such a
    request is active. A seeded greedy request draws nothing and rides
    blocks."""
    return (
        _uses_penalties(req)
        or req.logprobs
        or (req.seed is not None and req.temperature > 0)
    )


def _bias_rows(rows, vocab: int):
    """(ids (n, MAX_LOGIT_BIAS) int64, values (n, MAX_LOGIT_BIAS) fp32) of
    each row's ``logit_bias`` pairs. Padding, and ids outside the
    vocabulary (which the JAX package's scatter drops), add 0.0 at id 0: an
    exact no-op that writes nothing out of bounds."""
    ids = np.zeros((len(rows), MAX_LOGIT_BIAS), np.int64)
    vals = np.zeros((len(rows), MAX_LOGIT_BIAS), np.float32)
    for i, pairs in enumerate(rows):
        for j, (t, b) in enumerate(pairs):
            if 0 <= t < vocab:
                ids[i, j], vals[i, j] = t, b
    return ids, vals


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


def _resolve_auto(
    cache_mode, decode_attn_impl, prefill_attn_impl, encoder_attn_impl, block_attn_impl,
    decode_block_steps, max_seq_len, text_config, on_card: bool,
):
    """Per-workload defaults for the ``"auto"`` options, with the JAX
    package's gates: the cache mode by advertised context length; the
    kernels only on the card, the decode and block kernels by the per-layer
    KV bytes a decode step streams (kv_heads x head_dim x max_seq_len, the
    quantity both context length and model width scale), and the block
    kernel never with an attention softcap (it does not softcap). The
    thresholds are the reference's; where they cross over on an H100 is not
    measured yet. ``on_card`` plays the part of the reference's TPU test."""
    tc = text_config
    kv_layer_bytes = 2 * tc.num_kv_heads * tc.head_dim * max_seq_len * 2
    if cache_mode == "auto":
        cache_mode = "paged" if max_seq_len >= 1024 else "slots"
    if decode_attn_impl == "auto":
        decode_attn_impl = "kernel" if (on_card and kv_layer_bytes >= 4 * 1024 * 1024) else "xla"
    if prefill_attn_impl == "auto":
        prefill_attn_impl = "fused" if (on_card and max_seq_len >= 1024) else "xla"
    if encoder_attn_impl == "auto":
        encoder_attn_impl = "fused" if on_card else "xla"
    if block_attn_impl == "auto":
        block_attn_impl = (
            "kernel"
            if (on_card and kv_layer_bytes >= 16 * 1024 * 1024 and tc.attn_logit_softcapping is None)
            else "xla"
        )
    if decode_block_steps is None:
        # blocks engage only in steady-state decode (the loop prefers
        # admission and prefill work), so a block size is safe to default
        decode_block_steps = 8
    return (
        cache_mode, decode_attn_impl, prefill_attn_impl, encoder_attn_impl, block_attn_impl,
        decode_block_steps,
    )


class ServingEngine:
    def __init__(
        self,
        params: Any,
        cfg: UltravoxConfig,
        *,
        num_slots: int = 16,
        max_seq_len: int = 2048,
        cache_dtype=torch.bfloat16,
        cache_mode: str = "auto",  # "slots" or "paged" (shared pool + page tables)
        page_size: int = 256,
        num_pages: Optional[int] = None,  # default: the slot mode's token count
        prefill_len_buckets: Optional[Tuple[int, ...]] = None,
        # the padded lengths of the tower's input: mel frames for Whisper,
        # raw samples for wav2vec2; None: 4, 10, 20 and 30 s of audio
        mel_len_buckets: Optional[Tuple[int, ...]] = None,
        max_prefills_per_step: int = 2,
        prefill_chunk_tokens: int = 256,
        decode_block_steps: Optional[int] = None,  # None = auto (8)
        encoder_attn_impl: str = "auto",
        decode_attn_impl: str = "auto",  # "kernel": decode_attention / paged_decode_attention
        block_attn_impl: str = "auto",  # "kernel": the segment kernels inside blocks
        prefill_attn_impl: str = "auto",  # "fused": the fused_attention prefill kernel
        quantize: Optional[str] = None,
        lora_adapters: Optional[Dict[str, Any]] = None,
        spec_decode: Optional[str] = None,  # "ngram": prompt-lookup speculative decoding
        spec_k: int = 8,  # drafted tokens a speculative round
        spec_ngram: int = 2,  # the longest history n-gram matched (down to 1)
        spec_min_accept: float = 1.35,  # accepted tokens a round a slot below
        # which speculation pauses (a verify round costs more than a decode
        # step); 0 disables the guard
        spec_probe_period: int = 512,  # dispatches between re-probes while paused
        mesh=None,
        device=None,
    ):
        """Runs on the CUDA card unless ``device="cpu"``. ``"auto"`` options
        resolve in ``_resolve_auto``; explicit values override. ``mesh``:
        see the module's docstring (every process of the mesh builds its
        engine with the same arguments)."""
        if mesh is not None and quantize:
            raise ValueError("quantize= is not supported together with mesh=; quantize the "
                             "params before sharding or serve unquantized")
        if spec_decode in ("none", ""):
            spec_decode = None
        if spec_decode not in (None, "ngram"):
            raise ValueError(f"unsupported spec_decode={spec_decode!r}")
        if spec_decode and (int(spec_k) < 1 or int(spec_ngram) < 1):
            raise ValueError("spec_k and spec_ngram must be >= 1")
        if quantize and quantize != "int8":
            raise ValueError(f"unsupported quantize={quantize!r}")
        self.device = resolve_device(device)
        (cache_mode, decode_attn_impl, prefill_attn_impl, encoder_attn_impl, block_attn_impl,
         decode_block_steps) = _resolve_auto(
            cache_mode, decode_attn_impl, prefill_attn_impl, encoder_attn_impl, block_attn_impl,
            decode_block_steps, max_seq_len, cfg.text_config, self.device.type == "cuda",
        )
        for name, value, allowed in (
            ("encoder_attn_impl", encoder_attn_impl, ENCODER_ATTN_IMPLS),
            ("prefill_attn_impl", prefill_attn_impl, ("xla", "fused")),
            ("decode_attn_impl", decode_attn_impl, ("xla", "kernel")),
            ("block_attn_impl", block_attn_impl, ("xla", "kernel")),
        ):
            if value not in allowed:
                raise ValueError(f"unknown {name}={value!r}")
        self.mesh = mesh
        params = place_params(params, cfg, mesh, self.device)
        self.params = dict(params)
        (self._lora_banks, self._enc_lora_banks, self._lora_index,
         self._enc_adapter_names) = _lora_banks(
            _to_device(lora_adapters, self.device) if lora_adapters else None)
        if mesh is None:  # fused products do not compose with the splits
            self.params["language_model"] = decoder_lib.fuse_inference_params(
                params["language_model"], cfg.text_config
            )
        if quantize:  # the decoder only, as the reference serves int8
            self.params["language_model"] = decoder_lib.quantize_decoder_int8(
                self.params["language_model"])
        tc = cfg.text_config
        if self._lora_banks is not None and "qkv_proj" in self.params["language_model"]["layers"]:
            kv = tc.num_kv_heads * tc.head_dim
            self._lora_banks = lora_lib.fuse_lora_banks(
                self._lora_banks, qkv_dims=(tc.num_heads * tc.head_dim, kv, kv),
                gateup_dims=(tc.intermediate_size, tc.intermediate_size))
        enc_split = None
        if encoder_attn_impl == "fused" and is_whisper_tower(self.params):
            q_proj = self.params["audio_tower"]["layers"].get("q_proj", {})
            enc_split = split_of(q_proj.get("kernel"))
            self.params["audio_tower"] = fuse_encoder_inference_params(self.params["audio_tower"])
        if self._enc_lora_banks is not None and cfg.audio_arch == "wav2vec2":
            raise ValueError("lora_adapters carry audio_tower (encoder) adapters, which a wav2vec2 "
                             "audio tower does not run")
        if self._enc_lora_banks is not None:
            if "qkv_proj" in self.params.get("audio_tower", {}).get("layers", {}):
                D = cfg.audio_config.d_model
                if enc_split is not None:  # the fused leaf holds the rank's q/k/v columns
                    self._enc_lora_banks = _local_qkv_banks(self._enc_lora_banks, enc_split)
                    D //= enc_split.size
                self._enc_lora_banks = lora_lib.fuse_lora_banks(
                    self._enc_lora_banks, qkv_dims=(D, D, D), gateup_dims=())
            # fail here, not inside the first admission's tick
            _validate_enc_lora_banks(self.params.get("audio_tower"), self._enc_lora_banks)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        if prefill_len_buckets is None:
            # powers of two up to the cache length, so the advertised context
            # is actually prefillable
            buckets = [64]
            while buckets[-1] < max_seq_len:
                buckets.append(min(buckets[-1] * 2, max_seq_len))
            prefill_len_buckets = tuple(buckets)
        self.prefill_len_buckets = prefill_len_buckets
        if mel_len_buckets is None:
            mel_len_buckets = (SAMPLE_LEN_BUCKETS if cfg.audio_arch == "wav2vec2"
                               else MEL_LEN_BUCKETS)
        self.mel_len_buckets = mel_len_buckets
        self.max_prefills_per_step = max_prefills_per_step
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # prompt tokens dispatched per scheduler tick: several chunks per
        # tick amortise the tick's fixed dispatch and fetch latency
        self.prefill_tokens_per_tick = 4 * prefill_chunk_tokens
        self.encoder_attn_impl = encoder_attn_impl
        self.prefill_kernel = prefill_attn_impl == "fused"
        self.decode_kernel = decode_attn_impl == "kernel"

        dev = self.device
        self.cache_mode = cache_mode
        self.paged = cache_mode == "paged"
        if self.paged:
            if max_seq_len % page_size:
                raise ValueError(
                    f"max_seq_len {max_seq_len} must be a multiple of page_size {page_size}"
                )
            self.page_size = page_size
            self.pages_per_seq = max_seq_len // page_size
            if num_pages is None:
                num_pages = num_slots * self.pages_per_seq
            self.num_pages = num_pages
            kv_heads = cache_kv_heads(cfg, mesh)
            self.cache = decoder_lib.PagedKVCache.zeros(tc, num_pages, page_size, cache_dtype, dev,
                                                        kv_heads=kv_heads)
            # host-side allocator state: exclusive page ownership per slot
            self._free_pages: List[int] = list(range(num_pages))
            self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
            self._table_np = np.full((num_slots, self.pages_per_seq), num_pages, np.int32)
            self.page_table = self._upload(self._table_np)
            # chunked prefill runs against a contiguous one-row scratch cache
            # (the fused prefill kernel applies, no page gather per chunk);
            # the finished prompt scatters into the pool as whole pages once
            Ts = min(self.prefill_len_buckets[-1], max_seq_len)
            self._scratch = decoder_lib.KVCache.zeros(tc, 1, Ts, cache_dtype, dev, spare=1,
                                                      kv_heads=kv_heads)
        elif cache_mode == "slots":
            self.cache = decoder_lib.KVCache.zeros(
                tc, num_slots, max_seq_len, cache_dtype, dev, spare=1,
                kv_heads=cache_kv_heads(cfg, mesh),
            )
        else:
            raise ValueError(f"unknown cache_mode={cache_mode!r}")
        self.cache_lens = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
        self.last_tokens = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(0)
        # penalty state, allocated at the first penalized admission (the
        # fast path never reads it): per-slot output-token counts, advanced
        # on the card inside each step, and the prompt's token mask
        self._pen_counts: Optional[torch.Tensor] = None  # (num_slots, V) int32
        self._pen_prompt_mask: Optional[torch.Tensor] = None  # (num_slots, V) bool
        self._enc_bypass_warned: set = set()
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        # K decode steps per dispatch in steady state (multi-step scheduling)
        self.decode_block_steps = max(1, decode_block_steps)
        self._seg_attn_impl = block_attn_impl
        if block_attn_impl == "kernel" and tc.attn_logit_softcapping is not None:
            logger.warning(
                "block_attn_impl='kernel' ignored: attn_logit_softcapping is set and the "
                "segment kernels do not softcap"
            )
            self._seg_attn_impl = "xla"
        self.resolved_flags = {
            "cache_mode": cache_mode,
            "decode_attn_impl": decode_attn_impl,
            "prefill_attn_impl": prefill_attn_impl,
            "encoder_attn_impl": encoder_attn_impl,
            "block_attn_impl": self._seg_attn_impl,
            "decode_block_steps": decode_block_steps,
        }

        # loop accounting: enough to attribute the loop's time to prefill
        # work, host fetch waits and dispatch
        self.stat_decode_dispatches = 0  # decode dispatches
        self.stat_decode_steps = 0  # decode steps across those dispatches
        self.stat_prefill_chunks = 0  # prompt chunks dispatched
        self.stat_fetch_wait_s = 0.0  # host time blocked fetching results
        self.stat_dispatch_s = 0.0  # host time issuing decode dispatches
        self.stat_admit_s = 0.0  # host time in _admit
        self.stat_prefill_s = 0.0  # host time dispatching prefill chunks
        # the loop's spans (spans.py), recorded while a SpanRecorder is set
        # here; each counter of host time sums the spans of its code
        self.spans: Optional[SpanRecorder] = None

        # prompt-lookup speculative decoding: drafts come from a token
        # history on the card, so consecutive speculative dispatches need no
        # host state; the history is uploaded again from the host's tokens
        # only when it went stale (a non-speculative dispatch ran, or the
        # active set changed)
        self.spec_decode = spec_decode
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.spec_emitted_tokens = 0  # tokens emitted by speculative dispatches
        self.spec_dispatches = 0  # speculative rounds dispatched
        self.spec_syncs = 0  # history uploads (each after a drain)
        self.spec_sync_s = 0.0  # host time in those drains and uploads
        self.spec_single_dispatches = 0  # one-round dispatches outside probe mode
        self.spec_wasted_tokens = 0  # accepted, then dropped (request finished)
        # the acceptance health guard: mean accepted tokens a round a slot
        # over a window of dispatches; below spec_min_accept speculation
        # pauses, and re-probes after spec_probe_period dispatches
        self.spec_min_accept = float(spec_min_accept)
        self.spec_probe_period = max(1, int(spec_probe_period))
        self.spec_rows = 0  # rounds x active slots (the mean's denominator)
        self.spec_accepted_sum = 0  # accepted tokens, wasted ones included
        self.spec_autopauses = 0  # times the guard paused speculation
        self._dispatch_count = 0  # decode and speculative dispatches (the probe clock)
        # a probe (after a pause, and at a cold start) runs single rounds
        # and decides on a small window; failed probes double the period up
        # to _spec_backoff_cap times, a healthy one re-engages multi-round
        # dispatches
        self._spec_probe_evidence_rounds = 4
        self._spec_backoff_cap = 8
        self._reset_spec_guard()
        self.spec_probe_dispatches = 0
        self.token_hist: Optional[torch.Tensor] = None
        if spec_decode:
            self.token_hist = torch.zeros((num_slots, max_seq_len), dtype=torch.int32, device=dev)
            # multi-round speculative blocks: up to decode_block_steps rounds
            # a dispatch, in halving depths as the cache headroom shrinks
            self.spec_rounds = max(1, self.decode_block_steps)
            self._spec_round_buckets: List[int] = []
            nr = self.spec_rounds
            while nr > 1:
                self._spec_round_buckets.append(nr)
                nr //= 2
        self._hist_dirty = True
        self._spec_key = None  # the (slot, request_id) set the history matches
        self._spec_cache = None  # (key, active mask, samp, sampled, filtered, lora index)

        self._pending: "queue.Queue[Request]" = queue.Queue()
        self._cancels: "queue.Queue[int]" = queue.Queue()
        self._active: Dict[int, Request] = {}  # slot -> request
        self._prefilling: List[PrefillJob] = []  # chunked prefill queue
        # pipelined decode: dispatched, not yet fetched decode calls (device
        # results + the active-set snapshot they were dispatched against)
        self._inflight: "collections.deque" = collections.deque()
        self._max_inflight = 2
        self._mask_cache = None  # (key, active mask, samp, sampled, filtered, lora index, bias, seeds)
        self._free_slots = list(range(num_slots))
        # conversation-prefix reuse: finished slots keep their cache rows
        # until reallocated; min_reuse_tokens gates trivial matches
        self._retained: Dict[int, RetainedCache] = {}
        # paged copy-on-adopt: source slots whose pages a queued prefill will
        # read, protected from eviction and reallocation until loaded;
        # counted, since several queued prefills may share one source
        self._pinned: Dict[int, int] = {}
        self.min_reuse_tokens = 8
        self.reused_prefix_tokens = 0  # cumulative counter
        self._requests: Dict[int, Request] = {}
        self._id_counter = itertools.count()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # a mesh's rank 0 broadcasts each tick's plan over the default group
        self._group = dist.group.WORLD if mesh is not None and process_count() > 1 else None
        self._leader = self._group is None or process_index() == 0
        self._inbox: "queue.Queue[Request]" = queue.Queue()  # rank 0's new requests
        self._cancel_inbox: "queue.Queue[int]" = queue.Queue()
        self.mirrored: List[Request] = []  # another rank's copies of rank 0's requests

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy is
        non-blocking from a private pinned buffer, which the caching host
        allocator keeps until the copy has run; a blocking copy from
        pageable memory would wait for the whole stream."""
        t = torch.from_numpy(np.array(arr, copy=True))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- paged-pool bookkeeping (host side; serving thread only) -------------

    def _pages_needed(self, tokens: int) -> int:
        return -(-max(int(tokens), 1) // self.page_size)

    def _push_table(self):
        # _upload copies _table_np, which later bookkeeping mutates
        self.page_table = self._upload(self._table_np)

    def _release_slot_pages(self, slot: int):
        if self._slot_pages[slot]:
            self._free_pages.extend(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self._table_np[slot, :] = self.num_pages
            self._push_table()

    def _trim_slot_pages(self, slot: int, keep_tokens: int):
        """Keep only the pages covering positions [0, keep_tokens)."""
        keep = self._pages_needed(keep_tokens) if keep_tokens > 0 else 0
        extra = self._slot_pages[slot][keep:]
        if extra:
            self._slot_pages[slot] = self._slot_pages[slot][:keep]
            self._free_pages.extend(extra)
            self._table_np[slot, keep:] = self.num_pages
            self._push_table()

    def _evict_retained_pages(self, needed: int):
        """Free retained conversations' pages (free slots only) until
        ``needed`` pages are available."""
        for slot in list(self._retained):
            if len(self._free_pages) >= needed:
                break
            if slot in self._free_slots and slot not in self._pinned and self._slot_pages[slot]:
                self._retained.pop(slot, None)
                self._release_slot_pages(slot)

    def _reserve_pages(self, slot: int, total_tokens: int) -> bool:
        """Grow the slot's page list to cover ``total_tokens`` logical
        positions (reserved at admission, so a decode step never allocates).
        False: the pool is exhausted even after evicting retained
        conversations."""
        need = self._pages_needed(total_tokens)
        have = len(self._slot_pages[slot])
        grow = need - have
        if grow <= 0:
            return True
        if len(self._free_pages) < grow:
            self._evict_retained_pages(grow)
        if len(self._free_pages) < grow:
            return False
        new = [self._free_pages.pop() for _ in range(grow)]
        self._slot_pages[slot].extend(new)
        self._table_np[slot, have:need] = new
        self._push_table()
        return True

    def _pin(self, slot: int):
        self._pinned[slot] = self._pinned.get(slot, 0) + 1

    def _unpin(self, slot: int):
        n = self._pinned.get(slot, 0) - 1
        if n <= 0:
            self._pinned.pop(slot, None)
        else:
            self._pinned[slot] = n

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free_pages) if self.paged else 0

    # -- public API ----------------------------------------------------------

    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        if not self._leader:
            # a mesh's other ranks stop when rank 0's plan says so
            if self._thread:
                self._thread.join()
            return
        self._running = False
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=30)

    def submit(
        self,
        batch: Dict[str, np.ndarray],
        *,
        max_tokens: int = 256,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        repetition_penalty: float = 1.0,
        logit_bias=(),
        seed: Optional[int] = None,
        lora: Optional[str] = None,  # an adapter name of lora_adapters
        logprobs: bool = False,
        top_logprobs: int = 0,
        stop_token_ids: Tuple[int, ...] = (),
        audio_embeds=None,
        audio_spans: Optional[Tuple] = None,
    ) -> Request:
        """Queue one request (a single-row collated batch).

        Sampling: per-request temperature / top_k / top_p / min_p apply
        slot-wise inside the shared decode call. Penalties (presence and
        frequency over output tokens, repetition over prompt and output:
        vLLM semantics) and ``logit_bias`` (a mapping or (token_id, bias)
        pairs, at most 32) run in a single-step program with per-slot token
        counts. A ``seed`` (any int, reduced mod 0x7FFFFFFF) makes a sampled
        request reproducible whatever else is batched with it.
        ``logprobs`` / ``top_logprobs`` (0..5) fill each StreamEvent's
        ``logprob``, ``top_ids`` and ``top_logprobs``.

        ``audio_embeds``: precomputed audio token embeddings (N_chunks, Ta,
        D), numpy or a tensor (copied to the host here); the batch then
        carries the splice coordinates and no ``audio_values``, and the
        admission skips the audio tower. ``audio_spans`` supplies the
        prefix-matching content fingerprints otherwise derived from
        ``audio_values`` (or from the embeddings' bytes)."""
        if not self._leader:
            raise RuntimeError("requests enter a mesh's engine at its rank 0")
        if isinstance(audio_embeds, torch.Tensor):
            audio_embeds = audio_embeds.detach().float().cpu().numpy()
        elif audio_embeds is not None:
            audio_embeds = np.asarray(audio_embeds)
            if audio_embeds.dtype.name == "bfloat16":
                audio_embeds = audio_embeds.astype(np.float32)
        req = Request(
            request_id=next(self._id_counter),
            batch=batch,
            max_tokens=max_tokens,
            temperature=float(temperature),
            top_k=int(top_k),
            top_p=float(top_p),
            min_p=float(min_p),
            presence_penalty=float(presence_penalty),
            frequency_penalty=float(frequency_penalty),
            repetition_penalty=float(repetition_penalty),
            logit_bias=_normalize_logit_bias(logit_bias),
            # any int is a legal seed: reduce into the non-negative int32
            # range (negative values would collide with the -1 unseeded
            # sentinel; >= 2**31 would overflow int32)
            seed=None if seed is None else int(seed) % 0x7FFFFFFF,
            lora=lora,
            logprobs=bool(logprobs) or int(top_logprobs) > 0,
            top_logprobs=int(top_logprobs),
            stop_token_ids=tuple(stop_token_ids),
            audio_embeds=audio_embeds,
        )
        if not 0 <= req.top_logprobs <= MAX_TOP_LOGPROBS:
            raise ValueError(f"top_logprobs must be in [0, {MAX_TOP_LOGPROBS}]")
        if audio_spans is not None:
            req.audio_spans = tuple(audio_spans)
        # registration and enqueue are atomic with respect to
        # _fail_all_requests' drain and clear
        with self._lock:
            self._requests[req.request_id] = req
            (self._pending if self._group is None else self._inbox).put(req)
        self._wake.set()
        return req

    def stream(self, req: Request, timeout: Optional[float] = None):
        """Yield StreamEvents until the request finishes. If the loop can no
        longer finish the request (thread dead, engine stopped, request
        gone without a terminal event), or ``timeout`` seconds pass between
        two events, a terminal error event is yielded instead of blocking."""
        waited = 0.0
        while True:
            try:
                event: StreamEvent = req.out_queue.get(timeout=1.0)
                waited = 0.0
            except queue.Empty:
                waited += 1.0
                thread = self._thread
                loop_dead = not self._running or thread is None or not thread.is_alive()
                timed_out = timeout is not None and waited >= timeout
                if loop_dead or timed_out or req.request_id not in self._requests:
                    # drain anything that raced in before giving up
                    try:
                        event = req.out_queue.get_nowait()
                        waited = 0.0
                    except queue.Empty:
                        yield StreamEvent(token_id=None, finish_reason="error")
                        return
                else:
                    continue
            yield event
            if event.token_id is None:
                return

    def cancel(self, req_or_id) -> None:
        """Abort a request (thread-safe, idempotent; unknown or finished ids
        are ignored). The loop retires it at the next safe point: pending
        requests finish "cancelled" instead of admitting, prefilling jobs
        drop (slot and pages freed, adoption pins released), active slots
        stop decoding and free at once."""
        if not self._leader:
            raise RuntimeError("requests are cancelled at a mesh's rank 0")
        rid = req_or_id.request_id if isinstance(req_or_id, Request) else int(req_or_id)
        (self._cancels if self._group is None else self._cancel_inbox).put(rid)
        self._wake.set()

    # -- serving loop --------------------------------------------------------

    def _loop(self):
        # inference mode and the current device and stream are per thread
        with torch.inference_mode():
            if self._stream is not None:
                with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                    self._loop_body()
            else:
                self._loop_body()

    def _sync_plan(self) -> bool:
        """A mesh's tick plan, before any dispatch: rank 0's new requests
        (everything but their queues and times), cancellations and whether
        it still runs, broadcast to every rank and queued on each in one
        order. Returns whether the loop runs on."""
        if self._leader:
            reqs = _drain(self._inbox)
            plan = [self._running, [{f: getattr(r, f) for f in _PLAN_FIELDS} for r in reqs],
                    _drain(self._cancel_inbox)]
        obj = [plan if self._leader else None]
        dist.broadcast_object_list(obj, src=0, group=self._group)
        running, specs, cancels = obj[0]
        if not self._leader:
            reqs = [Request(**spec) for spec in specs]
            self.mirrored.extend(reqs)
            with self._lock:
                for r in reqs:
                    self._requests[r.request_id] = r
        for r in reqs:
            self._pending.put(r)
        for rid in cancels:
            self._cancels.put(rid)
        return running

    def _loop_body(self):
        while self._sync_plan() if self._group is not None else self._running:
            sp = self.spans
            tick = sp.open("tick") if sp is not None else -1
            try:
                self._loop_tick()
            except Exception:  # noqa: BLE001 - the scheduler itself raised
                # a dead loop thread would leave every stream() consumer
                # blocked: fail every known request and keep serving
                logger.exception("serving loop tick failed; failing all requests")
                try:
                    self._fail_all_requests()
                except Exception:  # noqa: BLE001 - last resort below
                    logger.exception("scheduler reset failed; stopping loop")
                    self._running = False
                    for req in list(self._requests.values()):
                        req.out_queue.put(StreamEvent(token_id=None, finish_reason="error"))
                    self._requests.clear()
            if sp is not None:
                sp.close(tick)
        # loop exit (stop()): deliver whatever was already computed
        try:
            self._drain_decodes()
        except Exception:  # noqa: BLE001 - shutdown must not raise
            self._inflight.clear()

    def _fail_all_requests(self):
        """Terminal-error every tracked request and reset scheduling state
        (slots, pages, pins, retained prefixes, in-flight dispatches)."""
        self._inflight.clear()
        self._mask_cache = None
        self._spec_cache = None
        self._spec_key = None
        with self._lock:
            while not self._pending.empty():
                try:
                    self._pending.get_nowait()
                except queue.Empty:
                    break
            while not self._cancels.empty():
                try:
                    self._cancels.get_nowait()
                except queue.Empty:
                    break
            self._prefilling.clear()
            self._active.clear()
            for req in list(self._requests.values()):
                req.out_queue.put(StreamEvent(token_id=None, finish_reason="error"))
            self._requests.clear()
        self._retained.clear()
        self._pinned.clear()
        if self.paged:
            for slot in range(self.num_slots):
                self._release_slot_pages(slot)
        self._free_slots = list(range(self.num_slots))
        self.cache_lens = torch.zeros((self.num_slots,), dtype=torch.int32, device=self.device)

    def _loop_tick(self):
        did_work = False
        sp = self.spans
        # admissions and cancellations change slot and page ownership:
        # retire in-flight decode work first, so lagged finishes free their
        # slots and pages and cancelled requests get their final tokens
        if self._inflight and not (self._pending.empty() and self._cancels.empty()):
            self._drain_decodes()
        while not self._cancels.empty():
            try:
                self._cancel_one(self._cancels.get_nowait())
            except queue.Empty:  # pragma: no cover - single consumer
                break
            did_work = True
        # admit new requests: embed the prompt and queue a chunked prefill
        admitted = 0
        while (
            admitted < self.max_prefills_per_step and self._free_slots
            and not self._pending.empty()
        ):
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            t0 = time.monotonic_ns()
            span = sp.open("admit", req.request_id, t0) if sp is not None else -1
            try:
                self._admit(req, t0)
            except Exception:  # noqa: BLE001 - fail the request, not the loop
                logger.exception("admit failed for request %d", req.request_id)
                if req.slot >= 0:
                    self._free_slots.append(req.slot)
                    req.slot = -1
                req.out_queue.put(StreamEvent(token_id=None, finish_reason="error"))
                self._requests.pop(req.request_id, None)
            t1 = time.monotonic_ns()
            self.stat_admit_s += (t1 - t0) * 1e-9
            if sp is not None:
                sp.close(span, end=t1)
            admitted += 1
            did_work = True

        if self._active:
            try:
                self._decode_tick()
            except Exception:  # noqa: BLE001 - fail active requests, keep serving
                logger.exception("decode step failed; failing active requests")
                self._inflight.clear()  # results are worthless now
                self._mask_cache = None
                self._spec_cache = None
                self._spec_key = None
                for slot, req in list(self._active.items()):
                    req.out_queue.put(StreamEvent(token_id=None, finish_reason="error"))
                    del self._active[slot]
                    self._free_slots.append(slot)
                    if self.paged:
                        self._release_slot_pages(slot)
                    self.cache_lens[slot].fill_(0)
                    self._requests.pop(req.request_id, None)
            did_work = True

        # advance the head prefill job by up to prefill_tokens_per_tick
        # tokens (several chunk dispatches)
        if self._prefilling:
            job = self._prefilling[0]
            try:
                budget = self.prefill_tokens_per_tick
                finished = False
                while budget > 0 and not finished:
                    budget -= job.chunk
                    finished = self._prefill_one_chunk(job)
            except Exception:  # noqa: BLE001
                logger.exception("prefill chunk failed for request %d", job.req.request_id)
                self._prefilling.pop(0)
                if self.paged:
                    self._release_slot_pages(job.req.slot)
                if job.prefix_src_slot >= 0:
                    self._unpin(job.prefix_src_slot)
                self._free_slots.append(job.req.slot)
                job.req.slot = -1
                job.req.out_queue.put(StreamEvent(token_id=None, finish_reason="error"))
                self._requests.pop(job.req.request_id, None)
            else:
                if finished:
                    self._prefilling.pop(0)
            did_work = True

        if not did_work:
            # nothing to dispatch: deliver in-flight tokens now rather than
            # sleeping on them
            if self._inflight:
                self._drain_decodes()
                return
            span = sp.open("wait") if sp is not None else -1
            self._wake.wait(timeout=0.01)
            if sp is not None:
                sp.close(span)
            self._wake.clear()

    def _pad_request(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        batch = dict(batch)
        T = batch["input_ids"].shape[-1]
        Tp = _bucket(T, self.prefill_len_buckets)
        for key in ("input_ids", "attention_mask"):
            arr = np.asarray(batch[key]).reshape(1, -1)
            batch[key] = np.pad(arr, ((0, 0), (0, Tp - T)))
        if batch.get("audio_values") is not None:
            mel = np.asarray(batch["audio_values"])
            Tm = mel.shape[-1]
            Tmp = _bucket(Tm, self.mel_len_buckets)
            batch["audio_values"] = np.pad(mel, ((0, 0), (0, 0), (0, Tmp - Tm)))
            if "audio_chunk_batch_idx" not in batch:
                batch["audio_chunk_batch_idx"] = np.zeros((mel.shape[0],), np.int32)
        return batch

    def _admit(self, req: Request, t0: int):
        """Embed the request's prompt and queue its prefill job, or settle
        it at once (cancelled, unknown adapter, too long), or requeue it
        while slots or pages are short (``defer_or_fail``). ``t0``: the
        call's start (``time.monotonic_ns``), the request's ``admit_time``
        once its job is queued."""
        if req.cancelled:
            self._finish_cancelled(req)
            return
        if req.lora is not None and req.lora not in self._lora_index:
            req.out_queue.put(StreamEvent(token_id=None, finish_reason="unknown_lora"))
            self._requests.pop(req.request_id, None)
            return
        if (req.audio_embeds is not None and req.lora in self._enc_adapter_names
                and req.lora not in self._enc_bypass_warned):
            # precomputed embeddings bypass the audio tower, so the adapter's
            # encoder half cannot apply; its decoder half still does
            self._enc_bypass_warned.add(req.lora)
            logger.warning(
                "request with precomputed audio_embeds selected lora=%r: any encoder "
                "(audio-tower) half of the adapter is bypassed for such requests", req.lora)
        prompt_len = int(np.asarray(req.batch["attention_mask"]).sum())
        # a prompt of max_seq_len - 1 is servable (one token, then
        # cache_full); anything beyond that, or beyond the largest prefill
        # bucket, cannot be prefilled
        limit = min(self.max_seq_len - 1, self.prefill_len_buckets[-1])
        if prompt_len > limit:
            req.out_queue.put(StreamEvent(token_id=None, finish_reason="prompt_too_long"))
            self._requests.pop(req.request_id, None)
            return
        # conversation-prefix reuse: prefer a retained slot whose cache
        # already holds a long prefix of this prompt
        req.token_ids, spans = _request_tokens_and_spans(req.batch, req.audio_embeds)
        if not req.audio_spans:  # submit() may have supplied fingerprints
            req.audio_spans = spans
        best_slot, best_m = None, 0
        for slot_r, entry in self._retained.items():
            if slot_r not in self._free_slots:
                continue
            if entry.lora != req.lora:
                continue  # k/v computed under another adapter
            m = _match_prefix(req.token_ids, req.audio_spans, entry)
            if m > best_m:
                best_m, best_slot = m, slot_r
        start = 0
        src_slot = -1
        adopting = best_slot is not None and best_m >= self.min_reuse_tokens
        if adopting:
            # at least one suffix token must prefill to produce logits
            start = min(best_m, prompt_len - 1)
            adopting = start > 0

        def defer_or_fail():
            """Backpressure: requeue while in-flight work can still free
            slots or pages; fail only when nothing could satisfy this."""
            if self._active or self._prefilling:
                self._pending.put(req)
            else:
                req.out_queue.put(StreamEvent(token_id=None, finish_reason="pool_exhausted"))
                self._requests.pop(req.request_id, None)

        if adopting and self.paged:
            # copy-on-adopt: place the request on a different slot when one
            # is free; the source's pages are read into the prefill scratch
            # and published into the new slot's own pages, so the retained
            # conversation survives for further reuse
            cands = [s for s in self._free_slots if s not in self._pinned]
            if not cands:
                defer_or_fail()  # pins are transient; retry shortly
                return
            others = [s for s in cands if s != best_slot]
            non_ret = [s for s in others if s not in self._retained]
            if non_ret:
                slot = non_ret[-1]
            elif others:
                slot = others[-1]
            else:
                slot = best_slot  # forced: fall back to transfer semantics
            self._free_slots.remove(slot)
            if slot != best_slot:
                src_slot = best_slot
        elif adopting:
            slot = best_slot
            self._free_slots.remove(slot)
        else:
            # prefer slots with no retained conversation, so one unrelated
            # request does not evict a reusable prefix
            cands = [s for s in self._free_slots if s not in self._pinned]
            if not cands:
                defer_or_fail()
                return
            non_retained = [s for s in cands if s not in self._retained]
            slot = non_retained[-1] if non_retained else cands[-1]
            self._free_slots.remove(slot)
        if self.paged:
            # reserve the request's full footprint up front against a
            # snapshot of the destination slot; transfer mode (src_slot < 0)
            # keeps the reused prefix pages, copy mode evicts the
            # destination's own (unrelated) retained pages
            if src_slot >= 0:
                # pin before reserving: the reservation's eviction pass must
                # not consume the adoption source
                self._pin(src_slot)
            keep = start if (adopting and src_slot < 0) else 0
            saved_pages = list(self._slot_pages[slot])
            saved_entry = self._retained.pop(slot, None)
            self._trim_slot_pages(slot, keep)
            total = min(prompt_len + req.max_tokens, self.max_seq_len)
            ok = self._reserve_pages(slot, total)
            if not ok and src_slot >= 0:
                # the pool cannot hold the request and the pinned source:
                # admit without reuse, evicting the source only if no other
                # queued adopter still needs its pages
                self._unpin(src_slot)
                if src_slot not in self._pinned:
                    self._retained.pop(src_slot, None)
                    self._release_slot_pages(src_slot)
                src_slot = -1
                adopting = False
                start = 0
                ok = self._reserve_pages(slot, total)
            if not ok:
                # a transient failure must not destroy cached state: restore
                # the snapshot (the freed pages are still on the free list)
                for p in saved_pages[len(self._slot_pages[slot]):]:
                    self._free_pages.remove(p)
                self._slot_pages[slot] = saved_pages
                self._table_np[slot, : len(saved_pages)] = saved_pages
                self._table_np[slot, len(saved_pages):] = self.num_pages
                self._push_table()
                if saved_entry is not None:
                    self._retained[slot] = saved_entry
                elif self._slot_pages[slot]:
                    self._release_slot_pages(slot)
                if src_slot >= 0:
                    self._unpin(src_slot)
                self._free_slots.append(slot)
                defer_or_fail()
                return
        else:
            self._retained.pop(slot, None)  # the row gets overwritten now
        try:
            req.slot = slot
            req.prompt_len = prompt_len
            req.reused_prefix = start
            self.reused_prefix_tokens += start
            padded = self._pad_request(req.batch)
            adapter = self._lora_index.get(req.lora, 0)  # 0: the base model
            sp = self.spans
            span = sp.open("embed", req.request_id) if sp is not None else -1
            if req.audio_embeds is not None:
                embeds = self._embed_with_precomputed(padded, req.audio_embeds)
            else:
                batch = {k: self._upload(np.asarray(padded[k])) for k in _EMBED_KEYS
                         if padded.get(k) is not None}
                enc_idx = None
                if self._enc_lora_banks is not None:
                    enc_idx = self._upload(np.asarray(adapter, np.int32))
                # one call embeds the whole prompt (audio tower + projector +
                # splice); the LLM prefill then proceeds in chunks
                embeds = _embed_prompt(self.params, batch, self._enc_lora_banks, enc_idx,
                                       cfg=self.cfg, encoder_attn_impl=self.encoder_attn_impl)
            if sp is not None:
                sp.close(span)
            lora_idx = None
            if self._lora_banks is not None:
                lora_idx = self._upload(np.asarray([adapter], np.int32))
            T_padded = embeds.shape[1]
            # short suffixes take a single chunk; longer ones chunk at
            # prefill_chunk_tokens
            chunk = min(self.prefill_chunk_tokens, T_padded - start)
            if (T_padded - start) % chunk:
                Tp = start + (-(-(T_padded - start) // chunk)) * chunk
                embeds = F.pad(embeds, (0, 0, 0, Tp - T_padded))
        except Exception:
            if self.paged:
                self._release_slot_pages(slot)
            if src_slot >= 0:
                self._unpin(src_slot)
            self._free_slots.append(slot)  # the slot must not leak
            req.slot = -1
            raise
        if _uses_penalties(req) and self._pen_counts is None:
            V = self.cfg.text_config.vocab_size
            self._pen_counts = torch.zeros((self.num_slots, V), dtype=torch.int32, device=self.device)
            self._pen_prompt_mask = torch.zeros((self.num_slots, V), dtype=torch.bool,
                                                device=self.device)
        if self._pen_counts is not None:
            # reset this slot's rows (in stream order, after every in-flight
            # step of the slot's previous request); requests without
            # penalties run exact no-op penalties, so stale rows elsewhere
            # are harmless
            self._pen_counts[slot].zero_()
            self._pen_prompt_mask[slot].zero_()
            ids = self._upload(np.asarray(req.token_ids, np.int64))
            self._pen_prompt_mask[slot].index_fill_(0, ids, True)
        self._prefilling.append(
            PrefillJob(
                req=req, embeds=embeds, chunk=chunk, pos=start,
                needs_scratch_load=self.paged and start > 0, prefix_src_slot=src_slot,
                lora_idx=lora_idx,
            )
        )
        req.admit_time = t0 * 1e-9
        req.admitted_time = time.monotonic()

    def _embed_with_precomputed(self, padded: Dict[str, np.ndarray], audio_embeds):
        """Prompt embeddings with precomputed audio token embeddings spliced
        in: the text is embedded, the audio tower does not run."""
        ae = np.asarray(audio_embeds)
        N = ae.shape[0]

        def ints(key):
            arr = np.asarray(padded.get(key, np.zeros((N,), np.int32))).reshape(-1)[:N]
            return self._upload(arr.astype(np.int32))

        return _embed_precomputed(
            self.params, self._upload(np.asarray(padded["input_ids"])), self._upload(ae),
            ints("audio_token_start_idx"), ints("audio_token_len"), ints("audio_chunk_batch_idx"),
        )

    def _prefill_one_chunk(self, job: PrefillJob) -> bool:
        """Run one prompt chunk through the LLM into the job's cache row.
        Returns True when the prompt is fully prefilled (request active)."""
        t0 = time.monotonic_ns()
        if job.req.prefill_start_time is None:
            job.req.prefill_start_time = t0 * 1e-9
        sp = self.spans
        span = sp.open("prefill_chunk", job.req.request_id, t0) if sp is not None else -1
        try:
            return self._run_prefill_chunk(job)
        finally:
            t1 = time.monotonic_ns()
            self.stat_prefill_s += (t1 - t0) * 1e-9
            if sp is not None:
                sp.close(span, job.chunk, t1)

    def _run_prefill_chunk(self, job: PrefillJob) -> bool:
        req = job.req
        C = job.chunk
        T_padded = job.embeds.shape[1]
        start = job.pos
        chunk = job.embeds[:, start: start + C]
        if self.paged:
            if job.needs_scratch_load:
                # conversation reuse: the retained prefix lives in pages, the
                # request's own (transfer) or a retained source slot's (copy)
                src = job.prefix_src_slot if job.prefix_src_slot >= 0 else req.slot
                _pages_to_scratch(self.cache, self.page_table[src][None], self._scratch)
                job.needs_scratch_load = False
            if job.prefix_src_slot >= 0:
                # unpin keyed off the source field itself, so a pin can never
                # outlive its job
                self._unpin(job.prefix_src_slot)
                job.prefix_src_slot = -1
            logits_last = _prefill_chunk_scratch_impl(
                self.params, self._scratch, chunk, start, req.prompt_len, cfg=self.cfg,
                prefill_kernel=self.prefill_kernel, lora_banks=self._lora_banks,
                lora_idx=job.lora_idx,
            )
        else:
            logits_last = _prefill_chunk_impl(
                self.params, self.cache, chunk, req.slot, start, req.prompt_len, cfg=self.cfg,
                prefill_kernel=self.prefill_kernel, lora_banks=self._lora_banks,
                lora_idx=job.lora_idx,
            )
        job.pos = start + C
        self.stat_prefill_chunks += 1
        if job.pos < min(req.prompt_len, T_padded):
            return False
        if self.paged:
            # prompt complete: publish the scratch into the slot's pages
            _scratch_to_pages(self.cache, self._scratch, self.page_table[req.slot][None])
        # prompt complete: sample the first token and activate the slot. The
        # token stays on the card (last_tokens takes it there); its fetch and
        # emit ride the in-flight queue. (Scalars go to the card through
        # fill_: an item assignment from a Python number would copy it from
        # host memory and wait for the stream.)
        samp1 = np.array([[req.temperature, req.top_k, req.top_p, req.min_p,
                           req.presence_penalty, req.frequency_penalty, req.repetition_penalty]],
                         np.float32)
        sampled, filtered = sampling_flags(samp1)
        samp1_dev = self._upload(samp1)
        if _uses_penalties(req):
            # the first token honours the repetition penalty over the prompt
            # and logit_bias exactly like every later step
            bias_ids, bias_vals = _bias_rows([req.logit_bias], self.cfg.text_config.vocab_size)
            row = slice(req.slot, req.slot + 1)
            logits_last = _first_token_extras(
                logits_last, samp1_dev, self._pen_counts[row], self._pen_prompt_mask[row],
                self._upload(bias_ids), self._upload(bias_vals))
        seeds = positions = None
        if req.seed is not None and sampled:
            # the first token's seeded position is prompt_len; step n's is
            # prompt_len + n (cache_lens + 1 in _decode_all_slots)
            seeds = self._upload(np.array([req.seed], np.int32))
            positions = self._upload(np.array([req.prompt_len], np.int32))
        tok = _sample_slots(logits_last, samp1_dev, self.generator, sampled, filtered,
                            seeds, positions)
        if _uses_penalties(req):
            # the first token is an output token: presence / frequency see
            # it from the next step on, as every token the step counts
            self._pen_counts[req.slot: req.slot + 1].scatter_add_(
                1, tok.long()[:, None], torch.ones((1, 1), dtype=torch.int32, device=tok.device))
        self.cache_lens[req.slot].fill_(req.prompt_len)
        self.last_tokens[req.slot] = tok[0]
        self._active[req.slot] = req
        self._mask_cache = None  # active set changed
        req.first_token_time = time.monotonic()
        # first-token logprobs come from the logits the sample used
        lp1 = token_logprobs(logits_last, tok) if req.logprobs else None
        self._inflight.append(("first", tok, req, lp1))
        return True

    def _decode_tick(self):
        """One scheduler decision: dispatch the next decode call (a K-step
        block in steady state, else a single step) without waiting for its
        tokens, and fetch the oldest in-flight result once more than
        ``_max_inflight`` dispatches are outstanding.

        Safety of the lag: a request that finishes inside an in-flight
        dispatch keeps decoding wasted columns, which processing drops.
        Cache writes stay in bounds because the dispatch guard reserves
        (in-flight + next) steps of headroom against max_seq_len. Freed pages
        that a later admission reuses cannot be corrupted by an in-flight
        block's stray writes: the card runs one stream in order, so the
        adopting request's later prefill publish lands after them, and
        positions beyond cache_lens are never read."""
        # blocks engage only in steady-state decode (no prefill work, nothing
        # queued): under churn they would delay admissions by K steps
        churn = bool(self._prefilling) or not self._pending.empty()
        lag = sum(
            e[3] if e[0] == "decode" else e[4] if e[0] == "spec" else 0 for e in self._inflight
        )
        cap = self.max_seq_len - 1 - max(
            r.prompt_len + r.generated for r in self._active.values()
        )
        # penalties, logprobs and sampled seeds are exact only on single
        # steps: blocks and speculation disengage while any active request
        # needs them (each such request was active, so single-stepped, from
        # its first token)
        single = any(_needs_single_step(r) for r in self._active.values())
        # speculation: steady state only, with the worst case of K+1 tokens a
        # slot inside the cache headroom (as blocks)
        if (self.spec_decode and not churn and not single and not self._spec_paused()
                and cap - lag >= self.spec_k + 1):
            if self._dispatch_spec(cap - lag):
                while len(self._inflight) > self._max_inflight:
                    self._process_oldest_decode()
            # False: the drain before the history upload finished every
            # active request; either way this tick's decision is made
            return
        n_steps = 1
        if (self.decode_block_steps > 1 and not churn and not single
                and cap - lag >= self.decode_block_steps):
            # the capacity bound must hold for the whole block plus the
            # in-flight lag; per-request token budgets need not (mid-block
            # stop or length finishes drop the leftover columns)
            n_steps = self.decode_block_steps
        elif cap - lag < 1:
            # near the cache edge the host view lags too far to prove the
            # next write in bounds: retire in-flight work and re-decide
            if not self._inflight:
                # unreachable: _emit finishes any request reaching
                # max_seq_len - 1, so the lag-free cap is always >= 1
                logger.error("no cache headroom with nothing in flight")
                return
            self._drain_decodes()
            if not self._active:
                return
            return self._decode_tick()
        self._dispatch_decode(n_steps)
        while len(self._inflight) > self._max_inflight:
            self._process_oldest_decode()

    def _dispatch_decode(self, n_steps: int):
        """Queue one decode call (single step or K-step block) for the
        current active set; its device result and the active-set snapshot go
        on ``_inflight`` for lagged processing."""
        t_disp = time.monotonic_ns()
        sp = self.spans
        span = sp.open("decode_dispatch", start=t_disp) if sp is not None else -1
        self._hist_dirty = True  # the card's histories miss these tokens
        self._dispatch_count += 1
        self.stat_decode_dispatches += 1
        self.stat_decode_steps += n_steps
        slots = sorted(self._active)
        snapshot = [(s, self._active[s]) for s in slots]
        key = (
            tuple(slots),
            tuple((r.temperature, r.top_k, r.top_p, r.min_p, r.presence_penalty,
                   r.frequency_penalty, r.repetition_penalty, r.logit_bias, r.seed, r.lora)
                  for _, r in snapshot),
        )
        if self._mask_cache is None or self._mask_cache[0] != key:
            active_mask = np.zeros((self.num_slots,), bool)
            active_mask[slots] = True
            # per-slot sampling parameters [temperature, top_k, top_p, min_p,
            # presence_penalty, frequency_penalty, repetition_penalty]
            samp = np.zeros((self.num_slots, 7), np.float32)
            samp[:, 2] = 1.0
            samp[:, 6] = 1.0
            seeds = np.full((self.num_slots,), -1, np.int32)
            lora_idx = np.zeros((self.num_slots,), np.int32)  # 0 = the base model
            bias = [()] * self.num_slots
            for s, req in snapshot:
                samp[s] = (req.temperature, req.top_k, req.top_p, req.min_p,
                           req.presence_penalty, req.frequency_penalty, req.repetition_penalty)
                bias[s] = req.logit_bias
                if req.seed is not None:
                    seeds[s] = req.seed
                if req.lora is not None:
                    lora_idx[s] = self._lora_index[req.lora]
            sampled, filtered = sampling_flags(samp)
            extras = None
            if any(_uses_penalties(r) for _, r in snapshot):
                extras = tuple(self._upload(a) for a in _bias_rows(
                    bias, self.cfg.text_config.vocab_size))
            seeded = sampled and bool(((seeds >= 0) & (samp[:, 0] > 0)).any())
            self._mask_cache = (
                key, self._upload(active_mask), self._upload(samp), sampled, filtered,
                self._upload(lora_idx) if self._lora_banks is not None else None,
                extras, self._upload(seeds) if seeded else None,
            )
        (_, mask_dev, samp_dev, sampled, filtered, lora_idx_dev, extras,
         seeds_dev) = self._mask_cache
        lm = _with_lora(self.params["language_model"], self._lora_banks, lora_idx_dev)
        tc = self.cfg.text_config
        lp = None
        if n_steps == 1:
            pen = {}
            if extras is not None:
                # the penalized step: counts advance inside it, on the card
                pen = dict(out_counts=self._pen_counts, prompt_mask=self._pen_prompt_mask,
                           bias_ids=extras[0], bias_vals=extras[1])
            toks, self.cache_lens, self.last_tokens, lp = _decode_all_slots(
                lm, tc, self.cache, self.last_tokens, self.cache_lens, mask_dev, samp_dev,
                self.generator, sampled, filtered,
                page_table=self.page_table if self.paged else None,
                decode_kernel=self.decode_kernel, seeds=seeds_dev,
                with_logprobs=any(r.logprobs for _, r in snapshot), **pen,
            )
        else:
            block = _decode_block_paged if self.paged else _decode_block
            extra = (self.page_table,) if self.paged else ()
            toks, self.cache_lens, self.last_tokens = block(
                lm, tc, self.cache, self.last_tokens, self.cache_lens, mask_dev, samp_dev,
                self.generator, sampled, filtered, *extra,
                n_steps=n_steps, attn_impl=self._seg_attn_impl,
            )
        t_end = time.monotonic_ns()
        self.stat_dispatch_s += (t_end - t_disp) * 1e-9
        if sp is not None:
            sp.close(span, n_steps, t_end)
        self._inflight.append(("decode", toks, snapshot, n_steps, lp))

    def _reset_spec_guard(self):
        """The health guard's cold start: probe mode when the guard is on, no
        pause, an empty window and no failed probes. Outside the constructor,
        call it only while the loop has nothing active or in flight, so that
        runs compared token for token see the same schedule."""
        self._spec_window: "collections.deque" = collections.deque(maxlen=32)
        self._spec_paused_flag = False
        self._spec_resume_at = 0
        self._spec_probe_mode = self.spec_min_accept > 0
        self._spec_fail_streak = 0

    def _spec_paused(self) -> bool:
        """True while the health guard holds speculation off. The pause ends
        after its period of dispatches, in probe mode (single rounds, a small
        window), so a workload that turns repetitive is found again."""
        if not self._spec_paused_flag:
            return False
        if self._dispatch_count >= self._spec_resume_at:
            self._spec_paused_flag = False
            self._spec_probe_mode = True
            self._spec_window.clear()
            return False
        return True

    def _spec_health_update(self, rounds: int, rows: int, accepted: int):
        """Feed one processed speculative dispatch's accepted counts to the
        window; pause speculation when the window's mean says verify rounds
        emit too few tokens to beat decode steps."""
        self.spec_rows += rows
        self.spec_accepted_sum += accepted
        if self.spec_min_accept <= 0:
            return
        self._spec_window.append((rounds, rows, accepted))
        total_rounds = sum(w[0] for w in self._spec_window)
        need = self._spec_probe_evidence_rounds if self._spec_probe_mode else 24
        if total_rounds < need:
            return  # not enough evidence yet
        total_rows = sum(w[1] for w in self._spec_window)
        mean = sum(w[2] for w in self._spec_window) / max(total_rows, 1)
        if mean < self.spec_min_accept:
            if self._spec_probe_mode:
                # a failed probe: back off exponentially
                self._spec_fail_streak += 1
            period = self.spec_probe_period * min(
                2 ** max(self._spec_fail_streak - 1, 0), self._spec_backoff_cap)
            self._spec_paused_flag = True
            self._spec_probe_mode = False
            self._spec_resume_at = self._dispatch_count + period
            self._spec_window.clear()
            self.spec_autopauses += 1
            logger.info(
                "speculation paused: windowed acceptance %.2f tok/round/slot < %.2f floor "
                "(re-probe after %d dispatches)", mean, self.spec_min_accept, period)
        elif self._spec_probe_mode:
            # a healthy probe: multi-round speculation again, no backoff
            self._spec_probe_mode = False
            self._spec_fail_streak = 0

    def _sync_spec_hist(self):
        """Upload the active slots' token histories (prompt and everything
        emitted). Called only after a drain, when the host's tokens are
        exact: a history holds cache_lens + 1 tokens (the last sampled token
        is in it but not yet in the cache)."""
        hist = np.zeros((self.num_slots, self.max_seq_len), np.int32)
        for s, req in self._active.items():
            toks = np.concatenate(
                [req.token_ids, np.asarray(req.emitted_ids, np.int32)])[: self.max_seq_len]
            hist[s, : len(toks)] = toks
        self.token_hist = self._upload(hist)
        self._hist_dirty = False

    def _dispatch_spec(self, headroom: int) -> bool:
        """Queue one speculative dispatch: a multi-round block when
        ``headroom`` (cache capacity less the in-flight lag) covers its worst
        case, else one round. Returns False when the drain before the
        history upload finished every active request."""
        key = tuple((s, self._active[s].request_id) for s in sorted(self._active))
        sp = self.spans
        if self._hist_dirty or self._spec_key != key:
            # the card's history is stale: retire in-flight work so the
            # host's tokens are exact, then upload
            t_sync = time.monotonic_ns()
            span = sp.open("spec_sync", start=t_sync) if sp is not None else -1
            self.spec_syncs += 1
            self._drain_decodes()
            if self._active:
                headroom = self.max_seq_len - 1 - max(
                    r.prompt_len + r.generated for r in self._active.values())
            # at the cache edge a round could lose accepted tokens' k/v
            upload = bool(self._active) and headroom >= self.spec_k + 1
            if upload:
                self._sync_spec_hist()
                # the set the upload covered (the drain may have finished some)
                key = tuple((s, self._active[s].request_id) for s in sorted(self._active))
                self._spec_key = key
            t_end = time.monotonic_ns()
            self.spec_sync_s += (t_end - t_sync) * 1e-9
            if sp is not None:
                sp.close(span, end=t_end)
            if not self._active:
                return False
            if not upload:
                # the drain brought a request to the cache edge
                self._dispatch_decode(1)
                return True
        t_disp = time.monotonic_ns()
        span = sp.open("spec_dispatch", start=t_disp) if sp is not None else -1
        worst = self.spec_k + 1
        n_rounds = 1
        if self._spec_probe_mode:
            self.spec_probe_dispatches += 1
        elif self.spec_rounds > 1:
            for nr in self._spec_round_buckets:
                if headroom >= nr * worst:
                    n_rounds = nr
                    worst = nr * worst
                    break
            else:
                self.spec_single_dispatches += 1
        else:
            self.spec_single_dispatches += 1
        slots = sorted(self._active)
        snapshot = [(s, self._active[s]) for s in slots]
        if self._spec_cache is None or self._spec_cache[0] != key:
            active_mask = np.zeros((self.num_slots,), bool)
            active_mask[slots] = True
            # greedy rows temperature 0 (argmax acceptance); sampled rows
            # rejection-sample with their own filters
            samp = np.zeros((self.num_slots, 4), np.float32)
            samp[:, 2] = 1.0
            lora_idx = np.zeros((self.num_slots,), np.int32)  # 0 = the base model
            for s, req in snapshot:
                samp[s] = (req.temperature, req.top_k, req.top_p, req.min_p)
                if req.lora is not None:
                    lora_idx[s] = self._lora_index[req.lora]
            sampled, filtered = sampling_flags(samp)
            self._spec_cache = (
                key, self._upload(active_mask), self._upload(samp), sampled, filtered,
                self._upload(lora_idx) if self._lora_banks is not None else None,
            )
        _, mask_dev, samp_dev, sampled, filtered, lora_idx_dev = self._spec_cache
        lm = _with_lora(self.params["language_model"], self._lora_banks, lora_idx_dev)
        tc = self.cfg.text_config
        args = (lm, tc, self.cache, self.token_hist, self.last_tokens, self.cache_lens, mask_dev,
                samp_dev, self.generator, sampled, filtered)
        if n_rounds > 1:
            block = _spec_decode_block_paged if self.paged else _spec_decode_block
            extra = (self.page_table,) if self.paged else ()
            out, accepted, self.cache_lens, self.last_tokens = block(
                *args, *extra, K=self.spec_k, ngram=self.spec_ngram, n_rounds=n_rounds,
                attn_impl=self._seg_attn_impl,
            )
        else:
            out, accepted, self.cache_lens, self.last_tokens = _spec_decode_all_slots(
                *args, K=self.spec_k, ngram=self.spec_ngram,
                page_table=self.page_table if self.paged else None,
            )
        self.spec_dispatches += n_rounds
        self._dispatch_count += 1
        t_end = time.monotonic_ns()
        self.stat_dispatch_s += (t_end - t_disp) * 1e-9
        if sp is not None:
            sp.close(span, n_rounds, t_end)
        self._inflight.append(("spec", out, accepted, snapshot, worst))
        return True

    def _process_oldest_decode(self):
        """Fetch the oldest in-flight result and emit its tokens. Slots whose
        request finished in an earlier (lagged) dispatch, or was replaced by
        a newer admission, drop their columns."""
        t_fetch = time.monotonic_ns()
        sp = self.spans
        span = -1
        if sp is not None:
            head = self._inflight[0]  # a first token's fetch carries its request
            span = sp.open("fetch", head[2].request_id if head[0] == "first" else -1, t_fetch)
        try:
            self._process_oldest_decode_inner(sp)
        finally:
            # the read-back waits for the card: this is where the loop
            # waits; everything else is dispatch
            t_end = time.monotonic_ns()
            self.stat_fetch_wait_s += (t_end - t_fetch) * 1e-9
            if sp is not None:
                sp.close(span, end=t_end)

    def _process_oldest_decode_inner(self, sp: Optional[SpanRecorder]):
        """The oldest in-flight entry's results read back to the host (the
        loop's only waits for the card), then handed out."""
        entry = self._inflight.popleft()
        span = sp.open("readback") if sp is not None else -1
        if entry[0] == "first":
            lp1 = entry[3]
            host = (int(entry[1].cpu()[0]),
                    None if lp1 is None else tuple(x.cpu().numpy() for x in lp1))
        elif entry[0] == "spec":
            host = (entry[1].cpu().numpy(), entry[2].cpu().numpy())
        else:
            lp = entry[4]
            host = (entry[1].cpu().numpy(),
                    None if lp is None else tuple(x.cpu().numpy() for x in lp))
        if sp is not None:
            sp.close(span)
            span = sp.open("emit")
        n = self._emit_fetched(entry, *host)
        if sp is not None:
            sp.close(span, n)

    def _emit_fetched(self, entry, values, extra) -> int:
        """Emit an in-flight entry's read-back tokens (``values``, with
        ``extra`` its logprobs or, for a speculative entry, its accepted
        counts). Returns the number of ``_emit`` calls."""
        if entry[0] == "first":
            # a prefill-completion token (stream order holds: the queue is
            # FIFO and this was appended before any decode of the slot)
            req = entry[2]
            if self._active.get(req.slot) is not req:
                return 0
            self._emit(req, values, lp=_lp_row(extra, 0))
            return 1
        n = 0
        if entry[0] == "spec":
            # each slot's accepted tokens, 1 to K+1 a round; a request that
            # finished in an earlier (lagged) dispatch drops its columns
            snapshot = entry[3]
            out_np, acc_np = values, extra
            if out_np.ndim == 2:  # one round: (1, B, K+1)
                out_np, acc_np = out_np[None], acc_np[None]
            n_rounds = out_np.shape[0]
            slots = [s for s, _ in snapshot]
            self._spec_health_update(
                n_rounds, n_rounds * max(len(slots), 1),
                int(acc_np[:, slots].sum()) if slots else 0)
            for r in range(n_rounds):
                for s, req in snapshot:
                    for j in range(int(acc_np[r, s])):
                        if self._active.get(s) is not req:
                            self.spec_wasted_tokens += int(acc_np[r, s]) - j
                            break
                        tok = int(out_np[r, s, j])
                        if tok not in req.stop_token_ids:
                            # a stop token finishes without being delivered
                            self.spec_emitted_tokens += 1
                        self._emit(req, tok)
                        n += 1
            return n
        snapshot = entry[2]
        toks_np, lp_np = values, extra
        if toks_np.ndim == 1:
            toks_np = toks_np[:, None]
        for s, req in snapshot:
            for j in range(toks_np.shape[1]):
                if self._active.get(s) is not req:
                    break  # finished; later columns are dropped
                row = _lp_row(lp_np, s) if req.logprobs else None
                self._emit(req, int(toks_np[s, j]), lp=row)
                n += 1
        return n

    def _drain_decodes(self):
        while self._inflight:
            self._process_oldest_decode()

    def _cancel_one(self, rid: int):
        req = self._requests.get(rid)
        if req is None:
            return  # already finished (or never existed)
        req.cancelled = True  # pending requests drop at admission
        for i, job in enumerate(self._prefilling):
            if job.req.request_id == rid:
                self._prefilling.pop(i)
                if self.paged:
                    self._release_slot_pages(req.slot)
                if job.prefix_src_slot >= 0:
                    self._unpin(job.prefix_src_slot)
                self._free_slots.append(req.slot)
                req.slot = -1
                self._finish_cancelled(req)
                return
        if self._active.get(req.slot) is req:
            del self._active[req.slot]
            self._free_slots.append(req.slot)
            if self.paged:
                self._release_slot_pages(req.slot)
            self.cache_lens[req.slot].fill_(0)
            self._finish_cancelled(req)
            return
        # still pending (queued, no slot): acknowledge now; the stale queue
        # entry drops at admission
        self._finish_cancelled(req)

    def _finish_cancelled(self, req: Request):
        if req.request_id not in self._requests:
            return  # already acknowledged
        # event before untracking: stream() treats an untracked request with
        # an empty queue as lost
        req.out_queue.put(StreamEvent(token_id=None, finish_reason="cancelled"))
        self._requests.pop(req.request_id, None)

    def _emit(self, req: Request, token_id: int, lp=None):
        if req.first_emit_time is None:
            req.first_emit_time = time.monotonic()
        finish = None
        if token_id in req.stop_token_ids:
            finish = "stop"
        else:
            req.generated += 1
            req.emitted_ids.append(token_id)
            ev = StreamEvent(token_id=token_id)
            if lp is not None:
                ev.logprob = lp[0]
                n = min(req.top_logprobs, len(lp[1]))
                ev.top_ids = lp[1][:n]
                ev.top_logprobs = lp[2][:n]
            req.out_queue.put(ev)
            if req.generated >= req.max_tokens:
                finish = "length"
            if finish is None and req.prompt_len + req.generated >= self.max_seq_len - 1:
                finish = "cache_full"
        if finish is None:
            return
        req.finish_time = time.monotonic()
        # the TTFT a client sees: to the first event handed to its queue
        ttft = req.first_emit_time - req.submit_time
        req.out_queue.put(StreamEvent(token_id=None, finish_reason=finish, ttft_s=ttft))
        if req.slot in self._active:
            del self._active[req.slot]
            self._free_slots.append(req.slot)
            self.cache_lens[req.slot].fill_(0)
            # retain the slot's cache for conversation-prefix reuse. Its rows
            # hold the prompt and every emitted token on "stop" (the stop
            # token was sampled but never written), else the prompt and all
            # but the last emitted token (sampled, not yet written)
            if req.token_ids is not None:
                kept = req.emitted_ids if finish == "stop" else req.emitted_ids[:-1]
                entry = RetainedCache(
                    token_ids=np.concatenate(
                        [req.token_ids, np.asarray(kept, req.token_ids.dtype)]
                    ),
                    audio_spans=req.audio_spans,
                    lora=req.lora,
                )
                self._retained[req.slot] = entry
                if self.paged:
                    # keep only the pages covering resident tokens: the
                    # decode reserve was never written
                    self._trim_slot_pages(req.slot, len(entry.token_ids))
            elif self.paged:
                self._release_slot_pages(req.slot)
        self._requests.pop(req.request_id, None)


# the Request fields a mesh's rank 0 broadcasts: the options and inputs
_PLAN_FIELDS = (
    "request_id", "batch", "max_tokens", "temperature", "top_k", "top_p", "min_p",
    "presence_penalty", "frequency_penalty", "repetition_penalty", "logit_bias", "seed", "lora",
    "logprobs", "top_logprobs", "stop_token_ids", "audio_spans", "audio_embeds")


def _drain(q: "queue.Queue") -> list:
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


def _local_qkv_banks(banks, split):
    """Encoder banks with the q/k/v targets' ``b`` cut to this tensor
    rank's columns, to be fused over the rank's fused q/k/v leaf."""
    out = dict(banks)
    for tgt in ("q_proj", "k_proj", "v_proj"):
        if tgt in out:
            b = out[tgt]["b"]
            out[tgt] = dict(out[tgt], b=b.chunk(split.size, -1)[split.index].contiguous())
    return out


# --------------------------------------------------------------------------
# device programs (eager; caches are updated in place)
# --------------------------------------------------------------------------


def _lora_banks(adapters):
    """(decoder banks, encoder banks, index, names of the adapters with an
    encoder half) of ``lora_adapters``: name -> a tree with
    ``language_model`` and/or ``audio_tower`` adapters, or a bare LM tree.
    Both towers are banked over one sorted-name index; a tower no adapter
    targets has no banks (None)."""
    if not adapters:
        return None, None, {}, frozenset()

    def has_lora(tree) -> bool:
        return isinstance(tree, dict) and any(
            k == "lora_a" or has_lora(v) for k, v in tree.items())

    lms, encs = {}, {}
    for name, tree in adapters.items():
        lm = tree.get("language_model")
        if lm is None and "audio_tower" not in tree:
            lm = tree  # a bare LM adapter tree
        lms[name] = lm if has_lora(lm) else {"layers": {}}
        tower = tree.get("audio_tower")
        encs[name] = tower if has_lora(tower) else {"layers": {}}
    n_lm = sum(has_lora(t) for t in lms.values())
    n_enc = sum(has_lora(t) for t in encs.values())
    if not (n_lm or n_enc):
        raise ValueError("no lora_a leaves found in any adapter (neither language_model nor "
                         "audio_tower)")
    lm_banks = enc_banks = None
    if n_lm:
        lm_banks, index = lora_lib.build_lora_banks(lms)
    if n_enc:
        enc_banks, index = lora_lib.build_lora_banks(encs)  # the same names, the same index
    enc_names = frozenset(name for name, t in encs.items() if has_lora(t))
    return lm_banks, enc_banks, index, enc_names


def _validate_enc_lora_banks(tower, banks) -> None:
    """Construction-time check that the encoder banks apply to the served
    audio tower (possibly fused or int8): every banked target exists with
    matching (layers, in, out)."""
    layers = tower.get("layers") if isinstance(tower, dict) else None
    if not isinstance(layers, dict):
        raise ValueError("lora_adapters carry audio_tower (encoder) adapters but the served "
                         "params have no audio tower")
    for tgt, bank in banks.items():
        proj = layers.get(tgt)
        kern = proj.get("kernel", proj.get("kernel_q")) if isinstance(proj, dict) else None
        if kern is None:
            have = sorted(k for k, v in layers.items()
                          if isinstance(v, dict) and ("kernel" in v or "kernel_q" in v))
            raise ValueError(f"encoder LoRA adapters target {tgt!r}, which the served audio "
                             f"tower does not have (tower projections: {have})")
        L, d_in, d_out = bank["a"].shape[0], bank["a"].shape[-2], bank["b"].shape[-1]
        shape = full_shape(kern)  # a split kernel's banks stay whole
        if (shape[0], shape[-2], shape[-1]) != (L, d_in, d_out):
            raise ValueError(f"encoder LoRA bank for {tgt!r} is shaped for (layers={L}, "
                             f"d_in={d_in}, d_out={d_out}) but the served tower's projection is "
                             f"{tuple(kern.shape)}")


def _embed_prompt(params, batch, enc_banks=None, enc_idx=None, *, cfg: UltravoxConfig,
                  encoder_attn_impl: str = "xla"):
    """Prompt embeddings (1, T, D) with the audio embeddings spliced in: the
    audio tower runs once per request; the LLM prefill is chunked. With
    encoder banks the request's adapter (0-dim ``enc_idx``, 0 for the base
    model) is gathered into the tower first."""
    if enc_banks is not None:
        params = dict(params)
        params["audio_tower"] = lora_lib.apply_lora_banks(params["audio_tower"], enc_banks, enc_idx)
    return uv.ultravox_embed(params, cfg, batch["input_ids"], batch,
                             encoder_attn_impl=encoder_attn_impl)


def _embed_precomputed(params, input_ids, audio_embeds, starts, lens, bidx):
    """Prompt embeddings from precomputed audio token embeddings: text
    embedding lookup + splice, no audio tower."""
    emb = decoder_lib.embed_lookup(params["language_model"], input_ids)
    return uv.splice_audio_embeds(emb, audio_embeds.to(emb.dtype), starts, lens, bidx)


def _with_lora(lm, lora_banks, lora_idx):
    """The LM tree with each row's adapter gathered from the banks (no-op
    without banks)."""
    if lora_banks is None:
        return lm
    return lora_lib.apply_lora_banks(lm, lora_banks, lora_idx)


def _prefill_chunk_impl(
    params, cache, embeds_chunk, slot: int, start_pos: int, prompt_len: int, *, cfg,
    prefill_kernel: bool = False, lora_banks=None, lora_idx=None,
):
    """Prefill one chunk of prompt embeddings into row ``slot`` of the slot
    cache (through a view of the row, so the writes land in the cache).
    Returns the logits of the last valid prompt position (meaningful on the
    final chunk)."""
    row = decoder_lib.KVCache(
        k=cache.k[:, slot: slot + 1], v=cache.v[:, slot: slot + 1], spare=cache.spare
    )
    return _prefill_chunk_scratch_impl(
        params, row, embeds_chunk, start_pos, prompt_len, cfg=cfg, prefill_kernel=prefill_kernel,
        lora_banks=lora_banks, lora_idx=lora_idx,
    )


def _prefill_chunk_scratch_impl(
    params, scratch, embeds_chunk, start_pos: int, prompt_len: int, *, cfg,
    prefill_kernel: bool = False, lora_banks=None, lora_idx=None,
):
    """One prompt chunk (1, C, D) at positions [start_pos, start_pos + C)
    into a one-row contiguous cache: a slot row, or paged mode's scratch.
    Padding past prompt_len is written but masked by the valid length (and
    later by cache_lens)."""
    tc = cfg.text_config
    lm = _with_lora(params["language_model"], lora_banks, lora_idx)
    C = embeds_chunk.shape[1]
    dev = embeds_chunk.device
    positions = (start_pos + torch.arange(C, device=dev))[None]
    valid = min(start_pos + C, prompt_len)
    hidden, _ = decoder_lib.decoder_forward(
        lm, tc,
        inputs_embeds=embeds_chunk,
        positions=positions,
        kv_valid_len=torch.full((1,), valid, dtype=torch.int32, device=dev),
        cache=scratch,
        write_pos=torch.full((1,), start_pos, dtype=torch.int32, device=dev),
        return_hidden=True,
        prefill_kernel=prefill_kernel,
    )
    last_idx = min(max(prompt_len - 1 - start_pos, 0), C - 1)
    return decoder_lib.compute_logits(lm, tc, hidden[:, last_idx])


def _pages_to_scratch(pool, table_row, scratch):
    """Load a retained prefix from the pool into the contiguous scratch: the
    request's pages in table order, as many as the scratch holds. Positions
    past the resident tokens are garbage that prompt_len masks."""
    Ts = scratch.max_len
    P, ps = pool.num_pages, pool.page_size
    n_need = -(-Ts // ps)
    ids = table_row[0, :n_need].long().clamp(0, P - 1)
    L, Hkv, Dh = pool.k.shape[0], pool.k.shape[3], pool.k.shape[4]
    for src, dst in ((pool.k, scratch.k), (pool.v, scratch.v)):
        pages = src[:, ids].reshape(L, n_need * ps, Hkv, Dh)
        dst[:, 0, :Ts] = pages[:, :Ts]


def _scratch_to_pages(pool, scratch, table_row):
    """Scatter the scratch row into the pool as whole pages through the
    request's table row. Sentinel (unallocated) entries go to the write-only
    page; reserved decode pages beyond the prompt take scratch garbage,
    which decode overwrites before it becomes visible."""
    L, _, ps, Hkv, Dh = pool.k.shape
    P = pool.num_pages
    n_per = table_row.shape[1]
    Ts = scratch.max_len
    ids = table_row[0].long().clamp(0, P)
    for dst, src in ((pool.k, scratch.k), (pool.v, scratch.v)):
        s = src[:, 0, :Ts]
        pad = n_per * ps - Ts
        s = F.pad(s, (0, 0, 0, 0, 0, pad)) if pad > 0 else s[:, : n_per * ps]
        dst[:, ids] = s.reshape(L, n_per, ps, Hkv, Dh).to(dst.dtype)


def _sample_slots(logits, samp, generator, sampled: bool, filtered: bool, seeds=None,
                  positions=None):
    """Per-slot sampling: greedy where temperature == 0, with per-slot
    top-k / top-p / min-p and seeded noise for rows with seed >= 0; the
    branches are the host's."""
    return sample_slots(logits, samp, generator, sampled=sampled, filtered=filtered,
                        seeds=seeds, positions=positions)


def _first_token_extras(logits, samp, counts_row, mask_row, bias_ids, bias_vals):
    """Penalties + logit_bias for the prefill-completion (first) token: the
    output counts are all zero here, so presence and frequency are no-ops
    and the repetition penalty applies over the prompt mask; the same
    arithmetic as the penalized step."""
    return apply_penalties(logits, counts_row, mask_row, samp).scatter_add_(1, bias_ids, bias_vals)


def _decode_all_slots(
    lm, tc, cache, tokens, cache_lens, active_mask, samp, generator, sampled: bool,
    filtered: bool, *, page_table=None, decode_kernel: bool = False, out_counts=None,
    prompt_mask=None, bias_ids=None, bias_vals=None, seeds=None, with_logprobs: bool = False,
):
    """One decode step for every slot with per-slot sampling. Inactive slots
    keep their length and last token; their logits are computed and
    ignored, and their k/v writes go to spare storage (a freed slot's length
    is 0, so a live write would clobber position 0 of its retained cache).

    With ``out_counts`` (the penalized step): presence / frequency /
    repetition penalties (``samp`` columns 4..6) from the per-slot output
    counts and prompt mask, then ``logit_bias``; the counts advance in place
    by each active slot's sampled token (inactive slots add 0). ``seeds``:
    rows with seed >= 0 draw at position ``cache_lens + 1``. Returns
    (sampled (B,), new lengths, new last tokens, logprob stats of the final
    logits when ``with_logprobs``, else None)."""
    if page_table is not None:
        max_len = page_table.shape[1] * cache.page_size
    else:
        max_len = cache.max_len
    embeds = decoder_lib.embed_lookup(lm, tokens)[:, None]
    write_pos = torch.where(active_mask, cache_lens, max_len)
    logits, _ = decoder_lib.decoder_forward(
        lm, tc,
        inputs_embeds=embeds,
        positions=cache_lens[:, None],
        kv_valid_len=cache_lens + 1,
        cache=cache,
        page_table=page_table,
        write_pos=write_pos,
        decode_kernel=decode_kernel,
    )
    logits = logits[:, 0]
    if out_counts is not None:
        # logit_bias (_bias_rows' padding adds 0.0 at id 0)
        logits = apply_penalties(logits, out_counts, prompt_mask, samp).scatter_add_(
            1, bias_ids, bias_vals)
    positions = None if seeds is None else cache_lens + 1
    toks = _sample_slots(logits, samp, generator, sampled, filtered, seeds, positions)
    if out_counts is not None:
        out_counts.scatter_add_(1, toks.long()[:, None], active_mask[:, None].to(torch.int32))
    new_lens = torch.where(active_mask, cache_lens + 1, cache_lens)
    new_last = torch.where(active_mask, toks, tokens)
    lp = token_logprobs(logits, toks) if with_logprobs else None
    return toks, new_lens, new_last, lp


def _decode_block(
    lm, tc, cache, tokens, cache_lens, active_mask, samp, generator, sampled: bool,
    filtered: bool, *, n_steps: int, attn_impl: str = "xla",
):
    """``n_steps`` decode steps for every slot in one dispatch: the
    segmented scan against the slot cache (read-only; new k/v go to a small
    tail), then the tail is scattered back at per-slot offsets. Inactive
    slots' tail writes go to the spare positions. Returns (tokens (B,
    n_steps), new lengths, new last tokens)."""
    toks, tail = decoder_lib.segmented_decode_scan(
        lm, tc, cache, cache_lens, tokens, n_steps=n_steps,
        sample_fn=lambda logits: _sample_slots(logits, samp, generator, sampled, filtered),
        return_tail=True, attn_impl=attn_impl,
    )
    B = tokens.shape[0]
    dev = tokens.device
    bidx = torch.arange(B, device=dev)[:, None]
    steps = torch.arange(n_steps, device=dev)[None]
    tpos = torch.where(active_mask[:, None], cache_lens.long()[:, None] + steps,
                       cache.max_len + steps).clamp(max=cache.k.shape[2] - 1)
    cache.k[:, bidx, tpos] = tail.k
    cache.v[:, bidx, tpos] = tail.v
    new_toks = toks[:, 1:]
    new_lens = torch.where(active_mask, cache_lens + n_steps, cache_lens)
    new_last = torch.where(active_mask, new_toks[:, -1], tokens)
    return new_toks, new_lens, new_last


def _paged_view(pool, page_table):
    """Contiguous (L, B, n_per * page_size, Hkv, Dh) views of every row's
    pages: the ``gather_pages`` kernel for CUDA tensors, its plain version
    (the clamped ``index_select``) for CPU ones."""
    k, v = pool.pool()
    return gather_pages(k, v, page_table)


def _decode_block_paged(
    lm, tc, pool, tokens, cache_lens, active_mask, samp, generator, sampled: bool,
    filtered: bool, page_table, *, n_steps: int, attn_impl: str = "xla",
):
    """Paged multi-step decode: ``n_steps`` steps in one dispatch. With
    ``attn_impl="kernel"`` the paged segment kernel reads each row's live
    pages directly; otherwise the pool's pages are gathered once per block
    into a contiguous view and the scan runs against it as in slot mode.
    Either way the tail publishes into the pool as one per-token page
    scatter at the end; tokens past a reservation and inactive slots go to
    the write-only page."""
    P, ps = pool.num_pages, pool.page_size
    S = page_table.shape[1] * ps
    if attn_impl == "kernel":
        prompt_cache, scan_table = pool, page_table
    else:
        vk, vv = _paged_view(pool, page_table)
        prompt_cache, scan_table = decoder_lib.KVCache(k=vk, v=vv), None
    toks, tail = decoder_lib.segmented_decode_scan(
        lm, tc, prompt_cache, cache_lens, tokens, n_steps=n_steps,
        sample_fn=lambda logits: _sample_slots(logits, samp, generator, sampled, filtered),
        return_tail=True, attn_impl=attn_impl, page_table=scan_table,
    )
    write_pos = torch.where(active_mask, cache_lens, S)
    page, off = decoder_lib.paged_write_indices(page_table, write_pos, n_steps, ps, P)
    pool.k[:, page, off] = tail.k.to(pool.k.dtype)
    pool.v[:, page, off] = tail.v.to(pool.v.dtype)
    new_toks = toks[:, 1:]
    new_lens = torch.where(active_mask, cache_lens + n_steps, cache_lens)
    new_last = torch.where(active_mask, new_toks[:, -1], tokens)
    return new_toks, new_lens, new_last


# --------------------------------------------------------------------------
# prompt-lookup speculative decoding (device programs)
# --------------------------------------------------------------------------


def _ngram_drafts(hist, hist_len, K: int, ngram: int, ngram_min: int = 1):
    """Prompt-lookup drafts on the card: for each row, the K tokens that
    followed the most recent earlier occurrence of the longest final n-gram
    of its history (n from ``ngram`` down to ``ngram_min``). A row with no
    match gets arbitrary drafts, which verification rejects at position 0
    (the dispatch still emits its one certain token).

    ``hist``: (B, S) int32 history; ``hist_len``: (B,) its valid tokens
    (prompt and everything sampled). Returns (B, K) int32."""
    B, S = hist.shape
    dev = hist.device
    hl = hist_len.long()
    best_start = torch.full((B,), -1, dtype=torch.int64, device=dev)
    for n in range(ngram, ngram_min - 1, -1):
        W = S - n + 1  # candidate window starts
        jpos = torch.arange(W, device=dev)
        # start j matches iff hist[j:j+n] equals the final n-gram and its
        # continuation j+n is a known token (j < hl - n, which also keeps
        # the final n-gram from matching itself)
        m = jpos[None] < (hl - n)[:, None]
        for t in range(n):
            ctx_t = hist.gather(1, (hl - n + t).clamp(0, S - 1)[:, None])  # (B, 1)
            m &= hist[:, t: t + W] == ctx_t
        jstar = torch.where(m, jpos[None], -1).amax(dim=1)  # -1 = none
        best_start = torch.where((best_start < 0) & (jstar >= 0), jstar + n, best_start)
    start = best_start.clamp(0, max(S - K, 0))
    cols = (start[:, None] + torch.arange(K, device=dev)[None]).clamp(max=S - 1)
    return hist.gather(1, cols).to(torch.int32)


def _spec_accept(logits, drafts, samp, generator, sampled: bool, filtered: bool, hist_len):
    """The engine's acceptance rule: ``spec_accept_slots`` with the rows'
    sampling parameters; emit position i of a row is position hist_len + i."""
    return spec_accept_slots(logits, drafts, samp, generator, sampled=sampled, filtered=filtered,
                             positions=hist_len)


def _spec_decode_all_slots(
    lm, tc, cache, hist, tokens, cache_lens, active_mask, samp, generator, sampled: bool,
    filtered: bool, *, K: int, ngram: int, page_table=None,
):
    """One speculative round for every slot: K drafts a slot from the card's
    history (``_ngram_drafts``), then ``[last_token, drafts]`` verified in
    one (K+1)-token ``decoder_forward`` against the cache (the plain
    ``mha``; in paged mode over the gathered view of each row's pages), and
    the accepted run emitted. Every position's k/v is written; cache_lens
    advances only past the accepted tokens, so rejected ones stay invisible
    until overwritten. Inactive slots' writes go to spare storage and they
    accept 0. The accepted tokens are appended to ``hist`` in place.
    Returns (out (B, K+1), accepted (B,), new lengths, new last tokens)."""
    B = tokens.shape[0]
    T = K + 1
    dev = tokens.device
    hl = cache_lens + 1  # known tokens, the pending last token included
    drafts = _ngram_drafts(hist, hl, K, ngram)
    toks = torch.cat([tokens[:, None].to(torch.int32), drafts], dim=1)  # (B, T)
    if page_table is not None:
        max_len = page_table.shape[1] * cache.page_size
    else:
        max_len = cache.max_len
    positions = cache_lens[:, None] + torch.arange(T, dtype=torch.int32, device=dev)[None]
    write_pos = torch.where(active_mask, cache_lens, max_len)
    logits, _ = decoder_lib.decoder_forward(
        lm, tc, input_ids=toks, positions=positions, kv_valid_len=cache_lens + T, cache=cache,
        page_table=page_table, write_pos=write_pos,
    )
    out, accepted = _spec_accept(logits, drafts, samp, generator, sampled, filtered, hl)
    accepted = torch.where(active_mask, accepted, 0)
    new_lens = cache_lens + accepted
    bidx = torch.arange(B, device=dev)
    new_last = torch.where(active_mask, out[bidx, accepted.clamp(min=1).long() - 1], tokens)
    decoder_lib.append_accepted(hist, hl, out, accepted)
    return out, accepted, new_lens, new_last


def _spec_scan(lm, tc, prompt_cache, hist, tokens, cache_lens, samp, generator, sampled: bool,
               filtered: bool, *, K: int, ngram: int, n_rounds: int, attn_impl: str,
               page_table=None):
    """``n_rounds`` rounds of ``decoder.segmented_spec_scan`` with the
    engine's drafting and acceptance."""
    return decoder_lib.segmented_spec_scan(
        lm, tc, prompt_cache, cache_lens, tokens, hist,
        lambda h, hl: _ngram_drafts(h, hl, K, ngram),
        lambda logits, drafts, hl: _spec_accept(logits, drafts, samp, generator, sampled,
                                                filtered, hl),
        n_rounds=n_rounds, K=K, attn_impl=attn_impl, page_table=page_table,
    )


def _spec_decode_block(
    lm, tc, cache, hist, tokens, cache_lens, active_mask, samp, generator, sampled: bool,
    filtered: bool, *, K: int, ngram: int, n_rounds: int, attn_impl: str = "xla",
):
    """``n_rounds`` speculative rounds for every slot in one dispatch against
    the slot cache (``segmented_spec_scan``: the cache is only read; with
    ``attn_impl="kernel"`` through the ``segment_tail_attention`` kernel at
    q (B, K+1, H, D)). The accepted tokens' tail k/v is then written at each
    row's length; rejected positions and inactive slots go to the spare
    position. Returns (outs (n_rounds, B, K+1), accepts (n_rounds, B), new
    lengths, new last tokens)."""
    outs, accepts, tail, written, last, _ = _spec_scan(
        lm, tc, cache, hist, tokens, cache_lens, samp, generator, sampled, filtered, K=K,
        ngram=ngram, n_rounds=n_rounds, attn_impl=attn_impl,
    )
    B = tokens.shape[0]
    Ts = n_rounds * (K + 1)
    dev = tokens.device
    bidx = torch.arange(B, device=dev)[:, None]
    t = torch.arange(Ts, device=dev)[None]
    valid = (t < written.long()[:, None]) & active_mask[:, None]
    tpos = torch.where(valid, cache_lens.long()[:, None] + t, cache.max_len).clamp(
        max=cache.k.shape[2] - 1)
    cache.k[:, bidx, tpos] = tail.k.to(cache.k.dtype)
    cache.v[:, bidx, tpos] = tail.v.to(cache.v.dtype)
    written = torch.where(active_mask, written, 0)
    accepts = accepts * active_mask[None].to(accepts.dtype)
    return outs, accepts, cache_lens + written, torch.where(active_mask, last, tokens)


def _spec_decode_block_paged(
    lm, tc, pool, hist, tokens, cache_lens, active_mask, samp, generator, sampled: bool,
    filtered: bool, page_table, *, K: int, ngram: int, n_rounds: int, attn_impl: str = "xla",
):
    """Paged speculative rounds. With ``attn_impl="kernel"`` the verify
    attention reads each row's pool pages directly
    (``paged_segment_tail_attention``); otherwise the pages are gathered
    once into a contiguous view (``gather_pages``) and the scan runs on it as
    in slot mode. Either way the accepted tail publishes as one per-token
    page scatter (rejected and inactive positions to the write-only page)."""
    P, ps = pool.num_pages, pool.page_size
    if attn_impl == "kernel":
        prompt_cache, scan_table = pool, page_table
    else:
        vk, vv = _paged_view(pool, page_table)
        prompt_cache, scan_table = decoder_lib.KVCache(k=vk, v=vv), None
    outs, accepts, tail, written, last, _ = _spec_scan(
        lm, tc, prompt_cache, hist, tokens, cache_lens, samp, generator, sampled, filtered, K=K,
        ngram=ngram, n_rounds=n_rounds, attn_impl=attn_impl, page_table=scan_table,
    )
    Ts = n_rounds * (K + 1)
    t = torch.arange(Ts, device=tokens.device)[None]
    valid = (t < written.long()[:, None]) & active_mask[:, None]
    pos = torch.where(valid, cache_lens.long()[:, None] + t, -1)
    page, off = decoder_lib.paged_positions_to_indices(page_table, pos, ps, P)
    pool.k[:, page, off] = tail.k.to(pool.k.dtype)
    pool.v[:, page, off] = tail.v.to(pool.v.dtype)
    written = torch.where(active_mask, written, 0)
    accepts = accepts * active_mask[None].to(accepts.dtype)
    return outs, accepts, cache_lens + written, torch.where(active_mask, last, tokens)
