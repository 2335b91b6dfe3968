"""Generation engine: bucketed prefill into a KV cache, then decode.

The PyTorch counterpart of the JAX package's ``GenerationEngine``: the same
batch format, bucketing and results. ``generate`` decodes one token per
step through the whole cache; ``generate_fused`` runs the decode loop as
one segmented scan (``decoder.segmented_decode_scan``) with no host
synchronisation until its token matrix is read. The attention options are
``encoder_attn_impl`` (``"flash"``: the plain encoder with its attention in
the ``flash_attention`` kernel), ``prefill_attn_impl`` and ``decode_attn_impl``;
``quantize="int8"`` serves int8 weights in the decoder and the Whisper
tower, and a tree with one LoRA adapter runs it through ``proj_apply``. It
runs on the CUDA card unless the caller passes ``device="cpu"``; there is
no silent fallback, and a failed kernel build or launch raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ultravox_torch.models import decoder as decoder_lib
from ultravox_torch.models import ultravox as uv
from ultravox_torch.models.config import UltravoxConfig
from ultravox_torch.models.whisper_encoder import (
    ENCODER_ATTN_IMPLS,
    fuse_encoder_inference_params,
    quantize_encoder_int8,
)
from ultravox_torch.ops.sampling import sample_token

CACHE_BUCKET = 256


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


def _cache_bucket(need: int, cap: int) -> int:
    """Needed cache length rounded up to a multiple of CACHE_BUCKET (at most
    ``cap``), so decode reads only the KV it can use."""
    return min(cap, -(-need // CACHE_BUCKET) * CACHE_BUCKET)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ultravox_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[List[int]]  # generated ids per sequence (no prompt)
    prompt_lens: List[int]
    cache: Any = None  # with return_cache=True (conversation reuse)
    cache_lens: Any = None  # np (B,) valid cache entries per row


class GenerationEngine:
    """Owns the inference parameters, the KV cache budget and the sampler."""

    def __init__(
        self,
        params: Any,
        cfg: UltravoxConfig,
        *,
        max_cache_len: int = 2048,
        batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
        chunk_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128),
        cache_dtype=torch.bfloat16,
        stop_token_ids: Tuple[int, ...] = (),
        encoder_attn_impl: str = "xla",
        prefill_attn_impl: str = "xla",
        decode_attn_impl: str = "xla",  # "kernel" = the decode_attention kernel
        quantize: Optional[str] = None,  # "int8" = weight-only int8
        device=None,
        seed: int = 0,
    ):
        if encoder_attn_impl not in ENCODER_ATTN_IMPLS:
            raise ValueError(f"unknown encoder_attn_impl={encoder_attn_impl!r}")
        if prefill_attn_impl not in ("xla", "fused"):
            raise ValueError(f"unknown prefill_attn_impl={prefill_attn_impl!r}")
        if decode_attn_impl not in ("xla", "kernel"):
            raise ValueError(f"unknown decode_attn_impl={decode_attn_impl!r}")
        if quantize and quantize != "int8":
            raise ValueError(f"unsupported quantize={quantize!r}")
        self.device = resolve_device(device)
        params = _to_device(params, self.device)
        self.params = dict(params)
        # fused q/k/v and gate/up products (a no-op for LoRA'd trees), then
        # int8, then the fused encoder tree: the JAX engine's order
        self.params["language_model"] = decoder_lib.fuse_inference_params(
            params["language_model"], cfg.text_config
        )
        if quantize:
            self.params["language_model"] = decoder_lib.quantize_decoder_int8(
                self.params["language_model"])
            if "conv1" in self.params.get("audio_tower", {}):
                self.params["audio_tower"] = quantize_encoder_int8(self.params["audio_tower"])
        if encoder_attn_impl == "fused" and "audio_tower" in self.params:
            self.params["audio_tower"] = fuse_encoder_inference_params(self.params["audio_tower"])
        self.cfg = cfg
        self.max_cache_len = max_cache_len
        self.batch_buckets = batch_buckets
        self.chunk_buckets = chunk_buckets
        self.cache_dtype = cache_dtype
        self.stop_token_ids = tuple(stop_token_ids)
        self.encoder_attn_impl = encoder_attn_impl
        self.prefill_kernel = prefill_attn_impl == "fused"
        self.decode_kernel = decode_attn_impl == "kernel"
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _check_cache_budget(self, prompt_len: int, max_new_tokens: int, start_pos: int = 0) -> None:
        # the last sampled token is never written, so the last written
        # position is start + prompt + max_new - 2
        if start_pos + prompt_len + max_new_tokens > self.max_cache_len + 1:
            raise ValueError(
                f"prompt ({prompt_len} tokens at offset {start_pos}) + "
                f"max_new_tokens ({max_new_tokens}) exceeds max_cache_len "
                f"({self.max_cache_len}); raise max_cache_len or truncate."
            )

    def _ensure_cache(self, cache: Optional[decoder_lib.KVCache], batch: int, length: int):
        """A fresh cache of ``length`` slots, or a conversation cache grown to it."""
        if cache is not None and cache.max_len >= length:
            return cache
        new = decoder_lib.KVCache.zeros(
            self.cfg.text_config, batch, length, self.cache_dtype, self.device
        )
        if cache is not None:
            n = cache.max_len
            new.k[:, :, :n] = cache.k
            new.v[:, :, :n] = cache.v
        return new

    def pad_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Pad batch rows and audio chunk counts up to bucket sizes."""
        batch = dict(batch)
        B = batch["input_ids"].shape[0]
        Bp = _bucket(B, self.batch_buckets)
        if Bp != B:
            for key in ("input_ids", "attention_mask", "labels"):
                if key in batch:
                    pad = np.zeros((Bp - B,) + batch[key].shape[1:], batch[key].dtype)
                    batch[key] = np.concatenate([batch[key], pad])
        if "audio_values" in batch:
            N = batch["audio_values"].shape[0]
            Np = _bucket(N, self.chunk_buckets)
            if Np != N:
                av = batch["audio_values"]
                batch["audio_values"] = np.concatenate(
                    [av, np.zeros((Np - N,) + av.shape[1:], av.dtype)]
                )
                for key, fill in (
                    ("audio_lens", 1),
                    ("audio_token_len", 0),  # 0 tokens: nothing is spliced
                    ("audio_token_start_idx", 0),
                    ("audio_chunk_batch_idx", 0),
                ):
                    pad = np.full((Np - N,), fill, batch[key].dtype)
                    batch[key] = np.concatenate([batch[key], pad])
        return batch

    @torch.inference_mode()
    def generate(
        self,
        batch: Dict[str, np.ndarray],
        *,
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        generator: Optional[torch.Generator] = None,
        token_callback=None,
        cache: Optional[decoder_lib.KVCache] = None,
        start_pos: int = 0,
        return_cache: bool = False,
    ) -> GenerationResult:
        """Autoregressive generation for a collated batch (numpy arrays:
        input_ids, attention_mask and optionally audio_values, audio_lens,
        audio_token_start_idx, audio_token_len, audio_chunk_batch_idx).
        ``token_callback(step, tokens (B,), done)`` is the streaming hook.
        For conversation reuse pass the previous ``cache`` and ``start_pos``
        (tokens already cached); the batch then holds only the suffix."""
        true_B = batch["input_ids"].shape[0]
        prompt_lens = [int(x) for x in np.asarray(batch["attention_mask"]).sum(-1)][:true_B]
        self._check_cache_budget(max(prompt_lens), max_new_tokens, start_pos)
        batch = self.pad_batch({k: np.asarray(v) for k, v in batch.items()})
        tbatch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        B = batch["input_ids"].shape[0]
        need = start_pos + batch["input_ids"].shape[1] + max_new_tokens
        cache = self._ensure_cache(cache, B, _cache_bucket(need, self.max_cache_len))
        logits, cache, cache_len = self._prefill(tbatch, cache, start_pos)
        if generator is None:
            generator = self.generator

        done = np.zeros(B, dtype=bool)
        done[true_B:] = True
        out_ids: List[List[int]] = [[] for _ in range(B)]
        for step in range(max_new_tokens):
            next_tok = sample_token(
                logits, generator, temperature=temperature, top_k=top_k,
                top_p=top_p, min_p=min_p,
            )
            tok_np = next_tok.cpu().numpy()
            for b in range(true_B):
                if not done[b]:
                    if int(tok_np[b]) in self.stop_token_ids:
                        done[b] = True
                    else:
                        out_ids[b].append(int(tok_np[b]))
            if token_callback is not None:
                token_callback(step, tok_np, done.copy())
            if done.all() or step == max_new_tokens - 1:
                break
            logits, cache, cache_len = self._decode(cache, next_tok, cache_len)
        result = GenerationResult(token_ids=out_ids[:true_B], prompt_lens=prompt_lens)
        if return_cache:
            result.cache = cache
            result.cache_lens = cache_len.cpu().numpy()
        return result

    @torch.inference_mode()
    def generate_fused(
        self,
        batch: Dict[str, np.ndarray],
        *,
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> GenerationResult:
        """Offline generation with the decode loop as one segmented scan:
        prefill, the first token, then ``max_new_tokens - 1`` scan steps,
        with sampling on the device and one read of the token matrix at the
        end. Draws come from ``generator`` in the order of ``generate``, so
        the same seed gives the same samples on both paths. Stop tokens cut
        each row on the host afterwards."""
        true_B = batch["input_ids"].shape[0]
        prompt_lens = [int(x) for x in np.asarray(batch["attention_mask"]).sum(-1)][:true_B]
        self._check_cache_budget(max(prompt_lens), max_new_tokens)
        batch = self.pad_batch({k: np.asarray(v) for k, v in batch.items()})
        tbatch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        B = batch["input_ids"].shape[0]
        need = batch["input_ids"].shape[1] + max_new_tokens
        cache = self._ensure_cache(None, B, _cache_bucket(need, self.max_cache_len))
        logits, cache, seq_lens = self._prefill(tbatch, cache, 0)
        if generator is None:
            generator = self.generator
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
        first = sample_token(logits, generator, **kw)
        all_toks = self._decode_scan_segmented(
            cache, first, seq_lens, generator, n_steps=max_new_tokens - 1, **kw
        ).cpu().numpy()
        out_ids: List[List[int]] = []
        for b in range(true_B):
            ids = []
            for t in all_toks[b]:
                if int(t) in self.stop_token_ids:
                    break
                ids.append(int(t))
            out_ids.append(ids)
        return GenerationResult(token_ids=out_ids, prompt_lens=prompt_lens)

    def generate_greedy_fused(
        self, batch: Dict[str, np.ndarray], *, max_new_tokens: int = 256
    ) -> GenerationResult:
        return self.generate_fused(batch, max_new_tokens=max_new_tokens)

    def _prefill(self, batch, cache, start_pos: int):
        """Embed (with audio), write the prompt's k/v at [start_pos, ...),
        and return the logits of each row's last valid position."""
        cfg = self.cfg
        input_ids = batch["input_ids"]
        B, T = input_ids.shape
        dev = self.device
        inputs_embeds = uv.ultravox_embed(
            self.params, cfg, input_ids, batch, encoder_attn_impl=self.encoder_attn_impl
        )
        positions = start_pos + torch.arange(T, device=dev)[None].expand(B, T)
        seq_lens = start_pos + batch["attention_mask"].sum(dim=-1).to(torch.int32)
        hidden, cache = decoder_lib.decoder_forward(
            self.params["language_model"], cfg.text_config,
            inputs_embeds=inputs_embeds,
            positions=positions,
            kv_valid_len=seq_lens,
            cache=cache,
            write_pos=torch.full((B,), start_pos, dtype=torch.int32, device=dev),
            return_hidden=True,
            prefill_kernel=self.prefill_kernel,
        )
        last = torch.clamp(seq_lens - start_pos - 1, min=0).long()
        last_hidden = hidden[torch.arange(B, device=dev), last]
        logits = decoder_lib.compute_logits(
            self.params["language_model"], cfg.text_config, last_hidden
        )
        return logits, cache, seq_lens

    def _decode(self, cache, tokens, cache_pos):
        """One step: embed ``tokens``, write them at ``cache_pos``, return
        the next logits."""
        lm = self.params["language_model"]
        embeds = decoder_lib.embed_lookup(lm, tokens)[:, None]
        logits, cache = decoder_lib.decoder_forward(
            lm, self.cfg.text_config,
            inputs_embeds=embeds,
            positions=cache_pos[:, None],
            kv_valid_len=cache_pos + 1,
            cache=cache,
            write_pos=cache_pos,
            decode_kernel=self.decode_kernel,
        )
        return logits[:, 0], cache, cache_pos + 1

    def _decode_scan_segmented(
        self, cache, tokens, cache_pos, generator, *, n_steps: int, temperature: float = 0.0,
        top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
    ):
        """``n_steps`` decode steps in one segmented scan after the sampled
        ``tokens``; returns the (B, n_steps + 1) token matrix on the device.
        Each step draws from ``generator`` once, after the caller's draw for
        ``tokens``: the order of ``generate``."""

        def sample_fn(logits):
            return sample_token(
                logits, generator, temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p
            )

        return decoder_lib.segmented_decode_scan(
            self.params["language_model"], self.cfg.text_config, cache, cache_pos, tokens,
            n_steps=n_steps, sample_fn=sample_fn,
        )
