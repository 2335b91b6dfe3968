"""LocalInference: offline single, batch and streaming inference, with
conversation-mode KV reuse, on the port's ``GenerationEngine``.

Conversation mode keeps the KV cache between turns and reuses it by
token-prefix matching: each turn renders the whole conversation, and when
the cached token ids form a prefix of it only the suffix is prefilled
(``_split_prefix``; an audio chunk is never split).

It runs on the CUDA card unless ``device="cpu"``: on the card with the
fused encoder (#1-#3), the fused prefill (#4) and the decode kernel (#8),
on the CPU with their plain forms.
"""

from __future__ import annotations

import dataclasses
import queue as queue_lib
import re
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ultravox_torch.data.sample import SAMPLE_RATE, VoiceSample
from ultravox_torch.inference import base
from ultravox_torch.inference.engine import GenerationEngine, resolve_device
from ultravox_torch.models.config import UltravoxConfig
from ultravox_torch.models.processor import DataCollatorWithAudio, UltravoxProcessor
from ultravox_torch.utils.audio import resample

MAX_NEW_TOKENS = 1024
THINK_RE = re.compile(r"<think>(.*?)</think>\s*(.*)", re.DOTALL)


def _split_thinking(text: str):
    m = THINK_RE.match(text)
    if m:
        return m.group(1).strip(), m.group(2).strip()
    return None, text


class LocalInference(base.VoiceInference):
    def __init__(
        self,
        params: Any,
        cfg: UltravoxConfig,
        processor: UltravoxProcessor,
        *,
        max_cache_len: int = 4096,
        conversation_mode: bool = False,
        chat_template: Optional[str] = None,
        extra_stop_tokens: tuple = (),
        cache_dtype=None,
        fused_greedy_decode: bool = False,
        quantize: Optional[str] = None,
        device=None,
        mesh=None,  # a parallel.Mesh of data 1: every process calls with the same inputs
    ):
        self.cfg = cfg
        self.processor = processor
        self.tokenizer = processor.tokenizer
        stop_ids = {self.tokenizer.eos_token_id}
        for tok in extra_stop_tokens:
            tid = self.tokenizer.convert_tokens_to_ids(tok)
            if tid is not None:
                stop_ids.add(tid)
        dev = resolve_device(device)
        on_card = dev.type == "cuda"
        self.engine = GenerationEngine(
            params,
            cfg,
            max_cache_len=max_cache_len,
            stop_token_ids=tuple(stop_ids),
            cache_dtype=cache_dtype or torch.bfloat16,
            quantize=quantize,
            device=dev,
            encoder_attn_impl="fused" if on_card else "xla",
            prefill_attn_impl="fused" if on_card else "xla",
            decode_attn_impl="kernel" if on_card else "xla",
            mesh=mesh,
        )
        self.collator = DataCollatorWithAudio(
            pad_token_id=self.tokenizer.pad_token_id,
            max_audio_len=processor.audio_context_size or 3000,
        )
        if chat_template:
            self.tokenizer.chat_template = chat_template
        self.conversation_mode = conversation_mode
        self.fused_greedy_decode = fused_greedy_decode
        self.past_messages: List[Dict[str, str]] = []
        # audios referenced by <|audio|> placeholders in past messages, in
        # order (the prefix-reuse path skips re-encoding them; a cache miss
        # re-encodes from here)
        self.past_audios: List[np.ndarray] = []
        # conversation KV state: the tokens written to the cache so far and
        # the cache itself
        self._conv_tokens: List[int] = []
        self._conv_cache = None
        # how many prompt tokens the last conversational turn prefilled
        self.last_prefilled_tokens = 0

    # -- data prep ---------------------------------------------------------

    def _dataproc(
        self, sample: VoiceSample, past_audios: Optional[List[np.ndarray]] = None
    ) -> Dict[str, np.ndarray]:
        if sample.audio is not None and sample.sample_rate != SAMPLE_RATE:
            sample = dataclasses.replace(
                sample,
                audio=resample(sample.audio, sample.sample_rate, SAMPLE_RATE),
                sample_rate=SAMPLE_RATE,
            )
        text = self.tokenizer.apply_chat_template(
            sample.messages, tokenize=False, add_generation_prompt=True
        )
        audios = list(past_audios or [])
        if sample.audio is not None:
            audios.append(sample.audio)
        return self.processor(text=text, audios=audios or None)

    # -- public API ----------------------------------------------------------

    def infer(
        self,
        sample: VoiceSample,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> base.VoiceOutput:
        return self.infer_batch([sample], max_tokens, temperature)[0]

    def infer_batch(
        self,
        samples: List[VoiceSample],
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> List[base.VoiceOutput]:
        samples = [self._with_past(s) for s in samples]
        if self.conversation_mode and len(samples) == 1:
            result = self._generate_conversational(samples[0], max_tokens, temperature)
            results = [(result.token_ids[0], result.prompt_lens[0])]
        else:
            batch = self.collator([self._dataproc(s) for s in samples])
            # generate_fused: one segmented scan a call, always
            # max_new_tokens steps, sampling on the card
            gen = self.engine.generate_fused if self.fused_greedy_decode else self.engine.generate
            result = gen(batch, max_new_tokens=max_tokens or MAX_NEW_TOKENS,
                         temperature=temperature or 0.0)
            results = list(zip(result.token_ids, result.prompt_lens))
        outputs = []
        for ids, n_in in results:
            text = self.tokenizer.decode(ids, skip_special_tokens=True)
            thinking, text = _split_thinking(text)
            outputs.append(base.VoiceOutput(
                text=text, input_tokens=n_in, output_tokens=len(ids),
                thinking_content=thinking,
            ))
        if self.conversation_mode and len(samples) == 1:
            self.past_messages = samples[0].messages + [
                {"role": "assistant", "content": outputs[0].text}
            ]
            if samples[0].audio is not None:
                self.past_audios.append(samples[0].audio)
        return outputs

    # -- conversation KV reuse ------------------------------------------------

    def _split_prefix(self, feats: Dict[str, np.ndarray]):
        """Longest reusable cached prefix (token-id match, never splitting an
        audio chunk), and the suffix batch in local coordinates."""
        ids = np.asarray(feats["input_ids"][0])
        cached = self._conv_tokens
        p = 0
        limit = min(len(cached), len(ids) - 1)  # keep at least one suffix token
        while p < limit and cached[p] == int(ids[p]):
            p += 1
        if "audio_token_start_idx" in feats:
            starts = np.asarray(feats["audio_token_start_idx"])
            lens = np.asarray(feats["audio_token_len"])
            for s, n in zip(starts, lens):
                if s < p < s + n:  # do not split a chunk
                    p = int(s)
        suffix: Dict[str, np.ndarray] = {
            "input_ids": ids[None, p:],
            "attention_mask": np.ones((1, len(ids) - p), np.int32),
        }
        if "audio_values" in feats:
            starts = np.asarray(feats["audio_token_start_idx"])
            keep = starts >= p
            if keep.any():
                suffix["audio_values"] = np.asarray(feats["audio_values"])[keep]
                suffix["audio_lens"] = np.asarray(feats["audio_lens"])[keep]
                suffix["audio_token_len"] = np.asarray(feats["audio_token_len"])[keep]
                suffix["audio_token_start_idx"] = (starts[keep] - p).astype(np.int32)
                suffix["audio_chunk_batch_idx"] = np.zeros(int(keep.sum()), np.int32)
        return p, suffix, ids

    def _generate_conversational(self, sample, max_tokens, temperature, token_callback=None):
        """``sample`` must already include the past messages (``_with_past``)."""
        feats = self._dataproc(sample, past_audios=self.past_audios)
        p, suffix, full_ids = self._split_prefix(feats)
        self.last_prefilled_tokens = len(full_ids) - p
        result = self.engine.generate(
            suffix,
            max_new_tokens=max_tokens or MAX_NEW_TOKENS,
            temperature=temperature or 0.0,
            cache=self._conv_cache if p > 0 else None,
            start_pos=p,
            return_cache=True,
            token_callback=token_callback,
        )
        self._conv_cache = result.cache
        cache_len = int(result.cache_lens[0])
        written = list(full_ids) + result.token_ids[0]
        self._conv_tokens = written[:cache_len]
        # report the full prompt length (not just the suffix)
        result.prompt_lens = [len(full_ids)]
        return result

    def infer_stream(
        self,
        sample: VoiceSample,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> base.InferenceGenerator:
        """Text chunks as tokens arrive, then ``InferenceStats`` (TTFT from
        the call). Generation runs on a worker thread, which enters
        ``torch.inference_mode`` itself (a thread does not inherit it); a
        trailing U+FFFD (a byte sequence not yet complete) is held back."""
        conversational = self.conversation_mode
        sample = self._with_past(sample)
        if not conversational:
            batch = self.collator([self._dataproc(sample)])
        t_start = time.monotonic()
        ttft: List[Optional[float]] = [None]
        q: "queue_lib.Queue" = queue_lib.Queue()
        emitted = [0]
        all_ids: List[int] = []

        def callback(step, tokens, done):
            if ttft[0] is None:
                ttft[0] = time.monotonic() - t_start
            if not done[0]:
                all_ids.append(int(tokens[0]))
                text = self.tokenizer.decode(all_ids, skip_special_tokens=True)
                if not text.endswith("�") and len(text) > emitted[0]:
                    q.put(text[emitted[0]:])
                    emitted[0] = len(text)

        result_box: Dict[str, Any] = {}

        def run():
            try:
                with torch.inference_mode():
                    if conversational:
                        result_box["result"] = self._generate_conversational(
                            sample, max_tokens, temperature, token_callback=callback)
                    else:
                        result_box["result"] = self.engine.generate(
                            batch, max_new_tokens=max_tokens or MAX_NEW_TOKENS,
                            temperature=temperature or 0.0, token_callback=callback,
                        )
            except BaseException as e:  # noqa: BLE001 - surfaced to the consumer
                result_box["error"] = e
            finally:
                q.put(None)

        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        while True:
            chunk = q.get()
            if chunk is None:
                break
            yield base.InferenceChunk(chunk)
        worker.join()
        if "error" in result_box:
            raise result_box["error"]
        result = result_box["result"]
        full_text = self.tokenizer.decode(result.token_ids[0], skip_special_tokens=True)
        if self.conversation_mode:
            self.past_messages = sample.messages + [{"role": "assistant", "content": full_text}]
            if sample.audio is not None:
                self.past_audios.append(sample.audio)
        yield base.InferenceStats(
            input_tokens=result.prompt_lens[0],
            output_tokens=len(result.token_ids[0]),
            ttft_s=ttft[0],
            total_s=time.monotonic() - t_start,
        )

    def update_conversation(self, past_messages=None, past_cache=None) -> None:
        self.past_messages = past_messages or []
        if not past_messages:
            self.past_audios = []
            self._conv_tokens = []
            self._conv_cache = None

    def _with_past(self, sample: VoiceSample) -> VoiceSample:
        if not self.conversation_mode or not self.past_messages:
            return sample
        out = dataclasses.replace(sample)
        out.messages = self.past_messages + sample.messages
        return out
