"""OpenAI-protocol HTTP server over the continuous-batching engine.

Replaces the reference's external vLLM OpenAI server
(inference/run_vllm_inference.py:180-209). Supports ``/v1/chat/completions``
(streaming and non-streaming) with audio supplied as
``{"type": "input_audio", "input_audio": {"data": <b64 wav>, "format": "wav"}}``
content parts (the protocol the reference's ``tools/infer_api.py`` client
speaks), plus ``/health``. Sampling surface: temperature / top_k / top_p /
min_p / penalties / logit_bias / seed, ``stop`` string sequences (streamed
with holdback so no part of a matched stop is emitted), ``n`` multi-choice
(prompt processed once, choices decoded concurrently), and ``logprobs`` /
``top_logprobs``.

Stdlib http.server with a thread pool: the engine serialises decode work on
its own thread, so the HTTP layer only shuttles tokens. The voice
WebSocket's streaming encoder runs on its handler's thread, on the same
CUDA stream as the engine (the default stream), so the two serialise on
the device.

From the command line (the CUDA card unless ``--device cpu``):

    python -m ultravox_torch.inference.serving.api_server --model DIR \
        [--spec-decode ngram --spec-k 8] [--device cpu]

``build_api(argv)`` builds the ``ServingAPI`` from those flags without
starting it; ``serve`` blocks, ``make_server`` binds and returns the server.
A caller with its own engine, processor (which carries the tokenizer) and
collator builds ``ServingAPI`` directly.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)


class ServingAPI:
    """Binds a ServingEngine + processor/tokenizer to the HTTP protocol."""

    def __init__(self, engine, processor, collator, model_name="ultravox-torch"):
        self.engine = engine
        self.processor = processor
        self.tokenizer = processor.tokenizer
        self.collator = collator
        self.model_name = model_name

    def parse_messages(self, messages: List[Dict[str, Any]]):
        """OpenAI content-parts -> (chat messages, audio arrays)."""
        from ultravox_torch.data.sample import audio_from_wav_bytes
        from ultravox_torch.utils.audio import resample

        out_messages: List[Dict[str, str]] = []
        audios: List[np.ndarray] = []
        for m in messages:
            content = m.get("content")
            if isinstance(content, list):
                text_parts = []
                for part in content:
                    if part.get("type") == "text":
                        text_parts.append(part["text"])
                    elif part.get("type") == "input_audio":
                        data = base64.b64decode(part["input_audio"]["data"])
                        audio, sr = audio_from_wav_bytes(data)
                        if sr != 16000:
                            audio = resample(audio, sr, 16000)
                        audios.append(audio)
                        text_parts.append("<|audio|>")
                    elif part.get("type") == "audio_url":
                        url = part["audio_url"]["url"]
                        if url.startswith("data:"):
                            payload = url.split(",", 1)[1]
                            audio, sr = audio_from_wav_bytes(
                                base64.b64decode(payload)
                            )
                            if sr != 16000:
                                audio = resample(audio, sr, 16000)
                            audios.append(audio)
                            text_parts.append("<|audio|>")
                content = "".join(text_parts)
            out_messages.append({"role": m["role"], "content": content})
        return out_messages, audios

    def build_requests(self, body: Dict[str, Any]):
        """Submit the body's ``n`` engine requests (OpenAI multi-choice:
        the prompt is processed/collated ONCE; each choice decodes
        concurrently in the continuous batch)."""
        messages, audios = self.parse_messages(body["messages"])
        text = self.tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )
        features = self.processor(text=text, audios=audios or None)
        batch = self.collator([features])
        stop_ids = [self.tokenizer.eos_token_id]
        # multi-LoRA: requesting "model": "<adapter-name>" routes to that
        # adapter (the vLLM served-LoRA convention); the base model serves
        # under its own name or any unrecognized/absent model string
        lora = body.get("model")
        if lora is not None and lora not in getattr(
            self.engine, "_lora_index", {}
        ):
            lora = None
        def num(key, default):
            # explicit falsy values are MEANINGFUL here (top_p=0 = keep
            # only the top token; temperature=0 = greedy): only absence
            # or JSON null falls back to the default
            v = body.get(key)
            return default if v is None else v

        n = int(num("n", 1))
        if not 1 <= n <= MAX_CHOICES:
            raise ValueError(f"n must be in [1, {MAX_CHOICES}]")
        seed = body.get("seed")
        reqs = []
        try:
            for i in range(n):
                reqs.append(self._submit_choice(body, batch, stop_ids, lora,
                                                num, seed, i))
        except Exception:
            # a failed choice must not leak its siblings: already-submitted
            # requests would otherwise decode to max_tokens holding slots
            for req in reqs:
                self.engine.cancel(req)
            raise
        return reqs

    def _submit_choice(self, body, batch, stop_ids, lora, num, seed, i):
        return self.engine.submit(
            batch,
            max_tokens=int(num("max_tokens", 256)),
            temperature=float(num("temperature", 0.0)),
            top_k=int(num("top_k", 0)),
            top_p=float(num("top_p", 1.0)),
            min_p=float(num("min_p", 0.0)),
            presence_penalty=float(num("presence_penalty", 0.0)),
            frequency_penalty=float(num("frequency_penalty", 0.0)),
            repetition_penalty=float(num("repetition_penalty", 1.0)),
            logit_bias=(body.get("logit_bias") or {}),
            # seeded sampling is position-keyed and co-batch
            # independent, so the same seed would make every choice
            # identical — derive seed+i per choice (documented: choice
            # 0 reproduces a seeded n=1 request exactly)
            seed=None if seed is None else int(seed) + i,
            lora=lora,
            logprobs=bool(body.get("logprobs", False)),
            top_logprobs=int(num("top_logprobs", 0)),
            stop_token_ids=tuple(stop_ids),
        )

    def build_request(self, body: Dict[str, Any]):
        # single-request surface: n>1 would submit sibling choices the
        # caller has no handle to drain or cancel
        return self.build_requests({**body, "n": 1})[0]

    def handle_chat(self, body: Dict[str, Any]):
        """Returns (non-streaming response dict) or a generator of SSE lines."""
        stops = _parse_stops(body)
        reqs = self.build_requests(body)
        created = int(time.time())
        rid = f"chatcmpl-{uuid.uuid4().hex[:16]}"

        if body.get("stream"):
            return self._sse_stream(reqs, stops, rid, created)

        want_lp = bool(body.get("logprobs", False))
        choices = []
        completion_tokens = 0
        # sequential drain is fine: all choices decode concurrently in the
        # engine regardless of the order their queues are read; the finally
        # cancels undrained siblings if a client/tokenizer error aborts the
        # drain mid-way (the SSE path already does this)
        try:
            for i, req in enumerate(reqs):
                token_ids: List[int] = []
                lp_entries: List[Dict[str, Any]] = []
                finish = "stop"
                text = ""
                for event in self.engine.stream(req):
                    if event.token_id is None:
                        finish = event.finish_reason or "stop"
                        text = self.tokenizer.decode(
                            token_ids, skip_special_tokens=True
                        )
                        break
                    token_ids.append(event.token_id)
                    if want_lp and event.logprob is not None:
                        lp_entries.append(self._lp_entry(event))
                    if stops:
                        text = self.tokenizer.decode(
                            token_ids, skip_special_tokens=True
                        )
                        cut = _find_stop(text, stops)
                        if cut >= 0:
                            # matched a stop sequence: truncate BEFORE it
                            # (OpenAI semantics) and abort the decode
                            text = text[:cut]
                            finish = "stop"
                            self.engine.cancel(req)
                            # OpenAI trims logprobs to the emitted output:
                            # drop entries for tokens at/after the cut
                            lp_entries = self._trim_lp_to_cut(
                                token_ids, lp_entries, cut
                            )
                            break
                completion_tokens += len(token_ids)
                choices.append({
                    "index": i,
                    "message": {"role": "assistant", "content": text},
                    "logprobs": (
                        {"content": lp_entries} if want_lp else None
                    ),
                    "finish_reason": finish,
                })
        finally:
            for req in reqs[len(choices):]:
                self.engine.cancel(req)
        return {
            "id": rid,
            "object": "chat.completion",
            "created": created,
            "model": self.model_name,
            "choices": choices,
            "usage": {
                "prompt_tokens": reqs[0].prompt_len,
                "completion_tokens": completion_tokens,
                "total_tokens": reqs[0].prompt_len + completion_tokens,
            },
        }

    def _sse_stream(self, reqs, stops, rid, created):
        """SSE generator over ``len(reqs)`` concurrent choices: chunks are
        interleaved as tokens arrive, each tagged with its choice index.
        Stop sequences are enforced with holdback — text that could still
        be the beginning of a stop string is withheld until disambiguated,
        so a client never sees any part of a matched stop string."""
        import queue as _queue

        states = [
            {"req": r, "ids": [], "emitted": 0, "text": "", "lp": []}
            for r in reqs
        ]

        def finish_chunk(i, reason, lp=None):
            return _sse_chunk(
                rid, created, self.model_name, None, finish=reason, index=i,
                logprobs=lp,
            )

        def take_lp(st):
            # logprob entries accrued since the last emitted chunk ride
            # the next chunk (token/char alignment can lag one chunk when
            # holdback or partial UTF-8 delays text emission)
            if not st["lp"]:
                return None
            out, st["lp"] = {"content": st["lp"]}, []
            return out

        def sse():
            pending = set(range(len(reqs)))
            try:
                while pending:
                    for i in sorted(pending):
                        st = states[i]
                        try:
                            # single remaining choice: block (no spin);
                            # several: poll round-robin so one stalled
                            # queue never starves the others
                            event = st["req"].out_queue.get(
                                timeout=None if len(pending) == 1 else 0.02
                            )
                        except _queue.Empty:
                            continue
                        if event.token_id is None:
                            # flush any held-back text before finishing
                            tail = st["text"][st["emitted"]:]
                            if tail:
                                yield _sse_chunk(
                                    rid, created, self.model_name, tail,
                                    index=i, logprobs=take_lp(st),
                                )
                            yield finish_chunk(
                                i, event.finish_reason or "stop",
                                lp=take_lp(st),
                            )
                            pending.discard(i)
                            continue
                        st["ids"].append(event.token_id)
                        if event.logprob is not None:
                            st["lp"].append(self._lp_entry(event))
                        text = self.tokenizer.decode(
                            st["ids"], skip_special_tokens=True
                        )
                        if text.endswith("�"):
                            continue  # partial UTF-8; wait for more tokens
                        st["text"] = text
                        cut = _find_stop(text, stops)
                        if cut >= 0:
                            delta = text[st["emitted"]:cut]
                            if delta:
                                yield _sse_chunk(
                                    rid, created, self.model_name, delta,
                                    index=i, logprobs=take_lp(st),
                                )
                            yield finish_chunk(i, "stop", lp=take_lp(st))
                            self.engine.cancel(st["req"])
                            pending.discard(i)
                            continue
                        safe = len(text) - _stop_holdback(text, stops)
                        if safe > st["emitted"]:
                            yield _sse_chunk(
                                rid, created, self.model_name,
                                text[st["emitted"]:safe], index=i,
                                logprobs=take_lp(st),
                            )
                            st["emitted"] = safe
                yield "data: [DONE]\n\n"
            finally:
                # client gone mid-stream (GeneratorExit) or any other
                # early exit: abort the requests so they stop burning
                # decode steps and holding slots. No-op when finished.
                for r in reqs:
                    self.engine.cancel(r)

        return sse()


    def _lp_entry(self, event) -> Dict[str, Any]:
        """One OpenAI logprobs content entry from a token StreamEvent."""
        def one(tid, lp):
            s = self.tokenizer.decode([tid])
            return {
                "token": s,
                "logprob": lp,
                "bytes": list(s.encode("utf-8")),
            }

        entry = one(event.token_id, event.logprob)
        entry["top_logprobs"] = [
            one(t, l)
            for t, l in zip(event.top_ids or (), event.top_logprobs or ())
        ]
        return entry

    def _trim_lp_to_cut(self, token_ids, lp_entries, cut: int):
        """Keep logprob entries only for tokens whose decoded text ends at
        or before ``cut`` characters — tokens that complete a matched stop
        string are not part of the emitted message content."""
        keep = 0
        for k in range(1, len(token_ids) + 1):
            prefix = self.tokenizer.decode(
                token_ids[:k], skip_special_tokens=True
            )
            if len(prefix) <= cut:
                keep = k
            else:
                break
        return lp_entries[: min(keep, len(lp_entries))]

    # -- real-time voice (reference: tools/gradio_voice.py — WebRTC + VAD
    # ReplyOnPause; here: WebSocket PCM16 + in-repo energy VAD) -------------

    def handle_voice_ws(self, conn, *, max_tokens: int = 200) -> None:
        """Conversation loop over a WebSocket: binary frames carry PCM16
        mono @16 kHz mic audio; when the speaker pauses, the utterance plus
        the running conversation is submitted to the engine and token deltas
        stream back as JSON text frames.

        With a block-causal model (``audio_latency_block_size`` set) the
        audio tower runs INCREMENTALLY while the user is still speaking
        (inference/streaming.py): at pause time only the final partial
        block + projector + text splice remain before prefill starts, so
        pause-to-first-token drops by the full-utterance encode cost."""
        import hashlib

        from ultravox_torch.inference.serving.websocket import OP_TEXT
        from ultravox_torch.inference.streaming import EncoderWindowExceeded
        from ultravox_torch.utils.vad import ReplyOnPause

        vad = ReplyOnPause()
        messages: List[Dict[str, str]] = []
        audios: List[np.ndarray] = []
        use_streaming = bool(
            getattr(self.engine.cfg, "audio_latency_block_size", None)
        ) and "audio_tower" in self.engine.params
        stream_enc = None
        consumed = 0
        embeds_hist: List[torch.Tensor] = []  # per turn (n_tokens, D), on the device
        spans_sha: List[str] = []

        def new_stream_encoder():
            from ultravox_torch.inference.streaming import StreamingAudioEncoder

            return StreamingAudioEncoder(
                self.engine.params, self.engine.cfg,
                dtype=tower_dtype(self.engine.params["audio_tower"]),
            )

        conn.send_text(json.dumps({"type": "ready"}))
        while True:
            msg = conn.recv()
            utterance = None
            if msg is None:
                return
            op, payload = msg
            if op == OP_TEXT:
                ctl = json.loads(payload.decode("utf-8"))
                if ctl.get("type") == "flush":
                    utterance = vad.flush()
                elif ctl.get("type") == "reset":
                    messages, audios = [], []
                    embeds_hist, spans_sha = [], []
                    stream_enc, consumed = None, 0
                    vad.reset()
                    conn.send_text(json.dumps({"type": "ready"}))
                    continue
                else:
                    continue
            else:
                pcm = np.frombuffer(payload, np.int16).astype(np.float32)
                utterance = vad.process(pcm / 32768.0)
                if use_streaming and utterance is None:
                    part = vad.partial()
                    if part is None:
                        stream_enc, consumed = None, 0
                    else:
                        if stream_enc is None or len(part) < consumed:
                            stream_enc, consumed = new_stream_encoder(), 0
                        if len(part) > consumed:
                            try:
                                stream_enc.feed(part[consumed:])
                                consumed = len(part)
                            except EncoderWindowExceeded:
                                # speaker exceeded one encoder window (~30 s)
                                # without a pause: incremental encode can't
                                # represent that — the batch path (which
                                # chunks) serves the rest of the connection
                                use_streaming = False
                                stream_enc, consumed = None, 0
            if utterance is None or not len(utterance):
                continue

            conn.send_text(json.dumps(
                {"type": "utterance", "seconds": len(utterance) / 16000.0}
            ))
            messages.append({"role": "user", "content": "<|audio|>"})
            # retained even while streaming: the raw PCM is the fallback
            # input if a later utterance overflows the encoder window and
            # the connection drops to the batch path (which re-encodes the
            # whole conversation's audio)
            audios.append(utterance)
            text = self.tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True
            )
            if use_streaming:
                try:
                    if stream_enc is None:
                        stream_enc, consumed = new_stream_encoder(), 0
                    if len(utterance) > consumed:
                        stream_enc.feed(utterance[consumed:])
                    embeds_hist.append(stream_enc.finalize())
                except EncoderWindowExceeded:
                    use_streaming = False
                stream_enc, consumed = None, 0
            if use_streaming:
                spans_sha.append(
                    hashlib.sha1(
                        np.ascontiguousarray(utterance).tobytes()
                    ).hexdigest()
                )
                features = self.processor(
                    text=text,
                    audio_token_lens=[e.shape[0] for e in embeds_hist],
                )
                batch = self.collator(
                    [{k: features[k] for k in ("input_ids",)}]
                )
                for key in (
                    "audio_token_len", "audio_token_start_idx",
                    "audio_chunk_batch_idx",
                ):
                    batch[key] = features[key]
                Ta = max(e.shape[0] for e in embeds_hist)
                ae = torch.stack([
                    F.pad(e, (0, 0, 0, Ta - e.shape[0])) for e in embeds_hist
                ])
                spans = tuple(
                    (int(s), int(l), sha)
                    for s, l, sha in zip(
                        features["audio_token_start_idx"],
                        features["audio_token_len"],
                        spans_sha,
                    )
                )
                req = self.engine.submit(
                    batch,
                    max_tokens=max_tokens,
                    stop_token_ids=(self.tokenizer.eos_token_id,),
                    audio_embeds=ae,
                    audio_spans=spans,
                )
            else:
                features = self.processor(text=text, audios=audios)
                batch = self.collator([features])
                req = self.engine.submit(
                    batch,
                    max_tokens=max_tokens,
                    stop_token_ids=(self.tokenizer.eos_token_id,),
                )
            token_ids: List[int] = []
            emitted = 0
            ttft = None
            try:
                for event in self.engine.stream(req):
                    if event.token_id is None:
                        ttft = event.ttft_s
                        break
                    token_ids.append(event.token_id)
                    full = self.tokenizer.decode(
                        token_ids, skip_special_tokens=True
                    )
                    if not full.endswith("�") and len(full) > emitted:
                        conn.send_text(json.dumps(
                            {"type": "token", "text": full[emitted:]}
                        ))
                        emitted = len(full)
                        if not conn.open:
                            # the send found the peer gone: stop decoding
                            raise ConnectionError("websocket peer closed mid-reply")
            except BaseException:
                # socket gone (or handler torn down) mid-reply: stop the
                # request so it frees its slot instead of decoding on
                self.engine.cancel(req)
                raise
            reply = self.tokenizer.decode(token_ids, skip_special_tokens=True)
            messages.append({"role": "assistant", "content": reply})
            conn.send_text(json.dumps(
                {"type": "turn_end", "text": reply, "ttft_s": ttft}
            ))


def tower_dtype(tower) -> torch.dtype:
    """The dtype an audio tower computes in: a Whisper tower's conv1 kernel's
    (an int8 tower keeps its convolutions and norms in bf16, the dtype its
    activations run in; a fused tower's fp32 LayerNorm vectors do not set
    it), a wav2vec2 tower's feature projection's."""
    if "conv1" in tower:
        return tower["conv1"]["kernel"].dtype
    return tower["feature_projection"]["projection"]["kernel"].dtype


MAX_CHOICES = 8  # OpenAI `n` upper bound served per request
MAX_STOPS = 8  # OpenAI caps `stop` at 4; accept up to 8


def _parse_stops(body) -> tuple:
    """OpenAI ``stop``: a string or list of strings; generation halts
    BEFORE the first occurrence of any of them in the decoded text."""
    s = body.get("stop")
    if s is None:
        return ()
    if isinstance(s, str):
        s = [s]
    stops = tuple(x for x in s if x)
    if len(stops) > MAX_STOPS:
        raise ValueError(f"stop supports at most {MAX_STOPS} sequences")
    return stops


def _find_stop(text: str, stops) -> int:
    """Index of the earliest stop-sequence occurrence in ``text``; -1 if
    none."""
    cut = -1
    for s in stops:
        i = text.find(s)
        if i >= 0 and (cut < 0 or i < cut):
            cut = i
    return cut


def _stop_holdback(text: str, stops) -> int:
    """How many trailing chars of ``text`` could still be the start of a
    stop sequence (and therefore must not be streamed to the client yet)."""
    hold = 0
    for s in stops:
        for k in range(min(len(s) - 1, len(text)), hold, -1):
            if text.endswith(s[:k]):
                hold = k
                break
    return hold


def _sse_chunk(rid, created, model, delta_text, finish=None, index=0,
               logprobs=None):
    delta = {} if delta_text is None else {"content": delta_text}
    choice = {"index": index, "delta": delta, "finish_reason": finish}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    chunk = {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": created,
        "model": model,
        "choices": [choice],
    }
    return f"data: {json.dumps(chunk)}\n\n"


def make_handler(api: ServingAPI):
    class Handler(BaseHTTPRequestHandler):
        # browsers require an HTTP/1.1 response line on the WebSocket
        # 101 handshake (they reject 'HTTP/1.0 101'); all handlers either
        # set Content-Length or close the connection, so 1.1 is safe
        protocol_version = "HTTP/1.1"
        # token frames and SSE chunks are small writes: send each at once
        # (TCP_NODELAY) instead of holding it for the previous one's ACK
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

        def do_GET(self):
            if self.path in ("/", "/demo"):
                from ultravox_torch.inference.serving.demo_page import DEMO_HTML

                data = DEMO_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/voice":
                from ultravox_torch.inference.serving.demo_page import VOICE_HTML

                data = VOICE_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/ws/voice":
                from ultravox_torch.inference.serving.websocket import (
                    WebSocketConnection,
                    perform_handshake,
                )

                if not perform_handshake(self):
                    return
                conn = WebSocketConnection(self)
                try:
                    api.handle_voice_ws(conn)
                except (ConnectionError, BrokenPipeError):
                    pass
                finally:
                    conn.close()
                self.close_connection = True
            elif self.path in ("/health", "/v1/health"):
                eng = api.engine
                stats = {
                    "status": "ok",
                    "active_slots": len(eng._active),
                    "free_slots": len(eng._free_slots),
                    "queued_prefills": len(eng._prefilling),
                    "reused_prefix_tokens": eng.reused_prefix_tokens,
                }
                if getattr(eng, "paged", False):
                    stats["cache_mode"] = "paged"
                    stats["pages_in_use"] = eng.pages_in_use
                    stats["pages_total"] = eng.num_pages
                    stats["page_size"] = eng.page_size
                if getattr(eng, "spec_decode", None):
                    stats["spec_dispatches"] = eng.spec_dispatches
                    stats["spec_emitted_tokens"] = eng.spec_emitted_tokens
                    stats["spec_accept_mean_per_slot"] = round(
                        eng.spec_accepted_sum / max(eng.spec_rows, 1), 3
                    )
                    stats["spec_autopauses"] = eng.spec_autopauses
                    stats["spec_paused"] = eng._spec_paused_flag
                self._json(200, stats)
            elif self.path == "/v1/models":
                # base model + every served LoRA adapter (multi-LoRA:
                # request an adapter by putting its name in "model")
                data = [{"id": api.model_name, "object": "model"}]
                data += [
                    {"id": name, "object": "model",
                     "parent": api.model_name}
                    for name in sorted(
                        getattr(api.engine, "_lora_index", {})
                    )
                ]
                self._json(200, {"object": "list", "data": data})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/chat/completions":
                self._json(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length))
                result = api.handle_chat(body)
            except Exception as e:  # noqa: BLE001
                logger.exception("chat request failed")
                self._json(400, {"error": str(e)})
                return
            if isinstance(result, dict):
                self._json(200, result)
            else:  # SSE stream
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                # no Content-Length under HTTP/1.1 -> delimit by close
                self.send_header("Connection", "close")
                self.close_connection = True
                self.end_headers()
                try:
                    for line in result:
                        self.wfile.write(line.encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass

        def _json(self, code, payload):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    return Handler


def make_server(api: ServingAPI, host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
    """Start the engine and bind the HTTP server (``port=0`` picks a free
    port: ``server.server_address[1]``); the caller runs
    ``serve_forever``, then ``shutdown`` and ``api.engine.stop()``."""
    api.engine.start()
    try:
        server = ThreadingHTTPServer((host, port), make_handler(api))
    except Exception:
        api.engine.stop()
        raise
    logger.info("serving on %s:%d", host, server.server_address[1])
    return server


def serve(api: ServingAPI, host: str = "0.0.0.0", port: int = 8000):
    """Serve until interrupted (the entry point of ``main``)."""
    server = make_server(api, host, port)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        api.engine.stop()


def build_api(argv=None):
    """(ServingAPI, parsed args) from command-line arguments: the checkpoint
    and its tokenizer loaded (``load_ultravox_checkpoint``,
    ``load_tokenizer``) and the engine built from the flags, not started."""
    import argparse

    from ultravox_torch.inference.engine import resolve_device
    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.inference.ultravox_infer import load_ultravox_checkpoint
    from ultravox_torch.models.processor import DataCollatorWithAudio, make_processor
    from ultravox_torch.models.tokenizer import load_tokenizer

    parser = argparse.ArgumentParser(
        description="OpenAI-protocol HTTP server and voice WebSocket over the port's "
        "ServingEngine, from an Ultravox checkpoint directory")
    parser.add_argument("--model", required=True,
                        help="checkpoint directory (config.json, safetensors, tokenizer.json), "
                        "hf://repo or wandb://entity/project/artifact:vN")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card, in bf16 (cpu runs the plain "
                        "versions, in fp32)")
    parser.add_argument("--num-slots", type=int, default=16)
    parser.add_argument("--max-seq-len", type=int, default=4096)
    parser.add_argument(
        "--encoder-attn", default="auto", choices=["auto", "xla", "fused"],
        help="fused = the fused encoder (fused_layer_norm, ln_qkv_head_fused, "
        "attention_headmajor kernels; auto: fused on the card)")
    parser.add_argument(
        "--decode-attn", default="auto", choices=["auto", "xla", "kernel"],
        help="kernel = the decode_attention / paged_decode_attention kernels, which read "
        "only each row's valid cache (auto: kernel on the card from 4 MiB of KV a layer)")
    parser.add_argument(
        "--prefill-attn", default="auto", choices=["auto", "xla", "fused"],
        help="fused = the causal fused_attention prefill kernel (auto: on the card from "
        "1K contexts)")
    parser.add_argument(
        "--decode-block", type=int, default=None,
        help="decode steps (speculative rounds) a dispatch in steady state (default 8); "
        ">1 spreads the host's dispatch cost at the price of up to block-1 wasted steps "
        "a finished request")
    parser.add_argument(
        "--quantize", default=None, choices=[None, "int8"],
        help="int8 = int8 decoder weights with a per-channel scale (half the weight bytes)")
    parser.add_argument(
        "--cache-mode", default="auto", choices=["auto", "slots", "paged"],
        help="paged = a shared KV page pool with per-request page tables (conversation "
        "reuse copies pages on adoption; auto: paged from 1K contexts)")
    parser.add_argument("--page-size", type=int, default=256)
    parser.add_argument(
        "--num-pages", type=int, default=None,
        help="KV pool size in pages (default: the slot mode's token count; a smaller pool "
        "trades memory for admission backpressure)")
    parser.add_argument(
        "--spec-decode", default=None, choices=[None, "ngram"],
        help="ngram = prompt-lookup speculative decoding: greedy requests emit up to "
        "spec-k+1 tokens a verify forward when the output repeats earlier text; a health "
        "guard pauses it while drafts miss")
    parser.add_argument("--spec-k", type=int, default=8)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    # base sub-models first, the checkpoint last; a diff checkpoint that
    # leaves a tower at random init raises
    cfg, params, model_dir = load_ultravox_checkpoint(args.model, dtype, device=dev)
    tokenizer = load_tokenizer(model_dir)
    if tokenizer.pad_token_id is None:
        tokenizer.pad_token = tokenizer.eos_token
    processor = make_processor(tokenizer, cfg)
    collator = DataCollatorWithAudio(
        pad_token_id=tokenizer.pad_token_id,
        max_audio_len=processor.audio_context_size or 3000,
    )
    # the engine's default buckets follow the tower: mel frames for
    # Whisper, samples for wav2vec2 (4 to 30 s of audio either way)
    engine = ServingEngine(
        params, cfg,
        num_slots=args.num_slots,
        max_seq_len=args.max_seq_len,
        cache_dtype=dtype,
        encoder_attn_impl=args.encoder_attn,
        decode_attn_impl=args.decode_attn,
        prefill_attn_impl=args.prefill_attn,
        quantize=args.quantize,
        decode_block_steps=args.decode_block,
        cache_mode=args.cache_mode,
        page_size=args.page_size,
        num_pages=args.num_pages,
        spec_decode=args.spec_decode,
        spec_k=args.spec_k,
        device=dev,
    )
    return ServingAPI(engine, processor, collator), args


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    api, args = build_api(argv)
    serve(api, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
