"""OpenAI-protocol inference client.

``OpenAIInference`` implements ``VoiceInference`` against any
OpenAI-compatible chat server, the port's own ``serving.api_server``
included, with audio sent as base64-WAV ``input_audio`` content parts.
Stdlib HTTP only (no ``openai`` package).
"""

from __future__ import annotations

import base64
import json
import urllib.request
from typing import Optional

from ultravox_torch.data.sample import VoiceSample, audio_to_wav_bytes
from ultravox_torch.inference import base


class OpenAIInference(base.VoiceInference):
    def __init__(
        self,
        base_url: str,
        model: str = "ultravox-tpu",
        api_key: Optional[str] = None,
        timeout: float = 120.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.timeout = timeout

    def _messages_payload(self, sample: VoiceSample):
        messages = []
        for m in sample.messages:
            content = m["content"]
            if "<|audio|>" in content and sample.audio is not None:
                pre, _, post = content.partition("<|audio|>")
                parts = []
                if pre:
                    parts.append({"type": "text", "text": pre})
                parts.append({
                    "type": "input_audio",
                    "input_audio": {
                        "data": base64.b64encode(
                            audio_to_wav_bytes(sample.audio, sample.sample_rate)).decode(),
                        "format": "wav",
                    },
                })
                if post:
                    parts.append({"type": "text", "text": post})
                content = parts
            messages.append({"role": m["role"], "content": content})
        return messages

    def _post(self, body: dict):
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        req = urllib.request.Request(
            f"{self.base_url}/v1/chat/completions", data=json.dumps(body).encode(),
            headers=headers,
        )
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _body(self, sample, max_tokens, temperature, **extra):
        return {
            "model": self.model,
            "messages": self._messages_payload(sample),
            "max_tokens": max_tokens or 256,
            "temperature": temperature or 0.0,
            **extra,
        }

    def infer(
        self,
        sample: VoiceSample,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> base.VoiceOutput:
        with self._post(self._body(sample, max_tokens, temperature)) as r:
            out = json.load(r)
        usage = out.get("usage", {})
        return base.VoiceOutput(
            text=out["choices"][0]["message"]["content"],
            input_tokens=usage.get("prompt_tokens", 0),
            output_tokens=usage.get("completion_tokens", 0),
        )

    def infer_stream(
        self,
        sample: VoiceSample,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> base.InferenceGenerator:
        n_chunks = 0
        with self._post(self._body(sample, max_tokens, temperature, stream=True)) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                payload = line[6:]
                if payload == "[DONE]":
                    break
                delta = json.loads(payload)["choices"][0]["delta"].get("content")
                if delta:
                    n_chunks += 1
                    yield base.InferenceChunk(delta)
        yield base.InferenceStats(input_tokens=0, output_tokens=n_chunks)
