"""TTS provider clients for the dataset factory.

HTTP clients for Azure Cognitive Speech and ElevenLabs, so ``ds_tool tts``
synthesizes speech out of the box: a retrying ``requests`` session (made
on first use, so ``requests`` is needed only then), an SSML body for
Azure, the PCM streaming endpoint for ElevenLabs, and the ``random`` voice
key. A client returns ``(float32 waveform, sample_rate)``, the seam
``TtsTask`` consumes; rows store raw arrays, not encoded audio.

API keys come from env vars (``AZURE_TTS_API_KEY`` /
``AZURE_WESTUS_TTS_API_KEY``, ``ELEVEN_API_KEY``). Tests inject a fake
transport through the ``session`` constructor argument.
"""

import abc
import os
from typing import Any, Dict, List, Optional, Tuple
from xml.sax import saxutils

import numpy as np

RANDOM_VOICE_KEY = "random"
REQUEST_TIMEOUT_S = 30
NUM_RETRIES = 3


def _default_session():
    import requests
    import requests.adapters

    session = requests.Session()
    adapter = requests.adapters.HTTPAdapter(
        max_retries=requests.adapters.Retry(
            total=NUM_RETRIES, backoff_factor=0.5,
            status_forcelist=(429, 500, 502, 503, 504),
        )
    )
    session.mount("https://", adapter)
    return session


def _pcm16_to_f32(raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


class TtsClient(abc.ABC):
    """Base HTTP TTS client: retrying session + voice resolution."""

    DEFAULT_VOICE: str = ""
    ALL_VOICES: List[str] = []

    def __init__(self, sample_rate: int = 16000, session: Any = None):
        self.sample_rate = int(sample_rate)
        self._session = session

    def resolve_voice(self, voice: Optional[str]) -> str:
        voice = voice or self.DEFAULT_VOICE
        if voice == RANDOM_VOICE_KEY:
            # map-worker processes share numpy's seed; mix in the PID so
            # parallel workers pick different voices
            i = np.random.randint(len(self.ALL_VOICES)) + os.getpid()
            voice = self.ALL_VOICES[i % len(self.ALL_VOICES)]
        return voice

    def _post(self, url: str, headers: Dict[str, str], **kwargs) -> bytes:
        if self._session is None:
            self._session = _default_session()
        resp = self._session.post(
            url, headers=headers, timeout=REQUEST_TIMEOUT_S, **kwargs
        )
        resp.raise_for_status()
        return resp.content

    @abc.abstractmethod
    def synthesize(
        self, text: str, voice: Optional[str] = None
    ) -> Tuple[np.ndarray, int]:
        """Return (float32 mono waveform, sample_rate)."""


class AzureTts(TtsClient):
    """Azure Cognitive Speech REST TTS (raw PCM output format)."""

    DEFAULT_VOICE = "en-US-JennyNeural"
    ALL_VOICES = [
        "en-US-AvaNeural", "en-US-AndrewNeural", "en-US-EmmaNeural",
        "en-US-BrianNeural", "en-US-JennyNeural", "en-US-GuyNeural",
        "en-US-AriaNeural", "en-US-DavisNeural", "en-US-JaneNeural",
        "en-US-JasonNeural", "en-US-SaraNeural", "en-US-TonyNeural",
        "en-US-NancyNeural", "en-US-AmberNeural", "en-US-AnaNeural",
        "en-US-AshleyNeural", "en-US-BrandonNeural",
        "en-US-ChristopherNeural", "en-US-CoraNeural",
        "en-US-ElizabethNeural", "en-US-EricNeural", "en-US-JacobNeural",
        "en-US-MichelleNeural", "en-US-MonicaNeural", "en-US-RogerNeural",
    ]

    def __init__(
        self,
        sample_rate: int = 16000,
        region: str = "westus",
        session: Any = None,
    ):
        super().__init__(sample_rate=sample_rate, session=session)
        self.region = region

    @staticmethod
    def _ssml(voice: str, text: str) -> str:
        return (
            '<speak version="1.0" xml:lang="en-US">'
            f'<voice xml:lang="en-US" name="{voice}">'
            f"{saxutils.escape(text)}"
            "</voice></speak>"
        )

    def synthesize(
        self, text: str, voice: Optional[str] = None
    ) -> Tuple[np.ndarray, int]:
        voice = self.resolve_voice(voice)
        api_key = os.environ.get("AZURE_TTS_API_KEY") or os.environ.get(
            "AZURE_WESTUS_TTS_API_KEY"
        )
        if not api_key:
            raise RuntimeError(
                "set AZURE_TTS_API_KEY (or AZURE_WESTUS_TTS_API_KEY)"
            )
        url = (
            f"https://{self.region}.tts.speech.microsoft.com/"
            "cognitiveservices/v1"
        )
        headers = {
            "Ocp-Apim-Subscription-Key": api_key,
            "Content-Type": "application/ssml+xml",
            "X-Microsoft-OutputFormat": (
                f"raw-{self.sample_rate // 1000}khz-16bit-mono-pcm"
            ),
            "User-Agent": "ultravox-tpu-ds-tool",
        }
        raw = self._post(
            url, headers, data=self._ssml(voice, text).encode("utf-8")
        )
        return _pcm16_to_f32(raw), self.sample_rate


class ElevenTts(TtsClient):
    """ElevenLabs streaming TTS (PCM output)."""

    DEFAULT_VOICE = "21m00Tcm4TlvDq8ikWAM"
    DEFAULT_MODEL = "eleven_multilingual_v2"
    ALL_VOICES = [
        "21m00Tcm4TlvDq8ikWAM", "29vD33N1CtxCmqQRPOHJ",
        "2EiwWnXFnvU5JabPnv8n", "5Q0t7uMcjvnagumLfvZi",
        "AZnzlk1XvdvUeBnXmlld", "CYw3kZ02Hs0563khs1Fj",
        "D38z5RcWu1voky8WS1ja", "EXAVITQu4vr4xnSDxMaL",
        "ErXwobaYiN019PkySvjV", "GBv7mTt0atIp3Br8iCZE",
        "IKne3meq5aSn9XLyUdCD", "JBFqnCBsd6RMkjVDRZzb",
        "LcfcDJNUP1GQjkzn1xUU", "MF3mGyEYCl7XYWbV9V6O",
        "N2lVS1w4EtoT3dr4eOWO", "ODq5zmih8GrVes37Dizd",
        "SOYHLrjzK2X1ezoPC6cr", "TX3LPaxmHKxFdv7VOQHJ",
        "ThT5KcBeYPX3keUQqHPh", "TxGEqnHWrfWFTfGW9XjX",
        "VR6AewLTigWG4xSOukaG", "XB0fDUnXU5powFXDhCwa",
        "Xb7hH8MSUJpSbSDYk0k2", "XrExE9yKIg1WjnnlVkGX",
        "ZQe5CZNOzWyzPSCn5a3c", "Zlb1dXrM653N07WRdFW3",
    ]

    def synthesize(
        self, text: str, voice: Optional[str] = None
    ) -> Tuple[np.ndarray, int]:
        voice = self.resolve_voice(voice)
        api_key = os.environ.get("ELEVEN_API_KEY")
        if not api_key:
            raise RuntimeError("set ELEVEN_API_KEY")
        if self.sample_rate not in (16000, 22050, 24000, 44100):
            raise ValueError(
                f"ElevenLabs pcm output: unsupported rate {self.sample_rate}"
            )
        url = (
            f"https://api.elevenlabs.io/v1/text-to-speech/{voice}/stream"
            f"?output_format=pcm_{self.sample_rate}"
        )
        headers = {"xi-api-key": api_key}
        body = {
            "text": text,
            "model_id": self.DEFAULT_MODEL,
            "voice_settings": {"stability": 0.5, "similarity_boost": False},
        }
        raw = self._post(url, headers, json=body)
        return _pcm16_to_f32(raw), self.sample_rate


def create_client(
    implementation: str, sample_rate: int = 16000, **kwargs
) -> TtsClient:
    """``azure`` / ``eleven`` -> the concrete client."""
    if implementation == "azure":
        return AzureTts(sample_rate=sample_rate, **kwargs)
    if implementation == "eleven":
        return ElevenTts(sample_rate=sample_rate, **kwargs)
    raise ValueError(f"unknown TTS implementation: {implementation!r}")
