from ultravox_torch.models.config import (  # noqa: F401
    DecoderConfig,
    UltravoxConfig,
    WhisperEncoderConfig,
)
