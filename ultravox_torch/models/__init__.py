from ultravox_torch.models.config import (  # noqa: F401
    DecoderConfig,
    LoraConfig,
    LossConfig,
    LossFunction,
    UltravoxConfig,
    WhisperEncoderConfig,
)
