"""Data helpers the serving front end needs: WAV codecs (``sample``)."""

from ultravox_torch.data.sample import SAMPLE_RATE  # noqa: F401
