"""Data: the ``VoiceSample`` record and WAV codecs (``sample``), datasets,
augmentations and the registry of named data sets."""

from ultravox_torch.data.sample import SAMPLE_RATE, VoiceSample  # noqa: F401
