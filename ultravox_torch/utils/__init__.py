"""Utilities: checkpoint addressing (``wandb_utils``), resampling
(``audio``) and voice activity detection (``vad``)."""
