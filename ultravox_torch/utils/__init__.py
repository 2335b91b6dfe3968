"""Checkpoint addressing helpers (``wandb_utils``)."""
