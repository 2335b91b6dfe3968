"""Evaluation: the standalone validation-loss CLI (``validate``)."""
