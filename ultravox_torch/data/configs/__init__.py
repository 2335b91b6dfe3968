"""Declarative dataset configs (reference: data/configs/*.py)."""
