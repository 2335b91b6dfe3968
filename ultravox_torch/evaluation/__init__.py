"""Evaluation: the eval CLI (``eval``), the metric registries (``metrics``,
``string_metrics``, ``ifeval``, ``voicebench``) and the validation-loss
CLI (``validate``)."""
