"""W&B checkpoint addressing: ``wandb://entity/project/artifact:vN``.

A copy of the JAX package's ``utils/wandb_utils.py`` addressing, download
and checkpoint-artifact helpers. ``wandb`` is imported only when one is
called; it is an optional dependency.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

WANDB_PREFIX = "wandb://"


def is_wandb_url(model_path: str) -> bool:
    return model_path.startswith(WANDB_PREFIX)


def _api():
    try:
        import wandb
    except ImportError as e:
        raise ImportError("wandb:// checkpoint paths require the wandb package") from e
    return wandb.Api()


def get_artifact(model_url: str):
    """``wandb://entity/project/artifact:vN`` -> wandb Artifact."""
    if not is_wandb_url(model_url):
        raise ValueError(f"not a wandb:// path: {model_url!r}")
    return _api().artifact(model_url[len(WANDB_PREFIX):])


def download_model_from_wandb(model_url: str) -> str:
    """Download a model artifact and return the local checkpoint dir."""
    path = get_artifact(model_url).download()
    if path is None:
        raise ValueError(f"artifact {model_url} has no files")
    return path


def log_checkpoint_artifact(
    run, checkpoint_dir: str, name: Optional[str] = None
) -> None:
    """Log a checkpoint directory as a W&B model artifact (reference:
    WANDB_LOG_MODEL=checkpoint flow, train.py:167-175)."""
    import wandb

    artifact = wandb.Artifact(
        name=name or f"model-{os.path.basename(checkpoint_dir)}",
        type="model",
    )
    artifact.add_dir(checkpoint_dir)
    run.log_artifact(artifact)
    logger.info("logged checkpoint artifact %s", artifact.name)
