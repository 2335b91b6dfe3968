"""Audio augmentations (reference: data/aug/)."""

from ultravox_torch.data.aug.base import Augmentation, AugmentationArgs  # noqa: F401
from ultravox_torch.data.aug.registry import (  # noqa: F401
    AugRegistry,
    AugmentationConfig,
    create_augmentation,
)
