"""Dataset registry: name -> DatasetConfig with ``base`` chain merging and
language-aware prompt swapping (reference: data/registry.py:27-113)."""

from __future__ import annotations

import logging
from typing import Dict, List

from ultravox_torch.data import types
from ultravox_torch.data.datasets import (
    EmptyDataset,
    GenericDataset,
    SizedIterableDataset,
    SyntheticAsrDataset,
)

logger = logging.getLogger(__name__)

DATASET_MAP: Dict[str, types.DatasetConfig] = {}


def register_datasets(configs: List[types.DatasetConfig]) -> None:
    for config in configs:
        if config.name in DATASET_MAP:
            logger.debug("re-registering dataset %s", config.name)
        DATASET_MAP[config.name] = config


def unregister_datasets(names: List[str]) -> None:
    for name in names:
        DATASET_MAP.pop(name, None)


def _resolve_config(name: str) -> types.DatasetConfig:
    if name not in DATASET_MAP:
        raise KeyError(
            f"unknown dataset {name!r}; registered: {sorted(DATASET_MAP)}"
        )
    config = DATASET_MAP[name]
    chain = [config]
    while config.base is not None:
        if config.base not in DATASET_MAP:
            raise KeyError(f"dataset {name!r}: unknown base {config.base!r}")
        config = DATASET_MAP[config.base]
        chain.append(config)
    merged = chain[-1]
    for child in reversed(chain[:-1]):
        merged = merged.merged_with(child)
    return merged


def create_dataset(
    name: str, args: types.VoiceDatasetArgs
) -> SizedIterableDataset:
    """Instantiate a registered dataset (reference: registry.py:54-92)."""
    if name == "synthetic-asr":
        return SyntheticAsrDataset(args)
    if name == "empty":
        return EmptyDataset()
    config = _resolve_config(name)
    return GenericDataset(config, args)


def _register_builtin_configs():
    from ultravox_torch.data.configs import benchmarks, builtin, indic, multilingual

    register_datasets(builtin.configs())
    register_datasets(multilingual.configs())
    register_datasets(indic.configs())
    register_datasets(benchmarks.configs())


_register_builtin_configs()
