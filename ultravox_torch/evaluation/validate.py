"""Standalone val-loss CLI (reference: evaluation/validate.py:22-226):
teacher-forcing forward over the configured datasets, label-count-weighted
loss, on the card unless ``--device cpu``; under torchrun each process runs
a mod-N shard of every set over the config's data x fsdp x tensor x pipe
mesh (N batch shards; tensor and pipe peers run the same rows, pipeline
stages run the decoder stack as a GPipe schedule), and the master prints
the sums' ratio.

Usage: ``python -m ultravox_torch.evaluation.validate --config_path <train yaml>
[--val_sets ...]``.
"""

from __future__ import annotations

import json
import logging
from typing import Dict

from ultravox_torch.parallel.collectives import is_global_master
from ultravox_torch.parallel.sharding import shard_params
from ultravox_torch.training import train_step as ts
from ultravox_torch.training.config import get_train_config
from ultravox_torch.training.model_factory import create_model_pack
from ultravox_torch.training.train import _mesh, validate


def main():
    logging.basicConfig(level=logging.INFO)
    config = get_train_config()
    mesh, dev = _mesh(config)
    model_pack = create_model_pack(config)
    optimizer = ts.make_optimizer(config.lr)
    state, template = ts.init_train_state(
        shard_params(model_pack.params, mesh, cfg=model_pack.config), optimizer,
        config.effective_trainable_patterns, device=dev,
    )
    results: Dict[str, float] = validate(config, model_pack, state, template, mesh)
    if is_global_master():
        print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
