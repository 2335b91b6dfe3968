"""Model-soup weight averaging: the tensors of several checkpoint
directories (or single safetensors files) averaged into one checkpoint.

CLI: ``python -m ultravox_torch.tools.model_averaging --inputs a b c --output d``
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List

import torch

from ultravox_torch.models.weights import load_safetensors_dir, read_safetensors, save_safetensors


def average_state_dicts(dicts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The element-wise mean of state dicts with the same keys: summed in
    fp64 in the order given, divided by their count, and cast back to the
    first dict's dtype of each tensor."""
    if not dicts:
        raise ValueError("nothing to average")
    keys = set(dicts[0])
    for d in dicts[1:]:
        if set(d) != keys:
            missing = keys.symmetric_difference(set(d))
            raise ValueError(f"state dicts disagree on keys: {sorted(missing)[:8]}")
    out = {}
    for k in keys:
        total = dicts[0][k].double()
        for d in dicts[1:]:
            total = total + d[k].to(total.device).double()
        out[k] = (total / len(dicts)).to(dicts[0][k].dtype)
    return out


def average_checkpoints(inputs: List[str], output: str) -> str:
    """Average the checkpoints ``inputs`` into ``output/model.safetensors``,
    with the first input directory's ``config.json`` beside it."""
    dicts = []
    config_src = None
    for path in inputs:
        if os.path.isdir(path):
            dicts.append(load_safetensors_dir(path))
            if config_src is None and os.path.exists(os.path.join(path, "config.json")):
                config_src = os.path.join(path, "config.json")
        else:
            dicts.append(read_safetensors(path))
    avg = average_state_dicts(dicts)
    os.makedirs(output, exist_ok=True)
    save_safetensors(avg, os.path.join(output, "model.safetensors"))
    if config_src:
        shutil.copy(config_src, os.path.join(output, "config.json"))
    return output


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--inputs", nargs="+", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)
    print(average_checkpoints(args.inputs, args.output))


if __name__ == "__main__":
    main()
