"""Evaluation CLI: ``python -m ultravox_torch.evaluation.eval``.

Re-design of the reference's ``evaluation/eval.py``: per-dataset ×
per-augmentation batched inference (sharded mod-N over the processes of a
multi-process run, gathered and reordered by index), metric scoring via
the registries, JSON outputs per dataset, written by the master.

Each process holds the whole model on its own device (replicated data
parallelism, as each JAX host does): ``torchrun --nproc_per_node N -m
ultravox_torch.evaluation.eval --model <dir> --eval_sets [...]``. It runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, List, Optional

from ultravox_torch.data import registry
from ultravox_torch.data import types as data_types
from ultravox_torch.data.aug import AugmentationArgs, create_augmentation
from ultravox_torch.data.datasets import Range
from ultravox_torch.data.sample import VoiceSample
from ultravox_torch.evaluation import metrics as metrics_lib
from ultravox_torch.parallel import collectives

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EvalConfig:
    """Reference: eval.py:28-93."""

    model: str = ""  # checkpoint dir
    eval_sets: List[str] = dataclasses.field(default_factory=list)
    # None = the whole dataset (no silent cap; the reference caps only via
    # explicit config)
    num_samples: Optional[int] = None
    batch_size: int = 8
    max_tokens: int = 256
    temperature: float = 0.0
    augmentations: List[Any] = dataclasses.field(default_factory=list)
    language: Optional[str] = None
    output_dir: str = "eval_results"
    seed: int = 42
    # multi-process rendezvous (reference: dist.init_process_group,
    # eval.py:312-314); all None under torchrun or in one process
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # the port's device: None runs on the card, "cpu" the plain versions
    device: Optional[str] = None


def infer_dataset(
    inference,
    dataset,
    *,
    batch_size: int,
    max_tokens: int,
    temperature: float,
    augmentation=None,
) -> List[metrics_lib.EvalSample]:
    """Sharded batched inference over a dataset (reference: eval.py:96-195).

    Pops the final assistant message as the reference answer, runs
    ``infer_batch`` on the rest, gathers across hosts, reorders by index.
    """
    results: List[tuple] = []
    shards = collectives.process_count()
    rank = collectives.process_index()
    for batch in collectives.sharded_batch_iterator(dataset, batch_size, shards, rank):
        indices = [i for i, _ in batch]
        samples: List[VoiceSample] = []
        refs: List[str] = []
        questions: List[str] = []
        for _, sample in batch:
            sample = (
                augmentation.apply_sample(sample) if augmentation else sample
            )
            assert sample.messages[-1]["role"] == "assistant"
            refs.append(sample.messages[-1]["content"])
            questions.append(sample.messages[-2]["content"])
            trimmed = dataclasses.replace(sample)
            trimmed.messages = sample.messages[:-1]
            samples.append(trimmed)
        try:
            outputs = inference.infer_batch(
                samples, max_tokens=max_tokens, temperature=temperature
            )
        except Exception:  # noqa: BLE001 — one bad batch must not kill the run
            logger.exception(
                "inference failed for batch starting at sample %d; "
                "scoring empty answers", indices[0],
            )
            from ultravox_torch.inference.base import VoiceOutput

            outputs = [
                VoiceOutput(text="", input_tokens=0, output_tokens=0)
                for _ in samples
            ]
        for idx, q, ref, out, s in zip(indices, questions, refs, outputs, samples):
            results.append(
                (
                    idx,
                    metrics_lib.EvalSample(
                        index=idx,
                        question=q,
                        expected_answer=ref,
                        generated_answer=out.text,
                        transcript=s.audio_transcript,
                    ),
                )
            )
    gathered = collectives.all_gather_list(results)
    gathered.sort(key=lambda t: t[0])
    return [s for _, s in gathered]


def _log_wandb_table(tag, metric, score, samples, out_path) -> None:
    """Upload per-sample results + the JSON file to an active W&B run
    (reference: eval.py:268-291). No-op without wandb / an active run."""
    try:
        import wandb
    except ImportError:
        return
    if wandb.run is None:
        return
    table = wandb.Table(
        columns=["index", "question", "expected", "generated", "transcript"],
        data=[
            [s.index, s.question, s.expected_answer, s.generated_answer,
             s.transcript]
            for s in samples
        ],
    )
    wandb.log({f"eval/{tag}": score, f"eval_table/{tag}": table})
    wandb.save(out_path)


def eval_datasets(
    inference, config: EvalConfig
) -> Dict[str, Dict[str, Any]]:
    """Loop datasets × augmentations (reference: eval.py:198-293)."""
    os.makedirs(config.output_dir, exist_ok=True)
    augs = [None] + [
        create_augmentation(a, AugmentationArgs(seed=config.seed))
        for a in config.augmentations
    ]
    scores: Dict[str, Dict[str, Any]] = {}
    for name in config.eval_sets:
        try:
            ds_config = registry._resolve_config(name)
        except KeyError:
            ds_config = None  # special-cased dataset (e.g. synthetic-asr)
        eval_cfg = ds_config.eval_config if ds_config else None
        metric = eval_cfg.metric if eval_cfg else "wer"
        metric_args = dict(eval_cfg.args) if eval_cfg else {}
        if config.language:
            metric_args.setdefault("lang_id", config.language)
        args = data_types.EvalDatasetArgs(language=config.language)
        for aug in augs:
            tag = name if aug is None else f"{name}.{aug.name}"
            ds = Range(
                registry.create_dataset(name, args), config.num_samples
            )
            samples = infer_dataset(
                inference,
                ds,
                batch_size=config.batch_size,
                max_tokens=config.max_tokens,
                temperature=config.temperature,
                augmentation=aug,
            )
            if not collectives.is_global_master():
                continue
            result = metrics_lib.evaluate_answers(samples, metric, metric_args)
            scores[tag] = {
                "metric": metric,
                "score": result["score"],
                "num_samples": len(samples),
            }
            logger.info("%s: %s = %.4f", tag, metric, result["score"])
            out_path = os.path.join(config.output_dir, f"{tag}.json")
            with open(out_path, "w") as f:
                json.dump(
                    {
                        **scores[tag],
                        "samples": [dataclasses.asdict(s) for s in samples],
                    },
                    f,
                    indent=2,
                )
            _log_wandb_table(tag, metric, result["score"], samples, out_path)
    if collectives.is_global_master():
        with open(os.path.join(config.output_dir, "summary.json"), "w") as f:
            json.dump(scores, f, indent=2)
    return scores


def main():
    import sys

    import yaml

    logging.basicConfig(level=logging.INFO)
    # simple --key value CLI mirroring the train config loader
    argv = sys.argv[1:]
    kwargs: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        key = argv[i].lstrip("-").replace("-", "_")
        kwargs[key] = yaml.safe_load(argv[i + 1])
        i += 2
    config_path = kwargs.pop("config_path", None)
    if config_path:
        with open(config_path) as f:
            base = yaml.safe_load(f) or {}
        base.update(kwargs)
        kwargs = base
    config = EvalConfig(**kwargs)

    # multi-process init BEFORE any device access (reference: eval.py:312-314)
    from ultravox_torch.inference.engine import resolve_device
    from ultravox_torch.parallel.mesh import initialize_multihost, rank_device

    dev = resolve_device(config.device)
    initialize_multihost(
        config.coordinator_address, config.num_processes, config.process_id, device=dev
    )

    from ultravox_torch.inference.ultravox_infer import UltravoxInference

    inference = UltravoxInference(config.model, device=rank_device(dev))
    eval_datasets(inference, config)


if __name__ == "__main__":
    main()
