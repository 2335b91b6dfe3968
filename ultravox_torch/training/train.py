"""Training CLI: ``python -m ultravox_torch.training.train --config_path <yaml>``.

The JAX package's training loop on one card: the config (``meta_config.yaml``,
the recipe, CLI overrides), the model pack, host-side data loading on a
background prefetch thread (numpy only), the train step (forward, backward,
gradient accumulation, AdamW) with each batch copied to the card from pinned
memory, JSONL / TensorBoard / W&B logging, checkpoints every ``save_steps``,
validation every ``val_steps``, at the end the last checkpoint and
``model.safetensors``, and with ``do_eval`` the evaluation suite on the
trained model. ``model_load_dir`` + ``resume_from_load_dir`` resume from
its latest checkpoint. ``--device cpu`` runs the plain versions of the
kernels on the CPU; left unset, it trains on the card.

Several processes, one a device, train one model over the ``mesh_data`` x
``mesh_fsdp`` x ``mesh_tensor`` x ``mesh_pipe`` mesh (``parallel/``):
launched by ``torchrun --nproc_per_node N -m ultravox_torch.training.train
--config_path <yaml>`` (or given ``coordinator_address``, ``num_processes``
and ``process_id``), each process loads the mod-S shard of the samples of
its batch coordinate (S = data x fsdp shards; tensor and pipe peers read
the same rows) and runs ``batch_size / S`` rows of every global batch,
holds its stage's layers and its tensor and fsdp slice of the sharded
leaves, and only the master writes the config, the logs and the files.
Pipeline stages run the decoder stack as a GPipe schedule of
``pipe_microbatches`` microbatches (``parallel/pipeline.py``), in the train
step and in validation.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ultravox_torch.data import registry
from ultravox_torch.data import types as data_types
from ultravox_torch.data.aug import AugmentationArgs, create_augmentation
from ultravox_torch.data.datasets import InterleaveDataset, Range
from ultravox_torch.inference.engine import resolve_device
from ultravox_torch.parallel import multihost
from ultravox_torch.parallel.collectives import is_global_master, process_count, process_index
from ultravox_torch.parallel.mesh import MeshConfig, initialize_multihost, make_mesh, rank_device
from ultravox_torch.parallel.sharding import (
    all_reduce_,
    full_shape,
    gather_tree,
    map_paths,
    shard_params,
)
from ultravox_torch.training import checkpoint as ckpt_lib
from ultravox_torch.training import train_step as ts
from ultravox_torch.training.config import TrainConfig, get_train_config
from ultravox_torch.training.model_factory import create_model_pack

logger = logging.getLogger(__name__)


def batch_iterator(
    dataset, collator, batch_size: int, infinite: bool = True
) -> Iterator[Dict[str, np.ndarray]]:
    """Group dataset features into collated batches, cycling if needed."""
    while True:
        buf: List[Dict[str, Any]] = []
        n = 0
        for features in dataset:
            buf.append(features)
            if len(buf) == batch_size:
                yield collator(buf)
                buf = []
            n += 1
        if buf:
            yield collator(buf)
        if not infinite or n == 0:
            return


class Prefetcher:
    """Background-thread batch prefetch (replaces torch DataLoader workers).
    ``close`` stops the thread and closes the iterator."""

    def __init__(self, iterator: Iterator, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._iterator = iterator
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._iterator:
                if not self._put(item):
                    break
        except BaseException as e:  # surfaced on the consumer side
            self._put(e)
        finally:
            close = getattr(self._iterator, "close", None)
            if close is not None:
                close()
        self._put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self, timeout: float = 60.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            logger.warning("the prefetch thread did not stop within %.0f s", timeout)


class MetricsLogger:
    """Metrics sinks: JSONL always; TensorBoard and W&B when configured and
    importable (reference logs to W&B/TensorBoard via report_logs_to,
    config_base.py:171)."""

    def __init__(self, config: TrainConfig):
        self.config = config
        self._tb = None
        self._wandb = None
        os.makedirs(config.output_dir, exist_ok=True)
        if "tensorboard" in config.report_logs_to:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(config.output_dir, "tensorboard"))
            except ImportError:
                logger.warning("tensorboardX unavailable; skipping TB logs")
        if "wandb" in config.report_logs_to:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "ultravox-tpu"),
                    name=config.exp_name,
                    config=dataclasses.asdict(config),
                    dir=config.output_dir,
                )
            except ImportError:
                logger.warning("wandb unavailable; skipping W&B logs")
        self._jsonl = open(os.path.join(config.output_dir, "train_log.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, float]):
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        self._jsonl.write(json.dumps({"step": step, **metrics}) + "\n")
        self._jsonl.flush()
        logger.info(
            "step %d | %s",
            step,
            " ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
        )

    def log_checkpoint(self, path: Optional[str]):
        """Log a checkpoint dir as a W&B model artifact when
        WANDB_LOG_MODEL is set (reference: train.py WANDB_LOG_MODEL flow)."""
        if self._wandb is not None and path and os.environ.get("WANDB_LOG_MODEL"):
            from ultravox_torch.utils.wandb_utils import log_checkpoint_artifact

            log_checkpoint_artifact(self._wandb.run, path)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        self._jsonl.close()


def prepare_dataset(
    config: TrainConfig,
    model_pack,
    data_sets: List[str],
    args: data_types.VoiceDatasetArgs,
    num_samples: Optional[int] = None,
    augmentation=None,
):
    datasets = [registry.create_dataset(name, args) for name in data_sets]
    ds = (
        InterleaveDataset(datasets, config.data_weights)
        if len(datasets) > 1
        else datasets[0]
    )
    ds = model_pack.wrap_with_data_proc(ds, config, augmentation=augmentation)
    if num_samples:
        ds = Range(ds, num_samples)
    return ds


def prepare_train_dataset(config: TrainConfig, model_pack):
    """The training set as ``train`` reads it: the configured sets and
    augmentations through the model pack's data processing."""
    train_args = data_types.TrainDatasetArgs(
        shuffle=config.shuffle_data,
        shuffle_buffer_size=config.shuffle_buffer_size,
        max_audio_duration_secs=config.max_audio_duration_secs,
        max_input_characters=config.max_input_characters,
    )
    return prepare_dataset(
        config, model_pack, config.data_sets, train_args,
        num_samples=config.num_samples, augmentation=make_augmentation(config),
    )


def to_device(batch: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``dev``: on the card copied
    from pinned host memory without waiting for the copy."""
    if dev.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(dev, non_blocking=True)
            for k, v in batch.items()}


def _mesh(config: TrainConfig):
    """Join the run's processes (before any device access), then lay the
    mesh over them: (mesh, this process's device)."""
    dev = resolve_device(config.device)
    initialize_multihost(config.coordinator_address, config.num_processes, config.process_id,
                         device=dev)
    mesh = make_mesh(MeshConfig(config.mesh_data, config.mesh_fsdp, config.mesh_tensor,
                                config.mesh_pipe))
    if config.batch_size % mesh.batch_shards:
        raise ValueError(f"batch_size {config.batch_size} not divisible by the "
                         f"{mesh.batch_shards} batch shards (data x fsdp)")
    return mesh, rank_device(dev)


def _batch_shard(ds, mesh):
    """The rank's share of a dataset: the mod-S shard of its batch
    coordinate (S = data x fsdp shards; tensor and pipe peers read the
    same rows, as the JAX package's ``needs_replicated_feed`` demands)."""
    if mesh.batch_shards == 1:
        return ds
    return multihost.ShardedDataset(ds, mesh.batch_shards, mesh.batch_index)


def make_augmentation(config: TrainConfig):
    """The configured augmentations, one or grouped; None without any."""
    if not config.augmentations:
        return None
    augs = [
        create_augmentation(a, AugmentationArgs(seed=config.seed))
        for a in config.augmentations
    ]
    if len(augs) == 1:
        return augs[0]
    from ultravox_torch.data.aug.base import Augmentation

    return Augmentation(AugmentationArgs(seed=config.seed), children=augs)


def make_train_optimizer(config: TrainConfig) -> ts.Optimizer:
    """The config's AdamW, schedule and clipping, with its accumulation."""
    optimizer = ts.make_optimizer(
        config.lr,
        schedule=config.lr_scheduler,
        warmup_steps=config.lr_warmup_steps,
        total_steps=config.max_steps,
        min_lr_rate=config.min_lr_rate,
        weight_decay=config.weight_decay,
        max_grad_norm=config.max_grad_norm,
        b1=config.optimizer_betas[0],
        b2=config.optimizer_betas[1],
    )
    if config.grad_accum_steps > 1:
        optimizer = ts.multi_steps(optimizer, config.grad_accum_steps)
    return optimizer


def train(config: TrainConfig) -> Dict[str, float]:
    logging.basicConfig(
        level=logging.DEBUG if config.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
    )
    t_start = time.time()
    mesh, dev = _mesh(config)
    n_proc = process_count()
    logger.info("process %d/%d, device: %s", process_index(), n_proc,
                torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev)
    os.makedirs(config.output_dir, exist_ok=True)
    if is_global_master():
        with open(os.path.join(config.output_dir, "train_config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2, default=str)

    model_pack = create_model_pack(config)
    params = shard_params(model_pack.params, mesh, cfg=model_pack.config)

    # -- optimizer & state ---------------------------------------------------
    optimizer = make_train_optimizer(config)
    state, template = ts.init_train_state(
        params, optimizer, config.effective_trainable_patterns, device=dev
    )
    del params
    n_trainable = sum(math.prod(full_shape(x)) for x in state.trainable.values())
    n_frozen = sum(math.prod(full_shape(x)) for x in state.frozen.values())
    logger.info(
        "trainable params: %s || frozen: %s || trainable%%: %.2f%%",
        f"{n_trainable:,d}",
        f"{n_frozen:,d}",
        100 * n_trainable / max(n_trainable + n_frozen, 1),
    )

    if config.model_load_dir and config.resume_from_load_dir:
        latest = ckpt_lib.latest_checkpoint(config.model_load_dir)
        if latest:
            state = ckpt_lib.restore_checkpoint(latest, state)
            logger.info("resumed from %s at step %d", latest, state.step)

    step_fn = ts.make_train_step(
        model_pack.config,
        config.loss_config,
        optimizer,
        template,
        remat=config.remat,
        attn_impl=config.attn_impl,
        vocab_chunk=config.vocab_loss_chunk,
        pipe_mesh=mesh if config.mesh_pipe > 1 else None,
        pipe_micro=config.pipe_microbatches,
        mesh=mesh,
    )

    # -- data -----------------------------------------------------------------
    # each batch shard loads a mod-S shard of the samples and collates its
    # own rows of every global batch
    train_ds = _batch_shard(prepare_train_dataset(config, model_pack), mesh)
    local_batch_size = config.batch_size // mesh.batch_shards
    batches = Prefetcher(batch_iterator(train_ds, model_pack.collator, local_batch_size))

    # -- loop -------------------------------------------------------------------
    metrics_logger = MetricsLogger(config) if is_global_master() else None
    opt_steps = config.max_steps * config.grad_accum_steps
    final_metrics: Dict[str, float] = {}
    step = state.step
    try:
        for batch in batches:
            if step >= opt_steps:
                break
            state, metrics = step_fn(state, to_device(batch, dev))
            step = state.step
            if step % config.logging_steps == 0 or step == 1:
                host_metrics = {k: float(v) for k, v in metrics.items()}
                host_metrics["samples_per_s"] = (
                    step * config.batch_size / (time.time() - t_start)
                )
                if metrics_logger is not None:
                    metrics_logger.log(step, host_metrics)
                final_metrics = host_metrics
            if config.save_steps and step % config.save_steps == 0:
                path = save_checkpoint_multihost(config.output_dir, state)
                logger.info("saved checkpoint %s", path)
                if metrics_logger is not None:
                    metrics_logger.log_checkpoint(path)
            if config.val_steps and step % config.val_steps == 0 and config.val_sets:
                val = validate(config, model_pack, state, template, mesh)
                if metrics_logger is not None:
                    metrics_logger.log(step, val)
    except BaseException:
        logger.exception("training failed at step %d", step)
        raise
    finally:
        batches.close()
        if metrics_logger is not None:
            metrics_logger.close()

    # final artifacts
    save_checkpoint_multihost(config.output_dir, state)
    ckpt_lib.export_safetensors(state, os.path.join(config.output_dir, "model.safetensors"))

    # post-train in-process eval (reference: train.py:343-382 merges LoRA and
    # runs LocalInference over the eval sets)
    if config.do_eval and config.eval_sets:
        final_metrics.update(post_train_eval(config, model_pack, state, template, dev))
    logger.info("training done in %.1fs", time.time() - t_start)
    return final_metrics


def save_checkpoint_multihost(output_dir: str, state) -> Optional[str]:
    """The checkpoint write: every process joins the gathers of its
    shards, the master writes (``training/checkpoint.py``)."""
    return ckpt_lib.save_checkpoint(output_dir, state)


def post_train_eval(config, model_pack, state, template, dev) -> Dict[str, float]:
    """The evaluation suite on the trained model, LoRA merged: each
    process holds the whole model and runs its mod-N share of the samples;
    the master scores them (``eval/<tag>``, empty on the others)."""
    from ultravox_torch.evaluation.eval import EvalConfig, eval_datasets
    from ultravox_torch.inference.infer import LocalInference
    from ultravox_torch.models.lora import merge_lora

    params = gather_tree(ts.merge_params(template, state.trainable, state.frozen))
    params = merge_lora(map_paths(lambda _, v: v.detach(), params))
    inference = LocalInference(
        params, model_pack.config, model_pack.processor, max_cache_len=2048, device=dev,
    )
    scores = eval_datasets(
        inference,
        EvalConfig(
            eval_sets=config.eval_sets,
            num_samples=config.eval_num_samples,
            batch_size=config.eval_batch_size,
            max_tokens=config.eval_max_tokens,
            output_dir=os.path.join(config.output_dir, "eval"),
        ),
    )
    return {f"eval/{name}": float(s["score"]) for name, s in scores.items()}


def _without_labels(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``batch`` supervising nothing: a forward that adds 0 to the sums."""
    out = dict(batch)
    for k in ("labels", "alt_labels"):
        if k in out:
            out[k] = np.full_like(out[k], -100)
    return out


def validate(config, model_pack, state, template, mesh=None) -> Dict[str, float]:
    """Weighted val loss over the configured val sets (reference:
    evaluation/validate.py semantics), through the train step's attention
    and vocabulary chunking. Over several processes each runs a mod-N
    shard of the set in ``batch_size / N`` rows (N batch shards; tensor
    and pipe peers run the same rows), the same number of forwards on every process
    (the short ones run a batch that supervises nothing, since a forward
    gathers fsdp shards), and the (sum, count) pairs are summed over the
    batch axes."""
    eval_fn = ts.make_eval_step(
        model_pack.config, config.loss_config, template,
        vocab_chunk=config.vocab_loss_chunk,
        attn_impl=config.attn_impl,
        pipe_mesh=mesh if config.mesh_pipe > 1 else None,
        pipe_micro=config.pipe_microbatches,
        mesh=mesh,
    )
    dev = next(iter(state.frozen.values())).device
    group = mesh.batch_group if mesh is not None else None
    n_proc = mesh.batch_shards if mesh is not None else 1
    out: Dict[str, float] = {}
    args = data_types.ValDatasetArgs()
    for name in config.val_sets:
        ds = prepare_dataset(
            config, model_pack, [name], args,
            num_samples=config.val_num_samples,
        )
        if n_proc > 1:
            ds = multihost.ShardedDataset(ds, n_proc, mesh.batch_index)
        local = list(batch_iterator(ds, model_pack.collator, config.batch_size // n_proc,
                                    infinite=False))
        n = len(local)
        if group is not None:
            # the most and the fewest batches a process has, on every process,
            # so that all of them refuse a set some cannot take part in
            n_all = torch.tensor([n, -n], device=dev)
            dist.all_reduce(n_all, op=dist.ReduceOp.MAX, group=group)
            n, fewest = int(n_all[0]), -int(n_all[1])
            if n and not fewest:
                raise ValueError(f"val set {name} has fewer samples than the {n_proc} processes")
        total, count = 0.0, 0
        for i in range(n):
            batch = local[i] if i < len(local) else _without_labels(local[-1])
            s, c = eval_fn(state, to_device(batch, dev))
            total += float(s)
            count += int(c)
        if group is not None:
            sums = all_reduce_(torch.tensor([total, count], dtype=torch.float64, device=dev),
                               group)
            total, count = float(sums[0]), int(sums[1])
        if count:
            out[f"val_loss/{name}"] = total / count
    return out


def main():
    config = get_train_config()
    train(config)


if __name__ == "__main__":
    main()
