"""Training configuration: YAML composition + CLI overrides.

Re-design of the reference's simple_parsing setup (training/config_base.py):
``meta_config.yaml`` is always loaded as the base, ``--config_path <file>``
overlays it, and any remaining ``--key value`` CLI args override individual
fields (values YAML-parsed, hyphens normalised to underscores). The keys are
the JAX package's, plus ``device``: unset trains on the card, ``"cpu"`` runs
the plain versions of the kernels. The recipes in ``configs/`` are copies of
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Optional

import yaml

from ultravox_torch.models.config import LossConfig, LossFunction, LossMaskType

logger = logging.getLogger(__name__)

CONFIGS_DIR = os.path.join(os.path.dirname(__file__), "configs")
META_CONFIG = os.path.join(CONFIGS_DIR, "meta_config.yaml")


def expand_data_set_specs(entries) -> tuple:
    """Normalise a mixed data-set list to (names, weights).

    Accepts plain names, reference-style ``{name, weight}`` dicts
    (training/configs/v0.4.1_config.yaml uses per-set weights), and compact
    template specs ``{template, langs, weight?, weights?}`` where
    ``template`` contains ``{lang}``, ``weight`` is the default per-language
    weight and ``weights`` maps individual languages to overrides — the
    data-driven form the repo's dataset configs already use.
    """
    names: List[str] = []
    weights: List[float] = []
    for entry in entries:
        if isinstance(entry, str):
            names.append(entry)
            weights.append(1.0)
        elif isinstance(entry, dict) and "template" in entry:
            default_w = float(entry.get("weight", 1.0))
            overrides = entry.get("weights") or {}
            for lang in entry["langs"]:
                names.append(entry["template"].format(lang=lang))
                weights.append(float(overrides.get(lang, default_w)))
        elif isinstance(entry, dict) and "name" in entry:
            names.append(entry["name"])
            weights.append(float(entry.get("weight", 1.0)))
        else:
            raise ValueError(f"bad data_sets entry: {entry!r}")
    return names, weights


@dataclasses.dataclass
class TrainConfig:
    # -- experiment ------------------------------------------------------
    exp_name: str = "ultravox-tpu"
    output_dir: Optional[str] = None
    seed: int = 42
    verbose: bool = False

    # -- models ----------------------------------------------------------
    text_model: str = ""  # local dir (or hub id when egress exists)
    audio_model: str = ""
    tokenizer_path: Optional[str] = None  # defaults to text_model
    # inline configs for offline/test runs (dicts in HF config.json schema)
    text_model_config: Optional[Dict[str, Any]] = None
    audio_model_config: Optional[Dict[str, Any]] = None
    llm_only_training: bool = False

    # projector hparams (reference: ultravox_config.py)
    projector_hidden_size: int = 4096
    stack_factor: int = 8
    norm_init: float = 0.4
    projector_act: str = "swiglu"
    projector_ln_mid: bool = True
    audio_latency_block_size: Optional[int] = None

    # -- checkpoint load / resume -----------------------------------------
    model_load_dir: Optional[str] = None
    resume_from_load_dir: bool = False
    # fnmatch patterns over state-dict keys: load only matching params from
    # model_load_dir (reference: model_load_parameters, model_types.py:252-275)
    model_load_parameters: Optional[List[str]] = None

    # -- loss --------------------------------------------------------------
    loss_function: str = "kl"  # "ce" | "kl"
    kl_temperature: float = 2.0
    eot_loss_weight: float = 1.0
    loss_mask_type: str = "last_assistant"

    # -- trainability -------------------------------------------------------
    trainable_params: List[str] = dataclasses.field(
        default_factory=lambda: [r".*projector/.*"]
    )
    # LoRA configs (dicts: r, lora_alpha, target_modules, unfreeze_layers);
    # r > 0 adds adapters whose params train; r == 0 freezes the tower except
    # unfreeze_layers patterns (reference: apply_lora, ultravox_model.py:690)
    text_model_lora: Optional[Dict[str, Any]] = None
    audio_model_lora: Optional[Dict[str, Any]] = None

    # -- data ----------------------------------------------------------------
    # Entries are dataset names, reference-style dicts ({name, weight} —
    # train_sets in configs/v0.*.yaml), or compact template specs
    # ({template: "commonvoice-{lang}-transcription", langs: [...],
    #   weight: 1, weights: {hi: 10}}) expanded at construction; everything
    # normalises to flat data_sets + data_weights.
    data_sets: List[Any] = dataclasses.field(default_factory=list)
    data_weights: Optional[List[float]] = None
    val_sets: List[Any] = dataclasses.field(default_factory=list)
    num_samples: Optional[int] = None
    batch_size: int = 4  # global batch size
    max_audio_duration_secs: float = 16.0
    max_input_characters: int = 2200
    max_response_tokens: Optional[int] = 50
    shuffle_data: bool = True
    shuffle_buffer_size: int = 1000
    num_data_workers: int = 4  # host feature-pipeline threads
    augmentations: List[Any] = dataclasses.field(default_factory=list)

    # -- optimizer / schedule ----------------------------------------------
    lr: float = 2e-3
    lr_scheduler: str = "cosine_with_min_lr"
    lr_warmup_steps: int = 1000
    min_lr_rate: float = 0.1
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    optimizer_betas: List[float] = dataclasses.field(
        default_factory=lambda: [0.9, 0.999]
    )
    max_steps: int = 10_000
    grad_accum_steps: int = 1

    # -- cadence -----------------------------------------------------------
    val_steps: Optional[int] = None
    val_num_samples: Optional[int] = 64  # None = the whole val set
    save_steps: Optional[int] = 1000
    logging_steps: int = 10

    # -- post-train in-process eval (reference: train.py:343-382) ------------
    do_eval: bool = False
    eval_sets: List[str] = dataclasses.field(default_factory=list)
    eval_num_samples: int = 64
    eval_batch_size: int = 8
    eval_max_tokens: int = 64

    # -- numerics / parallelism ---------------------------------------------
    param_dtype: str = "bfloat16"
    remat: bool = True
    # "xla" (plain attention) or "flash" (the differentiable flash_attention
    # kernel in both towers, forward and backward)
    attn_impl: str = "xla"
    # project hidden states to the vocabulary N positions at a time inside
    # the loss (chunked cross-entropy + KL): the (B, T, V) fp32 logits never
    # materialize. None/0 = dense loss.
    vocab_loss_chunk: Optional[int] = 256
    # the parallel layout of the JAX package's recipes: one process a
    # device over the data, fsdp, tensor and pipe axes (torchrun's
    # environment or the three keys below); mesh_pipe stages each hold
    # num_layers / mesh_pipe decoder layers and run pipe_microbatches
    # microbatches a pass (None: the largest of 4/3/2/1 x stages dividing
    # the global batch) through the GPipe schedule of parallel/pipeline.py
    mesh_data: int = 1
    mesh_fsdp: int = -1
    mesh_tensor: int = 1
    mesh_pipe: int = 1
    pipe_microbatches: Optional[int] = None
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    # the port's device: None trains on the card, "cpu" runs the plain
    # versions of the kernels
    device: Optional[str] = None

    # -- logging sinks --------------------------------------------------------
    report_logs_to: List[str] = dataclasses.field(
        default_factory=lambda: ["tensorboard"]
    )

    # -- collation / bucketing ------------------------------------------------
    text_pad_multiple: int = 64
    mel_pad_multiple: int = 400

    def __post_init__(self):
        if self.output_dir is None:
            self.output_dir = os.path.join("runs", self.exp_name)
        if any(not isinstance(e, str) for e in self.data_sets):
            if self.data_weights is not None:
                raise ValueError(
                    "use either data_weights or per-entry weights, not both"
                )
            names, weights = expand_data_set_specs(self.data_sets)
            self.data_sets, self.data_weights = names, weights
        self.val_sets = expand_data_set_specs(self.val_sets)[0]
        self.eval_sets = expand_data_set_specs(self.eval_sets)[0]
        if self.data_weights is not None and len(self.data_weights) != len(
            self.data_sets
        ):
            raise ValueError("data_weights must match data_sets length")
        if self.loss_function not in ("ce", "kl"):
            raise ValueError(f"unknown loss_function {self.loss_function}")

    @property
    def effective_trainable_patterns(self) -> List[str]:
        from ultravox_torch.models.config import LoraConfig

        patterns = list(self.trainable_params)
        for tower, lora_dict in (
            ("language_model", self.text_model_lora),
            ("audio_tower", self.audio_model_lora),
        ):
            if not lora_dict:
                continue
            cfg = LoraConfig.from_dict(lora_dict)
            if cfg.r > 0:
                patterns.append(rf".*{tower}/.*lora_[ab]$")
            for pat in cfg.unfreeze_layers:
                patterns.append(rf".*{tower}/.*{pat}.*")
        return patterns

    @property
    def loss_config(self) -> LossConfig:
        return LossConfig(
            loss_function=LossFunction(self.loss_function),
            kl_temperature=self.kl_temperature,
            eot_loss_weight=self.eot_loss_weight,
        )

    @property
    def loss_mask(self) -> LossMaskType:
        return LossMaskType(self.loss_mask_type)


def _coerce(value: str) -> Any:
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def load_yaml(path: str) -> Dict[str, Any]:
    """Load a config yaml; an ``extends: <path>`` key (relative to the
    file) loads that config first and overlays this file's keys on it."""
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base_path = data.pop("extends", None)
    if base_path is not None:
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(path), base_path)
        merged = load_yaml(base_path)
        merged.update(data)
        return merged
    return data


def get_train_config(argv: Optional[List[str]] = None) -> TrainConfig:
    """meta_config.yaml + ``--config_path`` overlay(s) + ``--key value``
    overrides (reference: config_base.py:326-343)."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    merged: Dict[str, Any] = {}
    if os.path.exists(META_CONFIG):
        merged.update(load_yaml(META_CONFIG))

    i = 0
    overrides: Dict[str, Any] = {}
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected argument {arg!r}")
        key = arg[2:].replace("-", "_")
        if "=" in key:
            key, _, value = key.partition("=")
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for {arg!r}")
            value = argv[i + 1]
            i += 2
        if key == "config_path":
            merged.update(load_yaml(value))
        else:
            overrides[key] = _coerce(value)
    merged.update(overrides)

    valid = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = set(merged) - valid
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return TrainConfig(**merged)
