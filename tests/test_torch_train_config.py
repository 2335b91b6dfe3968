"""The port's training configuration against the JAX package's, on the CPU.

- Each of the 15 recipes: the port's copy equals the JAX file byte for byte,
  and ``get_train_config`` gives the same ``TrainConfig`` in both packages
  (``dataclasses.asdict``, the port's one extra key ``device`` set aside);
  every data set a recipe names resolves in the port's registry.
- The cases of ``tests/test_recipes.py``: ``extends:``, data-set spec
  expansion, CLI coercion (``--k=v`` and ``--k v``, hyphens), the unknown-key
  error, ``effective_trainable_patterns`` and ``loss_mask``.
"""

import dataclasses
import glob
import os

import pytest

from ultravox_torch.data import registry as tregistry
from ultravox_torch.training import config as tc
from ultravox_tpu.training import config as jc

RECIPES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(jc.CONFIGS_DIR, "*.yaml")))


def _both(argv_jax, argv_port):
    j = dataclasses.asdict(jc.get_train_config(argv_jax))
    t = dataclasses.asdict(tc.get_train_config(argv_port))
    assert t.pop("device") is None
    return j, t


def test_recipe_set_is_whole():
    assert len(RECIPES) == 15
    assert sorted(os.listdir(tc.CONFIGS_DIR)) == RECIPES
    assert tc.META_CONFIG == os.path.join(os.path.dirname(tc.__file__), "configs",
                                          "meta_config.yaml")


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_matches_jax(name):
    jpath, tpath = os.path.join(jc.CONFIGS_DIR, name), os.path.join(tc.CONFIGS_DIR, name)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    argv_j = [] if name == "meta_config.yaml" else ["--config_path", jpath]
    argv_t = [] if name == "meta_config.yaml" else ["--config_path", tpath]
    j, t = _both(argv_j, argv_t)
    assert t == j
    cfg = tc.get_train_config(argv_t)
    for ds in list(cfg.data_sets) + list(cfg.val_sets) + list(cfg.eval_sets):
        if ds != "synthetic-asr":
            tregistry._resolve_config(ds)


@pytest.mark.parametrize("argv", [
    ["--lr=3e-4", "--batch-size", "12", "--trainable_params", '[".*x.*", ".*y.*"]'],
    ["--text_model_lora", "{r: 4, lora_alpha: 16}", "--val_steps", "null", "--remat=false"],
    ["--exp_name", "run-7", "--mesh-fsdp=-1", "--data_sets", "[a, b]", "--data_weights", "[1, 2.5]"],
    ["--data_sets", "[{template: 'cv-{lang}-t', langs: [en, hi], weights: {hi: 3}}]",
     "--output_dir", "/x/y", "--num_samples", "0x10"],
])
def test_cli_coercion_matches_jax(argv):
    path = os.path.join(jc.CONFIGS_DIR, "test_train.yaml")
    tpath = os.path.join(tc.CONFIGS_DIR, "test_train.yaml")
    j, t = _both(["--config_path", path] + argv, ["--config_path", tpath] + argv)
    assert t == j


def test_device_key_and_unknown_keys():
    assert tc.get_train_config(["--device", "cpu"]).device == "cpu"
    assert tc.get_train_config([]).device is None
    with pytest.raises(ValueError, match="unknown config keys"):
        tc.get_train_config(["--no_such_key", "1"])
    with pytest.raises(ValueError, match="unexpected argument"):
        tc.get_train_config(["positional"])
    with pytest.raises(ValueError, match="missing value"):
        tc.get_train_config(["--lr"])
    with pytest.raises(ValueError, match="unknown loss_function"):
        tc.TrainConfig(loss_function="mse")


def test_extends_overlay(tmp_path):
    (tmp_path / "base.yaml").write_text("a: 1\nb: 2\n")
    (tmp_path / "child.yaml").write_text("extends: base.yaml\nb: 3\nc: 4\n")
    assert tc.load_yaml(str(tmp_path / "child.yaml")) == {"a": 1, "b": 3, "c": 4}
    assert tc.load_yaml(str(tmp_path / "child.yaml")) == jc.load_yaml(str(tmp_path / "child.yaml"))


def test_data_set_spec_expansion():
    entries = [
        "plain",
        {"name": "weighted", "weight": 2.5},
        {"template": "cv-{lang}-t", "langs": ["en", "hi"], "weight": 0.1, "weights": {"hi": 10}},
    ]
    assert tc.expand_data_set_specs(entries) == jc.expand_data_set_specs(entries)
    assert tc.expand_data_set_specs(entries) == (
        ["plain", "weighted", "cv-en-t", "cv-hi-t"], [1.0, 2.5, 0.1, 10.0])
    cfg = tc.TrainConfig(data_sets=["a", {"template": "x-{lang}", "langs": ["b", "c"],
                                          "weights": {"c": 3}}])
    assert (cfg.data_sets, cfg.data_weights) == (["a", "x-b", "x-c"], [1.0, 1.0, 3.0])
    with pytest.raises(ValueError, match="not both"):
        tc.TrainConfig(data_sets=[{"name": "a", "weight": 2}], data_weights=[1.0])
    with pytest.raises(ValueError, match="bad data_sets entry"):
        tc.expand_data_set_specs([3])
    with pytest.raises(ValueError, match="must match"):
        tc.TrainConfig(data_sets=["a", "b"], data_weights=[1.0])


@pytest.mark.parametrize("kw", [
    {},
    {"text_model_lora": {"r": 8}, "audio_model_lora": {"r": 0, "unfreeze_layers": ["fc1"]}},
    {"audio_model_lora": {"r": 8, "unfreeze_layers": ["layer_norm", "conv"]},
     "trainable_params": [".*projector/ln.*"]},
])
def test_patterns_loss_config_and_mask(kw):
    for lm in ("last_assistant", "all", "after_audio"):
        for lf in ("ce", "kl"):
            j = jc.TrainConfig(loss_mask_type=lm, loss_function=lf, kl_temperature=3.0, **kw)
            t = tc.TrainConfig(loss_mask_type=lm, loss_function=lf, kl_temperature=3.0, **kw)
            assert t.effective_trainable_patterns == j.effective_trainable_patterns
            assert t.loss_mask.value == j.loss_mask.value == lm
            tl, jl = t.loss_config, j.loss_config
            assert (tl.loss_function.value, tl.kl_temperature, tl.eot_loss_weight,
                    tl.requires_alt_fields) == (jl.loss_function.value, jl.kl_temperature,
                                                jl.eot_loss_weight, jl.requires_alt_fields)
