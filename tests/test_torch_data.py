"""The port's data pipeline against the JAX package's, on the CPU.

Every piece runs in both packages on the same inputs and must give the same
result exactly (the pipeline is host-side numpy and Python):

- ``SyntheticAsrDataset`` samples and its filters; ``InterleaveDataset``
  order and restarts; ``Range``; ``EmptyDataset``;
- the resolved config of every name in the JAX ``DATASET_MAP``;
- ``render_template`` and ``format_asr_text``;
- every registered augmentation at one seed (the JAX resampler on scipy:
  its C++ one is another algorithm, ROADMAP queue C);
- MDS: the port's writer read by the JAX reader and the reverse, every
  encoding, and ``GenericDataset`` over an MDS directory;
- ``VoiceSample``'s JSON and raw-WAV constructors;
- ``UltravoxDataproc`` for each ``LossMaskType``, with ``alt_*`` fields,
  ``max_response_tokens`` and ``inference_mode``: the port's
  ``load_tokenizer`` against the JAX package's ``AutoTokenizer`` on one saved
  tokenizer, ids, labels and mel equal;
- the collated batches of ``prepare_dataset`` + ``batch_iterator`` for
  ``test_train.yaml``, at 1 and 4 data workers.
"""

import copy
import dataclasses
import enum
import itertools
import os

import numpy as np
import pytest

from tests.helpers import make_tiny_tokenizer
from ultravox_torch.data import datasets as tds
from ultravox_torch.data import mds as tmds
from ultravox_torch.data import registry as treg
from ultravox_torch.data import sample as tsample
from ultravox_torch.data import text_proc as ttext
from ultravox_torch.data import types as ttypes
from ultravox_torch.data.aug import AugmentationArgs as TAugArgs
from ultravox_torch.data.aug import AugRegistry as TAugRegistry
from ultravox_torch.data.aug import create_augmentation as tcreate_aug
from ultravox_torch.models import config as tmc
from ultravox_torch.models.data_proc import UltravoxDataproc as TDataproc
from ultravox_torch.models.processor import UltravoxProcessor as TProcessor
from ultravox_torch.models.tokenizer import load_tokenizer
from ultravox_tpu.data import datasets as jds
from ultravox_tpu.data import mds as jmds
from ultravox_tpu.data import registry as jreg
from ultravox_tpu.data import sample as jsample
from ultravox_tpu.data import text_proc as jtext
from ultravox_tpu.data import types as jtypes
from ultravox_tpu.data.aug import AugmentationArgs as JAugArgs
from ultravox_tpu.data.aug import AugRegistry as JAugRegistry
from ultravox_tpu.data.aug import create_augmentation as jcreate_aug
from ultravox_tpu.models import config as jmc
from ultravox_tpu.models.data_proc import UltravoxDataproc as JDataproc
from ultravox_tpu.models.processor import UltravoxProcessor as JProcessor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(x):
    """Enums as their values, dataclasses as dicts: comparable across packages."""
    if isinstance(x, enum.Enum):
        return x.value
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _same_samples(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.messages == y.messages
        assert x.audio_transcript == y.audio_transcript and x.sample_rate == y.sample_rate
        if x.audio is None:
            assert y.audio is None
        else:
            assert x.audio.dtype == y.audio.dtype == np.float32
            np.testing.assert_array_equal(x.audio, y.audio)
    return a


def _fake(pkg_ds, pkg_sample, n, tag):
    class Fake(pkg_ds.SizedIterableDataset):
        def __init__(self):
            self._name = tag

        def __iter__(self):
            for i in range(n):
                yield pkg_sample.VoiceSample(messages=[
                    {"role": "user", "content": f"{tag} q{i}"},
                    {"role": "assistant", "content": f"a{i}"}])

        def __len__(self):
            return n

    return Fake()


# -- datasets ------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    {"include_audio": False},
    {"max_audio_duration_secs": 0.5},
    {"min_audio_duration_secs": 2.0},
    {"max_input_characters": 60, "split": "validation"},
])
def test_synthetic_asr_samples_and_filters(kw):
    j = jds.SyntheticAsrDataset(jtypes.VoiceDatasetArgs(
        **{k: jtypes.DatasetSplit(v) if k == "split" else v for k, v in kw.items()}))
    t = tds.SyntheticAsrDataset(ttypes.VoiceDatasetArgs(
        **{k: ttypes.DatasetSplit(v) if k == "split" else v for k, v in kw.items()}))
    assert (len(t), t.name) == (len(j), j.name) == (73, "synthetic-asr")
    _same_samples(j, t)


@pytest.mark.parametrize("sizes,weights", [
    ((100, 100), (3.0, 1.0)),
    ((4, 2), (1.0, 2.0)),
    ((5, 0, 3), (1.0, 1.0, 2.5)),
    ((7,), None),
])
def test_interleave_order_and_restarts(sizes, weights):
    def mk(ds, sample):
        return ds.InterleaveDataset([_fake(ds, sample, n, f"d{i}") for i, n in enumerate(sizes)],
                                    weights)

    j, t = mk(jds, jsample), mk(tds, tsample)
    assert (len(t), t.name) == (len(j), j.name)
    assert _same_samples(j, t)


@pytest.mark.parametrize("n", [None, 0, 3, 10, 50])
def test_range_and_empty(n):
    j = jds.Range(_fake(jds, jsample, 10, "r"), n)
    t = tds.Range(_fake(tds, tsample, 10, "r"), n)
    assert len(t) == len(j)
    _same_samples(j, t)
    assert len(tds.EmptyDataset(5)) == 5 and list(tds.EmptyDataset(5)) == []


def test_registry_resolves_every_dataset_as_jax():
    names = sorted(jreg.DATASET_MAP)
    assert names == sorted(treg.DATASET_MAP) and len(names) > 100
    for name in names:
        assert _plain(treg._resolve_config(name)) == _plain(jreg._resolve_config(name)), name
    assert len(treg.create_dataset("synthetic-asr", ttypes.VoiceDatasetArgs())) == 73
    with pytest.raises(KeyError, match="unknown dataset"):
        treg.create_dataset("nope", ttypes.VoiceDatasetArgs())


@pytest.mark.parametrize("template,row,kw", [
    ("{{text}}", {"text": "hello"}, {}),
    ("Transcribe {{language}}: <|audio|>", {}, {"language": "hi"}),
    ("{{ text_proc.format_asr_text(text) }}", {"text": "HELLO <COMMA> I AM HERE <PERIOD>"}, {}),
    ("{{q}} -> {{ opts | join(', ') }}", {"q": "pick"}, {"template_args": {"opts": "xyz"}}),
    ("{{missing}}", {}, {}),
    ("{{ text_proc.format_asr_text(text) }}", {"text": "<NOISE>"}, {}),
])
def test_render_template(template, row, kw):
    def run(mod):
        try:
            return mod.render_template(template, row, **kw)
        except mod.TemplateError as e:
            return ("TemplateError", type(e).__mro__[1].__name__)

    assert run(ttext) == run(jtext)


# -- augmentations -------------------------------------------------------------


def test_every_registered_augmentation_matches_jax(monkeypatch):
    import ultravox_tpu.utils.audio as jaudio

    monkeypatch.setattr(jaudio, "_USE_NATIVE", False)
    names = sorted(JAugRegistry._configs)
    assert names == sorted(TAugRegistry._configs)
    rng = np.random.default_rng(0)
    audio = (0.2 * np.sin(np.linspace(0, 300, 16000)) + 0.01 * rng.standard_normal(16000))
    audio = audio.astype(np.float32)
    for name in names:
        j = jcreate_aug(name, JAugArgs(seed=3))
        t = tcreate_aug(name, TAugArgs(seed=3))
        for _ in range(4):  # the gates and draws advance in step
            a, b = j.apply_audio(audio.copy()), t.apply_audio(audio.copy())
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    s = tsample.VoiceSample(messages=[{"role": "user", "content": "x"}], audio=audio)
    np.testing.assert_array_equal(
        tcreate_aug("gain", TAugArgs(seed=1)).apply_sample(s).audio,
        jcreate_aug("gain", JAugArgs(seed=1)).apply_sample(
            jsample.VoiceSample(messages=s.messages, audio=audio)).audio)


def test_ffmpeg_codec_skips_when_binary_absent():
    aug = tcreate_aug({"name": "amr", "type": "ffmpeg_compression",
                       "args": {"codec": "amr", "bitrate": 12200,
                                "ffmpeg_bin": "definitely-not-ffmpeg-xyz"}})
    audio = np.ones(100, np.float32) * 0.1
    np.testing.assert_array_equal(aug.apply_audio(audio.copy()), audio)


# -- MDS -----------------------------------------------------------------------


MDS_COLUMNS = {"text": "str", "blob": "bytes", "count": "int", "score": "float32",
               "meta": "json", "vec": "ndarray:float32:4", "dyn": "ndarray", "u": "uint32"}


def _mds_rows():
    return [{"text": f"sample {i} — ünïcødé", "blob": bytes([i, i + 1, i + 2]),
             "count": i * 1000 - 5, "score": i / 7.0, "meta": {"i": i, "tags": ["a", "b"]},
             "vec": np.arange(4, dtype=np.float32) + i, "dyn": np.ones((2, i + 1), np.int64) * i,
             "u": i * 3}
            for i in range(17)]


@pytest.mark.parametrize("writer,reader", [(tmds, jmds), (jmds, tmds)],
                         ids=["port_writes", "jax_writes"])
def test_mds_round_trip_across_packages(tmp_path, writer, reader):
    rows = _mds_rows()
    with writer.MDSWriter(str(tmp_path / "ds"), MDS_COLUMNS, size_limit=512) as w:
        for r in rows:
            w.write(r)
    other = writer is tmds and jmds or tmds
    with other.MDSWriter(str(tmp_path / "ds2"), MDS_COLUMNS, size_limit=512) as w:
        for r in rows:
            w.write(r)
    for name in sorted(os.listdir(tmp_path / "ds")):  # the same bytes
        assert (tmp_path / "ds" / name).read_bytes() == (tmp_path / "ds2" / name).read_bytes()
    ds = reader.LocalMDSDataset(str(tmp_path / "ds"))
    assert len(ds) == 17 and len(ds.shards) > 1
    for i, r in enumerate(rows):
        got = ds[i]
        for k in ("text", "blob", "count", "meta", "u"):
            assert got[k] == r[k]
        assert got["score"] == np.float32(r["score"])
        np.testing.assert_array_equal(got["vec"], r["vec"])
        np.testing.assert_array_equal(got["dyn"], r["dyn"])
    a = [r["count"] for r in tmds.LocalMDSDataset(str(tmp_path / "ds"), shuffle=True, shuffle_seed=3)]
    b = [r["count"] for r in jmds.LocalMDSDataset(str(tmp_path / "ds"), shuffle=True, shuffle_seed=3)]
    assert a == b and a != sorted(a)
    with pytest.raises(ImportError, match="mosaicml-streaming"):
        tmds.load_mds_dataset("gs://bucket/ds")


def test_generic_dataset_over_mds(tmp_path, monkeypatch):
    import ultravox_tpu.utils.audio as jaudio

    monkeypatch.setattr(jaudio, "_USE_NATIVE", False)  # scipy, as the port
    rng = np.random.default_rng(0)
    with tmds.MDSWriter(str(tmp_path / "train"), {"audio": "bytes", "text": "str"}) as w:
        for i in range(6):
            audio = (rng.standard_normal(8000 + 800 * i) * 0.1).astype(np.float32)
            sr = 16000 if i % 2 else 24000  # the odd rows resample on the way in
            w.write({"audio": tsample.audio_to_wav_bytes(audio, sr), "text": f"utterance {i}"})

    def make(types, ds):
        cfg = types.DatasetConfig(
            name="local-mds", path=str(tmp_path), use_mds=True,
            splits=[{"name": "train", "num_samples": 6}],
            user_template="transcribe <|audio|>", assistant_template="{{text}}",
            transcript_template="{{text}}")
        return ds.GenericDataset(cfg, types.VoiceDatasetArgs(shuffle=False))

    got = _same_samples(make(jtypes, jds), make(ttypes, tds))
    assert len(got) == 6 and got[0].messages[-1]["content"] == "utterance 0"


def test_voice_sample_json_and_wav():
    rng = np.random.default_rng(2)
    audio = (0.1 * rng.standard_normal(1600)).astype(np.float32)
    wav = jsample.audio_to_wav_bytes(audio, 16000)
    j = jsample.VoiceSample.from_prompt_and_raw_wav("say <|audio|>", wav)
    t = tsample.VoiceSample.from_prompt_and_raw_wav("say <|audio|>", wav)
    _same_samples([j], [t])
    assert t.to_json() == j.to_json()
    _same_samples([jsample.VoiceSample.from_json(j.to_json())],
                  [tsample.VoiceSample.from_json(t.to_json())])
    past = [{"role": "user", "content": "hi"}, {"role": "assistant", "content": "yo"}]
    j.add_past_messages(past)
    t.add_past_messages(past)
    assert t.messages == j.messages


# -- UltravoxDataproc ----------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    make_tiny_tokenizer().save_pretrained(str(d))
    return str(d)


def _samples(sample_mod, n=6):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        msgs = [{"role": "user", "content": f"Transcribe\n<|audio|> {i}"},
                {"role": "assistant", "content": "hello world " * (1 + 3 * i)}]
        if i % 3 == 1:
            msgs = [{"role": "system", "content": "be brief"}] + msgs
        if i % 3 == 2:
            msgs = [{"role": "user", "content": "hi"},
                    {"role": "assistant", "content": "yes"}] + msgs
        out.append(sample_mod.VoiceSample(
            messages=msgs, audio=(0.1 * rng.standard_normal(4000 + 1500 * i)).astype(np.float32),
            audio_transcript="hello world"))
    return out


def _features_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("mask", ["last_assistant", "all", "after_audio"])
@pytest.mark.parametrize("alt,max_resp,infer", [
    (False, None, False), (True, 5, False), (True, None, False), (False, 3, True)])
def test_dataproc_matches_jax(tokenizer_dir, mask, alt, max_resp, infer):
    from transformers import AutoTokenizer

    jproc = JProcessor(AutoTokenizer.from_pretrained(tokenizer_dir))
    tproc = TProcessor(load_tokenizer(tokenizer_dir))

    class Listed:  # a list as a dataset in either package
        name = "listed"

        def __init__(self, items):
            self.items = items

        def __iter__(self):
            return iter(self.items)

        def __len__(self):
            return len(self.items)

    kw = dict(include_alt_fields=alt, max_response_tokens=max_resp, inference_mode=infer)
    j = JDataproc(Listed(_samples(jsample)), jproc,
                  loss_mask_type=jmc.LossMaskType(mask), **kw)
    t = TDataproc(Listed(_samples(tsample)), tproc,
                  loss_mask_type=tmc.LossMaskType(mask), **kw)
    for a, b in zip(j, t):
        _features_equal(a, b)


def test_tokenizer_survives_deepcopy(tokenizer_dir):
    tok = load_tokenizer(tokenizer_dir)
    twin = copy.deepcopy(tok)
    text = tok.apply_chat_template([{"role": "user", "content": "hello world"}], tokenize=False,
                                   add_generation_prompt=True)
    assert twin.encode(text) == tok.encode(text) and twin.pad_token_id == tok.pad_token_id


# -- prepare_dataset + batch_iterator -------------------------------------------


@pytest.mark.parametrize("workers,aug", [(1, "gain"), (4, None)])
def test_collated_batches_match_jax(tokenizer_dir, tmp_path, workers, aug):
    """At 4 workers each thread draws from its own copy of an augmentation
    (in either package), so which sample a draw lands on depends on thread
    timing: the augmented case runs at 1 worker."""
    from ultravox_torch.training import config as tcfg
    from ultravox_torch.training import model_factory as tmf
    from ultravox_torch.training import train as ttrain
    from ultravox_tpu.training import config as jcfg
    from ultravox_tpu.training import model_factory as jmf
    from ultravox_tpu.training import train as jtrain

    argv = ["--tokenizer_path", tokenizer_dir, "--text_model", "", "--output_dir",
            str(tmp_path), "--num_data_workers", str(workers)]
    if aug:
        argv += ["--augmentations", f"[{aug}]"]
    jc = jcfg.get_train_config(
        ["--config_path", os.path.join(ROOT, "ultravox_tpu/training/configs/test_train.yaml")] + argv)
    tc = tcfg.get_train_config(
        ["--config_path", os.path.join(ROOT, "ultravox_torch/training/configs/test_train.yaml")]
        + argv + ["--device", "cpu"])
    jp, tp = jmf.create_model_pack(jc), tmf.create_model_pack(tc)
    assert tp.tokenizer.pad_token_id == jp.tokenizer.pad_token_id
    assert dataclasses.asdict(tp.collator) == dataclasses.asdict(jp.collator)
    augs = {ttrain: ttrain.make_augmentation(tc),
            jtrain: aug and jcreate_aug(aug, JAugArgs(seed=jc.seed))}

    def batches(train_mod, cfg, pack, types, n):
        ds = train_mod.prepare_dataset(cfg, pack, cfg.data_sets, types.TrainDatasetArgs(),
                                       num_samples=cfg.num_samples, augmentation=augs[train_mod])
        return list(itertools.islice(train_mod.batch_iterator(ds, pack.collator, cfg.batch_size), n))

    jb = batches(jtrain, jc, jp, jtypes, 40)  # past the 73 samples: the restart
    tb = batches(ttrain, tc, tp, ttypes, 40)
    for a, b in zip(jb, tb):
        _features_equal(a, b)
    val_j = list(jtrain.batch_iterator(jtrain.prepare_dataset(jc, jp, ["synthetic-asr"],
                 jtypes.ValDatasetArgs(), num_samples=5), jp.collator, 2, infinite=False))
    val_t = list(ttrain.batch_iterator(ttrain.prepare_dataset(tc, tp, ["synthetic-asr"],
                 ttypes.ValDatasetArgs(), num_samples=5), tp.collator, 2, infinite=False))
    assert len(val_t) == len(val_j) == 3
    for a, b in zip(val_j, val_t):
        _features_equal(a, b)


# -- tools -----------------------------------------------------------------------


def test_data_tool_prints_and_saves_as_jax(tmp_path, monkeypatch, capsys):
    from ultravox_torch.tools import data_tool as tdt
    from ultravox_tpu.tools import data_tool as jdt

    outs = {}
    for name, mod in (("jax", jdt), ("port", tdt)):
        monkeypatch.setattr("sys.argv", ["data_tool", "--data_set", "synthetic-asr", "-n", "3",
                                         "--augmentation", "gain",
                                         "--save_audio_dir", str(tmp_path / name)])
        mod.main()
        outs[name] = capsys.readouterr().out.replace(str(tmp_path / name), "DIR")
    assert outs["port"] == outs["jax"] and outs["port"].count("--- sample") == 3
    for i in range(3):
        wav = f"sample_{i}.wav"
        assert (tmp_path / "port" / wav).read_bytes() == (tmp_path / "jax" / wav).read_bytes()


def test_mds_tool_converts_as_jax(tmp_path):
    from ultravox_torch.tools.mds_tool import convert_to_mds as tconvert
    from ultravox_tpu.tools.mds_tool import convert_to_mds as jconvert

    rng = np.random.default_rng(1)
    rows = [{"audio": {"array": rng.standard_normal(4000).astype(np.float32),
                       "sampling_rate": 16000},
             "text": f"row {i}", "id": i, "flag": bool(i % 2), "extra": [i, i]}
            for i in range(3)]
    tout = tconvert(rows, str(tmp_path / "port"))
    jout = jconvert(rows, str(tmp_path / "jax"))
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    for name in os.listdir(jout):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    ds = tmds.LocalMDSDataset(tout)
    assert len(ds) == 3 and ds[1]["text"] == "row 1" and isinstance(ds[1]["audio"], bytes)
    with pytest.raises(ImportError, match="mosaicml-streaming"):
        tconvert(rows, "gs://bucket/out")
