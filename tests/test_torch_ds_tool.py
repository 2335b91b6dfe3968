"""The port's dataset factory (``tools/ds_tool/``), ``tools/update_hf_models.py``
and ``training/prefetch_weights.py`` against the JAX package's, on the CPU.

- ``DiskCache`` and ``CachingChatWrapper``: a cache written by either
  package is read by the other (the same sha256 keys of the same JSON).
- Each of the nine tasks of ``TASKS`` on the same HF split, with the same
  fake chat / TTS / ASR clients and the fake aligner of
  tests/test_tools.py: the same rows (and the same requests). AudioMix
  with pool audio at 16 kHz is bit-equal to JAX; at 32 and 24 kHz it is
  held against the JAX task on its scipy path (``_USE_NATIVE`` off): the
  JAX package's C++ ``resample_poly`` differs from scipy at 32 kHz too and
  doubles the RMS at 24 kHz (ROADMAP.md queue C, "found in the reference":
  its C++ ``resample_poly``).
- ``DatasetChunkProcessor``: the same chunk directories and contents, the
  subdivision of a failing chunk, the record of finished chunks.
- ``main()`` with ``datasets.load_dataset`` patched to a local split.
- The TTS clients: the same URL, headers and body, the same arrays.
- ``update_hf_models`` against the mocked ``HfApi`` of
  tests/test_hub_code.py: the same repos, operations (``path_in_repo`` and
  bytes), config bytes and dry run.
- ``prefetch_weights`` with ``snapshot_download`` stubbed.
"""

import hashlib
import json
import os
import sys
import types
from unittest import mock

import datasets as hf_datasets
import numpy as np
import pytest

from tests.test_hub_code import _FakeApi
from ultravox_torch.tools import update_hf_models as tupd
from ultravox_torch.tools.ds_tool import caching as tcache
from ultravox_torch.tools.ds_tool import ds_tool as tds
from ultravox_torch.tools.ds_tool import tts as ttts
from ultravox_torch.training import prefetch_weights as tpre
from ultravox_tpu.tools import update_hf_models as jupd
from ultravox_tpu.tools.ds_tool import caching as jcache
from ultravox_tpu.tools.ds_tool import ds_tool as jds
from ultravox_tpu.tools.ds_tool import tts as jtts
from ultravox_tpu.training import prefetch_weights as jpre
from ultravox_tpu.utils import audio as jaudio

SR = 16000


def _rows(ds):
    """A split as plain rows, arrays as lists (comparable with ==)."""
    def plain(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, list):
            return [plain(x) for x in v]
        return v

    return [plain(r) for r in (ds.to_list() if hasattr(ds, "to_list") else ds)]


# ---------------------------------------------------------------------------
# the disk cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer, reader", [(jcache, tcache), (tcache, jcache)],
                         ids=["jax_writes", "port_writes"])
def test_disk_cache_is_shared(tmp_path, writer, reader):
    payload = {"chat": {"model": "m", "messages": [{"role": "user", "content": "hé"}],
                        "max_tokens": 8}, "n": 1.5}
    value = {"text": "gen", "ids": [1, 2]}
    assert writer.DiskCache(str(tmp_path)).get_or_compute(payload, lambda: value) == value
    assert writer.DiskCache(str(tmp_path)).get_or_compute_bytes(payload, lambda: b"\x00raw") \
        == b"\x00raw"

    def never():
        raise AssertionError("recomputed")

    cache = reader.DiskCache(str(tmp_path))
    assert cache.get_or_compute(payload, never) == value
    assert cache.get_or_compute_bytes(payload, never) == b"\x00raw"
    assert sorted(os.listdir(tmp_path)) == sorted(
        reader.DiskCache(str(tmp_path))._path(payload, s).rsplit("/", 1)[1]
        for s in (".json", ".bin"))

    client = FakeChat()
    writer.CachingChatWrapper(client, str(tmp_path / "chat")).chat_completion(
        model="m", messages=[{"role": "user", "content": "x"}], max_tokens=4)
    broken = FakeChat(fail=True)
    assert reader.CachingChatWrapper(broken, str(tmp_path / "chat")).chat_completion(
        model="m", messages=[{"role": "user", "content": "x"}], max_tokens=4) \
        == client.replies[0]
    assert broken.sent == []


# ---------------------------------------------------------------------------
# fake clients
# ---------------------------------------------------------------------------


class FakeChat:
    """An OpenAI-compatible client whose reply is a function of the request;
    some replies are in the voice_ds_gen "Q: ... A: ..." form."""

    def __init__(self, fail=False):
        self.sent, self.replies, self.fail = [], [], fail
        self.chat = types.SimpleNamespace(completions=types.SimpleNamespace(create=self.create))

    def create(self, **kw):
        self.sent.append(kw)
        if self.fail:
            raise RuntimeError("no endpoint")
        h = hashlib.sha256(json.dumps(kw, sort_keys=True).encode()).hexdigest()
        text = f"Q: what is {h[:4]}?\nA: it is {h[4:9]}" if int(h, 16) % 3 else f"gen {h[:6]}"
        self.replies.append(text)
        message = types.SimpleNamespace(content=text)
        return types.SimpleNamespace(choices=[types.SimpleNamespace(message=message)])


class FakeTts:
    def synthesize(self, text, voice):
        seed = int(hashlib.sha256(f"{text}|{voice}".encode()).hexdigest()[:8], 16)
        n = 100 + seed % 400
        return np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 0.1, 22050


class FakeAsr:
    def transcribe(self, audio, sample_rate):
        return f"{len(audio)} samples at {sample_rate}: {float(np.sum(audio)):.4f}"


def _text_split(seed: int, n: int = 7):
    rng = np.random.default_rng(seed)
    words = ["one", "Two", "three", "two", "ONE", "four  five", "{{ x }}"]
    return {"text": [" ".join(rng.choice(words, size=1 + i % 3)) for i in range(n)],
            "id": list(range(n))}


def _audio_split(seed: int, seconds=(0.5, 1.25, 2.5, 0.05), sr: int = SR):
    rng = np.random.default_rng(seed)
    return {"audio": [{"array": (rng.standard_normal(int(s * sr)) * 0.2).astype(np.float32),
                       "sampling_rate": sr} for s in seconds],
            "text": [f"utterance {i}" for i in range(len(seconds))]}


# ---------------------------------------------------------------------------
# the nine tasks
# ---------------------------------------------------------------------------

TEXTGRID = '''File type = "ooTextFile"
Object class = "TextGrid"
xmin = 0
xmax = 1.0
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 1.0
        intervals: size = 3
        intervals [1]:
            xmin = 0.0
            xmax = 0.25
            text = "hello"
        intervals [2]:
            xmin = 0.25
            xmax = 0.5
            text = ""
        intervals [3]:
            xmin = 0.5
            xmax = 0.9
            text = "world"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 1.0
        intervals: size = 1
        intervals [1]:
            xmin = 0.0
            xmax = 1.0
            text = "HH"
'''


def _fake_aligner(seen):
    """tests/test_tools.py's aligner: a TextGrid for every utterance but the
    last; records the corpus it was given (file names, WAV and text bytes)."""

    def align(corpus_dir, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        files = sorted(os.listdir(corpus_dir))
        corpus = {}
        for name in files:
            with open(os.path.join(corpus_dir, name), "rb") as f:
                corpus[name] = f.read()
        seen.append(corpus)
        wavs = [f for f in files if f.endswith(".wav")]
        for w in wavs[:-1]:
            with open(os.path.join(out_dir, w[:-4] + ".TextGrid"), "w") as f:
                f.write(TEXTGRID)

    return align


def _task(mod, name, tmp, **kw):
    """(task, input split) of TASKS[name] in package ``mod``."""
    cls = mod.TASKS[name]
    if name == "textgen":
        return cls(client=FakeChat(), new_column_name="out", max_tokens=16,
                   cache_dir=str(tmp / "chat"), **kw), _text_split(0)
    if name == "voice_ds_gen":
        return cls(client=FakeChat(), cache_dir=str(tmp / "chat"), **kw), _text_split(1)
    if name == "tts":
        return cls(client=FakeTts(), column_name="text", voice="v1", **kw), _text_split(2)
    if name == "augment":
        return cls(**kw), _audio_split(3)
    if name == "dedup":
        return cls(column_name="text"), _text_split(4, n=12)
    if name == "asr":
        return cls(client=FakeAsr()), _audio_split(5)
    if name == "audiosplit":
        return cls(window_secs=0.5, min_window_secs=0.2), _audio_split(6)
    if name == "audiomix":
        pool_sr = kw.pop("pool_sr", SR)
        rng = np.random.default_rng(7)
        pool = [{"audio": {"array": (rng.standard_normal(int(pool_sr * s)) * 0.3).astype(
            np.float32), "sampling_rate": pool_sr}} for s in (0.4, 1.1, 0.7)]
        return cls(mix_rows=pool, max_length=2.0, seed=11, **kw), _audio_split(
            8, seconds=(0.5, 1.25, 2.5, 1.0, 0.05))
    if name == "timestamp":
        seen = []
        return cls(template="{{ text }} !", aligner=_fake_aligner(seen), aligned_ratio_check=0.5,
                   **kw), _audio_split(9, seconds=(0.5, 0.25, 1.0))
    raise KeyError(name)


def _run(mod, name, tmp, **kw):
    task, split = _task(mod, name, tmp, **kw)
    out = task.map_split(hf_datasets.Dataset.from_dict(split))
    sent = getattr(task.client, "sent", None) if hasattr(task, "client") else None
    aligned = task.aligner.__closure__[0].cell_contents if name == "timestamp" else None
    return _rows(out), sent, aligned


def test_tasks_match_jax_list():
    assert sorted(tds.TASKS) == sorted(jds.TASKS) == sorted(
        ["textgen", "tts", "augment", "dedup", "asr", "audiosplit", "voice_ds_gen", "audiomix",
         "timestamp"])
    for name in tds.TASKS:
        tf = [(f.name, f.default) for f in tds.TASKS[name].__dataclass_fields__.values()]
        jf = [(f.name, f.default) for f in jds.TASKS[name].__dataclass_fields__.values()]
        assert tf == jf, name


@pytest.mark.parametrize("name", ["textgen", "voice_ds_gen", "tts", "dedup", "asr",
                                  "audiosplit", "timestamp"])
def test_task_matches_jax(tmp_path, name):
    got = _run(tds, name, tmp_path / "port")
    want = _run(jds, name, tmp_path / "jax")
    assert got == want
    rows, sent, aligned = got
    assert rows
    if name in ("textgen", "voice_ds_gen"):
        assert len(sent) == len(rows)
    if name == "timestamp":
        assert [r["timestamps"] for r in rows] == [
            [{"start": 0.0, "end": 0.25, "text": "hello"},
             {"start": 0.5, "end": 0.9, "text": "world"}]] * 2 + [None]
        assert sorted(aligned[0]) == [f"utt{i:06d}.{e}" for i in range(3) for e in ("txt", "wav")]


class ListSplit:
    """Rows in a list with ``map``: the JAX task sees the numpy arrays an
    HF ``Audio`` column decodes to."""

    def __init__(self, split):
        self.rows = [dict(zip(split, vals)) for vals in zip(*split.values())]

    def map(self, fn):
        return [fn(dict(r)) for r in self.rows]


@pytest.mark.parametrize("augmentation", ["telephony", "white_noise", "gain", "mulaw"])
def test_augment_task_matches_jax(tmp_path, monkeypatch, augmentation):
    """The port's task on an HF split (lists) against the JAX task on the
    same rows as float32 arrays; both through their own registries."""
    monkeypatch.setattr(jaudio, "_USE_NATIVE", False)  # scipy, as the port
    got = _run(tds, "augment", tmp_path, augmentation=augmentation)
    task, split = _task(jds, "augment", tmp_path, augmentation=augmentation)
    want = _rows(task.map_split(ListSplit(split)))
    assert got[0] == want
    assert got[0][0]["audio"]["array"] != _rows(hf_datasets.Dataset.from_dict(
        _audio_split(3)))[0]["audio"]["array"]


@pytest.mark.parametrize("augmentation", ["white_noise", "gain"])
def test_jax_augment_task_cannot_take_an_hf_list_column(tmp_path, augmentation):
    """ROADMAP.md queue C: the JAX task hands an HF split's list to the
    augmentation, whose arithmetic needs an array; the port converts it."""
    task, split = _task(jds, "augment", tmp_path, augmentation=augmentation)
    with pytest.raises(TypeError):
        task.map_split(hf_datasets.Dataset.from_dict(split))


@pytest.mark.parametrize("pool_sr", [16000, 32000, 24000])
def test_audiomix_task_matches_jax(tmp_path, monkeypatch, pool_sr):
    """Bit-equal mixes with random.Random(seed) drawn in JAX's order. A
    16 kHz pool needs no resampling. At 32 and 24 kHz the JAX task runs its
    scipy path: its C++ resample_poly is another filter (ROADMAP.md queue C,
    "found in the reference"; at 24 kHz it doubles the RMS), checked here
    to still differ."""
    if pool_sr != SR:
        monkeypatch.setattr(jaudio, "_USE_NATIVE", False)
    got = _run(tds, "audiomix", tmp_path, pool_sr=pool_sr)
    want = _run(jds, "audiomix", tmp_path, pool_sr=pool_sr)
    assert got == want
    rows = got[0]
    assert len(rows) == 4  # the 2.5 s row is over max_length
    for r in rows:
        assert len(r["audio"]["array"]) <= 2 * SR + 2 and max(map(abs, r["audio"]["array"])) <= 1
    if pool_sr != SR:
        monkeypatch.setattr(jaudio, "_USE_NATIVE", None)
        if jaudio._native_dsp() is not None:
            assert _run(jds, "audiomix", tmp_path, pool_sr=pool_sr)[0] != rows


def test_textgen_requests_match_jax(tmp_path):
    """The same requests reach the client, and a second run with the same
    cache sends none."""
    _, sent, _ = _run(tds, "textgen", tmp_path)
    _, jsent, _ = _run(jds, "textgen", tmp_path / "j")
    assert sent == jsent and {kw["model"] for kw in sent} == {"gpt-4o-mini"}
    task, split = _task(tds, "textgen", tmp_path)
    rows = _rows(task.map_split(hf_datasets.Dataset.from_dict(split)))
    assert task.client.sent == [] and len(rows) == len(split["text"])


def test_timestamp_task_needs_mfa(monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: None)
    for mod in (tds, jds):
        with pytest.raises(RuntimeError, match="mfa"):
            mod.TimestampTask()


# ---------------------------------------------------------------------------
# chunked processing and main()
# ---------------------------------------------------------------------------


def _saved(paths, root):
    return [(os.path.relpath(p, root), _rows(hf_datasets.load_from_disk(p))) for p in paths]


@pytest.mark.parametrize("n, chunk", [(5, 2), (6, 4), (3, 10)])
def test_chunk_processor_matches_jax(tmp_path, n, chunk):
    out = {}
    for label, mod in (("port", tds), ("jax", jds)):
        task = mod.TextGenerationTask(client=FakeChat(), cache_dir=str(tmp_path / label / "c"))
        proc = mod.DatasetChunkProcessor(task=task, output_dir=str(tmp_path / label / "out"),
                                         chunk_size=chunk)
        ds = hf_datasets.Dataset.from_dict(_text_split(n, n))
        out[label] = _saved(proc.process_split(ds, "train"), tmp_path / label / "out")
        assert len(out[label]) == -(-n // chunk)
        # finished chunks are on disk: a second pass calls nothing
        task.client = FakeChat(fail=True)
        again = proc.process_split(ds, "train")
        assert _saved(again, tmp_path / label / "out") == out[label]
    assert out["port"] == out["jax"]


class FlakyTask:
    """Fails any chunk larger than ``limit`` rows, or one holding ``poison``."""

    def __init__(self, limit, poison=None):
        self.limit, self.poison, self.calls = limit, poison, []

    def map_split(self, dataset, num_proc=1):
        self.calls.append(len(dataset))
        if len(dataset) > self.limit or self.poison in dataset["x"]:
            raise RuntimeError("too big")
        return dataset


@pytest.mark.parametrize("limit, poison, min_chunk", [(2, None, 1), (3, None, 1), (8, 5, 1),
                                                      (8, 5, 2), (1, None, 3)])
def test_chunk_subdivision_matches_jax(tmp_path, limit, poison, min_chunk):
    got = {}
    for label, mod in (("port", tds), ("jax", jds)):
        task = FlakyTask(limit, poison)
        proc = mod.DatasetChunkProcessor(task=task, output_dir=str(tmp_path / label),
                                         chunk_size=8, min_chunk_size=min_chunk)
        saved = proc.process_split(hf_datasets.Dataset.from_dict({"x": list(range(8))}))
        got[label] = (_saved(saved, tmp_path / label), task.calls)
    assert got["port"] == got["jax"]
    if (limit, poison) == (2, None):
        assert [p for p, _ in got["port"][0]] == [
            f"train-{a:08d}-{a + 2:08d}" for a in range(0, 8, 2)]  # 8 -> 4, 4 -> 2, 2, 2, 2
    if poison is not None and min_chunk == 1:
        assert [r["x"] for _, rows in got["port"][0] for r in rows] == [0, 1, 2, 3, 4, 6, 7]


@pytest.mark.parametrize("task, task_args", [("dedup", "{column_name: text}"),
                                             ("textgen", "{max_tokens: 8, cache_dir: CACHE}")])
def test_main_matches_jax(tmp_path, monkeypatch, task, task_args):
    """``main()`` on a local split (``datasets.load_dataset`` patched), the
    textgen client from a fake ``openai`` module."""
    local = hf_datasets.Dataset.from_dict(_text_split(12, 9))
    loads = []

    def load_dataset(path, subset=None, split=None):
        loads.append((path, subset, split))
        return local

    monkeypatch.setattr(hf_datasets, "load_dataset", load_dataset)
    clients = []

    def OpenAI():
        clients.append(FakeChat())
        return clients[-1]

    monkeypatch.setitem(sys.modules, "openai", types.SimpleNamespace(OpenAI=OpenAI))
    out, printed = {}, []
    monkeypatch.setattr("builtins.print", lambda *a: printed.append(" ".join(map(str, a))))
    for label, mod in (("port", tds), ("jax", jds)):
        out_dir = tmp_path / label
        args = task_args.replace("CACHE", str(tmp_path / label / "cache"))
        monkeypatch.setattr(sys, "argv", ["ds_tool", task, "--dataset", "acme/set", "--split",
                                          "validation", "--output_dir", str(out_dir),
                                          "--chunk_size", "4", "--task_args", args])
        mod.main()
        saved = sorted(d for d in os.listdir(out_dir) if d.startswith("validation-"))
        out[label] = _saved([str(out_dir / d) for d in saved], out_dir)
    assert out["port"] == out["jax"] and len(out["port"]) == 3
    assert loads == [("acme/set", None, "validation")] * 2
    assert printed == [f"saved 3 chunks to {tmp_path / label}" for label in ("port", "jax")]
    if task == "textgen":
        assert len(clients) == 2 and clients[0].sent == clients[1].sent
        assert len(clients[0].sent) == 9


# ---------------------------------------------------------------------------
# TTS clients
# ---------------------------------------------------------------------------


class FakeSession:
    def __init__(self, pcm: bytes):
        self.pcm, self.posts = pcm, []

    def post(self, url, **kw):
        self.posts.append((url, kw))
        return types.SimpleNamespace(content=self.pcm, raise_for_status=lambda: None)


def _synth(mod, monkeypatch, impl, rate, text, voice, **kw):
    pcm = (np.random.default_rng(rate).integers(-32768, 32767, 64)).astype("<i2").tobytes()
    session = FakeSession(pcm)
    monkeypatch.setattr(os, "getpid", lambda: 4242)
    np.random.seed(5)
    client = mod.create_client(impl, sample_rate=rate, session=session, **kw)
    wav, sr = client.synthesize(text, voice)
    return wav.tolist(), sr, wav.dtype.name, session.posts


@pytest.mark.parametrize("impl, rate, text, voice, kw", [
    ("azure", 16000, "hello <world> & 'you'", None, {}),
    ("azure", 24000, "hi", "random", {"region": "eastus"}),
    ("azure", 8000, "x", "en-US-AvaNeural", {}),
    ("eleven", 16000, "hello", None, {}),
    ("eleven", 24000, "hi there", "random", {}),
    ("eleven", 44100, "é", "AZnzlk1XvdvUeBnXmlld", {}),
])
def test_tts_clients_match_jax(monkeypatch, impl, rate, text, voice, kw):
    monkeypatch.setenv("AZURE_TTS_API_KEY", "k-azure")
    monkeypatch.setenv("ELEVEN_API_KEY", "k-11")
    got = _synth(ttts, monkeypatch, impl, rate, text, voice, **kw)
    want = _synth(jtts, monkeypatch, impl, rate, text, voice, **kw)
    assert got == want
    wav, sr, dtype, posts = got
    assert sr == rate and dtype == "float32" and len(wav) == 64 and len(posts) == 1


def test_tts_clients_refuse_alike(monkeypatch):
    monkeypatch.delenv("AZURE_TTS_API_KEY", raising=False)
    monkeypatch.delenv("AZURE_WESTUS_TTS_API_KEY", raising=False)
    monkeypatch.delenv("ELEVEN_API_KEY", raising=False)
    for mod in (ttts, jtts):
        session = FakeSession(b"")
        with pytest.raises(RuntimeError, match="AZURE_TTS_API_KEY"):
            mod.AzureTts(session=session).synthesize("x")
        with pytest.raises(RuntimeError, match="ELEVEN_API_KEY"):
            mod.ElevenTts(session=session).synthesize("x")
        monkeypatch.setenv("ELEVEN_API_KEY", "k")
        with pytest.raises(ValueError, match="unsupported rate"):
            mod.ElevenTts(sample_rate=8000, session=session).synthesize("x")
        monkeypatch.delenv("ELEVEN_API_KEY")
        with pytest.raises(ValueError, match="unknown TTS implementation"):
            mod.create_client("nope")
        assert session.posts == []
    assert ttts.AzureTts.ALL_VOICES == jtts.AzureTts.ALL_VOICES
    assert ttts.ElevenTts.ALL_VOICES == jtts.ElevenTts.ALL_VOICES


def test_tts_session_is_made_at_first_use(monkeypatch):
    """The port makes its ``requests`` session at the first request, so a
    client (and ``TtsTask(client="azure")``) is built without ``requests``."""
    monkeypatch.setitem(sys.modules, "requests", None)
    task = tds.TtsTask(client="azure", column_name="text")
    assert isinstance(task.client, ttts.AzureTts) and task.client._session is None
    session = FakeSession(np.zeros(4, "<i2").tobytes())
    task.client._session = session
    monkeypatch.setenv("AZURE_TTS_API_KEY", "k")
    rows = _rows(task.map_split(hf_datasets.Dataset.from_dict({"text": ["a", "b"]})))
    assert [r["question_audio"]["sampling_rate"] for r in rows] == [16000] * 2
    assert len(session.posts) == 2


# ---------------------------------------------------------------------------
# update_hf_models and prefetch_weights
# ---------------------------------------------------------------------------


class RecordingApi(_FakeApi):
    def __init__(self, tmpdir):
        super().__init__(tmpdir)
        self.calls = []

    def list_models(self, **kw):
        self.calls.append(("list_models", kw))
        return super().list_models(**kw)

    def hf_hub_download(self, repo_id, filename, local_dir):
        self.calls.append(("hf_hub_download", repo_id, filename))
        return super().hf_hub_download(repo_id, filename, local_dir)


def _op_bytes(op):
    src = op.path_or_fileobj
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            return f.read()
    return src


def _sync(mod, tmp_path, argv):
    api = RecordingApi(str(tmp_path))
    repos = mod.main(argv, api=api)
    commits = [(repo, [(op.path_in_repo, _op_bytes(op)) for op in ops], msg)
               for repo, ops, msg in api.commits]
    return repos, commits, api.calls


@pytest.mark.parametrize("argv", [
    ["--author", "acme"],
    ["--author", "acme", "--include_private", "--commit_message", "sync"],
    ["--repos", "acme/one", "acme/two", "--config_changes", "torch_dtype=bfloat16",
     "stack_factor=4", "note=a=b", "flag=true"],
    ["--query", "ultravox-v0_6", "--dry_run"],
])
def test_update_hf_models_matches_jax(tmp_path, argv):
    got = _sync(tupd, tmp_path / "port", argv)
    want = _sync(jupd, tmp_path / "jax", argv)
    assert got == want
    repos, commits, _ = got
    if "--dry_run" in argv:
        assert commits == [] and repos
        return
    assert len(commits) == len(repos)
    paths = [p for p, _ in commits[0][1]]
    assert paths == list(tupd.hub.HUB_CODE_FILES) + ["config.json"]
    config = json.loads(commits[0][1][-1][1])
    assert config["auto_map"] == tupd.hub.AUTO_MAP


def test_sync_repo_dry_run_matches_jax(tmp_path):
    for mod in (tupd, jupd):
        api = RecordingApi(str(tmp_path))
        touched = mod.sync_repo(api, "acme/x", config_changes=["a=1"], dry_run=True)
        assert touched == list(tupd.hub.HUB_CODE_FILES) + ["config.json"]
        assert api.commits == []
    assert tupd.discover_repos(RecordingApi(str(tmp_path)), author="acme") == \
        jupd.discover_repos(RecordingApi(str(tmp_path)), author="acme")


def _prefetch(mod, monkeypatch, models, fail_first):
    import huggingface_hub

    calls, sleeps = [], []
    failures = dict(fail_first)

    def snapshot_download(model_id, cache_dir=None):
        calls.append((model_id, cache_dir))
        if failures.get(model_id, 0):
            failures[model_id] -= 1
            raise ConnectionError(f"{model_id} unreachable")
        return f"{cache_dir}/snap/{model_id.replace('/', '--')}"

    monkeypatch.setattr(huggingface_hub, "snapshot_download", snapshot_download)
    monkeypatch.setattr("time.sleep", sleeps.append)
    paths = mod.download_weights(models, cache_dir="/cache")
    return paths, sorted(calls), len(sleeps)


def test_prefetch_weights_matches_jax(monkeypatch):
    models = ["acme/a", "/local/ckpt", "", "acme/b", "acme/c", "/other", "acme/d", "acme/e"]
    fails = {"acme/b": 2}
    got = _prefetch(tpre, monkeypatch, models, fails)
    want = _prefetch(jpre, monkeypatch, models, fails)
    assert got == want
    paths, calls, sleeps = got
    assert paths == [f"/cache/snap/acme--{m}" for m in "abcde"]
    assert [c for c, _ in calls].count("acme/b") == 3 and sleeps == 2
    assert not any(m.startswith("/") for m, _ in calls)


def test_prefetch_weights_gives_up_after_five_attempts(monkeypatch):
    for mod in (tpre, jpre):
        with pytest.raises(ConnectionError, match="acme/x unreachable"):
            _prefetch(mod, monkeypatch, ["acme/x"], {"acme/x": 9})


def test_prefetch_weights_cli(monkeypatch, capsys):
    monkeypatch.setattr(tpre, "download_weights", mock.Mock(return_value=["/p/1", "/p/2"]))
    monkeypatch.setattr(sys, "argv", ["prefetch", "--models", "acme/a", "/x", "--cache_dir",
                                      "/c"])
    tpre.main()
    tpre.download_weights.assert_called_once_with(["acme/a", "/x"], "/c")
    assert capsys.readouterr().out.split() == ["/p/1", "/p/2"]
