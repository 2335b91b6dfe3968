"""The port's tokenizer loader (``ultravox_torch.models.tokenizer``) against
``transformers.PreTrainedTokenizerFast`` on the same tokenizer saved with
``save_pretrained``: ids, decoded text and chat-template strings must be
equal (exact string and id equality, no tolerance)."""

import json

import numpy as np
import pytest

from tests.helpers import CHAT_TEMPLATE, make_tiny_tokenizer
from ultravox_torch.models import tokenizer as ttok

# a llama-3-style template: bos_token, a system default, raise_exception on
# roles it does not know, and the header tokens around each role
LLAMA3_TEMPLATE = (
    "{{ bos_token }}"
    "{% if messages[0]['role'] == 'system' %}"
    "{% set loop_messages = messages[1:] %}{% set system = messages[0]['content'] %}"
    "{% else %}{% set loop_messages = messages %}{% set system = 'You are helpful.' %}{% endif %}"
    "<|start|>system\n\n{{ system | trim }}<|eot_id|>"
    "{% for message in loop_messages %}"
    "{% if message['role'] not in ['user', 'assistant'] %}"
    "{{ raise_exception('Conversation roles must be user or assistant') }}"
    "{% endif %}"
    "<|start|>{{ message['role'] }}\n\n{{ message['content'] | trim }}<|eot_id|>"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|start|>assistant\n\n{% endif %}"
)

TEXTS = [
    "hello world how are you today",
    "the quick brown fox, über naïve café — 日本語 ✓",
    "<|begin_of_text|>transcribe <|eot_id|> the <|start|>audio",
    "listen <|audio|> and transcribe",
    "",
    "  leading and trailing spaces  ",
    "spaces before punctuation , here . it 's done ?",
]

CONVERSATIONS = [
    [{"role": "user", "content": "hello world"}],
    [{"role": "system", "content": "be brief"}, {"role": "user", "content": "how are you"},
     {"role": "assistant", "content": "fine"}, {"role": "user", "content": "<|audio|> again"}],
    [{"role": "user", "content": "über {{ not a tag }} 'quoted'"},
     {"role": "assistant", "content": "  spaced  "}],
]


@pytest.fixture(scope="module", params=["tiny", "llama3"])
def pair(request, tmp_path_factory):
    """(transformers tokenizer, port tokenizer) loaded from one directory."""
    from transformers import PreTrainedTokenizerFast

    ref = make_tiny_tokenizer()
    out = tmp_path_factory.mktemp(request.param)
    if request.param == "llama3":
        # a copy with a pad token, an extra special token, the clean-up of
        # spaces before punctuation that llama-3 checkpoints set, and a
        # template that uses bos_token and raise_exception
        ref = PreTrainedTokenizerFast(
            tokenizer_object=ref.backend_tokenizer.__class__.from_str(
                ref.backend_tokenizer.to_str()),
            bos_token="<|begin_of_text|>", eos_token="<|eot_id|>", pad_token="<|start|>",
            additional_special_tokens=["<|reserved_0|>"], clean_up_tokenization_spaces=True,
        )
        ref.chat_template = LLAMA3_TEMPLATE
    ref.save_pretrained(out)
    hf = PreTrainedTokenizerFast.from_pretrained(out)
    return hf, ttok.load_tokenizer(str(out))


@pytest.mark.parametrize("add_special", [True, False])
def test_ids_equal(pair, add_special):
    hf, port = pair
    for text in TEXTS:
        assert port(text, add_special_tokens=add_special)["input_ids"] == hf(
            text, add_special_tokens=add_special)["input_ids"]
        assert port.encode(text, add_special_tokens=add_special) == hf.encode(
            text, add_special_tokens=add_special)
    # the processor's batch call: one list of ids per text
    parts = "a <|audio|> b".split("<|audio|>")
    assert port(parts, add_special_tokens=False)["input_ids"] == hf(
        parts, add_special_tokens=False)["input_ids"]


@pytest.mark.parametrize("skip", [True, False])
def test_decode_equal(pair, skip):
    hf, port = pair
    rng = np.random.default_rng(0)
    for text in TEXTS:
        ids = hf(text, add_special_tokens=True)["input_ids"]
        assert port.decode(ids, skip_special_tokens=skip) == hf.decode(ids, skip_special_tokens=skip)
    seqs = [rng.integers(0, len(hf), 12).tolist() for _ in range(4)]
    assert port.batch_decode(seqs, skip_special_tokens=skip) == hf.batch_decode(
        seqs, skip_special_tokens=skip)
    arr = np.asarray(seqs[0], np.int64)
    assert port.decode(arr, skip_special_tokens=skip) == hf.decode(arr, skip_special_tokens=skip)


def test_special_tokens_and_vocab(pair):
    hf, port = pair
    for name in ("bos_token", "eos_token", "pad_token", "unk_token"):
        assert getattr(port, name) == getattr(hf, name), name
        assert getattr(port, name + "_id") == getattr(hf, name + "_id"), name
    assert port.get_vocab() == hf.get_vocab()
    assert len(port) == len(hf)
    assert port.padding_side == hf.padding_side
    assert port.convert_tokens_to_ids("<|eot_id|>") == hf.convert_tokens_to_ids("<|eot_id|>")
    assert port.convert_tokens_to_ids(["<|start|>", "<|eot_id|>"]) == hf.convert_tokens_to_ids(
        ["<|start|>", "<|eot_id|>"])
    assert port.convert_tokens_to_ids("no-such-token") == hf.convert_tokens_to_ids("no-such-token")
    assert port.special_tokens_map == hf.special_tokens_map
    # the pad fallback both JAX call sites use
    if port.pad_token_id is None:
        port.pad_token = port.eos_token
        hf.pad_token = hf.eos_token
        assert port.pad_token_id == hf.pad_token_id == hf.eos_token_id


@pytest.mark.parametrize("gen", [True, False])
def test_chat_template_equal(pair, gen):
    hf, port = pair
    for conv in CONVERSATIONS:
        want = hf.apply_chat_template(conv, tokenize=False, add_generation_prompt=gen)
        assert port.apply_chat_template(conv, tokenize=False, add_generation_prompt=gen) == want
        assert port.apply_chat_template(conv, add_generation_prompt=gen) == hf.apply_chat_template(
            conv, add_generation_prompt=gen)


def test_chat_template_raise_exception_and_setter(pair):
    import jinja2

    hf, port = pair
    bad = [{"role": "tool", "content": "x"}]
    if port.chat_template == LLAMA3_TEMPLATE:
        with pytest.raises(jinja2.exceptions.TemplateError, match="roles"):
            port.apply_chat_template(bad, tokenize=False)
        with pytest.raises(jinja2.exceptions.TemplateError, match="roles"):
            hf.apply_chat_template(bad, tokenize=False)
    # a settable template, as LocalInference(chat_template=...) sets it
    saved = port.chat_template
    try:
        port.chat_template = "{% for m in messages %}[{{ m.content | tojson }}]{% endfor %}"
        hf_t = "{% for m in messages %}[{{ m.content | tojson }}]{% endfor %}"
        conv = [{"role": "user", "content": "<b>&'\"ü"}]
        assert port.apply_chat_template(conv, tokenize=False) == hf.apply_chat_template(
            conv, tokenize=False, chat_template=hf_t)
    finally:
        port.chat_template = saved


def test_add_audio_token_matches_transformers(pair):
    hf, port = pair
    a = ttok.add_audio_token(port)
    b = ttok.add_audio_token(hf)
    assert a == b == port.convert_tokens_to_ids(ttok.AUDIO_TOKEN)
    assert ttok.get_audio_token_id(port) == a
    text = "say <|audio|> now"
    assert port(text)["input_ids"] == hf(text)["input_ids"]
    assert port.decode(port(text)["input_ids"], skip_special_tokens=True) == hf.decode(
        hf(text)["input_ids"], skip_special_tokens=True)


def test_named_templates_and_added_tokens_from_config(tmp_path):
    """chat_template as a list of named templates, special tokens given as
    AddedToken dicts and an added token only the config declares."""
    from transformers import PreTrainedTokenizerFast

    make_tiny_tokenizer().save_pretrained(tmp_path)
    (tmp_path / "chat_template.jinja").unlink()
    cfg_path = tmp_path / "tokenizer_config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["chat_template"] = [
        {"name": "default", "template": CHAT_TEMPLATE},
        {"name": "tool_use", "template": "{{ tools | tojson }}{{ messages[0].content }}"},
    ]
    cfg["eos_token"] = {"__type": "AddedToken", "content": "<|eot_id|>", "lstrip": False,
                        "normalized": False,
                        "rstrip": False, "single_word": False, "special": True}
    n = len(make_tiny_tokenizer())
    cfg["added_tokens_decoder"][str(n)] = {
        "content": "<|extra|>", "lstrip": False, "normalized": False, "rstrip": False,
        "single_word": False, "special": True}
    cfg_path.write_text(json.dumps(cfg))
    hf = PreTrainedTokenizerFast.from_pretrained(tmp_path)
    port = ttok.load_tokenizer(str(tmp_path))
    conv = [{"role": "user", "content": "hi"}]
    assert port.apply_chat_template(conv, tokenize=False) == hf.apply_chat_template(
        conv, tokenize=False)
    tools = [{"type": "function", "function": {"name": "f"}}]
    assert port.apply_chat_template(conv, tools=tools, tokenize=False) == hf.apply_chat_template(
        conv, tools=tools, tokenize=False)
    assert port.eos_token == hf.eos_token and port.eos_token_id == hf.eos_token_id
    assert port.convert_tokens_to_ids("<|extra|>") == hf.convert_tokens_to_ids("<|extra|>") == n
    assert port("a <|extra|> b")["input_ids"] == hf("a <|extra|> b")["input_ids"]


def test_save_pretrained_round_trip(pair, tmp_path):
    """The port's save_pretrained writes a directory both loaders read back
    to the same tokenizer."""
    from transformers import PreTrainedTokenizerFast

    _, port = pair
    port.save_pretrained(str(tmp_path))
    again = ttok.load_tokenizer(str(tmp_path))
    hf = PreTrainedTokenizerFast.from_pretrained(tmp_path)
    for text in TEXTS:
        assert again(text)["input_ids"] == port(text)["input_ids"] == hf(text)["input_ids"]
    conv = CONVERSATIONS[1]
    assert again.apply_chat_template(conv, tokenize=False) == hf.apply_chat_template(
        conv, tokenize=False)
    assert again.eos_token_id == hf.eos_token_id and again.bos_token == hf.bos_token


def test_missing_tokenizer_json_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        ttok.load_tokenizer(str(tmp_path))


def test_chip_smoke_flagship_tokenizer_matches_transformers(tmp_path):
    """chip_smoke.py's tokenizer over the flagship's 128256 ids (byte-level,
    every id decodes, a llama-3-style template): the loader and
    transformers agree on it."""
    import importlib.util
    from pathlib import Path

    from transformers import PreTrainedTokenizerFast

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke._write_flagship_tokenizer(str(tmp_path))
    port = ttok.load_tokenizer(str(tmp_path))
    hf = PreTrainedTokenizerFast.from_pretrained(tmp_path)
    assert len(port) == len(hf) == 128256
    assert port.eos_token_id == hf.eos_token_id == 128009
    assert port.bos_token_id == hf.bos_token_id == 128000
    for conv in CONVERSATIONS:
        text = port.apply_chat_template(conv, tokenize=False, add_generation_prompt=True)
        assert text == hf.apply_chat_template(conv, tokenize=False, add_generation_prompt=True)
        assert port(text, add_special_tokens=False)["input_ids"] == hf(
            text, add_special_tokens=False)["input_ids"]
    ids = np.random.default_rng(7).integers(0, 128256, 64).tolist()
    for skip in (True, False):
        assert port.decode(ids, skip_special_tokens=skip) == hf.decode(ids, skip_special_tokens=skip)
    assert port.decode([300, 127999]) == "t300t127999"
