"""The port's host tokenizers against the JAX package's, on the CPU.

``frido_tpu_torch/text/`` is the port's own copy of ``frido_tpu/text/``;
its CLIP pre-tokenizer uses the standard library's ``re`` where the JAX
package uses the ``regex`` module. Every comparison is exact: the same
int32 ids, shape and dtype, on fixed captions (accents, CJK, ``½``,
``Ⅻ``, punctuation, control characters, over-long captions) and on
``hypothesis`` strings of arbitrary unicode, with the built-in fallback
vocabularies, with vocab files written from them, and with a small BPE
vocab that has merges. Also: the host tokenizers' resolution order (env
var, vendored copy, fallback), strict mode, the vendor round trip and
its CLI.
"""

import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from frido_tpu.nn import encoders as jax_encoders
from frido_tpu.text import ClipBPETokenizer as JaxClip
from frido_tpu.text import WordPieceTokenizer as JaxWordPiece
from frido_tpu.text import clip_bpe as jax_clip_bpe
from frido_tpu.text import wordpiece as jax_wordpiece
from frido_tpu_torch.nn import encoders
from frido_tpu_torch.text import ClipBPETokenizer, WordPieceTokenizer, vendor
from frido_tpu_torch.text.clip_bpe import (bytes_to_unicode, fallback_vocab,
                                           write_vocab_files)
from frido_tpu_torch.text.wordpiece import fallback_vocab as bert_fallback

CAPTIONS = [
    "A man riding a horse on the beach.",
    "Two dogs playing   with a red ball!!",
    "an über-cool café, naïve résumé",            # accents
    "a photo of 猫 and 犬 together",               # CJK isolation
    "½ cup, Ⅻ o'clock, ² and ①",                   # No / Nl numbers
    "Weird\tcontrol\x00chars�here end",  # cleanup path
    "unaffable prewordpieceness",                  # multi-piece + unk
    "don't stop; it's $5.99 (99%) #hashtag",       # punctuation
    "ᾳ ᾼ Ι ι ͅ ΐ İstanbul ǅemal ß",           # case folds
    "x" * 120,                                     # > 100 chars -> [UNK]
    "a b c d e f g h i j k l m n o p q r s t u v w x y z " * 4,  # > 77
    "",                                            # empty caption
    "HTTPS://EXAMPLE.COM/PaTh?q=1&r=2",
]


def _same(port, jax, texts, max_length=77):
    got = port(texts, max_length=max_length)
    want = jax(texts, max_length=max_length)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def bert_files(tmp_path_factory):
    """vocab.txt written from the fallback vocab."""
    v = bert_fallback()
    p = tmp_path_factory.mktemp("bert") / "vocab.txt"
    p.write_text("\n".join(sorted(v, key=v.get)) + "\n", encoding="utf-8")
    return str(p)


@pytest.fixture(scope="module")
def clip_fallback_dir(tmp_path_factory):
    """vocab.json / merges.txt written from the fallback vocab."""
    d = tmp_path_factory.mktemp("clipfb")
    write_vocab_files(str(d), *fallback_vocab())
    return str(d)


@pytest.fixture(scope="module")
def clip_merges_dir(tmp_path_factory):
    """Every byte symbol (+ </w>) and a handful of merges, so the merge
    loop runs."""
    b2u = bytes_to_unicode()
    syms = [b2u[b] for b in range(256)]
    vocab = syms + [s + "</w>" for s in syms]
    merges = ["t h", "th e</w>", "a n", "an d</w>", "d o", "do g</w>",
              "i n", "in g</w>", "r i", "ri d", "rid ing</w>"]
    for m in merges:
        tok = m.replace(" ", "")
        if tok not in vocab:
            vocab.append(tok)
    vocab += ["ing</w>", "<|startoftext|>", "<|endoftext|>"]
    d = tmp_path_factory.mktemp("clipmerges")
    (d / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(vocab)}), encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(merges) + "\n", encoding="utf-8")
    return str(d)


def _clip_pair(d):
    if d is None:
        return ClipBPETokenizer(), JaxClip()
    files = (d + "/vocab.json", d + "/merges.txt")
    return ClipBPETokenizer(*files), JaxClip(*files)


@pytest.fixture(scope="module")
def tokenizer_pairs(bert_files, clip_fallback_dir, clip_merges_dir):
    return {
        "wordpiece-fallback": (WordPieceTokenizer(), JaxWordPiece()),
        "wordpiece-file": (WordPieceTokenizer(bert_files),
                           JaxWordPiece(bert_files)),
        "clip-fallback": _clip_pair(None),
        "clip-fallback-files": _clip_pair(clip_fallback_dir),
        "clip-merges": _clip_pair(clip_merges_dir),
    }


PAIRS = ["wordpiece-fallback", "wordpiece-file", "clip-fallback",
         "clip-fallback-files", "clip-merges"]


def test_fallback_vocabularies_equal_jax():
    assert bert_fallback(30522) == jax_wordpiece.fallback_vocab(30522)
    assert fallback_vocab() == jax_clip_bpe.fallback_vocab()
    assert bytes_to_unicode() == jax_clip_bpe.bytes_to_unicode()


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("max_length", [77, 8])
def test_ids_equal_jax_on_fixed_captions(tokenizer_pairs, pair, max_length):
    port, jax = tokenizer_pairs[pair]
    _same(port, jax, CAPTIONS, max_length)
    for cap in CAPTIONS:               # one caption at a time, as a str
        _same(port, jax, cap, max_length)


def test_clip_files_give_the_fallback_ids(tokenizer_pairs):
    """Files written from the fallback vocab tokenize as the fallback."""
    files, _ = tokenizer_pairs["clip-fallback-files"]
    fb, _ = tokenizer_pairs["clip-fallback"]
    np.testing.assert_array_equal(files(CAPTIONS), fb(CAPTIONS))


@pytest.mark.parametrize("pair", PAIRS)
@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(min_size=0, max_size=40))
def test_ids_equal_jax_on_arbitrary_unicode(tokenizer_pairs, pair, text):
    port, jax = tokenizer_pairs[pair]
    _same(port, jax, [text, text.upper() + " " + text])


def test_pretokenizer_equals_regex_on_every_code_point():
    """The ``re`` pattern against the JAX package's ``regex`` one, on every
    code point that survives the BasicTokenizer's cleanup (categories
    ``C*`` are dropped before either pattern runs), between letters and
    digits and repeated."""
    import sys
    import unicodedata

    port = ClipBPETokenizer().pat
    jax = JaxClip().pat
    for cp in range(sys.maxunicode + 1):
        c = chr(cp)
        if unicodedata.category(c).startswith("C"):
            continue
        s = "a" + c + "1" + c + c + "x" + c
        assert port.findall(s) == jax.findall(s), hex(cp)


@pytest.fixture
def no_vocab(tmp_path, monkeypatch):
    """No env vocab, an empty vendored dir, no HF download."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for var in ("FRIDO_TPU_BERT_VOCAB", "FRIDO_TPU_CLIP_VOCAB",
                "FRIDO_TPU_BERT_TOKENIZER", "FRIDO_TPU_CLIP_TOKENIZER",
                "FRIDO_TPU_STRICT_VOCAB"):
        monkeypatch.delenv(var, raising=False)
    d = tmp_path / "vendored"
    monkeypatch.setattr(vendor, "VENDOR_DIR", str(d))
    monkeypatch.setattr(vendor, "MANIFEST", str(d / "MANIFEST.json"))
    return vendor


def test_hosts_fall_back_with_a_warning(no_vocab):
    with pytest.warns(UserWarning, match="char-fallback"):
        bert = encoders.BERTTokenizerHost()
    np.testing.assert_array_equal(bert(CAPTIONS), JaxWordPiece()(CAPTIONS))
    with pytest.warns(UserWarning, match="byte-level"):
        clip = encoders.CLIPTokenizerHost("openai/clip-vit-large-patch14")
    np.testing.assert_array_equal(clip(CAPTIONS), JaxClip()(CAPTIONS))


@pytest.mark.parametrize("value", ["1", "true"])
def test_strict_mode_refuses_the_fallback(no_vocab, monkeypatch, value):
    monkeypatch.setenv("FRIDO_TPU_STRICT_VOCAB", value)
    with pytest.raises(RuntimeError, match="strict mode"):
        encoders.BERTTokenizerHost()
    with pytest.raises(RuntimeError, match="strict mode"):
        encoders.CLIPTokenizerHost("openai/clip-vit-large-patch14")
    with pytest.raises(RuntimeError, match="strict mode"):
        encoders.FrozenCLIPTextEmbedder(device="meta").tokenize(["a dog"])


def test_strict_mode_passes_with_vocab_files(no_vocab, monkeypatch,
                                             bert_files, clip_fallback_dir):
    """The env vocabularies resolve first; the ids are the JAX hosts'."""
    monkeypatch.setenv("FRIDO_TPU_STRICT_VOCAB", "1")
    monkeypatch.setenv("FRIDO_TPU_BERT_VOCAB", bert_files)
    monkeypatch.setenv("FRIDO_TPU_CLIP_VOCAB", clip_fallback_dir)
    _same(lambda t, max_length: encoders.BERTTokenizerHost(max_length)(t),
          lambda t, max_length: jax_encoders.BERTTokenizerHost(
              max_length)(t), CAPTIONS, 16)
    version = "openai/clip-vit-large-patch14"
    _same(lambda t, max_length: encoders.CLIPTokenizerHost(
              version, max_length)(t),
          lambda t, max_length: jax_encoders.CLIPTokenizerHost(
              version, max_length)(t), CAPTIONS, 77)


def test_named_tokenizer_that_fails_raises(no_vocab, monkeypatch):
    monkeypatch.setenv("FRIDO_TPU_BERT_TOKENIZER", "/no/such/tokenizer")
    with pytest.raises(RuntimeError, match="refusing"):
        encoders.BERTTokenizerHost()
    monkeypatch.setenv("FRIDO_TPU_CLIP_TOKENIZER", "/no/such/tokenizer")
    with pytest.raises(RuntimeError, match="refusing"):
        encoders.CLIPTokenizerHost("openai/clip-vit-large-patch14")


def test_vendor_round_trip(no_vocab, monkeypatch, bert_files,
                           clip_merges_dir, capsys):
    """Vendored files resolve with no env var (and under strict mode); an
    env var still wins; ``--verify`` sees drift; the CLI vendors."""
    vendor = no_vocab
    monkeypatch.setenv("FRIDO_TPU_STRICT_VOCAB", "1")
    assert vendor.verify() == ["nothing vendored yet"]
    p = vendor.vendor_bert(bert_files)
    assert vendor.bert_vocab_path() == p
    v, m = vendor.vendor_clip(clip_merges_dir + "/vocab.json",
                              clip_merges_dir + "/merges.txt")
    assert vendor.clip_vocab_paths() == (v, m)
    assert vendor.verify() == []
    np.testing.assert_array_equal(
        encoders.BERTTokenizerHost()(CAPTIONS),
        JaxWordPiece(bert_files)(CAPTIONS))
    np.testing.assert_array_equal(
        encoders.CLIPTokenizerHost("openai/clip-vit-large-patch14")(CAPTIONS),
        JaxClip(clip_merges_dir + "/vocab.json",
                clip_merges_dir + "/merges.txt")(CAPTIONS))
    monkeypatch.setenv("FRIDO_TPU_BERT_VOCAB", str(p) + ".missing")
    with pytest.raises(FileNotFoundError):
        encoders.BERTTokenizerHost()
    with open(p, "a", encoding="utf-8") as f:
        f.write("extra_token\n")
    assert "drift" in vendor.verify()[0]
    assert vendor.main(["--verify"]) == 1
    assert vendor.main([bert_files]) == 0
    assert vendor.main([clip_merges_dir]) == 0
    assert "vendored CLIP BPE" in capsys.readouterr().out
    assert vendor.main(["--verify"]) == 0


def test_vendor_rejects_what_is_not_a_vocab(no_vocab, tmp_path):
    bad = tmp_path / "words.txt"
    bad.write_text("just\nsome\nwords\n", encoding="utf-8")
    with pytest.raises(ValueError, match="PAD"):
        no_vocab.vendor_bert(str(bad))
    (tmp_path / "v.json").write_text("{}", encoding="utf-8")
    with pytest.raises(ValueError, match="startoftext"):
        no_vocab.vendor_clip(str(tmp_path / "v.json"), str(bad))


def test_embedder_tokenize_equals_jax(no_vocab, monkeypatch, bert_files,
                                      clip_fallback_dir):
    """The config wrappers' ``tokenize``: BERT with and without its
    tokenizer (``cond_key``), the CLIP wrappers on captions and on ids,
    ClassEmbedder from a dict."""
    monkeypatch.setenv("FRIDO_TPU_BERT_VOCAB", bert_files)
    monkeypatch.setenv("FRIDO_TPU_CLIP_VOCAB", clip_fallback_dir)
    pairs = [
        (encoders.BERTEmbedder(32, 1, device="meta"),
         jax_encoders.BERTEmbedder(32, 1), CAPTIONS),
        (encoders.BERTEmbedder(32, 1, use_tokenizer=False,
                               cond_key="objects", device="meta"),
         jax_encoders.BERTEmbedder(32, 1, use_tokenizer=False,
                                   cond_key="objects"),
         {"objects": [[3, 4, 5], [6, 7, 8]]}),
        (encoders.FrozenCLIPEmbedder(device="meta"),
         jax_encoders.FrozenCLIPEmbedder(), CAPTIONS),
        (encoders.FrozenCLIPTextEmbedder(device="meta"),
         jax_encoders.FrozenCLIPTextEmbedder(), CAPTIONS),
        (encoders.FrozenCLIPTextEmbedder(device="meta"),
         jax_encoders.FrozenCLIPTextEmbedder(), [[1, 2, 3]]),
        (encoders.ClassEmbedder(8, device="meta"),
         jax_encoders.ClassEmbedder(8), {"class": [3, 1]}),
    ]
    for port, jax, cond in pairs:
        got, want = port.tokenize(cond), jax.tokenize(cond)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
