"""CLIP byte-level BPE tokenizer, pure Python (port of
``frido_tpu/text/clip_bpe.py``).

``transformers.CLIPTokenizer`` in its no-ftfy configuration (lowercase, no
accent strip, no punctuation split), the path of the original
FrozenCLIPEmbedder. Given the same ``vocab.json``/``merges.txt`` the ids
are HF's.

The JAX package pre-tokenizes with the ``regex`` module's ``\\p{L}`` and
``\\p{N}``; the port uses the standard library's ``re``, which has neither.
``[^\\W\\d_]`` is not ``\\p{L}``: it also takes the ``No``/``Nl`` numbers
(``½``, ``Ⅻ``). So both classes are built once from
``unicodedata.category`` (every code point whose category starts with
``L``, resp. ``N``) as ranges, and the pattern keeps ``IGNORECASE``.
"""

from __future__ import annotations

import json
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

from frido_tpu_torch.text.wordpiece import BasicTokenizer

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table (the BPE operates
    on these stand-in chars so raw bytes never collide with merges)."""
    bs = list(range(ord("!"), ord("~") + 1)) \
        + list(range(ord("¡"), ord("¬") + 1)) \
        + list(range(ord("®"), 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


def _ranges(major: str) -> str:
    """A character-class body of every code point whose Unicode category
    starts with ``major``, as escaped ``a-b`` ranges."""
    out, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp))[0] == major:
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            out.append((start, prev))
            start = None
    if start is not None:
        out.append((start, prev))
    return "".join(re.escape(chr(a)) if a == b
                   else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in out)


@lru_cache()
def pretokenize_pattern() -> "re.Pattern":
    """CLIP's pre-tokenizer, ``\\p{L}`` and ``\\p{N}`` spelled as ranges.

    One code point needs care: U+0345 (combining ypogegrammeni, ``Mn``,
    whose case fold is a letter) matches none of the three classes under
    the ``regex`` module's IGNORECASE, so the JAX tokenizer drops it; under
    ``re``'s IGNORECASE it would join a letter run, so the run excludes it
    here, case-sensitively (U+0399, U+03B9 and U+1FBE fold alike)."""
    letters, numbers = _ranges("L"), _ranges("N")
    return re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        rf"""|(?:(?!(?-i:\u0345))[{letters}])+|[{numbers}]"""
        rf"""|[^\s{letters}{numbers}]+""",
        re.IGNORECASE)


def fallback_vocab() -> Tuple[Dict[str, int], Dict[Tuple[str, str], int]]:
    """Byte-level fallback: every byte symbol plus its ``</w>`` word-final
    variant, no merges. Tokenizes arbitrary text deterministically (each
    word becomes its byte sequence); ids are NOT openai/clip ids — for
    importing real CLIP checkpoints supply the original vocab files."""
    syms = [bytes_to_unicode()[b] for b in range(256)]
    toks = syms + [s + "</w>" for s in syms] + [BOS, EOS]
    return {t: i for i, t in enumerate(toks)}, {}


def write_vocab_files(directory: str, encoder: Dict[str, int],
                      bpe_ranks: Dict[Tuple[str, str], int]) -> None:
    """``vocab.json`` and ``merges.txt`` (a version line, then one merge a
    line in rank order) in ``directory``, HF's layout."""
    import os

    with open(os.path.join(directory, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(encoder, f, ensure_ascii=False)
    merges = sorted(bpe_ranks, key=bpe_ranks.get)
    with open(os.path.join(directory, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.writelines(f"{a} {b}\n" for a, b in merges)


class ClipBPETokenizer:
    """End-to-end CLIP tokenizer: clean/lowercase -> pre-tokenize ->
    byte-encode -> BPE -> ``<|startoftext|>`` x ``<|endoftext|>`` ->
    truncate/pad (CLIP pads with the EOS id). Returns int32 [B, L].
    """

    def __init__(self, vocab_file: str | None = None,
                 merges_file: str | None = None):
        if vocab_file is None:
            self.encoder, self.bpe_ranks = fallback_vocab()
        else:
            with open(vocab_file, encoding="utf-8") as f:
                self.encoder = json.load(f)
            with open(merges_file, encoding="utf-8") as f:
                lines = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
            merges = [tuple(line.split()) for line in lines]
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.nlp = BasicTokenizer(strip_accents=False, do_split_on_punc=False)
        self.cache = {BOS: BOS, EOS: EOS}
        self.pat = pretokenize_pattern()
        self.bos_id = self.encoder[BOS]
        self.eos_id = self.encoder[EOS]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 \
                        and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        merged = " ".join(word)
        self.cache[token] = merged
        return merged

    def tokenize(self, text: str) -> List[str]:
        text = " ".join(self.nlp.tokenize(text))
        out: List[str] = []
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            out.extend(self._bpe(tok).split(" "))
        return out

    def encode(self, text: str, max_length: int = 77) -> List[int]:
        ids = [self.encoder.get(t, self.eos_id) for t in self.tokenize(text)]
        ids = [self.bos_id] + ids[:max_length - 2] + [self.eos_id]
        return ids + [self.eos_id] * (max_length - len(ids))

    def __call__(self, texts: Sequence[str] | str,
                 max_length: int = 77) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return np.asarray([self.encode(t, max_length) for t in texts],
                          dtype=np.int32)
