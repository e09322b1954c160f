"""BERT-style WordPiece tokenizer, pure Python (port of
``frido_tpu/text/wordpiece.py``, kept as the port's own copy).

The ``transformers.BertTokenizer`` pipeline of the original BERTEmbedder:
text cleanup, CJK isolation, NFC normalisation, lowercase and accent strip,
punctuation split, then greedy longest-match-first WordPiece, so that with
the same ``vocab.txt`` the ids are HF's (``tests/test_torch_text.py`` holds
them to the JAX package's).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Sequence

import numpy as np


# --- character classes (BERT's definitions, not str.isXxx) -----------------

def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumerics count as punctuation even when unicode
    # disagrees (e.g. ^ $ `), matching BERT
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """Whitespace/punctuation pre-tokenizer (BERT semantics).

    ``strip_accents=None`` means "follow do_lower_case", as in BERT.
    ``do_split_on_punc=False`` is the CLIP-without-ftfy configuration.
    """

    def __init__(self, do_lower_case: bool = True, strip_accents=None,
                 do_split_on_punc: bool = True,
                 tokenize_chinese_chars: bool = True):
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.do_split_on_punc = do_split_on_punc
        self.tokenize_chinese_chars = tokenize_chinese_chars

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        if self.tokenize_chinese_chars:
            text = self._isolate_cjk(text)
        text = unicodedata.normalize("NFC", text)
        out: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                if self.strip_accents is not False:
                    tok = self._strip_accents(tok)
            elif self.strip_accents:
                tok = self._strip_accents(tok)
            out.extend(self._split_punc(tok))
        return " ".join(out).split()

    @staticmethod
    def _clean(text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            chars.append(" " if _is_whitespace(ch) else ch)
        return "".join(chars)

    @staticmethod
    def _isolate_cjk(text: str) -> str:
        return "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    def _split_punc(self, tok: str) -> List[str]:
        if not self.do_split_on_punc:
            return [tok]
        parts: List[str] = []
        word = ""
        for ch in tok:
            if _is_punctuation(ch):
                if word:
                    parts.append(word)
                    word = ""
                parts.append(ch)
            else:
                word += ch
        if word:
            parts.append(word)
        return parts


def _greedy_wordpiece(token: str, vocab: Dict[str, int], unk: str,
                      max_chars: int = 100) -> List[str]:
    if len(token) > max_chars:
        return [unk]
    pieces: List[str] = []
    start = 0
    while start < len(token):
        end = len(token)
        piece = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return [unk]
        pieces.append(piece)
        start = end
    return pieces


def load_vocab(path: str) -> Dict[str, int]:
    """``vocab.txt`` (one token per line, id = line number), HF format."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def fallback_vocab(vocab_size: int = 30522) -> Dict[str, int]:
    """Deterministic char-level WordPiece vocab for zero-egress training.

    Keeps bert-base-uncased's special-token layout ([PAD]=0, [unused0..98],
    [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103) and fills onward with every
    printable latin-1 char plus its ``##`` continuation, so any text
    tokenizes to chars (never [UNK] for latin text). Ids are NOT
    bert-base-uncased ids — the embedder must be trained from scratch, which
    is exactly what Frido's BERTEmbedder does.
    """
    toks = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] \
        + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = [chr(c) for c in range(33, 127)] \
        + [chr(c) for c in range(0xA1, 0x100)]
    toks += chars + ["##" + c for c in chars]
    # a dash of common English wordpieces so captions don't explode to
    # pure char sequences (77-token budget); chosen once, fixed forever
    common = ("the a an of in on with and is are to at for it this that "
              "man woman person people dog cat car street room water sky "
              "table sitting standing next two white black red green blue "
              "##s ##ing ##ed ##er").split()
    toks += [w for w in common if w not in set(toks)]
    if len(toks) > vocab_size:
        toks = toks[:vocab_size]
    toks += [f"[pad{i}]" for i in range(vocab_size - len(toks))]
    return {t: i for i, t in enumerate(toks)}


class WordPieceTokenizer:
    """End-to-end BERT tokenizer: basic split -> WordPiece -> [CLS] x [SEP]
    -> truncate/pad to ``max_length``. Returns int32 [B, L].
    """

    def __init__(self, vocab: Dict[str, int] | str | None = None,
                 do_lower_case: bool = True, unk_token: str = "[UNK]",
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]"):
        if vocab is None:
            vocab = fallback_vocab()
        elif isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case=do_lower_case)
        self.unk_token = unk_token
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic.tokenize(text):
            out.extend(_greedy_wordpiece(tok, self.vocab, self.unk_token))
        return out

    def encode(self, text: str, max_length: int = 77) -> List[int]:
        ids = [self.vocab.get(t, self.vocab[self.unk_token])
               for t in self.tokenize(text)]
        ids = ids[:max_length - 2]
        ids = [self.cls_id] + ids + [self.sep_id]
        return ids + [self.pad_id] * (max_length - len(ids))

    def __call__(self, texts: Sequence[str] | str,
                 max_length: int = 77) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return np.asarray([self.encode(t, max_length) for t in texts],
                          dtype=np.int32)
