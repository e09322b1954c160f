"""Conditioning encoders and their host tokenizers (port of
``frido_tpu/nn/encoders.py``).

Each config target is one ``nn.Module`` that is both the cond stage
(``cond_stage_model.*`` in the key tree) and its host side: ``tokenize``
turns a batch's raw condition (captions, class ids, token ids, images)
into the array ``forward`` takes, outside the device program.

- ``BERTEmbedder``: the from-scratch x-transformer over BERT token ids;
  ``tokenize`` runs the WordPiece tokenizer (``use_tokenizer``) or passes
  token ids through (optionally picked from a dict by ``cond_key``);
  ``TransformerEmbedder`` is the same over raw ids.
- ``ClassEmbedder``: a class-id embedding, max-pooled over the labels when
  ``multilabel``.
- ``SpatialRescaler``: ``n_stages`` antialiased bilinear resizes by
  ``multiplier`` (``jax.image.resize`` semantics, ``ops/image.py``) and an
  optional bias-free 1x1 channel map, on NHWC images.
- ``BERTEmbedderVQTInterface``: the BERT tokenizer behind the VQ-model
  interface (no parameters).
- ``FrozenCLIPEmbedder`` (per-token CLIP text states),
  ``FrozenCLIPTextEmbedder`` (the pooled, projected, normalised CLIP text
  embedding, [B, n_repeat, 768]) and ``FrozenClipImageEmbedder`` (the
  CLIP ViT over ``clip_preprocess``-ed [-1, 1] images), ``nn/clip.py``.

Host tokenizers resolve their vocabulary as the JAX package's do: an
environment variable, then a vendored copy (``text/vendor.py``), then a
local ``transformers`` tokenizer (a cache-only probe; a machine without
``transformers`` skips it), then the built-in fallback vocabulary with a
warning, or an error under ``FRIDO_TPU_STRICT_VOCAB``.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from frido_tpu_torch.nn.clip import (CLIPTextModule, CLIPTextPooledModule,
                                     CLIPVisionTower, clip_preprocess)
from frido_tpu_torch.nn.layers import Conv2d, Embed
from frido_tpu_torch.nn.xtransformer import TransformerWrapper
from frido_tpu_torch.ops.image import resize, to_nchw, to_nhwc


# ---------------------------------------------------------------------------
# host-side tokenization
# ---------------------------------------------------------------------------

def _fallback_vocab_notice(msg: str) -> None:
    """Warn, or raise under ``FRIDO_TPU_STRICT_VOCAB`` (any value but
    ``""``, ``0`` and ``false``).

    The char/byte fallback vocabularies keep training from scratch working
    without files, but their ids match no trained checkpoint's embedding
    rows, so the checkpoint-consuming sampling CLI sets strict mode:
    sampling garbage from an imported checkpoint is worse than failing."""
    if os.environ.get("FRIDO_TPU_STRICT_VOCAB", "0") not in ("", "0",
                                                             "false"):
        raise RuntimeError(
            msg + " (strict mode: FRIDO_TPU_STRICT_VOCAB is set; vendor "
            "the real vocab with `python -m frido_tpu_torch.text.vendor "
            "...`, or unset the variable to accept the non-canonical "
            "fallback)")
    warnings.warn(msg)


def _hf_tokenizer(cls_name: str, default: str, env: str, fallback: str):
    """A ``transformers`` tokenizer from the path or name in ``env``, else
    from ``default`` by a cache-only probe; None when the probe finds
    nothing. A named tokenizer that fails to load raises: it must not
    degrade to the fallback's ids."""
    explicit = os.environ.get(env)
    try:
        import transformers

        # the implicit probe is cache-only: with the network allowed the
        # hub client retries for minutes on a machine without one
        return getattr(transformers, cls_name).from_pretrained(
            explicit or default, local_files_only=not explicit)
    except Exception as e:  # no transformers, no cache: the fallback
        if explicit:
            raise RuntimeError(
                f"{env}={explicit!r} was set but loading it failed "
                f"({type(e).__name__}: {e}); refusing to fall back to the "
                f"{fallback} vocab: fix the path or unset the "
                f"variable") from e
        return None


def _notice(kind: str, fallback: str, vendor_args: str, env: str) -> str:
    return (f"{kind} vocab unavailable locally: falling back to the "
            f"{fallback} vocab. This trains a DIFFERENT text "
            "representation: results are NOT comparable to any published "
            "Frido number, and the ids DO NOT match any trained "
            "checkpoint's embedding rows. For canonical ids, vendor the "
            f"files once: `python -m frido_tpu_torch.text.vendor "
            f"{vendor_args}` (or set {env})")


class BERTTokenizerHost:
    """BERT tokenization on the host: truncate and pad to ``max_length``,
    int32 [B, L] numpy ids.

    Resolution order:
      1. ``FRIDO_TPU_BERT_VOCAB``, a ``vocab.txt``;
      2. a vendored vocab (``python -m frido_tpu_torch.text.vendor
         /path/to/vocab.txt``);
      3. ``FRIDO_TPU_BERT_TOKENIZER`` / the HF cache: BertTokenizerFast;
      4. the built-in char-level fallback vocab (train-from-scratch only).
    """

    def __init__(self, max_length: int = 77):
        from frido_tpu_torch.text import WordPieceTokenizer, vendor

        self.max_length = max_length
        self._hf = None
        vocab = os.environ.get("FRIDO_TPU_BERT_VOCAB") \
            or vendor.bert_vocab_path()
        if vocab:
            self.tokenizer = WordPieceTokenizer(vocab)
            return
        self._hf = _hf_tokenizer("BertTokenizerFast", "bert-base-uncased",
                                 "FRIDO_TPU_BERT_TOKENIZER", "char")
        if self._hf is None:
            _fallback_vocab_notice(_notice(
                "bert-base-uncased", "char-fallback", "/path/to/vocab.txt",
                "FRIDO_TPU_BERT_VOCAB"))
            self.tokenizer = WordPieceTokenizer()

    def __call__(self, texts) -> np.ndarray:
        if self._hf is not None:
            enc = self._hf(texts, truncation=True, max_length=self.max_length,
                           padding="max_length", return_tensors="np")
            return np.asarray(enc["input_ids"], dtype="int32")
        return self.tokenizer(texts, max_length=self.max_length)


class CLIPTokenizerHost:
    """CLIP BPE tokenization on the host, like :class:`BERTTokenizerHost`.

    Resolution order:
      1. ``FRIDO_TPU_CLIP_VOCAB``, a directory with ``vocab.json`` and
         ``merges.txt``;
      2. a vendored pair (``python -m frido_tpu_torch.text.vendor
         vocab.json merges.txt``);
      3. ``FRIDO_TPU_CLIP_TOKENIZER`` / the HF cache: CLIPTokenizer;
      4. the built-in byte-level fallback vocab (train-from-scratch only).
    """

    def __init__(self, version: str, max_length: int = 77):
        from frido_tpu_torch.text import ClipBPETokenizer, vendor

        self.max_length = max_length
        self._hf = None
        vdir = os.environ.get("FRIDO_TPU_CLIP_VOCAB")
        if vdir:
            self.tokenizer = ClipBPETokenizer(
                os.path.join(vdir, "vocab.json"),
                os.path.join(vdir, "merges.txt"))
            return
        vendored = vendor.clip_vocab_paths()
        if vendored:
            self.tokenizer = ClipBPETokenizer(*vendored)
            return
        self._hf = _hf_tokenizer("CLIPTokenizer", version,
                                 "FRIDO_TPU_CLIP_TOKENIZER", "byte")
        if self._hf is None:
            _fallback_vocab_notice(_notice(
                "CLIP BPE", "byte-level", "vocab.json merges.txt",
                "FRIDO_TPU_CLIP_VOCAB"))
            self.tokenizer = ClipBPETokenizer()

    def __call__(self, texts) -> np.ndarray:
        if self._hf is not None:
            enc = self._hf(texts, truncation=True, max_length=self.max_length,
                           padding="max_length", return_tensors="np")
            return np.asarray(enc["input_ids"], dtype="int32")
        return self.tokenizer(texts, max_length=self.max_length)


# ---------------------------------------------------------------------------
# config targets
# ---------------------------------------------------------------------------

class BERTEmbedder(nn.Module):
    """The from-scratch x-transformer over BERT-vocab token ids, returning
    per-token embeddings for cross-attention (config target
    ``frido.modules.encoders.modules.BERTEmbedder``; key tree
    ``transformer.*``). ``embedding_dropout`` is the original config's and
    does not change sampling. ``device`` places the module."""

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int = 30522,
                 max_seq_len: int = 77, use_tokenizer: bool = True,
                 embedding_dropout: float = 0.0, cond_key: str = "",
                 device=None):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.use_tokenizer = use_tokenizer
        self.cond_key = cond_key
        self._tokenizer = None
        self.transformer = TransformerWrapper(
            num_tokens=vocab_size, max_seq_len=max_seq_len, dim=n_embed,
            depth=n_layer, device=device)

    def tokenize(self, cond) -> np.ndarray:
        """Captions -> int32 ids (``use_tokenizer``); otherwise token ids
        pass through, picked from a dict by ``cond_key`` when set (e.g.
        ``objects`` for label2i)."""
        if self.use_tokenizer:
            if self._tokenizer is None:
                self._tokenizer = BERTTokenizerHost(self.max_seq_len)
            return self._tokenizer(cond)
        if self.cond_key and isinstance(cond, dict):
            cond = cond[self.cond_key]
        return np.asarray(cond, dtype="int32")

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens)


class TransformerEmbedder(BERTEmbedder):
    """The x-transformer over raw token ids (no tokenizer)."""

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int,
                 max_seq_len: int = 77, device=None):
        super().__init__(n_embed, n_layer, vocab_size, max_seq_len,
                         use_tokenizer=False, device=device)


class ClassEmbedder(nn.Module):
    """Class-id embedding ([B] ids -> [B, 1, D]); ``multilabel`` max-pools
    the embeddings of [B, L] ids -> [B, D]. ``padding_idx`` is the original
    config's and is not used by the JAX package either."""

    def __init__(self, embed_dim: int, multilabel: bool = False,
                 padding_idx: int = 1023, n_classes: int = 1000,
                 key: str = "class", device=None):
        super().__init__()
        self.multilabel = multilabel
        self.key = key
        self.embedding = Embed(n_classes, embed_dim, device=device)

    def tokenize(self, cond) -> np.ndarray:
        if isinstance(cond, dict):
            cond = cond[self.key]
        return np.asarray(cond, dtype="int32")

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        if self.multilabel:
            return self.embedding(c).amax(dim=-2)
        return self.embedding(c[:, None])


class SpatialRescaler(nn.Module):
    """``n_stages`` antialiased bilinear resizes of NHWC images by
    ``multiplier`` (sizes ``int(h * multiplier)``), then with
    ``out_channels`` a bias-free 1x1 conv from ``in_channels``. ``method``
    and ``bias`` are the original config's; the JAX package resizes
    bilinearly without a bias whatever they say."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear",
                 multiplier: float = 0.5, in_channels: int = 3,
                 out_channels: Optional[int] = None, bias: bool = False,
                 device=None):
        super().__init__()
        self.n_stages = n_stages
        self.multiplier = multiplier
        self.channel_mapper = (None if out_channels is None else Conv2d(
            in_channels, out_channels, 1, bias=False, device=device))

    def tokenize(self, cond):
        return cond

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            n, h, w, c = x.shape
            x = resize(x, (n, int(h * self.multiplier),
                           int(w * self.multiplier), c), method="bilinear")
        if self.channel_mapper is not None:
            x = to_nhwc(self.channel_mapper(to_nchw(x)))
        return x


class BERTEmbedderVQTInterface(nn.Module):
    """The BERT tokenizer behind the VQ-model interface: ``encode`` returns
    the tokens in the ``(quant, loss, (..., indices))`` slot shape, so a
    text stream can stand in for a codebook stream; ``decode`` is the
    identity. No parameters."""

    def __init__(self, device=None, vq_interface: bool = True,
                 max_length: int = 77):
        super().__init__()
        self.max_length = max_length
        self._tokenizer = None

    def tokenize(self, texts) -> np.ndarray:
        if self._tokenizer is None:
            self._tokenizer = BERTTokenizerHost(self.max_length)
        return self._tokenizer(texts)

    def encode(self, c):
        return c, None, [None, None, self.tokenize(c)]

    def decode(self, c):
        return c


class FrozenCLIPEmbedder(CLIPTextModule):
    """The CLIP text tower's per-token last hidden state (keys
    ``transformer.text_model.*``); ``version`` names the HF tokenizer of
    the resolution order's third step. The tower is ViT-L/14's text
    tower."""

    def __init__(self, version: str = "openai/clip-vit-large-patch14",
                 device=None, max_length: int = 77):
        super().__init__(max_positions=max_length, device=device)
        self.version = version
        self.max_length = max_length
        self._tokenizer = None

    def tokenize(self, cond) -> np.ndarray:
        """Captions -> int32 [B, max_length] CLIP ids; ids pass through."""
        if not isinstance(cond, (list, tuple)) or (
                cond and not isinstance(cond[0], str)):
            return np.asarray(cond, dtype="int32")
        if self._tokenizer is None:
            self._tokenizer = CLIPTokenizerHost(self.version, self.max_length)
        return self._tokenizer(cond)


class FrozenCLIPTextEmbedder(CLIPTextPooledModule):
    """The pooled, projected and (``normalize``) L2-normalised CLIP text
    embedding repeated ``n_repeat`` times: [B, n_repeat, 768] (keys
    ``transformer.text_model.*``, ``text_projection``)."""

    def __init__(self, version: str = "openai/clip-vit-large-patch14",
                 device=None, max_length: int = 77, n_repeat: int = 1,
                 normalize: bool = True):
        super().__init__(max_positions=max_length, n_repeat=n_repeat,
                         normalize=normalize, device=device)
        self.version = version
        self.max_length = max_length
        self._tokenizer = None

    tokenize = FrozenCLIPEmbedder.tokenize


class _Visual(nn.Module):
    """The ``model`` node of the key tree (openai CLIP's ``model.visual``)."""

    def __init__(self, device=None):
        super().__init__()
        self.visual = CLIPVisionTower(device=device)


class FrozenClipImageEmbedder(nn.Module):
    """The CLIP image embedding of NHWC [-1, 1] images: bicubic 224
    resize, CLIP normalisation and the ViT-L/14 tower (keys
    ``model.visual.*``); [B, 768]. ``model``, ``jit`` and ``antialias``
    are the original config's; the JAX package resizes with antialiasing
    whatever ``antialias`` says."""

    def __init__(self, model: str = "ViT-L/14", jit: bool = False,
                 device=None, antialias: bool = False):
        super().__init__()
        self.model = _Visual(device=device)

    def tokenize(self, cond) -> np.ndarray:
        return np.asarray(cond, dtype="float32")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.visual(clip_preprocess(x))
