"""Host tokenizers, pure Python (port of ``frido_tpu/text/``, kept as the
port's own copy: the port imports nothing of the JAX package).

- :mod:`frido_tpu_torch.text.wordpiece`: BERT BasicTokenizer + WordPiece,
  id for id ``transformers.BertTokenizer`` given the same ``vocab.txt``;
- :mod:`frido_tpu_torch.text.clip_bpe`: CLIP byte-level BPE (the no-ftfy
  HF path), id for id ``transformers.CLIPTokenizer`` given the same
  ``vocab.json``/``merges.txt``; pre-tokenized with the standard
  library's ``re``;
- :mod:`frido_tpu_torch.text.vendor`: copies vocab files into
  ``vendored/`` with a hash manifest.

Each tokenizer has a deterministic built-in fallback vocabulary (char- or
byte-level), so training from scratch needs no file. A published
checkpoint needs the vocab files it was trained with
(``FRIDO_TPU_BERT_VOCAB`` / ``FRIDO_TPU_CLIP_VOCAB``, or vendored).
"""

from frido_tpu_torch.text.clip_bpe import ClipBPETokenizer  # noqa: F401
from frido_tpu_torch.text.wordpiece import WordPieceTokenizer  # noqa: F401
