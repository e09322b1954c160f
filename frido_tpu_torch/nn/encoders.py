"""Conditioning encoders (port of ``frido_tpu/nn/encoders.py``).

This slice ports the BERTEmbedder on raw token ids, as the benchmark feeds
them (``bench.py:173-178``); the host tokenizers of ``frido_tpu/text/``
are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from frido_tpu_torch.nn.xtransformer import TransformerWrapper


class BERTEmbedder(nn.Module):
    """The from-scratch x-transformer over BERT-vocab token ids, returning
    per-token embeddings for cross-attention (config target
    ``frido.modules.encoders.modules.BERTEmbedder``; key tree
    ``transformer.*``).

    ``use_tokenizer``, ``embedding_dropout`` and ``cond_key`` are the
    original config's and do not change sampling from token ids.
    ``device`` places the module, as everywhere in the port.
    """

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int = 30522,
                 max_seq_len: int = 77, use_tokenizer: bool = True,
                 embedding_dropout: float = 0.0, cond_key: str = "",
                 device=None):
        super().__init__()
        self.transformer = TransformerWrapper(
            num_tokens=vocab_size, max_seq_len=max_seq_len, dim=n_embed,
            depth=n_layer, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens)
