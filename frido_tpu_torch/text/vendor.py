"""Vendor tokenizer vocabulary files into the port (one command; port of
``frido_tpu/text/vendor.py``).

The original code downloads ``bert-base-uncased``'s vocab and CLIP's BPE
merges through HuggingFace at run time. The port has no network and ships
no vocab files, so checkpoint-compatible tokenization needs the user to
supply them once. This module copies and hash-pins them into
``frido_tpu_torch/text/vendored/``; after that
:class:`~frido_tpu_torch.nn.encoders.BERTTokenizerHost` and
``CLIPTokenizerHost`` find the vendored copies by themselves (after the
explicit environment variables, before the HF cache probe).

Usage::

    # BERT WordPiece (a bert-base-uncased vocab.txt)
    python -m frido_tpu_torch.text.vendor /path/to/vocab.txt

    # CLIP BPE (a directory or the two files)
    python -m frido_tpu_torch.text.vendor /path/to/clip_dir
    python -m frido_tpu_torch.text.vendor vocab.json merges.txt

Every copy is recorded in ``vendored/MANIFEST.json`` with its sha256, so a
later run can check that the files have not drifted (``--verify``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import time
from typing import Optional

VENDOR_DIR = os.path.join(os.path.dirname(__file__), "vendored")
MANIFEST = os.path.join(VENDOR_DIR, "MANIFEST.json")

# canonical vendored filenames per asset kind
_BERT_VOCAB = "bert_vocab.txt"
_CLIP_VOCAB = "clip_vocab.json"
_CLIP_MERGES = "clip_merges.txt"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _load_manifest() -> dict:
    if os.path.exists(MANIFEST):
        with open(MANIFEST, encoding="utf-8") as f:
            return json.load(f)
    return {"assets": {}}


def _save_manifest(m: dict) -> None:
    os.makedirs(VENDOR_DIR, exist_ok=True)
    with open(MANIFEST, "w", encoding="utf-8") as f:
        json.dump(m, f, indent=2, sort_keys=True)
        f.write("\n")


def _vendor_file(src: str, dst_name: str) -> dict:
    os.makedirs(VENDOR_DIR, exist_ok=True)
    dst = os.path.join(VENDOR_DIR, dst_name)
    shutil.copyfile(src, dst)
    return {
        "source": os.path.abspath(src),
        "sha256": _sha256(dst),
        "vendored_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def bert_vocab_path() -> Optional[str]:
    """Path to the vendored bert vocab.txt, or None if not vendored."""
    p = os.path.join(VENDOR_DIR, _BERT_VOCAB)
    return p if os.path.exists(p) else None


def clip_vocab_paths() -> Optional[tuple]:
    """(vocab.json, merges.txt) paths if both vendored, else None."""
    v = os.path.join(VENDOR_DIR, _CLIP_VOCAB)
    m = os.path.join(VENDOR_DIR, _CLIP_MERGES)
    return (v, m) if os.path.exists(v) and os.path.exists(m) else None


def vendor_bert(vocab_txt: str) -> str:
    """Copy + hash-pin a WordPiece vocab.txt. Returns the vendored path."""
    if not os.path.isfile(vocab_txt):
        raise FileNotFoundError(vocab_txt)
    # sanity: a bert vocab is one token per line and contains the specials
    with open(vocab_txt, encoding="utf-8") as f:
        head = [f.readline().rstrip("\n") for _ in range(200)]
    toks = set(t for t in head if t)
    if "[PAD]" not in toks:
        raise ValueError(
            f"{vocab_txt} does not look like a BERT vocab.txt "
            "([PAD] not in the first 200 lines)")
    m = _load_manifest()
    m["assets"]["bert_vocab"] = dict(_vendor_file(vocab_txt, _BERT_VOCAB),
                                     file=_BERT_VOCAB)
    _save_manifest(m)
    return os.path.join(VENDOR_DIR, _BERT_VOCAB)


def vendor_clip(vocab_json: str, merges_txt: str) -> tuple:
    """Copy + hash-pin CLIP's vocab.json + merges.txt."""
    for p in (vocab_json, merges_txt):
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
    with open(vocab_json, encoding="utf-8") as f:
        v = json.load(f)
    if not isinstance(v, dict) or "<|startoftext|>" not in v:
        raise ValueError(f"{vocab_json} does not look like a CLIP "
                         "vocab.json (<|startoftext|> missing)")
    m = _load_manifest()
    m["assets"]["clip_vocab"] = dict(_vendor_file(vocab_json, _CLIP_VOCAB),
                                     file=_CLIP_VOCAB)
    m["assets"]["clip_merges"] = dict(_vendor_file(merges_txt, _CLIP_MERGES),
                                      file=_CLIP_MERGES)
    _save_manifest(m)
    return (os.path.join(VENDOR_DIR, _CLIP_VOCAB),
            os.path.join(VENDOR_DIR, _CLIP_MERGES))


def verify() -> list:
    """Re-hash every vendored asset against the manifest. Returns a list of
    human-readable problem strings (empty = all good)."""
    m = _load_manifest()
    problems = []
    if not m["assets"]:
        problems.append("nothing vendored yet")
    for name, rec in m["assets"].items():
        p = os.path.join(VENDOR_DIR, rec["file"])
        if not os.path.exists(p):
            problems.append(f"{name}: {rec['file']} missing")
        elif _sha256(p) != rec["sha256"]:
            problems.append(f"{name}: {rec['file']} sha256 drift "
                            f"(manifest {rec['sha256'][:12]}…)")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="vocab.txt | clip dir | vocab.json merges.txt")
    ap.add_argument("--verify", action="store_true",
                    help="re-hash vendored assets against the manifest")
    args = ap.parse_args(argv)

    if args.verify:
        problems = verify()
        for p in problems:
            print(f"FAIL: {p}")
        if not problems:
            print("all vendored assets match the manifest")
        return 1 if problems else 0

    if not args.paths:
        ap.error("give a vocab.txt, a CLIP dir, or vocab.json merges.txt "
                 "(or --verify)")

    if len(args.paths) == 2:
        v, m = vendor_clip(args.paths[0], args.paths[1])
        print(f"vendored CLIP BPE -> {v}, {m}")
        return 0

    (path,) = args.paths
    if os.path.isdir(path):
        v, m = vendor_clip(os.path.join(path, "vocab.json"),
                           os.path.join(path, "merges.txt"))
        print(f"vendored CLIP BPE -> {v}, {m}")
    elif path.endswith(".json"):
        ap.error("CLIP vendoring needs merges.txt too: "
                 "pass 'vocab.json merges.txt' or the directory")
    else:
        p = vendor_bert(path)
        print(f"vendored BERT WordPiece vocab -> {p}")
    print("tokenizers now resolve these automatically "
          "(env vars still take precedence)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
