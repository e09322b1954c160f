#!/usr/bin/env python
"""Visual Genome scene graphs -> flattened text captions (sg2i input),
without h5py (port of ``scripts/preprocess_vg_to_sg.py``).

    python -m frido_tpu_torch.tools.preprocess_vg_to_sg -b BASE_DIR \\
        -s {train,val}

Reads ``{split}.npz`` of ``preprocess_vg_sg2im.py`` (this package's; the
datasets of the JAX script's ``{split}.h5``), ``vocab.json`` and
``image_data.json``, and writes the coco-caption-style
``{split}_sg.json`` that ``data/vg.py`` reads: each caption "subj [A]
pred obj [B], ..." with letter disambiguators for repeated object names.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

LETTERS = [chr(ord("A") + i) for i in range(26)] + [
    "AB", "AC", "AD", "AE", "AF"]


def load_split(base_dir: str, split: str) -> dict:
    """The split's datasets, as arrays (``{split}.npz``)."""
    with np.load(os.path.join(base_dir, f"{split}.npz")) as f:
        return {k: f[k] for k in f.files}


def scene_graph_caption(num_rel, rel_objs, rel_sbjs, rel_preds, obj_names,
                        vocab) -> str:
    """Flatten one scene graph into text; repeated object names get letter
    suffixes (A, B, ...) by order of first appearance."""
    name_to_ids: dict = {}
    for i in range(num_rel):
        for oid in (rel_sbjs[i], rel_objs[i]):
            name = vocab["object_idx_to_name"][obj_names[oid]]
            ids = name_to_ids.setdefault(name, [])
            if oid not in ids:
                ids.append(oid)

    words = []
    for i in range(num_rel):
        for oid, is_subj in ((rel_sbjs[i], True), (rel_objs[i], False)):
            name = vocab["object_idx_to_name"][obj_names[oid]]
            if is_subj:
                words.append(name)
                if len(name_to_ids[name]) > 1:
                    words.append(LETTERS[name_to_ids[name].index(oid)])
                words.append(vocab["pred_idx_to_name"][rel_preds[i]])
            else:
                words.append(name)
                if len(name_to_ids[name]) > 1:
                    words.append(LETTERS[name_to_ids[name].index(oid)])
        words.append(",")
    return " ".join(words[:-1]) if words else ""


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base_dir", type=str, required=True)
    p.add_argument("-s", "--split", type=str, required=True,
                   choices=["train", "val"])
    args = p.parse_args(argv)

    with open(os.path.join(args.base_dir, "image_data.json")) as f:
        vg_imgs = json.load(f)
    with open(os.path.join(args.base_dir, "vocab.json")) as f:
        vocab = json.load(f)
    d = load_split(args.base_dir, args.split)

    wanted = set(int(i) for i in d["image_ids"])
    images = []
    for ann in vg_imgs:
        if int(ann["image_id"]) not in wanted:
            continue
        images.append(dict(
            license=0, file_name=ann["url"].split("/")[-1],
            coco_url=ann["url"], height=float(ann["height"]),
            width=float(ann["width"]), flickr_url=ann["url"],
            id=int(ann["image_id"])))

    annotations = []
    for img_id, num_rel, rel_objs, rel_sbjs, rel_preds, obj_names in zip(
            d["image_ids"], d["relationships_per_image"],
            d["relationship_objects"], d["relationship_subjects"],
            d["relationship_predicates"], d["object_names"]):
        annotations.append(dict(
            image_id=int(img_id), id=int(img_id),
            caption=scene_graph_caption(int(num_rel), rel_objs, rel_sbjs,
                                        rel_preds, obj_names, vocab)))

    out = dict(info={}, licenses=[], images=images, annotations=annotations)
    path = os.path.join(args.base_dir, f"{args.split}_sg.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"wrote {path}: {len(images)} images, {len(annotations)} captions")


if __name__ == "__main__":
    main()
