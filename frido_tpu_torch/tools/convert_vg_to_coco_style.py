#!/usr/bin/env python
"""Visual Genome boxes -> coco-style instances JSON (layout2i input),
without h5py (port of ``scripts/convert_vg_to_coco_style.py``).

    python -m frido_tpu_torch.tools.convert_vg_to_coco_style -b BASE_DIR \\
        -s {train,val}

Reads ``{split}.npz`` of ``preprocess_vg_sg2im.py`` (this package's),
``vocab.json`` and ``image_data.json``, and writes
``{split}_coco_style.json`` with the VG object categories as COCO
categories, which ``data/vg_cocostyle.py`` reads.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from frido_tpu_torch.tools.preprocess_vg_to_sg import load_split


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

    categories = [dict(supercategory=name, id=int(idx), name=name)
                  for name, idx in vocab["object_name_to_idx"].items()]

    info = {int(a["image_id"]): a for a in vg_imgs}
    images = []
    for img_id, img_path in zip(d["image_ids"], d["image_paths"]):
        ann = info[int(img_id)]
        images.append(dict(
            license=1, file_name=img_path.decode("utf-8").split("/")[-1],
            coco_url=ann["url"], height=int(ann["height"]),
            width=int(ann["width"]), flickr_url=ann["url"], id=int(img_id)))

    annotations = []
    for img_id, obj_ids, obj_cate_ids, obj_bboxes in zip(
            d["image_ids"], d["object_ids"], d["object_names"],
            d["object_boxes"]):
        for j in range(len(obj_ids)):
            if obj_ids[j] == -1:
                continue
            annotations.append(dict(
                segmentation=[], iscrowd=0, image_id=int(img_id),
                bbox=list(np.asarray(obj_bboxes[j], np.float64)),
                category_id=int(obj_cate_ids[j]), id=int(obj_ids[j])))

    out = dict(images=images, annotations=annotations,
               categories=categories)
    path = os.path.join(args.base_dir, f"{args.split}_coco_style.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"wrote {path}: {len(images)} images, {len(annotations)} boxes")


if __name__ == "__main__":
    main()
