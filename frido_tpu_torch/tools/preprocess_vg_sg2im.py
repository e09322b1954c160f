#!/usr/bin/env python
"""Visual Genome -> sg2im-style scene graphs, without h5py (port of
``scripts/preprocess_vg_sg2im.py``).

    python -m frido_tpu_torch.tools.preprocess_vg_sg2im --vg_dir DIR \\
        [--output_dir DIR] [the JAX script's filter flags]

Reads the raw VG JSON dumps (image_data / objects / attributes /
relationships), builds frequency-thresholded vocabularies on the train
split, filters objects by size and images by object/relationship count,
and writes ``vocab.json`` plus one ``{split}.npz`` per split: the datasets
the JAX script writes into ``{split}.h5``, with the same names, dtypes,
shapes and ``-1`` padding, in a file numpy reads (the card's machine has
no h5py). The ``.npz`` feeds ``preprocess_vg_to_sg.py`` (scene-graph
captions for sg2i) and ``convert_vg_to_coco_style.py`` (layout2i boxes)
of this package.

Output schema per split (rows = images, ragged data padded with -1):
  image_ids [N], image_paths [N] (fixed-length bytes, as h5py stores
  them), object_ids/object_names [N, max_obj], object_boxes [N, max_obj,
  4] (xywh), objects_per_image [N],
  relationship_ids/subjects/predicates/objects [N, max_rel],
  relationships_per_image [N],
  attributes_per_object [N, max_obj], object_attributes [N, max_obj,
  max_att]

vocab.json: object/pred/attribute `*_name_to_idx` + `*_idx_to_name`;
object index 0 is ``__image__`` and predicate 0 is ``__in_image__``
(sg2im's dummy whole-image node / fully-connecting edge).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter, defaultdict

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--vg_dir", default="data/vg",
                   help="dir with image_data/objects/attributes/"
                        "relationships .json")
    p.add_argument("--splits_json", default=None,
                   help="optional {split: [image_id]} json; without it a "
                        "deterministic 80/10/10 split by image_id is made")
    p.add_argument("--object_aliases", default=None,
                   help="optional 'alias,canonical' txt")
    p.add_argument("--relationship_aliases", default=None)
    p.add_argument("--min_image_size", type=int, default=200)
    p.add_argument("--min_object_instances", type=int, default=2000)
    p.add_argument("--min_attribute_instances", type=int, default=2000)
    p.add_argument("--min_object_size", type=int, default=32)
    p.add_argument("--min_objects_per_image", type=int, default=3)
    p.add_argument("--max_objects_per_image", type=int, default=30)
    p.add_argument("--max_attributes_per_object", type=int, default=30)
    p.add_argument("--min_relationship_instances", type=int, default=500)
    p.add_argument("--min_relationships_per_image", type=int, default=1)
    p.add_argument("--max_relationships_per_image", type=int, default=30)
    p.add_argument("--output_dir", default=None,
                   help="defaults to --vg_dir")
    return p.parse_args(argv)


def load_aliases(path):
    """'alias,canonical' lines -> dict; identity when no file given."""
    table = {}
    if path and os.path.isfile(path):
        with open(path) as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) == 2:
                    table[parts[0]] = parts[1]
    return table


def canonical(name: str, aliases: dict) -> str:
    name = name.strip().lower()
    return aliases.get(name, name)


def first_name(obj: dict, aliases: dict) -> str | None:
    names = obj.get("names") or ([obj["name"]] if "name" in obj else [])
    return canonical(names[0], aliases) if names else None


def make_splits(image_ids):
    """Deterministic 80/10/10 by image_id hash order (no RNG, stable
    across runs)."""
    ids = sorted(image_ids)
    n = len(ids)
    n_train = int(n * 0.8)
    n_val = int(n * 0.1)
    return {
        "train": ids[:n_train],
        "val": ids[n_train:n_train + n_val],
        "test": ids[n_train + n_val:],
    }


def build_vocab(counter: Counter, min_count: int, specials):
    names = list(specials) + sorted(
        n for n, c in counter.items() if c >= min_count and n not in specials)
    return {n: i for i, n in enumerate(names)}, names


def main(argv=None):
    args = parse_args(argv)
    out_dir = args.output_dir or args.vg_dir
    os.makedirs(out_dir, exist_ok=True)

    def load(name):
        path = os.path.join(args.vg_dir, name)
        print(f"loading {path}")
        with open(path) as f:
            return json.load(f)

    images = load("image_data.json")
    img_info = {im["image_id"]: im for im in images
                if min(im["width"], im["height"]) >= args.min_image_size}

    if args.splits_json:
        with open(args.splits_json) as f:
            splits = {s: [i for i in ids if i in img_info]
                      for s, ids in json.load(f).items()}
    else:
        splits = make_splits(img_info.keys())
    train_ids = set(splits.get("train", []))

    obj_alias = load_aliases(args.object_aliases)
    rel_alias = load_aliases(args.relationship_aliases)

    objects = load("objects.json")
    image_objects = {im["image_id"]: im.get("objects", []) for im in objects}

    # object vocab from train-split instance counts
    obj_counts = Counter()
    for iid in train_ids:
        for obj in image_objects.get(iid, []):
            name = first_name(obj, obj_alias)
            if name:
                obj_counts[name] += 1
    obj_to_idx, obj_names_list = build_vocab(
        obj_counts, args.min_object_instances, ["__image__"])
    print(f"object vocab: {len(obj_to_idx)}")

    # attribute vocab
    try:
        attributes = load("attributes.json")
    except FileNotFoundError:
        attributes = []
    image_attrs = {im["image_id"]: im.get("attributes", [])
                   for im in attributes}
    att_counts = Counter()
    for iid in train_ids:
        for entry in image_attrs.get(iid, []):
            for att in entry.get("attributes", []) or []:
                att_counts[canonical(att, {})] += 1
    att_to_idx, att_names_list = build_vocab(
        att_counts, args.min_attribute_instances, ["__no_attribute__"])
    print(f"attribute vocab: {len(att_to_idx)}")

    # filter object instances: known name + big enough box
    object_table = {}  # object_id -> (name_idx, box, attr idx list)
    for im in objects:
        attrs_by_oid = defaultdict(list)
        for entry in image_attrs.get(im["image_id"], []):
            oid = entry.get("object_id")
            for att in entry.get("attributes", []) or []:
                ai = att_to_idx.get(canonical(att, {}))
                if ai is not None:
                    attrs_by_oid[oid].append(ai)
        for obj in im.get("objects", []):
            name = first_name(obj, obj_alias)
            idx = obj_to_idx.get(name) if name else None
            if idx is None:
                continue
            if min(obj["w"], obj["h"]) < args.min_object_size:
                continue
            box = (obj["x"], obj["y"], obj["w"], obj["h"])
            oid = obj["object_id"]
            object_table[oid] = (idx, box,
                                 attrs_by_oid.get(oid, [])
                                 [:args.max_attributes_per_object])
    print(f"object instances kept: {len(object_table)}")

    relationships = load("relationships.json")
    image_rels = {im["image_id"]: im.get("relationships", [])
                  for im in relationships}
    pred_counts = Counter()
    for iid in train_ids:
        for rel in image_rels.get(iid, []):
            s = rel["subject"]["object_id"]
            o = rel["object"]["object_id"]
            if s in object_table and o in object_table:
                pred_counts[canonical(rel["predicate"], rel_alias)] += 1
    pred_to_idx, pred_names_list = build_vocab(
        pred_counts, args.min_relationship_instances, ["__in_image__"])
    print(f"predicate vocab: {len(pred_to_idx)}")

    vocab = {
        "object_name_to_idx": obj_to_idx,
        "object_idx_to_name": obj_names_list,
        "pred_name_to_idx": pred_to_idx,
        "pred_idx_to_name": pred_names_list,
        "attribute_name_to_idx": att_to_idx,
        "attribute_idx_to_name": att_names_list,
    }
    vocab_path = os.path.join(out_dir, "vocab.json")
    with open(vocab_path, "w") as f:
        json.dump(vocab, f)
    print(f"wrote {vocab_path}")

    for split, ids in splits.items():
        rows = []
        skips = Counter()
        for iid in ids:
            objs = [(oid, *object_table[oid])
                    for oid in (o["object_id"]
                                for o in image_objects.get(iid, []))
                    if oid in object_table]
            if not (args.min_objects_per_image <= len(objs)
                    <= args.max_objects_per_image):
                skips["objects" if len(objs) < args.min_objects_per_image
                      else "too_many_objects"] += 1
                continue
            oid_to_local = {o[0]: i for i, o in enumerate(objs)}
            rels = []
            for rel in image_rels.get(iid, []):
                pi = pred_to_idx.get(canonical(rel["predicate"], rel_alias))
                si = oid_to_local.get(rel["subject"]["object_id"])
                oi = oid_to_local.get(rel["object"]["object_id"])
                if pi is not None and si is not None and oi is not None:
                    rels.append((rel.get("relationship_id", -1), si, pi, oi))
            rels = rels[:args.max_relationships_per_image]
            if len(rels) < args.min_relationships_per_image:
                skips["relationships"] += 1
                continue
            url = img_info[iid].get("url", f"{iid}.jpg")
            rows.append((iid, url.split("/")[-1], objs, rels))
        print(f"{split}: {len(rows)} images kept, skipped {dict(skips)}")
        if not rows:
            continue

        max_obj = max(len(r[2]) for r in rows)
        max_rel = max(len(r[3]) for r in rows)
        max_att = args.max_attributes_per_object
        n = len(rows)
        d = {
            "image_ids": np.array([r[0] for r in rows], np.int64),
            "image_paths": np.array([r[1].encode() for r in rows]),
            "objects_per_image": np.array([len(r[2]) for r in rows],
                                          np.int64),
            "relationships_per_image": np.array([len(r[3]) for r in rows],
                                                np.int64),
            "object_ids": np.full((n, max_obj), -1, np.int64),
            "object_names": np.full((n, max_obj), -1, np.int64),
            "object_boxes": np.full((n, max_obj, 4), -1, np.int64),
            "attributes_per_object": np.zeros((n, max_obj), np.int64),
            "object_attributes": np.full((n, max_obj, max_att), -1,
                                         np.int64),
            "relationship_ids": np.full((n, max_rel), -1, np.int64),
            "relationship_subjects": np.full((n, max_rel), -1, np.int64),
            "relationship_predicates": np.full((n, max_rel), -1, np.int64),
            "relationship_objects": np.full((n, max_rel), -1, np.int64),
        }
        for i, (iid, _, objs, rels) in enumerate(rows):
            for j, (oid, name_idx, box, atts) in enumerate(objs):
                d["object_ids"][i, j] = oid
                d["object_names"][i, j] = name_idx
                d["object_boxes"][i, j] = box
                d["attributes_per_object"][i, j] = len(atts)
                d["object_attributes"][i, j, :len(atts)] = atts
            for j, (rid, si, pi, oi) in enumerate(rels):
                d["relationship_ids"][i, j] = rid
                d["relationship_subjects"][i, j] = si
                d["relationship_predicates"][i, j] = pi
                d["relationship_objects"][i, j] = oi

        path = os.path.join(out_dir, f"{split}.npz")
        np.savez(path, **d)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
