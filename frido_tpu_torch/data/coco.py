"""COCO 2014/2017 annotated-objects dataset (port of
``frido_tpu/data/coco.py``): the instances (and stuff) JSON, the caption
map (a sample's caption is its image's first, dots removed), the mini-val
image-id files and the optional COCO->OpenImages category unification.
"""

from __future__ import annotations

import csv
import itertools
import json
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

from frido_tpu_torch.data.annotated_objects import AnnotatedObjectsDataset
from frido_tpu_torch.data.helper_types import Annotation, Category, ImageDescription


def coco_layout(year: str, split: str) -> Dict[str, str]:
    """Relative file layout of a COCO checkout for one split, keyed the way
    ``AnnotatedObjectsDataset.build_paths`` expects. 2014 checkouts ship no
    stuff annotations, so that entry only appears for 2017."""
    tag = {"train": "train", "validation": "val"}[split] + year
    layout = {
        "top_level": "",
        "files": tag,
        "instances_annotations": f"annotations/instances_{tag}.json",
    }
    if year == "2017":
        layout["stuff_annotations"] = f"annotations/stuff_{tag}.json"
    return layout


def index_image_records(records: Iterable[Mapping]) -> Dict[str, ImageDescription]:
    """COCO ``images`` records -> id-keyed ImageDescription map. Ids are
    string keys throughout the data layer (JSON round-trips them as ints)."""
    out: Dict[str, ImageDescription] = {}
    for rec in records:
        out[str(rec["id"])] = ImageDescription(
            id=rec["id"],
            file_name=rec["file_name"],
            original_size=(rec["width"], rec["height"]),
            license=rec.get("license"),
            coco_url=rec.get("coco_url"),
            date_captured=rec.get("date_captured"),
            flickr_url=rec.get("flickr_url"))
    return out


def index_category_records(records: Iterable[Mapping]) -> Dict[str, Category]:
    """COCO ``categories`` records -> id-keyed Category map, dropping the
    stuff JSON's catch-all pseudo-class ``other``."""
    out: Dict[str, Category] = {}
    for rec in records:
        if rec["name"] == "other":
            continue
        cid = str(rec["id"])
        out[cid] = Category(id=cid, name=rec["name"],
                            super_category=rec["supercategory"])
    return out


def collect_annotations(
        streams: Iterable[Iterable[Mapping]],
        images: Mapping[str, ImageDescription],
        category_no_for_id: Callable[[str], int],
        category_remap: Optional[Mapping[str, str]] = None,
) -> Dict[str, List[Annotation]]:
    """Merge annotation streams (instances, stuff) into a per-image map.

    Bboxes are normalized by the original image size; ``area`` is the
    normalized bbox area (not the segmentation area — the filters downstream
    are calibrated to that). Records whose category was filtered out are
    skipped; an annotation pointing at an unknown image is a corrupt
    checkout and raises. ``category_remap`` applies the COCO->OpenImages
    unification before the category-number lookup.
    """
    per_image: Dict[str, List[Annotation]] = {}
    for rec in itertools.chain.from_iterable(streams):
        img_key = str(rec["image_id"])
        desc = images.get(img_key)
        if desc is None:
            raise ValueError(
                f"annotation {rec['id']} references image {img_key} which is "
                f"not in the images index")
        cat = str(rec["category_id"])
        if category_remap is not None:
            cat = str(category_remap.get(cat, cat))
        try:
            cat_no = category_no_for_id(cat)
        except KeyError:
            continue
        w, h = desc.original_size
        x0, y0, bw, bh = rec["bbox"]
        box = (x0 / w, y0 / h, bw / w, bh / h)
        per_image.setdefault(img_key, []).append(Annotation(
            id=rec["id"],
            image_id=rec["image_id"],
            category_id=cat,
            category_no=cat_no,
            bbox=box,
            area=box[2] * box[3],
            is_group_of=rec["iscrowd"]))
    return per_image


def read_oi_category_csv(path: Path) -> Dict[str, Category]:
    """OpenImages class-description CSV (mid, display name) -> Category map
    for the COCO->OI unification path."""
    with open(path, newline="") as f:
        return {mid: Category(id=mid, name=name, super_category=None)
                for mid, name in csv.reader(f)}


class AnnotatedObjectsCoco(AnnotatedObjectsDataset):
    def __init__(self, use_things: bool = True, use_stuff: bool = True,
                 img_id_file: Optional[str] = None,
                 caption_ann_path: Optional[str] = None,
                 stuff_only: bool = False, OI_cate_path: str = "",
                 specific_img_ids: List[str] = (), num_sample: int = -1,
                 **kwargs):
        super().__init__(**kwargs)
        self.use_things = use_things
        self.use_stuff = use_stuff
        self.caption_ann_path = caption_ann_path

        with open(self.paths["instances_annotations"]) as f:
            inst_data_json = json.load(f)
        stuff_data_json = None
        if use_stuff:
            with open(self.paths["stuff_annotations"]) as f:
                stuff_data_json = json.load(f)
        if caption_ann_path is not None:
            with open(caption_ann_path) as f:
                self._setup_caption(json.load(f))

        img_id_used = {}
        if img_id_file is not None:
            with open(img_id_file) as f:
                lines = f.readlines()
            if num_sample != -1:
                lines = lines[:num_sample]
            img_id_used = {line.rstrip(): 1 for line in lines}

        category_jsons, annotation_jsons = [], []
        if use_things:
            category_jsons.append(inst_data_json["categories"])
            annotation_jsons.append(inst_data_json["annotations"])
        if use_stuff:
            category_jsons.append(stuff_data_json["categories"])
            annotation_jsons.append(stuff_data_json["annotations"])

        image_ids_with_stuff = None
        if stuff_only and stuff_data_json is not None:
            image_ids_with_stuff = {
                str(a["image_id"]) for a in stuff_data_json["annotations"]}

        self.categories = index_category_records(
            itertools.chain.from_iterable(category_jsons))
        coco_to_oi = None
        if OI_cate_path:
            # COCO->OpenImages category unification (coco.py:187-203)
            self.categories_OI = read_oi_category_csv(OI_cate_path)
            oi_raw = (["-".join(v.name.lower().split(" "))
                       for v in self.categories_OI.values()]
                      + [v.name.lower() for v in self.categories_OI.values()])
            oi_ids = list(self.categories_OI.keys()) * 2
            coco_to_oi = {}
            self.categories_append = {}
            for k, v in self.categories.items():
                if v.name not in oi_raw:
                    self.categories_append[k] = v
                else:
                    coco_to_oi[k] = oi_ids[oi_raw.index(v.name)]
            self.categories = self.categories_OI

        self.filter_categories()
        self.setup_category_id_and_number()
        self.image_descriptions = index_image_records(
            inst_data_json["images"])
        annotations = collect_annotations(
            annotation_jsons, self.image_descriptions,
            self.get_category_number, coco_to_oi)
        self.annotations = self.filter_object_number(
            annotations, self.min_object_area, self.min_objects_per_image,
            self.max_objects_per_image)
        self.image_ids = sorted(self.annotations.keys())
        if image_ids_with_stuff is not None:
            self.image_ids = [i for i in self.image_ids
                              if i in image_ids_with_stuff]
        if img_id_used:
            self.image_ids = [
                i for i in self.image_ids
                if "{:012d}".format(int(i)) in img_id_used]
        if caption_ann_path is not None:
            cap_ids = set(self.img_id_to_caption_list.keys())
            self.image_ids = sorted(set(self.image_ids) & cap_ids)
        self.clean_up_annotations_and_image_descriptions()
        if specific_img_ids:
            wanted = set(specific_img_ids)
            self.image_ids = [i for i in self.image_ids if i in wanted]

    def _setup_caption(self, caption_data_json) -> None:
        m: Dict[str, List[str]] = {}
        for ann in caption_data_json["annotations"]:
            m.setdefault(str(ann["image_id"]), []).append(
                ann["caption"].replace(".", ""))
        self.img_id_to_caption_list = m

    def get_path_structure(self) -> Dict[str, str]:
        if self.split not in ("train", "validation"):
            raise ValueError(f"no COCO split named {self.split!r}")
        for year in ("2017", "2014"):
            if year in str(self.data_path):
                return coco_layout(year, self.split)
        raise ValueError(
            f"cannot tell the COCO year from data_path {self.data_path!r} "
            f"(expected '2014' or '2017' in the path)")

    def get_image_path(self, image_id: str) -> Path:
        return self.paths["files"].joinpath(
            self.image_descriptions[str(image_id)].file_name)

    def get_image_description(self, image_id: str) -> Dict[str, Any]:
        return self.image_descriptions[image_id]._asdict()

    def get_image_caption(self, image_id: str) -> List[str]:
        return self.img_id_to_caption_list[image_id]

    def plan(self, n: int) -> Dict[str, Any]:
        sample = self._base_sample(n)
        if self.caption_ann_path is not None:
            sample["caption"] = self.get_image_caption(
                self.get_image_id(n))[0]
        self._build_conditionals(sample)
        return sample
