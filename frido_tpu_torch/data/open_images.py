"""OpenImages annotated-objects dataset for layout2i (port of
``frido_tpu/data/open_images.py``).

A streaming parse of the detections CSV, the top-300-class and
COCO-compatibility filter and the category unification map. The class
tables are the port's own copy of the JAX package's
``open_images_data.json`` (public OpenImages metadata), beside this
module.
"""

from __future__ import annotations

import json
import os
import warnings
from collections import defaultdict
from csv import DictReader, reader as TupleReader
from pathlib import Path
from typing import Any, Dict, List

from frido_tpu_torch.data.annotated_objects import AnnotatedObjectsDataset
from frido_tpu_torch.data.helper_types import Annotation, Category

OPEN_IMAGES_STRUCTURE = {
    split: {
        "top_level": "",
        "class_descriptions": "metadata/classes.csv",
        "annotations": "labels/detections.csv",
        "file_list": "metadata/image_ids.csv",
        "files": "data",
    }
    for split in ("train", "validation", "test")
}

_DATA_JSON = os.path.join(os.path.dirname(__file__), "open_images_data.json")


def _load_tables():
    with open(_DATA_JSON) as f:
        d = json.load(f)
    return (d["top_300_classes_plus_coco_compatibility"],
            d["open_images_unify_categories_for_coco"])


def load_categories(csv_path: Path) -> Dict[str, Category]:
    with open(csv_path) as f:
        return {row[0]: Category(id=row[0], name=row[1], super_category=None)
                for row in TupleReader(f)}


def load_annotations(descriptor_path: Path, min_object_area: float,
                     category_mapping: Dict[str, str],
                     category_no_for_id: Dict[str, int],
                     cate_id_check: Dict[str, int]):
    annotations: Dict[str, List[Annotation]] = defaultdict(list)
    with open(descriptor_path) as f:
        reader = DictReader(f)
        i = -1
        for i, row in enumerate(reader):
            width = float(row["XMax"]) - float(row["XMin"])
            height = float(row["YMax"]) - float(row["YMin"])
            area = width * height
            category_id = row["LabelName"]
            category_id = category_mapping.get(category_id, category_id)
            if (area >= min_object_area and category_id in category_no_for_id
                    and cate_id_check.get(category_id) == 1):
                annotations[row["ImageID"]].append(Annotation(
                    id=i,
                    image_id=row["ImageID"],
                    source=row["Source"],
                    category_id=category_id,
                    category_no=category_no_for_id[category_id],
                    confidence=float(row["Confidence"]),
                    bbox=(float(row["XMin"]), float(row["YMin"]), width,
                          height),
                    area=area,
                    is_occluded=bool(int(row["IsOccluded"])),
                    is_truncated=bool(int(row["IsTruncated"])),
                    is_group_of=bool(int(row["IsGroupOf"])),
                    is_depiction=bool(int(row["IsDepiction"])),
                    is_inside=bool(int(row["IsInside"])),
                ))
    if "train" in str(descriptor_path) and i < 14000000:
        warnings.warn("Running with a subset of OpenImages "
                      f"({len(annotations)} annotated images).")
    return dict(annotations)


class AnnotatedObjectsOpenImages(AnnotatedObjectsDataset):
    def __init__(self, use_additional_parameters: bool, **kwargs):
        super().__init__(**kwargs)
        self.use_additional_parameters = use_additional_parameters
        top300, unify = _load_tables()

        self.categories = load_categories(self.paths["class_descriptions"])
        self.filter_categories()
        self.setup_category_id_and_number()
        self.image_descriptions = {}
        name_to_id = {v.name: k for k, v in self.categories.items()}
        self.cate_id_check = {k: 0 for k in self.categories}
        for cate in top300:
            self.cate_id_check[name_to_id[cate[0]]] = 1
        self.category_mapping = unify
        annotations = load_annotations(
            self.paths["annotations"], self.min_object_area,
            self.category_mapping, self.category_number, self.cate_id_check)
        self.annotations = self.filter_object_number(
            annotations, self.min_object_area, self.min_objects_per_image,
            self.max_objects_per_image)
        self.image_ids = list(self.annotations.keys())
        self.clean_up_annotations_and_image_descriptions()

    def get_path_structure(self) -> Dict[str, str]:
        if self.split not in OPEN_IMAGES_STRUCTURE:
            raise ValueError(
                f"Split [{self.split}] does not exist for OpenImages.")
        return OPEN_IMAGES_STRUCTURE[self.split]

    def get_image_path(self, image_id: str) -> Path:
        return self.paths["files"].joinpath(f"{image_id:0>16}.jpg")

    def get_image_description(self, image_id: str) -> Dict[str, Any]:
        image_path = self.get_image_path(image_id)
        return {"file_path": str(image_path), "file_name": image_path.name}
