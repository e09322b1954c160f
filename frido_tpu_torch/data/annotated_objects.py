"""The annotated-objects dataset (port of
``frido_tpu/data/annotated_objects.py``).

Path-structure checks, category filtering and numbering, min/max-objects
filtering, the lazy conditional builders and the sample dict restricted to
``keys``, as the JAX package has them. A sample is made in two parts:

- :meth:`AnnotatedObjectsDataset.plan` on the host: the image's record,
  its annotations, the crop and flip drawn from the pipeline (the width
  and height read from the file's header, no decode) and the conditional
  builders' rows (``build`` shuffles with :attr:`rng`: the global
  ``random`` unless the caller gives the dataset a ``random.Random`` of
  its own, as the training CLI does). The loader calls it in index order
  on one thread, so the draws are deterministic for any number of
  workers, and equal the JAX package's where it runs one worker; a
  resumed loader draws the plans of the batches it skips again, without
  their pixels (``data/datamodule.py``);
- :meth:`AnnotatedObjectsDataset.load`: the decode and the pixel work on
  the dataset's ``device`` (``data/image_io.py``, ``data/transforms.py``),
  in any thread.

``__getitem__`` is ``load(plan(n))``. The dataset runs on the card unless
``device`` says otherwise; the image is float32 [S, S, 3] in [-1, 1] there.
"""

from __future__ import annotations

import importlib
import random
import struct
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from frido_tpu_torch.data.conditional_builder import (
    ObjectsBoundingBoxConditionalBuilder,
    ObjectsCenterPointsConditionalBuilder,
    ObjectsConditionalBuilder,
)
from frido_tpu_torch.data.helper_types import Annotation
from frido_tpu_torch.data.image_io import image_size, load_rgb
from frido_tpu_torch.data.transforms import ImagePipeline
from frido_tpu_torch.device import resolve_device

# a header within the first bytes of a file, else the whole file is read
_HEADER_BYTES = 1 << 16


def load_object_from_string(object_string: str) -> Any:
    """A module attribute named by a dotted path; only the port's own
    objects (``frido_tpu_torch.*``) resolve."""
    module_name, class_name = object_string.rsplit(".", 1)
    if not module_name.startswith("frido_tpu_torch."):
        raise ValueError(f"{object_string!r} is not an object of "
                         f"frido_tpu_torch")
    return getattr(importlib.import_module(module_name), class_name)


def header_size(path: str):
    """(width, height) from the file's header, without a decode."""
    with open(path, "rb") as f:
        head = f.read(_HEADER_BYTES)
    try:
        return image_size(head, path)
    except (ValueError, struct.error):
        with open(path, "rb") as f:
            return image_size(f.read(), path)


class AnnotatedObjectsDataset:
    def __init__(self, data_path: Union[str, Path], split: str,
                 keys: List[str], target_image_size: int,
                 min_object_area: float, min_objects_per_image: int,
                 max_objects_per_image: int, crop_method: Optional[str],
                 random_flip: bool, no_tokens: int, use_group_parameter: bool,
                 encode_crop: bool, category_allow_list_target: str = "",
                 category_mapping_target: str = "",
                 no_object_classes: Optional[int] = None,
                 shifting_cls_num: int = 0, device=None):
        self.data_path = data_path
        self.split = split
        self.keys = keys
        self.target_image_size = target_image_size
        self.min_object_area = min_object_area
        self.min_objects_per_image = min_objects_per_image
        self.max_objects_per_image = max_objects_per_image
        self.crop_method = crop_method
        self.random_flip = random_flip
        self.no_tokens = no_tokens
        self.use_group_parameter = use_group_parameter
        self.encode_crop = encode_crop
        self.shifting_cls_num = shifting_cls_num
        self.device = resolve_device(device)

        self.annotations: Optional[Dict[str, List[Annotation]]] = None
        self.image_descriptions = None
        self.categories = None
        self.category_ids = None
        self.category_number = None
        self.image_ids: Optional[List[str]] = None
        self.pipeline = (ImagePipeline(target_image_size, crop_method,
                                       random_flip)
                         if crop_method is not None else None)
        self.paths = self.build_paths(self.data_path)
        self._conditional_builders = None
        # the builders' shuffles (and VG's caption choice): None is the
        # global ``random``, as in the JAX package
        self.rng: Optional[random.Random] = None
        self._sizes: Dict[str, Any] = {}
        self.category_allow_list = None
        if category_allow_list_target:
            allow_list = load_object_from_string(category_allow_list_target)
            self.category_allow_list = {name for name, _ in allow_list}
        self.category_mapping = {}
        if category_mapping_target:
            self.category_mapping = load_object_from_string(
                category_mapping_target)
        self.no_object_classes = no_object_classes

    def build_paths(self, top_level: Union[str, Path]) -> Dict[str, Path]:
        top_level = Path(top_level)
        sub_paths = {name: top_level.joinpath(sub)
                     for name, sub in self.get_path_structure().items()}
        for path in sub_paths.values():
            if not path.exists():
                raise FileNotFoundError(
                    f"{type(self).__name__} data structure error: "
                    f"[{path}] does not exist.")
        return sub_paths

    @property
    def no_classes(self) -> int:
        return (self.no_object_classes if self.no_object_classes
                else len(self.categories))

    @property
    def conditional_builders(self) -> Dict[str, Any]:
        if self._conditional_builders is None:
            use_extra = getattr(self, "use_additional_parameters", False)
            self._conditional_builders = {
                "objects_center_points": ObjectsCenterPointsConditionalBuilder(
                    self.no_classes, self.max_objects_per_image,
                    self.no_tokens, self.encode_crop,
                    self.use_group_parameter, use_extra),
                "objects_bbox": ObjectsBoundingBoxConditionalBuilder(
                    self.no_classes, self.max_objects_per_image,
                    self.no_tokens, self.encode_crop,
                    self.use_group_parameter, use_extra,
                    self.shifting_cls_num),
                "objects": ObjectsConditionalBuilder(
                    self.no_classes, self.max_objects_per_image,
                    self.no_tokens, self.encode_crop,
                    self.use_group_parameter, use_extra),
            }
        return self._conditional_builders

    def filter_categories(self) -> None:
        if self.category_allow_list:
            self.categories = {i: c for i, c in self.categories.items()
                               if c.name in self.category_allow_list}
        if self.category_mapping:
            self.categories = {i: c for i, c in self.categories.items()
                               if c.id not in self.category_mapping}

    def setup_category_id_and_number(self) -> None:
        self.category_ids = sorted(self.categories.keys())
        # OpenImages 'tortoise' pinned last for checkpoint-compatible
        # numbering (annotated_objects_dataset.py:176-178)
        if "/m/01s55n" in self.category_ids:
            self.category_ids.remove("/m/01s55n")
            self.category_ids.append("/m/01s55n")
        if getattr(self, "categories_append", None):
            appended = sorted(self.categories_append.keys())
            self.category_ids += appended
            self.categories = {**self.categories, **self.categories_append}
        self.category_number = {cid: i
                                for i, cid in enumerate(self.category_ids)}
        if (self.category_allow_list is not None
                and not self.category_mapping
                and len(self.category_ids) != len(self.category_allow_list)):
            warnings.warn("Unexpected number of categories: mismatch with "
                          "category_allow_list.")

    def clean_up_annotations_and_image_descriptions(self) -> None:
        image_id_set = set(self.image_ids)
        self.annotations = {k: v for k, v in self.annotations.items()
                            if k in image_id_set}
        self.image_descriptions = {k: v
                                   for k, v in self.image_descriptions.items()
                                   if k in image_id_set}

    @staticmethod
    def filter_object_number(all_annotations, min_object_area,
                             min_objects_per_image, max_objects_per_image):
        filtered = {}
        for image_id, annotations in all_annotations.items():
            big = [a for a in annotations if a.area > min_object_area]
            if min_objects_per_image <= len(big) <= max_objects_per_image:
                filtered[image_id] = big
        return filtered

    def __len__(self):
        return len(self.image_ids)

    def _base_sample(self, n: int) -> Dict[str, Any]:
        """The record, the annotations and, with ``image`` in ``keys``,
        the path and the pipeline's plan (``_spec``)."""
        image_id = self.get_image_id(n)
        sample = self.get_image_description(image_id)
        sample["annotations"] = self.get_annotation(image_id)
        sample["crop_bbox"] = None
        sample["flipped"] = None
        if "image" in self.keys:
            path = str(self.get_image_path(image_id))
            sample["image_path"] = path
            if path not in self._sizes:     # read once: a resume replans
                self._sizes[path] = header_size(path)
            (sample["_spec"], sample["crop_bbox"],
             sample["flipped"]) = self.pipeline.spec(*self._sizes[path])
        return sample

    def _build_conditionals(self, sample: Dict[str, Any]) -> None:
        for conditional, builder in self.conditional_builders.items():
            if conditional in self.keys:
                sample[conditional] = builder.build(
                    sample["annotations"], sample["crop_bbox"],
                    sample["flipped"], rng=self.rng)

    def plan(self, n: int) -> Dict[str, Any]:
        """Everything of sample ``n`` but its pixels, on the host."""
        sample = self._base_sample(n)
        self._build_conditionals(sample)
        return sample

    def load(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        """A plan's pixels: decode and pipeline on ``device``; the sample
        restricted to ``keys``."""
        spec = sample.pop("_spec", None)
        if spec is not None:
            img = load_rgb(sample["image_path"], self.device)
            sample["image"] = self.pipeline.apply(img, spec)
        if self.keys:
            sample = {k: sample[k] for k in self.keys}
        return sample

    def __getitem__(self, n: int) -> Dict[str, Any]:
        return self.load(self.plan(n))

    # --- id/category accessors (same surface as the reference) -----------
    def get_image_id(self, no: int) -> str:
        return self.image_ids[no]

    def get_annotation(self, image_id: str):
        return self.annotations[image_id]

    def get_textual_label_for_category_id(self, category_id: str) -> str:
        return self.categories[category_id].name

    def get_textual_label_for_category_no(self, category_no: int) -> str:
        return self.categories[self.get_category_id(category_no)].name

    def get_category_number(self, category_id: str) -> int:
        return self.category_number[category_id]

    def get_category_id(self, category_no: int) -> str:
        return self.category_ids[category_no]

    def get_image_description(self, image_id: str) -> Dict[str, Any]:
        raise NotImplementedError

    def get_path_structure(self):
        raise NotImplementedError

    def get_image_path(self, image_id: str) -> Path:
        raise NotImplementedError
