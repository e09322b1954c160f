"""Layout -> token-sequence conditional builders (a copy of
``frido_tpu/data/conditional_builder.py``).

Center points, bounding boxes and class-only sequences. Each builder turns
a ragged list of annotations into a fixed-length int64 numpy vector (the
pad token is ``no_tokens - 1``) on the host. ``build`` shuffles the
annotations with the global ``random`` module, as the JAX package does,
or with the ``random.Random`` it is given; the port's loader calls it in
index order on one thread.
"""

from __future__ import annotations

import math
import random
import warnings
from typing import List, Optional, Tuple

import numpy as np

from frido_tpu_torch.data.helper_types import Annotation, BoundingBox

FULL_CROP: BoundingBox = (0.0, 0.0, 1.0, 1.0)


def intersection_area(r1: BoundingBox, r2: BoundingBox) -> float:
    a = (r1[0], r1[1], r1[0] + r1[2], r1[1] + r1[3])
    b = (r2[0], r2[1], r2[0] + r2[2], r2[1] + r2[3])
    x = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    y = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    return x * y


def horizontally_flip_bbox(bbox: BoundingBox) -> BoundingBox:
    return 1 - (bbox[0] + bbox[2]), bbox[1], bbox[2], bbox[3]


def rescale_annotations(annotations: List[Annotation],
                        crop_coordinates: BoundingBox,
                        flip: bool) -> List[Annotation]:
    """Remap bboxes into crop-relative coords (``utils.py:44-59``)."""

    def clamp(x: float) -> float:
        return max(min(x, 1.0), 0.0)

    def rescale(bbox: BoundingBox) -> BoundingBox:
        x0 = clamp((bbox[0] - crop_coordinates[0]) / crop_coordinates[2])
        y0 = clamp((bbox[1] - crop_coordinates[1]) / crop_coordinates[3])
        w = min(bbox[2] / crop_coordinates[2], 1 - x0)
        h = min(bbox[3] / crop_coordinates[3], 1 - y0)
        if flip:
            x0 = 1 - (x0 + w)
        return x0, y0, w, h

    return [a._replace(bbox=rescale(a.bbox)) for a in annotations]


def filter_annotations(annotations: List[Annotation],
                       crop_coordinates: BoundingBox) -> List[Annotation]:
    return [a for a in annotations
            if intersection_area(a.bbox, crop_coordinates) > 0.0]


class ObjectsCenterPointsConditionalBuilder:
    """class-token + center-position token on a sqrt(no_tokens) grid
    (``objects_center_points.py:17-171``)."""

    def __init__(self, no_object_classes: int, no_max_objects: int,
                 no_tokens: int, encode_crop: bool, use_group_parameter: bool,
                 use_additional_parameters: bool = False,
                 shifting_cls_num: int = 0):
        self.no_object_classes = no_object_classes
        self.no_max_objects = no_max_objects
        self.no_tokens = no_tokens
        self.shifting_cls_num = shifting_cls_num
        self.encode_crop = encode_crop
        self.no_sections = int(math.sqrt(no_tokens))
        self.use_group_parameter = use_group_parameter
        self.use_additional_parameters = use_additional_parameters

    @property
    def none(self) -> int:
        return self.no_tokens - 1

    @property
    def object_descriptor_length(self) -> int:
        return 2

    @property
    def embedding_dim(self) -> int:
        extra = 2 if self.encode_crop else 0
        return self.no_max_objects * self.object_descriptor_length + extra

    def tokenize_coordinates(self, x: float, y: float) -> int:
        xd = int(round(x * (self.no_sections - 1)))
        yd = int(round(y * (self.no_sections - 1)))
        return yd * self.no_sections + xd

    def coordinates_from_token(self, token: int) -> Tuple[float, float]:
        x = (token - self.shifting_cls_num) % self.no_sections
        y = (token - self.shifting_cls_num) // self.no_sections
        return x / (self.no_sections - 1), y / (self.no_sections - 1)

    def token_pair_from_bbox(self, bbox: BoundingBox) -> Tuple[int, int]:
        return (self.tokenize_coordinates(bbox[0], bbox[1])
                + self.shifting_cls_num,
                self.tokenize_coordinates(bbox[0] + bbox[2], bbox[1] + bbox[3])
                + self.shifting_cls_num)

    def bbox_from_token_pair(self, t1: int, t2: int) -> BoundingBox:
        x0, y0 = self.coordinates_from_token(t1)
        x1, y1 = self.coordinates_from_token(t2)
        return x0, y0, x1 - x0, y1 - y0

    def object_representation(self, a: Annotation) -> int:
        modifier = 0
        if self.use_group_parameter:
            modifier |= 1 * (a.is_group_of is True)
        if self.use_additional_parameters:
            modifier |= 2 * (a.is_occluded is True)
            modifier |= 4 * (a.is_depiction is True)
            modifier |= 8 * (a.is_inside is True)
        return a.category_no + self.no_object_classes * modifier

    def representation_to_annotation(self, representation: int) -> Annotation:
        category_no = representation % self.no_object_classes
        modifier = representation // self.no_object_classes
        return Annotation(
            area=None, image_id=None, bbox=None, category_id=None, id=None,
            category_no=category_no,
            is_group_of=bool((modifier & 1) * self.use_group_parameter),
            is_occluded=bool((modifier & 2) * self.use_additional_parameters),
            is_depiction=bool((modifier & 4) * self.use_additional_parameters),
            is_inside=bool((modifier & 8) * self.use_additional_parameters),
        )

    def _crop_encoder(self, crop_coordinates: BoundingBox) -> List[int]:
        return list(self.token_pair_from_bbox(crop_coordinates))

    def _make_object_descriptors(self, annotations: List[Annotation]):
        tuples = [
            (self.object_representation(a),
             self.tokenize_coordinates(a.bbox[0] + a.bbox[2] / 2,
                                       a.bbox[1] + a.bbox[3] / 2))
            for a in annotations
        ]
        pad = (self.none,) * self.object_descriptor_length
        return tuples + [pad] * (self.no_max_objects - len(tuples))

    def build(self, annotations: List[Annotation],
              crop_coordinates: Optional[BoundingBox] = None,
              horizontal_flip: bool = False,
              rng: Optional[random.Random] = None) -> np.ndarray:
        if len(annotations) == 0:
            warnings.warn("Did not receive any annotations.")
        if len(annotations) > self.no_max_objects:
            warnings.warn("Received more annotations than allowed.")
            annotations = annotations[: self.no_max_objects]
        if not crop_coordinates:
            crop_coordinates = FULL_CROP
        annotations = list(annotations)
        (random if rng is None else rng).shuffle(annotations)
        annotations = filter_annotations(annotations, crop_coordinates)
        if self.encode_crop:
            annotations = rescale_annotations(annotations, FULL_CROP,
                                              horizontal_flip)
            if horizontal_flip:
                crop_coordinates = horizontally_flip_bbox(crop_coordinates)
            extra = self._crop_encoder(crop_coordinates)
        else:
            annotations = rescale_annotations(annotations, crop_coordinates,
                                              horizontal_flip)
            extra = []
        tuples = self._make_object_descriptors(annotations)
        flat = [tok for tup in tuples for tok in tup] + extra
        assert len(flat) == self.embedding_dim
        assert all(0 <= v < self.no_tokens + self.shifting_cls_num
                   for v in flat)
        return np.asarray(flat, dtype=np.int64)

    def inverse_build(self, conditional: np.ndarray):
        tokens = list(np.asarray(conditional).tolist())
        crop_coordinates = None
        if self.encode_crop:
            crop_coordinates = self.bbox_from_token_pair(tokens[-2], tokens[-1])
            tokens = tokens[:-2]
        n = self.object_descriptor_length
        groups = [tuple(tokens[i:i + n]) for i in range(0, len(tokens), n)]
        return [
            (g[0], self.coordinates_from_token(g[1]))
            for g in groups if g[0] != self.none
        ], crop_coordinates


class ObjectsBoundingBoxConditionalBuilder(ObjectsCenterPointsConditionalBuilder):
    """(class, top-left, bottom-right) token triples
    (``objects_bbox.py:15-60``)."""

    @property
    def object_descriptor_length(self) -> int:
        return 3

    def _make_object_descriptors(self, annotations: List[Annotation]):
        triples = [
            (self.object_representation(a), *self.token_pair_from_bbox(a.bbox))
            for a in annotations
        ]
        pad = (self.none,) * 3
        return triples + [pad] * (self.no_max_objects - len(triples))

    def inverse_build(self, conditional: np.ndarray):
        tokens = list(np.asarray(conditional).tolist())
        crop_coordinates = None
        if self.encode_crop:
            crop_coordinates = self.bbox_from_token_pair(tokens[-2], tokens[-1])
            tokens = tokens[:-2]
        groups = [tuple(tokens[i:i + 3]) for i in range(0, len(tokens), 3)]
        return [
            (g[0], self.bbox_from_token_pair(g[1], g[2]))
            for g in groups if g[0] != self.none
        ], crop_coordinates


class ObjectsConditionalBuilder(ObjectsCenterPointsConditionalBuilder):
    """class-token-only sequence for label2i (``objects_bbox.py:63-94``)."""

    @property
    def object_descriptor_length(self) -> int:
        return 1

    def _make_object_descriptors(self, annotations: List[Annotation]):
        singles = [(self.object_representation(a),) for a in annotations]
        return singles + [(self.none,)] * (self.no_max_objects - len(singles))

    def inverse_build(self, conditional: np.ndarray):
        tokens = list(np.asarray(conditional).tolist())
        return [t for t in tokens if t != self.none], None
