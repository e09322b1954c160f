"""Visual Genome dataset over the scene-graph caption JSON (port of
``frido_tpu/data/vg.py``).

The image records and the sg2i captions come from the COCO-style caption
JSON that ``scripts/preprocess_vg_to_sg.py`` writes (``images``,
``annotations``); a sample has no boxes and, as in the JAX package, no
builder rows. With ``caption_ann_path`` a
sample's caption is one of its image's, chosen in :meth:`plan` with the
dataset's :attr:`rng` (the global ``random`` unless set), as the JAX
package chooses it with the global ``random`` on every read.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Any, Dict, List

from frido_tpu_torch.data.annotated_objects import AnnotatedObjectsDataset
from frido_tpu_torch.data.coco import index_image_records

VG_PATH_STRUCTURE = {
    "train": {"top_level": "", "image_data": "image_data.json",
              "files": "VG_100K"},
    "validation": {"top_level": "", "image_data": "image_data.json",
                   "files": "VG_100K"},
}


class AnnotatedObjectsVg(AnnotatedObjectsDataset):
    def __init__(self, use_things: bool = True, use_stuff: bool = True,
                 caption_ann_path: str = None, specific_img_ids=(), **kwargs):
        super().__init__(**kwargs)
        self.caption_ann_path = caption_ann_path
        with open(caption_ann_path) as f:
            caption_data_json = json.load(f)
        self._setup_caption(caption_data_json)
        self.image_descriptions = index_image_records(
            caption_data_json["images"])
        self.image_ids = sorted(
            str(img["id"]) for img in caption_data_json["images"])
        self.annotations = {i: [] for i in self.image_ids}
        if specific_img_ids:
            self.image_ids = [i for i in self.image_ids
                              if any(s in i for s in specific_img_ids)]

    def _setup_caption(self, caption_data_json) -> None:
        m: Dict[str, List[str]] = {}
        for ann in caption_data_json["annotations"]:
            m.setdefault(str(ann["image_id"]), []).append(
                ann["caption"].replace(".", ""))
        self.img_id_to_caption_list = m

    def get_path_structure(self) -> Dict[str, str]:
        if self.split not in VG_PATH_STRUCTURE:
            raise ValueError(f"Split [{self.split}] does not exist for VG.")
        return VG_PATH_STRUCTURE[self.split]

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
            sample["caption"] = (random if self.rng is None else
                                 self.rng).choice(
                self.get_image_caption(self.get_image_id(n)))
        return sample
