"""Visual Genome boxes in COCO-style JSON for layout2i (port of
``frido_tpu/data/vg_cocostyle.py``): the COCO dataset over the
``*_coco_style.json`` files that ``scripts/convert_vg_to_coco_style.py``
writes."""

from __future__ import annotations

from typing import Dict

from frido_tpu_torch.data.coco import AnnotatedObjectsCoco

VG_COCOSTYLE_PATH_STRUCTURE = {
    "train": {"top_level": "",
              "instances_annotations": "train_coco_style.json",
              "files": "VG_100K"},
    "validation": {"top_level": "",
                   "instances_annotations": "val_coco_style.json",
                   "files": "VG_100K"},
}


class AnnotatedObjectsVgCocoStyle(AnnotatedObjectsCoco):
    def get_path_structure(self) -> Dict[str, str]:
        if self.split not in VG_COCOSTYLE_PATH_STRUCTURE:
            raise ValueError(
                f"Split [{self.split}] does not exist for VG-cocostyle.")
        return VG_COCOSTYLE_PATH_STRUCTURE[self.split]
