"""The port's VG preprocessing (``frido_tpu_torch/tools/
preprocess_vg_sg2im.py``, ``preprocess_vg_to_sg.py``,
``convert_vg_to_coco_style.py``: ``.npz`` instead of ``.h5``, no h5py)
against the JAX package's scripts (``scripts/``, run as subprocesses here,
where h5py is), with the same flags on the same dump: ``tests/
test_vg_preprocess.py``'s synthetic dump and a seeded one
(``tools/make_mini_coco.write_vg_raw``: repeated object names, several
relationships, small and rare objects, attributes and aliases). Exact: ``vocab.json``, ``{split}_sg.json`` and
``{split}_coco_style.json`` byte for byte, and every array of the port's
``{split}.npz`` equal to the h5 dataset of the same name (dtype, shape and
values; read with h5py in this test only).
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from frido_tpu_torch.tools import (convert_vg_to_coco_style,
                                   preprocess_vg_sg2im, preprocess_vg_to_sg)
from frido_tpu_torch.tools.make_mini_coco import write_vg_raw
from tests.test_vg_preprocess import vg_root  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FLAGS = ["--min_object_instances", "2", "--min_attribute_instances", "2",
         "--min_relationship_instances", "2", "--min_objects_per_image", "2"]


@pytest.fixture(params=["test_vg_preprocess", "seeded"])
def dump(request, tmp_path):
    """(the dump's directory, the extra flags for it)."""
    if request.param == "seeded":
        root = tmp_path / "dump"
        flags = write_vg_raw(str(root))
        return root, [x for kv in flags.items() for x in kv]
    return request.getfixturevalue("vg_root"), []


def _jax_script(name, *args):
    r = subprocess.run([sys.executable, str(REPO / "scripts" / name), *args],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_port_tools_equal_the_jax_scripts(dump, tmp_path):
    src, extra = dump
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    for d in (jax_dir, port_dir):
        shutil.copytree(src, d)
    _jax_script("preprocess_vg_sg2im.py", "--vg_dir", str(jax_dir), *FLAGS,
                *extra)
    preprocess_vg_sg2im.main(["--vg_dir", str(port_dir), *FLAGS, *extra])
    assert (port_dir / "vocab.json").read_bytes() == \
        (jax_dir / "vocab.json").read_bytes()
    splits = sorted(p.stem for p in jax_dir.glob("*.h5"))
    assert {"train", "val"} <= set(splits)
    assert splits == sorted(p.stem for p in port_dir.glob("*.npz"))
    for split in splits:
        with h5py.File(jax_dir / f"{split}.h5", "r") as f, \
                np.load(port_dir / f"{split}.npz") as g:
            assert sorted(f.keys()) == sorted(g.files)
            for k in f.keys():
                want, got = f[k][...], g[k]
                assert got.dtype == want.dtype, (split, k)
                assert got.shape == want.shape, (split, k)
                np.testing.assert_array_equal(got, want, err_msg=k)
            if extra and split == "train":
                assert (g["object_names"] == -1).any()     # rows padded
    for split in ("train", "val"):
        for script, tool, out in (
                ("preprocess_vg_to_sg.py", preprocess_vg_to_sg,
                 f"{split}_sg.json"),
                ("convert_vg_to_coco_style.py", convert_vg_to_coco_style,
                 f"{split}_coco_style.json")):
            _jax_script(script, "-b", str(jax_dir), "-s", split)
            tool.main(["-b", str(port_dir), "-s", split])
            assert (port_dir / out).read_bytes() == \
                (jax_dir / out).read_bytes(), out
    if extra:
        caps = json.loads((port_dir / "train_sg.json").read_text())
        assert any(" A " in a["caption"]
                   for a in caps["annotations"])     # a repeated name
