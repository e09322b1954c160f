"""The traffic generator: the same seed gives the same batches, every
seed the same sizes."""

import numpy as np
import pytest
import torch

from harness import registry, traffic as tr

BIG = 2 ** 31 + 12345


def _mix(name):
    return registry.cell(name, registry.benchmark()).traffic


@pytest.mark.parametrize("cell", ["t2i.sample", "layout2i.sample"])
def test_conditions_repeat_per_seed(cell):
    t = _mix(cell)
    a, ua = tr.conditions(t, BIG, 3)
    b, ub = tr.conditions(t, BIG, 3)
    c, _ = tr.conditions(t, BIG + 1, 3)
    d, _ = tr.conditions(t, BIG, 4)
    assert np.array_equal(a, b) and np.array_equal(ua, ub)
    assert a.shape == c.shape == d.shape
    assert not np.array_equal(a, c) and not np.array_equal(a, d)


def test_captions_are_wordpiece_rows():
    t = _mix("t2i.sample")
    spec = t["cond"]
    tok, utok = tr.conditions(t, BIG, 0)
    assert tok.shape == (t["batch"], 77) and tok.dtype == np.int32
    for row in tok:
        n = int((row != spec["pad"]).sum())
        assert 10 <= n <= 26 and row[0] == 101 and row[n - 1] == 102
        assert ((row[1:n - 1] >= 999) & (row[1:n - 1] < 30522)).all()
    assert (utok[:, :2] == [101, 102]).all() and (utok[:, 2:] == 0).all()


def test_layouts_are_builder_rows():
    t = _mix("layout2i.sample")
    spec = t["cond"]
    tok, utok = tr.conditions(t, BIG, 0)
    assert tok.shape == (t["batch"], 3 * spec["max_objects"] + 2)
    assert (utok == 0).all()
    none = spec["no_tokens"] - 1
    for row in tok:
        triples = row[:-2].reshape(-1, 3)
        real = triples[triples[:, 0] != none]
        assert spec["min_objects"] <= len(real) <= spec["max_objects"]
        assert (real[:, 0] < spec["classes"]).all()
        assert (real[:, 1] <= real[:, 2]).all()
        assert (triples[len(real):] == none).all()
        assert list(row[-2:]) == [0, none]


def test_images_repeat_per_seed():
    t = {"image_size": 8}
    a = tr.images(t, BIG, 4, "cpu")
    b = tr.images(t, BIG, 4, "cpu")
    assert torch.equal(a, b) and a.shape == (4, 8, 8, 3)
    assert a.min() >= -1 and a.max() <= 1
    assert not torch.equal(a, tr.images(t, BIG + 1, 4, "cpu"))
