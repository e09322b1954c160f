"""Import and device hygiene of the port, and full-width weight-bridge
coverage of the t2i configuration.

- No file of ``frido_tpu_torch/`` (the training and loss modules
  included) and not ``chip_smoke.py`` imports jax, flax, optax or the JAX
  package.
- Entry points run on the card unless told otherwise: without CUDA,
  building the model without ``device="cpu"`` raises.
- On CPU tensors the kernel wrappers take their plain versions and never
  count a launch.
- Every tensor of the full-width t2i port (built on the ``meta`` device)
  gets a JAX leaf of the same shape through ``io/jax_weights.py``, and no
  JAX leaf is left over, the first stage's encoder and fusion heads
  included.
  The JAX shapes come from ``jax.eval_shape``, with nothing allocated.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.config import load_yaml as jax_load_yaml
from frido_tpu_torch.config import instantiate_from_config, load_yaml
from frido_tpu_torch.io.jax_weights import jax_params_to_state_dict
from frido_tpu_torch.nn.transformer import dot_attention
from frido_tpu_torch.ops.cuda.attention import flash_attention
from frido_tpu_torch.ops.cuda.vq import vq_argmin
from frido_tpu_torch.ops.vq import vq_lookup

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
T2I = REPO / "configs" / "frido" / "t2i" / "frido_f16f8_coco.yaml"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "frido_tpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "frido_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    names = {str(f.relative_to(REPO / "frido_tpu_torch")) for f in files
             if "frido_tpu_torch" in f.parts}
    assert {f"training/{m}.py" for m in ("optim", "ema", "trainer",
                                         "vqgan_trainer")} <= names
    assert {f"losses/{m}.py" for m in ("discriminator", "lpips",
                                       "vqperceptual")} <= names
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f))
                                           & FORBIDDEN)
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_yaml(str(T2I))["model"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        instantiate_from_config(cfg)


def test_cpu_wrappers_take_plain_path():
    before = (flash_attention.launches, vq_argmin.launches)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 520, 8), np.float32))
    z = torch.from_numpy(rng.standard_normal((2, 4, 4, 4), np.float32))
    book = torch.from_numpy(rng.standard_normal((64, 4), np.float32))
    flash_attention(q, q, q, 0.3)
    dot_attention(q, q, q, 0.3)    # kv >= 512: the kernel's site on CUDA
    vq_argmin(z.reshape(-1, 4), book)
    vq_lookup(z, book)
    assert (flash_attention.launches, vq_argmin.launches) == before
    if not torch.cuda.is_available():
        assert before == (0, 0)


def test_full_width_weight_bridge_covers_port():
    jmodel = jax_instantiate(jax_load_yaml(str(T2I))["model"])
    shapes = jax.eval_shape(lambda r: jmodel.init_params(r),
                            jax.random.PRNGKey(0))
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    state = jax_params_to_state_dict(views)

    port = instantiate_from_config(load_yaml(str(T2I))["model"],
                                   device="meta")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    assert got == want      # every leaf has its tensor: none is skipped
    assert sum(np.prod(s) for s in want.values()) > 7e8
    assert {k.split(".")[1] for k in got
            if k.startswith("first_stage_model.")} == {
        "encoder", "decoder", "ms_quantize", "ms_quant_conv",
        "post_quant_conv", "upsample", "shared_post_quant_conv",
        "shared_decoder"}
