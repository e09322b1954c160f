"""Import and device hygiene of the port, and full-width weight-bridge
coverage of the t2i configuration.

- No file of ``frido_tpu_torch/`` (the training, loss, text, CLI,
  checkpoint and data modules included) and not ``chip_smoke.py`` imports
  jax, flax, optax or the JAX package, nor ``regex`` or PIL, which the
  card's machine does not have. Two exceptions for PIL, each inside a
  function and never at module level: the CPU branch of the JPEG decode
  (``data/image_io.py``, the plain version the card's decoder is held to)
  and the fixture writer ``tools/make_mini_coco.py``, which runs where PIL
  is.
- Entry points run on the card unless told otherwise: without CUDA,
  building the model without ``device="cpu"`` raises.
- On CPU tensors the kernel wrappers take their plain versions and never
  count a launch.
- Every tensor of the full-width t2i port (built on the ``meta`` device)
  gets a JAX leaf of the same shape through ``io/jax_weights.py``, and no
  JAX leaf is left over, the first stage's encoder and fusion heads
  included; so for the two full-width models ``chip_smoke.py`` builds from
  dicts: ``ddpm-pixel`` (a pixel-space DDPM with the t2i UNet's widths,
  GroupNorm ResBlocks, resblock up/down, scale-shift norm and the plain
  ``AttentionBlock``) and ``t2i-ablations`` (the t2i config with stage
  experts, mscond and position embeddings).
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
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "h5py", "frido_tpu",
             "regex", "PIL"}
# files that may import PIL inside a function
PIL_IN_FUNCTIONS = {"data/image_io.py", "tools/make_mini_coco.py",
                    "tools/make_glyphs.py"}


def _roots(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return _roots(ast.walk(tree))


def _module_level_roots(path):
    """Imports outside any function."""
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                nodes.append(child)
                visit(child)

    visit(tree)
    return _roots(nodes)


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
    assert {"text/wordpiece.py", "text/clip_bpe.py", "text/vendor.py",
            "text/__init__.py", "nn/clip.py", "nn/encoders.py",
            "io/checkpoint.py", "io/torch_import.py", "utils/visualize.py",
            "utils/profiling.py", "cli/sample_diffusion.py", "cli/main.py",
            "parallel/dist.py", "ops/cuda/jpeg.py", "data/image_io.py",
            "data/transforms.py", "data/coco.py", "data/datamodule.py",
            "tools/make_mini_coco.py", "data/vg.py", "data/vg_cocostyle.py",
            "data/open_images.py", "eval/__init__.py", "eval/inception.py",
            "eval/fid.py", "eval/metrics.py", "cli/eval_fid.py",
            "cli/eval_recon.py", "cli/train_msvqgan.py", "parallel/mesh.py",
            "parallel/tp.py", "parallel/fsdp.py", "training/image_logger.py",
            "tools/dryrun_multichip.py", "tools/make_glyphs.py",
            "io/jax_export.py", "tools/import_jax_run.py",
            "tools/jax_import_check.py", "tools/preprocess_vg_sg2im.py",
            "tools/preprocess_vg_to_sg.py",
            "tools/convert_vg_to_coco_style.py"} <= names
    pil_ok = {REPO / "frido_tpu_torch" / f for f in PIL_IN_FUNCTIONS}
    bad = {str(f.relative_to(REPO)): sorted(
               set(_imported_roots(f)) & (FORBIDDEN - {"PIL"} if f in pil_ok
                                          else FORBIDDEN))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}
    assert all("PIL" in set(_imported_roots(f)) for f in pil_ok)
    assert not any("PIL" in set(_module_level_roots(f)) for f in pil_ok)


def test_exporter_imports_no_torch_and_no_port():
    """``tools/export_jax_checkpoint.py`` runs where the JAX package is
    (the TPU host): it imports numpy and the JAX package's checkpoint
    module, and neither torch nor the port."""
    path = REPO / "tools" / "export_jax_checkpoint.py"
    roots = set(_imported_roots(path))
    assert "frido_tpu" in roots and "numpy" in roots
    assert not roots & {"torch", "frido_tpu_torch"}


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


def test_first_load_from_many_threads_builds_once(tmp_path, monkeypatch):
    """The data loader's threads may all reach the first JPEG decode at
    once: the library is compiled by one of them, once, and every thread
    gets it (a stand-in compiler and loader; no nvcc here)."""
    import ctypes
    import sys
    import threading

    from frido_tpu_torch.ops.cuda import build

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(calls)!r}, 'a').write('x')\n"
        "time.sleep(0.2)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: ("loaded", path))
    got, errors = [], []

    def load():
        try:
            got.append(build.library("jpeg_decode"))
        except Exception as e:      # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=load) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(set(got)) == 1 and len(got) == 16
    assert calls.read_text() == "x"


def _full_width(name):
    """The full-width models ``chip_smoke.py`` drives beside the configs:
    the t2i ``unet_config``'s widths with the options switched on."""
    cfg = jax_load_yaml(str(T2I))["model"]
    unet = cfg["params"]["unet_config"]["params"]
    if name == "t2i-ablations":
        unet.update(use_stage_expert=True, use_mscond=True,
                    use_pos_embed=True)
        return cfg
    pixel = dict(image_size=64, in_channels=3, out_channels=3,
                 use_split_head=False, use_SPADE_norm=False,
                 use_spatial_transformer=False, resblock_updown=True,
                 use_scale_shift_norm=True, use_new_attention_order=True,
                 num_stage=1)
    unet = {k: v for k, v in unet.items()
            if k not in ("split_embed_dim_list", "context_dim",
                         "transformer_depth")}
    unet.update(pixel)
    return {"target": "frido.models.diffusion.frido.DDPM",
            "params": dict(channels=3, image_size=64, timesteps=1000,
                           unet_config={"target": cfg["params"][
                               "unet_config"]["target"], "params": unet})}


@pytest.mark.parametrize("name", ["ddpm-pixel", "t2i-ablations"])
def test_full_width_options_bridge_covers_port(name):
    cfg = _full_width(name)
    jmodel = jax_instantiate(cfg)
    shapes = jax.eval_shape(lambda r: jmodel.init_params(r),
                            jax.random.PRNGKey(0))
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    got = {k: tuple(v.shape) for k, v in
           jax_params_to_state_dict(views).items()}
    port = instantiate_from_config(_full_width(name), device="meta")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want      # every leaf has its tensor: none is skipped
    unet = {k for k in want if k.startswith("model.diffusion_model.")}
    if name == "ddpm-pixel":
        assert port.first_stage_model is None
        assert "model.diffusion_model.input_blocks.0.0.weight" in unet
        # attention at 32^2, 16^2 and 8^2: 6 in, 1 middle, 9 out
        assert sum(".qkv." in k for k in unet) == 2 * 16
    else:
        for part in ("input_blocks_expert.1.", "attn_prev", "attn_cross",
                     "cond_proj_in", "pos_embed"):
            assert any(part in k for k in unet), part
        assert not any(".input_blocks." in k for k in unet)
