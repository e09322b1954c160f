"""The layout2i f8f4 task in the port against the JAX package, on the CPU.

- A toy layout2i-shaped FridoDiffusion in both packages (the split
  [3, 3], codebooks of K = 4096 with D = 3, a three-level decoder whose
  first resolution carries attention, a token window of 24 instead of 77),
  seeded numpy weights as in ``tests/test_torch_models.py``: token ids ->
  BERT context -> DPM-Solver++(2M) with CFG 1.5 -> MS-VQGAN decode.
- The full-width layout2i, label2i and sg2i configs built on the ``meta``
  device: every tensor gets a JAX leaf of the same name and shape through
  ``io/jax_weights.py`` (shapes by ``jax.eval_shape``, nothing allocated).
- Every kernel site of the full-width layout2i path, found by a ``meta``
  run of the model (UNet at batch 4 in bf16, both stages; decode at
  batches 4 and 32 in fp32; BERT over 96 tokens): each site's host plan
  (``flash_plan``, ``smalls_plan``, ``vq_plan``, ``conv_plan``,
  ``group_norm_plan``) covers its output once and fits the shared memory,
  checked as the numerics tests check the t2i sites.

Tolerances, fixed before the comparison, are those of
``tests/test_torch_models.py``: 1e-4 absolute for the BERT context, 1e-3
for the sampled latent (four UNet evaluations per stage, each two calls
under CFG), 3e-4 for the decoded image; VQ codes must agree wherever the
best and second-best distances differ by more than 1e-5.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frido_tpu.config import instantiate_from_config as jax_instantiate
from frido_tpu.config import load_yaml as jax_load_yaml
from frido_tpu_torch.config import instantiate_from_config, load_yaml
from frido_tpu_torch.io.jax_weights import (jax_params_to_state_dict,
                                            load_jax_params)
from frido_tpu_torch.nn import transformer
from frido_tpu_torch.nn.layers import Conv2d, GroupNorm
from frido_tpu_torch.nn.pyunet import ResBlock
from frido_tpu_torch.ops import vq as ops_vq
from frido_tpu_torch.ops.cuda import dispatch
from frido_tpu_torch.ops.cuda.attention import (MAX_SMEM, flash_plan,
                                                smalls_plan)
from tests.test_torch_attention_numerics import _coverage
from tests.test_torch_conv_numerics import _check_plan
from tests.test_torch_models import _jitted, _random_params
from tests.test_torch_norm_vq_numerics import (
    test_group_norm_plan_covers_every_element_once as _check_gn_plan,
    test_vq_plan_parts_cover_the_codebook_once as _check_vq_plan)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = {name: REPO / "configs" / "frido" / path for name, path in (
    ("layout2i", "layout2i/frido_f8f4_coco_seg.yaml"),
    ("label2i", "label2i/frido_f16f8_coco.yaml"),
    ("sg2i", "sg2i/frido_f16f8_coco.yaml"))}

CTX_LEN = 24
UNET = dict(use_split_head=True, split_embed_dim_list=[3, 3],
            use_SPADE_norm=True, image_size=16, in_channels=6,
            out_channels=6, model_channels=32, attention_resolutions=[2],
            num_res_blocks=1, channel_mult=[1, 2], num_head_channels=32,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=32, num_stage=2)
ED = dict(multiscale=2, double_z=False, z_channels=[3, 3], resolution=64,
          in_channels=3, out_ch=3, ch=32, ch_mult=[1, 1, 2],
          num_res_blocks=1, attn_resolutions=[16], dropout=0.0)
# three levels; the first (16^2, the latent's) carries the attention, as
# layout2i's decoder does at 64^2
DD = dict(double_z=False, z_channels=6, resolution=64, in_channels=3,
          out_ch=3, ch=32, ch_mult=[1, 2, 2], num_res_blocks=1,
          attn_resolutions=[16], dropout=0.0)
CONFIG = {
    "target": "frido.models.diffusion.frido.FridoDiffusion",
    "params": dict(
        adopted_scale_factor=True, adopted_scale_factor_value=[0.9, 1.2],
        linear_start=0.0015, linear_end=0.0155, timesteps=40,
        image_size=16, channels=6, conditioning_key="crossattn",
        unet_config=dict(target="frido.modules.diffusionmodules.pyunet."
                                "PyUNetModel", params=UNET),
        first_stage_config=dict(
            target="taming.models.msvqgan.VQModelInterface",
            params=dict(embed_dim=[3, 3], n_embed=[4096, 4096], edconfig=ED,
                        ddconfig=DD,
                        lossconfig={"target":
                                    "taming.modules.losses.DummyLoss"})),
        cond_stage_config=dict(
            target="frido.modules.encoders.modules.BERTEmbedder",
            params=dict(n_embed=32, n_layer=1, vocab_size=100,
                        max_seq_len=CTX_LEN, use_tokenizer=False)),
    ),
}


@pytest.fixture(scope="module")
def models():
    jmodel = jax_instantiate(CONFIG)
    shapes = jax.eval_shape(
        lambda r: jmodel.init_params(r, context_len=CTX_LEN),
        jax.random.PRNGKey(0))
    np_params = _random_params(shapes, np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    port = instantiate_from_config(CONFIG, device="cpu")
    load_jax_params(port, np_params)
    return jmodel, jparams, port


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _decided(z, codebook):
    d = (codebook.astype(np.float64) ** 2).sum(1)[None] \
        - 2 * z.reshape(-1, z.shape[-1]).astype(np.float64) \
        @ codebook.astype(np.float64).T
    top2 = np.sort(d, axis=1)[:, :2]
    return ((top2[:, 1] - top2[:, 0]) > 1e-5).reshape(z.shape[:-1])


def test_layout2i_chain_matches_jax(models):
    """bbox token ids -> context -> DPM-Solver++(2M), 4 steps, CFG 1.5
    sequential -> decode, in both packages; the JAX latent then goes
    through both decoders, so that a near-tie code flip in sampling cannot
    reach the image comparison."""
    jmodel, jparams, port = models
    tokens = np.random.default_rng(7).integers(0, 100, (2, CTX_LEN),
                                               dtype=np.int32)
    utokens = np.zeros_like(tokens)
    cond = _jitted(jmodel, "get_learned_conditioning")
    ctx_j = cond(jparams, jnp.asarray(tokens))
    uctx_j = cond(jparams, jnp.asarray(utokens))
    ctx_p = port.get_learned_conditioning(tokens)
    uctx_p = port.get_learned_conditioning(torch.from_numpy(utokens))
    assert ctx_p.shape == (2, CTX_LEN, 32)
    np.testing.assert_allclose(ctx_p.detach().numpy(), np.asarray(ctx_j),
                               atol=1e-4, rtol=0)

    x_init = _np(8, (2, 16, 16, 6))
    z_j = np.asarray(jax.jit(lambda p, c, u, x: jmodel.sample(
        p, jax.random.PRNGKey(0), 2, context=c, uncond_context=u, steps=4,
        eta=0.0, guidance_scale=1.5, sampler="dpmpp", x_init=x,
        cfg_mode="sequential"))(jparams, ctx_j, uctx_j, jnp.asarray(x_init)))
    z_p = port.sample(2, context=ctx_p, uncond_context=uctx_p, steps=4,
                      eta=0.0, guidance_scale=1.5, sampler="dpmpp",
                      x_init=torch.from_numpy(x_init), cfg_mode="sequential")
    assert z_p.shape == (2, 16, 16, 6)
    assert np.abs(z_j - x_init).max() > 1e-2   # the chain moved the latent
    np.testing.assert_allclose(z_p.numpy(), z_j, atol=1e-3, rtol=0)

    want_img, want_codes = _jitted(jmodel, "decode_first_stage_with_codes")(
        jparams, jnp.asarray(z_j))
    zt = torch.from_numpy(z_j)
    with torch.no_grad():
        z_raw = port._scale_latent(zt, invert=True)
        _, got_codes = port.first_stage_model.decode_interface(
            z_raw, return_code=True)
        got_img = port.decode_first_stage(zt)
    assert [tuple(c.shape) for c in got_codes] == [(2, 16, 16)] * 2
    for i, (g, w) in enumerate(zip(got_codes, want_codes)):
        book = port.first_stage_model.ms_quantize[i].embedding.weight
        assert tuple(book.shape) == (4096, 3)
        keep = _decided(z_raw.numpy()[..., 3 * i:3 * i + 3],
                        book.detach().numpy())
        assert keep.mean() > 0.9
        np.testing.assert_array_equal(g.numpy()[keep], np.asarray(w)[keep])
    assert got_img.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=3e-4, rtol=0)


# ---------------------------------------------------------------------------
# full-width configs on the meta device


@pytest.mark.parametrize("name", list(CONFIGS))
def test_full_width_config_builds_with_the_jax_tree(name):
    path = str(CONFIGS[name])
    jmodel = jax_instantiate(jax_load_yaml(path)["model"])
    shapes = jax.eval_shape(lambda r: jmodel.init_params(r),
                            jax.random.PRNGKey(0))
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    state = jax_params_to_state_dict(views)
    port = instantiate_from_config(load_yaml(path)["model"], device="meta")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    assert got == want      # every leaf has its tensor: none is skipped
    assert "first_stage_model.upsample.0.weight" in got
    seq = load_yaml(path)["model"]["params"]["cond_stage_config"][
        "params"].get("max_seq_len", 77)
    pos = "cond_stage_model.transformer.pos_emb.emb.weight"
    assert want[pos] == (seq, 640)
    if name == "layout2i":
        assert want["first_stage_model.ms_quantize.0.embedding.weight"] == (
            4096, 3)
        assert port.num_stage == 2 and port.embed_dim_list == [3, 3]


# ---------------------------------------------------------------------------
# the kernel sites of the full-width layout2i path


BATCH = 4
DECODE_BATCHES = (BATCH, 32)     # this batch, and bench.py's decode chunk


@pytest.fixture(scope="module")
def sites():
    """Every site the kernels would serve on the full-width layout2i path,
    from a ``meta`` run with the kernels off (so every op takes its plain
    form, which runs on ``meta``): attention (bh, nq, nk, d, itemsize); VQ
    (n, k, d); 3x3 convs (shape, cout, itemsize, fused, spade), a ResBlock
    conv counted as fused (its GroupNorm -> SPADE -> SiLU prologue) and
    every other 3x3 conv as plain; GroupNorms (shape, itemsize)."""
    model = instantiate_from_config(
        load_yaml(str(CONFIGS["layout2i"]))["model"], device="meta")
    found = dict(attn=set(), vq=set(), conv=set(), gn=set())
    stage = [0]
    fused = {id(m) for r in model.modules() if isinstance(r, ResBlock)
             for m in (r.in_layers["2"], r.out_layers["3"])}
    plain_attn, plain_vq = (transformer.attention_plain,
                            ops_vq.vq_argmin_plain)

    def attn(q, k, v, scale):
        found["attn"].add((int(np.prod(q.shape[:-2])), q.shape[-2],
                           k.shape[-2], q.shape[-1], q.element_size()))
        return plain_attn(q, k, v, scale)

    def vq(z, e):
        found["vq"].add((z.shape[0],) + tuple(e.shape))
        return plain_vq(z, e)

    def conv_hook(mod, args, out):
        if mod.is_3x3_same:
            x = args[0]
            f = id(mod) in fused
            found["conv"].add((tuple(x.shape), mod.weight.shape[0],
                               x.element_size(), f, f and stage[0] > 0))

    def gn_hook(mod, args, out):
        found["gn"].add((tuple(args[0].shape), args[0].element_size()))

    mp = pytest.MonkeyPatch()
    mp.setenv("FRIDO_PALLAS", "0")
    mp.setattr(transformer, "attention_plain", attn)
    mp.setattr(ops_vq, "vq_argmin_plain", vq)
    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, Conv2d)]
    hooks += [m.register_forward_hook(gn_hook) for m in model.modules()
              if isinstance(m, GroupNorm)]
    try:
        with torch.no_grad():
            tokens = torch.zeros((BATCH, 96), dtype=torch.long,
                                 device="meta")
            ctx = model.cond_stage_model(tokens).to(torch.bfloat16)
            x = torch.empty((BATCH, 64, 64, 6), dtype=torch.bfloat16,
                            device="meta")
            t = torch.zeros((BATCH,), dtype=torch.long, device="meta")
            for s in (0, 1):
                stage[0] = s
                tables = model.spade_tables(x[..., :3], 1) if s else None
                model.apply_model(x, t, ctx, s, tables)
            for b in DECODE_BATCHES:
                model.first_stage_model.decode_interface(
                    torch.empty((b, 64, 64, 6), device="meta"))
    finally:
        for h in hooks:
            h.remove()
        mp.undo()
    return found


def _route(site):
    bh, nq, nk, d, itemsize = site
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("FRIDO_SMALLS_ATTN", "1"), ("FRIDO_PALLAS", "auto"),
                     ("FRIDO_FLASH", "1")):
            mp.setenv(k, v)
        if dispatch.use_flash(nk):
            return "flash"
        return "smalls" if dispatch.use_smalls(nq, nk) else "plain"


def test_attention_sites_and_their_routes(sites):
    """Flash takes the decoder's 4096-token fp32 attention and the UNet's
    1024-token bf16 self-attention at 32^2; the short-sequence kernel
    (under its switch) the 16^2 and 8^2 attention and BERT's; the 32^2
    cross-attention (1024 queries over 96 keys) fits neither gate and
    stays on the plain path, as in the JAX package."""
    routes = {}
    for site in sites["attn"]:
        routes.setdefault(_route(site), set()).add(site)
    assert routes["flash"] == {(4, 4096, 4096, 512, 4),
                               (32, 4096, 4096, 512, 4),
                               (4, 1024, 1024, 384, 2)}
    assert routes["plain"] == {(4, 1024, 96, 384, 2)}
    assert routes["smalls"] == {(4, 256, 256, 576, 2), (4, 256, 96, 576, 2),
                                (4, 64, 64, 960, 2), (4, 64, 96, 960, 2),
                                (32, 96, 96, 64, 4)}


@pytest.mark.parametrize("kernel", ["flash", "smalls"])
def test_attention_plans_cover_and_fit(sites, kernel):
    planner = flash_plan if kernel == "flash" else smalls_plan
    chosen = [s for s in sites["attn"] if _route(s) == kernel]
    assert chosen
    for bh, nq, nk, d, itemsize in chosen:
        plan = planner(bh, nq, nk, d, itemsize)
        assert (_coverage(plan, bh, nq, d) == 1).all(), plan
        assert 0 < plan.smem <= MAX_SMEM, plan
        if plan.copy_bytes:
            assert d * itemsize % plan.copy_bytes == 0


def test_flash_plans_at_the_new_sites():
    """fp32 d = 512 takes 64-row tiles (214 KB of shared memory), bf16
    d = 384 at batch 4 takes 32-row tiles, 128 blocks."""
    for bh in (4, 32):
        p = flash_plan(bh, 4096, 4096, 512, 4)
        assert p.rows == 64 and p.smem == 219392
    p = flash_plan(4, 1024, 1024, 384, 2)
    assert p.rows == 32 and p.grid == (32, 1, 4)


def test_vq_plans_cover_and_fit(sites):
    assert sites["vq"] == {(BATCH * 64 * 64, 4096, 3),
                           (32 * 64 * 64, 4096, 3)}
    for n, k, d in sorted(sites["vq"]):
        _check_vq_plan(n, k, d)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_conv_plans_cover_and_fit(sites, fused):
    chosen = sorted(s for s in sites["conv"] if s[3] == fused)
    assert chosen
    # the new 64^2 UNet sites are among them
    assert any(s[0] == (BATCH, 192, 64, 64) and s[2] == 2 for s in chosen)
    for shape, cout, itemsize, f, spade in chosen:
        _check_plan(shape, cout, itemsize, f, spade)


def test_group_norm_plans_cover_and_fit(sites):
    assert ((BATCH, 192, 64, 64), 2) in sites["gn"]
    for shape, itemsize in sorted(sites["gn"]):
        _check_gn_plan((shape, itemsize))
