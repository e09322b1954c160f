"""The port's PyUNet options against the JAX package, on the CPU.

Each variant is a toy PyUNet (32 channels, one ResBlock a level, two
levels, 8^2-16^2 latents) with one option switched on, or one of the two
combinations the card runs at full width: ``ddpm-pixel`` (GroupNorm
ResBlocks with resblock up/down and scale-shift norm, the plain
``AttentionBlock`` in the new QKV order, the stem and the single head) and
``t2i-ablations`` (the split-head SPADE t2i UNet with stage experts, the
mscond branch and position embeddings, on a grid that is not square).
Seeded numpy values for every JAX leaf (``tests/test_torch_models.py``'s
recipe, the zero-initialised convs included) go into both packages, into
the port through ``io/jax_weights.load_jax_params`` (strict: every leaf
has its tensor, every tensor its leaf). Inputs are seeded numpy. The JAX
side of a variant is jitted once, all its stages in one program.

- Default routing: every stage's output against JAX.
- All-kernel routing (``FRIDO_CONV_MODE=pallas_fused FRIDO_GN_PALLAS=1
  FRIDO_SMALLS_ATTN=1``): every variant again, the port's sites routed to
  the kernels' entry points (plain versions on CPU tensors; each entry
  point's call counter moves). For the two combinations the JAX side of
  the last stage runs under the same switches with
  ``FRIDO_PALLAS=interpret``; elsewhere it is the default path's output,
  which the JAX package's Pallas kernels reproduce
  (``tests/test_pallas.py``): an interpreted-kernel compile costs about
  10 s a stage on this CPU, and the combinations' last stages reach every
  site kind the single options do.
- ``spade_tables`` of each stage's expert trunk equal the in-line
  computation; the poisoned tables move the output.
- ``ResBlock(use_conv_skip=True)`` alone, ``pyunet_from_config``'s options
  all taken, dropout refused in training, the tensor-parallel leaf rule on
  the new leaves (against the JAX rule, and on 2 gloo ranks the sharded
  forward equals the whole one).

Tolerance, fixed before the comparison: 3e-4 absolute for one UNet call
(``tests/test_torch_models.py``); 1e-6 for the precomputed SPADE tables
against the in-line computation (the same fp32 ops), and 1e-6 of the
output's largest magnitude for the sharded forward against the whole one
(each rank's conv over a part of the output channels may block its fp32
sums another way).
"""

import datetime
import inspect
import os
import re
import socket
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from frido_tpu.nn import pyunet as jax_pyunet
from frido_tpu.parallel import tp as jax_tp
from frido_tpu_torch.io.jax_weights import (leaf_name, load_jax_params,
                                            to_torch_layout, torch_key)
from frido_tpu_torch.nn.pyunet import (AttentionBlock, PyUNetModel,
                                       ResBlock)
from frido_tpu_torch.nn.spade import SPADE
from frido_tpu_torch.nn.transformer import SpatialTransformer
from frido_tpu_torch.ops.cuda.attention import smalls_attention
from frido_tpu_torch.ops.cuda.conv import conv3x3, conv3x3_norm_silu
from frido_tpu_torch.ops.cuda.norm import group_norm
from frido_tpu_torch.parallel import mesh, tp
from tests.test_torch_models import UNET, _random_params

torch.set_num_threads(2)

ATOL = 3e-4
EXACT = 1e-6
SWITCHES = {"FRIDO_CONV_MODE": "pallas_fused", "FRIDO_GN_PALLAS": "1",
            "FRIDO_SMALLS_ATTN": "1"}
OPS = (conv3x3_norm_silu, conv3x3, group_norm, smalls_attention)
CTX = 5

PLAIN = dict(image_size=16, in_channels=3, out_channels=3, model_channels=32,
             num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2],
             num_head_channels=16)
# the split-head options alone: one level (no resampling), attention at
# every block, two stages; the t2i-ablations combination keeps the t2i toy
# of tests/test_torch_models.py (two levels)
SPLIT = dict(PLAIN, in_channels=8, out_channels=8, use_split_head=True,
             split_embed_dim_list=[4, 4], num_stage=2, channel_mult=[1],
             attention_resolutions=[1])
SPADE_ST = dict(UNET, channel_mult=[1], attention_resolutions=[1])
# name: (unet params, input H x W, class labels: None, "ids" or "vectors")
VARIANTS = {
    "attention-legacy-order": (PLAIN, (16, 16), None),
    "attention-new-order": (dict(PLAIN, use_new_attention_order=True),
                            (16, 16), None),
    "heads-upsample": (dict(PLAIN, legacy=False, num_head_channels=-1,
                            num_heads=2, num_heads_upsample=4,
                            conv_resample=False), (16, 16), None),
    "resblock-updown": (dict(PLAIN, resblock_updown=True), (16, 16), None),
    "scale-shift-norm": (dict(PLAIN, use_scale_shift_norm=True), (16, 16),
                         None),
    "label-embed": (dict(PLAIN, num_classes=10, use_embed=True), (16, 16),
                    "ids"),
    "label-dense": (dict(PLAIN, num_classes=10), (16, 16), "vectors"),
    "id-head": (dict(PLAIN, n_embed=24), (16, 16), None),
    "split-head-groupnorm": (SPLIT, (8, 8), None),
    "split-head-spade-attention-block": (dict(SPLIT, use_SPADE_norm=True),
                                         (8, 8), None),
    "spatial-transformer-groupnorm": (dict(
        PLAIN, use_spatial_transformer=True, context_dim=32), (16, 16),
        None),
    "stage-experts": (dict(SPADE_ST, use_stage_expert=True), (8, 8), None),
    "mscond": (dict(SPADE_ST, use_mscond=True), (8, 8), None),
    "pos-embed-non-square": (dict(SPADE_ST, use_pos_embed=True), (8, 16),
                             None),
    "ddpm-pixel": (dict(PLAIN, resblock_updown=True,
                        use_scale_shift_norm=True,
                        use_new_attention_order=True), (16, 16), None),
    "t2i-ablations": (dict(UNET, use_stage_expert=True, use_mscond=True,
                           use_pos_embed=True), (8, 16), None),
}
INTERPRETED = ("ddpm-pixel", "t2i-ablations")
_CASES = {}


def _stages(params):
    return list(range(max(params.get("num_stage", 1), 1)))


def _inputs(name):
    params, (h, w), labels = VARIANTS[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, h, w, params["in_channels"]),
                            dtype=np.float32)
    t = np.asarray([3, 617], np.int32)
    ctx = (rng.standard_normal((2, CTX, params["context_dim"]),
                               dtype=np.float32)
           if params.get("use_spatial_transformer") else None)
    y = None
    if labels == "ids":
        y = np.asarray([1, 7], np.int32)
    elif labels == "vectors":
        y = rng.standard_normal((2, params["num_classes"]), dtype=np.float32)
    return x, t, ctx, y


def _jax_outputs(name, np_params, stages=None):
    """The JAX output of every stage (or of ``stages``), one jitted
    program under the current switches."""
    params = VARIANTS[name][0]
    m = jax_pyunet.pyunet_from_config(params)
    x, t, ctx, y = _inputs(name)
    stages = _stages(params) if stages is None else stages

    def run(p, x, t, ctx, y):
        return [m.apply(p, x, t, ctx, y, stage=s) for s in stages]

    return [np.asarray(o) for o in jax.jit(run)(
        {"params": np_params}, x, t, ctx, y)]


def _case(name):
    """(numpy params, the port on the CPU, the JAX outputs by stage) of a
    variant, built once."""
    if name not in _CASES:
        params = VARIANTS[name][0]
        m = jax_pyunet.pyunet_from_config(params)
        x, t, ctx, y = _inputs(name)
        shapes = jax.eval_shape(lambda r: m.init(
            r, x, t, ctx, y, method="init_all"), jax.random.PRNGKey(0))
        np_params = _random_params(shapes["params"],
                                   np.random.default_rng(0))
        port = PyUNetModel(**params, device="cpu")
        load_jax_params(port, np_params)
        port.eval()
        _CASES[name] = (np_params, port, _jax_outputs(name, np_params))
    return _CASES[name]


def _port_outputs(name, port, spade_pre=None):
    params = VARIANTS[name][0]
    x, t, ctx, y = _inputs(name)
    opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = []
    with torch.no_grad():
        for s in _stages(params):
            pre = spade_pre(s, x) if spade_pre else None
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(t).long(), opt(ctx), s, pre,
                       y=opt(y))
            out.append(got.permute(0, 2, 3, 1).numpy())
    return out


def _check(name, got, want):
    params = VARIANTS[name][0]
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, s, g.shape, w.shape)
        assert np.abs(w).max() > 1e-2      # the zero-init convs are not 0
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                   err_msg=f"{name} stage {s}")
    if params.get("n_embed"):
        assert got[0].shape[-1] == params["n_embed"]


@pytest.fixture
def no_switches(monkeypatch):
    for key in (*SWITCHES, "FRIDO_PALLAS", "FRIDO_CONV_SMALLS"):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax(name, no_switches):
    _, port, want = _case(name)
    _check(name, _port_outputs(name, port), want)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax_all_kernel(name, no_switches):
    np_params, port, want = _case(name)
    for key, value in SWITCHES.items():
        no_switches.setenv(key, value)
    if name in INTERPRETED:
        # the last stage interpreted (t2i-ablations: the expert trunk with
        # SPADE, mscond and its tables); an earlier one, on the default
        # path
        no_switches.setenv("FRIDO_PALLAS", "interpret")
        last = len(want) - 1
        want = want[:last] + _jax_outputs(name, np_params, [last])
    before = [op.calls for op in OPS]
    got = _port_outputs(name, port)
    calls = [op.calls - b for op, b in zip(OPS, before)]
    # fused prologues (or the norm kernel before a resample), GroupNorm
    # kernels and 3x3 conv kernels at every variant; short attention where
    # its tokens fit
    assert calls[2] > 0 and calls[0] + calls[1] > 0, calls
    assert calls[3] > 0, calls
    _check(name, got, want)


@pytest.mark.parametrize("name", ["stage-experts", "t2i-ablations"])
def test_spade_tables_equal_in_line(name, no_switches):
    _, port, _ = _case(name)
    x, *_ = _inputs(name)
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert port.spade_tables(xc[:, :4], 0) is None

    def tables(stage, x_np, poison=0.0):
        t = port.spade_tables(xc[:, :4], stage)
        return {k: tuple((g + poison, b) for g, b in v)
                if isinstance(v[0], tuple) else (v[0] + poison, v[1])
                for k, v in t.items()}

    inline = _port_outputs(name, port)
    pre = _port_outputs(name, port, lambda s, x_np: tables(s, x_np)
                        if s else None)
    poisoned = _port_outputs(name, port, lambda s, x_np: tables(
        s, x_np, 1.0) if s else None)
    np.testing.assert_allclose(pre[1], inline[1], atol=EXACT, rtol=0)
    assert np.abs(poisoned[1] - inline[1]).max() > 1e-3
    # one entry per SPADE site of stage 1's expert trunk, and none of the
    # stage-0 trunk's SPADEs has modulation convs
    t1 = port.spade_tables(xc[:, :4], 1)
    trunk1 = [port.input_blocks_expert[1], port.middle_block_expert[1],
              port.output_blocks_expert[1]]
    assert len(t1) == sum(isinstance(m, (ResBlock, SpatialTransformer,
                                         AttentionBlock))
                          for part in trunk1 for m in part.modules())
    assert all(k.split(".")[0].endswith("_expert") and k.split(".")[1] == "1"
               for k in t1)
    for part in (port.input_blocks_expert[0], port.middle_block_expert[0]):
        spades = [m for m in part.modules() if isinstance(m, SPADE)]
        assert spades and not any(hasattr(m, "mlp_gamma") for m in spades)


def test_conv_skip_resblock_matches_jax():
    """``use_conv_skip`` (a 3x3 skip where the channels change), which no
    PyUNet config reaches: the JAX ResBlock alone."""
    blk = jax_pyunet.ResBlock(channels=32, out_channels=64,
                              use_conv_skip=True)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 32), dtype=np.float32)
    emb = rng.standard_normal((2, 128), dtype=np.float32)
    shapes = jax.eval_shape(lambda r: blk.init(r, x, emb),
                            jax.random.PRNGKey(0))
    np_params = _random_params(shapes["params"], np.random.default_rng(4))
    want = np.asarray(jax.jit(blk.apply)({"params": np_params}, x, emb))
    port = ResBlock(32, 64, 128, None, use_spade=False, use_conv_skip=True,
                    device="cpu")
    load_jax_params(port, np_params)
    assert tuple(port.skip_connection.weight.shape) == (64, 32, 3, 3)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(emb)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_port_takes_every_option_of_pyunet_from_config():
    src = inspect.getsource(jax_pyunet.pyunet_from_config)
    keys = set(re.findall(r'p\.(?:get|pop)\("(\w+)"', src))
    keys |= set(re.findall(r'p\["(\w+)"\]', src))
    assert {"use_stage_expert", "use_checkpoint", "image_size"} <= keys
    assert keys <= set(inspect.signature(PyUNetModel).parameters)


def test_dropout_is_refused_in_training_naming_the_jax_fault():
    port = PyUNetModel(**dict(PLAIN, dropout=0.1), device="cpu")
    x = torch.zeros(1, 3, 16, 16)
    t = torch.zeros(1, dtype=torch.long)
    port.eval()
    port(x, t)                       # eval: dropout is the identity
    port.train()
    with pytest.raises(NotImplementedError, match="AssignSubModuleError"):
        port(x, t)


def _leaves(shapes):
    out = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            p = path + (k,)
            sizes = (2, 3, 5, 7, 11)[:len(v.shape)]
            moved = to_torch_layout(np.empty(sizes), leaf_name(p)).shape
            out.append(("/".join(p), tuple(v.shape), torch_key(p),
                        tuple(sizes.index(m) for m in moved)))

    walk(shapes, ())
    return out


TP_VARIANTS = ("t2i-ablations", "ddpm-pixel", "label-embed",
               "label-dense", "id-head")


def test_tp_leaf_rule_matches_jax_on_the_new_leaves():
    keys = set()
    for name in TP_VARIANTS:
        np_params, port, _ = _case(name)
        specs = tp.param_specs(port, 2)
        leaves = _leaves(np_params)
        assert {key for _, _, key, _ in leaves} == set(specs)
        for path, jshape, key, perm in leaves:
            jt = jax_tp._leaf_spec(path, jshape, 2)
            axis = tuple(jt).index("model") if "model" in tuple(jt) else None
            want = None if axis is None else perm.index(axis)
            assert specs[key][0] == want, (name, path)
            keys.add(key)
    for part in ("input_blocks_expert.1.", "middle_block_expert.0.",
                 "output_blocks_expert.1.", ".attn_prev.", ".attn_cross.",
                 ".norm_prev.", ".norm_cross.", ".cond_proj_in.",
                 ".pos_embed.", "label_emb.", ".qkv.", "id_predictor.0.",
                 "id_predictor.1.", "out.0.", "out.2."):
        assert any(part in k or k.startswith(part) for k in keys), part


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tp_worker(rank, port, out):
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=120))
    try:
        layout = mesh.make_layout(2, rank, 2)
        results = {}
        for name in ("t2i-ablations", "ddpm-pixel",
                     "label-embed"):
            model = PyUNetModel(**VARIANTS[name][0], device="cpu").eval()
            gen = torch.Generator().manual_seed(5)
            with torch.no_grad():
                for p in model.parameters():      # zero-init convs too
                    p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            whole = _port_outputs(name, model)
            shards = tp.shard_module_(model, layout)
            results[name] = (len(shards), [
                float(np.abs(a - b).max()) for a, b in
                zip(_port_outputs(name, model), whole)],
                [float(np.abs(w).max()) for w in whole])
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        torch.save(results, os.path.join(out, "tp.pt"))


def test_tp_shards_the_new_leaves_on_two_gloo_ranks(tmp_path):
    ctx = mp.start_processes(_tp_worker, (_free_port(), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + 180
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the gloo ranks timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = torch.load(tmp_path / "tp.pt", weights_only=False)
    for name, (n_shards, errs, mags) in results.items():
        assert n_shards > 10, name
        assert max(mags) > 1e-2, name
        assert max(errs) <= EXACT * max(mags), (name, errs)


def test_bf16_ablations_give_each_attention_kernel_one_dtype(no_switches):
    """In bf16 the position embedding's fp32 table promotes the tokens
    (as in the JAX package), while the context and the previous stage's
    tokens stay bf16: every attention kernel call still gets q, k and v of
    one dtype (the CUDA kernels take no mixture), promoted as
    ``jnp.einsum`` promotes them."""
    from frido_tpu_torch.nn import transformer

    _, port, _ = _case("t2i-ablations")
    x, t, ctx, _ = _inputs("t2i-ablations")
    for key, value in SWITCHES.items():
        no_switches.setenv(key, value)
    seen = []

    def one_dtype(kernel):
        def call(q, k, v, scale):
            assert q.dtype == k.dtype == v.dtype, (q.dtype, k.dtype, v.dtype)
            seen.append(q.dtype)
            return kernel(q, k, v, scale)
        return call

    for name in ("smalls_attention", "flash_attention"):
        no_switches.setattr(transformer, name,
                            one_dtype(getattr(transformer, name)))
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16(),
                   torch.from_numpy(t).long(),
                   torch.from_numpy(ctx).bfloat16(), 1)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert torch.bfloat16 in seen and torch.float32 in seen
