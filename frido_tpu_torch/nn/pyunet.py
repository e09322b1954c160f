"""PyUNet: the coarse-to-fine pyramid denoiser (port of
``frido_tpu/nn/pyunet.py``), channel-first.

Sinusoidal t-embedding + MLP, plus the stage embedding and class labels
(``label_emb``, an ``Embed`` of ids with ``use_embed``, else a ``Dense``
of [N, num_classes] vectors). The input is the split head (per-stage
``pre_input_blocks`` over the stage's channel window; with SPADE the
previous stages' channels feed SPADE through ``pre_input_cond_blocks``)
or one 3x3 stem conv. The trunk is guided diffusion's: ResBlocks (SPADE or
GroupNorm norms, ``use_scale_shift_norm``, resblock up/down resampling)
and attention at the configured rates, the SpatialTransformer
(``use_spatial_transformer``) or the plain ``AttentionBlock`` with its
legacy or new QKV order, with skip concatenation; one trunk, or one per
stage with ``use_stage_expert``. The output is a per-stage head, one
head, or the ``n_embed`` codebook-id predictor. ``spade_tables``
precomputes every SPADE site's (gamma, beta) of a stage's trunk once per
stage (``:518-567``).

Each block of the trunk (``input_blocks.i``, ``middle_block``,
``output_blocks.i``) is a :class:`UNetBlock` whose layers run as one call:
the unit FSDP gathers (``parallel/fsdp.py``); the PyUNet itself is the
unit of the rest (time and stage embeddings, the split head, the output
head).

Module names follow the original torch key tree (``input_blocks.1.0.
in_layers.2.weight``; ``input_blocks_expert.1.…`` for the stage experts),
so the JAX params map onto this module mechanically
(``frido_tpu_torch/io/jax_weights.py``). A layer that the JAX package
never calls, and so never gives parameters (the modulation convs and the
mscond branch of a trunk that never sees a previous stage), is not built.

Refused: ``dropout > 0`` in training mode. The JAX package cannot train
with it either: ``ResBlock.__call__`` builds ``nn.Dropout`` inside a
``setup`` module (``frido_tpu/nn/pyunet.py:199-201``), which raises
``flax.errors.AssignSubModuleError`` at the first step. In eval mode
dropout is the identity, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from frido_tpu_torch.nn.layers import Conv1d, Conv2d, Dense, Embed, GroupNorm
from frido_tpu_torch.nn.spade import SPADE
from frido_tpu_torch.nn.transformer import SpatialTransformer, dot_attention
from frido_tpu_torch.ops.cuda import dispatch
from frido_tpu_torch.ops.image import avg_pool_2x, interpolate_nearest_2x


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, **cos first** (``pyunet.py:37-49``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class UNetUpsample(nn.Module):
    """nearest 2x + optional 3x3 conv."""

    def __init__(self, channels: int, use_conv: bool = True, device=None):
        super().__init__()
        self.conv = (Conv2d(channels, channels, 3, padding=1, device=device)
                     if use_conv else None)

    def forward(self, x):
        x = interpolate_nearest_2x(x)
        return self.conv(x) if self.conv is not None else x


class UNetDownsample(nn.Module):
    """stride-2 conv with symmetric pad 1, or 2x average pool."""

    def __init__(self, channels: int, use_conv: bool = True, device=None):
        super().__init__()
        self.op = (Conv2d(channels, channels, 3, stride=2, padding=1,
                          device=device) if use_conv else None)

    def forward(self, x):
        return self.op(x) if self.op is not None else avg_pool_2x(x)


class ResBlock(nn.Module):
    """guided-diffusion ResBlock (``pyunet.py:86-205``): norm -> SiLU ->
    3x3 conv, the time embedding added (or, with ``use_scale_shift_norm``,
    applied as a scale and a shift after the second norm), norm -> SiLU ->
    3x3 conv, plus the skip (1x1 conv, or 3x3 with ``use_conv_skip``, where
    the channels change).

    The norms are SPADE with ``use_spade`` (modulated by ``cond_channels``
    of the previous stage's feature map, or parameter-free where the block
    never sees one) or GroupNorm (eps 1e-5). ``up``/``down``: GroupNorm +
    SiLU, then nearest 2x or 2x average pool of both paths, then the plain
    conv. Under ``FRIDO_CONV_MODE=pallas_fused`` each prologue that feeds
    a conv directly is folded into it (one kernel; SPADE's tables ride
    along, a GroupNorm has none); otherwise the ops run one by one."""

    def __init__(self, channels: int, out_channels: int, emb_channels: int,
                 cond_channels: Optional[int] = None, use_spade: bool = True,
                 use_scale_shift_norm: bool = False,
                 use_conv_skip: bool = False, up: bool = False,
                 down: bool = False, device=None):
        super().__init__()
        cout = out_channels
        self.use_spade = use_spade
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down

        def norm(c):
            if use_spade:
                return SPADE(c, cond_channels, device=device)
            return GroupNorm(c, eps=1e-5, device=device)

        self.in_layers = nn.ModuleDict({
            "0": norm(channels),
            "2": Conv2d(channels, cout, 3, padding=1, device=device)})
        # emb_layers = Sequential(SiLU, Linear) -> key emb_layers.1
        self.emb_layers = nn.ModuleDict({"1": Dense(
            emb_channels, 2 * cout if use_scale_shift_norm else cout,
            device=device)})
        self.out_layers = nn.ModuleDict({
            "0": norm(cout),
            "3": Conv2d(cout, cout, 3, padding=1, zero_init=True,
                        device=device)})
        if cout == channels:
            self.skip_connection = None
        elif use_conv_skip:
            self.skip_connection = Conv2d(channels, cout, 3, padding=1,
                                          device=device)
        else:
            self.skip_connection = Conv2d(channels, cout, 1, device=device)

    def spade_tables(self, cond, hw):
        """Both SPADE norms' (gamma, beta) at their resolutions (the out
        norm runs after the resampling); None without SPADE."""
        if not self.use_spade:
            return None
        h, w = hw
        out_hw = ((2 * h, 2 * w) if self.up else (h // 2, w // 2)
                  if self.down else hw)
        return (self.in_layers["0"].gamma_beta(cond, hw),
                self.out_layers["0"].gamma_beta(cond, out_hw))

    def _norm(self, norm, x, feat_cond, pre):
        return norm(x, feat_cond, pre) if self.use_spade else norm(x)

    def _norm_silu(self, norm, x, feat_cond, pre):
        if self.use_spade:
            return F.silu(norm(x, feat_cond, pre))
        return norm(x, fuse_silu=True)

    def _norm_silu_conv(self, norm, conv, x, feat_cond, pre):
        if not dispatch.use_fused_prologue():
            return conv(self._norm_silu(norm, x, feat_cond, pre))
        args = (norm.fused_args(x, feat_cond, pre) if self.use_spade
                else norm.fused_args())
        return conv(x, fused_norm=args)

    def _skip(self, x):
        return x if self.skip_connection is None else self.skip_connection(x)

    def forward(self, x, emb, feat_cond=None, spade_pre=None):
        pre_in, pre_out = spade_pre if spade_pre is not None else (None, None)
        if self.up or self.down:
            resample = interpolate_nearest_2x if self.up else avg_pool_2x
            h = resample(self._norm_silu(self.in_layers["0"], x, feat_cond,
                                         pre_in))
            x = resample(x)
            h = self.in_layers["2"](h)
        else:
            h = self._norm_silu_conv(self.in_layers["0"],
                                     self.in_layers["2"], x, feat_cond,
                                     pre_in)
        emb_out = self.emb_layers["1"](F.silu(emb)).to(h.dtype)[
            :, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self._norm(self.out_layers["0"], h, feat_cond, pre_out) \
                * (1 + scale) + shift
            return self._skip(x) + self.out_layers["3"](F.silu(h))
        return self._skip(x) + self._norm_silu_conv(
            self.out_layers["0"], self.out_layers["3"], h + emb_out,
            feat_cond, pre_out)


def qkv_attention_legacy(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``QKVAttentionLegacy`` (``pyunet.py:208-222``) on [N, 3*H*c, T]:
    head-major triplets [h0: (q k v), h1: (q k v), ...]; -> [N, H*c, T]."""
    n, width, t = qkv.shape
    ch = width // (3 * n_heads)
    q, k, v = qkv.reshape(n, n_heads, 3, ch, t).transpose(-1, -2).unbind(2)
    a = dot_attention(q, k, v, 1.0 / math.sqrt(ch))
    return a.transpose(-1, -2).reshape(n, n_heads * ch, t)


def qkv_attention_new(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``QKVAttention`` (``pyunet.py:225-235``) on [N, 3*H*c, T]: [all q
    heads | all k heads | all v heads]; -> [N, H*c, T]."""
    n, width, t = qkv.shape
    ch = width // (3 * n_heads)
    q, k, v = qkv.reshape(n, 3, n_heads, ch, t).transpose(-1, -2).unbind(1)
    a = dot_attention(q, k, v, 1.0 / math.sqrt(ch))
    return a.transpose(-1, -2).reshape(n, n_heads * ch, t)


class AttentionBlock(nn.Module):
    """Spatial self-attention with 1x1 ``Conv1d`` qkv and proj_out
    (``pyunet.py:238-268``), after a GroupNorm (eps 1e-5) or a SPADE norm;
    its attention goes through ``dot_attention``'s kernel gates."""

    def __init__(self, channels: int, num_heads: int = 1,
                 use_new_attention_order: bool = False,
                 use_spade: bool = False,
                 cond_channels: Optional[int] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.use_spade = use_spade
        self.attention = (qkv_attention_new if use_new_attention_order
                          else qkv_attention_legacy)
        self.norm = (SPADE(channels, cond_channels, device=device)
                     if use_spade else
                     GroupNorm(channels, eps=1e-5, device=device))
        self.qkv = Conv1d(channels, 3 * channels, 1, device=device)
        self.proj_out = Conv1d(channels, channels, 1, zero_init=True,
                               device=device)

    def spade_tables(self, cond, hw):
        return self.norm.gamma_beta(cond, hw) if self.use_spade else None

    def forward(self, x, feat_cond=None, spade_pre=None):
        b, c, h, w = x.shape
        xn = (self.norm(x, feat_cond, spade_pre) if self.use_spade
              else self.norm(x))
        a = self.attention(self.qkv(xn.reshape(b, c, h * w)), self.num_heads)
        return x + self.proj_out(a).reshape(b, c, h, w)


class UNetBlock(nn.ModuleList):
    """One block of the trunk: its layers (keys ``<block>.<j>``) run in
    one call, each with its SPADE tables from ``pres`` (or in line)."""

    def forward(self, h, emb, context=None, h_cond=None, pres=None):
        for j, mod in enumerate(self):
            pre = pres[j] if pres is not None else None
            if isinstance(mod, ResBlock):
                h = mod(h, emb, h_cond, pre)
            elif isinstance(mod, SpatialTransformer):
                h = mod(h, context, h_cond, pre)
            elif isinstance(mod, AttentionBlock):
                h = mod(h, h_cond, pre)
            else:
                h = mod(h)
        return h


def _heads_for(ch: int, num_heads: int, num_head_channels: int, legacy: bool,
               use_spatial_transformer: bool) -> Tuple[int, int]:
    """The head count and width of an attention site (``pyunet.py:
    271-281``): with ``legacy`` (the default) one head, of width ``ch``
    in a SpatialTransformer and ``num_head_channels`` otherwise."""
    if num_head_channels == -1:
        heads, dim_head = num_heads, ch // num_heads
    else:
        heads, dim_head = ch // num_head_channels, num_head_channels
    if legacy:
        heads = 1
        dim_head = ch // heads if use_spatial_transformer \
            else num_head_channels
    return heads, dim_head


class PyUNetModel(nn.Module):
    """Config fields mirror the reference yaml params
    (``configs/frido/t2i/frido_f16f8_coco.yaml:22-46``) and
    ``pyunet_from_config``'s defaults (``pyunet.py:628-668``). Inputs and
    outputs are NCHW; ``stage`` is a Python int."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int], dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True,
                 num_classes: Optional[int] = None, num_heads: int = -1,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False, use_embed: bool = False,
                 num_stage: int = 1, resblock_updown: bool = False,
                 use_new_attention_order: bool = False,
                 use_spatial_transformer: bool = False,
                 transformer_depth: int = 1,
                 context_dim: Optional[int] = None,
                 n_embed: Optional[int] = None, legacy: bool = True,
                 use_split_head: bool = False,
                 split_embed_dim_list: Sequence[int] = (),
                 use_SPADE_norm: bool = False, use_pos_embed: bool = False,
                 use_mscond: bool = False, use_stage_expert: bool = False,
                 use_checkpoint: bool = False, use_fp16: bool = False,
                 dims: int = 2, device=None):
        super().__init__()
        # use_checkpoint: remat is the trainer's (DiffusionTrainer(remat=));
        # use_fp16: the caller's compute_dtype; dims: 2-D only, as the JAX
        # package (pyunet_from_config drops all three)
        del use_checkpoint, use_fp16, dims
        mc = model_channels
        ted = mc * 4
        split = list(split_embed_dim_list)
        if use_spatial_transformer and context_dim is None:
            raise ValueError("context_dim required with "
                             "use_spatial_transformer")
        if use_split_head and (not split or sum(split) != in_channels):
            raise ValueError("use_split_head needs split_embed_dim_list "
                             "summing to in_channels")
        if n_embed is not None and (use_SPADE_norm or use_split_head):
            raise ValueError("the n_embed id head takes neither SPADE nor "
                             "the split head")
        if use_stage_expert and not split:
            raise ValueError("use_stage_expert needs split_embed_dim_list")
        self.model_channels = mc
        self.context_dim = context_dim
        self.dropout = dropout
        self.num_classes = num_classes
        self.num_stage = num_stage
        self.split = split
        self.use_split_head = use_split_head
        self.use_spade = use_SPADE_norm
        self.use_mscond = use_mscond
        self.use_stage_expert = use_stage_expert
        self.n_embed = n_embed
        # SPADE feeds on the previous stages only with the split head
        spade_cond = use_split_head and use_SPADE_norm

        self.time_embed = nn.ModuleDict({"0": Dense(mc, ted, device=device),
                                         "2": Dense(ted, ted, device=device)})
        if num_classes is not None:
            self.label_emb = (Embed(num_classes, ted, device=device)
                              if use_embed else
                              Dense(num_classes, ted, device=device))
        if num_stage > 1:
            self.stage_emb = Embed(num_stage, ted, device=device)

        if use_split_head:
            # stage s reads its own channel window (with SPADE; else every
            # channel up to its window's end); with SPADE the previous
            # stages' channels feed it through pre_input_cond_blocks[s - 1]
            # (registered first: seed_init_ draws in module order)
            if use_SPADE_norm:
                self.pre_input_cond_blocks = nn.ModuleList([
                    nn.ModuleList([Conv2d(sum(split[:i + 1]), mc, 3,
                                          padding=1, device=device)])
                    for i in range(len(split) - 1)])
            self.pre_input_blocks = nn.ModuleList([
                nn.ModuleList([Conv2d(d if use_SPADE_norm else
                                      sum(split[:i + 1]), mc, 3, padding=1,
                                      device=device)])
                for i, d in enumerate(split)])

        def trunk(cond_channels):
            def res(cin, cout, **kw):
                return ResBlock(cin, cout, ted, cond_channels, use_SPADE_norm,
                                use_scale_shift_norm, device=device, **kw)

            def attn(ch, upsample=False):
                heads, dim_head = _heads_for(
                    ch, num_heads_upsample if upsample and not
                    use_spatial_transformer else num_heads,
                    num_head_channels, legacy, use_spatial_transformer)
                if use_spatial_transformer:
                    return SpatialTransformer(
                        ch, heads, dim_head, transformer_depth, context_dim,
                        cond_channels, use_SPADE_norm,
                        image_size if use_pos_embed else -1, use_mscond,
                        device=device)
                return AttentionBlock(
                    ch, heads if num_head_channels == -1 else ch // dim_head,
                    use_new_attention_order, use_SPADE_norm, cond_channels,
                    device=device)

            input_blocks = []
            if not use_split_head:
                input_blocks.append(UNetBlock([Conv2d(
                    in_channels, mc, 3, padding=1, device=device)]))
            chans = [mc]
            ch, ds = mc, 1
            for level, mult in enumerate(channel_mult):
                for _ in range(num_res_blocks):
                    layers = [res(ch, mult * mc)]
                    ch = mult * mc
                    if ds in attention_resolutions:
                        layers.append(attn(ch))
                    input_blocks.append(UNetBlock(layers))
                    chans.append(ch)
                if level != len(channel_mult) - 1:
                    input_blocks.append(UNetBlock([
                        res(ch, ch, down=True) if resblock_updown else
                        UNetDownsample(ch, conv_resample, device)]))
                    chans.append(ch)
                    ds *= 2
            middle_block = UNetBlock([res(ch, ch), attn(ch),
                                      res(ch, ch)])
            output_blocks = []
            for level, mult in list(enumerate(channel_mult))[::-1]:
                for i in range(num_res_blocks + 1):
                    layers = [res(ch + chans.pop(), mc * mult)]
                    ch = mc * mult
                    if ds in attention_resolutions:
                        layers.append(attn(ch, upsample=True))
                    if level and i == num_res_blocks:
                        layers.append(
                            res(ch, ch, up=True) if resblock_updown else
                            UNetUpsample(ch, conv_resample, device))
                        ds //= 2
                    output_blocks.append(UNetBlock(layers))
            return (nn.ModuleList(input_blocks), middle_block,
                    nn.ModuleList(output_blocks), ch)

        if use_stage_expert:
            # one trunk per stage; the stage-0 trunk never sees a previous
            # stage's feature map
            trunks = [trunk(mc if spade_cond and s else None)
                      for s in range(len(split))]
            self.input_blocks_expert = nn.ModuleList([t[0] for t in trunks])
            self.middle_block_expert = nn.ModuleList([t[1] for t in trunks])
            self.output_blocks_expert = nn.ModuleList([t[2] for t in trunks])
            ch = trunks[0][3]
        else:
            shared = spade_cond and max(num_stage, 1) > 1
            (self.input_blocks, self.middle_block, self.output_blocks,
             ch) = trunk(mc if shared else None)

        if n_embed is not None:
            self.id_predictor = nn.ModuleDict({
                "0": GroupNorm(ch, eps=1e-5, device=device),
                "1": Conv2d(ch, n_embed, 1, device=device)})
        elif use_split_head:
            self.out = nn.ModuleList([nn.ModuleDict({
                "0": GroupNorm(ch, eps=1e-5, device=device),
                "2": Conv2d(ch, c, 3, padding=1, zero_init=True,
                            device=device)}) for c in split])
        else:
            self.out = nn.ModuleDict({
                "0": GroupNorm(ch, eps=1e-5, device=device),
                "2": Conv2d(ch, out_channels, 3, padding=1, zero_init=True,
                            device=device)})

    def _blocks(self, stage: int = 0):
        """(group, block, [(site name, layer), ...]) for each block of the
        trunk ``stage`` runs, in execution order; the group is
        ``input_blocks``, ``middle_block`` or ``output_blocks``."""
        for group in ("input_blocks", "middle_block", "output_blocks"):
            if self.use_stage_expert:
                name = f"{group}_expert.{stage}"
                blocks = getattr(self, f"{group}_expert")[stage]
            else:
                name, blocks = group, getattr(self, group)
            if group == "middle_block":
                yield group, blocks, [(f"{name}.{j}", m) for j, m in
                                      enumerate(blocks)]
                continue
            for i, layers in enumerate(blocks):
                yield group, layers, [(f"{name}.{i}.{j}", m) for j, m in
                                      enumerate(layers)]

    def _cond_dim(self, stage: int) -> int:
        """Channels of the previous stages that feed SPADE at ``stage``."""
        if not (self.use_split_head and self.use_spade):
            return 0
        return sum(self.split[:stage])

    def spade_tables(self, x_cond: torch.Tensor, stage: int,
                     scope=None) -> Optional[Dict[str, Any]]:
        """Every SPADE site's (gamma, beta) of the trunk ``stage`` runs,
        from the previous stages' channels ``x_cond`` [N, sum(split[:stage]),
        H, W], keyed by site; None without SPADE or at stage 0.

        Those channels are frozen for the whole stage during sampling, so
        the sampler computes the tables once per stage; the result equals
        the in-line computation. The tables read the weights outside a
        forward: ``scope(module)``, where given, is the context in which
        the model itself and then each block are read (sharded training
        gathers them there)."""
        if self._cond_dim(stage) == 0:
            return None
        scope = scope or (lambda module: contextlib.nullcontext())
        with scope(self):
            h_cond = self.pre_input_cond_blocks[stage - 1][0](x_cond)
        hw = tuple(x_cond.shape[-2:])
        tables = {}
        for _, block, layers in self._blocks(stage):
            with scope(block):
                for site, mod in layers:
                    if isinstance(mod, (ResBlock, SpatialTransformer,
                                        AttentionBlock)):
                        tables[site] = mod.spade_tables(h_cond, hw)
                    if isinstance(mod, UNetDownsample) or (
                            isinstance(mod, ResBlock) and mod.down):
                        hw = (hw[0] // 2, hw[1] // 2)
                    elif isinstance(mod, UNetUpsample) or (
                            isinstance(mod, ResBlock) and mod.up):
                        hw = (hw[0] * 2, hw[1] * 2)
        return tables

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None, stage: int = 0,
                spade_pre: Optional[Dict[str, Any]] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x`` [N, C, H, W]; ``context`` [N, T, D] for the
        SpatialTransformer; ``y`` the class labels (int ids with
        ``use_embed``, else [N, num_classes]), given exactly when the model
        has ``num_classes``; ``spade_pre`` from :meth:`spade_tables`."""
        if self.dropout > 0.0 and self.training:
            raise NotImplementedError(
                "PyUNet dropout in training: the JAX package raises "
                "flax.errors.AssignSubModuleError there (ResBlock builds "
                "nn.Dropout in __call__ of a setup module, frido_tpu/nn/"
                "pyunet.py:199-201), so there is no reference to port")
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("y (class labels) is given exactly when the "
                             "model has num_classes")
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed["2"](F.silu(self.time_embed["0"](emb)))
        if y is not None:
            emb = emb + self.label_emb(y)
        if self.num_stage > 1:
            ids = torch.full((x.shape[0],), stage, dtype=torch.long,
                             device=x.device)
            emb = emb + self.stage_emb(ids)

        h_cond = None
        if self.use_split_head:
            cond_dim = self._cond_dim(stage)
            h = self.pre_input_blocks[stage][0](
                x[:, cond_dim:sum(self.split[:stage + 1])])
            # the tables replace the feature map, except for mscond
            if cond_dim and (spade_pre is None or self.use_mscond):
                h_cond = self.pre_input_cond_blocks[stage - 1][0](
                    x[:, :cond_dim])
            hs = [h]
        else:
            h, hs = x, []

        for group, block, layers in self._blocks(stage):
            if group == "output_blocks":
                h = torch.cat([h, hs.pop()], dim=1)
            pres = (None if spade_pre is None else
                    [spade_pre.get(site) for site, _ in layers])
            h = block(h, emb, context, h_cond, pres)
            if group == "input_blocks":
                hs.append(h)

        if self.n_embed is not None:
            return self.id_predictor["1"](self.id_predictor["0"](h))
        head = self.out[stage] if self.use_split_head else self.out
        return head["2"](head["0"](h, fuse_silu=True))
