"""The multi-rank dry run of sharded training (port of
``__graft_entry__.py::dryrun_multichip``).

    torchrun --nproc_per_node N -m frido_tpu_torch.tools.dryrun_multichip \\
        [--full] [--device cpu]

One process a rank (NCCL on the card, gloo with ``--device cpu``; without
``torchrun`` a world of one). On the JAX dry run's toy model (by default)
or the t2i config at full width (``--full``: 256^2 images, 77 BERT tokens;
the first stage's checkpoint is not read), with seeded weights (the
zero-initialised convs given a seeded init too, so that every leaf has a
gradient at the first step), fp32 (TF32 off), it prints four checks:

1. **DP x TP step**: one train step (AdamW, lr 1e-4, the EMA) on an
   (N/2) x 2 data x model layout when N is even (else N x 1), each data
   index training on its rows of a global batch of 2 a data rank; the
   loss is finite.
2. **FSDP x TP step**: the same step from the same weights with the train
   state sharded over the data ranks as well (``min_size`` 1, so every
   leaf of 2-D or more shards); its loss within ``FSDP_ATOL`` of check
   1's.
3. **Sharded resume**: the FSDP state after its step is saved
   (``io/checkpoint.py``: gathered, rank 0 writes), one more step runs
   uninterrupted, then a fresh model is sharded, restores the saved state
   and replays that step: the two losses within ``RESUME_ATOL``.
4. **Sampling over the ranks**: PLMS-4 sampling and decoding on an N x 1
   layout, each data rank on its rows of the tokens and of ``x_init``,
   equals one process on the whole batch within ``SAMPLE_ATOL``, and the
   per-rank seeds (``mesh.fold_rng_per_device``) are all distinct.

Checks 1 and 2 also print each rank's peak bytes of full parameters and
of full gradients (check 1: every parameter and trainable gradient of the
rank's model shard, held whole; check 2: the FSDP units' counters,
``parallel/fsdp.py``) and, on the card, ``torch.cuda.max_memory_allocated``
of the step. The tolerances are the JAX dry run's. :func:`run` returns the
losses, the errors, the peaks and (on rank 0) the full train states after
checks 1 and 2, for a comparison against one process
(``tests/test_torch_sharding.py``).
"""

from __future__ import annotations

import argparse
import copy
import math
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as tdist

from frido_tpu_torch.config import instantiate_from_config, load_yaml
from frido_tpu_torch.io import checkpoint as ckpt_io
from frido_tpu_torch.nn.layers import _Linearish
from frido_tpu_torch.parallel import dist, fsdp as fsdp_mod, mesh
from frido_tpu_torch.training import optim, trainer as trainer_mod

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
T2I = os.path.join(REPO, "configs", "frido", "t2i", "frido_f16f8_coco.yaml")
FSDP_ATOL = 1e-4
RESUME_ATOL = 1e-6
SAMPLE_ATOL = 1e-4
LR = 1e-4
SAMPLE_STEPS = 4
SEED = 0

# the JAX dry run's toy model (__graft_entry__.py:14-44)
_TINY_ED = dict(multiscale=2, double_z=False, z_channels=[4, 4],
                resolution=32, in_channels=3, out_ch=3, ch=32,
                ch_mult=[1, 1, 2], num_res_blocks=1, attn_resolutions=[8],
                dropout=0.0)
_TINY_DD = dict(double_z=False, z_channels=8, resolution=32, in_channels=3,
                out_ch=3, ch=32, ch_mult=[1, 1], num_res_blocks=1,
                attn_resolutions=[8], dropout=0.0)
TOY = {
    "target": "frido.models.diffusion.frido.FridoDiffusion",
    "params": dict(
        adopted_scale_factor=True, noise_mix_ratio=0.1,
        linear_start=0.0015, linear_end=0.0155, timesteps=100,
        loss_type="l1", image_size=16, channels=8,
        cond_stage_trainable=True, conditioning_key="crossattn",
        scale_by_std=True,
        unet_config={
            "target": "frido.modules.diffusionmodules.pyunet.PyUNetModel",
            "params": dict(
                use_split_head=True, split_embed_dim_list=[4, 4],
                use_SPADE_norm=True, image_size=16, in_channels=8,
                out_channels=8, model_channels=32,
                attention_resolutions=[4, 2], num_res_blocks=1,
                channel_mult=[1, 2], num_head_channels=16,
                use_spatial_transformer=True, transformer_depth=1,
                context_dim=48, num_stage=2)},
        first_stage_config={
            "target": "taming.models.msvqgan.VQModelInterface",
            "params": dict(embed_dim=[4, 4], n_embed=[64, 64],
                           edconfig=_TINY_ED, ddconfig=_TINY_DD,
                           lossconfig={"target":
                                       "taming.modules.losses.DummyLoss"})},
        cond_stage_config={
            "target": "frido.modules.encoders.modules.BERTEmbedder",
            "params": dict(n_embed=48, n_layer=2, vocab_size=64,
                           max_seq_len=12, use_tokenizer=False)},
    ),
}


def config(full: bool) -> Dict[str, Any]:
    """The model config: the toy, or the t2i config without its first
    stage checkpoint."""
    if not full:
        return copy.deepcopy(TOY)
    cfg = load_yaml(T2I)["model"]
    cfg["params"]["first_stage_config"]["params"].pop("ckpt_path", None)
    return cfg


def shapes(model) -> Dict[str, int]:
    """The image side, token count and vocabulary of ``model``."""
    cond = model.cond_stage_model
    return dict(side=model.first_stage_ddconfig["resolution"],
                ctx=cond.max_seq_len,
                vocab=cond.transformer.token_emb.num_embeddings)


def build(cfg: Dict[str, Any], device, seed: int = SEED):
    """The model from ``seed``, its zero-initialised layers given a seeded
    U(+-1/sqrt(fan_in)) init too."""
    model = instantiate_from_config(cfg, device=device, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, _Linearish) and mod.zero_init:
                b = 1.0 / math.sqrt(mod.fan_in)
                mod.weight.uniform_(-b, b, generator=gen)
    return mesh.replicate(model)


def make_batch(n: int, seed: int, dims: Dict[str, int]) -> Dict[str, Any]:
    """Seeded images (standard normal, as the JAX dry run's) and token ids
    of a global batch of ``n``."""
    s = dims["side"]
    return {"image": np.random.RandomState(seed).randn(n, s, s, 3).astype(
                np.float32),
            "tokens": np.random.RandomState(seed + 1).randint(
                0, dims["vocab"], (n, dims["ctx"])).astype(np.int64)}


def make_trainer(model, world: dist.World, n_model: int, fsdp: bool,
                 min_size: int = 1):
    params = [p for _, p in trainer_mod.trainable_parameters(model)]
    return trainer_mod.DiffusionTrainer(
        model, optim.build_optimizer(params, LR), use_ema=True,
        rank=world.rank, world_size=world.world_size, n_model=n_model,
        fsdp=fsdp, min_size=min_size)


def _peaks(tr) -> Dict[str, int]:
    """This rank's peak full-parameter and full-gradient bytes in the last
    step: the FSDP units' counters, or (no units) every parameter and
    every trainable gradient, all held whole."""
    c = tr.fsdp_counters()
    if c:
        return {"param": c["peak_full_param_bytes"],
                "grad": c["peak_full_grad_bytes"]}
    params = list(tr.model.parameters())
    return {"param": fsdp_mod.resident_bytes(params),
            "grad": fsdp_mod.resident_bytes(
                [p for p in params if p.requires_grad])}


def _per_rank(x: Dict[str, int], world: dist.World, device):
    """``x`` of every rank (rank order), on every rank."""
    keys = sorted(x)
    t = torch.tensor([float(x[k]) for k in keys], dtype=torch.float64,
                     device=device)
    if world.world_size == 1:
        rows = [t]
    else:
        rows = [torch.empty_like(t) for _ in range(world.world_size)]
        tdist.all_gather(rows, t)
    return [{k: int(v) for k, v in zip(keys, r.tolist())} for r in rows]


def _measured_step(tr, batch, seed, world, device):
    """:func:`step`, and every rank's peaks (with the card's peak
    allocation on ``cuda``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    loss = step(tr, batch, seed)
    mine = _peaks(tr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        mine["max_allocated"] = torch.cuda.max_memory_allocated(device)
    return loss, _per_rank(mine, world, device)


def _gib(rows) -> str:
    return "; ".join(", ".join(f"{k} {v / 2 ** 30:.4g} GiB"
                               for k, v in sorted(r.items()))
                     for r in rows)


def step(tr, batch, seed: int) -> float:
    """One train step on this data index's rows of ``batch``, the draws
    from a CPU generator seeded with ``seed`` (the same on every rank)."""
    logs = tr.train_step(mesh.shard_batch(batch, tr.layout),
                         torch.Generator().manual_seed(seed))
    return float(logs["loss"])


def _shared_tmpdir(world: dist.World) -> str:
    box = [tempfile.mkdtemp(prefix="dryrun_ckpt_") if world.main else None]
    if world.world_size > 1:
        tdist.broadcast_object_list(box, src=0)
    return box[0]


def _barrier(world: dist.World) -> None:
    if world.world_size > 1:
        tdist.barrier()


@torch.no_grad()
def sample_pipeline(model, tokens, x_init) -> torch.Tensor:
    ctx = model.get_learned_conditioning(tokens)
    z = model.sample(tokens.shape[0], context=ctx, steps=SAMPLE_STEPS,
                     eta=0.0, sampler="plms",
                     x_init=torch.as_tensor(x_init))
    return model.decode_first_stage(z)


def _max_over_ranks(x: float, world: dist.World, device) -> float:
    if world.world_size == 1:
        return x
    t = torch.tensor([x], dtype=torch.float64, device=device)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return float(t.item())


def run(world: dist.World, device, full: bool = False, log=print,
        cfg: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The four checks on this rank (on ``cfg`` when given); raises on a
    failed one. Returns the losses and errors, and on rank 0 the full
    train states after checks 1 and 2 (``dp_tp_state``,
    ``fsdp_tp_state``)."""
    n = world.world_size
    n_model = 2 if n % 2 == 0 and n > 1 else 1
    n_data = n // n_model
    tag = f"dryrun_multichip({n})"
    cfg = config(full) if cfg is None else cfg
    out: Dict[str, Any] = {"n_data": n_data, "n_model": n_model}

    # 1. DP x TP
    model = build(cfg, device)
    dims = shapes(model)
    batch = make_batch(2 * n_data, 0, dims)
    tr = make_trainer(model, world, n_model, fsdp=False)
    loss, out["peaks_dp_tp"] = _measured_step(tr, batch, 0, world, device)
    if not math.isfinite(loss):
        raise AssertionError(f"{tag}: non-finite loss {loss}")
    out["loss"] = loss
    out["dp_tp_state"] = ckpt_io.train_state(tr)
    log(f"{tag}: one train step OK on {n_data}x{n_model} (data x model) "
        f"layout, loss={loss:.4f}; peak full bytes a rank: "
        f"{_gib(out['peaks_dp_tp'])}")
    del tr, model

    # 2. FSDP x TP, min_size 1
    model = build(cfg, device)
    tr = make_trainer(model, world, n_model, fsdp=True)
    loss_f, out["peaks_fsdp_tp"] = _measured_step(tr, batch, 0, world,
                                                  device)
    if not (math.isfinite(loss_f) and abs(loss_f - loss) < FSDP_ATOL):
        raise AssertionError(f"{tag}: FSDP loss {loss_f} vs {loss}")
    out["loss_fsdp"] = loss_f
    state = ckpt_io.train_state(tr)
    out["fsdp_tp_state"] = state
    log(f"{tag}: FSDP x TP train step OK, loss={loss_f:.4f} (matches "
        f"replicated); peak full bytes a rank: "
        f"{_gib(out['peaks_fsdp_tp'])}")

    # 3. save -> uninterrupted step; fresh model -> restore -> replay
    tmp = _shared_tmpdir(world)
    try:
        if world.main:
            ckpt_io.save_train_state(tmp, 1, state)
        _barrier(world)
        batch2 = make_batch(2 * n_data, 2, dims)
        loss_cont = step(tr, batch2, 1)
        del tr, model
        model = build(cfg, device, seed=SEED + 7)
        tr = make_trainer(model, world, n_model, fsdp=True)
        restored = ckpt_io.restore_train_state(tmp, tr)
        if restored != 1:
            raise AssertionError(f"{tag}: restored step {restored}")
        loss_res = step(tr, batch2, 1)
        _barrier(world)
    finally:
        if world.main:
            shutil.rmtree(tmp, ignore_errors=True)
    if not (math.isfinite(loss_res)
            and abs(loss_res - loss_cont) < RESUME_ATOL):
        raise AssertionError(f"{tag}: resumed loss {loss_res} vs "
                             f"uninterrupted {loss_cont}")
    out.update(loss_cont=loss_cont, loss_res=loss_res)
    log(f"{tag}: FSDP save->restore->resume step matches uninterrupted "
        f"continuation (loss {loss_res:.6f} == {loss_cont:.6f})")
    del tr, model

    # 4. sampling over an N x 1 layout
    flat = mesh.make_layout(n, world.rank, 1)
    model = build(cfg, device).eval()
    bs = 2 * n
    tokens = np.random.RandomState(4).randint(
        0, dims["vocab"], (bs, dims["ctx"])).astype(np.int64)
    x_init = np.random.RandomState(5).standard_normal(
        (bs, model.image_size, model.image_size, model.channels)).astype(
            np.float32)
    single = sample_pipeline(model, torch.from_numpy(tokens), x_init)
    rows = dist.rank_rows(bs, flat.data_index, flat.n_data)
    mine = sample_pipeline(model, torch.from_numpy(tokens[rows]),
                           x_init[rows])
    err = _max_over_ranks(float((mine - single[rows]).abs().max()), world,
                          device)
    seeds = mesh.fold_rng_per_device(SEED, flat)
    if not (err <= SAMPLE_ATOL and len(set(seeds)) == n):
        raise AssertionError(f"{tag}: sharded sampling error {err}, seeds "
                             f"{seeds}")
    out.update(sample_err=err, seeds=seeds)
    log(f"{tag}: sharded sample+decode over the {n}-rank data layout "
        f"matches one process (max|diff|={err:.2e}), per-rank seeds all "
        f"distinct")
    return out


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--full", action="store_true",
                   help="the t2i config at full width, not the toy")
    p.add_argument("--device", default=None,
                   help="torch device type (default: the card)")
    args = p.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("the dry run runs on the card by default and no "
                           "CUDA device is available; pass --device cpu")
    world = dist.init_from_env(args.device or "cuda")
    device = (torch.device(args.device) if args.device
              else torch.device("cuda", world.local_rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return run(world, device, args.full,
                   log=print if world.main else (lambda *a: None))
    finally:
        dist.shutdown(world)


if __name__ == "__main__":
    main()
