"""Training entry point: one process on one card, or one process a rank.

    python -m cvvae_tpu_torch.train --base configs/sd3_latent_constraint.yaml \
        --train [--max_steps N] [--logdir runs/exp] [--resume] \
        [--device cuda|cuda:N|cpu] [--scale_lr] [key.path=value ...]
    torchrun --nproc_per_node 8 -m cvvae_tpu_torch.train --base ... --train

Port of ``cvvae_tpu/train.py``.  The YAML is the JAX package's (its
``cvvae_tpu.*`` targets resolve to the same classes here,
``utils/config.resolve_target``); dotlist overrides set any key, e.g.
``model.allow_random_lpips=true`` or ``data.train.datasets.webvid.
urls_or_dir=/data/csv``.  It runs on the card unless ``--device cpu``.

Data parallelism: under torchrun, ``multihost_init`` joins the group
(NCCL on cards, gloo with ``--device cpu``); a caller that forms the
default group itself (gloo for ranks sharing one card) is joined as it
is.  Each rank trains on ``cuda:{LOCAL_RANK}`` (``--device cuda``; an
index given is kept) on its own shard of the train and val data
(``shard_id`` = rank), with the replicated state of
``Trainer(mesh=process_mesh(...))``; rank 0 writes the logdir.  A rank's
batch is the config's ``batch_size``, so the global batch is world x
batch_size.

``--scale_lr`` scales base_lr by the global batch: world size times the
per-process batch size, which the train datasets must agree on.
"""

from __future__ import annotations

import argparse
import datetime
import os
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist


def build_engine(model_cfg: Dict, device="cuda"):
    """(engine, warm-start checkpoint path or None) from the config's
    ``model`` section."""
    from cvvae_tpu_torch.training.engine import EngineConfig, TrainingEngine
    from cvvae_tpu_torch.utils.config import instantiate_from_config

    engine_cfg = instantiate_from_config(model_cfg["engine"])
    assert isinstance(engine_cfg, EngineConfig)
    kwargs = {}
    frozen = model_cfg.get("frozen_ckpts") or {}
    # pretrained LPIPS is loaded before the engine is built: without it
    # the engine refuses a random one unless the config opts in
    if frozen.get("lpips"):
        from cvvae_tpu_torch.models.lpips import load_lpips_params
        blob = torch.load(frozen["lpips"], map_location="cpu")
        kwargs["lpips_params"] = load_lpips_params(blob["vgg"], blob["lins"])
    if model_cfg.get("allow_random_lpips"):
        kwargs["allow_random_lpips"] = True
    for name in ("constraint_decoder", "constraint_encoder"):
        if frozen.get(name):
            from cvvae_tpu_torch.utils.convert import \
                load_torch_checkpoint_file
            prefix = "decoder" if name == "constraint_decoder" else "encoder"
            tree, _ = load_torch_checkpoint_file(frozen[name],
                                                 prefixes=(prefix,))
            kwargs[f"{name}_params"] = {
                k[len(prefix) + 1:]: v for k, v in tree.items()
                if k.startswith(prefix + ".")}
    engine = TrainingEngine(engine_cfg, seed=model_cfg.get("seed", 0),
                            device=device, **kwargs)
    for name, module in engine.left_out.items():
        print(f"[train] {name}: {frozen[name]} has no {module}; the frozen "
              f"net runs without it (legacy_quant_conv asked for it)")
    return engine, model_cfg.get("ckpt_path")


def _subtree(key: str) -> str:
    return key.split(".", 1)[0]


def _some(keys, n: int = 20) -> str:
    keys = sorted(keys)
    more = f" and {len(keys) - n} more" if len(keys) > n else ""
    return f"{keys[:n]}{more}"


def warm_start(params: torch.nn.Module, tree: Dict[str, torch.Tensor],
               path: str = "the checkpoint") -> list:
    """Load a warm-start checkpoint's converted state dict ``tree`` into
    ``params`` (the generator's ``VAEParams``), as the JAX package does:
    each top-level subtree of the params that the checkpoint also has is
    replaced whole, the others keep their init.  A shared subtree whose
    keys do not match the checkpoint's one for one raises a ValueError
    naming the missing and extra keys (the JAX package fails there too,
    at the first forward); so does a checkpoint that shares no subtree
    with the params (which the JAX package trains past from its init).
    Returns the names of the subtrees loaded."""
    own = params.state_dict()
    shared = sorted({_subtree(k) for k in own} & {_subtree(k) for k in tree})
    if not shared:
        raise ValueError(
            f"warm start from {path}: it shares no top-level subtree with "
            f"the params (it has {sorted({_subtree(k) for k in tree})}, the "
            f"params {sorted({_subtree(k) for k in own})})")
    new = dict(own)
    for name in shared:
        mine = {k for k in own if _subtree(k) == name}
        theirs = {k for k in tree if _subtree(k) == name}
        if mine != theirs:
            raise ValueError(
                f"warm start from {path}: subtree {name!r} does not match "
                f"the params: missing {_some(mine - theirs)}, extra "
                f"{_some(theirs - mine)}")
        new.update({k: tree[k] for k in theirs})
    params.load_state_dict(new, strict=True)
    return shared


def apply_lr_scaling(cfg: Dict, world_size: int = 1) -> float:
    """--scale_lr: base_lr *= the global batch (world size x the
    per-process batch size, which the train datasets must agree on); the
    linear scaling rule."""
    sizes = {ds.get("batch_size", 1)
             for ds in cfg["data"]["train"]["datasets"].values()}
    if len(sizes) != 1:
        raise SystemExit(
            f"--scale_lr needs a uniform train batch_size across datasets, "
            f"got {sorted(sizes)}; set "
            f"model.engine.params.optim.params.base_lr directly instead")
    optim = cfg["model"]["engine"]["params"]["optim"]["params"]
    base = float(optim["base_lr"])
    global_batch = world_size * sizes.pop()
    optim["base_lr"] = global_batch * base
    print(f"[train] --scale_lr: base_lr {base:.2e} -> {optim['base_lr']:.2e}"
          f" (global batch {global_batch} = {world_size} process(es) x "
          f"{global_batch // world_size})")
    return optim["base_lr"]


def build_data(data_cfg: Dict, *, shard_id: int = 0,
               num_shards: int = 1) -> Iterator:
    from cvvae_tpu_torch.data import pipeline as pl
    from cvvae_tpu_torch.utils.config import get_obj_from_str

    datasets, weights = {}, {}
    for name, ds in data_cfg["datasets"].items():
        kind = ds.get("kind", "webdataset")
        decoder = None
        if "decoder" in ds:
            factory = get_obj_from_str(ds["decoder"]["target"])
            decoder = factory(**(ds["decoder"].get("params") or {}))
        common = dict(
            urls_or_dir=ds["urls_or_dir"],
            file_mask=ds.get("file_mask", "*.tar" if kind == "webdataset"
                             else "*.csv"),
            repeat=ds.get("repeat"), decoder=decoder,
            select_keys=ds.get("select_keys", ("frames",)),
            batch_size=ds.get("batch_size", 1),
            num_workers=ds.get("num_workers", 4),
            prefetch=ds.get("prefetch", 2),
            seed=ds.get("seed", 0), shard_id=shard_id, num_shards=num_shards)
        if kind == "webdataset":
            datasets[name] = pl.build_webdataset_pipeline(
                shardshuffle=ds.get("shardshuffle", 0),
                sample_shuffle=ds.get("sample_shuffle", 0), **common)
        else:
            datasets[name] = pl.build_metadata_pipeline(
                sample_shuffle=ds.get("sample_shuffle", 0), **common)
        weights[name] = ds.get("weight", 1.0)
    if len(datasets) == 1:
        return next(iter(datasets.values()))
    return pl.build_multi_dataset(datasets, weights,
                                  seed=data_cfg.get("seed", 58),
                                  shard_id=shard_id)


def main(argv=None, step_callback=None):
    """Run training; returns (trainer, final state) when ``--train``."""
    from cvvae_tpu_torch.parallel.data import process_mesh
    from cvvae_tpu_torch.parallel.mesh import multihost_init
    from cvvae_tpu_torch.training.trainer import Trainer
    from cvvae_tpu_torch.utils.config import load_configs, save_config

    p = argparse.ArgumentParser()
    p.add_argument("--base", nargs="+", required=True)
    p.add_argument("--train", action="store_true")
    p.add_argument("--logdir", default=None)
    p.add_argument("--name", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: cuda:LOCAL_RANK), cuda:N or cpu")
    p.add_argument("--scale_lr", action="store_true",
                   help="scale base_lr by the global batch (world size x "
                        "per-process batch size)")
    args, unknown = p.parse_known_args(argv)
    bad = [u for u in unknown if "=" not in u]
    if bad:
        p.error(f"unrecognized arguments: {' '.join(bad)}")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("train: no CUDA device; pass --device cpu to "
                             "train on the CPU")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        torch.cuda.set_device(device)
    multihost_init("gloo" if device.type == "cpu" else None)
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))

    cfg = load_configs(args.base, unknown)
    if args.scale_lr:
        apply_lr_scaling(cfg, world_size=world)
    if args.logdir is None:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        name = args.name or os.path.splitext(os.path.basename(args.base[0]))[0]
        args.logdir = os.path.join("logs", f"{now}_{name}")
    if world > 1:  # rank 0's name, which it alone writes to
        named = [args.logdir]
        dist.broadcast_object_list(named, src=0)
        args.logdir = named[0]
    if rank == 0:
        os.makedirs(args.logdir, exist_ok=True)
        save_config(cfg, os.path.join(args.logdir, "config.yaml"))

    engine, warm_ckpt = build_engine(cfg["model"], device=device)
    data = build_data(cfg["data"]["train"], shard_id=rank, num_shards=world)
    val_data: Optional[Iterator] = None
    if "val" in cfg.get("data", {}):
        val_data = build_data(cfg["data"]["val"], shard_id=rank,
                              num_shards=world)
    tcfg = cfg.get("trainer", {})
    trainer = Trainer(
        engine, args.logdir,
        mesh=process_mesh(device) if world > 1 else None,
        max_steps=args.max_steps or tcfg.get("max_steps", 200_000),
        ckpt_every=tcfg.get("ckpt_every", 2000),
        permanent_every=tcfg.get("permanent_every", 10_000),
        image_every=tcfg.get("image_every", 250),
        val_every=tcfg.get("val_every"), seed=cfg["model"].get("seed", 0),
        step_callback=step_callback)

    state = None
    if warm_ckpt:
        from cvvae_tpu_torch.utils.convert import load_torch_checkpoint_file
        state = engine.init_state(cfg["model"].get("seed", 0))
        tree, skipped = load_torch_checkpoint_file(warm_ckpt)
        loaded = warm_start(state.params, tree, warm_ckpt)
        print(f"[train] warm-started {len(loaded)} subtree(s) {loaded} from "
              f"{warm_ckpt} ({len(skipped)} keys skipped)")
    if args.train:
        state = trainer.fit(data, state=state, resume=args.resume,
                            val_data=val_data)
        return trainer, state
    return trainer, state


if __name__ == "__main__":
    main()
