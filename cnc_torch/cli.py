"""Command-line drivers of the port: the bodies of the repo-root scripts
`train_cnc_nerf_synthetic.py` and `train_cnc_tank_temples.py`.

    python3 -m cnc_torch.cli nerf_synthetic --scene chair --lmbda 2e-3 ...
    python3 -m cnc_torch.cli tank_temples --scene Barn ...

The same flags, defaults and output layout as those scripts (the pipeline
of `train/driver.py`, one TSV row under <out_root>/results/<dataset>/, the
bundle under <out_root>/bitstreams/<scene>/), and the same fallback to the
procedural `blocks` scene when the dataset is not on disk.  `--device` picks
the device (default: the card; `cpu` runs the plain twins).
`--checkpoint_path` resumes a run from its file.

`--multichip` trains data parallel over rays (`parallel/sharding.py`) and
means "launched by torchrun", one process a card:

    torchrun --nproc_per_node=N -m cnc_torch.cli nerf_synthetic --multichip ...

Each rank runs on cuda:LOCAL_RANK (NCCL); rank 0 evaluates, encodes, writes
the row and prints.  Without torchrun's environment it raises, where the
root drivers fall back to one device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import sys
from typing import List, Optional


def _common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--lmbda", type=float, default=2e-3)
    parser.add_argument("--Pg_level", type=int, default=12)
    parser.add_argument("--Pg_level_2D", type=int, default=4)
    parser.add_argument("--log2_hashmap_size", type=int, default=19)
    parser.add_argument("--log2_hashmap_size_2D", type=int, default=17)
    parser.add_argument("--sample_num", type=int, default=200000)
    parser.add_argument("--max_context_layer_num", type=int, default=3)
    parser.add_argument("--n_features", type=int, default=4)
    parser.add_argument("--max_steps", type=int, default=20000)
    parser.add_argument("--max_eval_images", type=int, default=None)
    parser.add_argument("--out_root", type=str, default=".")
    parser.add_argument("--ctx_grad", type=int, default=1,
                        help="0: stop-gradient the coarser-level context lookups in the rate "
                             "estimate (see EntropyConfig)")
    parser.add_argument("--visible_frac", type=float, default=None,
                        help="prune invisible samples before the differentiable field eval, "
                             "compacting to this fraction of the sample buffer; None = "
                             "evaluate every marched sample")
    parser.add_argument("--rate_update_interval", type=int, default=1,
                        help="run the entropy rate gradients every K steps (1 = reference "
                             "schedule)")
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="enable checkpoint/auto-resume at this path")
    parser.add_argument("--checkpoint_every", type=int, default=1000)
    parser.add_argument("--decode_only", action="store_true",
                        help="rebuild the field from bitstreams/<scene>/ in a fresh process, "
                             "render the test set, report PSNR (no training)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "PyTorch path)")
    parser.add_argument("--multichip", action="store_true",
                        help="data-parallel training over the ranks torchrun starts, one "
                             "process a card on cuda:LOCAL_RANK (see python3 -m "
                             "cnc_torch.cli's docstring)")


_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _multichip_group(args):
    """The data-parallel group torchrun's environment describes, or None
    without --multichip; raises when the launcher is missing."""
    if not args.multichip:
        return None
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multichip runs under torchrun (torchrun --nproc_per_node=N -m "
                           f"cnc_torch.cli ... --multichip); {', '.join(missing)} not set")
    from .parallel import sharding
    return sharding.make_group(device=args.device)


def _run(args, cfg, train_ds, test_ds, dataset_name, dev, group, summary):
    """The pipeline and its row (rank 0's alone under --multichip)."""
    from .parallel import sharding
    from .train import driver
    try:
        result = driver.run_pipeline(cfg, train_ds, test_ds, args.scene, out_root=args.out_root,
                                     max_eval_images=args.max_eval_images, device=dev,
                                     group=group)
        if result is not None:
            driver.append_result_row(result, args.scene, dataset_name, args.out_root)
            print(summary(result))
    finally:
        if group is not None:
            sharding.destroy_group(group)


def _procedural(dev):
    from .data.scenes import ProceduralDataset
    return (ProceduralDataset("blocks", n_images=24, width=256, height=256, split="train",
                              device=dev),
            ProceduralDataset("blocks", n_images=8, width=256, height=256, split="test",
                              device=dev))


def _decode_only(args, test_ds, dev, group=None) -> None:
    """Decode the bundle and score the test set (rank 0's alone under
    --multichip)."""
    if group is not None:
        from .parallel import sharding
        rank = group.rank
        sharding.destroy_group(group)
        if rank != 0:
            return
    import numpy as np
    import torch

    from .render import renderer
    from .train import driver
    from .utils import metrics as M

    stream_dir = os.path.join(args.out_root, "bitstreams", args.scene)
    field, binaries, bcfg = driver.decode_bundle(stream_dir, device=dev)
    n = (len(test_ds) if args.max_eval_images is None
         else min(args.max_eval_images, len(test_ds)))
    aabb = torch.tensor(bcfg.render.aabb, dtype=torch.float32, device=dev)
    psnrs = []
    for i in range(n):
        rays, gt = test_ds.image_and_rays(i)
        rgb, _, _ = renderer.render_image(field, bcfg.model, bcfg.render, aabb, binaries,
                                          rays.origins, rays.viewdirs, torch.ones(3),
                                          device=dev)
        psnrs.append(float(M.psnr(rgb, gt)))
    print(f"decode_only: psnr={np.mean(psnrs):.3f} over {n} images")


def main_nerf_synthetic(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python3 -m cnc_torch.cli nerf_synthetic")
    parser.add_argument("--data_root", type=str,
                        default=str(pathlib.Path.cwd() / "data/nerf_synthetic"))
    parser.add_argument("--train_split", type=str, default="train",
                        choices=["train", "trainval"])
    parser.add_argument("--scene", type=str, default="chair")
    _common_flags(parser)
    args = parser.parse_args(argv)

    from .config import CNCConfig, EntropyConfig, ModelConfig, RenderConfig, TrainConfig
    from .utils.device import resolve_device

    group = _multichip_group(args)
    dev = group.device if group is not None else resolve_device(args.device)
    weight_decay = 2e-5 if args.scene in ("drums",) else 2e-6
    cfg = CNCConfig(
        model=ModelConfig(n_features_per_level=args.n_features,
                          log2_hashmap_size=args.log2_hashmap_size,
                          log2_hashmap_size_2D=args.log2_hashmap_size_2D),
        entropy=EntropyConfig(n_features=args.n_features, sample_num=args.sample_num,
                              max_context_layer_num=args.max_context_layer_num,
                              Pg_level=args.Pg_level, Pg_level_2D=args.Pg_level_2D,
                              ctx_grad=bool(args.ctx_grad)),
        render=dataclasses.replace(RenderConfig(), visible_frac=args.visible_frac),
        train=dataclasses.replace(TrainConfig(), lmbda=args.lmbda, weight_decay=weight_decay,
                                  max_steps=args.max_steps,
                                  rate_update_interval=args.rate_update_interval,
                                  checkpoint_path=args.checkpoint_path,
                                  checkpoint_every=args.checkpoint_every),
    )

    scene_dir = os.path.join(args.data_root, args.scene)
    if os.path.isdir(scene_dir):
        from .data.nerf_synthetic import SubjectLoader
        train_ds = SubjectLoader(args.scene, args.data_root, args.train_split,
                                 num_rays=cfg.train.init_batch_size, device=dev)
        test_ds = SubjectLoader(args.scene, args.data_root, "test", device=dev)
        dataset_name = "Synthetic-NeRF"
    else:
        print(f"[cnc_torch] dataset not found at {scene_dir}; using a procedural scene "
              f"through the same pipeline")
        train_ds, test_ds = _procedural(dev)
        dataset_name = "Procedural"

    if args.decode_only:
        _decode_only(args, test_ds, dev, group)
        return

    _run(args, cfg, train_ds, test_ds, dataset_name, dev, group,
         lambda r: (f"psnr={r.psnr:.3f} psnr_codec={r.psnr_codec:.3f} "
                    f"size={r.embed_MB_codec:.4f}MB total={r.total_size_MB():.4f}MB"))


def main_tank_temples(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python3 -m cnc_torch.cli tank_temples")
    parser.add_argument("--data_root", type=str,
                        default=str(pathlib.Path.cwd() / "data/TanksAndTemple"))
    parser.add_argument("--train_split", type=str, default="train",
                        choices=["train", "trainval"])
    parser.add_argument("--scene", type=str, default="Barn")
    _common_flags(parser)
    parser.add_argument("--eval_spi", type=int, default=None,
                        help="eval per-round sample budget (RenderConfig.eval_samples_per_iter)")
    args = parser.parse_args(argv)

    from .config import CNCConfig, EntropyConfig, ModelConfig, RenderConfig, TrainConfig
    from .data import tanks
    from .utils.device import resolve_device

    group = _multichip_group(args)
    dev = group.device if group is not None else resolve_device(args.device)
    scene_dir = os.path.join(args.data_root, args.scene)
    if os.path.isdir(scene_dir):
        aabb, step = tanks.load_scene_bbox(args.data_root, args.scene)
        train_ds = tanks.SubjectLoaderTanks(args.scene, args.data_root, args.train_split,
                                            num_rays=1024, device=dev)
        test_ds = tanks.SubjectLoaderTanks(args.scene, args.data_root, "test", device=dev)
        render = RenderConfig(visible_frac=args.visible_frac,
                              aabb=tuple(float(x) for x in aabb),
                              near_plane=train_ds.NEAR, render_step_size=step)
        dataset_name = "TanksAndTemple"
    else:
        print(f"[cnc_torch] dataset not found at {scene_dir}; using a procedural scene "
              f"through the same pipeline")
        train_ds, test_ds = _procedural(dev)
        render = RenderConfig(visible_frac=args.visible_frac)
        dataset_name = "Procedural"
    if args.eval_spi:
        render = dataclasses.replace(render, eval_samples_per_iter=args.eval_spi)

    cfg = CNCConfig(
        model=ModelConfig(n_features_per_level=args.n_features,
                          log2_hashmap_size=args.log2_hashmap_size,
                          log2_hashmap_size_2D=args.log2_hashmap_size_2D),
        entropy=EntropyConfig(n_features=args.n_features, sample_num=args.sample_num,
                              max_context_layer_num=args.max_context_layer_num,
                              Pg_level=args.Pg_level, Pg_level_2D=args.Pg_level_2D,
                              ctx_grad=bool(args.ctx_grad)),
        render=render,
        train=dataclasses.replace(TrainConfig(), lmbda=args.lmbda, max_steps=args.max_steps,
                                  rate_update_interval=args.rate_update_interval,
                                  checkpoint_path=args.checkpoint_path,
                                  checkpoint_every=args.checkpoint_every),
    )

    if args.decode_only:
        _decode_only(args, test_ds, dev, group)
        return

    _run(args, cfg, train_ds, test_ds, dataset_name, dev, group,
         lambda r: (f"psnr={r.psnr:.3f} psnr_codec={r.psnr_codec:.3f} "
                    f"size={r.embed_MB_codec:.4f}MB"))


DRIVERS = {"nerf_synthetic": main_nerf_synthetic, "tank_temples": main_tank_temples}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in DRIVERS:
        print(f"usage: python3 -m cnc_torch.cli {{{','.join(DRIVERS)}}} [flags]  "
              f"(--help after the driver's name lists its flags)", file=sys.stderr)
        return 2
    DRIVERS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
