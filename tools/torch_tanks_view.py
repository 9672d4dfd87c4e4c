#!/usr/bin/env python3
"""Test view 0 of the tanks bundle's scene, drawn in memory, and the
bundle's PSNR on it through cnc_torch on either device.

    python3 tools/torch_tanks_view.py psnr DEVICE [BUNDLE] [--procs P]

The bundle (default runs_tanks/bitstreams/Spheres, cnc_tpu's 1920x1080
NSVF run) was trained on the scene tools/make_tanks_nsvf.py writes.  Its
test views are drawn by that tool's numpy raytracer (`poses(n_test,
seed=2)`, `reference_rays_cv`, `trace`, then `np.round(rgb * 255)`) and
stored as PNGs, which round-trip losslessly; so `view0` draws view 0 in
memory, bit for bit as `SubjectLoaderTanks` would read it, without
imageio: the K, pose and scene box that `make_dataset` writes (through
savetxt/loadtxt, exact in float64, then float32 as the loader casts them),
the box scaled as `load_scene_bbox` scales it, the loader's rays
(`cameras.image_rays`, OpenCV) and its pixels (white background, alpha 1).
View 0's pose does not depend on the number of test views.

`psnr` decodes the bundle through `decode_bundle` on DEVICE ("cpu": the
plain path; "cuda": the kernels), renders view 0 through `render_image`
and prints one JSON line (psnr, ssim, seconds, threads, device); a
progress line goes to stderr every 8 chunks of the render.  On the CPU,
`--procs P` renders the view in P bands of rows, each in a python3
process of its own with one thread (the plain path's many small ops keep
one process far from using a machine's cores: one process with 8 threads
took about 49 minutes for the view on the H100 machine's CPU); the rays
are independent, so the bands' pixels are the whole view's.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
BUNDLE = "runs_tanks/bitstreams/Spheres"


def _maker():
    spec = importlib.util.spec_from_file_location("make_tanks_nsvf",
                                                  REPO / "tools" / "make_tanks_nsvf.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def view0(device, size=None):
    """(rays [H, W] on device, pixels [H, W, 3] on device, aabb float32 [6],
    render_step_size) of test view 0, as SubjectLoaderTanks("Spheres", ...,
    "test") and load_scene_bbox give them; `size` (W, H) replaces the
    tool's 1920x1080 (make_dataset then has to be run at that size too)."""
    import torch
    from cnc_torch.data import cameras
    mk = _maker()
    w, h = size or (mk.W, mk.H)
    focal = 0.5 * w / np.tan(0.5 * 0.6911112070083618)
    K = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]])
    pose = mk.poses(1, seed=2)[0]                    # view 0 of the "1_" (test) prefix
    bbox = np.array([-1.3, -1.3, -1.3, 1.3, 1.3, 1.3, 0.2]).astype(np.float32)
    aabb = (bbox[:6].reshape(2, 3) * 1.2).reshape(-1)
    step = 4e-3 if float(bbox[-1]) >= 0.15 else 1e-3
    x, y = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64),
                       indexing="xy")
    o, v = mk.reference_rays_cv(K, pose, x.ravel(), y.ravel())
    img = np.round(mk.trace(o, v) * 255).astype(np.uint8).reshape(h, w, 3)
    dev = torch.device(device)
    rgb = torch.from_numpy(img.astype(np.float32) / 255.0).to(dev)
    rays = cameras.image_rays(torch.from_numpy(K.astype(np.float32)).to(dev),
                              torch.from_numpy(pose.astype(np.float32)).to(dev), w, h,
                              opengl=False)
    return rays, rgb, aabb, step


def psnr(device: str, bundle: str = BUNDLE, procs: int = 1) -> dict:
    import torch
    from cnc_torch.train import driver
    from cnc_torch.utils import metrics
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("psnr: no CUDA device")
    t0 = time.time()
    field, binaries, cfg = driver.decode_bundle(bundle, device=dev, log_fn=lambda m: None)
    decode_s = time.time() - t0
    rays, gt, aabb, step = view0(dev)
    if not (np.array_equal(np.asarray(cfg.render.aabb, np.float32), aabb)
            and cfg.render.render_step_size == step):
        raise AssertionError(f"the bundle's box {cfg.render.aabb} / step"
                             f" {cfg.render.render_step_size} are not the scene's {aabb} / {step}")
    t0 = time.time()
    if procs > 1:
        if dev.type != "cpu":
            raise ValueError("psnr: --procs is for the CPU")
        rgb = _render_in_bands(field, binaries, cfg, procs)
    else:
        rgb = _render(field, binaries, cfg, aabb, rays, dev, "")
    render_s = time.time() - t0
    return {"bundle": bundle, "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                                         else "cpu"),
            "threads": torch.get_num_threads(), "procs": procs, "decode_s": decode_s,
            "render_s": render_s, "psnr": float(metrics.psnr(rgb, gt)),
            "ssim": float(metrics.ssim(rgb, gt))}


def _render(field, binaries, cfg, aabb, rays, dev, tag):
    import torch
    from cnc_torch.render import renderer
    t0 = time.time()
    progress = lambda done, total: print(f"{tag}render chunk {done}/{total}"
                                         f" {time.time() - t0:.0f} s", file=sys.stderr, flush=True)
    return renderer.render_image(field, cfg.model, cfg.render, torch.from_numpy(aabb).to(dev),
                                 binaries, rays.origins, rays.viewdirs,
                                 torch.ones(3, device=dev), device=dev, progress_fn=progress)[0]


def _render_in_bands(field, binaries, cfg, procs, size=None):
    """The view (of `size`, as view0 takes it) rendered on the CPU by
    `procs` processes, a band of rows each, from the decoded field saved
    once to a temporary file."""
    import subprocess
    import tempfile
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"field": field, "binaries": binaries, "cfg": cfg, "size": size},
                   Path(tmp) / "field.pt")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        workers = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "band", tmp,
                                     str(i), str(procs)], env=env) for i in range(procs)]
        if any(w.wait() != 0 for w in workers):
            raise RuntimeError("psnr: a band's process failed")
        return torch.cat([torch.load(Path(tmp) / f"band{i}.pt") for i in range(procs)])


def band(tmp: str, index: int, procs: int) -> None:
    """One band of rows of view 0 on the CPU, one thread, saved to tmp."""
    import torch
    torch.set_num_threads(1)
    saved = torch.load(Path(tmp) / "field.pt", weights_only=False)
    rays, _, aabb, _ = view0("cpu", saved["size"])
    h = rays.origins.shape[0]
    r0, r1 = index * h // procs, (index + 1) * h // procs
    part = type(rays)(**{k: getattr(rays, k)[r0:r1] for k in rays._fields})
    rgb = _render(saved["field"], saved["binaries"], saved["cfg"], aabb, part,
                  torch.device("cpu"), f"band {index}: ")
    torch.save(rgb, Path(tmp) / f"band{index}.pt")


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["psnr"] and len(args) in (2, 3, 4, 5):
        sys.path.insert(0, str(REPO))
        procs = 1
        if "--procs" in args:
            i = args.index("--procs")
            procs = int(args[i + 1])
            args = args[:i] + args[i + 2:]
        print(json.dumps(psnr(args[1], *args[2:], procs=procs)), flush=True)
        return 0
    if args[:1] == ["band"] and len(args) == 4:
        sys.path.insert(0, str(REPO))
        band(args[1], int(args[2]), int(args[3]))
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
