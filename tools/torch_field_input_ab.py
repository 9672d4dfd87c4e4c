#!/usr/bin/env python3
"""A/B of the radiance field's input row (`radiance_field.encode_position`)
between trees, on one NVIDIA GPU: K1f (one launch) against the composition
(four K1 launches, three plane indices, `sine_embed`, `torch.cat`).

    python3 tools/torch_field_input_ab.py prepare WORK
    python3 tools/torch_field_input_ab.py time WORK TREE LABEL >> LOG
    python3 tools/torch_field_input_ab.py summary LOG

`prepare` makes the inputs with this tree's cnc_torch and saves them to
WORK/inputs.pt: a full-width field with random weights (seed 0, its tables
quantized as a view reads them), the occupancy grid of the `blocks` scene,
the rays of an 800x800 view (chip_smoke.py's pose), and the positions of
the first eval round of two chunks of that view's rays, strided over the
image: 65,536 rays (the serving cells' chunk; 524,288 slots) and 8,192
rays (65,536 slots), normalised to [0,1]^3.

`time` imports cnc_torch from TREE (a directory holding another version's
`cnc_torch/`, e.g. a commit unpacked with `git archive`) and builds its
kernels into TREE/cnc_torch/_build.  At each of the two sizes, under
no_grad as the eval loop calls it: `encode_position` with the given
tables (ms with the host by CUDA events, device ms behind a spin kernel:
chip_smoke.py's `time_ms` and `device_ms`), the launches one call counts,
and a digest of the row (equal across trees; the grid columns' sum in
float64).  In a tree with `composed_position` it also times the
composition (the yardstick K1f replaces) and holds K1f's row to it (grid
columns bit-equal, sine columns within chip_smoke.FIELD_SINE_TOL).  Last,
the view through `render_image` in chunks of 65,536 rays: the median of
five renders' ms.  One JSON line.

Times vary between calls by up to 1.5x: compare trees only within one call,
in turns (parent, new, new, parent), e.g.

    for t in parent new new parent; do
        python3 tools/torch_field_input_ab.py time WORK trees/$t $t; done
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SIZES = {"524288": 65_536, "65536": 8_192}     # points: the chunk's rays, 8 slots each
VIEW_CHUNK = 65_536


def _smoke():
    sys.path.insert(1, str(REPO))
    import chip_smoke
    return chip_smoke


def prepare(work: Path) -> None:
    import torch
    sys.path.insert(0, str(REPO))
    cs = _smoke()
    from cnc_torch.config import ModelConfig, RenderConfig
    from cnc_torch.data import cameras, scenes
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.render import marching

    dev = torch.device("cuda")
    mcfg, rcfg = ModelConfig(), RenderConfig()
    field = rf.RadianceField(mcfg, torch.Generator().manual_seed(0), device=dev)
    aabb = torch.tensor(rcfg.aabb, dtype=torch.float32, device=dev)
    binaries = scenes.occupancy_from_scene(scenes.make_scene("blocks"), rcfg.occ_resolution,
                                           rcfg.render_step_size, device=dev)
    view = cs.VIEW
    K = torch.tensor([[0.8 * view, 0, view / 2.0], [0, 0.8 * view, view / 2.0], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    c2w = torch.from_numpy(cameras.look_at_poses(1, radius=3.2, seed=1000,
                                                 full_sphere=True)[0]).to(dev)
    rays = cameras.image_rays(K, c2w, view, view)
    points = {}
    with torch.no_grad():
        tables = {k: v.contiguous() for k, v in rf.quantized_tables(field, mcfg).items()}
        mip = marching.build_march_mip(binaries)
        for label, chunk in SIZES.items():
            o = rays.origins.reshape(-1, 3)[::view * view // chunk][:chunk].contiguous()
            d = rays.viewdirs.reshape(-1, 3)[::view * view // chunk][:chunk].contiguous()
            smp = marching.march_rays(o, d, binaries, aabb, rcfg,
                                      chunk * rcfg.eval_samples_per_iter,
                                      ray_mask=torch.ones(chunk, dtype=torch.bool, device=dev),
                                      t_start=torch.full((chunk,), rcfg.near_plane, device=dev),
                                      mip=mip)
            pos, _ = marching.sample_positions(smp, o, d)
            points[label] = ((pos - aabb[:3]) / (aabb[3:] - aabb[:3])).contiguous()
            print(f"{label}: {int(smp.valid.sum())} samples of {pos.shape[0]} slots",
                  file=sys.stderr)
    work.mkdir(parents=True, exist_ok=True)
    torch.save({"tables": tables, "points": points, "binaries": binaries,
                "field": {k: v.detach() for k, v in field.state_dict().items()},
                "origins": rays.origins, "viewdirs": rays.viewdirs}, work / "inputs.pt")


def time_tree(work: Path, tree: Path, label: str) -> None:
    import torch
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.config import ModelConfig, RenderConfig
    from cnc_torch.models import radiance_field as rf
    from cnc_torch.render import renderer
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    cs = _smoke()
    kernels.lib()
    inp = torch.load(work / "inputs.pt")
    mcfg, rcfg = ModelConfig(), RenderConfig()
    tables = inp["tables"]
    n_grid = mcfg.grid_3d.output_dim + 3 * mcfg.grid_2d.output_dim
    composed = getattr(rf, "composed_position", None)
    sites = {}
    with torch.no_grad():
        for size, x01 in inp["points"].items():
            call = lambda: rf.encode_position(None, mcfg, x01, tables)
            before = dict(kernels.launches)
            row = call()
            torch.cuda.synchronize()
            made = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
            rec = {"points": x01.shape[0], "launches": made,
                   "digest": float(row[:, :n_grid].double().sum()),
                   "ms": cs.time_ms(call), "device_ms": cs.device_ms(call)}
            if composed is not None:
                want = composed(mcfg, x01, tables)
                torch.cuda.synchronize()
                if not torch.equal(row[:, :n_grid], want[:, :n_grid]):
                    raise AssertionError(f"{size}: grid columns differ from the composition")
                err = float((row[:, n_grid:] - want[:, n_grid:]).abs().max())
                if not err <= cs.FIELD_SINE_TOL:
                    raise AssertionError(f"{size}: sine columns {err} from the composition's")
                comp = lambda: composed(mcfg, x01, tables)
                rec.update(sine_err=err, composed_ms=cs.time_ms(comp),
                           composed_device_ms=cs.device_ms(comp))
            sites[size] = rec
        field = rf.RadianceField(mcfg, torch.Generator().manual_seed(0), device="cuda")
        field.load_state_dict(inp["field"])
        aabb = torch.tensor(rcfg.aabb, dtype=torch.float32, device="cuda")
        bkgd = torch.ones(3, device="cuda")
        render = lambda: renderer.render_image(field, mcfg, rcfg, aabb, inp["binaries"],
                                               inp["origins"], inp["viewdirs"], bkgd,
                                               chunk=VIEW_CHUNK, device="cuda")
        render()
        views = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render()
            torch.cuda.synchronize()
            views.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"tree": label, "card": cs.card_line(),
                      "device": torch.cuda.get_device_name(0), "sites": sites,
                      "view_ms": statistics.median(views), "views_ms": views}))


def summary(path: Path) -> None:
    """A markdown table of the `time` lines in `path`: per size, each
    tree's mean ms / device ms over its runs, the composition's where a
    tree timed it, and each tree's view ms."""
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"tree"')]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    mean = lambda xs: sum(xs) / len(xs)
    print(f"{runs[0]['card']}; {len(runs)} runs")
    print("| points | " + " | ".join(f"{t} ms / device ms" for t in trees)
          + " | composition ms / device ms | launches |")
    print("| --- |" + " --- |" * (len(trees) + 2))
    for size in runs[0]["sites"]:
        cells, comp, launches = [], [], {}
        for t in trees:
            got = [r["sites"][size] for r in runs if r["tree"] == t]
            cells.append(f"{mean([g['ms'] for g in got]):.4f} / "
                         f"{mean([g['device_ms'] for g in got]):.4f}")
            comp += [g for g in got if "composed_ms" in g]
            launches[t] = got[0]["launches"]
        c = (f"{mean([g['composed_ms'] for g in comp]):.4f} / "
             f"{mean([g['composed_device_ms'] for g in comp]):.4f}" if comp else "-")
        digests = {r["sites"][size]["digest"] for r in runs}
        print(f"| {size} | " + " | ".join(cells) + f" | {c} | {json.dumps(launches)}"
              f" (digests {'equal' if len(digests) == 1 else sorted(digests)}) |")
    for t in trees:
        print(f"{t}: view ms {[round(r['view_ms'], 2) for r in runs if r['tree'] == t]}")


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "summary":
        summary(Path(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("torch_field_input_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "prepare":
        prepare(Path(sys.argv[2]))
    elif len(sys.argv) == 5 and sys.argv[1] == "time":
        time_tree(Path(sys.argv[2]), Path(sys.argv[3]), sys.argv[4])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
