"""Occupancy-grid transmittance estimator.

Port of `cnc_tpu/grids/occupancy.py` (reference OccGridEstimator,
nerfacc/estimators/occ_grid.py:14-443): a binary voxel grid maintained by
EMA-max density updates every N steps, binarized at
min(mean(occs >= 0), occ_thre), feeding the ray marcher.

State is an explicit tuple and every update returns a new one, as in cnc_tpu.
After warm-up an update refreshes N/4 uniformly drawn cells and N/4 cells
drawn from the occupied list with replacement: the occupied cells are
compacted into a fixed-capacity index buffer (K3) and indexed with uniform
draws over the dynamic count (occ_grid.py:364-384).  The with-replacement
draw leaves some occupied cells unrefreshed at low occupancy; cnc_tpu has
the same bias and the port keeps it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .config import RenderConfig
from . import scatter_ops


class OccGridState(NamedTuple):
    occs: torch.Tensor      # [cells] float32; -1 marks camera-invisible cells
    binaries: torch.Tensor  # [R, R, R] bool
    aabb: torch.Tensor      # [6] float32

    @property
    def resolution(self) -> int:
        return self.binaries.shape[0]


def _cell_coords(indices: torch.Tensor, resolution: int) -> torch.Tensor:
    x = indices // (resolution * resolution)
    y = (indices // resolution) % resolution
    z = indices % resolution
    return torch.stack([x, y, z], dim=-1)


def _binarize(occs: torch.Tensor, shape, occ_thre: float) -> torch.Tensor:
    visible = occs >= 0
    mean_occ = torch.where(visible, occs, 0.0).sum() / torch.clamp(visible.sum(), min=1)
    return (occs > torch.clamp(mean_occ, max=occ_thre)).reshape(shape)


def _update_from_draws(state: OccGridState, occ_eval_fn: Callable, cfg: RenderConfig,
                       cell_jitter: torch.Tensor,
                       uniform_idx: Optional[torch.Tensor] = None,
                       occ_draw: Optional[torch.Tensor] = None) -> OccGridState:
    """`update_occ_grid` with its random draws given as tensors.

    cell_jitter: [M, 3] uniforms placing each candidate inside its cell.
    Warm-up (uniform_idx None): every cell is a candidate, M = cells.
    Otherwise uniform_idx [n] holds cell indices and occ_draw [n] positions
    in [0, max(occupied count, 1)) of the compacted occupied list, M = 2n.
    """
    res = state.resolution
    cells = res ** 3
    dev = state.occs.device
    if uniform_idx is None:
        indices = torch.arange(cells, device=dev)
        sel_mask = state.occs >= 0           # skip camera-invisible cells
    else:
        occ_src, occ_count = scatter_ops.compact_mask_indices(state.binaries.reshape(-1), cells)
        occupied_cand = occ_src[occ_draw.long()].long()
        uniform_idx = uniform_idx.long()
        indices = torch.cat([uniform_idx, occupied_cand])
        sel_mask = torch.cat([state.occs[uniform_idx] >= 0,
                              (state.occs[occupied_cand] >= 0) & (occ_count > 0)])
    # jitter within the cell (occ_grid.py:405-408)
    x01 = (_cell_coords(indices, res).float() + cell_jitter) / res
    lo, hi = state.aabb[:3], state.aabb[3:]
    occ_new = occ_eval_fn(lo + x01 * (hi - lo)).reshape(-1)

    # dense masked EMA-max: occs[sel] = max(occs[sel]*decay, occ_new)
    upd = torch.zeros_like(state.occs).scatter_reduce_(
        0, indices, torch.where(sel_mask, occ_new, -torch.inf), reduce="amax")
    touched = torch.zeros(cells, dtype=torch.int32, device=dev).index_add_(
        0, indices, sel_mask.to(torch.int32)) > 0
    occs = torch.where(touched, torch.maximum(state.occs * cfg.occ_ema_decay, upd), state.occs)
    return state._replace(occs=occs, binaries=_binarize(occs, state.binaries.shape,
                                                        cfg.occ_thre))


@torch.no_grad()
def update_occ_grid(state: OccGridState, generator: torch.Generator, occ_eval_fn: Callable,
                    step_is_warmup: bool, cfg: RenderConfig) -> OccGridState:
    """One EMA update (occ_grid.py:387-424), without gradients.

    occ_eval_fn: [N,3] world positions -> [N] occupancy values (density *
    render_step_size in the CNC training scripts).  The draws come from `generator`
    (on its device, then moved to the grid's).  No host sync: the occupied
    count stays on the device.
    """
    cells = state.resolution ** 3
    dev = state.occs.device
    rand = lambda *shape: torch.rand(*shape, generator=generator,
                                     device=generator.device).to(dev)
    if step_is_warmup:
        return _update_from_draws(state, occ_eval_fn, cfg, rand(cells, 3))
    n = cells // 4
    uniform_idx = torch.randint(cells, (n,), generator=generator,
                                device=generator.device).to(dev)
    count = torch.clamp(state.binaries.sum(), min=1)
    occ_draw = torch.minimum((rand(n).double() * count).long(), count - 1)
    return _update_from_draws(state, occ_eval_fn, cfg, rand(2 * n, 3), uniform_idx, occ_draw)

