"""Model FLOPs of a step and of a view, counted from shapes.

A multiply-add is two FLOPs; a layer's backward costs twice its forward
(the gradients of its input and of its weights).  Counted: the radiance
field's two MLPs (base `base_in -> n -> 1 + geo`, head `head_in -> n -> n ->
3`; 66,720 MACs a sample at the published widths), the 3D context MLP
(`kF + 1 -> 32 -> 32 -> F`; 1,568 MACs a vertex) and the 2D context Linears
(`F (cln + 1) + 1 -> F`), and the occupancy update's density queries
(the base MLP, forward only).  Not counted: the encodes, the composite, the
march and the rate's pooling, which are bound by memory and have no
multiply-adds worth the name; their rooflines are the kernels' business.
"""

from __future__ import annotations


def field_macs(model: dict) -> tuple:
    """(base MLP MACs, head MLP MACs) a sample, from a ModelConfig's fields."""
    f = model["n_features_per_level"]
    base_in = (len(model["resolutions_3d"]) * f + 3 * len(model["resolutions_2d"]) * f
               + 3 + 6 * model["pe_num_freqs"])
    geo = max(15, min(127, f * 10 - 1))
    n = model["n_neurons"]
    head_in = model["sh_degree"] ** 2 + geo
    return base_in * n + n * (1 + geo), head_in * n + n * n + n * 3


def ctx3d_macs(entropy: dict) -> int:
    f, k = entropy["n_features"], entropy["max_context_layer_num"]
    return (f * k + 1) * 32 + 32 * 32 + 32 * f


def ctx2d_macs(entropy: dict, level: int) -> int:
    f, k = entropy["n_features"], entropy["max_context_layer_num"]
    return (f * (min(level, k) + int(entropy["use_dimension_wise"])) + 1) * f


def train_window(cnc: dict, window_rows_2d: dict, counts: dict) -> float:
    """FLOPs of a window of training steps.  counts: "samples" (rendered
    samples summed over the steps), "ctx_rows" (3D context vertices
    encoded, summed), "rate_steps" (steps that took the rate), "occ_updates"
    (occupancy updates); window_rows_2d: {2D context level: rows of one
    axis's window}."""
    base, head = field_macs(cnc["model"])
    ent = cnc["entropy"]
    macs = 3 * ((base + head) * counts["samples"] + ctx3d_macs(ent) * counts["ctx_rows"]
                + counts["rate_steps"] * 3 * sum(ctx2d_macs(ent, l) * rows
                                                 for l, rows in window_rows_2d.items()))
    cells = cnc["render"]["occ_resolution"] ** 3
    macs += base * 2 * (cells // 4) * counts["occ_updates"]
    return 2.0 * macs


def view(cnc: dict, samples: int) -> float:
    """FLOPs of rendering `samples` marched samples (forward only)."""
    base, head = field_macs(cnc["model"])
    return 2.0 * (base + head) * samples
