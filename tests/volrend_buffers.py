"""Sample buffers at the edges of K5/K5b's per-ray walk, as numpy arrays.

Shared by the CPU parity tests (tests/test_torch_volrend_segments.py) and
the kernel tests on the card (tests/test_torch_kernels_gpu.py); it imports
neither JAX nor torch.
"""

import numpy as np

LAYOUTS = ("long_rays", "empty_between", "all_padding", "one_ray", "prefilter")
# buffers that break the kernels' precondition, which their fault word flags
BROKEN = ("valid_after_invalid", "ids_decrease")
DT = np.float32(0.02)


def segment_buffer(layout: str, seed: int = 0):
    """(ray_id int32, valid bool, t_mid, sigmas, rgbs [S,3], n_rays), sorted
    by ray, each segment's valid samples first, the padding parked on ray
    n_rays - 1 after that ray's real samples:

      long_rays      rays of 1, 33, 1,100 and 2,500 samples (longer than a
                     pass of 32 lanes and than 1,024) among short and empty
                     ones; the last ray has real samples before the padding
      empty_between  every other ray has no sample
      all_padding    no valid sample at all
      one_ray        one ray (17 of 64) holds the whole buffer
      prefilter      the last ray has only the padding, as in the training
                     prefilter's re-compacted buffer

    Rays longer than 100 samples are thin (sigma*dt about 0.01), so their
    transmittance crosses early_stop_eps = 1e-4 well inside them; the others
    are thin or dense at random.
    """
    rng = np.random.default_rng(seed)
    n_pad = 0
    if layout == "long_rays":
        counts = np.array([1, 0, 33, 0, 0, 1100, 7, 2500, 0, 16, 32, 64, 3, 0, 9])
        n_pad = 40
    elif layout == "empty_between":
        counts = rng.integers(1, 40, 300)
        counts[::2] = 0
        n_pad = 100
    elif layout == "all_padding":
        counts = np.zeros(64, np.int64)
        n_pad = 5000
    elif layout == "one_ray":
        counts = np.zeros(64, np.int64)
        counts[17] = 4000
    elif layout == "prefilter":
        counts = rng.integers(0, 30, 200)
        counts[-1] = 0
        n_pad = 300
    else:
        raise ValueError(layout)
    n_rays = counts.shape[0]
    ray_id = np.concatenate([np.repeat(np.arange(n_rays), counts),
                             np.full(n_pad, n_rays - 1)]).astype(np.int32)
    n = ray_id.shape[0]
    valid = np.arange(n) < counts.sum()
    scale = np.where(counts > 100, 0.5, rng.choice([0.5, 30.0], n_rays))[ray_id]
    sigmas = rng.exponential(scale).astype(np.float32)
    t_mid = np.sort(rng.uniform(0, 4, n)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return ray_id, valid, t_mid, sigmas, rgbs, n_rays


def broken_buffer(kind: str, seed: int = 0):
    """`segment_buffer("long_rays")` with the precondition broken:

      valid_after_invalid  a ray of 33 samples has an invalid one before its
                           last valid one
      ids_decrease         two rays' segments swapped, so the ids fall once
    """
    ray_id, valid, t_mid, sigmas, rgbs, n_rays = segment_buffer("long_rays", seed)
    ray_id, valid = ray_id.copy(), valid.copy()
    start = int(np.searchsorted(ray_id, 2))            # ray 2: 33 samples
    if kind == "valid_after_invalid":
        valid[start + 20] = False
    elif kind == "ids_decrease":
        ray_id[start:start + 33] = 10                  # ray 10 before ray 5
    else:
        raise ValueError(kind)
    return ray_id, valid, t_mid, sigmas, rgbs, n_rays
