"""Frozen copy of `cnc_torch/config.py`, its plain path only (no CUDA kernel);
what follows is the original's description.

Configuration for the PyTorch port of CNC.

A copy of `cnc_tpu/config.py` (the port imports nothing of the JAX package):
the same frozen dataclasses with the same fields and defaults, so a config
dumped by either package with `CNCConfig.to_dict` reads back in the other.
The defaults reproduce the reference's NeRF-synthetic setup.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def _round8(x: int) -> int:
    return int(math.ceil(x / 8) * 8)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of a multiresolution hash grid.

    Mirrors GridEncoder's table layout (reference examples/radiance_fields/
    ngp.py:197-212): per-level table size is min(2**log2_hashmap_size, R**D)
    rounded up to a multiple of 8; levels are concatenated along axis 0.
    """

    num_dim: int
    n_features: int
    resolutions: Tuple[int, ...]
    log2_hashmap_size: int

    @property
    def n_levels(self) -> int:
        return len(self.resolutions)

    @property
    def max_params(self) -> int:
        return 2 ** self.log2_hashmap_size

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        return tuple(
            _round8(min(self.max_params, r ** self.num_dim))
            for r in self.resolutions
        )

    @property
    def offsets(self) -> Tuple[int, ...]:
        out = [0]
        for s in self.level_sizes:
            out.append(out[-1] + s)
        return tuple(out)

    @property
    def total_entries(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features

    def is_dense(self, level: int) -> bool:
        """True if the level indexes row-major without hashing.

        Matches gridencoder.cu:72-81: hashing kicks in only when
        resolution**num_dim exceeds the level's table size.
        """
        r = self.resolutions[level]
        return r ** self.num_dim <= self.level_sizes[level]


# Reference resolutions (train_CNC_nerf_synthetic.py:150-154): the published
# lists are [16..512] / [128..1024]; the driver adds +2 for the one-cell
# zero border used by the encoder.
RESOLUTIONS_3D = (16, 22, 31, 42, 57, 78, 106, 146, 199, 273, 374, 512)
RESOLUTIONS_2D = (128, 256, 512, 1024)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Radiance-field architecture (reference ngp.py:365-512)."""

    n_features_per_level: int = 4
    n_neurons: int = 160                  # driver :139
    log2_hashmap_size: int = 19
    log2_hashmap_size_2D: int = 17
    resolutions_3d: Tuple[int, ...] = tuple(r + 2 for r in RESOLUTIONS_3D)
    resolutions_2d: Tuple[int, ...] = tuple(r + 2 for r in RESOLUTIONS_2D)
    use_viewdirs: bool = True
    sh_degree: int = 4                    # tcnn SphericalHarmonics degree 4 -> 16 dims
    pe_num_freqs: int = 10                # get_embedder(10) -> 63 dims
    # unbounded-scene mode: query through the mip-360 unisphere contraction
    # (reference ngp.py:374,515-516; consumed by the nerf_360_v2 loader)
    unbounded: bool = False
    # STE mode for the hash tables
    ste_binary: bool = True
    ste_multistep: bool = False
    add_noise: bool = False
    Q: float = 10.0

    @property
    def geo_feat_dim(self) -> int:
        # ngp.py:398-401
        g = self.n_features_per_level * 10 - 1
        return max(15, min(127, g))

    @property
    def grid_3d(self) -> GridSpec:
        return GridSpec(3, self.n_features_per_level, self.resolutions_3d,
                        self.log2_hashmap_size)

    @property
    def grid_2d(self) -> GridSpec:
        return GridSpec(2, self.n_features_per_level, self.resolutions_2d,
                        self.log2_hashmap_size_2D)


@dataclasses.dataclass(frozen=True)
class EntropyConfig:
    """Context-model / rate-estimation setup (reference utils_bpp_acc.py:193-402)."""

    n_features: int = 4
    sample_num: int = 200000              # entries sampled per step across levels
    max_context_layer_num: int = 3
    Pg_level: int = 12                    # 3D levels [0, Pg_level) get context models
    Pg_level_2D: int = 4
    skip_levels_3d: Tuple[int, ...] = (0, 1, 2)   # driver :158
    skip_levels_2d: Tuple[int, ...] = (0,)        # driver :159
    step_update: int = 16                 # refresh cached occupancy structures
    use_dimension_wise: bool = True
    use_overlap_area_pool: bool = True
    Rb: int = 128                         # occupancy grid resolution
    # encode/decode vertex budget per chunk (reference MAX_POINTS_NUM_TO_OOM=
    # 20M).  The full-coverage pool holds several [w, 24] corner-index/weight
    # buffers; 8M-vertex chunks compiled to a 21.6 GB program on a 16 GB v5e,
    # so the default stays at 2M (measured fit with ~3x headroom).
    max_points_per_chunk: int = 2_000_000
    # --- TPU static-shape / sampling knobs (adaptations; encode/decode are
    # always full-coverage so the bitstream is unaffected) ---
    # capacity of the dilated-coordinate list behind the dimension-wise prior
    # (reference keeps the exact dynamic list, utils_bpp_acc.py:498-512)
    pn_coords_cap: int = 1 << 24
    # training-time stride-sample of that list (None = full, like reference)
    pn_frac_sample_cap: Optional[int] = 1 << 21
    # propagate gradients through the dimension-wise prior during training
    # (the reference does; default off here to skip its scatter-heavy backward)
    pn_frac_grad: bool = False
    # propagate rate gradients through the CONTEXT-feature gathers
    # (reference behavior: utils_bpp_acc.py differentiates the coarser-level
    # lookups feeding the context MLPs).  Their backward is the dominant
    # scatter of the 3D rate program (~2M ctx vertices x 24 corners x F
    # column updates); ctx_grad=False stop-gradients the gathered features —
    # the coded entries and the context MLPs still train through the direct
    # bernoulli-bits path — as a measured speed/RD tradeoff knob.
    ctx_grad: bool = True
    # training-time 2D entry-window sampling (None = full lattice per step,
    # which is the reference behavior)
    sample_num_2d: Optional[int] = 65536
    # budget of occupancy-masked vertices entering the 3D context model per step
    v_ctx_cap: int = 1 << 21
    # per-window budget of footprint-masked rows entering the 2D context
    # model (the 2D twin of v_ctx_cap: only masked rows contribute to the
    # per-entry pooling, so encoding only them is exact while the budget
    # holds; None = reference-faithful full-window encode).  Training-only —
    # the codec's integer path is always full-coverage.
    v_ctx_cap_2d: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Sampling and rendering parameters (driver :174-186)."""

    aabb: Tuple[float, ...] = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    near_plane: float = 0.0
    far_plane: float = 1e10
    render_step_size: float = 5e-3
    alpha_thre: float = 0.0    # CNC drivers pin 0 (tank_temples.py:186)
    early_stop_eps: float = 1e-4
    occ_resolution: int = 128
    occ_thre: float = 1e-2
    occ_ema_decay: float = 0.95
    occ_warmup_steps: int = 256
    occ_update_interval: int = 16
    # TPU static-shape capacities
    sample_budget: int = 1 << 18          # target samples per train step (driver :169)
    sample_budget_slack: float = 1.25     # buffer capacity = budget * slack
    march_block: int = 64                 # steps marched per compaction block
    # Visibility pruning before the differentiable field eval (the reference
    # structure: estimator.sampling is @torch.no_grad and drops samples whose
    # transmittance fell below early_stop_eps BEFORE rendering re-evaluates
    # the field, occ_grid.py:88-239 + volrend.py:424-482; our round-1/2
    # renderer instead evaluated fwd+bwd on every marched sample).  When set,
    # a gradient-free density pass marks visible samples, which are compacted
    # to visible_frac * sample_capacity slots for the full fwd+bwd — the
    # gradients are identical (invisible samples carry zero weight and no
    # grad path) unless the pruned buffer overflows, in which case the rays
    # losing samples are masked out of the loss.  None = off.
    visible_frac: Optional[float] = None
    eval_chunk_rays: int = 8192
    eval_samples_per_iter: int = 8    # per-round budget = chunk_rays * this
    eval_max_iters: int = 1024

    @property
    def sample_capacity(self) -> int:
        return _round8(int(self.sample_budget * self.sample_budget_slack))

    @property
    def visible_capacity(self) -> Optional[int]:
        if self.visible_frac is None:
            return None
        return _round8(max(8, int(self.sample_capacity * self.visible_frac)))

    @property
    def max_march_steps(self) -> int:
        # longest possible traversal: aabb diagonal / step size
        lo = self.aabb[:3]
        hi = self.aabb[3:]
        diag = math.sqrt(sum((b - a) ** 2 for a, b in zip(lo, hi)))
        steps = int(math.ceil(diag / self.render_step_size))
        blocks = int(math.ceil(steps / self.march_block))
        return blocks * self.march_block


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """End-to-end training schedule (driver :167-294)."""

    max_steps: int = 20000
    init_batch_size: int = 1024
    target_sample_batch_size: int = 1 << 18
    lr: float = 6e-3
    adam_eps: float = 1e-15
    weight_decay: float = 2e-6            # 2e-5 for 'drums'
    warmup_iters: int = 1000
    warmup_start_factor: float = 0.01
    lr_milestones: Tuple[int, ...] = (9000, 12000, 15000, 17000, 19000)
    lr_gamma: float = 0.33
    lmbda: float = 2e-3
    seed: int = 42
    # ray-count buckets (powers of two); the dynamic ray batch is rounded up
    # to one of these so the jitted step compiles a bounded number of shapes.
    min_ray_bucket: int = 1024
    max_ray_bucket: int = 1 << 17
    mlp_quant_digits: Tuple[int, ...] = (13,)   # driver :513
    # checkpoint/resume (reference has none — SURVEY.md §5); None = off
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 1000
    # run the 2D/3D entropy rate gradients every K steps (reference: every
    # step).  The rate programs are an estimate over freshly-sampled entry
    # windows anyway; amortizing them over K render steps is a measured
    # speed/RD knob (tools/rd_sweep.py), NOT a default deviation.
    rate_update_interval: int = 1


@dataclasses.dataclass(frozen=True)
class CNCConfig:
    model: ModelConfig = ModelConfig()
    entropy: EntropyConfig = EntropyConfig()
    render: RenderConfig = RenderConfig()
    train: TrainConfig = TrainConfig()

    def to_dict(self) -> dict:
        """JSON-serializable dump (bundle metadata / reproducibility)."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "CNCConfig":
        def build(cls, sub):
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name not in sub:
                    continue
                v = sub[f.name]
                if isinstance(v, list):
                    v = tuple(v)
                kw[f.name] = v
            return cls(**kw)

        return CNCConfig(
            model=build(ModelConfig, d.get("model", {})),
            entropy=build(EntropyConfig, d.get("entropy", {})),
            render=build(RenderConfig, d.get("render", {})),
            train=build(TrainConfig, d.get("train", {})))

    @staticmethod
    def with_n_features(n_features: int, **kw) -> "CNCConfig":
        return CNCConfig(
            model=ModelConfig(n_features_per_level=n_features),
            entropy=EntropyConfig(n_features=n_features,
                                  **{k: v for k, v in kw.items()
                                     if k in EntropyConfig.__dataclass_fields__}),
        )
