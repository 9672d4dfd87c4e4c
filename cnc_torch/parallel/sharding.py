"""Data parallelism over rays, on torch.distributed.

Port of `cnc_tpu/parallel/sharding.py`.  The reference is single-GPU
(SURVEY.md §2.7); cnc_tpu extends it by sharding the training ray batch over
a `data` mesh axis.  Here a mesh is a process group of W ranks, one process
each (`make_group`; `torchrun` or `torch.multiprocessing` starts them):

  * every rank holds the whole field, the context MLPs, the occupancy grid
    and the optimizers, and draws the same global ray batch and occupancy
    candidates from the same seeded generator; it keeps its contiguous rows
    `[r*B/W, (r+1)*B/W)` of the batch (`shard_rays`, cnc_tpu's P("data"));
  * the render loss is the global mean: each rank's squared error over the
    group's pixel count, so the sum of the ranks' gradients is the gradient
    of the global MSE;
  * the rate is the mean of the ranks' estimates, each over its own entry
    windows with per-rank quotas (`train/driver.build_entropy(cfg, W)`), and
    the frac plane's histogram is split by rows and summed
    (`all_reduce_sum`, `ContextModels.pn_frac_plane(group=)`);
  * after the backward the gradients are summed in one all-reduce and every
    rank takes the same Adam step, so the ranks stay bit-equal
    (`check_replicated` checks that, it does not enforce it).

`make_dp_train_step` has no counterpart: `train/trainer.Trainer(group=)` is
the one data-parallel step, as `Trainer(mesh=)` is cnc_tpu's.
`dp_step_plain` runs the same step's arithmetic in one process, over the W
shards in turn, as the yardstick the collective version is held to.
Scene-level parallelism needs no collectives: run independent drivers.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from typing import Any, Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils import profiling
from ..utils.device import normalize_device, resolve_device

MAX_TIMEOUT_S = 120         # every group's collective and store timeout, at most
RANK0_WAIT_S = 3600         # how long rank0_barrier waits for rank 0's evaluation and encode
ReduceOp = dist.ReduceOp
_SEED_MIX = 0x9E3779B97F4A7C15


@dataclasses.dataclass(frozen=True)
class Group:
    """A data-parallel group: W ranks, this process's rank, its device, the
    torch.distributed process group and the rendezvous store."""
    world_size: int
    rank: int
    device: torch.device
    process_group: Any
    store: Any


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def make_group(world_size: Optional[int] = None, rank: Optional[int] = None, device=None,
               backend: Optional[str] = None, init_method: Optional[str] = None,
               timeout_s: float = MAX_TIMEOUT_S) -> Group:
    """Join (and on first use create) this process's data-parallel group.

    rank and world_size default to torchrun's RANK and WORLD_SIZE, the
    device to `cuda:LOCAL_RANK` (the card unless device="cpu"; never the CPU
    on its own), the backend to nccl on CUDA and gloo on the CPU (gloo on
    CUDA only when asked for: it moves the tensors through the host), the
    rendezvous to torchrun's `env://` (else pass `file://<path>` or
    `tcp://127.0.0.1:<port>`).  Every collective and store wait times out
    after `timeout_s`, at most MAX_TIMEOUT_S, and then raises."""
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None or world_size is None:
        raise RuntimeError("make_group: pass rank and world_size, or launch the ranks with "
                           "torchrun (which sets RANK, WORLD_SIZE and LOCAL_RANK)")
    if not 0 <= rank < world_size:
        raise ValueError(f"make_group: rank {rank} outside a world of {world_size}")
    if not 0 < timeout_s <= MAX_TIMEOUT_S:
        raise ValueError(f"make_group: timeout_s must lie in (0, {MAX_TIMEOUT_S}]")
    if device is None and torch.cuda.is_available():
        device = f"cuda:{_env_int('LOCAL_RANK') or 0}"
    dev = normalize_device(resolve_device(device))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("make_group: nccl needs a CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("make_group: this torch build has no NCCL")
        torch.cuda.set_device(dev)
    elif backend != "gloo":
        raise ValueError(f"make_group: backend {backend!r} is neither nccl nor gloo")
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise RuntimeError("make_group: no rendezvous; pass init_method (file://<path> or "
                               "tcp://127.0.0.1:<port>) or launch the ranks with torchrun")
        init_method = "env://"
    if dist.is_initialized():
        raise RuntimeError("make_group: this process already has a group; destroy_group it first")
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(init_method, rank, world_size,
                                                   timeout=timeout))
    store.set_timeout(timeout)
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store), rank=rank,
                            world_size=world_size, timeout=timeout)
    return Group(world_size=world_size, rank=rank, device=dev, process_group=dist.group.WORLD,
                 store=dist.PrefixStore("cnc_torch", store))


def destroy_group(group: Optional[Group] = None) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_rays(group: Group, *arrays: torch.Tensor):
    """This rank's contiguous rows [r*B/W, (r+1)*B/W) of each [B, ...] array
    (views; B must be a multiple of W)."""
    out = []
    for a in arrays:
        b = a.shape[0]
        if b % group.world_size:
            raise ValueError(f"shard_rays: {b} rows do not split over {group.world_size} ranks")
        n = b // group.world_size
        out.append(a[group.rank * n:(group.rank + 1) * n])
    return tuple(out)


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the ranks of x.  The backward is the same sum of the
    ranks' cotangents: with a loss summed over ranks, L = sum_r f_r(y), and
    y = sum_q x_q, dL/dx_q = sum_r df_r/dy on every rank q."""

    @staticmethod
    def forward(ctx, x, process_group):
        ctx.process_group = process_group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=process_group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.process_group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The differentiable sum of x over the group's ranks (every rank calls
    it, in the same order; the backward is a collective too)."""
    return _AllReduceSum.apply(x, group.process_group)


def _on_device(x, dev) -> torch.Tensor:
    """x as a tensor on `dev`; a Python number is copied from the host, and
    on the card that copy waits for the stream."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(x, device=dev)
    with profiling.span("sync/host_scalar"):
        return torch.as_tensor(x, device=dev)


def reduce_stats(values: Sequence[torch.Tensor], group: Optional[Group],
                 op=dist.ReduceOp.SUM):
    """Gradient-free reduction of a few scalars in one collective, float64
    (with no group, the values themselves: the step of one process)."""
    dev = group.device if group is not None else next(
        x.device for x in values if isinstance(x, torch.Tensor))
    v = torch.stack([_on_device(x, dev).detach().to(torch.float64).reshape(()) for x in values])
    if group is not None:
        dist.all_reduce(v, op=op, group=group.process_group)
    return v


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group: Group) -> None:
    """Sum the parameters' gradients over the group in one coalesced
    all-reduce (a missing gradient counts as zeros); each .grad becomes a
    view of the summed buffer."""
    params = list(params)
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.process_group)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()


def _digest(t: torch.Tensor) -> torch.Tensor:
    """A position-weighted sum of the tensor's bits (int64, wrapping)."""
    x = t.detach().contiguous().reshape(-1)
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    x = x.to(torch.int64)
    w = torch.arange(x.numel(), device=x.device, dtype=torch.int64) % 65521 + 1
    return (x * w).sum()


def check_replicated(group: Group, tensors: Dict[str, torch.Tensor], where: str = "") -> None:
    """Raise unless every rank holds the same bits in each named tensor (a
    digest each, compared by one MIN and one MAX all-reduce; every rank
    calls it with the same names)."""
    if group.world_size == 1 or not tensors:
        return
    names = list(tensors)
    d = torch.stack([_digest(tensors[k]) for k in names]) & ((1 << 52) - 1)
    lo = reduce_stats(list(d), group, dist.ReduceOp.MIN)
    hi = reduce_stats(list(d), group, dist.ReduceOp.MAX)
    differ = [k for k, a, b in zip(names, lo.tolist(), hi.tolist()) if a != b]
    if differ:
        raise RuntimeError(f"the ranks' replicas differ{(' ' + where) if where else ''}: {differ}")


def trainer_state(trainer) -> Dict[str, torch.Tensor]:
    """The tensors every rank of a data-parallel trainer must hold alike."""
    out = {f"field.{k}": p for k, p in trainer.field.named_parameters()}
    if trainer.ent_params is not None:
        out.update({f"ent.{k}": p for k, p in trainer.ent_params.named_parameters()})
    out["occs"] = trainer.occ_state.occs
    out["binaries"] = trainer.occ_state.binaries
    return out


def rank0_barrier(group: Group, tag: str, ok: bool = True, timeout_s: float = RANK0_WAIT_S,
                  poll_s: float = 0.2) -> None:
    """Rank 0 arrives when its own work is done (with ok=False: when it
    failed, and then the other ranks raise too); the other ranks wait for it
    up to `timeout_s` (longer than any collective's timeout: the rank-0 work
    is an evaluation and an encode), then raise.  Rank 0 returns only when
    every other rank has seen it arrive (a counter in the store), so that
    it never closes a store, as a tcp:// rendezvous's is rank 0's, while a
    rank still polls it; it too raises after `timeout_s`.  Every rank calls
    it with the same tag, once."""
    key, acks = f"rank0_barrier/{tag}", f"rank0_barrier/{tag}/acks"
    deadline = time.monotonic() + timeout_s
    if group.rank == 0:
        group.store.set(key, "1" if ok else "0")
        while group.store.add(acks, 0) < group.world_size - 1:
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank0_barrier {tag!r}: {group.store.add(acks, 0)} of "
                                   f"{group.world_size - 1} ranks arrived in {timeout_s} s")
            time.sleep(poll_s)
        return
    while not group.store.check([key]):
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank0_barrier {tag!r}: rank 0 did not arrive in {timeout_s} s")
        time.sleep(poll_s)
    failed = group.store.get(key) != b"1"
    group.store.add(acks, 1)
    if failed:
        raise RuntimeError(f"rank0_barrier {tag!r}: rank 0 failed")


def draw_rank_seed(generator: torch.Generator) -> int:
    """One draw from the shared generator (every rank draws it alike): the
    seed the ranks' own generators of one step derive from."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator, device=generator.device))


def rank_generator(device, seed: int, rank: int) -> torch.Generator:
    """Rank `rank`'s generator of a step: its march jitter and entry-window
    starts (cnc_tpu folds the step key with axis_index).  Any rank can make
    any rank's, so `dp_step_plain` replays the ranks' draws."""
    return torch.Generator(device=device).manual_seed((seed + rank * _SEED_MIX) % (1 << 63))


def run_ranks(fn, world_size: int, args: tuple = (), timeout_s: float = 600.0) -> None:
    """Run fn(rank, *args) in `world_size` spawned processes and join them;
    raise if one fails or the deadline passes (the others are killed).  fn
    must be a module-level function, importable by the children."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=world_size, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_ranks: {world_size} ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


# ------------------------------------------------------- the plain step
def dp_step_plain(trainer, world_size: int, rays_o, rays_d, pixels, bkgd, jitters=None,
                  ent_cache=None, starts=None, apply: bool = True) -> Dict:
    """One data-parallel step's arithmetic in one process, no collectives.

    The arguments are `Trainer._train_step`'s with the global ray batch;
    `jitters` and `starts`, when given, are lists with each rank's draws, else
    they are drawn as the ranks would draw them (one seed from the trainer's
    generator, then each rank's own generator: its starts, then its jitter).
    For each of the W shards in turn: its render with the per-rank sample
    capacity and its rate estimate over its own windows (the frac plane
    whole).  The loss is sum_r sq_r / sum_r n_px_r + scale * sum_r bits_r / W,
    one backward; with `apply`, one update of each optimizer.  The gradients
    stay in the parameters' .grad.  The yardstick the collective step is
    held to; the trainer never calls it."""
    from ..models import radiance_field as rf

    cfg = trainer.cfg
    use_entropy = trainer._uses_rate()
    n = rays_o.shape[0]
    if n % world_size:
        raise ValueError(f"dp_step_plain: {n} rays do not split over {world_size} ranks")
    m = n // world_size
    gens = None
    if jitters is None or (use_entropy and starts is None):
        seed = draw_rank_seed(trainer.generator)
        gens = [rank_generator(trainer.device, seed, r) for r in range(world_size)]
    starts = list(starts) if starts is not None else [None] * world_size
    jitters = list(jitters) if jitters is not None else [None] * world_size
    for r in range(world_size):
        if use_entropy and starts[r] is None:
            starts[r] = trainer.entropy.draw_starts(gens[r])
        if jitters[r] is None:
            jitters[r] = torch.rand(m, generator=gens[r], device=gens[r].device).to(
                rays_o.device)
    cap = trainer.rank_capacity(world_size)
    trainer._zero_grads(use_entropy)
    terms = [trainer._render_terms(rays_o[r * m:(r + 1) * m], rays_d[r * m:(r + 1) * m],
                                   pixels[r * m:(r + 1) * m], bkgd, jitters[r], None, cap)
             for r in range(world_size)]
    n_px = sum(t[1] for t in terms)
    loss = sum(t[0] for t in terms) / n_px
    outs = [t[2] for t in terms]
    aux = {"mse": loss.detach(),
           "n_samples": sum(o.n_rendering_samples.to(torch.int64) for o in outs),
           "n_marched": sum(o.n_marched_samples.to(torch.int64) for o in outs),
           "max_depth": torch.stack([o.depth.detach().max() for o in outs]).max()}
    if use_entropy:
        tables = rf.quantized_tables(trainer.field, cfg.model)
        bits = [trainer._rate_terms(tables, starts[r], ent_cache, None) for r in range(world_size)]
        ttl_bits = sum(b[0] for b in bits) / world_size
        loss = loss + trainer._rate_scale() * ttl_bits
        aux.update(trainer._rate_aux(ttl_bits.detach(),
                                     sum(torch.as_tensor(b[1]) for b in bits) / world_size))
    loss.backward()
    if apply:
        trainer._apply_update(use_entropy)
    return aux


# ------------------------------------------------------------- the dry run
def _dryrun_config(world_size: int):
    """cnc_tpu's dry-run shapes (sharding.py:147-170): the tiny grids, a
    16^3 occupancy grid, lambda 2e-3 and a one-step lr warm-up."""
    from ..config import (CNCConfig, EntropyConfig, ModelConfig, RenderConfig, TrainConfig)
    mcfg = ModelConfig(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18, 34, 66),
                       resolutions_2d=(18, 34), log2_hashmap_size=10, log2_hashmap_size_2D=8,
                       pe_num_freqs=4)
    # the whole budgets; build_entropy(cfg, W) splits them into per-rank quotas
    ecfg = EntropyConfig(n_features=2, sample_num=2048, max_context_layer_num=2, Pg_level=4,
                         Pg_level_2D=2, skip_levels_3d=(0, 1), skip_levels_2d=(0,), Rb=16,
                         pn_coords_cap=1 << 14, pn_frac_sample_cap=None, sample_num_2d=1024,
                         v_ctx_cap=1 << 13)
    return CNCConfig(
        model=mcfg, entropy=ecfg,
        render=dataclasses.replace(RenderConfig(), occ_resolution=16, render_step_size=0.05,
                                   sample_budget=1 << 10, march_block=16),
        train=dataclasses.replace(TrainConfig(), lmbda=2e-3, warmup_iters=1))


def _dryrun_rank(rank: int, world_size: int, n_steps: int, device: str, init_file: str,
                 out_dir: str, group_timeout_s: float) -> None:
    """One rank of `dryrun_multichip` (module level: spawned children import it)."""
    import numpy as np

    from ..train.driver import build_entropy
    from ..train.trainer import Trainer

    torch.set_num_threads(1)
    group = make_group(world_size, rank, device=device, init_method="file://" + init_file,
                       backend="gloo", timeout_s=group_timeout_s)
    try:
        cfg = _dryrun_config(world_size)
        dev = group.device
        entropy = build_entropy(cfg, world_size, device=dev)
        tr = Trainer(cfg, None, entropy=entropy, device=dev, group=group)
        binaries = torch.zeros(16, 16, 16, dtype=torch.bool, device=dev)
        binaries[6:10, 6:10, 6:10] = True
        tr.occ_state = tr.occ_state._replace(binaries=binaries)
        cache = entropy.refresh_cache(binaries)
        g = torch.Generator().manual_seed(0)
        n_rays = 8 * world_size
        rays_o = torch.tensor([[0.0, 0.0, -3.0]]).repeat(n_rays, 1)
        d = torch.randn(n_rays, 3, generator=g) * 0.05 + torch.tensor([0.0, 0.0, 1.0])
        rays_d = d / d.norm(dim=-1, keepdim=True)
        pixels = torch.full((n_rays, 3), 0.5)
        rays_o, rays_d, pixels = (x.to(dev) for x in (rays_o, rays_d, pixels))
        mses, bits = [], []
        for _ in range(n_steps):
            aux = tr._train_step(rays_o, rays_d, pixels, torch.ones(3, device=dev),
                                 ent_cache=cache)
            tr.step += 1
            mses.append(float(aux["mse"]))
            bits.append(float(aux["bits_per_param"]))
        check_replicated(group, trainer_state(tr), f"after {n_steps} dry-run steps")
        if not (np.all(np.isfinite(mses)) and np.all(np.isfinite(bits))):
            raise AssertionError(f"non-finite losses or bits: {mses} {bits}")
        if not all(bool(torch.isfinite(p).all()) for p in tr.field.parameters()):
            raise AssertionError("non-finite parameters")
        # a fixed ray batch and a milestone-free lr: the trajectory descends
        if not min(mses[-3:]) < mses[0]:
            raise AssertionError(f"the loss did not decrease: {mses}")
        line = (f"dryrun_multichip({world_size}): ok, mse {mses[0]:.4f} -> {mses[-1]:.4f} over "
                f"{n_steps} steps, bpp={bits[-1]:.4f}")
        if rank == 0:
            # the codec round trip on the trained tables
            from ..codec.codec import CNCCodec
            from ..models import radiance_field as rf
            with torch.no_grad():
                tables = rf.quantized_tables(tr.field, cfg.model)
            codec = CNCCodec(entropy)
            with tempfile.TemporaryDirectory() as stream_dir:
                pgs, est_mb, coded_mb = codec.encode(tr.ent_params, tables, binaries, stream_dir)
                rec = codec.decode(tr.ent_params, binaries, pgs, stream_dir)
            if not coded_mb > 0:
                raise AssertionError("the codec wrote nothing")
            for name in ("xyz", "xy", "xz", "yz"):
                if tuple(rec[name].shape) != tuple(tables[name].shape):
                    raise AssertionError(f"decoded {name} has shape {tuple(rec[name].shape)}")
            line += f", codec {coded_mb:.4f} MB (est {est_mb:.4f})"
            with open(os.path.join(out_dir, "dryrun.txt"), "w") as fh:
                fh.write(line + "\n")
        rank0_barrier(group, "dryrun")
    finally:
        destroy_group(group)


def dryrun_multichip(world_size: int, n_steps: int = 10, device=None,
                     timeout_s: float = 600.0, group_timeout_s: float = MAX_TIMEOUT_S) -> str:
    """Train the data-parallel step `n_steps` steps in `world_size` spawned
    ranks at cnc_tpu's tiny dry-run shapes, on a fixed ray batch and
    occupancy grid: each rank asserts finite losses and bits, a falling
    loss and parameters bit-equal across the ranks; rank 0 then encodes and
    decodes the trained tables.  On the card by default (every rank shares
    it over gloo, which moves the tensors through the host; raises when
    there is none); on the CPU with device="cpu".  The ranks must finish
    within `timeout_s`; each collective within `group_timeout_s`.  Returns
    rank 0's summary line."""
    dev = str(normalize_device(resolve_device(device)))
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(_dryrun_rank, world_size,
                  (world_size, n_steps, dev, os.path.join(tmp, "rendezvous"), tmp,
                   group_timeout_s), timeout_s)
        with open(os.path.join(tmp, "dryrun.txt")) as fh:
            line = fh.read().strip()
    print(line)
    return line
