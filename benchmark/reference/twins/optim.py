"""Optimizer and LR schedule with parity with the reference's training script.

Port of `cnc_tpu/train/optim.py`.  The reference uses torch Adam (radiance
field with additive L2 weight decay) at lr 6e-3, eps 1e-15, under a
ChainedScheduler of LinearLR(start_factor 0.01, 1000 iters) and
MultiStepLR([9000,12000,15000,17000,19000], gamma 0.33)
(train_CNC_nerf_synthetic.py:254-294).  cnc_tpu rebuilt those from optax
parts; here they are torch's own again:

  * `torch.optim.Adam(weight_decay=wd)` adds wd*p to the gradient before the
    moment updates, on every parameter it is given, the hash tables included
    (optax `add_decayed_weights` before `scale_by_adam`);
  * the product of both schedule factors per step is one `LambdaLR`.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from .config import TrainConfig


def reference_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Learning rate after `count` optimizer updates (0 for the first step)."""
    def sched(count: int) -> float:
        warm = cfg.warmup_start_factor + (1.0 - cfg.warmup_start_factor) * \
            min(count / cfg.warmup_iters, 1.0)
        n_hit = sum(count >= m for m in cfg.lr_milestones)
        return cfg.lr * warm * (cfg.lr_gamma ** n_hit)
    return sched


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                   weight_decay: float = 0.0
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam (eps cfg.adam_eps, additive L2 before the moments) and the
    scheduler that follows `reference_schedule`; step the scheduler once
    after every optimizer step."""
    opt = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999), eps=cfg.adam_eps,
                           weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, reference_schedule(cfg))
