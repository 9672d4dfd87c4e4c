"""Checkpoint save/resume, in the npz layout `cnc_tpu`'s checkpoints use.

Port of `cnc_tpu/utils/checkpoint.py`.  One npz holds a Trainer's whole
state, under the key strings JAX's `keystr` gives cnc_tpu's pytrees, so
either package reads the other's file:

  * `params|['xyz']`, `params|['mlp_base']['l0']['w']`, ... (weights [in, out]
    in both packages) and `ent|['ctx3d']['l0']['w']`, ... (the context MLPs);
  * the optimizers as optax's chain states: `opt_rf|[i].count` (int32),
    `opt_rf|[i].mu[...]`, `opt_rf|[i].nu[...]` and the schedule's
    `opt_rf|[i+1].count`, with i = 1 when the field's Adam has weight decay
    (optax's `add_decayed_weights` holds an empty state at [0]) and 0 when it
    has none; `opt_ent|[0]...`, `opt_ent|[1].count` for the context MLPs.
    torch's `exp_avg` is optax's `mu`, `exp_avg_sq` its `nu`, each
    parameter's `step` its `count`, and `LambdaLR.last_epoch` the schedule's
    count;
  * `occs`, `binaries` (np.packbits), `bin_res`, `step`, `num_rays`, and
    `key`, jax.random.PRNGKey(seed)'s raw form, which cnc_tpu's loader reads;
  * the port's own generator: `torch_generator` (its state, uint8) and
    `torch_generator_device` (the device type it was drawn on).  cnc_tpu
    reads keys by name and ignores both.

`load_field` reads only a checkpoint's field and occupancy grid; `_flatten`
and `_nest` are the key layout the codec's bundle shares.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models.radiance_field import RadianceField, params_from_jax
from ..utils.device import resolve_device

_KEY = re.compile(r"\['([^']*)'\]")


def _flatten(tree: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    """{"a": {"b": x}} -> {"prefix|['a']['b']": x as numpy}: the keys JAX's
    `keystr` gives a dict path, as cnc_tpu's `_flatten` writes them.  Leaves
    are numpy arrays or tensors (copied to the host)."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k], f"{path}[{str(k)!r}]")
        else:
            out[f"{prefix}|{path}"] = (node.detach().cpu().numpy()
                                       if isinstance(node, torch.Tensor) else np.asarray(node))

    walk(tree, "")
    return out


def _nest(flat: Dict[str, np.ndarray], prefix: str) -> Dict:
    """{"params|['a']['b']": x} -> {"a": {"b": x}}."""
    out: Dict = {}
    for key, arr in flat.items():
        head, _, path = key.partition("|")
        if head != prefix:
            continue
        names = _KEY.findall(path)
        node = out
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = arr
    return out


def norm_path(path: str) -> str:
    """np.savez appends '.npz' to extension-less paths; normalize once so
    save and the resume existence check agree on the same file."""
    return path if path.endswith(".npz") else path + ".npz"


def _keystr(name: str) -> str:
    """A module parameter's name as cnc_tpu's key path: "tables.xyz" ->
    "['xyz']", "mlp_base.l0.w" -> "['mlp_base']['l0']['w']"."""
    parts = name.split(".")
    if parts[0] == "tables":
        parts = parts[1:]
    return "".join(f"[{p!r}]" for p in parts)


def _named(module) -> Dict[str, torch.nn.Parameter]:
    return {_keystr(n): p for n, p in module.named_parameters()}


def _adam_payload(opt: torch.optim.Adam, sched, named: Mapping[str, torch.nn.Parameter],
                  prefix: str) -> Dict[str, np.ndarray]:
    """One Adam and its schedule as optax's chain state.  A parameter that has
    not stepped yet (torch creates Adam's state lazily) has zero moments and
    count 0."""
    i = 1 if opt.param_groups[0]["weight_decay"] else 0
    counts = set()
    mu, nu = {}, {}
    for path, p in named.items():
        st = opt.state.get(p, {})
        counts.add(int(st["step"]) if "step" in st else 0)
        mu[path] = st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p)
        nu[path] = st["exp_avg_sq"] if "exp_avg_sq" in st else torch.zeros_like(p)
    if len(counts) != 1:
        raise ValueError(f"{prefix}: the parameters' Adam step counts differ ({sorted(counts)});"
                         f" optax keeps one count")
    out = {f"{prefix}|[{i}].count": np.asarray(counts.pop(), np.int32)}
    out.update({f"{prefix}|[{i}].mu{k}": v.detach().cpu().numpy() for k, v in mu.items()})
    out.update({f"{prefix}|[{i}].nu{k}": v.detach().cpu().numpy() for k, v in nu.items()})
    out[f"{prefix}|[{i + 1}].count"] = np.asarray(sched.last_epoch, np.int32)
    return out


def _take(data: Mapping[str, np.ndarray], key: str, like: torch.Tensor) -> torch.Tensor:
    arr = data[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(arr.shape)} in the checkpoint, "
                         f"{tuple(like.shape)} in the trainer")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(like.device)


def _load_adam(opt: torch.optim.Adam, sched, named: Mapping[str, torch.nn.Parameter],
               data: Mapping[str, np.ndarray], prefix: str) -> None:
    """Set each parameter's Adam state by its name, and the schedule's count
    and learning rate."""
    i = 1 if opt.param_groups[0]["weight_decay"] else 0
    count = int(data[f"{prefix}|[{i}].count"])
    for path, p in named.items():
        opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": _take(data, f"{prefix}|[{i}].mu{path}", p),
                        "exp_avg_sq": _take(data, f"{prefix}|[{i}].nu{path}", p)}
    n = int(data[f"{prefix}|[{i + 1}].count"])
    sched.last_epoch = n
    lrs = [base * fn(n) for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(opt.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = lrs


def save_checkpoint(path: str, trainer) -> None:
    """Serialize a train.trainer.Trainer's whole state (see the module
    docstring for the layout)."""
    path = norm_path(path)
    rf_named = _named(trainer.field)
    payload = {f"params|{k}": p.detach().cpu().numpy() for k, p in sorted(rf_named.items())}
    if trainer.ent_params is not None:
        ent_named = _named(trainer.ent_params)
        payload.update({f"ent|{k}": p.detach().cpu().numpy()
                        for k, p in sorted(ent_named.items())})
    payload.update(_adam_payload(trainer.optimizer, trainer.scheduler, dict(sorted(
        rf_named.items())), "opt_rf"))
    if trainer.opt_ent is not None:
        payload.update(_adam_payload(trainer.opt_ent, trainer.sched_ent, dict(sorted(
            ent_named.items())), "opt_ent"))
    occ = trainer.occ_state
    payload["occs"] = occ.occs.detach().cpu().numpy()
    payload["binaries"] = np.packbits(occ.binaries.cpu().numpy().reshape(-1))
    payload["bin_res"] = np.asarray(occ.resolution)
    payload["step"] = np.asarray(trainer.step)
    payload["num_rays"] = np.asarray(trainer.num_rays)
    payload["key"] = np.asarray([0, trainer.seed], np.uint32)
    payload["torch_generator"] = trainer.generator.get_state().numpy()
    payload["torch_generator_device"] = np.asarray(trainer.generator.device.type)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # write-then-rename: a kill mid-savez must never leave a torn file at the
    # resume path
    tmp = path + ".tmp.npz"   # keep the .npz suffix so savez won't rename
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, trainer, log_fn=print) -> None:
    """Restore a checkpoint of either package in place; the trainer must be
    built with the same config.  The generator's state carries over only
    from a port checkpoint drawn on the trainer's device type (CUDA's and
    the CPU's states differ); otherwise the generator is reseeded from the
    trainer's seed and one line says so."""
    with np.load(norm_path(path), allow_pickle=False) as npz:
        data = {k: npz[k] for k in npz.files}
    rf_named = _named(trainer.field)
    with torch.no_grad():
        for k, p in rf_named.items():
            p.copy_(_take(data, f"params|{k}", p))
        if trainer.ent_params is not None:
            ent_named = _named(trainer.ent_params)
            for k, p in ent_named.items():
                p.copy_(_take(data, f"ent|{k}", p))
    _load_adam(trainer.optimizer, trainer.scheduler, rf_named, data, "opt_rf")
    if trainer.opt_ent is not None:
        _load_adam(trainer.opt_ent, trainer.sched_ent, ent_named, data, "opt_ent")
    res = int(data["bin_res"])
    if res != trainer.occ_state.resolution:
        raise ValueError(f"occupancy grid {res}^3 in the checkpoint, "
                         f"{trainer.occ_state.resolution}^3 in the trainer")
    bits = np.unpackbits(data["binaries"])[:res ** 3].reshape((res,) * 3).astype(bool)
    dev = trainer.occ_state.occs.device
    trainer.occ_state = trainer.occ_state._replace(
        occs=torch.from_numpy(np.array(data["occs"], dtype=np.float32)).to(dev),
        binaries=torch.from_numpy(bits).to(dev))
    trainer.step = int(data["step"])
    trainer.num_rays = int(data["num_rays"])
    gen_dev = str(data["torch_generator_device"]) if "torch_generator_device" in data else None
    if gen_dev == trainer.generator.device.type:
        trainer.generator.set_state(torch.from_numpy(data["torch_generator"]))
    else:
        trainer.generator.manual_seed(trainer.seed)
        log_fn(f"checkpoint {norm_path(path)}: "
               + ("no torch generator state (a cnc_tpu checkpoint)" if gen_dev is None else
                  f"its generator was drawn on {gen_dev}, this trainer's is on "
                  f"{trainer.generator.device.type}")
               + f"; the generator is reseeded from seed {trainer.seed}")


def load_field(path: str, cfg: ModelConfig, device=None) -> Tuple[RadianceField, torch.Tensor]:
    """(field, binaries [R,R,R] bool) from a checkpoint npz of either
    package, on `device`."""
    dev = resolve_device(device)
    with np.load(norm_path(path), allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    field = params_from_jax(_nest(flat, "params"), cfg, device=dev)
    res = int(flat["bin_res"])
    bits = np.unpackbits(flat["binaries"])[:res ** 3].reshape((res,) * 3)
    return field, torch.from_numpy(bits.astype(bool)).to(dev)
