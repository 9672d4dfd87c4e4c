"""Read a cnc_tpu checkpoint into the port, and the npz key layout bundles share.

`cnc_tpu/utils/checkpoint.py` writes one npz: every param leaf under
`params|<keystr>` (e.g. `params|['xyz']`, `params|['mlp_base']['l0']['w']`,
`cnc_tpu/utils/checkpoint.py:19-23`), the occupancy grid bit-packed under
`binaries` with its resolution in `bin_res` (:54-56, :76-78).  `load_field`
reads it with numpy alone; `_flatten` writes nested dicts under the same keys
(the codec's bundle uses it); saving and resuming come with slice 5.
"""

from __future__ import annotations

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


def load_field(path: str, cfg: ModelConfig, device=None) -> Tuple[RadianceField, torch.Tensor]:
    """(field, binaries [R,R,R] bool) from a cnc_tpu checkpoint npz, on `device`."""
    dev = resolve_device(device)
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    field = params_from_jax(_nest(flat, "params"), cfg, device=dev)
    res = int(flat["bin_res"])
    bits = np.unpackbits(flat["binaries"])[:res ** 3].reshape((res,) * 3)
    return field, torch.from_numpy(bits.astype(bool)).to(dev)
