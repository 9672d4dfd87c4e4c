"""OpenCV-model lens undistortion (iterative Newton).

Port of `cnc_tpu/utils/camera_undistort.py` (nerfacc/cameras.py:13-211,
cuda/csrc/camera.cu and include/utils_camera.cuh:13-201): the radial
(k1..k4) and tangential (p1, p2) distortion is inverted by Newton steps on
the residual, over all pixels at once, in float32 with the same iteration
count.  Plain torch on the coordinates' device; unused by the CNC drivers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _residual_and_jacobian(x, y, xd, yd, params):
    """The distortion residual and its jacobian (utils_camera.cuh)."""
    k1, k2, k3, k4, p1, p2 = params
    r2 = x * x + y * y
    d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    d_r = k1 + r2 * (2.0 * k2 + r2 * (3.0 * k3 + r2 * 4.0 * k4))
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r

    fx = d * x + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xd
    fy = d * y + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y) - yd

    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_and_tangential_undistort(xd: torch.Tensor, yd: torch.Tensor,
                                    params: Sequence, eps: float = 1e-9,
                                    max_iterations: int = 10
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distorted normalized coordinates -> undistorted ones.  `params` holds
    (k1, k2, k3, k4, p1, p2) as floats or 0-dim tensors."""
    x, y = xd, yd
    for _ in range(max_iterations):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _residual_and_jacobian(x, y, xd, yd, params)
        det = fx_y * fy_x - fx_x * fy_y
        safe = torch.abs(det) > eps
        det = torch.where(safe, det, 1.0)
        dx = (fx * fy_y - fy * fx_y) / det
        dy = (fy * fx_x - fx * fy_x) / det
        x = torch.where(safe, x + dx, x)
        y = torch.where(safe, y + dy, y)
    return x, y


def opencv_lens_undistortion(uv: torch.Tensor, params: torch.Tensor,
                             max_iterations: int = 10) -> torch.Tensor:
    """uv [..., 2] distorted normalized coordinates; params [6]
    (k1, k2, k3, k4, p1, p2, shorter vectors zero-padded) or [4]
    (k1, k2, p1, p2), as nerfacc's cameras.py lays them out."""
    params = params.to(torch.float32)
    p = torch.zeros(6, dtype=torch.float32, device=params.device)
    p[:params.shape[-1]] = params
    if params.shape[-1] == 4:
        zero = torch.zeros((), dtype=torch.float32, device=params.device)
        p = torch.stack([params[0], params[1], zero, zero, params[2], params[3]])
    x, y = radial_and_tangential_undistort(uv[..., 0], uv[..., 1],
                                           tuple(p[i] for i in range(6)),
                                           max_iterations=max_iterations)
    return torch.stack([x, y], -1)
