"""cnc_torch's lens undistortion (utils/camera_undistort.py) against
cnc_tpu's on the same numpy inputs.

Tolerance: 1e-5 absolute on normalized coordinates within [-0.8, 0.8]
(the same ten float32 Newton steps; products in another association may
round apart by an ulp per step).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_tpu.utils import camera_undistort as jcu
from cnc_torch.utils import camera_undistort as tcu

PARAMS = {
    "radial_tangential6": [0.05, -0.01, 0.002, -0.0005, 0.001, -0.002],
    "opencv4": [-0.12, 0.03, 0.0008, -0.0011],
    "strong": [0.3, 0.1, 0.0, 0.0, 0.01, 0.01],
}


def _distort(x, y, p):
    k1, k2, k3, k4, p1, p2 = p
    r2 = x * x + y * y
    d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    return (d * x + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            d * y + 2 * p2 * x * y + p1 * (r2 + 2 * y * y))


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_opencv_lens_undistortion_matches_cnc_tpu(name):
    params = np.asarray(PARAMS[name], np.float32)
    full = (params if params.size == 6 else
            np.asarray([params[0], params[1], 0, 0, params[2], params[3]], np.float32))
    rng = np.random.default_rng(len(name))
    x, y = rng.uniform(-0.8, 0.8, (2, 4096)).astype(np.float32)
    uv = np.stack(_distort(x, y, full), -1).astype(np.float32).reshape(64, 64, 2)
    want = np.asarray(jcu.opencv_lens_undistortion(jnp.asarray(uv), jnp.asarray(params)))
    got = tcu.opencv_lens_undistortion(torch.from_numpy(uv), torch.from_numpy(params)).numpy()
    assert got.shape == uv.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # and it inverts the distortion
    np.testing.assert_allclose(got.reshape(-1, 2), np.stack([x, y], -1), atol=2e-4, rtol=0)


def test_radial_and_tangential_undistort_matches_cnc_tpu():
    p = (0.05, -0.01, 0.0, 0.0, 0.001, -0.002)
    rng = np.random.default_rng(0)
    xd, yd = rng.uniform(-0.5, 0.5, (2, 1000)).astype(np.float32)
    want = jcu.radial_and_tangential_undistort(jnp.asarray(xd), jnp.asarray(yd), p)
    got = tcu.radial_and_tangential_undistort(torch.from_numpy(xd), torch.from_numpy(yd), p)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    # a singular jacobian leaves the point where it is
    sx, sy = tcu.radial_and_tangential_undistort(torch.tensor([0.5]), torch.tensor([0.5]),
                                                 (0.0,) * 6, eps=10.0)
    assert float(sx) == 0.5 and float(sy) == 0.5
