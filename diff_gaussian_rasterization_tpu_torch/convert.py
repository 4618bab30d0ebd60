"""Carry a scene across from the JAX package: weights and cameras as numpy.

``gaussian_model_from_numpy`` takes the fields of the JAX package's
``GaussianModel`` (``means3D``, ``scales_log``, ``rotations``,
``opacities_logit``, ``sh``, ``active``) as numpy arrays and builds the
port's model; ``camera_from_numpy`` does the same for a camera.  With them
both packages render one scene.  Nothing here imports JAX: the caller
converts with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import Camera
from .models.gaussians import PARAM_FIELDS, GaussianModel


def gaussian_model_from_numpy(arrays, device="cuda",
                              dtype=torch.float32) -> GaussianModel:
    """``arrays``: a mapping from the six field names to numpy arrays."""
    missing = [k for k in PARAM_FIELDS + ("active",) if k not in arrays]
    if missing:
        raise KeyError(f"missing GaussianModel fields: {missing}")
    # np.array copies: arrays handed over from JAX are read-only
    t = lambda k: torch.as_tensor(np.array(arrays[k]), dtype=dtype,
                                  device=device)
    active = torch.as_tensor(np.array(arrays["active"], dtype=bool),
                             device=device)
    return GaussianModel(*(t(k) for k in PARAM_FIELDS), active)


def camera_from_numpy(viewmatrix, tanfovx, tanfovy, h, w, device="cuda",
                      znear=0.01, zfar=100.0) -> Camera:
    """A camera from a (4,4) row-vector-convention view matrix."""
    vm = torch.as_tensor(np.array(viewmatrix, np.float32), device=device)
    return Camera(viewmatrix=vm, tanfovx=float(tanfovx),
                  tanfovy=float(tanfovy), height=int(h), width=int(w),
                  znear=float(znear), zfar=float(zfar))
