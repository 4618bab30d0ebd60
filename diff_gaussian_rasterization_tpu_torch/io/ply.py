"""3DGS-standard PLY import/export for Gaussian models (PyTorch port of the
JAX package's ``io/ply.py``).

Binary-little-endian PLY with per-vertex fields::

    x y z nx ny nz f_dc_0..2 f_rest_0..(3M-4) opacity scale_0..2 rot_0..3

``f_dc`` are the degree-0 SH coefficients, ``f_rest`` the higher orders in
channel-major order (all R coefficients, then G, then B); ``opacity`` is
the pre-sigmoid logit, ``scale`` the pre-exp log and ``rot`` the
unnormalized quaternion (r, x, y, z): the ``GaussianModel``
parametrization.  numpy structured arrays only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gaussians import GaussianModel, init_model


def save_ply(path: str, model: GaussianModel):
    """Write the ACTIVE Gaussians in 3DGS PLY layout."""
    as_np = lambda t: t.detach().cpu().numpy()
    act = as_np(model.active)
    means = as_np(model.means3D)[act]
    scales = as_np(model.scales_log)[act]
    rots = as_np(model.rotations)[act]
    opac = as_np(model.opacities_logit)[act]
    sh = as_np(model.sh)[act]                             # (N, M, 3)
    n, m, _ = sh.shape
    f_dc = sh[:, 0, :]
    # channel-major rest coefficients, the 3DGS convention
    f_rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, 3 * (m - 1))

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(3 * (m - 1))]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    data = np.zeros(n, dtype=[(nm, "<f4") for nm in names])
    cols = np.concatenate(
        [means, np.zeros((n, 3), np.float32), f_dc, f_rest, opac, scales,
         rots], axis=1)
    for i, nm in enumerate(names):
        data[nm] = cols[:, i]

    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {nm}" for nm in names]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        data.tofile(f)


def load_ply(path: str, capacity: int = None,
             device="cuda") -> GaussianModel:
    """Read a 3DGS PLY into a GaussianModel (padded to ``capacity``)."""
    with open(path, "rb") as f:
        names = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line == "end_header":
                break
            elif (line.startswith("format")
                  and "binary_little_endian" not in line):
                raise ValueError(f"unsupported PLY format: {line}")
        data = np.fromfile(f, dtype=[(nm, "<f4") for nm in names], count=n)

    def cols(prefix, k):
        return np.stack([data[f"{prefix}_{i}"] for i in range(k)], -1)

    means = np.stack([data["x"], data["y"], data["z"]], -1)
    n_rest = len([nm for nm in names if nm.startswith("f_rest_")])
    m = 1 + n_rest // 3
    sh = np.zeros((n, m, 3), np.float32)
    sh[:, 0, :] = cols("f_dc", 3)
    if n_rest:
        sh[:, 1:, :] = cols("f_rest", n_rest).reshape(
            n, 3, m - 1).transpose(0, 2, 1)

    cap = capacity or n
    if cap < n:
        raise ValueError(
            f"PLY file holds {n} Gaussians but capacity={cap}; pass "
            f"capacity >= {n} (never a silent cap)")

    def pad(a):
        a = np.asarray(a, np.float32)
        if cap > n:
            a = np.concatenate(
                [a, np.zeros((cap - n, *a.shape[1:]), np.float32)], 0)
        return torch.as_tensor(a, device=device)

    sh_degree = int(round(m ** 0.5)) - 1
    model = init_model(cap, sh_degree=sh_degree, device=device)
    with torch.no_grad():
        model.means3D.copy_(pad(means))
        model.scales_log.copy_(pad(cols("scale", 3)))
        model.rotations.copy_(pad(cols("rot", 4)))
        model.opacities_logit.copy_(pad(data["opacity"][:, None]))
        model.sh.copy_(pad(sh))
        model.active.copy_(torch.arange(cap, device=device) < n)
    return model
