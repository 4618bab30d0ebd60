"""Checkpoint and restore of the Gaussian map and a trajectory (PyTorch
port of the JAX package's ``utils/checkpoint.py``: ``torch.save`` and
``torch.load`` in place of orbax).

The file holds plain containers of CPU tensors, so ``torch.load`` reads it
with ``weights_only=True``.  The SLAM session's own checkpoint is
``models.runner.save_slam``.
"""

from __future__ import annotations

import torch

from ..models.gaussians import PARAM_FIELDS, GaussianModel


def model_tensors(model: GaussianModel) -> dict:
    """The model's six fields as detached CPU tensors."""
    return {k: getattr(model, k).detach().cpu()
            for k in PARAM_FIELDS + ("active",)}


def model_from_tensors(fields: dict, device="cuda") -> GaussianModel:
    return GaussianModel(*(fields[k].to(device).clone()
                           for k in PARAM_FIELDS + ("active",)))


def _stack(views):
    return torch.stack([torch.as_tensor(v).detach().cpu() for v in views])


def save(path: str, model: GaussianModel, est_views=None, kf_views=None,
         step: int = 0):
    payload = {"model": model_tensors(model), "step": int(step)}
    if est_views is not None:
        payload["est_views"] = _stack(est_views)
    if kf_views is not None:
        payload["kf_views"] = _stack(kf_views)
    torch.save(payload, path)


def restore(path: str, device="cuda"):
    """Returns (the model on ``device``, the payload as saved: ``step``
    and, when saved, ``est_views`` / ``kf_views`` [K, 4, 4] on the CPU)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return model_from_tensors(payload["model"], device), payload
