"""Image <-> tile-major layout helpers (PyTorch port).

The render core works in tile-major layout ``[T, Q]``: ``T`` tiles in
row-major order over the tile grid, ``Q = tile_h * tile_w`` pixels per tile.
"""

from __future__ import annotations

import torch.nn.functional as F


def grid_dims(h: int, w: int, th: int, tw: int):
    return -(-w // tw), -(-h // th)  # tiles_x, tiles_y


def img_to_tiles(img, th: int, tw: int, pad_value=0.0):
    """[..., H, W] -> [..., T, Q] (padding partial tiles)."""
    *lead, h, w = img.shape
    tx, ty = grid_dims(h, w, th, tw)
    x = F.pad(img, (0, tx * tw - w, 0, ty * th - h), value=pad_value)
    x = x.reshape(*lead, ty, th, tx, tw)
    x = x.movedim(-2, -3)  # [..., ty, tx, th, tw]
    return x.reshape(*lead, ty * tx, th * tw)


def tiles_to_img(tiles, h: int, w: int, th: int, tw: int):
    """[..., T, Q] -> [..., H, W] (cropping padded tiles)."""
    *lead, t, q = tiles.shape
    tx, ty = grid_dims(h, w, th, tw)
    x = tiles.reshape(*lead, ty, tx, th, tw)
    x = x.movedim(-3, -2)  # [..., ty, th, tx, tw]
    x = x.reshape(*lead, ty * th, tx * tw)
    return x[..., :h, :w]
