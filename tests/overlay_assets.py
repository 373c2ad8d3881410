"""A synthetic reference assets/ tree for the PNG overlay
(`procgen2_tpu_torch.render.png_assets`), for the CPU tests and
chip_smoke.py's overlay phase: seeded random RGBA images at every path
the overlay reads."""
import pathlib

import numpy as np


def random_rgba(rng, h, w):
    """Random RGBA u8 [h, w, 4] from numpy Generator `rng`: fractional
    alpha, a quarter of the texels fully clear and a quarter opaque."""
    img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    r = rng.random((h, w))
    img[..., 3][r < 0.25] = 0
    img[..., 3][r > 0.75] = 255
    return img


def synthetic_assets(root, seed=13):
    """Write a synthetic reference assets/ tree under `root`: every path
    of png_assets.default_mapping() and BACKGROUND_PATHS as seeded
    `random_rgba`; sprites 12-70 px on a side, backgrounds wider or
    taller than square (they are square-cropped on install)."""
    from PIL import Image

    from procgen2_tpu_torch.render import png_assets

    rng = np.random.default_rng(seed)

    def save(rel, img):
        p = pathlib.Path(root) / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img, "RGBA").save(p)

    for rel in sorted(set(png_assets.default_mapping().values())):
        save(rel, random_rgba(rng, *rng.integers(12, 71, 2)))
    for rels in png_assets.BACKGROUND_PATHS.values():
        for rel in rels:
            h = int(rng.integers(40, 120))
            w = int(h * rng.choice([0.6, 1.5, 2.0]))
            save(rel, random_rgba(rng, h, w))
