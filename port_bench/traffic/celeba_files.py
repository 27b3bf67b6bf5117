"""Training traffic: a CelebA-format data set on disk, which the port's
own feed (`CelebADataset` under `DataPipeline`) reads as it reads CelebA.

`ensure(cache, traffic)` writes, once per checkout, `traffic["images"]`
JPEGs of 178 x 218 (CelebA's aligned size) named 000001.jpg ... and a
`list_attr_celeba.txt` with CelebA's 40 attribute columns (+-1), all from
the fixed `traffic["data_seed"]`, into a directory under `cache` named by
those two numbers; it is built beside it and renamed into place, so a run
that is cut leaves no half-written set.  The images are smooth random
colour fields plus noise, not faces: their JPEG decode costs what a
photograph of that size costs within a small factor, which the
configuration file states under `assumed`.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np

ATTRS = ("5_o_Clock_Shadow Arched_Eyebrows Attractive Bags_Under_Eyes Bald Bangs "
         "Big_Lips Big_Nose Black_Hair Blond_Hair Blurry Brown_Hair Bushy_Eyebrows "
         "Chubby Double_Chin Eyeglasses Goatee Gray_Hair Heavy_Makeup High_Cheekbones "
         "Male Mouth_Slightly_Open Mustache Narrow_Eyes No_Beard Oval_Face Pale_Skin "
         "Pointy_Nose Receding_Hairline Rosy_Cheeks Sideburns Smiling Straight_Hair "
         "Wavy_Hair Wearing_Earrings Wearing_Hat Wearing_Lipstick Wearing_Necklace "
         "Wearing_Necktie Young").split()
WIDTH, HEIGHT = 178, 218


def ensure(cache: Path, traffic: dict) -> Path:
    """The data set's directory (images/ and list_attr_celeba.txt)."""
    n, seed = traffic["images"], traffic["data_seed"]
    final = Path(cache) / f"celeba_{n}_{seed}"
    if (final / "list_attr_celeba.txt").exists():
        return final
    from PIL import Image

    tmp = Path(cache) / f"celeba_{n}_{seed}.partial{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    (tmp / "images").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    ys = (np.arange(HEIGHT) + 0.5) / HEIGHT * 6 - 0.5
    xs = (np.arange(WIDTH) + 0.5) / WIDTH * 5 - 0.5
    lines = [str(n), " ".join(ATTRS)]
    for i in range(n):
        low = rng.uniform(0, 255, (6, 5, 3))
        # bilinear upsample of the 6 x 5 field to 218 x 178
        y0 = np.clip(np.floor(ys).astype(int), 0, 4)
        x0 = np.clip(np.floor(xs).astype(int), 0, 3)
        wy = np.clip(ys - y0, 0, 1)[:, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, :, None]
        top = low[y0][:, x0] * (1 - wx) + low[y0][:, x0 + 1] * wx
        bot = low[y0 + 1][:, x0] * (1 - wx) + low[y0 + 1][:, x0 + 1] * wx
        img = top * (1 - wy) + bot * wy + rng.normal(0, 8, (HEIGHT, WIDTH, 3))
        name = f"{i + 1:06d}.jpg"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(tmp / "images" / name)
        signs = np.where(rng.random(len(ATTRS)) < 0.5, "-1", " 1")
        lines.append(name + " " + " ".join(signs))
    (tmp / "list_attr_celeba.txt").write_text("\n".join(lines) + "\n")
    try:
        os.rename(tmp, final)
    except OSError:          # another run renamed its copy first
        shutil.rmtree(tmp, ignore_errors=True)
    return final
