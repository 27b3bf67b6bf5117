"""Procedural "fake-CelebA": label-controlled synthetic face images (the
port's own copy of `dwcgan_tpu/data/procedural.py`, pure numpy).

This environment has no real CelebA images (zero egress).  Training on pure
noise gives no measurable *quality* signal, so this module renders procedural
face-like images whose visual features are a deterministic function of the 8
CelebA attribute bits (reference attribute list: `train.py:50-51`):

    Black/Blond/Brown_Hair -> hair-cap color
    Male                   -> face (jaw) width
    Smiling                -> mouth arc (corners up) vs flat mouth
    Young                  -> skin brightness (+ forehead wrinkles when old)
    Eyeglasses             -> dark rings around the eyes + bridge bar
    No_Beard               -> chin patch absent/present

Because the mapping is analytic, `measure_attributes` can read the bits back
from any image — including *generated* ones — giving an objective
attribute-transfer accuracy metric for text-guided translation, plus real
images for FID trends.  Nuisance variation (background color, center jitter,
pixel noise) keeps the task generative rather than a lookup table.

Dataset item contract matches `CelebADataset.__getitem__` (image [H,W,3]
float32 in [-1,1], src_label, trg_label, txt_ids, txt_len) so the standard
`DataPipeline`/`to_device` path is exercised unchanged.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np

from dwcgan_tpu_torch.data.drawkey import draw_key
from dwcgan_tpu_torch.text.synthesis import TextSynthesizer
from dwcgan_tpu_torch.text.vocab import Vocab, tokens_to_ids

# ---- shared geometry (normalized [0,1] coords; renderer + probe) ----
FACE_CY, FACE_CX = 0.58, 0.5
FACE_RX_F, FACE_RX_M = 0.26, 0.32        # female / male face half-width
FACE_RY = 0.30
HAIR_CY, HAIR_RX, HAIR_RY = 0.30, 0.34, 0.17
EYE_Y, EYE_DX, EYE_R = 0.52, 0.10, 0.025
GLASS_R, GLASS_T = 0.055, 0.012
MOUTH_Y, MOUTH_HALF_W, MOUTH_T = 0.71, 0.10, 0.014
SMILE_DEPTH = 0.045                       # corner-to-center y offset when smiling
BEARD_Y0, BEARD_Y1 = 0.76, 0.86
WRINKLE_YS = (0.40, 0.43, 0.46)

# ---- shared colors ([0,1] RGB) ----
HAIR_COLORS = {
    "black": (0.08, 0.07, 0.07),
    "blond": (0.90, 0.78, 0.35),
    "brown": (0.45, 0.29, 0.15),
    "gray":  (0.55, 0.55, 0.55),          # none-of-the-three fallback
}
SKIN_YOUNG = (0.95, 0.80, 0.70)
SKIN_OLD = (0.76, 0.68, 0.60)
MOUTH_COLOR = (0.62, 0.10, 0.12)
EYE_COLOR = (0.06, 0.05, 0.05)
GLASS_COLOR = (0.10, 0.10, 0.12)
BEARD_COLOR = (0.16, 0.11, 0.08)
WRINKLE_COLOR = (0.55, 0.45, 0.38)

ATTRS = ("Black_Hair", "Blond_Hair", "Brown_Hair", "Male",
         "Smiling", "Young", "Eyeglasses", "No_Beard")


def sample_labels(n: int, rng: np.random.Generator) -> np.ndarray:
    """[n, 8] float32 in {0,1}; hair colors mutually exclusive, beard male-only
    (matching CelebA's real label structure)."""
    lab = np.zeros((n, 8), np.float32)
    hair = rng.choice(4, size=n, p=[0.3, 0.25, 0.25, 0.2])  # 3 == none
    for k in range(3):
        lab[:, k] = hair == k
    lab[:, 3] = rng.random(n) < 0.5                        # Male
    lab[:, 4] = rng.random(n) < 0.5                        # Smiling
    lab[:, 5] = rng.random(n) < 0.7                        # Young
    lab[:, 6] = rng.random(n) < 0.3                        # Eyeglasses
    beard = (lab[:, 3] > 0) & (rng.random(n) < 0.4)
    lab[:, 7] = ~beard                                     # No_Beard
    return lab


def render_face(label: np.ndarray, size: int = 128,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """Render one face for an 8-bit label. Returns [size,size,3] f32 in [-1,1]."""
    if rng is None:
        rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    jy, jx = (rng.uniform(-0.01, 0.01), rng.uniform(-0.01, 0.01))
    yy, xx = yy - jy, xx - jx

    img = np.empty((size, size, 3), np.float32)
    # pastel background, rejection-sampled away from both skin tones so the
    # probe's jaw-width measurement can't leak across the face boundary
    while True:
        bg = rng.uniform(0.55, 0.95, 3).astype(np.float32)
        if min(np.abs(bg - np.asarray(SKIN_YOUNG)).mean(),
               np.abs(bg - np.asarray(SKIN_OLD)).mean()) > 0.18:
            break
    img[:] = bg

    black, blond, brown, male, smiling, young, glasses, no_beard = \
        (bool(round(float(v))) for v in label)

    # hair cap (behind the face)
    hair_mask = (((yy - HAIR_CY) / HAIR_RY) ** 2
                 + ((xx - FACE_CX) / HAIR_RX) ** 2) <= 1.0
    hc = HAIR_COLORS["black" if black else "blond" if blond
                     else "brown" if brown else "gray"]
    img[hair_mask] = hc

    # face ellipse
    rx = FACE_RX_M if male else FACE_RX_F
    face_mask = (((yy - FACE_CY) / FACE_RY) ** 2
                 + ((xx - FACE_CX) / rx) ** 2) <= 1.0
    skin = SKIN_YOUNG if young else SKIN_OLD
    img[face_mask] = skin

    if not young:                                          # forehead wrinkles
        for wy in WRINKLE_YS:
            m = face_mask & (np.abs(yy - wy) < 0.006) & (np.abs(xx - FACE_CX) < 0.14)
            img[m] = WRINKLE_COLOR

    # eyes
    for sx in (-EYE_DX, EYE_DX):
        m = ((yy - EYE_Y) ** 2 + (xx - (FACE_CX + sx)) ** 2) <= EYE_R ** 2
        img[m] = EYE_COLOR

    if glasses:
        for sx in (-EYE_DX, EYE_DX):
            r2 = (yy - EYE_Y) ** 2 + (xx - (FACE_CX + sx)) ** 2
            ring = (r2 <= (GLASS_R + GLASS_T) ** 2) & (r2 >= (GLASS_R - GLASS_T) ** 2)
            img[ring] = GLASS_COLOR
        bridge = (np.abs(yy - EYE_Y) < GLASS_T) & \
                 (np.abs(xx - FACE_CX) < EYE_DX - GLASS_R + GLASS_T)
        img[bridge] = GLASS_COLOR

    # mouth: smiling -> corners up (smaller y) relative to center
    mx = np.clip((xx - FACE_CX) / MOUTH_HALF_W, -1.0, 1.0)
    curve = MOUTH_Y + (SMILE_DEPTH * (1.0 - mx ** 2) - SMILE_DEPTH * 0.5
                       if smiling else 0.0)
    mouth = (np.abs(yy - curve) < MOUTH_T) & (np.abs(xx - FACE_CX) <= MOUTH_HALF_W)
    img[mouth] = MOUTH_COLOR

    if not no_beard:
        beard = face_mask & (yy > BEARD_Y0) & (yy < BEARD_Y1) & ~mouth
        img[beard] = BEARD_COLOR

    img += rng.normal(0.0, 0.015, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0) * 2.0 - 1.0


# ---------------- attribute probe ----------------

def _patch_median(img01: np.ndarray, y0: float, y1: float,
                  x0: float, x1: float) -> np.ndarray:
    s = img01.shape[0]
    return np.median(
        img01[int(y0 * s):max(int(y1 * s), int(y0 * s) + 1),
              int(x0 * s):max(int(x1 * s), int(x0 * s) + 1)].reshape(-1, 3),
        axis=0)


def measure_attributes(image: np.ndarray) -> np.ndarray:
    """Read the 8 attribute bits back from one [H,W,3] image in [-1,1].

    Analytic inverse of `render_face`; works on generated images too (a fixed,
    training-free classifier for attribute-transfer accuracy).  Patch
    locations keep clear margins from every other feature under the renderer's
    +-0.01 center jitter.
    """
    img = (np.asarray(image, np.float32) + 1.0) / 2.0
    s = img.shape[0]
    out = np.zeros(8, np.float32)

    # hair: hair-cap patch (above the face top, which reaches y=0.28 center)
    hair = _patch_median(img, 0.16, 0.26, 0.42, 0.58)
    names = list(HAIR_COLORS)
    d = [np.abs(hair - np.asarray(HAIR_COLORS[k])).mean() for k in names]
    best = names[int(np.argmin(d))]
    out[0], out[1], out[2] = best == "black", best == "blond", best == "brown"

    # skin reference from the nose patch (clear of eyes/rings/mouth)
    skin_ref = _patch_median(img, 0.555, 0.595, 0.48, 0.52)

    # male: contiguous skin-colored run through the center on the jaw band.
    # A global color match would count skin-like *background* pixels (the
    # pastel background can coincide with a skin tone); contiguity from the
    # center column avoids that.
    # band sits below the glasses rings (max y ~0.60 with jitter) and above
    # the smile's mouth corners (min y ~0.66 with jitter)
    band = img[int(0.615 * s):int(0.655 * s)].mean(0)
    skin_like = np.abs(band - skin_ref).mean(-1) < 0.12
    c = s // 2
    right = c
    while right < s - 1 and skin_like[right + 1]:
        right += 1
    left = c
    while left > 0 and skin_like[left - 1]:
        left -= 1
    width = (right - left + 1) / s
    out[3] = width > (FACE_RX_F + FACE_RX_M)  # midpoint of the two diameters

    # smiling: corner-vs-center y-centroid of mouth-colored pixels
    y0, y1 = int(0.64 * s), int(0.80 * s)
    dist = np.abs(img[y0:y1] - np.asarray(MOUTH_COLOR)).mean(-1)
    ys, xs = np.nonzero(dist < 0.15)
    if len(ys) >= 4:
        xn = xs / s
        corner = ys[(xn < FACE_CX - 0.05) | (xn > FACE_CX + 0.05)]
        center = ys[np.abs(xn - FACE_CX) < 0.04]
        if len(corner) and len(center):
            out[4] = (center.mean() - corner.mean()) / s > SMILE_DEPTH * 0.4

    # young: nose-patch skin tone, nearest of the two palettes
    out[5] = np.abs(skin_ref - np.asarray(SKIN_YOUNG)).mean() < \
        np.abs(skin_ref - np.asarray(SKIN_OLD)).mean()

    # eyeglasses: a dark bridge-bar row inside a jitter-tolerant window
    win = img[int(0.49 * s):int(0.56 * s), int(0.47 * s):int(0.53 * s)]
    out[6] = win.mean(-1).mean(-1).min() < 0.42

    # beard: dark chin patch
    chin = _patch_median(img, 0.79, 0.84, 0.44, 0.56)
    out[7] = np.abs(chin - np.asarray(BEARD_COLOR)).mean() >= 0.15  # No_Beard
    return out


def attribute_accuracy(images: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-attribute accuracy [8] of the probe over a batch."""
    preds = np.stack([measure_attributes(im) for im in images])
    return (preds == np.asarray(labels, np.float32)).mean(0)


# ---------------- dataset ----------------

class ProceduralFaceDataset:
    """Map-style dataset; item contract identical to `CelebADataset`."""

    def __init__(self, n_samples: int = 4000, image_size: int = 128,
                 seed: int = 1234, mode: str = "train", max_text_len: int = 80,
                 dataset: str = "CelebA", cache: bool = True):
        self.image_size = image_size
        self.max_text_len = max_text_len
        self.mode = mode
        base = np.random.default_rng(seed)
        self.labels = sample_labels(n_samples, base)
        self.seed = seed
        self.vocab = Vocab(dataset)
        self.rng = random.Random(seed + (1 if mode == "test" else 0))
        self.synth = TextSynthesizer(self.rng)
        self._rng_salt = 0
        # renders are deterministic per index; memoize as uint8 (~n*48KB at
        # 128px) so epochs after the first cost no render CPU — this host
        # class can be CPU-starved and the renderer would otherwise compete
        # with the training loop's dispatch for the core
        self._cache: dict[int, np.ndarray] | None = {} if cache else None

    def __len__(self) -> int:
        return len(self.labels)

    def reseed_augmentation(self, salt: int) -> None:
        """Decorrelate per-item augmentation randomness (target pairing,
        flip, text) across data-parallel hosts; `self.labels` and the
        per-index renders stay process-identical (they must — each host's
        disjoint index slice refers to the same global dataset).  Called by
        `DataPipeline` with salt=process_index when process_count > 1."""
        self._rng_salt = salt
        self.rng = random.Random(self.seed + (1 if self.mode == "test" else 0)
                                 + 7919 * (salt + 1))
        self.synth = TextSynthesizer(self.rng)

    def render(self, index: int) -> np.ndarray:
        """Deterministic per-index render (nuisance varies with index only)."""
        if self._cache is not None and index in self._cache:
            u8 = self._cache[index]
            return u8.astype(np.float32) / 127.5 - 1.0
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        img = render_face(self.labels[index], self.image_size, rng)
        if self._cache is not None:
            # store AND return the uint8 roundtrip so repeated calls are
            # bit-identical (the 1/127.5 quantization is visually lossless)
            u8 = np.round((img + 1.0) * 127.5).astype(np.uint8)
            self._cache[index] = u8
            return u8.astype(np.float32) / 127.5 - 1.0
        return img

    def __getitem__(self, index: int) -> Tuple[np.ndarray, ...]:
        return self._make_item(index, self.rng, self.synth)

    def item(self, index: int, epoch: int) -> Tuple[np.ndarray, ...]:
        """Deterministic variant of __getitem__: augmentation (target
        pairing, text synthesis, flip) is keyed by (seed, host salt,
        epoch, index) instead of drawn from the shared stateful RNG, so
        item content is independent of prefetch-thread scheduling —
        reference DataLoader reproducibility, stateless-key style
        (data/drawkey.py)."""
        rng = random.Random(draw_key(
            self.seed + (1 if self.mode == "test" else 0),
            self._rng_salt, epoch, index))
        return self._make_item(index, rng, TextSynthesizer(rng))

    def _make_item(self, index: int, rng: random.Random,
                   synth: TextSynthesizer) -> Tuple[np.ndarray, ...]:
        src_label = self.labels[index]
        trg_label = self.labels[rng.randrange(len(self.labels))]
        command = synth.labels2text(src_label, trg_label)
        ids, lens = tokens_to_ids([command.split()], self.vocab, self.max_text_len)
        image = self.render(index)
        if self.mode == "train" and rng.random() < 0.5:
            image = image[:, ::-1].copy()
        return (image, src_label.astype(np.float32),
                trg_label.astype(np.float32), ids[0], lens[0])
