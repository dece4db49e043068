"""Natural-image-class data of the 64-px stretch config (port of
data/natural.py; numpy and Pillow only, a copy of the JAX package's module,
so the same seed gives the same images bit for bit).

* `generate_natural('objects' | 'faces', n, seed)` — procedural 64x64 RGB
  images in ten classes: textured object scenes (CIFAR-10-class: plane,
  car, bird, cat, deer, dog, frog, horse, ship and truck analogues) and
  face schematics (CelebA-class: hair colour x glasses). Class k of one
  pairs with class k of the other: the cross-modal coupling.
* `load_natural(kind, n, seed, root)` — real CIFAR-10 python batches
  (<root>/cifar-10-batches-py/data_batch_*) or CelebA aligned images with
  list_attr_celeba.txt (<root>/celeba/ or <root>) when they are on disk,
  the procedural generator otherwise. Nothing is downloaded.

Arrays cache under <root>/synthetic_cache/ (nat_* for the procedural
images, real_* for the real-data assemblies).
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

# class-typical palettes: (sky/bg top, bg bottom, object base color)
_OBJECT_STYLES = [
    # name,      bg_top,          bg_bottom,       obj_color
    ("plane", (120, 170, 230), (190, 215, 240), (190, 195, 205)),
    ("car", (140, 140, 150), (90, 90, 95), (180, 40, 40)),
    ("bird", (135, 190, 235), (170, 210, 235), (150, 110, 70)),
    ("cat", (200, 180, 160), (150, 130, 110), (120, 90, 60)),
    ("deer", (110, 150, 90), (150, 180, 110), (140, 100, 60)),
    ("dog", (170, 160, 150), (120, 110, 100), (200, 170, 130)),
    ("frog", (60, 110, 60), (100, 150, 80), (80, 170, 70)),
    ("horse", (150, 190, 220), (120, 160, 90), (90, 60, 40)),
    ("ship", (130, 180, 225), (40, 90, 150), (210, 210, 215)),
    ("truck", (150, 155, 165), (105, 105, 110), (210, 160, 40)),
]

_HAIR_COLORS = [(25, 20, 20), (95, 60, 35), (205, 175, 95),
                (150, 60, 35), (170, 170, 170)]
_SKIN_TONES = [(246, 219, 185), (228, 185, 145), (200, 150, 110),
               (160, 110, 75), (120, 80, 55)]


def _value_noise(rng: np.random.RandomState, px: int, amp: float = 1.0
                 ) -> np.ndarray:
    """Multi-octave value noise in [-amp, amp], [px, px]."""
    out = np.zeros((px, px), np.float32)
    for cells in (4, 8, 16):
        g = rng.randn(cells, cells).astype(np.float32)
        # bilinear upsample to px
        idx = np.linspace(0, cells - 1, px)
        i0 = np.floor(idx).astype(int)
        i1 = np.minimum(i0 + 1, cells - 1)
        f = (idx - i0).astype(np.float32)
        rows = (g[i0] * (1 - f)[:, None] + g[i1] * f[:, None])
        out += (rows[:, i0] * (1 - f)[None, :] + rows[:, i1] * f[None, :])
    out /= 3.0
    return out * amp


def _bg_gradient(rng, px, top, bottom, noise_amp=10.0):
    t = np.linspace(0, 1, px, dtype=np.float32)[:, None, None]
    top = np.asarray(top, np.float32) + rng.randint(-25, 26, 3)
    bottom = np.asarray(bottom, np.float32) + rng.randint(-25, 26, 3)
    img = top[None, None, :] * (1 - t) + bottom[None, None, :] * t
    img = img + _value_noise(rng, px, noise_amp)[..., None]
    return img


def _finish(rng, arr, blur=True):
    from PIL import Image, ImageFilter

    arr = np.clip(arr, 0, 255).astype(np.uint8)
    img = Image.fromarray(arr)
    if blur:
        img = img.filter(ImageFilter.GaussianBlur(
            radius=float(rng.uniform(0.4, 0.9))))
    out = np.asarray(img, np.float32)
    out += rng.normal(0, 4.0, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def _render_object_scene(rng: np.random.RandomState, cls: int, px: int
                         ) -> np.ndarray:
    """One CIFAR-class textured scene, uint8 [px, px, 3]."""
    from PIL import Image, ImageDraw

    name, bg_top, bg_bot, base = _OBJECT_STYLES[cls]
    arr = _bg_gradient(rng, px, bg_top, bg_bot)
    img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    d = ImageDraw.Draw(img)

    def jcol(c, j=35):
        return tuple(int(np.clip(v + rng.randint(-j, j + 1), 0, 255))
                     for v in c)

    col = jcol(base)
    dark = tuple(int(v * 0.55) for v in col)
    s = px / 64.0                       # scale factor
    cx = px // 2 + int(rng.randint(-6, 7) * s)
    cy = px // 2 + int(rng.randint(-4, 5) * s)
    u = rng.uniform(0.8, 1.25) * s      # size jitter

    def E(x0, y0, x1, y1, c):           # ellipse around (cx,cy), units of u
        d.ellipse([cx + x0 * u, cy + y0 * u, cx + x1 * u, cy + y1 * u],
                  fill=c)

    def P(pts, c):                      # polygon
        d.polygon([(cx + a * u, cy + b * u) for a, b in pts], fill=c)

    if name == "plane":
        P([(-24, 2), (24, -2), (20, 4), (-20, 6)], col)          # fuselage
        P([(-4, 0), (10, -16), (16, -14), (4, 2)], jcol(base))   # wing up
        P([(-4, 4), (8, 16), (14, 14), (4, 3)], dark)            # wing down
        P([(-24, 2), (-18, -8), (-14, -7), (-18, 3)], jcol(base))  # tail
    elif name == "car":
        E(-22, -2, 22, 14, col)                                  # body
        P([(-12, -2), (-6, -12), (10, -12), (14, -2)], jcol(col, 20))
        E(-16, 8, -6, 18, (25, 25, 28))                          # wheels
        E(6, 8, 16, 18, (25, 25, 28))
        d.rectangle([0, cy + 16 * u, px, px], fill=jcol((70, 70, 72)))
    elif name == "bird":
        E(-12, -6, 12, 10, col)                                  # body
        E(6, -16, 20, -4, jcol(col, 20))                         # head
        P([(-8, -2), (-22, -14), (-4, -8)], dark)                # wing
        P([(18, -11), (26, -9), (18, -7)], (230, 180, 40))       # beak
        d.line([cx - 20 * u, cy + 14 * u, cx + 24 * u, cy + 12 * u],
               fill=(90, 60, 35), width=max(1, int(2 * s)))      # branch
    elif name == "cat":
        E(-14, -2, 10, 16, col)                                  # body
        E(2, -18, 20, 0, jcol(col, 15))                          # head
        P([(4, -16), (6, -26), (11, -17)], col)                  # ears
        P([(14, -17), (19, -26), (20, -15)], col)
        E(7, -12, 10, -9, (20, 60, 20))                          # eyes
        E(14, -12, 17, -9, (20, 60, 20))
        d.line([cx - 14 * u, cy + 8 * u, cx - 24 * u, cy - 2 * u],
               fill=col, width=max(1, int(3 * s)))               # tail
    elif name == "deer":
        E(-14, -4, 12, 8, col)                                   # body
        E(8, -18, 20, -6, jcol(col, 15))                         # head
        for lx in (-10, -4, 4, 9):
            d.rectangle([cx + lx * u, cy + 6 * u, cx + (lx + 2) * u,
                         cy + 20 * u], fill=dark)                # legs
        for ax in (10, 15):                                      # antlers
            d.line([cx + ax * u, cy - 16 * u, cx + (ax + 4) * u,
                    cy - 26 * u], fill=dark, width=max(1, int(2 * s)))
    elif name == "dog":
        E(-16, -2, 8, 14, col)                                   # body
        E(0, -16, 18, 2, jcol(col, 15))                          # head
        E(12, -4, 20, 4, dark)                                   # snout
        P([(2, -14), (0, -24), (8, -16)], dark)                  # ear
        E(5, -10, 8, -7, (30, 25, 20))                           # eye
    elif name == "frog":
        E(-18, -2, 18, 14, col)                                  # body
        E(-14, -10, -4, 0, col)                                  # eye bumps
        E(4, -10, 14, 0, col)
        E(-11, -8, -7, -4, (240, 240, 210))                      # eyes
        E(7, -8, 11, -4, (240, 240, 210))
        E(-10, -7, -8, -5, (20, 20, 20))
        E(8, -7, 10, -5, (20, 20, 20))
    elif name == "horse":
        E(-16, -4, 10, 8, col)                                   # body
        P([(8, -4), (16, -18), (22, -16), (12, 0)], col)         # neck
        E(16, -22, 26, -14, jcol(col, 15))                       # head
        for lx in (-12, -6, 2, 7):
            d.rectangle([cx + lx * u, cy + 6 * u, cx + (lx + 2) * u,
                         cy + 20 * u], fill=dark)                # legs
    elif name == "ship":
        d.rectangle([0, cy + 8 * u, px, px], fill=jcol((50, 100, 160)))
        P([(-22, 8), (22, 8), (14, 18), (-16, 18)], dark)        # hull
        d.rectangle([cx - 8 * u, cy - 4 * u, cx + 8 * u, cy + 8 * u],
                    fill=col)                                    # cabin
        d.rectangle([cx - 2 * u, cy - 16 * u, cx + 2 * u, cy - 4 * u],
                    fill=dark)                                   # stack
    else:  # truck
        d.rectangle([cx - 22 * u, cy - 12 * u, cx + 8 * u, cy + 8 * u],
                    fill=col)                                    # box
        d.rectangle([cx + 8 * u, cy - 4 * u, cx + 22 * u, cy + 8 * u],
                    fill=jcol(col, 25))                          # cab
        E(-16, 4, -6, 14, (25, 25, 28))                          # wheels
        E(8, 4, 18, 14, (25, 25, 28))
        d.rectangle([0, cy + 12 * u, px, px], fill=jcol((75, 75, 78)))

    # distractor blob (clouds / bushes / second object hint)
    for _ in range(rng.randint(1, 3)):
        bx, by = rng.randint(0, px, 2)
        r = rng.randint(3, 8) * s
        d.ellipse([bx - r, by - r * 0.6, bx + r, by + r * 0.6],
                  fill=jcol(bg_top, 20))

    out = np.asarray(img, np.float32)
    out += _value_noise(rng, px, 6.0)[..., None]   # texture over everything
    return _finish(rng, out)


def _render_face(rng: np.random.RandomState, cls: int, px: int) -> np.ndarray:
    """One CelebA-class face schematic, uint8 [px, px, 3].

    Attribute k = (hair color k%5, glasses k>=5)."""
    from PIL import Image, ImageDraw

    hair = tuple(int(np.clip(v + rng.randint(-18, 19), 0, 255))
                 for v in _HAIR_COLORS[cls % 5])
    glasses = cls >= 5
    skin = _SKIN_TONES[rng.randint(0, len(_SKIN_TONES))]
    skin = tuple(int(np.clip(v + rng.randint(-12, 13), 0, 255)) for v in skin)

    hue = rng.randint(0, 3)
    bg_base = [(168, 180, 200), (200, 185, 170), (175, 195, 175)][hue]
    arr = _bg_gradient(rng, px, bg_base,
                       tuple(int(v * 0.75) for v in bg_base), 6.0)
    img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    d = ImageDraw.Draw(img)

    s = px / 64.0
    cx = px // 2 + int(rng.randint(-4, 5) * s)
    cy = px // 2 + int(rng.randint(-3, 2) * s)
    u = rng.uniform(0.9, 1.12) * s

    def E(x0, y0, x1, y1, c):
        d.ellipse([cx + x0 * u, cy + y0 * u, cx + x1 * u, cy + y1 * u],
                  fill=c)

    # shoulders / torso
    shirt = tuple(int(v) for v in rng.randint(40, 200, 3))
    d.ellipse([cx - 26 * u, cy + 18 * u, cx + 26 * u, cy + 50 * u],
              fill=shirt)
    # hair mass behind the head (style jitter: long vs short)
    long_hair = rng.rand() < 0.5
    hy = 34 if long_hair else 16
    E(-17, -26, 17, hy, hair)
    # head
    E(-13, -22, 13, 14, skin)
    # hair fringe on top
    E(-13, -24, 13, -8, hair)
    E(-11, -16, 11, -4, skin)        # reopen forehead
    # ears
    E(-15, -4, -11, 4, skin)
    E(11, -4, 15, 4, skin)
    # eyes
    ey = -3 + rng.randint(-1, 2)
    for ex in (-6, 6):
        E(ex - 3, ey - 2, ex + 3, ey + 2, (245, 245, 245))
        iris = (60, 40, 25) if rng.rand() < 0.6 else (55, 80, 120)
        E(ex - 1.4, ey - 1.6, ex + 1.4, ey + 1.2, iris)
        # brow
        d.line([cx + (ex - 4) * u, cy + (ey - 5) * u,
                cx + (ex + 4) * u, cy + (ey - 5.5) * u],
               fill=hair, width=max(1, int(1.6 * s)))
    if glasses:
        gw = max(1, int(1.4 * s))
        for ex in (-6, 6):
            d.ellipse([cx + (ex - 4.6) * u, cy + (ey - 3.6) * u,
                       cx + (ex + 4.6) * u, cy + (ey + 3.6) * u],
                      outline=(20, 20, 22), width=gw)
        d.line([cx - 1.6 * u, cy + ey * u, cx + 1.6 * u, cy + ey * u],
               fill=(20, 20, 22), width=gw)
    # nose
    d.line([cx, cy + (ey + 1) * u, cx - 1.5 * u, cy + 6 * u],
           fill=tuple(int(v * 0.85) for v in skin),
           width=max(1, int(1.5 * s)))
    # mouth (smile jitter)
    smile = rng.uniform(-1.0, 2.5)
    d.arc([cx - 5 * u, cy + (7 - smile) * u, cx + 5 * u,
           cy + (12 + smile) * u], start=20, end=160,
          fill=(150, 60, 60), width=max(1, int(1.8 * s)))
    return _finish(rng, np.asarray(img, np.float32))


def generate_natural(
    kind: str,           # 'objects' (CIFAR-class) | 'faces' (CelebA-class)
    n: int,
    seed: int,
    root: str = "./data",
    cache: bool = True,
    px: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images uint8 [n,px,px,3], labels int32 [n]); deterministic
    in (kind, n, seed, px)."""
    cache_dir = os.path.join(root, "synthetic_cache")
    path = os.path.join(cache_dir, f"nat_{kind}_{n}_{seed}_{px}px.npz")
    if cache and os.path.exists(path):
        z = np.load(path)
        return z["images"], z["labels"]

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.int32)
    if kind == "objects":
        imgs = np.stack([_render_object_scene(rng, int(c), px)
                         for c in labels])
    elif kind == "faces":
        imgs = np.stack([_render_face(rng, int(c), px) for c in labels])
    else:
        raise ValueError(kind)
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(path, images=imgs, labels=labels)
    return imgs, labels


# ---------------------------------------------------------------------------
# Real-data ingestion: the stretch config pairs CIFAR-10 with CelebA; the
# procedural generators above are the default, and when the real files are
# under the data root the loader reads them instead (the auto-detect
# pattern of data/sources.py's MNIST IDX / SVHN .mat files).
#
# Recognized layouts:
#   objects → CIFAR-10 python batches:  <root>/cifar-10-batches-py/
#             data_batch_{1..5} (pickled dicts, data [10000,3072] u8
#             row-major CHW, labels 0..9 — the canonical distribution)
#   faces   → CelebA aligned images:    <root>/celeba/img_align_celeba/*.jpg
#             (or <root>/img_align_celeba/) + list_attr_celeba.txt next to
#             the image dir or under <root>/celeba/.
#
# CelebA's 10-way pairing class mirrors the procedural faces' latent:
# (hair color ∈ {black, brown, blonde, red/other, gray}) × (glasses ∈
# {no, yes}) — class = hair*2 + glasses — so a trained procedural stack
# and a real-data stack share label semantics (data/natural.py module
# docstring; ref mnist_svhn_dataset.py:93-99 label-aligned pairing).
# ---------------------------------------------------------------------------

def _resize_u8(img: np.ndarray, px: int) -> np.ndarray:
    """[H,W,3] uint8 → [px,px,3] uint8 (PIL bilinear; center-crop to
    square first so CelebA 178×218 doesn't squash)."""
    from PIL import Image

    h, w = img.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    img = img[y0:y0 + s, x0:x0 + s]
    if s == px:
        return np.ascontiguousarray(img)
    return np.asarray(Image.fromarray(img).resize((px, px), Image.BILINEAR))


def _find_cifar10(root: str):
    d = os.path.join(root, "cifar-10-batches-py")
    batches = [os.path.join(d, f"data_batch_{i}") for i in range(1, 6)]
    present = [p for p in batches if os.path.exists(p)]
    return present or None


def _load_cifar10(root: str, n: int, seed: int, px: int):
    import pickle

    imgs, labels = [], []
    for p in _find_cifar10(root):
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        data = np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32)
        imgs.append(data.transpose(0, 2, 3, 1))     # CHW → HWC
        labels.append(np.asarray(d[b"labels"], np.int32))
    imgs = np.concatenate(imgs)
    labels = np.concatenate(labels)
    rng = np.random.RandomState(seed)
    pick = (rng.permutation(len(imgs))[:n] if n <= len(imgs)
            else rng.randint(0, len(imgs), n))     # sample w/ replacement
    out = np.stack([_resize_u8(imgs[i], px) for i in pick])
    return out, labels[pick].astype(np.int32)


def _find_celeba(root: str):
    for base in (os.path.join(root, "celeba"), root):
        img_dir = os.path.join(base, "img_align_celeba")
        attrs = os.path.join(base, "list_attr_celeba.txt")
        if os.path.isdir(img_dir) and os.path.exists(attrs):
            return img_dir, attrs
    return None


def _celeba_class(row: dict) -> int:
    """10-way (hair × glasses) class matching the procedural faces' latent
    order [black, brown, blonde, red/other, gray] × [no, yes]."""
    if row.get("Black_Hair", -1) == 1:
        hair = 0
    elif row.get("Brown_Hair", -1) == 1:
        hair = 1
    elif row.get("Blond_Hair", -1) == 1:
        hair = 2
    elif row.get("Gray_Hair", -1) == 1:
        hair = 4
    else:
        hair = 3   # red / unlabeled → the procedural 'red' slot
    return hair * 2 + int(row.get("Eyeglasses", -1) == 1)


def _load_celeba(root: str, n: int, seed: int, px: int):
    from PIL import Image

    img_dir, attr_path = _find_celeba(root)
    with open(attr_path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    # canonical format: count line, attr-name header, then rows
    # "filename v1 v2 ..." with v ∈ {+1,-1}
    header_i = 1 if lines[0].isdigit() else 0
    names = lines[header_i].split()
    rows = []
    for ln in lines[header_i + 1:]:
        parts = ln.split()
        fname = parts[0]
        if not os.path.exists(os.path.join(img_dir, fname)):
            continue
        vals = dict(zip(names, (int(v) for v in parts[1:])))
        rows.append((fname, _celeba_class(vals)))
    if not rows:
        raise FileNotFoundError(
            f"CelebA attr file {attr_path} lists no image present in "
            f"{img_dir}")
    rng = np.random.RandomState(seed)
    pick = (rng.permutation(len(rows))[:n] if n <= len(rows)
            else rng.randint(0, len(rows), n))
    imgs, labels = [], []
    for i in pick:
        fname, cls = rows[i]
        with Image.open(os.path.join(img_dir, fname)) as im:
            arr = np.asarray(im.convert("RGB"), np.uint8)
        imgs.append(_resize_u8(arr, px))
        labels.append(cls)
    return np.stack(imgs), np.asarray(labels, np.int32)


def load_natural(
    kind: str,           # 'objects' | 'faces'
    n: int,
    seed: int,
    root: str = "./data",
    cache: bool = True,
    px: int = 64,
) -> Tuple[np.ndarray, np.ndarray, str]:
    """Config-#5 loader with real-data auto-detection.

    Returns (images uint8 [n,px,px,3], labels int32 [n], source) where
    source ∈ {'cifar10', 'celeba', 'procedural'}. Real files win when
    present (layouts above); otherwise falls back to `generate_natural`.
    Real-data assemblies are cached under <root>/synthetic_cache/ (the
    JPEG decode + resize pass is the expensive part, not the sampling).
    """
    if kind not in ("objects", "faces"):
        raise ValueError(kind)
    real = _find_cifar10(root) if kind == "objects" else _find_celeba(root)
    if real is None:
        imgs, labels = generate_natural(kind, n, seed, root=root,
                                        cache=cache, px=px)
        return imgs, labels, "procedural"

    source = "cifar10" if kind == "objects" else "celeba"
    cache_dir = os.path.join(root, "synthetic_cache")
    path = os.path.join(cache_dir, f"real_{source}_{n}_{seed}_{px}px.npz")
    if cache and os.path.exists(path):
        z = np.load(path)
        return z["images"], z["labels"], source
    loader = _load_cifar10 if kind == "objects" else _load_celeba
    imgs, labels = loader(root, n, seed, px)
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(path, images=imgs, labels=labels)
    return imgs, labels, source
