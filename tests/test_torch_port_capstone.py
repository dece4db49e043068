"""The port's capstone, on the CPU: train two flows and a ratio net with the
port's own train steps, then show that mc_feng guidance through the port's
`make_guided_sampler` raises pair coherence, as the JAX package's
tests/test_integration_e2e.py does for the JAX package.

The same two-class blob data (y is x rotated by 90 degrees, drawn from the
same numpy stream), the same sizes and budgets (H = 12, FlexibleUNet with
model_channels 8 and channel_mult (1, 2), 80 FM steps per net,
FlexibleRatioEstimator(32, 64) with 60 disc steps, 24 Euler steps, 48
samples and N_mc 48) and the same criterion: coherence(mc_feng, 0.8) >
coherence(none) + 0.1. The seeds are the JAX test's numbers, fixed before
the first run: numpy 0, the nets 1, 2, 3, the steps 100 + i, 200 + i,
300 + i, the sampler 9.
"""
import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlexibleRatioEstimator,
    FlexibleUNet,
)
from ratio_guided_multimodal_fm_tpu_torch.sample import (
    GuidedSamplerConfig,
    make_guided_sampler,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    create_fm_state,
    create_ratio_state,
    make_fm_train_step,
    make_ratio_train_step,
    velocity_nhwc,
)

H = 12
CPU = torch.device("cpu")


def _make_batch(rng, n):
    """Two-class blobs; y = rot90(x) of a same-class (not same!) sample."""
    cls = rng.randint(0, 2, n)
    base = np.full((n, H, H, 1), -0.6, np.float32)
    for i, c in enumerate(cls):
        if c == 0:
            base[i, 1:5, 1:5, 0] = 1.0
        else:
            base[i, 7:11, 7:11, 0] = 1.0
    base += rng.randn(n, H, H, 1).astype(np.float32) * 0.08
    ys = np.rot90(base, k=-1, axes=(1, 2)).copy()
    return base, ys, cls


def _blob_class(im, rot=False):
    im = np.asarray(im)[..., 0]
    if rot:
        im = np.rot90(im, k=1, axes=(1, 2))
    tl = im[:, 1:5, 1:5].sum(axis=(1, 2))
    br = im[:, 7:11, 7:11].sum(axis=(1, 2))
    return (br > tl).astype(int)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_guidance_improves_coherence_end_to_end():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _capstone()
    finally:
        torch.set_num_threads(threads)


def _capstone():
    rng = np.random.RandomState(0)

    def unet(seed):
        torch.manual_seed(seed)
        return FlexibleUNet(in_channels=1, img_size=H, model_channels=8,
                            channel_mult=(1, 2), num_res_blocks=1,
                            dropout=0.0)

    sx = create_fm_state(unet(1), CPU, lr=2e-3)
    sy = create_fm_state(unet(2), CPU, lr=2e-3)
    fstep = make_fm_train_step()
    for i in range(80):
        x, y, _ = _make_batch(rng, 64)
        fstep(sx, torch.from_numpy(x), _gen(100 + i))
        fstep(sy, torch.from_numpy(y), _gen(200 + i))

    torch.manual_seed(3)
    rs = create_ratio_state(
        FlexibleRatioEstimator(x_channels=1, y_channels=1, feature_dim=32,
                               hidden_dim=64), CPU, lr=3e-3)
    rstep = make_ratio_train_step("disc")
    for i in range(60):
        # the JAX test's draws, in its order (y_mis is drawn and unused)
        x, y, cls = _make_batch(rng, 64)
        flip = rng.rand(64) < 0.5
        np.rot90(np.where(
            flip[:, None, None, None],
            _make_batch(rng, 64)[0][np.argsort(rng.rand(64))],
            np.rot90(y, k=1, axes=(1, 2))), k=-1, axes=(1, 2))
        # real = matched rotation pair, fake = shuffled partner
        perm = rng.permutation(64)
        is_real = np.where(flip, (cls == cls[perm]).astype(np.float32), 1.0)
        yy = np.where(flip[:, None, None, None], y[perm], y)
        rstep(rs, torch.from_numpy(x), torch.from_numpy(yy),
              torch.from_numpy(is_real.astype(np.float32)), _gen(300 + i))

    for s in (sx, sy, rs):
        s.model.eval()
    fm_x, fm_y = velocity_nhwc(sx.model), velocity_nhwc(sy.model)

    def log_ratio(a, b):
        return rs.model.log_ratio(a.permute(0, 3, 1, 2),
                                  b.permute(0, 3, 1, 2))

    def coherence(method, strength):
        cfg = GuidedSamplerConfig(method, strength, num_steps=24,
                                  mc_batch_size=48, x_shape=(H, H, 1),
                                  y_shape=(H, H, 1))
        sampler = make_guided_sampler(fm_x, fm_y, cfg, log_ratio)
        x1, y1, _ = sampler(_gen(9), 48)
        assert torch.isfinite(x1).all() and torch.isfinite(y1).all()
        return float((_blob_class(x1.numpy())
                      == _blob_class(y1.numpy(), rot=True)).mean())

    c0 = coherence("none", 0.0)
    c1 = coherence("mc_feng", 0.8)
    print(f"coherence: none {c0:.3f}, mc_feng at 0.8 {c1:.3f}")
    assert c1 > c0 + 0.1, f"guidance did not help: {c0} -> {c1}"
