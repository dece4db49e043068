"""The 64-px cross-channel stretch demo (port of scripts/stretch64_demo.py):
a 64-px RGB flow beside a 64-px grayscale one, coupled by a cross-channel
ratio net, through the library API.

Steps, as in the JAX script:

* synthetic 64-px digits: SVHN-style RGB (seed 10) and MNIST-style
  grayscale (seed 11), --n of each (data/synthetic.py), both held on the
  device;
* two FlowMatchingUNet64 (in_channels 3 and 1, bf16 activations, Adam
  2e-4) through the CFM step, --epochs epochs at --batch_size, saved to and
  reloaded from --ckpt_dir (fm_x.pth, fm_y.pth: a rerun skips the flow
  training);
* FlexibleRatioEstimator(x_channels=3, y_channels=1) in bf16 with the
  `disc` loss (Adam --ratio_lr, clip 1.0), --ratio_epochs (default
  max(8, --epochs)) on same-label (real) and different-label (fake) pairs;
* the guided sweep: none, mc_feng γ 0.5 and γ 1.0 on 64 pairs, N_mc 128,
  log r̂ clipped at 3, --num_steps Euler steps; the mc_feng steps run
  kernel A at Dx = 12,288, Dy = 4,096. A nearest-centroid label readout
  (per-label mean training image) gives the coherence.

Writes outputs/stretch64/results.json with the JAX script's keys (and the
sample grids where matplotlib is installed). --device cpu runs it on the
CPU; --model_channels narrows the U-Nets there (96 is FlowMatchingUNet64).

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.stretch64_demo \\
        --epochs 6 --n 4000
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    ratio_log_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.core.device import (
    place_model,
    resolve_device,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG, set_seed
from ratio_guided_multimodal_fm_tpu_torch.data.pipeline import (
    Pairing,
    gather,
    to_device,
    to_unit_range,
)
from ratio_guided_multimodal_fm_tpu_torch.data.synthetic import (
    generate_digits,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlexibleRatioEstimator,
    FlexibleUNet,
)
from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    GuidedSamplerConfig,
    make_guided_sampler_p,
)
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (
    load_params,
    save_checkpoint,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    create_fm_state,
    create_ratio_state,
    make_fm_train_step,
    make_ratio_train_step,
)

X_SHAPE, Y_SHAPE = (64, 64, 3), (64, 64, 1)
SWEEP = (("none", 0.0), ("mc_feng", 0.5), ("mc_feng", 1.0))


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--n", type=int, default=4000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_steps", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ratio_epochs", type=int, default=None,
                   help="default: max(8, --epochs)")
    p.add_argument("--ratio_lr", type=float, default=1e-4)
    p.add_argument("--ratio_seed", type=int, default=3)
    p.add_argument("--ckpt_dir", type=str, default="outputs/stretch64/ckpt",
                   help="flows are saved/loaded here so ratio-only reruns "
                        "skip the flow training")
    p.add_argument("--model_channels", type=int, default=96,
                   help="U-Net width (96 = FlowMatchingUNet64; small values "
                        "for CPU smoke runs)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu'")
    return p


def centroids(imgs: np.ndarray, lbls: np.ndarray) -> np.ndarray:
    """The per-label mean image [10, ...]."""
    return np.stack([imgs[lbls == c].mean(axis=0) for c in range(10)])


def read_label(samples: np.ndarray, cents: np.ndarray) -> np.ndarray:
    """Each sample's nearest centroid (L2), the label readout."""
    s = np.asarray(samples, np.float32).reshape(len(samples), -1)
    c = cents.reshape(10, -1)
    d = (s * s).sum(1)[:, None] - 2 * s @ c.T + (c * c).sum(1)[None, :]
    return d.argmin(axis=1)


def main(argv=None):
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    set_seed(args.seed)
    print("Generating 64px synthetic data...", flush=True)
    x_u8, x_lbl = generate_digits("svhn", args.n, seed=10, px=64)   # RGB
    y_u8, y_lbl = generate_digits("mnist", args.n, seed=11, px=64)  # gray
    x_imgs, y_imgs = to_unit_range(x_u8), to_unit_range(y_u8)
    x_dev, y_dev = to_device(x_imgs, device), to_device(y_imgs, device)
    pairing = Pairing(y_lbl)

    states = []
    for seed, ch in ((1, 3), (2, 1)):
        torch.manual_seed(seed)
        states.append(create_fm_state(FlexibleUNet(
            in_channels=ch, img_size=64, model_channels=args.model_channels,
            channel_mult=(1, 2, 2, 4), num_res_blocks=2, dropout=0.1,
            dtype=torch.bfloat16), device, lr=2e-4))
    sx, sy = states
    n_params = sum(p.numel() for p in sx.model.parameters())
    print(f"FM-64 RGB params: {n_params:,}", flush=True)

    step = make_fm_train_step()
    rng = RNG(args.seed + 1, device)
    nb = args.n // args.batch_size
    host = np.random.RandomState(0)
    t0 = time.time()
    loss_curve = {"flow_x": [], "flow_y": [], "ratio": []}
    ck_x, ck_y = (os.path.join(args.ckpt_dir, f"{nm}.pth")
                  for nm in ("fm_x", "fm_y"))
    if os.path.exists(ck_x) and os.path.exists(ck_y):
        load_params(ck_x, sx.model)
        load_params(ck_y, sy.model)
        print("Loaded flow checkpoints; skipping flow training", flush=True)
    else:
        for epoch in range(args.epochs):
            order = host.permutation(args.n)[: nb * args.batch_size]
            losses = []
            for b in range(nb):
                idx = order[b * args.batch_size:(b + 1) * args.batch_size]
                losses.append(torch.stack([
                    step(sx, gather(x_dev, idx), rng.generator(epoch, b, 0)),
                    step(sy, gather(y_dev, idx), rng.generator(epoch, b, 1))]))
            ax, ay = (torch.stack(losses).mean(0).tolist() if losses
                      else (float("nan"),) * 2)
            loss_curve["flow_x"].append(round(ax, 4))
            loss_curve["flow_y"].append(round(ay, 4))
            print(f"epoch {epoch+1}/{args.epochs} loss_x={ax:.3f} "
                  f"loss_y={ay:.3f} ({time.time()-t0:.0f}s)", flush=True)
        save_checkpoint(ck_x, sx.model.state_dict())
        save_checkpoint(ck_y, sy.model.state_dict())

    # the cross-channel ratio estimator (3 channels x 1 channel at 64 px)
    torch.manual_seed(args.ratio_seed)
    rs = create_ratio_state(FlexibleRatioEstimator(
        x_channels=3, y_channels=1, dtype=torch.bfloat16), device,
        lr=args.ratio_lr)
    rstep = make_ratio_train_step("disc")
    ratio_epochs = args.ratio_epochs or max(8, args.epochs)
    for epoch in range(ratio_epochs):
        order = host.permutation(args.n)[: nb * args.batch_size]
        metrics = {}
        for b in range(nb):
            idx = order[b * args.batch_size:(b + 1) * args.batch_size]
            lbl = x_lbl[idx]
            is_real = host.rand(len(idx)) < 0.5
            y_same = pairing.same_label(lbl, host)
            y_diff, _ = pairing.different_label(lbl, host)
            y_idx = np.where(is_real, y_same, y_diff)
            metrics = rstep(rs, gather(x_dev, idx), gather(y_dev, y_idx),
                            is_real.astype(np.float32),
                            rng.generator(10_000 + epoch, b))
        row = {k: round(float(v), 4) for k, v in metrics.items()}
        loss_curve["ratio"].append(row)
        print(f"ratio epoch {epoch+1}: "
              + " ".join(f"{k}={v:.3f}" for k, v in row.items()), flush=True)

    fm_x, fm_y = (place_model(s.model, device) for s in (sx, sy))
    ratio = place_model(rs.model, device)
    os.makedirs("outputs/stretch64", exist_ok=True)
    cx, cy = centroids(x_imgs, x_lbl), centroids(y_imgs, y_lbl)
    results = {"loss_curve": loss_curve}
    for method, gamma in SWEEP:
        cfg = GuidedSamplerConfig(
            guidance_method=method, guidance_strength=gamma,
            num_steps=args.num_steps, mc_batch_size=128, x_shape=X_SHAPE,
            y_shape=Y_SHAPE, log_ratio_clip=3.0)
        sampler = make_guided_sampler_p(
            lambda m, x, t: velocity_fn(m)(x, t),
            lambda m, y, t: velocity_fn(m)(y, t), cfg,
            None if method == "none" else
            (lambda r, a, b: ratio_log_fn(r)(a, b)))
        t0 = time.time()
        xs, ys, _ = sampler((fm_x, fm_y, ratio),
                            torch.Generator(device).manual_seed(9), 64)
        xs, ys = xs.cpu().numpy(), ys.cpu().numpy()   # a copy: a barrier
        dt = time.time() - t0
        path = f"outputs/stretch64/samples_{method}_gamma{gamma}.png"
        try:
            from ratio_guided_multimodal_fm_tpu_torch.eval.viz import (
                visualize_pairs_mnist_svhn,
            )
            visualize_pairs_mnist_svhn(torch.from_numpy(xs[:32]),
                                       torch.from_numpy(ys[:32]), path,
                                       num_cols=8, num_rows=4)
        except ImportError as e:   # matplotlib is optional
            path = f"no PNG ({e})"
        coh = float(np.mean(read_label(xs, cx) == read_label(ys, cy)))
        results[f"{method}_gamma{gamma}"] = {
            "wall_sec": round(dt, 1),
            "centroid_coherence": round(coh, 4),
            "finite": bool(np.isfinite(xs).all() and np.isfinite(ys).all()),
        }
        print(f"{method} γ={gamma}: {dt:.1f}s coherence={coh:.3f} -> {path}",
              flush=True)

    with open("outputs/stretch64/results.json", "w") as f:
        json.dump(results, f, indent=2)
    print("DONE", flush=True)
    return results


if __name__ == "__main__":
    main()
