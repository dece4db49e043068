"""The 64-px stretch config end to end: object scenes ↔ faces at 64x64
(port of scripts/config5_demo.py).

Steps, as in the JAX script:

* `load_natural` objects (seed 20) and faces (seed 21), n each: real
  CIFAR-10 / CelebA files under ./data when present, the procedural
  generators otherwise (data/natural.py); both held on the device, every
  batch gathered there;
* two `Classifier64` (one per modality, Adam 1e-3, 6 epochs on 90%, the
  accuracy on the other 10%) for the coherence readout;
* two FlowMatchingUNet64 (in=3, --model_channels 96, bf16 activations,
  Adam --lr 2e-4, --batch_size 64) through the CFM step, --epochs epochs;
* `FlexibleRatioEstimator(3, 3)` (bf16, disc, Adam --ratio_lr, clip 1.0)
  on same-label (real) and different-label (fake) pairs, --ratio_epochs;
* the guidance sweep over --gammas (γ = 0 is 'none', else mc_feng):
  --num_samples pairs in --eval_chunks chunks with a fresh MC set per
  chunk (each chunk's set shared across the γ values), coherence and
  label entropies from the classifiers.

Writes outputs/config5/results.json with the JAX script's keys (and the
sample grids where matplotlib is installed); checkpoints go to --ckpt_dir
as .pth state dicts and are reloaded, skipping that training, when they
exist. --merged_unet evaluates the two U-Nets as one merged network
(models/merged.py) in the sampler and in the MC sets. --device cpu runs it
on the CPU (small --model_channels and --n there).

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.config5_demo \\
        --epochs 40 --n 8000 --ratio_epochs 80
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    classifier_fn,
    ratio_log_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.core.device import (
    place_model,
    resolve_device,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import (
    RNG,
    derive_seed,
    set_seed,
)
from ratio_guided_multimodal_fm_tpu_torch.data.natural import load_natural
from ratio_guided_multimodal_fm_tpu_torch.data.pipeline import (
    Pairing,
    gather,
    to_device,
    to_unit_range,
)
from ratio_guided_multimodal_fm_tpu_torch.eval.coherence import (
    label_entropy,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    Classifier64,
    FlexibleRatioEstimator,
    FlexibleUNet,
)
from ratio_guided_multimodal_fm_tpu_torch.models.merged import (
    can_merge,
    merged_pair_apply,
)
from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    GuidedSamplerConfig,
    generate_mc_set,
    make_guided_sampler_p,
)
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (
    load_params,
    save_checkpoint,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    create_classifier_state,
    create_fm_state,
    create_ratio_state,
    make_classifier_train_step,
    make_fm_train_step,
    make_ratio_train_step,
)

SHAPE = (64, 64, 3)


def train_classifier(imgs_dev, lbls: np.ndarray, seed: int, device,
                     epochs: int = 6, bs: int = 128):
    """A Classifier64 on the first 90% of the device-resident images;
    returns (NHWC -> logits function, accuracy on the other 10%)."""
    torch.manual_seed(seed)
    state = create_classifier_state(Classifier64(), device, lr=1e-3)
    step = make_classifier_train_step()
    n = len(imgs_dev)
    n_tr = int(n * 0.9)
    rng = RNG(seed, device)
    host = np.random.RandomState(seed)
    for ep in range(epochs):
        order = host.permutation(n_tr)
        for b in range(n_tr // bs):
            idx = order[b * bs:(b + 1) * bs]
            step(state, gather(imgs_dev, idx), lbls[idx],
                 rng.generator(ep, b))
    classify = classifier_fn(place_model(state.model, device))
    preds = [classify(imgs_dev[b:b + 256]).argmax(-1).cpu().numpy()
             for b in range(n_tr, n, 256)]
    acc = (float((np.concatenate(preds) == lbls[n_tr:]).mean())
           if preds else float("nan"))
    return classify, acc


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--n", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_steps", type=int, default=100)
    p.add_argument("--num_samples", type=int, default=256)
    p.add_argument("--mc_batch_size", type=int, default=128)
    p.add_argument("--eval_chunks", type=int, default=4)
    p.add_argument("--merged_unet", action="store_true",
                   help="merged-pair U-Net evaluation (models/merged.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--ratio_epochs", type=int, default=80)
    p.add_argument("--ratio_lr", type=float, default=1e-4)
    p.add_argument("--ratio_seed", type=int, default=3)
    p.add_argument("--gammas", nargs="+", type=float,
                   default=[0.0, 0.5, 1.0, 2.0])
    p.add_argument("--ckpt_dir", type=str, default="outputs/config5/ckpt")
    p.add_argument("--model_channels", type=int, default=96,
                   help="U-Net width (96 = FlowMatchingUNet64; small values "
                        "for CPU smoke runs)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    set_seed(args.seed)
    print("Loading natural-image-class data (objects/faces)...", flush=True)
    x_u8, x_lbl, x_src = load_natural("objects", args.n, seed=20)
    y_u8, y_lbl, y_src = load_natural("faces", args.n, seed=21)
    print(f"  objects source: {x_src}, faces source: {y_src}", flush=True)
    pairing = Pairing(y_lbl)
    x_dev = to_device(to_unit_range(x_u8), device)
    y_dev = to_device(to_unit_range(y_u8), device)

    print("Training eval classifiers...", flush=True)
    clf_x, acc_x = train_classifier(x_dev, x_lbl, 101, device)
    clf_y, acc_y = train_classifier(y_dev, y_lbl, 102, device)
    print(f"classifier acc: objects={acc_x:.3f} faces={acc_y:.3f}",
          flush=True)

    kw = dict(in_channels=3, img_size=64, model_channels=args.model_channels,
              channel_mult=(1, 2, 2, 4), num_res_blocks=2, dropout=0.1,
              dtype=torch.bfloat16)
    states = []
    for seed in (1, 2):
        torch.manual_seed(seed)
        states.append(create_fm_state(FlexibleUNet(**kw), device,
                                      lr=args.lr))
    sx, sy = states
    n_params = sum(p.numel() for p in sx.model.parameters())
    print(f"FM-64 params per modality: {n_params:,}", flush=True)

    step = make_fm_train_step()
    rng = RNG(args.seed + 1, device)
    nb = args.n // args.batch_size
    host = np.random.RandomState(0)
    loss_curve = {"flow_x": [], "flow_y": [], "ratio": []}
    t0 = time.time()
    os.makedirs(args.ckpt_dir, exist_ok=True)
    ck_x, ck_y, ck_r = (os.path.join(args.ckpt_dir, f"{nm}.pth")
                        for nm in ("fm_x", "fm_y", "ratio"))
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

    torch.manual_seed(args.ratio_seed)
    rs = create_ratio_state(
        FlexibleRatioEstimator(x_channels=3, y_channels=3,
                               dtype=torch.bfloat16), device,
        lr=args.ratio_lr)
    rstep = make_ratio_train_step("disc")
    if os.path.exists(ck_r):
        load_params(ck_r, rs.model)
        print("Loaded ratio checkpoint; skipping ratio training", flush=True)
    else:
        for epoch in range(args.ratio_epochs):
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
            print(f"ratio epoch {epoch+1}/{args.ratio_epochs}: "
                  + " ".join(f"{k}={v:.3f}" for k, v in row.items()),
                  flush=True)
        save_checkpoint(ck_r, rs.model.state_dict())

    fm_x, fm_y = (place_model(s.model, device) for s in (sx, sy))
    ratio = place_model(rs.model, device)
    fx, fy, log_ratio = velocity_fn(fm_x), velocity_fn(fm_y), \
        ratio_log_fn(ratio)
    pair_apply = (merged_pair_apply(fm_x)
                  if args.merged_unet and can_merge(fm_x, fm_y) else None)
    fm_pair = None if pair_apply is None else pair_apply(fm_x, fm_y)

    os.makedirs("outputs/config5", exist_ok=True)
    results = {"n_train": args.n, "fm_params_per_modality": n_params,
               "data_sources": {"objects": x_src, "faces": y_src},
               "classifier_acc": {"objects": acc_x, "faces": acc_y},
               "loss_curve": loss_curve, "eval": []}
    mc_sets = {}

    def mc_for(ci):
        """Chunk ci's MC set, drawn once and shared across the γ values."""
        if ci not in mc_sets:
            gen = torch.Generator(device).manual_seed(derive_seed(9, ci, 7))
            mc_sets[ci] = generate_mc_set(
                fx, fy, log_ratio, gen, args.mc_batch_size, SHAPE, SHAPE,
                args.num_steps, fm_pair_fn=fm_pair)
        return mc_sets[ci]

    for gamma in args.gammas:
        method = "none" if gamma == 0.0 else "mc_feng"
        cfg = GuidedSamplerConfig(
            guidance_method=method, guidance_strength=gamma,
            num_steps=args.num_steps, mc_batch_size=args.mc_batch_size,
            x_shape=SHAPE, y_shape=SHAPE)
        sampler = make_guided_sampler_p(
            lambda m, x, t: velocity_fn(m)(x, t),
            lambda m, y, t: velocity_fn(m)(y, t), cfg,
            None if method == "none" else
            (lambda r, a, b: ratio_log_fn(r)(a, b)),
            fm_pair_apply=pair_apply)

        n_chunks = args.eval_chunks if method == "mc_feng" else 1
        base, extra = divmod(args.num_samples, n_chunks)
        xs_all, ys_all = [], []
        t0 = time.time()
        for ci in range(n_chunks):
            mc = mc_for(ci) if method == "mc_feng" else None
            gen = torch.Generator(device).manual_seed(
                derive_seed(9, ci) if n_chunks > 1 else 9)
            xs, ys, _ = sampler((fm_x, fm_y, ratio), gen,
                                base + (1 if ci < extra else 0), mc)
            xs_all.append(xs.cpu().numpy())     # a copy: a barrier
            ys_all.append(ys.cpu().numpy())
        dt = time.time() - t0
        xs = np.concatenate(xs_all)
        ys = np.concatenate(ys_all)

        px = clf_x(xs).argmax(-1).cpu().numpy()
        py = clf_y(ys).argmax(-1).cpu().numpy()
        coh = float((px == py).mean())
        row = {
            "method": method, "gamma": gamma, "coherence": round(coh, 4),
            "label_entropy_objects": round(label_entropy(px), 3),
            "label_entropy_faces": round(label_entropy(py), 3),
            "wall_sec": round(dt, 1),
            "samples_per_sec": round(len(xs) / dt, 2),
            "finite": bool(np.isfinite(xs).all() and np.isfinite(ys).all()),
        }
        results["eval"].append(row)
        grid = f"outputs/config5/samples_{method}_gamma{gamma}.png"
        try:
            from ratio_guided_multimodal_fm_tpu_torch.eval.viz import (
                visualize_pairs_mnist_svhn,
            )
            visualize_pairs_mnist_svhn(
                torch.from_numpy(xs[:32]), torch.from_numpy(ys[:32]), grid,
                num_cols=8, num_rows=4,
                title="Generated Pairs — object scenes (odd rows) / "
                      "faces (even rows)")
        except ImportError as e:   # matplotlib is optional
            grid = f"no PNG ({e})"
        print(f"{method} gamma={gamma}: coherence={coh:.3f} "
              f"H(obj)={row['label_entropy_objects']} "
              f"H(face)={row['label_entropy_faces']} ({dt:.0f}s) -> {grid}",
              flush=True)

    with open("outputs/config5/results.json", "w") as f:
        json.dump(results, f, indent=1)
    print("DONE -> outputs/config5/results.json", flush=True)
    return results


if __name__ == "__main__":
    main()
