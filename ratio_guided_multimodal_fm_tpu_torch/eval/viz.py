"""PNG pair-grid writers (port of eval/viz.py): columns of (x, y) pairs
stacked vertically, from NHWC tensors in [-1, 1]. matplotlib is imported
inside the function; callers that can run without it catch the
ImportError."""
from __future__ import annotations

import os

import numpy as np


def _to_01(img):
    return np.clip((img.detach().float().cpu().numpy() + 1.0) / 2.0, 0.0, 1.0)


def _pair_grid(samples_x, samples_y, save_path, title,
               num_cols=8, num_rows=8, row_labels=("x", "y")):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    num_pairs = min(num_cols * num_rows, len(samples_x))
    fig, axes = plt.subplots(num_rows * 2, num_cols,
                             figsize=(num_cols * 1.2, num_rows * 2 * 1.2 + 0.5))
    axes = np.atleast_2d(axes)

    for idx in range(num_cols * num_rows):
        col = idx % num_cols
        row_x = (idx // num_cols) * 2
        for r in (row_x, row_x + 1):
            axes[r, col].axis("off")
        if idx >= num_pairs:
            continue
        for r, img in ((row_x, _to_01(samples_x[idx])),
                       (row_x + 1, _to_01(samples_y[idx]))):
            if img.shape[-1] == 1:
                axes[r, col].imshow(img[..., 0], cmap="gray", vmin=0, vmax=1)
            else:
                axes[r, col].imshow(img)

    if row_labels:
        for pair_row in range(num_rows):
            for off, lbl in ((0, row_labels[0]), (1, row_labels[1])):
                ax = axes[pair_row * 2 + off, 0]
                ax.set_ylabel(lbl, fontsize=10, rotation=0, labelpad=15,
                              va="center")
                ax.yaxis.set_visible(True)

    fig.suptitle(title, fontsize=12, fontweight="bold")
    plt.tight_layout()
    d = os.path.dirname(save_path)
    if d:
        os.makedirs(d, exist_ok=True)
    plt.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"Saved visualization: {save_path}")


def visualize_pairs(samples_x, samples_y, save_path,
                    transform_type="rotate90", num_cols=8, num_rows=8):
    """MNIST-transform pair grid (experiment 1), NHWC samples in [-1, 1]."""
    _pair_grid(samples_x, samples_y, save_path,
               f"Generated Pairs (x, y) — Transform: {transform_type}",
               num_cols, num_rows)


def visualize_pairs_mnist_svhn(samples_x, samples_y, save_path,
                               num_cols=8, num_rows=4, title=None):
    """Cross-modal pair grid for NHWC samples in [-1, 1]."""
    _pair_grid(samples_x, samples_y, save_path,
               title or "Generated Pairs — MNIST (top) / SVHN (bottom)",
               num_cols, num_rows)
