"""Spectrogram triptych plots: original / pre-refiner / post-refiner
(counterpart of ``mqgan_tpu/utils/plotting.py``): stacked panels with a
shared colour range, magma, saved under ``{output_dir}/plots``. matplotlib
is imported inside the function; where it is missing the import raises and
the trainer logs that and goes on."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def plot_mel_spectrograms(spectrograms: Sequence[np.ndarray],
                          titles: Sequence[str], vmin: float, vmax: float,
                          save_path: str | None = None,
                          main_title: str = "Mel Spectrograms"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(spectrograms)
    fig, axes = plt.subplots(n, 1, figsize=(10, 4 * n))
    if n == 1:
        axes = [axes]
    for ax, spec, title in zip(axes, spectrograms, titles):
        im = ax.imshow(np.asarray(spec, np.float32).T, aspect="auto",
                       origin="lower", vmin=vmin, vmax=vmax, cmap="magma")
        fig.colorbar(im, ax=ax, format="%+2.0f")
        ax.set_title(title)
        ax.set_ylabel("Frequency")
    axes[-1].set_xlabel("Time")
    plt.suptitle(main_title)
    plt.tight_layout(rect=[0, 0.03, 1, 0.95])
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        plt.savefig(save_path)
    plt.close(fig)
    return save_path


def save_triptych(output_dir: str, tag: str, original, recon_pre, recon_post,
                  length: int | None = None):
    arrays = [np.asarray(a, np.float32)[:length]
              for a in (original, recon_pre, recon_post)]
    vmin = min(a.min() for a in arrays)
    vmax = max(a.max() for a in arrays)
    path = os.path.join(output_dir, "plots", f"{tag}.png")
    return plot_mel_spectrograms(
        arrays, ["Original", "Reconstructed (Pre-Refiner)",
                 "Reconstructed (Post-Refiner)"], vmin, vmax, path, tag)
