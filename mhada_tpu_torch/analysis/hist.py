"""BGR histogram plots (mhada_tpu/analysis/hist.py; reference hist.py:5-40).
cv2 and matplotlib are imported at use."""

import os


def plot_bgr_histograms(image_paths: list[str], out_path: str | None = None,
                        show: bool = False):
    import cv2
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(image_paths)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 4), squeeze=False)
    for ax, path in zip(axes[0], image_paths):
        img = cv2.imread(path)
        for ch, color in enumerate(("b", "g", "r")):
            hist = cv2.calcHist([img], [ch], None, [256], [0, 256])
            ax.plot(hist, color=color)
        ax.set_title(os.path.basename(path))
        ax.set_xlim([0, 256])
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path)
    if show:
        plt.show()
    plt.close(fig)
    return out_path
