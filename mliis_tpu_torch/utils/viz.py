"""Prediction overlays: predicted masks on the query images.

A copy of the JAX package's `utils/viz.py` (numpy and matplotlib), with
the SAVE_PREDICTIONS toggle of the reference's reptile.py:495-513: during
an evaluation, each query image's predicted foreground is saved as a
translucent overlay under `predictions/` (PREDICTIONS_DIR overrides).

matplotlib is imported only when an overlay is drawn. Where it is not
installed (the card's machine has neither matplotlib nor PIL), drawing an
overlay raises ImportError saying so: the toggle never skips its overlays
quietly.
"""
import os
from typing import Optional

import numpy as np

SAVE_PREDICTIONS_ENV = "SAVE_PREDICTIONS"


def save_predictions_enabled() -> bool:
    return bool(os.environ.get(SAVE_PREDICTIONS_ENV))


def pyplot():
    """matplotlib.pyplot on the Agg backend, or ImportError saying why it
    is needed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "{} is set, and drawing the prediction overlays needs "
            "matplotlib, which is not installed".format(
                SAVE_PREDICTIONS_ENV)) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def savefig_mask_on_image(image: np.ndarray, mask: np.ndarray,
                          save_path: str, alpha: float = 0.5,
                          foreground_channel: Optional[int] = 1) -> None:
    """Overlay `mask`'s foreground on `image` and save to `save_path`."""
    plt = pyplot()
    image = np.asarray(image, np.float32)
    if image.max() > 1.0:
        image = image / 255.0
    mask = np.asarray(mask)
    if mask.ndim == 3 and foreground_channel is not None:
        mask = mask[..., foreground_channel]
    mask = np.round(mask).astype(bool)

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(np.clip(image, 0, 1))
    overlay = np.zeros(image.shape[:2] + (4,), np.float32)
    overlay[mask] = [1.0, 0.0, 0.0, alpha]
    ax.imshow(overlay)
    ax.axis("off")
    fig.savefig(save_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def predictions_dir() -> str:
    """The overlays' directory: "predictions/" as in the reference
    (reptile.py:512), or PREDICTIONS_DIR."""
    return os.environ.get("PREDICTIONS_DIR", "predictions")


def save_query_predictions(images, predictions, task_name: str,
                           out_dir: Optional[str] = None) -> None:
    """One overlay per query image (the reference's reptile.py:508-513
    layout)."""
    if out_dir is None:
        out_dir = predictions_dir()
    for i, (image, pred) in enumerate(zip(images, predictions)):
        save_path = os.path.join(
            out_dir, "prediction_{}_{}.jpeg".format(task_name or "", i))
        savefig_mask_on_image(np.asarray(image), np.asarray(pred), save_path)
