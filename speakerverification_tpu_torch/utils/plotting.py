"""Training and evaluation plots (port of ``utils/plotting.py``): curves
from ``scores.txt``, a confusion matrix, 3-D embeddings.

The reference's src/utils.py:281-438: accuracy, loss and validation
curves regenerated from the per-epoch text log, a confusion-matrix PNG
and the 3-D normalized-embedding sphere. Matplotlib is imported when a
plot is drawn (Agg backend, no display); without it a plot raises
``ImportError``. Nothing else in the port needs it.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["plot_graph", "parse_scores_file", "plot_from_scores",
           "plot_confusion_matrix", "plot_embeddings_3d"]


def _pyplot():
    try:
        import matplotlib
    except ImportError:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed here") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, plt, save_path) -> Path:
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_graph(data, x_label: str, y_label: str, title: str,
               save_path: str | Path, color: str = "b-", mono: bool = True,
               figsize=(10, 6)) -> Path:
    """A single- or multi-curve line plot (src/utils.py:281-313)."""
    plt = _pyplot()
    fig = plt.figure(figsize=figsize)
    if mono:
        plt.plot(data, color)
    else:
        for dt in data:
            plt.plot(dt)
    plt.xlabel(x_label)
    plt.ylabel(y_label)
    plt.title(title)
    return _save(fig, plt, save_path)


_LINE = re.compile(
    r"epoch\s+(\d+),\s*LR\s+([\d.eE+-]+),\s*TEER/TAcc\s+([\d.eE+-]+),"
    r"\s*TLOSS\s+([\d.eE+-]+)(?:,\s*VEER\s+([\d.eE+-]+))?")


def parse_scores_file(path: str | Path) -> dict:
    """The per-epoch columns of a trainer's ``scores.txt``."""
    epochs, lrs, accs, losses, veers = [], [], [], [], []
    for line in Path(path).read_text().splitlines():
        m = _LINE.search(line)
        if not m:
            continue
        epochs.append(int(m.group(1)))
        lrs.append(float(m.group(2)))
        accs.append(float(m.group(3)))
        losses.append(float(m.group(4)))
        if m.group(5) is not None:
            veers.append(float(m.group(5)))
    return {"epoch": epochs, "lr": lrs, "acc": accs, "loss": losses,
            "veer": veers}


def plot_from_scores(result_dir: str | Path) -> list:
    """Regenerate the loss, accuracy and VEER curves from ``scores.txt``
    (src/utils.py:349-413 plot_from_file)."""
    result_dir = Path(result_dir)
    data = parse_scores_file(result_dir / "scores.txt")
    out = []
    if data["loss"]:
        out.append(plot_graph(data["loss"], "epoch", "loss",
                              "Training loss", result_dir / "loss.png"))
        out.append(plot_graph(data["acc"], "epoch", "accuracy",
                              "Training accuracy", result_dir / "acc.png",
                              color="g-"))
    if data["veer"]:
        out.append(plot_graph(data["veer"], "eval", "EER %",
                              "Validation EER", result_dir / "val_eer.png",
                              color="r-"))
    return out


def plot_confusion_matrix(y_true: Sequence[int], y_pred: Sequence[int],
                          save_path: str | Path,
                          labels: Optional[Sequence[str]] = None) -> Path:
    """A confusion-matrix heatmap PNG (src/utils.py:416-438)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    classes = sorted(set(y_true.tolist()) | set(y_pred.tolist()))
    idx = {c: i for i, c in enumerate(classes)}
    cm = np.zeros((len(classes), len(classes)), int)
    for t, p in zip(y_true, y_pred):
        cm[idx[t], idx[p]] += 1

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(cm, cmap="Blues")
    names = labels if labels is not None else [str(c) for c in classes]
    ax.set_xticks(range(len(classes)), names, rotation=45)
    ax.set_yticks(range(len(classes)), names)
    for i in range(len(classes)):
        for j in range(len(classes)):
            ax.text(j, i, cm[i, j], ha="center", va="center",
                    color="white" if cm[i, j] > cm.max() / 2 else "black")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.colorbar(im)
    return _save(fig, plt, save_path)


def plot_embeddings_3d(embeddings: np.ndarray, labels: Sequence[int],
                       save_path: str | Path) -> Path:
    """A 3-D unit-sphere scatter of the (PCA-reduced) normalized
    embeddings (src/utils.py:316-346)."""
    emb = np.asarray(embeddings)
    emb = emb / np.clip(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12,
                        None)
    if emb.shape[1] > 3:
        emb = emb - emb.mean(0)
        _, _, vt = np.linalg.svd(emb, full_matrices=False)
        emb = emb @ vt[:3].T
        emb = emb / np.clip(np.linalg.norm(emb, axis=1, keepdims=True),
                            1e-12, None)
    plt = _pyplot()
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    labels = np.asarray(labels)
    for lab in sorted(set(labels.tolist())):
        pts = emb[labels == lab]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], label=str(lab), s=12)
    ax.legend(loc="upper right", fontsize=7)
    return _save(fig, plt, save_path)
