"""Headless mesh drawing (counterpart of ``surfacenetworks_tpu/viz.py``, a
copy of its functions): each writes a PNG or GIF file with matplotlib's Agg
backend, numpy arrays in.

* :func:`render_mesh`: one shaded triangle mesh, an optional per-vertex
  scalar coloured through viridis.
* :func:`render_comparison`: input, prediction and ground truth side by
  side, red, blue and green.
* :func:`animate_sequence`: a vertex-position sequence (optionally beside
  its prediction) as an animated GIF (ARAP ``--dump-rollout``).
* :func:`quiver_operator`: an operator applied to the coordinates as a
  vertex quiver over the mesh.
* :func:`plot_curves`: the per-epoch metrics file of a run as one subplot
  per metric, train and test overlaid (``MetricsLogger.plot``).

matplotlib is imported inside the functions only: importing the port never
needs it, and the machine with the card has none.
"""

from __future__ import annotations

import numpy as np


def _axes3d(fig, idx=111):
    ax = fig.add_subplot(idx, projection="3d")
    ax.set_axis_off()
    return ax


def _plot_mesh(ax, V, F, color=None, face_color="#cccccc", edge_color="none", alpha=1.0):
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    tris = np.asarray(V)[np.asarray(F)]
    pc = Poly3DCollection(tris, alpha=alpha)
    if color is not None:
        import matplotlib.cm as cm
        import matplotlib.colors as mcolors

        vals = np.asarray(color, dtype=np.float64)
        face_vals = vals[np.asarray(F)].mean(axis=1)
        norm = mcolors.Normalize(vmin=face_vals.min(), vmax=face_vals.max() + 1e-12)
        pc.set_facecolor(cm.viridis(norm(face_vals)))
    else:
        pc.set_facecolor(face_color)
    pc.set_edgecolor(edge_color)
    ax.add_collection3d(pc)
    lo, hi = np.asarray(V).min(axis=0), np.asarray(V).max(axis=0)
    c, r = (lo + hi) / 2.0, max(float((hi - lo).max()) / 2.0, 1e-9)
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)


def render_mesh(V, F, path: str, color=None, title: str | None = None, dpi: int = 80):
    """Render one mesh to a PNG file; ``color`` is an optional per-vertex
    scalar mapped through viridis."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(4, 4))
    ax = _axes3d(fig)
    _plot_mesh(ax, V, F, color=color)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


def render_comparison(V_in, V_pred, V_gt, F, path: str, dpi: int = 80):
    """Input (red) / prediction (blue) / ground truth (green) side by side."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 3.2))
    for i, (V, name, col) in enumerate(
        [(V_in, "input", "#cc4444"), (V_pred, "predicted", "#4444cc"), (V_gt, "ground truth", "#44aa44")]
    ):
        ax = _axes3d(fig, 131 + i)
        _plot_mesh(ax, V, F, face_color=col, alpha=0.9)
        ax.set_title(name, fontsize=9)
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


def animate_sequence(frames, F, path: str, pred_frames=None, fps: int = 8, dpi: int = 60):
    """Animate a vertex-position sequence (optionally alongside its
    predictions, ``pred_frames``) into a GIF, one frame per position."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as manim
    import matplotlib.pyplot as plt

    frames = [np.asarray(f) for f in frames]
    two = pred_frames is not None
    fig = plt.figure(figsize=(6 if two else 3.2, 3.2))

    def draw(i):
        fig.clf()
        ax = _axes3d(fig, 121 if two else 111)
        _plot_mesh(ax, frames[i], F, face_color="#44aa44")
        ax.set_title(f"gt {i}", fontsize=8)
        if two:
            ax2 = _axes3d(fig, 122)
            _plot_mesh(ax2, np.asarray(pred_frames[i]), F, face_color="#4444cc")
            ax2.set_title(f"pred {i}", fontsize=8)

    anim = manim.FuncAnimation(fig, draw, frames=len(frames))
    anim.save(path, writer=manim.PillowWriter(fps=fps), dpi=dpi)
    plt.close(fig)
    return path


def quiver_operator(V, F, operator_applied, path: str, dpi: int = 80, scale: float = 0.1):
    """Vertex quiver of an operator applied to coordinates (``L V`` or the
    vector part of ``Di V``) over the mesh."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    D = np.asarray(operator_applied, dtype=np.float64)
    fig = plt.figure(figsize=(4.5, 4.5))
    ax = _axes3d(fig)
    _plot_mesh(ax, V, F, alpha=0.3)
    V = np.asarray(V)
    ax.quiver(
        V[:, 0], V[:, 1], V[:, 2], D[:, 0], D[:, 1], D[:, 2],
        length=scale, normalize=False, color="#bb3333", linewidth=0.7,
    )
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


def plot_curves(jsonl_path: str, png_path: str | None = None, dpi: int = 90) -> str | None:
    """Render training curves from a per-epoch metrics JSONL file: the
    trainers append one ``{"epoch": E, "split": "train"|"test", <metric>:
    value}`` line per epoch (``cli.common.MetricsLogger``); this renders one
    subplot per metric with the train and test series overlaid, to
    ``png_path`` (default ``<prefix>_curves.png`` beside the file).  Returns
    the PNG path (None if the file is missing or holds no metric)."""
    import json
    import os

    if not os.path.exists(jsonl_path):
        return None
    records = []
    with open(jsonl_path) as fp:
        for line in fp:
            line = line.strip()
            if line:
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    if not records:
        return None
    metrics = sorted(
        {
            k
            for r in records
            for k, v in r.items()
            if k not in ("epoch", "split", "time") and isinstance(v, (int, float))
        }
    )
    if not metrics:
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    png_path = png_path or jsonl_path.rsplit(".metrics.jsonl", 1)[0] + "_curves.png"
    fig, axes = plt.subplots(1, len(metrics), figsize=(4.5 * len(metrics), 3.4), squeeze=False)
    for ax, metric in zip(axes[0], metrics):
        for split in sorted({r.get("split", "train") for r in records}):
            pts = [
                (r["epoch"], r[metric])
                for r in records
                if r.get("split", "train") == split and isinstance(r.get(metric), (int, float))
            ]
            if pts:
                xs, ys = zip(*sorted(pts))
                ax.plot(xs, ys, marker=".", markersize=3, linewidth=1.2, label=split)
        ax.set_xlabel("epoch")
        ax.set_title(metric)
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(png_path, dpi=dpi)
    plt.close(fig)
    return png_path
