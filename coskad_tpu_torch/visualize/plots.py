"""Score, ROC and latent plots (counterpart of
`coskad_tpu/visualize/plots.py`: the reference's ROC PNGs,
utils/eval_utils.py:216-230, and the latent-sphere and per-person score
plots of its analysis notebook, visualize/visualize.ipynb), with the
tables of that notebook.

The plots need matplotlib, which each function imports when it is called
(the card's machine has none): importing this module needs numpy alone, and
the tables need nothing more."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..score.auc import roc_auc_score, roc_curve


def plot_roc(y_true: np.ndarray, y_score: np.ndarray, path: str = "") -> float:
    """ROC curve with the TPR = 1 - FPR crossing marked; saves a PNG when a
    path is given. Returns the AUC."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fpr, tpr, _ = roc_curve(y_true, y_score)
    auc = roc_auc_score(y_true, y_score)
    idx = np.argwhere(np.diff(np.sign(tpr - (1 - fpr)))).flatten()

    fig, ax = plt.subplots()
    ax.plot(fpr, tpr, label=f"AUC={auc:.4f}")
    ax.plot(fpr, 1 - fpr, "r:")
    ax.plot(fpr[idx], tpr[idx], "ro")
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.legend(loc=4)
    ax.grid(True)
    if path:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig.savefig(path)
    plt.close(fig)
    return auc


def plot_scores(
    scores: np.ndarray,
    gt: Optional[np.ndarray] = None,
    path: str = "",
    title: str = "anomaly score",
    per_actor: Optional[Dict[int, np.ndarray]] = None,
):
    """Per-frame anomaly score curve with ground-truth shading; optional
    per-actor curves underneath."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_rows = 1 + (1 if per_actor else 0)
    fig, axes = plt.subplots(n_rows, 1, figsize=(10, 3 * n_rows), squeeze=False)
    ax = axes[0][0]
    ax.plot(scores, color="tab:blue", linewidth=1)
    if gt is not None:
        ax.fill_between(
            np.arange(len(gt)), 0, np.max(scores) if len(scores) else 1,
            where=np.asarray(gt, bool), alpha=0.2, color="red",
            label="ground truth",
        )
        ax.legend()
    ax.set_title(title)
    ax.set_xlabel("frame")
    if per_actor:
        ax2 = axes[1][0]
        for actor, row in per_actor.items():
            ax2.plot(row, linewidth=0.8, label=f"actor {actor}")
        ax2.legend(fontsize=7)
        ax2.set_title("per-actor scores")
    fig.tight_layout()
    if path:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig.savefig(path)
    plt.close(fig)


def plot_latents(
    latents: np.ndarray,
    labels: Optional[np.ndarray] = None,
    center: Optional[np.ndarray] = None,
    path: str = "",
    three_d: bool = True,
    title: str = "latent space",
):
    """Latent-space scatter (3D when the geometry is spherical/3D-projected,
    else 2D), colored by anomaly labels, with the center marked — the
    latent-sphere plots of the reference's analysis notebook
    (visualize/visualize.ipynb). Dimensions above 3 are PCA-projected."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z = np.asarray(latents, np.float64)
    c = None if center is None else np.asarray(center, np.float64)
    d = min(3 if three_d else 2, z.shape[1])
    if z.shape[1] > d:
        mu = z.mean(0)
        zc = z - mu
        _, _, vt = np.linalg.svd(zc, full_matrices=False)
        z = zc @ vt[:d].T
        if c is not None:
            c = (c - mu) @ vt[:d].T
    colors = None
    if labels is not None:
        colors = np.where(np.asarray(labels) > 0, "crimson", "steelblue")

    fig = plt.figure(figsize=(6, 6))
    if d == 3:
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(z[:, 0], z[:, 1], z[:, 2], s=4, c=colors, alpha=0.6)
        if c is not None:
            ax.scatter([c[0]], [c[1]], [c[2]], s=120, marker="*", c="black",
                       label="center")
            ax.legend()
    else:
        ax = fig.add_subplot(111)
        ax.scatter(z[:, 0], z[:, 1], s=4, c=colors, alpha=0.6)
        if c is not None:
            ax.scatter([c[0]], [c[1]], s=120, marker="*", c="black", label="center")
            ax.legend()
    ax.set_title(title)
    if path:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig.savefig(path)
    plt.close(fig)


def plot_latent_sphere(
    latents: np.ndarray,
    center: Optional[np.ndarray] = None,
    radius: Optional[float] = None,
    path: str = "",
    titles=("Latent vectors", "Distribution of distances\nfrom the "
            "representative center"),
):
    """Latent-sphere figure of the reference's analysis notebook
    (visualize/visualize.ipynb `plot_3d_latent_space`): a translucent unit
    sphere with dashed wireframe around the (PCA-projected) latent vectors,
    the representative center marked, plus a histogram of the latent-to-
    center distances in the ORIGINAL (un-projected) space.

    Args:
        latents: [N, D] latent vectors (D >= 3; projected to 3D via PCA
            when D > 3 — the notebook assumes latent_dim == 3).
        center: [D] representative center; defaults to the origin (the
            notebook draws the spherical-VAE case where latents live on the
            unit sphere around 0).
        radius: sphere radius; defaults to the median latent norm about the
            center, which is 1.0 for normalized spherical latents.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z = np.asarray(latents, np.float64)
    c = np.zeros(z.shape[1]) if center is None else np.asarray(center, np.float64)
    dists = np.linalg.norm(z - c, axis=1)
    if radius is None:
        radius = float(np.median(dists)) or 1.0

    z3, c3 = z, c
    if z.shape[1] > 3:
        mu = z.mean(0)
        _, _, vt = np.linalg.svd(z - mu, full_matrices=False)
        z3 = (z - mu) @ vt[:3].T
        c3 = (c - mu) @ vt[:3].T

    fig = plt.figure(figsize=(12, 6))
    ax = fig.add_subplot(121, projection="3d")
    ax.view_init(30, 45)
    # sphere surface + coarse dashed wireframe (notebook: violet alpha .15
    # surface over an 80-point grid, gray dashed 10-point wireframe)
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, 80), np.linspace(0, np.pi, 80))
    xs = np.cos(u) * np.sin(v) * radius + c3[0]
    ys = np.sin(u) * np.sin(v) * radius + c3[1]
    zs = np.cos(v) * radius + c3[2]
    ax.plot_surface(xs, ys, zs, color="violet", alpha=0.15)
    uw, vw = np.meshgrid(np.linspace(0, 2 * np.pi, 10), np.linspace(0, np.pi, 10))
    ax.plot_wireframe(
        np.cos(uw) * np.sin(vw) * radius + c3[0],
        np.sin(uw) * np.sin(vw) * radius + c3[1],
        np.cos(vw) * radius + c3[2],
        color="gray", alpha=0.25, linewidth=1, linestyle="--",
    )
    ax.scatter(z3[:, 0], z3[:, 1], z3[:, 2], s=6, alpha=0.6, color="teal")
    ax.scatter([c3[0]], [c3[1]], [c3[2]], color="firebrick", s=50, zorder=0.99)
    ax.set_title(titles[0])

    ax2 = fig.add_subplot(122)
    ax2.hist(dists, bins=40, color="violet", edgecolor="purple", alpha=0.8)
    ax2.axvline(radius, color="firebrick", linestyle="--", label=f"r={radius:.3g}")
    ax2.set_xlabel("distance from center")
    ax2.legend()
    ax2.set_title(titles[1])
    fig.tight_layout()
    if path:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig.savefig(path)
    plt.close(fig)
    return dists


def plot_person_scores(
    error_per_person: np.ndarray,
    gt: Optional[np.ndarray] = None,
    path: str = "",
    smooth_sigma: float = 50.0,
    shift: int = 8 + (8 // 2) - 1,
    log_scale: bool = True,
):
    """Per-person anomaly-score curves over one clip with the smoothed
    max-aggregated clip score and the ground-truth band — the notebook's
    per-clip analysis plot (visualize/visualize.ipynb cell 'Visualize the
    anomaly scores of each person...'): every person's raw score, a dashed
    smoothed clip score (shift-then-gaussian, the notebook's
    `score_process`), the GT as a translucent band, log y-scale.

    Args:
        error_per_person: [P, F] per-person per-frame scores.
        gt: [F] 0/1 ground-truth mask (drawn as gt/10, as the notebook does).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..score.smoothing import gaussian_filter1d as _gauss

    e = np.asarray(error_per_person, np.float64)
    frames = np.arange(e.shape[1])
    clip = np.amax(e, axis=0)
    shifted = np.zeros_like(clip)
    if shift > 0:
        shifted[shift:] = clip[:-shift]
    else:
        shifted = clip
    clip_score = _gauss(shifted, smooth_sigma)

    fig = plt.figure(figsize=(20, 8))
    for i in range(e.shape[0]):
        plt.plot(frames, e[i], linewidth=2.5, label=f"Person {i + 1}")
    plt.plot(frames, clip_score, linewidth=3.5, linestyle="--",
             label="Smoothed clip score")
    if gt is not None:
        g = np.asarray(gt, np.float64)
        plt.fill_between(frames[: len(g)], g / 10, 0, color="tomato",
                         alpha=0.5, label="Ground-truth")
    if log_scale:
        plt.yscale("log")
    plt.xlabel("Frames")
    plt.ylabel(r"$\log$-distance" if log_scale else "distance")
    plt.legend(loc="upper left", ncol=2)
    if path:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        plt.savefig(path)
    plt.close(fig)
    return clip_score


_VERSION_SUFFIX = {"51": "fog", "52": "fire", "53": "smoke"}


def ubnormal_original_name(clip_name: str):
    """Map a compact UBnormal stats key like '107_020.mp4' back to the
    original clip name ('normal_scene_7_scenario_20') — the notebook's
    `translate_to_original_name` (visualize/visualize.ipynb, HR-UBnormal
    stats section). Returns (name, scene_id)."""
    scene_id, clip_id = clip_name.split(".")[0].split("_")
    name = "normal" if scene_id[0] == "1" else "abnormal"
    name += f"_scene_{int(scene_id[1:])}_scenario_{int(clip_id[:2])}"
    suffix = clip_id[2:]
    if scene_id[0] == "1":
        if int(suffix) != 0:
            name += f"_{_VERSION_SUFFIX.get(suffix, int(suffix))}"
    elif suffix in _VERSION_SUFFIX:
        name += f"_{_VERSION_SUFFIX[suffix]}"
    return name, int(scene_id[1:])


def hr_stats_table(stats: dict, fmt: str = "latex") -> str:
    """HR-UBnormal discarded-frames table from a stats.json dict — the
    notebook's LaTeX longtable (visualize/visualize.ipynb 'Generate LaTeX
    table for HR-UBnormal'): abnormal clips with discarded_frames > 0, with
    clip names translated back to the original UBnormal naming.

    stats: {clip_key: {'details': {'length':, 'discarded_frames':,
    'perc_discarded':, 'normal_frames':, 'anomalous_frames':,
    'perc_abnormality':}}} (global_stats rows are skipped).
    """
    rows = []
    for key, rec in stats.items():
        details = rec.get("details") if isinstance(rec, dict) else None
        if not isinstance(details, dict):
            continue  # global_stats rows
        try:
            name, _scene = ubnormal_original_name(key)
        except (ValueError, IndexError):
            name = key
        if "abnormal" not in name or details.get("discarded_frames", 0) <= 0:
            continue
        rows.append((
            name,
            details.get("length", ""),
            details.get("discarded_frames", ""),
            details.get("perc_discarded", ""),
            details.get("perc_abnormality", ""),
        ))
    rows.sort()
    headers = ["Clip", "Length", "Discarded", "% discarded", "% abnormality"]
    if fmt == "markdown":
        return "\n".join([
            "| " + " | ".join(headers) + " |",
            "|" + "---|" * len(headers),
            *("| " + " | ".join(str(v) for v in r) + " |" for r in rows),
        ])
    if fmt != "latex":
        raise ValueError(f"unknown fmt {fmt!r}")
    head = " & ".join(rf"\textbf{{{h}}}" for h in headers)
    body = [
        r"\verb|" + str(r[0]) + "| & "
        + " & ".join(str(v) for v in r[1:]) + r" \\"
        for r in rows
    ]
    return "\n".join([
        r"\begin{longtable}{l" + "r" * (len(headers) - 1) + "}",
        r"\toprule", head + r" \\", r"\midrule",
        *body,
        r"\bottomrule", r"\end{longtable}",
    ])


def per_clip_auc_table(
    per_clip_auc: dict, fmt: str = "markdown", sort_by: str = "auc"
) -> str:
    """Render {(scene, clip): auc} as a markdown or LaTeX table — the
    analysis the reference keeps in its notebook's HR-UBnormal stats cell
    (visualize/visualize.ipynb).

    Args:
        per_clip_auc: e.g. EvalResult.per_clip_auc from score.aggregate.
        fmt: 'markdown' or 'latex'.
        sort_by: 'auc' (ascending — worst clips first) or 'clip'.
    """
    items = sorted(
        per_clip_auc.items(),
        key=(lambda kv: kv[1]) if sort_by == "auc" else (lambda kv: kv[0]),
    )
    rows = [(f"{s}_{c}", f"{auc:.4f}") for (s, c), auc in items]
    if fmt == "latex":
        lines = [
            r"\begin{tabular}{lr}", r"\toprule",
            r"clip & AUC \\", r"\midrule",
            *[f"{name} & {auc} \\\\" for name, auc in rows],
            r"\bottomrule", r"\end{tabular}",
        ]
        return "\n".join(lines)
    if fmt != "markdown":
        raise ValueError(f"unknown fmt {fmt!r}")
    return "\n".join(["| clip | AUC |", "|---|---|",
                      *[f"| {name} | {auc} |" for name, auc in rows]])
