from .clips import ClipVisualizer, extract_frames, extract_frames_tree
from .plots import (hr_stats_table, per_clip_auc_table, plot_latent_sphere, plot_latents,
                    plot_person_scores, plot_roc, plot_scores, ubnormal_original_name)

__all__ = [
    "ClipVisualizer", "extract_frames", "extract_frames_tree", "plot_latents", "plot_roc",
    "plot_scores", "plot_latent_sphere", "plot_person_scores", "hr_stats_table",
    "per_clip_auc_table", "ubnormal_original_name",
]
