"""The scoring subset of the Trainer (counterpart of `coskad_tpu/train/loop.py`).

Windows are uploaded once, flat [N, C*T*V], to the device. A scoring pass
walks wrap-padded [K, B] index chunks in an eager Python loop: per chunk,
gather the batch (sample i % N, transform i // N), run the eval forward
(on CUDA, the fused encoder kernel) and the variant's window score. Results
stay on the device until one copy to the host at the end.

Ported: `embed_all`, `score_all`, `initialize_center`, `validate`. Training
(`init_state`'s optimizer, the train step and epoch, `fit`) comes with the
training slice (ROADMAP.md, Queue 1 item 2).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..data.transforms import canonical_transforms, gather_batch
from ..data.windows import SegmentDataset
from ..device import resolve_device
from ..models import build_model
from ..score.aggregate import EvalResult, ScoringConfig, evaluate_windows
from ..score.masks import AVENUE_MASKED_CLIPS
from . import objectives
from .state import TrainState, clamp_center, init_state


def model_kwargs_from_config(cfg: Config) -> dict:
    if cfg.run.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {cfg.run.compute_dtype!r} is not ported yet "
            "(ROADMAP.md, Queue 1 item 5)")
    return dict(
        use_decoder=cfg.model.use_decoder,
        use_vae=cfg.model.use_vae,
        input_dim=cfg.model.num_coords,
        layer_channels=tuple(cfg.model.channels),
        hidden_dimension=cfg.model.h_dim,
        latent_dim=cfg.model.latent_dim,
        n_frames=cfg.data.seg_len,
        n_joints=cfg.data.n_joints,
        encoder_type=cfg.model.encoder_type,
        projector=cfg.model.projector,
        projector_hidden_layers=cfg.model.projector_hidden_layers,
        dropout=cfg.model.dropout,
    )


class Trainer:
    """Scoring for one config.

    Args:
        cfg: full configuration.
        train_ds: training SegmentDataset (resident once on the device).
        val_ds: optional SegmentDataset for validation AUC.
        ground_truths: {(scene, clip): labels} for validation scoring.
        device: 'cuda' (default; raises if CUDA is missing) or 'cpu'.

    The model is built with weights drawn from `cfg.run.seed`; load trained
    weights into `trainer.model` (e.g. `interop.load_jax_variables`).
    """

    def __init__(
        self,
        cfg: Config,
        train_ds: SegmentDataset,
        val_ds: Optional[SegmentDataset] = None,
        ground_truths: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(**model_kwargs_from_config(cfg))
        self.model.reset_parameters(torch.Generator().manual_seed(cfg.run.seed))
        self.model = self.model.to(self.device).eval()
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.ground_truths = ground_truths or {}
        self.trans_table = torch.as_tensor(
            canonical_transforms(max(cfg.data.num_transform, 1)), device=self.device)
        self.batch_size = cfg.data.batch_size
        # The transform table has cfg.data.num_transform rows while the index
        # stream spans len(ds) = N * ds.num_transform: refuse a mismatch
        # rather than gather a wrong matrix. num_transform=1 (raw serving
        # windows) stays valid: every transform index is 0, the identity.
        for name, ds in (("train", train_ds), ("validation", val_ds)):
            k = getattr(ds, "num_transform", None)
            if ds is not None and k not in (None, 1, cfg.data.num_transform):
                raise ValueError(
                    f"{name} dataset carries num_transform={k} but the config "
                    f"says {cfg.data.num_transform}; rebuild the dataset with "
                    "the config's transform count")
        self.train_data = self._device_data(train_ds)
        self.val_data = self._device_data(val_ds) if val_ds is not None else None

    def init_state(self) -> TrainState:
        """A fresh state: zero center, identity inverse covariance. The
        weights are the model's (drawn from cfg.run.seed at construction)."""
        return init_state(self.cfg.model.latent_dim, self.device)

    def _device_data(self, ds: SegmentDataset) -> torch.Tensor:
        """Windows flat [N, C*T*V] on the device; `_gather` reshapes."""
        n = ds.data.shape[0]
        return torch.as_tensor(
            np.ascontiguousarray(ds.data.reshape(n, -1), np.float32), device=self.device)

    @staticmethod
    def _window_shape_of(ds):
        data = getattr(ds, "data", None)
        return None if data is None else tuple(data.shape[1:])

    def _gather(self, data: torch.Tensor, indices: torch.Tensor, window_shape=None):
        ws = tuple(window_shape or self.train_ds.data.shape[1:])
        if data.dim() == 2 and data.shape[1] != int(np.prod(ws)):
            raise ValueError(
                f"flat window data has {data.shape[1]} features but window_shape "
                f"{ws} expects {int(np.prod(ws))}; pass the owning dataset's window "
                "shape to _gather/embed_all/score_all")
        return gather_batch(data, indices, self.trans_table, self.cfg.model.num_coords,
                            window_shape=ws)

    def _chunked_indices(self, n: int) -> Tuple[torch.Tensor, int]:
        """[K, B] index chunks with the tail wrap-padded (index i % n), and
        K. A pass smaller than one batch runs as one chunk of n rows: eval
        rows are independent, so nothing needs the padding."""
        if n < 1:
            raise ValueError("nothing to score: the dataset has no windows")
        bs = min(self.batch_size, n)
        k = (n + bs - 1) // bs
        idx = torch.remainder(torch.arange(k * bs, device=self.device), n)
        return idx.reshape(k, bs), k

    def _embed_step(self, data, indices, window_shape=None) -> torch.Tensor:
        """Eval-mode latents for one batch of logical indices."""
        return self.model(self._gather(data, indices, window_shape=window_shape))

    @torch.inference_mode()
    def embed_all(self, state: TrainState, ds: SegmentDataset, data: torch.Tensor,
                  return_rec: bool = False):
        """Latents for every (window x transform) item, as numpy [n, D]
        (and zero reconstruction errors [n] for encoder-only variants)."""
        n = len(ds)
        idx, k = self._chunked_indices(n)
        ws = self._window_shape_of(ds)
        z = torch.cat([self._embed_step(data, idx[i], ws) for i in range(k)])[:n]
        z = z.cpu().numpy()
        if return_rec:
            return z, np.zeros(n, np.float32)
        return z

    @torch.inference_mode()
    def score_all(self, state: TrainState, ds: SegmentDataset, data: torch.Tensor):
        """Anomaly scores for every (window x transform) item: ([n] scores,
        [n] reconstruction errors, zeros for encoder-only variants) as numpy."""
        n = len(ds)
        idx, k = self._chunked_indices(n)
        ws = self._window_shape_of(ds)
        scores = torch.cat([
            objectives.window_scores(self.cfg, self._embed_step(data, idx[i], ws),
                                     state.center, state.inv_cov, state.mean_vector)
            for i in range(k)
        ])[:n]
        return scores.cpu().numpy(), np.zeros(n, np.float32)

    def initialize_center(self, state: TrainState) -> TrainState:
        """Full eval-mode pass over the train set: center = clamp(mean(z)),
        the mean taken in float64; Mahalanobis also inverts the latent
        covariance around it."""
        if self.cfg.model.variant not in ("euclidean_static", "euclidean_dynamic"):
            raise NotImplementedError(
                f"{self.cfg.model.variant} centers are not ported yet "
                "(ROADMAP.md, Queue 1 item 5)")
        z = self.embed_all(state, self.train_ds, self.train_data)
        c = torch.as_tensor(z.mean(axis=0, dtype=np.float64), dtype=torch.float32)
        c = clamp_center(c, self.cfg.opt.center_tolerance)
        state = state.replace(center=c.to(self.device))
        if self.cfg.model.distance == "mahalanobis":
            d = z - c.numpy()
            cov = self._shrink_cov((d.T @ d) / (len(z) - 1))
            state = state.replace(inv_cov=torch.as_tensor(
                np.linalg.inv(cov), dtype=torch.float32, device=self.device))
        return state

    def _shrink_cov(self, cov: np.ndarray) -> np.ndarray:
        """Optional shrinkage toward mu*I (mu = trace/d) before inverting;
        opt.cov_shrinkage = 0 (default) keeps the raw covariance."""
        lam = self.cfg.opt.cov_shrinkage
        if lam <= 0.0:
            return cov
        d = cov.shape[-1]
        return (1.0 - lam) * cov + lam * (np.trace(cov) / d) * np.eye(d, dtype=cov.dtype)

    def validate(self, state: TrainState) -> Optional[EvalResult]:
        """Frame-level AUC of the validation set under the current center."""
        if self.val_ds is None or not self.ground_truths:
            return None
        scores, _ = self.score_all(state, self.val_ds, self.val_data)
        k = max(self.cfg.data.num_transform, 1)
        avenue_masks = (
            AVENUE_MASKED_CLIPS if self.cfg.data.dataset_choice == "HR-Avenue" else {})
        # Metadata is identical across the k transforms (scores are
        # transform-major), so pass the base arrays once.
        return evaluate_windows(
            scores, None, self.val_ds.meta, self.val_ds.frame_ids, self.ground_truths,
            ScoringConfig(num_transform=k, pad_size=self.cfg.eval.pad_size),
            avenue_clip_masks=avenue_masks,
        )
