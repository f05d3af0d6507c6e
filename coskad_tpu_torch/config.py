"""Typed configuration tree of the port.

A copy of the dataclasses in `coskad_tpu/config.py` (same fields, same
defaults), so a config written by either package reads in the other. The
reference-format YAML loader is left out here (it needs pyyaml); configs
come from code or from the JSON snapshot a checkpoint carries
(`config_from_snapshot`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

VARIANTS = (
    "euclidean_static",
    "euclidean_dynamic",
    "autoencoder",
    "vae",
    "hyperbolic",
)


@dataclass
class ModelConfig:
    variant: str = "euclidean_static"
    num_coords: int = 2
    channels: Tuple[int, ...] = (32, 16, 32)
    h_dim: int = 64
    latent_dim: int = 16
    dropout: float = 0.0
    projector: str = "linear"  # 'linear' | 'mlp'
    projector_hidden_layers: Optional[Tuple[int, ...]] = None
    encoder_type: str = "sts_gcn"  # 'sts_gcn' | 'st_gcn' | 'learnable_gcn' | 'static_gcn'
    # BatchNorm implementation of the JAX package ('auto' | 'moment' |
    # 'flax'), identical math in every mode. The port's eval path always
    # folds BN from running statistics.
    bn_mode: str = "auto"
    distance: str = "euclidean"  # 'euclidean' | 'mahalanobis'
    distribution: str = "ps"  # VAE: 'ps' | 'normal'
    decoder_channels: Optional[Tuple[int, ...]] = None
    # VAE ('ps') concentration floor: z_var = softplus(head) + kappa_floor;
    # 1.0 is the reference semantics.
    kappa_floor: float = 1.0

    @property
    def use_decoder(self) -> bool:
        return self.variant in ("autoencoder", "vae")

    @property
    def use_vae(self) -> bool:
        return self.variant == "vae"

    @property
    def hyperbolic(self) -> bool:
        return self.variant == "hyperbolic"


@dataclass
class DataConfig:
    dataset_choice: str = "UBnormal"
    # {'train': dir, 'test': dir} of AlphaPose JSONs (or Morais CSV root for
    # the robust pipeline)
    pose_dirs: Dict[str, str] = field(default_factory=dict)
    path_to_robust: str = ""  # Morais CSV root (normalization_strategy='robust')
    gt_dir: str = ""  # offline-eval ground truth masks (= reference test_path)
    val_gt_dir: str = ""  # in-training validation masks (may differ, see loader)
    seg_len: int = 12
    seg_stride: int = 8
    start_offset: int = 0
    num_transform: int = 5
    normalization_strategy: str = "markovitz"
    vid_res: Tuple[int, int] = (856, 480)
    symm_range: bool = True
    sub_mean: bool = True
    kp18_format: bool = True
    headless: bool = False
    normalize_pose: bool = True
    kp_threshold: float = 0.0
    batch_size: int = 512
    num_clips: Optional[int] = None  # debug limit (reference: 5 clips)
    use_fitted_scaler: bool = False
    n_joints_override: Optional[int] = None  # tests / nonstandard skeletons

    @property
    def n_joints(self) -> int:
        if self.n_joints_override is not None:
            return self.n_joints_override
        if self.headless:
            return 14
        return 18 if self.kp18_format else 17


@dataclass
class OptConfig:
    lr: float = 1e-4
    epochs: int = 100
    alpha: float = 1e-6  # weight-regularization weight
    lambda_: float = 0.01  # autoencoder reconstruction weight
    phi: float = 1.0  # VAE reconstruction weight
    beta: float = 0.001  # VAE KL weight
    gamma: float = 0.01  # VAE expected-distance weight
    # LR schedule: '' | 'tri' | 'step' | 'exp' | 'cosine'. '' is constant lr
    # plus ReduceLROnPlateau when validation is on.
    lr_schedule: str = ""
    lr_decay: float = 0.99  # decay for lr_schedule='exp' (reference opt_lr_decay)
    center_tolerance: float = 0.001
    validation: bool = False
    # Contrastive auxiliary loss on a second augmented view. 0 disables.
    contrastive_weight: float = 0.0
    contrastive_tau: float = 0.2
    contrastive_hyp_c: float = 0.0  # 0 = cosine logits; >0 hyperbolic
    # ReduceLROnPlateau settings used when validation is on
    plateau_factor: float = 0.2
    plateau_patience: int = 100
    min_lr: float = 1e-6
    # VAE stabilizer, off by default (reference ELBO): weight of
    # w * E[1 - cos(mu(x), mean_vector)].
    vae_contraction: float = 0.0
    # Mahalanobis inverse-covariance shrinkage, off by default (reference
    # semantics invert the raw sample covariance): cov_shrinkage=l blends
    # (1-l)*cov + l*mu*I with mu = trace(cov)/d before inverting.
    cov_shrinkage: float = 0.0


@dataclass
class EvalConfig:
    pad_size: int = -1
    smoothing: int = 50  # kept for config parity; the shift+sigma=30 path ignores it
    split: str = "test"
    use_hr: bool = False
    hr_masks_glob: str = ""
    load_ckpt: str = ""
    # VAE scoring: True draws one PowerSpherical sample per window like the
    # reference; False scores the posterior mean.
    vae_sample: bool = True


@dataclass
class RunConfig:
    seed: int = 999
    exp_dir: str = "./checkpoints"
    dir_name: str = "default"
    debug: bool = False
    validate_every: int = 1
    # Parallelism of the JAX package: data axis size -1 means all devices.
    data_parallel: int = -1
    model_parallel: int = 1
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # Train with running BN statistics from this epoch on (-1 disables); a
    # deviation from the reference, off by default.
    freeze_bn_after: int = -1
    # Fused on-device preprocessing of whole trajectories (JAX package's
    # data/device_pipeline.py; not ported yet).
    device_pipeline: bool = False
    # Fused ghost-BN train kernels ('auto' | 'on' | 'off'); they come with
    # the training slice.
    fused_train: str = "off"
    # Ghost-BN block size (samples per BatchNorm statistics block).
    ghost_size: int = 64


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    opt: OptConfig = field(default_factory=OptConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    run: RunConfig = field(default_factory=RunConfig)

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.run.exp_dir, self.data.dataset_choice, self.run.dir_name)


def config_from_snapshot(path: str) -> Config:
    """Rebuild a Config from the '<ckpt>.config.json' snapshot written beside
    every checkpoint. Unknown keys are ignored; lists become tuples."""
    with open(path) as f:
        raw = json.load(f)

    def build(cls, section):
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in section.items():
            if k not in fields:
                continue
            kwargs[k] = tuple(v) if isinstance(v, list) else v
        return cls(**kwargs)

    return Config(
        model=build(ModelConfig, raw["model"]),
        data=build(DataConfig, raw["data"]),
        opt=build(OptConfig, raw["opt"]),
        eval=build(EvalConfig, raw["eval"]),
        run=build(RunConfig, raw["run"]),
    )
