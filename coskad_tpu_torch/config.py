"""Typed configuration tree of the port.

A copy of the dataclasses in `coskad_tpu/config.py` (same fields, same
defaults), so a config written by either package reads in the other.
Configs come from code, from the JSON snapshot a checkpoint carries
(`config_from_snapshot`), or from a reference-format config file
(`from_reference_yaml`, the reference's flat key names mapped onto the
tree). That loader needs pyyaml for YAML; a config written as JSON loads
without it.
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
    # Fused ghost-BN train kernels K2-K4 ('auto' | 'on' | 'off'):
    # kernels/stse_train.py.
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


def _variant_from_flags(raw: Dict[str, Any]) -> str:
    """The reference's train dispatch order: decoder > vae > hyperbolic >
    center."""
    if raw.get("use_decoder"):
        return "autoencoder"
    if raw.get("use_vae"):
        return "vae"
    if raw.get("hyperbolic"):
        return "hyperbolic"
    return "euclidean_static" if raw.get("static_center", True) else "euclidean_dynamic"


def from_reference_yaml(path: str) -> Config:
    """Load a reference-format config file (config/*/*.yaml) into a Config
    tree. A file that parses as JSON is read as JSON, which needs no pyyaml
    and reads a dotless exponent (1e-06) as the number PyYAML would leave a
    string; any other file is YAML and needs pyyaml."""
    with open(path) as f:
        text = f.read()
    try:
        return from_reference_dict(json.loads(text))
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError:
        raise ImportError(f"{path} is not JSON, and reading YAML needs pyyaml, which is not "
                          "installed: install pyyaml or write the config as JSON") from None
    return from_reference_dict(yaml.safe_load(text))


def from_reference_dict(raw: Dict[str, Any]) -> Config:
    """The reference's flat config keys -> a Config tree."""

    def get(key, default):
        v = raw.get(key, default)
        return default if v is None else v

    model = ModelConfig(
        variant=_variant_from_flags(raw),
        num_coords=get("num_coords", 2),
        channels=tuple(get("channels", [32, 16, 32])),
        h_dim=get("h_dim", 64),
        latent_dim=get("latent_dim", 16),
        dropout=get("dropout", 0.0),
        projector=str(get("projector", "linear")).lower(),
        encoder_type=str(get("encoder_type", "sts_gcn")).lower(),
        bn_mode=str(get("bn_mode", "auto")).lower(),
        distance=str(get("distance", "euclidean")).lower(),
        distribution=str(get("distribution", "ps")).lower(),
        kappa_floor=float(get("kappa_floor", 1.0)),
        decoder_channels=(
            tuple(raw["decoder_channels"]) if raw.get("decoder_channels") else None),
    )
    # 'poincare' appears as a distance string in hyperbolic configs; the
    # variant flag is authoritative there.
    if model.distance not in ("euclidean", "mahalanobis"):
        model = dataclasses.replace(model, distance="euclidean")

    data_dir = get("data_dir", "")
    pose_dirs = {}
    gt_dir = get("gt_path", get("test_path", ""))
    val_gt_dir = gt_dir
    if data_dir:
        # Offline-eval ground truth is test_path. With validation on, the
        # in-training ground truth is 'validating/test_frame_mask' for every
        # dataset, while the validation pose split is 'validating' for
        # UBnormal and the test split otherwise. A custom layout (derived
        # directory missing) keeps its explicit gt_path for validation too.
        pose_dirs = {
            "train": os.path.join(data_dir, "pose", "training"),
            "test": os.path.join(data_dir, "pose", "testing"),
            "validation": os.path.join(data_dir, "pose", "validating"),
        }
        if get("validation", False):
            if get("dataset_choice", "UBnormal") != "UBnormal":
                pose_dirs["validation"] = pose_dirs["test"]
            derived = os.path.join(data_dir, "validating", "test_frame_mask")
            if os.path.isdir(derived) or not val_gt_dir:
                val_gt_dir = derived
    data = DataConfig(
        dataset_choice=get("dataset_choice", "UBnormal"),
        pose_dirs=pose_dirs,
        path_to_robust=get("dataset_path_to_robust", ""),
        gt_dir=gt_dir,
        val_gt_dir=val_gt_dir,
        seg_len=get("dataset_seg_len", 12),
        seg_stride=get("dataset_seg_stride", 8),
        start_offset=get("dataset_start_offset", 0),
        num_transform=get("dataset_num_transform", 5),
        normalization_strategy=get("dataset_normalization_strategy", "markovitz"),
        vid_res=tuple(get("dataset_vid_res", [856, 480])),
        symm_range=get("dataset_symm_range", True),
        sub_mean=get("dataset_sub_mean", True),
        kp18_format=get("dataset_kp18_format", True),
        headless=get("dataset_headless", False),
        normalize_pose=get("dataset_normalize_pose", True),
        kp_threshold=get("dataset_kp_th", 0.0),
        batch_size=get("dataset_batch_size", 512),
        num_clips=5 if get("debug", False) else None,
        use_fitted_scaler=get("dataset_use_fitted_scaler", False),
    )
    # ReduceLROnPlateau patience differs per variant in the reference:
    # static and hyperbolic 100; dynamic, autoencoder and VAE 2.
    patience = 100 if model.variant in ("euclidean_static", "hyperbolic") else 2
    opt = OptConfig(
        plateau_patience=patience,
        lr=get("opt_lr", 1e-4),
        epochs=10 if get("debug", False) else get("ae_epochs", 100),  # debug caps at 10
        alpha=get("alpha", 1e-6),
        lambda_=get("lambda_", 0.01),
        phi=get("phi", 1.0),
        beta=get("beta", 0.001),
        gamma=get("gamma", 0.01),
        # `warmup_epochs` and `opt_scheduler` are accepted and dropped: the
        # reference reads neither on a live path.
        lr_schedule=get("lr_schedule", ""),
        lr_decay=get("opt_lr_decay", 0.99),
        center_tolerance=get("center_tolerance", 0.001),
        cov_shrinkage=get("cov_shrinkage", 0.0),
        vae_contraction=get("vae_contraction", 0.0),
        contrastive_weight=get("contrastive_weight",
                               0.1 if get("dataset_double_item", False) else 0.0),
        validation=get("validation", False),
    )
    # HR-UBnormal boolean masks: '<data_dir>/hr_bool_masks/<split>/
    # test_frame_mask/*' unless a glob is given.
    hr_glob = get("hr_masks_glob", "")
    if not hr_glob and get("use_hr", False) and data_dir:
        hr_split = "testing" if "test" in get("split", "train") else "validating"
        hr_glob = os.path.join(data_dir, "hr_bool_masks", hr_split, "test_frame_mask", "*")
    ev = EvalConfig(
        pad_size=get("pad_size", -1),
        smoothing=get("smoothing", 50),
        split=get("split", "train"),
        use_hr=get("use_hr", False),
        hr_masks_glob=hr_glob,
        load_ckpt=get("load_ckpt", ""),
        vae_sample=bool(get("vae_sample", True)),
    )
    run = RunConfig(
        seed=get("seed", 999),
        exp_dir=get("exp_dir", "./checkpoints"),
        dir_name=get("dir_name", "default"),
        debug=get("debug", False),
        compute_dtype=get("compute_dtype", "float32"),
        freeze_bn_after=get("freeze_bn_after", -1),
        data_parallel=get("data_parallel", -1),
        model_parallel=get("model_parallel", 1),
        device_pipeline=get("device_pipeline", False),
        fused_train=get("fused_train", "off"),
        ghost_size=get("ghost_size", 64),
    )
    return Config(model=model, data=data, opt=opt, eval=ev, run=run)
