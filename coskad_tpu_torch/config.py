"""Typed configuration tree of the port.

A copy of the dataclasses in `coskad_tpu/config.py` (same fields, same
defaults), so a config written by either package reads in the other.
Configs come from code, from the JSON snapshot a checkpoint carries
(`config_from_snapshot`), or from a reference-format config file
(`from_reference_yaml`, the reference's flat key names mapped onto the
tree). The loader needs no pyyaml: a YAML file is read by
`parse_reference_yaml`, which reads the subset the shipped files use to
the dict `yaml.safe_load` gives and refuses, naming the line, anything
else; a config written as JSON is read with `json`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
    # Whole trajectories resident on the device, each batch's windows
    # gathered and normalized there (data/device_pipeline.py; the AlphaPose
    # path of cli.train / cli.eval).
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


# PyYAML's implicit resolvers (YAML 1.1), which safe_load applies to a plain
# scalar. The subset read here takes null, bool, decimal int and decimal
# float; a scalar that resolves to another type (octal, hex, binary or
# sexagesimal ints, underscores, timestamps, merge and value keys) is refused.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")
_INT_ANY = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                      r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT_ANY = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                        r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                        r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                        r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP = re.compile(r"^(?:[0-9]{4}-[0-9]{2}-[0-9]{2}"
                        r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}"
                        r":[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_KEY_LINE = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?:[ ](.*))?$")
_COMMENT = re.compile(r"(?:^|[ ])#")
_INDICATORS = set("[]{},#&*!|>'\"%@`")


class YamlSubsetError(ValueError):
    """A reference config line outside the YAML subset `parse_reference_yaml`
    reads."""


def _plain_scalar(v: str, where: str, in_list: bool = False) -> Any:
    """A plain scalar resolved as PyYAML's safe_load resolves it, or a
    refusal for what the subset does not read."""
    if _NULL.match(v):
        return None
    if _BOOL.match(v):
        return v in _TRUE
    if _INT.match(v):
        return int(v)
    if _FLOAT.match(v):
        low = v.lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        return float("nan") if low.endswith("nan") else float(v)
    if (_INT_ANY.match(v) or _FLOAT_ANY.match(v) or _TIMESTAMP.match(v)
            or v in ("<<", "=")):
        raise YamlSubsetError(f"{where}: {v!r} is a YAML scalar form this reader does not "
                              "take (octal, hex, binary, sexagesimal, underscores, "
                              "timestamps, merge keys)")
    bad_start = v[0] in _INDICATORS or (v[0] in "-?:" and (len(v) == 1 or v[1] == " "))
    if (bad_start or ": " in v or v.endswith(":") or "\t" in v
            or (in_list and any(c in v for c in "[]{},"))):
        raise YamlSubsetError(f"{where}: {v!r} is not a plain scalar of the subset")
    return v


def _quoted(v: str, where: str) -> str:
    """A single-quoted ('' for a quote) or double-quoted (no escapes)
    string followed by nothing but a comment."""
    q = v[0]
    body, i = [], 1
    while True:
        j = v.find(q, i)
        if j < 0:
            raise YamlSubsetError(f"{where}: unterminated {q}-quoted string")
        body.append(v[i:j])
        if q == "'" and v[j + 1:j + 2] == "'":
            body.append("'")
            i = j + 2
            continue
        break
    text = "".join(body)
    rest = v[j + 1:]
    if rest.strip() and not re.match(r"^[ ]+#", rest):
        raise YamlSubsetError(f"{where}: text after the closing quote")
    if q == '"' and "\\" in text:
        raise YamlSubsetError(f"{where}: escapes in double-quoted strings are not read")
    return text


def _scalar(raw: str, where: str) -> Any:
    """A value or list item: a quoted string, or a plain scalar with its
    trailing comment cut."""
    raw = raw.strip(" ")
    if raw[:1] in ("'", '"'):
        return _quoted(raw, where)
    c = _COMMENT.search(raw)
    return _plain_scalar((raw[:c.start()] if c else raw).strip(" "), where)


def _flow_list(v: str, where: str) -> list:
    if not v.endswith("]"):
        raise YamlSubsetError(f"{where}: a list must open and close on its line")
    inner = v[1:-1].strip(" ")
    items = [] if not inner else [i.strip(" ") for i in inner.split(",")]
    if any(not i or i[0] in "'\"" for i in items):
        raise YamlSubsetError(f"{where}: empty or quoted list items are not read")
    return [_plain_scalar(i, where, in_list=True) for i in items]


def parse_reference_yaml(text: str, source: str = "<config>") -> Dict[str, Any]:
    """The reference configs' YAML subset -> the dict yaml.safe_load gives.

    The subset: one `key: value` a line at column 0 (keys are identifiers,
    each once), `#` comments and blank lines; values that are plain scalars
    (resolved by YAML 1.1's rules, as safe_load does: `1.0e-06` is a float
    and a dotless `1e-06` a string, `on` / `off` are booleans), single- or
    double-quoted strings without escapes, one-line `[a, b]` lists of plain
    scalars, or, after a bare `key:`, a block list of `- item` lines of one
    indent (as yaml.safe_dump writes lists). Anything else (nesting,
    anchors, tags, multi-line values, documents, tabs, octal / hex /
    sexagesimal numbers, timestamps) raises YamlSubsetError naming the
    line."""
    out: Dict[str, Any] = {}
    lines = text.splitlines()
    n = 0
    while n < len(lines):
        line = lines[n]
        n += 1
        where = f"{source}:{n}"
        stripped = line.strip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        m = _KEY_LINE.match(line)
        if m is None:
            raise YamlSubsetError(f"{where}: not a `key: value` line at column 0: {line!r}")
        key, raw = m.group(1), (m.group(2) or "").strip(" ")
        if key in out:
            raise YamlSubsetError(f"{where}: key {key!r} given twice")
        if raw.startswith("["):
            c = _COMMENT.search(raw)
            out[key] = _flow_list((raw[:c.start()] if c else raw).strip(" "), where)
            continue
        out[key] = _scalar(raw, where)
        if raw and not raw.startswith("#"):
            continue
        items, indent = [], None  # a bare `key:` may open a block list
        while n < len(lines):
            item = re.match(r"^( *)- (.*)$", lines[n])
            if item is None:
                if lines[n].strip(" ") and not lines[n].strip(" ").startswith("#"):
                    break
                n += 1
                continue
            if indent not in (None, item.group(1)):
                raise YamlSubsetError(f"{source}:{n + 1}: list items of two indents")
            indent = item.group(1)
            n += 1
            items.append(_scalar(item.group(2), f"{source}:{n}"))
        if indent is not None:
            out[key] = items
    if not out:
        raise YamlSubsetError(f"{source}: no `key: value` line")
    return out


def from_reference_yaml(path: str) -> Config:
    """Load a reference-format config file (config/*/*.yaml) into a Config
    tree, with no pyyaml. A file that parses as JSON is read as JSON, where
    a dotless exponent (1e-06) is the number it says; any other file is
    read by `parse_reference_yaml`, to what yaml.safe_load would give."""
    with open(path) as f:
        text = f.read()
    try:
        return from_reference_dict(json.loads(text))
    except json.JSONDecodeError:
        pass
    return from_reference_dict(parse_reference_yaml(text, path))


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
