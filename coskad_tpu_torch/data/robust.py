"""The 'robust' (Morais CSV) dataset pipeline of the UBnormal configs.

Counterpart of `coskad_tpu/data/robust.py`: load CSV trajectories, drop
short ones, optionally extract global bbox features, move the local
coordinates to the bounding-box centre, window, fit or load the scalers
(pickled as '<kind>_<strategy>.pickle' in the experiment directory), and
assemble a SegmentDataset of [N, C, T, V] windows (C = x, y, conf=1; or 7
channels with the 4 global features appended).

Scaler pickles are read by `load_scaler`, whose unpickler resolves only
the scaler classes (the JAX package's, the port's and sklearn's fitted
`RobustScaler`, the reference's `robust.pkl`) and the numpy globals an
array needs, each to the port's own object: a pickle written by the JAX
package or by sklearn loads without importing either, and one naming any
other global is refused. `save_scaler` writes only where `is_primary` is
true; `write_sklearn_scaler` writes a `robust.pkl` that sklearn reads,
without importing sklearn.
"""

from __future__ import annotations

import importlib
import os
import pickle
from copy import deepcopy
from typing import Optional

import numpy as np

from .normalize import RobustScalerState
from .trajectories import (
    MinMaxState,
    StdState,
    aggregate_all_coordinates,
    aggregate_windows,
    load_trajectories,
    remove_short_trajectories,
    scale_trajectories,
)
from .windows import SegmentDataset, keypoints17_to_coco18


def _numpy_globals() -> dict:
    """The numpy globals a pickled ndarray or numpy scalar names, under the
    module names numpy 1.x and 2.x write."""
    try:
        multiarray = importlib.import_module("numpy._core.multiarray")
    except ImportError:  # numpy < 2
        multiarray = importlib.import_module("numpy.core.multiarray")
    try:
        numeric = importlib.import_module("numpy._core.numeric")
    except ImportError:  # numpy < 2
        numeric = importlib.import_module("numpy.core.numeric")
    out = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype}
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        out[(mod, "_reconstruct")] = multiarray._reconstruct
        out[(mod, "scalar")] = multiarray.scalar
    for mod in ("numpy.core.numeric", "numpy._core.numeric"):  # protocol 5 arrays
        out[(mod, "_frombuffer")] = numeric._frombuffer
    return out


class SklearnRobustScaler:
    """What the port reads of a pickled fitted sklearn `RobustScaler` (the
    reference's `robust.pkl`): `center_` and `scale_`. The rest of the
    estimator's state (its parameters, `n_features_in_`, the sklearn
    version) is dropped."""

    def __setstate__(self, state: dict) -> None:
        self.center_ = state.get("center_")
        self.scale_ = state.get("scale_")


# sklearn's module path since 0.22 and the one before it
_SKLEARN_ROBUST = ("sklearn.preprocessing._data", "sklearn.preprocessing.data")

_ALLOWED = {
    **_numpy_globals(),
    **{(mod, "RobustScaler"): SklearnRobustScaler for mod in _SKLEARN_ROBUST},
    **{(f"{package}.data.{mod}", cls.__name__): cls
       for package in ("coskad_tpu", "coskad_tpu_torch")
       for mod, cls in (("normalize", RobustScalerState), ("trajectories", MinMaxState),
                        ("trajectories", StdState))},
}


class _ScalerUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(f"a scaler pickle may not name {module}.{name}")
        return _ALLOWED[(module, name)]


def load_scaler(path: str):
    """A fitted scaler from a pickle written by either package (or by
    sklearn: a `SklearnRobustScaler`)."""
    with open(path, "rb") as f:
        return _ScalerUnpickler(f).load()


class _ByName:
    """An object to pickle as an instance of the class `module.name`,
    which the writer need not be able to import, with `state` as its
    instance dict."""

    def __init__(self, module: str, name: str, state: dict):
        self.module, self.name, self.state = module, name, state


class _ByNamePickler(pickle._Pickler):
    """The pure-Python pickler, writing a `_ByName` by hand: GLOBAL (the
    class by module and name), an empty argument tuple and NEWOBJ (as
    `object.__reduce_ex__` gives a class without arguments to `__new__`),
    then its state and BUILD, which calls the class's `__setstate__`."""

    def save(self, obj, save_persistent_id=True):
        if not isinstance(obj, _ByName):
            return super().save(obj, save_persistent_id)
        self.framer.commit_frame()
        self.write(pickle.GLOBAL + f"{obj.module}\n{obj.name}\n".encode())
        self.write(pickle.EMPTY_TUPLE + pickle.NEWOBJ)
        self.memoize(obj)
        self.save(obj.state)
        self.write(pickle.BUILD)


def write_sklearn_scaler(center: np.ndarray, scale: np.ndarray, path: str) -> None:
    """Write a fitted robust scaler as the pickle of an sklearn
    `RobustScaler(quantile_range=(10.0, 90.0))` (the reference's
    `robust.pkl`) without importing sklearn: `_ByNamePickler` emits the
    class reference as a pickle GLOBAL by hand around the estimator's state
    dict, its parameters at sklearn's defaults and the fitted `center_`,
    `scale_` and `n_features_in_`, as the JAX package sets them. The state
    names no sklearn version, so sklearn warns that the pickle predates
    0.18 when it loads it."""
    center = np.asarray(center, np.float64)
    state = {"with_centering": True, "with_scaling": True, "quantile_range": (10.0, 90.0),
             "copy": True, "unit_variance": False, "center_": center,
             "scale_": np.asarray(scale, np.float64), "n_features_in_": int(center.shape[0])}
    with open(path, "wb") as f:
        _ByNamePickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(
            _ByName(_SKLEARN_ROBUST[0], "RobustScaler", state))


def save_scaler(scaler, path: str, is_primary: bool = True) -> None:
    """Pickle a fitted scaler atomically; a no-op where `is_primary` is
    false (every process fits the same scaler from the same data, and one
    writes it)."""
    if not is_primary:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(scaler, f)
    os.replace(tmp, path)


def robust_windows(
    trajectories_path: str,
    split: str = "train",
    seg_len: int = 12,
    seg_stride: int = 1,
    vid_res=(1080, 720),
    normalization_strategy: str = "robust",
    exp_dir: str = ".",
    normalize_pose: bool = True,
    include_global: bool = False,
    debug: bool = False,
    scaler=None,
    is_primary: bool = True,
):
    """-> ((X_global, meta) | (None, None), (X_local, (meta, frame_ids))).

    `seg_stride` becomes an intra-window frame gap of (stride - 1). The train
    split fits and saves the scalers; other splits load them from
    `exp_dir`, unless `scaler` (e.g. from a checkpoint) is given for the
    local features."""
    subfolder = ("training" if "train" in split
                 else "testing" if "test" in split else "validating")
    path = os.path.join(trajectories_path, subfolder, "trajectories")
    video_resolution = np.array(vid_res, dtype=np.float32)
    input_gap = seg_stride - 1

    trajectories = load_trajectories(path, debug=debug, split=split)
    trajectories = remove_short_trajectories(trajectories, input_length=seg_len,
                                             input_gap=input_gap)

    x_global, global_meta = None, None
    if include_global:
        gtraj = {tid: deepcopy(tr).use_global_features(video_resolution)
                 for tid, tr in trajectories.items()}
        for tr in gtraj.values():
            tr.to_global_coordinates(video_resolution)
        x_global, gmeta, gids = aggregate_windows(gtraj, seg_len, input_gap)
        global_meta = (gmeta, gids)
        if normalize_pose:
            scaler_path = os.path.join(exp_dir, f"global_{normalization_strategy}.pickle")
            if split == "train":
                _, gscaler = scale_trajectories(aggregate_all_coordinates(gtraj),
                                                strategy=normalization_strategy)
                save_scaler(gscaler, scaler_path, is_primary)
            else:
                try:
                    gscaler = load_scaler(scaler_path)
                except FileNotFoundError:
                    raise FileNotFoundError(
                        f"global scaler pickle missing: {scaler_path}. The include_global "
                        "path keeps its global-feature scaler only in exp_dir (not in "
                        "checkpoints); evaluate in the training exp_dir or re-fit on the "
                        "train split.") from None
            x_global, _ = scale_trajectories(x_global, scaler=gscaler,
                                             strategy=normalization_strategy)

    for tr in trajectories.values():
        tr.to_bounding_box_centre(video_resolution)
    x_local, lmeta, lids = aggregate_windows(trajectories, seg_len, input_gap)
    if normalize_pose:
        scaler_path = os.path.join(exp_dir, f"local_{normalization_strategy}.pickle")
        if scaler is not None:
            lscaler = scaler
        elif split == "train":
            _, lscaler = scale_trajectories(aggregate_all_coordinates(trajectories),
                                            strategy=normalization_strategy)
            save_scaler(lscaler, scaler_path, is_primary)
        else:
            lscaler = load_scaler(scaler_path)
        x_local, _ = scale_trajectories(x_local, scaler=lscaler,
                                        strategy=normalization_strategy)

    return (x_global, global_meta), (x_local, (lmeta, lids))


def load_robust_split(
    trajectories_path: str,
    split: str = "train",
    seg_len: int = 12,
    seg_stride: int = 1,
    vid_res=(1080, 720),
    normalization_strategy: str = "robust",
    exp_dir: str = ".",
    normalize_pose: bool = True,
    include_global: bool = False,
    kp18_format: bool = False,
    headless: bool = False,
    num_transform: int = 5,
    debug: bool = False,
    num_clips_debug: Optional[int] = None,
    scaler=None,
    is_primary: bool = True,
) -> SegmentDataset:
    """Robust pipeline -> SegmentDataset."""
    (x_global, _), (x_local, (meta, ids)) = robust_windows(
        trajectories_path, split=split, seg_len=seg_len, seg_stride=seg_stride,
        vid_res=vid_res, normalization_strategy=normalization_strategy, exp_dir=exp_dir,
        normalize_pose=normalize_pose, include_global=include_global,
        debug=debug or (num_clips_debug is not None), scaler=scaler, is_primary=is_primary)
    n, t, d = x_local.shape
    v = d // 2
    local = x_local.reshape(n, t, v, 2)
    if include_global:
        segs = np.empty((n, t, v, 7))
        segs[..., :2] = local
        segs[..., 2:6] = x_global[:, :, None, :]
        segs[..., 6] = 1.0
    else:
        segs = np.empty((n, t, v, 3))
        segs[..., :2] = local
        segs[..., 2] = 1.0

    if kp18_format and segs.shape[-2] == 17:
        segs = keypoints17_to_coco18(segs)
    if headless:
        segs = segs[:, :, :14]

    fitted = scaler
    if fitted is None and normalize_pose:
        try:
            fitted = load_scaler(os.path.join(exp_dir, f"local_{normalization_strategy}.pickle"))
        except FileNotFoundError:
            fitted = None
    return SegmentDataset(
        data=np.transpose(segs, (0, 3, 1, 2)).astype(np.float32),
        meta=np.asarray(meta, dtype=np.int64),
        frame_ids=np.asarray(ids, dtype=np.int32),
        num_transform=num_transform,
        scaler=fitted,
    )
