"""Shared CLI plumbing: config and dataset loading, ground-truth discovery,
and the multi-GPU launch (counterpart of `coskad_tpu/cli/common.py`).

The reference trains on N cards with one command (Lightning spawns the DDP
ranks). The port runs one CLI process a rank, wired into one process group
by `--distributed` (`parallel/mesh.py::initialize_distributed`): every
rank computes the same host-side results (scores are gathered), rank 0
alone writes files (`is_primary`), and the ranks leave together
(`distributed_barrier`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..config import Config, from_reference_yaml
from ..data.alphapose import load_alphapose_split, load_alphapose_store
from ..data.device_pipeline import TrajectoryStore
from ..data.robust import load_robust_split, load_scaler, save_scaler
from ..data.windows import SegmentDataset
from ..parallel import mesh
from ..utils.net import PORT_IN_USE_EXIT


def load_config(path: str) -> Config:
    return from_reference_yaml(path)


def add_distributed_flag(parser) -> None:
    """Attach the multi-GPU launch flag shared by the train and eval CLIs."""
    parser.add_argument(
        "--distributed", default=None, metavar="SPEC",
        help="multi-GPU launch: 'auto' (torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, "
             "RANK and LOCAL_RANK) or 'host:port,num_processes,process_id'; run the same "
             "command once a rank with its own process_id. NCCL on cards, gloo with "
             "--device cpu")


def init_distributed(spec: Optional[str], device="cuda") -> mesh.Layout:
    """Join the process group a --distributed SPEC names, before any use of
    the device; None (or '') joins none. Returns the layout. A rank 0 whose
    coordinator port another process holds exits with PORT_IN_USE_EXIT,
    which the supervisor retries on a fresh port."""
    if not spec:
        return mesh.layout()
    if spec in ("auto", "env"):
        args = ()
    else:
        parts = spec.rsplit(",", 2)
        if len(parts) != 3:
            raise ValueError(f"--distributed expects 'host:port,num_processes,process_id' or "
                             f"'auto', got {spec!r}")
        args = (parts[0], int(parts[1]), int(parts[2]))
    try:
        return mesh.initialize_distributed(*args, device=device)
    except mesh.CoordinatorBindError as e:
        print(f"[coskad] {e}", flush=True)
        raise SystemExit(PORT_IN_USE_EXIT)


def is_primary() -> bool:
    """True on the process that owns file writes (checkpoints, metrics,
    scores): rank 0 of a group, or the one process. Every rank computes the
    same host-side results, so gating the writes on rank 0 keeps a shared
    filesystem free of races."""
    return mesh.layout().rank == 0


def distributed_barrier() -> None:
    """The ranks wait for each other before they exit, so that no rank's
    teardown lands under another's live collective; a no-op without a
    group. Then the process leaves its group."""
    mesh.barrier()
    mesh.destroy()


def load_split(cfg: Config, split: str, stride: Optional[int] = None,
               scaler=None, device=None) -> Union[SegmentDataset, TrajectoryStore]:
    """The config's dataset for `split` ('train', 'test' or 'validation'),
    windowed at `stride` (default: the config's) and normalized with
    `scaler` where given. The AlphaPose path with robust normalization
    keeps the fitted scaler in <ckpt_dir>/robust.pkl: the train split writes
    it, other splits (or use_fitted_scaler) read it. With
    `run.device_pipeline` the AlphaPose path gives a TrajectoryStore on
    `device` (default 'cuda'), which needs that scaler already fitted for
    robust normalization."""
    d = cfg.data
    seg_stride = stride if stride is not None else d.seg_stride
    if d.normalization_strategy == "robust" and d.path_to_robust:
        return load_robust_split(
            d.path_to_robust, split=split, include_global=cfg.model.num_coords == 6,
            seg_len=d.seg_len, seg_stride=seg_stride, vid_res=d.vid_res,
            normalization_strategy="robust", exp_dir=cfg.ckpt_dir,
            normalize_pose=d.normalize_pose, kp18_format=d.kp18_format, headless=d.headless,
            num_transform=d.num_transform, num_clips_debug=d.num_clips, scaler=scaler,
            is_primary=is_primary())
    pose_dir = d.pose_dirs.get(split)
    if not pose_dir or not os.path.isdir(pose_dir):
        raise FileNotFoundError(f"pose directory for split {split!r} not found: {pose_dir!r}")
    scaler_pkl = os.path.join(cfg.ckpt_dir, "robust.pkl")
    if (scaler is None and d.normalization_strategy == "robust"
            and (d.use_fitted_scaler or split != "train") and os.path.exists(scaler_pkl)):
        scaler = load_scaler(scaler_pkl)
    kwargs = dict(seg_len=d.seg_len, seg_stride=seg_stride, start_offset=d.start_offset,
                  num_clips=d.num_clips, kp_threshold=d.kp_threshold,
                  kp18_format=d.kp18_format, headless=d.headless, vid_res=d.vid_res,
                  symm_range=d.symm_range, sub_mean=d.sub_mean, scaler=scaler,
                  num_transform=d.num_transform)
    if cfg.run.device_pipeline:
        return load_alphapose_store(
            pose_dir, device=device,
            normalization_strategy=d.normalization_strategy if d.normalize_pose else "none",
            **kwargs)
    ds = load_alphapose_split(pose_dir, normalize_pose=d.normalize_pose,
                              normalization_strategy=d.normalization_strategy, **kwargs)
    if (d.normalization_strategy == "robust" and split == "train" and scaler is None
            and ds.scaler is not None):
        save_scaler(ds.scaler, scaler_pkl, is_primary())
    return ds


def load_ground_truths(gt_dir: str) -> Dict[Tuple[int, int], np.ndarray]:
    """{(scene, clip): labels} from '<scene>_<clip>.npy' files (sorted)."""
    gts = {}
    for fn in sorted(os.listdir(gt_dir)):
        if not fn.endswith(".npy"):
            continue
        scene = int(fn.split("_")[0])
        clip = int(fn.split("_")[1].split(".")[0])
        gts[(scene, clip)] = np.load(os.path.join(gt_dir, fn))
    return gts
