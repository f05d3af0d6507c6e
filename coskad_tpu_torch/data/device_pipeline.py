"""Device-side preprocessing: resident trajectories -> normalized windows.

Counterpart of `coskad_tpu/data/device_pipeline.py`. Instead of
materializing every sliding window on the host ([N, C, T, V], each frame
copied ~T times at stride 1), whole per-person trajectories are resident on
the device once ([P, F_max, V*C], zero padded), and each batch is gathered,
normalized, transformed and cut to its coordinate channels there.

Semantics are the host path's (`data/alphapose.py` + `data/normalize.py`):
- window validity (at most 2 missing frame keys) is decided on the host when
  the index tables are built; a window's content is `seg_len` consecutive
  trajectory rows, gaps included, as the reference's;
- 'markovitz', 'stan' and 'bbox' are per-window and computed on the device in
  float32; 'robust' applies the host-fitted scaler elementwise;
- a logical index i is (window i % N, transform i // N).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .transforms import apply_transforms
from .windows import PersonTrajectory, SegmentDataset, is_seg_continuous, keypoints17_to_coco18


@dataclass
class TrajectoryStore:
    """Device-resident trajectories + host-side window index tables.

    `traj` is stored flat as [P, F_max, V*C]: a window is then `seg_len`
    consecutive rows of the [P*F_max, V*C] view, one row gather a window
    row. `kp_shape` carries (V, C) for the reshape after gathering."""

    traj: torch.Tensor  # [P, F_max, V*C] float32 (zero padded)
    kp_shape: Tuple[int, int]  # (V, C) of the flattened minor dim
    window_person: np.ndarray  # [N] int32 row into traj
    window_start: np.ndarray  # [N] int32 start row within the trajectory
    meta: np.ndarray  # [N, 4] scene, clip, person, start_frame
    frame_ids: np.ndarray  # [N, T] actual frame keys
    seg_len: int
    num_transform: int
    normalization: str = "markovitz"
    vid_res: Tuple[int, int] = (856, 480)
    symm_range: bool = True
    sub_mean: bool = True
    scaler_center: Optional[np.ndarray] = None  # robust strategy
    scaler_scale: Optional[np.ndarray] = None

    @property
    def num_windows(self) -> int:
        return len(self.window_person)

    def __len__(self) -> int:
        return self.num_windows * max(self.num_transform, 1)

    @property
    def scaler(self):
        """RobustScalerState view of the fitted scaler (what a checkpoint
        keeps, as for a SegmentDataset)."""
        if self.scaler_center is None:
            return None
        from .normalize import RobustScalerState

        return RobustScalerState(center=self.scaler_center, scale=self.scaler_scale)


def build_store(
    clips: Sequence[Tuple[int, int, Sequence[PersonTrajectory]]],
    seg_len: int = 12,
    seg_stride: int = 1,
    start_offset: int = 0,
    kp18_format: bool = True,
    headless: bool = False,
    num_transform: int = 5,
    normalization: str = "markovitz",
    vid_res=(856, 480),
    symm_range: bool = True,
    sub_mean: bool = True,
    scaler=None,
    device: Union[str, torch.device, None] = None,
) -> TrajectoryStore:
    """[(scene, clip, trajectories)] -> TrajectoryStore on `device` (default
    'cuda', which raises without CUDA; pass 'cpu' for the plain path).

    Windows are enumerated as `windows.split_trajectory_to_windows` does;
    the raw keypoints go to the device, normalization happens per batch."""
    dev = resolve_device("cuda" if device is None else device)
    persons: List[np.ndarray] = []
    w_person, w_start, meta, fids = [], [], [], []
    for scene_id, clip_id, trajectories in clips:
        for tr in trajectories:
            kp = tr.keypoints
            if kp18_format and kp.shape[-2] == 17:
                kp = keypoints17_to_coco18(kp)
            if headless:
                kp = kp[:, :14]
            row = len(persons)
            persons.append(kp.astype(np.float32))
            clip_t = kp.shape[0]
            keys = tr.frame_keys
            num_segs = int(np.ceil((clip_t - seg_len) / seg_stride)) if clip_t > seg_len else 0
            for seg_ind in range(max(num_segs, 0)):
                start = start_offset + seg_ind * seg_stride
                if start >= clip_t or start + seg_len > clip_t:
                    continue
                if not is_seg_continuous(keys, keys[start], seg_len):
                    continue
                w_person.append(row)
                w_start.append(start)
                meta.append([scene_id, clip_id, tr.person_id, keys[start]])
                fids.append(keys[start:start + seg_len])
    if not w_person:
        raise ValueError("no valid windows")
    # gather_windows reads seg_len rows from each start with no clamp: every
    # window must lie inside its person's trajectory. Checked here, on the
    # host, with a raise that survives python -O.
    rows = np.asarray(w_person)
    starts = np.asarray(w_start)
    lengths = np.asarray([p.shape[0] for p in persons])
    bad = (starts < 0) | (starts + seg_len > lengths[rows])
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"window [{starts[i]}, {starts[i] + seg_len}) exceeds trajectory "
            f"length {lengths[rows[i]]} for person row {rows[i]} "
            f"({int(bad.sum())} violations total)")
    # Every person is padded to the longest trajectory, so a trajectory no
    # window reads (shorter than seg_len, or all discontinuous) would hold
    # [F_max, V*C] of device memory for nothing: drop it before padding and
    # remap window_person onto the kept rows.
    used = np.unique(rows)
    if len(used) < len(persons):
        remap = np.full(len(persons), -1, np.int64)
        remap[used] = np.arange(len(used))
        rows = remap[rows]
        w_person = rows.tolist()
        persons = [persons[i] for i in used]
    f_max = max(p.shape[0] for p in persons)
    v, f = persons[0].shape[1], persons[0].shape[2]
    padded = np.zeros((len(persons), f_max, v, f), np.float32)
    for i, p in enumerate(persons):
        padded[i, :p.shape[0]] = p
    return TrajectoryStore(
        traj=torch.from_numpy(padded.reshape(len(persons), f_max, v * f)).to(dev),
        kp_shape=(v, f),
        window_person=np.asarray(w_person, np.int32),
        window_start=np.asarray(w_start, np.int32),
        meta=np.asarray(meta, np.int64),
        frame_ids=np.asarray(fids, np.int32),
        seg_len=seg_len,
        num_transform=num_transform,
        normalization=normalization,
        vid_res=tuple(vid_res),
        symm_range=symm_range,
        sub_mean=sub_mean,
        scaler_center=None if scaler is None else np.asarray(scaler.center),
        scaler_scale=None if scaler is None else np.asarray(scaler.scale),
    )


def gather_windows(traj: torch.Tensor, person: torch.Tensor, start: torch.Tensor,
                   seg_len: int, kp_shape: Tuple[int, int]) -> torch.Tensor:
    """[P, F, V*C] + per-window (person, start) -> [B, T, V, C]: one
    `index_select` of rows person*F + start + arange(T) of the [P*F, V*C]
    view. Equal to advanced indexing `traj[person[:, None], rows]` bit for
    bit; build_store guarantees every window lies inside its trajectory."""
    v, c = kp_shape
    p, f, _ = traj.shape
    rows = (person.long() * f + start.long())[:, None] + torch.arange(
        seg_len, device=traj.device)[None, :]
    win = traj.reshape(p * f, v * c).index_select(0, rows.reshape(-1))
    return win.reshape(rows.shape[0], seg_len, v, c)


@functools.lru_cache(maxsize=64)
def _on_device(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A float32 constant on `device`, copied there once: a host-to-device
    copy a batch would make the host wait for the card every batch."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _constant(values, like: torch.Tensor) -> torch.Tensor:
    return _on_device(tuple(np.asarray(values, np.float32).ravel().tolist()), like.device)


def normalize_xy_device(win: torch.Tensor, normalization: str, vid_res, symm_range: bool,
                        sub_mean: bool, scaler_center=None, scaler_scale=None) -> torch.Tensor:
    """The xy channels of `normalize_windows_device`: [B, T, V, 3] windows ->
    [B, T, V, 2] (the confidence channel never enters the xy arithmetic in
    any strategy), without building the third channel. What every
    configuration with num_coords == 2 runs. 'bbox' ranges run over the TIME
    axis (each joint's temporal extent), as the reference's do."""
    if normalization in (None, "none"):
        return win[..., :2]
    xy = win[..., :2] / _constant(vid_res, win)
    if symm_range:
        xy = 2.0 * xy - 1.0
    if normalization == "markovitz":
        if sub_mean:
            xy = xy - torch.mean(xy, dim=(1, 2), keepdim=True)
        return xy
    if normalization == "stan":
        xy = xy - torch.mean(xy, dim=1, keepdim=True)
        smean = torch.mean(xy, dim=(2, 3), keepdim=True)
        std = torch.sqrt(torch.mean((xy - smean) ** 2, dim=(2, 3), keepdim=True) + 1e-5)
        return xy / std
    if normalization == "bbox":
        x, y = xy[..., 0], xy[..., 1]
        w = x.amax(-2, keepdim=True) - x.amin(-2, keepdim=True)
        h = y.amax(-2, keepdim=True) - y.amin(-2, keepdim=True)
        return xy / torch.stack([w, h], dim=-1)
    if normalization == "robust":
        b, t, v, _ = xy.shape
        flat = xy.reshape(b, t, v * 2)
        center, scale = _constant(scaler_center, flat), _constant(scaler_scale, flat)
        return torch.where(flat == 0.0, torch.zeros_like(flat),
                           (flat - center) / scale).reshape(b, t, v, 2)
    raise ValueError(f"Unsupported device normalization {normalization!r}")


def normalize_windows_device(win: torch.Tensor, normalization: str, vid_res, symm_range: bool,
                             sub_mean: bool, scaler_center=None, scaler_scale=None
                             ) -> torch.Tensor:
    """`data/normalize.py`'s strategies over [B, T, V, 3] windows, float32,
    on the windows' device: the xy channels are `normalize_xy_device`'s (so
    the two agree bit for bit); the confidence channel is kept, made
    time-centred by 'stan' and set to 1 by 'robust'."""
    if normalization in (None, "none"):
        return win
    xy = normalize_xy_device(win, normalization, vid_res, symm_range, sub_mean,
                             scaler_center, scaler_scale)
    rest = win[..., 2:]
    if normalization == "stan":
        rest = rest - torch.mean(rest, dim=1, keepdim=True)
    elif normalization == "robust":
        rest = torch.cat([torch.ones_like(rest[..., :1]), rest[..., 1:]], dim=-1)
    return torch.cat([xy, rest], dim=-1)


def gather_batch_from_store(store: TrajectoryStore, traj: torch.Tensor,
                            persons_dev: torch.Tensor, starts_dev: torch.Tensor,
                            indices: torch.Tensor, trans_table: torch.Tensor,
                            num_coords: int = 2) -> torch.Tensor:
    """Logical indices -> normalized, transformed [B, C, T, V] on the device.

    `persons_dev` / `starts_dev` are the device copies of the window index
    tables, `traj` the resident trajectory tensor."""
    n = persons_dev.shape[0]
    sample_idx = torch.remainder(indices, n)
    trans_idx = torch.div(indices, n, rounding_mode="floor")
    win = gather_windows(traj, persons_dev.index_select(0, sample_idx),
                         starts_dev.index_select(0, sample_idx), store.seg_len, store.kp_shape)
    mats = trans_table.index_select(0, trans_idx)
    args = (store.normalization, store.vid_res, store.symm_range, store.sub_mean,
            store.scaler_center, store.scaler_scale)
    if num_coords == 2:
        xy = normalize_xy_device(win, *args)
        return apply_transforms(xy.permute(0, 3, 1, 2), mats)
    pose = normalize_windows_device(win, *args).permute(0, 3, 1, 2)  # [B, 3, T, V]
    return apply_transforms(pose, mats)[:, :num_coords]


def to_segment_dataset_host(store: TrajectoryStore) -> SegmentDataset:
    """The store's windows materialized on the host (for comparisons)."""
    v, c = store.kp_shape
    traj = store.traj.cpu().numpy().reshape(store.traj.shape[0], store.traj.shape[1], v, c)
    win = traj[store.window_person[:, None],
               store.window_start[:, None] + np.arange(store.seg_len)[None, :]]
    win = normalize_windows_device(
        torch.from_numpy(np.ascontiguousarray(win)), store.normalization, store.vid_res,
        store.symm_range, store.sub_mean, store.scaler_center, store.scaler_scale).numpy()
    return SegmentDataset(
        data=np.transpose(win, (0, 3, 1, 2)).astype(np.float32),
        meta=store.meta,
        frame_ids=store.frame_ids,
        num_transform=store.num_transform,
    )
