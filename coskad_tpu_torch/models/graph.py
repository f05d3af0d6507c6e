"""Skeleton graph construction for the fixed ST-GCN and the static plain-GCN
encoders (numpy).

A copy of `coskad_tpu/models/graph.py`, which is pure numpy: the (K, V, V)
partitioned adjacency stacks of Yan et al.'s ST-GCN (openpose-17 / ntu-25
layouts, uniform / distance / spatial partitions, hop distances by the
reachability of adjacency powers, in-degree normalization A @ D^-1) and the
row-normalized [T*V, T*V] space-time adjacency of the static plain GCN,
with its replication of the spatial block over every frame pair. Each
result is a constant of its encoder.
"""

from __future__ import annotations

import numpy as np

# 17-joint COCO/OpenPose skeleton bones (reference stgcn.py:60-62, also the
# static-plain-GCN link list in alternative_components.py:294-297).
OPENPOSE17_LINKS = [
    (0, 1), (0, 2), (0, 5), (0, 6), (1, 2), (1, 3), (2, 4),
    (5, 6), (5, 7), (7, 9), (6, 8), (8, 10), (5, 11), (6, 12),
    (11, 12), (11, 13), (12, 14), (13, 15), (14, 16),
]

NTU25_LINKS = [
    (i - 1, j - 1)
    for (i, j) in [
        (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6), (8, 7),
        (9, 21), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13), (15, 14),
        (16, 15), (17, 1), (18, 17), (19, 18), (20, 19), (22, 23), (23, 8),
        (24, 25), (25, 12),
    ]
]

LAYOUTS = {
    "openpose": (17, OPENPOSE17_LINKS, 1),  # (num_node, bones, center joint)
    "ntu-rgb+d": (25, NTU25_LINKS, 20),
}


def hop_distance(num_node: int, edges, max_hop: int = 1) -> np.ndarray:
    """Per-pair hop distance, inf beyond max_hop (reachability of A^d)."""
    a = np.zeros((num_node, num_node))
    for i, j in edges:
        a[i, j] = a[j, i] = 1
    dist = np.full((num_node, num_node), np.inf)
    reach = [np.linalg.matrix_power(a, d) > 0 for d in range(max_hop + 1)]
    for d in range(max_hop, -1, -1):
        dist[reach[d]] = d
    return dist


def normalize_digraph(a: np.ndarray) -> np.ndarray:
    """Column (in-degree) normalization A @ D^-1."""
    deg = a.sum(0)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    return a @ np.diag(inv)


def build_partitioned_adjacency(
    layout: str = "openpose",
    strategy: str = "spatial",
    max_hop: int = 1,
) -> np.ndarray:
    """(K, V, V) adjacency stack for the given partition strategy."""
    num_node, links, center = LAYOUTS[layout]
    edges = [(i, i) for i in range(num_node)] + links
    hops = hop_distance(num_node, edges, max_hop)
    valid = range(max_hop + 1)
    adjacency = np.zeros((num_node, num_node))
    for hop in valid:
        adjacency[hops == hop] = 1
    norm = normalize_digraph(adjacency)

    if strategy == "uniform":
        return norm[None]
    if strategy == "distance":
        parts = np.zeros((len(valid), num_node, num_node))
        for i, hop in enumerate(valid):
            parts[i][hops == hop] = norm[hops == hop]
        return parts
    if strategy == "spatial":
        parts = []
        for hop in valid:
            root = np.zeros((num_node, num_node))
            closer = np.zeros((num_node, num_node))
            further = np.zeros((num_node, num_node))
            mask = hops == hop
            # a[j, i] classified by j's vs i's distance to the center joint
            jc = hops[:, center][:, None]  # [j, 1]
            ic = hops[:, center][None, :]  # [1, i]
            root[mask & (jc == ic)] = norm[mask & (jc == ic)]
            closer[mask & (jc > ic)] = norm[mask & (jc > ic)]
            further[mask & (jc < ic)] = norm[mask & (jc < ic)]
            if hop == 0:
                parts.append(root)
            else:
                parts.append(root + closer)
                parts.append(further)
        return np.stack(parts)
    raise ValueError(f"Unknown partition strategy {strategy!r}")


def build_spacetime_adjacency(n_frames: int, n_joints: int) -> np.ndarray:
    """Row-normalized static space-time adjacency over T*V flattened nodes:
    skeleton bones + self loops within each frame, plus same-joint links
    between consecutive frames (reference alternative_components.py:207-259)."""
    spatial = np.zeros((n_joints, n_joints), dtype=np.float64)
    for i, j in OPENPOSE17_LINKS:
        if i < n_joints and j < n_joints:
            spatial[i, j] = spatial[j, i] = 1.0
    spatial += np.eye(n_joints)
    # The reference replicates the spatial block over BOTH frame axes
    # (np.repeat on axes 0 and 2, alternative_components.py:219-220), so a
    # joint connects to its spatial neighbors in *every* frame, not only its
    # own — reproduced faithfully.
    adj = np.broadcast_to(
        spatial[None, :, None, :], (n_frames, n_joints, n_frames, n_joints)
    ).copy()
    for t in range(n_frames - 1):
        for v in range(n_joints):
            adj[t, v, t + 1, v] = 1.0
            adj[t + 1, v, t, v] = 1.0
    flat = adj.reshape(n_frames * n_joints, n_frames * n_joints)
    rowsum = flat.sum(1)
    inv = np.where(rowsum > 0, 1.0 / np.maximum(rowsum, 1e-12), 0.0)
    return (np.diag(inv) @ flat).astype(np.float32)
