"""GNOT graph-dataset surface, dgl-free.

Counterpart of resolution_pde_tpu/data/graph.py, numpy on the host as
the port's other data code (reference dataloaders/dgl_data.py:9-147,
FNODataset building DGL graphs, and dataloaders/sequential_dataset.py:4,
the SequentialDataSet ABC).
The reference gates these behind `dgl`/`networkx`/`sklearn` imports; this
module realizes the same dataset semantics in plain numpy — the
reference's FNO graphs carry no edges, and for operators that do want
local structure, `knn_edges` / `radius_edges` build edge lists without a
graph library.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


class SequentialDataSet(ABC):
    """Sequence-dataset ABC (sequential_dataset.py:4-12)."""

    @abstractmethod
    def __len__(self):
        ...

    @abstractmethod
    def __getitem__(self, idx):
        ...


def grid_to_point_cloud(u: np.ndarray):
    """(n, h, w[, c]) fields -> (n, h*w, c) node features + (h*w, 2)
    normalized positions — the dgl-free half of FNODataset's graph
    construction (dgl_data.py:33-120)."""
    if u.ndim == 3:
        u = u[..., None]
    n, h, w, c = u.shape
    feats = u.reshape(n, h * w, c).astype(np.float32)
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    pos = np.stack([ys.ravel(), xs.ravel()], axis=-1).astype(np.float32)
    return feats, pos


def _d2_block(pos: np.ndarray, i0: int, i1: int) -> np.ndarray:
    """Squared distances from rows [i0:i1) to ALL nodes, (i1-i0, n) —
    x²+y²−2xy so only an (block, n) tensor materializes, never (n, n, d).
    Self-distances are set to inf."""
    sq = (pos ** 2).sum(-1)
    blk = pos[i0:i1]
    d2 = sq[i0:i1, None] + sq[None, :] - 2.0 * (blk @ pos.T)
    np.maximum(d2, 0.0, out=d2)  # guard fp cancellation going negative
    d2[np.arange(i1 - i0), np.arange(i0, i1)] = np.inf
    return d2


# rows per distance block: block * n float64 stays ~0.5 GB even at
# n = 256*256 grid point clouds (the sizes build_graph_dataset produces)
_EDGE_BLOCK = 1024


def knn_edges(pos: np.ndarray, k: int) -> np.ndarray:
    """(2, n*k) int32 [src; dst] edge list connecting each node to its k
    nearest neighbours (self excluded), plain numpy — the dgl-free
    counterpart of the k-NN graph construction GNOT-style loaders use
    (dgl_data.py's DGLDataset surface without the dgl/sklearn stack).
    Blocked over rows: memory is O(block * n), never O(n^2 * d)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    pos = np.asarray(pos, np.float64)
    n = pos.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n_nodes={n}")
    nbrs = []
    for i0 in range(0, n, _EDGE_BLOCK):
        d2 = _d2_block(pos, i0, min(i0 + _EDGE_BLOCK, n))
        nbrs.append(np.argpartition(d2, k - 1, axis=1)[:, :k])
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    return np.stack([src, np.concatenate(nbrs).astype(np.int32).ravel()])


def radius_edges(pos: np.ndarray, radius: float) -> np.ndarray:
    """(2, n_edges) int32 [src; dst] edge list connecting node pairs within
    `radius` (self excluded), plain numpy, blocked like knn_edges."""
    pos = np.asarray(pos, np.float64)
    n = pos.shape[0]
    srcs, dsts = [], []
    for i0 in range(0, n, _EDGE_BLOCK):
        d2 = _d2_block(pos, i0, min(i0 + _EDGE_BLOCK, n))
        s, d = np.nonzero(d2 <= radius * radius)
        srcs.append((s + i0).astype(np.int32))
        dsts.append(d.astype(np.int32))
    return np.stack([np.concatenate(srcs), np.concatenate(dsts)])


class GraphDataset:
    """dgl-free FNODataset equivalent (dgl_data.py:33-120).

    Per-sample node sets: x rows are [features | positions] (the
    reference concatenates pos into X upstream and stores it as ndata
    'x'), y node targets, and a zero global-parameter vector u_p — the
    reference augments FNO data with ``u_p = 0`` and its graphs carry NO
    edges (dgl_data.py:29: "there is no edge info"). `edges` optionally
    attaches a shared k-NN / radius edge list built from the trailing
    `space_dim` position columns for operators that want local structure.

    ``__getitem__`` returns (x, y, u_p); x feeds GNOTOperator directly
    (models/mgpt.py:228 consumes [features | positions] rows)."""

    def __init__(self, X: np.ndarray, Y: np.ndarray, *, space_dim: int = 2,
                 normalize_y: bool = False, y_normalizer=None,
                 edges=None):
        if X.ndim != 3 or Y.ndim != 3 or X.shape[:2] != Y.shape[:2]:
            raise ValueError(
                f"X, Y must be (n, nodes, feat) with matching leading "
                f"dims, got {X.shape} and {Y.shape}")
        self.x = np.asarray(X, np.float32)
        self.y = np.asarray(Y, np.float32)
        self.space_dim = space_dim
        # the reference's u_p global-input slot, zero for FNO data
        # (dgl_data.py:65 "we augment g_u = g and set u_p = 0")
        self.u_p = np.zeros((len(self.x), 1), np.float32)
        self.y_normalizer = y_normalizer
        if normalize_y:
            if self.y_normalizer is None:
                from resolution_pde_tpu_torch.utils.gnot import (
                    PointWiseUnitTransformer)
                # the stats fit in numpy on the host, then handed to the
                # transformer
                mean = self.y.mean(axis=0)
                std = self.y.std(axis=0)
                self.y_normalizer = PointWiseUnitTransformer(mean, std)
                self.y = ((self.y - mean)
                          / (std + self.y_normalizer.eps)).astype(np.float32)
            else:
                self.y = np.asarray(self.y_normalizer.encode(self.y),
                                    np.float32)
        self.edges = None
        if edges is not None:
            kind, arg = edges
            pos = self.x[0, :, -space_dim:]
            if kind == "knn":
                self.edges = knn_edges(pos, int(arg))
            elif kind == "radius":
                self.edges = radius_edges(pos, float(arg))
            else:
                raise ValueError(
                    f"edges must be ('knn', k) or ('radius', r), "
                    f"got {edges!r}")

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx], self.u_p[idx]


def build_graph_dataset(u_in: np.ndarray, u_out: np.ndarray, *,
                        normalize_y: bool = False, edges=None):
    """Grids -> GraphDataset: (n, h, w[, c]) input/target fields become
    [features | positions] node rows (the FNODataset X layout,
    dgl_data.py:27 "X: concat of [pos, a]"). `edges=('knn', k)` or
    `('radius', r)` attaches an edge list; default matches the
    reference's edgeless FNO graphs."""
    fi, pos = grid_to_point_cloud(u_in)
    fo, _ = grid_to_point_cloud(u_out)
    x = np.concatenate([fi, np.broadcast_to(pos, fi.shape[:1] + pos.shape)],
                       axis=-1)
    return GraphDataset(x, fo, space_dim=pos.shape[-1],
                        normalize_y=normalize_y, edges=edges)


def build_dgl_graph_dataset(u_in: np.ndarray, u_out: np.ndarray, **kwargs):
    """Name kept from the gated round-3 surface; now dgl-free — the
    reference's FNODataset graphs carry no edge info, so nothing here
    needs a graph library. See build_graph_dataset."""
    return build_graph_dataset(u_in, u_out, **kwargs)
