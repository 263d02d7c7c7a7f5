"""Spatial graph construction as a dense normalized adjacency.

The reference builds a directed kNN edge list for PyTorch-Geometric's sparse
scatter/gather GCNConv (graphBuilder.py:9-47). The graphs here are small
(~441 nodes for a 5-degree box at 0.25 degrees) and static per region, so
the design is a precomputed **dense** GCN-normalized adjacency matrix: graph
convolution then is a single matmul next to the feature transform.

Node counts are padded to a lane-aligned size so every region shares one
compiled program shape under vmap/pjit; padding nodes are isolated (zero
adjacency rows/columns) and masked out of losses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LANE = 128  # node-count padding multiple; part of the workload's shapes


def round_up(x: int, multiple: int = LANE) -> int:
    return -(-x // multiple) * multiple


def grid_node_positions(lats: np.ndarray, lons: np.ndarray) -> np.ndarray:
    """Node positions [N, 2] = (lat, lon) in row-major (lat-outer) order.

    Matches the reference flattening order (graphBuilder.py:27-30:
    meshgrid(indexing='ij') then ravel), which in turn matches the
    [T, lat, lon, C] -> [T, N, C] reshape in the feature pipeline
    (featurePreprocessor.py:122).
    """
    lat_g, lon_g = np.meshgrid(np.asarray(lats), np.asarray(lons), indexing="ij")
    return np.stack([lat_g.ravel(), lon_g.ravel()], axis=-1)


def knn_edges(positions: np.ndarray, k: int = 4) -> np.ndarray:
    """Directed kNN edge list [E, 2] of (src, dst) pairs, self excluded.

    Each node receives messages from its k nearest neighbors in Euclidean
    (lat, lon) degree space — the same neighborhood structure the reference
    derives from cKDTree (graphBuilder.py:33-44), computed here with a fully
    vectorized argpartition (no per-node Python loop).
    """
    pos = np.asarray(positions, dtype=np.float64)
    n = pos.shape[0]
    if k >= n:
        raise ValueError(f"k_neighbors={k} must be < num_nodes={n}")
    from weatherforecast_stgcn_maml_tpu import native

    native_edges = native.knn_edges_native(pos, k)
    if native_edges is not None:
        return native_edges
    # Pairwise squared distances; N is small (hundreds) so O(N^2) is fine.
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    # Full stable sort per row: ascending distance with ties broken by node
    # index — the SAME deterministic order as the native C++ path
    # (std::partial_sort over (dist, index) pairs). argpartition would pick
    # an arbitrary member among equidistant candidates, which on regular
    # grids (ties everywhere) made the two paths build different graphs.
    nbr = np.argsort(d2, axis=1, kind="stable")[:, :k]
    dst = np.repeat(np.arange(n), k)
    src = nbr.reshape(-1)
    return np.stack([src, dst], axis=-1)


def _sym_normalize(a: np.ndarray) -> np.ndarray:
    """D^-1/2 A D^-1/2 symmetric normalization; zero-degree rows (padding)
    stay all-zero. Shared by both graph builders so the epsilon/isolation
    policy cannot diverge."""
    deg = a.sum(axis=1)
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    return inv_sqrt[:, None] * a * inv_sqrt[None, :]


def normalized_adjacency(
    edges: np.ndarray,
    num_nodes: int,
    *,
    pad_to: int | None = None,
    add_self_loops: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """Dense GCN-normalized adjacency `A_hat = D^-1/2 (A + I) D^-1/2`.

    `A[dst, src] = 1` for each directed edge so that `A_hat @ H` aggregates
    neighbor features into each destination row — the dense equivalent of
    the sparse normalized message passing the reference gets from PyG's
    GCNConv (model.py:23-26). Degrees are computed on A + I.

    When `pad_to > num_nodes`, rows/columns beyond `num_nodes` are exactly
    zero: padding nodes neither send nor receive messages (and, having no
    self loop, stay identically zero through ReLU layers).
    """
    n = num_nodes
    size = pad_to if pad_to is not None else n
    if size < n:
        raise ValueError(f"pad_to={size} < num_nodes={n}")
    if add_self_loops and dtype == np.float32:
        from weatherforecast_stgcn_maml_tpu import native

        a_native = native.normalized_adjacency_native(np.asarray(edges), n, size)
        if a_native is not None:
            return a_native
    a = np.zeros((size, size), dtype=np.float64)
    if len(edges):
        e = np.asarray(edges)
        a[e[:, 1], e[:, 0]] = 1.0
    if add_self_loops:
        a[np.arange(n), np.arange(n)] = a[np.arange(n), np.arange(n)] + 1.0
    return _sym_normalize(a).astype(dtype)


@dataclass(frozen=True)
class RegionGraph:
    """Static per-region graph artifacts.

    Attributes:
      a_hat: [Np, Np] dense normalized adjacency (padded).
      node_mask: [Np] float32, 1.0 for real nodes, 0.0 for padding.
      num_nodes: number of real nodes N.
      positions: [N, 2] (lat, lon) of real nodes.
    """

    a_hat: np.ndarray
    node_mask: np.ndarray
    num_nodes: int
    positions: np.ndarray

    @property
    def padded_nodes(self) -> int:
        return self.a_hat.shape[0]


def build_region_graph(
    lats: np.ndarray,
    lons: np.ndarray,
    *,
    k_neighbors: int = 4,
    pad_to: int | None = None,
) -> RegionGraph:
    """Build the padded dense-adjacency graph for a lat/lon grid region.

    `pad_to=None` pads N up to the next multiple of LANE (128), so regions
    of similar size share one compiled shape.
    """
    positions = grid_node_positions(lats, lons)
    n = positions.shape[0]
    size = pad_to if pad_to is not None else round_up(n)
    edges = knn_edges(positions, k=k_neighbors)
    a_hat = normalized_adjacency(edges, n, pad_to=size)
    mask = np.zeros((size,), dtype=np.float32)
    mask[:n] = 1.0
    return RegionGraph(a_hat=a_hat, node_mask=mask, num_nodes=n, positions=positions)


def build_distance_weighted_graph(
    lats: np.ndarray,
    lons: np.ndarray,
    *,
    distance_threshold: float = 5.0,
    pad_to: int | None = None,
) -> RegionGraph:
    """Inverse-distance weighted dense graph (alternative to kNN).

    Capability match for the reference's `build_distance_weighted_graph`
    (graphBuilder.py:50-84, an O(N^2) Python loop producing unnormalized
    edge weights that nothing consumes). Here: fully vectorized, and the
    weighted adjacency is symmetrically normalized like the kNN variant so
    it drops into the same dense-matmul graph convolution.

    `A[i, j] = 1/dist(i, j)` for `0 < dist < distance_threshold` (degrees),
    plus identity self loops, then `D^-1/2 (A + I) D^-1/2`.
    """
    positions = grid_node_positions(lats, lons)
    n = positions.shape[0]
    size = pad_to if pad_to is not None else round_up(n)
    if size < n:
        raise ValueError(f"pad_to={size} < num_nodes={n}")

    d = np.sqrt(
        np.sum((positions[:, None, :] - positions[None, :, :]) ** 2, axis=-1)
    )
    with np.errstate(divide="ignore"):
        w = np.where((d > 0) & (d < distance_threshold), 1.0 / d, 0.0)
    w = w + np.eye(n)
    a_hat = np.zeros((size, size), dtype=np.float32)
    a_hat[:n, :n] = _sym_normalize(w).astype(np.float32)

    mask = np.zeros((size,), dtype=np.float32)
    mask[:n] = 1.0
    return RegionGraph(a_hat=a_hat, node_mask=mask, num_nodes=n, positions=positions)
