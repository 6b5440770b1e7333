"""Connected components of contact/H-bond graphs (port of
waterorderlib_tpu.hbonds.clusters), batched over frames.

Replaces the reference's recursive depth-first search `depthFirstSort`
(sortlib.f90:26-72) and `getClusters` (orderParam_lib.py:123-156) by
min-label propagation over the adjacency matrix: each sweep is one masked
min-reduction for every frame at once. It stops when no frame's labels
change, after at most n sweeps, with one host sync per sweep.
"""

from __future__ import annotations

import torch


def connected_components(adj: torch.Tensor) -> torch.Tensor:
    """Component label per vertex (the smallest vertex index in its
    component). adj: (..., n, n) boolean adjacency; diagonal ignored.
    Returns (..., n) int32."""
    n = adj.shape[-1]
    dev = adj.device
    adj = adj | torch.eye(n, dtype=torch.bool, device=dev)
    labels = torch.arange(n, dtype=torch.int32, device=dev).expand(adj.shape[:-1]).contiguous()
    big = torch.tensor(n, dtype=torch.int32, device=dev)
    for _ in range(n):
        neigh = torch.where(adj, labels[..., None, :], big)
        new = torch.minimum(labels, neigh.min(dim=-1).values)
        if not bool((new != labels).any()):
            break
        labels = new
    return labels


def cluster_sizes(adj: torch.Tensor) -> torch.Tensor:
    """(..., n) int32: the size of the component whose smallest member is
    vertex r at r, 0 at the other vertices. The nonzero entries are
    `getClusters`' cluster-size list (isolated vertices are size-1
    clusters, orderParam_lib.py:150-152)."""
    labels = connected_components(adj)
    return torch.zeros_like(labels).scatter_add_(-1, labels.long(), torch.ones_like(labels))


def size_distribution(sizes: torch.Tensor, max_size: int) -> torch.Tensor:
    """out[..., s] = number of clusters of size s (index 0 unused), from
    `cluster_sizes`' output, sizes above max_size counted at max_size."""
    valid = sizes > 0
    idx = torch.where(valid, torch.clamp(sizes, 0, max_size), 0).long()
    out = torch.zeros(sizes.shape[:-1] + (max_size + 1,), dtype=torch.int32, device=sizes.device)
    return out.scatter_add_(-1, idx, valid.to(torch.int32))


def cluster_size_distribution(adj: torch.Tensor, max_size: int | None = None) -> torch.Tensor:
    """Histogram of cluster sizes: out[..., s] = clusters of size s (index
    0 unused). The histogramming of getHBClusterStats (orderParam_lib.py:
    158-237)."""
    return size_distribution(cluster_sizes(adj), adj.shape[-1] if max_size is None else max_size)


def mean_cluster_size(adj: torch.Tensor) -> torch.Tensor:
    """Mean cluster size over all clusters of the graph (float32)."""
    return mean_of_sizes(cluster_sizes(adj))


def mean_of_sizes(sizes: torch.Tensor) -> torch.Tensor:
    """Mean of the nonzero entries of `cluster_sizes`' output (float32)."""
    return sizes.sum(dim=-1) / torch.clamp((sizes > 0).sum(dim=-1), min=1)
