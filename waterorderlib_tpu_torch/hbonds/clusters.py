"""Connected components of contact/H-bond graphs (port of
waterorderlib_tpu.hbonds.clusters), batched over frames.

Replaces the reference's recursive depth-first search `depthFirstSort`
(sortlib.f90:26-72) and `getClusters` (orderParam_lib.py:123-156) by
min-label propagation over the adjacency matrix: each sweep is one masked
min-reduction for every frame at once. It stops when no frame's labels
change, after at most n sweeps, with one host sync per sweep.

`hb_cluster_block` is `get_hb_cluster_stats`' dispatch (drivers/
hbonds_driver.py): one frame block from positions to cluster sizes, the
H-bond matrix and residue adjacency in a `hb_clusters:matrix` span, the
components in a `hb_clusters:components` span (CUDA events on the card),
with the counters `hb_clusters:frames` and `hb_clusters:sweeps`.
"""

from __future__ import annotations

import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.hbonds.bonds import general_hbonds


def _propagate(adj: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(`connected_components`' labels, the sweeps it took: the last one
    finds no label to change)."""
    n = adj.shape[-1]
    dev = adj.device
    adj = adj | torch.eye(n, dtype=torch.bool, device=dev)
    labels = torch.arange(n, dtype=torch.int32, device=dev).expand(adj.shape[:-1]).contiguous()
    big = torch.tensor(n, dtype=torch.int32, device=dev)
    sweeps = 0
    for _ in range(n):
        sweeps += 1
        neigh = torch.where(adj, labels[..., None, :], big)
        new = torch.minimum(labels, neigh.min(dim=-1).values)
        if not bool((new != labels).any()):
            break
        labels = new
    return labels, sweeps


def connected_components(adj: torch.Tensor) -> torch.Tensor:
    """Component label per vertex (the smallest vertex index in its
    component). adj: (..., n, n) boolean adjacency; diagonal ignored.
    Returns (..., n) int32."""
    return _propagate(adj)[0]


def _sizes_of(labels: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(labels).scatter_add_(-1, labels.long(), torch.ones_like(labels))


def cluster_sizes(adj: torch.Tensor) -> torch.Tensor:
    """(..., n) int32: the size of the component whose smallest member is
    vertex r at r, 0 at the other vertices. The nonzero entries are
    `getClusters`' cluster-size list (isolated vertices are size-1
    clusters, orderParam_lib.py:150-152)."""
    return _sizes_of(connected_components(adj))


@clock.traced("dispatch:hb_cluster_block", device=True)
def hb_cluster_block(pos, boxes, inds, res_pair, n_res: int, dist_cut: float,
                     ang_cut: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster sizes of one frame block of `get_hb_cluster_stats`.

    pos (fb, N, 3) and boxes (fb, 3) float32; inds: the (acceptor, donor,
    donor hydrogen) atom index tensors; res_pair (Na * Nd,) int64: the
    flat (acceptor residue, donor residue) entry of each matrix entry in an
    (n_res, n_res) adjacency. Any bonded atom pair connects two residues
    (a max over repeated entries), both ways, never a residue to itself.

    Returns (sizes (fb, n_res) int32 as `cluster_sizes` gives them, the
    residue pairs bonded over the block, a 0-d int64 tensor left on the
    device so that reading it adds no wait)."""
    fb = pos.shape[0]
    with clock.span("hb_clusters:matrix", device=True):
        hb = general_hbonds(*(pos[:, i] for i in inds), boxes, dist_cut, ang_cut)
        adj = torch.zeros((fb, n_res * n_res), dtype=torch.int32, device=pos.device)
        adj.scatter_reduce_(1, res_pair.expand(fb, -1), hb.reshape(fb, -1).to(torch.int32),
                            "amax")
        adj = adj.reshape(fb, n_res, n_res) > 0
        adj = adj | adj.transpose(1, 2)
        adj.diagonal(dim1=1, dim2=2).fill_(False)
    with clock.span("hb_clusters:components", device=True):
        labels, sweeps = _propagate(adj)
        sizes = _sizes_of(labels)
    clock.count("hb_clusters:frames", fb)
    clock.count("hb_clusters:sweeps", sweeps)
    return sizes, adj.sum() // 2


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
