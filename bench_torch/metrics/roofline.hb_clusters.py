"""`roofline.hb_clusters`: share of the H-bond cluster dispatch
(`hb_cluster_block`: the H-bond matrix, the residue adjacency, its
components and cluster sizes) in its roofline.

Work of one call of F frames of n waters, each water one residue, from
the definition (reference/hb_clusters.py), never from the program's
layout, counted as `roofline.hbond` counts a bond:
- operations: one squared distance for each acceptor-donor oxygen pair
  within the cut (a donor's two hydrogens share it), for each (acceptor,
  hydrogen) of such a pair the angle test (ANGLE_FLOPS: A - H, its squared
  norm, its dot product with the unit D - H, a square root and a
  product), and each hydrogen's unit D - H once a frame (UNIT_FLOPS); the
  components' union of bonded pairs is not counted, so the count is a
  floor;
- bytes: every O and H coordinate read once (12 B an atom), the residue
  adjacency (n x n, a byte an entry) written once and read once, each
  residue's cluster size written once (4 B), and each frame's box
  (12 B)."""

from bench_torch.core.roofline import DSQ_FLOPS, pair_dsq, share

ANGLE_FLOPS = 15
UNIT_FLOPS = 12


def count(pos, boxes, dist_cut: float) -> tuple[float, float]:
    """(flops, bytes) for waters pos (F, 3 n, 3) (O, H1, H2 each) and
    boxes (F, 3)."""
    frames, n = pos.shape[0], pos.shape[1] // 3
    within = 0
    for f in range(frames):
        for _, dsq in pair_dsq(pos[f, 0::3], boxes[f]):
            within += int(((dsq > 1e-2) & (dsq <= dist_cut * dist_cut)).sum())
    flops = within * DSQ_FLOPS + 2 * within * ANGLE_FLOPS + frames * 2 * n * UNIT_FLOPS
    return float(flops), float(frames * (3 * n * 12 + 2 * n * n + n * 4 + 12))


def read(run):
    def one(rec):
        pos, boxes = rec.inputs()
        return count(pos, boxes, rec.kwargs.get("dist_cut", 3.0))
    return share(run, one)
