"""`roofline.hbond`: share of the water-water H-bond dispatch
(`hbond_counts_certified`: the dense or slab kernel and its prep) in its
roofline.

Work of one call of F frames of n waters, from the definition of an
H-bond (acceptor O, donor O, hydrogen H: D - A in (0.1, cut], angle
between A - H and D - H at least ang_cut):
- operations: one squared distance for each acceptor-donor oxygen pair
  within the cut (a donor's two hydrogens share it), for each (acceptor,
  hydrogen) of such a pair the angle test (ANGLE_FLOPS: A - H, its squared
  norm, its dot product with the unit D - H, a square root and a
  product), and each hydrogen's unit D - H once a frame (UNIT_FLOPS);
- bytes: every O and H coordinate read once (12 B an atom), the counts of
  each acceptor and each donor hydrogen written once (4 B each), and each
  frame's box (12 B)."""

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
    return float(flops), float(frames * (3 * n * 12 + 3 * n * 4 + 12))


def read(run):
    def one(rec):
        pos, boxes = rec.inputs()
        return count(pos, boxes, rec.kwargs.get("dist_cut", 3.5))
    return share(run, one)
