"""`roofline.q`: share of the q dispatch (`order_param_q_certified`:
slab prep, the q kernels, stragglers, unsort) in its roofline.

Work of one call of F frames of N centers, from the definition of q:
- operations: each center's four nearest neighbors in (low, high] (fewer
  where it has fewer), one squared distance each, and for each center with
  a neighbor Q_EPILOGUE: four squared norms (20), six dot products (30),
  six cosines' (cos + 1/3)^2 from them (36: product, square root,
  division, sum, square, sum), and the final 1 - 3/8 sum (2);
- bytes: the centers' coordinates (12 B) and q (4 B) per center, and each
  frame's box (12 B)."""

from bench_torch.core.roofline import DSQ_FLOPS, pair_dsq, share

Q_EPILOGUE = 88


def count(pos, boxes, low: float, high: float) -> tuple[float, float]:
    """(flops, bytes) for centers pos (F, N, 3) and boxes (F, 3)."""
    pairs = with_nbr = 0
    for f in range(pos.shape[0]):
        for _, dsq in pair_dsq(pos[f], boxes[f]):
            c = ((dsq > low * low) & (dsq <= high * high) & (dsq > 0)).sum(-1)
            pairs += int(c.clamp(max=4).sum())
            with_nbr += int((c > 0).sum())
    frames, n = pos.shape[0], pos.shape[1]
    return float(pairs * DSQ_FLOPS + with_nbr * Q_EPILOGUE), float(frames * (n * 16 + 12))


def read(run):
    def one(rec):
        pos, boxes = rec.inputs()
        kw = rec.kwargs
        return count(pos[:, 0::3], boxes, kw.get("low_cut", 0.0), kw.get("high_cut", 10.0))
    return share(run, one)
