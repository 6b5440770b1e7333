"""`roofline.lsi_split`: share of the LSI dispatch (`lsi_certified`: slab
prep, the split-shell or K = 24 kernel, unsort) in its roofline. The count
is the same whichever tier serves; the traced run prints the tier.

Work of one call of F frames of N centers, from the definition of the LSI:
- operations: for each center, one squared minimum-image distance to each
  neighbor in (low, high] and each next-shell atom in (high, high + 3.7],
  one raw squared distance to each next-shell atom (the next-shell pick),
  and for each center with an LSI, LSI_EPILOGUE per gap (a square root, a
  difference, and the mean and variance's sums and products);
- bytes: the centers' coordinates (12 B) and the LSI, its validity and its
  count (4 + 1 + 4 B) per center, and each frame's box (12 B)."""

from bench_torch.core.roofline import DSQ_FLOPS, pair_dsq, share

NEXT_SHELL = 3.7
LSI_EPILOGUE = 6


def count(pos, boxes, low: float, high: float) -> tuple[float, float]:
    """(flops, bytes) for centers pos (F, N, 3) and boxes (F, 3)."""
    outer = high + NEXT_SHELL
    flops = 0
    for f in range(pos.shape[0]):
        for _, dsq in pair_dsq(pos[f], boxes[f]):
            near = ((dsq > low * low) & (dsq <= high * high) & (dsq > 0)).sum(-1)
            nxt = ((dsq > high * high) & (dsq <= outer * outer)).sum(-1)
            valid = (near > 1) & (nxt > 0)
            flops += int((near + 2 * nxt).sum()) * DSQ_FLOPS
            flops += int((near * valid).sum()) * LSI_EPILOGUE
    frames, n = pos.shape[0], pos.shape[1]
    return float(flops), float(frames * (n * 21 + 12))


def read(run):
    def one(rec):
        pos, boxes = rec.inputs()
        kw = rec.kwargs
        return count(pos[:, 0::3], boxes, kw.get("low_cut", 0.0), kw.get("high_cut", 3.7))
    return share(run, one)
