"""`roofline.angles`: share of the 3-body angles dispatch
(`neighbor_pair_angles_certified`: slab prep, the angles kernel, unsort)
in its roofline.

Work of one call of F frames of N centers, from the definition of the
3-body angles (reference/three_body.py), never from the program's layout:
- operations: for each center, one squared distance (DSQ_FLOPS) to each
  neighbor in (low, high] (the full shell count is an answer); for each
  of its K = 16 nearest, NORM_EPILOGUE to make the unit vector (a square
  root, a reciprocal, three products: 5); for each pair of those,
  PAIR_EPILOGUE: the dot product of the unit vectors (three products, two
  sums: 5), the arccos polynomial (A&S 4.4.46: the absolute value, seven
  Horner steps of a product and a sum, 1 - |x|, the square root, the
  product, and the reflection for x < 0: 19) and the conversion to
  degrees (1): 25;
- bytes: the centers' coordinates (12 B) and shell count (4 B) per center,
  4 B per valid angle, and each frame's box (12 B). The program's 128-slot
  rows (empty and padding slots too) and its unsort are its own choice and
  are not counted: the share shows them as cost."""

from bench_torch.core.roofline import DSQ_FLOPS, pair_dsq, share

K = 16
NORM_EPILOGUE = 5
PAIR_EPILOGUE = 25


def count(pos, boxes, low: float, high: float) -> tuple[float, float]:
    """(flops, bytes) for centers pos (F, N, 3) and boxes (F, 3)."""
    shell = kept = pairs = 0
    for f in range(pos.shape[0]):
        for _, dsq in pair_dsq(pos[f], boxes[f]):
            c = ((dsq > low * low) & (dsq <= high * high) & (dsq > 0)).sum(-1)
            k = c.clamp(max=K)
            shell += int(c.sum())
            kept += int(k.sum())
            pairs += int((k * (k - 1) // 2).sum())
    frames, n = pos.shape[0], pos.shape[1]
    flops = shell * DSQ_FLOPS + kept * NORM_EPILOGUE + pairs * PAIR_EPILOGUE
    return float(flops), float(frames * (n * 16 + 12) + pairs * 4)


def read(run):
    def one(rec):
        pos, boxes = rec.inputs()
        kw = rec.kwargs
        return count(pos[:, 0::3], boxes, kw.get("low_cut", 0.0), kw.get("high_cut", 3.413))
    return share(run, one)
