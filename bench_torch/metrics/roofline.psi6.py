"""`roofline.psi6`: share of the psi6 dispatch (`psi6_certified`: slab
prep, the psi6 kernel, unsort) in its roofline.

Work of one call of F frames of N centers, from the definition of psi6
(reference/hex.py), never from the program's layout:
- operations: for each center, one squared distance (DSQ_FLOPS) to each
  neighbor in (low, high] (the full shell count is an answer); for each
  of its K = 24 nearest, NORM_EPILOGUE to make the unit vector (a square
  root, a reciprocal, three products: 5); for each pair of those,
  PAIR_EPILOGUE: the dot product of the unit vectors (three products, two
  sums: 5), T6 = cos 6t from c = cos t (c^2, then three products and three
  sums of ((32 c^2 - 48) c^2 + 18) c^2 - 1: 7), U5 and sin 6t (1 - c^2, its
  square root, U5 = ((32 c^2 - 32) c^2 + 6) c in three products and two
  sums, the product with the root: 8) and the two sums into the real and
  imaginary parts (2): 22; for each center with at least two neighbors,
  ROW_EPILOGUE: the mean (two quotients) and the modulus (two products,
  a sum, a square root): 6;
- bytes: the centers' coordinates (12 B), psi6 (4 B) and shell count
  (4 B) per center, and each frame's box (12 B). The program's windows,
  padding and unsort are its own choice and are not counted: the share
  shows them as cost."""

from bench_torch.core.roofline import DSQ_FLOPS, pair_dsq, share
from bench_torch.reference.hex import ends

K = 24
NORM_EPILOGUE = 5
PAIR_EPILOGUE = 22
ROW_EPILOGUE = 6


def count(pos, boxes, low: float, high: float) -> tuple[float, float]:
    """(flops, bytes) for centers pos (F, N, 3) and boxes (F, 3)."""
    shell = kept = pairs = rows = 0
    for f in range(pos.shape[0]):
        for _, dsq in pair_dsq(pos[f], boxes[f]):
            c = ((dsq > low * low) & (dsq <= high * high) & (dsq > 0)).sum(-1)
            k = c.clamp(max=K)
            shell += int(c.sum())
            kept += int(k.sum())
            pairs += int((k * (k - 1) // 2).sum())
            rows += int((c > 1).sum())
    frames, n = pos.shape[0], pos.shape[1]
    flops = (shell * DSQ_FLOPS + kept * NORM_EPILOGUE + pairs * PAIR_EPILOGUE
             + rows * ROW_EPILOGUE)
    return float(flops), float(frames * (n * 20 + 12))


def read(run):
    def one(rec):
        pos, boxes = rec.inputs()
        kw = rec.kwargs
        return count(ends(pos), boxes, kw.get("low_cut", 0.0), kw.get("high_cut", 7.0))
    return share(run, one)
