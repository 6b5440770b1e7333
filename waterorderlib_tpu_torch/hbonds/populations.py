"""Hydration-shell population decomposition (bound / wrap / shell /
non-shell), port of waterorderlib_tpu.hbonds.populations, batched over
frames.

As the reference's `getBoundWrap` (orderParam_lib.py:419-572):
- **shell**  = waters whose oxygen lies within (0, cutoff] of any solute
               heavy atom;
- **bound**  = shell waters H-bonded to the solute, accepting from a solute
               O-H donor or donating to a solute O acceptor -- the reference
               computes but never uses the solute *N* triplets here, so
               neither does the port;
- **wrap**   = shell minus bound;
- **non-shell** = all other waters.

Populations are boolean masks over the water-oxygen axis for all waters at
once; an H-bond needs a heavy-heavy distance below hbDist < cutoff, so this
equals the reference's search over shell waters only. The two any-bond tests
need only counts: `counts` is `ops.cuda.hbond.hbond_counts` (the kernel on
the card, its plain version on the CPU) or the arccos form
`hbonds.bonds.general_hbond_counts`, which agree away from the measure-zero
angle boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from waterorderlib_tpu_torch.ops import pairs
from waterorderlib_tpu_torch.ops.cuda import hbond

PAIR_BUDGET = 1 << 22  # (frame, solute atom, water) triples per block of the shell test


class BoundWrap(NamedTuple):
    shell: torch.Tensor      # (F, Nw) water in hydration shell
    bound: torch.Tensor      # (F, Nw) shell water H-bonded to solute
    wrap: torch.Tensor       # (F, Nw) shell water not H-bonded to solute
    non_shell: torch.Tensor  # (F, Nw)


def _shell_mask(sol_pos, wat_o_pos, boxes, cutoff):
    """(F, Nw) bool: any solute heavy atom within (0, cutoff] of the water
    oxygen, `pairs.neighbor_mask` in frame blocks."""
    F, ns, nw = sol_pos.shape[0], sol_pos.shape[1], wat_o_pos.shape[1]
    fb = max(1, PAIR_BUDGET // max(1, ns * nw))
    return torch.cat([
        pairs.neighbor_mask(sol_pos[f0 : f0 + fb], wat_o_pos[f0 : f0 + fb],
                            boxes[f0 : f0 + fb, None, None, :], 0.0, cutoff).any(dim=1)
        for f0 in range(0, F, fb)
    ]) if F else torch.zeros((0, nw), dtype=torch.bool, device=wat_o_pos.device)


def bound_wrap_masks(
    wat_o_pos: torch.Tensor,       # (F, Nw, 3) water oxygen positions
    wat_donh_pos: torch.Tensor,    # (F, 2 Nw, 3) water hydrogens (2 per O, O-major)
    sol_pos: torch.Tensor,         # (F, Nsol, 3) solute heavy atoms
    sol_acc_o_pos: torch.Tensor,   # (F, NaccO, 3) solute O acceptors
    sol_don_o_pos: torch.Tensor,   # (F, NdonO, 3) solute O donors (one per H)
    sol_donh_o_pos: torch.Tensor,  # (F, NdonO, 3) solute donor hydrogens
    boxes: torch.Tensor,           # (F, 3)
    cutoff: float = 4.0,
    hb_dist: float = 3.0,
    hb_ang: float = 150.0,
    counts=hbond.hbond_counts,
) -> BoundWrap:
    F, nw = wat_o_pos.shape[:2]
    shell = _shell_mask(sol_pos, wat_o_pos, boxes, cutoff)
    # water accepts from solute O-H donors
    acc_any = counts(wat_o_pos, sol_don_o_pos, sol_donh_o_pos, boxes, hb_dist, hb_ang)[0] > 0
    # water donates to solute O acceptors; water donors = each O twice
    wat_don_pos = torch.repeat_interleave(wat_o_pos, 2, dim=1)
    don_cnt = counts(sol_acc_o_pos, wat_don_pos, wat_donh_pos, boxes, hb_dist, hb_ang)[1]
    don_any = (don_cnt.reshape(F, nw, 2) > 0).any(dim=-1)
    bound = shell & (acc_any | don_any)
    return BoundWrap(shell, bound, shell & ~bound, ~shell)

