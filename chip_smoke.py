#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
1. the card's name and power limit, and the build of every CUDA kernel on
   the paths from the sources in this checkout (one nvcc per source, all
   started together), with ptxas's register and spill report;
2. each kernel against its plain PyTorch version on the card at the main
   paths' shapes (a 4096-water jittered lattice, 8 frames): q_tet in the
   slab form, the brute form, with a third of the stored atoms shifted by
   +/-L, on pairs planted at exactly the 4.5 A margin (the lists' filter)
   and the 10 A shell edge with a coincident pair, on windows of 20
   columns (two outside the columns) and on a sparse 512-atom box whose
   every row is scanned again -- each in both forms of qtet_window.cu (as
   given, and with its frames repeated up to the row form's 65,536 rows) --
   the straggler patch, and the sparse box, which must take the brute tier;
   the 3-body angles and psi6 in the slab
   and brute forms; both LSI kernels in the slab and brute forms on the
   lattice with a third of its atoms stored shifted by +/-L (so raw and
   imaged distances differ) and on pairs planted at exactly high and high
   + 3.7 A (float32 offsets whose squares are those bounds exactly), a
   coincident pair and an annulus tie in raw distance; the split kernel on
   narrow windows sticking out of its wide ones at either end, windows
   apart and touching, windows of 20 columns and a wide window outside the
   columns; both on a 16^3 lattice of
   spacing 3 A (distances tie exactly) in both forms, the K=24 kernel on
   windows of 20
   columns, two of them outside the columns (NaN rows), and a 16-member
   cluster in one shell of a 16,384-water box (the split kernel equal to
   its plain version on it), where `lsi_certified` must keep the split
   tier, redo the incomplete rows through the split kernel's escalation
   form and run no K=24 kernel, its result equal to its plain versions'
   on the CPU (without the cluster no row of that box is incomplete);
   both H-bond kernels on 4096 waters x 8 frames
   of `make_water_box` (water-water, the JAX package's asymmetric 37-donor
   sets, a third of the stored atoms shifted by +/-L, and pairs planted at
   exactly the cut and at exactly half a box edge in x, y and z, also in a
   6 x 7 x 6.5 A box and its NPT copy where half an edge lies within the
   cut), the slab kernel also against the dense one and, at w = 512,
   failing `covered`; counts exactly equal;
3. the q_tet slice: `tet_order_calc` on a 4096-water, 1024-frame box with
   one sub-population, device="cuda"; it must take the slab tier, launch
   the kernel and never call the plain version; its q on 16 frames must
   match the plain PyTorch q path;
4. the 3-body slice: `three_body_calc` on the same box (output_2d=True) and
   the psi6 slice: `hex_order_calc` on its 2048 chain-end centers, with the
   same assertions; their angles and psi on 16 frames must match the plain
   paths `order.angles.neighbor_angles` and `order.psi6.order_param_psi`;
   the LSI slice: `lsi_calc` on the same box, which must take the K=24 slab
   tier with one `lsi_window` launch, its valid flags on 16 frames equal to
   and its values within 2e-5 of the plain path `order.lsi.lsi`; then one
   more call of each of the four drivers under the drivers' stage clock
   (`orderparams.stage_times`: host gather, H2D, masks, kernel stage,
   device stats, D2H, savetxt, bootstrap); and the split tier through the
   driver: `lsi_calc` at its default high_cut 3.7 A on 16,384 waters x 64
   frames whose oxygens sit on `_split_traj`'s lattice (six neighbors
   within 3.7 A on average, at most 9) must take "slab-split" and launch
   `lsi_split_window`, then one more call of it under the stage clock;
   the H-bond slice: `hb_calc` on 4096 waters and a
   solute whose nine acceptor x donor sets are non-empty x 1024 frames (the
   dense tier; its per-water totals on 16 frames equal the arccos form
   `bonds.general_hbond_counts` on the card), `get_bound_wrap` on it (masks
   equal the plain masks with the arccos form on 16 frames) and `hb_calc`
   at 16,384 waters x 64 frames (the slab tier), plus a warm `hb_calc`
   under the stage clock;
5. each kernel's time per frame at its slice's own launch (F=1024; the
   split kernel at 16,384 waters, F=64; `hbond_slab` at 16,384 x 64 and,
   for the crossover, at 4096 x 1024) and its plain version's on a few
   frames of it, with its share of the bound (the q, split LSI, H-bond and
   K=24 LSI kernels' device time alone, from torch.profiler, comes after
   the last phase from `python3 chip_smoke.py --alone q` and `--alone hb`,
   each a process of its own, as `[alone]` lines; the Voronoi window
   search's at its four launches from `--alone vor`);
6. 131,072 and 1,048,576 atoms, 1 frame: each certified dispatch must take
   the slab tier (LSI at high_cut 3.7 A: "slab-split" at 131,072 atoms of
   `_split_traj`'s lattice, the K=24 "slab" on `_lattice_traj`'s, whose
   12-13-neighbor rows fail the split certificate, and at 1,048,576), and
   each kernel must equal its plain
   version on two row tiles passed as the rows and window starts of those
   tiles only; H-bonds at 131,072 and 349,525 waters (1,048,575 atoms), 1
   frame: the certified dispatch takes the slab tier, the slab kernel
   equals the dense kernel on every acceptor and donor, and each equals its
   plain version on two acceptor tiles;
7. the interface slice: `density_grid` at its defaults (80^3 grid points)
   on 4096 waters and a 6-atom solute, the box's z edge doubled (a liquid
   slab under vapour; fixture A), must take the x tier with one
   `willard_grid` launch and a mesh of more than 1000 faces, and with
   window_x=8 the certificate fails and one `willard_points` launch
   serves; fixture A's field equals `fields.willard_density_field` (the
   points kernel); the grid kernel in its x, plane and brute forms and the
   points kernel against their plain versions on the whole grid; their
   times, with bounds whose expf and division costs are read from the SASS
   of a probe; fixture B, 32,768
   waters, must take a grid tier and equal the points kernel on three
   planes; a warm `density_grid` under the stage clock;
8. the SASA slice: `sasa_per_atom` on bench.py's 4096-atom lattice with
   1000 points and radii 1.5 + 1.4 A, with the box and with box=None, must
   take the pruned tier with one `sasa_topk` launch and no plain call; both
   occlusion kernels equal their plain versions and the brute tier the
   pruned one, exactly; 130 atoms around atom 0 fail the certificate and
   the brute tier serves (one launch of each kernel); a coincident pair is
   left out by the pruned tier and counted by the brute tier; times,
   bounds, a warm `sasa_per_atom` under the stage clock; `sasa_calc` and
   `sphere_volumes` on the card equal the port's CPU run;
9. the earlier q kernels at 4096 waters: `order_param_q_dense` (one
   `qtet_window_hist` launch; q equal to the brute `q_window` form, the
   fused histogram to its plain version, in both forms), the dense q over
   1024 frames, and the v1 slab q (per-frame z-sort, its per-frame window
   starts against the plain version on 8 frames, in both forms; frame-0
   sort) over 1024 frames, equal to the brute q wherever ok and covered but
   at exact 4th/5th-neighbor ties, whose frames the kernel then takes in
   the brute form equal to its plain version (the lower column of a tie);
10. the Voronoi volumes slice (`_voronoi_phases`): both forms of
   `voronoi_topk.cu` equal to their plain versions (dist and payload) at
   12,294 points (the window form with `_suggest_win`'s window, its full
   scan at k 256 on 64 rows and on rows at both ends of the z-sorted array,
   the cell-grid form at k 64), on a 2,048-row subset at k 96, 128 and 192
   (the escalation grids), at 2,048 waters on the pruned mirror set, and on
   planted ties: within a window, at the k-th distance on both sides of a
   full scan's row (k 96 and 256), across cells; the window form at every
   split (1, 2, 4 and 8 warps a row), the cell-grid form in both its
   mappings (rows grouped by cell, one warp a row) wherever both fit;
   `voronoi_calc(engine=
   "device")` on `make_water_box(12288, 32 frames, 6-atom solute)` in two
   chunks of 16 (tier 1 on the cell-grid form; the certified count of each
   tier and the host closes printed; the cell kernel, in dedup "always",
   launched once a chunk at each tier up to (64, 128) on its real rows,
   `kernel_rows`: the kernels line's launches), frames 0-1 against Qhull in float64
   (every cell within 1.5e-3) and the host engine, `chunk_frames=1` equal
   to one chunk; `voronoi_calc` at 2,048 waters x 16 frames (tier 1 on
   the window form); each form's time at its main-path launch beside its
   bound, its plain version and `torch.topk` at the launch's k on the same
   distances, and its kernels' own device time (torch.profiler); the
   cell-grid form also at each escalation tier's real launch in a 16-frame
   chunk (the rows that reach the tier, its grid and k; equal to the plain
   version in both mappings); the window form at its four launches
   captured from `voronoi_volumes_hybrid_frames` (the last tier's full scan
   of a 16-frame chunk at 12,294 points; tier 1 and the (48, 96) and (64,
   128) full scans at 2,048 waters x 16 frames), each equal to its plain
   version at every split, its bound counted from the lanes the data needs
   (fl(dz*dz) within the row's k-th dsq) beside the lanes the kernel
   tested and its windows' lanes; a warm `voronoi_calc` on the stage clock;
11. the fused cell kernel and the Voronoi contacts slice
   (`_voronoi_cells_phases`, `_voronoi_contacts_phases`):
   `voronoi_cells.cu` against its plain version (flags and face vertex
   counts equal, moments within 1e-6 relative) at tier 1 of a 16-frame
   chunk of 12,294 points (196,608 rows at (32, 64), cell-grid
   candidates), on a 2,048-row subset at (40, 96), on the 6^3 cubic lattice
   (the tangency test dedups the interior rows; every cell certified at
   a^3) and with dedup "always" (the plain version is the clip builder);
   its dedup "auto" time beside its bound and plain version at tier 1 and
   (40, 96) (the kernel's own device time there), and 256 of those rows scaled by 2^-20
   (the kernel's exact-division path); tier-1 cells certified by
   both builders within 1e-5 but where the clip builder's dedup merged a
   small face (named, both within 1.5e-3 of the host cell in float64);
   the clip builder on the kernel: every launch of the chunk's
   `voronoi_volumes_hybrid_frames` (tier 1, (48, 96), (64, 128)) in dedup
   "always" equal to the PyTorch clip builder on every key (torch.equal),
   with both times (tier 1's, with the kernel's own device time and its
   bound, are the kernels line's);
   `voronoi_volumes_hybrid_frames` on the chunk under cell_impl "pallas"
   (the fused rule at tier 1) and "clip", the kernel launched once at each
   tier up to (64, 128) on its real rows (`kernel_rows`), against each
   other and Qhull, and a warm call of each on the stage clock; one more
   warm "clip" call under torch.profiler: device time by kernel name and
   the card's busy share;
   `voronoi_contacts_hybrid_frames` at 12,294 points x 16
   frames x rows 0-511 under both, against each other, frames 0-1 against
   the host Qhull contacts in float64 (entries within 5e-2, or once the
   doubling quirk's factor is undone, on at most 1% of the nonzero ones)
   and frames 0 and 1 alone against the batch; `contact_area_calc` and
   `hydrated_volume_calc` (engine "device") at 12,288 waters + 24 solute
   atoms x 16 frames, their solute rows and means on frames 0-1 against
   the host engine (solute atoms stored outside the box are mirrored
   otherwise by the host engine: named, and held to their own float64
   cells), and a warm call of each on the stage clock.
scipy.spatial is imported right after the build (the Voronoi host close
needs it). Near the end, a line says whether scipy imports on this
machine, and one sums up ptxas's registers and spills.

The last line is one JSON object, {"ok": true, "device": {...}}; before it
come a JSON line of the kernels (launches in their slice, largest error
against the plain version (for the occlusion kernels a count of points),
times per frame (the Willard, SASA and Voronoi kernels and
`qtet_window_hist`: per call) of the kernel, the plain version and the
bound, "bound_by"; "library_ms" is `torch.topk` on the same distances for
the Voronoi search, null elsewhere: no single PyTorch call computes the
other functions, the fused Voronoi cells included), and
the card's name and power limit. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero and
prints no result. Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_WATERS = 4096
N_FRAMES_CMP = 8
N_FRAMES_SLICE = 1024
N_FRAMES_PLAIN = 64
LARGE_SIZES = (131_072, 1_048_576)
Q_TOL = 1e-5    # float32 q; kernel and plain version do the same operations
ANG_TOL = 1e-4  # degrees
PSI_TOL = 1e-5
LSI_TOL = 1e-6  # A^2, kernel against plain version (the same operations)
LSI_REF_TOL = 2e-5  # against order.lsi.lsi, the JAX package's own bound
N_SPLIT = 16_384  # waters: the JAX package's split-shell LSI tier
N_FRAMES_SPLIT = 64
N_FRAMES_SPLIT_PLAIN = 4
# peaks of one H100 SXM (NVIDIA's data sheet, at a 700 W power limit):
# float32 outside the tensor cores, and HBM3
PEAK_FP32 = 67e12  # FLOP/s
PEAK_HBM = 3.35e12  # bytes/s
# float32 operations each kernel must do: per distinct (row, column) pair
# of its windows -- 3 subtracts, 6 minimum-image adds, a squared length (5);
# the split kernel's two windows count as their union -- and per row in
# its epilogue: per neighbor slot 19 (displacement, length, sqrt, 1/x,
# scaling), per neighbor pair 10 (q), 26 (angle: cosine, clip, arccos
# polynomial, degrees) or 24 (psi6: cosine, clip, T6, sqrt, U5, sums); LSI:
# per slot 9 (sqrt; the K=24 kernel's raw squared distance from the column:
# 3 subtracts, 5 for the length) and per gap 6 (difference, sum; difference,
# mean, square, sum), plus 4 (final gap, mean, variance); the split kernel
# has 13 slots, no raw distance in its epilogue, and 8 per annulus
# candidate of its wide pass for the raw distance (RAW_FLOPS)
PAIR_FLOPS = 14
RAW_FLOPS = 8
EPILOGUE_FLOPS = {"qtet_window": 4 * 19 + 6 * 10, "qtet_window_hist": 4 * 19 + 6 * 10 + 3,
                  "angles_window": 16 * 19 + 120 * 26,
                  "psi6_window": 24 * 19 + 276 * 24, "lsi_window": 24 * 9 + 23 * 6 + 4,
                  "lsi_split_window": 13 * 1 + 12 * 6 + 4}
SOURCES = {"qtet_window": "waterorderlib_tpu_torch/ops/cuda/csrc/qtet_window.cu",
           "angles_window": "waterorderlib_tpu_torch/ops/cuda/csrc/nbr_window.cu",
           "psi6_window": "waterorderlib_tpu_torch/ops/cuda/csrc/nbr_window.cu",
           "lsi_window": "waterorderlib_tpu_torch/ops/cuda/csrc/lsi_window.cu",
           "lsi_split_window": "waterorderlib_tpu_torch/ops/cuda/csrc/lsi_window.cu",
           "hbond_dense": "waterorderlib_tpu_torch/ops/cuda/csrc/hbond.cu",
           "hbond_slab": "waterorderlib_tpu_torch/ops/cuda/csrc/hbond.cu",
           "willard_grid": "waterorderlib_tpu_torch/ops/cuda/csrc/willard.cu",
           "willard_points": "waterorderlib_tpu_torch/ops/cuda/csrc/willard.cu",
           "qtet_window_hist": "waterorderlib_tpu_torch/ops/cuda/csrc/qtet_window.cu",
           "sasa_topk": "waterorderlib_tpu_torch/ops/cuda/csrc/sasa.cu",
           "sasa_brute": "waterorderlib_tpu_torch/ops/cuda/csrc/sasa.cu",
           "voronoi_window_topk": "waterorderlib_tpu_torch/ops/cuda/csrc/voronoi_topk.cu",
           "voronoi_cellgrid_topk": "waterorderlib_tpu_torch/ops/cuda/csrc/voronoi_topk.cu",
           "voronoi_cells": "waterorderlib_tpu_torch/ops/cuda/csrc/voronoi_cells.cu"}
REPLACES = {"qtet_window": "waterorderlib_tpu/ops/pallas/qtet2.py:111, qtet_kernel.py:286, "
                           "qtet_sorted.py:192, :315",
            "angles_window": "waterorderlib_tpu/ops/pallas/angles_kernel.py:159",
            "psi6_window": "waterorderlib_tpu/ops/pallas/psi6_kernel.py:163",
            "lsi_window": "waterorderlib_tpu/ops/pallas/lsi_kernel.py:177",
            "lsi_split_window": "waterorderlib_tpu/ops/pallas/lsi_slab2.py:235",
            "hbond_dense": "waterorderlib_tpu/ops/pallas/hbond_kernel.py:153",
            "hbond_slab": "waterorderlib_tpu/ops/pallas/hbond_slab.py:193",
            "willard_grid": "waterorderlib_tpu/ops/pallas/willard_grid.py:358, :375",
            "willard_points": "waterorderlib_tpu/ops/pallas/willard_kernel.py:102",
            "qtet_window_hist": "waterorderlib_tpu/ops/pallas/qtet_kernel.py:159",
            "sasa_topk": "waterorderlib_tpu/ops/pallas/sasa_kernel.py:81",
            "sasa_brute": "waterorderlib_tpu/ops/pallas/sasa_kernel.py:81",
            "voronoi_window_topk": "waterorderlib_tpu/ops/pallas/voronoi_topk.py:112",
            "voronoi_cellgrid_topk": "waterorderlib_tpu/ops/pallas/voronoi_topk.py:218",
            "voronoi_cells": "waterorderlib_tpu/ops/pallas/voronoi_cells.py:352"}
# the H-bond slice: hb_calc's default cuts; a solute with one O acceptor,
# one O-H donor, one N acceptor and two N-H donors, so that each of the nine
# acceptor x donor sets is non-empty; the slab tier's size
HB_DIST, HB_ANG = 3.5, 120.0
HB_SOLUTE = ["C", "O", "H", "N", "H", "C"]
N_HB_SLAB = 16_384
N_FRAMES_HB_SLAB = 64
N_FRAMES_HB_PLAIN = 4
N_FRAMES_HB_REF = 16
HB_LARGE = (131_072, 349_525)  # waters; 349,525 x 3 = 1,048,575 atoms
# float32 operations of the H-bond kernels: per visited (acceptor, donor)
# pair 16 -- 3 subtracts, 6 minimum-image adds and 5 for the heavy-heavy
# dsq (PAIR_FLOPS), 2 compares; per pair within the cut (dsq in (1e-2,
# cut^2], the only pairs whose angle the kernels test) 22 more -- 3
# subtracts, 6 minimum-image adds, 5 for |u|^2, 5 for u.vhat, a sqrt, a
# multiply and a compare
HB_PAIR_FLOPS = PAIR_FLOPS + 2
HB_ANGLE_FLOPS = 22
# the interface slice: density_grid's defaults (81 bins: 80^3 grid points,
# smoothlen 2.4, level 0.016) on the JAX bench's 4096 waters with a 6-atom
# solute, the box's z edge doubled (a liquid slab under vapour), and the
# uncapped grid tier's size
WC_SOLUTE = ["C", "C", "O", "C", "C", "O"]
N_WC_LARGE = 32_768
WC_TOL = 1e-6       # kernel against plain version, each output (the same operations)
WC_REF_TOL = 2e-6   # grid tiers against the points kernel: the JAX package's x-tier bound
WC_DOT, WC_DOT_SHARE = 0.98, 0.999  # unit normals: dot > 0.98 on >= 99.9% of points
# float32 operations the Willard fields need, beside EXPF and DIV, the
# instructions nvcc emits for expf and for an IEEE division (counted from
# the SASS in each run, `_sass_ops`); each term charged only to the pairs
# that need it. Grid: per (x-row, atom) of a window 10 (2 subtracts, 4
# minimum-image adds, dx^2 + dz^2, the 9 sigma^2 test); per (x-row, atom)
# whose dx^2 + dz^2 is under 9 sigma^2 2 + EXPF (the x-z exponential: scale,
# x peak); per (point, atom) of those 6 (subtract, 2 minimum-image adds,
# square, add, the test); per pair within 3 sigma 12 + EXPF (scale, the
# product with the x-z exponential, the sum, and negate, multiply, add for
# each gradient sum). Points: per (point, atom) 21 (3 x subtract, x 1/L,
# rint, x L, subtract; |d|^2; test); per pair within 3 sigma 10 + EXPF + DIV
# (negate, divide, x peak, g - shift, add, 3 x multiply-add)
WG_ROW_FLOPS, WG_ROW_NEAR_FLOPS, WG_STRIP_FLOPS, WG_INSIDE_FLOPS = 10, 2, 6, 12
WP_PAIR_FLOPS, WP_INSIDE_FLOPS = 21, 10
# the SASA slice: bench.py's SASA size (4096 atoms of the jittered lattice,
# 1000 points, radii vdW 1.5 + probe 1.4), K = 128 occluder slots; the
# certificate's failure: 130 atoms within 2 max r of atom 0
SASA_VDW, SASA_PROBE, SASA_POINTS, SASA_K = 1.5, 1.4, 1000, 128
SASA_CLUSTER = 130
# float32 operations of the occlusion kernel: per sphere point 6 (3 fmas);
# per (point, occluder) test 8 (3 subtracts, a product, 2 fmas); per
# (atom, occluder) of the brute loader 19 (3 x subtract, x 1/L, rint, x L,
# subtract, add; r_j^2). Tests are counted from this run's data: each point
# against the occluders in order up to its first occluding one, a visible
# point against every occluder that can occlude (`_sasa_tests`)
SASA_POINT_FLOPS, SASA_TEST_FLOPS, SASA_LOAD_FLOPS = 6, 8, 19
N_FRAMES_LEGACY_PLAIN = 8
# the Voronoi slice: the JAX bench's Voronoi size, 12,288 waters and the
# 6-atom solute (12,294 points: the cell-grid form serves tiers 1-4), 32
# frames in voronoi_calc's chunks of 16; 2,048 waters x 16 frames, where
# tier 1 takes the z-window form on the pruned mirror set; the escalation
# tiers' grid checks on a 2,048-row subset, the last tier's full scan on 64
# rows (its main-path launch: 64 rows a frame x 16 frames). Certified cells
# against Qhull in float64 (the JAX package's f32 band) and per-frame means
# against the host engine
VOR_N, VOR_FRAMES, VOR_SMALL, VOR_SMALL_FRAMES = 12_288, 32, 2_048, 16
VOR_SOLUTE = ["C", "C", "O", "C", "C", "O"]
VOR_SUBSET, VOR_LAST_ROWS = 2_048, 64
VOR_REF_TOL, VOR_MEAN_TOL = 1.5e-3, 5e-3
# float32 operations per (row, candidate lane) the search must do: 3
# subtracts, 3 products, 2 adds, the comparison with the k-th distance.
# Lanes counted from the data: a window's candidates whose fl(dz*dz) is
# within the row's k-th dsq (`_vor_window_lanes`); a row's 27 cells'
# members (not their empty slots)
VOR_LANE_FLOPS = 9
# the Voronoi contacts slice: the fused cell kernel against its plain
# version (relative, each moment: the same operations), on tier 1 of a
# 16-frame chunk at 12,294 points, a 2,048-row subset at the wide tier (40,
# 96) and the 6^3 cubic lattice; volumes and contacts under cell_impl
# "pallas" against "clip"; contacts at scripts/perf_round5_tpu.py's
# production shape (512 solute rows x 16 frames); the contact drivers on 24
# solute atoms
VOR_CHUNK = 16  # voronoi_calc's chunk of frames
VOR_CELLS_TOL = 1e-6
VOR_IMPL_TOL = 1e-5  # cells certified by both builders
VOR_CONTACT_ROWS = 512
VOR_CONTACT_TOL = 5e-2  # a contact entry against Qhull, or once the quirk's factor 2 is undone
VOR_CONTACT_SOLUTE = ["C", "C", "O", "C", "N", "C"] * 4
# float32 operations the fused cell kernel must do, counted from its code:
# per candidate 9 (|r|^2, s, |r|, and the thresholds eps |r| and eps s, which
# depend on the plane alone); per pair 64 (line, point, unit direction,
# |q|), per (pair, build plane) 22 (two dot products, the pair's thresholds
# from the plane's, the division, the interval), per pair 26 after the clip
# (endpoints, their lengths, r_cell); per (edge, check plane) 21; per (face,
# slot) 70 (edge test, orientation, the triangle's vector area, the sums);
# per comparison of two valid edges of a face 9 (the dedup's first endpoint
# test). Counted from the data: the edges (half a row's face vertex
# counts) and the dedup's comparisons, C(n, 2) over each face's n kept edges
# on the boundary rows (the tangent rows and the dropped edges not counted)
CELL_CAND_FLOPS, CELL_PAIR_FLOPS, CELL_PLANE_FLOPS, CELL_POST_FLOPS = 9, 64, 22, 26
CELL_CHECK_FLOPS, CELL_SLOT_FLOPS, CELL_DEDUP_FLOPS = 21, 70, 9


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _lattice_traj(n, f, seed, shifted=False):
    """bench.py-style jittered lattice at water density: (f, n, 3) f32.
    With `shifted`, a third of the atoms of each frame are stored shifted by
    +/-L along random axes (the same wrapped frame; other raw distances)."""
    import numpy as np
    from waterorderlib_tpu_torch.io.synthetic import water_oxygen_lattice

    box_len = (n / 0.033456) ** (1.0 / 3.0)
    rs = np.random.RandomState(seed)
    base = water_oxygen_lattice(n, box_len, seed=seed)
    pos = np.stack(
        [np.mod(base + rs.normal(scale=0.1, size=base.shape), box_len) for _ in range(f)]
    ).astype(np.float32)
    if shifted:
        some = rs.uniform(size=pos.shape[:2]) < 1.0 / 3.0
        pos = pos + rs.randint(-1, 2, size=pos.shape) * some[..., None] * np.float32(box_len)
        pos = pos.astype(np.float32)
    boxes = np.tile(np.array([box_len] * 3, np.float32), (f, 1))
    return pos, boxes


def _ms(fn, args, iters):
    import torch

    fn(*args)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _split_traj(n, f, seed):
    """(f, n, 3) f32 positions and (f, 3) boxes of the split-tier checks:
    a cubic lattice at water density whose z rises by one spacing across x
    (still periodic), jittered by 0.1 spacings and 0.1 A more per frame. Six
    neighbors lie within 3.7 A on average and never more than 9, so the
    split kernel's 12 in-shell slots hold every shell (`_lattice_traj`'s
    0.35-spacing jitter puts 12-13 in some). The rise keeps the lattice's z
    layers from lining up with the row tiles' z-slabs, which then hold up
    to four layers where the windows are sized for the mean density."""
    import numpy as np

    box_len = (n / 0.033456) ** (1.0 / 3.0)
    m = int(np.ceil(n ** (1.0 / 3.0)))
    spacing = box_len / m
    rs = np.random.RandomState(seed)
    i, j, k = np.meshgrid(*(np.arange(m),) * 3, indexing="ij")
    sites = np.stack([i, j, k + i / m], -1).reshape(-1, 3) * spacing
    base = sites[rs.permutation(len(sites))[:n]] + rs.uniform(-0.1, 0.1, (n, 3)) * spacing
    pos = np.stack([np.mod(base + rs.normal(scale=0.1, size=base.shape), box_len)
                    for _ in range(f)]).astype(np.float32)
    return pos, np.full((f, 3), box_len, np.float32)


def _bytes_in(rows, cols):
    """Bytes of rows and columns, rows counted only where they are not a
    view into the columns."""
    n = 4 * cols.numel()
    if rows.data_ptr() < cols.data_ptr() or rows.data_ptr() >= cols.data_ptr() + 4 * cols.numel():
        n += 4 * rows.numel()
    return n


def _pairs(args, split):
    """(row, column) pairs whose distance a launch needs: each row against
    its tile's window; for the split kernel against the union of its narrow
    and wide windows, each distinct pair once."""
    import torch

    rows, _, starts, _, w, rt = args[:6]
    F, _, n_rows = rows.shape
    tile_rows = (n_rows - torch.arange(starts.numel(), device=starts.device) * rt).clamp(max=rt)
    width = torch.full_like(tile_rows, w)
    if split:
        s_n, s_w, w_w = starts.long(), args[8].long(), args[9]
        overlap = (torch.minimum(s_n + w, s_w + w_w) - torch.maximum(s_n, s_w)).clamp(min=0)
        width = w + w_w - overlap
    return F * int((tile_rows * width).sum())


def _bound_ms(name, args, out_bytes_per_row, annulus=0):
    """Least time of one launch on these inputs: the larger of its float32
    operations over the peak rate and its bytes (each input read once, each
    output written once) over the memory rate. `annulus`: the split LSI
    kernel's (high, high+3.7] candidates over all rows and frames, which
    also take a raw distance. Returns (ms, bound_by)."""
    rows, cols, starts, boxes = args[:4]
    F, _, n_rows = rows.shape
    split = name == "lsi_split_window"
    in_bytes = _bytes_in(rows, cols) + 4 * (starts.numel() + boxes.numel())
    if name.startswith("lsi"):
        in_bytes += _bytes_in(args[6], args[7])  # the raw rows and columns
    if split:
        in_bytes += 4 * args[8].numel()
    flops = (_pairs(args, split) * PAIR_FLOPS + F * n_rows * EPILOGUE_FLOPS[name]
             + annulus * RAW_FLOPS)
    t_ops = flops / PEAK_FP32 * 1e3
    t_bytes = (in_bytes + F * n_rows * out_bytes_per_row) / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _cmp(name, kernel, plain, args, tols):
    """Kernel vs plain version on the same inputs: every output within its
    tolerance (0 means exactly equal). Returns the largest float error."""
    import torch

    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    errs = [0.0]
    for g, w, tol in zip(got, want, tols):
        if g.dtype.is_floating_point:
            _check(bool(torch.isfinite(g).all()), f"{name}: kernel output not finite")
            err = float((g - w).abs().max()) if g.numel() else 0.0
            errs.append(err)
            _check(err <= tol, f"{name}: max|d| {err} > {tol}")
        else:
            mism = int((g != w).sum())
            _check(mism == 0, f"{name}: {mism} mismatches in an exact output")
    print(f"[kernel] {kernel.__name__} {name}: max|d|={max(errs):.3e}, exact outputs equal",
          flush=True)
    return max(errs)


def _two_tiles(args, n_tiles, n, rt, cut_at):
    """A launch of the first and the last row tile only (the boundary
    tiles, whose windows reach into the pad copies): `args` with the rows
    (and raw rows) at positions `cut_at[0]` cut to those tiles' rows and
    the window starts at `cut_at[1]` cut to those two tiles. Returns (the
    arguments, the tiles' rows as indices into the full rows)."""
    import torch

    rows_at, starts_at = cut_at
    last = n_tiles - 1
    dev = args[0].device
    sel = torch.cat([torch.arange(0, rt), torch.arange(last * rt, min(n, (last + 1) * rt))]).to(dev)
    tiles = torch.tensor([0, last], device=dev)
    sub = list(args)
    for i in rows_at:
        sub[i] = args[i][:, :, sel].contiguous()
    for i in starts_at:
        sub[i] = args[i][tiles].contiguous()
    return tuple(sub), sel


def _slab_args(pos, boxes, margin, rt, high, qtet):
    """(prep, n, pad, kernel arguments) of a slab-form launch, as the
    certified dispatch plans it."""
    from waterorderlib_tpu_torch.ops.cuda import slab

    n = pos.shape[1]
    window, pad = slab.plan(n, float(boxes[0, 2]), margin, rt)
    prep = slab.slab_prep_traj(pos, boxes, ((margin, window),), rt, pad)
    _check(bool(prep.covered[0].all()), f"slab prep not covered (n={n}, margin={margin})")
    args = (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], boxes, prep.ws[0], rt,
            0.0, high * high)
    return prep, n, pad, args + ((margin * margin,) if qtet else ())


def _brute_args(pos, boxes, rt, high, qtet):
    import torch
    from waterorderlib_tpu_torch.ops.cuda import slab

    n = pos.shape[1]
    ext = slab.brute_cols(pos, boxes)
    starts = torch.zeros(-(-n // rt), dtype=torch.int32, device=pos.device)
    return (ext, ext, starts, boxes, n, rt, 0.0, high * high) + ((high * high,) if qtet else ())


LSI_HIGH, LSI_OUTER = 3.7, 3.7 + 3.7
LSI_SCALARS = (0.0, LSI_HIGH, LSI_OUTER * LSI_OUTER)
SPLIT_SCALARS = (0.0, LSI_HIGH, LSI_HIGH * LSI_HIGH, LSI_OUTER * LSI_OUTER)


def _lsi_slab_args(pos, boxes):
    """(prep, pad, raw, lsi_window arguments) of the K=24 kernel's slab
    form, as `lsi_certified` plans it."""
    from waterorderlib_tpu_torch.ops.cuda import slab

    n = pos.shape[1]
    window, pad = slab.plan(n, float(boxes[0, 2]), LSI_OUTER, 128)
    prep = slab.slab_prep_traj(pos, boxes, ((LSI_OUTER, window),), 128, pad)
    _check(bool(prep.covered[0].all()), f"LSI slab prep not covered (n={n})")
    raw = slab.raw_ext_t(pos, prep.order0, pad)
    return prep, pad, raw, (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], boxes,
                            prep.ws[0], 128, raw[:, :, pad : pad + n], raw, *LSI_SCALARS)


def _lsi_split_args(pos, boxes):
    """(prep, pad, raw, lsi_split_window arguments) of the split kernel's
    narrow and wide windows, as `lsi_certified` plans them."""
    from waterorderlib_tpu_torch.ops.cuda import slab

    n, box_z = pos.shape[1], float(boxes[0, 2])
    window, pad = slab.plan(n, box_z, LSI_OUTER, 128)
    w_narrow = slab.suggest_window(n, box_z, margin=LSI_HIGH, row_tile=128)
    prep = slab.slab_prep_traj(pos, boxes, ((LSI_HIGH, w_narrow), (LSI_OUTER, window)), 128, pad)
    _check(all(bool(c.all()) for c in prep.covered), f"LSI split prep not covered (n={n})")
    raw = slab.raw_ext_t(pos, prep.order0, pad)
    return prep, pad, raw, (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], boxes,
                            prep.ws[0], 128, raw[:, :, pad : pad + n], raw, prep.starts[1],
                            prep.ws[1], *SPLIT_SCALARS)


def _lsi_brute_args(pos, boxes, split):
    import torch
    from waterorderlib_tpu_torch.ops.cuda import slab

    n = pos.shape[1]
    ext, raw = slab.brute_cols(pos, boxes), slab.brute_raw(pos)
    starts = torch.zeros(-(-n // 128), dtype=torch.int32, device=pos.device)
    if split:
        return (ext, ext, starts, boxes, n, 128, raw, raw, starts, n, *SPLIT_SCALARS)
    return (ext, ext, starts, boxes, n, 128, raw, raw, *LSI_SCALARS)


def _annulus(pos, boxes):
    """(high, high+3.7] neighbors over all rows and frames: the candidates
    of the split kernel's raw-distance pass."""
    from waterorderlib_tpu_torch.ops import pairs

    return sum(int(pairs.neighbor_counts(p, p, b, LSI_HIGH, LSI_OUTER, row_block=64).sum())
               for p, b in zip(pos, boxes))


# arguments of each kernel that carry a leading frame axis
FRAME_ARGS = {"qtet_window": (0, 1, 3), "angles_window": (0, 1, 3), "psi6_window": (0, 1, 3),
              "lsi_window": (0, 1, 3, 6, 7), "lsi_split_window": (0, 1, 3, 6, 7)}


def _first_frames(name, args, nf):
    return tuple(a[:nf] if i in FRAME_ARGS[name] else a for i, a in enumerate(args))


def _hb_water_sets(pos, n):
    """Water-water H-bond sets of frames whose first 3n atoms are n waters
    laid out O, H1, H2: acceptors the oxygens (F, n, 3), donors each oxygen
    twice and donor hydrogens the H's (F, 2n, 3)."""
    import torch

    f = pos.shape[0]
    acc = pos[:, 0 : 3 * n : 3]
    return (acc, torch.repeat_interleave(acc, 2, dim=1),
            pos[:, : 3 * n].reshape(f, n, 3, 3)[:, :, 1:].reshape(f, 2 * n, 3))


def _hb_water_frames(n, f, seed):
    """(f, 3n, 3) f32 frames of n rigid waters (O, H1, H2; O-H 0.9572 A, HOH
    104.52 degrees, random orientations) on the jittered lattice at water
    density, and (f, 3) boxes; index arrays follow from the layout."""
    import numpy as np
    from waterorderlib_tpu_torch.io.synthetic import water_oxygen_lattice

    box_len = (n / 0.033456) ** (1.0 / 3.0)
    rs = np.random.RandomState(seed)
    base = water_oxygen_lattice(n, box_len, seed=seed)
    frames = []
    for _ in range(f):
        o = np.mod(base + rs.normal(scale=0.08, size=base.shape), box_len)
        a = rs.normal(size=(n, 3))
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        b = rs.normal(size=(n, 3))
        b -= np.sum(a * b, axis=1, keepdims=True) * a
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        c, sn = 0.9572 * np.cos(np.radians(52.26)), 0.9572 * np.sin(np.radians(52.26))
        frames.append(np.stack([o, o + c * a + sn * b, o + c * a - sn * b], axis=1).reshape(-1, 3))
    return np.stack(frames).astype(np.float32), np.full((f, 3), box_len, np.float32)


def _hb_dense_args(acc, don, donh, boxes, dist=HB_DIST, ang=HB_ANG):
    """hbond_dense's arguments, as `hbond_counts` prepares them."""
    from waterorderlib_tpu_torch.ops.cuda import hbond

    return (*hbond.dense_prep(acc, don, donh, boxes), boxes, dist * dist, hbond.cos_cut(ang))


def _hb_slab_args(acc, don, donh, boxes, window_w=None, dist=HB_DIST, ang=HB_ANG):
    """(prep, hbond_slab's arguments) at the certified dispatch's window and
    pad, or at `window_w`."""
    from waterorderlib_tpu_torch.ops.cuda import hbond

    na, nd, box_z = acc.shape[1], don.shape[1], float(boxes[0, 2])
    win = window_w or hbond.suggest_window_two_set(na, nd, box_z, dist)
    pad = hbond.suggest_pad_two_set(nd, box_z, dist + 2.0)
    prep = hbond.slab_prep_two_set(acc, don, donh, boxes, dist, win, pad)
    return prep, (prep.acc, prep.don, prep.donh, prep.vhat, prep.starts, boxes, prep.w,
                  dist * dist, hbond.cos_cut(ang))


def _hb_within(prep, boxes, dist=HB_DIST):
    """(acceptor, donor) pairs of all frames with dsq in (1e-2, dist^2]: the
    pairs whose angle the kernels test. Counted over the slab prep's
    windows, which hold every such pair where `covered` holds, with the
    kernels' wrapped coordinates and minimum image."""
    import torch

    _check(bool(prep.covered.all()), "within-pair count: slab prep not covered")
    F, _, n_rows = prep.acc.shape
    n_tiles, w = prep.starts.shape[1], prep.w
    offs = torch.arange(w, device=prep.acc.device)
    tb = max(1, 2**26 // (128 * w))
    total = 0
    for f in range(F):
        half = boxes[f] * 0.5
        for t0 in range(0, n_tiles, tb):
            t1 = min(n_tiles, t0 + tb)
            cols = prep.starts[f, t0:t1].long()[:, None] + offs         # (tb, w)
            d = prep.don[f][:, cols][:, :, None, :]                       # (3, tb, 1, w)
            a = prep.acc[f][:, t0 * 128 : t1 * 128].reshape(3, t1 - t0, 128, 1)
            e = d - a
            e = torch.where(e > half[:, None, None, None], e - boxes[f][:, None, None, None], e)
            e = torch.where(e < -half[:, None, None, None], e + boxes[f][:, None, None, None], e)
            dsq = (e * e).sum(dim=0)
            total += int(((dsq > 1.0e-2) & (dsq <= dist * dist)).sum())
    return total


def _hb_bound_ms(args, n_acc, within, slab):
    """Least time of one H-bond launch on these inputs: float32 operations
    (HB_PAIR_FLOPS per visited pair -- Na x Nd, or Na x w for the slab
    kernel -- and HB_ANGLE_FLOPS per pair within the cut) over the peak
    rate, or bytes (inputs read once, int32 counts written once) over the
    memory rate. Returns (ms, bound_by)."""
    acc, don = args[0], args[1]
    F, _, n_rows = acc.shape
    n_cols = don.shape[2]
    width = args[6] if slab else n_cols
    in_bytes = 4 * (acc.numel() + 3 * don.numel() + args[5 if slab else 4].numel())
    if slab:
        in_bytes += 4 * args[4].numel()
    out_bytes = 4 * F * (n_rows + n_cols)
    t_ops = (F * n_acc * width * HB_PAIR_FLOPS + within * HB_ANGLE_FLOPS) / PEAK_FP32 * 1e3
    t_bytes = (in_bytes + out_bytes) / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _hb_mismatch(label, pos, boxes, top, got, want):
    """Stop with the (frame, water) totals that differ between the kernel
    path and the arccos form, and each differing water-water pair's margins
    to the distance and angle cuts (float64)."""
    import numpy as np
    import torch
    from waterorderlib_tpu_torch.drivers import hbonds_driver
    from waterorderlib_tpu_torch.hbonds import bonds
    from waterorderlib_tpu_torch.ops.cuda import hbond

    bad = torch.nonzero(got != want).tolist()
    lines = [f"{label}: {len(bad)} per-water totals differ, e.g. (frame, water, kernel path, "
             f"arccos) {[(f, w, int(got[f, w]), int(want[f, w])) for f, w in bad[:8]]}"]
    (wa, wd, wdh), _, _ = hbonds_driver.hb_sets(top, "WAT", pos.device)[0]
    for f, w in bad[:8]:
        acc, don, donh = (pos[f : f + 1, i] for i in (wa, wd, wdh))
        b = boxes[f : f + 1]
        m_arc = bonds.general_hbonds(acc, don, donh, b, HB_DIST, HB_ANG)[0]
        prep = hbond.dense_prep(acc, don, donh, b)
        box_l = b[:, :, None, None]
        ds, cc = (torch.tensor(v, dtype=torch.float32, device=pos.device)
                  for v in (HB_DIST * HB_DIST, hbond.cos_cut(HB_ANG)))
        m_cos = hbond._bonds(prep.acc[:, :, :, None], prep.don[:, :, None, :],
                             prep.donh[:, :, None, :], prep.vhat[:, :, None, :], box_l, ds, cc)[0]
        for i, j in torch.nonzero(m_arc != m_cos).tolist():
            if i != w and j // 2 != w:
                continue
            a, d, h = (x[0, k].double().cpu().numpy() for x, k in ((acc, i), (don, j), (donh, j)))
            L = b[0].double().cpu().numpy()
            dv = d - a - L * np.round((d - a) / L)
            u = a - h - L * np.round((a - h) / L)
            v = d - h - L * np.round((d - h) / L)
            ang = np.degrees(np.arccos(np.dot(u, v) / np.linalg.norm(u) / np.linalg.norm(v)))
            lines.append(f"  frame {f} acceptor {i} donor {j}: arccos {bool(m_arc[i, j])}, kernel "
                         f"{bool(m_cos[i, j])}, |d| - cut = {np.linalg.norm(dv) - HB_DIST:.3e} A, "
                         f"angle - cut = {ang - HB_ANG:.3e} degrees")
    print("\n".join(lines), flush=True)
    raise AssertionError(lines[0])


def _hb_planted(w_sets, boxes):
    """H-bond sets with pairs planted at the edges of csrc/hbond.cu's
    magnitude minimum image: (label, (acc, don, donh), boxes) for the
    water-water sets of `w_sets` with 6 acceptors and 6 donors appended --
    3 pairs at exactly the cut (a donor 3.5 A from its acceptor along x, y
    or z on exact float32 coordinates: dsq == dist^2, the hydrogen on the
    line between them, so each bonds) and 3 at exactly half a box edge along
    x, y or z -- and a small box of edges 6, 7 and 6.5 A (frame 0) and an
    NPT copy scaled by 1.0625 (frame 1), where half an edge lies within the
    cut: 4 acceptors, each with donors at exactly half an edge along x, y
    and z and one at the cut."""
    import torch

    acc, don, donh = w_sets
    f, dev = acc.shape[0], acc.device
    a_pl = torch.zeros((f, 6, 3), device=dev)
    d_pl = torch.zeros((f, 6, 3), device=dev)
    for ax in range(3):
        a_pl[:, ax] = 2.0 + 4.0 * ax
        d_pl[:, ax] = a_pl[:, ax]
        d_pl[:, ax, ax] += 3.5
        a_pl[:, 3 + ax] = 0.5
        a_pl[:, 3 + ax, ax] = 0.0
        d_pl[:, 3 + ax] = a_pl[:, 3 + ax]
        d_pl[:, 3 + ax, ax] = boxes[:, ax] * 0.5
    h_pl = d_pl.clone()
    for ax in range(3):
        h_pl[:, ax, ax] -= 0.9572
        h_pl[:, 3 + ax, ax] -= 0.9572
    big = (torch.cat([acc, a_pl], dim=1), torch.cat([don, d_pl], dim=1),
           torch.cat([donh, h_pl], dim=1))
    # the small box: each acceptor's donors at half an edge along x, y and z
    # (hydrogens 0.9572 A back along the axis) and at (1, 1.5, 3) A, where
    # dsq = 12.25 exactly (hydrogen at 0.7 of the way to the acceptor)
    sb = torch.tensor([[6.0, 7.0, 6.5], [6.375, 7.4375, 6.90625]], device=dev)
    a_s = torch.tensor([[0.25, 0.5, 0.75], [1.0, 1.0, 1.0], [0.5, 3.0, 2.0], [2.0, 0.25, 3.0]],
                       device=dev).expand(2, 4, 3)
    cut_d = torch.tensor([1.0, 1.5, 3.0], device=dev)
    d_s, h_s = [], []
    for i in range(4):
        for ax in range(4):
            d, h = a_s[:, i].clone(), a_s[:, i].clone()
            if ax < 3:
                d[:, ax] = d[:, ax] + sb[:, ax] * 0.5
                h[:, ax] = d[:, ax] - 0.9572
            else:
                d, h = d + cut_d, h + 0.3 * cut_d
            d_s.append(torch.remainder(d, sb))
            h_s.append(torch.remainder(h, sb))
    small = (a_s.contiguous(), torch.stack(d_s, dim=1), torch.stack(h_s, dim=1))
    return ((f"{acc.shape[1]} waters + 6 planted pairs (cut, half edge)", big, boxes),
            ("6 x 7 x 6.5 A box and its NPT copy, half edges within the cut", small, sb))


def _lsi_lattice(n_side, dev):
    """(pos (1, n, 3), boxes (1, 3)) of a cubic lattice of spacing 3 A in a
    box of n_side spacings: exact float32 coordinates, so distances tie
    exactly everywhere (a row's 24th candidate falls inside a 24-member
    shell); every third site stored shifted by +L in x (other raw distances,
    the same imaged ones)."""
    import numpy as np
    import torch

    g = np.stack(np.meshgrid(*(np.arange(n_side),) * 3, indexing="ij"), -1).reshape(-1, 3) * 3.0
    g[::3, 0] += 3.0 * n_side
    return (torch.tensor(g[None], dtype=torch.float32, device=dev),
            torch.full((1, 3), 3.0 * n_side, dtype=torch.float32, device=dev))


# rows of a launch (frames x rows) from which qtet_window.cu takes its row
# form (kRowFormMin); smaller launches take its lane form
Q_ROW_FORM_MIN = 65_536


def _tile_frames(args):
    """(q_window arguments with their frames repeated up to Q_ROW_FORM_MIN
    rows, the repeat count): rows, cols, per-frame window starts (where
    2-D) and boxes carry a leading frame axis."""
    rows = args[0]
    k = -(-Q_ROW_FORM_MIN // (rows.shape[0] * rows.shape[2]))
    if k <= 1:
        return args, 1
    return tuple(a.repeat(k, *([1] * (a.dim() - 1))) if i < 4 and a.dim() >= 2 else a
                 for i, a in enumerate(args)), k


def _cmp_q(label, kern, plain, args, errs):
    """q_window (or q_window_hist) against its plain version in both forms
    of qtet_window.cu: on `args`, and with their frames repeated up to
    Q_ROW_FORM_MIN rows (held against the plain outputs repeated; the
    histogram times the repeat count). NaN rows (windows outside the
    columns) must match as NaN."""
    import torch

    want = plain(*args)
    for form, a_k, k in (("as given", args, 1), ("frames repeated", *_tile_frames(args))):
        if form != "as given" and k == 1:
            continue
        got = kern(*a_k)
        torch.cuda.synchronize()
        q_w = want[0].repeat(k, 1)
        err = float(torch.nan_to_num((got[0] - q_w).abs(), 0.0).max())
        same_nan = torch.equal(torch.isnan(got[0]), torch.isnan(q_w))
        exact = torch.equal(got[1], want[1].repeat(k, 1)) and (
            len(got) < 3 or torch.equal(got[2], want[2] * k))
        rows = got[0].numel()
        print(f"[kernel] {kern.__name__} {label} ({form}{f' x{k}' if k > 1 else ''}, {rows} rows: "
              f"the {'row' if rows >= Q_ROW_FORM_MIN else 'lane'} form): max|d|={err:.3e}, "
              f"NaN rows equal {same_nan}, ok{' and histogram' if len(got) > 2 else ''} "
              f"equal {exact}", flush=True)
        _check(err <= Q_TOL and same_nan and exact, f"{kern.__name__} {label} ({form}) differs "
               f"from its plain version")
        errs.append(err)


def _q_planted(pos, boxes):
    """(pos, boxes) of q pairs planted at the kernel's edges: the frames
    with every atom within 10.5 A of two centers removed, and around each
    center atoms on exact float32 offsets -- C1 = (20, 20, 20): three at 2.5
    A, one at exactly 4.5 A (the margin and the lists' filter, both
    inclusive), one at exactly 10 A (the shell's edge, inclusive) and one on
    C1 itself (distance 0: low, exclusive); C2 = (20, 20, 38): three at 2.5
    A, a 4th at 4.5625 A (beyond the filter: C2 is scanned again and its
    `ok` fails) and one at exactly 10 A."""
    import torch

    dev = pos.device
    c1 = torch.tensor([20.0, 20.0, 20.0], device=dev)
    c2 = torch.tensor([20.0, 20.0, 38.0], device=dev)
    off1 = [[2.5, 0, 0], [0, 2.5, 0], [0, 0, 2.5], [-4.5, 0, 0], [0, 0, -10.0], [0, 0, 0]]
    off2 = [[2.5, 0, 0], [0, 2.5, 0], [0, 0, 2.5], [-4.5625, 0, 0], [0, 0, -10.0]]
    planted = torch.cat([c1[None], c1 + torch.tensor(off1, device=dev), c2[None],
                         c2 + torch.tensor(off2, device=dev)])
    keep = torch.ones(pos.shape[1], dtype=torch.bool, device=dev)
    for c in (c1, c2):
        d = pos[0] - c
        d = d - boxes[0] * torch.round(d / boxes[0])
        keep &= (d * d).sum(-1) > 10.5 * 10.5
    out = torch.cat([pos[:, keep], planted.expand(pos.shape[0], -1, -1)], dim=1)
    return out.contiguous(), boxes


# float32 offsets whose squared length in the LSI kernels' arithmetic (the
# fmaf chain) is exactly LSI_HIGH^2 and LSI_OUTER^2 as float32: (x, y, 0)
LSI_AT_HIGH = (3.699997901916504, 0.00390625)
LSI_AT_OUTER = (7.399995803833008, 0.0078125)


def _lsi_planted(pos, boxes):
    """(pos, boxes) of LSI pairs planted at the split kernel's edges: the
    frames with every atom within 9 A of two rows removed, and around them
    atoms on exact float32 coordinates -- R1 = (0, 20, 20): one neighbor at
    exactly `high` (in the shell, inclusive), two at 2.5 A, one on R1
    itself (distance 0: low, exclusive), and two annulus candidates at equal
    raw distances, 5 A (the first column wins); R2 = (0, 20, 40): two at
    2.5 A and its only annulus candidate at exactly `high + 3.7` (inclusive),
    another at 7.5 A (beyond it)."""
    import torch

    dev = pos.device
    (hx, hy), (ox, oy) = LSI_AT_HIGH, LSI_AT_OUTER
    r1 = torch.tensor([0.0, 20.0, 20.0], device=dev)
    r2 = torch.tensor([0.0, 20.0, 40.0], device=dev)
    planted = torch.tensor(
        [[0.0, 20.0, 20.0], [hx, 20.0 + hy, 20.0], [0.0, 22.5, 20.0], [0.0, 20.0, 22.5],
         [0.0, 20.0, 20.0], [0.0, 15.0, 20.0], [0.0, 20.0, 15.0],
         [0.0, 20.0, 40.0], [0.0, 22.5, 40.0], [0.0, 20.0, 42.5], [ox, 20.0 + oy, 40.0],
         [7.5, 20.0, 40.0]], device=dev)
    keep = torch.ones(pos.shape[1], dtype=torch.bool, device=dev)
    for c in (r1, r2):
        d = torch.remainder(pos[0], boxes[0]) - c
        d = d - boxes[0] * torch.round(d / boxes[0])
        keep &= (d * d).sum(-1) > 9.0 * 9.0
    out = torch.cat([pos[:, keep], planted.expand(pos.shape[0], -1, -1)], dim=1)
    return out.contiguous(), boxes


def _stages(label, driver_fn):
    """One more (warm) driver call under the drivers' stage clock: the wall
    time of each of its named steps, the device synchronised between them.
    Returns {stage: ms}."""
    from waterorderlib_tpu_torch.drivers import orderparams

    with tempfile.TemporaryDirectory() as d, orderparams.stage_times() as t:
        t0 = time.perf_counter()
        driver_fn(d)
        wall = (time.perf_counter() - t0) * 1e3
    print(f"[stages] {label}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in t.items())
          + f"; sum {sum(t.values()):.2f} ms; wall {wall:.2f} ms", flush=True)
    return t


def _slice(label, driver_fn, kernels, name, tier_of, want_tier, files, n_results,
           shape=(500, 2), hist_sum=None):
    """Run a driver with every kernel's and plain version's counter set to
    0; check tier, the launches of kernel `name`, that no plain version was
    called, files of `shape` (the first file's counts summing to `hist_sum`,
    as far as the files' %.3e shows, where given) and finite results (each a [means, CIs] pair or a number).
    Returns the launches."""
    import numpy as np
    import torch

    kernel = kernels[name][0]
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        for k, p in kernels.values():
            k.launches, p.calls = 0, 0
        t0 = time.perf_counter()
        res = driver_fn(out_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, tier = kernel.launches, tier_of()
        plain_calls = sum(p.calls for _, p in kernels.values())
        hists = [np.loadtxt(os.path.join(out_dir, f)) for f in files]
    pairs = [r if isinstance(r, (list, tuple)) else [r] for r in res]
    print(f"[slice] {label}: tier={tier} {kernel.__name__} launches={launches} "
          f"plain calls={plain_calls} wall={wall:.3f} s "
          f"means={[np.asarray(r[0]).tolist() for r in pairs]}", flush=True)
    _check(tier == want_tier, f"{label} took tier {tier}, not {want_tier}")
    _check(launches > 0, f"{label} never launched {kernel.__name__}")
    _check(plain_calls == 0, f"{label} called a plain version")
    _check(all(h.shape == shape for h in hists), f"{label}: histogram files are not {shape}")
    _check(all(int(h[:, 1].sum()) > 0 for h in hists), f"{label}: empty histogram")
    # the files print counts as %.3e: each bin within half a unit of its
    # fourth significant digit
    _check(hist_sum is None or abs(hists[0][:, 1].sum() - hist_sum) <= 5e-4 * hist_sum,
           f"{label}: {files[0]} counts {hists[0][:, 1].sum()}, not {hist_sum}")
    _check(len(res) == n_results, f"{label}: {len(res)} results, not {n_results}")
    _check(all(np.all(np.isfinite(np.asarray(a))) for r in pairs for a in r),
           f"{label}: statistics not finite")
    return launches

_SASS_PROBE = r"""
extern "C" __global__ void probe_expf(const float* x, float* y) {
  y[threadIdx.x] = expf(x[threadIdx.x]);
}
extern "C" __global__ void probe_div(const float* x, const float* s, float* y) {
  y[threadIdx.x] = x[threadIdx.x] / s[threadIdx.x];
}
"""


def _sass_start():
    """Start nvcc, with the kernels' flags, on a probe of expf and of a
    float32 division, beside the kernels' build. Returns (process, its
    directory)."""
    from waterorderlib_tpu_torch.ops.cuda import build

    d = tempfile.mkdtemp()
    src = os.path.join(d, "probe.cu")
    with open(src, "w") as f:
        f.write(_SASS_PROBE)
    cmd = [build._nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
           "--fmad=false", "-o", os.path.join(d, "probe.cubin"), src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), d


def _sass_ops(proc, d):
    """{"expf": n, "div": n}: the float32 instructions (opcodes F* and MUFU)
    before each probe kernel's first EXIT in the SASS that cuobjdump shows
    (the division's slow path, a subroutine after EXIT, is not counted)."""
    import re
    import shutil
    from waterorderlib_tpu_torch.ops.cuda import build

    _, err = proc.communicate()
    _check(proc.returncode == 0, f"nvcc failed on the SASS probe: {err}")
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", os.path.join(d, "probe.cubin")],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    shutil.rmtree(d)
    ops, fn, done = {}, None, False
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn, done = m.group(1), False
            ops[fn] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)(\.\S+)?", line)
        if fn is None or done or not m:
            continue
        if m.group(1) == "EXIT":
            done = True
        elif m.group(1).startswith("F") or m.group(1) == "MUFU":
            ops[fn].append(m.group(1) + (m.group(2) or ""))
    out = {"expf": len(ops["probe_expf"]), "div": len(ops["probe_div"])}
    print(f"[sass] float32 instructions: expf {out['expf']} {ops['probe_expf']}; division "
          f"{out['div']} {ops['probe_div']}", flush=True)
    _check(out["expf"] > 0 and out["div"] > 0, "SASS probe found no float32 instructions")
    return out


def _interface_system(n_waters, seed):
    """(solute heavy atoms, water oxygens, box) of one frame of
    make_water_box(n_waters, seed=seed, solute WC_SOLUTE), wrapped into its
    box, whose z edge is then doubled: a liquid slab in z in [0, L) under
    vapour, the solute inside the liquid."""
    import numpy as np
    from waterorderlib_tpu_torch.io.synthetic import make_water_box

    top, traj = make_water_box(n_waters, n_frames=1, seed=seed, solute_elements=WC_SOLUTE)
    p = np.mod(traj.positions[0], traj.boxes[0])
    box = traj.boxes[0].copy()
    box[2] *= 2.0
    return p[top.get_sol_inds()[0]], p[top.get_wat_inds()[0]], box


def _wg_args(prep, box, grid):
    """willard_grid's arguments for a prep's whole grid."""
    return (prep.atoms, prep.starts, prep.w, box, grid)


def _wg_counts(prep, box, grid):
    """(row visits, near row visits, strip pairs, inside pairs) of a grid
    launch: the (x-row, atom) pairs of its windows; those whose dx^2 + dz^2
    is under 9 sigma^2; the (point, atom) pairs of those; the pairs within
    3 sigma. The kernel's operations, plane by plane, on the card."""
    import torch
    from waterorderlib_tpu_torch.ops.cuda import willard

    sig2 = willard.scalars(2.4)[0]
    nine = torch.tensor(9.0, device=box.device) * torch.tensor(sig2, device=box.device)
    gx, gy, gz = (willard._wrap(a, box[d]) for d, a in enumerate(willard.grid_axes(grid, box.device)))
    nz, nx, ny = len(gz), len(gx), len(gy)
    offs = torch.arange(prep.w, device=box.device)
    near = inside = 0
    for k in range(nz):
        a = prep.atoms[k if prep.atoms.shape[0] > 1 else 0]
        idx = prep.starts[k].long()[:, None] + offs  # (nx, w)
        dx = willard._mi(gx[:, None] - a[0][idx], box[0])
        dz = willard._mi(gz[k] - a[2][idx], box[2])
        dxz = dx * dx + dz * dz
        near += int((dxz < nine).sum())
        dy = willard._mi(gy[None, :, None] - a[1][idx][:, None, :], box[1])
        inside += int((dy * dy + dxz[:, None, :] < nine).sum())
    return nz * nx * prep.w, near, near * ny, inside


def _wg_bound_ms(prep, grid, counts, sass):
    """Least time of one grid launch on these inputs: its float32 operations
    (WG_*_FLOPS, and expf per near row visit and per pair within 3 sigma)
    over the peak rate, or its bytes (atoms and starts read once, the four
    outputs written once) over the memory rate. Returns (ms, bound_by)."""
    rows, near, strip, inside = counts
    (_, _, nx), (_, _, ny), (_, _, nz) = grid
    ops = (rows * WG_ROW_FLOPS + near * (WG_ROW_NEAR_FLOPS + sass["expf"])
           + strip * WG_STRIP_FLOPS + inside * (WG_INSIDE_FLOPS + sass["expf"]))
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = 4 * (prep.atoms.numel() + prep.starts.numel() + 4 * nx * ny * nz) / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _wp_bound_ms(n_atoms, n_points, inside, sass):
    """Least time of one points launch: WP_PAIR_FLOPS per (point, atom),
    WP_INSIDE_FLOPS, expf and a division per pair within 3 sigma, or the
    bytes of atoms and points read once and four outputs written once."""
    ops = n_points * n_atoms * WP_PAIR_FLOPS + inside * (WP_INSIDE_FLOPS + sass["expf"]
                                                         + sass["div"])
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = 4 * (3 * n_atoms + 3 * n_points + 4 * n_points) / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _unit_dots(a, b):
    """Share of points whose unit normals a and b (..., 3) have a dot above
    WC_DOT or are both zero (no atom within 3 sigma: the vapour)."""
    zero = (a == 0).all(dim=-1) & (b == 0).all(dim=-1)
    return float((((a * b).sum(dim=-1) > WC_DOT) | zero).float().mean())


def _willard_phases(card, kernels, errs, launches, times, sass):
    """The interface slice: density_grid on fixture A (4096 waters, 80^3
    grid: the x tier, one willard_grid launch) and with a window_x too
    narrow (one willard_points launch), its field against the points
    kernel, each kernel against its plain version on fixture A's whole grid
    (the grid kernel in the x, plane and brute forms), their times and bounds,
    fixture B (32,768 waters: a grid tier, equal to the points kernel on
    three planes), and a warm density_grid under the stage clock."""
    import numpy as np
    import torch
    from waterorderlib_tpu_torch.density import fields
    from waterorderlib_tpu_torch.ops.cuda import willard
    from waterorderlib_tpu_torch.surface import grids

    dev = torch.device("cuda")
    wg_k, wg_p = willard.willard_grid, willard.willard_grid_plain
    wp_k, wp_p = willard.willard_points, willard.willard_points_plain
    kernels["willard_grid"] = (wg_k, wg_p)
    kernels["willard_points"] = (wp_k, wp_p)

    def drive(label, heavy, wat, box_np, want_tiers, **kw):
        """density_grid with every count at 0; returns (the two kernels'
        launches, faces)."""
        torch.cuda.synchronize()
        for k, p in kernels.values():
            k.launches, p.calls = 0, 0
        t0 = time.perf_counter()
        verts, faces = grids.density_grid(heavy, wat, box_np, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = (wg_k.launches, wp_k.launches)
        plain = sum(p.calls for _, p in kernels.values())
        print(f"[slice] density_grid {label}: tier={willard.last_tier} launches grid/points={ran} "
              f"plain calls={plain} wall={wall:.3f} s; mesh {len(verts)} vertices, {len(faces)} "
              f"faces", flush=True)
        _check(willard.last_tier in want_tiers, f"density_grid {label} took tier "
               f"{willard.last_tier}, not {want_tiers}")
        _check(plain == 0, f"density_grid {label} called a plain version")
        _check(len(faces) > 1000 and bool(np.isfinite(verts).all())
               and int(faces.max()) < len(verts), f"density_grid {label}: mesh of {len(faces)} "
               "faces, or not finite")
        return ran, faces

    heavy, wat, box_np = _interface_system(N_WATERS, seed=0)
    ran, faces_x = drive(f"{N_WATERS} waters + solute (liquid slab), 80^3 grid", heavy, wat,
                         box_np, ("x",))
    _check(ran == (1, 0), f"density_grid launched grid/points {ran}, not (1, 0)")
    launches["willard_grid"] = ran[0]
    ran, faces_p = drive(f"{N_WATERS} waters + solute, window_x=8", heavy, wat, box_np,
                         ("points",), window_x=8)
    _check(ran == (0, 1), f"density_grid with a failing certificate launched {ran}, not (0, 1)")
    launches["willard_points"] = ran[1]

    grid = grids.grid_spec(heavy, box_np)
    ng = grid[0][2]
    pos = torch.as_tensor(wat, dtype=torch.float32, device=dev)
    box = torch.as_tensor(box_np, dtype=torch.float32, device=dev)
    axes = willard.grid_axes(grid, dev)
    dens, norms = willard.density_grid_certified(pos, box, grid)
    d_ref, n_ref = fields.willard_density_field(pos, *axes, box, nx=ng, ny=ng, nz=ng)
    err, share = float((dens - d_ref).abs().max()), _unit_dots(norms, n_ref)
    print(f"[slice] fixture A field (tier {willard.last_tier}) vs fields.willard_density_field "
          f"(points kernel): max|d dens|={err:.3e}, normals dot>{WC_DOT} on {share:.6f}; density "
          f"{float(dens.min()):.5f}..{float(dens.max()):.5f}; faces x tier {len(faces_x)}, "
          f"points tier {len(faces_p)}", flush=True)
    _check(err <= WC_REF_TOL and share >= WC_DOT_SHARE, "fixture A: grid field differs from the "
           f"points kernel's ({err}, {share})")

    preps = {"x": willard.grid_prep(pos, box, grid), "plane": willard.grid_prep(pos, box, grid,
                                                                               window_x=0),
             "brute": willard.brute_prep(pos, box, grid)}
    for label, prep in preps.items():
        _check(prep.tier == label and prep.covered, f"fixture A: {label} prep took {prep.tier}, "
               f"covered={prep.covered}")
        errs["willard_grid"].append(_cmp(f"{label} form (w={prep.w}), whole grid", wg_k, wg_p,
                                         _wg_args(prep, box, grid), (WC_TOL,) * 4))
    atoms_t = pos.t().contiguous()
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij")).reshape(3, -1)
    n_pts = pts.shape[1]
    errs["willard_points"].append(_cmp("whole grid", wp_k, wp_p, (atoms_t, pts, box),
                                       (WC_TOL,) * 4))

    for label, prep in preps.items():
        counts = _wg_counts(prep, box, grid)
        ms = _ms(wg_k, _wg_args(prep, box, grid), 10)
        plain_ms = _ms(wg_p, _wg_args(prep, box, grid), 1)
        bound, bound_by = _wg_bound_ms(prep, grid, counts, sass)
        if label == "x":
            times["willard_grid"] = (ms, plain_ms, bound, bound_by)
            inside_a = counts[3]
        print(f"[time] willard_grid {label} form, fixture A ({ng}^3 points, {N_WATERS} atoms, "
              f"w={prep.w}; {counts[0]} row visits, {counts[1]} near row visits, {counts[2]} "
              f"strip pairs, {counts[3]} pairs within 3 sigma): kernel {ms:.5f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({bound_by}); {card}", flush=True)
    ms = _ms(wp_k, (atoms_t, pts, box), 3)
    plain_ms = _ms(wp_p, (atoms_t, pts, box), 1)
    bound, bound_by = _wp_bound_ms(N_WATERS, n_pts, inside_a, sass)
    times["willard_points"] = (ms, plain_ms, bound, bound_by)
    print(f"[time] willard_points, fixture A ({n_pts} points x {N_WATERS} atoms, {inside_a} pairs "
          f"within 3 sigma): kernel {ms:.5f} ms, plain {plain_ms:.3f} ms, bound {bound:.5f} ms "
          f"({bound_by}); {card}", flush=True)
    del preps, pts, dens, norms, d_ref, n_ref

    # fixture B: the uncapped grid tier at 32,768 waters, against the points
    # kernel on the first, middle and last planes
    heavy_b, wat_b, box_b = _interface_system(N_WC_LARGE, seed=1)
    ran, _ = drive(f"{N_WC_LARGE} waters + solute (liquid slab), 80^3 grid", heavy_b, wat_b,
                   box_b, ("x", "plane"))
    _check(ran == (1, 0), f"density_grid at {N_WC_LARGE} waters launched {ran}, not (1, 0)")
    grid_b = grids.grid_spec(heavy_b, box_b)
    pos_b = torch.as_tensor(wat_b, dtype=torch.float32, device=dev)
    bx_b = torch.as_tensor(box_b, dtype=torch.float32, device=dev)
    prep_b = willard.grid_prep(pos_b, bx_b, grid_b)
    dens_b, norms_b = willard.density_grid_certified(pos_b, bx_b, grid_b)
    ax, ay, az = willard.grid_axes(grid_b, dev)
    err_b, share_b = 0.0, 1.0
    for k in (0, ng // 2, ng - 1):
        pk = torch.stack(torch.meshgrid(ax, ay, az[k : k + 1], indexing="ij"), dim=-1)
        d, n = fields.willard_density_points(pos_b, pk.reshape(-1, 3), bx_b)
        err_b = max(err_b, float((dens_b[:, :, k].reshape(-1) - d).abs().max()))
        share_b = min(share_b, _unit_dots(norms_b[:, :, k].reshape(-1, 3), n))
    ms_b = _ms(wg_k, _wg_args(prep_b, bx_b, grid_b), 10)
    print(f"[large] density_grid {N_WC_LARGE} waters: tier {willard.last_tier} (w={prep_b.w}, "
          f"{prep_b.atoms.shape[2]} atoms a plane array); planes 0, {ng // 2}, {ng - 1} vs the "
          f"points kernel: max|d dens|={err_b:.3e}, normals dot>{WC_DOT} on {share_b:.6f}; grid "
          f"kernel {ms_b:.5f} ms; {card}", flush=True)
    _check(err_b <= WC_REF_TOL and share_b >= WC_DOT_SHARE,
           f"fixture B: grid field differs from the points kernel's ({err_b}, {share_b})")
    del pos_b, dens_b, norms_b, prep_b
    torch.cuda.empty_cache()

    _stages("density_grid", lambda d: grids.density_grid(heavy, wat, box_np, device="cuda"))


def _env_line():
    """One line: does scipy import here (the Voronoi slice's host close
    needs it)? Not a phase that can fail."""
    try:
        import scipy
    except ImportError as e:
        print(f"[env] scipy: not importable ({type(e).__name__}: {e})", flush=True)
    else:
        print(f"[env] scipy: imports, version {scipy.__version__}", flush=True)


def _ptxas_summary(logs):
    """One line: each source's kernels' registers and spill-store bytes, as
    ptxas reported them in this run's build (the early [ptxas] lines fall
    out of a tail of the output)."""
    import re

    parts = []
    for name, log in logs.items():
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        parts.append(f"{name} {'/'.join(regs)} registers, spill stores {'/'.join(spills)} bytes")
    return "[ptxas] " + "; ".join(parts)


def _sasa_tests(pos, rad, pts, box, slots=None):
    """(point, occluder) tests the occlusion loop needs on these inputs:
    each point against the occluders in order up to its first occluding
    one, a visible point against every occluder that can occlude. slots:
    the pruned tier's (occ, occ_rsq, valid); None: the brute tier (all
    atoms but the point's own). float32 without the fmas: a count."""
    import math
    import torch
    from waterorderlib_tpu_torch.core import pbc

    n, p = pos.shape[0], pts.shape[0]
    m = n if slots is None else slots[0].shape[1]
    idx = torch.arange(n, device=pos.device)
    step = max(1, (1 << 24) // (p * m))
    total = 0
    for s in range(0, n, step):
        c, r = pos[s : s + step], rad[s : s + step]
        if slots is None:
            occ = c[:, None] + pbc.minimum_image(pos[None] - c[:, None], box)
            rsq = torch.where(idx[s : s + step, None] == idx[None], -math.inf, (rad * rad)[None])
        else:
            occ = slots[0][s : s + step]
            rsq = torch.where(slots[2][s : s + step], slots[1][s : s + step], -math.inf)
        d = (c[:, None] + r[:, None, None] * pts[None])[:, :, None] - occ[:, None]
        hit = (d * d).sum(-1) < rsq[:, None]  # (B, P, M)
        cum = torch.cumsum(torch.isfinite(rsq).int(), dim=-1)  # (B, M)
        first = hit.int().argmax(dim=-1)  # (B, P)
        tests = torch.where(hit.any(dim=-1), cum.gather(1, first), cum[:, -1:].expand_as(first))
        total += int(tests.sum())
    return total


def _sasa_bound_ms(n, p, tests, k=None):
    """Least time of one occlusion launch: its float32 operations (points,
    tests, and the brute loader's reimaging) over the peak rate, or its
    bytes (centers, radii, points, box or slots read once, n_vis written
    once) over the memory rate. k: the pruned tier's slots; None: brute."""
    ops = n * p * SASA_POINT_FLOPS + tests * SASA_TEST_FLOPS
    in_bytes = 16 * n + 12 * p + 4 * n
    if k is None:
        ops += n * n * SASA_LOAD_FLOPS
        in_bytes += 12
    else:
        in_bytes += 17 * n * k  # occ, occ_rsq, valid
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = in_bytes / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sasa_phases(card, kernels, errs, launches, times):
    """The SASA slice: sasa_per_atom on bench.py's 4096-atom lattice with
    1000 points, with the box and with box=None (the pruned tier, one
    sasa_topk launch, no plain call); both kernels against their plain
    versions and the brute tier against the pruned one, exactly; a cluster
    of 130 atoms around atom 0 fails the certificate (the brute tier, one
    launch of each kernel); a coincident pair (left out by the pruned tier,
    counted by the brute tier); times, bounds and a warm sasa_per_atom on
    the stage clock; sasa_calc and sphere_volumes on the card against the
    port's own CPU run."""
    import numpy as np
    import torch
    from waterorderlib_tpu_torch.core.geometry import sphere_points
    from waterorderlib_tpu_torch.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.ops import pairs
    from waterorderlib_tpu_torch.ops.cuda import sasa as occl
    from waterorderlib_tpu_torch.surface import sasa

    dev = torch.device("cuda")
    tk, tp = occl.sasa_topk, occl.sasa_topk_plain
    bk, bp = occl.sasa_brute, occl.sasa_brute_plain
    kernels["sasa_topk"] = (tk, tp)
    kernels["sasa_brute"] = (bk, bp)
    pos_np = _lattice_traj(N_WATERS, 1, seed=0)[0][0]
    box_np = np.full(3, (N_WATERS / 0.033456) ** (1.0 / 3.0), np.float32)
    vdw = np.full(N_WATERS, SASA_VDW, np.float32)
    pts = torch.as_tensor(sphere_points(SASA_POINTS), dtype=torch.float32, device=dev)

    def drive(label, p_np, v_np, box_arg, want_tier, want_launches):
        """sasa_per_atom with every count at 0; returns (areas, exposed)."""
        torch.cuda.synchronize()
        for k, p in kernels.values():
            k.launches, p.calls = 0, 0
        t0 = time.perf_counter()
        areas, exposed = sasa.sasa_per_atom(p_np, v_np, box=box_arg, n_points=SASA_POINTS,
                                             device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = (tk.launches, bk.launches)
        plain = sum(p.calls for _, p in kernels.values())
        print(f"[slice] sasa_per_atom {label}: tier={sasa.last_tier} launches topk/brute={ran} "
              f"plain calls={plain} wall={wall:.3f} s; total area {float(areas.sum()):.2f} A^2, "
              f"{int(exposed.sum())} of {len(p_np)} atoms exposed", flush=True)
        _check(sasa.last_tier == want_tier, f"sasa_per_atom {label} took {sasa.last_tier}")
        _check(ran == want_launches, f"sasa_per_atom {label} launched {ran}, not {want_launches}")
        _check(plain == 0, f"sasa_per_atom {label} called a plain version")
        _check(bool(torch.isfinite(areas).all()) and tuple(areas.shape) == (len(p_np),),
               f"sasa_per_atom {label}: areas not finite or of the wrong shape")
        return areas, exposed

    def cmp_counts(label, kern, plain, args):
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        print(f"[kernel] {kern.__name__} {label}: max|d n_vis|={err} (a count), "
              f"{int((got != want).sum())} atoms differ", flush=True)
        _check(err == 0, f"{kern.__name__} {label}: n_vis differs from the plain version")
        errs[kern.__name__].append(float(err))
        return got

    for label, box_arg in (("with the box", box_np), ("box=None", None)):
        areas, exposed = drive(f"{N_WATERS} atoms x {SASA_POINTS} points, {label}", pos_np, vdw,
                               box_arg, "topk", (1, 0))
        launches["sasa_topk"] = 1
        pos = torch.as_tensor(pos_np, device=dev)
        rad = torch.as_tensor(vdw, device=dev) + SASA_PROBE
        box = torch.as_tensor(box_np if box_arg is not None else np.full(3, -1.0, np.float32),
                              device=dev)
        nl = pairs.topk_neighbors(pos, pos, box, k=SASA_K, low_cut=0.0,
                                  high_cut=2.0 * float(rad.max()), row_block=256)
        ok = bool((nl.count <= SASA_K).all())
        slots = sasa.occluder_slots(pos, rad, box, nl)
        t_args, b_args = (pos, rad, pts, *slots), (pos, rad, pts, box)
        n_top = cmp_counts(f"{label} (ok={ok}, at most {int(nl.count.max())} candidates)", tk, tp,
                           t_args)
        n_brute = cmp_counts(label, bk, bp, b_args)
        _check(ok, f"{label}: the certificate failed on the lattice")
        _check(torch.equal(n_top, n_brute), f"{label}: the brute tier differs from the pruned one")
        _check(torch.equal(areas, sasa._areas(rad, n_top, SASA_POINTS))
               and torch.equal(exposed, n_top >= 10),
               f"{label}: sasa_per_atom differs from the kernel's counts")
        print(f"[kernel] {label}: brute tier equals pruned tier on all {N_WATERS} atoms; "
              f"n_vis {int(n_top.min())}..{int(n_top.max())}", flush=True)
        tests_t, tests_b = _sasa_tests(pos, rad, pts, box, slots), _sasa_tests(pos, rad, pts, box)
        ms_t, ms_b = _ms(tk, t_args, 20), _ms(bk, b_args, 5)
        plain_t, plain_b = _ms(tp, t_args, 1), _ms(bp, b_args, 1)
        bound_t = _sasa_bound_ms(N_WATERS, SASA_POINTS, tests_t, SASA_K)
        bound_b = _sasa_bound_ms(N_WATERS, SASA_POINTS, tests_b)
        if box_arg is not None:
            times["sasa_topk"] = (ms_t, plain_t, *bound_t)
            times["sasa_brute"] = (ms_b, plain_b, *bound_b)
        print(f"[time] sasa_topk {label} ({N_WATERS} atoms x {SASA_POINTS} points, K={SASA_K}, "
              f"{tests_t} tests): kernel {ms_t:.5f} ms, plain {plain_t:.3f} ms, bound "
              f"{bound_t[0]:.5f} ms ({bound_t[1]}); {card}", flush=True)
        print(f"[time] sasa_brute {label} ({N_WATERS} atoms x {SASA_POINTS} points x {N_WATERS} "
              f"occluders, {tests_b} tests): kernel {ms_b:.5f} ms, plain {plain_b:.3f} ms, bound "
              f"{bound_b[0]:.5f} ms ({bound_b[1]}); {card}", flush=True)
        del nl, slots, t_args, b_args

    # the certificate fails: 130 atoms within 2 max r of atom 0
    rs = np.random.RandomState(6)
    dirs = rs.normal(size=(SASA_CLUSTER, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    cluster = pos_np[0] + (0.5 + 2.0 * rs.rand(SASA_CLUSTER, 1)) * dirs
    cl_pos = np.concatenate([pos_np, cluster]).astype(np.float32)
    cl_vdw = np.full(len(cl_pos), SASA_VDW, np.float32)
    areas, exposed = drive(f"{len(cl_pos)} atoms (a {SASA_CLUSTER}-atom cluster at atom 0)",
                           cl_pos, cl_vdw, box_np, "brute", (1, 1))
    launches["sasa_brute"] = 1
    cp = torch.as_tensor(cl_pos, device=dev)
    crad = torch.as_tensor(cl_vdw, device=dev) + SASA_PROBE
    cbox = torch.as_tensor(box_np, device=dev)
    want_a, want_e = sasa.sphere_surface_areas(cp, crad, pts, cbox)
    n_plain = cmp_counts("cluster", bk, bp, (cp, crad, pts, cbox))
    _check(torch.equal(areas, want_a) and torch.equal(exposed, want_e)
           and torch.equal(areas, sasa._areas(crad, n_plain, SASA_POINTS)),
           "sasa_per_atom on the cluster differs from the brute tier")

    # a coincident pair: an atom of radius 3.5 on atom 0
    co_pos = torch.as_tensor(np.concatenate([pos_np, pos_np[:1]]), device=dev)
    co_rad = torch.cat([torch.full((N_WATERS,), SASA_VDW, device=dev) + SASA_PROBE,
                        torch.tensor([3.5], device=dev)])
    co_box = torch.as_tensor(box_np, device=dev)
    a_top, _, ok = sasa.sphere_surface_areas_topk(co_pos, co_rad, pts, co_box)
    a_brute, _ = sasa.sphere_surface_areas(co_pos, co_rad, pts, co_box)
    rest = torch.arange(1, N_WATERS, device=dev)
    print(f"[kernel] coincident pair at atom 0: pruned tier area {float(a_top[0]):.4f} A^2, brute "
          f"tier {float(a_brute[0]):.4f} A^2; the other atoms equal: "
          f"{bool(torch.equal(a_top[rest], a_brute[rest]))}", flush=True)
    _check(bool(ok) and float(a_top[0]) > 0.0 and float(a_brute[0]) == 0.0
           and torch.equal(a_top[rest], a_brute[rest]),
           "coincident pair: the pruned tier must leave it out and the brute tier count it")
    del cp, crad, co_pos, co_rad, want_a, want_e

    _stages("sasa_per_atom", lambda d: sasa.sasa_per_atom(pos_np, vdw, box=box_np,
                                                          n_points=SASA_POINTS, device="cuda"))
    _check(sasa.last_tier == "topk", "warm sasa_per_atom left the pruned tier")

    # sasa_calc and sphere_volumes: the card against the port's CPU run
    top, traj = make_water_box(64, n_frames=1, seed=5, solute_elements=["C", "O"])
    sp = traj.positions[0].astype(np.float32)
    srad = (1.2 + 0.6 * np.random.RandomState(2).rand(len(sp))).astype(np.float32)
    sbox = traj.boxes[0].astype(np.float32)
    got = sasa.sasa_calc(sp, sbox, srad, device="cuda")
    want = sasa.sasa_calc(sp, sbox, srad, device="cpu")
    err_c = max(float((g.cpu() - w).abs().max()) for g, w in ((got[0], want[0]), (got[2], want[2])))
    same_acc = torch.equal(got[1].cpu(), want[1])
    v_got = sasa.sphere_volumes(sp, srad, 0.5, 64, device="cuda").cpu()
    v_want = sasa.sphere_volumes(sp, srad, 0.5, 64, device="cpu")
    err_v = float(((v_got - v_want).abs() / v_want.abs().clamp(min=1e-30)).max())
    print(f"[slice] sasa_calc ({len(sp)} atoms x 100 points) on the card vs the CPU: accessible "
          f"equal {same_acc}, max|d| points and sasa {err_c:.3e}; sphere_volumes (64^3 voxels): "
          f"max relative |d| {err_v:.3e}, total {float(v_got.sum()):.3f} A^3", flush=True)
    _check(same_acc and err_c <= 1e-6 * float(want[2].abs().max()) and err_v <= 1e-6,
           "sasa_calc or sphere_volumes differ between the card and the CPU")


def _q_ties(pos, boxes, frames, rows):
    """(M,) bool: the 4th and 5th nearest neighbors of atom rows[m] in frame
    frames[m] (shell (0, 10 A]) lie at exactly equal squared distances in
    the q kernel's arithmetic (wrapped coordinates, two-select minimum
    image, unfused sums), so which one q takes depends on column order."""
    import math
    import torch

    if len(frames) == 0:
        return torch.zeros(0, dtype=torch.bool, device=pos.device)
    L = boxes[frames][:, None, :]
    wrapped = torch.remainder(pos[frames], L)  # (M, N, 3)
    d = wrapped - wrapped[torch.arange(len(frames), device=pos.device), rows][:, None, :]
    d = torch.where(d > L * 0.5, d - L, d)
    d = torch.where(d < -L * 0.5, d + L, d)
    dsq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    dsq = torch.where((dsq > 0.0) & (dsq <= 100.0), dsq, math.inf)
    top = torch.sort(dsq, dim=1).values[:, :5]
    return top[:, 3] == top[:, 4]


def _qtet_legacy_phases(card, kernels, errs, launches, times):
    """The earlier q kernels at 4096 waters: the dense q with its fused
    histogram (one qtet_window_hist launch; q equal to the brute q_window
    form, the histogram to its plain version), the dense q over 1024 frames,
    and the v1 slab q (per-frame z-sort: per-frame window starts, against
    the plain version on 8 frames; frame-0 sort) over 1024 frames, equal to
    the brute q wherever ok and covered."""
    import torch
    from waterorderlib_tpu_torch.ops.cuda import qtet2, qtet_kernel, qtet_sorted, slab

    dev = torch.device("cuda")
    hk, hp = qtet2.q_window_hist, qtet2.q_window_hist_plain
    q_k, q_p = qtet2.q_window, qtet2.q_window_plain
    kernels["qtet_window_hist"] = (hk, hp)
    pos_np, boxes_np = _lattice_traj(N_WATERS, N_FRAMES_SLICE, seed=1)
    pos, boxes = torch.from_numpy(pos_np).to(dev), torch.from_numpy(boxes_np).to(dev)

    torch.cuda.synchronize()
    for k, p in kernels.values():
        k.launches, p.calls = 0, 0
    q, hist = qtet_kernel.order_param_q_dense(pos[0], boxes[0])
    torch.cuda.synchronize()
    ran, plain = (hk.launches, q_k.launches), sum(p.calls for _, p in kernels.values())
    launches["qtet_window_hist"] = hk.launches
    q_brute = qtet2.order_param_q_frames(pos[:1], boxes[:1], row_tile=128)[0]
    cols = slab.brute_cols(pos[:1], boxes[:1])
    args = (cols, cols, torch.zeros(N_WATERS // 128, dtype=torch.int32, device=dev), boxes[:1],
            N_WATERS, 128, 0.0, 100.0, 100.0)
    q_pl, _, h_pl = hp(*args)
    err_h = float((q - q_pl[0]).abs().max())
    print(f"[qtet-legacy] order_param_q_dense {N_WATERS} waters: launches hist/q={ran}, plain "
          f"calls={plain}; q equals the brute q_window form: {bool(torch.equal(q, q_brute))}; "
          f"hist equals the plain version's: {bool(torch.equal(hist, h_pl))} "
          f"({int(hist.sum())} rows in [0, 1]); max|dq| vs plain {err_h:.3e}", flush=True)
    _check(ran == (1, 0) and plain == 0, f"order_param_q_dense launched {ran}, plain {plain}")
    _check(torch.equal(q, q_brute), "the hist kernel's q differs from q_window's brute form")
    _check(torch.equal(hist, h_pl), "the fused histogram differs from its plain version")
    _check(err_h <= Q_TOL, f"dense q: max|dq| {err_h} > {Q_TOL}")
    errs["qtet_window_hist"].append(err_h)
    _cmp_q("dense q, brute form, 1 frame", hk, hp, args, errs["qtet_window_hist"])
    ms = _ms(hk, args, 20)
    plain_ms = _ms(hp, args, 1)
    bound, bound_by = _bound_ms("qtet_window_hist", args, 5)
    times["qtet_window_hist"] = (ms, plain_ms, bound, bound_by)
    print(f"[time] qtet_window_hist, brute form, 1 frame ({N_WATERS} rows, w={N_WATERS}): kernel "
          f"{ms:.5f} ms, plain {plain_ms:.3f} ms, bound {bound:.5f} ms ({bound_by}); {card}",
          flush=True)

    q_f, hist_f = qtet_kernel.order_param_q_dense_frames(pos, boxes)
    q_ref = qtet2.order_param_q_frames(pos, boxes, row_tile=128)
    _check(torch.equal(q_f, q_ref) and int(hist_f.sum()) == int(((q_f >= 0) & (q_f <= 1)).sum()),
           "order_param_q_dense_frames differs from order_param_q_frames")
    print(f"[qtet-legacy] order_param_q_dense_frames {N_WATERS} waters x {N_FRAMES_SLICE} frames: "
          f"q equals order_param_q_frames; hist of {int(hist_f.sum())} values", flush=True)

    # the q kernel at rows 5-7's own launches (1024 frames): the brute form,
    # the per-frame slab form (per-frame window starts) and the frame-0 slab
    # form; each against its plain version on the first 8 frames
    nf, n = N_FRAMES_LEGACY_PLAIN, N_WATERS
    cols_all = slab.brute_cols(pos, boxes)
    pf = slab.slab_prep_frames(pos, boxes, 4.5, 1280, 128, 512)
    pt = slab.slab_prep_traj(pos, boxes, ((4.5, 1536),), 128, 512)
    forms = (
        ("qtet_kernel.py:286", "brute form", (cols_all, cols_all, args[2], boxes, n, 128, 0.0,
                                               100.0, 100.0)),
        ("qtet_sorted.py:192", f"per-frame slab form (w={pf.w})",
         (pf.ext_t[:, :, 512 : 512 + n], pf.ext_t, pf.starts, boxes, pf.w, 128, 0.0, 100.0,
          4.5 * 4.5)),
        ("qtet_sorted.py:315", f"frame-0 slab form (w={pt.ws[0]})",
         (pt.ext_t[:, :, 512 : 512 + n], pt.ext_t, pt.starts[0], boxes, pt.ws[0], 128, 0.0, 100.0,
          4.5 * 4.5)),
    )
    for site, label, full in forms:
        starts = full[2]
        sub = (full[0][:nf], full[1][:nf], starts[:nf] if starts.dim() == 2 else starts,
               full[3][:nf], *full[4:])
        _cmp_q(f"{label}, frames 0-{nf - 1}", q_k, q_p, sub, errs["qtet_window"])
        ms = _ms(q_k, full, 3) / N_FRAMES_SLICE
        plain_ms = _ms(q_p, sub, 1) / nf
        shared = (*full[:2], starts[0] if starts.dim() == 2 else starts, *full[3:])
        bound, bound_by = _bound_ms("qtet_window", shared, 5)
        print(f"[time] qtet_window for {site}, {label} ({n} rows, F={N_FRAMES_SLICE}): kernel "
              f"{ms:.5f} ms/frame, plain {plain_ms:.3f} ms/frame (F={nf}), bound "
              f"{bound / N_FRAMES_SLICE:.5f} ms/frame ({bound_by}); {card}", flush=True)
    del cols_all, pf, pt, forms
    for name, fn in (("order_param_q_sorted", qtet_sorted.order_param_q_sorted),
                     ("order_param_q_sorted_traj", qtet_sorted.order_param_q_sorted_traj)):
        before = q_k.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_s, ok, cov = fn(pos, boxes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        good = ok & cov[:, None]
        apart = good & ((q_s - q_ref).abs() > Q_TOL)
        f_idx, r_idx = torch.nonzero(apart, as_tuple=True)
        ties = _q_ties(pos, boxes, f_idx, r_idx)
        err = float((q_s[good & ~apart] - q_ref[good & ~apart]).abs().max())
        tie_rows = list(zip(f_idx.tolist(), r_idx.tolist(), q_s[apart].tolist(),
                            q_ref[apart].tolist()))
        print(f"[qtet-legacy] {name} {N_WATERS} waters x {N_FRAMES_SLICE} frames: slab tier, "
              f"q_window launches={q_k.launches - before}, covered on {int(cov.sum())} frames, ok "
              f"on {float(ok.float().mean()):.6f} of rows; max|dq| vs brute where ok and covered "
              f"{err:.3e}, but for {len(f_idx)} rows (frame, atom, slab q, brute q) "
              f"{tie_rows[:8]} whose 4th and 5th neighbors lie at "
              f"exactly equal distances ({int(ties.sum())} of them): the tie goes to the lower "
              f"column, z-sorted here and in atom order in the brute form; {wall:.3f} s",
              flush=True)
        _check(bool(cov.all()) and float(good.float().mean()) > 0.999 and err <= Q_TOL
               and bool(ties.all()) and q_k.launches - before == 1,
               f"{name}: not certified, or differs from brute q other than at an exact tie")
        errs["qtet_window"].append(err)
        # the frames holding those ties: the kernel takes the lower column
        # of a tie as its plain version does, in both forms
        tie_frames = sorted(set(f_idx.tolist()))[:8]
        if tie_frames and name == "order_param_q_sorted":
            fr = torch.tensor(tie_frames, device=dev)
            cols_tie = slab.brute_cols(pos[fr], boxes[fr])
            _cmp_q(f"brute form, the {len(tie_frames)} frames of those ties", q_k, q_p,
                   (cols_tie, cols_tie, args[2], boxes[fr].contiguous(), n, 128, 0.0, 100.0,
                    100.0), errs["qtet_window"])


def _vor_system(n_waters, n_frames, seed, solute=None):
    """make_water_box's system and its heavy atoms (the waters first),
    as voronoi_calc takes them: (top, traj, heavy, n_waters)."""
    import numpy as np
    from waterorderlib_tpu_torch.io.synthetic import make_water_box

    top, traj = make_water_box(n_waters, n_frames=n_frames, seed=seed, solute_elements=solute)
    heavy = np.concatenate([top.get_wat_inds("WAT")[0], top.get_sol_inds("WAT")[0]])
    return top, traj, heavy, n_waters


def _vor_cmp(label, kern, plain, args, errs):
    """Kernel against plain version on the same inputs: dist and payload
    exactly equal. Returns the kernel's output."""
    import torch

    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    both = torch.isfinite(got[0]) & torch.isfinite(want[0])
    err = float((got[0] - want[0])[both].abs().max()) if bool(both.any()) else 0.0
    print(f"[kernel] {kern.__name__} {label}: dist max|d|={err:.3e}, payloads differ in "
          f"{int((got[1] != want[1]).sum())} of {got[1].numel()} slots, "
          f"{int(torch.isfinite(got[0]).sum())} filled", flush=True)
    _check(same and bool((torch.isfinite(got[0]) == torch.isfinite(want[0])).all()),
           f"{kern.__name__} {label}: differs from the plain version")
    errs[kern.__name__].append(err)
    return got


def _vor_cmp_mappings(label, args, errs):
    """The cell-grid kernel against its plain version, exactly, in the
    mapping the wrapper picks for these rows and, where its staged cells
    fit a block, in the other one (rows grouped by cell, or one warp a row).
    Returns the picked mapping's output and its name."""
    from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vtopk

    ck, cp = vtopk.voronoi_cellgrid_topk, vtopk.voronoi_cellgrid_topk_plain
    centers, _, _, tbl_idx, n_side, _ = args
    picked = vtopk._cellgrid_grouped(centers.shape[1], n_side, tbl_idx.shape[-1])
    names = {True: "grouped", False: "direct"}
    got = _vor_cmp(f"{label}, {names[picked]} mapping (picked)", ck, cp, args, errs)
    if picked or vtopk.grouped_smem(tbl_idx.shape[-1]) <= vtopk.SMEM_MAX:
        pick = vtopk._cellgrid_grouped
        vtopk._cellgrid_grouped = lambda *_: not picked
        try:
            _vor_cmp(f"{label}, {names[not picked]} mapping", ck, cp, args, errs)
        finally:
            vtopk._cellgrid_grouped = pick
    return got, names[picked]


def _captured_vtopk(fn, *names):
    """Run fn; the arguments of every launch it made of each search wrapper
    `names` of ops/cuda/voronoi_topk.py, {name: [args, ...]} (each launch
    runs as usual and is counted by its wrapper)."""
    from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vtopk

    real = {name: getattr(vtopk, name) for name in names}
    seen = {name: [] for name in names}

    def recorder(name):
        def record(*args):
            seen[name].append(args)
            return real[name](*args)

        return record

    for name in names:
        setattr(vtopk, name, recorder(name))
    try:
        fn()
    finally:
        for name in names:
            setattr(vtopk, name, real[name])
    return seen


def _vor_cmp_splits(label, args, errs):
    """The window kernel against its plain version, exactly, at the warps a
    row (`_window_split`) the wrapper picks for these rows and at each
    other split. Returns the picked split's output."""
    from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vtopk

    wk, wp = vtopk.voronoi_window_topk, vtopk.voronoi_window_topk_plain
    pick = vtopk._window_split
    picked = pick(args[0].shape[0] * args[0].shape[1])
    got = _vor_cmp(f"{label}, {picked} warps a row (picked)", wk, wp, args, errs)
    try:
        for split in vtopk.WINDOW_SPLITS:
            if split != picked:
                vtopk._window_split = lambda _, s=split: s
                _vor_cmp(f"{label}, {split} warps a row", wk, wp, args, errs)
    finally:
        vtopk._window_split = pick
    return got


def _vor_tie_args(k, dev):
    """A full scan whose one row ties at its k-th distance on both sides
    (tests/test_torch_voronoi_topk_kernel_design.py's fixture): the row at
    O = (50, 50, 50), itself a candidate; k - 2 candidates within 5.9 A and
    2 A in z; six at exactly 6 A along the axes (dsq 36), so P- = O - 6 z and
    P+ = O + 6 z have fl(dz*dz) equal to the k-th dsq; 40 far in x at each of
    z = 44 and z = 56, P- first and P+ last of its z in the stable order;
    400 between 6.05 and 6.7 A with 2 < |dz| < 5.5 (their merges bring the
    bound down to the k-th dsq before the scan reaches z = 44); 300 fillers
    far in x. Slots k - 1 and k go to P- and the first of those at z = 50:
    a side stopped at fl(dz*dz) >= the bound would lose P-."""
    import numpy as np
    import torch

    rs = np.random.RandomState(k)
    inner, shell = [], []
    while len(inner) < k - 2:
        v = np.round(rs.uniform(-5.9, 5.9, 3) * 16.0) / 16.0
        if 0.0 < np.dot(v, v) < 5.9**2 and abs(v[2]) < 2.0:
            inner.append(v)
    while len(shell) < 400:
        v = rs.normal(size=3)
        v *= rs.uniform(6.05, 6.7) / np.linalg.norm(v)
        if 2.0 < abs(v[2]) < 5.5:
            shell.append(v)
    axes = np.array([[0, 0, -6], [6, 0, 0], [-6, 0, 0], [0, 6, 0], [0, -6, 0], [0, 0, 6]])
    block = [[20.0 + 0.5 * i, 0.0, dz] for dz in (-6.0, 6.0) for i in range(40)]
    fill = np.stack([rs.uniform(15.0, 30.0, 300) * rs.choice([-1, 1], 300),
                     rs.uniform(-30.0, 30.0, 300), rs.uniform(-36.0, 36.0, 300)], -1)
    cand = np.concatenate([[[0.0, 0.0, 0.0]], axes[:1], inner, axes[1:5], block, axes[5:], fill,
                           shell]) + 50.0
    ext = cand[np.argsort(cand[:, 2], kind="stable")].astype(np.float32)
    return (torch.full((1, 1, 3), 50.0, device=dev), torch.as_tensor(ext, device=dev)[None],
            torch.zeros((1, 1), dtype=torch.int32, device=dev), k, 1, ext.shape[0])


def _device_us(ev):
    t = getattr(ev, "self_device_time_total", None)
    return t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)


def _is_kernel(ev):
    """A device activity (a kernel or a copy), not a host operator, nor the
    port's own `wol.*` ranges, which the profiler lists on the device too."""
    if ev.key.startswith("wol."):
        return False
    kind = getattr(ev, "device_type", None)
    if kind is not None:
        return "CUDA" in str(kind)
    return not ev.key.startswith(("aten::", "cuda"))


def _device_ms(fn, args, name, calls=3):
    """Device time of the kernels whose name holds `name` in one warm call of
    fn(*args) (torch.profiler, the mean over `calls` calls): the kernel
    alone, without its wrapper's own PyTorch work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    return sum(_device_us(ev) for ev in prof.key_averages()
               if _is_kernel(ev) and name in ev.key) / 1e3 / calls


def _profile_line(label, fn, top=8, named=("cellgrid_", "voronoi_cells_kernel")):
    """One warm call of fn under torch.profiler: device time by kernel name
    (the `top` largest, and every kernel whose name holds one of `named`),
    their sum against the call's wall time (the card's busy share), printed
    as one line. Returns {name: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if _is_kernel(ev) and _device_us(ev) > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + _device_us(ev) / 1e3
    busy = sum(by_name.values())
    top_k = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    top_k += [kv for kv in by_name.items() if kv not in top_k and any(n in kv[0] for n in named)]
    _check(busy > 0, f"{label}: the profiler saw no device time")
    print(f"[profile] {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms ({busy / wall:.1%}; "
          f"idle {1 - busy / wall:.1%}) in {len(by_name)} kernels; largest: "
          + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top_k), flush=True)
    return by_name


def _vor_window_args(vd, centers, ext, k, row_block, win):
    """The window kernel's arguments as _windowed_topk makes them."""
    import torch

    _, exts, _, cs, start = vd._window_prep(centers, ext, row_block, win)
    return (cs, exts, start.to(torch.int32).contiguous(), k, row_block, win)


def _vor_cellgrid_args(vd, centers, ext, box_l, k, cg):
    """The cell-grid kernel's arguments as _cellgrid_topk makes them from
    _cellgrid_build's grid, and the grid."""
    grid = vd._cellgrid_build(ext, box_l, cg[0], cg[1])
    _, cid = vd._cellgrid_rows(centers, grid[4], cg[0])
    return (centers.contiguous(), cid, grid[0], grid[1], cg[0], k), grid


def _vor_cellgrid_lanes(args):
    """Candidate lanes the rows' 27 cells hold (their members, not the
    empty slots): the search's data-dependent work."""
    import torch
    from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vtopk

    centers, cid, _, tbl_idx, n_side, _ = args
    count = (tbl_idx >= 0).sum(-1)  # (F, n_cells)
    offs = torch.tensor(vtopk._offsets(n_side), device=cid.device)
    cells = (cid.long()[..., None] + offs).reshape(cid.shape[0], -1)
    return int(torch.gather(count, 1, cells).sum())


def _vor_bound_ms(lanes, in_bytes, rows, k):
    """Least time of one search launch: VOR_LANE_FLOPS per (row, lane) over
    the float32 peak, or the bytes (each input read once, dist and payload
    written once) over the memory rate. Returns (ms, bound_by)."""
    t_ops = lanes * VOR_LANE_FLOPS / PEAK_FP32 * 1e3
    t_bytes = (in_bytes + rows * k * 8) / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _vor_window_lanes(args):
    """(lanes a window launch needs, lanes its windows hold, its (rows, win)
    squared distances for torch.topk): per row, the candidates of its window
    whose fl(dz*dz) is at most its k-th dsq, the rest lying beyond the
    kernel's exact stop (all of them where the window holds fewer than k
    candidates with 0 < dsq < inf); dsq formed as the kernel forms it."""
    import math

    import torch

    cs, exts, start, k, rb, win = args
    F, R, _ = cs.shape
    lanes = torch.arange(win, device=cs.device)
    needed, out = 0, []
    for f in range(F):
        cand = exts[f][start[f].long()[:, None] + lanes]  # (nb, win, 3)
        c = cs[f].reshape(-1, rb, 3)
        dx, dy, dz = (c[:, :, None, a] - cand[:, None, :, a] for a in range(3))
        dz2 = (dz * dz).reshape(R, win)
        dsq = ((dx * dx + dy * dy) + dz * dz).reshape(R, win)
        kept = torch.where((dsq > 0) & (dsq < math.inf), dsq, torch.full_like(dsq, math.inf))
        kth = torch.topk(kept, min(k, win), largest=False).values[:, -1]
        needed += int((dz2 <= kth[:, None]).sum())
        out.append(dsq)
    return needed, F * R * win, torch.cat(out)


def _vor_dsq_cellgrid(args):
    """The (rows, 27 cap) squared-distance matrix of a cell-grid launch,
    parked slots at +inf, for torch.topk's time."""
    import torch
    from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vtopk

    centers, cid, tbl_pos, _, n_side, _ = args
    F, R, _ = centers.shape
    cap = tbl_pos.shape[-1]
    offs = torch.tensor(vtopk._offsets(n_side), device=cid.device)
    out = []
    for f in range(F):
        planes = tbl_pos[f][cid[f].long()[:, None] + offs]  # (R, 27, 3, cap)
        d = centers[f][:, :, None, None] - planes.permute(0, 2, 1, 3)  # (R, 3, 27, cap)
        out.append((d * d).sum(1).reshape(R, 27 * cap))
    return torch.cat(out)


def _voronoi_kernel_checks(card, kernels, errs):
    """Both forms of csrc/voronoi_topk.cu against their plain versions,
    exactly, at the main path's shapes: the window form at 12,294 points
    (k 64, _suggest_win's window), its full scan at k 256 on 64 rows and on
    rows at both ends of the z-sorted array and beyond it, and at 2,048
    waters on the pruned mirror set, each at every split (warps a row); the
    cell-grid form at 12,294 points (k 64, s_factor 1.12) and at k 96, 128
    and 192 on a 2,048-row subset (s_factor 1.4); planted ties: four
    candidates at one distance in a window, a tie at the k-th distance on
    both sides of a full scan's row (k 96 and 256), and one across cells."""
    import numpy as np
    import torch
    from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vtopk
    from waterorderlib_tpu_torch.surface import voronoi_device as vd

    dev = torch.device("cuda")
    wk, wp = vtopk.voronoi_window_topk, vtopk.voronoi_window_topk_plain
    ck, cp = vtopk.voronoi_cellgrid_topk, vtopk.voronoi_cellgrid_topk_plain
    kernels["voronoi_window_topk"] = (wk, wp)
    kernels["voronoi_cellgrid_topk"] = (ck, cp)
    _, traj, heavy, _ = _vor_system(VOR_N, 1, 7, VOR_SOLUTE)
    n = len(heavy)
    box_l = float(traj.boxes[0][0])
    pts = torch.as_tensor(traj.positions[0][heavy], dtype=torch.float32, device=dev)[None]
    box_t = torch.tensor([box_l], dtype=torch.float32, device=dev)
    ext = vd.mirror_points_device(pts, box_t)
    p4 = ext.shape[1]
    win = vd._suggest_win(n, p4, box_l, 64)
    _vor_cmp_splits(f"{n} points, k 64, win {win} of {p4}",
                    _vor_window_args(vd, pts, ext, 64, 256, win), errs)
    rs = np.random.RandomState(3)
    last = torch.as_tensor(rs.choice(n, VOR_LAST_ROWS, replace=False), device=dev)
    full = _vor_window_args(vd, pts[:, last], ext, 256, VOR_LAST_ROWS, p4)
    _vor_cmp_splits(f"full scan, k 256, {VOR_LAST_ROWS} rows x {p4} candidates", full, errs)
    # rows at both ends of the z-sorted candidates (on candidates 0, 1, 2 and
    # the last three) and 3 A beyond them
    e, up = full[1][0], torch.tensor([0.0, 0.0, 3.0], device=dev)
    ends = torch.stack([e[0] - up, e[0], e[1], e[2], e[-3], e[-2], e[-1], e[-1] + up])[None]
    _vor_cmp_splits("full scan, k 256, 8 rows at the array's ends", (
        ends.contiguous(), full[1], torch.zeros((1, 1), dtype=torch.int32, device=dev), 256, 8,
        p4), errs)
    for kt in (96, 256):
        targs = _vor_tie_args(kt, dev)
        got = _vor_cmp_splits(f"full scan, k {kt}, a tie at the k-th distance on both sides of "
                              f"the row", targs, errs)
        z_kept = targs[1][0, got[1][0, 0].long(), 2]
        _check(float(got[0][0, 0, kt - 1]) == 6.0 and int((got[0][0, 0] == 6.0).sum()) == 2
               and bool((z_kept == 44.0).any()) and not bool((z_kept == 56.0).any()),
               f"planted k-th tie at k {kt}: not the two lowest tied positions")
    cg = vd._suggest_cellgrid(n, box_l, 64)
    _check(cg is not None, f"no cell grid at {n} points")
    args, _ = _vor_cellgrid_args(vd, pts, ext, box_t, 64, cg)
    _vor_cmp_mappings(f"{n} points, k 64, grid {cg}", args, errs)
    sub = torch.as_tensor(rs.choice(n, VOR_SUBSET, replace=False), device=dev)
    for ks in (96, 128, 192):
        cg2 = vd._suggest_cellgrid(n, box_l, ks, s_factor=1.4)
        _check(cg2 is not None, f"no escalation grid at k {ks}")
        args, _ = _vor_cellgrid_args(vd, pts[:, sub], ext, box_t, ks, cg2)
        _vor_cmp_mappings(f"{VOR_SUBSET}-row subset, k {ks}, grid {cg2}", args, errs)
    _, traj2, heavy2, _ = _vor_system(VOR_SMALL, 1, 8)
    box2 = float(traj2.boxes[0][0])
    pts2 = torch.as_tensor(traj2.positions[0][heavy2], dtype=torch.float32, device=dev)[None]
    budget = vd._suggest_mirror_budget(len(heavy2), box2, 64)
    _check(budget > 0, f"no mirror pruning at {VOR_SMALL} waters")
    ext2, _, _ = vd.mirror_points_pruned(pts2, torch.tensor([box2], device=dev), budget)
    win2 = vd._suggest_win(len(heavy2), ext2.shape[1], box2, 64)
    _vor_cmp_splits(f"{VOR_SMALL} waters, pruned mirrors ({ext2.shape[1]}), k 64, win {win2}",
                    _vor_window_args(vd, pts2, ext2, 64, 256, win2), errs)
    # a planted tie: four candidates at one distance (lanes 3, 7, 40, 41)
    # and a coincident one (lane 10, dropped); the lowest lanes win
    c = torch.zeros((1, 8, 3), device=dev)
    e = torch.full((1, 64, 3), 50.0, device=dev)
    e[0, :, 0] += torch.arange(64, device=dev, dtype=torch.float32)
    for lane in (3, 7, 40, 41):
        e[0, lane] = torch.tensor([1.0, 0.0, 0.0] if lane % 2 else [0.0, 1.0, 0.0], device=dev)
    e[0, 10] = 0.0
    got = _vor_cmp("a planted 4-way tie", wk, wp,
                   (c, e, torch.zeros((1, 1), dtype=torch.int32, device=dev), 3, 8, 64), errs)
    _check(got[1][0, 0].tolist() == [3, 7, 40] and bool((got[0][0, :, :3] == 1.0).all()),
           f"planted tie: lanes {got[1][0, 0].tolist()}, not [3, 7, 40]")
    # the tie across cells (tests/test_torch_voronoi_topk.py): three
    # candidates at distance 1 in cells 20 (slot 1), 4 (slots 2 and 0) of a
    # 3x3x3 grid and a coincident one in the row's own cell 13 (dropped):
    # cells in lane order, then slots, win
    tbl = torch.full((1, 27, 3, 4), float("inf"), device=dev)
    ids = torch.full((1, 27, 4), -1, dtype=torch.int32, device=dev)
    for cell, slot, xyz, cid in ((20, 1, (0.0, 0.0, 1.0), 5), (4, 2, (0.0, 1.0, 0.0), 9),
                                 (4, 0, (1.0, 0.0, 0.0), 2), (13, 0, (0.0, 0.0, 0.0), 7)):
        tbl[0, cell, :, slot] = torch.tensor(xyz, device=dev)
        ids[0, cell, slot] = cid
    got, _ = _vor_cmp_mappings("a planted cross-cell tie", (
        c[:, :1].contiguous(), torch.tensor([[13]], dtype=torch.int32, device=dev), tbl, ids, 3, 4),
        errs)
    _check(got[1][0, 0].tolist() == [2, 9, 5, -1] and got[0][0, 0, :3].tolist() == [1.0] * 3,
           f"planted cross-cell tie: ids {got[1][0, 0].tolist()}, not [2, 9, 5, -1]")
    del pts, ext, pts2, ext2
    torch.cuda.empty_cache()


def _vor_drive(label, kernels, fn):
    """Drive a Voronoi path with every kernel's and plain version's count
    and the tier statistics at 0: (result, {kernel: launches}, tiers,
    plain calls, wall s)."""
    import torch
    from waterorderlib_tpu_torch.surface import voronoi_device as vd

    torch.cuda.synchronize()
    for k, p in kernels.values():
        k.launches, p.calls = 0, 0
    vd.tier_stats.clear()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = {name: kernels[name][0].launches for name in ("voronoi_window_topk",
                                                         "voronoi_cellgrid_topk", "voronoi_cells")
           if name in kernels}
    plain = sum(p.calls for _, p in kernels.values())
    tiers = {str(k): dict(v) for k, v in vd.tier_stats.items()}
    print(f"[slice] {label}: launches {ran}, plain calls {plain}, wall {wall:.3f} s", flush=True)
    print(f"[tiers] {label}: {json.dumps(tiers)}", flush=True)
    _check(plain == 0, f"{label} called a plain version")
    return res, ran, dict(vd.tier_stats), wall


def _voronoi_phases(card, kernels, errs, launches, times):
    """The Voronoi volumes slice: both kernel forms against their plain
    versions; voronoi_calc(engine="device") at 12,294 points x 32 frames in
    two chunks of 16 (tier 1 and the escalation tiers on the cell-grid
    form; the last tier, if any row reaches it, on the window form's full
    scan; the clip builder's cells on the cell kernel at every tier up to
    (64, 128), its launches the kernels line's), against Qhull in float64
    and the host engine on frames 0-1, and chunk_frames=1 against 16 on 2
    frames; voronoi_calc at 2,048 waters x
    16 frames (tier 1 on the window form, pruned mirrors); each form's
    times at its main-path launches beside its bound, its plain version and
    torch.topk; a warm voronoi_calc on the stage clock."""
    import numpy as np
    import torch
    from waterorderlib_tpu_torch.drivers.voronoi_driver import voronoi_calc
    from waterorderlib_tpu_torch.ops.cuda import voronoi_cells as vcells
    from waterorderlib_tpu_torch.surface import voronoi_device as vd
    from waterorderlib_tpu_torch.surface.voronoi import voronoi_volumes

    dev = torch.device("cuda")
    _voronoi_kernel_checks(card, kernels, errs)
    ck, cp = kernels["voronoi_cellgrid_topk"]
    kernels["voronoi_cells"] = (vcells.voronoi_cells_fused, vcells.voronoi_cells_fused_plain)

    top, traj, heavy, nw = _vor_system(VOR_N, VOR_FRAMES, 0, VOR_SOLUTE)

    def calc(t, tr, **kw):
        with tempfile.TemporaryDirectory() as d:
            res = voronoi_calc(t, tr, output_dir=d, device="cuda", **kw)
            files = {f: np.loadtxt(os.path.join(d, f)) for f in sorted(os.listdir(d))}
        return res, files

    (res, files), ran, tiers, wall = _vor_drive(
        f"voronoi_calc {len(heavy)} points x {VOR_FRAMES} frames (engine device, chunks of 16)",
        kernels, lambda: calc(top, traj, engine="device"))
    launches["voronoi_cellgrid_topk"] = ran["voronoi_cellgrid_topk"]
    launches["voronoi_cells"] = ran["voronoi_cells"]
    _check(set(v["cells"] for k, v in tiers.items() if k != "host") == {"clip"}
           and _on_kernel_whole(ran, tiers, VOR_FRAMES * nw),
           f"voronoi_calc: the cell kernel did not build the clip builder's cells once a chunk at "
           f"each tier up to k {vcells.MAX_K}, on its real rows: {ran}, {tiers}")
    t1 = tiers.get((32, 64), {})
    _check(t1.get("form") == "cellgrid" and ran["voronoi_cellgrid_topk"] >= 2,
           f"tier 1 at {len(heavy)} points was not served by the cell-grid form: {t1}")
    last_ran = (128, 256) in tiers
    _check(not last_ran or (tiers[(128, 256)]["form"] == "full"
                            and ran["voronoi_window_topk"] == tiers[(128, 256)]["launches"]),
           "the last tier was not the window form's full scan")
    print(f"[slice] voronoi_calc: the last tier (128, 256) ran: {last_ran}; means "
          f"{[float(r[0][0]) for r in res]}", flush=True)
    _check(len(files) == 3 and all(h.shape == (500, 2) and h[:, 1].sum() > 0
                                   for h in files.values()), "voronoi_calc: histogram files")
    _check(all(np.all(np.isfinite(np.asarray(a))) for r in res for a in r),
           "voronoi_calc: statistics not finite")
    n_pts_frames = VOR_FRAMES * nw
    n_host = tiers.get("host", {}).get("rows", 0)
    print(f"[slice] voronoi_calc: {n_pts_frames} cells, certified per tier "
          + ", ".join(f"{k}: {v.get('certified', 0)} of {v['rows']} rows searched ({v['form']}, "
                      f"{v['launches']} launches)" for k, v in tiers.items() if k != "host")
          + f"; host closes {n_host} ({tiers.get('host', {}).get('full_search', 0)} by a full "
          f"host search); wall {wall:.3f} s; {card}", flush=True)

    # frames 0-1 against Qhull in float64 and the host engine
    pos01 = traj.positions[:2][:, heavy]
    box01 = traj.boxes[:2, 0].astype(np.float64)
    vol_d, area_d, n_c = vd.voronoi_volumes_hybrid_frames(pos01, box01, nw, device="cuda")
    worst = worst_mean = 0.0
    for t in range(2):
        vh, ah = voronoi_volumes(pos01[t].astype(np.float64), float(box01[t]), nw)
        worst = max(worst, float(np.max(np.abs(vol_d[t] - vh) / vh)),
                    float(np.max(np.abs(area_d[t] - ah) / ah)))
        worst_mean = max(worst_mean, abs(vol_d[t].mean() - vh.mean()) / vh.mean(),
                         abs(area_d[t].mean() - ah.mean()) / ah.mean())
    print(f"[slice] frames 0-1 ({2 * nw} cells, {n_c} device-certified) against Qhull float64: "
          f"max relative error of a cell's volume or area {worst:.3e} (limit {VOR_REF_TOL}), of "
          f"a frame's mean {worst_mean:.3e} (limit {VOR_MEAN_TOL})", flush=True)
    _check(worst <= VOR_REF_TOL and worst_mean <= VOR_MEAN_TOL,
           "voronoi volumes differ from Qhull beyond the float32 band")
    res_host, _ = calc(top, traj[:2], engine="host")
    res_dev, _ = calc(top, traj[:2], engine="device")
    gap = max(abs(float(a[0][0]) - float(b[0][0])) / abs(float(b[0][0]))
              for a, b in zip(res_dev, res_host) if float(b[0][0]) != 0.0)
    res_one, _ = calc(top, traj[:2], engine="device", chunk_frames=1)
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(res_dev, res_one))
    print(f"[slice] voronoi_calc frames 0-1: device against host engine, largest relative gap "
          f"of the six means {gap:.3e} (limit {VOR_MEAN_TOL}); chunk_frames=1 equals 16: {same}",
          flush=True)
    _check(gap <= VOR_MEAN_TOL, "voronoi_calc: device and host engines differ")
    _check(same, "voronoi_calc: chunk_frames=1 differs from one chunk")

    # 2,048 waters: tier 1 on the window form, pruned mirrors
    top2, traj2, heavy2, nw2 = _vor_system(VOR_SMALL, VOR_SMALL_FRAMES, 5)
    (res2, files2), ran2, tiers2, wall2 = _vor_drive(
        f"voronoi_calc {len(heavy2)} points x {VOR_SMALL_FRAMES} frames (engine device)",
        kernels, lambda: calc(top2, traj2, engine="device"))
    launches["voronoi_window_topk"] = ran2["voronoi_window_topk"]
    _check(tiers2.get((32, 64), {}).get("form") == "window" and ran2["voronoi_window_topk"] >= 1,
           f"tier 1 at {VOR_SMALL} waters was not served by the window form: {tiers2}")
    _check(all(np.all(np.isfinite(np.asarray(a))) for r in res2 for a in r),
           "voronoi_calc at 2,048 waters: statistics not finite")
    print(f"[slice] voronoi_calc {VOR_SMALL} waters: means {[float(r[0][0]) for r in res2]}",
          flush=True)

    # times at the main path's launches: the cell-grid form's tier 1 of a
    # 16-frame chunk at 12,294 points; the window form's launches captured
    # from voronoi_volumes_hybrid_frames: (a) the last tier's full scan of
    # that chunk, (b) tier 1 at 2,048 waters x 16 frames (pruned mirrors),
    # (c) and (d) that call's (48, 96) and (64, 128) full scans
    pb = torch.as_tensor(traj.positions[:16][:, heavy], device=dev)
    bl = torch.as_tensor(traj.boxes[:16, 0], device=dev)
    cg = vd._suggest_cellgrid(len(heavy), float(bl.min()), 64)
    c_args, _ = _vor_cellgrid_args(vd, pb[:, :nw], vd.mirror_points_device(pb, bl), bl, 64, cg)
    rows = c_args[0].shape[0] * c_args[0].shape[1]
    lanes = _vor_cellgrid_lanes(c_args)
    dsq = _vor_dsq_cellgrid(c_args)
    ms, plain_ms = _ms(ck, c_args, 5), _ms(cp, c_args, 1)
    lib_ms = _ms(lambda x: torch.topk(x, 64, largest=False), (dsq,), 5)
    alone = _device_ms(ck, c_args, "cellgrid_")
    # centers, cell ids; table slots
    bound, bound_by = _vor_bound_ms(lanes, 16 * rows + 16 * c_args[3].numel(), rows, 64)
    times["voronoi_cellgrid_topk"] = (ms, plain_ms, bound, bound_by, lib_ms)
    print(f"[time] voronoi_cellgrid_topk, tier 1 of a {c_args[0].shape[0]}-frame batch ({rows} "
          f"rows x 27 cells of cap {c_args[3].shape[-1]}, grid {cg}, {lanes} lanes): kernel "
          f"{ms:.5f} ms (its kernels alone on the card {alone:.5f} ms), plain {plain_ms:.3f} ms, "
          f"torch.topk on the {tuple(dsq.shape)} distances {lib_ms:.5f} ms, bound {bound:.5f} ms "
          f"({bound_by}); {card}", flush=True)
    del dsq, c_args
    seen, w_launches = _vor_launches((traj, heavy, nw), (traj2, heavy2, nw2))
    _vor_window_times(card, errs, times, w_launches)
    # the escalation tiers of a 16-frame chunk at their own shapes: the rows
    # that reach each tier, its grid (_suggest_cellgrid, s_factor 1.4) and k
    _check(len(seen) >= 2 and seen[0][5] == 64,
           f"the chunk's cell-grid launches: k {[a[5] for a in seen]}")
    for args in seen[1:]:
        centers, _, _, tbl_idx, n_side, k = args
        rows, grid = centers.shape[0] * centers.shape[1], (n_side, tbl_idx.shape[-1])
        _, mapping = _vor_cmp_mappings(f"escalation tier k {k} of a 16-frame chunk, {rows} rows, "
                                       f"grid {grid}", args, errs)
        lanes, dsq = _vor_cellgrid_lanes(args), _vor_dsq_cellgrid(args)
        ms, plain_ms = _ms(ck, args, 5), _ms(cp, args, 1)
        alone = _device_ms(ck, args, "cellgrid_")
        lib_ms = _ms(lambda x, k=k: torch.topk(x, k, largest=False), (dsq,), 5)
        bound, bound_by = _vor_bound_ms(lanes, 16 * rows + 16 * tbl_idx.numel(), rows, k)
        print(f"[time] voronoi_cellgrid_topk, escalation tier k {k} of a 16-frame chunk ({rows} "
              f"rows, {centers.shape[1]} a frame, x 27 cells of cap {grid[1]}, grid {grid}, "
              f"{mapping} mapping, {lanes} lanes): kernel {ms:.5f} ms (alone on the card "
              f"{alone:.5f} ms), plain {plain_ms:.3f} ms, torch.topk on the {tuple(dsq.shape)} "
              f"distances {lib_ms:.5f} ms, bound {bound:.5f} ms ({bound_by}); {card}", flush=True)
        del dsq
    del seen, pb, bl
    torch.cuda.empty_cache()
    _stages("voronoi_calc", lambda d: voronoi_calc(top, traj[:16], output_dir=d,
                                                   engine="device", device="cuda"))


def _vor_launches(chunk, small):
    """The search launches of voronoi_volumes_hybrid_frames, captured: on
    the first 16 frames of `chunk` (traj, heavy, n_waters; 12,294 points)
    the cell-grid form's (tier 1 and the escalation tiers) and the window
    form's (a), the last tier's full scan; on `small` (2,048 waters x 16
    frames, pruned mirrors at tier 1) the window form's (b) tier 1, (c) and
    (d) the (48, 96) and (64, 128) full scans. Returns (the cell-grid
    launches, [(a), (b), (c), (d)])."""
    import numpy as np
    from waterorderlib_tpu_torch.surface import voronoi_device as vd

    (traj, heavy, nw), (traj2, heavy2, nw2) = chunk, small
    seen = _captured_vtopk(lambda: vd.voronoi_volumes_hybrid_frames(
        traj.positions[:16][:, heavy], traj.boxes[:16, 0].astype(np.float64), nw, device="cuda"),
        "voronoi_cellgrid_topk", "voronoi_window_topk")
    rest = _captured_vtopk(lambda: vd.voronoi_volumes_hybrid_frames(
        traj2.positions[:, heavy2], traj2.boxes[:, 0].astype(np.float64), nw2, device="cuda"),
        "voronoi_window_topk")["voronoi_window_topk"]
    _check(len(seen["voronoi_window_topk"]) == 1 and len(rest) == 3,
           f"the window form's launches: {len(seen['voronoi_window_topk'])} at {len(heavy)} "
           f"points (the last tier), {len(rest)} at {len(heavy2)} points (tiers 1-3)")
    return seen["voronoi_cellgrid_topk"], seen["voronoi_window_topk"] + rest


def _vor_window_times(card, errs, times, launches):
    """The window form at its four main-path launches (`_vor_launches`),
    each equal to its plain version at every split; its time, the plain
    version's, torch.topk's at the launch's k, the lanes the data needs,
    the kernel tests and the windows hold, and the bound (its kernel's own
    device time: `--alone vor`). Puts (b) in `times`."""
    import torch
    from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vtopk

    dev = torch.device("cuda")
    wk, wp = vtopk.voronoi_window_topk, vtopk.voronoi_window_topk_plain
    for tag, args in zip("abcd", launches):
        cs, exts, starts, k, _, win = args
        rows = cs.shape[0] * cs.shape[1]
        label = (f"launch ({tag}), {cs.shape[0]} frames x {cs.shape[1]} rows x win {win} of "
                 f"{exts.shape[1]}, k {k}")
        _vor_cmp_splits(label, args, errs)
        needed, in_window, dsq = _vor_window_lanes(args)
        tested = torch.zeros(1, dtype=torch.int64, device=dev)
        wk(*args, tested=tested)
        ms, plain_ms = _ms(wk, args, 5), _ms(wp, args, 1)
        lib_ms = _ms(lambda x, k=k: torch.topk(x, k, largest=False), (dsq,), 5)
        in_bytes = 12 * rows + 12 * exts.shape[0] * exts.shape[1] + 4 * starts.numel()
        bound, bound_by = _vor_bound_ms(needed, in_bytes, rows, k)
        w_bound, w_by = _vor_bound_ms(in_window, in_bytes, rows, k)
        if tag == "b":
            times["voronoi_window_topk"] = (ms, plain_ms, bound, bound_by, lib_ms)
        print(f"[time] voronoi_window_topk {label} ({vtopk._window_split(rows)} warps a row): "
              f"kernel {ms:.5f} ms, plain {plain_ms:.3f} ms, torch.topk (k {k}) on the "
              f"{tuple(dsq.shape)} distances {lib_ms:.5f} ms; lanes needed {needed} (fl(dz*dz) "
              f"<= the row's k-th dsq), tested by the kernel {int(tested)}, in the windows "
              f"{in_window}; bound {bound:.5f} ms ({bound_by}; on the windows' lanes "
              f"{w_bound:.5f} ms, {w_by}); {card}", flush=True)
        del dsq


def _cells_args(vd, pb, bl, k, ks, n_centers=None, rows=None):
    """The fused cell kernel's arguments as the main path makes them
    (`_search_rows`, then `_fused_inputs`) for tier 1 of a frame batch pb
    (F, P, 3): the centers pb[:, :n_centers] (or pb[:, rows]) on the full
    mirror set, candidates from the cell-grid form (the full scan below the
    grid's cut). Returns ((rel_parked, valid, is_boundary, k), d_far (R,),
    grid)."""
    ext = vd.mirror_points_device(pb, bl)
    centers = pb[:, :n_centers] if rows is None else pb[:, rows]
    cg = vd._suggest_cellgrid(pb.shape[1], float(bl.min()), ks)
    (dist, idx, valid, _), _, rel = vd._search_rows(centers, ext, ks, 256, cg=cg, box_l=bl)
    R = centers.shape[0] * centers.shape[1]
    inputs = vd._fused_inputs(rel, valid.reshape(R, ks), idx.reshape(R, ks), k, ext.shape[1])
    return (*inputs, k), dist.reshape(R, ks)[:, -1], cg


def _cells_cmp(label, args, mode, errs):
    """The fused kernel against its plain version on the same inputs: flags
    and face vertex counts equal on every row, vol, area, r_cell and
    face_area within VOR_CELLS_TOL relative; rows beyond it are named.
    Returns the kernel's output."""
    import torch
    from waterorderlib_tpu_torch.ops.cuda import voronoi_cells as vcells

    got = vcells.voronoi_cells_fused(*args, 1e-4, mode)
    want = vcells.voronoi_cells_fused_plain(*args, 1e-4, mode)
    torch.cuda.synchronize()
    same = all(torch.equal(got[key], want[key])
               for key in ("ok_shape", "extra_cut", "neg_face", "face_nverts"))
    err, bad = 0.0, torch.zeros(args[0].shape[0], dtype=torch.bool, device=args[0].device)
    for key in ("vol", "area", "r_cell", "face_area"):
        d = (got[key] - want[key]).abs()
        err = max(err, float(d.max()))
        rel = d / want[key].abs().clamp(min=1e-30)
        bad |= (rel > VOR_CELLS_TOL).reshape(rel.shape[0], -1).any(-1)
    rows = torch.nonzero(bad)[:, 0].tolist()
    n_bound = int(args[2].sum())
    print(f"[kernel] voronoi_cells {label}, dedup {mode}: {args[0].shape[0]} rows ({n_bound} "
          f"boundary), ok {int(got['ok_shape'].sum())}, extra_cut {int(got['extra_cut'].sum())}; "
          f"flags and face_nverts equal: {same}; moments max|d|={err:.3e}, rows beyond "
          f"{VOR_CELLS_TOL} relative: {len(rows)}", flush=True)
    for r in rows[:20]:
        print(f"[kernel] voronoi_cells row {r}: vol {float(got['vol'][r])!r} / "
              f"{float(want['vol'][r])!r}, area {float(got['area'][r])!r} / "
              f"{float(want['area'][r])!r}, r_cell {float(got['r_cell'][r])!r} / "
              f"{float(want['r_cell'][r])!r}", flush=True)
    _check(same and not rows, f"voronoi_cells {label}: differs from the plain version")
    errs["voronoi_cells"].append(err)
    return got


def _cells_bound_ms(args, got, always=False):
    """Least time of one fused-cell launch: the operations its code must do
    on these rows (the CELL_* counts; edges and dedup comparisons from the
    data, the comparisons on the boundary rows, or on every row in dedup
    mode "always") over the float32 peak, or the bytes (rel, valid and the
    flag read once, the outputs written once) over the memory rate."""
    rel, _, isb, k = args
    R, ks = rel.shape[0], rel.shape[1]
    P = k * (k - 1) // 2
    nv = got["face_nverts"].double()
    edges = float(nv.sum()) / 2.0
    pairs = nv * (nv - 1) / 2
    compares = float(pairs.sum() if always else pairs[isb].sum())
    ops = (R * (ks * CELL_CAND_FLOPS + P * (CELL_PAIR_FLOPS + k * CELL_PLANE_FLOPS + CELL_POST_FLOPS)
                + k * (k - 1) * CELL_SLOT_FLOPS)
           + edges * (ks - k) * CELL_CHECK_FLOPS + compares * CELL_DEDUP_FLOPS)
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = R * (ks * 13 + 1 + 19 + 8 * k) / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _builders_agree(args, d_far, got, clip):
    """Tier-1 cells certified by both the fused rule (dedup on boundary and
    tangent rows) and the clip builder (dedup everywhere): vol and area
    within VOR_IMPL_TOL, except on rows where the two keep different faces
    (the clip builder's dedup merged the edges of a face smaller than its
    tolerance). Those are named, at most 0.1% of the rows, and both values
    lie within VOR_REF_TOL of the row's cell from the same candidates on the
    host in float64."""
    import numpy as np
    import torch
    from waterorderlib_tpu_torch.surface import voronoi_device as vd

    cert_k = got["ok_shape"] & (d_far >= 2.0 * got["r_cell"])
    cert_c = clip["ok_shape"] & (d_far >= 2.0 * clip["r_cell"])
    both = cert_k & cert_c
    rel = torch.maximum(*((got[key] - clip[key]).abs() / clip[key].abs() for key in ("vol", "area")))
    beyond = both & (rel > VOR_IMPL_TOL)
    faces_differ = (got["face_nverts"] != clip["face_nverts"]).any(-1)
    gap = float(rel[both & ~beyond].max())
    rows = torch.nonzero(beyond)[:, 0].tolist()
    print(f"[kernel] voronoi_cells against the clip builder at tier 1: certified "
          f"{int(cert_k.sum())} / {int(cert_c.sum())} of {args[0].shape[0]} rows, by both "
          f"{int(both.sum())}; their vol and area within {gap:.3e} relative (limit {VOR_IMPL_TOL}) "
          f"but on {len(rows)} rows, where the faces differ", flush=True)
    worst = 0.0
    for n, r in enumerate(rows):
        cand = args[0][r][args[1][r]].double().cpu().numpy()
        vh = vd._host_cell(cand)[0]
        vk, vc = float(got["vol"][r]), float(clip["vol"][r])
        worst = max(worst, abs(vk - vh) / vh, abs(vc - vh) / vh)
        faces = (got["face_nverts"][r] > 0).sum(), (clip["face_nverts"][r] > 0).sum()
        if n < 10:
            print(f"[kernel] row {r}: vol fused {vk:.6f}, clip {vc:.6f}, host float64 {vh:.6f}; "
                  f"faces {int(faces[0])} / {int(faces[1])}", flush=True)
    print(f"[kernel] on all {len(rows)} of these rows, both builders within {worst:.3e} of "
          f"the host cell (limit {VOR_REF_TOL})", flush=True)
    _check(int(both.sum()) >= 0.8 * args[0].shape[0] and not bool((beyond & ~faces_differ).any())
           and len(rows) <= 1e-3 * int(both.sum()) and worst <= VOR_REF_TOL,
           "voronoi_cells: co-certified cells differ from the clip builder")


def _on_kernel_whole(ran, tiers, n_first):
    """Whether the cell kernel built every tier it holds (k <= MAX_K) and
    none beyond: one launch each time such a tier ran (`ran` against the
    tiers' `launches`), and `kernel_rows` counting every real row there:
    tier 1's n_first rows, then at each tier the rows the tiers before left
    uncertified (no bucket padding)."""
    from waterorderlib_tpu_torch.ops.cuda import voronoi_cells as vcells

    ladder = [(key, v) for key, v in tiers.items() if key != "host"]
    if ran["voronoi_cells"] != sum(v["launches"] for key, v in ladder if key[0] <= vcells.MAX_K):
        return False
    left = n_first
    for key, v in ladder:
        if v["kernel_rows"] != (left if key[0] <= vcells.MAX_K else 0):
            return False
        left -= v["certified"]
    return True


def _clip_on_kernel_cmp(card, pos, box, nw, errs, times):
    """The clip builder on the cell kernel: every `voronoi_cells_fused`
    launch of voronoi_volumes_hybrid_frames (cell_impl "clip") on a
    16-frame chunk, captured (tier 1 and each escalation tier up to (64,
    128)), in dedup "always" and equal to the PyTorch clip builder
    (`_clip_cells`) on every key with torch.equal; the kernel's time beside
    the builder's at each. The tier-1 launch, the main path's largest, gives
    the kernels line its times: the kernel, its own device time, its plain
    version (the clip builder) and its bound."""
    import torch
    from waterorderlib_tpu_torch.ops.cuda import voronoi_cells as vcells
    from waterorderlib_tpu_torch.surface import voronoi_device as vd

    real, seen = vcells.voronoi_cells_fused, []

    def record(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    vcells.voronoi_cells_fused = record
    try:
        vd.voronoi_volumes_hybrid_frames(pos, box, nw, device="cuda")
    finally:
        vcells.voronoi_cells_fused = real
    shapes = [(args[3], args[0].shape[1]) for args, _ in seen]
    _check(shapes[:1] == [(32, 64)] and (48, 96) in shapes and (64, 128) in shapes
           and all(kw == {"dedup_mode": "always"} for _, kw in seen),
           f"cell_impl clip: the kernel's launches of a {VOR_CHUNK}-frame chunk: {shapes}, "
           f"{[kw for _, kw in seen]}")
    for (rel, ok, flag, k, eps), kw in seen:
        got = real(rel, ok, flag, k, eps, **kw)
        want = vd._clip_cells(rel, ok, k, eps)
        torch.cuda.synchronize()
        differ = [key for key in want if not torch.equal(got[key], want[key])]
        ms = _ms(lambda *a: real(*a, **kw), (rel, ok, flag, k, eps), 5)
        clip_ms = _ms(vd._clip_cells, (rel, ok, k, eps), 1)
        print(f"[kernel] voronoi_cells dedup always against the PyTorch clip builder at ({k}, "
              f"{rel.shape[1]}), {rel.shape[0]} rows ({int(flag.sum())} boundary) of a "
              f"{VOR_CHUNK}-frame chunk at {pos.shape[1]} points: equal to the bit on every key: "
              f"{not differ}{f' (differ: {differ})' if differ else ''}; ok "
              f"{int(got['ok_shape'].sum())}", flush=True)
        print(f"[time] voronoi_cells dedup always at ({k}, {rel.shape[1]}), {rel.shape[0]} rows: "
              f"kernel {ms:.5f} ms, PyTorch clip builder {clip_ms:.3f} ms; {card}", flush=True)
        if (k, rel.shape[1]) == (32, 64):
            alone = _device_ms(lambda *a: real(*a, **kw), (rel, ok, flag, k, eps),
                               "voronoi_cells_kernel")
            bound, bound_by = _cells_bound_ms((rel, ok, flag, k), got, always=True)
            times["voronoi_cells"] = (ms, clip_ms, bound, bound_by, None)
            print(f"[time] voronoi_cells, the main path's tier 1 (dedup always, {rel.shape[0]} "
                  f"rows, {float(got['face_nverts'].sum()) / 2:.0f} edges): kernel {ms:.5f} ms "
                  f"(alone on the card {alone:.5f} ms), plain (the clip builder) {clip_ms:.3f} "
                  f"ms, bound {bound:.5f} ms ({bound_by}); no library call computes it; {card}",
                  flush=True)
        _check(not differ, f"voronoi_cells always at ({k}, {rel.shape[1]}) differs from the "
                           f"clip builder: {differ}")
        errs["voronoi_cells"].append(0.0)
        del got, want
    del seen
    torch.cuda.empty_cache()


def _voronoi_cells_phases(card, kernels, errs, launches, times):
    """The clip builder's launches on the kernel first (`_clip_on_kernel_cmp`,
    which times the main path's tier 1 for the kernels line); then the
    fused cell kernel (csrc/voronoi_cells.cu) against its plain
    version at tier 1 of a 16-frame chunk of 12,294 points (196,608 rows at
    (32, 64), cell-grid candidates), on a 2,048-row subset at (40, 96), on
    the 6^3 cubic lattice (interior rows carry no boundary flag: the
    tangency test must dedup them, and every cell certify at a^3), and with
    dedup "always" against the clip builder; its dedup "auto" time beside
    its bound and plain version; tier-1 cells certified by both builders
    against each other; voronoi_volumes_hybrid_frames(cell_impl="pallas") on the
    chunk against "clip" and, frames 0-1, Qhull in float64; a warm call of
    each on the stage clock; one warm "clip" chunk under torch.profiler."""
    import numpy as np
    import torch
    from waterorderlib_tpu_torch.ops.cuda import voronoi_cells as vcells
    from waterorderlib_tpu_torch.surface import voronoi_device as vd
    from waterorderlib_tpu_torch.surface.voronoi import voronoi_volumes

    dev = torch.device("cuda")
    kk, kp = vcells.voronoi_cells_fused, vcells.voronoi_cells_fused_plain
    kernels["voronoi_cells"] = (kk, kp)
    _, traj, heavy, nw = _vor_system(VOR_N, VOR_CHUNK, 0, VOR_SOLUTE)
    pos16 = traj.positions[:, heavy]
    box16 = traj.boxes[:, 0].astype(np.float64)
    # first, so that the main path's tier-1 device time is read before the
    # profiler starts losing events late in the process (`_device_ms`)
    _clip_on_kernel_cmp(card, pos16, box16, nw, errs, times)
    pb = torch.as_tensor(traj.positions[:, heavy], device=dev)
    bl = torch.as_tensor(traj.boxes[:, 0], device=dev)
    args, d_far, cg = _cells_args(vd, pb, bl, 32, 64, n_centers=nw)
    got = _cells_cmp(f"tier 1 of a {VOR_CHUNK}-frame chunk at {len(heavy)} points (32, 64), grid {cg}",
                     args, "auto", errs)
    # dedup "auto" (cell_impl "pallas"), a side line: the main path runs
    # "always" (`_clip_on_kernel_cmp`)
    ms = _ms(kk, (*args, 1e-4), 5)
    plain_ms = _ms(kp, (*args, 1e-4), 1)
    bound, bound_by = _cells_bound_ms(args, got)
    print(f"[time] voronoi_cells dedup auto, tier 1 of a {VOR_CHUNK}-frame chunk "
          f"({args[0].shape[0]} rows, (32, 64), {int(args[2].sum())} boundary rows, "
          f"{float(got['face_nverts'].sum()) / 2:.0f} edges): kernel {ms:.5f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({bound_by}); {card}", flush=True)
    # tier-1 cells certified by both builders
    _builders_agree(args, d_far, got, vd._clip_cells(args[0], args[1], 32, 1e-4))
    # dedup "always": the plain version is the clip builder itself
    sub = tuple(a[:VOR_SUBSET] if torch.is_tensor(a) else a for a in args)
    _cells_cmp(f"{VOR_SUBSET} rows of tier 1 (the plain version: the clip builder)", sub,
               "always", errs)
    del args, d_far, got, sub
    rs = np.random.RandomState(4)
    rows = torch.as_tensor(rs.choice(nw, VOR_SUBSET, replace=False), device=dev)
    wide, _, cgw = _cells_args(vd, pb[:1], bl[:1], 40, 96, rows=rows)
    wgot = _cells_cmp(f"{VOR_SUBSET}-row subset at (40, 96), grid {cgw}", wide, "auto", errs)
    wms, wplain = _ms(kk, (*wide, 1e-4), 5), _ms(kp, (*wide, 1e-4), 1)
    walone = _device_ms(kk, (*wide, 1e-4), "voronoi_cells_kernel")
    wbound, wby = _cells_bound_ms(wide, wgot)
    print(f"[time] voronoi_cells, the {VOR_SUBSET}-row subset at (40, 96) (grid {cgw}, "
          f"{int(wide[2].sum())} boundary rows): kernel {wms:.5f} ms (alone on the card "
          f"{walone:.5f} ms), plain {wplain:.3f} ms, bound {wbound:.5f} ms ({wby}); {card}",
          flush=True)
    del wgot
    # the kernel's exact-division path: candidates scaled by 2^-20 put s_m
    # below the fast division's range (2^-30), so every pair divides with `/`
    tiny = ((wide[0][:256] * 2.0 ** -20).contiguous(), wide[1][:256], wide[2][:256], 40)
    _cells_cmp("256 rows at (40, 96) scaled by 2^-20 (the exact-division path)", tiny, "auto",
               errs)
    del tiny
    # the 6^3 cubic lattice: degenerate vertices everywhere
    a, ng = 3.0, 6
    g = np.arange(ng) * a + a / 2.0
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    lt = torch.as_tensor(lat, device=dev)[None]
    largs, ld_far, _ = _cells_args(vd, lt, torch.tensor([ng * a], device=dev), 32, 64,
                                   n_centers=len(lat))
    lat_k = _cells_cmp(f"the {ng}^3 cubic lattice", largs, "auto", errs)
    lat_a = kk(*largs, 1e-4, "always")
    cert = lat_k["ok_shape"] & (ld_far >= 2.0 * lat_k["r_cell"])
    vgap = float(((lat_k["vol"] - a**3).abs() / a**3).max())
    interior = int((~largs[2]).sum())
    print(f"[kernel] voronoi_cells on the cubic lattice: {interior} rows without the boundary "
          f"flag; certified {int(cert.sum())} of {len(lat)}; volumes within {vgap:.3e} of a^3; "
          f"equal to dedup always: {torch.equal(lat_k['vol'], lat_a['vol'])}", flush=True)
    _check(interior >= 8 and int(cert.sum()) == len(lat) and vgap <= 1e-4
           and torch.equal(lat_k["vol"], lat_a["vol"]),
           "voronoi_cells: the cubic lattice was not deduped by the tangency test")
    del wide, largs, lat_k, lat_a
    torch.cuda.empty_cache()

    # the volumes frame batch under both builders
    res = {}
    for impl in ("pallas", "clip"):
        res[impl], ran, tiers, wall = _vor_drive(
            f"voronoi_volumes_hybrid_frames {len(heavy)} points x {VOR_CHUNK} frames, cell_impl {impl}",
            kernels, lambda: vd.voronoi_volumes_hybrid_frames(pos16, box16, nw, cell_impl=impl,
                                                              device="cuda"))
        cells = {k: v.get("cells") for k, v in tiers.items() if k != "host"}
        _check(_on_kernel_whole(ran, tiers, VOR_CHUNK * nw),
               f"cell_impl {impl}: the kernel did not serve every tier up to k {vcells.MAX_K} "
               f"once on its real rows: {ran}, {tiers}")
        if impl == "pallas":
            _check(cells[(32, 64)] == "pallas"
                   and all(v == "clip" for k, v in cells.items() if k != (32, 64)),
                   f"cell_impl pallas: the fused rule did not serve tier 1 alone: {cells}")
        else:
            _check(set(cells.values()) == {"clip"}, f"cell_impl clip: builders {cells}")
    (vp, ap, np_), (vc_, ac_, nc_) = res["pallas"], res["clip"]
    gap = max(float(np.max(np.abs(vp - vc_) / vc_)), float(np.max(np.abs(ap - ac_) / ac_)))
    worst = 0.0
    for t in range(2):
        vh, ah = voronoi_volumes(pos16[t].astype(np.float64), float(box16[t]), nw)
        worst = max(worst, float(np.max(np.abs(vp[t] - vh) / vh)),
                    float(np.max(np.abs(ap[t] - ah) / ah)))
    print(f"[slice] voronoi_volumes_hybrid_frames pallas against clip: certified {np_} / {nc_} of "
          f"{16 * nw}; every cell within {gap:.3e} relative; frames 0-1 against Qhull float64: "
          f"{worst:.3e} (limit {VOR_REF_TOL}); {card}", flush=True)
    _check(gap <= VOR_REF_TOL and worst <= VOR_REF_TOL,
           "cell_impl pallas: volumes differ from clip or Qhull beyond the float32 band")
    for impl in ("pallas", "clip"):
        _stages(f"voronoi_volumes_hybrid_frames, cell_impl {impl}",
                lambda d: vd.voronoi_volumes_hybrid_frames(pos16, box16, nw, cell_impl=impl,
                                                           device="cuda"))
    # the card's view of one warm chunk: kernel time by name, busy share
    _profile_line(f"voronoi_volumes_hybrid_frames {len(heavy)} points x {VOR_CHUNK} frames, "
                  f"cell_impl clip (warm); {card}",
                  lambda: vd.voronoi_volumes_hybrid_frames(pos16, box16, nw, device="cuda"))
    del pb, bl
    torch.cuda.empty_cache()


def _quirk_flips(dev, host):
    """Contact entries beyond VOR_CONTACT_TOL of Qhull's: each must be a flip
    of the reference's doubling quirk (a face's sliver 4th vertex seen on
    one side only), within VOR_CONTACT_TOL once the factor 2 is undone (the
    sliver's own area stays in the difference)."""
    import numpy as np

    return bool(np.all((np.abs(2.0 * dev - host) <= VOR_CONTACT_TOL)
                       | (np.abs(dev - 2.0 * host) <= VOR_CONTACT_TOL)))


def _driver_means(name, res):
    """The means a contact driver returns: contact_area_calc's five total
    and four fraction means, hydrated_volume_calc's volume and area."""
    import numpy as np

    if name == "contact_area_calc":
        return np.asarray(list(res[0]) + list(res[2]), np.float64)
    return np.asarray([res[0][0], res[1][0]], np.float64)


def _voronoi_contacts_phases(card, kernels, errs):
    """The Voronoi contacts slice: voronoi_contacts_hybrid_frames at 12,294
    points x 16 frames with rows 0-511 (scripts/perf_round5_tpu.py's
    production shape) under cell_impl "pallas" (tier 1 on the fused kernel,
    one launch) and "clip", against each other on every frame, frames 0-1
    against the host Qhull contacts in float64, frames 0 and 1 alone equal
    to the batch; contact_area_calc and hydrated_volume_calc
    (engine="device") at 12,288 waters + 24 solute atoms x 16 frames, frames
    0-1 against engine="host", and a warm call of each on the stage clock."""
    import numpy as np
    from waterorderlib_tpu_torch.drivers.voronoi_driver import (
        contact_area_calc,
        hydrated_volume_calc,
    )
    from waterorderlib_tpu_torch.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.ops.cuda import voronoi_cells as vcells
    from waterorderlib_tpu_torch.surface import voronoi_device as vd
    from waterorderlib_tpu_torch.surface.voronoi import voronoi_contacts

    _, traj, heavy, _ = _vor_system(VOR_N, VOR_CHUNK, 0, VOR_SOLUTE)
    pos = traj.positions[:, heavy]
    box = traj.boxes[:, 0].astype(np.float64)
    num = len(heavy)
    sel = np.arange(VOR_CONTACT_ROWS)

    def run(impl, frames=slice(None)):
        # keep the computed rows of each frame's dense matrix, not the matrix
        return [(c[sel].copy(), aa[0, sel].copy(), wa[0, sel].copy(), av[0, sel].copy(), n)
                for c, aa, wa, av, n in vd.voronoi_contacts_hybrid_frames(
                    pos[frames], box[frames], num, rows=sel, cell_impl=impl, device="cuda")]

    res = {}
    for impl in ("pallas", "clip"):
        res[impl], ran, tiers, wall = _vor_drive(
            f"voronoi_contacts_hybrid_frames {num} points x {VOR_CHUNK} frames, rows {VOR_CONTACT_ROWS}, "
            f"cell_impl {impl}", kernels, lambda: run(impl))
        cells = {k: v.get("cells") for k, v in tiers.items() if k != "host"}
        _check(_on_kernel_whole(ran, tiers, VOR_CHUNK * VOR_CONTACT_ROWS),
               f"contacts, cell_impl {impl}: the kernel did not serve every tier up to k "
               f"{vcells.MAX_K} once on its real rows: {ran}, {tiers}")
        if impl == "pallas":
            _check(cells[(32, 64)] == "pallas" and ran["voronoi_cellgrid_topk"] >= 1,
                   f"contacts, cell_impl pallas: tier 1 not on the fused rule: {cells}, {ran}")
        print(f"[slice] contacts {impl}: certified per tier "
              + ", ".join(f"{k}: {v.get('certified', 0)} of {v['rows']} ({v['form']}, "
                          f"{v.get('cells')})" for k, v in tiers.items() if k != "host")
              + f"; host closes {tiers.get('host', {}).get('rows', 0)}; wall {wall:.3f} s; {card}",
              flush=True)
    # rows beyond VOR_IMPL_TOL: where the clip builder's dedup merged a small
    # face (see _builders_agree); named, and held to the float32 band
    n_rows, named, band, entry = 0, [], 0.0, 0.0
    for t, ((cp, aap, wap, avp, _), (cc, aac, wac, avc, _)) in enumerate(
            zip(res["pallas"], res["clip"])):
        diff = np.maximum.reduce([np.max(np.abs(cp - cc), 1) / aac, np.abs(aap - aac) / aac,
                                  np.abs(avp - avc) / avc, np.abs(wap - wac) / (4 * aac)])
        n_rows += len(diff)
        for r in np.where(diff > VOR_IMPL_TOL)[0]:
            named.append((t, int(r)))
            band = max(band, abs(aap[r] - aac[r]) / aac[r], abs(avp[r] - avc[r]) / avc[r])
            entry = max(entry, float(np.max(np.abs(cp[r] - cc[r]))))
    n_p = sum(r[4] for r in res["pallas"])
    n_c = sum(r[4] for r in res["clip"])
    print(f"[slice] contacts pallas against clip, {VOR_CHUNK} frames: certified {n_p} / {n_c}; "
          f"rows whose entries, area or volume differ beyond {VOR_IMPL_TOL} of the cell: "
          f"{len(named)} of {n_rows} {named[:20]}; there areas and volumes within {band:.3e} "
          f"(limit {VOR_REF_TOL}), entries within {entry:.3e} (limit {VOR_CONTACT_TOL})",
          flush=True)
    _check(len(named) <= 1e-3 * n_rows and band <= VOR_REF_TOL and entry <= VOR_CONTACT_TOL,
           "contacts: cell_impl pallas differs from clip")
    worst_cell, flips, nonzero = 0.0, 0, 0
    for t in range(2):
        ch, aah, _, avh = voronoi_contacts(pos[t].astype(np.float64), float(box[t]), num)
        cd, aad, _, avd, _ = res["pallas"][t]
        worst_cell = max(worst_cell, float(np.max(np.abs(aad - aah[0, sel]) / aah[0, sel])),
                         float(np.max(np.abs(avd - avh[0, sel]) / avh[0, sel])))
        flip = np.abs(cd - ch[sel]) > VOR_CONTACT_TOL
        _check(_quirk_flips(cd[flip], ch[sel][flip]),
               f"contacts frame {t}: an entry differs from Qhull other than by the quirk factor")
        flips += int(flip.sum())
        nonzero += int((ch[sel] > 0).sum())
        del ch
    print(f"[slice] contacts frames 0-1 against Qhull float64: atom areas and volumes within "
          f"{worst_cell:.3e} (limit {VOR_MEAN_TOL}); entries beyond {VOR_CONTACT_TOL}: {flips} "
          f"of {nonzero} nonzero (limit 1%)", flush=True)
    _check(worst_cell <= VOR_MEAN_TOL and flips <= 0.01 * nonzero,
           "contacts differ from Qhull beyond the float32 band")
    for t in range(2):
        one = run("pallas", slice(t, t + 1))[0]
        _check(all(np.array_equal(a, b) for a, b in zip(one, res["pallas"][t])),
               f"contacts: frame {t} alone differs from the {VOR_CHUNK}-frame batch")
    print(f"[slice] contacts: frames 0 and 1 alone equal the {VOR_CHUNK}-frame batch", flush=True)
    del res

    ctop, ctraj = make_water_box(VOR_N, n_frames=VOR_CHUNK, seed=0,
                                  solute_elements=VOR_CONTACT_SOLUTE)
    c_quirk, w_quirk = _rows_vs_host(ctop, ctraj)
    drv = {}
    for name, fn in (("contact_area_calc", contact_area_calc),
                     ("hydrated_volume_calc", hydrated_volume_calc)):
        drv[name], ran, tiers, wall = _vor_drive(
            f"{name} {VOR_N} waters + {len(VOR_CONTACT_SOLUTE)} solute atoms x {VOR_CHUNK} frames "
            f"(engine device)", kernels, lambda: fn(ctop, ctraj, engine="device", device="cuda"))
        _check(ran["voronoi_cellgrid_topk"] >= 1, f"{name} did not run the search kernel")
        print(f"[slice] {name}: {json.dumps(drv[name], default=lambda x: np.asarray(x).tolist())}",
              flush=True)
        dev2 = _driver_means(name, fn(ctop, ctraj[:2], engine="device", device="cuda"))
        host2 = _driver_means(name, fn(ctop, ctraj[:2], engine="host", device="cuda"))
        # the float32 band, and the quirk's flips of _rows_vs_host: a total
        # sums halved entries; a fraction a / b moves by at most
        # 2 (band a / b + quirk / b)
        if name == "contact_area_calc":
            tot = host2[0]
            limit = np.concatenate([VOR_MEAN_TOL * np.abs(host2[:5]) + c_quirk,
                                    2.0 * (VOR_MEAN_TOL * host2[5:] + c_quirk / tot)])
        else:
            limit = VOR_MEAN_TOL * np.abs(host2) + np.array([0.0, w_quirk])
        gap = np.abs(dev2 - host2)
        print(f"[slice] {name} frames 0-1: device {dev2.tolist()}, host {host2.tolist()}; gaps "
              f"{gap.tolist()}, limits {limit.tolist()} ({VOR_MEAN_TOL} relative, plus the "
              f"quirk's flips)", flush=True)
        _check(bool(np.all(gap <= limit)), f"{name}: device and host engines differ")
        _stages(name, lambda d: fn(ctop, ctraj, engine="device", device="cuda"))


def _rows_vs_host(top, traj):
    """The contact rows of the drivers' solute on frames 0-1, device against
    the host engine (Qhull, float64): areas and volumes within VOR_MEAN_TOL,
    entries by the JAX package's rule (within VOR_CONTACT_TOL, or off by the
    doubling quirk's factor on at most 1% of the nonzero entries). Returns
    the quirk's bound on the drivers' means, from the host's numbers alone
    and averaged over the two frames: a flipped entry moves by its face's
    polygon area, at most the host's entry there; the halved row sums move
    by half of that, the exposed area by all of it."""
    import numpy as np
    from waterorderlib_tpu_torch.surface import voronoi_device as vd
    from waterorderlib_tpu_torch.surface.voronoi import voronoi_contacts

    heavy = top.get_heavy_inds()
    row_of = {int(a): i for i, a in enumerate(heavy)}
    sol = np.array([row_of[int(a)] for a in top.get_sol_inds("WAT")[0]], int)
    pos = np.asarray(traj.positions[:2][:, heavy], np.float32)
    box = np.asarray(traj.boxes[:2, 0], np.float64)
    dev = list(vd._contacts_frames(pos, box, len(heavy), sol, vd.DEFAULT_TIERS, 256, 96, "clip",
                                   "cuda", False))
    quirk = 0.0
    flips, nonzero, worst = 0, 0, 0.0
    for t in range(2):
        rows, aa, _, av, _ = dev[t]
        c, aah, _, avh = voronoi_contacts(pos[t].astype(np.float64), float(box[t]), len(heavy))
        host = c[sol]
        flip = np.abs(rows - host) > VOR_CONTACT_TOL
        _check(_quirk_flips(rows[flip], host[flip]),
               f"contact rows, frame {t}: an entry differs from Qhull other than by the quirk")
        flips += int(flip.sum())
        nonzero += int((host > 0).sum())
        worst = max(worst, float(np.max(np.abs(aa[0, sol] - aah[0, sol]) / aah[0, sol])),
                    float(np.max(np.abs(av[0, sol] - avh[0, sol]) / avh[0, sol])))
        quirk += float(host[flip].sum()) / 2.0
    print(f"[slice] the contact drivers' {len(sol)} solute rows, frames 0-1, against the host "
          f"engine: areas and volumes within {worst:.3e} (limit {VOR_MEAN_TOL}), {flips} of "
          f"{nonzero} nonzero entries beyond {VOR_CONTACT_TOL} (limit 1%); the host's entries "
          f"there {quirk:.6f} (a frame's mean)", flush=True)
    _check(flips <= 0.01 * nonzero and worst <= VOR_MEAN_TOL,
           "the drivers' contact rows differ from the host engine")
    return quirk / 2.0, quirk


def _alone(group: str) -> int:
    """`python3 chip_smoke.py --alone q`, `--alone hb` or `--alone vor`: the
    device time alone (torch.profiler) of `q_window` (its row form),
    `lsi_split_window` and `q_window_hist` (one frame: the lane form), of
    `lsi_window`, `hbond_dense` and `hbond_slab`, at their slices' launches,
    as phases 5 and 9 time them, or of `voronoi_window_topk` at its four
    launches (`_vor_launches`), in a process of its own for each group.
    Late in the main run torch.profiler sessions lose kernel events
    (readings of 0, or of one launch in three, on the H100), so the main
    run keeps only the cell-grid and cell kernels' readings, which come
    first there."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from waterorderlib_tpu_torch.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.ops.cuda import hbond, lsi, qtet2, slab, voronoi_topk

    card, dev = _card(), torch.device("cuda")
    if group == "vor":
        _, traj, heavy, nw = _vor_system(VOR_N, VOR_FRAMES, 0, VOR_SOLUTE)
        _, traj2, heavy2, nw2 = _vor_system(VOR_SMALL, VOR_SMALL_FRAMES, 5)
        _, launches = _vor_launches((traj, heavy, nw), (traj2, heavy2, nw2))
        for tag, args in zip("abcd", launches):
            ms = _device_ms(voronoi_topk.voronoi_window_topk, args, "topk_kernel")
            print(f"[alone] voronoi_window_topk launch ({tag}), {args[0].shape[0]} frames x "
                  f"{args[0].shape[1]} rows x win {args[5]}, k {args[3]}: its kernel alone on the "
                  f"card (torch.profiler, a process of its own) {ms:.5f} ms a call; {card}",
                  flush=True)
        return 0
    top, traj = make_water_box(N_WATERS, n_frames=N_FRAMES_SLICE, seed=0)
    wat_pos = torch.as_tensor(traj.positions[:, top.get_wat_inds()[0]], dtype=torch.float32,
                              device=dev)
    boxes = torch.as_tensor(traj.boxes, dtype=torch.float32, device=dev)
    if group == "q":
        sp_np, sb_np = _split_traj(N_SPLIT, N_FRAMES_SPLIT, seed=0)
        split_args = _lsi_split_args(torch.from_numpy(sp_np).to(dev),
                                     torch.from_numpy(sb_np).to(dev))[3]
        lat, lat_b = (torch.from_numpy(x).to(dev) for x in _lattice_traj(N_WATERS, 1, seed=1))
        cols = slab.brute_cols(lat, lat_b)
        dense = (cols, cols, torch.zeros(N_WATERS // 128, dtype=torch.int32, device=dev), lat_b,
                 N_WATERS, 128, 0.0, 100.0, 100.0)
        readings = (
            ("q_window at its slice's launch", qtet2.q_window,
             _slab_args(wat_pos, boxes, 4.5, 256, 10.0, True)[3], "qtet_row_kernel"),
            (f"lsi_split_window at its slice's launch ({N_SPLIT} waters)", lsi.lsi_split_window,
             split_args, "lsi_split_kernel"),
            ("q_window_hist at row 4's launch (1 frame; ms a call)", qtet2.q_window_hist, dense,
             "qtet_lane_kernel"))
    else:
        _, traj_h = make_water_box(N_WATERS, n_frames=N_FRAMES_SLICE, seed=0,
                                   solute_elements=HB_SOLUTE)
        _, traj_hs = make_water_box(N_HB_SLAB, n_frames=N_FRAMES_HB_SLAB, seed=0)
        wh = _hb_water_sets(torch.as_tensor(traj_h.positions, device=dev), N_WATERS)
        bh = torch.as_tensor(traj_h.boxes, device=dev)
        wh16 = _hb_water_sets(torch.as_tensor(traj_hs.positions, device=dev), N_HB_SLAB)
        bh16 = torch.as_tensor(traj_hs.boxes, device=dev)
        prep16, slab16 = _hb_slab_args(*wh16, bh16)
        prep4, slab4 = _hb_slab_args(*wh, bh)
        readings = (
            ("lsi_window at its slice's launch", lsi.lsi_window,
             _lsi_slab_args(wat_pos, boxes)[3], "lsi_window_kernel"),
            (f"hbond_dense at {N_WATERS} waters", hbond.hbond_dense, _hb_dense_args(*wh, bh),
             "hbond_kernel"),
            (f"hbond_slab at {N_HB_SLAB} waters, w={prep16.w}", hbond.hbond_slab, slab16,
             "hbond_kernel"),
            (f"hbond_slab at {N_WATERS} waters, w={prep4.w}", hbond.hbond_slab, slab4,
             "hbond_kernel"))
    for label, fn, args, kname in readings:
        ms = _device_ms(fn, args, kname) / args[0].shape[0]
        print(f"[alone] {label}: its kernel alone on the card (torch.profiler, a process of its "
              f"own) {ms:.5f} ms/frame; {card}", flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    import waterorderlib_tpu_torch
    from waterorderlib_tpu_torch.drivers import orderparams
    from waterorderlib_tpu_torch.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.io.trajectory import Trajectory
    from waterorderlib_tpu_torch.ops import pairs
    from waterorderlib_tpu_torch.drivers import hbonds_driver
    from waterorderlib_tpu_torch.hbonds import bonds, populations
    from waterorderlib_tpu_torch.ops.cuda import angles, build, hbond, lsi, psi6, qtet2
    from waterorderlib_tpu_torch.order import angles as angles_ref
    from waterorderlib_tpu_torch.order import lsi as lsi_ref
    from waterorderlib_tpu_torch.order import psi6 as psi6_ref
    from waterorderlib_tpu_torch.order import qtet

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(waterorderlib_tpu_torch.__file__)))
    _check(pkg_dir == REPO, f"the port was imported from {pkg_dir}, not this checkout")
    t_start = time.perf_counter()

    # 1. the card and the build
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)
    t0 = time.perf_counter()
    sass = _sass_start()
    build.build_all(["qtet_window", "nbr_window", "lsi_window", "hbond", "willard", "sasa",
                     "voronoi_topk", "voronoi_cells"])
    print(f"[build] qtet_window.cu, nbr_window.cu, lsi_window.cu, hbond.cu, willard.cu, sasa.cu, "
          f"voronoi_topk.cu and voronoi_cells.cu built in parallel in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    sass_ops = _sass_ops(*sass)
    import scipy.spatial  # noqa: F401  (the Voronoi host close: fail now if it is missing)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "Function properties" in line or "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    errs = {k: [] for k in SOURCES}
    kernels = {
        "qtet_window": (qtet2.q_window, qtet2.q_window_plain),
        "angles_window": (angles.angles_window, angles.angles_window_plain),
        "psi6_window": (psi6.psi6_window, psi6.psi6_window_plain),
        "lsi_window": (lsi.lsi_window, lsi.lsi_window_plain),
        "lsi_split_window": (lsi.lsi_split_window, lsi.lsi_split_window_plain),
        "hbond_dense": (hbond.hbond_dense, hbond.hbond_dense_plain),
        "hbond_slab": (hbond.hbond_slab, hbond.hbond_slab_plain),
    }

    # 2. kernels against plain versions, at the main paths' shapes
    pos_np, boxes_np = _lattice_traj(N_WATERS, N_FRAMES_CMP, seed=0)
    pos, boxes = torch.from_numpy(pos_np).to(dev), torch.from_numpy(boxes_np).to(dev)
    n, rt = N_WATERS, 256
    # q in both forms of qtet_window.cu (`_cmp_q`): the slab and brute forms,
    # the lattice with a third of its atoms stored shifted by +/-L, pairs
    # planted at exactly the margin (= the lists' filter) and the shell's
    # edge and a coincident pair, and windows of 20 columns, two of them
    # outside the columns
    _, _, _, slab_args = _slab_args(pos, boxes, 4.5, rt, 10.0, qtet=True)
    q_k, q_p = qtet2.q_window, qtet2.q_window_plain
    _cmp_q(f"slab form (w={slab_args[4]})", q_k, q_p, slab_args, errs["qtet_window"])
    brute_args = _brute_args(pos, boxes, rt, 10.0, qtet=True)
    _cmp_q("brute form", q_k, q_p, brute_args, errs["qtet_window"])
    q_brute_plain, _ = q_p(*brute_args)
    sh_np, _ = _lattice_traj(N_WATERS, N_FRAMES_CMP, seed=0, shifted=True)
    sh = torch.from_numpy(sh_np).to(dev)
    _cmp_q("slab form, +/-L shifts", q_k, q_p, _slab_args(sh, boxes, 4.5, rt, 10.0, True)[3],
           errs["qtet_window"])
    qp_pos, qp_boxes = _q_planted(pos[:2], boxes[:2])
    for label, args in (("planted pairs, slab form", _slab_args(qp_pos, qp_boxes, 4.5, rt, 10.0,
                                                                True)[3]),
                        ("planted pairs, brute form", _brute_args(qp_pos, qp_boxes, rt, 10.0,
                                                                  True))):
        _cmp_q(label, q_k, q_p, args, errs["qtet_window"])
    got = q_k(*_slab_args(qp_pos, qp_boxes, 4.5, rt, 10.0, True)[3])
    prep_qp = _slab_args(qp_pos, qp_boxes, 4.5, rt, 10.0, True)[0]
    at = [int(torch.nonzero(prep_qp.order0 == qp_pos.shape[1] - k)[0, 0]) for k in (13, 6)]
    print(f"[kernel] planted q rows C1 / C2: ok {[bool(got[1][0, r]) for r in at]} (4th neighbor "
          f"at exactly the 4.5 A margin / at 4.5625 A, found by the second scan)", flush=True)
    _check([bool(got[1][0, r]) for r in at] == [True, False], "planted q rows: ok flags wrong")
    nar = list(_brute_args(pos[:2], boxes[:2], 128, 10.0, True))
    nar[4] = 20
    nar[2] = (torch.arange(-(-N_WATERS // 128), dtype=torch.int32, device=dev) * 97
              % (N_WATERS - 20)).to(torch.int32)
    _cmp_q("windows of 20 columns", q_k, q_p, tuple(nar), errs["qtet_window"])
    nar[2][1], nar[2][5] = -1, N_WATERS - 19
    _cmp_q("windows of 20 columns, tiles 1 and 5 outside the columns", q_k, q_p, tuple(nar),
           errs["qtet_window"])
    del nar, qp_pos, prep_qp, got

    # straggler patch: a margin just under the 3 largest 4th-neighbor
    # distances leaves 3 uncertified rows, patched by the brute form
    d4 = torch.cat([pairs.topk_neighbors(pos[f], pos[f], boxes[f], 4, 0.0, 10.0).dist[:, 3]
                    for f in range(N_FRAMES_CMP)])
    margin = float(torch.sort(d4).values[-4:-2].mean())
    before = q_k.launches
    q_cert = qtet2.order_param_q_certified(pos, boxes, 0.0, 10.0, margin=margin)
    patched = q_k.launches - before - 1
    err_patch = float((q_cert - q_brute_plain).abs().max())
    print(f"[kernel] straggler patch: margin={margin:.4f} tier={qtet2.last_tier} "
          f"patch launches={patched} max|dq| vs plain brute={err_patch:.3e}", flush=True)
    _check(qtet2.last_tier == "slab" and patched >= 1, "straggler patch did not run")
    _check(err_patch <= Q_TOL, f"straggler patch: max|dq| {err_patch} > {Q_TOL}")
    errs["qtet_window"].append(err_patch)

    rs = np.random.RandomState(13)
    sp_pos = torch.as_tensor(rs.uniform(0, 200.0, (2, 512, 3)), dtype=torch.float32, device=dev)
    sp_boxes = torch.full((2, 3), 200.0, device=dev)
    q_sp = qtet2.order_param_q_certified(sp_pos, sp_boxes, 0.0, 50.0)
    q_sp_plain, _ = q_p(*_brute_args(sp_pos, sp_boxes, rt, 50.0, qtet=True))
    err_sparse = float((q_sp - q_sp_plain).abs().max())
    print(f"[kernel] sparse 512-atom box: tier={qtet2.last_tier} max|dq|={err_sparse:.3e}",
          flush=True)
    _check(qtet2.last_tier == "brute", "sparse box did not take the brute tier")
    _check(err_sparse <= Q_TOL, f"sparse box: max|dq| {err_sparse} > {Q_TOL}")
    errs["qtet_window"].append(err_sparse)
    # every row of the sparse box has fewer than 4 neighbors within the
    # lists' filter: each is scanned again, in both forms
    _cmp_q("sparse 512-atom box, brute form", q_k, q_p, _brute_args(sp_pos, sp_boxes, rt, 50.0,
                                                                    True), errs["qtet_window"])

    a_k, a_p = angles.angles_window, angles.angles_window_plain
    p_k, p_p = psi6.psi6_window, psi6.psi6_window_plain
    for label, args_fn in (("slab form", lambda m, h: _slab_args(pos, boxes, m, 128, h, False)[3]),
                           ("brute form", lambda m, h: _brute_args(pos, boxes, 128, h, False))):
        errs["angles_window"].append(_cmp(label, a_k, a_p, args_fn(4.5, 3.413), (ANG_TOL, 0)))
        errs["psi6_window"].append(_cmp(label, p_k, p_p, args_fn(7.0, 7.0), (PSI_TOL, 0)))

    # both LSI kernels on the lattice with a third of the atoms stored
    # shifted by +/-L, so that the next-shell pick reads raw distances that
    # differ from the imaged ones
    l_k, l_p = kernels["lsi_window"]
    s_k, s_p = kernels["lsi_split_window"]
    lsi_tols = (LSI_TOL, 0, 0, 0)
    for label, k24_args, split_args in (
            ("slab form, +/-L shifts", _lsi_slab_args(sh, boxes)[3], _lsi_split_args(sh, boxes)[3]),
            ("brute form, +/-L shifts", _lsi_brute_args(sh, boxes, False),
             _lsi_brute_args(sh, boxes, True))):
        errs["lsi_window"].append(_cmp(label, l_k, l_p, k24_args, lsi_tols))
        errs["lsi_split_window"].append(_cmp(label, s_k, s_p, split_args, lsi_tols))
    # the split kernel's union scan on windows the certified dispatch never
    # plans: a narrow window sticking out of the wide one at either end,
    # windows apart and touching, windows of 20 columns, and a wide window
    # outside the columns (NaN rows, incomplete)
    ba = list(_lsi_brute_args(sh[:2], boxes[:2], True))
    n_t = -(-N_WATERS // 128)
    for label, s_n, w_n, s_w, w_w in (
            ("a narrow window sticking out left of the wide one", 100, 700, 400, 1500),
            ("a narrow window sticking out right of the wide one", 1500, 900, 300, 1600),
            ("windows apart", 0, 300, 2000, 1200),
            ("windows touching", 500, 300, 800, 1000),
            ("windows of 20 columns", 777, 20, 760, 20)):
        ba[2] = torch.full((n_t,), s_n, dtype=torch.int32, device=dev)
        ba[2][::3] = max(0, s_n - 50)
        ba[8] = torch.full((n_t,), s_w, dtype=torch.int32, device=dev)
        ba[4], ba[9] = w_n, w_w
        errs["lsi_split_window"].append(_cmp(label, s_k, s_p, tuple(ba), lsi_tols))
    ba[8][3] = -1
    got, want = s_k(*ba), s_p(*ba)
    same = all(torch.equal(torch.nan_to_num(g, 7.0), torch.nan_to_num(x, 7.0))
               for g, x in zip(got, want))
    print(f"[kernel] lsi_split_window, tile 3's wide window outside the columns: equal to the "
          f"plain version (NaN rows {int(torch.isnan(got[0]).sum())}, incomplete "
          f"{int(got[3].sum())}): {same}", flush=True)
    _check(same and int(torch.isnan(got[0]).sum()) == 2 * 128, "lsi_split_window: a window "
           "outside the columns differs")
    # pairs planted at exactly high and high + 3.7 (both inclusive), a
    # coincident pair and an annulus tie in raw distance, in both LSI kernels
    lp_pos, lp_boxes = _lsi_planted(sh[:2], boxes[:2])
    for label, k24_args, split_args in (
            ("planted pairs, slab form", _lsi_slab_args(lp_pos, lp_boxes)[3],
             _lsi_split_args(lp_pos, lp_boxes)[3]),
            ("planted pairs, brute form", _lsi_brute_args(lp_pos, lp_boxes, False),
             _lsi_brute_args(lp_pos, lp_boxes, True))):
        errs["lsi_window"].append(_cmp(label, l_k, l_p, k24_args, lsi_tols))
        errs["lsi_split_window"].append(_cmp(label, s_k, s_p, split_args, lsi_tols))
    got = s_k(*_lsi_brute_args(lp_pos, lp_boxes, True))
    n_lp = lp_pos.shape[1]
    r1, r2 = n_lp - 12, n_lp - 5
    print(f"[kernel] planted LSI rows R1 / R2: valid {bool(got[1][0, r1])} / {bool(got[1][0, r2])}, "
          f"count {int(got[2][0, r1])} / {int(got[2][0, r2])} (R1: 3 in its shell, one at "
          f"exactly high; R2: 2, its next-shell pick at exactly high + 3.7)", flush=True)
    _check(int(got[2][0, r1]) == 3 and int(got[2][0, r2]) == 2 and bool(got[1][0, r2]),
           "planted LSI rows: counts or valid flags wrong")
    del ba, got, want, lp_pos
    n_differ = int((l_k(*_lsi_brute_args(sh, boxes, False))[0]
                    != s_k(*_lsi_brute_args(sh, boxes, True))[0]).sum())
    print(f"[kernel] +/-L shifts: K=24 and split LSI differ on {n_differ} of "
          f"{N_FRAMES_CMP * N_WATERS} rows (the next-shell pick among 24 against all)", flush=True)

    # the K=24 kernel on exact ties: a 16^3 lattice of spacing 3 A (every
    # distance exact in float32), brute and slab forms; and windows of 20
    # columns, narrower than a warp, two of them outside the columns
    lat, lat_b = _lsi_lattice(16, dev)
    errs["lsi_window"].append(_cmp("16^3 lattice, spacing 3 A (exact ties), brute form", l_k, l_p,
                                   _lsi_brute_args(lat, lat_b, False), lsi_tols))
    errs["lsi_window"].append(_cmp("16^3 lattice (exact ties), slab form", l_k, l_p,
                                   _lsi_slab_args(lat, lat_b)[3], lsi_tols))
    # and the split kernel there: equal raw distances among its next-shell
    # candidates, the first column wins
    errs["lsi_split_window"].append(_cmp("16^3 lattice (exact ties), brute form", s_k, s_p,
                                         _lsi_brute_args(lat, lat_b, True), lsi_tols))
    errs["lsi_split_window"].append(_cmp("16^3 lattice (exact ties), slab form", s_k, s_p,
                                         _lsi_split_args(lat, lat_b)[3], lsi_tols))
    narrow = list(_lsi_brute_args(sh[:2], boxes[:2], False))
    narrow[4] = 20
    narrow[2] = (torch.arange(-(-N_WATERS // 128), dtype=torch.int32, device=dev) * 97
                 % (N_WATERS - 20)).to(torch.int32)
    errs["lsi_window"].append(_cmp("windows of 20 columns", l_k, l_p, tuple(narrow), lsi_tols))
    narrow[2][1], narrow[2][5] = -1, N_WATERS - 19
    got, want = l_k(*narrow), l_p(*narrow)
    same = all(torch.equal(torch.nan_to_num(g, 7.0), torch.nan_to_num(x, 7.0))
               for g, x in zip(got, want))
    nan_rows = int(torch.isnan(got[0]).sum())
    print(f"[kernel] lsi_window, windows of 20 columns, tiles 1 and 5 outside the columns: "
          f"equal to the plain version (NaN rows {nan_rows}): {same}", flush=True)
    _check(same and nan_rows == 2 * 2 * 128, "lsi_window: windows outside the columns differ")
    del lat, lat_b, narrow, got, want

    # count certificate: a 16-member cluster in one 3.7 A shell of a box on
    # the split tier; the split kernel flags its rows, the escalation form
    # redoes them and the split tier serves. Without the cluster no row of
    # the box is incomplete
    cl_np, cl_boxes_np = _split_traj(N_SPLIT, 1, seed=7)
    clean = torch.from_numpy(cl_np.copy()).to(dev)
    incomplete_clean = int(s_k(*_lsi_split_args(clean, torch.from_numpy(cl_boxes_np).to(dev))[3])
                           [3].sum())
    _check(incomplete_clean == 0, f"cluster box without its cluster: {incomplete_clean} rows "
           "incomplete")
    rs_cl = np.random.RandomState(7)
    cluster = cl_np[0, 0] + rs_cl.normal(scale=1.2, size=(16, 3))
    cl_np[0, -16:] = np.clip(cluster, 0.0, cl_boxes_np[0, 0] - 1e-3)
    cl, cl_boxes = torch.from_numpy(cl_np).to(dev), torch.from_numpy(cl_boxes_np).to(dev)
    _check(lsi.split_tier(N_SPLIT, float(cl_boxes[0, 2]), LSI_HIGH), "16,384 waters: no split tier")
    incomplete = int(s_k(*_lsi_split_args(cl, cl_boxes)[3])[3].sum())
    errs["lsi_split_window"].append(_cmp("16-member cluster (rows with more than 12 in their "
                                         "shell)", s_k, s_p, _lsi_split_args(cl, cl_boxes)[3],
                                         lsi_tols))
    before = (l_k.launches, s_k.launches)
    got = lsi.lsi_certified(cl, cl_boxes)
    ran = (l_k.launches - before[0], s_k.launches - before[1])
    # the same dispatch on CPU tensors: its plain versions, the same prep
    want = lsi.lsi_certified(cl.cpu(), cl_boxes.cpu())
    same = all(torch.equal(torch.nan_to_num(g.cpu(), 7.0), torch.nan_to_num(w, 7.0))
               for g, w in zip(got, want))
    print(f"[kernel] 16-member cluster, {N_SPLIT} waters: split rows incomplete={incomplete} "
          f"(0 without the cluster), "
          f"tier={lsi.last_tier}, launches K=24/split (with the escalation)={ran}, equal to the "
          f"plain dispatch on the CPU: {same}", flush=True)
    _check(incomplete > 0 and lsi.last_tier == "slab-split" and ran == (0, 2),
           "the cluster box left the split tier or its escalation did not run")
    _check(same, "cluster box: the split tier with its escalation differs from its plain versions")
    del sh, cl, cl_boxes, clean, got, want

    # both H-bond kernels on 4096 waters x 8 frames of make_water_box: the
    # water-water sets; the JAX package's asymmetric sets (37 pseudo-donors
    # shifted 0.3 A, hydrogens 0.8 A further; 3.0 A, 150 degrees); the same
    # frames with a third of the stored atoms shifted by +/-L, which the
    # kernels' wrap must absorb; the slab kernel at the certified
    # dispatch's window against its plain version and the dense kernel, and
    # at w = 512, where `covered` must fail
    hd_k, hd_p = kernels["hbond_dense"]
    hs_k, hs_p = kernels["hbond_slab"]
    _, hb_traj = make_water_box(N_WATERS, n_frames=N_FRAMES_CMP, seed=0)
    hb_pos = torch.as_tensor(hb_traj.positions, device=dev)
    hb_boxes = torch.as_tensor(hb_traj.boxes, device=dev)
    rs_hb = np.random.RandomState(5)
    some = rs_hb.uniform(size=hb_traj.positions.shape[:2]) < 1.0 / 3.0
    hb_shift = hb_pos + torch.as_tensor(rs_hb.randint(-1, 2, size=hb_traj.positions.shape)
                                        * some[..., None], dtype=torch.float32,
                                        device=dev) * hb_boxes[:, None, :]
    w_sets = _hb_water_sets(hb_pos, N_WATERS)
    sol = w_sets[0][:, :37] + 0.3
    dense_counts = {}
    for label, sets, cuts in (("water-water", w_sets, (HB_DIST, HB_ANG)),
                              ("37 pseudo-donors, 3.0 A / 150 deg",
                               (w_sets[0], sol, sol + 0.8), (3.0, 150.0)),
                              ("water-water, +/-L shifts", _hb_water_sets(hb_shift, N_WATERS),
                               (HB_DIST, HB_ANG))):
        args = _hb_dense_args(*sets, hb_boxes, *cuts)
        errs["hbond_dense"].append(_cmp(f"dense, {label}", hd_k, hd_p, args, (0, 0)))
        dense_counts[label] = hd_k(*args)
    same = [torch.equal(a, b) for a, b in zip(dense_counts["water-water"],
                                             dense_counts["water-water, +/-L shifts"])]
    print(f"[kernel] hbond_dense: +/-L-shifted stored atoms give the unshifted counts: {same}; "
          f"bonds {int(dense_counts['water-water'][0].sum())} (water-water), "
          f"{int(dense_counts['37 pseudo-donors, 3.0 A / 150 deg'][0].sum())} (37 donors)",
          flush=True)
    _check(all(same), "hbond_dense: shifting stored atoms by +/-L changed the counts")
    for label, sets in (("water-water", w_sets),
                        ("water-water, +/-L shifts", _hb_water_sets(hb_shift, N_WATERS))):
        prep, args = _hb_slab_args(*sets, hb_boxes)
        _check(bool(prep.covered.all()), f"hbond slab prep not covered ({label})")
        errs["hbond_slab"].append(_cmp(f"slab (w={prep.w}), {label}", hs_k, hs_p, args, (0, 0)))
        got = hbond.unsort_two_set(prep, *hs_k(*args))
        _check(all(torch.equal(g, d) for g, d in zip(got, dense_counts[label])),
               f"hbond_slab ({label}) differs from hbond_dense")
    for label, sets, pb in _hb_planted(w_sets, hb_boxes):
        args = _hb_dense_args(*sets, pb)
        errs["hbond_dense"].append(_cmp(f"dense, {label}", hd_k, hd_p, args, (0, 0)))
        nd = sets[1].shape[1]
        if nd > 64:
            prep, sargs = _hb_slab_args(*sets, pb)
        else:  # the small box: every donor in one window, all of them copied on each side
            prep = hbond.slab_prep_two_set(*sets, pb, HB_DIST, nd, nd)
            sargs = (prep.acc, prep.don, prep.donh, prep.vhat, prep.starts, pb, prep.w,
                     HB_DIST * HB_DIST, hbond.cos_cut(HB_ANG))
        errs["hbond_slab"].append(_cmp(f"slab (w={prep.w}), {label}", hs_k, hs_p, sargs, (0, 0)))
        acc_c = hd_k(*args)[0]
        if nd > 64:
            planted = acc_c[:, N_WATERS:]
            print(f"[kernel] planted pairs: acceptor counts at the cut {planted[:, :3].tolist()[0]}, "
                  f"at half an edge {planted[:, 3:].tolist()[0]} (frame 0)", flush=True)
            _check(bool((planted[:, :3] >= 1).all()), "a pair at exactly the cut did not bond")
        else:
            print(f"[kernel] small box: acceptor counts {acc_c.tolist()}", flush=True)
    small, _ = _hb_slab_args(*w_sets, hb_boxes, window_w=512)
    print(f"[kernel] hbond_slab equals hbond_dense on every acceptor and donor; at w=512 covered="
          f"{small.covered.tolist()}", flush=True)
    _check(not bool(small.covered.any()), "hbond slab prep at w=512 certified a frame")
    del hb_pos, hb_shift, w_sets, sol, dense_counts, small

    # 3. the q_tet slice, through the user's entry point
    top, traj = make_water_box(N_WATERS, n_frames=N_FRAMES_SLICE, seed=0)
    wat_inds, _, _ = top.get_wat_inds()
    end_inds = wat_inds[1::2]
    sub_inds = [[wat_inds[::2]] for _ in range(N_FRAMES_SLICE)]
    end_sub = [[end_inds[::2]] for _ in range(N_FRAMES_SLICE)]
    drivers = {
        "tet_order_calc": lambda d: orderparams.tet_order_calc(
            top, traj, sub_inds=sub_inds, n_pops=1, output_dir=d, device="cuda"),
        "three_body_calc": lambda d: orderparams.three_body_calc(
            top, traj, sub_inds=sub_inds, n_pops=1, output_dir=d, output_2d=True, device="cuda"),
        "hex_order_calc": lambda d: orderparams.hex_order_calc(
            top, traj, sub_inds=end_sub, n_pops=1, output_dir=d, device="cuda"),
        "lsi_calc": lambda d: orderparams.lsi_calc(
            top, traj, sub_inds=sub_inds, n_pops=1, output_dir=d, device="cuda"),
    }
    launches = {}
    launches["qtet_window"] = _slice(
        f"tet_order_calc {N_WATERS} waters x {N_FRAMES_SLICE} frames", drivers["tet_order_calc"],
        kernels, "qtet_window", lambda: qtet2.last_tier, "slab",
        ["qDistribution_0.txt", "qDistribution_1.txt"], 2,
    )
    wat_pos = torch.as_tensor(traj.positions[:, wat_inds, :], dtype=torch.float32, device=dev)
    end_pos = torch.as_tensor(traj.positions[:, end_inds, :], dtype=torch.float32, device=dev)
    wat_boxes = torch.as_tensor(traj.boxes, dtype=torch.float32, device=dev)
    q_all = qtet2.order_param_q_certified(wat_pos, wat_boxes)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        q_all = qtet2.order_param_q_certified(wat_pos, wat_boxes)
    torch.cuda.synchronize()
    fps = 3 * N_FRAMES_SLICE / (time.perf_counter() - t0)
    q_ref = torch.stack([qtet.order_param_q(wat_pos[f], wat_pos[f], wat_boxes[f])
                         for f in range(16)])
    err_slice = float((q_all[:16] - q_ref).abs().max())
    print(f"[slice] q stage: {fps:.1f} frames/s ({N_WATERS} waters, F={N_FRAMES_SLICE}); "
          f"q of 16 frames vs plain PyTorch q: max|dq|={err_slice:.3e}", flush=True)
    _check(err_slice <= Q_TOL, f"slice q: max|dq| {err_slice} > {Q_TOL}")
    errs["qtet_window"].append(err_slice)

    # 4. the 3-body and psi6 slices, through the user's entry points
    launches["angles_window"] = _slice(
        f"three_body_calc {N_WATERS} waters x {N_FRAMES_SLICE} frames",
        drivers["three_body_calc"], kernels, "angles_window", lambda: angles.last_tier, "slab",
        ["3bDistribution_0.txt", "3bDistribution_1.txt"], 5,
    )
    launches["psi6_window"] = _slice(
        f"hex_order_calc {len(end_inds)} chain-end centers x {N_FRAMES_SLICE} frames",
        drivers["hex_order_calc"], kernels, "psi6_window", lambda: psi6.last_tier, "slab",
        ["psiDistribution_0.txt", "psiDistribution_1.txt"], 2,
    )
    for label, fn, p in (("angles", angles.neighbor_pair_angles_certified, wat_pos),
                         ("psi6", psi6.psi6_certified, end_pos)):
        fn(p, wat_boxes)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn(p, wat_boxes)
        torch.cuda.synchronize()
        fps = 3 * N_FRAMES_SLICE / (time.perf_counter() - t0)
        print(f"[slice] {label} stage (certified dispatch, F={N_FRAMES_SLICE}): "
              f"{fps:.1f} frames/s", flush=True)
        if label == "angles":
            ang_all, cnt_all = out
        else:
            psi_all, _ = out

    valid_all = angles.pair_validity(cnt_all[:16])
    err_ang = 0.0
    for f in range(16):
        ref = angles_ref.neighbor_angles(wat_pos[f], wat_pos[f], wat_boxes[f], 0.0, 3.413, k=16)
        _check(bool((cnt_all[f].long() == ref.count.long()).all()), f"frame {f}: counts differ")
        got = torch.sort(torch.where(valid_all[f], ang_all[f], -1.0), dim=1).values
        want = torch.sort(torch.where(ref.valid, ref.ang, -1.0).reshape(N_WATERS, -1),
                          dim=1).values[:, -got.shape[1]:]
        err_ang = max(err_ang, float((got - want).abs().max()))
    psi_ref = torch.stack([psi6_ref.order_param_psi(end_pos[f], end_pos[f], wat_boxes[f],
                                                     0.0, 7.0, k=24) for f in range(16)])
    err_psi = float((psi_all[:16] - psi_ref).abs().max())
    print(f"[slice] 16 frames vs plain paths: angle multisets max|d|={err_ang:.3e} deg "
          f"(counts equal), psi max|d|={err_psi:.3e}", flush=True)
    _check(err_ang <= 5e-3, f"slice angles: max|d| {err_ang} > 5e-3 degrees")
    _check(err_psi <= 5e-5, f"slice psi: max|d| {err_psi} > 5e-5")
    del ang_all, cnt_all, valid_all

    # the LSI slice, through the user's entry point: the K=24 slab tier
    launches["lsi_window"] = _slice(
        f"lsi_calc {N_WATERS} waters x {N_FRAMES_SLICE} frames", drivers["lsi_calc"],
        kernels, "lsi_window", lambda: lsi.last_tier, "slab",
        ["lsiDistribution_0.txt", "lsiDistribution_1.txt"], 2,
    )
    _check(launches["lsi_window"] == 1, f"lsi_calc launched lsi_window {launches['lsi_window']} times")
    lsi.lsi_certified(wat_pos, wat_boxes)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        lsi_all, lsi_ok, lsi_cnt = lsi.lsi_certified(wat_pos, wat_boxes)
    torch.cuda.synchronize()
    fps = 3 * N_FRAMES_SLICE / (time.perf_counter() - t0)
    err_lsi = 0.0
    for f in range(16):
        ref = lsi_ref.lsi(wat_pos[f], wat_pos[f], wat_boxes[f], 0.0, LSI_HIGH)
        _check(bool((lsi_ok[f] == ref.valid).all()), f"frame {f}: LSI valid flags differ")
        _check(bool((lsi_cnt[f] == ref.count).all()), f"frame {f}: LSI counts differ")
        err_lsi = max(err_lsi, float((lsi_all[f] - ref.lsi).abs().max()))
    print(f"[slice] lsi stage (certified dispatch, tier={lsi.last_tier}, F={N_FRAMES_SLICE}): "
          f"{fps:.1f} frames/s; 16 frames vs plain path order.lsi.lsi: valid and counts equal, "
          f"max|d lsi|={err_lsi:.3e} A^2", flush=True)
    _check(err_lsi <= LSI_REF_TOL, f"slice lsi: max|d| {err_lsi} > {LSI_REF_TOL}")
    del lsi_all, lsi_ok, lsi_cnt

    for label, drive in drivers.items():
        _stages(label, drive)

    # the split tier through the user's entry point, at the default
    # high_cut: each water of a synthetic box moved rigidly so that its
    # oxygen sits on `_split_traj`'s lattice (the same box edge)
    top_s, traj_s = make_water_box(N_SPLIT, n_frames=N_FRAMES_SPLIT, seed=0)
    wat_s = top_s.get_wat_inds()[0]
    ox, _ = _split_traj(N_SPLIT, N_FRAMES_SPLIT, seed=0)
    waters = traj_s.positions.reshape(N_FRAMES_SPLIT, N_SPLIT, 3, 3)
    traj_s = Trajectory((waters - waters[:, :, :1] + ox[:, :, None]).reshape(
        N_FRAMES_SPLIT, 3 * N_SPLIT, 3), traj_s.boxes)
    launches["lsi_split_window"] = _slice(
        f"lsi_calc {N_SPLIT} waters x {N_FRAMES_SPLIT} frames (split lattice)",
        lambda d: orderparams.lsi_calc(top_s, traj_s, sub_inds=[[wat_s[::2]]] * N_FRAMES_SPLIT,
                                       n_pops=1, output_dir=d, device="cuda"),
        kernels, "lsi_split_window", lambda: lsi.last_tier, "slab-split",
        ["lsiDistribution_0.txt", "lsiDistribution_1.txt"], 2,
    )
    _stages(f"lsi_calc, split tier ({N_SPLIT} waters x {N_FRAMES_SPLIT} frames)",
            lambda d: orderparams.lsi_calc(top_s, traj_s, sub_inds=[[wat_s[::2]]] * N_FRAMES_SPLIT,
                                           n_pops=1, output_dir=d, device="cuda"))
    split_pos = torch.as_tensor(traj_s.positions[:, wat_s, :], dtype=torch.float32, device=dev)
    split_boxes = torch.as_tensor(traj_s.boxes, dtype=torch.float32, device=dev)
    del top_s, traj_s

    # the H-bond slice, through the user's entry points: hb_calc and
    # get_bound_wrap on 4096 waters x 1024 frames with a solute whose nine
    # acceptor x donor sets are all non-empty (the dense tier), held on 16
    # frames against the arccos form `bonds.general_hbond_counts`; hb_calc
    # at 16,384 waters x 64 frames (the slab tier)
    top_h, traj_h = make_water_box(N_WATERS, n_frames=N_FRAMES_SLICE, seed=0,
                                   solute_elements=HB_SOLUTE)
    hb_files = ["hbDistribution_water.txt", "hbDistribution_cosolv.txt"]

    def hb_drive(d):
        return hbonds_driver.hb_calc(top_h, traj_h, output_dir=d, device="cuda")

    launches["hbond_dense"] = _slice(
        f"hb_calc {N_WATERS} waters + solute x {N_FRAMES_SLICE} frames", hb_drive, kernels,
        "hbond_dense", lambda: hbond.last_tier, "dense", hb_files, 2, shape=(10, 2),
        hist_sum=N_WATERS * N_FRAMES_SLICE,
    )
    sets_h, n_sol_h, _ = hbonds_driver.hb_sets(top_h, "WAT", dev)
    p_ref = torch.as_tensor(traj_h.positions[:N_FRAMES_HB_REF], device=dev)
    b_ref = torch.as_tensor(traj_h.boxes[:N_FRAMES_HB_REF], device=dev)
    got = hbonds_driver.hb_totals(p_ref, b_ref, sets_h, n_sol_h)
    want = hbonds_driver.hb_totals(p_ref, b_ref, sets_h, n_sol_h,
                                   water_counts=bonds.general_hbond_counts,
                                   counts=bonds.general_hbond_counts)
    if not torch.equal(got[0], want[0]):
        _hb_mismatch("hb_calc slice", p_ref, b_ref, top_h, got[0], want[0])
    _check(torch.equal(got[1], want[1]), "hb_calc slice: per-cosolvent totals differ")
    print(f"[slice] hb_calc, {N_FRAMES_HB_REF} frames: per-water and per-cosolvent totals equal "
          f"the arccos form's (general_hbonds on the card); mean per water "
          f"{float(got[0].float().mean()):.4f}, cosolvent {got[1][:, 0].tolist()[:4]}...",
          flush=True)

    torch.cuda.synchronize()
    for k, p in kernels.values():
        k.launches, p.calls = 0, 0
    t0 = time.perf_counter()
    bw = hbonds_driver.get_bound_wrap(top_h, traj_h, device="cuda")
    torch.cuda.synchronize()
    bw_wall = time.perf_counter() - t0
    bw_launches = hd_k.launches
    bw_plain = sum(p.calls for _, p in kernels.values())
    wat_h = top_h.get_wat_inds()[0]
    _, (_, _, donh_h) = hbonds_driver._water_triplets(top_h, "WAT")
    sol_h, triplet_o, _ = hbonds_driver._sol_hb_triplets(top_h, "WAT")
    ref = populations.bound_wrap_masks(
        *(p_ref[:, torch.as_tensor(i, device=dev)] for i in (wat_h, donh_h, sol_h, *triplet_o)),
        b_ref, counts=bonds.general_hbond_counts)
    ref = [m.cpu().numpy() for m in (ref.bound, ref.wrap, ref.shell, ref.non_shell)]
    bw_equal = all(np.array_equal(bw[t][k], wat_h[ref[k][t]])
                   for t in range(N_FRAMES_HB_REF) for k in range(4))
    print(f"[slice] get_bound_wrap {N_WATERS} waters + solute x {N_FRAMES_SLICE} frames: "
          f"hbond_dense launches={bw_launches} plain calls={bw_plain} wall={bw_wall:.3f} s; "
          f"frame 0 bound/wrap/shell/non-shell {[len(x) for x in bw[0]]}; {N_FRAMES_HB_REF} "
          f"frames equal the plain masks with general_hbond_counts: {bw_equal}", flush=True)
    _check(len(bw) == N_FRAMES_SLICE and bw_launches == 2 and bw_plain == 0,
           "get_bound_wrap did not run the dense kernel twice without plain calls")
    _check(bw_equal, "get_bound_wrap differs from the plain masks")
    _check(sum(len(f[2]) for f in bw) > 0 and sum(len(f[0]) for f in bw) > 0,
           "get_bound_wrap: no shell or no bound water in any frame")
    del p_ref, b_ref, got, want, bw, ref

    top_hs, traj_hs = make_water_box(N_HB_SLAB, n_frames=N_FRAMES_HB_SLAB, seed=0)
    launches["hbond_slab"] = _slice(
        f"hb_calc {N_HB_SLAB} waters x {N_FRAMES_HB_SLAB} frames",
        lambda d: hbonds_driver.hb_calc(top_hs, traj_hs, output_dir=d, device="cuda"), kernels,
        "hbond_slab", lambda: hbond.last_tier, "slab", hb_files, 2, shape=(10, 2),
        hist_sum=N_HB_SLAB * N_FRAMES_HB_SLAB,
    )
    _stages("hb_calc", hb_drive)

    # 5. each kernel's time at its slice's own launch (all 1024 frames, slab
    # form, as the certified dispatch plans it); plain version on 64 frames
    mains = {
        "qtet_window": (q_k, q_p, _slab_args(wat_pos, wat_boxes, 4.5, 256, 10.0, True)[3], 5, Q_TOL),
        "angles_window": (a_k, a_p, _slab_args(wat_pos, wat_boxes, 4.5, 128, 3.413, False)[3],
                          4 * 128 + 4, ANG_TOL),
        "psi6_window": (p_k, p_p, _slab_args(end_pos, wat_boxes, 7.0, 128, 7.0, False)[3],
                        4 + 4, PSI_TOL),
        "lsi_window": (l_k, l_p, _lsi_slab_args(wat_pos, wat_boxes)[3], 4 + 1 + 4, LSI_TOL),
        "lsi_split_window": (s_k, s_p, _lsi_split_args(split_pos, split_boxes)[3],
                             4 + 1 + 4 + 1, LSI_TOL),
    }
    times = {}
    for name, (kern, plain, args, out_bytes, tol) in mains.items():
        n_frames = args[0].shape[0]
        nf = N_FRAMES_SPLIT_PLAIN if name == "lsi_split_window" else N_FRAMES_PLAIN
        sub = _first_frames(name, args, nf)
        errs[name].append(_cmp(f"slab form, slice frames 0-{nf - 1}", kern, plain, sub,
                               (tol, 0, 0, 0)))
        ms = _ms(kern, args, 10) / n_frames
        plain_ms = _ms(plain, sub, 2) / nf
        annulus = _annulus(split_pos, split_boxes) if name == "lsi_split_window" else 0
        bound, bound_by = _bound_ms(name, args, out_bytes, annulus)
        times[name] = (ms, plain_ms, bound / n_frames, bound_by)
        width = f"w={args[4]}" + (f"/{args[9]}" if name == "lsi_split_window" else "")
        print(f"[time] {name} slab form at its slice's launch ({args[0].shape[2]} rows, "
              f"{width}): kernel {ms:.5f} ms/frame (F={n_frames}), plain "
              f"{plain_ms:.5f} ms/frame (F={nf}), bound {bound / n_frames:.5f} "
              f"ms/frame ({bound_by}), {bound / n_frames / ms:.1%} of its bound; {card}",
              flush=True)

    # the H-bond kernels at their slices' launches: hbond_dense on the
    # water-water sets of hb_calc's 4096 waters x 1024 frames, hbond_slab on
    # 16,384 waters x 64 frames and, for the crossover, on the 4096-water
    # frames; plain versions on N_FRAMES_HB_PLAIN frames
    bh = torch.as_tensor(traj_h.boxes, device=dev)
    bh16 = torch.as_tensor(traj_hs.boxes, device=dev)
    wh = _hb_water_sets(torch.as_tensor(traj_h.positions, device=dev), N_WATERS)
    wh16 = _hb_water_sets(torch.as_tensor(traj_hs.positions, device=dev), N_HB_SLAB)
    prep4, slab4 = _hb_slab_args(*wh, bh)
    prep16, slab16 = _hb_slab_args(*wh16, bh16)
    within4, within16 = _hb_within(prep4, bh), _hb_within(prep16, bh16)
    for name, label, args, within, na, main in (
            ("hbond_dense", f"{N_WATERS} waters", _hb_dense_args(*wh, bh), within4, N_WATERS,
             True),
            ("hbond_slab", f"{N_HB_SLAB} waters, w={prep16.w}", slab16, within16, N_HB_SLAB, True),
            ("hbond_slab", f"{N_WATERS} waters, w={prep4.w}", slab4, within4, N_WATERS, False)):
        kern, plain = kernels[name]
        n_frames, nf = args[0].shape[0], N_FRAMES_HB_PLAIN
        sub = tuple(a[:nf] if torch.is_tensor(a) else a for a in args)
        errs[name].append(_cmp(f"{label}, frames 0-{nf - 1}", kern, plain, sub, (0, 0)))
        ms = _ms(kern, args, 10) / n_frames
        plain_ms = _ms(plain, sub, 1) / nf
        bound, bound_by = _hb_bound_ms(args, na, within, name == "hbond_slab")
        if main:
            times[name] = (ms, plain_ms, bound / n_frames, bound_by)
        print(f"[time] {name} at {label} (F={n_frames}, {within / n_frames:.0f} pairs within "
              f"{HB_DIST} A a frame): kernel {ms:.5f} ms/frame, plain {plain_ms:.5f} ms/frame "
              f"(F={nf}), bound {bound / n_frames:.5f} ms/frame ({bound_by}), "
              f"{bound / n_frames / ms:.1%} of its bound; {card}", flush=True)
    del wh, wh16, prep4, slab4, prep16, slab16, top_hs, traj_hs
    del wat_pos, end_pos, split_pos, split_boxes

    # 6. 131k and 1M atoms: the certified dispatch takes the slab tier, and
    # each kernel equals its plain version on two boundary row tiles
    for n_big in LARGE_SIZES:
        bp_np, bb_np = _lattice_traj(n_big, 1, seed=n_big % 997)
        bp, bb = torch.from_numpy(bp_np).to(dev), torch.from_numpy(bb_np).to(dev)
        cases = (
            ("qtet_window", lambda: (qtet2.order_param_q_certified(bp, bb),), lambda: qtet2.last_tier,
             4.5, 256, 10.0, True, (Q_TOL, 0)),
            ("angles_window", lambda: angles.neighbor_pair_angles_certified(bp, bb),
             lambda: angles.last_tier, 4.5, 128, 3.413, False, (ANG_TOL, 0)),
            ("psi6_window", lambda: psi6.psi6_certified(bp, bb), lambda: psi6.last_tier,
             7.0, 128, 7.0, False, (PSI_TOL, 0)),
        )
        for name, certified, tier_of, margin, rt_, high, is_q, tols in cases:
            kern, plain = mains[name][:2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = certified()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tier = tier_of()
            _check(tier == "slab", f"{name} at {n_big} atoms took tier {tier}, not slab")
            prep, nn, pad, args = _slab_args(bp, bb, margin, rt_, high, is_q)
            sub, sel = _two_tiles(args, prep.n_tiles, nn, rt_, ((0,), (2,)))
            err = _cmp(f"{n_big} atoms, 2 row tiles (w={args[4]})", kern, plain, sub, tols)
            errs[name].append(err)
            k_out = kern(*sub)[0]
            atoms = prep.order0[sel]  # the tiles' rows in the original atom order
            err_full = float((full[0][:, atoms] - k_out).abs().max())
            _check(err_full <= tols[0], f"{name} at {n_big}: full launch vs tiles {err_full}")
            ms = _ms(kern, args, 3)
            plain_ms = _ms(plain, sub, 1) * prep.n_tiles / 2
            bound, bound_by = _bound_ms(name, args, mains[name][3])
            print(f"[large] {name} {n_big} atoms: tier={tier} certified call {wall:.3f} s, "
                  f"w={args[4]}, full launch vs 2-tile launch max|d|={err_full:.3e}; kernel "
                  f"{ms:.3f} ms/frame, plain {plain_ms:.1f} ms/frame (2 row tiles timed, "
                  f"scaled by {prep.n_tiles}/2), bound {bound:.3f} ms/frame ({bound_by}); {card}",
                  flush=True)
            del full, prep, args, sub, k_out

        # LSI at high_cut 3.7: at 131,072 atoms the split tier on
        # `_split_traj`'s lattice, and the K=24 kernel on `_lattice_traj`'s,
        # where the count certificate fails; at 1,048,576 the K=24 kernel
        lsi_cases = [("lsi_window", bp, "slab")]
        if n_big == LARGE_SIZES[0]:
            sp_np, _ = _split_traj(n_big, 1, seed=n_big % 997)
            lsi_cases.insert(0, ("lsi_split_window", torch.from_numpy(sp_np).to(dev),
                                 "slab-split"))
        for name, lp, want_tier in lsi_cases:
            split = name == "lsi_split_window"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = lsi.lsi_certified(lp, bb)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _check(lsi.last_tier == want_tier,
                   f"lsi_certified at {n_big} atoms ({name}) took tier {lsi.last_tier}, "
                   f"not {want_tier}")
            prep, pad, raw, args = _lsi_split_args(lp, bb) if split else _lsi_slab_args(lp, bb)
            kern, plain = kernels[name]
            sub, sel = _two_tiles(args, prep.n_tiles, n_big, 128,
                                  ((0, 6), (2, 8) if split else (2,)))
            width = f"w={args[4]}" + (f"/{args[9]}" if split else "")
            errs[name].append(_cmp(f"{n_big} atoms, 2 row tiles ({width})", kern, plain, sub,
                                   (LSI_TOL, 0, 0, 0)))
            k_out = kern(*sub)
            atoms = prep.order0[sel]  # the tiles' rows in the original atom order
            err_full = float((full[0][:, atoms] - k_out[0]).abs().max())
            _check(err_full <= LSI_TOL and bool((full[1][:, atoms] == k_out[1]).all()),
                   f"{name} at {n_big}: full launch vs tiles {err_full}")
            ms = _ms(kern, args, 3)
            plain_ms = _ms(plain, sub, 1) * prep.n_tiles / 2
            bound, bound_by = _bound_ms(name, args, 10 if split else 9,
                                        _annulus(lp, bb) if split else 0)
            print(f"[large] {name} {n_big} atoms: tier={lsi.last_tier} "
                  f"certified call {wall:.3f} s, {width}, full launch vs 2-tile launch "
                  f"max|d|={err_full:.3e}; kernel {ms:.3f} ms/frame, plain {plain_ms:.1f} "
                  f"ms/frame (2 row tiles timed, scaled by {prep.n_tiles}/2), bound "
                  f"{bound:.3f} ms/frame ({bound_by}); {card}", flush=True)
            del full, prep, raw, args, sub, k_out
        del bp, bb, lsi_cases, lp
        torch.cuda.empty_cache()


    # H-bonds at 131,072 and 349,525 waters (1,048,575 atoms), 1 frame: the
    # certified dispatch takes the slab tier, the slab kernel equals the
    # dense kernel on every acceptor and donor, and each kernel equals its
    # plain version on two acceptor tiles (the first and the last)
    for n_big in HB_LARGE:
        hp_np, hb_np = _hb_water_frames(n_big, 1, seed=n_big % 997)
        hp, hbx = torch.from_numpy(hp_np).to(dev), torch.from_numpy(hb_np).to(dev)
        sets = _hb_water_sets(hp, n_big)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cert = hbond.hbond_counts_certified(*sets, hbx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tier = hbond.last_tier
        dense = hbond.hbond_counts(*sets, hbx)
        _check(tier == "slab", f"hbond_counts_certified at {n_big} waters took tier {tier}")
        _check(all(torch.equal(c, d) for c, d in zip(cert, dense)),
               f"hbond_slab differs from hbond_dense at {n_big} waters")
        prep, sargs = _hb_slab_args(*sets, hbx)
        dargs = _hb_dense_args(*sets, hbx)
        n_tiles = prep.starts.shape[1]
        sel = torch.cat([torch.arange(0, 128), torch.arange((n_tiles - 1) * 128, n_tiles * 128)])
        sel = sel.to(dev)
        s_sub = (sargs[0][:, :, sel].contiguous(), *sargs[1:4],
                 sargs[4][:, [0, n_tiles - 1]].contiguous(), *sargs[5:])
        d_sel = torch.cat([torch.arange(0, 128), torch.arange(n_big - 128, n_big)]).to(dev)
        d_sub = (dargs[0][:, :, d_sel].contiguous(), *dargs[1:])
        errs["hbond_slab"].append(_cmp(f"{n_big} waters, 2 acceptor tiles (w={prep.w})", hs_k,
                                       hs_p, s_sub, (0, 0)))
        errs["hbond_dense"].append(_cmp(f"{n_big} waters, 2 acceptor tiles", hd_k, hd_p, d_sub,
                                        (0, 0)))
        real = sel < n_big
        s_out, d_out = hs_k(*s_sub)[0], hd_k(*d_sub)[0]
        _check(torch.equal(s_out[0, real], dense[0][0, prep.order_a[0, sel[real]]])
               and torch.equal(d_out[0], dense[0][0, d_sel]),
               f"H-bond kernels at {n_big}: 2-tile launches differ from the full launches")
        within = _hb_within(prep, hbx)
        for name, kern, plain, args, sub, n_sub_tiles in (
                ("hbond_dense", hd_k, hd_p, dargs, d_sub, -(-n_big // 128)),
                ("hbond_slab", hs_k, hs_p, sargs, s_sub, n_tiles)):
            ms = _ms(kern, args, 1 if name == "hbond_dense" else 3)
            plain_ms = _ms(plain, sub, 1) * n_sub_tiles / 2
            bound, bound_by = _hb_bound_ms(args, n_big, within, name == "hbond_slab")
            width = f"w={prep.w}" if name == "hbond_slab" else f"{2 * n_big} donors"
            print(f"[large] {name} {n_big} waters ({3 * n_big} atoms, {width}, {within} pairs "
                  f"within {HB_DIST} A): certified call {wall:.3f} s, tier={tier}; kernel "
                  f"{ms:.3f} ms/frame, plain {plain_ms:.1f} ms/frame (2 acceptor tiles timed, "
                  f"scaled by {n_sub_tiles}/2), bound {bound:.3f} ms/frame ({bound_by}); {card}",
                  flush=True)
        del hp, hbx, sets, cert, dense, prep, sargs, dargs, s_sub, d_sub
        torch.cuda.empty_cache()

    # 7. the Willard-Chandler interface slice
    _willard_phases(card, kernels, errs, launches, times, sass_ops)

    # 8. the SASA slice; 9. the earlier q kernels
    _sasa_phases(card, kernels, errs, launches, times)
    _qtet_legacy_phases(card, kernels, errs, launches, times)

    # 10. the Voronoi volumes slice; 11. the fused cell kernel and the
    # Voronoi contacts slice
    _voronoi_phases(card, kernels, errs, launches, times)
    _voronoi_cells_phases(card, kernels, errs, launches, times)
    _voronoi_contacts_phases(card, kernels, errs)

    # the redesigned q and split LSI kernels', the H-bond and K=24 LSI
    # kernels' and the Voronoi window search's device time alone, each group
    # in a process of its own (`_alone`)
    for group in ("q", "hb", "vor"):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--alone", group], check=True,
                       timeout=900)

    # no jax, and nothing of the JAX package
    _check("jax" not in sys.modules, "jax was imported")
    shared = sorted(m for m in sys.modules
                    if m == "waterorderlib_tpu" or m.startswith("waterorderlib_tpu."))
    _check(not shared, f"modules of the JAX package were imported: {shared}")
    _env_line()
    print(_ptxas_summary(build.BUILD_LOG), flush=True)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": max(errs[name]),
        "ms": times[name][0],
        "plain_ms": times[name][1],
        "bound_ms": times[name][2],
        "bound_by": times[name][3],
        "library_ms": times[name][4] if len(times[name]) > 4 else None,
    } for name in SOURCES]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_alone(sys.argv[2]) if sys.argv[1:2] == ["--alone"] else main())
