#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fccf_pcr_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero and prints no
result:

  1. environment: torch / CUDA / nvcc versions and the card's name and
     power limit (nvidia-smi); no card -> fail (never a CPU fallback);
  2. build the eight sources with nvcc, in parallel: csrc/label_prop.cu
     (the label-propagation kernels: the propagation entry, one
     cooperative launch a propagation, and the one-sweep entry K1),
     csrc/gather.cu (the per-row gather P1), csrc/cluster.cu (the
     cluster stage's block scan C1, the standalone block-seed walk and
     the floor walk C2), csrc/lm.cu (the LM solve L1), csrc/scan.cu
     (the integer scans S1 and the blocked prefix sum S2) and
     csrc/faces.cu (the faces stage's plane fit F1 and label segment sums
     F2), csrc/hypotheses.cu (the hypotheses stage's H1, H2 and H3 and
     its bases form) and csrc/fine.cu (fine verify's join V: the lookup,
     counts, places and score in one launch); ptxas's registers, shared
     memory and spills of each kernel;
  3. label propagation vs its plain PyTorch version on the card, through
     the propagation kernel and through the per-sweep host loop (K1 +
     P1 launches): clustered voxel stats at V=1536 (office), V=1000 (a
     tail) and V=9216 (heritage), batch 2 (a pass-1 prefix bound and a
     small pass-2 bound), and the edge cases (bounds 0 and 1, no valid
     row, one component spanning every voxel, only isolated voxels, V
     under one tile, P=3 with mixed bounds, P=3 pairs that converge at
     different sweeps, so the kernel drops a pair at its fixpoint from
     the later sweeps); labels must be equal. Then
     the main path's own pass-1 inputs (seed 0's target cloud at office
     and heritage, and heritage's through measure_content at V=16384,
     the largest V of any path): one sweep and its plain version timed,
     with the
     bound and the roofline share; one propagation through the kernel
     and through the host loop, in device time and wall time, the
     sweeps it ran, the device time outside its sweep phase, and its
     bound; and the two propagation launches of the heritage batch-8
     step (their own inputs, 16 clouds each): each launch's device time,
     sweeps and bound, labels equal to plain;
  4. P1 vs its plain version: the TPU probe's own inputs
     (tools/probe_gather.py) and label rows at the main path's shapes,
     (8, 9216) included; outputs must be equal; times beside plain and
     beside torch.gather alone (the library call, never called by the
     port);
  5. the main path at the full eth-office preset: configs.CONFIGS["office"]
     scenes for seeds 0-3 -> one batched pre_downsample a side -> the
     batched program (make_register_fn(batched=True), one program for
     the batch) on the card, held to the office rows of
     tests/golden/pipeline.json (transform within 0.1 deg / 0.02 m,
     status and kept mask equal) and to configs.GATES["office"] against
     ground truth; the propagation kernel's launch count must grow and
     the one-sweep and gather kernels' must not (the main path launches
     neither); each pair registered alone (P = 1) must match its batch
     row (status, kept mask, hypothesis and face counts equal, transform
     within 1e-3 deg / 1e-4 m); the join V must launch; a second run,
     timed, must give
     bitwise-equal transforms; office, structured, resso and heritage
     also within tests/test_twin_production.py's bands of the NumPy
     twin's cached transforms (tests/golden/twin_production.json);
  6. the same for every other golden config at its full preset:
     structured (stairs and hall scenes, round-robin by seed), resso,
     apartment, cross-season and the building-scale heritage (two-key
     voxelization, V=9216); then office seed 0 with the target cut to its
     valid rows (another length than the source's), every field bitwise
     equal to the equal-length run; every config's path must launch L1;
  7. the command line in subprocesses: `python -m fccf_pcr_torch SRC TAR
     0.2 --caps heritage --device cuda --json` on the heritage seed-0
     pair written as PLY, held to its golden row; and a `--batch --out
     --caps auto` sweep of the resso seed-0 pair, held to
     configs.GATES["resso"];
  8. steady-state step time at batch 8 (build excluded), office and
     heritage, in pairs/s, each kernel's launches per step and the
     sweeps the propagation kernel ran (at most 4 propagation launches a
     step, no one-sweep, gather or standalone block-seed launch; one
     block-scan launch, whatever H / 512 is, one floor walk and one L1
     launch, 9 S1 calls and S2 called, one F1 and three F2 launches,
     one each of H1, H2 and H3 and no bases form, one join V),
     and per step: every
     kernel
     launched, as host
     launches (the CUDA runtime's launch calls, cudaGraphLaunch
     included) and as device kernels (the kernels CUPTI saw run, those
     inside a graph replay included), both from torch.profiler, the step
     graph's captures and replays (pipeline/register.py's STEP: a warm
     step is 1 step graph replay and nothing else), the host syncs
     (counted under torch.cuda.set_sync_debug_mode("warn"); there must
     be none), the peak device memory (torch.cuda.max_memory_allocated:
     a replay allocates only its outputs' clones) and beside it the
     private pool the step's capture made (the step graph holds about
     the eager step's peak there), and all graphs' pools;
  9. the mesh dry run: the office batch of 8 split over one card listed
     k times (parallel/mesh.py, make_mesh([cuda:0] * k), k = 2 and 4) and
     over make_mesh() (every card), every field bitwise equal to the
     unsplit batch; step wall times for k = 1, 2, 4 in turns and
     sharded_mean_errors against ground truth;
 10. the face-membership diff (twin/diff.py) on the five twin-sweep
     families' seed-30 targets at TEST_CAPS: the pipeline membership on
     the card equal to the CPU run's, the propagation kernel launched,
     pair_agreement > 0.98 and matched_fraction > 0.95;
 11. one heritage batch-8 step through the step graph under
     utils/profiling.py's trace (its Chrome trace must name
     label_prop_propagate, the block scan, the floor walk and L1): the device's busy
     share and the kernels with the most device time; then one eager
     step under the trace and a StageTimer: host time per stage
     (register.py's record_function scopes, which a replay does not
     run), its busy share and kernels;
 12. the accuracy sweep (evaluation/evaluate.py): every non-sequence
     config, 16 seeds at batch 8 with escalate_caps="auto", 100% success,
     seeds 0-3 within their golden rows' bands; summary and pairs/s;
 13. escalation: office scenes at 3 cm noise on the office preset flag
     their residual bound; escalated rows (two-key wide_extent
     voxelization at V=1536) bitwise equal to a direct batch at the
     escalation caps, and run_sweep's escalated records too;
 14. the overlap curve (evaluation/overlap_eval.py) at 8 seeds a point,
     its CURVE lines; the rows at overlap 1.0 equal phase 12's;
 15. the production twin check (evaluation/twin_production.py): all 24
     fixture pairs inside their bands, the worst printed;
 16. content measurement (evaluation/measure_content.py): office seed 0
     equal on the card and on the CPU at max_voxels 4096; heritage seeds
     0-1 at V=16384, each count at or under the heritage preset's bound;
 17. --native-io: make -C csrc, the library loads, and the CLI's --json
     record of the resso seed-0 pair with --native-io equals the Python
     reader's, at the resso preset and at tiny caps, where both scans are
     subsampled at load;
 18. (run after phase 8) the register step as one CUDA graph against
     the eager step: the batch-8 step of phase 8 at office and heritage
     replayed as a graph (make_register_fn, the main path), run eagerly
     (_register_batch, L1 launched eagerly) and run eagerly with the
     plain LM loop and its early exit (gauss_newton.lm_loop put into the
     step):
     every field bitwise equal; per step for each arm the host syncs,
     host launches and device kernels, step graph captures and replays
     (the eager arms capture and replay none), peak memory and the
     graphs' pools, and step wall times in turns (graph, eager, eager,
     graph, graph, eager); the LM alone on that step's own inputs: L1
     against the eager loop with and without its early exit, bitwise
     equal, in wall ms and in CUDA-event ms, and the device kernels of
     one call. Then every
     golden config's seeds as one batch, and the office batch of 8 over
     make_mesh([cuda:0] * 2), through the step graph and the eager step
     in turns (graph, eager, eager, graph), every field bitwise equal;
 19. (run after phase 4) C1, the block scan, against its plain version
     (the PyTorch block loop, block_scan_plain) on the card: the
     hypotheses of the eager step at seed 0 of office, heritage and
     structured and of the batch-8 steps at all three, and synthetic
     pools (mixed, one type, an empty lane, a chain, non-finite
     entries, H = 512, 2048 and 8192); seeds equal, sizes and member
     sums equal bit for bit (NaN where plain has one); its device time
     at the batch-8 steps' hypotheses beside the plain loop's, the
     library call's (the JAX formulation: one torch.matmul(geo_f,
     stats_cols) a block, TF32 off) and the bound. The standalone block-seed walk and C2 against
     their plain versions (the fixpoint; the host walk): every block's
     walk inputs of the plain scan and the floor walk's inputs of those
     steps, and the edge cases (an empty mask, all eligible, a chain,
     one ball, a full mask, no eligible row, B = 200; cluster_num 0, 1
     and large, all sizes equal, a floor that drops below 2, an empty
     tail, no seed, one slot, each stop in the last slot of a round of
     32, ties at the floor, NaN sizes, a first floor above 2^24, W = 1000
     and 8192, sizes that are no integers); outputs equal; their device
     times at the heritage batch-8 step's inputs beside the plain
     versions' and the bounds, and C2's slots walked (the most a lane
     and in all). Then the cluster stage's device time on each batch-8 step's
     hypotheses with the plain loop, with C1, and captured as a graph;
 20. (run after phase 18) L1 against its plain version
     (gauss_newton.lm_loop run to its cap) on the card, torch.equal:
     the LM inputs of the batch-8 steps at office and heritage (phase
     18's), of seed 0 of every golden config, and the edge cases (all
     weights 0, a NaN plane, a lane at zero cost, iters 0, 1 and 50, Bt
     1, 12, 96 and 192, F 4, 16, 32, 33, 64, 200, 4097 and 40000); the
     LM steps each lane ran and those it accepted; at the heritage step's
     inputs a lane alone and in 12 lanes against the same lane in the 96,
     q, t and both counts bitwise equal; L1's
     device time at the heritage step's inputs beside the plain loop
     captured as a graph of its own and replayed (CUDA events), the
     eager loop and the bound, and its two instantiations in turns;
 21. (run after phase 18) the device time of one eager batch-8 step by
     stage, at heritage and office: each device kernel put in the
     record_function ranges around the host op that launched it
     (register.py's stages, the finer ranges of the port's modules), by
     stage and by chain of ranges: device ms, kernels and the three
     kernels with the most time, every kernel in a stage and the buckets
     adding up to the step's kernels; three times: with the step's scans
     as their plain versions (the port before S1 and S2), with the
     voxelization's leaf and moment columns concatenated and then
     prefix-summed by S2 (the port before the fused S2), and through S1
     and the fused S2, whose voxelize.leaf and voxelize.voxels ranges
     must hold no torch.cat / torch.stack of float32 columns of the
     clouds' rows (seen by a TorchDispatchMode; the concatenated arm
     must show them, so the check is proven) and as many fewer 3-D
     float32 CatArrayBatchedCopy kernels as the concatenated arm makes
     such calls there; beside it the graph step's kernel count and the
     kernel names a
     replay holds more or fewer than the eager step; a fourth time with
     F1 and F2 swapped for their plain versions (the port before them),
     against which the kernels' arm must hold no kernel but F1 in the
     faces_kernels.plane_fit range (no eigen3 chain), and no
     CatArrayBatchedCopy (the doubling steps) and no sort kernel (F2
     orders the rows itself) beside its three F2 launches in the
     face_stats and roughness ranges of F2 (faces_kernels.face_stats /
     .segment_sum); a fifth time with H1-H3 swapped for their plain
     versions (the port before them), against which the kernels' arm
     must hold in the hypotheses stage no sort kernel, one launch each of
     H1, H2 and H3 and at most 6 kernels in all (the plain arm's sort
     kernels there prove the check); a sixth time with the join V swapped
     for its plain versions (fine verify's searchsorted counts and dense
     fold_sum), against which the kernels' arm must hold in the
     fine_kernels.join range one launch of V and nothing else (no
     counters' fill), and no sort kernel in the
     fine_verify stage outside its table's fine.table range (the plain
     arm's kernels in those ranges prove the ranges catch them);
 22. S1 and S2 against their plain versions on the card, bit for bit:
     every S1 and S2 input of the heritage and office batch-8 eager steps
     (the fused S2 calls by their sources) and the edge cases (S1: rows
     of 1, 17, 1023, 1024, 1025, 4095, 4096, 4097, 8192, 8193 and 12289
     entries (tiles of 1024), one row
     and many, all-false and all-true flags, int32 and int64 values near
     2^31, sentinel tails; S2: -0.0, inf and NaN in the float input,
     lengths 1, 17, 257 and 65537; the fused S2: -0.0, inf and NaN in p
     and px, masked rows where x * 0.0 gives -0.0 or NaN, lengths 1, 17,
     4097, 65537 and 65536 + 4096 k +- 1); every kernel called twice in
     one captured CUDA graph, replayed twice, equal to the eager calls
     (the calls' scratch may share the graph's pool); at the steps'
     inputs each call's device
     time (a graph of 10 calls, CUDA events) beside the plain version's,
     the library call's (torch.cumsum / torch.cummax / torch.cummin; for
     S2 torch.cumsum, another order of additions, on the columns formed
     beforehand) and the bound (the fused S2: its sources read once and
     its output written once), for a fused call also the columns
     concatenated and then prefix-summed by S2, and their sums a step;
 23. F1 and F2 against their plain versions on the card, bit for bit:
     first F1's cosf and atan2f against torch.cos and torch.atan2 at
     every float32 of their domains in the plane fit (cos on [0, pi],
     atan2 at every r in [-1, 1]) and at random float32 pairs; then every
     F1 and F2 input of the heritage and office batch-8 eager steps (one
     F1, two face statistics and one roughness call a step) and the edge
     cases (zero, isotropic and rank-1 covariances, -0.0 off-diagonals
     around a negative eigenvalue, NaN and inf entries, V = 1; F2 at V =
     1, one-voxel faces, labels past V, every valid row labelled V or
     above, negative labels, labels in sorted runs from the first row (a
     -0.0 sum kept where no +0.0 reaches it), -0.0 and NaN sources, V =
     16384, V = 40000 with one face of every voxel, which does not fit in
     shared memory, labels below -2^31); F2's own stable order
     (faces_kernels.label_order: the sum forms' blocks, each sorting its
     range of slots) against torch.sort(stable=True) on every F2 input,
     refused where a valid label is below -2^31; every form called
     twice in one captured CUDA graph, replayed twice, equal to the eager
     calls; at the steps' inputs each call's device time (a graph of 10
     calls) beside the plain version's, the library call's
     (torch.linalg.eigh of the covariances for F1, in the fewest equal
     slices cuSOLVER takes, by CUDA events around 5 calls since it reads
     back its error flags; Tensor.index_add_ of the columns as formed
     into the slots of seg from the unsorted labels for F2, atomics in
     another order) and the bound (F2: the labels, the valid flags and
     the sources read once, the outputs written once);
 24. H1, H2 and H3 (the hypotheses stage) and its bases form against
     their plain versions on the card, bit for bit (NaN-aware): first
     CUDA's acosf against torch.arccos at every float32 in [-1, 1] and
     at random float32 of any magnitude; then every H1, H2 and H3 input
     of the heritage and office batch-8 eager steps (one call each a
     step; the bases form on the steps' 2P face sets) and the edge cases
     (random faces at F = 16, 5, 24, 64 and 96, PER_MATCH 16 and 48 and
     above F * F + 1, each overflow (M, H and a row's PER_MATCH), no valid
     face, zero normals, NaN normals, centroids and point sizes, one
     face; H2 on matches whose runs of one source base cross its chunks,
     are cut by the count, hold every match or one match each; a lane
     alone against a batch of 8; H2's hits compared where kept, H3 also
     on H2's own slots); the stage called
     twice in one captured CUDA graph, replayed twice, equal to the eager
     calls; at the steps' inputs each call's device time (a graph of 10
     calls) beside the plain version's and the bound (no one PyTorch call
     computes any of them);
 25. the join V (fine verify's lookup, counts and score in one launch)
     against its plain versions on the card, bit for bit (NaN-aware): the
     V input of the heritage and office batch-8 eager steps (one call a
     step), each of their pairs alone against its row of 8, and the edge
     cases (an empty table and target, every point outside the window, an
     overflowing and an aliased table, NaN and huge translations, one
     live run, one cell, odd and even n, Vf = 1, 13 slots, a hit count
     past 65535; the sizes that choose clusters of 2, 4 and 8 blocks and
     the scratch: default caps, 40000 slots, an escalation of auto caps,
     --caps large, 270000 points), each in the cluster size the wrapper
     picks for it, which must be the case's; fine_verify called twice in one captured CUDA
     graph, replayed twice, equal to the eager calls; at the steps'
     inputs the call's device time (a graph of 10 calls) beside the plain
     version's and the bound (fine_bound's: the points, mask, T and
     table read once and the scores written once, against the lookup's
     operations; no one PyTorch call computes it).

Phases 5-6 are the main path: their launch counts are the kernels'
"launches". Every later in-process path (12-16) is driven with the
counts set to 0 just before it and read just after (drive_path): each
must launch the propagation kernel, C1 (the block scan), S1, S2, F1 and
F2, and neither
the one-sweep, the gather nor the standalone block-seed kernel, and
each but the content measurement (which
stops at the seeds and takes the bases form) must replay a step graph
and launch H1, H2, H3, C2, L1 and V. A path's
kernels launched inside a captured step graph count at each replay
(ops/graph.py's count_launch); the hooks that record a kernel's inputs
(phases 3, 18, 19, 20, 22, 23, 24, 25) drive the eager step, where
Python runs.

Then one JSON line describing the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""


import collections
import contextlib
import functools
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "pipeline.json"
TWIN_PRODUCTION = GOLDEN.with_name("twin_production.json")
# The golden configs, in the order phases 5-6 run them.
PATH_CONFIGS = ("office", "structured", "resso", "apartment", "cross-season",
                "heritage")
KERNELS = {
    "label_prop_propagate": dict(
        name="label_prop_propagate",
        route="cuda",
        source="fccf_pcr_torch/csrc/label_prop.cu",
        replaces="tools/probe_gather.py:23",
        also_replaces="fccf_pcr_tpu/ops/pallas/label_prop.py:72",
    ),
    "label_prop_sweep": dict(
        name="label_prop_sweep",
        route="cuda",
        source="fccf_pcr_torch/csrc/label_prop.cu",
        replaces="fccf_pcr_tpu/ops/pallas/label_prop.py:72",
    ),
    "gather_rows": dict(
        name="gather_rows",
        route="cuda",
        source="fccf_pcr_torch/csrc/gather.cu",
        replaces="tools/probe_gather.py:23",
    ),
    # The cluster stage's device loops: no Pallas kernel, the lax loops of
    # the JAX package's compiled program. C1 is the whole block scan; the
    # standalone block-seed walk (its intra-block fixpoint alone) is off
    # the main path.
    "cluster_block_scan": dict(
        name="cluster_block_scan",
        route="cuda",
        source="fccf_pcr_torch/csrc/cluster.cu",
        replaces="fccf_pcr_tpu/cluster/cluster.py:93",
    ),
    "cluster_block_seeds": dict(
        name="cluster_block_seeds",
        route="cuda",
        source="fccf_pcr_torch/csrc/cluster.cu",
        replaces="fccf_pcr_tpu/cluster/cluster.py:157",
    ),
    "cluster_floor_walk": dict(
        name="cluster_floor_walk",
        route="cuda",
        source="fccf_pcr_torch/csrc/cluster.cu",
        replaces="fccf_pcr_tpu/cluster/cluster.py:260",
    ),
    # The LM refine's device loop: no Pallas kernel, the lax.while_loop of
    # the JAX package's compiled program.
    "lm_refine": dict(
        name="lm_refine",
        route="cuda",
        source="fccf_pcr_torch/csrc/lm.cu",
        replaces="fccf_pcr_tpu/refine/gauss_newton.py:100",
    ),
    # The step's scans along long rows: no Pallas kernel, jnp.cumsum and
    # lax.cummax in the JAX package's compiled program.
    "scan_int": dict(
        name="scan_int",
        route="cuda",
        source="fccf_pcr_torch/csrc/scan.cu",
        replaces="fccf_pcr_tpu/ops/voxelize.py:526",
        also_replaces=["fccf_pcr_tpu/ops/voxelize.py:116",
                       "fccf_pcr_tpu/ops/voxelize.py:208",
                       "fccf_pcr_tpu/ops/voxelize.py:386"],
    ),
    "prefix_sum16": dict(
        name="prefix_sum16",
        route="cuda",
        source="fccf_pcr_torch/csrc/scan.cu",
        replaces="fccf_pcr_tpu/ops/voxelize.py:143",
        also_replaces=["fccf_pcr_tpu/ops/voxelize.py:530",
                       "fccf_pcr_tpu/ops/voxelize.py:584"],
    ),
    # The faces stage's plane fit and segment sums: no Pallas kernel, fused
    # loops of the JAX package's compiled program (its segment sums are a
    # one-hot contraction; the port's plain version a doubling scan).
    "faces_plane_fit": dict(
        name="faces_plane_fit",
        route="cuda",
        source="fccf_pcr_torch/csrc/faces.cu",
        replaces="fccf_pcr_tpu/ops/eigen3.py:72",
        also_replaces=["fccf_pcr_tpu/features/faces.py:261"],
    ),
    "faces_segment_sum": dict(
        name="faces_segment_sum",
        route="cuda",
        source="fccf_pcr_torch/csrc/faces.cu",
        replaces="fccf_pcr_tpu/features/faces.py:163",
        also_replaces=["fccf_pcr_tpu/features/faces.py:200"],
    ),
    # The hypotheses stage: no Pallas kernel, fused loops of the JAX
    # package's compiled program. H1 forms the bases with the matches on
    # the main path; the bases form alone is select_bases on a card.
    "hyp_matches": dict(
        name="hyp_matches",
        route="cuda",
        source="fccf_pcr_torch/csrc/hypotheses.cu",
        replaces="fccf_pcr_tpu/hypotheses/transforms.py:161",
        also_replaces=["fccf_pcr_tpu/hypotheses/bases.py:40"],
    ),
    "hyp_slots": dict(
        name="hyp_slots",
        route="cuda",
        source="fccf_pcr_torch/csrc/hypotheses.cu",
        replaces="fccf_pcr_tpu/hypotheses/transforms.py:78",
    ),
    "hyp_emit": dict(
        name="hyp_emit",
        route="cuda",
        source="fccf_pcr_torch/csrc/hypotheses.cu",
        replaces="fccf_pcr_tpu/hypotheses/transforms.py:217",
        also_replaces=["fccf_pcr_tpu/hypotheses/transforms.py:230"],
    ),
    "hyp_bases": dict(
        name="hyp_bases",
        route="cuda",
        source="fccf_pcr_torch/csrc/hypotheses.cu",
        replaces="fccf_pcr_tpu/hypotheses/bases.py:40",
    ),
    # Fine verify's per-candidate join: no Pallas kernel, the keys, join
    # sort, cummin and sum of the JAX package's compiled program.
    "fine_join": dict(
        name="fine_join",
        route="cuda",
        source="fccf_pcr_torch/csrc/fine.cu",
        replaces="fccf_pcr_tpu/verify/fine.py:193",
        also_replaces=["fccf_pcr_tpu/verify/fine.py:168",
                       "fccf_pcr_tpu/verify/fine.py:202",
                       "fccf_pcr_tpu/verify/fine.py:216"],
    ),
}
_BIG = 2**30
# K1 against plain: (V, per-pair bounds) of batch-2 comparisons, and the
# main path's pass-1 shapes it is timed at: (name, reps).
K1_CASES = ((1536, (1019, 97)), (1000, (1000, 61)), (9216, (8526, 100)))
# MEASURE_K1: heritage seed 0 through measure_content at its capacities
# (V = 16384, the largest V of any path).
MEASURE_K1 = "heritage-measure"
K1_TIMED = (("office", 20), ("heritage", 5), (MEASURE_K1, 3))
# The accuracy sweep's seeds a config (batch 8) and the overlap curve's
# seeds a (config, overlap) point.
EVAL_SEEDS = 16
OVERLAP_SEEDS = 8
# The escalation cell: the office preset on office scenes with 3 cm of
# sensor noise and 10000 points a plane. Their residual clouds (36-39k
# points, CPU measure_content, seeds 0-7) exceed the preset's 28672 and
# their fine voxels (2.4-2.8k) its 2048, both bounds that
# auto_escalation_caps doubles; down-sampled points (~58k), voxels
# (~1.0k) and raw points (104k) stay inside the bounds it keeps.
ESCALATING = dict(
    model="eth-office",
    scene=dict(points_per_plane=10000, clutter_points=4000, noise=0.03),
    pair=dict(),
)
# measure_content's counts and the Capacities field each must fit in.
CONTENT_CAPS = {
    "raw": "raw_points", "down": "max_points", "voxels": "max_voxels",
    "faces": "max_faces", "matches": "max_matches",
    "per_match_hits": "per_match_hits", "hypotheses": "max_hypotheses",
    "seeds": "max_clusters", "residual": "max_residual",
    "fine_voxels": "max_fine_voxels",
}
# P1 against plain: (P, V) label rows (after the TPU probe's own inputs).
P1_SHAPES = ((1, 1536), (1, 9216), (8, 9216))
# Peak rates of an H100 SXM at 700 W (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# float32 operations of K1's predicate for one pair (i, j)
# (csrc/label_prop.cu): the normal test (3 multiplies, 2 adds, a compare),
# and the plane test, which only a pair that passes the normal test needs
# (12 multiplies, 11 adds, fmaxf, sqrtf and the division counted as one
# each, 3 compares).
K1_NORMAL_OPS = 6
K1_PLANE_OPS = 29
# float32 operations C1 needs (csrc/cluster.cu): the ball predicate (the
# 3-term dot products, the squared distance, the clamp and two compares:
# 18) for a row of a lane against a column of that lane; the member sums'
# 10 adds for a column in the row's ball (their products are by a 0/1
# predicate, a select); the finiteness test of each of a hypothesis' 9
# [t, px, py] entries (a column outside the row's lane adds an exact 0,
# or a NaN where one of them is not finite).
C1_BALL_OPS = 18
C1_SUM_ADDS = 10
C1_FINITE_OPS = 9
# float32 operations of L1 (csrc/lm.cu), sqrtf, sinf, cosf, a clamp and a
# division counted as one each. Every LM step: a plane's trial residuals
# and squares (86), the cost's adds over the lane's 4F rows, and the
# lane's damping, 6 x 6 Cholesky solve, exponential map, quaternion
# product, normalization and update (315). At the start and at each
# accepted step: a plane's residuals and Jacobian at the pose (449) and
# the 27 products of its 4 rows (108), and the 27 folds' adds over the
# 4F rows (a rejected step leaves them as they were).
L1_TRIAL_OPS = 86
L1_ROWS_OPS = 557
L1_LANE_OPS = 315
# Operations of F1 a voxel (csrc/faces.cu), float64 ones counted twice, a
# conversion, cosf, atan2f, a clamp and a division as one each: 33 of
# eigen3's _fma (a float64 product and sum and four conversions: 8), 3 of
# its _sqrt (4) and 147 float32 ones (the scale, the divisions by it and
# by p, the phases, the 9 entries of A - lam I, the cross products'
# products, the choice of the best, the gates and the orientation).
F1_OPS = 33 * 8 + 3 * 4 + 147
# register.py's record_function ranges, the stages of the step, in order
# (the port's modules nest finer ranges inside them); a range also appears
# on the device timeline, as no kernel.
STAGES = ("downsample", "faces", "hypotheses", "cluster", "quick_verify",
          "select", "refine", "fine_verify", "fuse")
# The host's CUDA calls that launch work on the card.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")
# The graph counts read around a step (pipeline/register.py's STEP).
GRAPH_COUNTS = ("step_graph_captures", "step_graph_replays")
# torch.profiler captures taken again because CUPTI had dropped records
# (kernel_times), by the kernel name they were taken for.
RETAKEN = collections.Counter()


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (out.stdout.strip() or out.stderr.strip()).splitlines()[-1]


def clustered(rng, V, n_groups=6, prefix=None):
    import numpy as np

    gn = rng.normal(size=(n_groups, 3))
    gn /= np.linalg.norm(gn, axis=1, keepdims=True)
    gc = rng.uniform(-10, 10, (n_groups, 3))
    which = rng.integers(0, n_groups, V)
    normal = (gn[which] + rng.normal(0, 0.01, (V, 3))).astype(np.float32)
    offsets = rng.uniform(-4, 4, (V, 3)).astype(np.float32)
    offsets -= (offsets * gn[which]).sum(1, keepdims=True) * gn[which]
    centroid = (gc[which] + offsets).astype(np.float32)
    valid = np.arange(V) < (V if prefix is None else prefix)
    valid &= rng.uniform(size=V) < 0.9
    return normal, centroid, valid


def cuda_ms(fn, reps, reset=None):
    """Mean ms of one call of ``fn`` on the card's clock, host time of its
    launches included where the card waits on them: ``reps`` calls back
    to back between two CUDA events or, with ``reset`` (untimed, before
    each call), each call between two events of its own."""
    import torch

    if reset is not None:
        reset()
    fn()  # warm up
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(1 if reset is None else reps)]
    for a, b in pairs:  # an event is created at its first record: not timed
        a.record()
        b.record()
    if reset is None:
        ((a, b),) = pairs
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    for a, b in pairs:
        reset()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def phase_build(modules):
    """Build every kernel from its source, one nvcc each, all at once."""
    def build(mod):
        t0 = time.perf_counter()
        mod.build(force=True)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(modules)) as ex:
        return list(ex.map(build, modules))


def ptxas_summary(mod, kernel=""):
    """ptxas's lines for a source's build, of the kernels whose mangled
    name holds ``kernel``: registers, shared memory, spills."""
    lines, name = [], ""
    for ln in mod._LIBRARY.build_log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif kernel in name and ("Used" in ln or "spill" in ln):
            lines.append(ln.split("ptxas info    : ")[-1].strip())
    return " | ".join(lines)


def edge_cases(rng):
    """K1's edge cases: (name, normal, centroid, valid, bounds) with
    (P, V, 3) / (P, V) numpy arrays and one bound a pair."""
    import numpy as np

    def one(V, prefix=None):
        return clustered(rng, V, prefix=prefix)

    def stack(clouds):
        return [np.stack([c[k] for c in clouds]) for k in range(3)]

    cases = []
    n, c, v = stack([one(700, 0), one(700, 1)])
    v[1, 0] = True  # the one slot below bound 1
    cases.append(("bounds 0 and 1", n, c, v, (0, 1)))
    n, c, v = stack([one(700)])
    cases.append(("no valid row", n, c, np.zeros_like(v), (700,)))
    # one plane through every voxel: every pair affine (the most atomics)
    V = 1536
    n = np.tile(np.float32([0, 0, 1]), (1, V, 1))
    c = np.concatenate([rng.uniform(-2, 2, (1, V, 2)),
                        np.zeros((1, V, 1))], axis=2).astype(np.float32)
    cases.append(("one component", n, c, np.ones((1, V), bool), (V,)))
    # parallel planes 10 apart: no pair affine
    c = np.zeros((1, V, 3), np.float32)
    c[0, :, 2] = 10.0 * np.arange(V)
    cases.append(("only isolated voxels", n, c, np.ones((1, V), bool), (V,)))
    for V in (40, 20):
        n, c, v = stack([one(V)])
        cases.append((f"V={V} under one tile", n, c, v, (V,)))
    n, c, v = stack([one(700, 700), one(700, 40), one(700, 1)])
    cases.append(("P=3 mixed bounds", n, c, v, (700, 40, 1)))
    n, c, v = stack([ring(2), one(700, 700), ring(0)])
    cases.append(("P=3 converging at different sweeps", n, c, v,
                  (700, 700, 700)))
    return cases


def ring(seed, V=700, n=120):
    """n voxels on a circle of radius 10 at 3 deg steps, normals radial,
    slots shuffled, ~5% invalid, in the first n of V slots: only
    neighbours on the circle are affine (6 deg fails the 5 deg gate), so
    components are long chains that take 12-14 sweeps to settle (seeds 2
    and 0; a numpy model of the kernel's schedule, Jacobi sweeps), where
    a clustered pair takes 2-3."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = np.deg2rad(3.0 * np.arange(n))
    normal = np.zeros((V, 3), np.float32)
    normal[:n] = np.stack([np.cos(a), np.sin(a), np.zeros(n)], 1)[
        rng.permutation(n)]
    valid = np.zeros(V, bool)
    valid[:n] = rng.uniform(size=n) < 0.95
    return normal, 10.0 * normal, valid


def k1_against_plain(lp, dev, normal, centroid, valid, bounds, what,
                     angle=5.0, l=0.5, k=5.0):
    """label_propagate (the propagation kernel, one launch) and the
    per-sweep host loop (one-sweep kernel + gather kernel) against the
    plain version: labels must be equal. Returns the kernel's labels and
    the largest error of each route."""
    import torch

    normal, centroid, valid = (
        torch.as_tensor(a).to(dev) for a in (normal, centroid, valid))
    bound = torch.tensor(bounds, dtype=torch.int32, device=dev)
    want = lp.label_propagate_plain(normal, centroid, valid, angle, l, k)
    routes = {
        "propagate": ("PROPAGATIONS", lambda: lp.label_propagate(
            normal, centroid, valid, angle, l, k, bound=bound)),
        "host loop": ("LAUNCHES", lambda: lp._label_propagate_host_loop(
            normal, centroid, valid, angle, l, k, bound, 32)),
    }
    got, errs = {}, {}
    for route, (counter, fn) in routes.items():
        before = getattr(lp, counter)
        got[route] = fn()
        torch.cuda.synchronize()
        check(getattr(lp, counter) > before,
              f"{what}: the {route} kernel was not launched")
        errs[route] = int((got[route].long() - want.long()).abs().max())
        check(errs[route] == 0, f"{what}: {route} labels differ from plain "
              f"(max {errs[route]})")
    return got["propagate"], errs


def main_path_k1_inputs(name, dev):
    """The first label propagation of a path: pass 1 of seed 0's target
    cloud through the batched main path's eager step at the ``name``
    preset, or, for
    MEASURE_K1, through measure_content.measure_pair of heritage seed 0 at
    the measurement capacities (V = 16384): (normal, centroid, valid) with
    a pair axis of 1, angle, l, k and the (1,) int32 bound."""
    import torch

    from fccf_pcr_torch.evaluation import configs, measure_content
    from fccf_pcr_torch.features import faces
    from fccf_pcr_torch.models.fccf import get_model

    if name == MEASURE_K1:
        def drive():
            measure("heritage", 0, measure_content.measurement_caps(), dev)
    else:
        # The eager step: a replay of the step graph runs no Python, so
        # the hook would see nothing.
        model = get_model(configs.CONFIGS[name]["model"])
        args, _ = config_batch(name, [0], model.params, model.caps, dev)

        def drive():
            eager_step(model.params, model.caps)(*args)
    calls = []
    propagate = faces.label_propagate

    def record(*a, **kw):
        calls.append((a, kw))
        return propagate(*a, **kw)

    faces.label_propagate = record
    try:
        drive()
    finally:
        faces.label_propagate = propagate
    # The first call is pass 1 of the stacked clouds, targets first.
    (normal, centroid, valid, angle, l, k), kw = calls[0]
    bound = torch.as_tensor(kw["bound"], device=dev).reshape(-1)[:1]
    return (normal[:1], centroid[:1], valid[:1], angle, l, k,
            bound.to(torch.int32))


def measure(name, seed, caps, device):
    """measure_content.measure_pair of one seed of configs.CONFIGS[name]
    at its preset's params and the capacities ``caps``."""
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.evaluation.measure_content import measure_pair
    from fccf_pcr_torch.models.fccf import get_model

    src, tar, _ = scene(name, seed)
    params = get_model(configs.CONFIGS[name]["model"]).params
    return measure_pair(src, tar, params, caps, device=device)


def eager_step(params, caps):
    """The eager form of the batched step (``_register_batch``, which
    make_register_fn runs on the CPU): no step graph is captured or
    replayed, so a hook put into a module the step looks names up in
    sees every call."""
    from fccf_pcr_torch.pipeline.register import _register_batch, set_precision

    def step(*args):
        set_precision()
        return _register_batch(*args, params, caps)

    return step


def cluster_inputs(name, seeds, dev):
    """C1's block-scan inputs (masks, t, px, py, params) and C2's
    (s_size, cluster_num), cloned, as the eager batched step of
    configs.CONFIGS[name]'s ``seeds`` gives them to the kernels; and the
    preset's capacities."""
    import torch

    from fccf_pcr_torch.cluster import cluster as cl
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(configs.CONFIGS[name]["model"])
    args, _ = config_batch(name, seeds, model.params, model.caps, dev)
    calls = {"block_scan": [], "floor_walk": []}
    kept = {k: getattr(cl, k) for k in calls}

    def recorder(k):
        def record(*a):
            calls[k].append(tuple(x.clone() if torch.is_tensor(x) else x
                                  for x in a))
            return kept[k](*a)
        return record

    for k in calls:
        setattr(cl, k, recorder(k))
    try:
        eager_step(model.params, model.caps)(*args)
    finally:
        for k, fn in kept.items():
            setattr(cl, k, fn)
    return calls["block_scan"], calls["floor_walk"], model.caps


def walk_inputs(ck, scan_args):
    """The standalone block-seed walk's inputs (sub_lower, elig) of every
    block, cloned, as the plain block scan gives them on ``scan_args``."""
    seen = []
    kept = ck.block_seeds

    def record(sub, elig):
        seen.append((sub.clone(), elig.clone()))
        return kept(sub, elig)

    ck.block_seeds = record
    try:
        ck.block_scan_plain(*scan_args)
    finally:
        ck.block_seeds = kept
    return seen


def scan_pool(seed, P, H, kind, dev):
    """A batch of P hypothesis pools of capacity H for the block scan
    (tests/test_torch_cuda.py's _scan_pool): poses around a few centers,
    the valid prefix ending inside the last block. kind: "mixed", "one
    type", "empty lane", "chain" (runs of 8 on lines 0.75 apart: each
    covers the next only) or "nonfinite" (a NaN px entry in a valid slot,
    an inf t entry in an invalid one)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    masks = np.zeros((P, 3, H), bool)
    t = np.zeros((P, H, 3), np.float32)
    ang = np.zeros((P, H))
    for p in range(P):
        n = H - int(rng.integers(1, min(H, 300)))
        if kind == "chain":
            i = np.arange(n)
            t[p, :n] = np.stack([0.75 * (i % 8), 3.0 * ((i // 8) % 50),
                                 3.0 * (i // 400)], -1)
            typ = np.zeros(n, int)
        else:
            centers = rng.uniform(-6, 6, (max(2, n // 40), 3))
            pick = rng.integers(0, len(centers), n)
            t[p, :n] = centers[pick] + rng.normal(0, 0.4, (n, 3))
            ang[p, :n] = (rng.integers(0, 4, n) * 0.5
                          + rng.normal(0, 0.01, n))
            typ = rng.integers(0, 3 if kind != "empty lane" else 2, n)
            if kind == "one type":
                typ[:] = 0
        masks[p, typ, np.arange(n)] = True
    c, s = np.cos(ang), np.sin(ang)
    z = np.zeros_like(c)
    px = np.stack([c, s, z], -1).astype(np.float32)
    py = np.stack([-s, c, z], -1).astype(np.float32)
    if kind == "nonfinite":
        px[0, 3, 1] = np.nan
        t[P - 1, H - 1, 2] = np.inf
    return tuple(torch.from_numpy(x).to(dev) for x in (masks, t, px, py))


def scan_diff(got, want):
    """The outputs of two block scans (seeds, size, sums) that differ: a
    NaN equals a NaN."""
    import torch

    n = int((got[0] != want[0]).sum())
    for a, b in zip(got[1:], want[1:]):
        n += int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())
    return n


def c1_scan_bound(masks, size):
    """(bound ms, bound_by, operations) of one C1 launch on ``masks``
    (P, 3, H) whose member counts are ``size`` (P, 3, H): the member
    sums' operations this pool needs (each row of a lane against each
    column of that lane: C1_BALL_OPS; each (row, column) pair in a ball,
    the sum of the rows' sizes: C1_SUM_ADDS; each hypothesis' entries:
    C1_FINITE_OPS; the seeds' chain adds a predicate a candidate pair
    within a block and a seed's pair with a later column, fewer, not
    counted) against the bytes (masks, t, px and py read once; seeds,
    size and the 9 sums written once)."""
    P, _, H = masks.shape
    lane_pairs = int((masks.sum(dim=-1).double() ** 2).sum())
    in_ball = int(size.double().nansum())
    ops = (lane_pairs * C1_BALL_OPS + in_ball * C1_SUM_ADDS
           + P * H * C1_FINITE_OPS)
    ops_s = ops / PEAK_F32
    bytes_s = P * H * (3 + 36 + 3 + 4 * 3 + 4 * 27) / PEAK_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes", ops)


def c1_library(ck, masks, t, px, py, params):
    """The JAX package's formulation of the member sums as one library
    call a block: torch.matmul(geo_f, stats_cols) for each block of 512
    rows (fccf_pcr_tpu/cluster/cluster.py:173), geo_f and stats_cols made
    beforehand. Returns the function that runs those calls."""
    import torch

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the library call would round as no path does")
    H = masks.shape[-1]
    B = min(512, H)
    lead = tuple(masks.shape[:-2])
    stats10 = torch.cat([t, px, py, torch.ones(lead + (H, 1), device=t.device)],
                        dim=-1)
    cols = (stats10[..., None, :, :] * masks[..., None].float()
            ).transpose(-3, -2).reshape(lead + (H, 30)).contiguous()
    geos = [ck.ball_rows(t[..., i:i + B, :], px[..., i:i + B, :], t, px,
                         params).float().contiguous()
            for i in range(0, H, B)]
    return lambda: [torch.matmul(g, cols) for g in geos]


def cluster_edge_cases(dev):
    """C1's and C2's edge cases: (what, inputs) each."""
    import numpy as np
    import torch

    B = 512
    rng = np.random.default_rng(512)
    tri = torch.ones((B, B), dtype=torch.bool, device=dev).triu(1)
    ones = torch.ones((3, B), dtype=torch.bool, device=dev)
    chain = torch.zeros((3, B, B), dtype=torch.bool, device=dev)
    ar = torch.arange(B - 1, device=dev)
    chain[:, ar, ar + 1] = True
    ball = torch.zeros_like(chain)
    ball[:, 0, 1:] = True
    rand = torch.from_numpy(rng.uniform(size=(3, B, B)) < 0.05).to(dev) & tri
    seeds = [
        ("empty mask", (torch.zeros_like(chain), ones)),
        ("all eligible, random balls", (rand, ones)),
        ("chain", (chain, ones)),
        ("one ball", (ball, ones)),
        ("full mask", (tri.expand(3, B, B).contiguous(), ones)),
        ("no row eligible", (rand, torch.zeros_like(ones))),
        ("B = 200", (rand[:, :200, :200].contiguous(), ones[:, :200])),
    ]
    W = 2048
    sizes = np.sort(rng.integers(1, 40, (8, W)), axis=-1)[:, ::-1]
    sizes = sizes.astype(np.float32).copy()
    cn = np.full(8, 20.0, np.float32)
    cn[0], cn[1] = 0.0, 1.0
    sizes[2] = 7.0
    cn[2] = 4000.0  # all equal, every slot emitted
    sizes[3, :8] = (9, 3, 3, 3, 2, 2, 1, 1)
    sizes[3, 8:] = 1.0
    cn[3] = 40.0  # the floor drops below 2
    sizes[4, W // 7:] = 0.0  # an empty tail
    sizes[5] = 0.0  # no seed
    walks = [("cluster_num 0, 1, large; all equal; floor below 2; empty "
              "tail; no seed", (sizes, cn)),
             ("one slot", (sizes[:, :1].copy(), cn))]
    # C2's rounds of 32 slots: each stop in the last slot of a round, ties
    # at the floor, widths that are no multiple of 32, 8192 slots,
    # sizes that are no integers, a first floor of 2^24 and more
    f32 = np.float32
    edge = np.full((6, 96), 1, f32)
    edge[0, :32] = 7   # the 32nd emit is over a budget of 31: slot 31
    edge[1, :31] = 2   # slot 31 lowers the floor from 2 to 1
    edge[2, :63] = 7   # slot 63 emits nothing at 63 >= half of 100
    edge[3] = 5
    edge[3, 40:] = 4   # ties at the floor, and at the floor lowered
    edge[4, :] = np.nan
    edge[4, 0] = 4     # no seed after slot 0
    edge[5, :] = 3e7   # a first floor above 2^24
    walks += [
        ("a stop in the last slot of a round, ties, NaN sizes, a floor "
         "above 2^24", (edge, f32([31, 100, 100, 1000, 10, 50]))),
        ("W = 1000", (np.sort(rng.integers(0, 30, (6, 1000)), axis=-1)
                      [:, ::-1].astype(f32), f32([0, 1, 20, 60, 500, 2000]))),
        ("W = 8192", (np.sort(rng.integers(0, 9, (24, 8192)), axis=-1)
                      [:, ::-1].astype(f32), np.full(24, 4000, f32))),
        ("sizes that are no integers", (np.sort(rng.uniform(
            0, 30, (9, 500)), axis=-1)[:, ::-1].astype(f32),
            rng.uniform(0, 80, 9).astype(f32))),
    ]
    walks = [(w, (torch.from_numpy(np.ascontiguousarray(a)).to(dev),
                  torch.from_numpy(np.ascontiguousarray(c)).to(dev)))
             for w, (a, c) in walks]
    return seeds, walks


def c1_bound(sub_lower, elig, seeds):
    """(bound ms, bound_by) of one C1 launch: the bytes its data needs
    (elig read and the seeds written once, and only the row of each seed:
    no other row changes the result) against its operations (a 16-bit OR
    a row chunk of each seed), which are far fewer."""
    B = elig.shape[-1]
    n_seeds = int(seeds.sum())
    bytes_s = (2 * elig.numel() + n_seeds * B) / PEAK_BYTES
    ops_s = n_seeds * -(-B // 16) / PEAK_F32
    return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else \
        "operations"


def c2_bound(s_size, cluster_num):
    """(bound ms, bound_by, slots walked by each lane) of one C2 launch:
    each slot a lane walks before it stops read once, the budgets read
    and the mask written once; a few comparisons a slot."""
    from fccf_pcr_torch.ops import cluster_kernels as ck

    W = s_size.shape[-1]
    rows = s_size.reshape(-1, W).cpu().tolist()
    walked = [ck._walk_lane(r, c)[1] for r, c in zip(
        rows, cluster_num.reshape(-1).cpu().tolist())]
    bytes_s = (4 * sum(walked) + 4 * len(rows) + s_size.numel()) / PEAK_BYTES
    ops_s = 6 * sum(walked) / PEAK_F32
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", walked)


def phase_cluster_vs_plain(ck, dev):
    """C1 (the block scan) against its plain version on the card: the
    hypotheses of the eager step at seed 0 of the office, heritage and
    structured presets and of their batch-8 steps, and synthetic pools;
    seeds, sizes and member sums equal (a NaN equals a NaN). Its device
    time at the batch-8 steps' hypotheses beside the plain loop's (the
    sum of its kernels' device times), the library call's and the bound.
    The standalone block-seed walk and C2 against their plain versions:
    the walk's inputs of every block of those steps' plain scans, C2's of
    those steps, and the edge cases; their times at the heritage batch-8
    step's inputs beside the plain versions' (CUDA events: they wait for
    the host) and the bounds. Returns the most outputs that differ in a
    case, by kernel, and the times."""
    import torch

    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.evaluation import configs

    errs = {"scan": [0], "seeds": [0], "walk": [0]}

    def compare(kind, what, a):
        counter, kernel, plain = {
            "scan": ("SCANS", ck.block_scan, ck.block_scan_plain),
            "seeds": ("SEEDS", ck.block_seeds, ck.block_seeds_plain),
            "walk": ("WALKS", ck.floor_walk, ck.floor_walk_plain)}[kind]
        before = getattr(ck, counter)
        got = kernel(*a)
        torch.cuda.synchronize()
        check(getattr(ck, counter) == before + 1,
              f"{what}: the {kind} kernel was not launched")
        want = plain(*a)
        err = (scan_diff(got, want) if kind == "scan"
               else int((got != want).sum()))
        errs[kind].append(err)
        check(err == 0, f"{what}: {err} outputs of the {kind} kernel differ "
              "from plain")
        return got

    timed = {}
    for name, seeds in (("office", [0]), ("heritage", [0]),
                        ("structured", [0]), ("office", list(range(8))),
                        ("heritage", list(range(8))),
                        ("structured", list(range(8)))):
        scans, walks, caps = cluster_inputs(name, seeds, dev)
        check(len(scans) == 1 and len(walks) == 1,
              f"{name}: {len(scans)} block-scan and {len(walks)} floor-walk "
              "calls a step (want 1 and 1)")
        what = f"{name} seeds {seeds[0]}-{seeds[-1]}"
        got = compare("scan", what, scans[0])
        masks = scans[0][0]
        print(f"[cluster] C1 block scan equal to plain: {what} "
              f"{tuple(masks.shape)}, {int(masks.sum())} hypotheses, "
              f"{int(got[0].sum())} seeds, NaN sums "
              f"{int(torch.isnan(got[2]).sum())}", flush=True)
        compare("walk", f"{what} walk", walks[0])
        if len(seeds) == 8:
            timed[name] = scans[0]
        if name == "heritage" and len(seeds) == 8:
            blocks = walk_inputs(ck, scans[0])
            walk = walks[0]
            for k, a in enumerate(blocks):
                compare("seeds", f"{what} block {k}", a)
    params = get_model(configs.CONFIGS["office"]["model"]).params
    for H, P in ((512, 1), (2048, 8), (8192, 8)):
        for kind in ("mixed", "one type", "empty lane", "chain",
                     "nonfinite"):
            got = compare("scan", f"{kind} pool {P} x {H}",
                          scan_pool(H + P, P, H, kind, dev) + (params,))
            print(f"[cluster] C1 block scan equal to plain: {kind} pool, "
                  f"{P} x {H}, {int(got[0].sum())} seeds", flush=True)
    seeds_edge, walks_edge = cluster_edge_cases(dev)
    for w, a in seeds_edge:
        compare("seeds", w, a)
    for w, a in walks_edge:
        compare("walk", w, a)
    print(f"[cluster] the standalone block-seed walk and C2 equal to plain "
          f"on {len(errs['seeds']) - 1} and {len(errs['walk']) - 1} cases",
          flush=True)

    t = {"scan": {}}
    for name, a in timed.items():
        masks = a[0]
        seeds, size, _ = ck.block_scan(*a)
        b_ms, b_by, ops = c1_scan_bound(masks, size)
        plain = lambda: ck.block_scan_plain(*a)  # noqa: E731
        plain()
        library = c1_library(ck, *a)
        library()
        torch.cuda.synchronize()
        t["scan"][name] = dict(
            shape=tuple(masks.shape), rows=int(masks.any(dim=1).sum()),
            seeds=int(seeds.sum()),
            lane_pairs=int((masks.sum(dim=-1).double() ** 2).sum()),
            in_ball=int(size.double().nansum()),
            ms=device_ms(lambda: ck.block_scan(*a), 10,
                         only="cluster_block_scan_kernel",
                         launched=lambda: ck.SCANS),
            # the most of three whole captures (CUPTI drops records and
            # never adds one)
            plain_ms=max(sum(capture(plain)) for _ in range(3)),
            library_ms=max(sum(capture(library)) for _ in range(3)),
            library_calls=masks.shape[-1] // 512,
            bound_ms=b_ms, bound_by=b_by, ops=ops)
    t["blocks"] = []
    for sub, elig in blocks:
        seeds = ck.block_seeds(sub, elig)
        b_ms, b_by = c1_bound(sub, elig, seeds)
        t["blocks"].append(dict(
            seeds=int(seeds.sum()), eligible=int(elig.sum()),
            ms=device_ms(lambda: ck.block_seeds(sub, elig), 10,
                         only="cluster_block_seeds_kernel",
                         launched=lambda: ck.SEEDS),
            plain_ms=cuda_ms(lambda: ck.block_seeds_plain(sub, elig), 3),
            bound_ms=b_ms, bound_by=b_by))
    t["shape"] = tuple(blocks[0][0].shape)
    for k in ("ms", "plain_ms", "bound_ms"):
        t[k] = sum(b[k] for b in t["blocks"]) / len(t["blocks"])
    t["bound_by"] = t["blocks"][0]["bound_by"]
    w_ms, w_by, walked = c2_bound(*walk)
    t["walk"] = dict(
        shape=tuple(walk[0].shape), walked=sum(walked),
        most_walked=max(walked), lanes=len(walked),
        emitted=int(ck.floor_walk(*walk).sum()),
        ms=device_ms(lambda: ck.floor_walk(*walk), 10,
                     only="cluster_floor_walk_kernel",
                     launched=lambda: ck.WALKS),
        plain_ms=cuda_ms(lambda: ck.floor_walk_plain(*walk), 3),
        bound_ms=w_ms, bound_by=w_by)
    return {k: max(v) for k, v in errs.items()}, t


def cluster_stage_ms(name, dev):
    """The cluster stage (cluster_hypotheses) on the hypotheses of the
    eager batch-8 step of configs.CONFIGS[name], three ways: with the
    plain block loop (block_scan_plain over all H // 512 blocks, as the
    card ran the stage before C1 was the block scan), with C1, and with
    C1 captured as a graph of its own, as inside the step graph. Every
    output equal; each form's device time (the sum of the device times of
    its kernels and copies, the most of three CUPTI captures: CUPTI drops
    records and never adds one)."""
    import torch

    from fccf_pcr_torch.cluster import cluster as cl
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.hypotheses.transforms import Hypotheses
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.ops import cluster_kernels as ck
    from fccf_pcr_torch.ops import graph
    from fccf_pcr_torch.pipeline import register

    model = get_model(configs.CONFIGS[name]["model"])
    args, _ = config_batch(name, list(range(8)), model.params, model.caps,
                           dev)
    seen = []
    kept = register.cluster_hypotheses

    def record(hyp, params, caps):
        seen.append(tuple(f.clone() for f in hyp))
        return kept(hyp, params, caps)

    register.cluster_hypotheses = record
    try:
        eager_step(model.params, model.caps)(*args)
    finally:
        register.cluster_hypotheses = kept
    check(len(seen) == 1, f"{name}: {len(seen)} cluster stages in a step")
    hyp = seen[0]

    def stage(*fields):
        return cl.cluster_hypotheses(Hypotheses(*fields), model.params,
                                     model.caps)

    def plain():
        cl.block_scan = ck.block_scan_plain
        try:
            return stage(*hyp)
        finally:
            cl.block_scan = ck.block_scan

    graphs = graph.Graphs(max_graphs=1)
    forms = {"plain": plain, "kernel": lambda: stage(*hyp),
             "graph": lambda: graphs.replay(stage, hyp)}
    outs = {form: call() for form, call in forms.items()}
    torch.cuda.synchronize()
    for form in ("kernel", "graph"):
        for f, a, b in zip(outs["plain"]._fields, outs["plain"], outs[form]):
            check(torch.equal(a, b), f"{name}: the cluster stage's {f} "
                  f"differs between the plain loop and the {form} form")
    out = {form: max(sum(capture(call)) for _ in range(3))
           for form, call in forms.items()}
    graphs.clear()
    out["blocks"] = model.caps.max_hypotheses // 512
    return out


def capture(fn, only="", reset=None):
    """Device ms of each record whose name holds ``only`` in one
    torch.profiler (CUPTI) capture of one call of ``fn``, after ``reset``
    (untimed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if reset is not None:
        reset()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [record_ms(e) for e in device_records(prof) if only in e.name()]


def device_records(prof):
    """The device records of a torch.profiler capture (its raw kineto
    records): kernels, copies and fills, without the device-side mirrors
    of the port's record_function ranges, which are no work of their
    own."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges = {e.name() for e in events
              if e.device_type() != cuda and e.is_user_annotation()}
    return [e for e in events if e.device_type() == cuda
            and not e.is_user_annotation() and e.name() not in ranges]


def record_ms(e):
    """A raw kineto record's duration in ms."""
    return (e.end_ns() - e.start_ns()) / 1e6


def record_count(fn, only="", reset=None, n=3, tries=10):
    """The records named ``only`` that a whole capture of one call of
    ``fn`` holds: the most of ``n`` captures (CUPTI drops records and
    never adds one), and of up to ``tries`` while every capture is
    empty."""
    counts = []
    while len(counts) < n or (not max(counts) and len(counts) < tries):
        counts.append(len(capture(fn, only, reset)))
    check(max(counts) > 0, f"torch.profiler captured no record named "
          f"{only!r} in {len(counts)} captures")
    return max(counts)


def kernel_times(fn, only="", reset=None, launched=None, records=None,
                 tries=10):
    """Device ms of each kernel whose name holds ``only`` that one call
    of ``fn`` launches (``capture``). The capture must hold exactly as
    many records as the call launched: the growth of ``launched()`` (a
    launch count of the port's) over the call, or else ``records``
    (``record_count``). CUPTI can drop records (in chip runs, one capture
    of the host loop held none of its sweep kernels, and three captures of
    a gather in a row held no kernel at all): a capture with another count
    is taken again after a pause that grows with each try, up to ``tries``
    times, and then the phase fails. A capture that holds more than
    ``records`` is taken as it is: a capture never holds a record the call
    did not make, so the captures ``records`` was counted from had lost
    some (a chip run counted 43 of a plain sweep's 46 in each of its first
    three captures). RETAKEN counts the captures taken again."""
    got = []
    for attempt in range(tries):
        if attempt:
            RETAKEN[only] += 1
            time.sleep(0.05 * attempt)
        before = launched() if launched else 0
        times = capture(fn, only, reset)
        want = launched() - before if launched else records
        check(want > 0, f"the call launched no kernel named {only!r}")
        if len(times) == want or (not launched and len(times) > want):
            return times
        got.append(len(times))
    raise SmokeFailure(f"torch.profiler captured {got} records named "
                       f"{only!r} in {tries} captures of a call that "
                       f"launched {want}")


def device_ms(fn, reps, reset=None, only="", launched=None):
    """Mean device time of one call of ``fn`` in ms: the sum of the
    durations of the kernels it launches (those whose name holds
    ``only``), so host time between launches does not count; ``reset``
    (before each call) is left out. Each capture holds every record of
    the call (``kernel_times``): as many as ``launched`` grew by, or as a
    whole capture holds."""
    import torch

    if reset is not None:
        reset()
    fn()  # warm up
    torch.cuda.synchronize()
    records = None if launched else record_count(fn, only, reset)
    total = 0.0
    for _ in range(reps):
        times = kernel_times(fn, only, reset, launched, records)
        records = records and max(records, len(times))
        total += sum(times)
    return total / reps


def wall_ms(fn, reps):
    """Mean and least wall time of one call of ``fn`` in ms, host clock,
    from an idle card to the end of its work (a synchronize on each
    side)."""
    import torch

    fn()  # warm up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sum(times) / reps, min(times)


def sweep_device_times(fn, launched=None):
    """Device ms of each one-sweep kernel launch of one call of ``fn``
    (``kernel_times``: as many as ``launched`` grew by, or as a whole
    capture holds)."""
    only = "label_prop_sweep_kernel"
    return kernel_times(fn, only, launched=launched, records=(
        None if launched else record_count(fn, only)))


def propagate_once(lp, stats, bound, init, cos_gate, l, k, max_iters):
    """One launch of the propagation kernel from ``init``: (labels,
    sweeps run)."""
    import torch

    labels = init.clone()
    flags = torch.zeros((max_iters, labels.shape[0] + 1), dtype=torch.int32,
                        device=labels.device)
    sweeps = torch.zeros((1,), dtype=torch.int64, device=labels.device)
    lp._launch_propagate(stats, bound, labels, flags, sweeps, cos_gate, l, k,
                         max_iters)
    torch.cuda.synchronize()
    return labels, int(sweeps)


def plain_sweep(lp, normal, centroid, valid, angle, l, k, labels):
    """One Jacobi sweep of the plain version: the affinity matrix, then
    each row's minimum over its affine labels."""
    import torch

    aff = lp.pairwise_affinity(normal, centroid, valid, angle, l, k)
    neigh = torch.amin(torch.where(aff, labels[..., None, :], _BIG), dim=-1)
    return torch.minimum(labels, neigh)


def k1_bound(stats, labels, nb, cos_gate):
    """The least time of one sweep from ``labels`` (V,) over the packed
    stats (12, V): the float32 operations the sweep's pairs need against
    the bytes (stats and bound read once, labels read and written once,
    the flag written). A pair needs the normal test when i is valid, both
    lie below the bound and j's label is below i's (the kernel skips every
    other pair exactly), and the plane test only when it also passes the
    normal test, evaluated in the kernel's expression order. Returns
    (bound ms, bound_by, operations, normal-test pairs, plane-test
    pairs)."""
    lab = labels[:nb]
    need = (lab[None, :] < lab[:, None]) & (lab[:, None] < _BIG)
    nh = stats[:3, :nb]
    cos = (nh[0][:, None] * nh[0][None, :] + nh[1][:, None] * nh[1][None, :]
           + nh[2][:, None] * nh[2][None, :])
    n_normal = int(need.sum())
    n_plane = int((need & (cos >= cos_gate)).sum())
    ops = n_normal * K1_NORMAL_OPS + n_plane * K1_PLANE_OPS
    ops_s = ops / PEAK_F32
    V = labels.shape[0]
    bytes_s = (12 * V * 4 + 4 + 2 * V * 4 + 4) / PEAK_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes",
            ops, n_normal, n_plane)


def step_k1(lp, dev, name="heritage"):
    """The propagation launches of the eager batch-8 step of
    configs.CONFIGS[name], on their own recorded inputs: each launch's
    device time (from its initial labels, reset before each run), sweeps,
    labels equal to the plain version's (pair by pair), and bound: the
    operations each sweep's pairs need (k1_bound, from the labels that
    sweep starts from, a launch capped at s sweeps) of every pair summed
    over the launch's sweeps, against its bytes (stats and bounds read
    once, labels read and written once, the flags)."""
    import torch

    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(configs.CONFIGS[name]["model"])
    args, _ = config_batch(name, list(range(8)), model.params, model.caps,
                           dev)
    seen = []
    kept = lp._label_propagate_fused

    def record(*a):
        seen.append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return kept(*a)

    lp._label_propagate_fused = record
    try:
        eager_step(model.params, model.caps)(*args)
    finally:
        lp._label_propagate_fused = kept
    out = []
    for normal, centroid, valid, angle, l, k, bound, max_iters in seen:
        stats, bound_t, init = lp._kernel_inputs(normal, centroid, valid,
                                                 bound)
        P, V = init.shape
        cos_gate = lp.cos_deg(angle)
        final, n = propagate_once(lp, stats, bound_t, init, cos_gate, l, k,
                                  max_iters)
        for p in range(P):
            want = lp.label_propagate_plain(normal[p:p + 1],
                                            centroid[p:p + 1],
                                            valid[p:p + 1], angle, l, k)
            check(torch.equal(final[p:p + 1], want),
                  f"{name} step launch {len(out)}: pair {p}'s labels differ "
                  "from plain")
        labels = init.clone()
        flags = torch.zeros((max_iters, P + 1), dtype=torch.int32,
                            device=dev)
        sweeps = torch.zeros((1,), dtype=torch.int64, device=dev)

        def reset():
            labels.copy_(init)
            flags.zero_()

        def launch():
            lp._launch_propagate(stats, bound_t, labels, flags, sweeps,
                                 cos_gate, l, k, max_iters)

        ms = device_ms(launch, 10, reset, "label_prop_propagate",
                       lambda: lp.PROPAGATIONS)
        nbs = [int(x) for x in bound_t.tolist()]
        ops = 0
        for s in range(n):
            start = init if s == 0 else propagate_once(
                lp, stats, bound_t, init, cos_gate, l, k, s)[0]
            ops += sum(k1_bound(stats[p], start[p], nbs[p], cos_gate)[2]
                       for p in range(P) if nbs[p] > 0)
        ops_s = ops / PEAK_F32
        bytes_s = (P * (12 * V * 4 + 4 + 2 * V * 4)
                   + 4 * max_iters * (P + 1)) / PEAK_BYTES
        out.append(dict(P=P, V=V, bounds=nbs, sweeps=n, ms=ms,
                        bound_ms=max(ops_s, bytes_s) * 1e3,
                        bound_by="operations" if ops_s >= bytes_s
                        else "bytes", ops=ops))
    return out


def phase_kernel_vs_plain(lp, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    errs = collections.defaultdict(list)

    def compare(*args, **kw):
        got, e = k1_against_plain(lp, dev, *args, **kw)
        for route, err in e.items():
            errs[route].append(err)
        return got

    for V, bounds in K1_CASES:
        stats = [clustered(rng, V, prefix=b) for b in bounds]
        got = compare(*(np.stack([s[k] for s in stats]) for k in range(3)),
                      bounds, f"V={V}")
        check(len(torch.unique(got[0][got[0] < _BIG])) >= 2,
              "no components formed")
    for what, normal, centroid, valid, bounds in edge_cases(rng):
        got = compare(normal, centroid, valid, bounds, what)
        comps = [len(torch.unique(g[g < _BIG])) for g in got]
        print(f"[kernel] propagation and host loop equal to plain: {what} "
              f"(V={valid.shape[1]}, bounds {bounds}, components {comps})",
              flush=True)

    # Times at the main path's own pass-1 inputs: one sweep from the
    # initial labels (reset before each) and its plain version; one
    # propagation through the kernel, through the per-sweep host loop
    # and through the plain version.
    times = {}
    for name, reps in K1_TIMED:
        normal, centroid, valid, angle, l, k, bound = main_path_k1_inputs(
            name, dev)
        V, nb = valid.shape[1], int(bound[0])
        compare(normal, centroid, valid, (nb,), f"{name} pass 1", angle, l, k)
        stats = lp._pack_stats(normal, centroid, valid)
        init = torch.where(valid, torch.arange(V, dtype=torch.int32,
                                               device=dev), _BIG).contiguous()
        labels = init.clone()
        changed = torch.zeros(1, dtype=torch.int32, device=dev)
        cos_gate = lp.cos_deg(angle)

        def sweep():
            lp._launch_sweep(stats, bound, labels, changed, cos_gate, l, k)

        def reset():
            labels.copy_(init)

        def fused():
            return lp.label_propagate(normal, centroid, valid, angle, l, k,
                                      bound=bound)

        def host_loop():
            return lp._label_propagate_host_loop(
                normal, centroid, valid, angle, l, k, bound, 32)

        t = dict(V=V, bound=nb)
        t["sweep_ms"] = device_ms(sweep, 10, reset, "label_prop_sweep_kernel",
                                  lambda: lp.LAUNCHES)
        t["sweep_call_ms"] = cuda_ms(sweep, 4 * reps, reset)
        t["plain_sweep_ms"] = device_ms(lambda: plain_sweep(
            lp, normal, centroid, valid, angle, l, k, init), 10)
        (t["bound_ms"], t["bound_by"], t["ops"], t["normal_pairs"],
         t["plane_pairs"]) = k1_bound(stats[0], init[0], nb, cos_gate)
        t["full_bound_ms"] = (nb * nb * (K1_NORMAL_OPS + K1_PLANE_OPS)
                              / PEAK_F32 * 1e3)
        # Propagation: kernel and host loop in turns (kernel, loop, loop,
        # kernel), wall and device time.
        for which in ("propagate", "host_loop", "host_loop", "propagate"):
            fn = fused if which == "propagate" else host_loop
            mean, least = wall_ms(fn, reps)
            t.setdefault(f"{which}_wall_ms", []).append(mean)
            t.setdefault(f"{which}_wall_min_ms", []).append(least)
        t["propagate_ms"] = device_ms(fused, 10, only="label_prop_propagate",
                                      launched=lambda: lp.PROPAGATIONS)
        t["host_loop_ms"] = device_ms(host_loop, 10)
        t["host_loop_sweeps_ms"] = sweep_device_times(
            host_loop, lambda: lp.LAUNCHES)
        t["plain_ms"] = device_ms(lambda: lp.label_propagate_plain(
            normal, centroid, valid, angle, l, k), 3)
        t["plain_wall_ms"] = wall_ms(lambda: lp.label_propagate_plain(
            normal, centroid, valid, angle, l, k), 3)[0]
        # The sweeps the kernel runs and the labels before each (a launch
        # capped at s sweeps): the propagation's bound counts each sweep's
        # operations from those labels, against its bytes (stats and
        # bound read once, labels read and written once, the flags).
        final, n = propagate_once(lp, stats, bound, init, cos_gate, l, k, 32)
        check(torch.equal(final, lp.label_propagate_plain(
            normal, centroid, valid, angle, l, k)), f"{name}: labels differ")
        t["sweeps"] = n
        sweep_bounds = [k1_bound(stats[0], propagate_once(
            lp, stats, bound, init, cos_gate, l, k, s)[0][0], nb, cos_gate)
            for s in range(n)]
        t["sweep_bounds_ms"] = [b[0] for b in sweep_bounds]
        t["halving_bound_ms"] = halving_bound(1, V)
        ops_s = sum(b[2] for b in sweep_bounds) / PEAK_F32
        flag_bytes = 32 * 2 * 4  # (max_iters, P + 1) int32
        bytes_s = (12 * V * 4 + 4 + 2 * V * 4 + flag_bytes) / PEAK_BYTES
        t["propagate_bound_ms"] = max(ops_s, bytes_s) * 1e3
        t["propagate_bound_by"] = "operations" if ops_s >= bytes_s else "bytes"
        # The sweep phase: the kernel's sweeps timed as the host loop's
        # one-sweep launches (their mean, times the kernel's count).
        host = t["host_loop_sweeps_ms"]
        sweep_phase_ms = sum(host) / len(host) * n
        t["sweep_share"] = sweep_phase_ms / t["propagate_ms"]
        t["outside_per_sweep_ms"] = (t["propagate_ms"] - sweep_phase_ms) / n
        times[name] = t
    return {route: max(e) for route, e in errs.items()}, times


def label_rows(rng, P, V):
    """Label rows as label-prop leaves them between sweeps: each valid
    slot points at or below itself, invalid slots hold 2^30."""
    import numpy as np

    rows = (np.arange(V) * rng.uniform(0, 1, (P, V))).astype(np.int32)
    rows[rng.uniform(size=(P, V)) < 0.1] = _BIG
    return rows


def phase_gather_vs_plain(gt, dev):
    import numpy as np
    import torch

    def on(a):
        return torch.from_numpy(a).to(dev)

    # The TPU probe's own inputs: tbl = arange(1024) * 7, random indices.
    tbl = (np.arange(1024, dtype=np.int32) * 7)[None]
    idx = np.random.default_rng(0).integers(0, 1024, 1024).astype(np.int32)[None]
    before = gt.LAUNCHES
    got = gt.gather_rows(on(tbl), on(idx)).cpu().numpy()
    check(gt.LAUNCHES == before + 1, "gather kernel was not launched")
    check(np.array_equal(got, tbl[:, idx[0]]), "gather differs from tbl[idx] "
          "at the probe's inputs")
    errs = [0]

    rng = np.random.default_rng(1)
    times = {}
    for P, V in P1_SHAPES:
        labels = on(label_rows(rng, P, V))
        wild = on(rng.integers(-5, V + 5, (P, V)).astype(np.int32))
        for a, b in ((labels, labels), (labels, wild)):
            got = gt.gather_rows(a, b)
            want = gt.gather_rows_plain(a, b)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            check(err == 0, f"({P}, {V}): gather differs from plain (max {err})")
            errs.append(err)
        # torch.gather alone, on indices already in range: the library
        # call that computes P1's function (the port never calls it here).
        idx = torch.clamp(labels, 0, V - 1).long()
        fns = dict(kernel=lambda: gt.gather_rows(labels, labels),
                   plain=lambda: gt.gather_rows_plain(labels, labels),
                   library=lambda: torch.gather(labels, -1, idx))
        times[(P, V)] = {
            **{f"{k}_call_ms": cuda_ms(fn, 200) for k, fn in fns.items()},
            "kernel_ms": device_ms(fns["kernel"], 10, only="gather_rows_kernel",
                                   launched=lambda: gt.LAUNCHES),
            **{f"{k}_ms": device_ms(fns[k], 10) for k in ("plain", "library")},
        }
    return max(errs), times


def p1_bound(P, V):
    """(bound ms, bound_by) of one gather over (P, V) int32 rows: the
    table and the indices read once, the output written once."""
    return 3 * P * V * 4 / PEAK_BYTES * 1e3, "bytes"


def halving_bound(P, V):
    """ms of one in-place halving round over (P, V) int32 labels: read
    once and written once (the table is the labels themselves)."""
    return 2 * P * V * 4 / PEAK_BYTES * 1e3


@functools.lru_cache(maxsize=None)
def scene(name, seed):
    """(src, tar, T_gt) of configs.CONFIGS[name] for one seed, as
    configs.pairs_for_config makes it (the evaluation's assignment)."""
    from fccf_pcr_torch.evaluation import configs

    return configs.pairs_for_config(configs.CONFIGS[name], [seed])[0]


def config_batch(name, seeds, params, caps, dev):
    import numpy as np
    import torch

    from fccf_pcr_torch import pre_downsample
    from fccf_pcr_torch.io import synthetic

    pts, gts = [], []
    for s in seeds:
        src, tar, T_gt = scene(name, s)
        pair = []
        for cloud in (src, tar):
            p, m = synthetic.pad_points(cloud, caps.raw_points)
            d, dm, ovf = pre_downsample(p, m, params, caps, device=dev)
            check(not bool(ovf), f"{name} seed {s}: pre_downsample overflow")
            pair.append((d, dm))
        pts.append(pair)
        gts.append(T_gt)
    args = (
        torch.stack([p[0][0] for p in pts]), torch.stack([p[0][1] for p in pts]),
        torch.stack([p[1][0] for p in pts]), torch.stack([p[1][1] for p in pts]),
    )
    return args, torch.from_numpy(np.stack(gts).astype(np.float64))


def rotation_gap(T, T_ref):
    """(deg, m) between two transforms: the rotation angle from
    |R - R_ref| (2 sqrt(2) sin(angle / 2) for rotations), exactly 0 for
    equal matrices, which the trace form is not for float32 matrices a
    few ulps from orthonormal; and the translations' distance."""
    import math

    import torch

    T, T_ref = (torch.as_tensor(x, dtype=torch.float64) for x in (T, T_ref))
    fro = float(torch.linalg.norm(T[:3, :3] - T_ref[:3, :3]))
    deg = math.degrees(2.0 * math.asin(min(1.0, fro / (2.0 * math.sqrt(2.0)))))
    return deg, float(torch.linalg.norm(T[:3, 3] - T_ref[:3, 3]))


def drift(T, T_ref):
    import torch

    from fccf_pcr_torch import registration_errors

    rre, rte = registration_errors(
        torch.as_tensor(T, dtype=torch.float64),
        torch.as_tensor(T_ref, dtype=torch.float64),
    )
    return float(rre), float(rte)


def zero_counts(counters, dev):
    """Every kernel's launch count, and the propagation kernel's sweeps,
    to 0."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    counters["label_prop_propagate"][0].sweep_counter(dev).zero_()


def read_counts(counters, dev):
    """Launch counts by kernel and the propagation kernel's sweeps, read
    after a synchronize."""
    counts = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    counts["sweeps"] = int(
        counters["label_prop_propagate"][0].sweep_counter(dev))
    return counts


def phase_path(name, counters, dev):
    """One config's golden seeds through the batched main path; returns
    each kernel's launch count in that run (counts reset just before) and
    the sweeps the propagation kernel ran, and the wall ms of a second,
    repeated step (which must give bitwise-equal transforms)."""
    import torch

    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch import make_register_fn
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.twin.families import TWIN_BANDS

    model = get_model(configs.CONFIGS[name]["model"])
    rows = json.loads(GOLDEN.read_text())["configs"][name]
    seeds = [r["seed"] for r in rows]
    args, T_gt = config_batch(name, seeds, model.params, model.caps, dev)
    fn = make_register_fn(model.params, model.caps, batched=True, device=dev)

    zero_counts(counters, dev)
    res = fn(*args)
    torch.cuda.synchronize()
    launches = read_counts(counters, dev)
    check(launches["label_prop_propagate"] > 0 and launches["sweeps"] > 0,
          f"the {name} path launched no propagation kernel")
    for k in ("label_prop_sweep", "gather_rows", "cluster_block_seeds",
              "hyp_bases"):
        check(launches[k] == 0, f"the {name} path launched the {k} kernel "
              f"{launches[k]} times (it runs inside the propagation kernel, "
              "the block scan or H1)")
    for k in ("cluster_block_scan", "cluster_floor_walk", "lm_refine",
              "scan_int", "prefix_sum16", "faces_plane_fit",
              "faces_segment_sum", "hyp_matches", "hyp_slots", "hyp_emit",
              "fine_join", "step_graph_replays"):
        check(launches[k] > 0, f"the {name} path made no {k}")

    T = res.transform
    check(T.shape == (len(seeds), 4, 4) and bool(torch.isfinite(T).all()),
          f"{name}: transforms not finite / wrong shape")
    T64 = T.double().cpu()
    gate = configs.GATES[name]
    for k, row in enumerate(rows):
        d_rre, d_rte = drift(T64[k], row["T"])
        g_rre, g_rte = drift(T64[k], T_gt[k])
        status = int(res.status[k])
        kept = res.kept[k].tolist()
        print(
            f"[{name}] seed {row['seed']}: golden drift {d_rre:.5f} deg "
            f"{d_rte:.5f} m | GT {g_rre:.4f} deg {g_rte:.4f} m "
            f"| status {status} (pinned {row['status']}) kept {kept} "
            f"(pinned {row['kept']}) | n_hyp {int(res.n_hypotheses[k])} "
            f"(pinned {row['n_hypotheses']}) n_faces {res.n_faces[k].tolist()} "
            f"(pinned {row['n_faces']}) | quick "
            f"{[round(x, 5) for x in res.quick_score[k].tolist()]} (pinned "
            f"{[round(x, 5) for x in row['quick_score']]}) fine "
            f"{[round(x, 5) for x in res.fine_score[k].tolist()]} (pinned "
            f"{[round(x, 5) for x in row['fine_score']]})",
            flush=True,
        )
        check(d_rre < 0.1 and d_rte < 0.02,
              f"{name} seed {row['seed']}: outside the golden band")
        check(status == row["status"], f"{name} seed {row['seed']}: status differs")
        check(kept == row["kept"], f"{name} seed {row['seed']}: kept mask differs")
        check(g_rre < gate[0] and g_rte < gate[1],
              f"{name} seed {row['seed']}: ground-truth gate failed")
    if name in TWIN_BANDS:
        check_twin_bands(name, seeds, T64)

    # Each pair alone (P = 1) against its batch row.
    single = make_register_fn(model.params, model.caps, device=dev)
    worst = [0.0, 0.0]
    for k, row in enumerate(rows):
        alone = single(*(a[k] for a in args))
        for f in ("status", "kept", "n_hypotheses", "n_faces"):
            check(torch.equal(getattr(alone, f), getattr(res, f)[k]),
                  f"{name} seed {row['seed']}: {f} of the pair alone "
                  "differs from its batch row")
        d = rotation_gap(alone.transform.double().cpu(), T64[k])
        worst = [max(w, x) for w, x in zip(worst, d)]
        check(d[0] <= 1e-3 and d[1] <= 1e-4,
              f"{name} seed {row['seed']}: the pair alone is {d[0]:.3g} deg "
              f"/ {d[1]:.3g} m from its batch row")
    print(f"[{name}] each pair alone (P = 1) matches its batch row: status, "
          f"kept, n_hypotheses and n_faces equal; largest transform "
          f"difference {worst[0]:.3g} deg / {worst[1]:.3g} m (limit 1e-3 deg "
          "/ 1e-4 m)", flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = fn(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(again.transform, res.transform),
          f"{name}: a repeated run gave different transforms")
    print(f"[{name}] {len(seeds)} pairs inside the golden bands; launches "
          f"{launches}; repeated run bitwise equal, its step "
          f"{step_ms:.1f} ms wall (batch {len(seeds)})", flush=True)
    return launches, step_ms


def check_twin_bands(name, seeds, T64):
    """The batch's transforms against the NumPy twin's cached ones of
    tests/golden/twin_production.json, within TWIN_BANDS[name]."""
    import numpy as np

    from fccf_pcr_torch.twin.families import TWIN_BANDS

    rows = {r["seed"]: r for r in json.loads(TWIN_PRODUCTION.read_text())[
        "rows"] if r["config"] == name}
    band = TWIN_BANDS[name]
    worst = [0.0, 0.0]
    for k, seed in enumerate(seeds):
        r = rows[seed]
        src, tar, _ = scene(name, seed)
        check((len(src), len(tar)) == (r["n_src"], r["n_tar"]),
              f"{name} seed {seed}: scene differs from the twin fixture's")
        d = drift(T64[k], np.reshape(r["T_twin"], (4, 4)))
        worst = [max(w, x) for w, x in zip(worst, d)]
        check(d[0] < band[0] and d[1] < band[1],
              f"{name} seed {seed}: {d[0]:.4f} deg / {d[1]:.5f} m from the "
              f"twin (band {band})")
    print(f"[{name}] seeds {seeds} within the twin-production band {band}: "
          f"worst {worst[0]:.4f} deg / {worst[1]:.5f} m", flush=True)


def phase_unequal(dev):
    """Office seed 0 with the target cut to its valid rows (another N than
    the source's): every field bitwise equal to the equal-N run."""
    import torch

    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch import make_register_fn
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(configs.CONFIGS["office"]["model"])
    (sp, sm, tp, tm), _ = config_batch("office", [0], model.params,
                                       model.caps, dev)
    n = int(tm[0].sum())
    check(bool(tm[0, :n].all()) and n < tm.shape[1],
          "office seed 0: the target's valid rows are not a proper prefix")
    fn = make_register_fn(model.params, model.caps, device=dev)
    equal = fn(sp[0], sm[0], tp[0], tm[0])
    cut = fn(sp[0], sm[0], tp[0, :n], tm[0, :n])
    for f, a, b in zip(equal._fields, equal, cut):
        check(torch.equal(a, b), f"unequal N: {f} differs from the equal-N run")
    print(f"[unequal] office seed 0, source {sp.shape[1]} rows, target cut "
          f"to its {n} valid rows: every field bitwise equal to the equal-N "
          "run", flush=True)


def phase_mesh(dev, counters):
    """The office batch of 8 split over make_mesh([dev] * k) for k = 2 and
    4 and over make_mesh() (every card): every field bitwise equal to the
    unsplit batch, and so for k = 2 from the raw clouds through
    sharded_pre_downsample (run_sweep's mesh path). Step wall times for
    k = 1, 2, 4 in turns (1, 2, 4, 4, 2, 1); sharded_mean_errors against
    ground truth."""
    import numpy as np
    import torch

    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch import make_register_fn, registration_errors
    from fccf_pcr_torch.io import synthetic
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.parallel.mesh import (
        make_mesh, make_sharded_register_fn, sharded_mean_errors,
        sharded_pre_downsample)

    model = get_model(configs.CONFIGS["office"]["model"])
    args, T_gt = config_batch("office", list(range(8)), model.params,
                              model.caps, dev)
    fns = {1: make_register_fn(model.params, model.caps, batched=True,
                               device=dev)}
    meshes = {k: make_mesh([dev] * k) for k in (2, 4)}
    for k, mesh in meshes.items():
        fns[k] = make_sharded_register_fn(model.params, model.caps, mesh)
    whole = fns[1](*args)
    torch.cuda.synchronize()
    every = make_mesh()
    runs = {**{k: (fns[k], f"[{dev}] * {k}") for k in (2, 4)},
            "all": (make_sharded_register_fn(model.params, model.caps, every),
                    f"make_mesh() = {[str(d) for d in every]}")}
    for k, (fn, what) in runs.items():
        fn(*args)  # captures the chunks' step graph
        zero_counts(counters, dev)
        split = fn(*args)
        torch.cuda.synchronize()
        counts = read_counts(counters, dev)
        props = counts["label_prop_propagate"]
        for f, a, b in zip(whole._fields, split, whole):
            check(torch.equal(a, b), f"mesh {what}: {f} differs from the "
                  "unsplit batch")
        n_chunks = len(every) if k == "all" else k
        check(props == 2 * n_chunks and counts["step_graph_captures"] == 0
              and counts["step_graph_replays"] == n_chunks,
              f"mesh {what}: {props} propagation launches (want 2 a chunk, "
              f"{2 * n_chunks}), step graph captures / replays {counts}")
        print(f"[mesh] office batch 8 split over {what}: every field bitwise "
              f"equal to the unsplit batch; {props} propagation launches, "
              f"{n_chunks} step graph replays", flush=True)
    # The raw clouds downsampled chunk by chunk, each on its own device,
    # and registered where they lie (run_sweep's mesh path).
    chunks = []
    for side in (0, 2):  # sources, then targets
        raw = [synthetic.pad_points(scene("office", s)[side // 2],
                                    model.caps.raw_points) for s in range(8)]
        pts, valid, ovf = sharded_pre_downsample(
            np.stack([r[0] for r in raw]), np.stack([r[1] for r in raw]),
            model.params, model.caps, meshes[2])
        check(not bool(ovf.any()), "mesh: sharded_pre_downsample overflow")
        for got, want in ((pts, args[side]), (valid, args[side + 1])):
            check(torch.equal(torch.cat(got), want), "mesh: a chunk of "
                  "sharded_pre_downsample differs from its clouds alone")
        chunks += [pts, valid]
    split = fns[2](*chunks)
    for f, a, b in zip(whole._fields, split, whole):
        check(torch.equal(a, b), f"mesh sharded_pre_downsample: {f} differs "
              "from the unsplit batch")
    print(f"[mesh] office raw clouds through sharded_pre_downsample over "
          f"[{dev}] * 2: every chunk equal to its clouds downsampled alone, "
          f"every field of the split batch bitwise equal to the unsplit "
          f"batch", flush=True)
    times = collections.defaultdict(list)
    for k in (1, 2, 4, 4, 2, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[k](*args)
        torch.cuda.synchronize()
        times[k].append((time.perf_counter() - t0) * 1e3)
    # sharded_mean_errors (float32, like the batch) against the same
    # errors of the whole batch on the card; float64 errors for reference.
    rre32, rte32 = registration_errors(whole.transform,
                                       T_gt.float().to(dev))
    rre, rte = registration_errors(whole.transform.double().cpu(), T_gt)
    errs = {k: sharded_mean_errors(whole.transform, T_gt, meshes[k])
            for k in (2, 4)}
    for k, (m_rre, m_rte) in errs.items():
        check(math.isclose(m_rre, float(rre32.mean()), rel_tol=1e-5)
              and math.isclose(m_rte, float(rte32.mean()), rel_tol=1e-5),
              f"mesh [{dev}] * {k}: sharded_mean_errors {m_rre}, {m_rte} "
              f"disagrees with the whole batch's {float(rre32.mean())}, "
              f"{float(rte32.mean())}")
    print(f"[mesh] torch.cuda.device_count() {torch.cuda.device_count()}; "
          f"office batch-8 step wall ms in turns (k = 1, 2, 4, 4, 2, 1): "
          f"k=1 {[round(x, 1) for x in times[1]]}, k=2 "
          f"{[round(x, 1) for x in times[2]]}, k=4 "
          f"{[round(x, 1) for x in times[4]]} (one card listed k times: "
          f"its chunks run in turn); sharded_mean_errors vs ground truth "
          f"{errs} (float32, as the batch; in float64 {float(rre.mean()):.5f} "
          f"deg {float(rte.mean()):.6f} m)", flush=True)


def phase_diff(lp):
    """twin/diff.py on the FAMILIES targets (seed 30, TEST_CAPS): the
    pipeline membership on the card equal to the CPU run's, the
    propagation kernel launched, and the diff's metrics inside
    tests/test_twin_sweep.py's limits. Returns the wall seconds of the
    card-side diffs."""
    import numpy as np

    from fccf_pcr_torch import TEST_CAPS, FCCFParams
    from fccf_pcr_torch.io import synthetic
    from fccf_pcr_torch.twin import diff
    from fccf_pcr_torch.twin.families import FAMILIES

    params = FCCFParams()
    wall = 0.0
    for fam, cfg in FAMILIES.items():
        _, tar, _ = synthetic.make_pair(seed=30, **cfg["scene"], **cfg["pair"])
        cloud = np.asarray(tar, np.float32)
        before = lp.PROPAGATIONS
        on_card = diff._pipeline_membership(cloud, params, TEST_CAPS,
                                            device="cuda")
        check(lp.PROPAGATIONS > before,
              f"diff {fam}: the propagation kernel was not launched")
        on_cpu = diff._pipeline_membership(cloud, params, TEST_CAPS,
                                           device="cpu")
        check(on_card == on_cpu, f"diff {fam}: the card's membership differs "
              "from the CPU's")
        t0 = time.perf_counter()
        res = diff.face_membership_diff(tar, params, TEST_CAPS, device="cuda")
        wall += time.perf_counter() - t0
        check(res["pair_agreement"] > 0.98 and res["matched_fraction"] > 0.95,
              f"diff {fam}: {res}")
        print(f"[diff] {fam} seed 30 target: card membership == CPU "
              f"membership ({len(on_card)} cells); {res}", flush=True)
    print(f"[diff] {len(FAMILIES)} face_membership_diff calls on the card: "
          f"{wall:.2f} s wall", flush=True)
    return wall


def run_cli(args, what, env=None):
    """``python -m fccf_pcr_torch ARGS`` from the repo root, with ``env``
    added to the environment: (stdout, stderr, wall s)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), **(env or {}))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fccf_pcr_torch", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"CLI {what} exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return proc.stdout, proc.stderr, time.perf_counter() - t0


def phase_cli():
    import numpy as np

    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.io import ply
    from fccf_pcr_torch.models.fccf import get_model

    row = json.loads(GOLDEN.read_text())["configs"]["heritage"][0]
    with tempfile.TemporaryDirectory() as tmp:
        src, tar, _ = scene("heritage", row["seed"])
        paths = [os.path.join(tmp, f"heritage_{k}.ply") for k in "st"]
        for path, cloud in zip(paths, (src, tar)):
            ply.write_ply(path, cloud)
        params = get_model("heritage").params
        out, _, dt = run_cli(
            [*paths, f"{params.leaf_size:g}", "--caps", "heritage",
             "--set", f"face_voxel_size={params.face_voxel_size:g}",
             "--device", "cuda", "--json"], "heritage pair")
        rec = json.loads(out.strip().splitlines()[-1])
        d_rre, d_rte = drift(rec["transform"], row["T"])
        print(f"[cli] heritage seed {row['seed']}: {dt:.1f} s, golden drift "
              f"{d_rre:.5f} deg {d_rte:.5f} m, status {rec['status']} "
              f"(pinned {row['status']}), n_hyp {rec['n_hypotheses']} (pinned "
              f"{row['n_hypotheses']})", flush=True)
        check(rec["device"] == "cuda", "CLI record not from the card")
        check(d_rre < 0.1 and d_rte < 0.02, "CLI heritage: outside the golden band")
        check(rec["status"] == row["status"], "CLI heritage: status differs")

        src, tar, T_gt = scene("resso", 0)
        paths = [os.path.join(tmp, f"resso_{k}.ply") for k in "st"]
        for path, cloud in zip(paths, (src, tar)):
            ply.write_ply(path, cloud)
        jsonl = os.path.join(tmp, "sweep.jsonl")
        out, _, dt = run_cli(["--batch", *paths, "--out", jsonl, "--caps", "auto",
                           "--device", "cuda"], "resso sweep")
        summary = json.loads(out.strip().splitlines()[-1])
        with open(jsonl) as f:
            lines = [json.loads(line) for line in f]
        check(summary.get("out") == jsonl and summary["summary"]["n_pairs"] == 1,
              f"CLI sweep: unexpected summary {summary}")
        check(len(lines) == 2 and lines[0].get("pair") == 0
              and lines[-1] == {"summary": summary["summary"]},
              "CLI sweep: records / summary missing from the JSONL")
        rec = lines[0]
        g_rre, g_rte = drift(rec["transform"], T_gt)
        gate = configs.GATES["resso"]
        print(f"[cli] resso seed 0 sweep (--caps auto): {dt:.1f} s, GT "
              f"{g_rre:.4f} deg {g_rte:.4f} m, status {rec['status']}, "
              f"escalated {rec.get('escalated', False)}, summary "
              f"{summary['summary']}", flush=True)
        check(np.isfinite(np.asarray(rec["transform"])).all(),
              "CLI sweep: transform not finite")
        check(g_rre < gate[0] and g_rte < gate[1], "CLI sweep: GT gate failed")


def count_syncs(fn, *args):
    """Host syncs in one call of ``fn``: the warnings that
    torch.cuda.set_sync_debug_mode("warn") raises, one per synchronizing
    call (a copy to or from the host, a tensor read as a Python value),
    counted by the source line that made the call."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message))


def launch_capture(fn):
    """One torch.profiler capture (CPU and CUDA activity) of ``fn()``:
    the host's launch calls by the name of the CUDA call (cudaLaunchKernel,
    cuLaunchKernel, cudaGraphLaunch, ...), the device kernels (CUDA
    records that are neither copies, fills nor the mirrors of the
    record_function ranges: ``device_records``) and the device copies and
    fills. Read from the raw kineto records (building the
    profiler's event tree of an eager step takes seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                and e.name().startswith(LAUNCH_CALLS)):
            host[e.name()] += 1
    records = device_records(prof)
    copies = sum(e.name().startswith(("Memcpy", "Memset")) for e in records)
    return host, len(records) - copies, copies


def count_launches(fn, *args, n=3, tries=10):
    """Launches of one call of ``fn``: host launch calls (by API) and
    device kernels, from the capture of ``n`` that holds the most device
    records (CUPTI drops records and never adds one), and of up to
    ``tries`` while every capture holds none."""
    caps = []
    while len(caps) < n or (not max(c[1] for c in caps)
                            and len(caps) < tries):
        caps.append(launch_capture(lambda: fn(*args)))
    best = max(caps, key=lambda c: c[1] + c[2])
    check(best[1] > 0, "torch.profiler captured no device kernel")
    return dict(host_launches=sum(best[0].values()),
                host_by_api=dict(best[0]), device_kernels=best[1],
                device_copies=best[2])


def phase_timing(name, dev, counters, batch=8, reps=2):
    """Steady-state step time at ``batch`` pairs, each kernel's launches
    per step, the propagation kernel's sweeps and the step graph's
    captures and replays per step (the counts of the timed steps
    over ``reps``), the peak device memory of those steps and the graphs'
    pools, and, in one more step each, the host syncs (which must be 0)
    and the host launches and device kernels (``count_launches``).
    Returns pairs/s, s/step, the counts, (step, args) and the eager
    step."""
    import torch

    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch import make_register_fn
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.ops import graph
    from fccf_pcr_torch.pipeline.register import STEP

    model = get_model(configs.CONFIGS[name]["model"])
    args, _ = config_batch(name, list(range(batch)), model.params, model.caps,
                           dev)
    fn = make_register_fn(model.params, model.caps, batched=True, device=dev)
    # The pool the first call makes: the step graph's.
    STEP.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pools = graph.pool_bytes(dev)
    res = fn(*args)  # warm up: the capture
    torch.cuda.synchronize()
    step_pool = graph.pool_bytes(dev) - pools
    check(bool((res.status == 0).all()), f"{name} timing batch: non-zero status")
    del res
    zero_counts(counters, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    per_step = {k: n / reps for k, n in read_counts(counters, dev).items()}
    per_step["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    per_step["peak_bytes_over_inputs"] = per_step["peak_bytes"] - base
    per_step["graph_pool_bytes"] = graph.pool_bytes(dev)
    per_step["step_pool_bytes"] = step_pool
    want = dict(step_graph_replays=1, step_graph_captures=0)
    check(all(per_step[k] == v for k, v in want.items()),
          f"{name} timing: graph captures and replays a warm step "
          f"{ {k: per_step[k] for k in want} } (want {want})")
    per_step["host_sync_lines"] = count_syncs(fn, *args)
    per_step["host_syncs"] = sum(per_step["host_sync_lines"].values())
    check(per_step["host_syncs"] == 0, f"{name} timing: a warm step made "
          f"{per_step['host_syncs']} host syncs "
          f"({dict(per_step['host_sync_lines'])}; want 0)")
    per_step.update(count_launches(fn, *args))
    return (batch / dt, dt, per_step, (fn, args),
            eager_step(model.params, model.caps))


@contextlib.contextmanager
def lm_impl(impl):
    """verify/quick.py's refine_pairs replaced by ``impl`` for the
    duration (the step looks the name up at each call)."""
    from fccf_pcr_torch.verify import quick

    old = quick.refine_pairs
    quick.refine_pairs = impl
    try:
        yield
    finally:
        quick.refine_pairs = old


def event_ms(fn):
    """CUDA-event ms from before to after ``fn()`` on the current stream
    (the card's time for the call, idle gaps included)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_graph(name, step, eager, counters, dev):
    """Phase 18 at one preset: the batch-8 step replayed as one CUDA graph
    (make_register_fn, the main path) against the eager step
    (_register_batch, L1 launched eagerly) and the eager step with the
    plain LM loop and its early exit (``lm_loop`` put into the step).
    Every field must be bitwise equal; per step and arm: host syncs, host
    launches and device kernels, step graph captures and replays (the
    eager arms must capture and replay none), peak memory; wall times in
    turns; the LM alone on the step's own inputs (kept for phase 20).
    Returns the numbers."""
    import torch

    from fccf_pcr_torch.ops import graph
    from fccf_pcr_torch.pipeline.register import STEP
    from fccf_pcr_torch.refine import gauss_newton as gn
    from fccf_pcr_torch.refine import lm_kernel as lmk

    fn, args = step

    def eager_lm(*a):
        with lm_impl(gn.lm_loop):
            return eager(*a)

    arms = {"graph": fn, "eager": eager, "eager_lm": eager_lm}
    secs = {}
    ts = time.perf_counter()
    res = {arm: call(*args) for arm, call in arms.items()}
    torch.cuda.synchronize()
    for arm in ("eager", "eager_lm"):
        for f, a, b in zip(res["graph"]._fields, res["graph"], res[arm]):
            check(torch.equal(a, b), f"{name}: {f} of the graph step differs "
                  f"from the {arm} step's")
    out = {"turns_ms": collections.defaultdict(list), "secs": secs}
    secs["equal"] = time.perf_counter() - ts
    ts = time.perf_counter()
    for arm in ("graph", "eager", "eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arms[arm](*args)
        torch.cuda.synchronize()
        out["turns_ms"][arm].append((time.perf_counter() - t0) * 1e3)
    secs["turns"] = time.perf_counter() - ts
    ts = time.perf_counter()
    for arm, call in arms.items():
        lines = count_syncs(call, *args)
        zero_counts(counters, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        call(*args)
        torch.cuda.synchronize()
        counts = read_counts(counters, dev)
        out[arm] = dict(
            host_syncs=sum(lines.values()),
            host_sync_lines=dict(lines.most_common()),
            peak_bytes=torch.cuda.max_memory_allocated(dev),
            **{k: counts[k] for k in GRAPH_COUNTS},
            **count_launches(call, *args, n=3 if arm == "graph" else 1))
    g, e, el = out["graph"], out["eager"], out["eager_lm"]
    check(g["step_graph_replays"] == 1 and g["step_graph_captures"] == 0
          and g["host_syncs"] == 0, f"{name}: the graph step {g}")
    check(e["step_graph_replays"] == e["step_graph_captures"] == 0
          and el["step_graph_replays"] == el["step_graph_captures"] == 0,
          f"{name}: an eager arm captured or replayed a step graph: {e}, "
          f"{el}")
    out["graph_pool_bytes"] = graph.pool_bytes(dev)
    out["graphs_kept"] = STEP.cached(dev)
    secs["counts"] = time.perf_counter() - ts
    ts = time.perf_counter()

    # The LM alone, on the inputs the (eager) step gave it.
    kw = record_lm(name, eager, args)
    lm = {"lanes": int(kw["n1"].shape[0]), "planes": int(kw["n1"].shape[1])}
    forms = {"l1": lambda: lmk.refine_lm(**kw),
             "eager": lambda: gn.lm_loop(**kw),
             "eager_to_cap": lambda: gn.lm_loop(**kw, early_exit=False)}
    got = forms["l1"]()
    for form in ("eager", "eager_to_cap"):
        check(torch.equal(got, forms[form]()),
              f"{name}: L1 differs from the {form} LM loop")
    for form, call in forms.items():
        lm[form + "_wall_ms"] = wall_ms(call, 5 if form == "l1" else 2)
        lm[form + "_event_ms"] = min(
            event_ms(call) for _ in range(3 if form == "l1" else 1))
    lm["l1_launches"] = count_launches(forms["l1"])
    lm["eager_launches"] = count_launches(forms["eager"], n=1)
    out["lm"] = lm
    out["lm_inputs"] = kw
    secs["lm"] = time.perf_counter() - ts
    return out


def lm_lanes(seed, B, P):
    """(n1, p1, n2, p2, w) float32 numpy: plane pairs under a small
    per-lane pose error with 2 cm of noise on the points, a quarter of P
    masked; the last three lanes of zero weights, at exactly zero cost and
    with a NaN point (tests/test_torch_cuda.py's LM lanes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n1 = rng.normal(size=(B, P, 3))
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    p1 = rng.uniform(-5, 5, (B, P, 3))
    ang = rng.normal(0, 0.03, (B, 3))
    c, s = np.cos(ang[:, 2]), np.sin(ang[:, 2])
    R = np.zeros((B, 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
    R[:, 2, 2] = 1.0
    n2 = np.einsum("bij,bpj->bpi", R, n1)
    p2 = (np.einsum("bij,bpj->bpi", R, p1) + rng.normal(0, 0.05, (B, 1, 3))
          + rng.normal(0, 0.02, (B, P, 3)))
    w = rng.uniform(0.05, 0.2, (B, P))
    w[:, P - P // 4:] = 0.0
    w[B - 3] = 0.0
    n2[B - 2], p2[B - 2] = n1[B - 2], p1[B - 2]
    p1[B - 1, min(5, P - 1), 1] = np.nan
    return [a.astype(np.float32) for a in (n1, p1, n2, p2, w)]


def record_lm(what, eager, args):
    """refine_pairs' keyword inputs, cloned, as the eager step
    ``eager(*args)`` gives them (one LM call a step)."""
    import torch

    from fccf_pcr_torch.refine import gauss_newton as gn

    seen = []

    def record(**kw):
        seen.append({k: v.clone() if torch.is_tensor(v) else v
                     for k, v in kw.items()})
        return gn.refine_pairs(**kw)

    with lm_impl(record):
        eager(*args)
    check(len(seen) == 1, f"{what}: {len(seen)} LM calls in a step")
    return seen[0]


def lm_inputs(name, seeds, dev):
    """``record_lm`` of the eager batched step of configs.CONFIGS[name]'s
    ``seeds``."""
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(configs.CONFIGS[name]["model"])
    args, _ = config_batch(name, seeds, model.params, model.caps, dev)
    return record_lm(name, eager_step(model.params, model.caps), args)


def lm_cases(step_inputs, dev):
    """L1's cases: (what, (n1, p1, n2, p2, w), iters) each: the batch-8
    steps' LM inputs (phase 18), seed 0 of every golden config, and the
    edge cases."""
    import torch

    planes = ("n1", "p1", "n2", "p2", "w")
    cases = [(f"{name} batch-8 step", tuple(kw[k] for k in planes),
              kw["iters"]) for name, kw in step_inputs.items()]
    for name in PATH_CONFIGS:
        kw = lm_inputs(name, [0], dev)
        cases.append((f"{name} seed 0", tuple(kw[k] for k in planes),
                      kw["iters"]))
    n1, p1, n2, p2, w = (step_inputs["heritage"][k] for k in planes)
    nan = p1.clone()
    nan[0, 3, 1] = float("nan")
    zero_n2, zero_p2 = n2.clone(), p2.clone()
    zero_n2[1], zero_p2[1] = n1[1], p1[1]
    cases += [
        ("heritage step, all weights 0", (n1, p1, n2, p2,
                                          torch.zeros_like(w)), 50),
        ("heritage step, a NaN plane in lane 0", (n1, nan, n2, p2, w), 50),
        ("heritage step, lane 1 at zero cost", (n1, p1, zero_n2, zero_p2,
                                                w), 50),
        ("heritage step, iters 0", (n1, p1, n2, p2, w), 0),
        ("heritage step, iters 1", (n1, p1, n2, p2, w), 1),
        ("heritage step, Bt 1", tuple(x[:1] for x in (n1, p1, n2, p2, w)),
         50),
    ]
    for B, P in ((12, 16), (96, 16), (192, 16), (12, 4), (96, 4), (24, 32),
                 (12, 33), (96, 64), (24, 200)):
        lanes = tuple(torch.from_numpy(a).to(dev)
                      for a in lm_lanes(B + P, B, P))
        for iters in (1, 50):
            cases.append((f"Bt {B}, F {P} (zero-weight, zero-cost and NaN "
                          f"lanes), iters {iters}", lanes, iters))
    # no cap on F: one above PR 11's 4096, and 4F above the 130560 entries
    # from which torch's reduce splits a row over several blocks
    for B, P, iters in ((5, 4097, 20), (4, 40000, 10)):
        lanes = tuple(torch.from_numpy(a).to(dev)
                      for a in lm_lanes(B + P, B, P))
        cases.append((f"Bt {B}, F {P} (zero-weight, zero-cost and NaN "
                      f"lanes), iters {iters}", lanes, iters))
    return cases


def lane_alone_diff(lmk, planes, iters, lanes=(0, 1, 47, 94, 95)):
    """L1's outputs (q, t, steps, accepted) of a lane alone (Bt = 1) and
    of the lanes 36-47 alone (Bt = 12) against the same lanes in the
    whole launch: the count of entries that differ (a NaN equals a
    NaN)."""
    import torch

    full = lmk.lm_solve(*planes, iters)
    parts = [(slice(36, 48), lmk.lm_solve(*(x[36:48] for x in planes),
                                          iters))]
    parts += [(slice(i, i + 1), lmk.lm_solve(*(x[i:i + 1] for x in planes),
                                             iters)) for i in lanes]
    n = 0
    for sl, got in parts:
        for a, b in zip(got, full):
            b = b[sl]
            n += int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())
    return n


def l1_bound(planes, steps, accepted, iters):
    """(bound ms, bound_by, ops) of one L1 launch: the operations the LM
    steps each lane ran need (L1_TRIAL_OPS a plane, L1_LANE_OPS and the
    cost's adds over the 4F rows a lane, a step; L1_ROWS_OPS a plane and
    the 27 folds' adds a pass over the rows, at least one pass a lane
    and one an accepted step but the last) against the bytes (13 floats
    a plane read, q, t and the two counts written)."""
    Bt, F = planes[4].shape
    passes = int(accepted.clamp(min=1).sum()) if iters else 0
    ops = (int(steps.sum()) * (L1_TRIAL_OPS * F + L1_LANE_OPS + 4 * F - 1)
           + passes * (L1_ROWS_OPS * F + 27 * (4 * F - 1)))
    ops_s = ops / PEAK_F32
    bytes_s = 4 * (13 * Bt * F + 9 * Bt) / PEAK_BYTES
    return max(bytes_s, ops_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes"), ops


def phase_lm_vs_plain(lmk, step_inputs, dev):
    """L1 against lm_loop run to its cap on the card (``lm_cases``), every
    transform bitwise equal; then, at the heritage batch-8 step's
    inputs, L1's time by CUDA events (a launch, with and without the
    transform's ops), the plain loop's as a graph of its own replayed and
    eagerly with its early exit (CUDA events), and the bound. Returns the
    count of differing entries (the most in any case) and the times."""
    import torch

    from fccf_pcr_torch.ops import graph
    from fccf_pcr_torch.refine import gauss_newton as gn

    worst = 0
    for what, planes, iters in lm_cases(step_inputs, dev):
        before = lmk.LAUNCHES
        got = lmk.refine_lm(*planes, iters)
        torch.cuda.synchronize()
        check(lmk.LAUNCHES == before + 1, f"{what}: L1 was not launched")
        want = gn.lm_loop(*planes, iters, early_exit=False)
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        err = int((~same).sum())
        worst = max(worst, err)
        check(err == 0 and torch.equal(got, want),
              f"{what}: {err} entries of L1's transforms differ from "
              "lm_loop's")
        _, _, steps, accepted = lmk.lm_solve(*planes, iters)
        print(f"[lm] L1 bitwise equal to lm_loop: {what} "
              f"{tuple(planes[0].shape[:2])}, {iters} iterations at most, "
              f"LM steps {int(steps.sum())} (most {int(steps.max())} a "
              f"lane), {int(accepted.sum())} accepted", flush=True)

    kw = step_inputs["heritage"]
    planes = tuple(kw[k] for k in ("n1", "p1", "n2", "p2", "w"))
    iters = kw["iters"]
    # a lane rounds alike alone, in 12 lanes and in the step's 96
    alone = lane_alone_diff(lmk, planes, iters)
    check(alone == 0, f"heritage: {alone} outputs of L1 differ between a "
          "lane alone and in the batch")
    _, _, steps, accepted = lmk.lm_solve(*planes, iters)
    most = int(torch.argmax(steps))  # the first lane with the most steps
    t = {"lanes": int(planes[0].shape[0]), "planes": int(planes[0].shape[1]),
         "steps": int(steps.sum()), "most_steps": int(steps.max()),
         "accepted": int(accepted.sum()),
         "most_steps_accepted": int(accepted[most]), "alone_diff": alone}
    t["bound_ms"], t["bound_by"], t["ops"] = l1_bound(planes, steps,
                                                      accepted, iters)
    # By CUDA events over launches back to back (the host enqueues one in
    # far less time than the card runs it), not CUPTI: late in a run CUPTI
    # lost every record of a one-kernel capture, ten captures in a row.
    t["ms"] = cuda_ms(lambda: lmk.lm_solve(*planes, iters), 20)
    # The scratch instantiation on the same lanes: bit-equal, and its
    # time in turns with the registers one's (registers, scratch,
    # scratch, registers), the reason the registers one is kept.
    regs = lmk.lm_solve(*planes, iters)
    scratch = lmk.lm_solve(*planes, iters, registers=False)
    check(all(torch.equal(a, b) for a, b in zip(regs, scratch)),
          "heritage: L1's scratch instantiation differs from its registers "
          "one")
    t["turns"] = [cuda_ms(lambda: lmk.lm_solve(*planes, iters,
                                               registers=arm), 20)
                  for arm in (True, False, False, True)]
    t["scratch_ms"] = min(t["turns"][1:3])
    t["one_launch_ms"] = min(
        event_ms(lambda: lmk.lm_solve(*planes, iters)) for _ in range(3))
    t["call_event_ms"] = cuda_ms(lambda: lmk.refine_lm(*planes, iters), 20)
    lm_graph = graph.Graphs(max_graphs=1)

    def replay():
        return lm_graph.replay(gn.lm_loop, planes, (iters, False))

    check(torch.equal(replay(), lmk.refine_lm(*planes, iters)),
          "heritage: the plain loop's replay differs from L1")
    t["plain_ms"] = min(event_ms(replay) for _ in range(3))
    t["plain_kernels"] = count_launches(replay)["device_kernels"]
    lm_graph.clear()
    t["eager_ms"] = event_ms(lambda: gn.lm_loop(*planes, iters))
    return worst, t


def graph_turns(what, graph_fn, eager_fn, args):
    """``graph_fn`` and ``eager_fn`` on ``args`` in turns (graph, eager,
    eager, graph) after one untimed run of each (the graph's capture),
    every result's fields bitwise equal to that graph run's. Returns the
    wall ms of each arm."""
    import torch

    turns = collections.defaultdict(list)
    first = graph_fn(*args)  # captures the step graph; untimed
    eager_fn(*args)
    for arm in ("graph", "eager", "eager", "graph"):
        fn = graph_fn if arm == "graph" else eager_fn
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        turns[arm].append(round((time.perf_counter() - t0) * 1e3, 1))
        for f, a, b in zip(first._fields, first, res):
            check(torch.equal(a, b), f"{what}: {f} of the {arm} step "
                  "differs from the graph step's")
    return dict(turns)


def kernel_stages(fn):
    """One torch.profiler capture (CPU and CUDA activity) of ``fn()``:
    each device kernel (``device_records``, copies and fills left out)
    as (ranges, name, ms), ``ranges`` the record_function ranges around
    the host call that launched it, outermost first. That call is the
    CUDA launch call with the kernel's correlation id (a kernel of the
    port is launched through ctypes, inside no aten op), else the aten op
    the kernel is linked to; a kernel with neither gets no ranges."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ranges, ops, calls = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            continue
        if e.is_user_annotation():
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
        if e.name().startswith(LAUNCH_CALLS):
            calls[e.correlation_id()] = e.start_ns()
        elif e.name().startswith("aten::"):
            ops.setdefault(e.correlation_id(), e.start_ns())
    ranges.sort()
    starts = [r[0] for r in ranges]
    out = []
    for e in device_records(prof):
        if e.name().startswith(("Memcpy", "Memset")):
            continue
        t = calls.get(e.correlation_id())
        if t is None and e.linked_correlation_id() > 0:
            t = ops.get(e.linked_correlation_id())
        chain = () if t is None else tuple(
            name for start, end, name in ranges[:bisect.bisect_right(starts, t)]
            if end >= t)
        out.append((chain, e.name(), record_ms(e)))
    return out


@contextlib.contextmanager
def plain_scans():
    """ops/scan.py's kernels S1 and S2 replaced by their plain versions
    for the duration: the step's scans as the port ran them on the card
    before S1 and S2 (torch.cumsum, torch.cummax, flip / cummin / flip,
    and the blocked prefix sum as PyTorch ops)."""
    from fccf_pcr_torch.ops import scan

    with swapped(scan, _launch_int_scan=scan.int_scan_plain,
                 _launch_prefix_sum=functools.partial(scan.prefix_sum_plain,
                                                      dim=1),
                 _launch_leaf_sums=scan.leaf_sums_plain,
                 _launch_moment_sums=scan.moment_sums_plain):
        yield


@contextlib.contextmanager
def swapped(module, **attrs):
    """``module``'s attributes set to ``attrs`` for the duration."""
    kept = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in kept.items():
            setattr(module, k, v)


def unfused(kind):
    """A fused S2 call as the port made it before the fused entries: its
    columns concatenated (``leaf_columns`` / ``moment_columns``), then S2
    on them (``kind`` "leaf" or "moments")."""
    from fccf_pcr_torch.ops import scan

    columns = scan.leaf_columns if kind == "leaf" else scan.moment_columns

    def run(*sources):
        cols = columns(*sources)
        return scan._launch_prefix_sum(
            cols.reshape(-1, *cols.shape[-2:])).view(cols.shape)
    return run


@contextlib.contextmanager
def concatenated_columns():
    """The fused S2 calls made as before them (``unfused``): the leaf and
    moment columns written by torch.cat / torch.stack, then S2."""
    from fccf_pcr_torch.ops import scan

    with swapped(scan, _launch_leaf_sums=unfused("leaf"),
                 _launch_moment_sums=unfused("moments")):
        yield


def stage_table(name, ks):
    """``kernel_stages``' kernels by stage (the outermost range, one of
    STAGES) and by chain of ranges: device ms, kernel count and the three
    kernels with the most time. Every kernel must lie in a stage, and the
    buckets must add up to the kernels."""
    stages, paths = {}, {}
    for chain, kname, ms in ks:
        for key, table in ((chain[0] if chain else "", stages),
                           (" > ".join(chain), paths)):
            b = table.setdefault(key, dict(ms=0.0, kernels=0, by_name={}))
            b["ms"] += ms
            b["kernels"] += 1
            b["by_name"][kname] = b["by_name"].get(kname, 0.0) + ms
    check(sum(b["kernels"] for b in stages.values()) == len(ks)
          == sum(b["kernels"] for b in paths.values()),
          f"{name} stages: the buckets do not add up to {len(ks)} kernels")
    outside = collections.Counter(k for chain, k, _ in ks
                                  if not chain or chain[0] not in STAGES)
    check(not outside, f"{name} stages: kernels outside every stage: "
          f"{dict(outside)}")
    for b in list(stages.values()) + list(paths.values()):
        b["top"] = sorted(b.pop("by_name").items(), key=lambda kv: -kv[1])[:3]
    return dict(kernels=len(ks), ms=sum(ms for _, _, ms in ks),
                stages={k: stages[k] for k in STAGES if k in stages},
                paths=dict(sorted(paths.items(),
                                  key=lambda kv: -kv[1]["ms"])))


# A torch.cat / torch.stack kernel writing a 3-D float32 tensor (4-byte
# elements, 3 dims), the kind that concatenated the voxelization's leaf
# and moment columns before the fused S2 (and that assembles its
# covariances).
CAT_3D_FLOAT = re.compile(
    r"CatArrayBatchedCopy\w*<[^>]*OpaqueType<4u?>\s*,\s*unsigned int\s*,"
    r"\s*3\s*,")
COLUMN_RANGES = ("voxelize.leaf", "voxelize.voxels")
# The outer ranges of F1 (the plane fit) and F2 (the face statistics and
# the roughness), F1's entry range, and the kernel a doubling step's
# torch.cat runs.
F1_RANGE = "faces_kernels.plane_fit"
F2_RANGES = ("face_stats", "faces.roughness")
CAT_KERNEL = re.compile(r"CatArrayBatchedCopy")
# A kernel of torch.sort (cub's radix sort, or a small-row sort).
SORT_KERNEL = re.compile(r"[Ss]ort")


@contextlib.contextmanager
def plain_faces():
    """ops/faces_kernels.py's kernels F1 and F2 replaced by their plain
    versions for the duration: the faces stage's plane fit and segment
    sums as the port ran them on the card before F1 and F2."""
    from fccf_pcr_torch.ops import faces_kernels as fk

    with swapped(fk, _launch_plane_fit=fk.plane_fit_plain,
                 _launch_face_stats=fk.face_stats_by_label_plain,
                 _launch_segment_sum=fk.values_sum_by_label_plain):
        yield


@contextlib.contextmanager
def plain_hypotheses():
    """ops/hypotheses_kernels.py's H1, H2 and H3 replaced by their plain
    versions for the duration: the hypotheses stage as the port ran it on
    the card before them (the compactions, the (M, F, F) grids and the
    stable sort of each match's slots)."""
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    with swapped(hk, _launch_matches=hk.matches_plain,
                 _launch_slots=hk.slots_plain, _launch_emit=hk.emit_plain):
        yield


@contextlib.contextmanager
def plain_fine():
    """ops/fine_kernels.py's join V replaced by its plain versions for the
    duration: fine verify's join as searchsorted counts and a dense
    fold_sum of the join's places."""
    from fccf_pcr_torch.ops import fine_kernels as fnk

    def plain(T, table, pts, mask, params):
        return fnk.join_plain(T, table, pts, mask, params)

    with swapped(fnk, _launch_join=plain):
        yield


STAGE_ARMS = {"plain scans": plain_scans,
              "concatenated columns": concatenated_columns,
              "plain faces": plain_faces,
              "plain hypotheses": plain_hypotheses,
              "plain fine": plain_fine,
              "kernels": contextlib.nullcontext}
# H1, H2 and H3's kernels, and the most kernels the hypotheses stage may
# hold besides them.
HYP_KERNELS = ("hyp_matches_kernel", "hyp_slots_kernel", "hyp_emit_kernel")
HYP_STAGE_MOST = 6
# The join's kernel and its entry's range, the most kernels that range may
# hold (the join alone: its counts need no fill) and the range of the
# table's own sort in the fine_verify stage.
FINE_KERNELS = ("fine_join_kernel",)
FINE_RANGES = ("fine_kernels.join",)
FINE_RANGE_MOST = 1
FINE_TABLE_RANGE = "fine.table"


def hyp_chains(ks):
    """In one eager step's kernels (``kernel_stages``): those of the
    hypotheses stage, their sort kernels and the launches of each of H1,
    H2 and H3 there."""
    ks = [k for chain, k, _ in ks if chain and chain[0] == "hypotheses"]
    return dict(kernels=len(ks),
                sorts=sum(1 for k in ks if SORT_KERNEL.search(k)),
                launches={n: sum(1 for k in ks if n in k)
                          for n in HYP_KERNELS},
                names=sorted({k[:60] for k in ks})[:8])


def fine_chains(ks):
    """In one eager step's kernels (``kernel_stages``): those in the
    join's entry range and its launches there, and the sort kernels of
    the fine_verify stage outside its table's range."""
    inside = [k for chain, k, _ in ks if any(r in chain for r in FINE_RANGES)]
    return dict(kernels=len(inside),
                launches={n: sum(1 for k in inside if n in k)
                          for n in FINE_KERNELS},
                sorts=sum(1 for chain, k, _ in ks
                          if chain and chain[0] == "fine_verify"
                          and FINE_TABLE_RANGE not in chain
                          and SORT_KERNEL.search(k)),
                names=sorted({k[:60] for k in inside})[:8])


def faces_chains(ks):
    """In one eager step's kernels (``kernel_stages``): the kernels in
    F1's entry range (the eigen3 chain and the gates, or F1 alone), and
    those in F2's outer ranges with the CatArrayBatchedCopy kernels among
    them (the doubling steps' cats) and the sort kernels (torch.sort by
    label before F2 formed its own order)."""
    f1 = collections.Counter(k for chain, k, _ in ks if F1_RANGE in chain)
    f2 = [k for chain, k, _ in ks if any(r in chain for r in F2_RANGES)]
    return dict(f1_kernels=sum(f1.values()),
                f1_names=sorted(k[:60] for k in f1),
                f2_kernels=len(f2),
                f2_cats=sum(1 for k in f2 if CAT_KERNEL.search(k)),
                f2_sorts=sum(1 for k in f2 if SORT_KERNEL.search(k)),
                f2_launches=sum(1 for k in f2
                                if "faces_segment_sum_kernel" in k))


def column_cats(eager, args, n):
    """The torch.cat / torch.stack calls of one eager step inside
    COLUMN_RANGES that take a float32 tensor with a dim of n (the rows of
    the voxelized clouds): (range, input shapes) each. The calls are seen
    by a TorchDispatchMode, the ranges by wrapping ops/voxelize.py's
    record_function."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from fccf_pcr_torch.ops import voxelize as tvox

    ranges, found = [], []
    real = tvox.record_function
    cats = (torch.ops.aten.cat.default, torch.ops.aten.stack.default)

    @contextlib.contextmanager
    def tracked(name):
        ranges.append(name)
        try:
            with real(name):
                yield
        finally:
            ranges.pop()

    class Cats(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            inside = [r for r in ranges if r in COLUMN_RANGES]
            if func in cats and inside and any(
                    t.dtype == torch.float32 and n in t.shape
                    for t in args[0]):
                found.append((inside[-1], [tuple(t.shape) for t in args[0]]))
            return func(*args, **(kwargs or {}))

    with swapped(tvox, record_function=tracked), Cats():
        eager(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return found


def phase_stages(name, step, eager, graph_kernels):
    """Phase 21 at one preset: the device kernels of one eager batch-8
    step by stage and by range (``stage_table``; ``kernel_stages``, the
    capture of three that holds the most kernels: CUPTI drops records and
    never adds one), with the step's scans as their plain versions
    (``plain_scans``, the port before S1 and S2), with the leaf and
    moment columns concatenated before S2 (``concatenated_columns``, the
    port before the fused S2) and through S1 and the fused S2. In
    ``COLUMN_RANGES`` the fused arm must make no concatenation of the
    clouds' float32 columns (``column_cats``), the concatenated arm must
    make one at least in each range, and the fused arm's 3-D float32 cat
    kernels (``CAT_3D_FLOAT``) must be fewer by as many. The arms with
    F1 / F2 (``plain_faces``) and with H1-H3 (``plain_hypotheses``)
    swapped for their plain versions prove the faces and hypotheses
    stages' checks (``faces_chains``, ``hyp_chains``). Beside it the
    graph step's kernels (phase 8's
    count, and the kernel names one capture of the replay holds more or
    fewer than the eager step: the graph replays the same program)."""
    import torch

    fn, args = step
    n = next(x[-1].shape[-1] for _, x, op in record_scans(eager, args)
             if op == "moments")
    out = {"column_cats": {}, "cat_kernels": {}, "faces_chains": {},
           "hyp_chains": {}, "fine_chains": {}}
    for arm, ctx in STAGE_ARMS.items():
        with ctx():
            eager(*args)  # warm up
            torch.cuda.synchronize()
            ks = max((kernel_stages(lambda: eager(*args)) for _ in range(3)),
                     key=len)
            calls = column_cats(eager, args, n)
        out[arm] = stage_table(name, ks)
        out["faces_chains"][arm] = faces_chains(ks)
        out["hyp_chains"][arm] = hyp_chains(ks)
        out["fine_chains"][arm] = fine_chains(ks)
        out["column_cats"][arm] = {r: [c for c in calls if c[0] == r]
                                   for r in COLUMN_RANGES}
        out["cat_kernels"][arm] = {
            r: sum(1 for chain, k, _ in ks
                   if r in chain and CAT_3D_FLOAT.search(k))
            for r in COLUMN_RANGES}
        print(f"[stages] {name} {arm}: torch.cat / torch.stack calls on "
              f"float32 columns of {n} rows in {COLUMN_RANGES}: "
              f"{out['column_cats'][arm]}; 3-D float32 cat kernels there "
              f"{out['cat_kernels'][arm]}", flush=True)
    fc, plain = out["faces_chains"]["kernels"], out["faces_chains"][
        "plain faces"]
    check(fc["f1_kernels"] == 1 and "faces_plane_fit_kernel" in fc[
        "f1_names"][0], f"{name}: {F1_RANGE} holds {fc['f1_names']}, not F1 "
          "alone")
    check(plain["f1_kernels"] > 100, f"{name}: the plain plane fit ran "
          f"{plain['f1_kernels']} kernels in {F1_RANGE}: the range misses "
          "its chain")
    check(fc["f2_cats"] == 0 and fc["f2_launches"] == 3
          and fc["f2_sorts"] == 0,
          f"{name}: {F2_RANGES} hold {fc['f2_cats']} cat kernels, "
          f"{fc['f2_sorts']} sort kernels and {fc['f2_launches']} F2 "
          "launches (want 0, 0 and 3)")
    check(plain["f2_cats"] > 0 and plain["f2_launches"] == 0
          and plain["f2_sorts"] > 0,
          f"{name}: the plain segment sums ran {plain['f2_cats']} cat "
          f"kernels, {plain['f2_sorts']} sort kernels and "
          f"{plain['f2_launches']} F2 launches in {F2_RANGES}")
    hc, hplain = out["hyp_chains"]["kernels"], out["hyp_chains"][
        "plain hypotheses"]
    check(hc["sorts"] == 0 and all(n == 1 for n in hc["launches"].values())
          and hc["kernels"] <= HYP_STAGE_MOST,
          f"{name}: the hypotheses stage holds {hc['kernels']} kernels, "
          f"{hc['sorts']} sort kernels and H1-H3 launches {hc['launches']} "
          f"(want at most {HYP_STAGE_MOST}, no sort, one each): "
          f"{hc['names']}")
    check(hplain["sorts"] > 0 and not any(hplain["launches"].values()),
          f"{name}: the plain hypotheses stage ran {hplain['sorts']} sort "
          f"kernels and H1-H3 launches {hplain['launches']}")
    vc, vplain = out["fine_chains"]["kernels"], out["fine_chains"][
        "plain fine"]
    check(vc["sorts"] == 0 and all(n == 1 for n in vc["launches"].values())
          and vc["kernels"] <= FINE_RANGE_MOST,
          f"{name}: {FINE_RANGES} hold {vc['kernels']} kernels and V "
          f"launches {vc['launches']}, and the fine_verify stage "
          f"{vc['sorts']} sort kernels outside {FINE_TABLE_RANGE} (want at "
          f"most {FINE_RANGE_MOST}, one each and no sort): {vc['names']}")
    check(vplain["kernels"] > FINE_RANGE_MOST
          and not any(vplain["launches"].values()),
          f"{name}: the plain fine verify ran {vplain['kernels']} kernels and "
          f"V launches {vplain['launches']} in {FINE_RANGES}")
    for r in COLUMN_RANGES:
        fused = out["column_cats"]["kernels"][r]
        cat = out["column_cats"]["concatenated columns"][r]
        check(not fused, f"{name}: {r} still concatenates its columns: "
              f"{fused}")
        check(cat, f"{name}: no column concatenation seen in {r} with the "
              "columns concatenated: column_cats misses them")
        check(out["cat_kernels"]["concatenated columns"][r]
              - out["cat_kernels"]["kernels"][r] == len(cat),
              f"{name}: {r}'s 3-D float32 cat kernels "
              f"{out['cat_kernels']} do not fall by the {len(cat)} column "
              "concatenations")
    fn(*args)  # the step graph may have been evicted: capture it first
    torch.cuda.synchronize()
    graph_names = collections.Counter(
        e.name() for e in max(
            (device_records_of(lambda: fn(*args)) for _ in range(3)),
            key=len)
        if not e.name().startswith(("Memcpy", "Memset")))
    eager_names = collections.Counter(kname for _, kname, _ in ks)
    out.update(graph_kernels=graph_kernels,
               graph_capture_kernels=sum(graph_names.values()),
               graph_more=dict((graph_names - eager_names).most_common()),
               eager_more=dict((eager_names - graph_names).most_common()))
    return out


def device_records_of(fn):
    """``device_records`` of one torch.profiler capture (CUDA activity) of
    ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_records(prof)


def print_stages(name, st, smi):
    """Phase 21's lines for one preset."""
    for arm in STAGE_ARMS:
        t = st[arm]
        fc = st["faces_chains"][arm]
        print(f"[stages] {name} eager batch-8 step, {arm}: {t['kernels']} "
              f"device kernels, {t['ms']:.3f} ms of device time, every "
              f"kernel in a stage; {fc['f1_kernels']} kernels in {F1_RANGE}"
              f" ({len(set(fc['f1_names']))} names), {fc['f2_kernels']} in "
              f"{' / '.join(F2_RANGES)}, {fc['f2_cats']} of them "
              f"CatArrayBatchedCopy, {fc['f2_sorts']} sort kernels, "
              f"{fc['f2_launches']} F2; hypotheses stage "
              f"{st['hyp_chains'][arm]}; fine verify "
              f"{st['fine_chains'][arm]} | {smi}",
              flush=True)
        for stage, b in t["stages"].items():
            top = "; ".join(f"{ms:.3f} ms {k[:70]}" for k, ms in b["top"])
            print(f"[stages] {name} {arm} stage {stage}: {b['ms']:.3f} ms "
                  f"over {b['kernels']} kernels; most: {top}", flush=True)
        for path, b in t["paths"].items():
            top = "; ".join(f"{ms:.3f} ms {k[:60]}" for k, ms in b["top"])
            print(f"[stages] {name} {arm} range {path}: {b['ms']:.3f} ms "
                  f"over {b['kernels']} kernels; most: {top}", flush=True)
    print(f"[stages] {name} graph step: {st['graph_kernels']} device "
          f"kernels (phase 8; {st['graph_capture_kernels']} in this capture "
          f"of a replay) against the eager step's "
          f"{st['kernels']['kernels']}; kernels the replay holds more: "
          f"{st['graph_more']}, fewer: {st['eager_more']} | {smi}",
          flush=True)


def graph_ms(fn, reps=10):
    """Device ms of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph and its replay timed with CUDA events (no host time between
    the kernels), the least of three replays. Back to back, so an input
    that fits in the 50 MB L2 cache is read from there after the first
    call."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del g
    torch.cuda.synchronize()
    return min(times)


def record_scans(eager, args):
    """The inputs of every S1 and S2 call of one eager step, in order:
    (kernel, input, op) with S1's op; for S2 its (B, n, D) input and op
    None, or for a fused call the tuple of its sources and op "leaf" or
    "moments"."""
    import torch

    from fccf_pcr_torch.ops import scan

    seen = []
    kept = {k: getattr(scan, k) for k in (
        "_launch_int_scan", "_launch_prefix_sum", "_launch_leaf_sums",
        "_launch_moment_sums")}

    def s1(x, op):
        seen.append(("S1", x.clone(), op))
        return kept["_launch_int_scan"](x, op)

    def s2(x3):
        seen.append(("S2", x3.clone(), None))
        return kept["_launch_prefix_sum"](x3)

    def fused(kind, launch):
        def run(*sources):
            seen.append(("S2", tuple(t.clone() for t in sources), kind))
            return launch(*sources)
        return run

    with swapped(scan, _launch_int_scan=s1, _launch_prefix_sum=s2,
                 _launch_leaf_sums=fused("leaf",
                                         kept["_launch_leaf_sums"]),
                 _launch_moment_sums=fused("moments",
                                           kept["_launch_moment_sums"])):
        eager(*args)
    torch.cuda.synchronize()
    return seen


def scan_bound(kernel, x, op):
    """The least time the card could take for one S1 or S2 call, in ms,
    and what bounds it: each input byte read once and each output byte
    written once over the memory rate (S1 writes int64 sums, or the input
    type; S2 float32; a fused S2 call reads its sources and writes 4 or
    10 float32 columns). Its operations (one add or compare an entry, S2
    a few more levels of 1/16 of them and the products) take far less at
    any peak rate."""
    if op in ("leaf", "moments"):
        in_bytes = sum(t.numel() * t.element_size() for t in x)
        out_bytes = x[-1].numel() * 4 * (4 if op == "leaf" else 10)
    else:
        in_bytes = x.numel() * x.element_size()
        out_bytes = x.numel() * (8 if kernel == "S1" and op == 0
                                 else x.element_size())
    return (in_bytes + out_bytes) / PEAK_BYTES * 1e3, "bytes"


def scan_edge_cases(dev):
    """S1's and S2's edge inputs: (kernel, input, op), the fused S2's
    input the tuple of its sources."""
    import numpy as np
    import torch

    rng = np.random.default_rng(13)
    cases = []
    # Rows of one tile (1024 entries), of exactly k tiles, one entry more
    # or less; one row and many.
    for lead, n in (((2, 3), 1), ((2, 3), 17), ((2, 3), 1023), ((2, 3), 1024),
                    ((1,), 1025), ((2, 3), 4095), ((2, 3), 4096),
                    ((1,), 4097), ((2, 3), 8192), ((1,), 8193),
                    ((7, 5), 12289)):
        flags = rng.uniform(size=lead + (n,)) < 0.3
        flags[..., 0, :] = False
        flags[..., -1, :] = True
        big = rng.integers(2**31 - 2**20, 2**31 - 1, lead + (n,))
        big[..., 0, :] = -big[..., 0, :]
        tail = np.where(rng.uniform(size=(1, n)) < 0.2, np.arange(n),
                        2**31 - 1)
        tail[:, n - n // 3:] = 2**31 - 1
        cases.append(("S1", torch.from_numpy(flags), 0))
        for x in (big.astype(np.int32), big, tail.astype(np.int32), tail):
            for op in (0, 1, 2):
                cases.append(("S1", torch.from_numpy(x), op))
    for shape in ((1, 1, 4), (2, 17, 4), (3, 257, 10), (1, 65537, 3)):
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        x[..., 0] = -0.0
        x[rng.uniform(size=shape) < 0.01] = np.inf
        x[rng.uniform(size=shape) < 0.01] = np.nan
        cases.append(("S2", torch.from_numpy(x), None))
    # The fused S2: -0.0, inf and NaN in p / px, masked rows (x * 0.0 is
    # -0.0 or NaN there), lengths around its levels' rows (4096, 65536).
    for n in (1, 17, 4097, 65537, 65536 + 4096 - 1, 65536 + 4096 + 1,
              65536 + 3 * 4096 - 1, 65536 + 3 * 4096 + 1):
        p = rng.uniform(-2, 2, (2, n, 3)).astype(np.float32)
        p[rng.uniform(size=p.shape) < 0.02] = -0.0
        p[rng.uniform(size=p.shape) < 0.002] = np.inf
        p[rng.uniform(size=p.shape) < 0.002] = -np.inf
        p[rng.uniform(size=p.shape) < 0.002] = np.nan
        mask = rng.uniform(size=(2, n)) < 0.7
        mask[1, : n // 2] = False
        first = rng.uniform(size=(2, n)) < 0.2
        t = [torch.from_numpy(a) for a in (p, mask, first)]
        cases.append(("S2", (t[0][..., 0].contiguous(),
                             t[0][..., 1].contiguous(),
                             t[0][..., 2].contiguous(), t[1], t[2]), "leaf"))
        cases.append(("S2", (t[0], t[1]), "moments"))
    return [(k, tuple(t.to(dev) for t in x) if isinstance(x, tuple)
             else x.to(dev), op) for k, x, op in cases]


def scan_forms(kernel, x, op):
    """(kernel, plain, library) calls of one S1 or S2 input: the library
    call is torch.cumsum / torch.cummax / torch.cummin on the same rows,
    for S2 torch.cumsum along dim 1 (another order of additions) on the
    columns formed beforehand for a fused call."""
    import torch

    from fccf_pcr_torch.ops import scan

    if kernel == "S1":
        library = {0: lambda: torch.cumsum(x, dim=-1),
                   1: lambda: torch.cummax(x, dim=-1),
                   2: lambda: torch.cummin(x, dim=-1)}[op]
        return (lambda: scan._launch_int_scan(x, op),
                lambda: scan.int_scan_plain(x, op), library)
    if op is None:
        return (lambda: scan._launch_prefix_sum(x),
                lambda: scan.prefix_sum_plain(x, dim=1),
                lambda: torch.cumsum(x, dim=1))
    leaf = op == "leaf"
    cols = (scan.leaf_columns if leaf else scan.moment_columns)(*x)
    return ((lambda: scan._launch_leaf_sums(*x)) if leaf
            else (lambda: scan._launch_moment_sums(*x)),
            lambda: (scan.leaf_sums_plain if leaf
                     else scan.moment_sums_plain)(*x),
            lambda: torch.cumsum(cols, dim=-2))


def scan_equal(kernel, a, b):
    """Two scan outputs bit for bit (S2's as int32 views: signed zeros,
    and the card's NaNs are one bit pattern)."""
    import torch

    if kernel == "S2":
        a, b = a.view(torch.int32), b.contiguous().view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def scan_replays(cases):
    """Every S1 operation and S2 form of ``cases`` called twice inside one
    captured CUDA graph, the graph replayed twice: each replay's outputs
    equal the eager calls' (a call's scratch may be another's, freed, in
    the graph's pool). Returns the kernel calls the graph holds."""
    import torch

    forms = [scan_forms(k, x, op) for k, x, op in cases]
    kinds = [k for k, _, _ in cases]
    want = [f[0]() for f in forms]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [f[0]() for f in forms for _ in range(2)]
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for i, (k, w) in enumerate(zip(kinds, want)):
            for o in outs[2 * i:2 * i + 2]:
                check(scan_equal(k, o, w), f"{k} {cases[i][2]} called twice "
                      "in a replayed graph differs from its eager call")
    del g
    return len(outs)


def phase_scans(steps, eager, dev):
    """Phase 22: S1 and S2 against their plain versions on the card, bit
    for bit, on every S1 and S2 input of the heritage and office batch-8
    eager steps (``record_scans``; the fused S2 calls by their sources)
    and on the edge cases; each kernel twice in one replayed graph; at
    each step's inputs the device time a call (``graph_ms``) of the
    kernel, the plain version and the library call beside the bound, for
    a fused call also its columns concatenated and then S2 (``unfused``),
    and their sums over the step."""
    names = {0: "cumsum", 1: "cummax", 2: "rev_cummin", None: "prefix_sum",
             "leaf": "leaf_prefix_sums", "moments": "moment_prefix_sums"}

    def shape(x):
        return tuple(x[-1].shape if isinstance(x, tuple) else x.shape)

    def dtype(x):
        return ",".join(str(t.dtype).replace("torch.", "") for t in (
            x if isinstance(x, tuple) else (x,)))

    out = {"S1": {}, "S2": {}, "edge_cases": 0, "differ": 0}
    for name in ("heritage", "office"):
        fn, args = steps[name]
        calls = record_scans(eager[name], args)
        for kernel in ("S1", "S2"):
            out[kernel][name] = dict(calls=[], ms=0.0, plain_ms=0.0,
                                     library_ms=0.0, bound_ms=0.0)
        for kernel, x, op in calls:
            k, plain, lib = scan_forms(kernel, x, op)
            ok = scan_equal(kernel, k(), plain())
            out["differ"] += not ok
            check(ok, f"{name}: {kernel} {names[op]} {shape(x)} {dtype(x)} "
                  "differs from plain")
            bound_ms, bound_by = scan_bound(kernel, x, op)
            c = dict(what=names[op], shape=shape(x), dtype=dtype(x),
                     ms=graph_ms(k), plain_ms=graph_ms(plain),
                     library_ms=graph_ms(lib), bound_ms=bound_ms,
                     bound_by=bound_by)
            if op in ("leaf", "moments"):
                c["unfused_ms"] = graph_ms(lambda: unfused(op)(*x))
            t = out[kernel][name]
            t["calls"].append(c)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                t[key] += c[key]
        check(any(op == "leaf" for _, _, op in calls)
              and any(op == "moments" for _, _, op in calls),
              f"{name}: the step made no fused S2 call")
    cases = scan_edge_cases(dev)
    for kernel, x, op in cases:
        k, plain, _ = scan_forms(kernel, x, op)
        ok = scan_equal(kernel, k(), plain())
        out["differ"] += not ok
        check(ok, f"edge case: {kernel} {names[op]} {shape(x)} {dtype(x)} "
              "differs from plain")
        out["edge_cases"] += 1
    # Each S1 operation on rows of one and of four tiles; each S2 form on
    # columns of many tiles.
    out["replayed_calls"] = scan_replays([
        (k, x, op) for k, x, op in cases
        if (k == "S1" and shape(x)[-1] in (4096, 12289))
        or (k == "S2" and shape(x)[1 if op is None else -1] in (
            65537, 65536 + 3 * 4096 + 1))])
    return out


def record_faces(eager, args):
    """The inputs of every F1 and F2 call of one eager step, in order:
    (form, args) with form "plane_fit", "face_stats" or "values" and args
    those of its kernel's launch (the F2 forms take the labels as they
    come and the valid flags)."""
    import torch

    from fccf_pcr_torch.ops import faces_kernels as fk

    seen = []
    launches = {"plane_fit": "_launch_plane_fit",
                "face_stats": "_launch_face_stats",
                "values": "_launch_segment_sum"}
    kept = {form: getattr(fk, name) for form, name in launches.items()}

    def recorded(form):
        def run(*a):
            seen.append((form, tuple(x.clone() if torch.is_tensor(x) else x
                                     for x in a)))
            return kept[form](*a)
        return run

    with swapped(fk, **{name: recorded(form)
                        for form, name in launches.items()}):
        eager(*args)
    torch.cuda.synchronize()
    return seen


def faces_forms(form, a):
    """(kernel, plain, library) calls of one F1 or F2 input: the library
    call is torch.linalg.eigh of the covariances for F1 (their non-finite
    entries zeroed first: eigh raises on them; ``eigh_calls``), and for F2
    Tensor.index_add_ of the columns as formed (the face statistics' eight
    or the values) into the slots of seg, taken straight from the
    unsorted labels (seg = valid ? min(label, V - 1) : V, a slot V + 1 a
    cloud for the dropped rows; both made beforehand), with atomics in
    another order: what a user calls for these sums."""
    import torch

    from fccf_pcr_torch.ops import faces_kernels as fk

    if form == "plane_fit":
        finite = torch.nan_to_num(a[0], nan=0.0, posinf=0.0,
                                  neginf=0.0).reshape(-1, 3, 3)
        return (lambda: fk._launch_plane_fit(*a),
                lambda: fk.plane_fit_plain(*a),
                eigh_calls(finite))
    V = a[-1]
    if form == "face_stats":
        labels, valid = a[0], a[1]
        cols = fk.stat_columns(a[2], a[3], a[4], valid)
        kernel = lambda: fk._launch_face_stats(*a)  # noqa: E731
        plain = lambda: fk.face_stats_by_label_plain(*a)  # noqa: E731
    else:
        labels, valid = a[1], a[2]
        cols = a[0][..., None]
        kernel = lambda: fk._launch_segment_sum(*a)  # noqa: E731
        plain = lambda: fk.values_sum_by_label_plain(*a)  # noqa: E731
    seg = torch.where(valid, torch.clamp(labels, max=V - 1), V)
    rows = cols.reshape(-1, cols.shape[-1]).contiguous()
    B = seg.numel() // seg.shape[-1]
    base = torch.arange(B, device=seg.device)[:, None] * (V + 1)
    idx = (seg.reshape(B, -1) + base).reshape(-1)
    sums = torch.zeros(B * (V + 1), cols.shape[-1], device=seg.device)
    return kernel, plain, lambda: sums.index_add_(0, idx, rows)


def eigh_calls(cov):
    """torch.linalg.eigh of the (m, 3, 3) covariances ``cov`` as one call,
    or, where cuSOLVER refuses a batch that large, as the fewest calls
    on equal slices that it takes; the function returned reports the
    number of calls in its ``calls`` attribute."""
    import torch

    for parts in (1, 2, 4, 8, 16):
        slices = cov.chunk(parts)
        try:
            for s in slices:
                torch.linalg.eigh(s)
            torch.cuda.synchronize()
        except RuntimeError:  # torch._C._LinAlgError is one
            continue

        def run(slices=slices):
            return [torch.linalg.eigh(s) for s in slices]
        run.calls = len(slices)
        return run
    raise SmokeFailure(f"torch.linalg.eigh refuses {tuple(cov.shape)} in "
                       "16 slices")


def faces_equal(a, b):
    """Two F1 or F2 results bit for bit (float outputs as int32 views:
    signed zeros, and the card's NaNs are one bit pattern)."""
    import torch

    if torch.is_tensor(a):
        a, b = (a,), (b,)

    def bits(t):
        t = t.contiguous()
        return t.view(torch.int32) if t.is_floating_point() else t

    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def faces_bound(form, a):
    """The least time the card could take for one F1 or F2 call, in ms,
    and what bounds it: each input byte read once and each output byte
    written once over the memory rate, against the operations over the
    float32 rate (F1: F1_OPS a voxel; F2: its inputs are the labels
    (int64), the valid flags and the sources, its outputs the slots' sums
    and statistics; an add a row and summed column (7 for face
    statistics: centroid * w, normal * w and w; their count is the
    label's length), and 6 divisions a face-statistics slot)."""
    nbytes = sum(t.numel() * t.element_size() for t in a
                 if hasattr(t, "numel"))
    if form == "plane_fit":
        voxels = a[3].numel()
        nbytes += voxels * (12 + 4 + 1 + 1)
        ops = voxels * F1_OPS
    else:
        labels = a[0] if form == "face_stats" else a[1]
        slots = labels.numel() // labels.shape[-1] * a[-1]
        D = 7 if form == "face_stats" else 1
        nbytes += slots * (32 if D == 7 else 4)
        ops = labels.numel() * D + slots * (6 if D == 7 else 0)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def faces_math_sweep(dev):
    """F1's cosf and atan2f (faces_kernels.math_probe) against torch.cos
    and torch.atan2, bit for bit: cos at every float32 in [0, pi] (the
    phases eigen3 takes the cosine of), atan2 at every r in [-1, 1] with
    y = sqrt((1 - r)(1 + r)) formed as eigen3 forms it (the whole domain
    of its acos), then 2^24 random float32 pairs of any magnitude, inf
    and NaN. Returns the count of inputs held."""
    import numpy as np
    import torch

    from fccf_pcr_torch.ops import faces_kernels as fk

    step, held = 1 << 26, 0
    top = int(np.array(np.pi, np.float32).view(np.int32))
    for lo in range(0, top + 1, step):
        x = torch.arange(lo, min(lo + step, top + 1), dtype=torch.int32,
                         device=dev).view(torch.float32)
        check(faces_equal(fk.math_probe(x, x)[0], torch.cos(x)),
              f"cosf differs from torch.cos from bits {lo}")
        held += x.numel()
    one = int(np.array(1.0, np.float32).view(np.int32))
    for sign in (0, -(1 << 31)):
        for lo in range(0, one + 1, step):
            r = (torch.arange(lo, min(lo + step, one + 1), dtype=torch.int32,
                              device=dev) + sign).view(torch.float32)
            y = torch.sqrt(((1.0 - r) * (r + 1.0)).double()).float()
            check(faces_equal(fk.math_probe(r, y)[1], torch.atan2(y, r)),
                  f"atan2f differs from torch.atan2 from bits {lo + sign}")
            held += r.numel()
    g = torch.Generator(device=dev).manual_seed(23)
    bits = torch.randint(-2**31, 2**31 - 1, (2, 1 << 24), generator=g,
                         device=dev, dtype=torch.int64).to(torch.int32)
    x, y = bits.view(torch.float32)
    c, t = fk.math_probe(x, y)
    check(faces_equal(c, torch.cos(x)) and faces_equal(t, torch.atan2(y, x)),
          "cosf / atan2f differ from torch's on random float32 pairs")
    return held + 2 * x.numel()


def faces_edge_cases(dev):
    """F1's and F2's edge inputs as (form, args) of their launches:
    F1 on zero, isotropic, rank-1 and rank-2 covariances, -0.0
    off-diagonals around a negative eigenvalue, NaN and inf entries, tiny
    and huge scales, each kind alone (V = 1) and mixed (4 x 2000); F2's
    two forms at V = 1, one-voxel faces, one face of every voxel (V =
    40000: the rows do not fit in shared memory), labels past V, every
    valid row labelled V or above, negative labels (some below -2^31),
    labels in sorted runs from the first row (a label that starts where no
    power of two lies between its length and its end keeps a -0.0 sum), V
    = 16384 and 40000,
    -0.0, NaN and -NaN sources, counts of 0 (a negative coordinate times w
    = 0 is -0.0) and invalid rows."""
    import numpy as np
    import torch

    from fccf_pcr_torch.ops import faces_kernels as fk

    rng = np.random.default_rng(23)
    cases = []

    def covariances(n, kinds=None):
        R = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
        ev = rng.uniform(0.01, 1.0, (n, 3))
        ev[: n // 2, 0] = rng.uniform(1e-6, 1e-3, n // 2)
        cov = np.einsum("nij,nj,nkj->nik", R, ev, R).astype(np.float32)
        u = rng.normal(size=(n, 3)).astype(np.float32)
        w = rng.normal(size=(n, 3)).astype(np.float32)
        if kinds is None:
            kinds = rng.integers(0, 9, n)
        for i in range(n):
            k = kinds[i]
            if k == 0:
                cov[i] = 0.0
            elif k == 1:
                cov[i] = np.eye(3, dtype=np.float32) * np.float32(0.7)
            elif k == 2:
                cov[i] = np.outer(u[i], u[i])
            elif k == 3:
                cov[i] = np.outer(u[i], u[i]) + np.outer(w[i], w[i])
            elif k == 4:
                cov[i] = np.diag(rng.uniform(-1, 1, 3)).astype(np.float32)
                cov[i][~np.eye(3, dtype=bool)] = -0.0
            elif k == 5:
                cov[i] *= np.float32(10.0 ** rng.choice([-30, -8, 8, 20]))
            elif k == 6:
                cov[i].flat[rng.integers(0, 9)] = rng.choice(
                    [np.nan, np.inf, -np.inf])
        return cov

    def plane(B, V, kinds=None):
        cov = covariances(B * V, kinds).reshape(B, V, 3, 3)
        centroid = rng.uniform(-5, 5, (B, V, 3)).astype(np.float32)
        centroid[rng.uniform(size=(B, V)) < 0.01] = np.nan
        count = rng.integers(0, 12, (B, V)).astype(np.int32)
        valid = rng.uniform(size=(B, V)) < 0.8
        gcent = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
        return ("plane_fit", tuple(torch.from_numpy(x).to(dev) for x in (
            cov, centroid, count, valid, gcent)) + (5, 0.04))

    for kind in range(9):
        cases.append(plane(1, 1, [kind]))
    cases.append(plane(4, 2000))

    def stats(B, V, kind):
        valid = rng.uniform(size=(B, V)) < 0.85
        if kind == "random":
            labels = np.minimum(rng.integers(0, max(V // 7, 1), (B, V)),
                                np.arange(V))
        elif kind == "singletons":
            labels = np.broadcast_to(np.arange(V), (B, V)).copy()
        elif kind == "one":
            labels = np.zeros((B, V), np.int64)
            valid[:] = True
        elif kind in ("negative", "below"):
            labels = rng.integers(-V, V, (B, V))
            if kind == "below":
                labels[:, ::13] -= 2**33
        elif kind == "past":
            labels = rng.integers(V, 3 * V, (B, V))
        elif kind == "runs":
            cuts = np.cumsum(rng.integers(1, 71, V))
            labels = np.broadcast_to(np.searchsorted(
                cuts, np.arange(V), side="right"), (B, V)).copy()
            valid[:] = True
        else:
            labels = rng.integers(0, 2 * V, (B, V))
        labels = np.where(valid, labels, 2**30).astype(np.int64)
        count = rng.integers(0, 40, (B, V)).astype(np.int32)
        centroid = rng.normal(size=(B, V, 3)).astype(np.float32)
        normal = rng.normal(size=(B, V, 3)).astype(np.float32)
        for x in (centroid, normal):
            x[rng.uniform(size=x.shape) < (0.5 if kind == "runs"
                                           else 0.05)] = -0.0
            x[rng.uniform(size=x.shape) < 0.002] = np.nan
        values = centroid[..., 0].copy()
        values[..., ::2 if kind == "runs" else 5] = -0.0
        values[..., 1::97] = -np.nan
        t = [torch.from_numpy(x).to(dev) for x in (
            labels, valid, count, centroid, normal, values)]
        return [("face_stats", (t[0], t[1], t[2], t[3], t[4], V)),
                ("values", (t[5], t[0], t[1], V))]

    for B, V, kind in ((1, 1, "random"), (1, 1, "one"), (3, 300, "singletons"),
                       (2, 300, "wide"), (2, 1537, "random"),
                       (2, 700, "negative"), (2, 700, "below"),
                       (2, 300, "past"),
                       (2, 2100, "runs"), (4, 12000, "random"),
                       (2, 16384, "random"), (1, 40000, "one"),
                       (1, 40000, "singletons"), (1, 40000, "runs")):
        cases += stats(B, V, kind)
    return cases


def faces_order_equal(form, a, what):
    """F2's own stable order of one F2 input's labels
    (faces_kernels.label_order) against torch.sort(seg, stable=True): the
    same seg_s and order; refused (ValueError) where a valid label is
    below -2^31, which F2's 32-bit keys do not order. Returns 1 for an F2
    input held to torch.sort, 0 otherwise."""
    import torch

    from fccf_pcr_torch.ops import faces_kernels as fk

    if form == "plane_fit":
        return 0
    labels, valid = (a[0], a[1]) if form == "face_stats" else (a[1], a[2])
    if bool((valid & (labels < -2**31)).any()):
        try:
            fk.label_order(labels, valid, a[-1])
        except ValueError:
            return 0
        check(False, f"{what}: label_order took a label below -2^31")
    got = fk.label_order(labels, valid, a[-1])
    want = fk.sorted_labels(labels, valid, a[-1])
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{what}: F2's order differs from torch.sort(stable=True)")
    return 1


def faces_replays(cases):
    """Every F1 and F2 form of ``cases`` called twice inside one captured
    CUDA graph, the graph replayed twice: each replay's outputs equal the
    eager calls'. Returns the kernel calls the graph holds."""
    import torch

    forms = [faces_forms(form, a)[0] for form, a in cases]
    want = [f() for f in forms]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [f() for f in forms for _ in range(2)]
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for i, w in enumerate(want):
            for o in outs[2 * i:2 * i + 2]:
                check(faces_equal(o, w), f"{cases[i][0]} called twice in a "
                      "replayed graph differs from its eager call")
    del g
    return len(outs)


def phase_faces(steps, eager, dev):
    """Phase 23: F1 and F2 against their plain versions on the card, bit
    for bit: F1's math functions against torch's (``faces_math_sweep``);
    every F1 and F2 input of the heritage and office batch-8 eager steps
    (``record_faces``: one F1 call, two face statistics and one roughness
    sum a step) and the edge cases (``faces_edge_cases``); each form
    twice in one replayed graph; at each step's inputs the device time a
    call (``graph_ms``) of the kernel, the plain version and the library
    call beside the bound."""
    shape = {"plane_fit": lambda a: tuple(a[3].shape),
             "face_stats": lambda a: tuple(a[0].shape),
             "values": lambda a: tuple(a[1].shape)}
    out = {"F1": {}, "F2": {}, "edge_cases": 0, "differ": 0, "orders": 0,
           "math_inputs": faces_math_sweep(dev)}
    for name in ("heritage", "office"):
        fn, args = steps[name]
        calls = record_faces(eager[name], args)
        forms = collections.Counter(form for form, _ in calls)
        check(forms == {"plane_fit": 1, "face_stats": 2, "values": 1},
              f"{name}: the eager step's F1 / F2 calls are {dict(forms)} "
              "(want one F1, two face statistics, one roughness sum)")
        for kernel in ("F1", "F2"):
            out[kernel][name] = dict(calls=[], ms=0.0, plain_ms=0.0,
                                     library_ms=0.0, bound_ms=0.0)
        for form, a in calls:
            kernel = "F1" if form == "plane_fit" else "F2"
            k, plain, lib = faces_forms(form, a)
            ok = faces_equal(k(), plain())
            out["differ"] += not ok
            check(ok, f"{name}: {kernel} {form} {shape[form](a)} differs "
                  "from plain")
            out["orders"] += faces_order_equal(form, a, f"{name}: {form}")
            bound_ms, bound_by = faces_bound(form, a)
            # eigh reads its error flags back, which a capture refuses: it
            # is timed by CUDA events around 5 calls instead.
            c = dict(what=form, shape=shape[form](a), ms=graph_ms(k),
                     plain_ms=graph_ms(plain),
                     library_ms=(cuda_ms(lib, 5) if kernel == "F1"
                                 else graph_ms(lib)),
                     library_calls=getattr(lib, "calls", 1),
                     bound_ms=bound_ms, bound_by=bound_by)
            t = out[kernel][name]
            t["calls"].append(c)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                t[key] += c[key]
            t["bound_by"] = bound_by
    cases = faces_edge_cases(dev)
    for form, a in cases:
        k, plain, _ = faces_forms(form, a)
        ok = faces_equal(k(), plain())
        out["differ"] += not ok
        check(ok, f"edge case: {form} {shape[form](a)} differs from plain")
        out["orders"] += faces_order_equal(form, a, f"edge case {form} "
                                           f"{shape[form](a)}")
        out["edge_cases"] += 1
    out["replayed_calls"] = faces_replays([
        (form, a) for form, a in cases if shape[form](a)[-1] in (1, 2000)
        or (form != "plane_fit" and shape[form](a)[-1] in (12000, 40000))])
    return out


# Operations of H1 and H2 (csrc/hypotheses.cu), a 3-entry sum as 2 adds,
# sqrtf, acosf, a clamp, a compare and a division as one each: a base's
# angle, gates and type (30); an entry of the B x B mask (5); a match's
# prelude: R = R2 R1 with R1 m2, the normals of n1 x m1 and n2 x m2r, the
# two offsets, the fallback translation and the quaternion (384); a
# source face's test, offset d13 and P = inv(A^T A) A^T (154); a target
# face's rotation, test and offset d23 (51); a slot's angle test (12); a
# kept hit's translation (16). H2's bound counts the work its function
# needs (``hyp_slots_ops``): a prelude and F target faces a valid match, F
# source faces once for each distinct source base (pair, i1, j1) among
# them, the angle test of each slot whose two faces pass, in slot order
# up to the one that makes more than PER_MATCH valid. PR 18's count, a
# valid match's F source faces and every slot of its rounds of 32 until
# more than PER_MATCH are valid (``hyp_slots_tested``), stays beside it as
# the yardstick its times and later ones share.
HYP_BASE_OPS = 30
HYP_MASK_OPS = 5
HYP_MATCH_OPS = 384
HYP_SOURCE_OPS = 154
HYP_TARGET_OPS = 51
HYP_SLOT_OPS = 12
HYP_HIT_OPS = 16
# The kernels of the hypotheses stage by the form phase 24 names them in,
# and their plain versions in ops/hypotheses_kernels.py.
HYP_FORMS = {"bases": "bases_plain", "matches": "matches_plain",
             "slots": "slots_plain", "emit": "emit_plain"}
# Phase 24's kernels and their names in KERNELS.
HYP_PTXAS = {"H1": "hyp_matches", "H2": "hyp_slots", "H3": "hyp_emit",
             "bases": "hyp_bases"}


def cloned(x):
    """A copy of ``x``: tensors cloned, tuples and NamedTuples of them
    copied item by item, anything else as it is."""
    import torch

    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        items = [cloned(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def record_hypotheses(eager, args):
    """The inputs of the H1, H2 and H3 calls of one eager step, in order:
    (form, args) with form "matches", "slots" or "emit" and args those of
    its kernel's launch."""
    import torch

    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    seen = []
    kept = {form: getattr(hk, f"_launch_{form}")
            for form in ("matches", "slots", "emit")}

    def recorded(form):
        def run(*a):
            seen.append((form, cloned(a)))
            return kept[form](*a)
        return run

    with swapped(hk, **{f"_launch_{form}": recorded(form) for form in kept}):
        eager(*args)
    torch.cuda.synchronize()
    return seen


def hyp_forms(form, a):
    """(kernel, plain) calls of one input of H1 ("matches"), H2 ("slots"),
    H3 ("emit") or the bases form ("bases"), in their launch's
    signature."""
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    return (lambda: getattr(hk, f"_launch_{form}")(*a),
            lambda: getattr(hk, HYP_FORMS[form])(*a))


def hyp_equal(form, got, want):
    """A hypotheses kernel's outputs against its plain version's, bitwise
    and NaN-aware; H2's translations only where its hits are kept (a
    row's others are no output)."""
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    if form == "slots":
        got = hk.kept_hits(got)
    return faces_equal(got, want)


def tensor_bytes(x):
    """The bytes of the tensors in ``x`` (a tensor or nested tuples)."""
    import torch

    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, tuple):
        return sum(tensor_bytes(v) for v in x)
    return 0


def hyp_slots_tested(f1, f2, m, params, per_match_hits):
    """The (s, t) slots H2 tests on these inputs: for each valid match,
    its rounds of 32 slots in slot order up to the first after which
    more than PER_MATCH slots are valid (``match_all``'s pair tests)."""
    import torch

    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    _, _, pair_ok, _, _ = hk.match_all(f1, f2, m.i1, m.j1, m.i2, m.j2,
                                       params)
    F = f1.valid.shape[-1]
    K = min(per_match_hits, F * F + 1)
    FF = F * F
    rounds = -(-FF // 32)
    ok = torch.nn.functional.pad(pair_ok.flatten(-2), (0, rounds * 32 - FF))
    done = torch.cumsum(ok.reshape(ok.shape[:-1] + (rounds, 32)).sum(-1),
                        -1)
    # A round runs while the valid slots before it are at most K.
    ran = torch.cat([torch.ones_like(done[..., :1], dtype=torch.bool),
                     done[..., :-1] <= K], -1).sum(-1)
    tested = torch.clamp(ran * 32, max=FF)
    return int(torch.where(m.valid, tested, 0).sum())


def hyp_slots_ops(f1, f2, m, params, per_match_hits):
    """The operations H2's function needs on these inputs (HYP_*_OPS but
    the hits'): a prelude and F target faces for each valid match, F
    source faces once for each distinct (pair, i1, j1) among them, and the
    angle test of each slot whose source and target faces both pass, in
    slot order up to the first after which more than PER_MATCH slots are
    valid (``match_all``'s pair tests; with an infinite angle limit they
    are the faces' tests alone)."""
    import dataclasses

    import torch

    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    F = f1.valid.shape[-1]
    K = min(per_match_hits, F * F + 1)
    faces = (f1, f2, m.i1, m.j1, m.i2, m.j2)
    ok = hk.match_all(*faces, params)[2].flatten(-2)
    both = hk.match_all(*faces, dataclasses.replace(
        params, third_normal_threshold=float("inf")))[2].flatten(-2)
    before = torch.cumsum(ok, -1) - ok.to(torch.int64)
    tested = torch.where(m.valid[..., None], both & (before <= K), False)
    pair = torch.arange(m.i1.numel() // m.i1.shape[-1],
                        device=m.i1.device).view(m.i1.shape[:-1] + (1,))
    base = (pair * F + m.i1) * F + m.j1
    sources = torch.unique(base[m.valid]).numel()
    valid = int(m.count.sum())
    return (valid * (HYP_MATCH_OPS + F * HYP_TARGET_OPS)
            + sources * F * HYP_SOURCE_OPS
            + int(tested.sum()) * HYP_SLOT_OPS)


def hyp_bound(form, a, out, yardstick=False):
    """The least time the card could take for one call of a hypotheses
    kernel, in ms, and what bounds it: the inputs it needs read once and
    its outputs written once (H2's kept hits only) over the memory rate,
    against its operations (HYP_*_OPS) over the float32 rate. ``out`` is
    the call's result (its data-dependent counts). H2's operations are
    ``hyp_slots_ops``', or with ``yardstick`` PR 18's count."""
    fields = {"bases": ("normal", "theta", "valid"),
              "matches": ("normal", "theta", "valid"),
              "slots": ("normal", "centroid", "point_size", "valid")}
    if form == "bases":
        faces = a[0]
        F = faces.valid.shape[-1]
        C = faces.valid.numel() // F
        nbytes = sum(tensor_bytes(getattr(faces, f)) for f in fields[form])
        ops = C * F * (F - 1) // 2 * HYP_BASE_OPS
    elif form == "matches":
        f1, f2 = a[:2]
        F = f1.valid.shape[-1]
        P = f1.valid.numel() // F
        B = F * (F - 1) // 2
        nbytes = sum(tensor_bytes(getattr(f, k)) for f in (f1, f2)
                     for k in fields[form])
        ops = P * (2 * B * HYP_BASE_OPS + B * B * HYP_MASK_OPS)
    elif form == "slots":
        f1, f2, m, params, per_match_hits = a
        F = f1.valid.shape[-1]
        nbytes = sum(tensor_bytes(getattr(f, k)) for f in (f1, f2)
                     for k in fields[form])
        nbytes += tensor_bytes((m.count, m.i1, m.j1, m.i2, m.j2))
        hits = int(out.count.sum())
        ops = hits * HYP_HIT_OPS + (
            int(m.count.sum()) * (HYP_MATCH_OPS + F * HYP_SOURCE_OPS
                                  + F * HYP_TARGET_OPS)
            + hyp_slots_tested(f1, f2, m, params, per_match_hits)
            * HYP_SLOT_OPS if yardstick else
            hyp_slots_ops(f1, f2, m, params, per_match_hits))
        nbytes += (tensor_bytes((out.quat, out.count, out.row_overflow))
                   + hits * 12)
        out = ()
    else:
        s, m = a[:2]
        emitted = int(out[4].sum())
        nbytes = tensor_bytes((s.count, s.row_overflow, m.type_, m.overflow))
        nbytes += emitted * (16 + 12)
        ops = s.count.numel()
    nbytes += tensor_bytes(tuple(out))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def acos_sweep(dev):
    """CUDA's acosf (hypotheses_kernels.acos_probe) against torch.arccos,
    bit for bit, at every float32 in [-1, 1], then 2^24 random float32 of
    any magnitude with inf, -inf, NaN and -0.0. Returns the count of
    inputs held."""
    import numpy as np
    import torch

    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    step, held = 1 << 26, 0
    one = int(np.array(1.0, np.float32).view(np.int32))
    for sign in (0, -(1 << 31)):
        for lo in range(0, one + 1, step):
            x = (torch.arange(lo, min(lo + step, one + 1), dtype=torch.int32,
                              device=dev) + sign).view(torch.float32)
            check(faces_equal(hk.acos_probe(x), torch.arccos(x)),
                  f"acosf differs from torch.arccos from bits {lo + sign}")
            held += x.numel()
    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randint(-2**31, 2**31 - 1, (1 << 24,), generator=g, device=dev,
                      dtype=torch.int64).to(torch.int32).view(torch.float32)
    x[:4] = torch.tensor([float("inf"), -float("inf"), float("nan"), -0.0])
    check(faces_equal(hk.acos_probe(x), torch.arccos(x)),
          "acosf differs from torch.arccos on random float32")
    return held + x.numel()


def hyp_faces(seed, P, F, kinds, dev):
    """P pairs of face sets (f1, f2 = f1 rotated, translated and a little
    perturbed, so bases match); ``kinds[k]`` makes pair k an edge case:
    "none" (no valid face), "zero" (every normal zero), "nan" (a NaN
    normal, centroid and point size), "one" (one valid face)."""
    import numpy as np
    import torch

    from fccf_pcr_torch.features.faces import Faces

    rng = np.random.default_rng(seed)
    f1s, f2s = [], []
    for k in range(P):
        n = int(rng.integers(max(F - 4, 2), F + 1))
        normal = rng.normal(size=(n, 3))
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        normal *= rng.uniform(0.97, 1.0, (n, 1))
        pad = F - n
        a = dict(
            centroid=np.concatenate([rng.uniform(-8, 8, (n, 3)),
                                     np.zeros((pad, 3))]),
            normal=np.concatenate([normal, np.zeros((pad, 3))]),
            point_size=np.concatenate([rng.uniform(50, 4000, n),
                                       np.zeros(pad)]),
            voxel_count=np.concatenate([np.ones(n), np.zeros(pad)]),
            theta=np.concatenate([rng.uniform(0.2, 4.0, n), np.zeros(pad)]),
            valid=np.arange(F) < n)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        th = np.deg2rad(rng.uniform(5, 40))
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        v = a["valid"][:, None]
        b = dict(a)
        b["normal"] = np.where(v, a["normal"] @ R.T + rng.normal(
            scale=0.002, size=(F, 3)), 0.0)
        b["centroid"] = np.where(v, a["centroid"] @ R.T + rng.normal(size=3),
                                 0.0)
        kind = kinds[k] if k < len(kinds) else "plain"
        if kind == "none":
            a["valid"] = np.zeros(F, bool)
        elif kind == "zero":
            a["normal"] = np.zeros((F, 3))
            b["normal"] = np.zeros((F, 3))
        elif kind == "nan":
            a["normal"][0] = np.nan
            b["centroid"][1] = np.nan
            a["point_size"][2] = np.nan
        elif kind == "one":
            a["valid"] = np.arange(F) < 1
        f1s.append(a)
        f2s.append(b)

    def stack(fs):
        dtype = dict(voxel_count=np.int32, valid=bool)
        return Faces(**{k: torch.from_numpy(np.stack([f[k] for f in fs])
                                            .astype(dtype.get(k, np.float32)))
                        .to(dev) for k in Faces._fields})
    return stack(f1s), stack(f2s)


def hyp_edge_cases(dev):
    """The stage's edge inputs: (what, f1, f2, caps)."""
    from fccf_pcr_torch import TEST_CAPS

    cases = []
    for F, K in ((16, 16), (16, 48), (5, 16), (24, 16), (24, 48),
                 (16, 300), (64, 16)):
        cases.append((f"F {F} PER_MATCH {K}", *hyp_faces(F + K, 4, F, (), dev),
                      TEST_CAPS.replace(per_match_hits=K)))
    # 4560 bases a cloud: H1's rows' ballot words past its shared memory.
    cases.append(("F 96 PER_MATCH 16", *hyp_faces(112, 2, 96, (), dev),
                  TEST_CAPS.replace(per_match_hits=16)))
    for what, over in (("M overflow", dict(max_matches=64)),
                       ("H overflow", dict(max_hypotheses=256)),
                       ("row overflow", dict(per_match_hits=2)),
                       # --caps large, and the heritage preset escalated
                       # (auto_escalation_caps doubles M, H, PER_MATCH).
                       ("--caps large", dict(max_matches=4096,
                                             max_hypotheses=16384)),
                       ("escalated heritage", dict(
                           max_matches=4096, max_hypotheses=6144,
                           per_match_hits=96)),
                       ("M 1001", dict(max_matches=1001)),
                       ("H 0", dict(max_hypotheses=0)),
                       ("H 1", dict(max_hypotheses=1))):
        cases.append((what, *hyp_faces(31, 3, 16, (), dev),
                      TEST_CAPS.replace(**over)))
    cases.append(("a pair alone", *hyp_faces(33, 1, 16, (), dev), TEST_CAPS))
    cases.append(("no valid face, zero normals, NaN entries, one face",
                  *hyp_faces(41, 4, 16, ("none", "zero", "nan", "one"), dev),
                  TEST_CAPS))
    return cases


# H2's runs of one source base (i1, j1) that phase 24 feeds it:
# ``hyp_run_matches``' kinds.
HYP_RUNS = {"across": "runs of 20, 40 and 12 (one over a chunk boundary)",
            "cut": "the count inside a run", "one": "one source base",
            "own": "a source base a match"}


def hyp_run_matches(kind, F, M, P, dev):
    """P pairs of the same M matches, whose source bases (i1, j1) run as
    ``kind`` says: "across" runs of 20, 40 (over the boundary of H2's
    chunks of 32 matches) and 12 each; "cut" the same with the count
    inside a run of 12; "one" one source base for every match; "own" a
    source base of its own for each. The target bases walk the bases in
    triu order."""
    import numpy as np
    import torch

    from fccf_pcr_torch.ops.hypotheses_kernels import Matches

    ii, jj = np.triu_indices(F, 1)
    B = len(ii)
    runs = np.repeat(np.arange(M + 2) % B, [20, 40] + [12] * M)[:M]
    src = {"one": np.full(M, 5), "own": np.arange(M) % B}.get(kind, runs)
    count = {"own": min(M, B), "cut": 20 + 40 + 2 * 12 + 5}.get(kind, M)
    tgt = np.arange(M) % B
    valid = np.arange(M) < count

    def rows(x):
        return torch.from_numpy(np.where(valid, x, 0)).to(dev).expand(
            P, M).contiguous()
    return Matches(
        count=torch.full((P,), count, dtype=torch.int32, device=dev),
        overflow=torch.zeros(P, dtype=torch.bool, device=dev),
        valid=rows(valid).bool(), i1=rows(ii[src]), j1=rows(jj[src]),
        i2=rows(ii[tgt]), j2=rows(jj[tgt]),
        type_=rows(np.zeros(M, np.int32)))


def hyp_runs_equal(dev):
    """H2 against its plain version on each kind of ``HYP_RUNS`` at
    PER_MATCH 16 and 48 (H2's hits where kept), and H3 on H2's slots
    against ``emit_plain``. Returns (cases, kernel calls held)."""
    from fccf_pcr_torch import FCCFParams
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    f1, f2 = hyp_faces(81, 2, 16, (), dev)
    calls = 0
    for kind, what in HYP_RUNS.items():
        m = hyp_run_matches(kind, 16, 128, 2, dev)
        for K in (16, 48):
            want = hk.slots_plain(f1, f2, m, FCCFParams(), K)
            got = hk._launch_slots(f1, f2, m, FCCFParams(), K)
            check(hyp_equal("slots", got, want),
                  f"H2 on {what}, PER_MATCH {K}: differs from plain")
            check(faces_equal(hk._launch_emit(got, m, 2048),
                              hk.emit_plain(want, m, 2048)),
                  f"H3 on H2's slots of {what}: differs from plain")
            calls += 2
    return len(HYP_RUNS), calls


# H3's own cases (``hyp_emit_case``), held to emit_plain and not timed:
# their counts are made up. (what, P, M, K, counts, H), H a number or
# "below" / "at" / "above" the first pair's total: the sizes of --caps
# large and of the heritage preset escalated, an M that is no multiple of
# 4 (nor of 32), H 0 and 1, no hit, one match holding every hit, a pair
# alone and the most pairs a launch takes.
HYP_EMIT_CASES = (
    ("--caps large", 8, 4096, 16, "mixed", 16384),
    ("escalated heritage", 8, 4096, 96, "mixed", 6144),
    ("M 1001", 8, 1001, 48, "mixed", "below"),
    ("H 0", 8, 2048, 48, "mixed", 0),
    ("H 1", 8, 2048, 48, "mixed", 1),
    ("H below the total", 8, 2048, 48, "mixed", "below"),
    ("H at the total", 8, 2048, 48, "mixed", "at"),
    ("H above the total", 8, 2048, 48, "mixed", "above"),
    ("no hit", 8, 2048, 48, "zero", 3072),
    ("one match holds every hit", 8, 2048, 96, "one", "at"),
    ("a pair alone", 1, 2048, 48, "mixed", "above"),
    ("65535 pairs", 65535, 8, 2, "mixed", 4),
)
# H3's timed cases besides the presets' steps: the heritage batch-8
# step's own H3 call at the hypotheses stage's capacities of --caps large
# and of the preset escalated (``hyp_timed_caps``, ``record_emit``).
HYP_EMIT_TIMED = ("--caps large", "escalated heritage")


def hyp_timed_caps(what, caps):
    """The capacities of one of ``HYP_EMIT_TIMED`` from the heritage
    preset's ``caps``: its M, H and PER_MATCH replaced by those of --caps
    large (4096, 16384, 16), or ``auto_escalation_caps`` of it (M 4096, H
    6144, PER_MATCH 96)."""
    from fccf_pcr_torch.cli import _caps_preset
    from fccf_pcr_torch.models.auto import auto_escalation_caps

    if what == "--caps large":
        large = _caps_preset("large")
        return caps.replace(max_matches=large.max_matches,
                            max_hypotheses=large.max_hypotheses,
                            per_match_hits=large.per_match_hits)
    return auto_escalation_caps(caps)


def record_emit(what, args):
    """The args of H3's launch in the heritage eager step on ``args`` (the
    heritage batch) at ``hyp_timed_caps(what)``."""
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(configs.CONFIGS["heritage"]["model"])
    calls = record_hypotheses(
        eager_step(model.params, hyp_timed_caps(what, model.caps)), args)
    forms = [form for form, _ in calls]
    check(forms == ["matches", "slots", "emit"],
          f"heritage at {what}'s capacities: the eager step's hypotheses "
          f"calls are {forms} (want one H1, H2 and H3)")
    return calls[2][1]


def hyp_emit_case(case, dev):
    """H3's inputs for one of ``HYP_EMIT_CASES``: (Slots, Matches, H).
    Counts "mixed" are about 60% zero and the others 1 to K (a step's are
    about 1 a match), "zero" none, "one" K at one match of each pair; the
    quaternions, translations and types random; rows over PER_MATCH at
    0.1% in every pair but the first, and pair 1's matches over M."""
    import numpy as np
    import torch

    from fccf_pcr_torch.ops.hypotheses_kernels import Matches, Slots

    what, P, M, K, counts, H = case
    rng = np.random.default_rng(M + K + P)
    if counts == "zero":
        c = np.zeros((P, M), np.int64)
    elif counts == "one":
        c = np.zeros((P, M), np.int64)
        c[np.arange(P), rng.integers(0, M, P)] = K
    else:
        c = np.where(rng.uniform(size=(P, M)) < 0.6, 0,
                     rng.integers(1, K + 1, (P, M)))
    total0 = int(c[0].sum())
    H = {"below": total0 // 2 + 1, "at": total0,
         "above": total0 + 37}.get(H, H)
    rows = rng.uniform(size=(P, M)) < 0.001
    rows[0] = False

    def dev_(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    s = Slots(quat=dev_(rng.normal(size=(P, M, 4)), torch.float32),
              t=dev_(rng.normal(size=(P, M, K, 3)), torch.float32),
              count=dev_(c, torch.int32), row_overflow=dev_(rows))
    idx = torch.zeros((P, M), dtype=torch.int64, device=dev)
    m = Matches(count=torch.full((P,), M, dtype=torch.int32, device=dev),
                overflow=dev_(np.arange(P) == 1),
                valid=torch.ones((P, M), dtype=torch.bool, device=dev),
                i1=idx, j1=idx, i2=idx, j2=idx,
                type_=dev_(rng.integers(0, 3, (P, M)), torch.int32))
    return s, m, H


def hyp_emit_equal(dev):
    """H3 against ``emit_plain`` on each of ``HYP_EMIT_CASES``, bit for
    bit. Returns the cases."""
    for case in HYP_EMIT_CASES:
        k, plain = hyp_forms("emit", hyp_emit_case(case, dev))
        check(hyp_equal("emit", k(), plain()), f"H3 on {case[0]} "
              f"{case[1:]}: differs from plain")
    return len(HYP_EMIT_CASES)


def hyp_stage_equal(what, f1, f2, caps):
    """The bases form, H1, H2 and H3 against their plain versions on one
    case, each on the same inputs, bit for bit (``hyp_equal``), H3 also on
    H2's own slots; then the stage through the kernels against the plain
    chain. Returns the kernel calls held."""
    from fccf_pcr_torch import FCCFParams
    from fccf_pcr_torch.hypotheses.transforms import generate_hypotheses
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    def held(form, *a):
        k, plain = hyp_forms(form, a)
        want, got = plain(), k()
        check(hyp_equal(form, got, want), f"edge case {what}: {form} "
              "differs from plain")
        return want, got

    params = FCCFParams()
    for f in (f1, f2):
        held("bases", f, params)
    m, _ = held("matches", f1, f2, params, caps.max_matches)
    sl, ksl = held("slots", f1, f2, m, params, caps.per_match_hits)
    final, _ = held("emit", sl, m, caps.max_hypotheses)
    check(faces_equal(hk._launch_emit(ksl, m, caps.max_hypotheses), final),
          f"edge case {what}: H3 on H2's slots differs from plain")
    got = generate_hypotheses(f1, f2, params, caps)
    check(faces_equal(tuple(got), final), f"edge case {what}: the stage "
          "through H1-H3 differs from the plain chain")
    return 9


def hyp_lane_alone(dev):
    """A pair alone against the same pair in a batch of 8, through the
    kernels at heritage-like capacities: every field bitwise equal."""
    from fccf_pcr_torch import FCCFParams, TEST_CAPS
    from fccf_pcr_torch.features.faces import Faces
    from fccf_pcr_torch.hypotheses.transforms import generate_hypotheses

    caps = TEST_CAPS.replace(max_matches=2048, max_hypotheses=3072,
                             per_match_hits=48)
    f1, f2 = hyp_faces(51, 8, 16, ("plain", "nan", "zero", "one"), dev)
    batch = generate_hypotheses(f1, f2, FCCFParams(), caps)
    for k in range(8):
        alone = generate_hypotheses(Faces(*(x[k:k + 1] for x in f1)),
                                    Faces(*(x[k:k + 1] for x in f2)),
                                    FCCFParams(), caps)
        check(faces_equal(tuple(x[0] for x in alone),
                          tuple(x[k] for x in batch)),
              f"hypotheses: pair {k} alone differs from its row of 8")
    return 8


def hyp_replays(cases):
    """The stage (H1, H2, H3) of each case called twice inside one captured
    CUDA graph, the graph replayed twice: each replay's outputs equal the
    eager calls'. Returns the kernel calls the graph holds."""
    import torch

    from fccf_pcr_torch import FCCFParams
    from fccf_pcr_torch.hypotheses.transforms import generate_hypotheses

    def run(f1, f2, caps):
        return tuple(generate_hypotheses(f1, f2, FCCFParams(), caps))

    want = [run(f1, f2, caps) for _, f1, f2, caps in cases]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [run(f1, f2, caps) for _, f1, f2, caps in cases
                for _ in range(2)]
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for i, w in enumerate(want):
            for o in outs[2 * i:2 * i + 2]:
                check(faces_equal(o, w), f"hypotheses {cases[i][0]} called "
                      "twice in a replayed graph differs from its eager call")
    del g
    return 3 * len(outs)


def phase_hypotheses(steps, eager, dev):
    """Phase 24: the hypotheses stage's kernels against their plain
    versions on the card, bit for bit: acosf against torch.arccos
    (``acos_sweep``); every H1, H2 and H3 input of the heritage and
    office batch-8 eager steps (``record_hypotheses``: one call each a
    step) and the bases form on the steps' 2P face sets; the edge cases
    (``hyp_edge_cases``), a pair alone against a batch of 8
    (``hyp_lane_alone``) and the stage twice in one replayed graph
    (``hyp_replays``); at each step's inputs the device time a call
    (``graph_ms``) of the kernel and the plain version beside the bound;
    so too H3 on the heritage step's own call at the capacities of each
    of ``HYP_EMIT_TIMED`` (``record_emit``)."""
    import torch

    names = {"matches": "H1", "slots": "H2", "emit": "H3", "bases": "bases"}
    out = {k: {} for k in names.values()}
    out.update(edge_calls=0, differ=0, acos_inputs=acos_sweep(dev))
    for name in ("heritage", "office"):
        fn, args = steps[name]
        calls = record_hypotheses(eager[name], args)
        forms = [form for form, _ in calls]
        check(forms == ["matches", "slots", "emit"],
              f"{name}: the eager step's hypotheses calls are {forms} (want "
              "one H1, H2 and H3)")
        f1, f2 = calls[0][1][:2]
        both = type(f1)(*(torch.cat([x, y]) for x, y in zip(f1, f2)))
        calls.append(("bases", (both, calls[0][1][2])))
        for form, a in calls:
            kernel = names[form]
            k, plain = hyp_forms(form, a)
            got, want = k(), plain()
            ok = hyp_equal(form, got, want)
            out["differ"] += not ok
            check(ok, f"{name}: {kernel} differs from plain")
            bound_ms, bound_by = hyp_bound(form, a, want)
            shape = tuple((a[2].valid if form == "slots" else a[0].count
                           if form == "emit" else a[0].valid).shape)
            out[kernel][name] = dict(
                shape=shape, ms=graph_ms(k), plain_ms=graph_ms(plain),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
            if form == "slots":
                ys_ms, ys_by = hyp_bound(form, a, want, yardstick=True)
                out[kernel][name].update(
                    yardstick_ms=ys_ms, yardstick_by=ys_by,
                    matches=int(a[2].count.sum()),
                    hits=int(want.count.sum()),
                    row_overflows=int(want.row_overflow.sum()))
            elif form == "emit":
                out[kernel][name]["hypotheses"] = int(want[4].sum())
    out["emit_timed"] = {}
    for what in HYP_EMIT_TIMED:
        a = record_emit(what, steps["heritage"][1])
        k, plain = hyp_forms("emit", a)
        want = plain()
        ok = hyp_equal("emit", k(), want)
        out["differ"] += not ok
        check(ok, f"heritage at {what}'s capacities: H3 differs from plain")
        bound_ms, bound_by = hyp_bound("emit", a, want)
        out["emit_timed"][what] = dict(
            shape=tuple(a[0].t.shape[:3]), H=a[2],
            hits=int(a[0].count.clamp(0, a[0].t.shape[2]).sum()),
            hypotheses=int(want[4].sum()), ms=graph_ms(k),
            plain_ms=graph_ms(plain), bound_ms=bound_ms, bound_by=bound_by)
    cases = hyp_edge_cases(dev)
    for what, f1, f2, caps in cases:
        out["edge_calls"] += hyp_stage_equal(what, f1, f2, caps)
    out["edge_cases"] = len(cases)
    runs, calls = hyp_runs_equal(dev)
    out["edge_cases"] += runs
    out["edge_calls"] += calls
    emits = hyp_emit_equal(dev)
    out["edge_cases"] += emits
    out["edge_calls"] += emits
    out["lane_alone"] = hyp_lane_alone(dev)
    out["replayed_calls"] = hyp_replays(cases[:3] + cases[-1:])
    return out


# Operations of V1 (csrc/fine.cu), a floor, a cast, a compare and a select
# as one each: for a (candidate, valid target point) the transform (9
# products, 9 adds), the cells (3 products, floors and casts) and the
# window (6 compares); for a key in the window besides, the packing (3
# ands, 2 shifts, 2 ors), a step of the binary search (a compare and a
# select) for each of ceil(log2(S + 1)) steps over the S occupied keys a
# block holds, and the count. Of V2: a slot's place (2 adds) for each occupied
# slot; a live slot's value (the conversion, a subtraction, an add, min,
# max, the clamp, a product, a division) and its add into the sum; an add
# a point of the mask's count, and the score's add, clamp and division.
FINE_POINT_OPS = 33
FINE_KEY_OPS = 8
FINE_STEP_OPS = 2
FINE_SLOT_OPS = 2
FINE_LIVE_OPS = 9
FINE_SCORE_OPS = 3
# fine_bound's search: a binary search over every ceil(Vf / 32768)-th
# occupied key.
FINE_TABLE_SAMPLE = 32768
# Phase 25's kernel by the form it names it in.
FINE_FORMS = {"join": "V"}
# Phase 25's edge cases timed besides the steps' inputs: the sizes that
# take clusters of 8 blocks and the scratch.
FINE_TIMED = ("escalated auto", "large caps")


def record_fine(eager, args):
    """The inputs of the join's calls of one eager step, in order: (form,
    args) with form "join" and args those of its launch."""
    import torch

    from fccf_pcr_torch.ops import fine_kernels as fnk

    seen = []
    kept = fnk._launch_join

    def recorded(*a):
        seen.append(("join", cloned(a)))
        return kept(*a)

    with swapped(fnk, _launch_join=recorded):
        eager(*args)
    torch.cuda.synchronize()
    return seen


def fine_forms(form, a):
    """(kernel, plain) calls of one input of the join, in its launch's
    signature."""
    from fccf_pcr_torch.ops import fine_kernels as fnk

    return (lambda: fnk._launch_join(*a), lambda: fnk.join_plain(*a[:5]))


def fine_bound(form, a, out):
    """The least time the card could take for one call of V1 or V2, in ms,
    and what bounds it. The bytes of the function the two make together:
    V1 reads the candidates' poses (12 floats each), the valid points,
    the mask, the occupied slots' keys and the window once; V2 the
    occupied slots' counts, n_src and the mask once and writes the scores
    once (the counters between them are no input or output of the join);
    against their operations (FINE_*_OPS) on this call's data. ``out`` is
    the plain version's result. Returns (ms, bound_by, details)."""
    import torch

    from fccf_pcr_torch.ops import fine_kernels as fnk

    if form == "lookup":
        T, table, pts, mask, params = a
        P = mask.numel() // mask.shape[-1]
        C, Vf = T.shape[-3], table.keys.shape[-1]
        # Each pair's occupied slots, keys in the window and search steps
        # (over the occupied keys its blocks hold).
        occupied = (table.keys != fnk.SENTINEL).reshape(P, Vf).sum(-1)
        keys = fnk.candidate_keys(T, table, pts, mask, params)
        inside = (keys != fnk.SENTINEL).reshape(P, -1).sum(-1)
        stride = -(-Vf // FINE_TABLE_SAMPLE)
        steps = [math.ceil(math.log2(-(-int(r) // stride) + 1))
                 for r in occupied]
        valid = int(mask.sum())
        nbytes = (P * C * 48 + valid * 12 + mask.numel()
                  + int(occupied.sum()) * 8 + P * 24)
        ops = C * valid * FINE_POINT_OPS + sum(
            int(k) * (FINE_KEY_OPS + n * FINE_STEP_OPS)
            for k, n in zip(inside, steps))
        details = dict(points=tuple(pts.shape), valid_points=valid,
                       keys_in_window=int(inside.sum()),
                       counted=int(out[0].sum() + out[1].sum()),
                       occupied=int(occupied.sum()), search_steps=steps,
                       counter_bytes=2 * out[0].numel() * 4)
    else:
        hit, below, table, mask = a
        C = hit.shape[-2]
        occupied = int((table.keys != fnk.SENTINEL).sum())
        live = int((hit > 0).sum())
        nbytes = (occupied * 4 + table.n_src.numel() * 4 + mask.numel()
                  + out.numel() * 4)
        ops = (C * occupied * FINE_SLOT_OPS + live * FINE_LIVE_OPS
               + mask.numel() + out.numel() * FINE_SCORE_OPS)
        details = dict(live=live, occupied=occupied,
                       places=hit.shape[-1] + mask.shape[-1])
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    details.update(bytes=nbytes, ops=ops)
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (details,)


def join_bound(a):
    """The least time the card could take for one call of the join, in ms,
    and what bounds it: the larger of fine_bound's operations of the
    lookup and its bytes of the lookup and the score together (the counts
    between them are no input or output of the join). Returns (ms,
    bound_by, details)."""
    from fccf_pcr_torch.ops import fine_kernels as fnk

    T, table, pts, mask, params = a[:5]
    counts = fnk.lookup_plain(T, table, pts, mask, params)
    score = fnk.score_plain(*counts, table, mask)
    _, _, look = fine_bound("lookup", (T, table, pts, mask, params), counts)
    _, _, sc = fine_bound("score", counts + (table, mask), score)
    nbytes, ops = look["bytes"] + sc["bytes"], look["ops"]
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    details = dict(look, bytes=nbytes, ops=ops, live=sc["live"],
                   places=sc["places"])
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (details,)


def fine_edge_cases(dev):
    """tests/test_torch_fine_kernels.py's cases (``fine_case``): (what, T,
    table, tar_pts, tar_mask) on ``dev``."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_fine_kernels import FINE_CASES, fine_case

    cases = []
    for what in FINE_CASES:
        T, table, pts, mask = fine_case(what)
        cases.append((what, T.to(dev), type(table)(*(x.to(dev)
                                                     for x in table)),
                      pts.to(dev), mask.to(dev)))
    return cases


def fine_equal(what, T, table, pts, mask):
    """The join against its plain versions on one case, in the cluster
    size the wrapper picks, which must be the case's (``FINE_CLUSTERS``,
    else 1 block), then fine_verify through it against the plain chain,
    bit for bit. Returns the kernel calls held."""
    from fccf_pcr_torch import FCCFParams, TEST_CAPS
    from fccf_pcr_torch.ops import fine_kernels as fnk
    from fccf_pcr_torch.verify.fine import fine_verify
    from test_torch_fine_kernels import FINE_CLUSTERS

    params = FCCFParams()
    want = fnk.join_plain(T, table, pts, mask, params)
    K = join_cluster(table, mask)
    check(K == FINE_CLUSTERS.get(what, 1), f"edge case {what}: V takes "
          f"clusters of {K} (0: the scratch), want "
          f"{FINE_CLUSTERS.get(what, 1)}")
    check(faces_equal(fnk._launch_join(T, table, pts, mask, params), want),
          f"edge case {what}: V in clusters of {K} differs from plain")
    score, _ = fine_verify(T, table, pts, mask, params, TEST_CAPS)
    check(faces_equal(score, want), f"edge case {what}: fine_verify "
          "through V differs from the plain chain")
    return 2


def join_cluster(table, mask):
    """The cluster size the wrapper picks for the join of ``table`` and a
    cloud of ``mask``'s points (0: none holds it, the scratch)."""
    from fccf_pcr_torch.ops import fine_kernels as fnk

    return fnk.cluster_size(fnk.build(), table.keys.shape[-1],
                            mask.shape[-1])


def fine_pair_alone(a):
    """Each pair of a recorded join call alone (P = 1) against its row of
    the batch, bit for bit. Returns the pairs held."""
    from fccf_pcr_torch.ops import fine_kernels as fnk

    T, table, pts, mask, params = a[:5]
    batch = fnk._launch_join(T, table, pts, mask, params)
    for k in range(T.shape[0]):
        alone = fnk._launch_join(
            T[k:k + 1], type(table)(*(x[k:k + 1] for x in table)),
            pts[k:k + 1], mask[k:k + 1], params)
        check(faces_equal(alone[0], batch[k]),
              f"pair {k} alone differs from its row of the batch in V")
    return T.shape[0]


def fine_replays(cases):
    """fine_verify of each case called twice inside one captured CUDA
    graph, the graph replayed twice: each replay's scores equal the eager
    calls'. Returns the kernel calls the graph holds."""
    import torch

    from fccf_pcr_torch import FCCFParams, TEST_CAPS
    from fccf_pcr_torch.verify.fine import fine_verify

    def run(T, table, pts, mask):
        return fine_verify(T, table, pts, mask, FCCFParams(), TEST_CAPS)[0]

    want = [run(*c[1:]) for c in cases]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [run(*c[1:]) for c in cases for _ in range(2)]
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for i, w in enumerate(want):
            for o in outs[2 * i:2 * i + 2]:
                check(faces_equal(o, w), f"fine verify {cases[i][0]} called "
                      "twice in a replayed graph differs from its eager call")
    del g
    return len(outs)


def phase_fine(steps, eager, dev):
    """Phase 25: fine verify's join against its plain versions on the
    card, bit for bit: its input of the heritage and office batch-8 eager
    steps (``record_fine``: one call a step), each pair of it alone, the
    edge cases (``fine_edge_cases``) and fine_verify twice in one replayed
    graph (``fine_replays``); at each step's input the device time a call
    (``graph_ms``) of the kernel and the plain version beside the bound
    (``join_bound``), and the kernel's and plain version's time at the
    edge cases of FINE_TIMED."""
    from fccf_pcr_torch import FCCFParams

    out = {kernel: {} for kernel in FINE_FORMS.values()}
    out.update(edge_calls=0, differ=0, pairs_alone=0)
    for name in ("heritage", "office"):
        fn, args = steps[name]
        calls = record_fine(eager[name], args)
        forms = [form for form, _ in calls]
        check(forms == ["join"],
              f"{name}: the eager step's fine verify calls are {forms} (want "
              "one V)")
        for form, a in calls:
            kernel = FINE_FORMS[form]
            k, plain = fine_forms(form, a)
            got, want = k(), plain()
            ok = faces_equal(got, want)
            out["differ"] += not ok
            check(ok, f"{name}: {kernel} differs from plain")
            clusters = join_cluster(a[1], a[3])
            out["pairs_alone"] += fine_pair_alone(a)
            bound_ms, bound_by, details = join_bound(a)
            out[kernel][name] = dict(
                shape=tuple(a[0].shape), ms=graph_ms(k),
                plain_ms=graph_ms(plain), library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, clusters=clusters,
                **details)
    cases = fine_edge_cases(dev)
    out["timed"] = {}
    for what, *a in cases:
        out["edge_calls"] += fine_equal(what, *a)
        if what in FINE_TIMED:
            k, plain = fine_forms("join", (*a, FCCFParams()))
            out["timed"][what] = dict(
                shape=tuple(a[0].shape), points=a[3].shape[-1],
                slots=a[1].keys.shape[-1], clusters=join_cluster(a[1], a[3]),
                ms=graph_ms(k), plain_ms=graph_ms(plain))
    out["edge_cases"] = len(cases)
    out["replayed_calls"] = fine_replays(
        [c for c in cases if c[0] in ("plain", "NaN and huge T",
                                      "large table", "eight pairs",
                                      "large caps")])
    return out


def phase_graph_configs(dev, counters):
    """Every golden config's seeds as one batch through the step graph
    (make_register_fn) and the eager step in turns, every field bitwise
    equal; then the office batch of 8 over make_mesh([dev] * 2), each
    chunk a replay of its step graph, against each chunk's eager step."""
    import torch

    from fccf_pcr_torch import make_register_fn
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.parallel import mesh
    from fccf_pcr_torch.pipeline.register import RegistrationResult

    for name in PATH_CONFIGS:
        model = get_model(configs.CONFIGS[name]["model"])
        seeds = [r["seed"] for r in json.loads(GOLDEN.read_text())[
            "configs"][name]]
        args, _ = config_batch(name, seeds, model.params, model.caps, dev)
        fn = make_register_fn(model.params, model.caps, batched=True,
                              device=dev)
        turns = graph_turns(name, fn, eager_step(model.params, model.caps),
                            args)
        print(f"[graph] {name} seeds {seeds}: the step graph's every field "
              f"bitwise equal to the eager step's; wall ms in turns {turns}",
              flush=True)

    model = get_model(configs.CONFIGS["office"]["model"])
    args, _ = config_batch("office", list(range(8)), model.params,
                           model.caps, dev)
    grid = mesh.make_mesh([dev] * 2)
    split = mesh.make_sharded_register_fn(model.params, model.caps, grid)
    eager = eager_step(model.params, model.caps)

    def eager_split(*a):
        chunks = [x if isinstance(x, list) else mesh._split(x, grid)
                  for x in a]
        res = mesh._run_split(grid, lambda i: eager(*(c[i] for c in chunks)))
        return RegistrationResult(*(torch.cat(f) for f in zip(*res)))

    split(*args)  # captures the chunks' step graph
    zero_counts(counters, dev)
    turns = graph_turns(f"mesh [{dev}] * 2", split, eager_split, args)
    counts = read_counts(counters, dev)
    # three splits through the graph (graph_turns' first run and two
    # turns), a replay a chunk
    check(counts["step_graph_replays"] == 3 * 2 and counts[
        "step_graph_captures"] == 0, f"mesh [{dev}] * 2: {counts}")
    print(f"[graph] office batch 8 over make_mesh([{dev}] * 2): every field "
          f"of the split through the step graph (2 replays a split) bitwise "
          f"equal to the eager step of each chunk; wall ms in turns {turns}",
          flush=True)


def phase_profile(fn, args, eager):
    """One heritage batch-8 step through the step graph under
    utils.profiling.trace (its Chrome trace must name the propagation
    kernel, C1 (the block scan), C2, L1, F1 and F2): the device kernels of
    the replay
    and the device's busy share; then one eager step under the trace and
    a StageTimer: host time per stage (register.py's record_function
    ranges, which exist only in the eager step) and its busy share."""
    import torch

    from fccf_pcr_torch.utils.profiling import StageTimer, trace

    stages = STAGES
    ours = ("label_prop_propagate", "cluster_block_scan",
            "cluster_floor_walk", "lm_refine", "faces_plane_fit",
            "faces_segment_sum")
    for form, call in (("graph", fn), ("eager", eager)):
        call(*args)  # the step graph may have been evicted: capture it first
        torch.cuda.synchronize()
        # CUPTI can lose records (all of a capture's, at times, after the
        # card idled): a trace that misses one of ours is taken again.
        for attempt in range(5):
            timer = StageTimer()
            with tempfile.TemporaryDirectory() as logdir:
                with trace(logdir) as prof:
                    t0 = time.perf_counter()
                    with timer.stage(f"heritage batch-8 {form} step") as live:
                        live.append(call(*args))
                    wall_ms = (time.perf_counter() - t0) * 1e3
                text = pathlib.Path(prof.trace_path).read_text()
            missing = [k for k in ours if k not in text]
            if not missing:
                break
            RETAKEN[f"{form} step trace"] += 1
        check(not missing, f"the {form} step's exported trace does not name "
              f"{missing} in 5 captures")
        print(f"[profile] {form} step trace exported by "
              f"utils.profiling.trace: "
              f"{os.path.basename(prof.trace_path)}, {len(text)} bytes, "
              f"names {', '.join(ours)}", flush=True)
        if form == "eager":
            print(f"[profile] StageTimer report:\n{timer.report()}",
                  flush=True)
        # Device work = the kernels' own time (one stream, so no
        # overlap); the record_function ranges also appear on the device
        # timeline and are skipped.
        ranges = {e.name for e in prof.events() if e.is_user_annotation
                  and e.device_type != torch.autograd.DeviceType.CUDA}
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.name not in ranges]
        busy_ms = sum(e.device_time for e in kernels) / 1e3
        print(f"[profile] heritage {form} step {wall_ms:.1f} ms wall, "
              f"{len(kernels)} kernels, device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%)", flush=True)
        if form == "eager":
            for e in prof.key_averages():
                if e.key in stages and e.cpu_time_total > 0:
                    print(f"[profile] eager stage {e.key}: "
                          f"{e.cpu_time_total / 1e3:.1f} ms host-inclusive "
                          f"over {e.count} calls", flush=True)
        by_name = collections.Counter()
        calls = collections.Counter()
        for e in kernels:
            by_name[e.name] += e.device_time
            calls[e.name] += 1
        for name, us in by_name.most_common(8):
            print(f"[profile] {form} kernel {us / 1e3:.1f} ms over "
                  f"{calls[name]} launches: {name[:90]}", flush=True)
        # (its own name: the trace's check above reads ``ours`` again for
        # the eager step)
        for kname in ("label_prop_propagate_kernel",
                      "label_prop_sweep_kernel", "gather_rows",
                      "cluster_block_scan_kernel",
                      "cluster_floor_walk_kernel", "lm_refine_kernel",
                      "faces_plane_fit_kernel", "faces_segment_sum_kernel",
                      *HYP_KERNELS):
            for name, us in by_name.items():
                if kname in name:
                    print(f"[profile] {form} {kname}: {us / 1e3:.3f} ms of "
                          f"device time over {calls[name]} launches in the "
                          "step", flush=True)


def drive_path(what, fn, counters, dev, registers=True):
    """``fn()`` as a path of the port: every kernel's launch count set to
    0 just before and read just after; the path must launch the
    propagation kernel, C1 (the block scan), S1 and S2 (the scans), F1 and
    F2 (the faces stage's), and neither the one-sweep,
    the gather nor the standalone block-seed kernel, and, where it
    ``registers`` (every path but
    measure_content, which stops at the seeds), replay a step graph and
    launch H1, H2 and H3 (the hypotheses stage's), C2 (the floor walk),
    L1 (the LM) and V (fine verify's join). Returns (result, counts,
    wall s)."""
    import torch

    zero_counts(counters, dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts(counters, dev)
    check(counts["label_prop_propagate"] > 0 and counts["sweeps"] > 0,
          f"{what}: the propagation kernel was not launched")
    for k in ("label_prop_sweep", "gather_rows", "cluster_block_seeds"):
        check(counts[k] == 0, f"{what}: the {k} kernel was launched")
    for k in ("cluster_block_scan", "scan_int", "prefix_sum16",
              "faces_plane_fit", "faces_segment_sum"):
        check(counts[k] > 0, f"{what}: the {k} kernel was not launched")
    for k in ("step_graph_replays", "cluster_floor_walk", "lm_refine",
              "hyp_matches", "hyp_slots", "hyp_emit", "fine_join"):
        check(counts[k] > 0 or not registers, f"{what}: no {k}")
    return out, counts, secs


def eval_line(r):
    """One evaluate_config summary, as its table row reads. With
    escalate_caps="auto" every seed flagged before escalation re-runs, so
    n_escalated is that count (evaluate_config prints their bits to
    stderr)."""
    pps = f"{r['pairs_per_s']:.2f}" if r["pairs_per_s"] else "-"
    return (f"success {100 * r['success']:.0f}% (fails {r['fail_seeds']}), "
            f"RRE mean/med/p95 {r['rre_mean']:.4f} / {r['rre_med']:.4f} / "
            f"{r['rre_p95']:.4f} deg, RTE {r['rte_mean']:.5f} / "
            f"{r['rte_med']:.5f} / {r['rte_p95']:.5f} m, flagged before "
            f"escalation {r['n_escalated']} (re-run), after "
            f"{r['flagged_seeds']}, {pps} pairs/s")


def phase_accuracy(dev, counters, smi):
    """evaluate_config at every non-sequence config, EVAL_SEEDS seeds at
    batch 8 with escalate_caps="auto": 100% success; seeds 0-3 within
    tests/golden/pipeline.json's bands of their golden rows (the golden
    transform's errors against ground truth, 0.1 deg / 0.02 m, status
    equal). Returns the results by config and the path's launch counts."""
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.evaluation.evaluate import evaluate_config

    golden = json.loads(GOLDEN.read_text())["configs"]
    results, launches = {}, collections.Counter()
    for name in PATH_CONFIGS:
        r, counts, secs = drive_path(
            f"evaluate {name}", lambda: evaluate_config(
                name, configs.CONFIGS[name], EVAL_SEEDS, 8,
                escalate_caps="auto", device=dev), counters, dev)
        launches.update(counts)
        results[name] = r
        print(f"[accuracy] {name}, {EVAL_SEEDS} seeds at batch 8, "
              f"--escalate-caps auto: {eval_line(r)}; {secs:.1f} s wall; "
              f"launches {counts} | {smi}", flush=True)
        check(r["success"] == 1.0, f"evaluate {name}: success "
              f"{r['success']} (fails {r['fail_seeds']})")
        for row in golden[name]:
            got = r["seed_rows"][row["seed"]]
            d = (abs(got["rre"] - row["rre_gt"]), abs(got["rte"] - row["rte_gt"]))
            check(d[0] < 0.1 and d[1] < 0.02 and got["status"] == row["status"],
                  f"evaluate {name} seed {row['seed']}: {got} against the "
                  f"golden row's {row['rre_gt']} deg / {row['rte_gt']} m, "
                  f"status {row['status']}")
        print(f"[accuracy] {name} seeds 0-3 within the golden bands of their "
              f"rows (errors against ground truth within 0.1 deg / 0.02 m, "
              f"status equal)", flush=True)
    return results, launches


def phase_escalation(dev, counters, smi):
    """An office-preset evaluation whose scenes hold more content than the
    preset's residual and fine-voxel bounds (ESCALATING: the office
    scenes with 3 cm noise): plain, every flagged seed's bits printed;
    then with escalate_caps="auto" (n_escalated >= 1; the re-run takes
    the two-key wide_extent voxelization at V = 1536), its escalated rows
    bitwise equal to the same seeds registered as a direct batch at the
    escalation capacities; then run_sweep(escalate_caps=...), whose
    escalated records carry the direct batch's transforms bit for bit.
    Returns the path's launch counts."""
    import numpy as np
    import torch

    from fccf_pcr_torch import make_register_fn, registration_errors
    from fccf_pcr_torch import pre_downsample
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.evaluation.evaluate import evaluate_config
    from fccf_pcr_torch.io import synthetic
    from fccf_pcr_torch.models.auto import auto_escalation_caps
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.pipeline.sweep import (ESCALATION_STATUS_MASK,
                                               run_sweep)

    launches = collections.Counter()
    seeds = list(range(8))
    tight, counts, secs = drive_path("escalation (tight)", lambda: evaluate_config(
        "office-noisy", ESCALATING, len(seeds), 8, device=dev), counters, dev)
    launches.update(counts)
    flagged = {s: st for s, st in tight["flagged_seeds"].items()
               if st & ESCALATION_STATUS_MASK}
    print(f"[escalation] office preset, office scenes at 3 cm noise, "
          f"{len(seeds)} seeds, tight: {len(flagged)} flagged, status bits "
          f"by seed {flagged}; {secs:.1f} s wall", flush=True)
    check(flagged, "escalation: no seed flagged at the office preset")
    esc, counts, secs = drive_path("escalation", lambda: evaluate_config(
        "office-noisy", ESCALATING, len(seeds), 8, escalate_caps="auto",
        device=dev), counters, dev)
    launches.update(counts)
    print(f"[escalation] --escalate-caps auto: {eval_line(esc)}; "
          f"{secs:.1f} s wall; launches {counts} | {smi}", flush=True)
    check(esc["n_escalated"] == len(flagged) >= 1,
          f"escalation: n_escalated {esc['n_escalated']}, flagged "
          f"{len(flagged)}")

    # The flagged seeds as one direct batch at the escalation capacities,
    # padded with copies of the last seed, as evaluate_config's chunk.
    model = get_model(ESCALATING["model"])
    caps = auto_escalation_caps(model.caps)
    check(caps.wide_extent and caps.max_voxels == 1536,
          f"escalation caps {caps}: not the two-key path at V = 1536")
    chunk = sorted(flagged)
    chunk += [chunk[-1]] * (8 - len(chunk))
    pairs = configs.pairs_for_config(ESCALATING, chunk)
    raw = caps.raw_points
    pre_ovf = np.array([len(s) > raw or len(t) > raw for s, t, _ in pairs])
    sides = []
    for side in range(2):
        p, m = zip(*(synthetic.pad_points(pair[side], raw) for pair in pairs))
        pts, mask, ovf = pre_downsample(np.stack(p), np.stack(m), model.params,
                                        caps, device=dev)
        pre_ovf |= ovf.cpu().numpy()
        sides += [pts, mask]
    direct = make_register_fn(model.params, caps, batched=True,
                              device=dev)(*sides)
    T_gt = np.stack([p[2] for p in pairs]).astype(np.float32)
    rre, rte = registration_errors(direct.transform,
                                   torch.from_numpy(T_gt).to(dev))
    for k, s in enumerate(sorted(flagged)):
        # evaluate_config folds preprocess truncation into bit 1
        want = {"rre": float(rre[k]), "rte": float(rte[k]),
                "status": int(direct.status[k]) | int(pre_ovf[k])}
        check(esc["seed_rows"][s] == want, f"escalation seed {s}: row "
              f"{esc['seed_rows'][s]} differs from the direct batch's {want}")
    print(f"[escalation] the {len(flagged)} escalated rows bitwise equal to a "
          f"direct batch at the escalation caps (max_residual "
          f"{caps.max_residual}, max_fine_voxels {caps.max_fine_voxels}, "
          f"wide_extent {caps.wide_extent}, V {caps.max_voxels})", flush=True)

    all_pairs = configs.pairs_for_config(ESCALATING, seeds)
    (records, summary), counts, secs = drive_path("escalation sweep", lambda: (
        run_sweep([p[:2] for p in all_pairs], model.params, model.caps,
                  batch_size=8, ground_truth=[p[2] for p in all_pairs],
                  escalate_caps=caps, device=dev)), counters, dev)
    launches.update(counts)
    check(summary["n_escalated"] == len(flagged), f"run_sweep: {summary}")
    T = direct.transform.cpu()
    for k, s in enumerate(sorted(flagged)):
        rec = records[s]
        tight_bits = rec["status_tight"] | int(rec["preprocess_overflow"])
        check(rec.get("escalated") and tight_bits == flagged[s]
              and rec["transform"] == T[k].tolist()
              and rec["status"] == int(direct.status[k]),
              f"run_sweep pair {s}: escalated record {rec} differs from the "
              "direct batch")
    print(f"[escalation] run_sweep(escalate_caps=auto_escalation_caps): "
          f"{summary['n_escalated']} records marked escalated, status_tight "
          f"as evaluated, transforms bitwise equal to the direct batch; "
          f"{secs:.1f} s wall; launches {counts}", flush=True)
    return launches


def phase_overlap(dev, counters, smi, accuracy):
    """overlap_eval.overlap_curve at OVERLAP_SEEDS seeds a point; its
    CURVE lines. The rows at overlap 1.0 equal the accuracy sweep's rows
    of the same seeds bit for bit (make_pair at overlap 1.0 is the
    default scene). Returns the path's launch counts."""
    from fccf_pcr_torch.evaluation import configs, overlap_eval

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "overlap.jsonl")
        rows, counts, secs = drive_path("overlap", lambda: (
            overlap_eval.overlap_curve(
                {n: configs.CONFIGS[n] for n in overlap_eval.CONFIGS},
                overlap_eval.OVERLAPS, OVERLAP_SEEDS, out, device=dev)),
            counters, dev)
        with open(out) as f:
            check(len(f.readlines()) == len(rows), "overlap: records missing")
    for r in rows:
        print(f"[overlap] {r['config']} overlap {r['overlap']}: "
              f"{eval_line(r)}; {r['elapsed_s']} s", flush=True)
        if r["overlap"] == 1.0:
            for s, row in r["seed_rows"].items():
                check(row == accuracy[r["config"]]["seed_rows"][s],
                      f"overlap 1.0 {r['config']} seed {s}: {row} differs "
                      "from the accuracy sweep's row")
    for line in overlap_eval.curve_lines(rows):
        print(f"[overlap] {line}", flush=True)
    print(f"[overlap] {len(rows)} points of {OVERLAP_SEEDS} seeds: "
          f"{secs:.1f} s wall; rows at overlap 1.0 equal the accuracy "
          f"sweep's; launches {counts} | {smi}", flush=True)
    return counts


def phase_twin_check(dev, counters, smi):
    """twin_production.check over the fixture's 24 pairs, one batch per
    config: every pair inside its band. Returns the path's launch
    counts."""
    from fccf_pcr_torch.evaluation import twin_production

    (rows, worst), counts, secs = drive_path(
        "twin check", lambda: twin_production.check(
            device=dev, log=lambda *a: None), counters, dev)
    check(len(rows) == 24, f"twin check: {len(rows)} pairs, not 24")
    out = [r for r in rows if not r["in_band"]]
    check(not out, f"twin check: out of band {out}")
    top = max(rows, key=lambda r: r["pipe_vs_twin"][0])
    print(f"[twin] twin_production.check: 24 pairs (office 8, structured 8, "
          f"resso 4, heritage 4) inside their bands; worst {worst[0]:.4f} deg "
          f"/ {worst[1]:.5f} m; worst rotation {json.dumps(top)}; "
          f"{secs:.1f} s wall; launches {counts} | {smi}", flush=True)
    return counts


def phase_measure(dev, counters, smi):
    """measure_pair of office seed 0 at max_voxels 4096 on the card and on
    the CPU: equal dicts; heritage seeds 0-1 at the full measurement
    capacities (V = 16384) on the card, each count at or under the
    heritage preset's capacity for it. Returns the path's launch counts
    (the card's runs)."""
    from fccf_pcr_torch.evaluation.measure_content import measurement_caps
    from fccf_pcr_torch.models.fccf import get_model

    caps = measurement_caps(4096)
    on_card, counts, secs = drive_path(
        "measure office", lambda: measure("office", 0, caps, dev), counters,
        dev, registers=False)
    t0 = time.perf_counter()
    on_cpu = measure("office", 0, caps, "cpu")
    cpu_secs = time.perf_counter() - t0
    check(on_card == on_cpu, f"measure office seed 0: card {on_card} != "
          f"CPU {on_cpu}")
    print(f"[measure] office seed 0 at max_voxels 4096: card == CPU {on_card}; "
          f"{secs:.1f} s on the card, {cpu_secs:.1f} s on the CPU", flush=True)
    launches = collections.Counter(counts)
    her = get_model("heritage").caps
    limits = {k: getattr(her, attr) for k, attr in CONTENT_CAPS.items()}
    limits["fine_span_cells"] = 1023
    for seed in (0, 1):
        got, counts, secs = drive_path(
            f"measure heritage {seed}",
            lambda: measure("heritage", seed, measurement_caps(), dev),
            counters, dev, registers=False)
        launches.update(counts)
        print(f"[measure] heritage seed {seed} at V = 16384 (count / heritage "
              f"capacity): " + ", ".join(
                  f"{k} {v} / {limits.get(k, '-')}" for k, v in got.items())
              + f"; {secs:.1f} s wall; launches {counts} | {smi}", flush=True)
        over = {k: v for k, v in got.items() if k in limits and v > limits[k]}
        check(not over, f"measure heritage seed {seed}: over the preset {over}")
    return launches


def phase_native_io():
    """make -C csrc, then the native library loads; then the CLI's --json
    record of the resso seed-0 pair written as PLY (``--batch S T``, no
    --out), with --native-io, equal (load and register times aside) to
    the same run with FCCF_IO_LIB naming no library, which warns and
    reads with the Python reader. Once at the resso preset, and once at
    tiny caps, whose raw capacity of 8192 makes the loader subsample
    both scans at load, warn and flag them."""
    from fccf_pcr_torch.io import native, ply

    t0 = time.perf_counter()
    proc = subprocess.run(["make", "-C", str(ROOT / "csrc")],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"make -C csrc failed:\n{proc.stdout}"
          f"{proc.stderr}")
    native._LIB, native._TRIED = None, False
    check(native.load_library() is not None,
          f"native library {native._lib_path()} built but not loaded")
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        src, tar, _ = scene("resso", 0)
        paths = [os.path.join(tmp, f"resso_{k}.ply") for k in "st"]
        for path, cloud in zip(paths, (src, tar)):
            ply.write_ply(path, cloud)
        none = {"FCCF_IO_LIB": os.path.join(tmp, "none.so")}
        for caps, over in (("resso", []), ("tiny", [0, 1])):
            runs = {}
            for how, env in (("native", {}), ("python", none)):
                out, err, dt = run_cli(
                    ["--batch", *paths, "--caps", caps, "--device", "cuda",
                     "--json", "--native-io"], f"{how} --caps {caps}", env)
                warned = "--native-io: the native loader is not built" in err
                check(warned == (how == "python"),
                      f"{how} --caps {caps}: fallback warning {warned}: {err}")
                rec = json.loads(out.strip().splitlines()[-1])
                runs[how] = (rec, rec.pop("time_load_s"),
                             rec.pop("time_register_s"), dt, err)
            rec, err = runs["native"][0], runs["native"][4]
            check(rec == runs["python"][0],
                  f"--native-io --caps {caps}: record differs from the "
                  f"Python reader's:\n{rec}\n{runs['python'][0]}")
            check(rec["device"] == "cuda", "--native-io record not from the card")
            check(rec["preprocess_overflow"] == over,
                  f"--caps {caps}: preprocess_overflow "
                  f"{rec['preprocess_overflow']}, expected {over}")
            for k in over:
                check(f"scan {paths[k]} has " in err
                      and "subsampled at load to 8192" in err,
                      f"--caps {caps}: no load subsampling warning: {err}")
            print(f"[native] --batch --json --caps {caps} on the resso "
                  f"seed-0 PLY pair: load --native-io {runs['native'][1]:.4f} "
                  f"s vs Python reader {runs['python'][1]:.4f} s, wall "
                  f"{runs['native'][3]:.1f} / {runs['python'][3]:.1f} s, "
                  f"records equal (status {rec['status']}, n_hyp "
                  f"{rec['n_hypotheses']}, preprocess_overflow "
                  f"{rec['preprocess_overflow']})", flush=True)
    print(f"[native] make -C csrc and load: {build_s:.1f} s", flush=True)


def main():
    sys.path.insert(0, str(ROOT))
    try:
        import numpy  # noqa: F401
        import torch

        from fccf_pcr_torch.evaluation import configs  # noqa: F401
        from fccf_pcr_torch.ops import cluster_kernels as ck
        from fccf_pcr_torch.ops import cuda_build
        from fccf_pcr_torch.ops import faces_kernels as fk
        from fccf_pcr_torch.ops import fine_kernels as fnk
        from fccf_pcr_torch.ops import gather as gt
        from fccf_pcr_torch.ops import hypotheses_kernels as hk
        from fccf_pcr_torch.ops import label_prop as lp
        from fccf_pcr_torch.ops import scan as scn
        from fccf_pcr_torch.pipeline.register import STEP
        from fccf_pcr_torch.refine import lm_kernel as lmk
    except ImportError as e:
        print(f"FAIL: cannot import the port from {ROOT}: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1

    counters = {"label_prop_propagate": (lp, "PROPAGATIONS"),
                "label_prop_sweep": (lp, "LAUNCHES"),
                "gather_rows": (gt, "LAUNCHES"),
                "cluster_block_scan": (ck, "SCANS"),
                "cluster_block_seeds": (ck, "SEEDS"),
                "cluster_floor_walk": (ck, "WALKS"),
                "lm_refine": (lmk, "LAUNCHES"),
                "scan_int": (scn, "INT_SCANS"),
                "prefix_sum16": (scn, "PREFIX_SUMS"),
                "faces_plane_fit": (fk, "PLANE_FITS"),
                "faces_segment_sum": (fk, "SEGMENT_SUMS"),
                "hyp_matches": (hk, "MATCHES"),
                "hyp_slots": (hk, "SLOTS"),
                "hyp_emit": (hk, "EMITS"),
                "hyp_bases": (hk, "BASES"),
                "fine_join": (fnk, "JOINS"),
                "step_graph_captures": (STEP, "captures"),
                "step_graph_replays": (STEP, "replays")}
    try:
        dev = torch.device("cuda:0")
        smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
        print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} nvcc: "
              f"{run([cuda_build.nvcc(), '--version'])}", flush=True)
        print(f"[env] device {torch.cuda.get_device_name(0)} "
              f"(count {torch.cuda.device_count()}) | {smi}", flush=True)

        t_start = time.perf_counter()
        secs = phase_build([lp, gt, ck, lmk, scn, fk, hk, fnk])
        print(f"[build] label_prop.cu {secs[0]:.2f} s, gather.cu {secs[1]:.2f} s, "
              f"cluster.cu {secs[2]:.2f} s, lm.cu {secs[3]:.2f} s, scan.cu "
              f"{secs[4]:.2f} s, faces.cu {secs[5]:.2f} s, hypotheses.cu "
              f"{secs[6]:.2f} s, fine.cu {secs[7]:.2f} s (in parallel, "
              f"{time.perf_counter() - t_start:.2f} s)", flush=True)
        ptxas = {"label_prop_propagate": ptxas_summary(lp, "propagate_kernel"),
                 "label_prop_sweep": ptxas_summary(lp, "sweep_kernel"),
                 "gather_rows": ptxas_summary(gt),
                 "cluster_block_scan": ptxas_summary(ck, "block_scan"),
                 "cluster_block_seeds": ptxas_summary(ck, "block_seeds"),
                 "cluster_floor_walk": ptxas_summary(ck, "floor_walk"),
                 # the registers and the scratch instantiations
                 "lm_refine": ptxas_summary(lmk, "lm_refine_kernelILb1"),
                 "lm_refine_scratch": ptxas_summary(lmk,
                                                    "lm_refine_kernelILb0"),
                 # S1's int64 sum (its other instantiations alike) and
                 # S2's launches on the moment columns
                 "scan_int": ptxas_summary(scn, "scan_tile_apply_kernelILi0Exx")
                 + " | reduce " + ptxas_summary(
                     scn, "scan_tile_reduce_kernelILi0Exx"),
                 "prefix_sum16": " | ".join(
                     f"{k} " + ptxas_summary(scn, f"prefix16_{k}_kernel"
                                             + ("" if k == "top" else
                                                "INS_7Moments"))
                     for k in ("up", "top", "down")),
                 "faces_plane_fit": ptxas_summary(fk, "plane_fit_kernel"),
                 "hyp_matches": ptxas_summary(hk, "hyp_matches_kernel"),
                 "hyp_slots": ptxas_summary(hk, "hyp_slots_kernel"),
                 "hyp_emit": ptxas_summary(hk, "hyp_emit_kernel"),
                 "hyp_bases": ptxas_summary(hk, "hyp_bases_kernel"),
                 "fine_join": ptxas_summary(fnk, "fine_join_kernel")}
        # F2's face statistics' and values' forms, 16-bit row indices in
        # shared memory (the main path's)
        f2_forms = [ptxas_summary(fk, f"segment_sum_kernelILi{form}EtLb1")
                    for form in (1, 0)]
        check(all(f2_forms), "no ptxas lines for an F2 form")
        ptxas["faces_segment_sum"] = f2_forms[0] + " | values " + f2_forms[1]
        for name, info in ptxas.items():
            check(info, f"no ptxas lines for {name}")
            print(f"[build] ptxas {name}: {info}", flush=True)

        lp_err, k1 = phase_kernel_vs_plain(lp, dev)
        print("[kernel] labels of the propagation kernel and of the host loop "
              "(K1 + P1 launches) equal to plain at V=1536, V=1000 and V=9216 "
              "(batch 2), at every edge case, at the main path's pass-1 "
              "inputs and at heritage seed 0's through measure_content "
              "(V=16384)", flush=True)
        for name, t in k1.items():
            print(f"[kernel] K1 {name} pass-1 inputs (seed 0 target, V={t['V']}, "
                  f"bound {t['bound']}): one sweep {t['sweep_ms']:.4f} ms of "
                  f"device time ({t['sweep_call_ms']:.4f} ms a call with the "
                  f"wrapper) vs plain {t['plain_sweep_ms']:.4f} ms; sweep "
                  f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
                  f"{t['normal_pairs']} pairs need the normal test, "
                  f"{t['plane_pairs']} of them the plane test, {t['ops']} "
                  f"ops; both tests on all {t['bound']}^2 pairs: "
                  f"{t['full_bound_ms'] * 1e3:.2f} us), roofline share "
                  f"{100 * t['bound_ms'] / t['sweep_ms']:.2f}%, achieved "
                  f"{t['ops'] / t['sweep_ms'] / 1e9:.3f} TFLOP/s "
                  f"| ptxas {ptxas['label_prop_sweep']} | {smi}", flush=True)
            host = t["host_loop_sweeps_ms"]
            print(f"[kernel] propagation {name} pass 1: kernel "
                  f"{t['propagate_ms']:.4f} ms device, {t['sweeps']} sweeps, "
                  f"wall {[round(x, 4) for x in t['propagate_wall_ms']]} ms "
                  f"(least {[round(x, 4) for x in t['propagate_wall_min_ms']]}"
                  f"); host loop {t['host_loop_ms']:.4f} ms device ("
                  f"{len(host)} sweeps of {[round(x, 4) for x in host]} ms), "
                  f"wall {[round(x, 4) for x in t['host_loop_wall_ms']]} ms "
                  f"(least {[round(x, 4) for x in t['host_loop_wall_min_ms']]}"
                  f"), turns kernel, loop, loop, kernel; plain "
                  f"{t['plain_ms']:.3f} ms device, {t['plain_wall_ms']:.3f} ms "
                  f"wall; sweep phase {100 * t['sweep_share']:.1f}% of the "
                  f"kernel's device time, outside it "
                  f"{t['outside_per_sweep_ms'] * 1e3:.2f} us a sweep (halving "
                  f"bound {t['halving_bound_ms'] * 1e3:.4f} us a round); "
                  f"bound {t['propagate_bound_ms'] * 1e3:.3f} us "
                  f"({t['propagate_bound_by']}; sweeps "
                  f"{[round(x * 1e3, 3) for x in t['sweep_bounds_ms']]} us) | "
                  f"ptxas {ptxas['label_prop_propagate']} | {smi}", flush=True)

        k1_step = step_k1(lp, dev)
        for i, t in enumerate(k1_step):
            print(f"[kernel] heritage batch-8 step, propagation launch {i} "
                  f"({t['P']} clouds, V={t['V']}, bounds "
                  f"{min(t['bounds'])}-{max(t['bounds'])}): labels equal to "
                  f"plain; {t['ms']:.4f} ms device, {t['sweeps']} sweeps; "
                  f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
                  f"{t['ops']} ops), {t['ms'] / t['bound_ms']:.0f}x it | "
                  f"{smi}", flush=True)
        print(f"[kernel] heritage batch-8 step: {len(k1_step)} propagation "
              f"launches, {sum(t['ms'] for t in k1_step):.4f} ms device "
              f"against a bound of "
              f"{sum(t['bound_ms'] for t in k1_step) * 1e3:.3f} us | {smi}",
              flush=True)

        p1_err, p1 = phase_gather_vs_plain(gt, dev)
        print("[gather] equal to tbl[idx] at the probe's inputs (1, 1024) and "
              "to plain at (1, 1536), (1, 9216), (8, 9216)", flush=True)
        for (P, V), t in p1.items():
            b_ms, _ = p1_bound(P, V)
            print(f"[gather] ({P}, {V}) device time: {t['kernel_ms'] * 1e3:.2f} "
                  f"us vs plain {t['plain_ms'] * 1e3:.2f} us, torch.gather "
                  f"alone {t['library_ms'] * 1e3:.2f} us; a call with its "
                  f"wrapper: {t['kernel_call_ms'] * 1e3:.2f} / "
                  f"{t['plain_call_ms'] * 1e3:.2f} / "
                  f"{t['library_call_ms'] * 1e3:.2f} us; bound "
                  f"{b_ms * 1e3:.3f} us (bytes) | {smi}", flush=True)

        t0 = time.perf_counter()
        cl_err, cl = phase_cluster_vs_plain(ck, dev)
        for name, c in cl["scan"].items():
            print(f"[cluster] C1 block scan, {name} batch-8 step's "
                  f"hypotheses {c['shape']} ({c['rows']} valid, {c['seeds']} "
                  f"seeds, {c['lane_pairs']} (row, column) pairs within a "
                  f"lane, {c['in_ball']} in a ball): {c['ms']:.4f} ms "
                  f"device; plain loop "
                  f"{c['plain_ms']:.3f} ms device; library call "
                  f"(torch.matmul(geo_f, stats_cols), {c['library_calls']} "
                  f"blocks, TF32 off) {c['library_ms']:.3f} ms device; bound "
                  f"{c['bound_ms'] * 1e3:.3f} us ({c['bound_by']}: "
                  f"{c['ops']} ops), {c['ms'] / c['bound_ms']:.1f}x it | "
                  f"ptxas {ptxas['cluster_block_scan']} | {smi}", flush=True)
        for b in cl["blocks"]:
            print(f"[cluster] standalone block-seed walk, heritage batch 8 "
                  f"{cl['shape']}: {b['eligible']} eligible, {b['seeds']} "
                  f"seeds; {b['ms'] * 1e3:.2f} us device vs plain (the "
                  f"fixpoint, CUDA events) {b['plain_ms'] * 1e3:.1f} us; "
                  f"bound {b['bound_ms'] * 1e3:.4f} us ({b['bound_by']}) | "
                  f"{smi}", flush=True)
        w = cl["walk"]
        print(f"[cluster] C2 heritage batch 8 {w['shape']}: {w['walked']} "
              f"slots walked over {w['lanes']} lanes (most "
              f"{w['most_walked']} a lane), {w['emitted']} emitted; "
              f"{w['ms'] * 1e3:.2f} us "
              f"device vs plain (host walk, CUDA events) "
              f"{w['plain_ms'] * 1e3:.1f} us; bound "
              f"{w['bound_ms'] * 1e3:.4f} us ({w['bound_by']}) | ptxas walk "
              f"{ptxas['cluster_block_seeds']} | C2 "
              f"{ptxas['cluster_floor_walk']} | {smi}", flush=True)
        stage_ms = {}
        for name in ("office", "heritage", "structured"):
            st = stage_ms[name] = cluster_stage_ms(name, dev)
            print(f"[cluster] {name} batch 8 cluster stage "
                  f"({st['blocks']} blocks of 512), device time: plain loop "
                  f"{st['plain']:.3f} ms, with C1 {st['kernel']:.3f} ms, "
                  f"with C1 captured {st['graph']:.3f} ms; outputs equal | "
                  f"{smi}", flush=True)
        print(f"[cluster] phase {time.perf_counter() - t0:.1f} s", flush=True)

        launches = collections.Counter()
        paths = {}  # each later path's launch counts, read just after it
        path_ms = {}
        for name in PATH_CONFIGS:
            counts, path_ms[name] = phase_path(name, counters, dev)
            launches.update(counts)
        print(f"[paths] repeated-step wall ms by config: {path_ms} | {smi}",
              flush=True)
        phase_unequal(dev)

        phase_cli()

        steps = {}
        per_step = {}
        eager = {}
        for name in ("office", "heritage"):
            pps, dt, per_step[name], steps[name], eager[name] = phase_timing(
                name, dev, counters)
            t = per_step[name]
            check(t["label_prop_sweep"] == 0 and t["gather_rows"] == 0,
                  f"{name} timing: one-sweep or gather kernel launched")
            check(0 < t["label_prop_propagate"] <= 4,
                  f"{name} timing: {t['label_prop_propagate']} propagation "
                  "launches a step (at most 4)")
            check(t["lm_refine"] == 1,
                  f"{name} timing: {t['lm_refine']} L1 launches a step")
            check(t["scan_int"] == 9 and t["prefix_sum16"] > 0,
                  f"{name} timing: {t['scan_int']} S1 and "
                  f"{t['prefix_sum16']} S2 calls a step (want 9 S1)")
            check(t["fine_join"] == 1,
                  f"{name} timing: {t['fine_join']} V launches a step "
                  "(want 1)")
            check(t["hyp_matches"] == t["hyp_slots"] == t["hyp_emit"] == 1
                  and t["hyp_bases"] == 0,
                  f"{name} timing: {t['hyp_matches']} H1, {t['hyp_slots']} "
                  f"H2, {t['hyp_emit']} H3 and {t['hyp_bases']} bases-form "
                  "launches a step (want 1, 1, 1 and 0)")
            check(t["faces_plane_fit"] == 1 and t["faces_segment_sum"] == 3,
                  f"{name} timing: {t['faces_plane_fit']} F1 and "
                  f"{t['faces_segment_sum']} F2 launches a step (want 1 and "
                  "3)")
            check(t["cluster_block_scan"] == 1
                  and t["cluster_block_seeds"] == 0,
                  f"{name} timing: {t['cluster_block_scan']} block-scan and "
                  f"{t['cluster_block_seeds']} block-seed launches a step "
                  "(want 1 and 0)")
            print(f"[timing] {name} batch 8: {dt * 1e3:.1f} ms/step, "
                  f"{pps:.2f} pairs/s; per step: "
                  f"{t['label_prop_propagate']:g} "
                  f"propagation launches ({t['sweeps']:g} sweeps), "
                  f"{t['label_prop_sweep']:g} one-sweep and "
                  f"{t['gather_rows']:g} gather launches, "
                  f"{t['cluster_block_scan']:g} block-scan (C1), "
                  f"{t['cluster_block_seeds']:g} block-seed and "
                  f"{t['cluster_floor_walk']:g} floor-walk launches, "
                  f"{t['lm_refine']:g} L1 launches, "
                  f"{t['scan_int']:g} S1 and {t['prefix_sum16']:g} S2 "
                  f"calls, {t['faces_plane_fit']:g} F1 and "
                  f"{t['faces_segment_sum']:g} F2 launches, "
                  f"{t['hyp_matches']:g} H1, {t['hyp_slots']:g} H2 and "
                  f"{t['hyp_emit']:g} H3 launches, "
                  f"{t['fine_join']:g} V launches, "
                  f"{t['step_graph_replays']:g} step graph replays and "
                  f"{t['step_graph_captures']:g} captures, "
                  f"{t['host_launches']} host launches "
                  f"({t['host_by_api']}), {t['device_kernels']} device "
                  f"kernels and {t['device_copies']} device copies/fills, "
                  f"{t['host_syncs']} host syncs "
                  f"({dict(t['host_sync_lines'].most_common())}), peak "
                  "device memory allocated "
                  f"{t['peak_bytes'] / 2**30:.3f} GiB "
                  f"({t['peak_bytes_over_inputs'] / 2**30:.3f} GiB over what "
                  f"was allocated before the step: a replay allocates only "
                  f"its outputs' clones), besides the step graph's private "
                  f"pool {t['step_pool_bytes'] / 2**30:.3f} GiB (all graphs' "
                  f"pools "
                  f"{t['graph_pool_bytes'] / 2**30:.3f} GiB) | {smi} | "
                  f"torch {torch.__version__} cuda {torch.version.cuda}",
                  flush=True)
        t0 = time.perf_counter()
        graph_ab = {}
        for name in ("office", "heritage"):
            g = graph_ab[name] = phase_graph(name, steps[name], eager[name],
                                             counters, dev)
            turns = {k: [round(x, 1) for x in v]
                     for k, v in g["turns_ms"].items()}
            print(f"[graph] {name} batch 8: every field of the step graph "
                  f"bitwise equal to the eager step's (L1 launched "
                  f"eagerly) and to the eager step with lm_loop and its "
                  f"early exit; "
                  f"step wall "
                  f"ms in turns {turns} | {smi}", flush=True)
            for arm in ("graph", "eager", "eager_lm"):
                a = g[arm]
                print(f"[graph] {name} {arm} step: {a['host_syncs']} host "
                      f"syncs ({a['host_sync_lines']}), {a['host_launches']} "
                      f"host launches ({a['host_by_api']}), "
                      f"{a['device_kernels']} device kernels, "
                      f"{a['device_copies']} device copies/fills, step graph "
                      f"{a['step_graph_captures']} captures and "
                      f"{a['step_graph_replays']} replays, peak "
                      f"{a['peak_bytes'] / 2**30:.3f} GiB", flush=True)
            lm = g["lm"]
            print(f"[graph] {name} LM alone ({lm['lanes']} lanes x "
                  f"{lm['planes']} planes, 50 iterations): L1 "
                  f"{lm['l1_wall_ms'][0]:.3f} ms wall (least "
                  f"{lm['l1_wall_ms'][1]:.3f}), "
                  f"{lm['l1_event_ms']:.3f} ms by CUDA events, "
                  f"{lm['l1_launches']['host_launches']} host launches "
                  f"({lm['l1_launches']['host_by_api']}), "
                  f"{lm['l1_launches']['device_kernels']} device kernels "
                  "(L1 and the transform's ops); eager "
                  f"loop with its early exit {lm['eager_wall_ms'][0]:.1f} ms "
                  f"wall, {lm['eager_event_ms']:.1f} ms by events, "
                  f"{lm['eager_launches']['host_launches']} host launches; "
                  f"eager loop to the cap {lm['eager_to_cap_wall_ms'][0]:.1f}"
                  f" ms wall; all three bitwise equal; step graphs kept "
                  f"{g['graphs_kept']}, all graphs' pools "
                  f"{g['graph_pool_bytes'] / 2**20:.2f} MiB | {smi}",
                  flush=True)
            print(f"[graph] {name} seconds by part: "
                  f"{ {k: round(v, 1) for k, v in g['secs'].items()} }",
                  flush=True)
        phase_graph_configs(dev, counters)
        print(f"[graph] phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        stage_tables = {}
        for name in ("heritage", "office"):
            stage_tables[name] = phase_stages(
                name, steps[name], eager[name],
                per_step[name]["device_kernels"])
            print_stages(name, stage_tables[name], smi)
        print(f"[stages] phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        sc = phase_scans(steps, eager, dev)
        for kernel in ("S1", "S2"):
            for name, t in sc[kernel].items():
                for c in t["calls"]:
                    print(f"[scan] {kernel} {name} step, {c['what']} "
                          f"{c['shape']} {c['dtype']}: {c['ms'] * 1e3:.2f} "
                          f"us device vs plain {c['plain_ms'] * 1e3:.2f} us, "
                          f"library {c['library_ms'] * 1e3:.2f} us"
                          + (f", columns concatenated then S2 "
                             f"{c['unfused_ms'] * 1e3:.2f} us"
                             if "unfused_ms" in c else "")
                          + f"; bound {c['bound_ms'] * 1e3:.3f} us "
                          f"({c['bound_by']}), {c['ms'] / c['bound_ms']:.1f}x "
                          "it", flush=True)
                print(f"[scan] {kernel} {name} batch-8 step: "
                      f"{len(t['calls'])} calls, each equal to plain bit for "
                      f"bit; {t['ms']:.4f} ms device vs plain "
                      f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} "
                      f"ms; bound {t['bound_ms'] * 1e3:.3f} us (bytes) | "
                      f"ptxas {ptxas['scan_int' if kernel == 'S1' else 'prefix_sum16']}"
                      f" | {smi}", flush=True)
        print(f"[scan] {sc['edge_cases']} edge cases equal to plain; "
              f"{sc['replayed_calls']} kernel calls in one graph, replayed "
              f"twice, equal to their eager calls; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        fc = phase_faces(steps, eager, dev)
        print(f"[faces] F1's cosf and atan2f equal to torch.cos and "
              f"torch.atan2 at {fc['math_inputs']} inputs", flush=True)
        for kernel in ("F1", "F2"):
            for name, t in fc[kernel].items():
                for c in t["calls"]:
                    print(f"[faces] {kernel} {name} step, {c['what']} "
                          f"{c['shape']}: {c['ms'] * 1e3:.2f} us device vs "
                          f"plain {c['plain_ms'] * 1e3:.2f} us, library "
                          f"{c['library_ms'] * 1e3:.2f} us "
                          f"({c['library_calls']} calls); bound "
                          f"{c['bound_ms'] * 1e3:.3f} us ({c['bound_by']}), "
                          f"{c['ms'] / c['bound_ms']:.1f}x it", flush=True)
                ptx = ptxas["faces_plane_fit" if kernel == "F1"
                            else "faces_segment_sum"]
                print(f"[faces] {kernel} {name} batch-8 step: "
                      f"{len(t['calls'])} calls, each equal to plain bit for "
                      f"bit; {t['ms']:.4f} ms device vs plain "
                      f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} "
                      f"ms; bound {t['bound_ms'] * 1e3:.3f} us "
                      f"({t['bound_by']}) | ptxas {ptx} | {smi}", flush=True)
        print(f"[faces] {fc['edge_cases']} edge cases equal to plain; "
              f"F2's own order equal to torch.sort(stable=True) on "
              f"{fc['orders']} F2 inputs; "
              f"{fc['replayed_calls']} kernel calls in one graph, replayed "
              f"twice, equal to their eager calls; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        hc = phase_hypotheses(steps, eager, dev)
        print(f"[hypotheses] acosf equal to torch.arccos at "
              f"{hc['acos_inputs']} inputs", flush=True)
        for kernel, ptx in HYP_PTXAS.items():
            for name, c in hc[kernel].items():
                extra = "".join(f", {k} {c[k]}" for k in (
                    "matches", "hits", "row_overflows", "hypotheses")
                    if k in c)
                print(f"[hypotheses] {kernel} {name} batch-8 step "
                      f"{c['shape']}{extra}: equal to plain; "
                      f"{c['ms'] * 1e3:.2f} us device vs plain "
                      f"{c['plain_ms'] * 1e3:.2f} us; bound "
                      f"{c['bound_ms'] * 1e3:.3f} us ({c['bound_by']}), "
                      f"{c['ms'] / c['bound_ms']:.1f}x it"
                      + (f"; PR 18's count {c['yardstick_ms'] * 1e3:.3f} us "
                         f"({c['yardstick_by']}), "
                         f"{c['ms'] / c['yardstick_ms']:.1f}x it"
                         if "yardstick_ms" in c else "")
                      + f" | ptxas {ptxas[ptx]} | {smi}", flush=True)
        for what, c in hc["emit_timed"].items():
            print(f"[hypotheses] H3 heritage batch-8 step at {what}'s "
                  f"capacities (P, M, PER_MATCH) {c['shape']}, H {c['H']}, "
                  f"{c['hits']} hits, {c['hypotheses']} hypotheses: equal "
                  "to plain; "
                  f"{c['ms'] * 1e3:.2f} us device vs plain "
                  f"{c['plain_ms'] * 1e3:.2f} us; bound "
                  f"{c['bound_ms'] * 1e3:.3f} us ({c['bound_by']}), "
                  f"{c['ms'] / c['bound_ms']:.1f}x it | {smi}", flush=True)
        print(f"[hypotheses] {hc['edge_cases']} edge cases "
              f"({hc['edge_calls']} kernel calls) equal to plain; a pair "
              f"alone equal to its row of {hc['lane_alone']}; "
              f"{hc['replayed_calls']} kernel calls in one graph, replayed "
              f"twice, equal to their eager calls; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        vc = phase_fine(steps, eager, dev)
        for form, kernel in FINE_FORMS.items():
            ptx = ptxas[f"fine_{form}"]
            for name, c in vc[kernel].items():
                extra = ", ".join(f"{k} {v}" for k, v in c.items()
                                  if k not in ("shape", "ms", "plain_ms",
                                               "library_ms", "bound_ms",
                                               "bound_by"))
                print(f"[fine] {kernel} {name} batch-8 step {c['shape']} "
                      f"({extra}): equal to plain; {c['ms'] * 1e3:.2f} us "
                      f"device vs plain {c['plain_ms'] * 1e3:.2f} us; bound "
                      f"{c['bound_ms'] * 1e3:.3f} us ({c['bound_by']}), "
                      f"{c['ms'] / c['bound_ms']:.1f}x it | ptxas {ptx} | "
                      f"{smi}", flush=True)
        for what, c in vc["timed"].items():
            print(f"[fine] {kernel} edge case {what} {c['shape']}, "
                  f"{c['points']} points, {c['slots']} slots, clusters "
                  f"{c['clusters']} (0: the scratch): {c['ms'] * 1e3:.2f} us "
                  f"device vs plain {c['plain_ms'] * 1e3:.2f} us | {smi}",
                  flush=True)
        print(f"[fine] {vc['edge_cases']} edge cases ({vc['edge_calls']} "
              f"kernel calls) equal to plain; {vc['pairs_alone']} pairs alone "
              f"equal to their rows; {vc['replayed_calls']} kernel "
              f"calls in one graph, replayed twice, equal to their eager "
              f"calls; phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        l1_err, l1 = phase_lm_vs_plain(
            lmk, {k: g["lm_inputs"] for k, g in graph_ab.items()}, dev)
        print(f"[lm] L1 heritage batch-8 step ({l1['lanes']} lanes x "
              f"{l1['planes']} planes, {l1['steps']} LM steps, "
              f"{l1['accepted']} accepted; the first lane with the most "
              f"steps: {l1['most_steps']}, {l1['most_steps_accepted']} "
              f"accepted; "
              f"a lane alone and in 12 lanes equal to it in the 96 "
              f"({l1['alone_diff']} outputs differ)): "
              f"{l1['ms'] * 1e3:.2f} us a "
              f"launch by CUDA events over 20 back to back (one launch "
              f"alone {l1['one_launch_ms'] * 1e3:.2f} us; "
              f"{l1['call_event_ms'] * 1e3:.2f} us with the transform's "
              f"ops); plain (lm_loop to its cap as a graph of its "
              f"own, {l1['plain_kernels']} device kernels) "
              f"{l1['plain_ms']:.3f} ms by CUDA events, eager with its "
              f"early exit {l1['eager_ms']:.1f} ms; bound "
              f"{l1['bound_ms'] * 1e3:.4f} us ({l1['bound_by']}: "
              f"{l1['ops']} ops) | ptxas {ptxas['lm_refine']} | {smi}",
              flush=True)
        print(f"[lm] L1's scratch instantiation bitwise equal to the "
              f"registers one at the heritage step's LM; us a launch in "
              f"turns (registers, scratch, scratch, registers): "
              + ", ".join(f"{x * 1e3:.2f}" for x in l1["turns"])
              + f" | ptxas scratch {ptxas['lm_refine_scratch']} | {smi}",
              flush=True)
        print(f"[lm] phase {time.perf_counter() - t0:.1f} s", flush=True)
        phase_mesh(dev, counters)
        print(f"[mesh] {smi}", flush=True)
        phase_diff(lp)
        print(f"[diff] {smi}", flush=True)
        phase_profile(*steps["heritage"], eager["heritage"])
        t0 = time.perf_counter()
        accuracy, paths["accuracy sweep"] = phase_accuracy(dev, counters, smi)
        print(f"[accuracy] phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        paths["escalation"] = phase_escalation(dev, counters, smi)
        print(f"[escalation] phase {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        paths["overlap curve"] = phase_overlap(dev, counters, smi, accuracy)
        print(f"[overlap] phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        paths["twin check"] = phase_twin_check(dev, counters, smi)
        print(f"[twin] phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        paths["content measurement"] = phase_measure(dev, counters, smi)
        print(f"[measure] phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_native_io()
        print(f"[native] phase {time.perf_counter() - t0:.1f} s", flush=True)
        print(f"[done] {time.perf_counter() - t_start:.1f} s after the build "
              f"started; torch.profiler captures taken again for dropped "
              f"records: {dict(RETAKEN)}", flush=True)
    except Exception:  # any failed phase fails the run
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1

    her = k1["heritage"]
    big = k1[MEASURE_K1]
    scan = cl["scan"]["heritage"]
    g = p1[(1, 9216)]
    p1_bound_ms, p1_bound_by = p1_bound(1, 9216)

    def per_step_of(k):
        return {name: v[k] for name, v in per_step.items()}

    print(json.dumps({"kernels": [
        dict(KERNELS["label_prop_propagate"],
             launches=launches["label_prop_propagate"],
             max_abs_err=lp_err["propagate"], ms=her["propagate_ms"],
             plain_ms=her["plain_ms"], bound_ms=her["propagate_bound_ms"],
             bound_by=her["propagate_bound_by"], library_ms=None,
             sweeps=her["sweeps"], sweeps_on_main_path=launches["sweeps"],
             launches_per_step=per_step_of("label_prop_propagate"),
             sweeps_per_step=per_step_of("sweeps"),
             step_device_kernels=per_step_of("device_kernels"),
             step_host_launches=per_step_of("host_launches"),
             step_graph_replays=per_step_of("step_graph_replays"),
             step_host_syncs=per_step_of("host_syncs"),
             step_peak_bytes=per_step_of("peak_bytes"),
             step_graph_pool_bytes=per_step_of("step_pool_bytes"),
             wall_ms=her["propagate_wall_ms"],
             host_loop_wall_ms=her["host_loop_wall_ms"],
             host_loop_ms=her["host_loop_ms"],
             outside_sweep_phase_us_per_sweep=her["outside_per_sweep_ms"] * 1e3,
             sweep_phase_share=her["sweep_share"],
             halving_bound_us=her["halving_bound_ms"] * 1e3,
             plain_wall_ms=her["plain_wall_ms"],
             launches_by_path={k: {n: v[n] for n in (
                 "label_prop_propagate", "sweeps")} for k, v in paths.items()},
             heritage_step_launches=k1_step,
             at_v16384=dict(
                 V=big["V"], bound=big["bound"], ms=big["propagate_ms"],
                 plain_ms=big["plain_ms"], bound_ms=big["propagate_bound_ms"],
                 bound_by=big["propagate_bound_by"], sweeps=big["sweeps"],
                 wall_ms=big["propagate_wall_ms"],
                 sweep_ms=big["sweep_ms"], sweep_bound_ms=big["bound_ms"],
                 shape="one propagation, heritage seed 0 pass 1 through "
                       "measure_content at V = 16384"),
             ptxas=ptxas["label_prop_propagate"],
             shape=f"one propagation, heritage seed 0 pass 1 (V={her['V']}, "
                   f"bound {her['bound']}); ms device time of the kernel, "
                   "plain_ms the plain version's device time"),
        dict(KERNELS["label_prop_sweep"], launches=launches["label_prop_sweep"],
             max_abs_err=lp_err["host loop"], ms=her["sweep_ms"],
             plain_ms=her["plain_sweep_ms"], bound_ms=her["bound_ms"],
             bound_by=her["bound_by"], library_ms=None,
             bound_us=her["bound_ms"] * 1e3,
             launches_per_step=per_step_of("label_prop_sweep"),
             call_ms=her["sweep_call_ms"],
             ptxas=ptxas["label_prop_sweep"],
             shape=f"one sweep, heritage seed 0 pass 1 (V={her['V']}, "
                   f"bound {her['bound']}), from the initial labels; ms "
                   "device time; off the main path"),
        dict(KERNELS["gather_rows"], launches=launches["gather_rows"],
             max_abs_err=p1_err, ms=g["kernel_ms"], plain_ms=g["plain_ms"],
             bound_ms=p1_bound_ms, bound_by=p1_bound_by,
             library_ms=g["library_ms"], call_ms=g["kernel_call_ms"],
             bound_us=p1_bound_ms * 1e3,
             launches_per_step=per_step_of("gather_rows"),
             ptxas=ptxas["gather_rows"],
             shape="(1, 9216) int32; ms device time; off the main path"),
        dict(KERNELS["cluster_block_scan"],
             launches=launches["cluster_block_scan"],
             max_abs_err=cl_err["scan"], ms=scan["ms"],
             plain_ms=scan["plain_ms"], bound_ms=scan["bound_ms"],
             bound_by=scan["bound_by"], library_ms=scan["library_ms"],
             launches_per_step=per_step_of("cluster_block_scan"),
             by_config=cl["scan"], cluster_stage_ms=stage_ms,
             launches_by_path={k: v["cluster_block_scan"]
                               for k, v in paths.items()},
             ptxas=ptxas["cluster_block_scan"],
             shape=f"the block scan of the heritage batch-8 step's "
                   f"hypotheses {scan['shape']}; ms device time, plain_ms "
                   "the plain block loop's device time, library_ms "
                   "torch.matmul(geo_f, stats_cols) a block (the member "
                   "sums alone, as the JAX package computes them); "
                   "max_abs_err the most outputs that differ"),
        dict(KERNELS["cluster_block_seeds"],
             launches=launches["cluster_block_seeds"],
             max_abs_err=cl_err["seeds"], ms=cl["ms"],
             plain_ms=cl["plain_ms"], bound_ms=cl["bound_ms"],
             bound_by=cl["bound_by"], library_ms=None,
             launches_per_step=per_step_of("cluster_block_seeds"),
             blocks=cl["blocks"],
             launches_by_path={k: v["cluster_block_seeds"]
                               for k, v in paths.items()},
             ptxas=ptxas["cluster_block_seeds"],
             shape=f"one block {cl['shape']} bool of the heritage batch-8 "
                   "step's plain scan, the mean over its blocks; ms device "
                   "time, plain_ms the fixpoint's time by CUDA events (it "
                   "reads back each round); max_abs_err the most outputs "
                   "that differ; off the main path"),
        dict(KERNELS["cluster_floor_walk"],
             launches=launches["cluster_floor_walk"],
             max_abs_err=cl_err["walk"], ms=cl["walk"]["ms"],
             plain_ms=cl["walk"]["plain_ms"],
             bound_ms=cl["walk"]["bound_ms"],
             bound_by=cl["walk"]["bound_by"], library_ms=None,
             launches_per_step=per_step_of("cluster_floor_walk"),
             walked=cl["walk"]["walked"],
             most_walked=cl["walk"]["most_walked"],
             emitted=cl["walk"]["emitted"],
             launches_by_path={k: v["cluster_floor_walk"]
                               for k, v in paths.items()},
             ptxas=ptxas["cluster_floor_walk"],
             shape=f"the walk {cl['walk']['shape']} float32 of the heritage "
                   "batch-8 step; ms device time, plain_ms the host walk's "
                   "time by CUDA events; max_abs_err the most outputs that "
                   "differ"),
        dict(KERNELS["lm_refine"], launches=launches["lm_refine"],
             max_abs_err=l1_err, ms=l1["ms"], plain_ms=l1["plain_ms"],
             bound_ms=l1["bound_ms"], bound_by=l1["bound_by"],
             library_ms=None,
             launches_per_step=per_step_of("lm_refine"),
             one_launch_ms=l1["one_launch_ms"],
             call_event_ms=l1["call_event_ms"],
             eager_plain_ms=l1["eager_ms"], lm_steps=l1["steps"],
             lm_accepted=l1["accepted"], most_steps=l1["most_steps"],
             plain_device_kernels=l1["plain_kernels"],
             launches_by_path={k: v["lm_refine"] for k, v in paths.items()},
             ptxas=ptxas["lm_refine"],
             scratch_ms=l1["scratch_ms"],
             ptxas_scratch=ptxas["lm_refine_scratch"],
             shape=f"the LM of the heritage batch-8 step, {l1['lanes']} "
                   f"lanes x {l1['planes']} planes, 50 iterations at most; "
                   "ms a launch by CUDA events over 20 launches back to "
                   "back, plain_ms lm_loop to its cap replayed as a graph "
                   "of its own by CUDA events; max_abs_err the most "
                   "transform entries that differ"),
        *(dict(KERNELS[name], launches=launches[name],
               max_abs_err=sc["differ"], ms=sc[kernel]["heritage"]["ms"],
               plain_ms=sc[kernel]["heritage"]["plain_ms"],
               bound_ms=sc[kernel]["heritage"]["bound_ms"], bound_by="bytes",
               library_ms=sc[kernel]["heritage"]["library_ms"],
               launches_per_step=per_step_of(name),
               by_config={k: {f: v for f, v in t.items() if f != "calls"}
                          for k, t in sc[kernel].items()},
               calls=sc[kernel]["heritage"]["calls"],
               stage_ms={k: {arm: {st: round(b["ms"], 4) for st, b in
                                   stage_tables[k][arm]["stages"].items()}
                             for arm in STAGE_ARMS}
                         for k in stage_tables},
               launches_by_path={k: v[name] for k, v in paths.items()},
               ptxas=ptxas[name],
               shape=f"the {len(sc[kernel]['heritage']['calls'])} {kernel} "
                     "calls of the heritage batch-8 step, summed; ms, "
                     "plain_ms and library_ms device time a call by CUDA "
                     "events over a graph of 10 calls; a call launches "
                     + ("2 kernels (1 for rows of at most 1024 entries)"
                        if kernel == "S1" else
                        "3 kernels (1 for columns of at most 256 entries); "
                        "the leaf and moment columns formed in the kernel")
                     + "; max_abs_err the most outputs that differ")
          for name, kernel in (("scan_int", "S1"), ("prefix_sum16", "S2"))),
        *(dict(KERNELS[name], launches=launches[name],
               max_abs_err=fc["differ"], ms=fc[kernel]["heritage"]["ms"],
               plain_ms=fc[kernel]["heritage"]["plain_ms"],
               bound_ms=fc[kernel]["heritage"]["bound_ms"],
               bound_by=fc[kernel]["heritage"]["bound_by"],
               library_ms=fc[kernel]["heritage"]["library_ms"],
               launches_per_step=per_step_of(name),
               by_config={k: {f: v for f, v in t.items() if f != "calls"}
                          for k, t in fc[kernel].items()},
               calls=fc[kernel]["heritage"]["calls"],
               faces_chains={k: stage_tables[k]["faces_chains"]
                             for k in stage_tables},
               launches_by_path={k: v[name] for k, v in paths.items()},
               ptxas=ptxas[name],
               shape=f"the {len(fc[kernel]['heritage']['calls'])} {kernel} "
                     "calls of the heritage batch-8 step, summed; ms, "
                     "plain_ms and library_ms device time a call by CUDA "
                     "events over a graph of 10 calls; library_ms "
                     + ("torch.linalg.eigh of the covariances"
                        if kernel == "F1" else
                        "Tensor.index_add_ of the columns as formed into "
                        "the slots of seg from the unsorted labels "
                        "(atomics, another order)")
                     + "; max_abs_err the most outputs that differ")
          for name, kernel in (("faces_plane_fit", "F1"),
                               ("faces_segment_sum", "F2"))),
        *(dict(KERNELS[ptx], launches=launches[ptx],
               max_abs_err=hc["differ"], ms=hc[kernel]["heritage"]["ms"],
               plain_ms=hc[kernel]["heritage"]["plain_ms"],
               bound_ms=hc[kernel]["heritage"]["bound_ms"],
               bound_by=hc[kernel]["heritage"]["bound_by"], library_ms=None,
               launches_per_step=per_step_of(ptx), by_config=hc[kernel],
               hypotheses_stage={k: {arm: [round(b["ms"], 4), b["kernels"]]
                                     for arm in STAGE_ARMS for b in [
                                         stage_tables[k][arm]["stages"][
                                             "hypotheses"]]}
                                 for k in stage_tables},
               launches_by_path={k: v[ptx] for k, v in paths.items()},
               ptxas=ptxas[ptx],
               shape=f"one call at the heritage batch-8 step's inputs "
                     f"{hc[kernel]['heritage']['shape']}; ms and plain_ms "
                     "device time a call by CUDA events over a graph of 10 "
                     "calls; no one PyTorch call computes it; max_abs_err "
                     "the calls that differ"
                     + ("; off the main path (select_bases on a card), "
                        "timed on the step's 2P face sets"
                        if kernel == "bases" else "")
                     + ("; bound_ms the work its function needs "
                        "(hyp_slots_ops), by_config's yardstick_ms PR 18's "
                        "count" if kernel == "H2" else ""))
          for kernel, ptx in HYP_PTXAS.items()),
        *(dict(KERNELS[f"fine_{form}"], launches=launches[f"fine_{form}"],
               max_abs_err=vc["differ"], ms=vc[kernel]["heritage"]["ms"],
               plain_ms=vc[kernel]["heritage"]["plain_ms"],
               bound_ms=vc[kernel]["heritage"]["bound_ms"],
               bound_by=vc[kernel]["heritage"]["bound_by"], library_ms=None,
               launches_per_step=per_step_of(f"fine_{form}"),
               by_config=vc[kernel],
               fine_verify_stage={k: {arm: [round(b["ms"], 4), b["kernels"]]
                                      for arm in STAGE_ARMS for b in [
                                          stage_tables[k][arm]["stages"][
                                              "fine_verify"]]}
                                  for k in stage_tables},
               launches_by_path={k: v[f"fine_{form}"]
                                 for k, v in paths.items()},
               ptxas=ptxas[f"fine_{form}"],
               shape=f"one call at the heritage batch-8 step's inputs "
                     f"{vc[kernel]['heritage']['shape']}; ms and plain_ms "
                     "device time a call by CUDA events over a graph of 10 "
                     "calls; no one PyTorch call computes it; max_abs_err "
                     "the calls that differ")
          for form, kernel in FINE_FORMS.items()),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
