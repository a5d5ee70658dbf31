#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--log2-vertices 25] [--supersteps 20]
                          [--sssp-log2-vertices 22] [--imru-log2-records 23]
                          [--generic-domain 1024]
                          [--rows-log2-vertices 16] [--lm-layers 32]
                          [--lm-prompt 4000] [--train-layers 32]
                          [--train-seq 4096]

Phases, each of which exits nonzero on failure:

1. ``build``: compile every ``src/repro_torch/csrc/*.cu`` with nvcc
   (sm_90a), one process per source, all started together.
2. ``kernels``: the segment-combine kernel against its plain PyTorch
   version on the card: sum/max/min x f32/bf16, with and without
   ``edge_active``, at F in {1, 2, 8} on ragged shapes with padding ids at
   both ends, empty segments and one hub segment of 2^20 rows, and on the
   hub-split cases of ``SPLIT_CASES`` (a tile of exactly K chunks and one
   of K + 1, a hub that starts and ends mid-chunk, two long segments in
   one tile, a split tile with a wholly inactive piece, a split at F =
   1024), and at F = 16384, wider than the kernel's accumulator (one
   launch a column slice).  max/min must be bit-equal; sums must be within
   the error
   bounds of ``_sum_check`` (the depth from ``kernel.sum_depth``) of a
   float64 sum and of the plain version, and the hubs' integer-valued
   sums exact; two launches on the same input must be bit-identical.
3. ``pagerank`` (the main path): PageRank through ``compile_pregel`` with
   the planner's own plan (``dense_psum`` on one device) on a power-law
   graph of 2^25 vertices with the Yahoo webmap's mean out-degree (5.7)
   and web-graph degree exponents (see ``power_law_graph``), made from
   ``--seed`` with numpy, checked against a scipy.sparse float64 oracle;
   the kernel's launch count must rise by at least 2 a superstep.  At the
   main path's shapes the kernel is timed in turns with the parent's
   decomposition (one block per tile, the C entry point with no split),
   and beside ``torch.segment_reduce`` and ``index_add_`` (float atomics,
   not bit-reproducible), yardsticks the port never calls.
4. ``sssp``: semi-naive SSSP with the merging connector on 2^22 vertices;
   it must converge, equal scipy's BFS distances exactly and run at least
   one sparse superstep.
5. ``imru``: batch gradient descent (Listing 2, the paper's §5.1 task)
   through ``compile_imru`` with the planner's H100 plan: 2^23 records of
   1280 f32 features and a label made on the card from ``--seed`` (42.98
   GB, 3 microbatches and a tail of 2 records), 10 iterations on the
   device driver and on the host driver (equal), held to a float64 oracle
   within a bar of the f32 rounding (``_imru_oracle``); a skipped
   microbatch, the tail dropped as the JAX package drops it and the map
   run in bf16 must each break the bar.  ms per iteration,
   records/s and the share of the bytes bound (the records read once);
   one iteration profiled.  No TPU kernel on this path.
6. ``generic``: the dense-grid engine (``compile_program``) at n = 1024,
   the largest domain the planner keeps dense for a binary predicate:
   transitive closure of a random digraph (host and device drivers, naive
   and semi-naive, and the parsed text through the rewrite pass) and
   semi-naive connected components, each exactly equal to a numpy/scipy
   oracle; iterations, ms per iteration, peak memory, one iteration
   profiled; then PageRank -> threshold -> reach on 4 vertices, whose
   16-cell grid the planner gives the segment scan, which must launch the
   segment-combine kernel (the one TPU kernel the engine can reach).
7. ``rows``: row-table storage at n = 65,536, the largest domain whose
   binary row codes fit the 2^32 code space (``--rows-log2-vertices``, at
   most 16): transitive closure of 2,048 disjoint 32-vertex chains on
   planner-selected row tables (host and device drivers, naive and
   semi-naive) equal to the chains' closed form; semi-naive connected
   components of 2^19 random undirected edges (a ``RowRelation``, with a
   dense ``node``) equal to scipy's; PageRank -> threshold -> reach on
   forced row tables (out-degree 16, 30 iterations) within 1e-5 relative
   L1 of a float64 oracle, ``hot`` exact outside a 1e-5 relative margin
   of tau and ``reach`` exact given ``hot``.  No run may fall back to
   dense grids.  The segmented GroupBys and the row merge must launch the
   segment-combine kernel (at least once a CC iteration, twice a PageRank
   one), which is held against its plain version at those sites' shapes
   and timed there.  Iterations, ms per iteration, peak memory, planned
   caps and plan notes; one iteration of each profiled.
8. ``ft``: fault tolerance, every run bit-equal to the uninterrupted one.
   PageRank at the pagerank phase's size on the host driver with a
   checkpoint of the ``(state, active)`` carry every 4 supersteps into a
   temporary directory: crashes injected at supersteps 6 and 13, and a run
   stopped at 10 and resumed from disk (the uninterrupted host-driver run
   bit-equal to the device driver's); a checkpoint's bytes, the save's
   device-to-host copy and the writer's I/O, ms per superstep with and
   without checkpoints.  IMRU BGD on 2^20 records of 1280 features with a
   crash at iteration 4.  The rows phase's forced-row PageRank ->
   threshold -> reach pipeline with a crash in phase 1, and a crash at
   phase 2's first step resumed from disk by the phase cursor.  The
   injector raises on the host, which is what the drivers restore from.
   Sizes from ``--log2-vertices`` and ``--supersteps`` (at least 14),
   ``--imru-log2-records`` (at most 20 used) and ``--rows-log2-vertices``.
9. ``chunks``: out-of-core streaming.  The same pipeline at n = 65,536
   with 256 distinct out-edges a vertex (2^24 edges, a 151 MB edge slab),
   its edge ``RowRelation`` on the host, streamed from pinned memory in
   ``chunks={"edge": m}`` for m in {4, 7} and with ``hbm_budget`` a
   quarter of the slab (the planner picks m): ``hot`` exact to float64
   outside the 1e-5 margin of tau, ``reach`` its closure, ranks within
   1e-6 relative L1 of the reference run and 1e-5 of float64; two runs at
   m = 4 bit-identical, and one with a crash in the middle of a chunk
   stream; one chunk skipped in one iteration must break the bar.  For
   each m: warm ms per iteration, peak memory, host-to-device bytes and
   their rate beside a plain pinned copy of the same bytes, from one
   profiled iteration the copy and compute streams' busy times and the
   copy time under compute, and a rank iteration timed in turns with the
   same iteration on chunks already on the card.  B1 at the chunk-fold site (at least m launches a rank
   iteration) is held to its plain version there and timed.  The planner
   caps a row slab at 2^20 rows, as the reference's does, so the 2^24-edge
   slab compiles only chunked (m = 1 must refuse): m = 1, 4, 7 are held
   against the unchunked run at 2^20 edges, and the 2^24-edge runs against
   the first m = 4 run.  Size from ``--rows-log2-vertices``.
10. ``serve``: online fixpoint serving through ``FixpointServer``
   (``hw=H100_SXM``) over graphs handed over on the host: personalized
   PageRank at n = ``--generic-domain`` (16 distinct out-edges a vertex,
   20 iterations) in batches of 1, 4, 16 and 64 seed sets under
   ``torch.func.vmap`` and one by one, every query within 1e-5 relative
   L1 of float64 and batched within the f32 bound of the sums of
   sequential, the cold request's compile and host-to-device bytes and a
   warm one's (no compile, no copy of the graph); the same on dense grids
   at 4n, 16 queries, with peak memory; 64 reachability probes equal to
   scipy's BFS, batched bit-equal to sequential; row-table serving at n =
   2^--rows-log2-vertices (4 queries, admitted sequentially, each compiled
   with its bindings, batching refused) within 1e-5 of float64, B1 held
   to its plain version at the GroupBy and merge sites; a parameterized
   program on 4 vertices (segment-scan GroupBys: sum, max, min) whose 16
   queries launch B1 once a GroupBy firing, sums within
   ``kernel.sum_depth``'s bar of the sequential runs and max/min
   bit-equal; then 256 requests through ``serve_request_loop``, answered
   in arrival order and equal to one-by-one dispatch.
   Phases 5 to 10 must give back all the card memory they took.
11. ``lm``: the flash-attention forward kernel against its plain version
   (out, m and l) on the FLASH_SWEEP shapes of ``tests/test_kernels.py``,
   ragged tails and D = 160, in both layouts, f32 and bf16, bf16 output
   held per element to the kernel's own error bound, reaching every route
   (``f32``, ``mma``, ``wgmma``); then the dense LM's serving path,
   ``launch/serve.py``, on phi4-mini-3.8b at full width and depth with
   seeded random weights (bf16 compute): 4 requests of 4,000 prompt tokens,
   then 32 greedy decode steps.  The kernel must launch exactly once per
   layer in prefill, all on the wgmma route (which must be the route at D =
   128), and never in decode; the logits must agree with the same model run
   on the attention's plain version and with a teacher-forced forward
   within ``LM_NOISE_FACTOR`` times the model's bf16 compute bound,
   measured in the run (the plain path against the same weights computed in
   f32), and greedy tokens wherever the plain path's top-1 margin exceeds
   twice the logit gap. Negative controls, each of which must break its
   bar: the same prefill with the attention cut to a window (as a kernel
   that drops keys would cut it), against the whole-path bar; and at the
   main path's attention shape, a kernel output with one KV tile skipped in
   the long rows, against the kernel's bar.  Profiles one prefill and four
   decode steps, and times the kernel, the parent's design (the
   ``mma.sync`` kernel, launched outside the wrapper, in turns with the
   kernel), its plain version and PyTorch's SDPA at the main path's
   attention shape.
12. ``train``: the flash-attention backward kernels (dQ, dK/dV) against
   their plain version (``attention_backward`` in f32 on the same inputs
   and statistics) on the forward's sweep shapes with a head dim up to
   160 and rows that see no key, f32 and bf16, both layouts, reaching
   every route of each kernel: f32 within
   1e-5 x max(1, max |grad|), bf16 per element within
   ``kernel.bf16_bwd_error_bound``; two launches bit-identical.  Then the
   whole training path at full width, 2 layers, 1 x 4096 tokens: loss and
   gradients of the kernel path against the plain-attention path within
   ``LM_NOISE_FACTOR`` times the plain path's own distance from the same
   model in f32, over all gradient leaves and leaf by leaf; the same
   backward with delta dropped and with KV tile 0's dK/dV skipped must
   break that bar.  The main run (the main path): ``launch/train.py`` on
   phi4-mini-3.8b at full width and depth, the planner's train plan (bf16
   params, bf16 AdamW m, f32 v, full remat) with 8 x 4096 tokens a step in
   2 microbatches, 5 AdamW steps on the ``zipf`` stream: per-step seconds,
   tokens/s, loss, grad_norm, peak memory, and exactly 128 forward, 64 dQ
   and 64 dK/dV launches a step, all of them on the wgmma route.  Profiles one step.  Witnesses for the
   loss curve, on the same batches: the first 2 steps again, then step 2's
   loss and gradients through the kernels and through the plain attention
   on one sequence; the 5 steps
   with the learning rate warmed up; and the 5 steps at 2 layers through
   the kernels and through the plain attention.  At the main path's
   attention shape (one microbatch, 4 x 4096), on the inputs that are
   then timed: the forward kernel within its bound of the plain
   attention, the backward kernels within theirs of the plain backward
   (the timed plain call's own result), both planted faults breaking
   that bound, and the timed launches bit-equal to the checked ones;
   dQ and dK/dV each timed in turns with the parent's design (the
   ``mma.sync`` kernel, launched outside the wrapper);
   times beside PyTorch's SDPA backward.

Prints the card's name and power limit first and again after the phases'
seconds, one
``{"kernels": [...]}`` line with each kernel's launches, times and bound
at the main path's shapes, and as its last line ``{"ok": true, "device":
{...}}``.  Smaller sizes than the defaults make a rehearsal
(``--lm-layers 2 --lm-prompt 1000 --log2-vertices 20
--sssp-log2-vertices 18 --imru-log2-records 18 --generic-domain 256
--rows-log2-vertices 12 --train-layers 2 --train-seq 1024`` for a short
first call after a kernel edit): every phase runs and is checked, but
neither of those two lines is printed.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
WEBMAP_MEAN_OUT_DEGREE = 8.05e9 / 1.41e9
# Degree exponents of the web graph (Broder et al., "Graph structure in the
# Web", Computer Networks 33, 2000): P(in-degree = k) ~ k^-2.1,
# P(out-degree = k) ~ k^-2.72.
IN_DEGREE_EXPONENT = 2.1
OUT_DEGREE_EXPONENT = 2.72
F32_UNIT = 2.0 ** -24          # unit roundoff of f32
BF16_UNIT = 2.0 ** -8          # unit roundoff of bf16
F64_UNIT = 2.0 ** -53
PAGERANK_L1_TOL = 1e-5         # ||r - r*||_1 / ||r*||_1 against float64
HUB_ROWS = 1 << 20
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense tensor cores
# Flash kernel against its plain version (in f32) on unit-normal inputs:
# the bars tests/test_kernels.py sets for the Pallas kernel (2e-6 f32
# loosened to 1e-5 for another summation order; 3e-2 bf16), and in bf16
# also the kernel's own error bound per element (kernel.bf16_error_bound),
# which shrinks with the row's output where the flat bar cannot; m and l
# relative to max(|x|, 1).
FLASH_F32_TOL = 1e-5
FLASH_BF16_TOL = 3e-2
FLASH_STATS_RTOL = 1e-5
# Logits of the served model in bf16 (relative L2 over the real vocab)
# against the same model on the attention's plain version, and decode
# against teacher forcing, are held to LM_NOISE_FACTOR times the bf16
# compute bound of this model, measured in the run: the plain path's own
# distance from the same weights and tokens computed in f32.  Two bf16
# computations whose roundings are independent land about sqrt(2) times
# that bound apart.  A plain path more than LM_BF16_BOUND_CAP off f32 fails
# by itself.
LM_NOISE_FACTOR = 2.0
LM_BF16_BOUND_CAP = 0.1
TF_STEPS = 4
LM_ARCH = "phi4_mini_3_8b"
LM_REQUESTS = 4
LM_DECODE_STEPS = 32
DEFAULTS = {"log2_vertices": 25, "supersteps": 20, "sssp_log2_vertices": 22,
            "imru_log2_records": 23, "generic_domain": 1024,
            "rows_log2_vertices": 16, "lm_layers": 32, "lm_prompt": 4000,
            "train_layers": 32, "train_seq": 4096}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _timed(fn, reps: int):
    """(``_time_ms`` of ``fn``, the result of its last call)."""

    last = [None]

    def call():
        last[0] = fn()

    return _time_ms(call, reps), last[0]


# The parent's design of the flash forward (B2), dQ (B3) and dK/dV (B4)
# kernels, timed beside the kernels that replaced it: the mma.sync kernels,
# whose source the port keeps unchanged for the head dims the wgmma kernels
# do not cover, launched through the libraries' C entry points with the
# mma route's id at the main path's head dim.  No wrapper and no launch count
# sees these launches.  Causal, no window, the LM's layout.


def _same_function(name, parent, new, tol=1e-2):
    """The largest relative L2 distance between the parent's outputs and
    the new kernel's, which must stay under ``tol`` (both round to bf16 in
    different orders): a check that the timed parent computes the same
    function."""

    rel = max(float((a.double() - b.double()).norm() / b.double().norm())
              for a, b in zip(parent, new))
    if not rel < tol:
        raise AssertionError(f"the parent's {name} is {rel:.3e} (relative "
                             f"L2) from the new kernel's, over {tol}")
    return rel


def _parent_fwd(q, k, v, scale):
    """The parent's forward: (out, m, l), as ``kernel.flash_fwd``'s."""

    import torch

    from repro_torch.kernels.flash_attention import kernel as K

    B, S, H, D = q.shape
    out = torch.empty_like(q)
    m, l = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
            for _ in range(2))
    strides = [x for t in (q, k, v, out) for x in K._bhsd_strides(t, "bshd")]
    err = K._library().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), K.ROUTES["mma"], B, H, k.shape[2], S,
        k.shape[1], D, *strides, 1, -1, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"the parent's forward failed: CUDA error {err}")
    return out, m, l


def _parent_dq(q, k, v, do, m, l, delta, scale):
    """The parent's dQ: dq, as ``kernel.flash_bwd_dq``'s."""

    import torch

    from repro_torch.kernels.flash_attention import kernel as K

    B, S, H, D = q.shape
    dq = torch.empty_like(q)
    err = K._bwd_library().flash_attention_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        K.ROUTES["mma"], B, H, k.shape[2], S, k.shape[1], D,
        K._strides(q, k, v, do, dq, layout="bshd"), 1, -1, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"the parent's dQ failed: CUDA error {err}")
    return dq


def _parent_dkv(q, k, v, do, m, l, delta, scale):
    """The parent's dK/dV: (dk, dv), as ``kernel.flash_bwd_dkv``'s."""

    import torch

    from repro_torch.kernels.flash_attention import kernel as K

    B, S, H, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = K._bwd_library().flash_attention_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), K.ROUTES["mma"], B, H, k.shape[2], S, k.shape[1], D,
        K._strides(q, k, v, do, dk, dv, layout="bshd"), 1, -1, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"the parent's dK/dV failed: CUDA error {err}")
    return dk, dv


# ---------------------------------------------------------------------------
# Phase 2: kernel against plain
# ---------------------------------------------------------------------------


def _kernel_case(gen, dtype, F, with_active, device):
    """Ragged E and n, padding (-1) ids at both ends, ids drawn from a
    subset so many segments stay empty, one hub segment of HUB_ROWS rows.
    The hub's values are integers in [1, 8]: every partial sum of them is
    an integer below 2^24, exact in f32 in any order, so the hub's sum must
    come out exact and a chunk dropped or counted twice shows."""

    import torch

    n = 70_001
    rows = 300_017
    hub_id = n // 2 + 1
    ids = torch.randint(0, n, (rows,), generator=gen, device=device,
                        dtype=torch.int32)
    ids = ids[(ids % 3 != 1) & (ids != hub_id)]  # a third of segments empty
    hub = torch.full((HUB_ROWS,), hub_id, dtype=torch.int32, device=device)
    ids = torch.sort(torch.cat([ids, hub])).values
    pad_front = torch.full((1000,), -1, dtype=torch.int32, device=device)
    pad_back = torch.full((777,), -1, dtype=torch.int32, device=device)
    ids = torch.cat([pad_front, ids, pad_back]).contiguous()
    E = ids.shape[0]
    vals = torch.randn((E, F), generator=gen, device=device)
    at_hub = ids == hub_id
    vals[at_hub] = torch.randint(1, 9, (HUB_ROWS, F), generator=gen,
                                 device=device).float()
    vals = vals.to(dtype)
    act = None
    if with_active:
        # clustered activity: whole stretches of rows go quiet
        act = torch.rand(E, generator=gen, device=device) < 0.5
        act[E // 4: E // 2] = False
        act = act.contiguous()
    return vals.contiguous(), ids, n, act, (hub_id,)


def _gamma(d):
    return d * F32_UNIT / (1.0 - d * F32_UNIT)


def _sum_check(vals, ids, n, act, ker, ref, tag):
    """Holds kernel sums against a float64 sum and the plain version.

    A summation in which no term passes through more than d f32 additions
    is within gamma_d = d u / (1 - d u) of sum|v| of the exact sum
    (u = 2^-24).  In the kernel d is ``kernel.sum_depth`` of the chunks and
    pieces that hold the segment's valid rows (``summation_depths``); the
    plain version adds in any order (float atomics), d = m for m rows.  The
    float64 sum itself is within m 2^-53 sum|v|.  bf16 output adds its own
    rounding, 2^-8 of the value.  Raises on a bound broken; returns (max
    |kernel - plain|, max of |kernel - float64| / sum|v| over the
    segments)."""

    import torch

    from repro_torch.kernels.segment_combine.kernel import summation_depths

    ids64 = ids.long()
    valid = (ids64 >= 0) & (ids64 < n)
    if act is not None:
        valid &= act
    rows = torch.nonzero(valid).squeeze(1)
    seg = ids64[rows]
    v = vals[rows].double()
    F = vals.shape[1]
    exact = torch.zeros((n, F), dtype=torch.float64, device=vals.device)
    exact.index_add_(0, seg, v)
    mag = torch.zeros_like(exact).index_add_(0, seg, v.abs())
    m = torch.bincount(seg, minlength=n).double()[:, None]
    del rows, seg, v, ids64, valid
    d = summation_depths(ids, n, F, act).double()[:, None]
    f64_err = m * F64_UNIT * mag
    tol_k = _gamma(d) * mag + f64_err
    tol_p = _gamma(m) * mag + f64_err
    if vals.dtype == torch.bfloat16:
        tol_k = tol_k + BF16_UNIT * (exact.abs() + tol_k)
        tol_p = tol_p + BF16_UNIT * (exact.abs() + tol_p)
    err64 = (ker.double() - exact).abs()
    bad = int((err64 > tol_k).sum())
    if bad:
        raise AssertionError(f"kernel sum off the float64 sum by more than "
                             f"its bound on {bad} elements (max abs err "
                             f"{float(err64.max())}): {tag}")
    err = (ker.double() - ref.double()).abs()
    bad = int((err > tol_k + tol_p).sum())
    if bad:
        raise AssertionError(f"kernel sum != plain on {bad} elements (max abs "
                             f"err {float(err.max())}): {tag}")
    rel = float((err64 / mag)[mag > 0].max())
    return float(err.max()), rel


# Hub-split cases of the segment combine: tiles whose rows span more than
# kernel.PIECE_CHUNKS chunks are cut into pieces (csrc/segment_combine.cu).
# Each is a list of (id, rows) runs at payload width F over n segments, and
# its hubs: integer-valued segments whose sums must come out exact.
SPLIT_CASES = ("tile_of_K_chunks", "tile_of_K_plus_1_chunks",
               "hub_mid_chunk", "two_long_segments", "inactive_piece",
               "wide_payload")


def _split_runs(name):
    """(runs, n, F, hubs, rows of a wholly inactive piece or None)."""

    from repro_torch.kernels.segment_combine.kernel import (
        CHUNK_ROWS as C,
        PIECE_CHUNKS as K,
    )

    small = [(s, 37) for s in range(5)]
    if name == "tile_of_K_chunks":          # exactly K chunks: one piece
        return small + [(7, K * C - 185)], 768, 1, (7,), None
    if name == "tile_of_K_plus_1_chunks":   # K + 1 chunks: two pieces
        return small + [(7, K * C - 85)], 768, 1, (7,), None
    if name == "hub_mid_chunk":
        return ([(-1, 1000)] + [(s, 13) for s in range(10)]
                + [(20, 3 * K * C + 77)] + [(s, 5) for s in range(21, 200)]
                + [(s, 7) for s in range(300, 400)] + [(-1, 333)],
                1024, 1, (20,), None)
    if name == "two_long_segments":         # a boundary inside a piece
        return ([(-1, 50)] + [(s, 9) for s in range(10)]
                + [(10, 3 * K * C // 2 + 33), (11, 2 * K * C + 99)]
                + [(s, 3) for s in range(12, 250)] + [(-1, 10)],
                512, 1, (10, 11), None)
    if name == "inactive_piece":            # piece 1 of 4 has no valid row
        return ([(3, 4 * K * C)] + [(s, 21) for s in range(4, 100)],
                256, 1, (3,), (K * C, 2 * K * C))
    if name == "wide_payload":              # F = 1024: 8 segments a tile
        return ([(0, 3), (1, 5), (2, 7), (5, (K + 5) * C), (9, 11),
                 (20, 13)], 64, 1024, (5,), None)
    raise ValueError(name)


def _split_case(gen, name, dtype, with_active, device):
    """A case of SPLIT_CASES: ids from its runs, unit-normal values with
    the hubs' rows integers in [1, 8] (every partial sum exact in f32),
    half the rows active when ``with_active``; the inactive piece's rows
    are inactive, or carry id -1 when there is no mask.  Checks that the
    kernel's decomposition (``kernel.summation_shape``) cuts the case as
    its name says.  Returns (vals, ids, n, act, hubs)."""

    import torch

    from repro_torch.kernels.segment_combine.kernel import summation_shape

    runs, n, F, hubs, quiet = _split_runs(name)
    ids = torch.repeat_interleave(
        torch.tensor([i for i, _ in runs], dtype=torch.int32),
        torch.tensor([r for _, r in runs])).to(device)
    E = ids.shape[0]
    act = None
    if with_active:
        act = torch.rand(E, generator=gen, device=device) < 0.5
    if quiet is not None:
        if act is None:
            ids[quiet[0]:quiet[1]] = -1
        else:
            act[quiet[0]:quiet[1]] = False
    vals = torch.randn((E, F), generator=gen, device=device)
    for h in hubs:
        at = ids == h
        vals[at] = torch.randint(1, 9, (int(at.sum()), F), generator=gen,
                                 device=device).float()
    _, pieces = summation_shape(ids, n, F, act)
    got = [int(pieces[h]) for h in hubs]
    want_split = name != "tile_of_K_chunks"
    if any((p > 1) != want_split for p in got):
        raise AssertionError(f"split case {name}: the hubs lie in {got} "
                             f"pieces")
    return vals.to(dtype).contiguous(), ids.contiguous(), n, act, hubs


def _check_combine(vals, ids, n, act, hubs, op, tag):
    """The kernel against plain on one case: max/min bit-equal, sums
    within ``_sum_check``'s bars and the hubs' integer sums exact, two
    launches bit-identical.  Returns (max abs err vs plain, max |kernel -
    float64| / sum|v|, 0 for max/min)."""

    import torch

    from repro_torch.kernels.segment_combine.kernel import (
        segment_combine_cuda,
    )
    from repro_torch.kernels.segment_combine.ref import (
        segment_combine_reference,
    )

    dtype, F = vals.dtype, vals.shape[1]
    ker = segment_combine_cuda(vals, ids, n, op, edge_active=act)
    again = segment_combine_cuda(vals, ids, n, op, edge_active=act)
    ref = segment_combine_reference(vals, ids, n, op, edge_active=act)
    torch.cuda.synchronize()
    if ker.dtype != dtype or ker.shape != (n, F):
        raise AssertionError(f"kernel output {ker.dtype} {tuple(ker.shape)}: "
                             f"{tag}")
    if not torch.equal(ker, again):
        raise AssertionError(f"two launches differ: {tag}")
    if op == "sum":
        err, rel = _sum_check(vals, ids, n, act, ker, ref, tag)
        for h in hubs:
            at = (ids == h) if act is None else (ids == h) & act
            want = vals.float()[at].sum(0).to(dtype)  # integers < 2^24
            if not torch.equal(ker[h], want):
                raise AssertionError(f"hub {h} sum {ker[h].tolist()[:4]} != "
                                     f"exact {want.tolist()[:4]}: {tag}")
        return err, rel
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    err = float((ker.float() - ref.float()).abs().max())
    bad = int((ker.view(bits) != ref.view(bits)).sum())
    if bad:
        raise AssertionError(f"kernel != plain on {bad} elements (max abs "
                             f"err {err}): {tag}")
    return err, 0.0


WIDE_F = 16384                 # two column slices of kernel.ACC_FLOATS


def _wide_case(gen, dtype, with_active, device):
    """A payload of WIDE_F columns, wider than the kernel's accumulator, so
    the wrapper launches once a column slice (ROADMAP C10): ragged E and
    n, padding ids at both ends, half the rows active when
    ``with_active``.  Returns (vals, ids, n, act, hubs=())."""

    import torch

    n, E = 1_021, 20_011
    ids = torch.sort(torch.randint(0, n, (E - 30,), generator=gen,
                                   device=device, dtype=torch.int32)).values
    pad = torch.full((15,), -1, dtype=torch.int32, device=device)
    ids = torch.cat([pad, ids, pad]).contiguous()
    vals = torch.randn((E, WIDE_F), generator=gen, device=device).to(dtype)
    act = None
    if with_active:
        act = (torch.rand(E, generator=gen, device=device) < 0.5).contiguous()
    return vals.contiguous(), ids, n, act, ()


def _parent_segment_combine(vals, ids, n, op):
    """The parent's decomposition of the segment combine (B1): one block
    walks each tile's whole edge range, however long (the library's C entry
    point with split length 0), launched outside the wrapper and its
    count."""

    import torch

    from repro_torch.kernels.segment_combine import kernel as SC

    out = torch.empty((n, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    err = SC._launch(SC._library(), vals, ids, n, op, None, 0, out)
    if err:
        raise RuntimeError(f"the parent's segment combine failed: CUDA "
                           f"error {err}")
    return out


def phase_kernels(device) -> None:
    import torch

    from repro_torch.kernels.segment_combine.kernel import PIECE_CHUNKS

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    n_cases = n_split = 0
    worst = 0.0
    worst_rel = 0.0
    for op in ("sum", "max", "min"):
        for dtype in (torch.float32, torch.bfloat16):
            for with_active in (False, True):
                cases = [(f"F={F}", _kernel_case(gen, dtype, F, with_active,
                                                 device))
                         for F in (1, 2, 8)]
                cases += [(name, _split_case(gen, name, dtype, with_active,
                                             device))
                          for name in SPLIT_CASES]
                cases.append((f"F={WIDE_F}", _wide_case(gen, dtype,
                                                        with_active,
                                                        device)))
                for name, (vals, ids, n, act, hubs) in cases:
                    tag = (f"{name} op={op} dtype={str(dtype)[6:]} "
                           f"F={vals.shape[1]} active={with_active} "
                           f"E={ids.shape[0]} n={n}")
                    err, rel = _check_combine(vals, ids, n, act, hubs, op,
                                              tag)
                    worst = max(worst, err)
                    worst_rel = max(worst_rel, rel)
                    n_cases += 1
                    n_split += name in SPLIT_CASES
                del cases
    print(f"kernels: segment_combine == plain on {n_cases} cases, "
          f"{n_split} of them hub-split cases {list(SPLIT_CASES)} (K = "
          f"{PIECE_CHUNKS} chunks a piece), 12 at F = {WIDE_F} (one launch a "
          f"column slice) (max/min bit-equal; sums within "
          f"gamma_d sum|v| of float64, d = kernel.sum_depth of the "
          f"segment's chunks and pieces, and within that plus gamma_m "
          f"sum|v| of plain, bf16 + 2^-8 |sum|; integer-valued hubs, one of "
          f"{HUB_ROWS} rows, summed exactly; two launches bit-identical); "
          f"max abs err vs plain {worst}, max |kernel - float64| / sum|v| "
          f"{worst_rel:.3e}")


# ---------------------------------------------------------------------------
# Graphs (numpy, from the seed)
# ---------------------------------------------------------------------------


def power_law_graph(n: int, mean_degree: float, seed: int):
    """A directed multigraph with web-graph degree tails (Chung-Lu style).

    Each edge draws its source and its destination independently; the
    vertex of rank r, over a random order of the vertices (one order for
    sources, another for destinations), is drawn with probability about
    proportional to (r + 1)^-a.  Its expected degree is then proportional
    to (r + 1)^-a, so degrees follow P(k) ~ k^-(1 + 1/a): a = 1/1.1 gives
    the in-degree exponent 2.1 and a = 1/1.72 the out-degree exponent 2.72
    of IN_DEGREE_EXPONENT / OUT_DEGREE_EXPONENT.  Self-loops and repeated
    edges are kept."""

    import numpy as np

    rng = np.random.default_rng(seed)
    e = int(round(n * mean_degree))

    def endpoints(order, exponent):
        # Inverse transform of the density ~ x^-a on [1, n + 1); the rank
        # is floor(x) - 1.
        b = 1.0 - 1.0 / (exponent - 1.0)
        span = (n + 1.0) ** b - 1.0
        out = np.empty(e, np.int32)
        step = 1 << 24
        for lo in range(0, e, step):
            u = rng.random(min(step, e - lo))
            x = np.power(1.0 + u * span, 1.0 / b)
            rank = np.minimum(x.astype(np.int64) - 1, n - 1)
            out[lo:lo + u.shape[0]] = order[rank]
        return out

    src = endpoints(rng.permutation(n).astype(np.int32), OUT_DEGREE_EXPONENT)
    dst = endpoints(rng.permutation(n).astype(np.int32), IN_DEGREE_EXPONENT)
    return src, dst


@functools.lru_cache(maxsize=1)
def _webgraph(n: int, seed: int):
    """``power_law_graph(n, WEBMAP_MEAN_OUT_DEGREE, seed)``, made once for
    the pagerank phase and the ft phase after it (1.5 GB of host memory at
    2^25 vertices)."""

    return power_law_graph(n, WEBMAP_MEAN_OUT_DEGREE, seed)


# ---------------------------------------------------------------------------
# Phase 3: PageRank, the main path
# ---------------------------------------------------------------------------


def pagerank_program(n: int):
    import torch

    from repro_torch.core.pregel import VertexProgram

    return VertexProgram(
        init_vertex=lambda ids, outdeg: torch.stack(
            [torch.full((n,), 1.0 / n, device=ids.device), outdeg], dim=1),
        message=lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0),
        apply=lambda j, s, inbox, got: (
            torch.stack([0.15 / n + 0.85 * inbox, s[:, 1]], dim=1),
            torch.ones(s.shape[0], dtype=torch.bool, device=s.device),
        ),
        combine="sum",
    )


def pagerank_oracle(src, dst, n: int, iters: int):
    """float64 PageRank with the Pregel semantics of the program above: a
    vertex that gets no message from an active source keeps its rank and
    halts; halted sources send nothing.  The products run on row blocks in
    threads (scipy releases the interpreter lock in them)."""

    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import scipy.sparse as sp

    outdeg = np.maximum(np.bincount(src, minlength=n), 1).astype(np.float64)
    A = sp.csr_matrix(
        (np.ones(src.shape[0], np.float64), (dst, src)), shape=(n, n))
    bounds = np.linspace(0, n, 9).astype(np.int64)
    blocks = [A[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    del A
    r = np.full(n, 1.0 / n)
    active = np.ones(n, np.float64)
    got, got_of = None, None
    with ThreadPoolExecutor(len(blocks)) as pool:
        def matvec(x):
            return np.concatenate(list(pool.map(lambda b: b @ x, blocks)))

        for _ in range(iters):
            inbox = matvec(active * r / outdeg)
            # got depends on the active set alone: recompute it only when
            # the active set changed.
            if got_of is None or not np.array_equal(got_of, active):
                got, got_of = matvec(active) > 0, active
            r = np.where(got, 0.15 / n + 0.85 * inbox, r)
            active = got.astype(np.float64)
    return r


def _profile_supersteps(ex, carry, steps: int = 2) -> None:
    """Device time by kernel over ``steps`` dense supersteps (not counted
    as main-path launches), and the device's idle share of that window."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(steps):
            carry = ex.superstep(carry, j)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel events only: operator-level events also carry their kernels'
    # device time, which would count it twice.
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(t for _, t in rows)
    print(f"profile: {steps} supersteps, wall {wall_us / steps / 1e3:.3f} "
          f"ms/superstep, device busy {busy / steps / 1e3:.3f} ms/superstep, "
          f"idle share {max(0.0, 1 - busy / wall_us):.3f}")
    for key, t in rows[:10]:
        print(f"profile:   {t / steps / 1e3:9.3f} ms/superstep "
              f"{t / busy:6.1%}  {key[:90]}")


def phase_pagerank(args, device, report) -> None:
    import numpy as np
    import torch

    from repro_torch.carry import graph_from_numpy
    from repro_torch.core.pregel import compile_pregel
    from repro_torch.kernels.segment_combine import kernel as sc_kernel
    from repro_torch.kernels.segment_combine.kernel import (
        PIECE_CHUNKS,
        segment_combine_cuda,
    )
    from repro_torch.kernels.segment_combine.ref import (
        segment_combine_reference,
    )

    n = 1 << args.log2_vertices
    t0 = time.perf_counter()
    src, dst = _webgraph(n, args.seed)
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    max_in = int(np.bincount(dst, minlength=n).max())
    print(f"pagerank: graph n={n} e={src.shape[0]} max in-degree {max_in} "
          f"max out-degree {int(outdeg.max())} made in "
          f"{time.perf_counter() - t0:.1f}s")
    g = graph_from_numpy(n, src, dst, outdeg, device=device)
    ex = compile_pregel(pagerank_program(n), g, device=device)
    if ex.plan.connector != "dense_psum":
        raise AssertionError(f"planner chose {ex.plan.connector}")

    torch.cuda.synchronize()
    sc_kernel.reset_launch_count()
    res = ex.run(max_iters=args.supersteps)
    launches = sc_kernel.launch_count
    rank = res.state[0][:, 0].double().cpu().numpy()
    if res.iterations != args.supersteps:
        raise AssertionError(f"ran {res.iterations} supersteps")
    if launches < 2 * args.supersteps:
        raise AssertionError(f"kernel launched {launches} times in "
                             f"{args.supersteps} supersteps")
    t1 = time.perf_counter()
    oracle = pagerank_oracle(src, dst, n, args.supersteps)
    rel_l1 = float(np.abs(rank - oracle).sum() / np.abs(oracle).sum())
    print(f"pagerank: {res.iterations} supersteps in {res.seconds:.3f}s "
          f"({res.seconds / res.iterations * 1e3:.2f} ms/superstep), "
          f"plan {ex.plan.notes}, kernel launches {launches}; "
          f"rel L1 vs scipy float64 {rel_l1:.3e} (tol {PAGERANK_L1_TOL}, "
          f"oracle {time.perf_counter() - t1:.1f}s)")
    if not (np.isfinite(rank).all() and rel_l1 <= PAGERANK_L1_TOL):
        raise AssertionError("PageRank disagrees with the oracle")

    print(f"pagerank: {src.shape[0] * res.iterations / res.seconds:.4e} "
          f"edges/s end to end")
    _profile_supersteps(ex, res.state)

    # The kernel at the main path's shapes: one superstep's inbox combine
    # (values sorted by destination, no frontier mask).
    state = res.state[0]
    ids, order = torch.sort(g.dst, stable=True)
    msg = (state[:, 0] / torch.clamp(state[:, 1], min=1.0))
    vals = msg.index_select(0, g.src)[order].reshape(-1, 1).contiguous()
    del state, msg, order, res
    ker = segment_combine_cuda(vals, ids, n, "sum")
    if not torch.equal(ker, segment_combine_cuda(vals, ids, n, "sum")):
        raise AssertionError("two launches differ at the main path's shapes")
    ref = segment_combine_reference(vals, ids, n, "sum")
    max_abs_err, rel = _sum_check(vals, ids, n, None, ker, ref,
                                  "main path's shapes")
    print(f"pagerank: at the main path's shapes, kernel within its bound of "
          f"float64 and of plain; max |kernel - float64| / sum|v| {rel:.3e} "
          f"(= relative error: the messages are positive), "
          f"max abs err vs plain {max_abs_err}")
    lengths = torch.bincount(ids.long(), minlength=n)
    # The kernel and the parent's decomposition (one block walks each tile,
    # the hub's too) in turns: new, parent, parent, new.
    calls = {"new": lambda: segment_combine_cuda(vals, ids, n, "sum"),
             "parent": lambda: _parent_segment_combine(vals, ids, n, "sum")}
    turns = []
    for name in ("new", "parent", "parent", "new"):
        t, out = _timed(calls[name], 10)
        turns.append(t)
        if name == "parent":
            parent_out = out
        del out
    ms = (turns[0] + turns[3]) / 2
    parent_ms = (turns[1] + turns[2]) / 2
    parent_rel = _same_function("segment combine", [parent_out], [ker])
    del parent_out
    plain_ms = _time_ms(
        lambda: segment_combine_reference(vals, ids, n, "sum"), 3)
    library_ms = _time_ms(
        lambda: torch.segment_reduce(vals, "sum", lengths=lengths), 3)
    E, F = vals.shape
    # The call a PyTorch user would write for this sum: float atomics, so
    # not bit-reproducible from run to run (the port never calls it).
    ids64 = ids.long()
    index_add_ms = _time_ms(lambda: torch.zeros(
        (n, F), device=device).index_add_(0, ids64, vals), 10)
    del ids64
    bytes_moved = E * (4 * F + 4) + n * 4 * F
    report.append({
        "name": "segment_combine",
        "route": "cuda",
        "source": "src/repro_torch/csrc/segment_combine.cu",
        "replaces": "src/repro/kernels/segment_combine/kernel.py:106",
        "tpu_kernel": "repro.kernels.segment_combine.kernel."
                      "segment_combine_pallas",
        "launches": launches,
        "launches_per_superstep": launches / args.supersteps,
        "shape": {"E": E, "F": F, "n": n, "edge_active": False,
                  "max_segment_rows": max_in},
        "max_abs_err": max_abs_err,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "library": "torch.segment_reduce",
        "index_add_ms": index_add_ms,
        "index_add": "torch.zeros(n, F).index_add_(0, ids, vals): float "
                     "atomics, not bit-reproducible",
        "piece_chunks": PIECE_CHUNKS,
        "parent_ms": parent_ms,
        "parent_design": "one block per tile of segments (split 0)",
    })
    print(f"pagerank: segment_combine at E={E} F={F} n={n}: kernel "
          f"{ms:.3f} ms (pieces of at most {PIECE_CHUNKS} chunks), the "
          f"parent's decomposition (one block per tile) {parent_ms:.3f} ms "
          f"(in turns: {', '.join(f'{t:.3f}' for t in turns)}; rel L2 from "
          f"the kernel's {parent_rel:.3e}), plain {plain_ms:.3f} ms, "
          f"torch.segment_reduce "
          f"{library_ms:.3f} ms, index_add_ (float atomics, not "
          f"bit-reproducible) {index_add_ms:.3f} ms, bound "
          f"{bytes_moved / HBM_BYTES_PER_S * 1e3:.3f} ms")
    del g, ex, vals, ids, ker, ref, lengths
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4: semi-naive SSSP, merging connector
# ---------------------------------------------------------------------------


def phase_sssp(args, device) -> None:
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    import torch

    from repro_torch.carry import graph_from_numpy
    from repro_torch.core.pregel import VertexProgram, compile_pregel
    from repro_torch.kernels.segment_combine import kernel as sc_kernel

    n = 1 << args.sssp_log2_vertices
    src, dst = power_law_graph(n, WEBMAP_MEAN_OUT_DEGREE, args.seed + 1)
    source = int(np.bincount(src, minlength=n).argmax())
    inf = 1e9
    prog = VertexProgram(
        init_vertex=lambda ids, vd: torch.where(ids == source, 0.0, inf),
        message=lambda j, s, ed: s + 1.0,
        apply=lambda j, s, inbox, got: (torch.minimum(s, inbox),
                                        torch.minimum(s, inbox) < s),
        combine="min",
    )
    g = graph_from_numpy(n, src, dst, np.zeros(n, np.float32), device=device)
    ex = compile_pregel(prog, g, force_connector="merging", semi_naive=True,
                        device=device)
    sc_kernel.reset_launch_count()
    res = ex.run(max_iters=1000)
    launches = sc_kernel.launch_count
    dist = res.state[0].double().cpu().numpy()
    A = sp.csr_matrix((np.ones(src.shape[0]), (src, dst)), shape=(n, n))
    want = csgraph.shortest_path(A, directed=True, unweighted=True,
                                 indices=source)
    want = np.where(np.isinf(want), inf, want)
    sparse_modes = [m for m in res.modes if m.startswith("sparse@")]
    print(f"sssp: n={n} e={src.shape[0]} converged={res.converged} in "
          f"{res.iterations} supersteps ({res.seconds:.3f}s), modes "
          f"{res.modes}, kernel launches {launches}, reached "
          f"{int((dist < inf).sum())} vertices")
    if not res.converged or not np.array_equal(dist, want):
        raise AssertionError("SSSP disagrees with scipy BFS")
    if not sparse_modes or launches == 0:
        raise AssertionError("SSSP ran no sparse superstep on the kernel")
    del g, ex, res
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: IMRU batch gradient descent (Listing 2)
# ---------------------------------------------------------------------------
#
# The paper's §5.1 task: 16,557,921 records of about 5.2 KB (80 GB,
# configs/bgd.py), sparse vectors of about 4k nonzeros.  Cut to 2^23 records
# of IMRU_FEATURES dense f32 features and an f32 label (5,124 B a record,
# 42.98 GB on the card) to fit one card.  BGD with lr = IMRU_LR_SCALE / n:
# X^T X is about n I for unit-normal features, so each iteration moves the
# model 5% of the way to w_true and 10 iterations stay far from the fixpoint
# (a microbatch skipped shows).

IMRU_FEATURES = 1280
IMRU_ITERATIONS = 10
IMRU_LR_SCALE = 0.05
# The bar on the f32 model's distance from the float64 oracle, lambda
# sqrt(sum_k V_k) (see _imru_oracle).  With the rounding errors of mean
# zero, E ||m - m64||^2 <= sum_k V_k, so by Markov's inequality the bar
# fails with probability below 1 / lambda^2 = 6% even if every error were
# one and the same; with the 1280 components' errors independent, as the
# model has them, ||m - m64||^2 is a sum of 1280 terms and the chance is a
# chi-square tail, far smaller.
IMRU_LAMBDA = 4.0
IMRU_ORACLE_ROWS = 1 << 18


def _imru_records(n, d, seed, device):
    """Unit-normal features and labels y = X w_true, made on the card from
    ``seed`` in slices of 2^20 records; returns (records, w_true)."""

    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    w_true = torch.randn(d, generator=gen, device=device)
    X = torch.empty((n, d), device=device)
    y = torch.empty(n, device=device)
    for s in range(0, n, 1 << 20):
        e = min(s + (1 << 20), n)
        X[s:e].normal_(generator=gen)
        y[s:e] = X[s:e] @ w_true
    return {"x": X, "y": y}, w_true


def _imru_oracle(X, y, lr, iters, bounds):
    """float64 BGD on the card, chunk by chunk, sharing no code with the
    port's IMRU, and the bar on the f32 run's distance from it.

    Rounding errors are modelled as mean-independent, each within u =
    2^-24 of its result (Higham & Mary's probabilistic model).  Iteration k
    then adds to the f32 model an error of mean zero and variance V_k, and
    with ||I - lr X^T X||_2 <= 1 the errors carry over undamped at most, so
    E ||m_K - m64_K||^2 <= sum_k V_k.  V_k has two parts:

    * the map's: lr^2 ||g32_k - g64_k||^2, measured.  g32_k is the f32
      gradient at the oracle's model rounded to f32, mapped over the
      microbatch ``bounds`` and added in their order (the plain statement
      of the task's map, with cuBLAS's GEMVs at the run's shapes), g64_k
      the float64 gradient.  cuBLAS documents no summation order for its
      split-K GEMV, so the depth of its sums is not known and their
      rounding is read here, not bounded from a depth: a bound for any
      order (depth up to the microbatch's 2.8M rows) lies 4e5 times above
      the run's error.
    * the update's (``m - lr g``: a product and a subtraction, each
      rounded with variance at most u^2 / 3 of its square):
      (u^2 / 3) (||lr g64_k||^2 + ||m64_{k+1}||^2).

    ``lr`` is the f32 step size the run multiplies by.  Returns (w, bar)."""

    import torch

    d = X.shape[1]
    w = torch.zeros(d, dtype=torch.float64, device=X.device)
    var = 0.0
    for _ in range(iters):
        g = torch.zeros_like(w)
        w32 = w.float()
        g32 = None
        for s, e in bounds:
            for c in range(s, e, IMRU_ORACLE_ROWS):
                xc = X[c:min(c + IMRU_ORACLE_ROWS, e)].double()
                yc = y[c:min(c + IMRU_ORACLE_ROWS, e)].double()
                g += (xc @ w - yc) @ xc
                del xc, yc
            x = X[s:e]
            part = (x @ w32 - y[s:e]) @ x
            g32 = part if g32 is None else g32 + part
        step = lr * g
        w = w - step
        var += (lr * float((g32.double() - g).norm())) ** 2
        var += F32_UNIT ** 2 / 3 * (float(step.norm()) ** 2
                                    + float(w.norm()) ** 2)
    return w, IMRU_LAMBDA * math.sqrt(var)


def _bgd_task(d, lr, device, map_fn=None):
    """BGD (the paper's §5.1 task) as an IMRU task on ``device``."""

    import torch

    from repro_torch.core.imru import IMRUTask

    return IMRUTask(
        init_model=lambda: torch.zeros(d, device=device),
        map=map_fn or (lambda rec, m: (rec["x"] @ m - rec["y"]) @ rec["x"]),
        update=lambda j, m, g: m - lr * g,
        tol=0.0,
    )


def phase_imru(args, device) -> None:
    """BGD through ``compile_imru`` (the planner's plan for the H100) and
    ``ex.run``, on the device driver and the host driver, held against a
    float64 oracle within a bar of the f32 rounding (``_imru_oracle``);
    three controls (one microbatch skipped, the tail dropped as the
    reference drops it, the map run in bf16) must each break it.  No TPU
    kernel is on this path: the map is two f32 GEMVs (cuBLAS) and the
    reduce is the identity on one device."""

    import torch

    from repro_torch.core.executor import microbatch_slices
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.imru import compile_imru

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the f32 bar assumes f32")
    n, d = 1 << args.imru_log2_records, IMRU_FEATURES
    t0 = time.perf_counter()
    records, w_true = _imru_records(n, d, args.seed, device)
    torch.cuda.synchronize()
    lr = IMRU_LR_SCALE / n

    def bgd(map_fn=None):
        return _bgd_task(d, lr, device, map_fn)

    ex = compile_imru(bgd(), records, hw=H100_SXM, device=device)
    if ex.plan.microbatches < 3:
        # A rehearsal's records fit in one microbatch: force 3, so that the
        # planted faults have a microbatch to skip and a tail to drop.
        print(f"imru: rehearsal: the planner chose {ex.plan.microbatches} "
              f"microbatch(es); 3 forced")
        ex = compile_imru(bgd(), records, hw=H100_SXM, microbatches=3,
                          device=device)
    slices = microbatch_slices(n, ex.plan.microbatches)
    data_bytes = ex.stats.n_records * ex.stats.record_bytes
    bound_ms = data_bytes / HBM_BYTES_PER_S * 1e3
    print(f"imru: {n} records x {d} f32 features + label "
          f"({ex.stats.record_bytes} B a record, {data_bytes / 1e9:.2f} GB) "
          f"made in {time.perf_counter() - t0:.1f}s; plan {ex.plan.notes}, "
          f"{ex.plan.microbatches} microbatches of {slices[0][1]} records "
          f"and {len(slices) - ex.plan.microbatches} tail slice(s) of "
          f"{[e - s for s, e in slices[ex.plan.microbatches:]]} records "
          f"(every record counts, ROADMAP C8); plan_imru's estimate "
          f"{ex.plan.est_step_seconds * 1e3:.3f} ms")
    # The device driver, the host driver, then the device driver again
    # (timed warm: the first run pays cuBLAS's first-call set-up).
    dev = ex.run(max_iters=IMRU_ITERATIONS)
    host = ex.run(max_iters=IMRU_ITERATIONS, on_device=False)
    warm = ex.run(max_iters=IMRU_ITERATIONS)
    if {dev.iterations, host.iterations, warm.iterations} != \
            {IMRU_ITERATIONS}:
        raise AssertionError(f"ran {dev.iterations} / {host.iterations} / "
                             f"{warm.iterations} iterations")
    if not (torch.equal(dev.state, host.state)
            and torch.equal(dev.state, warm.state)):
        raise AssertionError("the device and host drivers disagree")
    ms = warm.seconds / warm.iterations * 1e3
    host_ms = host.seconds / host.iterations * 1e3
    cold_ms = dev.seconds / dev.iterations * 1e3
    model = dev.state.clone()
    step_ms = _time_ms(lambda: ex.step(model, 0), 5)

    # The oracle's own microbatch bounds, as the plan states them: slices
    # of n // microbatches records, then the rest.
    size = n // ex.plan.microbatches
    bounds = [(s, min(s + size, n)) for s in range(0, n, size)]
    lr32 = float(torch.tensor(lr, dtype=torch.float32))
    t1 = time.perf_counter()
    oracle, bar = _imru_oracle(records["x"], records["y"], lr32,
                               IMRU_ITERATIONS, bounds)
    err = float((dev.state.double() - oracle).norm())
    moved = float(oracle.norm() / w_true.double().norm())
    print(f"imru: {IMRU_ITERATIONS} iterations, ||m - m64||_2 {err:.4e} "
          f"against its bar {bar:.4e} (lambda {IMRU_LAMBDA}, oracle "
          f"{time.perf_counter() - t1:.1f}s); ||m64|| / ||w_true|| "
          f"{moved:.4f}; host driver equal to the device driver")
    if not (torch.isfinite(dev.state).all() and err <= bar):
        raise AssertionError("IMRU disagrees with the float64 oracle")

    # Controls through the same path, each of which must break the bar:
    # the map of one iteration's second microbatch returns zeros; the
    # tail's does (the reference's C8 behaviour); the map runs in bf16.
    def skipping(skip):
        calls = [0]

        def map_fn(rec, m):
            k = calls[0] % len(slices)
            calls[0] += 1
            g = (rec["x"] @ m - rec["y"]) @ rec["x"]
            return torch.zeros_like(g) if k == skip else g

        return map_fn

    def bf16_map(rec, m):
        xb = rec["x"].to(torch.bfloat16)
        r = (xb @ m.to(torch.bfloat16)).float() - rec["y"]
        return (r.to(torch.bfloat16) @ xb).float()

    if len(slices) == ex.plan.microbatches:
        raise AssertionError("no tail: choose a record count that "
                             "microbatches do not divide")
    controls = {"one microbatch skipped": skipping(1),
                "tail dropped": skipping(len(slices) - 1),
                "map in bf16": bf16_map}
    control_err = {}
    for name, map_fn in controls.items():
        bad = compile_imru(bgd(map_fn), records, hw=H100_SXM,
                           microbatches=ex.plan.microbatches, device=device)
        res = bad.run(max_iters=IMRU_ITERATIONS)
        control_err[name] = float((res.state.double() - oracle).norm())
        del bad, res
    print("imru: controls: " + ", ".join(
        f"{k} {v:.4e} ({v / bar:.1f}x the bar)"
        for k, v in control_err.items()) + f"; the sound run "
        f"{err / bar:.3f}x the bar")
    for name, e in control_err.items():
        if not e > bar:
            raise AssertionError(f"IMRU control falls inside the bar: {name}")

    print(f"imru: {ms:.3f} ms/iteration on the device driver (first run "
          f"{cold_ms:.3f}; {host_ms:.3f} on the host driver; the step alone "
          f"{step_ms:.3f} ms by CUDA events), {n / ms * 1e3:.4e} records/s, "
          f"bytes bound "
          f"{bound_ms:.3f} ms (the records read once): {bound_ms / ms:.1%} "
          f"of it")
    _profile(lambda: ex.step(model, 0), "imru iteration", 1)
    report_imru = {"ms": ms, "cold_ms": cold_ms, "host_ms": host_ms,
                   "step_ms": step_ms,
                   "bound_ms": bound_ms, "records": n,
                   "microbatches": ex.plan.microbatches, "err": err,
                   "bar": bar, "controls": control_err}
    print(f"imru: {json.dumps(report_imru)}")
    del records, ex, dev, host, warm, model, oracle, w_true


# ---------------------------------------------------------------------------
# Phase 6: the generic dense-grid engine (compile_program)
# ---------------------------------------------------------------------------


def _tc_oracle(src, dst, n):
    """The transitive closure (paths of length >= 1) by repeated f32
    matrix products of 0/1 matrices (exact: sums below 2^24)."""

    import numpy as np

    adj = np.zeros((n, n), np.float32)
    adj[src, dst] = 1.0
    tc = adj > 0
    while True:
        new = tc | ((tc.astype(np.float32) @ adj) > 0)
        if (new == tc).all():
            return tc
        tc = new


def phase_generic(args, device) -> None:
    """The generic engine at the largest domain the planner keeps on dense
    grids for a binary predicate (n^2 cells under its row-table minimum):
    transitive closure (host and device drivers, naive and semi-naive),
    connected components (semi-naive) and the parsed transitive-closure
    text through the rewrite pass, each exactly equal to a numpy/scipy
    oracle.  Joins, projections and GroupBys are dense tensor ops there (a
    sum/max/min GroupBy is a masked reduction).  The planner takes the
    segment scan instead only on grids of at most 21 cells: a PageRank ->
    threshold -> reach pipeline on 4 vertices drives that route, which
    reaches the segment-combine kernel, and counts its launches."""

    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    import torch

    from repro_torch.core.executor import Relation, compile_program
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.listings import (
        TRANSITIVE_CLOSURE_TEXT,
        connected_components_program,
        pagerank_threshold_program,
        transitive_closure_program,
    )
    from repro_torch.core.parser import parse
    from repro_torch.kernels.segment_combine import kernel as sc_kernel

    n = args.generic_domain
    rng = np.random.default_rng(args.seed + 2)
    src = rng.integers(0, n, 2 * n)
    dst = rng.integers(0, n, 2 * n)
    t0 = time.perf_counter()
    want_tc = _tc_oracle(src, dst, n)
    print(f"generic: n={n}, {2 * n} random edges, closure of "
          f"{int(want_tc.sum())} pairs (oracle {time.perf_counter() - t0:.1f}"
          f"s); the T2 join grid is n^3 bool = {n ** 3} B")
    edge = Relation.from_columns(n, src, dst, device=device)

    def run_twice(ex, **run_kw):
        """(first run, second run, peak bytes above the start): the second
        is timed warm, the first pays the kernels' first-call set-up."""

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cold = ex.run(max_iters=4 * n, **run_kw)
        res = ex.run(max_iters=4 * n, **run_kw)
        return cold, res, torch.cuda.max_memory_allocated() - base

    def ms_line(cold, res):
        return (f"{res.iterations} iterations in {res.seconds:.4f}s "
                f"({res.seconds / res.iterations * 1e3:.3f} ms/iteration; "
                f"first run {cold.seconds / cold.iterations * 1e3:.3f})")

    def check_tc(ex, tag, **run_kw):
        cold, res, peak = run_twice(ex, **run_kw)
        print(f"generic: {tag}: {ms_line(cold, res)}, converged "
              f"{res.converged}, peak memory above the start {peak} B")
        for r in (cold, res):
            got = r.state["tc"].present.cpu().numpy()
            if not (r.converged and np.array_equal(got, want_tc)):
                raise AssertionError(f"transitive closure disagrees: {tag}")

    for semi_naive in (False, True):
        ex = compile_program(transitive_closure_program(), {"edge": edge},
                             semi_naive=semi_naive, hw=H100_SXM,
                             device=device)
        print(f"generic: tc semi_naive={semi_naive} plan {ex.plan.notes}")
        for on_device in (False, True):
            check_tc(ex, f"tc semi_naive={semi_naive} "
                     f"{'device' if on_device else 'host'} driver",
                     on_device=on_device)
        if semi_naive:
            step, state = ex.phase_step_fn()
            _profile(lambda: step(state, 1), "tc iteration", 1)

    parsed = parse(TRANSITIVE_CLOSURE_TEXT, name="transitive-closure")
    ex = compile_program(parsed, {"edge": edge}, rewrite=True, hw=H100_SXM,
                         device=device)
    print(f"generic: parsed TRANSITIVE_CLOSURE_TEXT, rewrite=True, plan "
          f"{ex.plan.notes}")
    check_tc(ex, "parsed tc, rewrite", on_device=True)

    # Connected components of an undirected graph in several pieces: the
    # vertices split into 8 blocks with edges inside a block only.
    blocks = rng.integers(0, 8, n)
    order = np.argsort(blocks, kind="stable")
    pos = np.searchsorted(blocks[order], np.arange(9))
    a, b = [], []
    for k in range(8):
        members = order[pos[k]:pos[k + 1]]
        m = len(members)
        a.append(members[rng.integers(0, m, m)])
        b.append(members[rng.integers(0, m, m)])
    a, b = np.concatenate(a), np.concatenate(b)
    s2, d2 = np.concatenate([a, b]), np.concatenate([b, a])
    k, labels = connected_components(
        coo_matrix((np.ones(len(s2)), (s2, d2)), shape=(n, n)),
        directed=False)
    want_cc = np.full(k, n, np.int64)
    np.minimum.at(want_cc, labels, np.arange(n))
    ex = compile_program(
        connected_components_program(),
        {"edge": Relation.from_columns(n, s2, d2, device=device),
         "node": Relation.from_columns(n, np.arange(n),
                                       np.arange(n, dtype=np.float32),
                                       device=device)},
        semi_naive=True, hw=H100_SXM, device=device)
    cold, res, peak = run_twice(ex, on_device=True)
    print(f"generic: cc semi-naive, {k} components: {ms_line(cold, res)}, "
          f"peak memory above the start {peak} B, plan {ex.plan.notes}")
    for r in (cold, res):
        got = r.state["cc"].values[1].cpu().numpy()
        if not (r.converged and r.state["cc"].present.all()
                and np.array_equal(got, want_cc[labels].astype(np.float32))):
            raise AssertionError("connected components disagree with scipy")
    step, state = ex.phase_step_fn()
    _profile(lambda: step(state, 1), "cc iteration", 1)
    del edge, ex, cold, res, step, state

    # On a grid of at most 21 cells the planner prefers the segment scan to
    # the masked reduction even for a sum, and the GroupBy reaches the
    # segment-combine kernel: PageRank -> threshold -> reach on 4 vertices
    # against numpy (ranks within 1e-6 relative, sets exact).
    m, iters, tau = 4, 30, 0.25
    src4 = np.repeat(np.arange(m), 2)
    dst4 = np.array([1, 2, 2, 3, 1, 2, 0, 2])
    deg4 = np.bincount(src4, minlength=m).astype(np.float32)
    ex = compile_program(
        pagerank_threshold_program(tau=tau),
        {"edge": Relation.from_columns(m, src4, dst4, device=device),
         "node": Relation.from_columns(
             m, np.arange(m), np.full(m, 1.0 / m, np.float32), deg4,
             np.full(m, 0.15 / m, np.float32), device=device)},
        hw=H100_SXM, device=device)
    if ex.plan.connectors.get("P2") != "segment-scan":
        raise AssertionError(f"tiny grid planned {ex.plan.notes}")
    adj4 = np.zeros((m, m), np.float32)
    adj4[src4, dst4] = 1.0
    r = np.full(m, 1.0 / m, np.float32)
    for _ in range(iters):
        r = (0.85 * (adj4.T @ (r / deg4)) + 0.15 / m).astype(np.float32)
    reach = hot = r > tau
    while True:
        new = reach | ((((adj4 > 0).T @ reach) > 0) & hot)
        if (new == reach).all():
            break
        reach = new
    sc_kernel.reset_launch_count()
    res = ex.run(max_iters=iters, on_device=True)
    launches = sc_kernel.launch_count
    print(f"generic: pagerank -> threshold -> reach on {m} vertices, "
          f"{ex.plan.notes[-1]}: {launches} segment-combine launches in "
          f"{res.iterations} iterations")
    rank = res.state["rank"].values[1].cpu().numpy()
    if not (launches >= res.phase_iterations[0]
            and np.allclose(rank, r, rtol=1e-6, atol=0)
            and (res.state["hot"].present.cpu().numpy() == hot).all()
            and (res.state["reach"].present.cpu().numpy() == reach).all()):
        raise AssertionError("the segment-scan GroupBy disagrees with numpy "
                             "or launched no kernel")
    del ex, res


# ---------------------------------------------------------------------------
# Phase 7: row-table storage past the dense wall (n = 65,536)
# ---------------------------------------------------------------------------

# The largest domain whose binary row codes fit the 2^32 code space.
ROWS_MAX_LOG2 = 16
ROWS_CHAIN = 32                # vertices a chain of the TC input
ROWS_CC_DEGREE = 8             # undirected edges a vertex in the CC input
ROWS_PR_DEGREE = 16            # out-degree of the PageRank input
ROWS_PR_ITERS = 30
ROWS_PR_TAU = 1.5              # threshold, in units of 1/n


def _capture_combines(run, keep=True, depth=1):
    """``(run(), calls)``, with every segment combine the executor made in
    ``run()`` recorded as ``(caller, launches, inputs)``: the executor
    function that called it (with ``depth`` > 1, the names of that many
    callers joined by "/", the nearest first), the kernel launches the call
    made, and (with ``keep``) its ``(values, segment_ids, num_segments, op,
    edge_active)``."""

    from repro_torch.core import executor
    from repro_torch.kernels.segment_combine import kernel as sc_kernel

    real, calls = executor.segment_combine_sorted, []

    def record(values, ids, n, op="sum", *, edge_active=None, **kw):
        before = sc_kernel.launch_count
        out = real(values, ids, n, op, edge_active=edge_active, **kw)
        frame, names = sys._getframe(1), []
        while frame is not None and len(names) < depth:
            names.append(frame.f_code.co_name)
            frame = frame.f_back
        calls.append(("/".join(names), sc_kernel.launch_count - before,
                      (values, ids, n, op, edge_active) if keep else None))
        return out

    executor.segment_combine_sorted = record
    try:
        out = run()
    finally:
        executor.segment_combine_sorted = real
    return out, calls


def _row_site(site, call, launches, phase="rows"):
    """The kernel at one row site's shapes (captured from the path): held
    against its plain version (``_check_combine``: max/min bit-equal, sums
    within their bar, two launches bit-identical), timed in turns with
    it, and beside ``torch.segment_reduce`` on the valid prefix.
    ``launches`` is the site's own count in the workload's counted run."""

    import torch

    from repro_torch.kernels.segment_combine.kernel import (
        segment_combine_cuda,
    )
    from repro_torch.kernels.segment_combine.ref import (
        segment_combine_reference,
    )

    vals, ids, n, op, act = call[2]
    vals = vals.reshape(vals.shape[0], -1).contiguous()
    ids = ids.to(torch.int32).contiguous()
    E, F = vals.shape
    tag = f"{phase} {site}: op={op} E={E} F={F} n={n}"
    err, _ = _check_combine(vals, ids, n, act, (), op, tag)
    n_valid = E if act is None else int(act.sum())
    ker = lambda: segment_combine_cuda(vals, ids, n, op,  # noqa: E731
                                       edge_active=act)
    plain = lambda: segment_combine_reference(  # noqa: E731
        vals, ids, n, op, edge_active=act)
    turns = [_time_ms(ker if i in (0, 3) else plain, 10) for i in range(4)]
    lengths = torch.bincount(ids[:n_valid].long(), minlength=n)
    library_ms = _time_ms(lambda: torch.segment_reduce(
        vals[:n_valid], op, lengths=lengths), 10)
    # The mask of every slot read once, the values and ids of the active
    # rows only (the rest of the slab is the inactive suffix), the output
    # written once.
    bytes_moved = (0 if act is None else E) + n_valid * (4 * F + 4) \
        + n * 4 * F
    entry = {"site": site, "op": op, "E": E, "F": F, "n": n,
             "valid_rows": n_valid, "launches": launches,
             "max_abs_err": err, "ms": (turns[0] + turns[3]) / 2,
             "plain_ms": (turns[1] + turns[2]) / 2,
             "library_ms": library_ms, "library": "torch.segment_reduce "
             "over the valid prefix",
             "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes"}
    print(f"{phase}: segment_combine at the {site} site, E={E} ({n_valid} "
          f"valid) F={F} n={n} op={op}: kernel {entry['ms']:.3f} ms, plain "
          f"{entry['plain_ms']:.3f} ms (in turns: "
          f"{', '.join(f'{t:.3f}' for t in turns)}), segment_reduce "
          f"{library_ms:.3f} ms, bound {entry['bound_ms']:.3f} ms; max abs "
          f"err vs plain {err}")
    return entry


def _row_pagerank_rels(n, src, dst, device, edge_device=None):
    """The EDB of the PageRank -> threshold -> reach pipeline: the edges
    ``src -> dst`` as a ``RowRelation`` on ``edge_device`` (by default the
    card) and a dense ``node`` (initial rank, out-degree, base rank)."""

    import numpy as np

    from repro_torch.core.executor import Relation, RowRelation

    deg = np.bincount(src, minlength=n).astype(np.float32)
    return {"edge": RowRelation.from_columns(n, src, dst,
                                             device=edge_device or device),
            "node": Relation.from_columns(
                n, np.arange(n), np.full(n, 1.0 / n, np.float32), deg,
                np.full(n, 0.15 / n, np.float32), device=device)}


def _row_pagerank(n, rels, device, tau=ROWS_PR_TAU, **kw):
    """The pipeline (threshold ``tau`` / n) on forced row tables over
    ``rels`` (``_row_pagerank_rels``)."""

    from repro_torch.core.executor import compile_program
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.listings import pagerank_threshold_program

    return compile_program(pagerank_threshold_program(tau=tau / n),
                           dict(rels), storage="row-table", hw=H100_SXM,
                           device=device, **kw)


def _row_pagerank_edges(n, degree, rng):
    """``degree`` random out-edges a vertex, repeated edges merged."""

    import numpy as np

    src = np.repeat(np.arange(n), degree)
    dst = rng.integers(0, n, degree * n)
    pairs = np.unique(src * n + dst)
    return pairs // n, pairs % n


def _pipeline_oracle(n, src, dst, iters, tau=ROWS_PR_TAU):
    """(float64 ranks after ``iters`` iterations, the transposed adjacency,
    the vertices within the 1e-5 relative margin of the threshold ``tau`` /
    n)."""

    import numpy as np
    from scipy.sparse import coo_matrix

    deg = np.bincount(src, minlength=n).astype(np.float64)
    adj_t = coo_matrix((np.ones(src.shape[0]), (dst, src)),
                       shape=(n, n)).tocsr()
    r64 = np.full(n, 1.0 / n)
    for _ in range(iters):
        r64 = 0.85 * (adj_t @ (r64 / deg)) + 0.15 / n
    tau = tau / n
    return r64, adj_t, np.abs(r64 - tau) <= PAGERANK_L1_TOL * tau


def _reach_closure(adj_t, hot):
    """The vertices reachable from ``hot`` through ``hot`` vertices."""

    reach = hot.copy()
    while True:
        new = reach | (((adj_t @ reach.astype(float)) > 0) & hot)
        if (new == reach).all():
            return reach
        reach = new


def _pipeline_sets(res, n):
    """(ranks as float64, hot as a bool mask, reach as a bool mask) of a
    pipeline result; the ranks must cover every vertex."""

    import numpy as np

    rank = res.state["rank"]
    if not np.array_equal(rank.tuples()[:, 0], np.arange(n)):
        raise AssertionError("pagerank: rank does not cover every vertex")
    masks = []
    for p in ("hot", "reach"):
        m = np.zeros(n, bool)
        m[res.state[p].tuples()[:, 0]] = True
        masks.append(m)
    return (rank.values[1].double().cpu().numpy(),) + tuple(masks)


def phase_rows(args, device, report) -> None:
    """Row-table storage (``RowRelation`` EDBs, planner-selected and forced
    row tables) at n = 65,536, the largest domain whose binary row codes
    fit the 2^32 code space; every input from ``--seed``, every result
    against an oracle that shares no code with the port:

    * transitive closure of 2,048 disjoint 32-vertex chains (63,488 edges),
      naive and semi-naive, host and device drivers, on planner-selected
      row tables: equal to the chains' closed form (1,015,808 pairs);
    * semi-naive connected components of 2^19 random undirected edges with
      a dense ``node``: equal to scipy's (min label a component); the
      segmented min GroupBy launches the segment-combine kernel;
    * PageRank -> threshold -> reach on forced row tables (out-degree 16,
      30 iterations): ranks within 1e-5 relative L1 of a float64 oracle,
      ``hot`` exact outside a 1e-5 relative margin of tau and ``reach``
      exact given ``hot``; the segmented sum GroupBy and the row merge
      launch the kernel.

    Prints iterations, warm ms per iteration, peak memory, planned caps and
    plan notes for each, profiles one iteration of each, and holds the
    kernel against its plain version at the row sites' shapes."""

    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    import torch

    from repro_torch.core.executor import (
        Relation,
        RowRelation,
        compile_program,
    )
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.listings import (
        connected_components_program,
        transitive_closure_program,
    )
    from repro_torch.kernels.segment_combine import kernel as sc_kernel

    if not 1 <= args.rows_log2_vertices <= ROWS_MAX_LOG2:
        raise ValueError(f"--rows-log2-vertices must be in [1, "
                         f"{ROWS_MAX_LOG2}]: binary row codes over more "
                         f"vertices leave the 2^32 code space")
    n = 1 << args.rows_log2_vertices
    rng = np.random.default_rng(args.seed + 3)

    def run_twice(ex, max_iters, **run_kw):
        """(cold run, warm run, B1 launches in the cold run, those launches
        by the executor function that made them, peak bytes above the
        start)."""

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sc_kernel.reset_launch_count()
        cold, calls = _capture_combines(
            lambda: ex.run(max_iters=max_iters, **run_kw), keep=False)
        launches = sc_kernel.launch_count
        by_site = {}
        for caller, n_launches, _ in calls:
            by_site[caller] = by_site.get(caller, 0) + n_launches
        if sum(by_site.values()) != launches:
            raise AssertionError(f"{launches} segment-combine launches, "
                                 f"{by_site} of them by call site")
        res = ex.run(max_iters=max_iters, **run_kw)
        peak = torch.cuda.max_memory_allocated() - base
        for r in (cold, res):
            if r.storage_fallback:
                raise AssertionError("a row-table run fell back to dense")
        return cold, res, launches, by_site, peak

    def line(tag, ex, cold, res, launches, by_site, peak):
        print(f"rows: {tag}: {res.iterations} iterations "
              f"{tuple(res.phase_iterations)}, "
              f"{res.seconds / res.iterations * 1e3:.3f} ms/iteration warm "
              f"(first run {cold.seconds / cold.iterations * 1e3:.3f}), "
              f"{launches} segment-combine launches "
              f"{json.dumps(by_site)}, peak memory above the start {peak} B")

    def plan_line(tag, ex):
        print(f"rows: {tag} plan: caps {ex.row_caps}, intermediate "
              f"{ex.row_cap}; {ex.plan.notes}")

    sites, launch_counts = [], {}

    # Transitive closure of disjoint chains on planner-selected row tables.
    chains = n // ROWS_CHAIN
    starts = np.arange(chains)[:, None] * ROWS_CHAIN
    src = (starts + np.arange(ROWS_CHAIN - 1)).ravel()
    edge = RowRelation.from_columns(n, src, src + 1, device=device)
    i, j = np.triu_indices(ROWS_CHAIN, 1)
    want_tc = np.stack([(starts + i).ravel(), (starts + j).ravel()], 1)
    want_tc = want_tc[np.lexsort(want_tc.T[::-1])]
    print(f"rows: n={n}, tc over {chains} chains of {ROWS_CHAIN}: "
          f"{src.shape[0]} edges, closure of {want_tc.shape[0]} pairs")
    for semi_naive in (False, True):
        ex = compile_program(transitive_closure_program(), {"edge": edge},
                             semi_naive=semi_naive, hw=H100_SXM,
                             device=device)
        if ex.storage != {"edge": "row-table", "tc": "row-table"}:
            raise AssertionError(f"tc planned {ex.storage}")
        plan_line(f"tc semi_naive={semi_naive}", ex)
        for on_device in (False, True):
            tag = (f"tc semi_naive={semi_naive} "
                   f"{'device' if on_device else 'host'} driver")
            cold, res, launches, by_site, peak = run_twice(
                ex, 4 * ROWS_CHAIN, on_device=on_device)
            line(tag, ex, cold, res, launches, by_site, peak)
            for r in (cold, res):
                if not (r.converged
                        and np.array_equal(r.state["tc"].tuples(), want_tc)):
                    raise AssertionError(f"transitive closure disagrees: "
                                         f"{tag}")
            launch_counts[tag] = launches
        if semi_naive:
            step, state = ex.phase_step_fn()
            _profile(lambda: step(state, 1), "row tc iteration", 1)
            del step, state
    del edge, ex, cold, res

    # Connected components: a RowRelation edge set, a dense node.
    a = rng.integers(0, n, ROWS_CC_DEGREE * n)
    b = rng.integers(0, n, ROWS_CC_DEGREE * n)
    s2, d2 = np.concatenate([a, b]), np.concatenate([b, a])
    edge = RowRelation.from_columns(n, s2, d2, device=device)
    k, labels = connected_components(
        coo_matrix((np.ones(len(s2)), (s2, d2)), shape=(n, n)),
        directed=False)
    low = np.full(k, n, np.int64)
    np.minimum.at(low, labels, np.arange(n))
    want_cc = low[labels].astype(np.float32)
    ex = compile_program(
        connected_components_program(),
        {"edge": edge,
         "node": Relation.from_columns(n, np.arange(n),
                                       np.arange(n, dtype=np.float32),
                                       device=device)},
        semi_naive=True, hw=H100_SXM, device=device)
    plan_line("cc", ex)
    cold, res, launches, by_site, peak = run_twice(ex, 4 * n,
                                                   on_device=True)
    line(f"cc semi-naive, {edge.count()} directed edges, {k} components",
         ex, cold, res, launches, by_site, peak)
    for r in (cold, res):
        if not (r.converged and r.state["cc"].present.all()
                and np.array_equal(r.state["cc"].values[1].cpu().numpy(),
                                   want_cc)):
            raise AssertionError("row-table connected components disagree "
                                 "with scipy")
    if launches < cold.iterations:
        raise AssertionError(f"cc: {launches} segment-combine launches in "
                             f"{cold.iterations} iterations")
    launch_counts["cc"] = launches
    step, state = ex.phase_step_fn()
    _profile(lambda: step(state, 1), "row cc iteration", 1)
    _, calls = _capture_combines(lambda: step(state, 1))
    if [c[0] for c in calls] != ["_groupby_rows"]:
        raise AssertionError(f"a cc iteration ran combines from "
                             f"{[c[0] for c in calls]}")
    sites.append(_row_site("cc groupby", calls[0],
                           by_site["_groupby_rows"]))
    del edge, ex, cold, res, step, state, calls

    # PageRank -> threshold -> reach, every predicate on row tables.
    src, dst = _row_pagerank_edges(n, ROWS_PR_DEGREE, rng)
    ex = _row_pagerank(n, _row_pagerank_rels(n, src, dst, device), device)
    plan_line("pagerank", ex)
    cold, res, launches, by_site, peak = run_twice(ex, ROWS_PR_ITERS,
                                                   on_device=True)
    line(f"pagerank -> threshold -> reach, {src.shape[0]} edges", ex, cold,
         res, launches, by_site, peak)
    if launches < 2 * ROWS_PR_ITERS:
        raise AssertionError(f"pagerank: {launches} segment-combine "
                             f"launches in {ROWS_PR_ITERS} iterations")
    launch_counts["pagerank"] = launches
    r64, adj_t, margin = _pipeline_oracle(n, src, dst, ROWS_PR_ITERS)
    tau = ROWS_PR_TAU / n
    for r in (cold, res):
        got, hot, got_reach = _pipeline_sets(r, n)
        rel_l1 = float(np.abs(got - r64).sum() / np.abs(r64).sum())
        # Inside the margin the port's own choice stands; reach follows hot.
        want_hot = np.where(margin, hot, r64 > tau)
        reach = _reach_closure(adj_t, want_hot)
        if not (r.phase_iterations[0] == ROWS_PR_ITERS
                and rel_l1 <= PAGERANK_L1_TOL
                and np.array_equal(hot, want_hot)
                and np.array_equal(got_reach, reach)):
            raise AssertionError(f"row-table pagerank pipeline disagrees "
                                 f"with float64 (rel L1 {rel_l1:.3e})")
    print(f"rows: pagerank rel L1 vs float64 {rel_l1:.3e} (tol "
          f"{PAGERANK_L1_TOL}); {int(hot.sum())} hot, {int(reach.sum())} "
          f"reached, {int(margin.sum())} vertices inside the {PAGERANK_L1_TOL}"
          f" relative margin of tau")
    step, state = ex.phase_step_fn()
    _profile(lambda: step(state, 1), "row pagerank iteration", 1)
    _, calls = _capture_combines(lambda: step(state, 1))
    if [(c[0], c[2][3]) for c in calls] != [("_groupby_rows", "sum"),
                                            ("_merge_rows", "sum")]:
        raise AssertionError(f"a pagerank iteration ran combines "
                             f"{[(c[0], c[2][3]) for c in calls]}")
    sites.append(_row_site("pagerank groupby", calls[0],
                           by_site["_groupby_rows"]))
    sites.append(_row_site("pagerank merge", calls[1],
                           by_site["_merge_rows"]))
    del ex, cold, res, step, state, calls

    print(f"rows: segment-combine launches by workload "
          f"{json.dumps(launch_counts)}")
    for entry in report:
        if entry["name"] == "segment_combine":
            entry["rows_launches"] = launch_counts
            entry["rows_sites"] = sites


# ---------------------------------------------------------------------------
# Phase 8: fault tolerance (checkpoints, crash-restore, resume)
# ---------------------------------------------------------------------------

FT_EVERY = 4                   # supersteps between checkpoints
FT_CRASHES = (6, 13)           # supersteps the injector crashes at
FT_STOP = 10                   # superstep a run stops at, to resume from
FT_IMRU_LOG2 = 20              # records of the IMRU run (cut from 2^23)
FT_IMRU_CRASH = 4
FT_ROWS_CRASH = 12             # global step of the generic engine's crash


def _tree_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _same_rows(a, b, preds=("rank", "hot", "reach")) -> bool:
    """Two generic-engine results equal bit for bit (rows and values)."""

    import torch

    for p in preds:
        x, y = a.state[p], b.state[p]
        if not torch.equal(x.rows, y.rows):
            return False
        for k in x.values:
            if not torch.equal(x.values[k], y.values[k]):
                return False
    return True


def phase_ft(args, device) -> None:
    """Fault tolerance on the card, every run bit-equal to the uninterrupted
    one (the injector raises on the host; the drivers restore from disk):

    * PageRank at the pagerank phase's size through ``compile_pregel`` on
      the host driver with a checkpoint every FT_EVERY supersteps (the
      ``(state, active)`` carry) into a temporary directory: crashes at
      supersteps FT_CRASHES, and a run stopped at FT_STOP and resumed from
      disk; the uninterrupted host-driver run must equal the device
      driver's.  Prints a checkpoint's bytes, the save's synchronous
      device-to-host copy and the writer's I/O in ms, and ms per superstep
      with and without checkpoints.
    * IMRU BGD on 2^FT_IMRU_LOG2 records of the imru phase's 1280
      features, a crash at iteration FT_IMRU_CRASH (bit-equal, or within
      the imru phase's bar if cuBLAS is not run-to-run reproducible, with
      the reason printed).
    * The rows phase's forced-row PageRank -> threshold -> reach pipeline
      at n = 2^--rows-log2-vertices: a crash in phase 1, then a crash at
      phase 2's first step with no restarts left and a phase-cursor resume
      from disk whose phase-1 crash point never fires."""

    import tempfile

    import numpy as np
    import torch

    from repro_torch.carry import graph_from_numpy
    from repro_torch.checkpoint import CheckpointStore, latest_step
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.imru import compile_imru
    from repro_torch.core.pregel import compile_pregel
    from repro_torch.ft import FailureInjector

    steps = args.supersteps
    if steps <= max(FT_CRASHES):
        raise ValueError(f"--supersteps must exceed {max(FT_CRASHES)}")
    n = 1 << args.log2_vertices
    src, dst = _webgraph(n, args.seed)
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    g = graph_from_numpy(n, src, dst, outdeg, device=device)
    ex = compile_pregel(pagerank_program(n), g, device=device)
    dev_run = ex.run(max_iters=steps)
    host = ex.run(max_iters=steps, on_device=False)

    def same(res):
        return (torch.equal(res.state[0], dev_run.state[0])
                and torch.equal(res.state[1], dev_run.state[1]))

    if not same(host):
        raise AssertionError("ft: the host driver disagrees with the device "
                             "driver")
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        ck = ex.run(max_iters=steps, checkpoint_dir=str(root / "every"),
                    checkpoint_every=FT_EVERY)
        ckpt_bytes = _tree_bytes(
            root / "every" / f"step_{latest_step(str(root / 'every')):08d}")
        inj = FailureInjector(crashes=FT_CRASHES)
        crashed = ex.run(max_iters=steps, checkpoint_dir=str(root / "crash"),
                         checkpoint_every=FT_EVERY, injector=inj)
        stopped = ex.run(max_iters=FT_STOP,
                         checkpoint_dir=str(root / "resume"),
                         checkpoint_every=FT_EVERY)
        resumed = ex.run(max_iters=steps,
                         checkpoint_dir=str(root / "resume"), resume=True)
        # One save alone: the synchronous copy to the host, then the I/O.
        store = CheckpointStore(str(root / "timing"), keep=1)
        save_ms, io_ms = [], []
        for k in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            store.save(k, dev_run.state)
            t1 = time.perf_counter()
            store.wait()
            save_ms.append((t1 - t0) * 1e3)
            io_ms.append((time.perf_counter() - t1) * 1e3)
    for tag, res in (("with checkpoints", ck), ("crashed", crashed),
                     ("resumed", resumed)):
        if not same(res):
            raise AssertionError(f"ft: the pagerank run {tag} is not "
                                 f"bit-equal to the uninterrupted one")
    if crashed.restarts != len(FT_CRASHES) or \
            [e.step for e in inj.fired] != list(FT_CRASHES):
        raise AssertionError(f"ft: {crashed.restarts} restarts, fired "
                             f"{inj.fired}")
    if stopped.iterations != FT_STOP or \
            resumed.iterations != steps - FT_STOP:
        raise AssertionError(f"ft: stopped after {stopped.iterations}, "
                             f"resumed for {resumed.iterations}")
    per = lambda r: r.seconds / r.iterations * 1e3  # noqa: E731
    print(f"ft: pagerank n={n} e={src.shape[0]}, {steps} supersteps: host "
          f"driver {per(host):.3f} ms/superstep (device driver "
          f"{per(dev_run):.3f}), with a checkpoint every {FT_EVERY} "
          f"{per(ck):.3f}; crashes at {FT_CRASHES}: {crashed.restarts} "
          f"restarts, {crashed.seconds:.3f} s in all (uninterrupted "
          f"{ck.seconds:.3f}); stopped at {FT_STOP} and resumed from disk for "
          f"{resumed.iterations} ({per(resumed):.3f} ms/superstep); all "
          f"bit-equal to the device driver's ranks")
    print(f"ft: a checkpoint of the (state, active) carry {ckpt_bytes} B; "
          f"a save's device-to-host copy {save_ms[-1]:.3f} ms (runs "
          f"{', '.join(f'{t:.3f}' for t in save_ms)}), the writer's I/O "
          f"{io_ms[-1]:.3f} ms ({', '.join(f'{t:.3f}' for t in io_ms)}): "
          f"{ckpt_bytes / io_ms[-1] / 1e6:.3f} GB/s to disk")
    del g, ex, dev_run, host, ck, crashed, stopped, resumed
    torch.cuda.empty_cache()

    # IMRU: the model checkpointed, a crash, bit-equal.
    n_rec = 1 << min(FT_IMRU_LOG2, args.imru_log2_records)
    records, _ = _imru_records(n_rec, IMRU_FEATURES, args.seed, device)
    lr = IMRU_LR_SCALE / n_rec
    ex = compile_imru(_bgd_task(IMRU_FEATURES, lr, device), records,
                      hw=H100_SXM, device=device)
    clean = ex.run(max_iters=IMRU_ITERATIONS, on_device=False,
                   straggler_fallback=False)
    with tempfile.TemporaryDirectory() as root:
        crashed = ex.run(max_iters=IMRU_ITERATIONS, checkpoint_dir=root,
                         checkpoint_every=2,
                         injector=FailureInjector(crashes=(FT_IMRU_CRASH,)),
                         straggler_fallback=False)
    if crashed.restarts != 1:
        raise AssertionError(f"ft: imru restarted {crashed.restarts} times")
    if torch.equal(crashed.state, clean.state):
        verdict = "bit-equal to the uninterrupted run"
    else:
        size = n_rec // ex.plan.microbatches
        bounds = [(s, min(s + size, n_rec)) for s in range(0, n_rec, size)]
        lr32 = float(torch.tensor(lr, dtype=torch.float32))
        oracle, bar = _imru_oracle(records["x"], records["y"], lr32,
                                   IMRU_ITERATIONS, bounds)
        errs = [float((r.state.double() - oracle).norm())
                for r in (clean, crashed)]
        verdict = (f"not bit-equal (cuBLAS is not run-to-run reproducible "
                   f"here): ||m - m64|| {errs[1]:.4e}, uninterrupted "
                   f"{errs[0]:.4e}, bar {bar:.4e}")
        if max(errs) > bar:
            raise AssertionError(f"ft: imru after a crash: {verdict}")
    print(f"ft: imru {n_rec} records x {IMRU_FEATURES}, "
          f"{ex.plan.microbatches} microbatch(es), crash at iteration "
          f"{FT_IMRU_CRASH}: {crashed.restarts} restart, {verdict}; "
          f"{crashed.seconds / IMRU_ITERATIONS * 1e3:.3f} ms/iteration with "
          f"a checkpoint every 2 (uninterrupted host driver "
          f"{clean.seconds / IMRU_ITERATIONS * 1e3:.3f})")
    del records, ex, clean, crashed
    torch.cuda.empty_cache()

    # The generic engine on row tables: a crash in phase 1, then a
    # phase-cursor resume from disk.
    n = 1 << args.rows_log2_vertices
    src, dst = _row_pagerank_edges(n, ROWS_PR_DEGREE,
                                   np.random.default_rng(args.seed + 5))
    rels = _row_pagerank_rels(n, src, dst, device)
    clean = _row_pagerank(n, rels, device).run(max_iters=ROWS_PR_ITERS)
    rank_iters = clean.phase_iterations[0]
    with tempfile.TemporaryDirectory() as root:
        inj = FailureInjector(crashes=(FT_ROWS_CRASH,))
        crashed = _row_pagerank(n, rels, device).run(
            max_iters=ROWS_PR_ITERS, checkpoint_dir=root + "/a",
            checkpoint_every=FT_EVERY, injector=inj)
        try:
            _row_pagerank(n, rels, device).run(
                max_iters=ROWS_PR_ITERS, checkpoint_dir=root + "/b",
                checkpoint_every=FT_EVERY,
                injector=FailureInjector(crashes=(rank_iters,)),
                max_restarts=0)
            raise AssertionError("ft: the phase-2 crash did not fire")
        except RuntimeError as err:
            if "injected device failure" not in str(err):
                raise
        trap = FailureInjector(crashes=(FT_ROWS_CRASH,))
        resumed = _row_pagerank(n, rels, device).run(
            max_iters=ROWS_PR_ITERS, checkpoint_dir=root + "/b",
            checkpoint_every=FT_EVERY, resume=True, injector=trap)
    if crashed.restarts != 1 or not _same_rows(crashed, clean):
        raise AssertionError("ft: the row pipeline after a crash differs")
    if trap.fired or resumed.phase_iterations != clean.phase_iterations \
            or not _same_rows(resumed, clean):
        raise AssertionError(f"ft: the row pipeline resumed in phase 2 "
                             f"differs (fired {trap.fired})")
    print(f"ft: row pipeline n={n}, {src.shape[0]} edges, phases "
          f"{clean.phase_iterations}: crash at step {FT_ROWS_CRASH} "
          f"restored ({crashed.restarts} restart, "
          f"{crashed.seconds:.3f} s against {clean.seconds:.3f}), and a "
          f"crash at phase 2's first step resumed from disk in phase 2 "
          f"({resumed.iterations} iterations run, the phase-1 trap never "
          f"fired): both bit-equal to the uninterrupted run")


# ---------------------------------------------------------------------------
# Phase 9: out-of-core chunk streaming from pinned host memory
# ---------------------------------------------------------------------------

CHUNKS_DEGREE = 256            # out-degree: 2^24 edges at n = 65,536
CHUNKS_ITERS = 10              # PageRank iterations of each run
# Threshold in units of 1/n.  256 out-edges a vertex give in-degrees of
# 256 +- 16, so ranks of (1 +- 0.05) / n: the rows phase's 1.5 would leave
# no vertex hot.
CHUNKS_TAU = 1.05
# The planner caps a row slab at 2^20 rows (the reference's _ROW_CAP_MAX),
# and an EDB past its cap compiles only chunked: the chunk counts held
# against an unchunked run do so at the rows phase's out-degree (2^20
# edges); the 2^24-edge slab streams in CHUNK_COUNTS_BIG and at the
# planner's own count, with the join intermediate pinned to one pair an
# edge (the planner's 2^22 would overflow a chunk's join).
CHUNK_COUNTS = (1, 4, 7)
CHUNK_COUNTS_BIG = (4, 7)
CHUNKS_ROW_CAP = 1 << 24
CHUNKS_RANK_RTOL = 1e-6        # ranks against the reference run (rel L1)
CHUNKS_CRASH = (3, 2)          # (iteration, chunk) of the mid-stream crash


def _distinct_out_edges(n, degree, rng):
    """``degree`` distinct out-edges a vertex v: (a_v + k b_v) mod n for
    k < degree, b_v odd (n a power of two, so the k give distinct ends)."""

    import numpy as np

    a = rng.integers(0, n, n)
    b = 2 * rng.integers(0, n // 2, n) + 1
    src = np.repeat(np.arange(n), degree)
    dst = (np.repeat(a, degree) + np.tile(np.arange(degree), n)
           * np.repeat(b, degree)) % n
    return src, dst


def _chunked_rank_step(ex):
    """One rank iteration of a chunked pipeline (``phase_step_fn`` refuses
    a chunked phase) and the state it starts from."""

    state, materialized = ex._first_state()
    phase = ex.phases[0]
    inits = ex._run_rules_once(phase.init, state, materialized, 0)
    for pred in phase.carried:
        if pred in inits:
            state[pred] = ex._init_entry(inits[pred])
    return ex._chunked_phase_step(phase, materialized), state


def _stream_overlap(fn):
    """Device time of ``fn()`` by stream, from a profiler trace: (ms the
    host-to-device copies take, ms the other streams are busy, ms of the
    copies that lie under that busy time)."""

    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        with open(f"{d}/trace.json") as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    copies, busy = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            copies.append(span)
        else:
            busy.append(span)

    def union(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    busy_u = union(busy)
    under = 0.0
    for a, b in union(copies):
        for c, d in busy_u:
            under += max(0.0, min(b, d) - max(a, c))
    total = lambda u: sum(b - a for a, b in u) / 1e3  # noqa: E731
    return total(union(copies)), total(busy_u), under / 1e3


def phase_chunks(args, device, report) -> None:
    """Out-of-core streaming on the card: the forced-row PageRank ->
    threshold -> reach pipeline at n = 2^--rows-log2-vertices with distinct
    out-edges (``_distinct_out_edges``), every run of CHUNKS_ITERS rank
    iterations held to a float64 oracle (ranks within 1e-5 relative L1,
    ``hot`` exact outside the 1e-5 relative margin of tau, ``reach`` the
    closure through ``hot``) and to its reference run (ranks within
    CHUNKS_RANK_RTOL relative L1):

    * at the rows phase's out-degree (2^20 edges, the largest slab the
      planner admits unchunked), ``chunks={"edge": m}`` for m in
      CHUNK_COUNTS against the unchunked run;
    * at CHUNKS_DEGREE (2^24 edges, a 151 MB slab, whose unchunked compile
      must raise), the edge ``RowRelation`` on the host, streamed from
      pinned memory for m in CHUNK_COUNTS_BIG and with ``hbm_budget`` a
      quarter of the slab's planned bytes (the planner picks m), against
      the first m = 4 run; a second m = 4 run bit-identical, and one with a
      crash at CHUNKS_CRASH restored from its checkpoint; the same run with
      one chunk skipped in one iteration must break the bar.

    Prints for each run the warm ms per iteration and peak memory; for the
    streamed ones the host-to-device bytes an iteration and their rate
    beside a plain pinned copy of the same bytes, and from one profiled
    iteration the copy and compute streams' busy times and the copy time
    under compute.  B1 at the chunk-fold site is held to its plain version
    and timed there."""

    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.executor import ExecutorError
    from repro_torch.core.tree import tree_leaves
    from repro_torch.ft import FailureInjector

    n = 1 << args.rows_log2_vertices
    rng = np.random.default_rng(args.seed + 7)
    cpu = torch.device("cpu")

    def run(ex, **kw):
        """(result, peak bytes above the start)."""

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = ex.run(max_iters=CHUNKS_ITERS, **kw)
        if res.storage_fallback:
            raise AssertionError("chunks: a run fell back to dense grids")
        return res, torch.cuda.max_memory_allocated() - base

    def cell(degree, tau):
        src, dst = _distinct_out_edges(n, min(degree, n), rng)
        t0 = time.perf_counter()
        r64, adj_t, margin = _pipeline_oracle(n, src, dst, CHUNKS_ITERS, tau)
        print(f"chunks: n={n}, {src.shape[0]} edges ({degree} distinct a "
              f"vertex), tau {tau}/n, float64 oracle in "
              f"{time.perf_counter() - t0:.1f}s; {int(margin.sum())} "
              f"vertices inside the margin of tau, "
              f"{int((r64 > tau / n).sum())} above it")

        def bar(res, ref=None):
            """(what breaks the bar or None, ranks' rel L1 against
            ``ref``'s, against float64)."""

            rank, hot, reach = _pipeline_sets(res, n)
            rel_64 = float(np.abs(rank - r64).sum() / np.abs(r64).sum())
            rel = 0.0 if ref is None else float(
                np.abs(rank - ref).sum() / np.abs(ref).sum())
            problem = None
            if res.phase_iterations[0] != CHUNKS_ITERS:
                problem = f"{res.phase_iterations} iterations"
            elif rel_64 > PAGERANK_L1_TOL or rel > CHUNKS_RANK_RTOL:
                problem = f"ranks rel L1 {rel:.3e} (float64 {rel_64:.3e})"
            elif not np.array_equal(hot, np.where(margin, hot,
                                                  r64 > tau / n)):
                problem = "hot differs from float64 outside the margin"
            elif not np.array_equal(reach, _reach_closure(adj_t, hot)):
                problem = "reach is not the closure through hot"
            return problem, rel, rel_64

        return src, dst, bar

    def measure(tag, ex, bar, ref=None):
        """Two runs of ``ex`` (the first counted by call site), both held
        to the bar; the printed and returned figures."""

        (cold, _), calls = _capture_combines(lambda: run(ex), keep=False,
                                             depth=3)
        fold = sum(k for chain, k, _ in calls
                   if chain == "_merge_rows/_merge/fire")
        res, peak = run(ex)
        for r in (cold, res):
            problem, rel, rel_64 = bar(r, ref)
            if problem:
                raise AssertionError(f"chunks: {tag}: {problem}")
        m = len(ex.chunked_edb.get("edge", ())) or 1
        h2d = sum(t.numel() * t.element_size()
                  for chunk in ex.chunked_edb.get("edge", ())
                  for t in tree_leaves(chunk))
        entry = {"m": m, "ms": res.seconds / res.iterations * 1e3,
                 "cold_ms": cold.seconds / cold.iterations * 1e3,
                 "peak": peak, "rel_l1": rel, "rel_l1_f64": rel_64,
                 "h2d_bytes": h2d, "fold_launches": fold}
        text = (f"chunks: {tag}: {m} chunk(s), {entry['ms']:.3f} "
                f"ms/iteration warm (first run {entry['cold_ms']:.3f}), peak "
                f"{peak} B, ranks rel L1 {rel:.3e} from the reference run "
                f"({rel_64:.3e} from float64)")
        if m > 1:
            if fold < m * CHUNKS_ITERS:
                raise AssertionError(f"chunks: {tag}: {fold} launches at the "
                                     f"chunk-fold site in {CHUNKS_ITERS} "
                                     f"iterations of {m} chunks")
            step, state = _chunked_rank_step(ex)
            step(state, 1)
            copy_ms, busy_ms, under_ms = _stream_overlap(
                lambda: step(state, 1))
            src_p = torch.empty(h2d, dtype=torch.uint8, pin_memory=True)
            dst_d = torch.empty(h2d, dtype=torch.uint8, device=device)
            plain_ms = _time_ms(
                lambda: dst_d.copy_(src_p, non_blocking=True), 5)
            del src_p, dst_d
            # The same rank iteration with every chunk already on the card
            # (no copies), in turns with the streamed one: what the
            # stream's copies add to an iteration.
            resident = [ex._put_chunk(c) for c in ex.chunked_edb["edge"]]

            def timed(keep):
                if keep:
                    ex._stream = lambda pred: enumerate(resident)
                else:
                    vars(ex).pop("_stream", None)
                return _time_ms(lambda: step(state, 1), 3)

            turns = [timed(k in (1, 2)) for k in range(4)]
            vars(ex).pop("_stream", None)
            del resident
            stream_ms = (turns[0] + turns[3]) / 2
            resident_ms = (turns[1] + turns[2]) / 2
            entry.update(copy_ms=copy_ms, plain_copy_ms=plain_ms,
                         compute_ms=busy_ms, copy_under_compute_ms=under_ms,
                         stream_step_ms=stream_ms,
                         resident_step_ms=resident_ms)
            if copy_ms > 0:
                streams = (f"copy stream busy {copy_ms:.3f} ms "
                           f"({h2d / copy_ms / 1e6:.3f} GB/s), compute busy "
                           f"{busy_ms:.3f} ms, copy under compute "
                           f"{under_ms:.3f} ms ({under_ms / copy_ms:.1%})")
            else:
                streams = "not measured (the trace holds no copy)"
            text += (f"; {h2d} B host-to-device an iteration (a plain "
                     f"pinned copy_ of them alone {plain_ms:.3f} ms, "
                     f"{h2d / plain_ms / 1e6:.3f} GB/s); one profiled rank "
                     f"iteration: {streams}; a rank iteration streamed "
                     f"{stream_ms:.3f} ms, with every chunk resident on the "
                     f"card {resident_ms:.3f} ms (in turns: "
                     f"{', '.join(f'{t:.3f}' for t in turns)}); B1 at the "
                     f"chunk-fold site {fold} launches "
                     f"({fold / CHUNKS_ITERS:.1f} a rank iteration)")
            entry["step"] = (step, state)
        print(text, flush=True)
        return res, entry

    stats = {}
    # At the largest slab the planner admits unchunked: every m against
    # the unchunked run.
    src, dst, bar = cell(ROWS_PR_DEGREE, ROWS_PR_TAU)
    on_card = _row_pagerank_rels(n, src, dst, device)
    on_host = _row_pagerank_rels(n, src, dst, device, edge_device=cpu)
    ex = _row_pagerank(n, on_card, device)
    edges = f"{src.shape[0]} edges"
    base, stats["unchunked"] = measure(f"{edges}, unchunked", ex, bar)
    ref = _pipeline_sets(base, n)[0]
    for m in CHUNK_COUNTS:
        ex = _row_pagerank(n, on_host if m > 1 else on_card, device,
                           chunks={"edge": m})
        _, entry = measure(f"{edges}, m={m}", ex, bar, ref)
        entry.pop("step", None)
        stats[f"small m={m}"] = entry
    del ex, base, on_card, on_host

    # The 2^24-edge slab: only chunked.
    src, dst, bar = cell(CHUNKS_DEGREE, CHUNKS_TAU)
    on_host = _row_pagerank_rels(n, src, dst, device, edge_device=cpu)

    def big(**kw):
        return _row_pagerank(n, on_host, device, tau=CHUNKS_TAU,
                             row_cap=CHUNKS_ROW_CAP, **kw)

    ex = big(chunks={"edge": 4})
    # the slab's planned bytes: its capped row slab, two int32 ids and a
    # validity byte a row
    slab_bytes = ex.row_caps["edge"] * (4 * 2 + 1)
    if src.shape[0] > ex.row_caps["edge"]:
        try:
            _row_pagerank(n, _row_pagerank_rels(n, src, dst, device), device,
                          tau=CHUNKS_TAU, row_cap=CHUNKS_ROW_CAP,
                          chunks={"edge": 1})
            raise AssertionError(f"chunks: {src.shape[0]} edges compiled "
                                 f"unchunked past the slab's cap")
        except ExecutorError as err:
            print(f"chunks: m=1 at {src.shape[0]} edges refuses, as the "
                  f"reference does (the planner caps a row slab): {err}")
    at4, entry = measure("m=4", ex, bar)
    step, state = entry.pop("step")
    _, fold_calls = _capture_combines(lambda: step(state, 1), depth=3)
    fold_calls = [c for c in fold_calls if c[0] == "_merge_rows/_merge/fire"]
    fold_entry = _row_site("chunk fold", fold_calls[0],
                           entry["fold_launches"], phase="chunks")
    stats["m=4"] = entry
    del step, state, fold_calls
    ref = _pipeline_sets(at4, n)[0]
    for tag, kw in [(f"m={m}", {"chunks": {"edge": m}})
                    for m in CHUNK_COUNTS_BIG if m != 4] + [
            (f"hbm_budget={slab_bytes // 4}",
             {"hbm_budget": slab_bytes // 4})]:
        ex = big(**kw)
        if "hbm_budget" in kw:
            print(f"chunks: {tag} B (a quarter of the slab's planned "
                  f"{slab_bytes} B): the planner's "
                  f"{[x for x in ex.plan.notes if x.startswith('chunking(')]}")
        _, entry = measure(tag, ex, bar, ref)
        entry.pop("step", None)
        stats[tag] = entry
        del ex

    # Determinism, a crash mid-stream, and a control that must break the
    # bar: all at m = 4.
    again, _ = run(big(chunks={"edge": 4}))
    with tempfile.TemporaryDirectory() as root:
        inj = FailureInjector(chunk_crashes=(CHUNKS_CRASH,))
        crashed, _ = run(big(chunks={"edge": 4}), checkpoint_dir=root,
                         checkpoint_every=2, injector=inj)
    if not _same_rows(again, at4):
        raise AssertionError("chunks: two runs at m = 4 differ")
    fired = [e.detail for e in inj.fired]
    if crashed.restarts != 1 or fired != [f"chunk {CHUNKS_CRASH[1]}"] \
            or not _same_rows(crashed, at4):
        raise AssertionError(f"chunks: the run crashed at {CHUNKS_CRASH} "
                             f"differs ({crashed.restarts} restarts, fired "
                             f"{fired})")
    ex = big(chunks={"edge": 4})
    real, streams = ex._stream, [0]

    def skipping(pred):
        streams[0] += 1
        stream = real(pred)
        if streams[0] != 3:      # the third rank iteration's stream
            return stream
        return ((c, overlay) for c, overlay in stream if c != 1)

    ex._stream = skipping
    control, _ = run(ex)
    broken, rel, _ = bar(control, ref)
    if broken is None:
        raise AssertionError(f"chunks: a skipped chunk stays inside the "
                             f"bar (rel L1 {rel:.3e})")
    print(f"chunks: two runs at m=4 bit-identical; a crash at iteration "
          f"{CHUNKS_CRASH[0]} chunk {CHUNKS_CRASH[1]} restored "
          f"({crashed.restarts} restart, fired {fired}) bit-equal; one "
          f"chunk skipped in one iteration breaks the bar: {broken}")
    print(f"chunks: {json.dumps(stats)}")
    for entry in report:
        if entry["name"] == "segment_combine":
            entry["chunks_sites"] = [fold_entry]
    del ex, control, again, crashed, at4


# ---------------------------------------------------------------------------
# Phase 10: online fixpoint serving (plan and EDB caches, vmapped batches)
# ---------------------------------------------------------------------------

SERVE_DEGREE = 16              # distinct out-edges a vertex
SERVE_ITERS = 20               # personalized PageRank iterations
SERVE_DAMPING = 0.85
SERVE_BATCHES = (1, 4, 16, 64)
SERVE_GRID_FACTOR = 4          # part (b): n = 4 x --generic-domain
SERVE_GRID_K = 16
SERVE_PROBES = 64
SERVE_ROWS_K = 4
SERVE_SCAN_N = 4               # part (e): 16-cell grids take the segment scan
SERVE_SCAN_K = 16
SERVE_REQUESTS = 256
SERVE_MAX_BATCH = 16
SERVE_PPR_L1_TOL = 1e-5        # each query's ranks against float64


def _h2d_bytes(fn, at_least):
    """(``fn()``, the bytes of the host-to-device copies in its profiler
    trace).  ``fn`` is known to copy ``at_least`` bytes; a trace that
    holds fewer, or no byte counts, has lost events (a process's later
    profiler runs can), and the bytes are None: not measured."""

    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        with open(f"{d}/trace.json") as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    sizes = [e.get("args", {}).get("bytes") for e in events
             if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
             and "HtoD" in e.get("name", "")]
    if not sizes or any(b is None for b in sizes) or sum(sizes) < at_least:
        print(f"serve: the profiler's trace holds {sum(b or 0 for b in sizes)}"
              f" B of host-to-device copies, under the {at_least} B made: "
              f"not measured")
        return out, None
    return out, int(sum(sizes))


def _capture_sorted_combines(run):
    """``(run(), calls)``: every call of the sorted combine's operator on
    plain tensors in ``run()`` — under vmap the one call its batching rule
    makes for the whole batch — as ``(launches, (values, segment_ids,
    num_segments, op, edge_active))``."""

    import torch

    from repro_torch.core import physical
    from repro_torch.kernels.segment_combine import kernel as sc_kernel

    real, calls = physical._sorted_combine, []
    batched = torch._C._functorch.is_batchedtensor

    def record(*args):
        if any(isinstance(a, torch.Tensor) and batched(a) for a in args):
            return real(*args)        # the batching rule calls back in
        before = sc_kernel.launch_count
        out = real(*args)
        calls.append((sc_kernel.launch_count - before, args))
        return out

    physical._sorted_combine = record
    try:
        out = run()
    finally:
        physical._sorted_combine = real
    return out, calls


def _ppr_oracle64(src, dst, n, seed_sets, iters, damping=SERVE_DAMPING):
    """Float64 personalized PageRank of each seed set (the reference test's
    ``_ppr_oracle``: a vertex's rank counts once a walk from the seeds has
    reached it; the restart mass stays at the seeds), ``[n, k]``."""

    import numpy as np
    from scipy.sparse import coo_matrix

    adj_t = coo_matrix((np.ones(src.shape[0]), (dst, src)),
                       shape=(n, n)).tocsr()
    deg = np.maximum(np.bincount(src, minlength=n).astype(np.float64), 1.0)
    s = np.zeros((n, len(seed_sets)))
    for q, vs in enumerate(seed_sets):
        s[vs, q] = 1.0 / len(vs)
    seeded = s > 0
    r, pres = s.copy(), seeded.copy()
    for _ in range(iters):
        contrib = np.where(pres, damping * r / deg[:, None], 0.0)
        r = adj_t @ contrib + np.where(pres & seeded, (1 - damping) * s, 0.0)
        pres = ((adj_t @ pres.astype(np.float64)) > 0) | (pres & seeded)
    return np.where(pres, r, 0.0), pres


def _rank_of(answers, n):
    """(ranks as float64 with absent vertices 0, presence) of one query's
    answer, on the host."""

    import numpy as np

    rank = answers["rank"]
    if hasattr(rank, "rows"):                  # a RowRelation
        ids = rank.rows[:, 0].long().cpu().numpy()
        out, pres = np.zeros(n), np.zeros(n, bool)
        out[ids] = rank.values[1].double().cpu().numpy()
        pres[ids] = True
        return out, pres
    pres = rank.present.cpu().numpy()
    return np.where(pres, rank.values[1].double().cpu().numpy(), 0.0), pres


def _ppr_check(res, n, want, want_pres, tag):
    """Every query of ``res`` within SERVE_PPR_L1_TOL relative L1 of its
    float64 ranks, presence exact; the largest relative L1."""

    import numpy as np

    worst = 0.0
    for q, answers in enumerate(res.answers):
        got, pres = _rank_of(answers, n)
        rel = float(np.abs(got - want[:, q]).sum() / np.abs(want[:, q]).sum())
        if not (np.array_equal(pres, want_pres[:, q])
                and rel <= SERVE_PPR_L1_TOL):
            raise AssertionError(f"serve: {tag}: query {q} off float64 (rel "
                                 f"L1 {rel:.3e}, presence equal "
                                 f"{np.array_equal(pres, want_pres[:, q])})")
        worst = max(worst, rel)
    return worst


def _ppr_pair_gap(a, b, n, bar, tag):
    """The largest relative L1 distance between two results' queries,
    which must stay under ``bar``, with presence equal."""

    import numpy as np

    worst = 0.0
    for x, y in zip(a.answers, b.answers):
        (rx, px), (ry, py) = _rank_of(x, n), _rank_of(y, n)
        rel = float(np.abs(rx - ry).sum() / np.abs(ry).sum())
        if not (np.array_equal(px, py) and rel <= bar):
            raise AssertionError(f"serve: {tag}: batched and sequential "
                                 f"differ by {rel:.3e} relative L1 (bar "
                                 f"{bar:.3e})")
        worst = max(worst, rel)
    return worst


def _seed_sets(rng, n, k):
    import numpy as np

    return [np.sort(rng.choice(n, int(rng.integers(1, 9)), replace=False))
            for _ in range(k)]


def _seed_params(n, seed_sets):
    """The per-query ``seed`` relations, on the host."""

    import numpy as np

    from repro_torch.core.executor import Relation

    return [{"seed": Relation.from_columns(
        n, vs, np.full(len(vs), 1.0 / len(vs), np.float32), device="cpu")}
        for vs in seed_sets]


def _batched_step(exe, params):
    """``step(j)``: one batched iteration of ``exe``'s first phase over
    ``params`` from the state the vmapped prelude and init of
    ``exe.run_batched`` give."""

    import torch

    from repro_torch.core.tree import tree_map

    stacked = tree_map(lambda *xs: torch.stack(xs),
                       *[exe._param_grids(ps) for ps in params])
    state, mat = exe._batched_fn("prelude")(stacked)
    phase = exe.phases[0]
    state = exe._batched_fn("init", phase)(state, mat, stacked)
    step = exe._batched_fn("step", phase)
    return lambda j: step(state, mat, stacked, j)


def phase_serve(args, device, report) -> None:
    """Online fixpoint serving through ``FixpointServer`` (``hw=H100_SXM``)
    over graphs made from ``--seed`` and handed over on the host:

    (a) personalized PageRank at n = ``--generic-domain`` (1024: the largest
        domain the planner keeps dense for a binary predicate), 16 distinct
        out-edges a vertex, 20 iterations, in batches of 1, 4, 16 and 64
        seed sets of 1-8 vertices: every query within 1e-5 relative L1 of
        float64, batched within the f32 bound of the sums of sequential;
        the cold request's compile and host-to-device bytes, a warm one
        (a plan-cache hit, no compile, no copy of the graph), per-query ms
        batched and sequential, the admission notes, one batched iteration
        profiled;
    (b) the same program on dense grids at 4 x that n, 16 seed sets: the
        same bars, and peak memory;
    (c) point reachability at n, 64 probes: ``reach`` and ``hit`` equal to
        scipy's BFS, batched bit-equal to sequential;
    (d) row-table serving at n = 2^--rows-log2-vertices (16 out-edges a
        vertex): 4 seed sets, admitted sequentially, each compiled with its
        bindings, ``force="batched"`` refused; within 1e-5 of float64, no
        dense fallback; B1 at the GroupBy and merge sites (twice an
        iteration) held to its plain version there and timed;
    (e) 16 queries of a parameterized program on 4 vertices whose GroupBys
        take the segment scan (sum; max and min): B1 launches once a
        GroupBy firing for the batch, sums within ``kernel.sum_depth``'s
        bar of the sequential runs, max/min bit-equal;

    then 256 requests in runs of PageRank and reachability through
    ``serve_request_loop`` (``max_batch=16``): answers in arrival order,
    equal to one-by-one dispatch; requests/s."""

    import numpy as np
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order

    from repro_torch.core.executor import ExecutorError, Relation, RowRelation
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.monoid import get_monoid
    from repro_torch.core.parser import parse
    from repro_torch.core.serving import (
        FixpointServer,
        personalized_pagerank_program,
        point_reachability_program,
        top_k,
    )
    from repro_torch.kernels.segment_combine import kernel as sc_kernel
    from repro_torch.launch.query_serve import QueryRequest, serve_request_loop

    rng = np.random.default_rng(args.seed + 11)
    n = args.generic_domain
    ppr = personalized_pagerank_program(SERVE_DAMPING)
    reach_prog = point_reachability_program()
    sites, launch_counts, stats = [], {}, {}

    def host_graph(n_, src, dst):
        deg = np.bincount(src, minlength=n_).astype(np.float32)
        return {"edge": Relation.from_columns(n_, src, dst, device="cpu"),
                "deg": Relation.from_columns(n_, np.arange(n_), deg,
                                             device="cpu")}

    def sum_bar(n_, iters):
        # Any-order f32 sums of at most n_ terms (gamma_n relative to the
        # terms' magnitudes) in each of the two runs, each iteration; the
        # damped walk is a contraction in L1, so each iteration's rounding
        # adds at most once.
        return 2 * iters * _gamma(n_)

    # (a) batched dense personalized PageRank --------------------------------
    src, dst = _distinct_out_edges(n, SERVE_DEGREE, rng)
    shared = host_graph(n, src, dst)
    server = FixpointServer(shared, device=device, hw=H100_SXM)
    edge_bytes = n * n                         # the edge grid, bool
    seed_bytes = 5 * n                         # a seed grid: bool and f32
    sets = _seed_sets(rng, n, max(SERVE_BATCHES))
    want, want_pres = _ppr_oracle64(src, dst, n, sets, SERVE_ITERS)
    params = _seed_params(n, sets)
    cold, cold_h2d = _h2d_bytes(lambda: server.query(
        ppr, params[:1], max_iters=SERVE_ITERS, on_device=True),
        edge_bytes + seed_bytes)
    warm, warm_h2d = _h2d_bytes(lambda: server.query(
        ppr, params[1:2], max_iters=SERVE_ITERS, on_device=True),
        seed_bytes)
    # The cold request copies edge and deg into the EDB cache (two
    # misses); the warm one reuses the plan, which holds them on the card,
    # and copies only its seed.
    plan_edge = server.plan_cache._entries[cold.plan_key].relations["edge"]
    if not (not cold.cache_hit and cold.compile_seconds > 0
            and warm.cache_hit and warm.compile_seconds == 0.0
            and warm.cache["edb_misses"] == cold.cache["edb_misses"] == 2
            and warm.cache["edb_hits"] == 0
            and warm.cache["plan_hits"] == 1
            and plan_edge.present.device.type == device.type):
        raise AssertionError(f"serve: cold/warm requests: {cold.cache} "
                             f"{warm.cache}")
    if cold_h2d is not None and warm_h2d is not None \
            and warm_h2d >= edge_bytes:
        raise AssertionError(f"serve: host-to-device bytes cold {cold_h2d}, "
                             f"warm {warm_h2d} (the edge grid {edge_bytes})")
    print(f"serve: (a) n={n}, {src.shape[0]} edges; cold request: compile "
          f"{cold.compile_seconds * 1e3:.3f} ms, host-to-device "
          f"{cold_h2d} B (the edge grid {edge_bytes} B); warm request: "
          f"compile {warm.compile_seconds} s, host-to-device {warm_h2d} B, "
          f"caches {json.dumps(warm.cache)}; plan {cold.notes[:-1]}")
    stats["cold"] = {"compile_ms": cold.compile_seconds * 1e3,
                     "h2d_bytes": cold_h2d, "warm_h2d_bytes": warm_h2d,
                     "edge_grid_bytes": edge_bytes}
    bar = sum_bar(n, SERVE_ITERS)
    per_k = {}
    for k in SERVE_BATCHES:
        batch = params[:k]
        out = {}
        for force in ("batched", "sequential"):
            server.query(ppr, batch, max_iters=SERVE_ITERS, on_device=True,
                         force=force)
            out[force] = server.query(ppr, batch, max_iters=SERVE_ITERS,
                                      on_device=True, force=force)
        b, sq = out["batched"], out["sequential"]
        if b.batched != (k > 1) or sq.batched:
            raise AssertionError(f"serve: k={k} dispatched batched="
                                 f"{b.batched}/{sq.batched}")
        sub = want[:, :k], want_pres[:, :k]
        rel_b = _ppr_check(b, n, *sub, f"(a) k={k} batched")
        rel_s = _ppr_check(sq, n, *sub, f"(a) k={k} sequential")
        gap = _ppr_pair_gap(b, sq, n, bar, f"(a) k={k}")
        admitted = server.query(ppr, batch, max_iters=SERVE_ITERS,
                                on_device=True)
        per_k[k] = {"batched_ms": b.execute_seconds / k * 1e3,
                    "sequential_ms": sq.execute_seconds / k * 1e3,
                    "iterations": b.iterations, "rel_l1_f64": max(rel_b,
                                                                  rel_s),
                    "batched_vs_sequential": gap,
                    "note": admitted.notes[-1]}
        print(f"serve: (a) k={k}: per query {per_k[k]['batched_ms']:.3f} ms "
              f"batched, {per_k[k]['sequential_ms']:.3f} ms sequential "
              f"({b.iterations} iterations); rel L1 vs float64 "
              f"{per_k[k]['rel_l1_f64']:.3e}, batched vs sequential "
              f"{gap:.3e} (bar {bar:.3e}); admission {admitted.notes[-1]}")
    stats["a"] = per_k
    ids, scores = top_k(b.answers[0]["rank"], 5)
    print(f"serve: (a) top 5 of query 0 (seeds {sets[0].tolist()}): "
          f"{ids.tolist()} {scores.tolist()}")
    exe = server.plan_cache.get(cold.plan_key)
    one_step = _batched_step(exe, params[:max(SERVE_BATCHES)])
    one_step(1)
    _profile(lambda: one_step(1),
             f"batched ppr iteration (n={n}, k={max(SERVE_BATCHES)})", 1)
    del one_step, exe

    # (c) point reachability, 64 probes batched ------------------------------
    pairs = rng.integers(0, n, (SERVE_PROBES, 2))
    probes = [{"src": Relation.from_columns(n, np.array([a]), device="cpu"),
               "dst": Relation.from_columns(n, np.array([t]), device="cpu")}
              for a, t in pairs]
    adj = coo_matrix((np.ones(src.shape[0]), (src, dst)),
                     shape=(n, n)).tocsr()
    edb_hits = server.edb_cache.hits
    rb, rb_h2d = _h2d_bytes(lambda: server.query(
        reach_prog, probes, max_iters=n, on_device=True, force="batched"),
        SERVE_PROBES * 2 * n)
    rs = server.query(reach_prog, probes, max_iters=n, on_device=True,
                      force="sequential")
    if server.edb_cache.hits != edb_hits + 1:
        raise AssertionError("serve: (c) the reachability plan did not "
                             "reuse the cached edge grid")
    for q, (a, t) in enumerate(pairs):
        closure = np.zeros(n, bool)
        closure[breadth_first_order(adj, a, return_predecessors=False)] = \
            True
        hit = np.zeros(n, bool)
        hit[t] = closure[t]
        for res in (rb, rs):
            if not (np.array_equal(res.answers[q]["reach"].present.cpu()
                                   .numpy(), closure)
                    and np.array_equal(res.answers[q]["hit"].present.cpu()
                                       .numpy(), hit)):
                raise AssertionError(f"serve: (c) probe {q} ({a} -> {t}) "
                                     f"differs from scipy's BFS")
        for pred in ("reach", "hit"):
            if not torch.equal(rb.answers[q][pred].present,
                               rs.answers[q][pred].present):
                raise AssertionError(f"serve: (c) probe {q}: batched != "
                                     f"sequential")
    stats["c"] = {"batched_ms": rb.execute_seconds / SERVE_PROBES * 1e3,
                  "sequential_ms": rs.execute_seconds / SERVE_PROBES * 1e3,
                  "iterations": rb.iterations,
                  "hits": int(sum(int(r["hit"].count()) for r in rb.answers)),
                  "h2d_bytes": rb_h2d}
    print(f"serve: (c) {SERVE_PROBES} reachability probes: per probe "
          f"{stats['c']['batched_ms']:.3f} ms batched, "
          f"{stats['c']['sequential_ms']:.3f} ms sequential "
          f"({rb.iterations} iterations), {stats['c']['hits']} hit, equal to "
          f"scipy's BFS; cold compile against the cached edge grid "
          f"(EDB hits {server.edb_cache.hits}), host-to-device {rb_h2d} B")

    # the request loop ------------------------------------------------------
    # Runs of 1 to 40 requests, PageRank and reachability in turn.
    requests, kinds = [], itertools.cycle(("ppr", "reach"))
    while len(requests) < SERVE_REQUESTS:
        run, kind = int(rng.integers(1, 41)), next(kinds)
        for _ in range(min(run, SERVE_REQUESTS - len(requests))):
            if kind == "ppr":
                vs = _seed_sets(rng, n, 1)[0]
                requests.append(QueryRequest(ppr, _seed_params(n, [vs])[0],
                                             max_iters=SERVE_ITERS,
                                             tag="ppr"))
            else:
                a, t = rng.integers(0, n, 2)
                requests.append(QueryRequest(reach_prog, {
                    "src": Relation.from_columns(n, np.array([a]),
                                                 device="cpu"),
                    "dst": Relation.from_columns(n, np.array([t]),
                                                 device="cpu")},
                    max_iters=n, tag="reach"))
    for i, r in enumerate(requests):
        r.tag = f"{r.tag}{i}"
    serve_request_loop(server, requests[:SERVE_MAX_BATCH], on_device=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    responses = serve_request_loop(server, requests,
                                   max_batch=SERVE_MAX_BATCH, on_device=True)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    if [r.request.tag for r in responses] != [r.tag for r in requests]:
        raise AssertionError("serve: the request loop's answers are out of "
                             "order")
    t0 = time.perf_counter()
    solo = [server.query(r.program, r.params, max_iters=r.max_iters,
                         on_device=True) for r in requests]
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    for resp, one in zip(responses, solo):
        if "rank" in resp.answers:
            a_, pa = _rank_of(resp.answers, n)
            b_, pb = _rank_of(one.answers[0], n)
            gap = float(np.abs(a_ - b_).sum() / np.abs(b_).sum())
            if not (np.array_equal(pa, pb) and gap <= bar):
                raise AssertionError(f"serve: loop answer {resp.request.tag}"
                                     f" off its solo dispatch by {gap:.3e}")
        elif not all(torch.equal(resp.answers[p].present,
                                 one.answers[0][p].present)
                     for p in ("reach", "hit")):
            raise AssertionError(f"serve: loop answer {resp.request.tag} != "
                                 f"its solo dispatch")
    sizes = [r.result.batch for r in responses]
    dispatches = sum(1 for i, r in enumerate(responses)
                     if i == 0 or r.result is not responses[i - 1].result)
    stats["loop"] = {"requests": len(requests), "seconds": loop_s,
                     "requests_per_s": len(requests) / loop_s,
                     "dispatches": dispatches,
                     "solo_requests_per_s": len(requests) / solo_s}
    print(f"serve: request loop: {len(requests)} requests in {dispatches} "
          f"dispatches (largest batch {max(sizes)}) in {loop_s:.3f} s, "
          f"{stats['loop']['requests_per_s']:.1f} requests/s; one by one "
          f"{stats['loop']['solo_requests_per_s']:.1f} requests/s; answers "
          f"in arrival order, equal to one-by-one dispatch")
    del server, shared, responses, solo, rb, rs, b, sq, out, cold, warm
    del admitted, params, probes, requests

    # (b) dense grids at 4n ------------------------------------------------
    n_b = SERVE_GRID_FACTOR * n
    src_b, dst_b = _distinct_out_edges(n_b, SERVE_DEGREE, rng)
    server = FixpointServer(host_graph(n_b, src_b, dst_b), device=device,
                            hw=H100_SXM, storage="dense-grid")
    sets_b = _seed_sets(rng, n_b, SERVE_GRID_K)
    want_b, pres_b = _ppr_oracle64(src_b, dst_b, n_b, sets_b, SERVE_ITERS)
    params_b = _seed_params(n_b, sets_b)
    out = {}
    for force in ("batched", "sequential"):
        server.query(ppr, params_b, max_iters=SERVE_ITERS, on_device=True,
                     force=force)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = server.query(ppr, params_b, max_iters=SERVE_ITERS,
                           on_device=True, force=force)
        out[force] = (res, torch.cuda.max_memory_allocated() - base)
    (b, peak_b), (sq, peak_s) = out["batched"], out["sequential"]
    bar_b = sum_bar(n_b, SERVE_ITERS)
    rel = max(_ppr_check(b, n_b, want_b, pres_b, "(b) batched"),
              _ppr_check(sq, n_b, want_b, pres_b, "(b) sequential"))
    gap = _ppr_pair_gap(b, sq, n_b, bar_b, "(b)")
    stats["b"] = {"n": n_b, "k": SERVE_GRID_K,
                  "batched_ms": b.execute_seconds / SERVE_GRID_K * 1e3,
                  "sequential_ms": sq.execute_seconds / SERVE_GRID_K * 1e3,
                  "peak_batched": peak_b, "peak_sequential": peak_s,
                  "rel_l1_f64": rel, "batched_vs_sequential": gap,
                  "join_grid_cells": SERVE_GRID_K * n_b * n_b}
    print(f"serve: (b) n={n_b} dense grids, k={SERVE_GRID_K} (one batched "
          f"join grid {SERVE_GRID_K * n_b * n_b} cells): per query "
          f"{stats['b']['batched_ms']:.3f} ms batched, "
          f"{stats['b']['sequential_ms']:.3f} ms sequential; peak memory "
          f"above the start {peak_b} B batched, {peak_s} B sequential; rel "
          f"L1 vs float64 {rel:.3e}, batched vs sequential {gap:.3e} (bar "
          f"{bar_b:.3e}); {b.notes[-1]}")
    exe = server.plan_cache.get(b.plan_key)
    one_step = _batched_step(exe, params_b)
    one_step(1)
    _profile(lambda: one_step(1),
             f"batched ppr iteration (n={n_b}, k={SERVE_GRID_K})", 1)
    del server, out, b, sq, res, exe, one_step, params_b

    # (d) row-table serving ------------------------------------------------
    n_d = 1 << args.rows_log2_vertices
    src_d, dst_d = _distinct_out_edges(n_d, SERVE_DEGREE, rng)
    deg_d = np.bincount(src_d, minlength=n_d).astype(np.float32)
    server = FixpointServer(
        {"edge": RowRelation.from_columns(n_d, src_d, dst_d, device=device),
         "deg": Relation.from_columns(n_d, np.arange(n_d), deg_d,
                                      device="cpu")},
        device=device, hw=H100_SXM, storage="row-table")
    sets_d = _seed_sets(rng, n_d, SERVE_ROWS_K)
    want_d, pres_d = _ppr_oracle64(src_d, dst_d, n_d, sets_d, SERVE_ITERS)
    params_d = _seed_params(n_d, sets_d)
    try:
        server.query(ppr, params_d, max_iters=SERVE_ITERS, force="batched")
        raise AssertionError("serve: (d) row tables were forced batched")
    except ExecutorError as err:
        refusal = str(err)
    sc_kernel.reset_launch_count()
    res, calls = _capture_combines(lambda: server.query(
        ppr, params_d, max_iters=SERVE_ITERS, on_device=True))
    launches = sc_kernel.launch_count
    by_site = {}
    for caller, k_, _ in calls:
        by_site[caller] = by_site.get(caller, 0) + k_
    if res.batched or "sequential" not in res.notes[-1]:
        raise AssertionError(f"serve: (d) dispatch {res.notes[-1]}")
    # A dense fallback would answer with dense relations.
    if not all(isinstance(a["rank"], RowRelation) for a in res.answers):
        raise AssertionError("serve: (d) a row-table run fell back to dense "
                             "grids")
    rel_d = _ppr_check(res, n_d, want_d, pres_d, "(d) row tables")
    iters_d = res.iterations
    if set(by_site) != {"_groupby_rows", "_merge_rows"} or min(
            by_site.values()) < SERVE_ROWS_K * iters_d:
        raise AssertionError(f"serve: (d) {launches} segment-combine "
                             f"launches {by_site} in {SERVE_ROWS_K} queries "
                             f"of {iters_d} iterations")
    # Each site at its last firing, the last query's last iteration (its
    # rank rows spread furthest).
    group_call = [c for c in calls if c[0] == "_groupby_rows"][-1]
    merge_call = [c for c in calls if c[0] == "_merge_rows"][-1]
    del calls
    sites.append(_row_site("serve row groupby", group_call,
                           by_site["_groupby_rows"], phase="serve"))
    sites.append(_row_site("serve row merge", merge_call,
                           by_site["_merge_rows"], phase="serve"))
    launch_counts["row ppr"] = launches
    stats["d"] = {"n": n_d, "edges": int(src_d.shape[0]),
                  "k": SERVE_ROWS_K, "iterations": iters_d,
                  "ms_per_query": res.execute_seconds / SERVE_ROWS_K * 1e3,
                  "rel_l1_f64": rel_d, "launches": by_site}
    print(f"serve: (d) row tables, n={n_d}, {src_d.shape[0]} edges, "
          f"k={SERVE_ROWS_K}: {res.notes[-1]}; force='batched' refused: "
          f"{refusal}; {res.execute_seconds / SERVE_ROWS_K * 1e3:.3f} ms a "
          f"query (each compiled with its bindings), {iters_d} iterations "
          f"each, "
          f"rel L1 vs float64 {rel_d:.3e}; {launches} segment-combine "
          f"launches {json.dumps(by_site)}")
    del server, res, group_call, merge_call, params_d

    # (e) segment scans under vmap: one launch a GroupBy firing ------------
    m = SERVE_SCAN_N
    src_e = np.array([0, 0, 1, 2, 2, 3])
    dst_e = np.array([1, 2, 2, 0, 3, 1])
    spread = parse(
        "M1: hi(0, X, L)        :- lab(X, L).\n"
        "M2: hi(J+1, X, max<L>) :- hi(J, Y, L), edge(Y, X).\n"
        "M3: hi(J+1, X, L)      :- hi(J, X, L).\n"
        "M4: lo(0, X, L)        :- lab(X, L).\n"
        "M5: lo(J+1, X, min<L>) :- lo(J, Y, L), edge(Y, X).\n"
        "M6: lo(J+1, X, L)      :- lo(J, X, L).\n",
        aggregates={a: get_monoid(a).as_aggregate() for a in ("max", "min")})
    server = FixpointServer(host_graph(m, src_e, dst_e), device=device,
                            hw=H100_SXM)
    seed_e = _seed_params(m, [np.sort(rng.choice(m, int(rng.integers(1, 3)),
                                                 replace=False))
                              for _ in range(SERVE_SCAN_K)])
    lab_e = [{"lab": Relation.from_columns(
        m, np.arange(m), rng.normal(size=m).astype(np.float32),
        device="cpu")} for _ in range(SERVE_SCAN_K)]
    scan = {}
    # Each iteration fires one GroupBy (the spread program's hi and lo are
    # two fixpoint phases, one after the other).
    for tag, prog, batch, preds in (
            ("sum", ppr, seed_e, ("rank",)),
            ("max/min", spread, lab_e, ("hi", "lo"))):
        server.query(prog, batch[:2], max_iters=SERVE_ITERS, force="batched")
        exe = server.plan_cache.get(server.plan_key(prog, list(batch[0])))
        if set(exe.plan.connectors.values()) != {"segment-scan"}:
            raise AssertionError(f"serve: (e) {tag} planned {exe.plan.notes}")
        got = {}
        for force in ("batched", "sequential"):
            sc_kernel.reset_launch_count()
            res, calls = _capture_sorted_combines(lambda: server.query(
                prog, batch, max_iters=SERVE_ITERS, on_device=True,
                force=force))
            torch.cuda.synchronize()
            got[force] = (res, sc_kernel.launch_count, calls)
        (b, lb, calls_b), (sq, ls, calls_s) = (got["batched"],
                                               got["sequential"])
        # One launch a GroupBy firing for the whole batch; sequentially,
        # one a firing of each query's run.
        widths = {c[1][0].shape[1] for c in calls_b}
        if not (lb == len(calls_b) == b.iterations
                and all(c[0] == 1 for c in calls_b)
                and widths == {SERVE_SCAN_K}
                and ls == len(calls_s) >= SERVE_SCAN_K * len(preds)):
            raise AssertionError(f"serve: (e) {tag}: {lb} launches in "
                                 f"{len(calls_b)} batched combines over "
                                 f"{b.iterations} iterations; {ls} in "
                                 f"{len(calls_s)} sequential ones")
        # The batched combine's inputs at its last firing: against k
        # single launches within sum_depth's bar (max/min bit-equal).
        vals, ids, n_seg, op, act = calls_b[-1][1]
        worst = 0.0
        for pred in preds:
            for q in range(SERVE_SCAN_K):
                x = b.answers[q][pred]
                y = sq.answers[q][pred]
                if not torch.equal(x.present, y.present):
                    raise AssertionError(f"serve: (e) {tag} {pred} query "
                                         f"{q}: presence differs")
                xv = torch.where(x.present, x.values[1], 0.0).double()
                yv = torch.where(y.present, y.values[1], 0.0).double()
                if tag != "sum":
                    if not torch.equal(xv, yv):
                        raise AssertionError(f"serve: (e) {tag} {pred} "
                                             f"query {q}: batched != "
                                             f"sequential")
                    continue
                d1 = float(sc_kernel.summation_depths(ids, n_seg, 1).max())
                d2 = float(sc_kernel.summation_depths(
                    ids, n_seg, SERVE_SCAN_K).max())
                # Each iteration's combine within gamma_d1 + gamma_d2 of the
                # rank mass (at most 1), the walk a contraction in L1.
                bar_e = b.iterations * (_gamma(d1) + _gamma(d2))
                gap = float((xv - yv).abs().sum())
                if gap > bar_e:
                    raise AssertionError(f"serve: (e) sum query {q}: "
                                         f"batched off sequential by {gap} "
                                         f"(bar {bar_e})")
                worst = max(worst, gap)
        site = _row_site(f"serve segment scan {tag}",
                         (None, 1, calls_b[-1][1]), lb, phase="serve")
        site["batch"] = SERVE_SCAN_K
        sites.append(site)
        launch_counts[f"scan {tag} batched"] = lb
        launch_counts[f"scan {tag} sequential"] = ls
        scan[tag] = {"batched_launches": lb, "batched_iterations":
                     b.iterations, "sequential_launches": ls,
                     "sequential_iterations": sq.iterations,
                     "sum_gap_l1": worst}
        print(f"serve: (e) {tag} on {m} vertices, k={SERVE_SCAN_K}: batched "
              f"{lb} segment-combine launches in {b.iterations} iterations "
              f"(one a GroupBy firing, payload width {widths}); "
              f"sequential {ls}; batched vs sequential L1 {worst:.3e}")
    stats["e"] = scan
    del server, exe, got, b, sq, calls_b, calls_s, vals, ids, act
    print(f"serve: {json.dumps(stats)}")
    for entry in report:
        if entry["name"] == "segment_combine":
            entry["serve_launches"] = launch_counts
            entry["serve_sites"] = sites


# ---------------------------------------------------------------------------
# Phase 11: the dense LM's serving path (phi4-mini-3.8b)
# ---------------------------------------------------------------------------


def _flash_cases():
    """(B, H, KH, Sq, Skv, D, causal, window) of the kernel-vs-plain sweep:
    tests/test_kernels.py's FLASH_SWEEP shapes, ragged tails, D = 160."""

    return [
        (1, 2, 2, 128, 128, 64, True, None),
        (2, 4, 2, 128, 128, 64, True, None),
        (1, 4, 1, 64, 64, 32, False, None),
        (1, 2, 2, 128, 128, 64, True, 64),
        (1, 2, 2, 256, 256, 64, True, 32),
        (1, 2, 1, 64, 256, 64, True, None),
        (1, 2, 2, 128, 128, 128, True, None),
        (1, 8, 2, 64, 64, 32, True, None),
        (1, 4, 2, 1000, 1000, 128, True, None),
        (1, 4, 2, 100, 1000, 128, True, None),
        (1, 4, 2, 1000, 1000, 128, True, 64),
        (1, 4, 2, 1000, 1000, 160, True, None),
        (1, 4, 2, 333, 777, 160, False, 100),
    ]


def _out_bar(q, k, v, ref, causal, window, scale):
    """Per-element bar on |kernel out - plain| (all [B, H, S, D]): in f32
    FLASH_F32_TOL; in bf16 the kernel's own error bound
    (``bf16_error_bound``, which scales with the row's output and its
    sum_j p_j |v_j| / l), capped at FLASH_BF16_TOL."""

    import torch

    from repro_torch.kernels.flash_attention.kernel import bf16_error_bound
    from repro_torch.kernels.flash_attention.ref import attention_reference

    if q.dtype == torch.float32:
        return torch.full_like(ref, FLASH_F32_TOL)
    ref_abs_v = attention_reference(q.float(), k.float(), v.float().abs(),
                                    causal=causal, window=window,
                                    sm_scale=scale)
    bar = bf16_error_bound(ref, ref_abs_v, k.shape[2], q.shape[3])
    return bar.clamp_(max=FLASH_BF16_TOL)


def _out_off(out, ref, bar):
    """(max abs err, elements over their bar, max err / bar)."""

    err = (out.float() - ref).abs()
    return (float(err.max()), int((err > bar).sum()),
            float((err / bar).max()))


def _flash_check(q, k, v, causal, window, layout, tag):
    """Kernel against plain on one input; returns (max abs err of out, max
    err / bar of out, max relative err of m and l, and the plain version's
    (out f32, m, l) in [B, H, S, D]).  Raises on a bar broken."""

    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_fwd
    from repro_torch.kernels.flash_attention.ref import (
        NEG_INF,
        attention_reference,
    )

    scale = 1.0 / q.shape[-1] ** 0.5
    out, m, l = flash_fwd(q, k, v, causal=causal, window=window,
                          sm_scale=scale, layout=layout)
    bhsd = (lambda t: t) if layout == "bhsd" else (lambda t: t.transpose(1, 2))
    q, k, v, out = bhsd(q), bhsd(k), bhsd(v), bhsd(out)
    # The plain version on the same values in f32 (the casts are exact).
    ref, m_ref, l_ref = attention_reference(
        q.float(), k.float(), v.float(), causal=causal, window=window,
        sm_scale=scale, return_stats=True)
    bar = _out_bar(q, k, v, ref, causal, window, scale)
    torch.cuda.synchronize()
    err, bad, ratio = _out_off(out, ref, bar)
    if not (out.dtype == q.dtype and bad == 0):
        raise AssertionError(f"flash out off plain by more than its bar on "
                             f"{bad} elements (max abs err {err}, max err / "
                             f"bar {ratio}): {tag}")
    seen = m_ref > NEG_INF
    if not (torch.equal(m[~seen], m_ref[~seen])
            and torch.equal(l[~seen], l_ref[~seen])):
        raise AssertionError(f"flash stats of rows with no key differ: {tag}")
    rel = 0.0
    for got, want in ((m, m_ref), (l, l_ref)):
        r = ((got - want).abs() / want.abs().clamp(min=1.0))[seen]
        rel = max(rel, float(r.max()) if r.numel() else 0.0)
    if rel > FLASH_STATS_RTOL:
        raise AssertionError(f"flash m/l off plain by {rel} relative: {tag}")
    return err, ratio, rel, (ref, m_ref, l_ref, bar)


def _skip_first_tile(q, k, v, ref, m, l, scale, from_row):
    """A planted fault: what a causal kernel (Sq == Skv, [B, H, S, D])
    that skips KV tile 0 (keys 0-63) in rows ``from_row`` on (>= 64) would
    output, rounded to q's dtype: the plain output with those keys' share
    taken out of its numerator and of l."""

    import torch

    G = q.shape[1] // k.shape[1]
    k0 = k[:, :, :64].float().repeat_interleave(G, dim=1)
    v0 = v[:, :, :64].float().repeat_interleave(G, dim=1)
    p = torch.exp(q.float() @ k0.transpose(-1, -2) * scale - m[..., None])
    num = ref * l[..., None] - p @ v0
    den = (l - p.sum(-1))[..., None]
    past = (torch.arange(q.shape[2], device=q.device) >= from_row)[:, None]
    return torch.where(past, num / den, ref).to(q.dtype)


def _rel_l2(a, b, vocab):
    a = a[..., :vocab].double()
    b = b[..., :vocab].double()
    return float((a - b).norm() / b.norm())


# Kernel-name groups of the profile summaries, first match wins.
PROFILE_GROUPS = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_bwd", ("flash_bwd",)),
    ("gemm", ("nvjet", "gemm", "Gemm", "cutlass", "sm90_xmma")),
    ("copy/cast", ("copy", "Memcpy", "Memset")),
    ("reduce", ("reduce_kernel",)),
)


def _profile(fn, label, steps) -> None:
    """Device time by kernel over ``fn()`` (kernel events only) and the
    device's idle share of that window."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(t for _, t, _ in rows)
    print(f"profile: {label}: wall {wall_us / steps / 1e3:.3f} ms/{label}, "
          f"device busy {busy / steps / 1e3:.3f} ms/{label}, idle share "
          f"{max(0.0, 1 - busy / wall_us):.3f}")
    groups = {}
    for key, t, _ in rows:
        group = next((g for g, words in PROFILE_GROUPS
                      if any(w in key for w in words)), "other")
        groups[group] = groups.get(group, 0.0) + t
    print(f"profile: {label} by group: " + ", ".join(
        f"{g} {t / steps / 1e3:.3f} ms ({t / busy:.1%})"
        for g, t in sorted(groups.items(), key=lambda x: -x[1])))
    for key, t, n in rows[:10]:
        print(f"profile:   {t / steps / 1e3:9.3f} ms/{label} {t / busy:6.1%} "
              f"x{n // steps:<4d} {key[:80]}")


def phase_lm(args, device, report) -> None:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.hardware import H100_SXM, MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.launch.serve import (
        build_decode_step,
        build_prefill_step,
        greedy_sample,
    )
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Kernel against plain: the sweep, then the main path's shape.
    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_ratio = 0.0
    worst_rel = 0.0
    routes = {}
    cases = _flash_cases()
    for case in cases:
        B, H, KH, Sq, Skv, D, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            name = fa_kernel.route("fwd", dtype, D)
            routes[name] = routes.get(name, 0) + 2
            for layout in ("bhsd", "bshd"):
                q, k, v = (torch.randn(s, generator=gen, device=device)
                           .to(dtype)
                           for s in ((B, H, Sq, D), (B, KH, Skv, D),
                                     (B, KH, Skv, D)))
                if layout == "bshd":
                    q, k, v = (t.transpose(1, 2).contiguous()
                               for t in (q, k, v))
                err, ratio, rel, _ = _flash_check(
                    q, k, v, causal, window, layout,
                    f"{case} {dtype} {layout}")
                worst[dtype] = max(worst[dtype], err)
                worst_ratio = max(worst_ratio, ratio)
                worst_rel = max(worst_rel, rel)
    print(f"lm: flash_attention_fwd == plain on {len(cases) * 4} cases "
          f"(out within {FLASH_F32_TOL} f32 max abs; in bf16 within the "
          f"kernel's error bound per element, capped at {FLASH_BF16_TOL}; "
          f"m and l within {FLASH_STATS_RTOL} relative): max abs err f32 "
          f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}, "
          f"max err / bar {worst_ratio:.3f}, max m/l rel err "
          f"{worst_rel:.3e}; cases by route {json.dumps(routes)}")
    if set(routes) != set(fa_kernel.ROUTES):
        raise AssertionError(f"the forward sweep missed a route: {routes}")

    cfg = get_config(LM_ARCH)
    if args.lm_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.lm_layers)
    plan = plan_lm(cfg, "prefill_32k", MeshSpec((("data", 1),)), hw=H100_SXM)
    print("lm: " + plan.explain().replace("\n", "\nlm: "))
    cfg = plan.cfg
    B, S, steps = LM_REQUESTS, args.lm_prompt, LM_DECODE_STEPS
    cache_len = S + steps
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    master = lm.init_params(cfg, gen, device=device)
    # The bf16 copy of every matmul weight, made once: the bits of the
    # per-call cast (lm.serving_params).  The f32 master is not needed to
    # serve and is dropped.
    params = lm.serving_params(cfg, master)
    del master
    torch.cuda.synchronize()
    n_params = lm.param_count(cfg)
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"lm: {cfg.name}: {n_params} parameters ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {H}/{KH} heads x {D}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}), served in {cfg.compute_dtype}: "
          f"{n_bytes / 1e9:.2f} GB on the card, made in "
          f"{time.perf_counter() - t0:.1f}s")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    prompts = torch.from_numpy(prompts).to(device)

    prefill_fn, _ = build_prefill_step(plan, None, cache_len, device)
    decode_fn, _, _ = build_decode_step(plan, None, device)
    ref_prefill_fn, _ = build_prefill_step(plan, None, cache_len, device,
                                           attention="ref")

    wgmma_launches = [0]   # the last serve()'s prefill, on that route

    def serve(fn, weights=params, decode=decode_fn, n=steps, feed=None):
        """Prefill, then ``n`` decode steps fed the greedy tokens (or
        ``feed``'s).  Returns (logits per step [n+1, B, V] f32, tokens
        [B, n+1], prefill s, decode s, launches in prefill, launches in
        decode)."""

        fa_kernel.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, pos = fn(weights, {"tokens": prompts})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        n_prefill = fa_kernel.launch_count
        wgmma_launches[0] = fa_kernel.fwd_wgmma_launch_count
        out = [logits[:, -1].float()]
        token = greedy_sample(logits)
        toks = [token]
        t0 = time.perf_counter()
        for i in range(n):
            if feed is not None:
                token = feed[:, i:i + 1]
            logits, cache = decode(weights, cache, token, pos + i)
            out.append(logits[:, -1].float())
            token = greedy_sample(logits)
            toks.append(token)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        return (torch.stack(out), torch.cat(toks, dim=1), t_prefill,
                t_decode, n_prefill, fa_kernel.launch_count - n_prefill)

    # Warm-up on a short prompt (first cuBLAS calls, the kernel's load).
    with torch.inference_mode():
        lm.prefill(params, prompts[:1, :128], cfg, 160)
    torch.cuda.synchronize()

    logits, toks, t_prefill, t_decode, n_prefill, n_decode = serve(prefill_fn)
    n_wgmma = wgmma_launches[0]
    fwd_route = fa_kernel.route("fwd", torch.bfloat16, D)
    if fwd_route != "wgmma":
        raise AssertionError(f"the forward takes the {fwd_route} route at "
                             f"the main path's D = {D}, not wgmma")
    print(f"lm: served {B} requests x {S} prompt tokens + {steps} greedy "
          f"decode steps (cache {cache_len}): prefill {t_prefill:.4f}s = "
          f"{B * S / t_prefill:.1f} tokens/s, decode "
          f"{t_decode / steps * 1e3:.3f} ms/step = "
          f"{B * steps / t_decode:.1f} tokens/s; flash kernel launches: "
          f"{n_prefill} in prefill ({n_wgmma} on the wgmma route), "
          f"{n_decode} in decode")
    if n_prefill != cfg.n_layers or n_decode != 0:
        raise AssertionError(f"flash kernel launched {n_prefill} times in "
                             f"prefill (want {cfg.n_layers}) and {n_decode} "
                             f"in decode (want 0)")
    if n_wgmma != n_prefill:
        raise AssertionError(f"{n_wgmma} of {n_prefill} prefill launches on "
                             f"the wgmma route at D = {D}")
    if not (bool(torch.isfinite(logits[..., :cfg.vocab]).all())
            and toks.shape == (B, steps + 1)
            and int(toks.max()) < cfg.vocab):
        raise AssertionError("served logits not finite or tokens out of "
                             "the vocab")

    # Where the time goes: one prefill, and decode steps.
    def prefill_once():
        prefill_fn(params, {"tokens": prompts})

    _profile(prefill_once, "prefill", 1)
    with torch.inference_mode():
        _, cache, pos = lm.prefill(params, prompts, cfg, cache_len)

    def decode_few(n=4):
        for i in range(n):
            decode_fn(params, cache, toks[:, i:i + 1], pos + i)

    _profile(decode_few, "decode step", 4)
    del cache

    # The whole path against its plain version: the same weights and
    # prompts with the attention's plain version, decode fed the kernel
    # path's tokens.
    r_logits, r_toks, t_ref, _, r_launch, _ = serve(ref_prefill_fn,
                                                    feed=toks)
    if r_launch != 0:
        raise AssertionError("the plain path launched the flash kernel")
    # The bf16 compute bound of this model, measured: the plain path
    # against the same weights and tokens computed in f32, prefill and
    # TF_STEPS decode steps.
    plan32 = dataclasses.replace(
        plan, cfg=dataclasses.replace(cfg, compute_dtype="float32"))
    params32 = tree_map(lambda t: t.float(), params)
    f32_prefill_fn, _ = build_prefill_step(plan32, None, cache_len, device,
                                           attention="ref")
    f32_decode_fn, _, _ = build_decode_step(plan32, None, device)
    f_logits, _, t_f32, _, _, _ = serve(f32_prefill_fn, params32,
                                        f32_decode_fn, TF_STEPS, feed=toks)
    del params32
    torch.cuda.empty_cache()
    floor = [_rel_l2(r_logits[i], f_logits[i], cfg.vocab)
             for i in range(TF_STEPS + 1)]
    off_f32 = [_rel_l2(logits[i], f_logits[i], cfg.vocab)
               for i in range(TF_STEPS + 1)]
    rel = [_rel_l2(logits[i], r_logits[i], cfg.vocab) for i in range(2)]
    gap = (logits[..., :cfg.vocab] - r_logits[..., :cfg.vocab]).abs() \
        .amax(dim=-1)                                       # [steps+1, B]
    top2 = r_logits[..., :cfg.vocab].topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    decided = margin > 2 * gap
    agree = r_toks.T == toks.T                               # [steps+1, B]
    print(f"lm: bf16 compute bound: plain path vs the same model in f32 "
          f"(prefill {t_f32:.3f}s): rel L2 "
          f"{', '.join(f'{x:.3e}' for x in floor)} (prefill, then decode "
          f"steps); kernel path vs f32: "
          f"{', '.join(f'{x:.3e}' for x in off_f32)}")
    print(f"lm: kernel path vs plain path (attention_reference, prefill "
          f"{t_ref:.3f}s): last-token logits rel L2 {rel[0]:.3e}, first "
          f"decode step {rel[1]:.3e} (bar {LM_NOISE_FACTOR} x the bf16 "
          f"bound: {LM_NOISE_FACTOR * floor[0]:.3e}, "
          f"{LM_NOISE_FACTOR * floor[1]:.3e}); greedy tokens agree on "
          f"{int((agree & decided).sum())} of {int(decided.sum())} (step, "
          f"request) pairs whose plain top-1 margin exceeds twice the logit "
          f"gap ({int(agree.sum())} of {agree.numel()} in all)")
    if max(floor) > LM_BF16_BOUND_CAP:
        raise AssertionError(f"the bf16 plain path is {max(floor)} off f32")
    if any(rel[i] > LM_NOISE_FACTOR * floor[i] for i in range(2)):
        raise AssertionError("kernel path's logits off the plain path's")
    if not bool(agree[decided].all()):
        raise AssertionError("greedy tokens differ where the margin decides")

    # Negative controls of that bar: the same prefill on the kernel with the
    # attention narrowed by a sliding window, as a kernel that drops keys
    # would narrow it, against the plain path's logits; each must break it
    # (w = S - 64 drops only keys 0-63 of the last 64 rows).
    faults = []
    for w in (1, S // 2, S - 64):
        plan_w = dataclasses.replace(
            plan, cfg=dataclasses.replace(cfg, window=w))
        fault_fn, _ = build_prefill_step(plan_w, None, cache_len, device)
        w_logits = fault_fn(params, {"tokens": prompts})[0][:, -1].float()
        faults.append((w, _rel_l2(w_logits, r_logits[0], cfg.vocab)))
    print(f"lm: negative controls, prefill with the kernel's attention cut to "
          f"a window of w keys: last-token logits rel L2 to the plain path "
          f"{', '.join(f'w={w}: {d:.3e}' for w, d in faults)} (bar "
          f"{LM_NOISE_FACTOR * floor[0]:.3e}; the unbroken kernel "
          f"{rel[0]:.3e})")
    if any(d <= LM_NOISE_FACTOR * floor[0] for _, d in faults):
        raise AssertionError("the whole-path bar passes a planted attention "
                             "fault")
    del r_logits, r_toks, f_logits

    # Decode against teacher forcing: forward over prompt + TF_STEPS tokens.
    with torch.inference_mode():
        full = lm.forward(params, torch.cat([prompts, toks[:, :TF_STEPS]],
                                            dim=1), cfg)
    tf = [_rel_l2(logits[i], full[:, S - 1 + i].float(), cfg.vocab)
          for i in range(TF_STEPS + 1)]
    del full
    print(f"lm: prefill + {TF_STEPS} decode steps vs teacher-forced forward: "
          f"rel L2 {', '.join(f'{x:.3e}' for x in tf)} (bars "
          f"{', '.join(f'{LM_NOISE_FACTOR * x:.3e}' for x in floor)})")
    if any(tf[i] > LM_NOISE_FACTOR * floor[i] for i in range(TF_STEPS + 1)):
        raise AssertionError("decode disagrees with teacher forcing")
    del logits

    # The kernel at the main path's shape and layout, timed beside the
    # plain version and PyTorch's SDPA (a yardstick the port never calls).
    q = torch.randn((B, S, H, D), generator=gen, device=device) \
        .to(torch.bfloat16)
    k = torch.randn((B, S, KH, D), generator=gen, device=device) \
        .to(torch.bfloat16)
    v = torch.randn((B, S, KH, D), generator=gen, device=device) \
        .to(torch.bfloat16)
    max_abs_err, ratio, rel, (ref, m_ref, l_ref, bar) = _flash_check(
        q, k, v, True, None, "bshd", "main path's shape")
    scale = 1.0 / D ** 0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # The bar must reject a kernel that is wrong in long rows only.
    fault = _skip_first_tile(qt, kt, vt, ref, m_ref, l_ref, scale, S // 2)
    f_err, f_bad, f_ratio = _out_off(fault, ref, bar)
    f_flat = int(((fault.float() - ref).abs() > FLASH_BF16_TOL).sum())
    print(f"lm: flash bar at the main path's shape: kernel max err / bar "
          f"{ratio:.3f}; a planted fault (KV tile 0 skipped in rows "
          f"{S // 2} on) over its bar on {f_bad} of {fault.numel()} "
          f"elements, max err / bar {f_ratio:.3f}, max abs err {f_err:.3e} "
          f"(over the flat {FLASH_BF16_TOL} bar alone: {f_flat})")
    if f_bad == 0:
        raise AssertionError("the flash bar passes a kernel that skips a "
                             "KV tile")
    del ref, m_ref, l_ref, bar, fault
    # The kernel and the parent's design in turns: new, parent, parent,
    # new.
    calls = {"new": lambda: fa_kernel.flash_fwd(
        q, k, v, causal=True, window=None, sm_scale=scale, layout="bshd"),
        "parent": lambda: _parent_fwd(q, k, v, scale)}
    turns = [_time_ms(calls[name], 5)
             for name in ("new", "parent", "parent", "new")]
    ms = (turns[0] + turns[3]) / 2
    parent_ms = (turns[1] + turns[2]) / 2
    parent_rel = _same_function("forward", calls["parent"](),
                                calls["new"]())
    plain_ms = _time_ms(lambda: attention_reference(
        qt, kt, vt, causal=True, sm_scale=scale), 3)
    library_ms = _time_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(
                              qt, kt, vt, is_causal=True, scale=scale,
                              enable_gqa=True), 10)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_ms = _time_ms(lambda: fa_kernel.flash_fwd(
        q32, k32, v32, causal=True, window=None, sm_scale=scale,
        layout="bshd"), 3)
    del q32, k32, v32
    # Causal: row i sees i + 1 keys; QK^T and PV are 2 FLOP a MAC each.
    flops = 4.0 * D * B * H * S * (S + 1) / 2
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KH * D) + 2 * 4 * B * H * S
    bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    print(f"lm: flash_attention_fwd at B={B} H={H} KH={KH} S={S} D={D} bf16 "
          f"causal: kernel ({fwd_route} route) {ms:.3f} ms, the parent's "
          f"design (mma.sync) {parent_ms:.3f} ms (in turns: "
          f"{', '.join(f'{t:.3f}' for t in turns)}; rel L2 from the "
          f"kernel's {parent_rel:.3e}), plain "
          f"{plain_ms:.3f} ms, SDPA "
          f"{library_ms:.3f} ms, bound {bound:.3f} ms ({flops:.4e} FLOP, "
          f"{nbytes} bytes); vs plain max abs err {max_abs_err:.3e}, m/l rel "
          f"err {rel:.3e}; the same inputs in f32 (CUDA cores) {f32_ms:.3f} "
          f"ms")
    report.append({
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:141",
        "tpu_kernel": "repro.kernels.flash_attention.kernel.flash_fwd",
        "launches": n_prefill,
        "launches_per_prefill": n_prefill,
        "kernel_route": fwd_route,
        "route_launches_per_prefill": n_wgmma,
        "parent_ms": parent_ms,
        "parent_design": "mma.sync",
        "shape": {"B": B, "H": H, "KH": KH, "Sq": S, "Skv": S, "D": D,
                  "dtype": "bfloat16", "causal": True, "layout": "bshd"},
        "max_abs_err": max_abs_err,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "operations" if flops / BF16_FLOP_PER_S
        >= nbytes / HBM_BYTES_PER_S else "bytes",
        "library_ms": library_ms,
        "f32_ms": f32_ms,
        "prefill_tokens_per_s": B * S / t_prefill,
        "decode_ms_per_step": t_decode / steps * 1e3,
    })
    del params, q, k, v, qt, kt, vt
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 12: LM training (phi4-mini-3.8b), the backward kernels
# ---------------------------------------------------------------------------

# Backward kernels against their plain version (in f32, same inputs, same
# m, l and delta): in f32 within BWD_F32_TOL times max(1, max |gradient|)
# of each output (another summation order); in bf16 within
# kernel.bf16_bwd_error_bound per element (P and dS rounded to bf16 before
# their products, f32 sums, bf16 outputs).
BWD_F32_TOL = 1e-5
TRAIN_ARCH = LM_ARCH
TRAIN_BATCH = 8                # sequences per step (train_4k has 256)
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 5
TRAIN_LR = 3e-4                # make_optimizer's default, constant
SPIKE_STEP = 2                 # the main run's loss spike (PERF.md)
TRAIN_CHECK_LAYERS = 2         # depth of the whole-path gradient check
BWD_FLOP_PER_PAIR = {"dq": 6, "dkv": 8}   # x D per visible (q, k) pair


def _bwd_cases():
    """The forward sweep's shapes with a head dim the backward takes, and
    rows that see no key (Sq > Skv causal; window 0)."""

    from repro_torch.kernels.flash_attention.kernel import MAX_BWD_HEAD_DIM

    return [c for c in _flash_cases() if c[5] <= MAX_BWD_HEAD_DIM] + [
        (1, 2, 1, 93, 37, 16, True, None),
        (1, 2, 2, 50, 50, 16, False, 0),
    ]


def _bwd_run(q, k, v, do, causal, window, layout):
    """The forward kernel's (out, m, l), delta, and both backward kernels'
    outputs (launched twice: the second must give the same bits)."""

    import torch

    from repro_torch.kernels.flash_attention import kernel as K

    scale = 1.0 / q.shape[-1] ** 0.5
    out, m, l = K.flash_fwd(q, k, v, causal=causal, window=window,
                            sm_scale=scale, layout=layout)
    delta = (do.float() * out.float()).sum(-1)
    delta = (delta if layout == "bhsd" else delta.transpose(1, 2)) \
        .contiguous()
    kw = dict(causal=causal, window=window, sm_scale=scale, layout=layout)
    dq = K.flash_bwd_dq(q, k, v, do, m, l, delta, **kw)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, m, l, delta, **kw)
    same = torch.equal(dq, K.flash_bwd_dq(q, k, v, do, m, l, delta, **kw))
    dk2, dv2 = K.flash_bwd_dkv(q, k, v, do, m, l, delta, **kw)
    same = same and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    return (m, l, delta, scale), (dq, dk, dv), same


def _bwd_off(got, ref, bars):
    """([max abs err of dq, dk, dv], elements over their bar, max err /
    bar)."""

    errs, bad, ratio = [], 0, 0.0
    for g, r, b in zip(got, ref, bars):
        e = (g.float() - r).abs()
        errs.append(float(e.max()))
        bad += int((e > b).sum())
        ratio = max(ratio, float((e / b).max()))
    return errs, bad, ratio


def _bwd_check(q, k, v, do, causal, window, layout, tag, plain_reps=0):
    """Both backward kernels against the plain backward on one input;
    returns ([max abs err of dq, dk, dv], max err / bar, bhsd inputs,
    stats, the kernels' and the plain grads (bhsd), bars, and the plain
    backward's ms when ``plain_reps`` asks for it timed: the timed call's
    result is the one checked).  Raises on a bar broken or two launches
    that differ."""

    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        bf16_bwd_error_bound,
    )
    from repro_torch.kernels.flash_attention.ref import attention_backward

    (m, l, delta, scale), got, same = _bwd_run(q, k, v, do, causal, window,
                                               layout)
    bhsd = (lambda t: t) if layout == "bhsd" else (lambda t: t.transpose(1, 2))
    q, k, v, do = (bhsd(t) for t in (q, k, v, do))
    got = [bhsd(t) for t in got]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()

    def plain():
        return attention_backward(qf, kf, vf, dof, m, l, delta, causal=causal,
                                  window=window, sm_scale=scale)

    plain_ms, ref = _timed(plain, plain_reps) if plain_reps else (None,
                                                                  plain())
    del qf, kf, vf, dof
    if q.dtype == torch.float32:
        bars = [torch.full_like(r, BWD_F32_TOL * max(1.0, float(
            r.abs().max()))) for r in ref]
    else:
        bars = bf16_bwd_error_bound(q, k, v, do, m, l, delta, ref,
                                    causal=causal, window=window,
                                    sm_scale=scale)
    torch.cuda.synchronize()
    err, bad, ratio = _bwd_off(got, ref, bars)
    if not same:
        raise AssertionError(f"two backward launches differ: {tag}")
    if bad or any(g.dtype != q.dtype for g in got):
        raise AssertionError(f"backward off plain by more than its bar on "
                             f"{bad} elements (max abs err {max(err)}, max "
                             f"err / bar {ratio}): {tag}")
    return (err, ratio, (q, k, v, do), (m, l, delta, scale), got, ref, bars,
            plain_ms)


def _grads_of(params, cfg, tokens, attention):
    """(loss, [f32 gradient of every leaf]) of lm.loss_fn with full
    remat."""

    import torch

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import lm

    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = lm.loss_fn(leaves, {"tokens": tokens}, cfg,
                         remat_policy="full", attention=attention)
    loss.backward()
    grads = [t.grad.float() for t in tree_leaves(leaves)]
    del leaves
    torch.cuda.synchronize()
    return float(loss.detach()), grads


def _tree_rel_l2(a, b):
    num = sum(float((x.double() - y.double()).square().sum())
              for x, y in zip(a, b))
    den = sum(float(y.double().square().sum()) for y in b)
    return (num / den) ** 0.5


def _leaf_rel_l2(a, b):
    return [float((x.double() - y.double()).norm() / y.double().norm())
            for x, y in zip(a, b)]


def _train_counts(K):
    """(forward, dQ, dK/dV launches, forward, dQ and dK/dV launches on the
    wgmma route) since the last reset."""

    return (K.launch_count, K.dq_launch_count, K.dkv_launch_count,
            K.fwd_wgmma_launch_count, K.dq_wgmma_launch_count,
            K.dkv_wgmma_launch_count)


TRAIN_COUNTS = "(fwd, dq, dkv, fwd wgmma, dq wgmma, dkv wgmma)"


def _train_want(K, cfg, microbatches):
    """``_train_counts`` of one train step of ``cfg`` in bf16 with full
    remat (each layer's forward runs again in its backward), every forward,
    dQ and dK/dV launch on the wgmma route; raises if that route does not
    take cfg's head dim."""

    import torch

    routes = tuple(K.route(kernel, torch.bfloat16, cfg.hd)
                   for kernel in ("fwd", "dq", "dkv"))
    if routes != ("wgmma",) * 3:
        raise AssertionError(f"the forward, dQ and dK/dV take the {routes} "
                             f"routes at D = {cfg.hd}, not wgmma")
    n = cfg.n_layers * microbatches
    return (2 * n, n, n, 2 * n, n, n)


def phase_train(args, device, report) -> None:
    import dataclasses

    import torch

    from repro_torch.core.hardware import H100_SXM, MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_backward
    from repro_torch.launch.train import build_train_step, make_optimizer
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config
    from repro_torch.optim import warmup_cosine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(5678)

    # 1. The backward kernels against plain: the sweep.
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_ratio = 0.0
    routes = {}
    cases = _bwd_cases()
    for case in cases:
        B, H, KH, Sq, Skv, D, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            for kernel in ("dq", "dkv"):
                name = f"{kernel}/{K.route(kernel, dtype, D)}"
                routes[name] = routes.get(name, 0) + 2
            for layout in ("bhsd", "bshd"):
                q, k, v, do = (torch.randn(s, generator=gen, device=device)
                               .to(dtype)
                               for s in ((B, H, Sq, D), (B, KH, Skv, D),
                                         (B, KH, Skv, D), (B, H, Sq, D)))
                if layout == "bshd":
                    q, k, v, do = (t.transpose(1, 2).contiguous()
                                   for t in (q, k, v, do))
                err, ratio, *_ = _bwd_check(q, k, v, do, causal, window,
                                            layout,
                                            f"{case} {dtype} {layout}")
                worst[dtype] = max(worst[dtype], *err)
                if dtype == torch.bfloat16:
                    worst_ratio = max(worst_ratio, ratio)
    print(f"train: flash_bwd_dq / flash_bwd_dkv == plain on "
          f"{len(cases) * 4} cases (f32 within {BWD_F32_TOL} x max(1, "
          f"max|grad|); bf16 within bf16_bwd_error_bound per element; two "
          f"launches bit-identical): max abs err f32 "
          f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}, "
          f"bf16 max err / bound {worst_ratio:.3f}; cases by route "
          f"{json.dumps(routes)}", flush=True)
    want_routes = {f"{kernel}/{name}" for kernel in ("dq", "dkv")
                   for name in K.ROUTES}
    if set(routes) != want_routes:
        raise AssertionError(f"the backward sweep missed a route: {routes}")

    cfg = get_config(TRAIN_ARCH)
    plan = plan_lm(cfg, "train_4k", MeshSpec((("data", 1),)), hw=H100_SXM)
    print("train: " + plan.explain().replace("\n", "\ntrain: "))
    S = args.train_seq
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    # 2. The whole path against its plain version: loss and gradients of
    # the kernel path and of the plain-attention path at full width, at
    # TRAIN_CHECK_LAYERS layers, one sequence; the bar is LM_NOISE_FACTOR
    # times the plain path's own distance from the same model in f32.
    # Negative controls: the same backward with delta dropped, and with KV
    # tile 0's dK/dV skipped, must break it.
    ccfg = dataclasses.replace(plan.cfg, n_layers=TRAIN_CHECK_LAYERS)
    gen.manual_seed(args.seed)
    params = lm.init_params(ccfg, gen, device=device)
    tokens = torch.randint(0, ccfg.vocab, (1, S), generator=gen,
                           device=device, dtype=torch.int32)
    K.reset_launch_count()
    t0 = time.perf_counter()
    loss_k, g_k = _grads_of(params, ccfg, tokens, "auto")
    t_k = time.perf_counter() - t0
    launches = _train_counts(K)
    if launches != _train_want(K, ccfg, 1):
        raise AssertionError(f"kernel path launched {TRAIN_COUNTS} "
                             f"{launches} times")
    K.reset_launch_count()
    loss_r, g_r = _grads_of(params, ccfg, tokens, "ref")
    if (K.launch_count, K.dq_launch_count, K.dkv_launch_count) != (0, 0, 0):
        raise AssertionError("the plain path launched a flash kernel")
    cfg32 = dataclasses.replace(ccfg, compute_dtype="float32",
                                param_dtype="float32")
    loss_f, g_f = _grads_of(tree_map(lambda t: t.float(), params), cfg32,
                            tokens, "ref")
    floor = _tree_rel_l2(g_r, g_f)
    rel = _tree_rel_l2(g_k, g_r)
    leaf_floor = _leaf_rel_l2(g_r, g_f)
    leaf_ratio = max(r / f for r, f in zip(_leaf_rel_l2(g_k, g_r),
                                           leaf_floor))
    loss_floor = abs(loss_r - loss_f) / abs(loss_f)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    del g_f
    faults = {}
    real_dq, real_dkv = K.flash_bwd_dq, K.flash_bwd_dkv

    def dq_no_delta(q, k, v, do, m, l, delta, **kw):
        return real_dq(q, k, v, do, m, l, torch.zeros_like(delta), **kw)

    def dkv_no_delta(q, k, v, do, m, l, delta, **kw):
        return real_dkv(q, k, v, do, m, l, torch.zeros_like(delta), **kw)

    def dkv_skip_tile(*a, **kw):
        dk, dv = real_dkv(*a, **kw)
        dk[:, :64] = 0     # the LM's bshd layout: keys 0-63
        dv[:, :64] = 0
        return dk, dv

    try:
        for name, dq_fn, dkv_fn in (
                ("delta dropped", dq_no_delta, dkv_no_delta),
                ("KV tile 0 skipped", real_dq, dkv_skip_tile)):
            K.flash_bwd_dq, K.flash_bwd_dkv = dq_fn, dkv_fn
            _, g_bad = _grads_of(params, ccfg, tokens, "auto")
            faults[name] = (_tree_rel_l2(g_bad, g_r), max(
                r / f for r, f in zip(_leaf_rel_l2(g_bad, g_r),
                                      leaf_floor)))
            del g_bad
    finally:
        K.flash_bwd_dq, K.flash_bwd_dkv = real_dq, real_dkv
    print(f"train: whole path at full width, {ccfg.n_layers} layers, 1 x {S} "
          f"tokens ({t_k:.2f}s): loss kernel {loss_k:.6f}, plain {loss_r:.6f}"
          f", f32 {loss_f:.6f}; gradients rel L2 kernel vs plain {rel:.3e} "
          f"(bar {LM_NOISE_FACTOR} x the bf16 bound {floor:.3e} = "
          f"{LM_NOISE_FACTOR * floor:.3e}); loss rel {loss_rel:.3e} (bar "
          f"{LM_NOISE_FACTOR * max(loss_floor, floor):.3e}); largest "
          f"per-leaf ratio to the leaf's own bound {leaf_ratio:.3f} (bar "
          f"{LM_NOISE_FACTOR}); negative controls (rel L2, largest per-leaf "
          f"ratio): " + ", ".join(f"{n} {d:.3e}, {r:.3f}" for n, (d, r) in
                                  faults.items()), flush=True)
    if floor > LM_BF16_BOUND_CAP:
        raise AssertionError(f"the bf16 plain path is {floor} off f32")
    if rel > LM_NOISE_FACTOR * floor or leaf_ratio > LM_NOISE_FACTOR or \
            loss_rel > LM_NOISE_FACTOR * max(loss_floor, floor):
        raise AssertionError("kernel path's gradients off the plain path's")
    if any(d <= LM_NOISE_FACTOR * floor and r <= LM_NOISE_FACTOR
           for d, r in faults.values()):
        raise AssertionError("the whole-path bar passes a planted backward "
                             "fault")
    del params, g_k, g_r
    torch.cuda.empty_cache()

    # 3. The main run: the planner's train plan at full width and depth,
    # TRAIN_BATCH x S tokens a step in TRAIN_MICROBATCHES microbatches,
    # TRAIN_STEPS steps of AdamW on the zipf stream.
    cfg = dataclasses.replace(plan.cfg, n_layers=args.train_layers)
    plan = dataclasses.replace(plan, cfg=cfg,
                               microbatches=TRAIN_MICROBATCHES)
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device=device)
    opt = make_optimizer(plan, lr=TRAIN_LR)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    del params
    torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state["params"])
                      + tree_leaves(tuple(state["opt"])))
    print(f"train: {cfg.name}: {lm.param_count(cfg)} parameters "
          f"({cfg.n_layers} layers) in {cfg.param_dtype}, AdamW m "
          f"{plan.m_dtype}, v {plan.v_dtype}: {state_bytes / 1e9:.2f} GB of "
          f"state, made in {time.perf_counter() - t0:.1f}s", flush=True)
    step_fn, _, _ = build_train_step(plan, None, device=device)
    stream = SyntheticLMStream(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=TRAIN_BATCH,
        seed=args.seed, task="zipf"), device=device)
    batches = [next(stream) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_count()
    rows = []
    for i in range(TRAIN_STEPS):
        before = _train_counts(K)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = tuple(a - b for a, b in zip(_train_counts(K), before))
        rows.append((dt, loss, gnorm, n))
        print(f"train: step {i}: {dt:.3f}s = {TRAIN_BATCH * S / dt:.1f} "
              f"tokens/s, loss {loss:.6f}, grad_norm {gnorm:.6f}, launches "
              f"{TRAIN_COUNTS} {n}", flush=True)
    launches = _train_counts(K)
    peak = torch.cuda.max_memory_allocated()
    want = _train_want(K, cfg, TRAIN_MICROBATCHES)
    steady = [r[0] for r in rows[1:]] or [rows[0][0]]
    print(f"train: {TRAIN_STEPS} steps, steady {sum(steady) / len(steady):.3f}"
          f" s/step = {TRAIN_BATCH * S * len(steady) / sum(steady):.1f} "
          f"tokens/s; peak memory {peak / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated); launches {TRAIN_COUNTS} "
          f"{launches}, per step {want} wanted",
          flush=True)
    if any(r[3] != want for r in rows):
        raise AssertionError(f"flash kernels launched {[r[3] for r in rows]}"
                             f" times per step, want {want}")
    if not all(torch.isfinite(torch.tensor([r[1], r[2]])).all()
               for r in rows):
        raise AssertionError("loss or grad_norm not finite")
    if int(state["step"]) != TRAIN_STEPS:
        raise AssertionError(f"state step {int(state['step'])}")

    def one_step():
        step_fn(state, batches[TRAIN_STEPS])

    _profile(one_step, "train step", 1)
    del state, opt, step_fn
    torch.cuda.empty_cache()

    # 3b. Witnesses for the main run's loss curve, each from the same seed
    # on the same batches: the main run's recipe again for its first
    # SPIKE_STEP steps, then the loss and gradients of step SPIKE_STEP's
    # first sequence through the kernels and through the attention's plain
    # version (is the spike in the parameters or in the kernels?);
    # the main run with the learning rate warmed up over its steps; and at
    # TRAIN_CHECK_LAYERS layers, the main run through the kernels and
    # through the plain attention.
    wcfg = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)

    def run(run_cfg, lr, attention, n_steps):
        gen.manual_seed(args.seed)
        params = lm.init_params(run_cfg, gen, device=device)
        run_plan = dataclasses.replace(plan, cfg=run_cfg)
        opt = make_optimizer(run_plan, lr=lr)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        del params
        step_fn, _, _ = build_train_step(run_plan, None, optimizer=opt,
                                         device=device, attention=attention)
        curve = []
        for batch in batches[:n_steps]:
            state, metrics = step_fn(state, batch)
            curve.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))
        return state, curve

    curves = {}
    state, curves[f"{cfg.n_layers} layers, kernels, first {SPIKE_STEP} "
                  f"steps"] = run(cfg, TRAIN_LR, "auto", SPIKE_STEP)
    params = state["params"]
    del state
    torch.cuda.empty_cache()
    first = batches[SPIKE_STEP]["tokens"][:1]
    spike = {a: _grads_of(params, cfg, first, a) for a in ("auto", "ref")}
    spike_rel = _tree_rel_l2(spike["auto"][1], spike["ref"][1])
    spike_norm = {a: sum(float(g.double().square().sum()) for g in gs) ** 0.5
                  for a, (_, gs) in spike.items()}
    spike = {a: loss for a, (loss, _) in spike.items()}
    del params
    torch.cuda.empty_cache()
    for name, run_cfg, lr, attention in (
            (f"{cfg.n_layers} layers, kernels, warmup", cfg,
             warmup_cosine(TRAIN_LR, TRAIN_STEPS, TRAIN_STEPS), "auto"),
            (f"{TRAIN_CHECK_LAYERS} layers, kernels", wcfg, TRAIN_LR, "auto"),
            (f"{TRAIN_CHECK_LAYERS} layers, plain", wcfg, TRAIN_LR, "ref")):
        curves[name] = run(run_cfg, lr, attention, TRAIN_STEPS)[1]
        torch.cuda.empty_cache()
    for name, curve in curves.items():
        print(f"train: witness, {name}: loss, grad_norm by step " + "; ".join(
            f"{a:.6f}, {b:.6f}" for a, b in curve), flush=True)
    print(f"train: witness, step {SPIKE_STEP}'s first sequence at the "
          f"parameters after {SPIKE_STEP} steps: loss through the kernels "
          f"{spike['auto']:.6f}, through the plain attention "
          f"{spike['ref']:.6f}; gradient norm {spike_norm['auto']:.6f} and "
          f"{spike_norm['ref']:.6f}, gradients rel L2 kernels vs plain "
          f"{spike_rel:.3e}", flush=True)
    if not all(math.isfinite(x) for c in curves.values() for r in c
               for x in r) or not all(map(math.isfinite, spike.values())):
        raise AssertionError("witness loss or grad_norm not finite")
    del batches

    # 4. The three attention kernels at the main path's shape (one
    # microbatch, bf16, causal, the LM's layout), on the inputs they are
    # timed on: the forward against the plain attention within its bound;
    # both backward kernels against the plain backward (the timed call's
    # own result) within theirs, with both planted faults breaking that
    # bound; the timed launches bit-equal to the checked ones.  Timed
    # beside PyTorch's SDPA backward (a yardstick the port never calls).
    B = TRAIN_BATCH // TRAIN_MICROBATCHES
    q, k, v, do = (torch.randn(s, generator=gen, device=device)
                   .to(torch.bfloat16)
                   for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D),
                             (B, S, H, D)))
    f_err, f_ratio, f_rel, _ = _flash_check(q, k, v, True, None, "bshd",
                                            "train microbatch")
    torch.cuda.empty_cache()
    err, ratio, bq, (m, l, delta, scale), got, ref, bars, plain_ms = \
        _bwd_check(q, k, v, do, True, None, "bshd", "main path's shape",
                   plain_reps=2)
    qt, kt, vt, dot = bq
    no_delta = attention_backward(qt.float(), kt.float(), vt.float(),
                                  dot.float(), m, l, torch.zeros_like(delta),
                                  sm_scale=scale)
    skipped = [t.clone() for t in ref]
    skipped[1][:, :, :64] = 0
    skipped[2][:, :, :64] = 0
    f_delta = _bwd_off(no_delta, ref, bars)
    f_skip = _bwd_off(skipped, ref, bars)
    del no_delta, skipped, ref, bars
    torch.cuda.empty_cache()
    print(f"train: attention kernels at the main path's shape (B={B} x {S}):"
          f" forward max abs err {f_err:.3e} (max err / bound {f_ratio:.3f},"
          f" m and l rel {f_rel:.3e}); backward max err / bound "
          f"{ratio:.3f}, max abs err (dq, dk, dv) "
          f"{', '.join(f'{e:.3e}' for e in err)}; planted faults over their "
          f"bound: delta dropped on {f_delta[1]} elements (max err / bound "
          f"{f_delta[2]:.3f}), KV tile 0 skipped on {f_skip[1]} (max err / "
          f"bound {f_skip[2]:.3f})", flush=True)
    if f_delta[1] == 0 or f_skip[1] == 0:
        raise AssertionError("the backward bar passes a planted fault")

    kw = dict(causal=True, window=None, sm_scale=scale, layout="bshd")
    # Each backward kernel and the parent's design in turns: new, parent,
    # parent, new.
    dq_route = K.route("dq", torch.bfloat16, D)
    dkv_route = K.route("dkv", torch.bfloat16, D)
    calls = {
        "dq": {"new": lambda: (K.flash_bwd_dq(q, k, v, do, m, l, delta,
                                              **kw),),
               "parent": lambda: (_parent_dq(q, k, v, do, m, l, delta,
                                             scale),)},
        "dkv": {"new": lambda: K.flash_bwd_dkv(q, k, v, do, m, l, delta,
                                               **kw),
                "parent": lambda: _parent_dkv(q, k, v, do, m, l, delta,
                                              scale)},
    }
    turns, new_out = {}, {}
    for key, fns in calls.items():
        turns[key] = []
        for name in ("new", "parent", "parent", "new"):
            t, out = _timed(fns[name], 5)
            turns[key].append(t)
            if name == "new":
                new_out[key] = out
            del out
    dq_ms, dkv_ms = ((turns[x][0] + turns[x][3]) / 2 for x in ("dq", "dkv"))
    dq_parent_ms, dkv_parent_ms = ((turns[x][1] + turns[x][2]) / 2
                                   for x in ("dq", "dkv"))
    parent_rel = {x: _same_function(x, calls[x]["parent"](), new_out[x])
                  for x in ("dq", "dkv")}
    (dq,), (dk, dv) = new_out["dq"], new_out["dkv"]
    del new_out
    if not all(torch.equal(a.transpose(1, 2), b)
               for a, b in zip((dq, dk, dv), got)):
        raise AssertionError("timed backward launches differ from the "
                             "checked ones")
    del dq, dk, dv, got
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, scale=scale, enable_gqa=True)
    library_ms = _time_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, dot, retain_graph=True), 10)
    del sdpa_out, leaves
    pairs = B * H * S * (S + 1) / 2
    nbytes = {
        "dq": 2 * (2 * B * S * H * D + 2 * B * S * KH * D)
        + 3 * 4 * B * H * S,
        "dkv": 2 * (2 * B * S * H * D + 4 * B * S * KH * D)
        + 3 * 4 * B * H * S,
    }
    print(f"train: backward kernels at B={B} H={H} KH={KH} S={S} D={D} bf16 "
          f"causal (bshd): dq ({dq_route} route) {dq_ms:.3f} ms, the "
          f"parent's dq design (mma.sync) {dq_parent_ms:.3f} ms (in turns: "
          f"{', '.join(f'{t:.3f}' for t in turns['dq'])}; rel L2 from the "
          f"kernel's {parent_rel['dq']:.3e}), dkv ({dkv_route} route) "
          f"{dkv_ms:.3f} ms, the parent's dkv design (mma.sync) "
          f"{dkv_parent_ms:.3f} ms (in turns: "
          f"{', '.join(f'{t:.3f}' for t in turns['dkv'])}; rel L2 from the "
          f"kernel's {parent_rel['dkv']:.3e}), plain "
          f"(both, f32) {plain_ms:.3f} ms, SDPA backward (dq, dk, dv) "
          f"{library_ms:.3f} ms", flush=True)
    for name, ms, n, src_line, max_abs_err, extra in (
            ("flash_bwd_dq", dq_ms, launches[1], 245, err[0],
             {"kernel_route": dq_route,
              "route_launches_per_step": launches[4] / TRAIN_STEPS,
              "parent_ms": dq_parent_ms, "parent_design": "mma.sync"}),
            ("flash_bwd_dkv", dkv_ms, launches[2], 345, max(err[1:]),
             {"kernel_route": dkv_route,
              "route_launches_per_step": launches[5] / TRAIN_STEPS,
              "parent_ms": dkv_parent_ms, "parent_design": "mma.sync"})):
        key = name[10:]
        flops = BWD_FLOP_PER_PAIR[key] * D * pairs
        t_ops = flops / BF16_FLOP_PER_S
        t_bytes = nbytes[key] / HBM_BYTES_PER_S
        print(f"train: {name}: {flops:.4e} FLOP, {nbytes[key]} bytes, bound "
              f"{max(t_ops, t_bytes) * 1e3:.3f} ms; kernel {ms:.3f} ms")
        report.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"src/repro/kernels/flash_attention/kernel.py:"
                        f"{src_line}",
            "tpu_kernel": f"repro.kernels.flash_attention.kernel.{name}",
            "launches": n,
            "launches_per_step": n / TRAIN_STEPS,
            "shape": {"B": B, "H": H, "KH": KH, "Sq": S, "Skv": S, "D": D,
                      "dtype": "bfloat16", "causal": True, "layout": "bshd"},
            "max_abs_err": max_abs_err,
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "plain_computes": "dq, dk and dv together, in f32",
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "library": "SDPA backward (dq, dk and dv together)",
            "train_s_per_step": sum(steady) / len(steady),
            "train_tokens_per_s": TRAIN_BATCH * S * len(steady) / sum(steady),
            "train_peak_gb": peak / 1e9,
            **extra,
        })
    for entry in report:
        if entry["name"] == "flash_attention_fwd":
            entry["train_launches"] = launches[0]
            entry["train_route_launches"] = launches[3]
            entry["train_max_abs_err"] = f_err
    del q, k, v, do, m, l, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()


def _freeing(name, run) -> None:
    """Run a phase and check that it gave back every byte it took on the
    card (the train phase after it peaks at 65 GB)."""

    import gc

    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    run()
    gc.collect()
    torch.cuda.synchronize()
    # cuBLAS keeps its workspaces in the caching allocator from a process's
    # first matrix product on: not the phase's data.
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    print(f"phase {name}: {after - before} B still allocated after it")
    if after > before:
        raise AssertionError(f"phase {name} kept {after - before} B on the "
                             f"card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2-vertices", type=int,
                    default=DEFAULTS["log2_vertices"])
    ap.add_argument("--supersteps", type=int,
                    default=DEFAULTS["supersteps"])
    ap.add_argument("--sssp-log2-vertices", type=int,
                    default=DEFAULTS["sssp_log2_vertices"])
    ap.add_argument("--imru-log2-records", type=int,
                    default=DEFAULTS["imru_log2_records"])
    ap.add_argument("--generic-domain", type=int,
                    default=DEFAULTS["generic_domain"])
    ap.add_argument("--rows-log2-vertices", type=int,
                    default=DEFAULTS["rows_log2_vertices"])
    ap.add_argument("--lm-layers", type=int, default=DEFAULTS["lm_layers"])
    ap.add_argument("--lm-prompt", type=int, default=DEFAULTS["lm_prompt"])
    ap.add_argument("--train-layers", type=int,
                    default=DEFAULTS["train_layers"])
    ap.add_argument("--train-seq", type=int, default=DEFAULTS["train_seq"])
    args = ap.parse_args(argv)
    full = all(getattr(args, k) == v for k, v in DEFAULTS.items())

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    print(_card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")
    report = []
    seconds = {}
    for name, run in (
            ("kernels", lambda: phase_kernels(device)),
            ("pagerank", lambda: phase_pagerank(args, device, report)),
            ("sssp", lambda: phase_sssp(args, device)),
            ("imru", lambda: _freeing("imru",
                                      lambda: phase_imru(args, device))),
            ("generic", lambda: _freeing("generic",
                                         lambda: phase_generic(args,
                                                               device))),
            ("rows", lambda: _freeing("rows",
                                      lambda: phase_rows(args, device,
                                                         report))),
            ("ft", lambda: _freeing("ft", lambda: phase_ft(args, device))),
            ("chunks", lambda: _freeing("chunks",
                                        lambda: phase_chunks(args, device,
                                                             report))),
            ("serve", lambda: _freeing("serve",
                                       lambda: phase_serve(args, device,
                                                           report))),
            ("lm", lambda: phase_lm(args, device, report)),
            ("train", lambda: phase_train(args, device, report))):
        t0 = time.perf_counter()
        run()
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"phase {name}: {seconds[name]}s", flush=True)
    print(f"phases: {json.dumps(seconds)}")
    # again at the end, where a cut log's tail keeps it beside the numbers
    print(_card_line(), flush=True)
    if not full:
        print(f"rehearsal at reduced size {vars(args)}, no result: "
              f"{json.dumps(report)}")
        return 0
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
