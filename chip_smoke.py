#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--log2-vertices 25] [--supersteps 20]
                          [--sssp-log2-vertices 22]

Phases, each of which exits nonzero on failure:

1. ``build``: compile every ``src/repro_torch/csrc/*.cu`` with nvcc
   (sm_90a), one process per source, all started together.
2. ``kernels``: the segment-combine kernel against its plain PyTorch
   version on the card: sum/max/min x f32/bf16 x F in {1, 2, 8}, with and
   without ``edge_active``, on ragged shapes with padding ids at both ends,
   empty segments and one hub segment of 2^20 rows.  max/min must be
   bit-equal; sums must be within the error bounds of ``_sum_check`` of a
   float64 sum and of the plain version, and the hub's integer-valued sum
   exact; two launches on the same input must be bit-identical.
3. ``pagerank`` (the main path): PageRank through ``compile_pregel`` with
   the planner's own plan (``dense_psum`` on one device) on a power-law
   graph of 2^25 vertices with the Yahoo webmap's mean out-degree (5.7)
   and web-graph degree exponents (see ``power_law_graph``), made from
   ``--seed`` with numpy, checked against a scipy.sparse float64 oracle;
   the kernel's launch count must rise by at least 2 a superstep.
4. ``sssp``: semi-naive SSSP with the merging connector on 2^22 vertices;
   it must converge, equal scipy's BFS distances exactly and run at least
   one sparse superstep.

Prints the card's name and power limit first, one ``{"kernels": [...]}``
line with the kernel's launches, times and bound at the main path's
shapes, and as its last line ``{"ok": true, "device": {...}}``.  Smaller
sizes than the defaults make a rehearsal: every phase runs and is checked,
but neither of those two lines is printed.
"""

from __future__ import annotations

import argparse
import json
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
# The kernel's summation depth within one 256-row chunk: a 5-level warp
# scan, then up to 7 folds of earlier warps' tails; each further chunk a
# segment touches adds one addition into the tile's accumulator.
CHUNK_ROWS = 256
CHUNK_DEPTH = 5 + 7
PAGERANK_L1_TOL = 1e-5         # ||r - r*||_1 / ||r*||_1 against float64
HUB_ROWS = 1 << 20
DEFAULTS = {"log2_vertices": 25, "supersteps": 20, "sssp_log2_vertices": 22}


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
    return vals.contiguous(), ids, n, act, hub_id


def _gamma(d):
    return d * F32_UNIT / (1.0 - d * F32_UNIT)


def _sum_check(vals, ids, n, act, ker, ref, tag):
    """Holds kernel sums against a float64 sum and the plain version.

    A summation in which no term passes through more than d f32 additions
    is within gamma_d = d u / (1 - d u) of sum|v| of the exact sum
    (u = 2^-24).  In the kernel d = CHUNK_DEPTH + c for a segment whose
    valid rows lie in c chunks; the plain version adds in any order
    (float atomics), d = m for m rows.  The float64 sum itself is within
    m 2^-53 sum|v|.  bf16 output adds its own rounding, 2^-8 of the value.
    Raises on a bound broken; returns (max |kernel - plain|, max of
    |kernel - float64| / sum|v| over the segments)."""

    import torch

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
    chunk = rows // CHUNK_ROWS
    first = torch.ones_like(seg, dtype=torch.bool)
    first[1:] = (seg[1:] != seg[:-1]) | (chunk[1:] != chunk[:-1])
    c = torch.bincount(seg[first], minlength=n).double()[:, None]
    del rows, seg, v, chunk, first
    f64_err = m * F64_UNIT * mag
    tol_k = _gamma(CHUNK_DEPTH + c) * mag + f64_err
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


def phase_kernels(device) -> None:
    import torch

    from repro_torch.kernels.segment_combine.kernel import (
        segment_combine_cuda,
    )
    from repro_torch.kernels.segment_combine.ref import (
        segment_combine_reference,
    )

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    n_cases = 0
    worst = 0.0
    worst_rel = 0.0
    for op in ("sum", "max", "min"):
        for dtype in (torch.float32, torch.bfloat16):
            for F in (1, 2, 8):
                for with_active in (False, True):
                    vals, ids, n, act, hub_id = _kernel_case(
                        gen, dtype, F, with_active, device)
                    ker = segment_combine_cuda(vals, ids, n, op,
                                               edge_active=act)
                    again = segment_combine_cuda(vals, ids, n, op,
                                                 edge_active=act)
                    ref = segment_combine_reference(vals, ids, n, op,
                                                    edge_active=act)
                    torch.cuda.synchronize()
                    tag = (f"op={op} dtype={str(dtype)[6:]} F={F} "
                           f"active={with_active} E={ids.shape[0]} n={n}")
                    if ker.dtype != dtype or ker.shape != (n, F):
                        raise AssertionError(f"kernel output {ker.dtype} "
                                             f"{tuple(ker.shape)}: {tag}")
                    if not torch.equal(ker, again):
                        raise AssertionError(f"two launches differ: {tag}")
                    if op == "sum":
                        err, rel = _sum_check(vals, ids, n, act, ker, ref,
                                              tag)
                        worst_rel = max(worst_rel, rel)
                        hub = vals.float()[(ids == hub_id) if act is None
                                           else (ids == hub_id) & act]
                        want = hub.sum(0).to(dtype)  # exact: integers < 2^24
                        if not torch.equal(ker[hub_id], want):
                            raise AssertionError(
                                f"hub sum {ker[hub_id].tolist()} != exact "
                                f"{want.tolist()}: {tag}")
                    else:
                        bits = torch.int16 if dtype == torch.bfloat16 \
                            else torch.int32
                        err = float((ker.float() - ref.float()).abs().max())
                        bad = int((ker.view(bits) != ref.view(bits)).sum())
                        if bad:
                            raise AssertionError(
                                f"kernel != plain on {bad} elements "
                                f"(max abs err {err}): {tag}")
                    worst = max(worst, err)
                    n_cases += 1
    print(f"kernels: segment_combine == plain on {n_cases} cases "
          f"(max/min bit-equal; sums within gamma_(12+c) sum|v| of float64 "
          f"over a segment's c chunks and within that plus gamma_m sum|v| "
          f"of plain, bf16 + 2^-8 |sum|; hub segment {HUB_ROWS} integer "
          f"rows summed exactly; two launches bit-identical); max abs err "
          f"vs plain {worst}, max |kernel - float64| / sum|v| "
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
        segment_combine_cuda,
    )
    from repro_torch.kernels.segment_combine.ref import (
        segment_combine_reference,
    )

    n = 1 << args.log2_vertices
    t0 = time.perf_counter()
    src, dst = power_law_graph(n, WEBMAP_MEAN_OUT_DEGREE, args.seed)
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
    ms = _time_ms(lambda: segment_combine_cuda(vals, ids, n, "sum"), 10)
    plain_ms = _time_ms(
        lambda: segment_combine_reference(vals, ids, n, "sum"), 3)
    library_ms = _time_ms(
        lambda: torch.segment_reduce(vals, "sum", lengths=lengths), 3)
    E, F = vals.shape
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
    })
    print(f"pagerank: segment_combine at E={E} F={F} n={n}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, torch.segment_reduce "
          f"{library_ms:.3f} ms, bound {bytes_moved / HBM_BYTES_PER_S * 1e3:.3f}"
          f" ms")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2-vertices", type=int,
                    default=DEFAULTS["log2_vertices"])
    ap.add_argument("--supersteps", type=int,
                    default=DEFAULTS["supersteps"])
    ap.add_argument("--sssp-log2-vertices", type=int,
                    default=DEFAULTS["sssp_log2_vertices"])
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
    phase_kernels(device)
    phase_pagerank(args, device, report)
    phase_sssp(args, device)
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
