#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--log2-vertices 25] [--supersteps 20]
                          [--sssp-log2-vertices 22] [--imru-log2-records 23]
                          [--generic-domain 1024]
                          [--rows-log2-vertices 16] [--lm-layers 32]
                          [--lm-prompt 4000] [--families-layers 0]
                          [--train-layers 32] [--train-seq 4096]
                          [--families-train-layers 0]

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
   ``--seed`` with numpy, checked against a float64 oracle
   (``pagerank_oracle``);
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
   Phases 5 to 10, 10b, 12 and 14 must give back all the card memory they
   took.
10b. ``mesh``: sharded Pregel and IMRU on ``MESH_RANKS`` (4) ranks spawned
   by ``launch_ranks``: with four cards one a rank over ``nccl``, on one
   card all on ``cuda:0`` over ``gloo`` staged through pinned host
   buffers (printed: world, backend, transport, ranks a GPU, bytes
   staged).  Every rank builds the same global graph from files this
   script writes.  PageRank at the pagerank phase's size and supersteps
   on the planner's connector (``dense_psum``) within ``PAGERANK_L1_TOL``
   of the phase's float64 oracle; ``merging`` and ``hash_sort`` at
   the sssp phase's size (their buckets hold a whole slab) likewise, in
   ``MESH_BUCKET_SUPERSTEPS`` supersteps, and
   the max combine (``_max_program``) bit-equal to the single-device run;
   each PageRank run twice bit-identical (at 2^25 the second run is
   A10c's crash below, with checkpoints), and a run of
   ``MESH_FAULT_SUPERSTEPS`` with rank 1's sends dropped at the one before
   its last outside the bar of its own float64 oracle.  Semi-naive SSSP
   at the sssp
   phase's size on all three connectors equal to BFS, at least one sparse
   superstep each, modes printed.  IMRU BGD on a (2, 2) pod x data mesh,
   each rank its quarter of ``--imru-log2-records`` x 1280 records made
   from the seed, ``MESH_IMRU_ITERATIONS`` iterations under flat,
   hierarchical, kary_tree and scatter (within the imru phase's bar of a
   float64 oracle, reduced over the ranks, and within
   ``MESH_SCHEDULE_RTOL`` of flat) and the ``int8_ef`` codec (within that
   bar plus its quantization bound, see ``MESH_RANKS``).  ms a superstep
   or an iteration, B1 launches a rank (at least one in every cell), the
   bytes a rank hands each collective a superstep; B1 at the merging and
   hash_sort receivers' shapes held to its plain version and timed
   (``mesh_sites`` in B1's report entry).  Then the generic engine on the
   same ranks (``_mesh_generic``), each cell the generic or rows phase's
   program on its inputs: semi-naive transitive closure on dense grids
   at ``--generic-domain``, each rank holding and computing its block of
   n / 4 rows, exact to ``_tc_oracle``; at n = 2^``--rows-log2-vertices``
   on row tables, the chains' semi-naive transitive closure and semi-naive
   connected components on ``bucket-a2a``, exact, and the forced-row
   PageRank -> threshold -> reach pipeline on ``bucket-a2a`` and on
   ``psum-scatter`` within the rows phase's bar of float64.  Each runs
   twice, bit-identical, with no dense fallback and every rank's answer
   equal to rank 0's: ms an iteration beside the generic or rows phase's
   single-device time of the same program in this run, bytes a rank hands
   each collective an iteration and the bytes staged, B1 launches a rank
   by executor site (at least one at every GroupBy's receivers), and B1 at
   the receivers' shapes held to its plain version and timed beside
   ``torch.segment_reduce``.  Fault tolerance on the same ranks
   (ROADMAP A10c): right after the 2^25 PageRank cell, on its executable
   (``_mesh_ft_pagerank``), PageRank at the pagerank phase's size
   with a checkpoint every ``FT_EVERY`` supersteps (one save timed: the
   gather, the writer's copy and its I/O; the checkpoint's bytes), a
   crash on rank 1 only (every rank restarts once, bit-equal to the
   uninterrupted run), then a run crashed past its restarts, remeshed
   onto ranks 2-3 (rank 0, the writer, lost) and resumed from disk within
   ``PAGERANK_L1_TOL`` of float64; last (``_mesh_ft``), IMRU on the
   (2, 2) mesh crashed
   (bit-equal, or within the bar with the reason printed) and with rank 1
   straggling ``MESH_FT_SLOWDOWN`` times its iteration (every rank falls
   back to ``kary_tree`` at the same iteration, within the bar); the
   ``psum-scatter`` row pipeline crashed in phase 1 on rank 3 only
   (bit-equal), then crashed at phase 2's first step with no restarts
   left, remeshed onto ranks 2-3 and resumed through the phase cursor
   (``hot`` and ``reach`` exact, ranks within the rows phase's bar).
   Restarts and straggler events are printed for every rank, with the
   remesh notes and ms a superstep on 4 and on 2 ranks.  Serving on the
   same ranks last (ROADMAP A10d, ``_mesh_serve``): ``FixpointServer(
   mesh=)`` with personalized PageRank on the serve phase's dense grids at
   4 x ``--generic-domain`` and its 16 seed sets batched (4 also one by
   one), each query within 1e-5 relative L1 of float64, batched within
   1e-8 of one by one and of the serve phase's one-device answers, the
   collective calls of a batched iteration those of one query's; 64
   reachability probes at ``--generic-domain`` equal to scipy's BFS,
   batched bit-equal to one by one; the 4-vertex segment-scan programs'
   16 queries, B1 launched once a GroupBy firing for the batch and held to
   its plain version there (sums within ``kernel.sum_depth``'s bar of one
   by one, max/min bit-equal); 64 mixed requests through
   ``serve_request_loop`` (``max_batch=16``) in arrival order, each within
   1e-5 of float64 or equal to BFS; every rank's answers equal.  Printed:
   ms a query batched and one by one, collective calls and MB staged a
   batched iteration, the cold and warm request times, each rank's peak
   memory, B1's time and launches.  The LM cells on the same ranks last
   (ROADMAP A10e-1, A10e-2, A10h-1, A10h-2, A10h-3; ``_mesh_lm``, one cell
   a model of ``MESH_LM_CELLS``): phi4-mini-3.8b, minicpm3-4b (MLA),
   whisper-medium (encoder-decoder), mamba2-130m (SSM, its tied table
   vocab-parallel) and hymba-1.5b (hybrid; its 25 q / 5 kv heads, which
   2 does not divide, kept whole by the planner, so its attention runs
   replicated beside the replicated SSM half, as the reference's, A10h-3
   case (ii); its 1024-slot ring cut over ``model``) at published width, depth
   cut to ``MESH_LM_LAYERS`` (2) decoder layers (whisper also 2 encoder
   layers and its 1500 stub frames a row), random weights from
   ``--seed`` (the SSMs' A_log and dt_bias from Mamba2's decay init), on a
   (data 2, model 2) mesh (tensor parallel over ``model``).  Each trains
   on a batch of 4 x 2048 tokens in 2 microbatches (``_mesh_train``):
   its AdamW steps under the planner's plan cast to ZeRO-1 (``plan_lm``
   on ``H100_SXM``; phi4 2 steps, the others 1), one step with its
   family's planted fault (``_train_fault``: phi4's layer-0 row-parallel
   MLP psum skipped, MLA's ``copy_to`` at its latents skipped, whisper's
   ``copy_to`` of the encoder output skipped, mamba2's SSD gradients
   psum'd over ``model``, hymba's SSM half's output psum'd over it) and,
   for phi4 and mamba2 (its tied table gathered for each use), one under
   ZeRO-3 (the plan's ``rules.fsdp``), each from the seed's weights.
   Then it serves (``_mesh_serve_lm``) the same rows as prompts, seeded
   weights in bf16, the planner's ``prefill_32k`` / ``decode_32k``
   plans, into a cache cut over ``model`` (hymba's a ring of its window):
   fed decode steps (phi4 24, the others ``TF_STEPS``) fed the one
   device's greedy tokens, then free greedy steps (8, 4) sampled
   vocab-parallel, then the planted fault's steps (``_serve_fault``: the
   decode's split softmax left unjoined over ``model``; mamba2's, with no
   softmax, the vocab-parallel lookup left unsummed).
   Before the ranks start the phase runs each cell on one device (the
   yardsticks), measures the bf16 bounds as the train and lm phases do
   (the plain path against the same model in f32: loss and gradients on
   one row; prefill and ``TF_STEPS`` fed steps) and holds B2 (and in
   training B3 and B4) to its plain version at each of a rank's local
   launch shapes (phi4's H 12, KH 4 at D 128 and whisper's H 8 at D 64
   on ``wgmma``: the encoder, the decoder's self- and cross-attention,
   decode's cross-attention; minicpm3's H 20 at D 96 on ``mma``; hymba's
   whole heads, H 25, KH 5 at D 64, window 1024, on ``wgmma``), timed.
   Bars: every step's loss and grad norm (each rank's) and the prefill's
   and fed steps' logits within ``LM_NOISE_FACTOR`` x the bf16 bound
   (capped at 0.1) of one device's, the serving fault outside it,
   phi4's, mamba2's and hymba's train faults outside it too, and phi4's,
   minicpm3's and whisper's making the ranks' grad norms disagree (the
   copy_to faults move the grad norm by less than the bar); every rank's
   loss, grad norm, joined logits and tokens equal; the data replicas'
   gathered parameters bit-equal after each step; the padded vocab
   columns -1e30 on the last ``model`` rank and never sampled; B2-B4's
   launches a rank exact by route.  Printed: s a step per rank, tokens/s,
   calls and MB a rank hands each collective,
   MB staged, peak memory a rank, the collectives by phase of a train
   step, prefill s and decode ms a step per rank, the free steps' tokens
   that agree with one device.  Any rank's failure fails it.
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
12. ``families``: the other families' serving path, ``launch/serve.py``,
   at published width with seeded random bf16 weights drawn in bf16:
   minicpm3-4b (MLA, 62 layers), whisper-medium (encoder-decoder, 24 +
   24 layers, 4 x 1500 frame embeddings), mixtral-8x22b (MoE, 8 of 56
   layers), arctic-480b (MoE with a dense residual, 2 of 35 layers),
   mamba2-130m (SSM, 24 layers) and hymba-1.5b (attention beside SSM
   heads, 8 of 32 layers, a 1024-slot SWA ring; the cuts in
   ``FAMILY_LAYERS``), one after another, each freed
   before the next: 4 requests of ``--lm-prompt`` tokens, then 32 greedy
   decode steps; prefill s and tokens/s, decode ms a step, peak memory,
   the MoE's pairs dropped a decode step at its own capacity factor, one
   prefill and one decode step profiled.  B2 must launch once a
   self-attention layer in prefill (whisper: also once an encoder layer
   and once a cross-attention layer, which decode launches too; mamba2:
   never), all on the route of the family's head dim (``mma`` at MLA's
   96); two prefills bit-identical.  Bars (``LM_NOISE_FACTOR`` times the
   bf16 bound measured in the run, the plain path against the same
   weights in f32, on one request where the plain attention's scores
   would not fit beside the weights; the MoE at a drop-free capacity, the
   kernel path's expert choices replayed in the witnesses): prefill and
   ``TF_STEPS`` decode logits against the plain path, and decode against
   a teacher-forced forward; one planted fault in each family's own
   mechanism must break the first.  B2 is held to plain and timed beside
   SDPA at MLA's prefill shape (D 96) and at whisper's cross-attention
   shapes.  ``--families-layers`` caps the depths in a rehearsal.
13. ``train``: the flash-attention backward kernels (dQ, dK/dV) against
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
14. ``families_train``: the other families' training.  First the backward
   kernels at every shape their training launches (a microbatch of 4:
   minicpm3-4b's q.k head dim 96 on the ``mma`` route, whisper-medium's
   1500-frame encoder, 448-token decoder and 448 x 1500 cross-attention,
   hymba-1.5b's 25/5 heads with a 1024-key window, mixtral-8x22b's 48/8
   heads), per element against the plain backward within
   ``kernel.bf16_bwd_error_bound``, two launches bit-identical, each timed
   beside SDPA's backward and its bound.  Then minicpm3-4b, whisper-
   medium, mamba2-130m, hymba-1.5b, mixtral-8x22b and arctic-480b in turn,
   at published width with the planner's train dtypes, each at the largest
   depth whose params, AdamW state, f32 gradient accumulator and
   activations fit the card's free memory (``_train_reckoning``, printed;
   arctic-480b fits not one layer and is not trained), minicpm3-4b,
   hymba-1.5b, mamba2-130m and whisper-medium (decoder and encoder) cut
   to 4 layers and mixtral-8x22b to 1 (``FAMILY_TRAIN_DEPTH_CAP``): the whole
   path at 2 layers and one sequence, kernel path against the plain attention
   within ``LM_NOISE_FACTOR`` times the bf16 bound measured in the run
   (expert choices replayed), with one planted backward fault a family
   that leaves the forward exact and must break that bar (MLA's rope key,
   the MoE's gate weights, the SSD loop's carried state, hymba's SSM
   branch, whisper's cross K/V, each detached); then 3 AdamW steps of 8 x
   ``--train-seq`` tokens in 2 microbatches (whisper: 8 x 448 tokens and 8
   x 1500 seeded frames), the forward, dQ and dK/dV launches a step exact
   by route, step 0 run twice from the seed's state with every param and
   moment bit-identical (ROADMAP C6), one step profiled by group (flash,
   GEMMs, the SSD loop, the MoE dispatch, elementwise) with the idle share.
   The SSM families train from Mamba2's decay initialisation.
   ``--families-train-layers`` caps the depths in a rehearsal.
15. ``census``: the dry-run census (``launch/census.py``) of the LM
   paths.  phi4-mini at 2 layers, a 4 x 1000 prefill through the plain
   attention, must count the same FLOPs, bytes and ops on the card as on
   the ``meta`` device, and a census of the kernel path must raise
   (its kernels launch outside the dispatcher).  Then every LM path the
   ``lm``, ``families``, ``train`` and ``families_train`` phases timed
   (phi4's prefill, decode step and train step; each family's prefill
   and train step) is counted on ``meta`` at its plan, shapes, dtypes and
   depth, one worker process a path: its FLOPs, bytes, compute and
   memory terms on the H100's data sheet (``H100_SXM``) and its measured
   time over that bound, which must not be under ``CENSUS_FLOOR``; its
   peak estimate must lie within ``CENSUS_PEAK_FACTOR`` of the path's
   ``max_memory_allocated``.

Prints the card's name and power limit first and again after the phases'
seconds, one
``{"kernels": [...]}`` line with each kernel's launches, times and bound
at the main path's shapes, and as its last line ``{"ok": true, "device":
{...}}``.  Smaller sizes than the defaults make a rehearsal
(``--lm-layers 2 --lm-prompt 1000 --log2-vertices 20
--sssp-log2-vertices 18 --imru-log2-records 18 --generic-domain 256
--rows-log2-vertices 12 --families-layers 2 --train-layers 2
--train-seq 1024 --families-train-layers 2`` for a short first call after
a kernel edit): every
phase runs and is checked, but neither of those two lines is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

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
            "families_layers": 0, "train_layers": 32, "train_seq": 4096,
            "families_train_layers": 0}


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

    from concurrent.futures import ThreadPoolExecutor

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

        def fill(lo, u):
            x = np.power(1.0 + u * span, 1.0 / b)
            rank = np.minimum(x.astype(np.int64) - 1, n - 1)
            out[lo:lo + u.shape[0]] = order[rank]

        # The draws stay one stream, taken in order; each slice's
        # arithmetic runs in a thread (numpy releases the interpreter lock
        # in it), so the graph is the same as one thread makes.
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            for done in [pool.submit(fill, lo, rng.random(min(step, e - lo)))
                         for lo in range(0, e, step)]:
                done.result()
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


@functools.lru_cache(maxsize=1)
def _webgraph_oracle(n: int, seed: int, iters: int, device: str):
    """``pagerank_oracle`` of ``_webgraph(n, seed)``, computed once for the
    pagerank phase and the mesh phase."""

    return pagerank_oracle(*_webgraph(n, seed), n, iters, device)


def pagerank_oracle(src, dst, n: int, iters: int, device="cpu"):
    """float64 PageRank with the Pregel semantics of the program above: a
    vertex that gets no message from an active source keeps its rank and
    halts; halted sources send nothing.  Plain float64 gathers and
    ``index_add_`` on ``device``, sharing no code with the port; on the
    card the sums' order varies from run to run, at float64's rounding
    (a relative 1e-16 of each rank, far below the 1e-5 bar)."""

    import torch

    s = torch.from_numpy(src).to(device=device, dtype=torch.int64)
    d = torch.from_numpy(dst).to(device=device, dtype=torch.int64)
    outdeg = torch.bincount(s, minlength=n).clamp_(min=1).double()
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    got = got_of = None
    for _ in range(iters):
        x = torch.where(active, r / outdeg, 0.0)
        inbox = torch.zeros(n, dtype=torch.float64, device=device)
        inbox.index_add_(0, d, x[s])
        # got depends on the active set alone: recompute it only when the
        # active set changed.
        if got_of is None or not torch.equal(got_of, active):
            got = torch.zeros(n, dtype=torch.bool, device=device)
            got[d[active[s]]] = True
            got_of = active
        r = torch.where(got, 0.15 / n + 0.85 * inbox, r)
        active = got
        del x, inbox
    return r.cpu().numpy()


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
    oracle = _webgraph_oracle(n, args.seed, args.supersteps, device.type)
    rel_l1 = float(np.abs(rank - oracle).sum() / np.abs(oracle).sum())
    print(f"pagerank: {res.iterations} supersteps in {res.seconds:.3f}s "
          f"({res.seconds / res.iterations * 1e3:.2f} ms/superstep), "
          f"plan {ex.plan.notes}, kernel launches {launches}; "
          f"rel L1 vs float64 {rel_l1:.3e} (tol {PAGERANK_L1_TOL}, "
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


def _imru_oracle(X, y, lr, iters, bounds, reduce=None, scales=None):
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

    ``lr`` is the f32 step size the run multiplies by.  Returns (w, bar).

    On a mesh, ``X`` and ``y`` are this rank's records and ``reduce`` sums
    a gradient over the ranks (float64 and f32 alike), so that every rank
    gets the same oracle and bar; ``scales``, if given, receives each
    iteration's largest |float64 gradient component| of any rank.
    """

    import torch

    reduce = reduce or (lambda g, op="sum": g)
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
        if scales is not None:
            scales.append(float(reduce(g.abs().max(), "max")))
        g, g32 = reduce(g), reduce(g32)
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


def phase_generic(args, device, single=None) -> None:
    """The generic engine at the largest domain the planner keeps on dense
    grids for a binary predicate (n^2 cells under its row-table minimum):
    transitive closure (host and device drivers, naive and semi-naive),
    connected components (semi-naive) and the parsed transitive-closure
    text through the rewrite pass, each exactly equal to a numpy/scipy
    oracle.  Joins, projections and GroupBys are dense tensor ops there (a
    sum/max/min GroupBy is a masked reduction).  The planner takes the
    segment scan instead only on grids of at most 21 cells: a PageRank ->
    threshold -> reach pipeline on 4 vertices drives that route, which
    reaches the segment-combine kernel, and counts its launches.  Warm ms
    per iteration go into ``single`` by tag (the mesh phase prints them
    beside its cells)."""

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
        if single is not None:
            single[f"generic {tag}"] = res.seconds / res.iterations * 1e3
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


def phase_rows(args, device, report, single=None) -> None:
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
    kernel against its plain version at the row sites' shapes.  Warm ms
    per iteration go into ``single`` by tag (the mesh phase prints them
    beside its cells)."""

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
        if single is not None:
            single[f"rows {tag.split(',')[0]}"] = \
                res.seconds / res.iterations * 1e3
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


SERVE_SPREAD = (
    "M1: hi(0, X, L)        :- lab(X, L).\n"
    "M2: hi(J+1, X, max<L>) :- hi(J, Y, L), edge(Y, X).\n"
    "M3: hi(J+1, X, L)      :- hi(J, X, L).\n"
    "M4: lo(0, X, L)        :- lab(X, L).\n"
    "M5: lo(J+1, X, min<L>) :- lo(J, Y, L), edge(Y, X).\n"
    "M6: lo(J+1, X, L)      :- lo(J, X, L).\n")
SERVE_SCAN_SRC = (0, 0, 1, 2, 2, 3)
SERVE_SCAN_DST = (1, 2, 2, 0, 3, 1)


def _serve_graph(n, src, dst):
    """The shared ``edge`` and ``deg`` relations of ``src -> dst``, on the
    host."""

    import numpy as np

    from repro_torch.core.executor import Relation

    deg = np.bincount(src, minlength=n).astype(np.float32)
    return {"edge": Relation.from_columns(n, src, dst, device="cpu"),
            "deg": Relation.from_columns(n, np.arange(n), deg,
                                         device="cpu")}


def _spread_program():
    from repro_torch.core.monoid import get_monoid
    from repro_torch.core.parser import parse

    return parse(SERVE_SPREAD, aggregates={
        a: get_monoid(a).as_aggregate() for a in ("max", "min")})


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


def phase_serve(args, device, report, single=None) -> None:
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
    equal to one-by-one dispatch; requests/s.  ``single`` (when given)
    gets (b)'s graph, seed sets and batched ranks under ``"serve grid"``,
    which the mesh phase serves again on its ranks."""

    import numpy as np
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order

    from repro_torch.core.executor import ExecutorError, Relation, RowRelation
    from repro_torch.core.hardware import H100_SXM
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

    def sum_bar(n_, iters):
        # Any-order f32 sums of at most n_ terms (gamma_n relative to the
        # terms' magnitudes) in each of the two runs, each iteration; the
        # damped walk is a contraction in L1, so each iteration's rounding
        # adds at most once.
        return 2 * iters * _gamma(n_)

    # (a) batched dense personalized PageRank --------------------------------
    src, dst = _distinct_out_edges(n, SERVE_DEGREE, rng)
    shared = _serve_graph(n, src, dst)
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
    server = FixpointServer(_serve_graph(n_b, src_b, dst_b), device=device,
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
    if single is not None:
        single["serve grid"] = {
            "src": src_b, "dst": dst_b, "sets": sets_b,
            "ranks": np.stack([_rank_of(a, n_b)[0] for a in b.answers])}
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
    src_e = np.array(SERVE_SCAN_SRC)
    dst_e = np.array(SERVE_SCAN_DST)
    spread = _spread_program()
    server = FixpointServer(_serve_graph(m, src_e, dst_e), device=device,
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
    tests/test_kernels.py's FLASH_SWEEP shapes, ragged tails, D = 160, and
    the families' shapes: MLA's q.k head dim 96, whisper's cross-attention
    (more queries than keys, and one query against the 1500 frames),
    hymba's 25/5 heads with a window."""

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
        (1, 4, 4, 1000, 1000, 96, True, None),
        (1, 4, 4, 1000, 375, 64, False, None),
        (1, 4, 4, 1, 1500, 64, False, None),
        (1, 25, 5, 300, 300, 64, True, 64),
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


def _ranged(name, fn):
    """``fn`` inside a profiler range named ``name`` (a distinct name for
    None: a range that only stops an outer one from claiming its kernels)."""

    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with record_function(f"range: {name}"):
            return fn(*a, **kw)
    return wrapper


def _range_kernels(prof, names):
    """[(kernel name, device us, innermost range)] of every kernel the
    profile linked to an op, each once: the range is the innermost
    ``_ranged`` range among the op's callers (None where none), where a
    backward op counts as called from the forward op that made its
    autograd node (same thread and sequence number).  A range's own span
    on the device timeline is no kernel."""

    from torch.autograd import DeviceType

    fwd, owners = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.kernels:
            owners.setdefault(e.id, e)
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            fwd.setdefault((e.thread, e.sequence_nr), e)
    labels = {f"range: {n}": n for n in names}
    seen = {}

    def range_of(e, depth=0):
        chain = []
        found = None
        while e is not None:
            if e.id in seen:
                found = seen[e.id]
                break
            chain.append(e.id)
            if e.name in labels:
                found = labels[e.name]
                break
            if e.name.startswith("autograd::engine::evaluate_function") \
                    and e.sequence_nr >= 0 and depth < 4:
                f = fwd.get((e.fwd_thread, e.sequence_nr))
                if f is not None:
                    found = range_of(f, depth + 1)
                    break
            e = e.cpu_parent
        for i in chain:
            seen[i] = found
        return found

    return [(k.name, k.duration, range_of(e)) for e in owners.values()
            for k in e.kernels
            if not k.name.startswith(("range: ", "Activity Buffer"))]


def _profile(fn, label, steps, ranges=(), groups=None):
    """Device time by kernel over ``fn()`` (kernel events only) and the
    device's idle share of that window; with ``ranges`` ((group, module,
    attribute) triples), each function named there runs inside a profiler
    range, and ``groups(kernel name, range)`` sorts each kernel by name and
    range.  Returns the summary."""

    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, module, attr in ranges:
            stack.enter_context(mock.patch.object(
                module, attr, _ranged(name, getattr(module, attr))))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # (a range's own span on the device timeline is no kernel)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith(("Activity Buffer", "range: "))]
    rows.sort(key=lambda r: -r[1])
    busy = sum(t for _, t, _ in rows)
    print(f"profile: {label}: wall {wall_us / steps / 1e3:.3f} ms/{label}, "
          f"device busy {busy / steps / 1e3:.3f} ms/{label}, idle share "
          f"{max(0.0, 1 - busy / wall_us):.3f}")
    by_group = {}
    if groups is None:
        for key, t, _ in rows:
            group = next((g for g, words in PROFILE_GROUPS
                          if any(w in key for w in words)), "other")
            by_group[group] = by_group.get(group, 0.0) + t
    else:
        for key, t, rng in _range_kernels(prof, [n for n, _, _ in ranges]):
            group = groups(key, rng)
            by_group[group] = by_group.get(group, 0.0) + t
        linked = sum(by_group.values())
        if linked < busy:
            by_group["not linked to an op"] = busy - linked
    print(f"profile: {label} by group: " + ", ".join(
        f"{g} {t / steps / 1e3:.3f} ms ({t / busy:.1%})"
        for g, t in sorted(by_group.items(), key=lambda x: -x[1]))
        + f" (grouped {sum(by_group.values()) / steps / 1e3:.3f} ms)")
    for key, t, n in rows[:10]:
        print(f"profile:   {t / steps / 1e3:9.3f} ms/{label} {t / busy:6.1%} "
              f"x{n // steps:<4d} {key[:80]}")
    return {"wall_ms": wall_us / steps / 1e3, "busy_ms": busy / steps / 1e3,
            "idle_share": max(0.0, 1 - busy / wall_us),
            "groups_ms": {g: t / steps / 1e3 for g, t in by_group.items()}}


def phase_lm(args, device, report, timed=None) -> None:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.hardware import H100_SXM, MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.launch.serve import build_decode_step, build_prefill_step
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

    batch = {"tokens": prompts}

    # Warm-up on a short prompt (first cuBLAS calls, the kernel's load).
    with torch.inference_mode():
        lm.prefill(params, prompts[:1, :128], cfg, 160)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    run = _serve(prefill_fn, decode_fn, params, batch, steps)
    logits, toks = run["logits"], run["tokens"]
    t_prefill, t_decode = run["prefill_s"], run["decode_s"]
    _timed_path(timed, f"{cfg.name} prefill {B} x {S}", plan, (params, batch),
                t_prefill, run["prefill_peak"], cache_len=cache_len)
    n_prefill, n_decode = run["prefill_launches"], run["decode_launches"]
    n_wgmma = run["prefill_wgmma"]
    del run
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

    torch.cuda.reset_peak_memory_stats()
    _profile(decode_few, "decode step", 4)
    _timed_path(timed, f"{cfg.name} decode step {B} x {cache_len}", plan,
                (params, cache, toks[:, :1], pos), t_decode / steps,
                torch.cuda.max_memory_allocated(), kind="decode")
    del cache

    # The whole path against its plain version: the same weights and
    # prompts with the attention's plain version, decode fed the kernel
    # path's tokens.
    run = _serve(ref_prefill_fn, decode_fn, params, batch, steps, feed=toks)
    r_logits, r_toks = run["logits"], run["tokens"]
    t_ref, r_launch = run["prefill_s"], run["prefill_launches"]
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
    run = _serve(f32_prefill_fn, f32_decode_fn, params32, batch, TF_STEPS,
                 feed=toks)
    f_logits, t_f32 = run["logits"], run["prefill_s"]
    del run
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
# Phase 12: the other LM families served at full width
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("minicpm3_4b", "whisper_medium", "mixtral_8x22b",
                "arctic_480b", "mamba2_130m", "hymba_1_5b")
# Depth cuts the card forces: the bf16 weights of mixtral-8x22b take about
# 5.0 GB a layer (8 of 56 layers: 41 GB), arctic-480b's 27.2 GB (2 of 35:
# 55 GB).  And a cut that keeps the whole script inside its limit, for
# the mesh phase's LM train cells: hymba-1.5b served at 8 of 32 layers
# (21.9 s at 32, 5.0 at 8 on an NVIDIA H100 80GB HBM3 at 700.00 W).
# (minicpm3-4b at 16 of 62 took 8.3 s against 29.9 there, but its census
# peak estimate, which holds ~6 GB the card's path does not, then passed
# 2x the measured peak.)  Every other configuration is served whole.
FAMILY_LAYERS = {"mixtral_8x22b": 8, "arctic_480b": 2, "hymba_1_5b": 8}
# whisper-medium's decoder holds 448 positions (max_target_positions in
# its published config, hf:openai/whisper-medium) and takes a prompt of at
# most 224 tokens: it is served a 224-token prompt decoded to 448.
WHISPER_PROMPT = 224
WHISPER_CONTEXT = 448
# The plain attention's f32 scores, their shifted copy and exp: the
# witness runs on one request where three [B, H, S, S] f32 slabs would
# take more than this share of the card's free memory.
WITNESS_MEMORY_SHARE = 0.6
# The MoE witnesses' capacity factor: a decode step's capacity at the
# configs' 1.25 (one slot an expert) drops pairs that teacher forcing
# keeps, and n_experts (no drop possible) would give arctic-480b T * k
# slots an expert.  Every witness run checks that no pair was dropped.
MOE_WITNESS_CAPACITY = 4.0
# The one-layer checks at published width: the port's f32 mechanism against
# a float64 oracle, rel L2 over ONE_LAYER_DECODE decode steps (or the whole
# scan) within ONE_LAYER_TOL; its planted fault must break the bar.
ONE_LAYER_TOL = 1e-4
ONE_LAYER_DECODE = 8
ONE_LAYER_REQUESTS = 2


def _family_cfg(arch, args):
    """The configuration served: published widths, depth cut only where
    FAMILY_LAYERS says (and to ``--families-layers`` in a rehearsal)."""

    import dataclasses

    from repro_torch.models.registry import get_config

    cfg = get_config(arch)
    n = FAMILY_LAYERS.get(arch, cfg.n_layers)
    changes = {}
    if args.families_layers:
        n = min(n, args.families_layers)
        if cfg.enc_layers:
            changes["enc_layers"] = min(cfg.enc_layers, args.families_layers)
    if n != cfg.n_layers:
        changes["n_layers"] = n
    return dataclasses.replace(cfg, **changes) if changes else cfg


def _family_traffic(cfg, args):
    """(prompt tokens, decode steps) a request: whisper within its decoder's
    context, every other family the ``lm`` phase's prompt and steps."""

    if cfg.family == "encdec":
        S = min(WHISPER_PROMPT, args.lm_prompt)
        return S, WHISPER_CONTEXT - S
    return args.lm_prompt, LM_DECODE_STEPS


def _family_weights(cfg, gen, device):
    """Random weights with the JAX package's distribution (normal 0.02,
    ``small_normal`` 0.02 / sqrt(2 L), ones, zeros) drawn straight in the
    compute dtype, and in f32 where a spec names it (norm scales, the SSM's
    A_log, D and dt_bias): the tree ``lm.serving_params`` makes, without
    an f32 master (arctic's would not fit the card)."""

    import torch

    from repro_torch.models import lm
    from repro_torch.models.common import dtype_of

    dt = dtype_of(cfg.compute_dtype)
    small = 0.02 / max(1.0, (2.0 * cfg.n_layers) ** 0.5)

    def make(spec, stacked):
        if isinstance(spec, dict):
            return {k: make(v, stacked) for k, v in spec.items()}
        shape = ((stacked,) if stacked else ()) + spec.shape
        d = dtype_of(spec.dtype) if spec.dtype else dt
        if spec.init in ("zeros", "ones"):
            fill = torch.zeros if spec.init == "zeros" else torch.ones
            return fill(shape, dtype=d, device=device)
        t = torch.randn(shape, generator=gen, dtype=d, device=device)
        return t.mul_(0.02 if spec.init == "normal" else small)

    return {k: make(v, lm.n_stack(cfg, k))
            for k, v in lm.model_specs(cfg).items()}


def _family_flash_shapes(S):
    """(tag, B, H, KH, Sq, Skv, D, causal, window) of each B2 launch the
    families' served path makes (mamba2 makes none)."""

    from repro_torch.models.registry import get_config

    B = LM_REQUESTS
    mla, wh = get_config("minicpm3_4b"), get_config("whisper_medium")
    Sw = min(WHISPER_PROMPT, S)
    shapes = [("minicpm3-4b prefill", B, mla.n_heads, mla.n_kv_heads, S, S,
               mla.nope_head_dim + mla.rope_head_dim, True, mla.window),
              ("whisper-medium encoder", B, wh.n_heads, wh.n_kv_heads,
               wh.enc_seq, wh.enc_seq, wh.hd, False, None),
              ("whisper-medium decoder self-attention, prefill", B,
               wh.n_heads, wh.n_kv_heads, Sw, Sw, wh.hd, True, wh.window),
              ("whisper-medium cross-attention, prefill", B, wh.n_heads,
               wh.n_heads, Sw, wh.enc_seq, wh.hd, False, None),
              ("whisper-medium cross-attention, decode step", B, wh.n_heads,
               wh.n_heads, 1, wh.enc_seq, wh.hd, False, None)]
    for arch in ("mixtral_8x22b", "arctic_480b", "hymba_1_5b"):
        cfg = get_config(arch)
        shapes.append((f"{cfg.name} prefill", B, cfg.n_heads,
                       cfg.n_kv_heads, S, S, cfg.hd, True, cfg.window))
    return shapes


def _flash_at(B, H, KH, Sq, Skv, D, causal, window, gen, device, tag):
    """B2 at one of the families' shapes (bf16, the LM's layout): held to
    its plain version (``_flash_check``) and timed beside the plain version
    and SDPA (given the window as a boolean mask); returns the report's
    numbers."""

    import torch

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import (
        attention_reference,
        visible_mask,
    )

    q, k, v = (torch.randn(s, generator=gen, device=device)
               .to(torch.bfloat16)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))
    err, ratio, _, checked = _flash_check(q, k, v, causal, window, "bshd",
                                          tag)
    del checked
    scale = 1.0 / D ** 0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = _time_ms(lambda: fa_kernel.flash_fwd(
        q, k, v, causal=causal, window=window, sm_scale=scale,
        layout="bshd"), 10)
    plain_ms = _time_ms(lambda: attention_reference(
        qt, kt, vt, causal=causal, window=window, sm_scale=scale), 3)
    visible = visible_mask(Sq, Skv, causal, window, device)
    sdpa = ({"attn_mask": visible} if window is not None
            else {"is_causal": causal})
    library_ms = _time_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(
                              qt, kt, vt, scale=scale, enable_gqa=H != KH,
                              **sdpa), 10)
    # Visible (query, key) pairs; QK^T and PV are 2 FLOP a MAC each.
    pairs = int(visible.sum())
    del visible
    flops = 4.0 * D * B * H * pairs
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Skv * KH * D) \
        + 2 * 4 * B * H * Sq
    by_ops = flops / BF16_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S
    bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    route = fa_kernel.route("fwd", torch.bfloat16, D)
    mask = ("causal" if causal else "bidirectional") + (
        f", window {window}" if window is not None else "")
    print(f"families: flash_attention_fwd at {tag} (B={B} H={H} KH={KH} "
          f"Sq={Sq} Skv={Skv} D={D} bf16 {mask}, {route} route): kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA {library_ms:.3f} ms, "
          f"bound {bound:.4f} ms ({flops:.4e} FLOP, {nbytes} bytes); vs "
          f"plain max abs err {err:.3e}, max err / bar {ratio:.3f}",
          flush=True)
    return {"at": tag, "shape": {"B": B, "H": H, "KH": KH, "Sq": Sq,
                                 "Skv": Skv, "D": D, "dtype": "bfloat16",
                                 "causal": causal, "window": window,
                                 "layout": "bshd"},
            "kernel_route": route, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if by_ops else "bytes",
            "library_ms": library_ms}


def _b2_launches(cfg):
    """B2 launches a prefill and a decode step: one a layer's self-
    attention (none for the attention-free SSM), and for whisper one an
    encoder layer and one a decoder layer's cross-attention, which decode
    also launches (Sq = 1 against the frames)."""

    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers, cfg.n_layers
    return cfg.n_layers, 0


def _serve(prefill_fn, decode_fn, params, batch, steps, feed=None,
           after_prefill=None, sample=None):
    """Prefill ``batch``, then ``steps`` decode steps fed the greedy tokens
    (or, for the first ``feed.shape[1]`` steps, ``feed``'s);
    ``after_prefill(logits, cache)`` may read or edit the prefill's output
    before decode starts; ``sample(logits)`` takes the greedy tokens
    (``greedy_sample`` where ``None``).  Returns a dict: ``logits`` per
    step [steps+1, B, V] f32, ``tokens`` [B, steps+1], ``prefill_s``,
    ``decode_s``, ``prefill_peak`` (``max_memory_allocated`` after the
    prefill: its peak where the caller reset the statistics before), and
    B2's launches in prefill (``prefill_launches``, of
    them on the wgmma route ``prefill_wgmma``) and in decode
    (``decode_launches``)."""

    import torch

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.serve import greedy_sample

    sample = sample or greedy_sample
    fa_kernel.reset_launch_count()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, pos = prefill_fn(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        prefill_peak = torch.cuda.max_memory_allocated()
        n_prefill = fa_kernel.launch_count
        n_wgmma = fa_kernel.fwd_wgmma_launch_count
        out, token = [logits[:, -1].float()], sample(logits)
        if after_prefill is not None:
            after_prefill(logits, cache)
        toks = [token]
        t0 = time.perf_counter()
        for i in range(steps):
            if feed is not None and i < feed.shape[1]:
                token = feed[:, i:i + 1]
            logits, cache = decode_fn(params, cache, token, pos + i)
            out.append(logits[:, -1].float())
            token = sample(logits)
            toks.append(token)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
    return {"logits": torch.stack(out), "tokens": torch.cat(toks, dim=1),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "prefill_peak": prefill_peak,
            "prefill_launches": n_prefill, "prefill_wgmma": n_wgmma,
            "decode_launches": fa_kernel.launch_count - n_prefill}


def _experts_in_slices(real):
    """``blocks._experts`` over slices of experts whose weights, cast to
    the compute dtype, stay under 1 GiB: the f32 witness of a bf16 MoE (an
    f32 copy of arctic-480b's 128 experts a layer takes 53.5 GB)."""

    import torch

    def experts(buf, p, dt):
        n = max(1, (1 << 30) // (p["w_gate"][0].numel() * dt.itemsize))
        return torch.cat([real(buf[i:i + n], {
            k: p[k][i:i + n] for k in ("w_gate", "w_up", "w_down")}, dt)
            for i in range(0, buf.shape[0], n)])
    return experts


def _family_fault(cfg):
    """(what, context, after_prefill): the planted fault in the family's
    own mechanism that the whole-path bar must catch."""

    import contextlib

    import torch

    from repro_torch.models import blocks

    none = contextlib.nullcontext
    if cfg.family == "mla":
        def drop_latents(logits, cache):
            cache["layers"]["c"].zero_()
        return ("the latent cache c lost between prefill and decode "
                "(zeroed): the absorbed decode attends on the rope scores "
                "alone, over zero values", none(), drop_latents)
    if cfg.family == "moe":
        real = blocks._combine

        def off_by_one(y, slot, weight, order, k):
            return real(y, torch.clamp(slot + 1, max=y.shape[0] - 1),
                        weight, order, k)
        return ("expert rank off by one (each pair reads the slot after its "
                "own)", mock.patch.object(blocks, "_combine", off_by_one),
                None)
    if cfg.family == "ssm":
        def right_padded(xbc, w, b):
            # the next K - 1 inputs read in place of the last K - 1
            K = w.shape[0]
            pad = torch.nn.functional.pad(xbc, (0, 0, 0, K - 1))
            return sum(pad[:, i:i + xbc.shape[1]] * w[i]
                       for i in range(K)) + b
        return ("the causal conv padded on the wrong side",
                mock.patch.object(blocks, "_causal_conv", right_padded), None)
    if cfg.family == "hybrid":
        def drop_state(logits, cache):
            cache["layers"]["ssm"]["ssm"].zero_()
            cache["layers"]["ssm"]["conv"].zero_()
        return ("SSM state not handed from prefill to decode (zeroed), "
                "beside the SWA ring", none(), drop_state)
    if cfg.family == "encdec":
        def zero_cross(logits, cache):
            for t in cache["cross"].values():
                t.zero_()
        return ("cross K/V zeroed after prefill", none(), zero_cross)
    raise ValueError(cfg.family)


def _rel64(a, b):
    return float((a.double() - b).norm() / b.norm())


def _rms64(x, scale):
    return (x * (x.square().mean(-1, keepdim=True) + 1e-6).rsqrt()
            * scale.double())


def _rope64(x, sin, cos):
    """The port's rotary embedding (halves rotated) in float64; x
    [B, T, H, D], sin/cos [T, D/2]."""

    import torch

    d2 = x.shape[-1] // 2
    sin, cos = sin[None, :, None].double(), cos[None, :, None].double()
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend64(q, k, v, rows, window):
    """Causal (and windowed) softmax attention in float64 of the query rows
    ``rows`` (absolute positions) over keys 0..T-1: q [B, n, H, Dq],
    k [B, T, H, Dq], v [B, T, H, Dv] -> [B, n, H * Dv]."""

    import torch

    T = k.shape[1]
    s = torch.einsum("bqhd,bthd->bhqt", q, k) / q.shape[-1] ** 0.5
    col = torch.arange(T, device=q.device)[None, :]
    seen = col <= rows[:, None]
    if window is not None:
        seen &= col > rows[:, None] - window
    s = s.masked_fill(~seen, -torch.inf)
    out = torch.einsum("bhqt,bthd->bqhd", torch.softmax(s, dim=-1), v)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _mla_oracle64(p, x, cfg, rows, sin, cos):
    """MiniCPM3's multi-head latent attention in float64 without the
    absorbed form: full-width keys [k_nope, k_rope] and values from the
    latent, at the query rows ``rows``."""

    import torch

    p = {k: v.double() for k, v in p.items()}
    x = x.double()
    B, T, _ = x.shape
    H, nd, rd, vd, R = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    cq = _rms64(x[:, rows] @ p["q_down"], p["q_norm"])
    q = (cq @ p["q_up"]).reshape(B, len(rows), H, nd + rd)
    kv = x @ p["kv_down"]
    c = _rms64(kv[..., :R], p["kv_norm"])
    k_rope = _rope64(kv[..., R:][:, :, None], sin, cos).expand(B, T, H, rd)
    q_rope = _rope64(q[..., nd:], sin[rows], cos[rows])
    k = (c @ p["k_up"]).reshape(B, T, H, nd)
    v = (c @ p["v_up"]).reshape(B, T, H, vd)
    out = _attend64(torch.cat([q[..., :nd], q_rope], dim=-1),
                    torch.cat([k, k_rope], dim=-1), v, rows, None)
    return out @ p["wo"]


def _gqa_oracle64(p, x, cfg, rows, sin, cos):
    """GQA attention with a sliding window in float64 at the query rows
    ``rows``, over every key (no ring)."""

    p = {k: v.double() for k, v in p.items()}
    x = x.double()
    B, T, _ = x.shape
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x[:, rows] @ p["wq"]).reshape(B, len(rows), H, D)
    k = (x @ p["wk"]).reshape(B, T, KH, D)
    v = (x @ p["wv"]).reshape(B, T, KH, D)
    if cfg.qk_norm:
        q, k = _rms64(q, p["q_norm"]), _rms64(k, p["k_norm"])
    q, k = _rope64(q, sin[rows], cos[rows]), _rope64(k, sin, cos)
    G = H // KH
    out = _attend64(q, k.repeat_interleave(G, dim=2),
                    v.repeat_interleave(G, dim=2), rows, cfg.window)
    return out @ p["wo"]


def _mixer_decode(mixer, p, x, cfg, S, cache_len, after_prefill=None,
                  during_decode=None):
    """One layer's mixer: prefill over x[:, :S] (the plain attention),
    ``after_prefill(cache)``, then a decode step for each later token of
    x, under ``during_decode``; returns the decode outputs [B, n, E]."""

    import contextlib

    import torch

    from repro_torch.models import lm
    from repro_torch.models.blocks import LayerCtx

    dev = x.device
    sin, cos = lm._rope_tables(cfg, torch.arange(S, device=dev)[None])
    with torch.inference_mode():
        _, cache = mixer(p, x[:, :S], LayerCtx(
            cfg=cfg, mode="prefill", sin=sin, cos=cos, cache_len=cache_len,
            attention="ref"))
        if after_prefill is not None:
            after_prefill(cache)
        outs = []
        with during_decode or contextlib.nullcontext():
            for t in range(S, x.shape[1]):
                sin, cos = lm._rope_tables(
                    cfg, torch.full((1, 1), t, device=dev))
                y, cache = mixer(p, x[:, t:t + 1], LayerCtx(
                    cfg=cfg, mode="decode", sin=sin, cos=cos, pos=t), cache)
                outs.append(y)
    return torch.cat(outs, dim=1)


def _one_layer_weights(specs, gen, device):
    """f32 weights that keep activations at unit scale (each matrix normal
    with std 1 / sqrt(fan-in), norm scales one), so that attention is far
    from uniform and every term of the mechanism moves the output."""

    import torch

    return {k: (torch.ones(s.shape, device=device) if s.init == "ones"
                else torch.randn(s.shape, generator=gen, device=device)
                / s.shape[0] ** 0.5)
            for k, s in specs.items()}


def _one_layer_checks(args, device, gen):
    """The family mechanisms that random served weights leave near
    invisible, one layer at published width against float64: MLA's
    absorbed decode (minicpm3-4b) against attention over full-width keys,
    hymba-1.5b's ring decode against windowed attention over every key, and
    ``ssd_chunked`` at mamba2-130m's width against the step recurrence.
    Each holds ONE_LAYER_TOL, and its planted fault must break it: the
    decode's rope scores dropped, the ring a slot off, the inter-chunk term
    dropped."""

    import dataclasses

    import torch

    from repro_torch.models import blocks, lm
    from repro_torch.models.registry import get_config

    B, S, n = ONE_LAYER_REQUESTS, args.lm_prompt, ONE_LAYER_DECODE
    T = S + n
    rows = torch.arange(S, T, device=device)
    out = {}

    def hold(name, got, want, fault, what):
        err, off = _rel64(got, want), _rel64(fault, want)
        print(f"families: one layer, {name}: rel L2 from float64 {err:.3e} "
              f"(bar {ONE_LAYER_TOL}); planted fault, {what}: {off:.3e}",
              flush=True)
        if err > ONE_LAYER_TOL:
            raise AssertionError(f"{name} off its float64 oracle by {err}")
        if off <= ONE_LAYER_TOL:
            raise AssertionError(f"{name}: the bar passes the planted fault "
                                 f"({what})")
        out[name] = {"rel_l2": err, "fault": off}

    for arch in ("minicpm3_4b", "hymba_1_5b"):
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
        x = torch.randn((B, T, cfg.d_model), generator=gen, device=device)
        sin, cos = (t[0] for t in lm._rope_tables(
            cfg, torch.arange(T, device=device)[None]))
        if cfg.family == "mla":
            p = _one_layer_weights(blocks.mla_specs(cfg), gen, device)
            want = _mla_oracle64(p, x, cfg, rows, sin, cos)
            layer = (blocks.mla_mixer, p, x, cfg, S, T)
            got = _mixer_decode(*layer)
            fault = _mixer_decode(*layer, during_decode=mock.patch.object(
                blocks, "apply_rope", lambda t, sin, cos: torch.zeros_like(t)))
            hold(f"{cfg.name} absorbed MLA decode, {n} steps after a "
                 f"{S}-token prefill", got, want, fault,
                 "the decode's rope scores dropped")
        else:
            p = _one_layer_weights(blocks.attention_specs(cfg), gen, device)
            want = _gqa_oracle64(p, x, cfg, rows, sin, cos)
            layer = (blocks.attention_mixer, p, x, cfg, S, cfg.window)
            got = _mixer_decode(*layer)

            def shift(cache):
                for t in cache.values():
                    t.copy_(torch.roll(t, 1, dims=1))
            fault = _mixer_decode(*layer, after_prefill=shift)
            hold(f"{cfg.name} ring decode ({cfg.window} slots), {n} steps "
                 f"after a {S}-token prefill", got, want, fault,
                 "the ring's slots off by one")
        del p, x, want, got, fault

    # The SSD scan: Mamba2's initial ranges, dt log-uniform in
    # [1e-3, 1e-1] and -A uniform in [1, 16], so that the state carries
    # across chunks at the slow heads.
    cfg = get_config("mamba2_130m")
    h, P, N, G = (cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_groups)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    x, Bm, Cm = draw(B, S, h, P), draw(B, S, G, N), draw(B, S, G, N)
    dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1), B, S, h))
    A_log = torch.log(uniform(1.0, 16.0, h))
    D = torch.ones(h, device=device)
    want, st_want = _ssd_recurrence64(x, dt, A_log, Bm, Cm, D)
    chunk = min(cfg.ssm_chunk, S)
    with torch.inference_mode():
        got, st = blocks.ssd_chunked(x, dt, A_log, Bm, Cm, D, chunk)
        real = blocks._ssd_chunk_states

        def no_y_off(st_c, decay):
            states, final = real(st_c, decay)
            return torch.zeros_like(states), final
        with mock.patch.object(blocks, "_ssd_chunk_states", no_y_off):
            fault = blocks.ssd_chunked(x, dt, A_log, Bm, Cm, D, chunk)[0]
    st_err = _rel64(st, st_want)
    print(f"families: one layer, {cfg.name} ssd_chunked final state: rel L2 "
          f"from float64 {st_err:.3e} (bar {ONE_LAYER_TOL})")
    if st_err > ONE_LAYER_TOL:
        raise AssertionError(f"ssd_chunked's final state off by {st_err}")
    hold(f"{cfg.name} ssd_chunked over {S} tokens in chunks of {chunk}",
         got, want, fault, "the inter-chunk term y_off dropped")
    return out


def _ssd_recurrence64(x, dt, A_log, Bm, Cm, D):
    """The SSM as its step recurrence in float64 (the decode's math):
    y [b, s, h, p] and the final state [b, h, p, n]."""

    import torch

    x, dt, Bm, Cm = (t.double() for t in (x, dt, Bm, Cm))
    A = -torch.exp(A_log.double())
    rep = x.shape[2] // Bm.shape[2]
    Bh = torch.repeat_interleave(Bm, rep, dim=2)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)
    st = x.new_zeros((x.shape[0], x.shape[2], x.shape[3], Bm.shape[3]))
    ys = []
    for t in range(x.shape[1]):
        st = st * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bh[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], st))
    return torch.stack(ys, dim=1) + x * D.double()[None, None, :, None], st


def _serve_family(arch, args, device, gen, timed=None):
    """One configuration: served, profiled, held to its bars.  Returns its
    numbers."""

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.hardware import H100_SXM, MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.serve import build_decode_step, build_prefill_step
    from repro_torch.models import blocks, lm

    cfg = _family_cfg(arch, args)
    plan = plan_lm(cfg, "prefill_32k", MeshSpec((("data", 1),)), hw=H100_SXM)
    cfg = plan.cfg
    B = LM_REQUESTS
    S, steps = _family_traffic(cfg, args)
    cache_len = S + steps
    if cfg.window is not None:
        cache_len = min(cache_len, cfg.window)   # a ring, as init_cache's
    tag = f"families: {cfg.name}"

    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    params = _family_weights(cfg, gen, device)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"{tag}: {lm.param_count(cfg)} parameters ({cfg.family}, "
          f"{cfg.n_layers} layers"
          + (f" + {cfg.enc_layers} encoder layers" if cfg.enc_layers else "")
          + f", d_model {cfg.d_model}), {n_bytes / 1e9:.2f} GB of "
          f"{cfg.compute_dtype} weights drawn in "
          f"{time.perf_counter() - t0:.1f}s; cache {cache_len} slots",
          flush=True)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(device)
    batch = {"tokens": prompts}
    if cfg.family == "encdec":
        # the reference's stub: precomputed frame embeddings
        batch["enc_input"] = torch.randn(
            (B, cfg.enc_seq, cfg.d_model), generator=gen, device=device,
            dtype=torch.bfloat16)

    prefill_fn, _ = build_prefill_step(plan, None, cache_len, device)
    decode_fn, _, _ = build_decode_step(plan, None, device)
    want_prefill, want_decode = _b2_launches(cfg)
    D = cfg.nope_head_dim + cfg.rope_head_dim if cfg.family == "mla" \
        else cfg.hd
    route = None if cfg.attention_free else fa_kernel.route(
        "fwd", torch.bfloat16, D)

    # Warm-up on a short prompt (first cuBLAS calls, the kernel's load).
    with torch.inference_mode():
        prefill_fn(params, {k: v[:1, :128] if k == "tokens" else v[:1]
                            for k, v in batch.items()})
    torch.cuda.synchronize()

    # The served run, at the configuration's own capacity factor; which
    # of the MoE layers' pairs were kept, recorded (read after the run).
    kept = []
    real_route = blocks._route

    def route_kept(*a):
        out = real_route(*a)
        kept.append(out[4])
        return out

    first = []
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(blocks, "_route", route_kept):
        run = _serve(prefill_fn, decode_fn, params, batch, steps,
                     after_prefill=lambda logits, cache: first.append(
                         (logits.clone(), tree_map(torch.clone, cache))))
    peak = torch.cuda.max_memory_allocated()
    toks, t_prefill, t_decode = run["tokens"], run["prefill_s"], \
        run["decode_s"]
    _timed_path(timed, f"{cfg.name} prefill {B} x {S}", plan,
                (params, batch), t_prefill, run["prefill_peak"],
                cache_len=cache_len)
    n_prefill, n_decode = run["prefill_launches"], run["decode_launches"]
    by_route = {"wgmma": run["prefill_wgmma"],
                "mma": n_prefill - run["prefill_wgmma"]}
    print(f"{tag}: served {B} requests x {S} prompt tokens + {steps} greedy "
          f"decode steps: prefill {t_prefill:.4f}s = "
          f"{B * S / t_prefill:.1f} tokens/s, decode "
          f"{t_decode / steps * 1e3:.3f} ms/step = "
          f"{B * steps / t_decode:.1f} tokens/s, peak memory "
          f"{peak / 1e9:.2f} GB; B2 launches {n_prefill} in prefill "
          f"(by route {json.dumps(by_route)}), {n_decode} in {steps} decode "
          f"steps", flush=True)
    if n_prefill != want_prefill or n_decode != want_decode * steps:
        raise AssertionError(f"{cfg.name}: B2 launched {n_prefill} times in "
                             f"prefill (want {want_prefill}) and {n_decode} "
                             f"in decode (want {want_decode * steps})")
    if route is not None and by_route[route] != n_prefill:
        raise AssertionError(f"{cfg.name}: prefill launches by route "
                             f"{by_route}, all should take {route} at D {D}")
    if not (bool(torch.isfinite(run["logits"][..., :cfg.vocab]).all())
            and int(toks.max()) < cfg.vocab):
        raise AssertionError(f"{cfg.name}: logits not finite or tokens out "
                             f"of the vocab")
    del run
    drops = []
    if cfg.family == "moe":
        L = cfg.n_layers
        shares = [1 - float(torch.cat(kept[i:i + L]).float().mean())
                  for i in range(0, len(kept), L)]
        drops = shares[1:]
        print(f"{tag}: pairs dropped at capacity factor "
              f"{cfg.capacity_factor} (capacity "
              f"{blocks.moe_capacity(cfg, B * S)} slots an expert in "
              f"prefill, {blocks.moe_capacity(cfg, B)} in a decode step): "
              f"prefill {shares[0]:.4f}, decode steps "
              f"{', '.join(f'{x:.3f}' for x in drops)}")

    # Where the time goes: one prefill (bit-identical to the first) and
    # one decode step on its cache.
    again = []

    def prefill_once():
        with torch.inference_mode():
            again.append(prefill_fn(params, batch))

    _profile(prefill_once, f"{arch} prefill", 1)
    logits2, cache2, pos = again[0]
    same = torch.equal(logits2, first[0][0]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(cache2),
                                          tree_leaves(first[0][1])))
    print(f"{tag}: two prefills bit-identical: {same}")
    if not same:
        raise AssertionError(f"{cfg.name}: two prefills differ")
    del first, logits2

    def decode_once():
        decode_fn(params, cache2, toks[:, :1], pos)

    _profile(decode_once, f"{arch} decode step", 1)
    del cache2, again

    # The bars, on Bw requests (one where the plain attention's scores
    # would not fit beside the weights), the MoE configurations at
    # MOE_WITNESS_CAPACITY with every pair kept.  The kernel path's expert
    # choices are recorded and replayed in the plain, f32 and
    # teacher-forced witnesses: a near-tie that a rounding flips would
    # otherwise swap a token's expert.
    free = torch.cuda.mem_get_info(device)[0]
    slab = 3 * 4 * B * cfg.n_heads * S * S
    Bw = B if cfg.attention_free or slab < WITNESS_MEMORY_SHARE * free else 1
    cfg_w = cfg if not cfg.n_experts else dataclasses.replace(
        cfg, capacity_factor=MOE_WITNESS_CAPACITY)
    plan_w = dataclasses.replace(plan, cfg=cfg_w)
    plan32 = dataclasses.replace(
        plan, cfg=dataclasses.replace(cfg_w, compute_dtype="float32"))
    batch_w = {k: v[:Bw] for k, v in batch.items()}
    feed = toks[:Bw]
    paths = {
        "kernel": (build_prefill_step(plan_w, None, cache_len, device)[0],
                   build_decode_step(plan_w, None, device)[0]),
        "plain": (build_prefill_step(plan_w, None, cache_len, device,
                                     attention="ref")[0],
                  build_decode_step(plan_w, None, device,
                                    attention="ref")[0]),
        "f32": (build_prefill_step(plan32, None, cache_len, device,
                                   attention="ref")[0],
                build_decode_step(plan32, None, device,
                                  attention="ref")[0]),
    }
    routes = []
    replay = _routes_replayed

    def witness(name, ctx):
        with ctx:
            return _serve(*paths[name], params, batch_w, TF_STEPS,
                          feed)["logits"]

    t0 = time.perf_counter()
    kept.clear()
    with mock.patch.object(blocks, "_route", route_kept):
        got = witness("kernel", replay(routes))
        ref = witness("plain", replay(routes))
        with mock.patch.object(blocks, "_experts",
                               _experts_in_slices(blocks._experts)):
            f32 = witness("f32", replay(routes))
        torch.cuda.empty_cache()
        # Teacher forcing: one forward over the prompt and the fed tokens,
        # each MoE layer routed as prefill and the decode steps were.
        L = cfg.n_layers if cfg.n_experts else 0
        tf_routes = [torch.cat([routes[l].reshape(Bw, S, -1)] + [
            routes[L * (1 + i) + l].reshape(Bw, 1, -1)
            for i in range(TF_STEPS)], dim=1).reshape(Bw * (S + TF_STEPS), -1)
            for l in range(L)]
        with replay(tf_routes), torch.inference_mode():
            full = lm.forward(params, torch.cat([batch_w["tokens"],
                                                 feed[:, :TF_STEPS]], dim=1),
                              cfg_w, enc_input=batch_w.get("enc_input"))
    if not all(bool(k.all()) for k in kept):
        raise AssertionError(f"{cfg.name}: a witness dropped a pair at "
                             f"capacity factor {cfg_w.capacity_factor}")
    tf = [_rel_l2(got[i], full[:, S - 1 + i].float(), cfg.vocab)
          for i in range(TF_STEPS + 1)]
    del full
    floor = [_rel_l2(ref[i], f32[i], cfg.vocab) for i in range(TF_STEPS + 1)]
    rel = [_rel_l2(got[i], ref[i], cfg.vocab) for i in range(TF_STEPS + 1)]
    bars = [LM_NOISE_FACTOR * x for x in floor]
    print(f"{tag}: bars on {Bw} request(s)"
          + (f" at capacity factor {cfg_w.capacity_factor} (no pair "
             f"dropped), routes replayed" if cfg.n_experts else "")
          + f" ({time.perf_counter() - t0:.1f}s): the bf16 bound (plain path "
          f"vs the same model in f32) {', '.join(f'{x:.3e}' for x in floor)} "
          f"(prefill, then decode steps); kernel vs plain path "
          f"{', '.join(f'{x:.3e}' for x in rel)}; decode vs teacher-forced "
          f"forward {', '.join(f'{x:.3e}' for x in tf)} (bars "
          f"{', '.join(f'{x:.3e}' for x in bars)})")
    if max(floor) > LM_BF16_BOUND_CAP:
        raise AssertionError(f"{cfg.name}: the bf16 plain path is "
                             f"{max(floor)} off f32")
    if any(r > b for r, b in zip(rel, bars)):
        raise AssertionError(f"{cfg.name}: kernel path off the plain path")
    if any(r > b for r, b in zip(tf, bars)):
        raise AssertionError(f"{cfg.name}: decode off teacher forcing")

    # The planted fault must break the whole-path bar.
    what, fault_ctx, after = _family_fault(cfg)
    with replay(routes), fault_ctx:
        bad = _serve(*paths["kernel"], params, batch_w, TF_STEPS, feed,
                     after_prefill=after)["logits"]
    off = [_rel_l2(bad[i], ref[i], cfg.vocab) for i in range(TF_STEPS + 1)]
    print(f"{tag}: planted fault, {what}: vs the plain path "
          f"{', '.join(f'{x:.3e}' for x in off)} (bars "
          f"{', '.join(f'{x:.3e}' for x in bars)})")
    if not any(o > b for o, b in zip(off, bars)):
        raise AssertionError(f"{cfg.name}: the bar passes the planted fault "
                             f"({what})")
    del params, paths, routes, tf_routes, got, ref, f32, bad, batch, batch_w
    return {"arch": arch, "layers": cfg.n_layers, "prompt": S,
            "decode_steps": steps,
            "prefill_s": t_prefill, "prefill_tokens_per_s": B * S / t_prefill,
            "decode_ms_per_step": t_decode / steps * 1e3, "peak_gb":
            peak / 1e9, "b2_prefill": n_prefill, "b2_route": by_route,
            "b2_decode_per_step": n_decode / steps, "witness_requests": Bw,
            "bound": floor, "kernel_vs_plain": rel, "tf": tf,
            "fault": off, "drop_share_decode": drops}


def phase_families(args, device, report, timed=None) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)
    # B2 at every shape the families give it, held to its plain version
    # and timed beside SDPA.
    shapes = [_flash_at(*shape[1:], gen, device, shape[0])
              for shape in _family_flash_shapes(args.lm_prompt)]
    torch.cuda.empty_cache()
    one_layer = _one_layer_checks(args, device, gen)
    torch.cuda.empty_cache()
    rows = []
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        rows.append(_serve_family(arch, args, device, gen, timed))
        torch.cuda.empty_cache()
        print(f"families: {arch} in {time.perf_counter() - t0:.1f}s",
              flush=True)
    print("families: " + json.dumps({"served": rows,
                                     "one_layer": one_layer}))
    entry = next((e for e in report if e["name"] == "flash_attention_fwd"),
                 None)
    if entry is not None:
        entry["family_shapes"] = shapes
        entry["family_launches_per_prefill"] = {
            r["arch"]: r["b2_prefill"] for r in rows}
        entry["family_routes"] = {r["arch"]: r["b2_route"] for r in rows}


# ---------------------------------------------------------------------------
# Phase 13: LM training (phi4-mini-3.8b), the backward kernels
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
    remat; ``tokens`` a tensor, or a batch dict (an encoder-decoder's
    carries its frames)."""

    import torch

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import lm

    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = lm.loss_fn(leaves, batch, cfg,
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
    """``_family_train_want`` of phi4's train step, every forward, dQ and
    dK/dV launch on the wgmma route; raises if that route does not take
    cfg's head dim."""

    want = _family_train_want(K, cfg, microbatches)
    if want[3:] != want[:3]:
        raise AssertionError(f"the forward, dQ and dK/dV do not all take the "
                             f"wgmma route at D = {cfg.hd}")
    return want


def phase_train(args, device, report, timed=None) -> None:
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
    _timed_path(timed, f"{cfg.name} train step {TRAIN_BATCH} x {S}", plan,
                (state, batches[0]), sum(steady) / len(steady), peak)

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


# ---------------------------------------------------------------------------
# Phase 14: the other LM families trained at full width
# ---------------------------------------------------------------------------

FAMILY_TRAIN_ARCHS = ("minicpm3_4b", "whisper_medium", "mamba2_130m",
                      "hymba_1_5b", "mixtral_8x22b", "arctic_480b")
FAMILY_TRAIN_STEPS = 3
# Depths cut below the reckoning's to keep the whole script inside its
# limit (the longest families first, at published width): 4 of
# minicpm3-4b's 62 layers (100.1 s at 62 in the families_train phase, 27.8
# at 16, 10.0 at 4) and of hymba-1.5b's 32 (90.9 s at 32, 52.8 at 16,
# 16.8 at 4), for the mesh phase's generic and serving cells; 4 of
# mamba2-130m's 24 (50.4 s at 24, 11.3 at 8) and 4 of whisper-medium's 24
# decoder and 24 encoder layers (34.6 s at 24 + 24, 8.1 at 8 + 8), for its
# LM train and serve cells; then 1 of mixtral-8x22b's 56 (51.3 s at the
# reckoning's 2, 28.8 at 1), for its mla and encdec cells (~20 s) (times
# on an NVIDIA H100 80GB HBM3 at 700.00 W).
FAMILY_TRAIN_DEPTH_CAP = {"minicpm3_4b": 4, "hymba_1_5b": 4,
                          "mamba2_130m": 4, "whisper_medium": 4,
                          "mixtral_8x22b": 1}
# The depth reckoning plans for the card's memory less this reserve (the
# CUDA context and loaded kernels, cuBLAS's workspaces, the caching
# allocator's rounding): a depth that depends on the card, not on what
# earlier phases left behind.  mixtral-8x22b at 2 layers peaks at 77.4 GB
# of the H100's 85.0.
TRAIN_MEMORY_RESERVE = 8e9
# Mamba2's initialisation of the SSM's decay (arXiv:2405.21060 and its
# reference code): A ~ U[1, 16], dt ~ logU[1e-3, 1e-1] through dt_bias =
# softplus^-1(dt).  The ssm and hybrid families train from it here: at the
# packages' own A_log = 1, dt_bias = 0 each step decays by e^-1.9, the state
# carried from one chunk to the next moves the gradient by less than its bf16
# rounding, and a fault there would pass unseen.
SSM_A_RANGE = (1.0, 16.0)
SSM_DT_RANGE = (1e-3, 1e-1)
# Kernel-name groups of the family training profiles, after the flash
# kernels; record_function ranges put the SSD chunk loop's kernels (its
# small GEMMs too) and the MoE dispatch's (routing, sorts, gathers and
# scatters, the combine; not the expert GEMMs) in groups of their own.
TRAIN_RANGES = (("ssd loop", "ssd_chunked"), ("moe dispatch", "moe_apply"),
                (None, "_experts"))


def _train_group(key, rng):
    """The profile group of a kernel named ``key`` launched inside the
    ``TRAIN_RANGES`` range ``rng``."""

    words = dict(PROFILE_GROUPS)
    if any(w in key for w in words["flash_fwd"]):
        return "flash fwd"
    if any(w in key for w in words["flash_bwd"]):
        return "flash bwd"
    if rng == "ssd loop":
        return rng
    if any(w in key for w in words["gemm"]):
        return "gemm"
    if rng == "moe dispatch":
        return rng
    return next((g for g, w in PROFILE_GROUPS[3:] if any(x in key for x in w)),
                "elementwise and other")


def _attention_dim(cfg):
    """The q.k head dim of cfg's flash launches."""

    if cfg.family == "mla":
        return cfg.nope_head_dim + cfg.rope_head_dim
    return cfg.hd


def _family_train_want(K, cfg, microbatches):
    """``_train_counts`` of one train step of cfg in bf16 with full remat:
    each flash forward launches again when its layer is recomputed in the
    backward, once a microbatch; the routes those of cfg's head dim."""

    import torch

    n = _b2_launches(cfg)[0] * microbatches
    wgmma = [bool(n) and K.route(kernel, torch.bfloat16,
                                 _attention_dim(cfg)) == "wgmma"
             for kernel in ("fwd", "dq", "dkv")]
    return (2 * n, n, n, 2 * n * wgmma[0], n * wgmma[1], n * wgmma[2])


def _train_reckoning(cfg, plan, batch, seq, budget):
    """(depth, text): the largest depth (decoder layers; an encoder stays
    whole) whose training state and activations fit ``budget`` bytes, 0 if
    one layer does not.

    State a parameter: the params and AdamW's m in the plan's dtypes, v in
    f32 (``adamw`` keeps it so, as the JAX package's does) and the gradient
    accumulator (f32 over several microbatches).  Activations of a
    microbatch of T tokens: each layer's saved input (full remat), and one
    layer's recompute and backward at a time: its widest tensors in the
    compute dtype (attention's q, k, v and output, the MLP's three
    d_ff-wide tensors, the MoE's expert slots: X cap rows of d_model in,
    three of moe_d_ff inside; the SSD loop's f32 chunk tiles) and its
    largest weight gradient in the params' dtype (autograd hands each
    leaf's gradient to the accumulator and frees it), or the cross
    entropy's f32 logit chunks, whichever is larger.  (mixtral-8x22b at 2
    layers: reckoned 74.6 GB, measured 77.4 GB peak on the card.)"""

    import dataclasses

    from repro_torch.models import lm
    from repro_torch.models.blocks import moe_capacity

    size = {"float32": 4, "bfloat16": 2}
    pb, cd = size[cfg.param_dtype], size[cfg.compute_dtype]
    acc = 4 if plan.microbatches > 1 else pb
    per_param = pb + size[plan.m_dtype] + 4 + acc
    one, two = (lm.param_count(dataclasses.replace(cfg, n_layers=n))
                for n in (1, 2))
    per_layer, fixed = two - one, 2 * one - two
    B = batch // plan.microbatches
    T = B * seq
    E = cfg.d_model
    wide = 8 * E + 4 * cfg.n_heads * _attention_dim(cfg)
    if cfg.family != "moe" or cfg.dense_residual:      # a dense MLP
        wide += 3 * cfg.d_ff
    if cfg.n_experts:
        slots = cfg.n_experts * moe_capacity(cfg, T)
        wide += (slots * (E + 3 * cfg.moe_d_ff)) / T + 2 * cfg.top_k * E
    if cfg.ssm_state:
        wide += 2 * (2 * cfg.d_inner + cfg.n_ssm_heads) \
            + 6 * cfg.n_ssm_heads * cfg.ssm_chunk * 4 // cd
    largest = max(math.prod(spec.shape) for spec in
                  lm._spec_leaves(lm.model_specs(cfg)["layers"]))
    layer = max(T * wide * cd + largest * pb,
                3 * B * 512 * cfg.padded_vocab * 4)
    enc = B * cfg.enc_seq * E * cd * cfg.enc_layers

    def need(L):
        state = (fixed + L * per_layer) * per_param
        return state, state + T * E * cd * L + enc + layer

    depth = 0
    while depth < cfg.n_layers and need(depth + 1)[1] <= budget:
        depth += 1
    L = max(depth, 1)
    state, total = need(L)
    text = (f"{per_layer / 1e9:.3f}B parameters a layer, {fixed / 1e9:.3f}B "
            f"outside the layers, {per_param} B a parameter (params "
            f"{cfg.param_dtype}, m {plan.m_dtype}, v float32, accumulator "
            f"{'float32' if acc == 4 else cfg.param_dtype}); at {L} "
            f"layer(s) {state / 1e9:.1f} GB of state + {(total - state) / 1e9:.1f}"
            f" GB of activations ({B} x {seq} tokens a microbatch; one "
            f"layer's recompute and backward {layer / 1e9:.1f} GB) = "
            f"{total / 1e9:.1f} GB against {budget / 1e9:.1f} GB")
    if depth and depth < cfg.n_layers:
        text += f"; at {depth + 1} layers {need(depth + 1)[1] / 1e9:.1f} GB"
    return depth, text


def _ssm_init(params, gen):
    """Mamba2's decay initialisation (SSM_A_RANGE, SSM_DT_RANGE) written
    into the SSM's A_log and dt_bias leaves, in place."""

    import torch

    ssm = params["layers"]["ssm"]

    def uniform(lo, hi, like):
        return lo + (hi - lo) * torch.rand(like.shape, generator=gen,
                                           device=like.device)

    ssm["A_log"].copy_(torch.log(uniform(*SSM_A_RANGE, ssm["A_log"])))
    dt = torch.exp(uniform(math.log(SSM_DT_RANGE[0]),
                           math.log(SSM_DT_RANGE[1]), ssm["dt_bias"]))
    ssm["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))


def _family_params(cfg, gen, device):
    from repro_torch.models import lm

    params = lm.init_params(cfg, gen, device=device)
    if cfg.ssm_state:
        _ssm_init(params, gen)
    return params


def _family_batch(cfg, B, S, gen, device, stream=None):
    """A batch of B sequences of S tokens (from the zipf ``stream``, else
    uniform from ``gen``) and, for the encoder-decoder, B x enc_seq frame
    embeddings from ``gen``."""

    import torch

    if stream is not None:
        batch = next(stream)
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                         device=device, dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["enc_input"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                         generator=gen, device=device)
    return batch


def _backward_fault(cfg):
    """(what, context): the family's planted backward fault.  Each leaves
    the forward's values exact and takes a gradient path away."""

    from repro_torch.models import blocks, lm

    if cfg.family == "mla":
        real = blocks.apply_rope

        def rope_key_detached(x, sin, cos):
            out = real(x, sin, cos)
            return out.detach() if x.shape[2] == 1 else out   # k_rope
        return ("the rope key detached",
                mock.patch.object(blocks, "apply_rope", rope_key_detached))
    if cfg.family == "moe":
        real = blocks._route

        def gates_detached(*a, **kw):
            order, e_s, w_s, rank, keep = real(*a, **kw)
            return order, e_s, w_s.detach(), rank, keep
        return ("the gate weights detached (no gradient to the router)",
                mock.patch.object(blocks, "_route", gates_detached))
    if cfg.family == "ssm":
        real = blocks._ssd_chunk_states

        def state_detached(st_c, decay):
            states, final = real(st_c, decay)
            return states.detach(), final
        return ("the state carried between chunks detached",
                mock.patch.object(blocks, "_ssd_chunk_states",
                                  state_detached))
    if cfg.family == "hybrid":
        real = blocks.ssm_mixer

        def ssm_detached(*a, **kw):
            y, cache = real(*a, **kw)
            return y.detach(), cache
        return ("the SSM branch detached",
                mock.patch.object(blocks, "ssm_mixer", ssm_detached))
    if cfg.family == "encdec":
        real = lm._cross_kv

        def cross_detached(*a):
            return tuple(t.detach() for t in real(*a))
        return ("the cross K/V detached",
                mock.patch.object(lm, "_cross_kv", cross_detached))
    raise ValueError(cfg.family)


def _routes_replayed(log):
    """A context in which ``blocks._top_k`` records its choices into
    ``log`` (when empty) or replays them in call order (when not), so that
    paths that round differently route every token alike."""

    from repro_torch.models import blocks

    real = blocks._top_k
    replay = bool(log)
    it = iter(list(log))

    def top_k(probs, k):
        if not replay:
            log.append(real(probs, k))
            return log[-1]
        idx = next(it)
        if idx.shape != (probs.shape[0], k):
            raise AssertionError("replayed routes out of step")
        return idx
    return mock.patch.object(blocks, "_top_k", top_k)


def _family_grad_check(cfg, S, args, device, gen, K):
    """The whole training path at full width, TRAIN_CHECK_LAYERS layers,
    one sequence: loss and gradients of the kernel path against the plain-
    attention path within LM_NOISE_FACTOR times the plain path's own
    distance from the same model in f32 (over all leaves and leaf by leaf;
    the MoE's expert choices recorded on the plain path and replayed); the
    family's planted backward fault must break that bar.  The plain path's
    gradients wait on the host, so that the f32 model and its gradients
    fit beside the params at mixtral's width."""

    import contextlib
    import dataclasses

    import torch

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import lm

    changes = {"n_layers": min(cfg.n_layers, TRAIN_CHECK_LAYERS)}
    if cfg.enc_layers:
        changes["enc_layers"] = min(cfg.enc_layers, TRAIN_CHECK_LAYERS)
    ccfg = dataclasses.replace(cfg, **changes)
    gen.manual_seed(args.seed + 7)
    params = _family_params(ccfg, gen, device)
    batch = _family_batch(ccfg, 1, S, gen, device)
    routes = []

    def grads(p, c, attention, ctx):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), p)
        with ctx, _routes_replayed(routes):
            loss, _ = lm.loss_fn(leaves, batch, c, remat_policy="full",
                                 attention=attention)
            loss.backward()
        # a leaf a fault cut off from the loss gets no gradient: zero
        out = [torch.zeros_like(t) if t.grad is None else t.grad
               for t in tree_leaves(leaves)]
        del leaves
        torch.cuda.synchronize()
        return float(loss.detach()), out

    def against(gs, ref):
        """(rel L2 over all leaves, rel L2 of each leaf) of gs from ref,
        leaf by leaf on the card."""

        num, den, per = 0.0, 0.0, []
        for g, r in zip(gs, ref):
            r = r.to(device).double()
            d = float((g.to(device).double() - r).square().sum())
            n = float(r.square().sum())
            num, den = num + d, den + n
            per.append((d / n) ** 0.5 if n > 0 else (0.0 if d == 0 else
                                                      math.inf))
        return (num / den) ** 0.5, per

    none = contextlib.nullcontext()
    t0 = time.perf_counter()
    loss_r, g = grads(params, ccfg, "ref", none)
    g_r = [t.cpu() for t in g]
    del g
    K.reset_launch_count()
    loss_k, g_k = grads(params, ccfg, "auto", none)
    launches = _train_counts(K)
    want = _family_train_want(K, ccfg, 1)
    rel, per_k = against(g_k, g_r)
    del g_k
    what, fault_ctx = _backward_fault(ccfg)
    loss_bad, g_bad = grads(params, ccfg, "auto", fault_ctx)
    off, per_bad = against(g_bad, g_r)
    del g_bad
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(ccfg, compute_dtype="float32",
                                param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params
    loss_f, g_f = grads(params32, cfg32, "ref", none)
    del params32
    # the bf16 bound: the plain path's distance from the same model in f32
    floor, per_floor = against(g_r, g_f)
    del g_f, g_r
    torch.cuda.empty_cache()

    def ratio(per):
        return max((p / f if f > 0 else (0.0 if p == 0 else math.inf))
                   for p, f in zip(per, per_floor))

    leaf_ratio, fault_ratio = ratio(per_k), ratio(per_bad)
    loss_floor = abs(loss_r - loss_f) / abs(loss_f)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    bad_loss = abs(loss_bad - loss_k)
    tag = f"families_train: {cfg.name}"
    print(f"{tag}: whole path at full width, {ccfg.n_layers} layers, 1 x {S} "
          f"tokens ({time.perf_counter() - t0:.1f}s"
          + (", expert choices replayed" if cfg.n_experts else "")
          + f"): loss kernel {loss_k:.6f}, plain {loss_r:.6f}, f32 "
          f"{loss_f:.6f}; gradients rel L2 kernel vs plain {rel:.3e} (bar "
          f"{LM_NOISE_FACTOR} x the bf16 bound {floor:.3e} = "
          f"{LM_NOISE_FACTOR * floor:.3e}); loss rel {loss_rel:.3e} (bar "
          f"{LM_NOISE_FACTOR * max(loss_floor, floor):.3e}); largest per-"
          f"leaf ratio to the leaf's own bound {leaf_ratio:.3f} (bar "
          f"{LM_NOISE_FACTOR}); launches {TRAIN_COUNTS} {launches}, want "
          f"{want}; planted fault, {what}: loss moved {bad_loss:.3e}, rel L2 "
          f"{off:.3e}, largest per-leaf ratio {fault_ratio:.3f}", flush=True)
    if launches != want:
        raise AssertionError(f"{tag}: the check's kernel path launched "
                             f"{TRAIN_COUNTS} {launches} times, want {want}")
    if floor > LM_BF16_BOUND_CAP:
        raise AssertionError(f"{tag}: the bf16 plain path is {floor} off f32")
    if rel > LM_NOISE_FACTOR * floor or leaf_ratio > LM_NOISE_FACTOR or \
            loss_rel > LM_NOISE_FACTOR * max(loss_floor, floor):
        raise AssertionError(f"{tag}: kernel path's gradients off the plain "
                             f"path's")
    if bad_loss != 0.0:
        raise AssertionError(f"{tag}: the planted fault ({what}) moved the "
                             f"forward's loss")
    if off <= LM_NOISE_FACTOR * floor and fault_ratio <= LM_NOISE_FACTOR:
        raise AssertionError(f"{tag}: the gradient bar passes the planted "
                             f"fault ({what})")
    return {"layers": ccfg.n_layers, "bound": floor, "kernel_vs_plain": rel,
            "leaf_ratio": leaf_ratio, "loss_rel": loss_rel,
            "fault": what, "fault_rel": off, "fault_leaf_ratio": fault_ratio}


def _family_bwd_shapes(S):
    """(tag, B, H, KH, Sq, Skv, D, causal, window) of each shape at which
    the families' training launches the backward kernels (a microbatch)."""

    from repro_torch.models.registry import get_config

    B = TRAIN_BATCH // TRAIN_MICROBATCHES
    mla, wh = get_config("minicpm3_4b"), get_config("whisper_medium")
    Sw = min(WHISPER_CONTEXT, S)
    shapes = [("minicpm3-4b (MLA, D 96)", B, mla.n_heads, mla.n_kv_heads, S,
               S, _attention_dim(mla), True, None),
              ("whisper-medium encoder", B, wh.n_heads, wh.n_kv_heads,
               wh.enc_seq, wh.enc_seq, wh.hd, False, None),
              ("whisper-medium decoder self-attention", B, wh.n_heads,
               wh.n_kv_heads, Sw, Sw, wh.hd, True, None),
              ("whisper-medium cross-attention", B, wh.n_heads, wh.n_heads,
               Sw, wh.enc_seq, wh.hd, False, None)]
    for arch in ("hymba_1_5b", "mixtral_8x22b"):
        cfg = get_config(arch)
        shapes.append((cfg.name, B, cfg.n_heads, cfg.n_kv_heads, S, S,
                       cfg.hd, True, cfg.window))
    return shapes


def _bwd_at(B, H, KH, Sq, Skv, D, causal, window, gen, device, tag):
    """B3 and B4 at one of the families' training shapes (bf16, the LM's
    layout): per element against the plain backward (f32, the same inputs
    and statistics) within ``kernel.bf16_bwd_error_bound``, one batch row at
    a time; two launches bit-identical; each timed beside SDPA's backward
    (given a binding window as a boolean mask) and its bound.  Returns the
    report's numbers."""

    import torch

    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward,
        visible_mask,
    )

    q, k, v, do = (torch.randn(s, generator=gen, device=device)
                   .to(torch.bfloat16)
                   for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D),
                             (B, Sq, H, D)))
    (m, l, delta, scale), got, same = _bwd_run(q, k, v, do, causal, window,
                                               "bshd")
    if not same:
        raise AssertionError(f"two backward launches differ: {tag}")
    err, bad, ratio = [0.0, 0.0, 0.0], 0, 0.0
    for b in range(B):
        row = slice(b, b + 1)
        qb, kb, vb, dob = (t[row].transpose(1, 2) for t in (q, k, v, do))
        ref = attention_backward(qb.float(), kb.float(), vb.float(),
                                 dob.float(), m[row], l[row], delta[row],
                                 causal=causal, window=window,
                                 sm_scale=scale)
        bars = K.bf16_bwd_error_bound(qb, kb, vb, dob, m[row], l[row],
                                      delta[row], ref, causal=causal,
                                      window=window, sm_scale=scale)
        e, n, r = _bwd_off([g[row].transpose(1, 2) for g in got], ref, bars)
        err = [max(a, x) for a, x in zip(err, e)]
        bad, ratio = bad + n, max(ratio, r)
        del ref, bars
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"backward off plain by more than its bar on "
                             f"{bad} elements (max abs err {max(err)}, max "
                             f"err / bar {ratio}): {tag}")
    del got
    kw = dict(causal=causal, window=window, sm_scale=scale, layout="bshd")
    dq_ms = _time_ms(lambda: K.flash_bwd_dq(q, k, v, do, m, l, delta, **kw),
                     5)
    dkv_ms = _time_ms(lambda: K.flash_bwd_dkv(q, k, v, do, m, l, delta,
                                              **kw), 5)
    visible = visible_mask(Sq, Skv, causal, window, device)
    pairs = int(visible.sum())
    binding = window is not None and not bool(visible.equal(
        visible_mask(Sq, Skv, causal, None, device)))
    sdpa = {"attn_mask": visible} if binding else {"is_causal": causal}
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, scale=scale, enable_gqa=H != KH, **sdpa)
    dot = do.transpose(1, 2)
    library_ms = _time_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, dot, retain_graph=True), 5)
    del sdpa_out, leaves, visible
    out = {}
    nbytes = {
        "dq": 2 * (2 * B * Sq * H * D + 2 * B * Skv * KH * D)
        + 3 * 4 * B * H * Sq,
        "dkv": 2 * (2 * B * Sq * H * D + 4 * B * Skv * KH * D)
        + 3 * 4 * B * H * Sq,
    }
    for key, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
        flops = BWD_FLOP_PER_PAIR[key] * D * B * H * pairs
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes[key] / HBM_BYTES_PER_S
        out[key] = {"ms": ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "route": K.route(key, torch.bfloat16, D)}
    mask = ("causal" if causal else "bidirectional") + (
        f", window {window}" if window is not None else "")
    print(f"families_train: backward kernels at {tag} (B={B} H={H} KH={KH} "
          f"Sq={Sq} Skv={Skv} D={D} bf16 {mask}): dq ({out['dq']['route']}) "
          f"{dq_ms:.3f} ms (bound {out['dq']['bound_ms']:.4f}), dkv "
          f"({out['dkv']['route']}) {dkv_ms:.3f} ms (bound "
          f"{out['dkv']['bound_ms']:.4f}), SDPA backward (dq, dk, dv) "
          f"{library_ms:.3f} ms; vs plain max abs err (dq, dk, dv) "
          f"{', '.join(f'{e:.3e}' for e in err)}, max err / bound "
          f"{ratio:.3f}", flush=True)
    return {"at": tag, "shape": {"B": B, "H": H, "KH": KH, "Sq": Sq,
                                 "Skv": Skv, "D": D, "dtype": "bfloat16",
                                 "causal": causal, "window": window,
                                 "layout": "bshd"},
            "max_abs_err": err, "max_err_over_bound": ratio,
            "dq": out["dq"], "dkv": out["dkv"], "library_ms": library_ms}


def _state_leaves(state):
    from repro_torch.core.tree import tree_leaves

    return tree_leaves(state["params"]) + tree_leaves(tuple(state["opt"]))


def _train_family(arch, args, device, gen, budget, timed=None):
    """One configuration trained: the depth reckoning, the whole-path
    gradient check, FAMILY_TRAIN_STEPS steps of the main run (step 0 twice,
    from the same seed, bit-identical), one step profiled.  Returns its
    numbers, or None where not one layer fits."""

    import dataclasses

    import torch

    from repro_torch.core.hardware import H100_SXM, MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.launch.train import build_train_step, make_optimizer
    from repro_torch.models import blocks, lm
    from repro_torch.models.registry import get_config

    full = get_config(arch)
    plan = plan_lm(full, "train_4k", MeshSpec((("data", 1),)), hw=H100_SXM)
    plan = dataclasses.replace(plan, microbatches=TRAIN_MICROBATCHES)
    S = min(WHISPER_CONTEXT, args.train_seq) if full.family == "encdec" \
        else args.train_seq
    depth, reckoning = _train_reckoning(plan.cfg, plan, TRAIN_BATCH, S,
                                        budget)
    tag = f"families_train: {full.name}"
    print(f"{tag}: depth {depth} of {full.n_layers} by the reckoning: "
          f"{reckoning}", flush=True)
    if depth == 0:
        print(f"{tag}: not trained on one card (not one layer fits; its "
              f"training waits for a mesh, ROADMAP A10f)", flush=True)
        return None
    changes = {"n_layers": min(depth, FAMILY_TRAIN_DEPTH_CAP.get(arch, depth))}
    if full.enc_layers and arch in FAMILY_TRAIN_DEPTH_CAP:
        changes["enc_layers"] = min(full.enc_layers,
                                    FAMILY_TRAIN_DEPTH_CAP[arch])
    if changes["n_layers"] < depth:
        print(f"{tag}: trained at {changes['n_layers']} layers "
              f"(FAMILY_TRAIN_DEPTH_CAP)", flush=True)
    if args.families_train_layers:
        changes["n_layers"] = min(depth, args.families_train_layers)
        if full.enc_layers:
            changes["enc_layers"] = min(full.enc_layers,
                                        args.families_train_layers)
    cfg = dataclasses.replace(plan.cfg, **changes)
    plan = dataclasses.replace(plan, cfg=cfg)

    check = _family_grad_check(cfg, S, args, device, gen, K)
    torch.cuda.empty_cache()

    # The main run: 8 x S tokens a step in 2 microbatches (whisper: 8 x 448
    # decoder tokens and 8 x 1500 frames), AdamW at TRAIN_LR.
    stream = SyntheticLMStream(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=TRAIN_BATCH,
        seed=args.seed, task="zipf"), device=device)
    gen.manual_seed(args.seed + 11)
    batches = [_family_batch(cfg, TRAIN_BATCH, S, gen, device, stream)
               for _ in range(FAMILY_TRAIN_STEPS + 1)]

    def fresh():
        gen.manual_seed(args.seed)
        params = _family_params(cfg, gen, device)
        opt = make_optimizer(plan, lr=TRAIN_LR)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        return state, build_train_step(plan, None, optimizer=opt,
                                       device=device)[0]

    # Determinism (ROADMAP C6): step 0 from the seed's state, kept on the
    # host, then the state made again from the seed and the main run's
    # step 0 must give the same bits in every param and moment.
    state, step_fn = fresh()
    state, metrics = step_fn(state, batches[0])
    first = (float(metrics["loss"]), float(metrics["grad_norm"]))
    kept = [t.cpu() for t in _state_leaves(state)]
    state_bytes = sum(t.numel() * t.element_size() for t in kept)
    del state, step_fn, metrics
    torch.cuda.empty_cache()

    state, step_fn = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_count()
    want = _family_train_want(K, cfg, TRAIN_MICROBATCHES)
    rows, same = [], None
    tokens = TRAIN_BATCH * S
    for i in range(FAMILY_TRAIN_STEPS):
        before = _train_counts(K)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = tuple(a - b for a, b in zip(_train_counts(K), before))
        rows.append((dt, loss, gnorm, n))
        print(f"{tag}: step {i}: {dt:.3f}s = {tokens / dt:.1f} tokens/s, "
              f"loss {loss:.6f}, grad_norm {gnorm:.6f}, launches "
              f"{TRAIN_COUNTS} {n}", flush=True)
        if i == 0:
            same = (loss, gnorm) == first and all(
                torch.equal(t, h.to(device))
                for t, h in zip(_state_leaves(state), kept))
            del kept
    peak = torch.cuda.max_memory_allocated()
    steady = [r[0] for r in rows[1:]]
    s_step = sum(steady) / len(steady)
    print(f"{tag}: {lm.param_count(cfg)} parameters ({cfg.n_layers} layers"
          + (f" + {cfg.enc_layers} encoder" if cfg.enc_layers else "")
          + f"), {state_bytes / 1e9:.2f} GB of state; {FAMILY_TRAIN_STEPS} "
          f"steps, steady {s_step:.3f} s/step = {tokens / s_step:.1f} "
          f"tokens/s; peak memory {peak / 1e9:.2f} GB; step 0 twice from the "
          f"seed bit-identical: {same}; launches a step {want} wanted",
          flush=True)
    if any(r[3] != want for r in rows):
        raise AssertionError(f"{tag}: flash kernels launched "
                             f"{[r[3] for r in rows]} times a step, want "
                             f"{want}")
    if not all(math.isfinite(x) for r in rows for x in r[1:3]):
        raise AssertionError(f"{tag}: loss or grad_norm not finite")
    if not same:
        raise AssertionError(f"{tag}: two runs of step 0 from the same state "
                             f"differ")
    if int(state["step"]) != FAMILY_TRAIN_STEPS:
        raise AssertionError(f"{tag}: state step {int(state['step'])}")
    _timed_path(timed, f"{cfg.name} train step {TRAIN_BATCH} x {S}", plan,
                (state, batches[0]), s_step, peak)

    ranges = [(name, blocks, attr) for name, attr in TRAIN_RANGES]
    prof = _profile(lambda: step_fn(state, batches[FAMILY_TRAIN_STEPS]),
                    f"{cfg.name} train step", 1, ranges=ranges,
                    groups=_train_group)
    del state, step_fn, batches, stream
    return {"arch": arch, "layers": cfg.n_layers,
            "enc_layers": cfg.enc_layers, "depth_reckoning": reckoning,
            "tokens_per_step": tokens, "s_per_step": s_step,
            "tokens_per_s": tokens / s_step, "peak_gb": peak / 1e9,
            "losses": [r[1] for r in rows], "grad_norms": [r[2] for r in rows],
            "step_s": [r[0] for r in rows], "launches_per_step": want,
            "bit_identical": same, "check": check, "profile": prof}


def phase_families_train(args, device, report, timed=None) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 3)
    t_phase = time.perf_counter()
    # B3 and B4 at every shape the families' training gives them.
    shapes = [_bwd_at(*shape[1:], gen, device, shape[0])
              for shape in _family_bwd_shapes(args.train_seq)]
    torch.cuda.empty_cache()
    budget = torch.cuda.mem_get_info(device)[1] - TRAIN_MEMORY_RESERVE
    rows = []
    for arch in FAMILY_TRAIN_ARCHS:
        t0 = time.perf_counter()
        row = _train_family(arch, args, device, gen, budget, timed)
        torch.cuda.empty_cache()
        print(f"families_train: {arch} in {time.perf_counter() - t0:.1f}s",
              flush=True)
        if row is not None:
            rows.append(row)
    print("families_train: " + json.dumps({"trained": rows,
                                           "bwd_shapes": shapes}))
    print(f"families_train: phase in {time.perf_counter() - t_phase:.1f}s")
    for entry in report:
        if entry["name"] in ("flash_bwd_dq", "flash_bwd_dkv"):
            key = entry["name"][10:]
            entry["family_train_shapes"] = [
                {"at": s["at"], "shape": s["shape"], **s[key],
                 "library_ms": s["library_ms"]} for s in shapes]
            entry["family_train_launches_per_step"] = {
                r["arch"]: r["launches_per_step"][1 if key == "dq" else 2]
                for r in rows}


# ---------------------------------------------------------------------------
# Phase 15: the census of every timed LM path (launch/census.py)
# ---------------------------------------------------------------------------

# A measured time under CENSUS_FLOOR times its census bound fails: the
# census counts work the step does not do, or the timing ends early.  The
# bound counts attention as full blocks (the plain chunked version's work,
# masked blocks too): an over-count the bar is not loosened for.
CENSUS_FLOOR = 0.95
# The census's peak estimate within this factor of max_memory_allocated.
CENSUS_PEAK_FACTOR = 2.0
# The device-independence check: phi4 at 2 layers, a 4 x 1000 prefill.
CENSUS_CHECK_LAYERS, CENSUS_CHECK_BATCH, CENSUS_CHECK_PROMPT = 2, 4, 1000


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A tensor's shape and dtype, standing in for it in a timed path's
    arguments (sent to the census's worker processes)."""

    shape: tuple
    dtype: str


def _stand_ins(tree):
    import torch

    from repro_torch.core.tree import tree_map

    return tree_map(lambda t: _Leaf(tuple(t.shape), str(t.dtype)[6:])
                    if isinstance(t, torch.Tensor) else t, tree)


def _on_meta(tree):
    """``tree`` with each tensor or ``_Leaf`` made a ``meta`` tensor of its
    shape and dtype."""

    import torch

    from repro_torch.core.tree import tree_map

    def meta(x):
        if isinstance(x, torch.Tensor):
            x = _Leaf(tuple(x.shape), str(x.dtype)[6:])
        if isinstance(x, _Leaf):
            return torch.empty(x.shape, dtype=getattr(torch, x.dtype),
                               device="meta")
        return x

    return tree_map(meta, tree)


def _timed_path(timed, name, plan, args, measured_s, peak_bytes, *,
                kind=None, cache_len=None):
    """Record a timed LM path for the ``census`` phase: its plan, its
    step's arguments' shapes and dtypes, its measured time and its
    ``max_memory_allocated``."""

    if timed is not None:
        timed.append({"name": name, "kind": kind or plan.kind, "plan": plan,
                      "cache_len": cache_len, "args": _stand_ins(args),
                      "measured_s": measured_s, "peak_bytes": peak_bytes})


def _census_of_path(path):
    """The census of one timed path's step, built by the port's entry
    points on the ``meta`` device from its plan, at its arguments' shapes
    and dtypes (run in a worker process)."""

    import torch

    from repro_torch.core.hardware import H100_SXM
    from repro_torch.launch.census import census_of, roofline_terms
    from repro_torch.launch.serve import build_decode_step, build_prefill_step
    from repro_torch.launch.train import build_train_step, make_optimizer

    meta = torch.device("meta")
    plan, kind = path["plan"], path["kind"]
    if kind == "train":
        step = build_train_step(plan, None, device=meta,
                                optimizer=make_optimizer(plan, lr=TRAIN_LR))[0]
    elif kind == "prefill":
        step = build_prefill_step(plan, None, path["cache_len"], meta)[0]
    else:
        step = build_decode_step(plan, None, meta)[0]
    t0 = time.perf_counter()
    _, census = census_of(step, *_on_meta(path["args"]))
    terms = roofline_terms(census, 1, hw=H100_SXM)
    return {"flops": census.dot_flops, "bytes": census.bytes_accessed,
            "region_bytes": census.vmem_region_bytes,
            "peak_estimate_bytes": census.peak_bytes,
            "census_s": time.perf_counter() - t0,
            **{k: terms[k] for k in ("compute_s", "memory_s",
                                     "step_lower_bound_s", "dominant")}}


def _census_equal(card, meta):
    return (card.dot_flops == meta.dot_flops
            and card.bytes_accessed == meta.bytes_accessed
            and card.vmem_region_bytes == meta.vmem_region_bytes
            and card.op_counts == meta.op_counts)


def phase_census(args, device, timed) -> None:
    """(a) The census of phi4's plain-attention prefill on the card equals
    its census on ``meta``, and a census of the kernel path raises.  (b)
    Each path the run timed, counted on ``meta`` at its shapes and depth
    (in worker processes, one a path), against its measured time: the
    measured time over the H100's data-sheet bound.  (c) The census's peak
    estimate against the path's ``max_memory_allocated``."""

    import concurrent.futures
    import multiprocessing

    import torch

    from repro_torch.core.hardware import H100_SXM, MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.launch.census import census_of
    from repro_torch.launch.serve import build_prefill_step
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config

    t_phase = time.perf_counter()
    # Start the workers first: they count on the host while (a) runs.
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=max(1, min(len(timed), os.cpu_count() or 1)),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [pool.submit(_census_of_path, p) for p in timed]

        # (a) Device independence, and the kernel path refused.
        cfg = dataclasses.replace(get_config(LM_ARCH),
                                  n_layers=CENSUS_CHECK_LAYERS)
        plan = plan_lm(cfg, "prefill_32k", MeshSpec((("data", 1),)),
                       hw=H100_SXM)
        cfg, B, S = plan.cfg, CENSUS_CHECK_BATCH, CENSUS_CHECK_PROMPT
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed + 5)
        params = lm.serving_params(cfg, lm.init_params(cfg, gen,
                                                       device=device))
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                         device=device, dtype=torch.int32)}
        _, on_card = census_of(build_prefill_step(
            plan, None, S, device, attention="ref")[0], params, batch)
        _, on_meta = census_of(build_prefill_step(
            plan, None, S, "meta", attention="ref")[0],
            *_on_meta((params, batch)))
        same = _census_equal(on_card, on_meta)
        print(f"census: {cfg.name} ({cfg.n_layers} layers) prefill {B} x {S}"
              f" with the plain attention: on the card {on_card.dot_flops:.6e}"
              f" FLOPs, {on_card.bytes_accessed:.6e} bytes, "
              f"{sum(on_card.op_counts.values())} ops; on meta "
              f"{on_meta.dot_flops:.6e}, {on_meta.bytes_accessed:.6e}, "
              f"{sum(on_meta.op_counts.values())}: equal {same}", flush=True)
        if not same:
            raise AssertionError("the census on the card differs from the "
                                 "census on meta")
        try:
            census_of(build_prefill_step(plan, None, S, device)[0], params,
                      batch)
            refused = None
        except RuntimeError as e:
            refused = str(e)
        print(f"census: the kernel path's census raises: {refused}")
        if refused is None or "flash_fwd" not in refused:
            raise AssertionError("a census of the kernel path did not raise "
                                 "naming the kernel")
        del params, batch, on_card
        torch.cuda.empty_cache()

        # (b), (c) Each timed path against its census.
        card = _card_line()
        rows, failed = [], []
        for path, future in zip(timed, futures):
            c = future.result()
            share = path["measured_s"] / c["step_lower_bound_s"]
            peak = c["peak_estimate_bytes"] / path["peak_bytes"]
            rows.append({"path": path["name"], **c,
                         "measured_s": path["measured_s"],
                         "measured_over_bound": share,
                         "max_memory_allocated": path["peak_bytes"],
                         "peak_estimate_over_measured": peak})
            print(f"census: {path['name']} [{card}]: {c['flops']:.6e} FLOPs, "
                  f"{c['bytes']:.6e} bytes ({c['region_bytes']:.6e} in the "
                  f"kernels' regions); compute_s {c['compute_s']:.6f}, "
                  f"memory_s {c['memory_s']:.6f}, step_lower_bound_s "
                  f"{c['step_lower_bound_s']:.6f} ({c['dominant']}); "
                  f"measured {path['measured_s']:.6f} s, measured / bound "
                  f"{share:.4f}; peak estimate "
                  f"{c['peak_estimate_bytes'] / 1e9:.3f} GB vs "
                  f"max_memory_allocated {path['peak_bytes'] / 1e9:.3f} GB "
                  f"({peak:.3f}); counted in {c['census_s']:.1f}s",
                  flush=True)
            if share < CENSUS_FLOOR:
                failed.append(f"{path['name']}: measured / bound {share:.4f}"
                              f" under {CENSUS_FLOOR}")
            if not 1 / CENSUS_PEAK_FACTOR <= peak <= CENSUS_PEAK_FACTOR:
                failed.append(f"{path['name']}: peak estimate / measured "
                              f"{peak:.3f} outside {CENSUS_PEAK_FACTOR}x")
    finally:
        pool.shutdown(cancel_futures=True)
    seconds = time.perf_counter() - t_phase
    print("census: " + json.dumps({"card": card, "hardware": H100_SXM.name,
                                   "paths": rows, "phase_s": seconds}))
    print(f"census: {len(rows)} timed paths against their census on "
          f"{card}; phase in {seconds:.1f}s", flush=True)
    if not rows:
        raise AssertionError("no timed LM path reached the census")
    if failed:
        raise AssertionError("census: " + "; ".join(failed))

# ---------------------------------------------------------------------------
# Phase 16: the mesh (sharded Pregel and IMRU over torch.distributed)
# ---------------------------------------------------------------------------
#
# MESH_RANKS ranks, spawned by launch_ranks: with as many GPUs, one a rank
# over nccl; on one card, all on cuda:0 over gloo, staged through pinned
# host buffers.  Every rank builds the same global graph and keeps its
# shard.  The int8_ef bar adds to the f32 bar what the codec's rounding can
# move the model: a rank's residual holds each component within half a
# quantization step s_k = max |g + r| / 127, the update telescopes to
# lr * sum_r (r_{r,k} - r_{r,k+1}) an iteration, and ||I - lr X^T X|| <= 1
# carries it undamped at most, so ||m - m_exact|| <= lr R sqrt(d) sum_k s_k
# for R ranks.  s_k is read from the float64 oracle's per-rank gradients,
# doubled for the residual it adds and the trajectory it moves.

MESH_RANKS = 4
MESH_TIMEOUT = 600.0
MESH_CC_SUPERSTEPS = 8
# PageRank supersteps of the merging and hash_sort cells (the pagerank
# phase's count at 2^25): their slab-sized buckets cost 0.33-0.35 s a
# superstep on one card, three runs a connector.
MESH_BUCKET_SUPERSTEPS = 10
# Supersteps of a PageRank cell's planted-fault run (rank 1's sends dropped
# at the one before the last), held to its own float64 oracle.
MESH_FAULT_SUPERSTEPS = 4
MESH_IMRU_ITERATIONS = 5
MESH_SCHEDULES = ("flat", "hierarchical", "kary_tree", "scatter")
MESH_SCHEDULE_RTOL = 1e-6
# The LM cells on a mesh (ROADMAP A10e-1, A10e-2, A10h-1, A10h-2,
# A10h-3): each model of MESH_LM_CELLS at published width, depth cut to
# MESH_LM_LAYERS decoder layers (and as many of whisper's encoder layers;
# its rows carry its 1500 stub frames), seeded weights (the SSM's decay
# init, _family_params), on a (data 2, model 2) mesh.  A cell trains on a
# batch of MESH_LM_BATCH x MESH_LM_SEQ tokens in MESH_TRAIN_MICROBATCHES
# microbatches: "steps" AdamW steps under ZeRO-1, one step with its
# family's planted fault and, where "zero3", one step under ZeRO-3, each
# from the seed's weights.  Then it serves the same rows as prompts into a
# cache of MESH_LM_SEQ + "fed" + "free" slots, or a ring of the window's
# where that is shorter (cut over model): "fed" decode steps fed the one
# device's greedy tokens, then "free" free greedy steps; the planted fault
# runs MESH_SERVE_LM_FAULT_STEPS fed steps from the prefill's cache.
MESH_TRAIN_SHAPE = ((2, 2), ("data", "model"))
MESH_LM_LAYERS = 2
MESH_LM_BATCH = 4
MESH_LM_SEQ = 2048
MESH_TRAIN_MICROBATCHES = 2
MESH_TRAIN_FAULT_LAYER = 0
MESH_SERVE_LM_FAULT_STEPS = 2
MESH_LM_CELLS = {
    LM_ARCH: {"steps": 2, "zero3": True, "fed": 24, "free": 8},
    "minicpm3_4b": {"steps": 1, "zero3": False, "fed": TF_STEPS, "free": 4},
    "whisper_medium": {"steps": 1, "zero3": False, "fed": TF_STEPS,
                       "free": 4},
    "mamba2_130m": {"steps": 1, "zero3": True, "fed": TF_STEPS, "free": 4},
    "hymba_1_5b": {"steps": 1, "zero3": False, "fed": TF_STEPS, "free": 4},
}


def _max_program():
    """Max-label propagation (connected components on the directed
    graph): the max combine of the mesh phase's 2^22 cells."""

    import torch

    from repro_torch.core.pregel import VertexProgram

    return VertexProgram(
        init_vertex=lambda ids, vd: ids.to(torch.float32),
        message=lambda j, s, ed: s,
        apply=lambda j, s, inbox, got: (torch.maximum(s, inbox),
                                        torch.maximum(s, inbox) > s),
        combine="max")


def _sssp_program(source):
    import torch

    from repro_torch.core.pregel import VertexProgram

    return VertexProgram(
        init_vertex=lambda ids, vd: torch.where(ids == source, 0.0, 1e9),
        message=lambda j, s, ed: s + 1.0,
        apply=lambda j, s, inbox, got: (torch.minimum(s, inbox),
                                        torch.minimum(s, inbox) < s),
        combine="min")


def _counted_run(ex, mesh, iters):
    """``ex.run`` with the kernel's and the mesh's counts set to 0 just
    before and read just after: (result, B1 launches, bytes handed to
    each collective, staged bytes)."""

    import torch

    from repro_torch.kernels.segment_combine import kernel as sc_kernel

    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    mesh.stats.reset()
    sc_kernel.reset_launch_count()
    res = ex.run(max_iters=iters)
    launches = sc_kernel.launch_count
    return (res, launches, dict(mesh.stats.sent), mesh.stats.staged_bytes)


def _dropped_sends(rank, call):
    """The connectors with one planted fault: on ``rank``, connector call
    number ``call`` (two a dense superstep: inbox, then got) sends zeros,
    as if that rank's exchange had been skipped for one superstep."""

    import torch.distributed as dist

    from repro_torch.core import executor

    calls = [0]

    def wrap(real):
        def faulty(dst, payload, *a, **kw):
            hit = calls[0] == call and dist.get_rank() == rank
            calls[0] += 1
            return real(dst, payload * 0 if hit else payload, *a, **kw)
        return faulty

    return mock.patch.dict(executor._EXCHANGES, {
        k: wrap(v) for k, v in executor._EXCHANGES.items()})


def _mesh_pagerank(mesh, n, graph, oracles, conn, supersteps, capture,
                   again=True):
    """PageRank on the mesh: the counted run, with ``again`` a second run
    (bit-identical), and one of MESH_FAULT_SUPERSTEPS supersteps with rank
    1's sends dropped at the one before its last, which must break the bar
    against its own oracle.  ``oracles`` are the float64 ranks after
    ``supersteps`` and after MESH_FAULT_SUPERSTEPS.  Returns the cell, the
    captured receiver site and the executable."""

    import numpy as np
    import torch

    from repro_torch.core import physical
    from repro_torch.core.pregel import compile_pregel

    prog = pagerank_program(n)
    ex = compile_pregel(prog, graph, mesh=mesh, force_connector=conn)
    site = []
    real = physical.segment_combine_sorted

    def keep(values, ids, num, op="sum", *, edge_active=None, **kw):
        if not site and num == n // MESH_RANKS + 1:
            site.append((values, ids, num, op, edge_active))
        return real(values, ids, num, op, edge_active=edge_active, **kw)

    with mock.patch.object(physical, "segment_combine_sorted",
                           keep if capture else real):
        res, launches, sent, staged = _counted_run(ex, mesh, supersteps)
    digest = _digest(res.state[0])
    same = None
    if again:
        same = bool(torch.equal(res.state[0],
                                ex.run(max_iters=supersteps).state[0]))

    def rel(r, oracle):
        rank = r.state[0][:, 0].double().cpu().numpy()
        ok = bool(np.isfinite(rank).all())
        return float(np.abs(rank - oracle).sum() / np.abs(oracle).sum()) \
            if ok else float("inf")

    steps = MESH_FAULT_SUPERSTEPS
    with _dropped_sends(1, 2 * (steps - 2)):
        bad = compile_pregel(prog, graph, mesh=mesh, force_connector=conn)
    fault = rel(bad.run(max_iters=steps), oracles[1])
    del bad
    it = res.iterations
    return {"connector": ex.plan.connector, "notes": list(ex.plan.notes),
            "iterations": it, "ms": res.seconds / it * 1e3,
            "launches": launches, "rel_l1": rel(res, oracles[0]),
            "identical": same, "fault_rel_l1": fault, "digest": digest,
            "sent_per_superstep": {k: v / it for k, v in sent.items()},
            "staged_per_superstep": staged / it,
            "slab": ex.local_edge_cap}, site, ex


# The generic engine's cells of the mesh phase: the generic and rows
# phases' programs and inputs on the same ranks, the row cells on forced
# explicit exchanges.  The pipeline's PageRank phase runs
# MESH_ROWS_PR_ITERS iterations (the rows phase's ROWS_PR_ITERS).
MESH_ROWS_PR_ITERS = ROWS_PR_ITERS
MESH_PIPELINE_EXCHANGES = ("bucket-a2a", "psum-scatter")
# Each cell's single-device counterpart: the tag the generic or rows phase
# recorded its warm ms per iteration under in the same run.
MESH_SINGLE = {"dense tc": "generic tc semi_naive=True host driver",
               "rows tc": "rows tc semi_naive=True host driver",
               "rows cc": "rows cc semi-naive",
               "pipeline bucket-a2a": "rows pagerank -> threshold -> reach",
               "pipeline psum-scatter": "rows pagerank -> threshold -> reach"}


def _chains(n):
    """The rows phase's transitive-closure input: 2,048 (n / ROWS_CHAIN)
    disjoint ROWS_CHAIN-vertex chains, and their closure, lex-sorted."""

    import numpy as np

    starts = np.arange(n // ROWS_CHAIN)[:, None] * ROWS_CHAIN
    src = (starts + np.arange(ROWS_CHAIN - 1)).ravel()
    i, j = np.triu_indices(ROWS_CHAIN, 1)
    want = np.stack([(starts + i).ravel(), (starts + j).ravel()], 1)
    return src, want[np.lexsort(want.T[::-1])]


def _mesh_generic_inputs(args, d):
    """Write the generic cells' inputs to ``d`` (the generic and rows
    phases' own, made from the same seeds) and return their oracles."""

    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = args.generic_domain
    rng = np.random.default_rng(args.seed + 2)
    src, dst = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
    np.save(d / "gen_src.npy", src)
    np.save(d / "gen_dst.npy", dst)
    want = {"dense tc": _tc_oracle(src, dst, n)}
    rn = 1 << args.rows_log2_vertices
    want["rows tc"] = _chains(rn)[1]
    rng = np.random.default_rng(args.seed + 3)
    a = rng.integers(0, rn, ROWS_CC_DEGREE * rn)
    b = rng.integers(0, rn, ROWS_CC_DEGREE * rn)
    s2, d2 = np.concatenate([a, b]), np.concatenate([b, a])
    np.save(d / "rcc_src.npy", s2)
    np.save(d / "rcc_dst.npy", d2)
    k, labels = connected_components(
        coo_matrix((np.ones(len(s2)), (s2, d2)), shape=(rn, rn)),
        directed=False)
    low = np.full(k, rn, np.int64)
    np.minimum.at(low, labels, np.arange(rn))
    want["rows cc"] = low[labels].astype(np.float32)
    src, dst = _row_pagerank_edges(rn, ROWS_PR_DEGREE, rng)
    np.save(d / "rpr_src.npy", src)
    np.save(d / "rpr_dst.npy", dst)
    want["pipeline"] = _pipeline_oracle(rn, src, dst, MESH_ROWS_PR_ITERS)
    return want


def _generic_cell(ex, mesh, iters, answer, site, keep, **run_kw):
    """One generic cell on the mesh: a counted run (the kernel's and the
    mesh's counts set to 0 just before it and read just after; B1's
    launches by the executor function that made them; with ``keep`` the
    first combine made at ``site``), then a second run, which must give
    the same bits.  ``answer(result)`` is a tuple of numpy arrays."""

    import numpy as np
    import torch

    from repro_torch.core import executor
    from repro_torch.kernels.segment_combine import kernel as sc_kernel

    real, by_site, kept = executor.segment_combine_sorted, {}, []

    def record(values, ids, num, op="sum", *, edge_active=None, **kw):
        before = sc_kernel.launch_count
        out = real(values, ids, num, op, edge_active=edge_active, **kw)
        caller = sys._getframe(1).f_code.co_name
        by_site[caller] = by_site.get(caller, 0) \
            + sc_kernel.launch_count - before
        if keep and caller == site and not kept:
            kept.append((caller, 0, (values, ids, num, op, edge_active)))
        return out

    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    mesh.stats.reset()
    sc_kernel.reset_launch_count()
    with mock.patch.object(executor, "segment_combine_sorted", record):
        res = ex.run(max_iters=iters, **run_kw)
    launches = sc_kernel.launch_count
    sent, staged = dict(mesh.stats.sent), mesh.stats.staged_bytes
    again = ex.run(max_iters=iters, **run_kw)
    got = answer(res)
    same = all(np.array_equal(a, b) for a, b in zip(got, answer(again)))
    it = res.iterations
    return {"iterations": it, "phases": list(res.phase_iterations),
            "ms": again.seconds / again.iterations * 1e3,
            "first_ms": res.seconds / it * 1e3, "launches": launches,
            "by_site": by_site, "staged": staged / it,
            "sent": {k: v / it for k, v in sent.items()},
            "fallback": bool(res.storage_fallback or again.storage_fallback),
            "identical": same, "answer": got, "digest": _digest(*got),
            "notes": [x for x in ex.plan.notes
                      if x.startswith(("exchange(", "spmd("))]}, kept


def _mesh_generic(mesh, cfg, rank):
    """The generic engine on the mesh (``phase_mesh``'s generic cells):
    dense transitive closure at the generic phase's domain, one block of
    rows a rank; the rows phase's transitive closure, connected components
    and PageRank pipeline at its domain on forced explicit exchanges.
    Returns each cell's numbers (rank 0 also its answers and B1 at the
    receivers' shapes)."""

    import numpy as np

    from repro_torch.core.executor import (
        Relation,
        RowRelation,
        compile_program,
    )
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.listings import (
        connected_components_program,
        pagerank_threshold_program,
        transitive_closure_program,
    )

    d = Path(cfg["dir"])
    on_card = mesh.device.type == "cuda"
    out = {}

    def cell(tag, ex, iters, answer, site=None, **run_kw):
        c, kept = _generic_cell(ex, mesh, iters, answer, site,
                                rank == 0 and on_card, **run_kw)
        if kept:
            out[f"site/{tag}"] = _row_site(f"{tag} {site}", kept[0],
                                           c["by_site"][site], phase="mesh")
        if rank:
            c["answer"] = None
        out[tag] = c

    n = cfg["generic_n"]
    edge = Relation.from_columns(n, np.load(d / "gen_src.npy"),
                                 np.load(d / "gen_dst.npy"), device="cpu")
    ex = compile_program(transitive_closure_program(), {"edge": edge},
                         mesh=mesh, semi_naive=True, hw=H100_SXM)
    _, state = ex.phase_step_fn()
    out["dense tc blocks"] = {
        "edge": list(ex.local_relations["edge"].present.shape),
        "tc": list(state["tc"]["present"].shape),
        "delta": list(state["tc"]["delta"].shape)}
    del state
    cell("dense tc", ex, 4 * n,
         lambda r: (r.state["tc"].present.cpu().numpy(),))
    del ex, edge

    rn = cfg["rows_n"]
    src, _ = _chains(rn)
    ex = compile_program(
        transitive_closure_program(),
        {"edge": RowRelation.from_columns(rn, src, src + 1, device="cpu")},
        mesh=mesh, semi_naive=True, exchange="bucket-a2a", hw=H100_SXM)
    cell("rows tc", ex, 4 * ROWS_CHAIN, lambda r: (r.state["tc"].tuples(),))
    del ex

    rels = {"edge": RowRelation.from_columns(
                rn, np.load(d / "rcc_src.npy"), np.load(d / "rcc_dst.npy"),
                device="cpu"),
            "node": Relation.from_columns(rn, np.arange(rn),
                                          np.arange(rn, dtype=np.float32),
                                          device="cpu")}
    ex = compile_program(connected_components_program(), rels, mesh=mesh,
                         semi_naive=True, storage="row-table",
                         exchange="bucket-a2a", hw=H100_SXM)
    cell("rows cc", ex, 4 * rn,
         lambda r: (r.state["cc"].to_dense().present.cpu().numpy(),
                    r.state["cc"].to_dense().values[1].cpu().numpy()),
         site="_groupby_rows_exchange", on_device=True)
    del ex, rels

    rels = _row_pagerank_rels(rn, np.load(d / "rpr_src.npy"),
                              np.load(d / "rpr_dst.npy"), "cpu")
    for mode in MESH_PIPELINE_EXCHANGES:
        ex = compile_program(
            pagerank_threshold_program(tau=ROWS_PR_TAU / rn), dict(rels),
            mesh=mesh, storage="row-table", exchange=mode, hw=H100_SXM)
        cell(f"pipeline {mode}", ex, MESH_ROWS_PR_ITERS,
             lambda r: _pipeline_sets(r, rn),
             site="_groupby_rows_exchange", on_device=True)
        del ex
    return out


def _pipeline_ok(got, phases, want, args):
    """(the row pipeline's answer within its bars, its rank rel L1): rank
    within PAGERANK_L1_TOL of float64, hot and reach exact where the
    threshold is not within the tolerance of a rank."""

    import numpy as np

    r64, adj_t, margin = want
    rank, hot, reach = got
    rel_l1 = float(np.abs(rank - r64).sum() / np.abs(r64).sum())
    tau = ROWS_PR_TAU / (1 << args.rows_log2_vertices)
    want_hot = np.where(margin, hot, r64 > tau)
    # A run whose f32 ranks stop changing before the last iteration ends
    # its PageRank phase there.
    ok = (phases[0] <= MESH_ROWS_PR_ITERS and rel_l1 <= PAGERANK_L1_TOL
          and np.array_equal(hot, want_hot)
          and np.array_equal(reach, _reach_closure(adj_t, want_hot)))
    return ok, rel_l1


def _check_mesh_ft(ranks, want, args):
    """Print the A10c cells and return the names of those that failed."""

    failed = []
    r0 = ranks[0]
    every = list(range(MESH_RANKS))
    two = list(MESH_FT_SURVIVORS)
    # B1 on the restored and remeshed supersteps (on the card only).
    least = 1 if r0["ft/on_card"] else 0
    if [r["ft/in_two"] for r in ranks] != [k in two for k in every]:
        failed.append("ft: the 2-rank mesh")
    note = f"remesh({MESH_RANKS}->2: data=2)"

    pr = r0["ft/pagerank"]
    crash = [r["ft/pagerank"]["crash"] for r in ranks]
    print(f"mesh: ft pagerank n={1 << args.log2_vertices}: a checkpoint "
          f"{pr['bytes']} B; a save's gather "
          f"{', '.join(f'{t:.3f}' for t in pr['gather_ms'])} ms, the "
          f"writer's save (gather and copy to the host) "
          f"{', '.join(f'{t:.3f}' for t in pr['save_ms'])} ms and I/O "
          f"{', '.join(f'{t:.3f}' for t in pr['write_ms'])} ms")
    ok = (all(c["digest"] == r0["pagerank"]["digest"] for c in crash)
          and [c["restarts"] for c in crash] == [1] * MESH_RANKS
          and [c["fired"] for c in crash]
          == [int(k == MESH_FT_LONE_RANK) for k in every]
          and min(c["launches"] for c in crash) >= least)
    print(f"mesh: ft pagerank, a crash at superstep {FT_CRASHES[0]} on rank "
          f"{MESH_FT_LONE_RANK} only, a checkpoint every {FT_EVERY}: "
          f"{pr['crash']['ms']:.3f} ms/superstep on {MESH_RANKS} ranks "
          f"({pr['crash']['supersteps_run']} supersteps run; ranks "
          f"{[round(c['ms'], 3) for c in crash]}; uninterrupted without "
          f"checkpoints {r0['pagerank']['ms']:.3f}); restarts a rank "
          f"{[c['restarts'] for c in crash]}, straggler_events "
          f"{[c['stragglers'] for c in crash]}, injector fired "
          f"{[c['fired'] for c in crash]}, B1 launches a rank "
          f"{[c['launches'] for c in crash]}; bit-equal to the uninterrupted "
          f"{MESH_RANKS}-rank run on every rank {ok}")
    if not ok:
        failed.append("ft pagerank crash")
    rem = [ranks[k]["ft/pagerank"].get("remesh") for k in every]
    got = rem[two[0]]
    ok = (all(r["ft/pagerank"]["raised"] for r in ranks)
          and all(rem[k] is None for k in every if k not in two)
          and all(rem[k] is not None and rem[k]["rel_l1"] == got["rel_l1"]
                  for k in two)
          and got["rel_l1"] <= PAGERANK_L1_TOL and got["note"] == note
          and got["events"] == [note]
          and min(rem[k]["launches"] for k in two) >= least
          and got["iterations"] == args.supersteps - pr["out_step"])
    print(f"mesh: ft pagerank crashed out at supersteps {MESH_FT_OUT} "
          f"(max_restarts=1; raised on every rank "
          f"{all(r['ft/pagerank']['raised'] for r in ranks)}), remeshed "
          f"onto ranks {two} ({got['connector']}; note {got['note']!r}, "
          f"remesh_events {got['events']}) and resumed from superstep "
          f"{pr['out_step']} for {got['iterations']}: "
          f"{got['ms']:.3f} ms/superstep on 2 ranks with checkpoints "
          f"(ranks {[round(rem[k]['ms'], 3) for k in two]}), restarts "
          f"{[rem[k]['restarts'] for k in two]}, straggler_events "
          f"{[rem[k]['stragglers'] for k in two]}, B1 launches a rank "
          f"{[rem[k]['launches'] for k in two]}; rel L1 vs float64 "
          f"{got['rel_l1']:.3e} (tol {PAGERANK_L1_TOL}); {ok}")
    if not ok:
        failed.append("ft pagerank remesh")

    im = [r["ft/imru"] for r in ranks]
    c = im[0]
    bar = c["bar"]
    if all(x["crash_equal"] for x in im):
        verdict = "bit-equal to the uninterrupted run"
        ok = True
    else:
        verdict = (f"not bit-equal (cuBLAS is not run-to-run reproducible "
                   f"here): ||m - m64|| {c['crash_err']:.4e}, "
                   f"uninterrupted {c['clean_err']:.4e}, bar {bar:.4e}")
        ok = max(x["crash_err"] for x in im) <= bar
    ok = ok and [x["crash_restarts"] for x in im] == [1] * MESH_RANKS
    print(f"mesh: ft imru {1 << args.imru_log2_records} x {IMRU_FEATURES} "
          f"on (2, 2) flat, a crash at iteration {MESH_FT_IMRU_CRASH}: "
          f"restarts a rank {[x['crash_restarts'] for x in im]}, {verdict}; "
          f"{c['crash_ms']:.3f} ms/iteration with a checkpoint every 2 "
          f"(uninterrupted host driver {c['ms']:.3f}); {ok}")
    if not ok:
        failed.append("ft imru crash")
    ok = (all(x["fallbacks"] == c["fallbacks"] and x["note"] == c["note"]
              and x["stragglers"] == c["stragglers"] for x in im)
          and len(c["fallbacks"]) == 1 and c["reduce"] == "kary_tree"
          and c["fallbacks"][0] == "straggler-fallback(kary_tree @ "
          f"iteration {MESH_FT_STRAGGLE})"
          and [x["fired"] for x in im]
          == [int(k == MESH_FT_LONE_RANK) for k in every]
          and all(x["straggle_finite"] and x["straggle_err"] <= bar
                  for x in im))
    print(f"mesh: ft imru, rank {MESH_FT_LONE_RANK} straggling "
          f"{MESH_FT_SLOWDOWN:g}x its iteration at iteration "
          f"{MESH_FT_STRAGGLE}: straggler_events a rank "
          f"{[x['stragglers'] for x in im]}, fallbacks "
          f"{[x['fallbacks'] for x in im]}; ||m - m64|| "
          f"{c['straggle_err']:.4e} (bar {bar:.4e}); {ok}")
    if not ok:
        failed.append("ft imru straggler")

    rows = [r["ft/rows"] for r in ranks]
    c = rows[0]
    ok = (all(x["crash"]["digest"] == c["clean"]["digest"]
              and x["clean"]["digest"] == c["clean"]["digest"] for x in rows)
          and [x["crash"]["restarts"] for x in rows] == [1] * MESH_RANKS
          and [x["crash"]["fired"] for x in rows]
          == [int(k == 3) for k in every]
          and all(x["crash"]["phases"] == c["clean"]["phases"]
                  for x in rows))
    print(f"mesh: ft rows pipeline n={1 << args.rows_log2_vertices} on "
          f"psum-scatter, phases {c['clean']['phases']}: a crash at step "
          f"{FT_ROWS_CRASH} on rank 3 only, restarts a rank "
          f"{[x['crash']['restarts'] for x in rows]}, straggler_events "
          f"{[x['crash']['stragglers'] for x in rows]}; "
          f"{c['crash']['ms']:.3f} ms/iteration with checkpoints "
          f"(uninterrupted {c['clean']['ms']:.3f}); bit-equal to the "
          f"uninterrupted run on every rank {ok}")
    if not ok:
        failed.append("ft rows crash")
    rem = [rows[k].get("remesh") for k in every]
    got = rem[two[0]]
    good, rel_l1 = _pipeline_ok(got["answer"], c["clean"]["phases"],
                                want["pipeline"], args)
    ok = (good and all(x["raised"] for x in rows)
          and all(rem[k] is None for k in every if k not in two)
          and all(rem[k] is not None and rem[k]["phases"]
                  == c["clean"]["phases"] for k in two)
          and all(_digest(*rem[k]["answer"]) == _digest(*got["answer"])
                  for k in two)
          and got["note"] == note and got["events"] == [note]
          and not any(rem[k]["fallback"] or rem[k]["trap_fired"]
                      for k in two))
    print(f"mesh: ft rows pipeline crashed out at phase 2's first step "
          f"(raised on every rank {all(x['raised'] for x in rows)}), "
          f"remeshed onto ranks {two} (note {got['note']!r}) and resumed "
          f"through the phase cursor: {got['iterations']} iteration(s) of "
          f"phase 2 run (phases {got['phases']}, the phase-1 trap fired "
          f"{[rem[k]['trap_fired'] for k in two]}), {got['ms']:.3f} "
          f"ms/iteration on 2 ranks, B1 launches a rank "
          f"{[rem[k]['launches'] for k in two]}; rank rel L1 vs float64 "
          f"{rel_l1:.3e} "
          f"(tol {PAGERANK_L1_TOL}), {int(got['answer'][1].sum())} hot, "
          f"{int(got['answer'][2].sum())} reached; {ok}")
    if not ok:
        failed.append("ft rows remesh")
    return failed


def _check_mesh_generic(ranks, want, single, args):
    """Print the generic cells and return the names of those that failed:
    answers against the oracles (rank 0's, and every rank's digest equal
    to it), two runs bit-identical, no dense fallback, B1 launched at the
    receivers on every rank where the cell has a GroupBy."""

    import numpy as np

    failed = []
    r0 = ranks[0]
    blocks = [r["dense tc blocks"] for r in ranks]
    m = args.generic_domain // MESH_RANKS
    print(f"mesh: dense tc blocks a rank {blocks[0]}")
    if any(b != {"edge": [m, args.generic_domain],
                 "tc": [m, args.generic_domain],
                 "delta": [m, args.generic_domain]} for b in blocks):
        failed.append("dense tc blocks")
    for tag in ("dense tc", "rows tc", "rows cc") + tuple(
            f"pipeline {mode}" for mode in MESH_PIPELINE_EXCHANGES):
        c = r0[tag]
        got = c["answer"]
        if tag == "dense tc":
            ok = np.array_equal(got[0], want[tag])
        elif tag == "rows tc":
            ok = np.array_equal(got[0], want[tag])
        elif tag == "rows cc":
            ok = bool(got[0].all()) and np.array_equal(got[1], want[tag])
        else:
            ok, rel_l1 = _pipeline_ok(got, c["phases"], want["pipeline"],
                                      args)
            hot, reach = got[1], got[2]
            tag_l1 = f", rank rel L1 vs float64 {rel_l1:.3e} (tol " \
                     f"{PAGERANK_L1_TOL}), {int(hot.sum())} hot, " \
                     f"{int(reach.sum())} reached"
        receivers = [r[tag]["by_site"].get("_groupby_rows_exchange", 0)
                     for r in ranks]
        one = single.get(MESH_SINGLE[tag])
        print(f"mesh: generic {tag}: {c['iterations']} iterations "
              f"{c['phases']}, {c['ms']:.3f} ms/iteration warm (first run "
              f"{c['first_ms']:.3f}; ranks "
              f"{[round(r[tag]['ms'], 3) for r in ranks]}; one device in "
              f"this run: "
              f"{'not measured' if one is None else f'{one:.3f}'}), B1 "
              f"launches a rank {[r[tag]['launches'] for r in ranks]} "
              f"(at the receivers {receivers}; by site "
              f"{json.dumps(c['by_site'])}), bytes a rank an iteration "
              f"{ {k: int(v) for k, v in c['sent'].items()} }, staged "
              f"{int(c['staged'])}; equal to the oracle {ok}"
              f"{tag_l1 if tag.startswith('pipeline') else ''}; every "
              f"rank's answer equal to rank 0's "
              f"{len({r[tag]['digest'] for r in ranks}) == 1}, two runs "
              f"bit-identical {all(r[tag]['identical'] for r in ranks)}, "
              f"storage_fallback {any(r[tag]['fallback'] for r in ranks)}; "
              f"plan {c['notes']}")
        if not (ok and len({r[tag]["digest"] for r in ranks}) == 1
                and all(r[tag]["identical"] for r in ranks)
                and not any(r[tag]["fallback"] for r in ranks)):
            failed.append(f"generic {tag}")
        if tag in ("rows cc",) + tuple(
                f"pipeline {mode}" for mode in MESH_PIPELINE_EXCHANGES) \
                and min(receivers) <= 0:
            failed.append(f"generic {tag}: no B1 launch at the receivers")
    return failed


def _mesh_imru_records(mesh, cfg):
    """This rank's quarter of the IMRU records on ``mesh`` (pod x data),
    made on its device from the seed: the same records at every call."""

    import torch

    shard = mesh.linear_index(mesh.batch_axes)
    rows, dim = cfg["records"] // MESH_RANKS, IMRU_FEATURES
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(cfg["seed"])
    w_true = torch.randn(dim, generator=gen, device=mesh.device)
    gen.manual_seed((cfg["seed"] << 8) + 1 + shard)
    X = torch.empty((rows, dim), device=mesh.device)
    y = torch.empty(rows, device=mesh.device)
    for s in range(0, rows, 1 << 20):
        e = min(s + (1 << 20), rows)
        X[s:e].normal_(generator=gen)
        y[s:e] = X[s:e] @ w_true
    return X, y


def _digest(*arrays) -> str:
    """sha256 of tensors' or arrays' bytes (bit-equality across ranks)."""

    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().numpy() if hasattr(a, "detach") else a
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# A10c, fault tolerance on the mesh (the mesh phase's last cells).
MESH_FT_LONE_RANK = 1          # the rank whose own injector fires alone
MESH_FT_OUT = (10, 11)         # crashes past max_restarts=1: the run stops
MESH_FT_SURVIVORS = (2, 3)     # the ranks a remesh keeps (the writer, rank
#                                0, is among the lost ones)
MESH_FT_IMRU_CRASH = 4
MESH_FT_STRAGGLE = 3           # the IMRU iteration rank 1 straggles at,
MESH_FT_SLOWDOWN = 5.0         # for this many times its iteration's time


def _ft_sync(on_card):
    import torch

    if on_card:
        torch.cuda.synchronize()


def _ft_counted(run, on_card):
    """(run(), B1 launches it made): the count set to 0 just before."""

    from repro_torch.kernels.segment_combine import kernel as sc_kernel

    _ft_sync(on_card)
    sc_kernel.reset_launch_count()
    out = run()
    return out, sc_kernel.launch_count


def _ft_release(on_card):
    # A crashed-out run's traceback holds its executable in a cycle.
    import gc

    import torch

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def _ft_drop(rank, path):
    """Remove a checkpoint directory once every rank is done with it (rank
    0 writes and removes)."""

    import shutil

    import torch.distributed as dist

    dist.barrier()
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)


def _mesh_ft_pagerank(cfg, rank, data, two, box):
    """PageRank's A10c cells, on the executable of the mesh phase's 2^25
    PageRank cell (``box`` holds it, and is emptied): one save timed, a
    crash on rank 1 only with a checkpoint every FT_EVERY supersteps,
    then a run crashed past its restarts, remeshed onto ranks 2-3 (the
    ``two`` mesh; None on the other ranks) and resumed from disk.
    Returns the cells' numbers; ranks 2-3 also the remeshed run's."""

    import numpy as np

    from repro_torch.checkpoint import MeshCheckpointStore, latest_step
    from repro_torch.ft import FailureInjector

    d = Path(cfg["dir"])
    on_card = data.device.type == "cuda"
    n, steps = cfg["n"], cfg["supersteps"]
    ex = box.pop()
    pr = {}
    carry = ex.init()
    store = MeshCheckpointStore(str(d / "pr_save"), keep=1, mesh=data,
                                to_global=ex.gather)
    pr["gather_ms"], pr["save_ms"], pr["write_ms"] = [], [], []
    for k in range(2):
        _ft_sync(on_card)
        t0 = time.perf_counter()
        full = ex.gather(carry)
        _ft_sync(on_card)
        pr["gather_ms"].append((time.perf_counter() - t0) * 1e3)
        del full
        t0 = time.perf_counter()
        store.save(k, carry)
        t1 = time.perf_counter()
        store.wait()
        pr["save_ms"].append((t1 - t0) * 1e3)
        pr["write_ms"].append((time.perf_counter() - t1) * 1e3)
    if rank == 0:
        pr["bytes"] = _tree_bytes(d / "pr_save" / "step_00000001")
    del carry, store
    _ft_drop(rank, d / "pr_save")
    lone = FailureInjector(
        crashes=FT_CRASHES[:1] if rank == MESH_FT_LONE_RANK else ())
    res, launches = _ft_counted(lambda: ex.run(
        max_iters=steps, checkpoint_dir=str(d / "pr_crash"),
        checkpoint_every=FT_EVERY, injector=lone), on_card)
    replayed = FT_CRASHES[0] % FT_EVERY
    pr["crash"] = {"digest": _digest(res.state[0]), "launches": launches,
                   "restarts": res.restarts,
                   "stragglers": res.straggler_events,
                   "fired": len(lone.fired), "iterations": res.iterations,
                   "ms": res.seconds / (res.iterations + replayed) * 1e3,
                   "supersteps_run": res.iterations + replayed}
    del res
    _ft_drop(rank, d / "pr_crash")
    try:
        ex.run(max_iters=steps, checkpoint_dir=str(d / "pr_out"),
               checkpoint_every=FT_EVERY,
               injector=FailureInjector(crashes=MESH_FT_OUT), max_restarts=1)
        pr["raised"] = None
    except RuntimeError as err:
        pr["raised"] = str(err)
    if rank == 0:
        pr["out_step"] = latest_step(str(d / "pr_out"))
    if two is not None:
        ex2 = ex.remesh(two)
        del ex
        res, launches = _ft_counted(lambda: ex2.run(
            max_iters=steps, checkpoint_dir=str(d / "pr_out"),
            checkpoint_every=FT_EVERY, resume=True), on_card)
        r = res.state[0][:, 0].double().cpu().numpy()
        oracle = np.load(d / "pr_oracle.npy")
        pr["remesh"] = {
            "rel_l1": float(np.abs(r - oracle).sum() / np.abs(oracle).sum())
            if np.isfinite(r).all() else float("inf"),
            "iterations": res.iterations,
            "ms": res.seconds / res.iterations * 1e3,
            "events": list(res.remesh_events),
            "note": ex2.plan.notes[-1], "connector": ex2.plan.connector,
            "restarts": res.restarts, "stragglers": res.straggler_events,
            "launches": launches}
        del ex2, res
    else:
        del ex
    _ft_release(on_card)
    _ft_drop(rank, d / "pr_out")
    return pr


def _mesh_ft(cfg, rank, data, pod, imru_ref, two):
    """The other A10c cells, the mesh phase's last: IMRU BGD on the (2, 2)
    mesh crashed, and straggling on rank 1; the rows pipeline on
    ``psum-scatter`` crashed in phase 1 on rank 3 only, then crashed at
    phase 2's first step with no restarts left, remeshed onto ranks 2-3
    (the ``two`` mesh; None on the other ranks) and resumed through the
    phase cursor.  Returns each cell's numbers; ranks 2-3 also the
    remeshed run's."""

    import numpy as np
    import torch

    from repro_torch.core.executor import compile_program
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.imru import compile_imru
    from repro_torch.core.listings import pagerank_threshold_program
    from repro_torch.ft import FailureInjector

    d = Path(cfg["dir"])
    on_card = data.device.type == "cuda"

    # IMRU BGD on (2, 2), flat: a crash, and a straggler on rank 1.
    X, y = _mesh_imru_records(pod, cfg)
    recs = {"x": X, "y": y}
    w64, bar = imru_ref
    task = _bgd_task(IMRU_FEATURES, IMRU_LR_SCALE / cfg["records"],
                     pod.device)
    imru = {"bar": bar}

    def bgd():
        return compile_imru(task, recs, mesh=pod, hw=H100_SXM,
                            force_reduce="flat")

    ex = bgd()
    clean = ex.run(max_iters=MESH_IMRU_ITERATIONS, on_device=False,
                   straggler_fallback=False)
    crash = ex.run(max_iters=MESH_IMRU_ITERATIONS,
                   checkpoint_dir=str(d / "imru_crash"), checkpoint_every=2,
                   injector=FailureInjector(crashes=[MESH_FT_IMRU_CRASH]),
                   straggler_fallback=False)
    it_s = clean.seconds / clean.iterations
    imru.update({
        "ms": it_s * 1e3,
        "crash_ms": crash.seconds / crash.iterations * 1e3,
        "crash_equal": bool(torch.equal(crash.state, clean.state)),
        "crash_err": float((crash.state.double() - w64).norm()),
        "clean_err": float((clean.state.double() - w64).norm()),
        "crash_restarts": crash.restarts})
    del ex, clean, crash
    _ft_drop(rank, d / "imru_crash")
    ex = bgd()
    slow = FailureInjector(
        straggles=[(MESH_FT_STRAGGLE, MESH_FT_SLOWDOWN * it_s)]
        if rank == MESH_FT_LONE_RANK else [])
    res = ex.run(max_iters=MESH_IMRU_ITERATIONS, on_device=False,
                 injector=slow)
    imru.update({
        "straggle_err": float((res.state.double() - w64).norm()),
        "straggle_finite": bool(torch.isfinite(res.state).all()),
        "stragglers": res.straggler_events, "fired": len(slow.fired),
        "fallbacks": list(ex.straggler_fallbacks),
        "reduce": ex.plan.reduce.kind, "note": ex.plan.notes[-1]})
    del ex, res, X, y, recs
    _ft_release(on_card)

    # The rows pipeline on psum-scatter: a crash in phase 1 on rank 3, a
    # crash-out at phase 2's first step, a remesh, the phase cursor.
    rn = cfg["rows_n"]
    rels = _row_pagerank_rels(rn, np.load(d / "rpr_src.npy"),
                              np.load(d / "rpr_dst.npy"), "cpu")
    ex = compile_program(pagerank_threshold_program(tau=ROWS_PR_TAU / rn),
                         dict(rels), mesh=data, storage="row-table",
                         exchange="psum-scatter", hw=H100_SXM)
    rows = {}
    clean = ex.run(max_iters=MESH_ROWS_PR_ITERS)
    lone = FailureInjector(crashes=[FT_ROWS_CRASH] if rank == 3 else [])
    res = ex.run(max_iters=MESH_ROWS_PR_ITERS,
                 checkpoint_dir=str(d / "rows_crash"),
                 checkpoint_every=FT_EVERY, injector=lone)
    rows["clean"] = {"digest": _digest(*_pipeline_sets(clean, rn)),
                     "phases": list(clean.phase_iterations),
                     "ms": clean.seconds / clean.iterations * 1e3}
    rows["crash"] = {"digest": _digest(*_pipeline_sets(res, rn)),
                     "phases": list(res.phase_iterations),
                     "restarts": res.restarts, "fired": len(lone.fired),
                     "stragglers": res.straggler_events,
                     "ms": res.seconds / res.iterations * 1e3}
    rank_iters = clean.phase_iterations[0]
    del clean, res
    _ft_drop(rank, d / "rows_crash")
    try:
        ex.run(max_iters=MESH_ROWS_PR_ITERS,
               checkpoint_dir=str(d / "rows_out"), checkpoint_every=FT_EVERY,
               injector=FailureInjector(crashes=[rank_iters]),
               max_restarts=0)
        rows["raised"] = None
    except RuntimeError as err:
        rows["raised"] = str(err)
    if two is not None:
        ex2 = ex.remesh(two)
        trap = FailureInjector(crashes=[FT_ROWS_CRASH])
        res, launches = _ft_counted(lambda: ex2.run(
            max_iters=MESH_ROWS_PR_ITERS, checkpoint_dir=str(d / "rows_out"),
            checkpoint_every=FT_EVERY, resume=True, injector=trap), on_card)
        # The resumed run's iterations count the completed phases too.
        ran = res.iterations - sum(res.phase_iterations[:-1])
        rows["remesh"] = {"answer": _pipeline_sets(res, rn),
                          "phases": list(res.phase_iterations),
                          "iterations": ran,
                          "ms": res.seconds / max(ran, 1) * 1e3,
                          "events": list(res.remesh_events),
                          "note": ex2.plan.notes[-1],
                          "fallback": bool(res.storage_fallback),
                          "trap_fired": len(trap.fired),
                          "launches": launches}
        del ex2, res
    del ex, rels
    _ft_release(on_card)
    _ft_drop(rank, d / "rows_out")
    return {"ft/imru": imru, "ft/rows": rows}


# A10d, serving on the mesh (the mesh phase's last cells).
MESH_SERVE_SEQUENTIAL = 4      # (a)'s seed sets also served one by one
MESH_SERVE_REQUESTS = 64       # (d): mixed requests through the loop
MESH_SERVE_TOL = 1e-8          # (a): batched vs sequential and one device


def _mesh_serve_inputs(args, d, single):
    """Write the serving cells' inputs to ``d`` and return their oracles.
    (a) is the serve phase's (b): its dense-grid graph at 4 x
    ``--generic-domain`` and its 16 seed sets, with that phase's
    one-device batched ranks when it ran in this process (else a graph of
    the same shape from the seed, and the one-device ranks not measured);
    (b) and (d) a graph at ``--generic-domain`` with 64 probes and 64 mixed
    requests; (c) the serve phase's 4-vertex program's 16 queries."""

    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order

    rng = np.random.default_rng(args.seed + 17)
    n = args.generic_domain
    n_a = SERVE_GRID_FACTOR * n
    grid = (single or {}).get("serve grid")
    if grid is None:
        src, dst = _distinct_out_edges(n_a, SERVE_DEGREE, rng)
        sets = _seed_sets(rng, n_a, SERVE_GRID_K)
    else:
        src, dst, sets = grid["src"], grid["dst"], grid["sets"]
    np.save(d / "serve_a_src.npy", src)
    np.save(d / "serve_a_dst.npy", dst)
    want = {"a": _ppr_oracle64(src, dst, n_a, sets, SERVE_ITERS),
            "single": None if grid is None else grid["ranks"]}
    src, dst = _distinct_out_edges(n, SERVE_DEGREE, rng)
    np.save(d / "serve_b_src.npy", src)
    np.save(d / "serve_b_dst.npy", dst)
    adj = coo_matrix((np.ones(src.shape[0]), (src, dst)),
                     shape=(n, n)).tocsr()

    def closure(a):
        out = np.zeros(n, bool)
        out[breadth_first_order(adj, a, return_predecessors=False)] = True
        return out

    probes = rng.integers(0, n, (SERVE_PROBES, 2))
    closures = np.stack([closure(a) for a, _ in probes])
    hits = np.zeros_like(closures)
    hits[np.arange(SERVE_PROBES), probes[:, 1]] = \
        closures[np.arange(SERVE_PROBES), probes[:, 1]]
    want["b"] = (closures, hits)
    scan_sets = [np.sort(rng.choice(SERVE_SCAN_N, int(rng.integers(1, 3)),
                                    replace=False))
                 for _ in range(SERVE_SCAN_K)]
    labels = rng.normal(size=(SERVE_SCAN_K, SERVE_SCAN_N)).astype(
        np.float32)
    # (c)'s oracles: float64 PageRank, and the largest and smallest label
    # among the vertices that reach each vertex (itself included).
    reach = np.eye(SERVE_SCAN_N, dtype=bool)      # reach[y, x]: y -> x
    for _ in range(SERVE_SCAN_N):
        for a, c in zip(SERVE_SCAN_SRC, SERVE_SCAN_DST):
            reach[:, c] |= reach[:, a]
    by_source = labels[:, :, None]
    want["c"] = {
        "sum": _ppr_oracle64(np.array(SERVE_SCAN_SRC),
                             np.array(SERVE_SCAN_DST), SERVE_SCAN_N,
                             scan_sets, SERVE_ITERS),
        "hi": np.where(reach, by_source, -np.inf).max(axis=1),
        "lo": np.where(reach, by_source, np.inf).min(axis=1)}
    # (d): runs of 1 to 16 requests, PageRank and reachability in turn.
    requests, kinds = [], itertools.cycle(("ppr", "reach"))
    while len(requests) < MESH_SERVE_REQUESTS:
        run, kind = int(rng.integers(1, 17)), next(kinds)
        for _ in range(min(run, MESH_SERVE_REQUESTS - len(requests))):
            cols = _seed_sets(rng, n, 1)[0] if kind == "ppr" \
                else rng.integers(0, n, 2)
            requests.append((kind, cols.tolist()))
    ppr_sets = [np.array(c) for k, c in requests if k == "ppr"]
    want["d"] = (_ppr_oracle64(src, dst, n, ppr_sets, SERVE_ITERS),
                 [closure(c[0]) for k, c in requests if k == "reach"])
    (d / "serve.json").write_text(json.dumps({
        "a_sets": [s.tolist() for s in sets], "probes": probes.tolist(),
        "scan_sets": [s.tolist() for s in scan_sets],
        "labels": labels.tolist(), "requests": requests}))
    want["requests"] = requests
    return want


def _mesh_serve(mesh, cfg, rank):
    """Serving on the mesh (ROADMAP A10d, ``phase_mesh``'s serving cells):
    ``FixpointServer(mesh=)`` on every rank over the global graphs the
    phase wrote.  (a) personalized PageRank on dense grids at 4 x the
    generic domain, 16 seed sets batched (one collective a call site for
    the 16) and 4 of them one by one, the cold and warm requests timed;
    (b) 64 reachability probes batched and one by one; (c) the 4-vertex
    segment-scan programs, 16 queries batched, B1 launched once a GroupBy
    firing for the batch and (rank 0, on the card) held to its plain
    version there; (d) the mixed requests through ``serve_request_loop``.
    Returns each cell's numbers (rank 0 also its answers)."""

    import numpy as np
    import torch

    from repro_torch.core.executor import Relation
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.serving import (
        FixpointServer,
        personalized_pagerank_program,
        point_reachability_program,
    )
    from repro_torch.kernels.segment_combine import kernel as sc_kernel
    from repro_torch.launch.query_serve import QueryRequest, serve_request_loop

    d = Path(cfg["dir"])
    spec = json.loads((d / "serve.json").read_text())
    on_card = mesh.device.type == "cuda"
    ppr = personalized_pagerank_program(SERVE_DAMPING)
    reach = point_reachability_program()
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(run):
        sync()
        t0 = time.perf_counter()
        res = run()
        sync()
        return res, time.perf_counter() - t0

    def unary(n_, v):
        return Relation.from_columns(n_, np.array([v]), device="cpu")

    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    # (a) batched personalized PageRank on dense grids ---------------------
    n_a = SERVE_GRID_FACTOR * cfg["generic_n"]
    server = FixpointServer(
        _serve_graph(n_a, np.load(d / "serve_a_src.npy"),
                     np.load(d / "serve_a_dst.npy")),
        mesh=mesh, hw=H100_SXM, storage="dense-grid")
    params = _seed_params(n_a, [np.array(s) for s in spec["a_sets"]])
    k = len(params)
    cold, cold_s = timed(lambda: server.query(
        ppr, params[:1], max_iters=SERVE_ITERS, on_device=True))
    warm, warm_s = timed(lambda: server.query(
        ppr, params[1:2], max_iters=SERVE_ITERS, on_device=True))
    server.query(ppr, params, max_iters=SERVE_ITERS, on_device=True,
                 force="batched")
    sync()
    mesh.stats.reset()
    if on_card:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    b, _ = timed(lambda: server.query(ppr, params, max_iters=SERVE_ITERS,
                                      on_device=True, force="batched"))
    it = b.iterations
    calls = {c: v / it for c, v in mesh.stats.calls.items()}
    staged = mesh.stats.staged_bytes / it
    peak = torch.cuda.max_memory_allocated() - base if on_card else None
    # One by one: the first query's collective calls an iteration.
    seq = []
    for q in range(MESH_SERVE_SEQUENTIAL):
        mesh.stats.reset()
        seq.append(server.query(ppr, params[q:q + 1], max_iters=SERVE_ITERS,
                                on_device=True, force="sequential"))
        if q == 0:
            calls_one = {c: v / seq[0].iterations
                         for c, v in mesh.stats.calls.items()}
    ranks_b = [_rank_of(a, n_a) for a in b.answers]
    ranks_s = [_rank_of(r.answers[0], n_a)[0] for r in seq]
    out["serve a"] = {
        "n": n_a, "k": k, "iterations": it, "batched": b.batched,
        "batched_ms": b.execute_seconds / k * 1e3,
        "sequential_ms": sum(r.execute_seconds for r in seq) / len(seq)
        * 1e3,
        "calls": calls, "calls_one": calls_one,
        "staged_mb": staged / 1e6, "peak": peak,
        "cold_s": cold_s, "cold_compile_s": cold.compile_seconds,
        "warm_s": warm_s,
        "warm_hit": warm.cache_hit and warm.compile_seconds == 0.0,
        "gap": max(float(np.abs(x[0] - y).max())
                   for x, y in zip(ranks_b, ranks_s)),
        "note": b.notes[-1],
        "digest": _digest(*[x[0] for x in ranks_b]),
        "answers": ranks_b if rank == 0 else None}
    del server, params, cold, warm, b, seq, ranks_b, ranks_s
    lap("a")

    # (b) reachability probes -----------------------------------------------
    n = cfg["generic_n"]
    server = FixpointServer(
        _serve_graph(n, np.load(d / "serve_b_src.npy"),
                     np.load(d / "serve_b_dst.npy")),
        mesh=mesh, hw=H100_SXM)
    probes = [{"src": unary(n, a), "dst": unary(n, t)}
              for a, t in spec["probes"]]
    rb, _ = timed(lambda: server.query(reach, probes, max_iters=n,
                                       on_device=True, force="batched"))
    rs, _ = timed(lambda: server.query(reach, probes, max_iters=n,
                                       on_device=True, force="sequential"))
    got = {p: np.stack([a[p].present.cpu().numpy() for a in rb.answers])
           for p in ("reach", "hit")}
    out["serve b"] = {
        "n": n, "k": len(probes), "iterations": rb.iterations,
        "batched_ms": rb.execute_seconds / len(probes) * 1e3,
        "sequential_ms": rs.execute_seconds / len(probes) * 1e3,
        "equal": all(torch.equal(x[p].present, y[p].present)
                     for x, y in zip(rb.answers, rs.answers)
                     for p in ("reach", "hit")),
        "digest": _digest(got["reach"], got["hit"]),
        "answers": got if rank == 0 else None}
    del rb, rs
    lap("b")

    # (d) the request loop, on (b)'s server ---------------------------------
    requests = []
    for i, (kind, cols) in enumerate(spec["requests"]):
        if kind == "ppr":
            requests.append(QueryRequest(
                ppr, _seed_params(n, [np.array(cols)])[0],
                max_iters=SERVE_ITERS, tag=f"ppr{i}"))
        else:
            requests.append(QueryRequest(
                reach, {"src": unary(n, cols[0]), "dst": unary(n, cols[1])},
                max_iters=n, tag=f"reach{i}"))
    # The PageRank plan of this graph, compiled before the loop is timed.
    server.query(ppr, _seed_params(n, [np.array([0])])[0],
                 max_iters=SERVE_ITERS, on_device=True)
    responses, loop_s = timed(lambda: serve_request_loop(
        server, requests, max_batch=SERVE_MAX_BATCH, on_device=True))
    answers = [_rank_of(r.answers, n)[0] if "rank" in r.answers
               else r.answers["hit"].present.cpu().numpy()
               for r in responses]
    out["serve d"] = {
        "requests": len(requests), "seconds": loop_s,
        "requests_per_s": len(requests) / loop_s,
        "dispatches": sum(1 for i, r in enumerate(responses)
                          if i == 0 or r.result is not responses[i - 1].result),
        "largest": max(r.result.batch for r in responses),
        "in_order": [r.request.tag for r in responses]
        == [r.tag for r in requests],
        "digest": _digest(*answers),
        "answers": answers if rank == 0 else None}
    del server, requests, responses
    lap("d")

    # (c) the segment-scan programs under vmap ------------------------------
    m = SERVE_SCAN_N
    server = FixpointServer(
        _serve_graph(m, np.array(SERVE_SCAN_SRC), np.array(SERVE_SCAN_DST)),
        mesh=mesh, hw=H100_SXM)
    seeds = _seed_params(m, [np.array(v) for v in spec["scan_sets"]])
    labs = [{"lab": Relation.from_columns(
        m, np.arange(m), np.array(row, np.float32), device="cpu")}
        for row in spec["labels"]]
    for tag, prog, batch, preds in (
            ("sum", ppr, seeds, ("rank",)),
            ("max/min", _spread_program(), labs, ("hi", "lo"))):
        server.query(prog, batch[:2], max_iters=SERVE_ITERS, force="batched")
        exe = server.plan_cache.get(server.plan_key(prog, list(batch[0])))
        sync()
        sc_kernel.reset_launch_count()
        b, calls_b = _capture_sorted_combines(lambda: server.query(
            prog, batch, max_iters=SERVE_ITERS, on_device=True,
            force="batched"))
        sync()
        lb = sc_kernel.launch_count
        got = {p: np.stack([torch.where(a[p].present, a[p].values[1], 0.0)
                            .double().cpu().numpy() for a in b.answers])
               for p in preds}
        pres = {p: np.stack([a[p].present.cpu().numpy() for a in b.answers])
                for p in preds}
        cell = {"connectors": sorted(set(exe.plan.connectors.values())),
                "launches": lb, "calls": len(calls_b),
                "iterations": b.iterations,
                "one_a_firing": all(c[0] == int(on_card) for c in calls_b),
                "widths": sorted({int(c[1][0].shape[1]) for c in calls_b}),
                "digest": _digest(*got.values(), *pres.values()),
                "answers": (got, pres) if rank == 0 else None}
        if rank == 0 and on_card:
            site = _row_site(f"serve segment scan {tag}",
                             (None, lb, calls_b[-1][1]), lb, phase="mesh")
            site["batch"] = SERVE_SCAN_K
            out[f"site/serve scan {tag}"] = site
        out[f"serve c {tag}"] = cell
        del b, calls_b, exe
    lap("c")
    out["serve seconds"] = seconds
    return out


def _check_mesh_serve(ranks, want):
    """Print the serving cells and return the names of those that failed:
    (a) every query within SERVE_PPR_L1_TOL of float64, batched within
    MESH_SERVE_TOL of sequential and of the serve phase's one-device
    ranks, the collective calls of a batched iteration those of one
    query's; (b) equal to scipy's BFS, batched bit-equal to sequential;
    (c) B1 once a GroupBy firing for the batch, PageRank within
    SERVE_PPR_L1_TOL of float64 and max/min equal to their oracle; (d) in
    arrival order and right; every rank's answers equal to rank 0's."""

    import numpy as np

    failed = []
    r0 = ranks[0]
    on_card = "site/serve scan sum" in r0
    for key in ("serve a", "serve b", "serve d", "serve c sum",
                "serve c max/min"):
        if len({r[key]["digest"] for r in ranks}) != 1:
            failed.append(f"{key}: the ranks' answers differ")

    a = r0["serve a"]
    r64, p64 = want["a"]
    worst = 0.0
    for q, (got, pres) in enumerate(a["answers"]):
        rel = float(np.abs(got - r64[:, q]).sum() / np.abs(r64[:, q]).sum())
        worst = max(worst, rel)
        if not (np.array_equal(pres, p64[:, q]) and rel <= SERVE_PPR_L1_TOL):
            failed.append(f"serve a query {q}: rel L1 {rel:.3e}")
    one = want["single"]
    vs_one = None if one is None else max(
        float(np.abs(got - one[q]).max())
        for q, (got, _) in enumerate(a["answers"]))
    print(f"mesh: serve (a) personalized PageRank n={a['n']} dense grids, "
          f"{a['iterations']} iterations, k={a['k']} batched: per query "
          f"{a['batched_ms']:.3f} ms batched (ranks "
          f"{[round(r['serve a']['batched_ms'], 3) for r in ranks]}), "
          f"{a['sequential_ms']:.3f} ms one by one ({MESH_SERVE_SEQUENTIAL} "
          f"queries); collective calls a batched iteration "
          f"{json.dumps(a['calls'])} (one query's {json.dumps(a['calls_one'])}"
          f"), staged {a['staged_mb']:.3f} MB a batched iteration; cold "
          f"request {a['cold_s']:.3f} s (compile {a['cold_compile_s']:.3f} "
          f"s), warm {a['warm_s']:.3f} s (plan hit, no compile "
          f"{a['warm_hit']}); peak memory a rank above its start "
          f"{[r['serve a']['peak'] for r in ranks]} B; rel L1 vs float64 "
          f"{worst:.3e} (tol {SERVE_PPR_L1_TOL}); batched vs one by one max "
          f"abs {a['gap']:.3e}, vs the serve phase's one-device batched "
          f"ranks {'not measured' if vs_one is None else f'{vs_one:.3e}'} "
          f"(tol {MESH_SERVE_TOL}); {a['note']}")
    if not (a["batched"] and all(r["serve a"]["warm_hit"] for r in ranks)
            and a["calls"] == a["calls_one"]
            and max(r["serve a"]["gap"] for r in ranks) <= MESH_SERVE_TOL
            and (vs_one is None or vs_one <= MESH_SERVE_TOL)):
        failed.append("serve a")

    b = r0["serve b"]
    ok = np.array_equal(b["answers"]["reach"], want["b"][0]) \
        and np.array_equal(b["answers"]["hit"], want["b"][1])
    print(f"mesh: serve (b) {b['k']} reachability probes n={b['n']}, "
          f"{b['iterations']} iterations: per probe {b['batched_ms']:.3f} ms "
          f"batched, {b['sequential_ms']:.3f} ms one by one; equal to "
          f"scipy's BFS {ok}, batched bit-equal to one by one "
          f"{all(r['serve b']['equal'] for r in ranks)}")
    if not (ok and all(r["serve b"]["equal"] for r in ranks)):
        failed.append("serve b")

    for tag in ("sum", "max/min"):
        c = r0[f"serve c {tag}"]
        got, pres = c["answers"]
        if tag == "sum":
            r64, p64 = want["c"]["sum"]
            err = max(float(np.abs(got["rank"][q] - r64[:, q]).sum()
                            / np.abs(r64[:, q]).sum())
                      for q in range(SERVE_SCAN_K))
            ok = np.array_equal(pres["rank"], p64.T) \
                and err <= SERVE_PPR_L1_TOL
            right = f"rel L1 vs float64 {err:.3e} (tol {SERVE_PPR_L1_TOL})"
        else:
            ok = all(pres[p].all() and np.array_equal(got[p], want["c"][p])
                     for p in ("hi", "lo"))
            right = f"hi and lo equal to the oracle {ok}"
        launches = [r[f"serve c {tag}"]["launches"] for r in ranks]
        site = r0.get(f"site/serve scan {tag}")
        b1 = "not measured" if site is None else \
            f"{site['ms']:.3f} ms (plain {site['plain_ms']:.3f} ms)"
        print(f"mesh: serve (c) segment scan {tag} on {SERVE_SCAN_N} "
              f"vertices, k={SERVE_SCAN_K} batched: B1 launches a rank "
              f"{launches} in {c['iterations']} iterations (one a GroupBy "
              f"firing "
              f"{all(r[f'serve c {tag}']['one_a_firing'] for r in ranks)}, "
              f"payload widths {c['widths']}); {right}; B1 there {b1}")
        if not (ok and c["connectors"] == ["segment-scan"]
                and all(r[f"serve c {tag}"]["one_a_firing"]
                        and r[f"serve c {tag}"]["calls"]
                        == r[f"serve c {tag}"]["iterations"]
                        for r in ranks)
                and c["widths"] == [SERVE_SCAN_K]
                and (not on_card or min(launches) == c["iterations"])):
            failed.append(f"serve c {tag}")

    dd = r0["serve d"]
    (w64, wp), closures = want["d"]
    ok, pi, ri = True, 0, 0
    for (kind, cols), got in zip(want["requests"], dd["answers"]):
        if kind == "ppr":
            rel = float(np.abs(got - w64[:, pi]).sum()
                        / np.abs(w64[:, pi]).sum())
            ok &= rel <= SERVE_PPR_L1_TOL
            pi += 1
        else:
            hit = np.zeros_like(closures[ri])
            hit[cols[1]] = closures[ri][cols[1]]
            ok &= np.array_equal(got, hit)
            ri += 1
    print(f"mesh: serve (d) request loop: {dd['requests']} requests in "
          f"{dd['dispatches']} dispatches (largest batch {dd['largest']}) "
          f"in {dd['seconds']:.3f} s, {dd['requests_per_s']:.1f} "
          f"requests/s; in arrival order on every rank "
          f"{all(r['serve d']['in_order'] for r in ranks)}, right {ok}")
    if not (ok and all(r["serve d"]["in_order"] for r in ranks)):
        failed.append("serve d")
    print(f"mesh: serve cells on rank 0 in s {json.dumps(r0['serve seconds'])}")
    return failed


def _mesh_graph(d, tag, n):
    """The global graph ``tag`` the phase wrote to ``d``, on the CPU."""

    import numpy as np

    from repro_torch.carry import graph_from_numpy

    src, dst = np.load(d / f"{tag}_src.npy"), np.load(d / f"{tag}_dst.npy")
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    return graph_from_numpy(n, src, dst, outdeg, device="cpu")


def _mesh_rank(rank, world, cfg):
    """One rank of the mesh phase: every cell, in the order of the
    phase's docstring; returns its numbers (rank 0 also the receiver's
    B1 site)."""

    import numpy as np
    import torch

    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.imru import compile_imru
    from repro_torch.core.pregel import compile_pregel
    from repro_torch.launch.mesh import make_data_mesh, make_mesh
    from repro_torch.parallel import collectives as C

    d = Path(cfg["dir"])
    on_card = cfg["device"] == "cuda"
    data = make_data_mesh(device=cfg["device"], backend=cfg["backend"])
    out = {"device": str(data.device), "transport": data.transport,
           "world": world}
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    # PageRank at the pagerank phase's size, the planner's connector; its
    # second run is A10c's crash on one rank, bit-equal to the first.
    n = cfg["n"]
    g = _mesh_graph(d, "pr", n)
    out["pagerank"], _, ex = _mesh_pagerank(
        data, n, g, (np.load(d / "pr_oracle.npy"),
                     np.load(d / "pr_fault_oracle.npy")),
        None, cfg["supersteps"], False, again=False)
    lap("pagerank")
    two = make_data_mesh(2, ranks=MESH_FT_SURVIVORS, device=cfg["device"],
                         backend=cfg["backend"])
    box = [ex]
    del ex, g
    out["ft/pagerank"] = _mesh_ft_pagerank(cfg, rank, data, two, box)
    out["ft/in_two"], out["ft/on_card"] = two is not None, on_card
    out["pagerank"]["identical"] = (
        out["ft/pagerank"]["crash"]["digest"] == out["pagerank"]["digest"])
    lap("ft pagerank")
    # merging and hash_sort at the sssp phase's size: PageRank, and the max
    # combine against the single-device run.
    m = cfg["m"]
    g = _mesh_graph(d, "sssp", m)
    oracles = (np.load(d / "sssp_pr_oracle.npy"),
               np.load(d / "sssp_pr_fault_oracle.npy"))
    want_max = np.load(d / "max_single.npy")
    for conn in ("merging", "hash_sort"):
        cell, site, ex = _mesh_pagerank(data, m, g, oracles, conn,
                                        MESH_BUCKET_SUPERSTEPS,
                                        rank == 0 and on_card)
        del ex
        if site:
            out[f"site/{conn}"] = _row_site(
                f"{conn} receiver", ("mesh", cell["launches"], site[0]),
                cell["launches"], phase="mesh")
        del site
        out[f"pagerank/{conn}"] = cell
        ex = compile_pregel(_max_program(), g, mesh=data,
                            force_connector=conn)
        res, launches, _, _ = _counted_run(ex, data, MESH_CC_SUPERSTEPS)
        out[f"max/{conn}"] = {
            "equal": bool(np.array_equal(res.state[0].cpu().numpy(),
                                         want_max)),
            "ms": res.seconds / res.iterations * 1e3, "launches": launches}
    lap("merging, hash_sort")
    # Semi-naive SSSP on all three connectors against BFS.
    want = np.load(d / "bfs.npy")
    for conn in ("dense_psum", "merging", "hash_sort"):
        ex = compile_pregel(_sssp_program(cfg["source"]), g, mesh=data,
                            force_connector=conn, semi_naive=True)
        res, launches, sent, staged = _counted_run(ex, data, 1000)
        out[f"sssp/{conn}"] = {
            "equal": bool(res.converged and np.array_equal(
                res.state[0].double().cpu().numpy(), want)),
            "modes": list(res.modes), "iterations": res.iterations,
            "ms": res.seconds / res.iterations * 1e3, "launches": launches,
            "sent": sent, "staged": staged}
    del g
    lap("sssp")
    if on_card:
        torch.cuda.empty_cache()

    # IMRU BGD on (2, 2) pod x data: this rank's quarter of the records.
    mesh = make_mesh((2, 2), ("pod", "data"), device=cfg["device"],
                     backend=cfg["backend"])
    X, y = _mesh_imru_records(mesh, cfg)
    rows, dim = X.shape
    lr = IMRU_LR_SCALE / cfg["records"]
    lr32 = float(torch.tensor(lr, dtype=torch.float32))
    recs = {"x": X, "y": y}
    imru = {}
    for sched in MESH_SCHEDULES + ("int8_ef",):
        codec = "int8_ef" if sched == "int8_ef" else None
        ex = compile_imru(_bgd_task(dim, lr, mesh.device), recs, mesh=mesh,
                          hw=H100_SXM, codec=codec,
                          force_reduce="flat" if codec else sched)
        res = ex.run(max_iters=MESH_IMRU_ITERATIONS)
        imru[sched] = (res.state.double(), res.seconds / res.iterations * 1e3,
                       list(ex.plan.notes), ex.plan.microbatches)
    # The oracle's own microbatch bounds, as the plan states them.
    size = rows // imru["flat"][3]
    bounds = [(s, min(s + size, rows)) for s in range(0, rows, size)]

    def reduce(t, op="sum"):
        with C.bind(mesh):
            return (C.pmax if op == "max" else C.psum)(t, mesh.batch_axes)

    scales = []
    w64, bar = _imru_oracle(X, y, lr32, MESH_IMRU_ITERATIONS, bounds,
                            reduce=reduce, scales=scales)
    quant = 2 * lr32 * MESH_RANKS * math.sqrt(dim) * sum(
        s / 127 for s in scales)
    flat = imru["flat"][0]
    out["imru"] = {
        k: {"err": float((v[0] - w64).norm()), "ms": v[1], "notes": v[2],
            "vs_flat": float((v[0] - flat).norm() / flat.norm()),
            "finite": bool(torch.isfinite(v[0]).all())}
        for k, v in imru.items()}
    out["imru_bar"], out["imru_int8_bar"] = bar, bar + quant
    out["imru_microbatches"] = imru["flat"][3]
    out["staged_total"] = data.stats.staged_bytes + mesh.stats.staged_bytes
    # The last executable holds the records too.
    del X, y, recs, imru, ex, res
    if on_card:
        torch.cuda.empty_cache()
    lap("imru")
    out.update(_mesh_generic(data, cfg, rank))
    if on_card:
        torch.cuda.empty_cache()
    lap("generic")
    out.update(_mesh_ft(cfg, rank, data, mesh, (w64, bar), two))
    if on_card:
        torch.cuda.empty_cache()
    lap("ft imru, rows")
    out.update(_mesh_serve(data, cfg, rank))
    if on_card:
        torch.cuda.empty_cache()
    lap("serve")
    for arch in MESH_LM_CELLS:
        out.update(_mesh_lm(cfg, arch))
        if on_card:
            torch.cuda.empty_cache()
        lap(arch)
    out["seconds"] = seconds
    return out


@dataclasses.dataclass(frozen=True)
class _LmCell:
    """A mesh LM cell (``MESH_LM_CELLS``): the runs of its train step, each
    ``(tag, plan, steps, fault)`` from the seed's weights, the planner's
    prefill and decode plans, and its fed and free decode steps."""

    arch: str
    runs: tuple
    prefill: object
    decode: object
    fed: int
    free: int

    @property
    def cfg(self):
        return self.prefill.cfg

    @property
    def cache(self) -> int:
        L = MESH_LM_SEQ + self.fed + self.free
        return L if self.cfg.window is None else min(L, self.cfg.window)

    @property
    def steps(self) -> int:
        return self.fed + self.free


def _mesh_lm_cell(arch) -> _LmCell:
    """The cell of ``arch`` on the (data 2, model 2) mesh of H100s at
    MESH_LM_LAYERS decoder layers (and as many encoder layers): the
    planner's ``train_4k`` plan (``plan_lm`` on ``H100_SXM``) under ZeRO-1
    in MESH_TRAIN_MICROBATCHES microbatches; the fault's step in one
    microbatch (the same loss and gradient as the first step, at one
    gradient reduction instead of two); where the cell asks, one step under
    ZeRO-3 (the plan's ``rules.fsdp``); the ``prefill_32k`` and
    ``decode_32k`` plans."""

    from repro_torch.core.hardware import H100_SXM, MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.models.registry import get_config

    shape, axes = MESH_TRAIN_SHAPE
    spec = MeshSpec(tuple(zip(axes, shape)))
    full = get_config(arch)
    cfg = dataclasses.replace(
        full, n_layers=MESH_LM_LAYERS,
        enc_layers=MESH_LM_LAYERS if full.enc_layers else 0)
    want = MESH_LM_CELLS[arch]
    plan = plan_lm(full, "train_4k", spec, hw=H100_SXM)
    zero1 = dataclasses.replace(
        plan, cfg=cfg, microbatches=MESH_TRAIN_MICROBATCHES, zero="zero1",
        rules=dataclasses.replace(plan.rules, fsdp=False))
    runs = [("zero1", zero1, want["steps"], False),
            ("fault", dataclasses.replace(zero1, microbatches=1), 1, True)]
    if want["zero3"]:
        runs.append(("zero3", dataclasses.replace(
            zero1, zero="zero3",
            rules=dataclasses.replace(zero1.rules, fsdp=True)), 1, False))
    prefill, decode = (plan_lm(cfg, kind, spec, hw=H100_SXM)
                       for kind in ("prefill_32k", "decode_32k"))
    return _LmCell(arch, tuple(runs), prefill, decode, want["fed"],
                   want["free"])


def _mesh_lm_shapes(cfg):
    """(tag, Sq, Skv, causal, window) of each flash launch shape of a
    cell's prefill and train step (whisper: the encoder, the decoder's
    self- and cross-attention; none for the attention-free SSM), and
    whisper's decode step's cross-attention."""

    S = MESH_LM_SEQ
    if cfg.attention_free:
        return []
    if cfg.family != "encdec":
        return [("self", S, S, True, cfg.window)]
    return [("encoder", cfg.enc_seq, cfg.enc_seq, False, None),
            ("self", S, S, True, None),
            ("cross", S, cfg.enc_seq, False, None),
            ("decode cross", 1, cfg.enc_seq, False, None)]


def _mesh_lm_heads(cell):
    """(H, KH) of a rank's flash launches in a cell on the (data 2, model
    2) mesh: its q and kv heads where model divides both (MLA's k_rope
    broadcast to every local head); its q heads, a kv head each, where
    model divides the q heads only (A10h-3, case (i)); every head where
    the plan keeps qkv whole, the attention replicated (the planner's
    choice where model does not divide the q heads, case (ii))."""

    cfg, tp = cell.cfg, MESH_TRAIN_SHAPE[0][1]
    H, KH = cfg.n_heads, cfg.n_kv_heads
    whole = cell.prefill.rules.get("qkv") is None
    if cfg.family == "mla":
        return (H, H) if whole else (H // tp, H // tp)
    if whole:
        return H, KH
    return (H // tp, H // tp) if KH % tp else (H // tp, KH // tp)


def _layers_of(cfg) -> str:
    return f"{cfg.n_layers} layers" + (
        f" + {cfg.enc_layers} encoder" if cfg.enc_layers else "")


def _mesh_lm_inputs(args, d, device, arch):
    """A cell's inputs, yardsticks and bars, made before the ranks start:
    its batch (written to ``d``: the train step's rows, served again as
    the prompts; whisper's rows carry its stub frames), the train and serve
    yardsticks (``_mesh_train_inputs``, ``_mesh_serve_lm_inputs``), and
    B2-B4 held to their plain versions at each of a rank's local launch
    shapes (``_mesh_lm_shapes``: a rank's heads of the model axis, its
    rows of a microbatch in training and of the prompts in serving; MLA's
    k_rope broadcast to every local head), timed."""

    import numpy as np
    import torch

    t0 = time.perf_counter()
    cell = _mesh_lm_cell(arch)
    cfg = cell.cfg
    B, S = MESH_LM_BATCH, MESH_LM_SEQ
    rng = np.random.default_rng(args.seed + 7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["enc_input"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    np.savez(d / f"{arch}_batch.npz", **batch)
    on_dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    train = _mesh_train_inputs(cell, gen, on_dev, device)
    serve = _mesh_serve_lm_inputs(cell, args.seed, d, on_dev, device)
    D = _attention_dim(cfg)
    H, KH = _mesh_lm_heads(cell)
    rows = B // MESH_TRAIN_MICROBATCHES // 2
    kernels = []
    for tag, Sq, Skv, causal, window in _mesh_lm_shapes(cfg):
        at = f"a mesh rank's {cfg.name} {tag} shape"
        entry = {"tag": tag, "serve": _flash_at(B // 2, H, KH, Sq, Skv, D,
                                                causal, window, gen, device,
                                                at + " (serving)")}
        if Sq > 1:
            entry["fwd"] = _flash_at(rows, H, KH, Sq, Skv, D, causal,
                                     window, gen, device, at + " (training)")
            entry["bwd"] = _bwd_at(rows, H, KH, Sq, Skv, D, causal, window,
                                   gen, device, at + " (training)")
        kernels.append(entry)
        torch.cuda.empty_cache()
    print(f"mesh: {cfg.name} inputs made in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return {"train": train, "serve": serve, "kernels": kernels}


def _mesh_train_inputs(cell, gen, batch, device):
    """A cell's train yardstick and bar: the bf16 bound (the plain path's
    loss and gradients on one row against the same model in f32, as the
    train phase measures it) and the port's one-device step from the
    seed's weights on the cell's batch, for as many steps as the cell's
    ZeRO-1 run takes."""

    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.launch.train import build_train_step, make_optimizer

    plan = cell.runs[0][1]
    cfg = plan.cfg
    params = _family_params(cfg, gen, device)
    one = {k: v[:1] for k, v in batch.items()}
    loss_r, g_r = _grads_of(params, cfg, one, "ref")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    loss_f, g_f = _grads_of(tree_map(lambda t: t.float(), params), cfg32,
                            one, "ref")
    floor = _tree_rel_l2(g_r, g_f)
    loss_floor = abs(loss_r - loss_f) / abs(loss_f)
    del g_r, g_f
    if floor > LM_BF16_BOUND_CAP:
        raise AssertionError(f"mesh: {cfg.name}'s bf16 plain path is "
                             f"{floor} off f32")
    opt = make_optimizer(plan, lr=TRAIN_LR)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    del params
    step_fn, _, _ = build_train_step(plan, None, optimizer=opt, device=device)
    steps = []
    for _ in range(cell.runs[0][2]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        steps.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                      time.perf_counter() - t0))
    del state, step_fn, opt, metrics
    torch.cuda.empty_cache()
    bar = LM_NOISE_FACTOR * max(loss_floor, floor)
    print(f"mesh: train yardstick {cfg.name} {_layers_of(cfg)}, "
          f"{MESH_LM_BATCH} x {MESH_LM_SEQ} tokens in "
          f"{MESH_TRAIN_MICROBATCHES} microbatches on one device: (loss, "
          f"grad_norm, s) {[tuple(round(x, 6) for x in r) for r in steps]}; "
          f"bf16 bound: gradients rel L2 {floor:.3e}, loss rel "
          f"{loss_floor:.3e}; bar {LM_NOISE_FACTOR} x "
          f"{max(loss_floor, floor):.3e} = {bar:.3e}", flush=True)
    return {"steps": steps, "bar": bar}


def _bits_fingerprint(t) -> tuple:
    """An exact fingerprint of a tensor's bits (two integer sums, wrapping
    mod 2^64, so any order gives the same)."""

    import torch

    bits = t.detach().reshape(-1).view(
        torch.int32 if t.element_size() == 4 else torch.int16)
    a = b = 0
    for lo in range(0, bits.numel(), 1 << 24):
        c = bits[lo:lo + (1 << 24)].to(torch.int64)
        w = torch.arange(lo, lo + c.numel(), device=c.device) % 65521 + 1
        a += int(c.sum())
        b += int((c * w).sum())
    return a % (1 << 64), b % (1 << 64)


def _replica_fingerprint(params, specs, mesh):
    """The fingerprint of this rank's parameters gathered over the batch
    axes (its model block of the whole): equal on every data replica."""

    from repro_torch.core.tree import tree_leaves
    from repro_torch.parallel.sharding import P, join_blocks, spec_axes

    out = []
    for x, spec in zip(tree_leaves(params), tree_leaves(specs)):
        data_only = P(*[e if "model" not in spec_axes(e) else None
                        for e in spec])
        out.append(_bits_fingerprint(join_blocks(x, data_only, mesh)))
    return out


@contextlib.contextmanager
def _skipped_row_psum(layer):
    """The planted fault: layer ``layer``'s MLP output is not summed over
    ``model`` (its row-parallel psum skipped on every rank, in the forward
    and in the recompute), so each rank carries its own part of it."""

    from repro_torch.models import blocks, lm
    from repro_torch.parallel import collectives as C

    real_layer, real_mlp = lm._layer, blocks.mlp_apply
    at = {"i": None}

    def seen_layer(params, i, key="layers"):
        at["i"] = i
        return real_layer(params, i, key)

    def mlp(p, x, cfg):
        if at["i"] != layer:
            return real_mlp(p, x, cfg)
        with mock.patch.object(C, "reduce_from", lambda y, axes: y):
            return real_mlp(p, x, cfg)

    with mock.patch.object(lm, "_layer", seen_layer), \
            mock.patch.object(blocks, "mlp_apply", mlp):
        yield


def _train_fault(cfg):
    """The planted fault of a cell's train step, by family: its name, the
    patch that plants it, and the checks that must catch it.  Dense: layer
    MESH_TRAIN_FAULT_LAYER's row-parallel MLP psum skipped, so each
    ``model`` rank carries its own part of that MLP's output: outside the
    bar, and the ranks disagree.  MLA: the ``copy_to`` at ``cq``, ``c_kv``
    and ``k_rope`` skipped in every layer; whisper: the ``copy_to`` of the
    encoder output skipped.  These leave the loss as it is and give each
    ``model`` rank its own share of the gradient below them, which moves
    the grad norm by less than the bar (1.5e-2 and 1.7e-3 against 2.4e-2
    and 1.6e-2 on an NVIDIA H100 80GB HBM3 at 700.00 W,
    ``tools/mesh_lm_cells.py``) but makes the ranks' grad norms
    disagree.  SSM: the SSD mixer's parameters entered through
    ``copy_to``, so their gradients, whole on every ``model`` rank, are
    summed over it (doubled); hybrid: the SSM half's output, whole on
    every rank, summed over ``model`` as if it were a row-parallel
    layer's (doubled in ``0.5 (a + s)``).  Both leave every rank
    agreeing, so the one-device bar alone must catch them."""

    from repro_torch.models import blocks, lm
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding

    if cfg.family == "ssm":
        real_ssm = blocks.ssm_mixer

        def summed(p, x, ctx, cache=None):
            tp = sharding.tp_axes()
            return real_ssm({k: C.copy_to(v, tp) for k, v in p.items()}, x,
                            ctx, cache)

        return ("the SSD mixer's whole gradients psum'd over model",
                mock.patch.object(blocks, "ssm_mixer", summed), ("bar",))
    if cfg.family == "hybrid":
        real_half = blocks.ssm_mixer

        def psummed(p, x, ctx, cache=None):
            y, new_cache = real_half(p, x, ctx, cache)
            return C.reduce_from(y, sharding.tp_axes()), new_cache

        return ("the SSM half's whole output psum'd over model in the "
                "hybrid's sum", mock.patch.object(blocks, "ssm_mixer",
                                                  psummed), ("bar",))
    if cfg.family == "mla":
        real = blocks.mla_mixer

        def mixer(*args, **kwargs):
            with mock.patch.object(C, "copy_to", lambda x, axes: x):
                return real(*args, **kwargs)

        return ("MLA's copy_to at cq, c_kv and k_rope skipped",
                mock.patch.object(blocks, "mla_mixer", mixer), ("ranks",))
    if cfg.family == "encdec":
        return ("the encoder output's copy_to skipped",
                mock.patch.object(lm, "_xattn_tp", lambda params, cfg: ()),
                ("ranks",))
    return (f"layer {MESH_TRAIN_FAULT_LAYER}'s row-parallel MLP psum skipped",
            _skipped_row_psum(MESH_TRAIN_FAULT_LAYER), ("bar", "ranks"))


def _mesh_train(cfg, cell):
    """A cell's train step on a (data 2, model 2) mesh of this phase's
    ranks (ROADMAP A10e-1, A10h-1): each of ``cell.runs`` from the seed's
    weights on the cell's batch, the fault's under ``_train_fault``; per
    step the loss, grad norm, seconds, flash launches by route,
    collectives by op and phase, MB staged, peak memory and the data
    replicas' parameter fingerprints."""

    import numpy as np
    import torch

    from repro_torch.carry import shard_state, sharded_zeros
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_train_step, make_optimizer
    from repro_torch.models import lm

    mesh = make_mesh(*MESH_TRAIN_SHAPE, device=cfg["device"],
                     backend=cfg["backend"])
    on_card = mesh.device.type == "cuda"
    with np.load(Path(cfg["dir"]) / f"{cell.arch}_batch.npz") as f:
        batch = {k: f[k] for k in f.files}
    out = {"model": mesh.coordinate("model")}
    for tag, plan, steps, fault in cell.runs:
        opt = make_optimizer(plan, lr=TRAIN_LR)
        step_fn, specs, batch_fn = build_train_step(plan, mesh, optimizer=opt)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(cfg["seed"])
        params = _family_params(plan.cfg, gen, mesh.device)
        state = {"params": shard_state(params, specs["params"], mesh),
                 "opt": sharded_zeros(opt.init(lm.abstract_params(plan.cfg)),
                                      specs["opt"], mesh),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=mesh.device)}
        del params
        if on_card:
            torch.cuda.empty_cache()
        rows = batch_fn(batch)
        run = []
        with (_train_fault(plan.cfg)[1] if fault
              else contextlib.nullcontext()):
            for _ in range(steps):
                K.reset_launch_count()
                mesh.stats.reset()
                if on_card:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, rows)
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
                if on_card:
                    torch.cuda.synchronize()
                run.append({
                    "loss": loss, "grad_norm": gnorm,
                    "microbatches": plan.microbatches,
                    "s": time.perf_counter() - t0,
                    "launches": _train_counts(K),
                    "calls": dict(mesh.stats.calls),
                    "sent": dict(mesh.stats.sent),
                    "staged": mesh.stats.staged_bytes,
                    "phases": step_fn.phases,
                    "peak": torch.cuda.max_memory_allocated()
                    if on_card else 0,
                    "replica": _replica_fingerprint(
                        state["params"], specs["params"], mesh)})
        out[tag] = run
        del state, step_fn, rows, metrics
        if on_card:
            torch.cuda.empty_cache()
    return {f"lm_train/{cell.arch}": out}


def _check_mesh_train(ranks, want, cell):
    """A cell's train checks and lines; returns the failures."""

    import torch

    from repro_torch.kernels.flash_attention import kernel as K

    failed = []
    cfg = cell.cfg
    bar, steps = want["bar"], want["steps"]
    key = f"lm_train/{cell.arch}"
    per_step = _family_train_want(K, cfg, MESH_TRAIN_MICROBATCHES)
    route = {} if cfg.attention_free else {
        k: K.route(k, torch.bfloat16, _attention_dim(cfg))
        for k in ("fwd", "dq", "dkv")}
    tokens = MESH_LM_BATCH * MESH_LM_SEQ
    for tag, *_ in cell.runs:
        for i, c in enumerate(ranks[0][key][tag]):
            ref_loss, ref_gn, ref_s = steps[i]
            cells = [r[key][tag][i] for r in ranks]
            off = max(max(abs(x["loss"] - ref_loss) / abs(ref_loss),
                          abs(x["grad_norm"] - ref_gn) / abs(ref_gn))
                      for x in cells)
            same = len({(x["loss"], x["grad_norm"]) for x in cells}) == 1
            groups = {}
            for r, x in zip(ranks, cells):
                groups.setdefault(r[key]["model"], set()).add(
                    tuple(map(tuple, x["replica"])))
            replicas = all(len(g) == 1 for g in groups.values())
            secs = [round(x["s"], 3) for x in cells]
            mb = {k: round(v / 1e6, 1) for k, v in c["sent"].items()}
            fault = f" ({_train_fault(cfg)[0]})" if tag == "fault" else ""
            print(f"mesh: train {tag}{fault} step {i} ({cfg.name} "
                  f"{_layers_of(cfg)}, {MESH_LM_BATCH} x {MESH_LM_SEQ} "
                  f"tokens, {c['microbatches']} microbatch(es), mesh "
                  f"{MESH_TRAIN_SHAPE}): loss {c['loss']:.6f} grad_norm "
                  f"{c['grad_norm']:.6f} vs one device {ref_loss:.6f} "
                  f"{ref_gn:.6f}: rel {off:.3e} (the ranks' largest; bar "
                  f"{bar:.3e}); s a step per rank {secs} = "
                  f"{tokens / max(secs):.1f} tokens/s (one device "
                  f"{ref_s:.3f} s); calls a rank {c['calls']}, MB handed "
                  f"{mb}, MB staged {c['staged'] / 1e6:.1f}; peak memory a "
                  f"rank GB {[round(x['peak'] / 1e9, 2) for x in cells]}; "
                  f"flash launches a rank {TRAIN_COUNTS} "
                  f"{[x['launches'] for x in cells]} (routes {route}); "
                  f"every rank's loss and grad norm equal {same}, data "
                  f"replicas' parameters bit-equal {replicas}", flush=True)
            if tag == "fault":
                name, _, needs = _train_fault(cfg)
                caught = {"bar": off > bar, "ranks": not same}
                print(f"mesh: train {cfg.name} fault ({name}) caught by "
                      f"the bar {caught['bar']}, by the ranks' equality "
                      f"{caught['ranks']}; must be caught by {list(needs)}",
                      flush=True)
                if not all(caught[k] for k in needs):
                    failed.append(f"{cell.arch} train: {name} passes "
                                  f"{[k for k in needs if not caught[k]]}")
                continue
            if off > bar:
                failed.append(f"{cell.arch} train {tag} step {i}: {off} > "
                              f"{bar}")
            if not (same and replicas):
                failed.append(f"{cell.arch} train {tag} step {i}: ranks "
                              f"disagree")
            if any(x["launches"] != per_step for x in cells):
                failed.append(f"{cell.arch} train {tag} step {i}: flash "
                              f"launches {[x['launches'] for x in cells]}, "
                              f"want {per_step}")
    for p in ranks[0][key]["zero1"][0]["phases"].items():
        print(f"mesh: train {cfg.name} zero1 step 0 rank 0 collectives, "
              f"{p[0]}: {json.dumps(p[1])}")
    return failed


def _mesh_serve_lm_params(cfg, seed, device):
    """The seed's weights, served in the compute dtype
    (``lm.serving_params``; the f32 master dropped)."""

    import torch

    from repro_torch.models import lm

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    master = _family_params(cfg, gen, device)
    params = lm.serving_params(cfg, master)
    del master
    return params


def _mesh_serve_lm_inputs(cell, seed, d, batch, device):
    """A cell's serve yardstick and bar: the port's one-device prefill and
    ``cell.steps`` greedy steps on the seed's bf16 weights and the cell's
    prompts (their logits and tokens written to ``d``), and the bf16 bound
    (the plain path against the same model in f32, prefill and TF_STEPS
    steps fed the one device's tokens, as the lm phase measures it)."""

    import numpy as np
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serve import build_decode_step, build_prefill_step

    cfg, L = cell.cfg, cell.cache
    params = _mesh_serve_lm_params(cfg, seed, device)
    prefill_fn, _ = build_prefill_step(cell.prefill, None, L, device)
    decode_fn, _, _ = build_decode_step(cell.decode, None, device)
    with torch.inference_mode():
        prefill_fn(params, {k: v[:1] for k, v in batch.items()})
    run = _serve(prefill_fn, decode_fn, params, batch, cell.steps)
    np.save(d / f"{cell.arch}_logits.npy",
            run["logits"][:cell.fed + 1].cpu().numpy())
    one = {"prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
           "tokens": run["tokens"].cpu().numpy()}
    np.save(d / f"{cell.arch}_tokens.npy", one["tokens"])

    def plain(pplan, dplan, params):
        prefill_fn, _ = build_prefill_step(pplan, None, L, device,
                                           attention="ref")
        decode_fn, _, _ = build_decode_step(dplan, None, device,
                                            attention="ref")
        return _serve(prefill_fn, decode_fn, params, batch, TF_STEPS,
                      feed=run["tokens"])["logits"]

    def f32(plan):
        return dataclasses.replace(plan, cfg=dataclasses.replace(
            plan.cfg, compute_dtype="float32"))

    ref = plain(cell.prefill, cell.decode, params)
    full = plain(f32(cell.prefill), f32(cell.decode),
                 tree_map(lambda t: t.float(), params))
    del params, run
    floor = max(_rel_l2(ref[i], full[i], cfg.vocab)
                for i in range(TF_STEPS + 1))
    del ref, full
    torch.cuda.empty_cache()
    if floor > LM_BF16_BOUND_CAP:
        raise AssertionError(f"mesh: {cfg.name}'s bf16 plain serve path is "
                             f"{floor} off f32")
    bar = LM_NOISE_FACTOR * floor
    print(f"mesh: serve yardstick {cfg.name} {_layers_of(cfg)} on one "
          f"device: prefill {MESH_LM_BATCH} x {MESH_LM_SEQ} "
          f"{one['prefill_s']:.4f}s, decode "
          f"{one['decode_s'] / cell.steps * 1e3:.3f} ms/step; bf16 bound: "
          f"logits rel L2 {floor:.3e} (prefill and {TF_STEPS} fed steps); "
          f"bar {LM_NOISE_FACTOR} x {floor:.3e} = {bar:.3e}", flush=True)
    return {"bar": bar, **one}


@contextlib.contextmanager
def _unjoined_decode():
    """The planted fault: the decode's split softmax is not joined over
    ``model``: each rank normalises its own block of the slots."""

    from repro_torch.models import blocks

    real = blocks.decode_attention_join
    with mock.patch.object(blocks, "decode_attention_join",
                           lambda o, m, l, axes, dtype: real(o, m, l, (),
                                                             dtype)):
        yield


@contextlib.contextmanager
def _unsummed_lookup():
    """The planted fault: the vocab-parallel lookup's ``psum`` skipped, so
    each ``model`` rank embeds only the tokens of its own vocab block
    (zeros for the rest)."""

    from repro_torch.models import lm
    from repro_torch.parallel import collectives as C

    real = lm._embed_tokens

    def embed(*args):
        with mock.patch.object(C, "reduce_from", lambda x, axes: x):
            return real(*args)

    with mock.patch.object(lm, "_embed_tokens", embed):
        yield


def _serve_fault(cfg):
    """(name, context) of a cell's planted serving fault: the split
    softmax left unjoined over ``model``, or, for the attention-free SSM,
    whose decode joins no softmax, the tied table's vocab-parallel lookup
    left unsummed."""

    if cfg.attention_free:
        return ("the vocab-parallel lookup's psum skipped",
                _unsummed_lookup())
    return "split softmax unjoined over model", _unjoined_decode()


def _mesh_serve_lm(cfg, cell):
    """A cell's serving on a (data 2, model 2) mesh of this phase's ranks
    (ROADMAP A10e-2, A10h-1): prefill, ``cell.fed`` steps fed the one
    device's tokens and ``cell.free`` free steps, then the planted fault's
    steps from the prefill's cache.  Returns the logits' rel L2 against
    one device by step, the fault's, the joined logits' and tokens'
    fingerprints, the padded columns, the tokens, the times, B2's
    launches, the collectives of the prefill and of the decode, and the
    peak memory."""

    import numpy as np
    import torch

    from repro_torch.carry import shard_state
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import (batch_rows, build_decode_step,
                                          build_prefill_step, greedy_sample)
    from repro_torch.launch.train import _delta, _snapshot
    from repro_torch.models import lm
    from repro_torch.models.common import dtype_of
    from repro_torch.parallel.sharding import join_blocks, logical_to_spec

    mesh = make_mesh(*MESH_TRAIN_SHAPE, device=cfg["device"],
                     backend=cfg["backend"])
    on_card = mesh.device.type == "cuda"
    d = Path(cfg["dir"])
    lcfg, rules = cell.cfg, cell.prefill.rules
    B, S, L = MESH_LM_BATCH, MESH_LM_SEQ, cell.cache
    fed, steps = cell.fed, cell.steps
    prefill_fn, p_specs = build_prefill_step(cell.prefill, mesh, L)
    decode_fn, d_specs, _ = build_decode_step(cell.decode, mesh, cache_len=L)
    if d_specs != p_specs:
        raise AssertionError("mesh: the prefill and decode plans lay the "
                             "parameters out differently")
    params = shard_state(_mesh_serve_lm_params(lcfg, cfg["seed"],
                                               mesh.device), p_specs, mesh)
    if on_card:
        torch.cuda.empty_cache()
    with np.load(d / f"{cell.arch}_batch.npz") as f:
        batch = {k: f[k] for k in f.files}
    feed = np.load(d / f"{cell.arch}_tokens.npy")
    rows = batch_rows({**batch, "feed": feed}, mesh, rules)
    feed = rows.pop("feed")

    def sample(logits):
        return greedy_sample(logits, lcfg, mesh)

    box = {}

    def after_prefill(logits, cache):
        box["prefill"] = _snapshot(mesh.stats)
        box["cache"] = tree_map(torch.clone, cache)

    mesh.stats.reset()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    run = _serve(prefill_fn, decode_fn, params, rows, steps,
                 feed=feed[:, :fed], after_prefill=after_prefill,
                 sample=sample)
    decode = _delta(_snapshot(mesh.stats), box["prefill"])
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    times = {k: run[k] for k in ("prefill_s", "decode_s", "prefill_launches",
                                 "prefill_wgmma", "decode_launches")}
    local = run["logits"]                        # [steps + 1, B / 2, V / 2]
    first = mesh.coordinate("model") * local.shape[-1]
    pad = local[..., max(lcfg.vocab - first, 0):]
    masked = torch.tensor(-1e30, dtype=dtype_of(lcfg.compute_dtype)).item()
    padded = (int(pad.shape[-1]), bool((pad == masked).all()))

    def joined(x):
        return lm.gather_logits(x.transpose(0, 1), lcfg, mesh, rules,
                                B).transpose(0, 1)

    full = joined(local)
    one = torch.from_numpy(np.load(d / f"{cell.arch}_logits.npy")).to(
        mesh.device)
    rel = [_rel_l2(full[i], one[i], lcfg.vocab) for i in range(fed + 1)]
    tokens = join_blocks(run["tokens"], logical_to_spec(
        rules, ("batch", None), shape=(B, steps + 1), mesh=mesh), mesh)
    fingerprint = [_bits_fingerprint(full), _bits_fingerprint(tokens)]
    del full, local, run
    fault = []
    with _serve_fault(lcfg)[1], torch.inference_mode():
        cache = box.pop("cache")
        for i in range(MESH_SERVE_LM_FAULT_STEPS):
            logits, cache = decode_fn(params, cache, feed[:, i:i + 1], S + i)
            fault.append(_rel_l2(joined(logits.float().transpose(0, 1))[0],
                                 one[i + 1], lcfg.vocab))
    del cache, one, params
    if on_card:
        torch.cuda.empty_cache()
    return {f"lm_serve/{cell.arch}": {
        "rel": rel, "fault": fault, "fingerprint": fingerprint,
        "padded": padded, "model": mesh.coordinate("model"),
        "tokens": tokens.cpu().numpy().tolist(), "peak": peak,
        "prefill_calls": box["prefill"], "decode_calls": decode, **times}}


def _check_mesh_serve_lm(ranks, want, cell):
    """A cell's serve checks and lines; returns the failures."""

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import kernel as K

    failed = []
    cfg = cell.cfg
    cells = [r[f"lm_serve/{cell.arch}"] for r in ranks]
    c = cells[0]
    bar, fed, steps = want["bar"], cell.fed, cell.steps
    B, S = MESH_LM_BATCH, MESH_LM_SEQ
    one = np.asarray(want["tokens"])
    tokens = np.asarray(c["tokens"])
    same_fed = tokens[:, 1:fed + 1] == one[:, 1:fed + 1]
    free = tokens[:, fed + 1:] == one[:, fed + 1:]
    prefill_s = [round(x["prefill_s"], 4) for x in cells]
    decode_ms = [round(x["decode_s"] / steps * 1e3, 3) for x in cells]

    def per(calls, n=1):
        return ({k: round(v / n, 2) for k, v in calls["calls"].items()},
                {k: round(v / n / 1e6, 3) for k, v in calls["sent"].items()},
                round(calls["staged"] / n / 1e6, 3))

    pc, pm, ps = per(c["prefill_calls"])
    dc, dm, ds = per(c["decode_calls"], steps)
    launches = [(x["prefill_launches"], x["prefill_wgmma"],
                 x["decode_launches"]) for x in cells]
    n_prefill, n_decode = _b2_launches(cfg)
    wgmma = n_prefill and n_prefill * (K.route(
        "fwd", torch.bfloat16, _attention_dim(cfg)) == "wgmma")
    same = all(x["fingerprint"] == c["fingerprint"] for x in cells)
    padded = {x["model"]: x["padded"] for x in cells}
    print(f"mesh: serve {cfg.name} {_layers_of(cfg)}, {B} x {S} prompts, "
          f"cache {cell.cache} ({cell.cache // 2} slots a model rank), mesh "
          f"{MESH_TRAIN_SHAPE}: prefill s per rank {prefill_s} = "
          f"{B * S / max(prefill_s):.1f} tokens/s (one device "
          f"{want['prefill_s']:.4f} s), decode ms a step per rank "
          f"{decode_ms} = {B * 1e3 / max(decode_ms):.1f} tokens/s (one "
          f"device {want['decode_s'] / steps * 1e3:.3f}); a prefill: calls "
          f"{pc}, MB handed {pm}, MB staged {ps}; a decode step: calls {dc}, "
          f"MB handed {dm}, MB staged {ds}; peak memory a rank GB "
          f"{[round(x['peak'] / 1e9, 2) for x in cells]}; B2 launches a rank "
          f"(prefill, of them wgmma, decode) {launches}", flush=True)
    rels = ", ".join(f"{x:.2e}" for x in c["rel"])
    print(f"mesh: serve {cfg.name} logits vs one device, rel L2, prefill "
          f"then {fed} fed steps: max {max(c['rel']):.3e} ({rels}); bar "
          f"{bar:.3e}; the planted fault ({_serve_fault(cfg)[0]}) "
          f"{', '.join(f'{x:.3e}' for x in c['fault'])}; every rank's "
          f"joined logits and tokens equal {same}; padded columns a model "
          f"rank (count, all -1e30) {padded}; greedy tokens equal to one "
          f"device's: of the fed steps {int(same_fed.sum())} of "
          f"{same_fed.size}, of the free steps {int(free.sum())} of "
          f"{free.size}", flush=True)
    if max(c["rel"]) > bar:
        failed.append(f"{cell.arch} serve: logits {max(c['rel'])} > {bar}")
    if min(c["fault"]) <= bar:
        failed.append(f"{cell.arch} serve: the bar passes "
                      f"{_serve_fault(cfg)[0]}")
    if not same:
        failed.append(f"{cell.arch} serve: ranks disagree")
    if tokens.max() >= cfg.vocab or not all(p[1] for p in padded.values()) \
            or padded.get(1, (0,))[0] != cfg.padded_vocab - cfg.vocab:
        failed.append(f"{cell.arch} serve: padded columns {padded}")
    if any(x != (n_prefill, wgmma, n_decode * steps) for x in launches):
        failed.append(f"{cell.arch} serve: B2 launches {launches}")
    return failed


def _mesh_lm(cfg, arch):
    """The mesh LM cell of ``arch`` on this rank: its train step, then its
    serving (``_mesh_train``, ``_mesh_serve_lm``)."""

    cell = _mesh_lm_cell(arch)
    return {**_mesh_train(cfg, cell), **_mesh_serve_lm(cfg, cell)}


def _check_mesh_lm(ranks, want, arch):
    """The mesh LM cell of ``arch``'s checks and lines; returns the
    failures."""

    cell = _mesh_lm_cell(arch)
    return (_check_mesh_train(ranks, want["train"], cell)
            + _check_mesh_serve_lm(ranks, want["serve"], cell))


def phase_mesh(args, device, report, single=None) -> None:
    """Sharded Pregel and IMRU, the generic engine and serving, on
    MESH_RANKS ranks (the module docstring's phase 10b).  Inputs and
    oracles are made here and handed over in files; every rank returns its
    numbers, which are checked here.  ``single`` holds the generic and rows
    phases' single-device times from the same run, printed beside the
    generic cells, and the serve phase's dense-grid graph and answers,
    served again on the ranks."""

    import tempfile

    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse import csgraph

    from repro_torch.carry import graph_from_numpy
    from repro_torch.core.pregel import compile_pregel
    from repro_torch.launch.mesh import launch_ranks

    n_gpus = torch.cuda.device_count()
    backend = "nccl" if n_gpus >= MESH_RANKS and device.type == "cuda" \
        else "gloo"
    n, m = 1 << args.log2_vertices, 1 << args.sssp_log2_vertices
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        d = Path(tmp)
        src, dst = _webgraph(n, args.seed)
        np.save(d / "pr_src.npy", src)
        np.save(d / "pr_dst.npy", dst)
        np.save(d / "pr_oracle.npy",
                _webgraph_oracle(n, args.seed, args.supersteps, device.type))
        np.save(d / "pr_fault_oracle.npy",
                pagerank_oracle(src, dst, n, MESH_FAULT_SUPERSTEPS, device))
        src, dst = power_law_graph(m, WEBMAP_MEAN_OUT_DEGREE, args.seed + 1)
        np.save(d / "sssp_src.npy", src)
        np.save(d / "sssp_dst.npy", dst)
        np.save(d / "sssp_pr_oracle.npy",
                pagerank_oracle(src, dst, m, MESH_BUCKET_SUPERSTEPS, device))
        np.save(d / "sssp_pr_fault_oracle.npy",
                pagerank_oracle(src, dst, m, MESH_FAULT_SUPERSTEPS, device))
        source = int(np.bincount(src, minlength=m).argmax())
        A = sp.csr_matrix((np.ones(src.shape[0]), (src, dst)), shape=(m, m))
        bfs = csgraph.shortest_path(A, directed=True, unweighted=True,
                                    indices=source)
        np.save(d / "bfs.npy", np.where(np.isinf(bfs), 1e9, bfs))
        del A, bfs
        g = graph_from_numpy(m, src, dst, np.zeros(m, np.float32),
                             device=device)
        one = compile_pregel(_max_program(), g, device=device).run(
            max_iters=MESH_CC_SUPERSTEPS)
        np.save(d / "max_single.npy", one.state[0].cpu().numpy())
        del g, one, src, dst
        want_generic = _mesh_generic_inputs(args, d)
        want_serve = _mesh_serve_inputs(args, d, single)
        want_lm = {}
        for arch in MESH_LM_CELLS:
            want_lm[arch] = _mesh_lm_inputs(args, d, device, arch)
            torch.cuda.empty_cache()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"mesh: inputs and oracles in {time.perf_counter() - t0:.1f}s;"
              f" spawning {MESH_RANKS} ranks over {backend} on {n_gpus} "
              f"GPU(s)", flush=True)
        t1 = time.perf_counter()
        cfg = {"dir": tmp, "backend": backend, "device": device.type,
               "n": n, "m": m,
               "supersteps": args.supersteps, "source": source,
               "records": 1 << args.imru_log2_records, "seed": args.seed,
               "generic_n": args.generic_domain,
               "rows_n": 1 << args.rows_log2_vertices}
        ranks = launch_ranks(_mesh_rank, MESH_RANKS, cfg, store_dir=tmp,
                             backend=backend, timeout=MESH_TIMEOUT)
    r0 = ranks[0]
    per_gpu = MESH_RANKS / len({r["device"] for r in ranks})
    print(f"mesh: world {MESH_RANKS}, backend {backend}, transport "
          f"{r0['transport']}, {per_gpu:g} rank(s) a GPU, ranks ran in "
          f"{time.perf_counter() - t1:.1f}s; bytes staged a rank "
          f"{[r['staged_total'] for r in ranks]}")
    slowest = max((r["seconds"] for r in ranks),
                  key=lambda x: sum(x.values()))
    print(f"mesh: rank 0's cells in s {json.dumps(r0['seconds'])}; the "
          f"slowest rank's {json.dumps(slowest)}")
    failed = []
    cells = [("pagerank", n, args.supersteps)] + [
        (f"pagerank/{c}", m, MESH_BUCKET_SUPERSTEPS)
        for c in ("merging", "hash_sort")]
    for key, size, steps in cells:
        c = r0[key]
        launches = [r[key]["launches"] for r in ranks]
        second = " (the second: A10c's crash on rank 1)" \
            if key == "pagerank" else ""
        print(f"mesh: {key} n={size}, {steps} supersteps, {c['connector']} (plan "
              f"{c['notes'][-1]}), slab {c['slab']} edges a rank: "
              f"{c['ms']:.3f} ms/superstep (ranks "
              f"{[round(r[key]['ms'], 3) for r in ranks]}), B1 launches a "
              f"rank {launches}, bytes a rank a superstep "
              f"{ {k: int(v) for k, v in c['sent_per_superstep'].items()} }"
              f", staged {int(c['staged_per_superstep'])}; rel L1 vs "
              f"float64 {c['rel_l1']:.3e} (tol {PAGERANK_L1_TOL}), two runs "
              f"bit-identical {c['identical']}{second}, rank 1's sends "
              f"dropped at superstep "
              f"{MESH_FAULT_SUPERSTEPS - 2} of {MESH_FAULT_SUPERSTEPS}: rel "
              f"L1 {c['fault_rel_l1']:.3e}")
        if not (c["rel_l1"] <= PAGERANK_L1_TOL
                and all(r[key]["identical"] for r in ranks)
                and c["fault_rel_l1"] > PAGERANK_L1_TOL
                and min(launches) > 0
                and all(r[key]["rel_l1"] == c["rel_l1"] for r in ranks)):
            failed.append(key)
        if key == "pagerank" and c["connector"] != "dense_psum":
            failed.append(f"the planner chose {c['connector']}")
    for conn in ("merging", "hash_sort"):
        c = r0[f"max/{conn}"]
        print(f"mesh: max combine on {conn}, {MESH_CC_SUPERSTEPS} "
              f"supersteps: bit-equal to the single-device run {c['equal']}"
              f", {c['ms']:.3f} ms/superstep, B1 launches a rank "
              f"{[r[f'max/{conn}']['launches'] for r in ranks]}")
        if not all(r[f"max/{conn}"]["equal"] for r in ranks):
            failed.append(f"max/{conn}")
    for conn in ("dense_psum", "merging", "hash_sort"):
        c = r0[f"sssp/{conn}"]
        print(f"mesh: semi-naive SSSP n={m} on {conn}: equal to BFS "
              f"{c['equal']} in {c['iterations']} supersteps, "
              f"{c['ms']:.3f} ms/superstep, B1 launches a rank "
              f"{[r[f'sssp/{conn}']['launches'] for r in ranks]}, bytes "
              f"{ {k: int(v) for k, v in c['sent'].items()} }, staged "
              f"{c['staged']}, modes {c['modes']}")
        if not (all(r[f"sssp/{conn}"]["equal"] for r in ranks)
                and any(x.startswith("sparse@") for x in c["modes"])):
            failed.append(f"sssp/{conn}")
    bar, bar8 = r0["imru_bar"], r0["imru_int8_bar"]
    for k, c in r0["imru"].items():
        b = bar8 if k == "int8_ef" else bar
        print(f"mesh: imru {1 << args.imru_log2_records} x {IMRU_FEATURES} "
              f"on (2, 2) pod x data, {k}: {c['ms']:.3f} ms/iteration, "
              f"||m - m64|| {c['err']:.4e} (bar {b:.4e}), relative to flat "
              f"{c['vs_flat']:.3e}; plan {c['notes'][-1]}")
        if not (c["finite"] and c["err"] <= b):
            failed.append(f"imru/{k}")
        if k != "int8_ef" and c["vs_flat"] > MESH_SCHEDULE_RTOL:
            failed.append(f"imru/{k} vs flat")
    failed += _check_mesh_generic(ranks, want_generic, single or {}, args)
    failed += _check_mesh_ft(ranks, want_generic, args)
    failed += _check_mesh_serve(ranks, want_serve)
    for arch in MESH_LM_CELLS:
        failed += _check_mesh_lm(ranks, want_lm[arch], arch)
    if single is not None:
        single["mesh_lm"] = {
            arch: {"train": r0[f"lm_train/{arch}"]["zero1"][0]["launches"],
                   "prefill": r0[f"lm_serve/{arch}"]["prefill_launches"],
                   "decode": r0[f"lm_serve/{arch}"]["decode_launches"],
                   "kernels": want_lm[arch]["kernels"]}
            for arch in MESH_LM_CELLS}
    entry = next(e for e in report if e["name"] == "segment_combine") \
        if any(e["name"] == "segment_combine" for e in report) else None
    sites = [v for k, v in r0.items() if k.startswith("site/")]
    if entry is not None:
        entry["mesh_sites"] = sites
    if failed:
        raise AssertionError("mesh: " + "; ".join(failed))



def _attach_mesh_lm(report, single) -> None:
    """B2-B4's launches a rank in each mesh LM cell (a train step, a
    prefill, a decode step) and their checks and times at a rank's local
    shapes, on their report entries."""

    cells = single.get("mesh_lm", {})
    for e in report:
        if not e["name"].startswith("flash_"):
            continue
        key = {"flash_attention_fwd": 0, "flash_bwd_dq": 1,
               "flash_bwd_dkv": 2}[e["name"]]
        for arch, got in cells.items():
            shapes = []
            for k in got["kernels"]:
                if key == 0:
                    shapes.append({"serving": k["serve"], **(
                        {"training": k["fwd"]} if "fwd" in k else {})})
                elif "bwd" in k:
                    b = k["bwd"]
                    part = b["dq" if key == 1 else "dkv"]
                    shapes.append({"shape": b["shape"], **part,
                                   "max_abs_err": b["max_abs_err"],
                                   "library_ms": b["library_ms"]})
            e.setdefault("mesh_lm", {})[arch] = {
                "train_launches_per_rank_step": got["train"][key],
                **({"prefill_launches_per_rank": got["prefill"],
                    "decode_launches_per_rank": got["decode"]}
                   if key == 0 else {}),
                "local_shapes": shapes}


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
    ap.add_argument("--families-layers", type=int,
                    default=DEFAULTS["families_layers"],
                    help="cap on each family's depth (0: the stated depths)")
    ap.add_argument("--train-layers", type=int,
                    default=DEFAULTS["train_layers"])
    ap.add_argument("--train-seq", type=int, default=DEFAULTS["train_seq"])
    ap.add_argument("--families-train-layers", type=int,
                    default=DEFAULTS["families_train_layers"],
                    help="cap on each family's training depth (0: the "
                         "depths the memory reckoning gives)")
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
    timed = []
    single = {}
    seconds = {}
    for name, run in (
            ("kernels", lambda: phase_kernels(device)),
            ("pagerank", lambda: phase_pagerank(args, device, report)),
            ("sssp", lambda: phase_sssp(args, device)),
            ("imru", lambda: _freeing("imru",
                                      lambda: phase_imru(args, device))),
            ("generic", lambda: _freeing("generic",
                                         lambda: phase_generic(args, device,
                                                               single))),
            ("rows", lambda: _freeing("rows",
                                      lambda: phase_rows(args, device,
                                                         report, single))),
            ("ft", lambda: _freeing("ft", lambda: phase_ft(args, device))),
            ("chunks", lambda: _freeing("chunks",
                                        lambda: phase_chunks(args, device,
                                                             report))),
            ("serve", lambda: _freeing("serve",
                                       lambda: phase_serve(args, device,
                                                           report, single))),
            ("mesh", lambda: _freeing("mesh",
                                      lambda: phase_mesh(args, device,
                                                         report, single))),
            ("lm", lambda: phase_lm(args, device, report, timed)),
            ("families", lambda: _freeing(
                "families",
                lambda: phase_families(args, device, report, timed))),
            ("train", lambda: phase_train(args, device, report, timed)),
            ("families_train", lambda: _freeing(
                "families_train",
                lambda: phase_families_train(args, device, report, timed))),
            ("census", lambda: _freeing(
                "census", lambda: phase_census(args, device, timed)))):
        free, total = torch.cuda.mem_get_info()
        print(f"phase {name}: starts with {free} of {total} B free on the "
              f"card", flush=True)
        t0 = time.perf_counter()
        run()
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"phase {name}: {seconds[name]}s", flush=True)
    _attach_mesh_lm(report, single)
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
