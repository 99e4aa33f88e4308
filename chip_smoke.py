#!/usr/bin/env python3
"""Smoke run of the PyTorch port (torchpq_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # the full run, as below
    python3 chip_smoke.py --kernels-only  # phases 1-3 only, no result line
    python3 chip_smoke.py --parent DIR    # and, on each warp-specialised
        # block-scan row, DIR's csrc/block_scan_wg.cu (a checkout of the
        # parent tree) timed in turns with the row's route, its live keys
        # held equal; on each codes row DIR's block_scan_wg.cu codes
        # instance (keys held equal) and csrc/codes_scan_tc.cu; on each
        # narrow bf16 deep pack32 row DIR's csrc/block_scan_tc.cu, each
        # where DIR holds and takes it; on the pallas_flat plan's flat scan
        # DIR's csrc/flat_scan_tc.cu (its mma.sync kernel, at d <= 128 the
        # parent's route)

Phases, each of which fails the run on error:
  1. device: a CUDA card is required (no CPU continuation); prints its name
     and `nvidia-smi` name + power limit.
  2. build: compiles the kernels from `torchpq_tpu_torch/csrc` with nvcc;
     the ptxas report of the twenty-one warp-specialised instances
     (WG_KERNEL: block_scan_wg.cu, bf16 and int8, narrow and k-chunked,
     and the five codes instances) must show no spill and no stack frame,
     and each of them must hold warpgroup products (bf16 HGMMA,
     int8 IGMMA) and, but the codes ones (their producer decodes the
     window), UTMALDG instructions in its SASS (cuobjdump -sass; counts
     logged and in the kernels line); so must the warp-specialised flat
     scan (FLAT_WG_KERNEL: flat_scan_wg.cu, HGMMA and UTMALDG).
  3. kernel vs plain on seeded inputs: the bf16 block-scan kernel (the
     narrow warp-specialised instances, keys "tc_wgn_exact" /
     "tc_wgn_pack32", at d <= 128; pack32 above k_pair 16 the deep
     select, csrc/deep_select.cuh)
     against its plain PyTorch version (`block_scan_ref`) on the card
     (p_tile=128, d=128, s_eff 1024 and 2048, k_pair=10, 1024 blocks,
     bf16), both selects, live rows within tolerance and pad rows dead,
     with CUDA-event times of each, and bit for bit on integer-valued
     inputs with ties (d 128 at s_eff 640, pack32 also at k_pair 40 over
     512 strided groups, 64 over 512, 57 over 256 and 64 over 128, d 40 at
     s_eff 200, and d 1024 (256-byte k chunks) at s_eff 2048, exact and
     pack32 k_pair 10 and pack32 k_pair 40 and 64 over 512 groups, and d
     200 at s_eff 640, exact and pack32 k_pair 16, euclidean and inner: at
     d 1024 and 200 the warp-specialised route); on
     each of those inputs the CUDA-core block-scan kernel too, every row;
     then the warp-specialised route at d 200 and 384 (s_eff 640, k_pair
     10, 1024 blocks, 8 live probers a block and random liveness) within
     tolerance, pad rows dead, timed in turns with block_scan.cu (logged);
     then the f32-cache kernel (CUDA cores);
     then the tensor-core codes-scan kernels against `codes_scan_ref` (PQ64
     codes, s_eff 1024, 1024 blocks: the wgmma codes instances of
     block_scan_wg.cu), both selects, live rows within tolerance and pad
     rows dead, and bit for bit on integer-valued inputs with ties (PQ64,
     PQ8, PQ128 (two raw passes), the 4-bit byte pairs and PQ8 of dsub 9
     (a ragged second k half), euclidean and inner, exact k_pair 10 and
     16, pack32 k_pair 10 and 20 pass by pass, and the deep select at
     k_pair 40, 52 and 64 over 512 groups); on each
     of those inputs the CUDA-core
     codes kernel too, every row (bit for bit on integer inputs, equal
     exact values and >= 0.9999 of pack32 keys on random ones); then the
     block scan's int8 mode at d 128 and 1024 (random inputs) and 16, 128,
     272 and 1024 (ties) through both routes (the tensor-core one: the s8
     wgmma instances, narrow up to d 256, k-chunked above; on live rows
     with pad rows dead; the
     CUDA-core one on every row), both selects, bit for bit on random
     inputs and on `int8_tie_inputs` (equal rows, exact ties; pack32
     k_pair 40 over 128 groups, 5 tiles a phase, and 64 over 512 at d 128,
     2 tiles: the narrow deep instance; at d 1024 the k-chunked wgmma
     instance of four stages); the flat scan's three kernels (wgmma
     "flat_wg" at d 128, mma.sync "flat_tc" at d 1024, CUDA cores "flat")
     against `flat_scan_ref` (cap 262,144, 1,024 queries, the glue's head
     k=10 addresses equal outside ties), the wgmma one also at d 64 and
     128, r_keep 8, 16 and 32, the mma.sync one at d 1024, r_keep 16 and
     32 (values within tolerance, addresses equal outside ties), both on
     integer-valued inputs with ties (flat_wg at d 64 and 128, flat_tc at
     1024, euclidean and inner, r_keep 16; bit for bit); the row gather against
     `table[idx.clamp]` (f32, bf16, int8 tables, out-of-range indices, bit
     for bit).
  4. the slice: 1M x 128 manifold-12 base + 10k queries (the numpy draws of
     bench.py:make_data, seed 0), IVFPQIndex IVF4096 x PQ64 euclidean,
     trained on 100k; a second training on the same slice must give
     bit-equal codecs (sha256 logged: the Lloyd sums sort by label and
     sum each cluster in a fixed order), a third with the atomic sums
     times their cost, beside compute_centroids alone at 1M x 128 into
     4096 clusters and the first call of each deterministic route;
     filled in four 250k adds, the planner's sweep (phase 25) after each
     of the first three; exact f32 ground truth on the card; searches:
     flat, cell_major at n_probe 1/8/32 (pack32 select), cell_major at
     n_probe 8 (exact select). Launch counters are zeroed before the last
     add and read after these searches; every kernel of the path must
     have launched (the tensor-core block scan's two selects, and the row
     gather, which builds the compacted layouts) and the CUDA-core block
     scan never. Floors: flat recall@10 >= 0.85, n_probe=32 >= 0.75,
     recall non-decreasing in n_probe within 0.005. Then a small-input
     check: the probed exact plan over every cell equals the flat exact
     plan. Then the planner's sweep at 1M, and the small-index one (the
     main codecs, the base's first 20k and 100k rows).
  5. kernel vs plain at the main path's shapes: the block-scan arguments of
     the exact n_probe=8 and pack32 n_probe=32 searches, each checked with
     both selects (the tensor-core kernel on live rows, pad rows dead; the
     CUDA-core one on every row); the select each search ran timed on both
     kernels in turns (TFLOP/s over live probers and over live 16-prober
     tiles); the tensor-core times go into the kernels' JSON line, the
     CUDA-core ones beside them.
  6. relayout: the same trained codecs in an index with a quarter of the
     cell capacity, filled by the same adds, must relayout and then hold
     and find what the main index holds and finds.
  7. code-domain slice: an index with scan_cache_dtype="none" (codes and
     norms only) takes the same trained codecs and the same four adds; no
     decoded store may exist, and its bytes are logged beside the main
     index's cache. The codes-scan launch counters are zeroed, then the same
     plans run (flat = decode-on-the-fly sweep; probed = the codes kernel)
     with the same floors; the exact n_probe=8 result must equal the main
     index's, and the flat result must agree with the main flat result
     (ids >= 0.99, recall within 0.005: the codes sweep rounds the query to
     bf16). Both selects must have launched on the wgmma codes instances
     ("tc_wgn_exact" / "tc_wgn_pack32") and no other codes route. Then, on the codes-scan arguments of the
     exact n_probe=8 and pack32 n_probe=32 searches, the tensor-core kernel
     against `codes_scan_ref` and against the tensor-core block-scan
     kernel over the decoded bf16 rows (live rows, tolerances; pad rows
     dead), the
     CUDA-core codes kernel against `codes_scan_ref` (every row, equal
     exact values, pack32 keys >= 0.9999), and the search's own select
     timed on both codes kernels in turns (with --parent, the parent's
     block_scan_wg.cu codes instance in turns too, keys held equal).
  8. int8 tier: an index with scan_cache_dtype="int8" takes the same
     trained codecs and adds; device bytes logged; the block scan's
     counters zeroed, the five plans run (every plan's recall@10 within
     0.005 of the bf16 tier's; both selects of the narrow s8 wgmma
     instances must launch, "tc_wgn_int8_exact" / "tc_wgn_int8_pack32",
     no other int8 key); then both int8 kernels against the plain version
     on the int8 searches' own arguments (exact n_probe 8, pack32 n_probe
     32), bit for bit (the tensor-core one on live rows, pad rows dead),
     and the select each search ran timed on both in turns (TOP/s over
     live probers and live 16-prober tiles).
  9. deep-k: the JAX package's k = 100 configuration
     (benchmark/results/ivf4096_pq64_sift1m_deepk_r6_g8c64kp64t8_16.json:
     spill 8 cells at capacity 2 x n / n_cells = 512, supercells of 8, a
     cap of 64 per query, k_pair 64, the merge taper (8, 16) run as the
     split, n_probe 128, 10k queries) on the main index's codecs and adds,
     each add's spill routing held to its rule; the block-scan counters
     zeroed before the r6 plan's searches and read after: the split's head
     (pack32 k_pair 64 over 512 strided groups) and its tail (pack32
     k_pair 16) must both launch the tensor-core kernel, the CUDA-core one
     never; `LAST_GATE` must show super-probe, split (8, 16) and s_eff 4096
     on both sides; the same for the untapered plan (no supercells, cap or
     taper: pack32 k_pair 64 over 256 groups at s_eff 512), whose
     recall@100 against exact f32 ground truth the r6 plan's must come
     within 0.03 of, the flat plan's logged; the three scans against
     `block_scan_ref` on their searches' own arguments (live rows, key
     agreement >= 0.99, or slot agreement where the plain version's own
     keys agree with an f64-summed select's on fewer than 0.99; pad rows
     dead; the CUDA-core kernel on every row), each timed in turns with
     the CUDA-core kernel and beside the same tensor-core launch writing
     one key per row.
 10. 4-bit PQ: the JAX package's record
     (benchmark/results/ivf4096_pq64_sift1m_pq4.json): the main VQ codec,
     a 16-cluster PQ trained on the 100k train slice, n_bits 4 (32 code
     bytes per slot), the bf16 cache, spill 8 cells at 3 x n / n_cells,
     scan_group 4, four adds; pack32 at n_probe 1/8/32/128 for k = 10 and
     k = 100 (n_probe 1 at k = 100 on the plain select, as in the JAX
     package), exact at n_probe 8, flat; the block-scan counters zeroed
     before, only the tensor-core selects after; recall rising with
     n_probe; the all-cells probe against the flat sweep; the pack32 scans
     at n_probe 32 (k = 10, and k = 100: k_pair 64 over 512 groups, the
     deep select) against `block_scan_ref` on their searches' own
     arguments, timed in turns. Then the code domain at 4 bits (pack group 4, no spill or
     supercells): its plans must launch only the wgmma codes instances
     (32 byte pairs over the byte-pair codebook, dsub 4); a 4-bit bf16
     index of the main layout runs the slice's plans, each recall@10 below
     the 8-bit tier's, and holds the code domain's exact n_probe 8 and flat
     results; the codes kernels on the code domain's own arguments, as in
     phase 7; device bytes per slot logged (36 B against 68 B).
 11. residual PQ: the JAX package's record
     (ivf4096_pq64_residual_sift1m_residual.json): the main VQ codec, a PQ
     trained on the train slice's residuals, the main phase's settings,
     four adds; pack32 at n_probe 1/8/32/128 for k = 100 and k = 10, exact
     at n_probe 8, flat; tensor-core launches only; 4,096 sampled cache
     rows equal bf16(centroid[cell] + PQ decode) bit for bit; the
     reconstruction error on the train slice below the main index's; the
     all-cells probe against flat; the k = 100 pack32 scan (k_pair 64)
     against `block_scan_ref` on its search's own arguments, timed in
     turns.
 12. IVFPQR, cached bf16 tier: the JAX package's record
     (benchmark/results/ivf4096_pq64r32_sift1m_pqr3.json, built as
     benchmark/sweep.py:112-127 builds it): the main codecs and a PQ32
     rerank trained on the train slice's second-stage residuals, rerank
     multiplier 4, the cache rows the full two-stage reconstruction, spill 8
     cells at 2 x n / n_cells, scan_group 4, four adds; pack32 at n_probe
     1/8/32 and flat for k = 10 (with an exact n_probe 8 plan) and k = 100,
     the block-scan counters zeroed before and read after (tensor-core keys
     only; n_probe 1 at k = 100 on the plain select); the flat recall@10
     above the main index's; the all-cells probe against flat; the pack32
     scans at n_probe 32 (k_pair 10 and 64) held to block_scan_ref on their
     searches' own arguments and timed in turns with block_scan.cu; the
     exact select at scan_group 1 (the code domain's cells); a forced
     relayout (expand) keeps the exact and flat searches.
 13. IVFPQR, code domain (the record's _codes twin: scan_cache_dtype
     "none", initial_mult 3): flat and pack32 n_probe 8/32 at k = 10 (the
     base codes scan at k' 40) and k = 100 (k' 400: k_pair 64 / 52, the
     deep select), each plan's codes-scan counters zeroed before and read
     after: the wgmma codes instances only ("tc_wgn_pack32") at both k;
     recall within 0.02 of
     the cached tier's exact select over the same cells (its pack32 plans
     over supercells logged beside); the n_probe 32 scans and the k = 100
     n_probe 8 one held to codes_scan_ref on their own arguments (live
     rows, pad rows dead) and timed in turns with the CUDA-core
     codes_scan.cu (and, with --parent, the parent's sorted mma.sync
     codes_scan_tc.cu, its share of equal live keys logged); both k = 100
     plans profiled.
 14. FlatIndex at 1M x 128 f32 (the slice's base and 10k queries), k = 10
     and 100, at the search precision "highest" (IEEE f32, the exact
     index): ids against the exact ground truth (>= 0.999), ms per batch
     and device bytes; then a seeded 10% removed and 1,000 queries held to
     the survivors' exact ground truth. Then the precision phase (14b):
     util.matmul on the card on the slice's operands (1,024 queries
     against the coarse centroids and against 65,536 base rows, f32, and
     the bf16 query against bf16 cache rows): "default" within the f32
     summation bound of an f64 product of the bf16-rounded operands, "high"
     within the bf16_3x bound of the f64 product, "highest" bit-equal to
     the f32 product, each mode within the bound of its plain version;
     then at each precision (search precision set, then restored) the
     coarse GEMM's ms (CUDA events), the 1M x 128 bf16 index's flat plan
     and cell_major n_probe 32 (ms, recall@10; the flat plan profiled for
     its GEMMs' device ms) and a 1M x 128 f32 FlatIndex's 10k-query
     search; at "default": flat recall@10 >= 0.85 and n_probe 32 >= 0.75,
     the flat plan's ids >= 0.99 equal to "highest"'s, FlatIndex ids
     >= 0.999 equal to an f32 sweep of the bf16-rounded operands (its
     recall against the f32 truth logged).
 15. transforms and SQ at 100k x 128, card against CPU from the same
     carried state (at the search precision "highest": the CPU computes
     f32 at every precision): OPQ (PQ16) -> IVFPQIndex, PCA 128 -> 64 ->
     FlatIndex, an 8-bit SQCodec round trip.
 16. anisotropic PQ and manhattan, at 100k x 128 (no kernel on these
     paths): the card's `_aniso_refine` (eta 4, 8 iterations, from the
     main PQ codebook) and `_aniso_assign` on the 100k rows, then both on
     the card and on the CPU over 10,000 rows (labels >= 0.999 equal,
     refined centroid entries >= 0.99 within 1e-3 + 1e-3 |c|); an IVF256
     x PQ64 manhattan index, 1,000 queries: pack32 at n_probe 8 and flat,
     recall@10 against exact L1 logged, the all-cells probe against flat,
     the block and codes scan counters at 0 (zeroed before).
 17. GIST-class int8 tier: 1M x 960 manifold-12 data (make_data, seed 1),
     IVF4096 x PQ64, int8 cache 1024 wide, 10k queries, k=10; plans flat,
     pack32 at n_probe 8 and 32, exact at n_probe 8 (counters zeroed
     before; both selects of the k-chunked s8 wgmma instances must launch,
     "tc_wg_int8_exact" / "tc_wg_int8_pack32", no other int8 key); floors:
     recall
     non-decreasing in n_probe within 0.005, the flat plan within 0.02 of
     an exact f32 sweep over the same PQ-decoded rows; then both int8
     kernels on the phase's own arguments, as in phase 8 (fewer repeats).
     Then the JAX package's two GIST records at their settings
     (ivf4096_pq64_gist1m_class_r3.json, bf16 cache, and
     ivf4096_pq64_gist1m_int8_r5.json, int8 cache) on the same trained
     codecs: the same adds into each tier with spill 8 cells at 2 x n /
     n_cells (512 slots), scan_group 4; per tier flat, pack32 n_probe 8 /
     32 and exact n_probe 8 at k = 10, pack32 n_probe 8 / 32 at k = 100,
     the block-scan counters zeroed before each set and read after (the
     tensor-core keys only: chip_smoke fails if a CUDA-core key
     launches); each pack32 plan's LAST_GATE at s_eff 2048 with k_pair 10
     / 64; recall non-decreasing in n_probe (within 0.005), each flat plan
     within 0.02 of the exact sweep over its tier's PQ-decoded rows, int8
     within 0.005 of bf16 per k = 10 plan, recall@100 logged; the bf16
     record's flat plan timed at the search precisions "default" and
     "highest" in turns (logged); the bf16 scans run the warp-specialised
     route (keys "tc_wg_exact" / "tc_wg_pack32": they must launch); the
     bf16 exact scan
     (n_probe 8) held to block_scan_ref within the tolerance and
     its pack32 scans at k = 10 and k = 100 (k_pair 64 over 512 groups,
     a ring of four stages; n_probe 32) to an f64-summed select by key or
     slot as in phase 9, and block_scan.cu to it by slot, the tensor-core
     scans' values within the tolerance (their ratio to it logged), those
     of block_scan.cu's one sequential chain within the tolerance plus the
     bound of an f32 sum of their terms (sum_slack: the scores cancel),
     each timed in turns with block_scan.cu; the int8 k = 100 scan bit for
     bit,
     timed the same way; both tiers profiled.
 18. fused flat scan: the main index with scan_impl="pallas_flat" and
     approx top-k; the flat counters zeroed, the flat plan must launch the
     warp-specialised flat kernel ("flat_wg") and no other, agree with the
     exact flat plan on >= 0.98 of ids and lie within 0.01 of its recall
     (the kernel's bucket top-2 approximation); both timed in this call;
     then the kernel against `flat_scan_ref` on the plan's own arguments
     (head-k addresses equal outside ties), timed in turns with the
     CUDA-core kernel on the same arguments and, with --parent, with the
     parent's flat_scan_tc.cu (TFLOP/s and share of the bound), beside a
     yardstick of the product alone (bf16 torch.matmul over a 65,536-slot
     slice, scaled to the cache) and of the kernel at half the width (the
     same epilogue, half the products).
 19. profile: torch.profiler over one search per plan of the bf16, code
     domain and int8 indexes, the deep-k r6 and untapered plans and the
     pallas_flat flat plan (phases 10-13 profile their own plans);
     device-busy time and the largest kernels of each, and how many of
     the host's kernel launches the profiler recorded; a session that
     records no kernel is run again, and a third such session fails the
     run. The pallas_flat plan's profile comes right after phase 4 and
     must record every kernel launched (later in a run the card's
     profiler drops the first records of each session, its flat kernel
     among them).
 20. native (timed, as are 21-24, through profiling.PhaseTimer): the 1M
     base written as .fvecs and read back by read_fvecs and in 250k-row
     chunks by stream_vecs, bit-equal, through the C++ route (MB/s
     logged); the deep-k phase's spill (8 cells at 512) over the four adds
     through the device route and through spill_impl="host", each host
     add's cells equal to the numpy greedy's on the same top matrix and
     occupancy, no cell above the capacity; add s of both routes.
 21. presize: on an empty index of the main layout (16 slots a cell), a
     counting pass routes the 1M rows through the host greedy (8 cells at
     2 x n / n_cells) in the adds' chunks; expand(required, exact=True);
     the four adds with the same spill: capacities multiples of 16 (of 128
     from 128 up), unchanged by the adds (no relayout), the cell sizes the
     counting pass's.
 22. legacy: the v1 IVFPQ facade at 100k x 128 (IVF256 x PQ64, the
     CPU-RAM SQ tier on) trained on the card, its state carried into a CPU
     facade, the same adds: 1,000 queries at n_probe 8, cell_major pinned
     on both, at the search precision "highest", ids >= 0.999 equal; the
     SQ reconstructions within 0.05.
 23. dp k-means (inside 24's NCCL world): data_parallel_kmeans_fit on the
     100k train slice to 4096 clusters, 10 iterations, D = 1, timed beside
     a plain Lloyd loop from the same initial rows; both again under
     torch.use_deterministic_algorithms within 1e-3 (relative Frobenius).
 24. sharded: the bf16, int8 and code-domain indexes through
     ShardedIVFPQSearcher at D = 1 (a NCCL world of one, this process) and
     D = 2 (two processes of this script, --sharded-rank, over gloo on
     the same card, loading the three indexes this process saved as
     .npz): the bf16 plans (pack32 n_probe 8 / 32, exact n_probe 8, flat)
     and one pack32 n_probe 32 plan per other tier, each tier's counters
     zeroed before and read after (the tensor-core keys only), held to the
     single-device search on the same uncompacted layout (exact plans
     ids equal outside ties within the compare_topk tolerance, pack32
     ids >= 0.99, recall@10 within 0.005), both ranks' results equal; the
     block scan (exact n_probe 8, pack32 n_probe 32, int8 pack32) and the
     codes scan (pack32) held to their plain versions on the arguments a
     rank's local scan gives them (its shard's uncompacted layout and
     shard-local cell tables; at D = 2 rank 0's), as phases 5, 7 and 8 hold
     them (tensor-core kernel on live rows, pad rows dead, CUDA-core one on
     every row, the int8 scans bit for bit), and timed there; the
     all_gather + merge ms; an add of 100k seeded near-duplicate rows and
     a remove of 10% of them, then the exact plan, against the same on the
     single-device index; at D = 1, one search in profiling.trace under
     a named_scope (the scope and the card's kernels must be in the
     trace) and the sharded and single-device plans profiled.
 25. planner (run after phase 19, before 20-24): the points the sweeps
     timed (time_plans' clock: a warm-up, then the median of 3 host-clock
     searches) on the 1M x 128 index at 250k / 500k / 750k / 1M items, its
     code-domain and int8 tiers, the small index, the GIST bf16 record,
     pqr3 and the deep-k r6 plan: per k (10, 100) the flat plan, then
     cell_major at n_probe 1, 2, 4, ... up to n_cells / 4 with approx on
     and off (a series ends after the first point slower than flat whose
     select the next n_probe keeps), and the batch axis (nq 1, 16, 64, 256, 1024:
     flat, cell_major and, for bf16 caches, query_major). Each point's
     plan ms, the plan "auto" picks on the card, the JAX package's rule's
     pick on the same shadows and the fastest; the constants fitted to
     this call's points (fit_planner) beside the shipped table; the cases
     the JAX rule sent to the flat sweep (auto's plan and ms before and
     after). Prints the planner JSON line; fails where auto's plan at a
     point of the 1M, GIST, pqr3 or deep-k indexes is more than 2x slower
     than the fastest plan timed there, and lists the points at 1.25-2x
     and those near a crossover without failing.
 26. prints the kernels' JSON line (every kernel: launches on its path,
     kernel and plain ms, the bound from the inputs' own counts, the
     library call's ms where one PyTorch call computes the same, the share
     of the bound it reaches; the int8
     block scan at both widths, the 1M x 128 tier's and the GIST-class
     d = 1024 one's, and the GIST records' bf16 exact, pack32 and pack32
     k = 100 and int8 pack32 k = 100 scans at d_cache 1024 (on the
     warp-specialised route, as every bf16 and int8 block-scan row is: its
     launch key, the instance and its SASS counts of HGMMA or IGMMA and
     UTMALDG; with --parent, the parent's block_scan_wg.cu times in turns
     on every such row and codes row, its mma.sync times on the narrow
     bf16 deep rows and codes rows it takes); the
     deep-k
     split's head and tail scans and the
     untapered plan's scan; the 4-bit tier's pack32 block scans (k = 10
     and 100) and both
     codes scans, the residual tier's k = 100 pack32 block scan, the IVFPQR
     tiers' two block scans and two codes scans; each row's launches on
     the sharded path, per rank at D = 1 and 2; and the four sharded scans'
     rows of phase 24 at D = 1 and 2, names *_sharded_d1 / *_sharded_d2),
     the card line, and the result line.

Imports nothing of JAX or of the JAX package.
"""

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TOL_REL = 1e-3  # bf16 products are exact in f32; only summation order differs
TOL_ABS = 1e-3
# an f32 rounding unit wide enough for accumulators that truncate: what
# sum_slack allows a k-chunked (d > 128) score for each term it sums
F32_UNIT = 2.0 ** -23


# the deep codes instance (block_scan_wg.cu's codes instance of pack32
# k_pair 33-64, the deep select on three ring stages, one query buffer),
# by the name kernel_name gives its mangled one
DEEP_CODES_KERNEL = "block_scan_wg_kernelILb1ELi64ELi3ELi1ELb0ELb1E"
# block_scan_wg.cu's twenty-one warp-specialised instances (<PACK, KMAX,
# ring stages, query buffers, int8, codes>: bf16 and int8 alike over
# k-chunked rows exact 10 / 16 on 5 / 4 stages, pack32 up to k_pair 16 on 6
# (KMAX 16, passes) and, the deep select (KMAX 64, csrc/deep_select.cuh),
# above on 4; over narrow rows (at most 256 bytes) exact 10 / 16 on 6 / 5,
# pack32 on 8 (int8: 7) and, above k_pair 16, the deep select on 5, each
# with two query buffers; the codes instances, one query buffer, exact 10
# / 16 on 3 stages, pack32 on 5, 17-32 (passes) on 4 and, above, the deep
# select on 3), whose ptxas reports must show no spill and no stack frame
# and each of which must hold warpgroup products (bf16: HGMMA; int8,
# template argument I8 = true: IGMMA, the integer form) and, but the codes
# ones (CODES = true, the last argument: the producer decodes the window),
# TMA loads (UTMALDG) in its SASS
WG_KERNEL = re.compile(r"block_scan_wg_kernelI\w*E$")
N_WG_KERNELS = 21
WG_OPS = ("HGMMA", "IGMMA", "UTMALDG")
# the warp-specialised flat scan (flat_scan_wg.cu): one kernel, which must
# report no spill and no stack frame and hold warpgroup products (HGMMA) and
# TMA loads (UTMALDG) in its SASS
FLAT_WG_KERNEL = re.compile(r"flat_scan_wg_kernel$")
FLAT_WG_OPS = ("HGMMA", "UTMALDG")
# the codes routes: the wgmma codes instances (block_scan_wg.cu) that the
# code-domain, 4-bit and pqr3_codes plans must take
CODES_WG_KEYS = ("tc_wgn_exact", "tc_wgn_pack32")


# sessions profile_search runs before it fails the run: the card's profiler
# at times drops all of a session's kernel records, twice in a row in one
# run
PROFILE_TRIES = 3


def wg_ops(fn):
    """The SASS ops a warp-specialised instance must hold."""
    if FLAT_WG_KERNEL.search(fn):
        return FLAT_WG_OPS
    if fn.endswith("Lb1E"):  # codes
        return ("HGMMA",)
    return ("IGMMA" if fn.endswith("Lb1ELb0E") else "HGMMA", "UTMALDG")


def codes_source(route):
    """The source of a codes-scan route's kernel."""
    return "torchpq_tpu_torch/csrc/" + (
        "block_scan_wg.cu" if route.startswith("tc_wgn_") else
        "codes_scan.cu")


# per instance: its SASS counts of WG_OPS (main, from cuobjdump)
SASS = {}

# the card's data-sheet rates (H100 SXM, dense): HBM bytes/s and the
# tensor-core peak of each operand type, for the kernels' bounds
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 495e12}


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def make_data(n_base, n_query, d, seed=0, d_int=12):
    """The manifold branch of bench.py:make_data (spectrum="manifold-12"),
    same draws in the same order: x = z W + 0.02 eps."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_int, d)).astype(np.float32) / np.sqrt(d_int)

    def msample(n):
        out = np.empty((n, d), np.float32)
        chunk = max(1, (1 << 25) // d)
        noise = np.empty((chunk, d), np.float32)
        for i in range(0, n, chunk):
            j = min(i + chunk, n)
            z = rng.standard_normal((j - i, d_int), dtype=np.float32)
            np.matmul(z, w, out=out[i:j])
            nz = noise[: j - i]
            rng.standard_normal(dtype=np.float32, out=nz)
            nz *= 0.02
            out[i:j] += nz
        return out

    return msample(n_base), msample(n_query)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def kernel_name(mangled):
    """A kernel's name and template arguments from its mangled name: the
    length-prefixed identifier that ends in "_kernel", and what follows it
    up to the end of the template argument list."""
    for i in range(len(mangled)):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            continue
        start = i + m.end()
        name = mangled[start:start + int(m.group(0))]
        if name.endswith("_kernel"):
            args = re.match(r"I\w*?E(?=E)", mangled[start + len(name):])
            return name + (args.group(0) if args else "")
    return mangled[:80]


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops, nbytes, peak):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ops over the peak rate and bytes over the HBM rate."""
    t_ops, t_bytes = ops / PEAK_OPS_S[peak], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def scan_bound(torch, args, kw, *, slot_bytes, row_bytes, peak, d,
               extra_bytes=0):
    """Bound of a block scan (bf16 / int8 / codes) on its own arguments:
    2 * s_eff * d operations per live prober; bytes: the unique cache slots
    the windows cover (slot_bytes each), the live query rows (row_bytes
    each), the block arrays, the output, and extra_bytes (a codebook)."""
    probers, start_c = args[1], args[2]
    s_eff = kw["s_eff"]
    width = kw["k_pair"] if kw["pack32"] else 2 * kw["k_pair"]
    live = int((probers >= 0).sum())
    cap_total = args[5].shape[0]
    cover = torch.zeros(cap_total, dtype=torch.bool, device=probers.device)
    cover[(start_c.long()[:, None] + torch.arange(
        s_eff, device=probers.device)[None]).reshape(-1)] = True
    queries = int(torch.unique(probers[probers >= 0]).numel())
    nbytes = (int(cover.sum()) * slot_bytes + queries * row_bytes
              + probers.numel() * 4 + start_c.numel() * 12
              + probers.numel() * width * 4 + extra_bytes)
    return bound(2.0 * live * s_eff * d, nbytes, peak)


def compare_exact(torch, bs, got, ref, k, rel=TOL_REL, abs_=TOL_ABS,
                  slack=None, ratio=False):
    """Values within rel * |v| + abs_ (+ slack, where given: sum_slack);
    addresses equal wherever a value is separated from its neighbours by
    more than rel * |v| (+ slack) (rel = abs_ = 0: equal values, equal
    addresses outside exact ties)."""
    return compare_topk(torch, bs.sortable_i32_to_f32(got[..., :k]),
                        got[..., k:], bs.sortable_i32_to_f32(ref[..., :k]),
                        ref[..., k:], rel, abs_, slack, ratio)


def sum_slack(torch, args, euclidean, rows, probers, sides):
    """What f32 arithmetic may leave of an exact score c <q, y> - pen over
    a d-wide bf16 row, in any summation order: sides * (d + 2) * F32_UNIT *
    (c |q| |y| + |pen|) per entry, the forward error bound of a sum of
    d + 2 terms (Higham, Accuracy and Stability of Numerical Algorithms,
    2nd ed., eq. 3.5; bf16 products are exact in f32, and
    sum_i |q_i y_i| <= |q| |y|). At d_cache 1024 the score cancels
    (2 <q, y> ~ |y|^2 ~ 1e3 on the GIST-class data), so a score near 0
    carries an error far above TOL_ABS in every order, the plain
    version's too. rows / probers: the cache rows and the query ids of the
    entries (same shape; pad probers and dead rows clamped to 0, whose
    entries are dead or scored with query 0 on both sides). sides: 2
    between two f32 scores, 1 against the f64-summed one."""
    def norms(t, chunk=1 << 17):
        return torch.cat([t[i:i + chunk].float().norm(dim=1)
                          for i in range(0, t.shape[0], chunk)])

    rows = rows.clamp(min=0).long()
    terms = (2.0 if euclidean else 1.0) \
        * norms(args[0])[probers.clamp(min=0).long()] \
        * norms(args[6])[rows] + args[5][rows].abs()
    return sides * (args[6].shape[1] + 2) * F32_UNIT * terms


def log_slack(what, err, tol, slack, mask):
    """The entries that only the f32 summation bound (sum_slack) admits."""
    beyond = mask & (err > tol - slack)

    def most(r):
        return float(r[mask].max()) if bool(mask.any()) else 0.0

    log(f"{what}: {int(beyond.sum())} of {int(mask.sum())} compared values "
        f"beyond {TOL_REL:g} |v| + {TOL_ABS:g}, each within the f32 "
        f"summation bound (largest error / tolerance {most(err / tol):.4f}; "
        f"against {TOL_REL:g} |v| + {TOL_ABS:g} alone "
        f"{most(err / (tol - slack)):.4f})")


def worst(err, tol, v, vr):
    """The entry furthest outside its tolerance, for a failure message."""
    i = int((err - tol).flatten().argmax())
    return (f"{float(err.flatten()[i]):.6g} at {float(v.flatten()[i]):.6g} "
            f"(plain {float(vr.flatten()[i]):.6g}, tolerance "
            f"{float(tol.flatten()[i]):.6g})")


def log_ratio(what, err, tol, mask):
    """The largest error over its tolerance TOL_REL |v| + TOL_ABS."""
    r = float((err / tol)[mask].max()) if bool(mask.any()) else 0.0
    log(f"{what}: {int(mask.sum())} compared values, largest error / "
        f"({TOL_REL:g} |v| + {TOL_ABS:g}) {r:.4f} (no f32 summation bound)")


def compare_topk(torch, v, a, vr, ar, rel=TOL_REL, abs_=TOL_ABS, slack=None,
                 ratio=False):
    """compare_exact on sorted values v / vr and their addresses a / ar;
    ratio: log the largest error over the tolerance."""
    fin = torch.isfinite(vr)
    if not torch.equal(fin, torch.isfinite(v)):
        fail("exact select: dead entries differ from the plain version")
    err = torch.where(fin, (v - vr).abs(), 0.0)
    tol = rel * vr.abs() + abs_ + (0.0 if slack is None else slack)
    if bool((err > torch.where(fin, tol, 1.0)).any()):
        fail(f"exact select: values off by up to {float(err.max())}; worst "
             f"{worst(err, torch.where(fin, tol, 1.0), v, vr)}")
    if slack is not None:
        log_slack("exact select", err, tol, slack, fin)
    elif ratio:
        log_ratio("exact select", err, tol, fin)
    # addresses must agree wherever the value is separated from its
    # neighbours by more than the tolerance (else the order may swap)
    gap = rel * vr.abs() + (0.0 if slack is None else slack)
    left = torch.ones_like(fin)
    left[..., 1:] = (vr[..., :-1] - vr[..., 1:]).abs() > gap[..., 1:]
    right = torch.zeros_like(fin)  # the k-th may tie with the (k+1)-th
    right[..., :-1] = (vr[..., :-1] - vr[..., 1:]).abs() > gap[..., :-1]
    sep = left & right & fin
    if bool((a != ar)[sep].any()):
        fail("exact select: addresses differ at separated values")
    return float(err.max())


def share_equal(a, b):
    """Share of equal entries, counted exactly (a float32 mean of millions
    of ones is not exactly 1)."""
    return int((a == b).sum()) / a.numel()


def compare_pack32(torch, bs, got, ref, slot_mask, what="pack32 select",
                   by_slot=False, slack=None, ratio=False):
    """pack32 keys of a kernel against the plain version's: the values
    within TOL_REL |v| + TOL_ABS (+ slack, where given: sum_slack)
    wherever both name the same slot, and >= 0.99 of the entries agreeing,
    as whole keys or (by_slot) as slots, whose values the first check then
    holds to the tolerance (where a key's value bits are finer than any f32
    summation order keeps them: pack32_scan_row). Returns (max_abs_err, key
    agreement)."""
    agree = share_equal(got, ref)
    same_slot = (got & slot_mask) == (ref & slot_mask)
    v = bs.sortable_i32_to_f32(got & ~slot_mask)
    vr = bs.sortable_i32_to_f32(ref & ~slot_mask)
    err = torch.where(same_slot, (v - vr).abs(), 0.0)
    tol = TOL_REL * vr.abs() + TOL_ABS + (0.0 if slack is None else slack)
    if bool((err > tol).any()):
        fail(f"{what}: equal slots, values off by up to {float(err.max())}; "
             f"worst {worst(err, tol, v, vr)}")
    if slack is not None:
        log_slack(what, err, tol, slack, same_slot)
    elif ratio:
        log_ratio(what, err, tol, same_slot)
    held = share_equal(got & slot_mask, ref & slot_mask) if by_slot \
        else agree
    if held < 0.99:
        fail(f"{what}: {'slot' if by_slot else 'key'} agreement "
             f"{held:.4f} < 0.99")
    return float(err.max()), agree


def dead_rows(torch, bs, got, probers, k_pair, pack32):
    """Whether every pad row (prober -1) of `got` is dead: pack32 INT_MIN;
    exact sortable(-inf) keys and -1 addresses."""
    pad = got[probers < 0]
    if pack32:
        return bool((pad == torch.iinfo(torch.int32).min).all())
    neg = bs.sortable_i32(torch.full((1,), -torch.inf, device=got.device))
    return bool((pad[:, :k_pair] == neg).all()) and \
        bool((pad[:, k_pair:] == -1).all())


def block_launch(torch, bs, args, route, **kw):
    """The block scan's kernel of `route` on args, without counting a
    launch: the comparisons with the plain version and the times in
    turns."""
    from torchpq_tpu_torch import _build
    return bs.launch(_build.library(), torch.cuda.current_stream().cuda_stream,
                     *args, route=route, **kw)


def compare_rows(torch, bs, got, ref, *, k_pair, pack32, slot_mask, equal,
                 exact_bits, what, by_slot=False, slack=None, ratio=False):
    """Rows of a block-scan kernel against the plain version's; fails the
    run on disagreement. equal: bit for bit (integer inputs, every sum
    exact in any order); exact_bits: exact values equal, and pack32 keys
    agree on >= 0.9999 of entries (the plain version's batched GEMM may sum
    in another order on some chunks, which moves a key's low value bits);
    else the tolerances of compare_exact / compare_pack32 (by_slot as
    there; slack: sum_slack's, per entry of ref; ratio: log the largest
    error over the tolerance). Returns (max_abs_err, key agreement)."""
    if equal:
        if not torch.equal(got, ref):
            fail(f"{what} differs from block_scan_ref on integer inputs: "
                 f"{share_equal(got, ref):.6f} of entries equal")
        return 0.0, (1.0 if pack32 else None)
    if pack32:
        err, agree = compare_pack32(torch, bs, got, ref, slot_mask, what,
                                    by_slot, slack, ratio)
        if exact_bits and agree < 0.9999:
            fail(f"{what} pack32 select: key agreement {agree:.7f} < 0.9999")
        return err, agree
    if exact_bits:
        return compare_exact(torch, bs, got, ref, k_pair, 0.0, 0.0), None
    return compare_exact(torch, bs, got, ref, k_pair, slack=slack,
                         ratio=ratio), None


def entry_slack(torch, args, ref, *, k_pair, pack32, slot_mask, euclidean,
                sides):
    """sum_slack for each entry of a block scan's output ref [B, p_tile,
    ...]: pack32 keys name window slots (row start_c + slot), exact ones
    carry absolute addresses after their k_pair values."""
    probers = args[1][..., None]
    if pack32:
        rows = args[2][:, None, None] + (ref & slot_mask)
    else:
        rows = ref[..., k_pair:]
    return sum_slack(torch, args, euclidean, rows,
                     probers.expand(rows.shape), sides)


def check_kernel(torch, bs, args, *, s_eff, k_pair, pack32, euclidean=True,
                 reps=20, exact_bits=False, equal=False, extra=None,
                 by_slot=False, f32_bound=False):
    """The block scan as its wrapper routes it against its plain version on
    the same inputs; fails the run on disagreement (compare_rows' criteria,
    equal / exact_bits as there). A tensor-core route (bf16 d <= 1024, int8
    d <= 1024) is held on the live rows (prober >= 0), and every pad row
    must be dead: it does not score them, the plain version scores them
    with query 0. Then the CUDA-core kernel of the same cache mode and
    select (csrc/block_scan.cu, the route of f32 caches and of the shapes
    the tensor-core ones leave), launched uncounted, on every row. by_slot:
    compare_pack32's. f32_bound (the k-chunked rows, d > 128): the
    CUDA-core kernel's values may also take the bound of an f32 sum of the
    scores' terms (sum_slack, both sides f32: its one sequential chain
    comes near the tolerance where the score cancels); the tensor-core
    kernel is held to the tolerance alone, its ratio to it logged. Returns (max_abs_err, key agreement, ms, plain_ms) of
    the routed kernel, the times None when reps is 0."""
    slot_mask = bs.util.next_pow2(s_eff) - 1
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=slot_mask, **(extra or {}))
    route = bs.pick_route(dtype=args[6].dtype, d=args[6].shape[1],
                          p_tile=args[1].shape[1], s_eff=s_eff,
                          k_pair=k_pair, pack32=pack32)
    got = bs.block_scan(*args, **kw)
    torch.cuda.synchronize()
    ref = bs.block_scan_ref(*args, **kw)
    crit = dict(k_pair=k_pair, pack32=pack32, slot_mask=slot_mask,
                equal=equal, exact_bits=exact_bits, by_slot=by_slot)
    slack = entry_slack(torch, args, ref, k_pair=k_pair, pack32=pack32,
                        slot_mask=slot_mask, euclidean=euclidean,
                        sides=2) if f32_bound else None
    if route.startswith("tc_"):
        if not dead_rows(torch, bs, got, args[1], k_pair, pack32):
            fail(f"{route}: pad rows are not written dead")
        mode = cuda_core_route(route)
        cc = block_launch(torch, bs, args, mode, **kw)
        torch.cuda.synchronize()
        compare_rows(torch, bs, cc, ref, what=f"{mode} (CUDA cores)",
                     slack=slack, **crit)
        live = args[1] >= 0
        got, ref = got[live], ref[live]
        slack = None
    err, agree = compare_rows(torch, bs, got, ref, what=route, slack=slack,
                              ratio=f32_bound, **crit)
    if not reps:
        return err, agree, None, None
    ms = cuda_ms(torch, lambda: bs.block_scan(*args, **kw), reps)
    plain_ms = cuda_ms(torch, lambda: bs.block_scan_ref(*args, **kw), 3)
    return err, agree, ms, plain_ms


def check_codes(torch, bs, cs, args, *, s_eff, k_pair, pack32,
                euclidean=True, exact_bits=False, reps=20):
    """The codes scan as its wrapper routes it (the tensor-core kernel at
    these shapes) against codes_scan_ref on the live rows (prober >= 0);
    every pad row must be dead (pack32 INT_MIN; exact sortable(-inf) keys
    and -1 addresses): the tensor-core kernel does not score them, the
    plain version scores them with query 0. exact_bits: live rows equal bit
    for bit (integer inputs, every sum exact in any order); else the
    tolerances of compare_exact / compare_pack32. Then the CUDA-core
    kernel (csrc/codes_scan.cu, the route of the shapes the tensor-core
    one leaves), launched uncounted, against the same plain output on
    every row (it scores pad rows with query 0, as the plain version
    does): bit for bit on integer inputs; else exact values equal (the
    plain version's f32 FMA chain) and pack32 keys on >= 0.9999 of
    entries. Returns (max_abs_err, key agreement, ms, plain_ms) of the
    tensor-core kernel, the times None when reps is 0."""
    slot_mask = bs.util.next_pow2(s_eff) - 1
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=slot_mask)
    m, _, dsub = args[7].shape
    route = cs.pick_route(m=m, dsub=dsub, p_tile=args[1].shape[1],
                          s_eff=s_eff, k_pair=k_pair, pack32=pack32)
    if not route.startswith("tc_"):
        fail(f"the codes scan routes these shapes to {route}, not the "
             "tensor cores")
    got = cs.codes_scan(*args, **kw)
    torch.cuda.synchronize()
    ref = cs.codes_scan_ref(*args, **kw)
    check_cuda_core_codes(torch, bs, cs, args, ref, kw, exact_bits)
    if not dead_rows(torch, bs, got, args[1], k_pair, pack32):
        fail(f"{route}: pad rows are not written dead")
    live = args[1] >= 0
    got, ref = got[live], ref[live]
    if exact_bits:
        if not torch.equal(got, ref):
            fail(f"{route} differs from codes_scan_ref on integer inputs: "
                 f"{share_equal(got, ref):.6f} of entries equal")
        err, agree = 0.0, (1.0 if pack32 else None)
    elif pack32:
        err, agree = compare_pack32(torch, bs, got, ref, slot_mask)
    else:
        err, agree = compare_exact(torch, bs, got, ref, k_pair), None
    if not reps:
        return err, agree, None, None
    ms = cuda_ms(torch, lambda: cs.codes_scan(*args, **kw), reps)
    plain_ms = cuda_ms(torch, lambda: cs.codes_scan_ref(*args, **kw), 3)
    return err, agree, ms, plain_ms


def codes_launch(torch, cs, args, route, **kw):
    """The codes scan's kernel of `route` on args, without counting a
    launch: the comparisons with the plain version and the yardstick
    times."""
    from torchpq_tpu_torch import _build
    return cs.launch(_build.library(), torch.cuda.current_stream().cuda_stream,
                     *args, route=route, **kw)


def check_cuda_core_codes(torch, bs, cs, args, ref, kw, exact_bits):
    """The CUDA-core codes kernel against the plain version's output `ref`
    on every row; fails the run on disagreement (see check_codes)."""
    mode = "pack32" if kw["pack32"] else "exact"
    got = codes_launch(torch, cs, args, mode, **kw)
    torch.cuda.synchronize()
    if exact_bits:
        if not torch.equal(got, ref):
            fail(f"{mode} (CUDA cores) differs from codes_scan_ref on "
                 f"integer inputs: {share_equal(got, ref):.6f} equal")
    elif kw["pack32"]:
        agree = compare_pack32(torch, bs, got, ref, kw["slot_mask"])[1]
        if agree < 0.9999:
            fail(f"pack32 (CUDA cores): key agreement {agree:.7f} < 0.9999")
    else:
        compare_exact(torch, bs, got, ref, kw["k_pair"], 0.0, 0.0)


def in_turns(torch, fns, reps):
    """Mean CUDA-event ms of each callable, timed in turns a, b, ..., ...,
    b, a (reps launches each turn) -> ({name: mean}, {name: [turns]})."""
    names = list(fns)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cuda_ms(torch, fns[name], reps))
    return {k: float(np.mean(v)) for k, v in times.items()}, times


def cuda_core_route(route):
    """The CUDA-core route (csrc/block_scan.cu) of a tensor-core one's cache
    mode and select."""
    return route.split("_", 2)[2] if route.startswith(("tc_wg_", "tc_wgn_")) \
        else route[3:]


def is_wg(route):
    """Whether a block-scan route is block_scan_wg.cu's (narrow or
    k-chunked instances, bf16 or int8)."""
    return route.startswith(("tc_wg_", "tc_wgn_"))


def route_source(route):
    """The source of a block-scan route's kernel."""
    if is_wg(route):
        return "torchpq_tpu_torch/csrc/block_scan_wg.cu"
    return "torchpq_tpu_torch/csrc/block_scan.cu"


def wg_instance(pack32, k_pair, d, int8=False):
    """The warp-specialised instance (kernel_name) a launch of this select
    at width d runs (block_scan_wg.cu's dispatch: narrow instances up to
    256-byte rows, bf16 d <= 128 and int8 d <= 256, k-chunked ones
    above)."""
    from torchpq_tpu_torch.ops import block_scan as bs
    dtype = bs.torch.int8 if int8 else bs.torch.bfloat16
    if d * (1 if int8 else 2) <= bs._WG_NARROW_ROW:
        kmax, ring, qbufs = bs.wg_narrow_instance(pack32, k_pair, dtype)
    else:  # KMAX: 64 for the deep select (pack32 k_pair 17-64)
        kmax = (bs._DS_MAX_K if pack32 and k_pair > bs._DS_SHALLOW_K
                else 16 if pack32 or k_pair > 10 else 10)
        kmax, ring, qbufs = kmax, bs.wg_ring(pack32, k_pair), 0
    return (f"block_scan_wg_kernelILb{int(bool(pack32))}ELi{kmax}ELi{ring}"
            f"ELi{qbufs}ELb{int(bool(int8))}ELb0E")


def codes_instance(pack32, k_pair):
    """The wgmma codes instance (kernel_name) a codes launch of this select
    runs (block_scan_wg.cu's codes dispatch: one query buffer; exact 3
    stages, pack32 5 up to k_pair 16, 4 up to 32 (passes), the deep select
    above on 3)."""
    from torchpq_tpu_torch.ops import codes_scan as cs
    kmax = (64 if pack32 and k_pair > cs._WG_CODES_PASS_K
            else 16 if pack32 or k_pair > 10 else 10)
    return (f"block_scan_wg_kernelILb{int(bool(pack32))}ELi{kmax}ELi"
            f"{cs.wg_ring(pack32, k_pair)}ELi{cs._WG_CQB}ELb0ELb1E")


# --parent DIR: the parent tree's scans, built from DIR and timed in turns
# with this tree's route on each row's own arguments: csrc/block_scan_wg.cu
# on every warp-specialised block-scan row (bf16 and int8: the parent's
# instances of the row's select, keys held equal), csrc/codes_scan_tc.cu on
# every codes row, csrc/block_scan_tc.cu (mma.sync) on the narrow bf16
# rows whose shapes it takes, and csrc/flat_scan_tc.cu on the pallas_flat
# plan's flat scan, each where DIR holds it; empty without --parent
PARENT = {}
# the parent tree's csrc directory (None without --parent)
PARENT_CSRC = None
# the parent's sources: (file, {entry point: ((pointers, ints) before the
# stream, its occupancy entry's ints)})
PARENT_SOURCES = {
    "wg": ("block_scan_wg.cu", {"torchpq_block_scan_wg": ((8, 11), 3),
                                "torchpq_block_scan_wg_int8": ((10, 11), 3),
                                "torchpq_codes_scan_wg": ((9, 12), 4)}),
    "bf16": ("block_scan_tc.cu", {"torchpq_block_scan_tc": ((8, 10), 3)}),
    "codes": ("codes_scan_tc.cu", {"torchpq_codes_scan_tc": ((9, 12), 4)}),
    "flat": ("flat_scan_tc.cu", {"torchpq_flat_scan_tc": ((7, 8), 3)})}


def build_parent(_build, root):
    """The scans of the tree at `root` (PARENT_SOURCES that it holds, at
    least one), each built with the package's nvcc flags into
    build/parent/ and bound with ctypes (its entry points and their
    occupancy)."""
    import ctypes
    global PARENT_CSRC
    csrc = Path(root).resolve() / "torchpq_tpu_torch" / "csrc"
    PARENT_CSRC = csrc
    if not any((csrc / f[0]).exists() for f in PARENT_SOURCES.values()):
        fail(f"--parent: {csrc} holds none of "
             f"{[f[0] for f in PARENT_SOURCES.values()]}")
    out = Path("build/parent")
    out.mkdir(parents=True, exist_ok=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    jobs = {}
    for kind, (fname, entries) in PARENT_SOURCES.items():
        src = csrc / fname
        if not src.exists():
            continue
        so = out / f"libparent_{src.stem}.so"
        jobs[kind] = (src, so, entries, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-I{csrc}",
             str(src), "-o", str(so), *_build.LINK_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for kind, (src, so, entries, proc) in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"--parent: nvcc failed on {src}:\n{text}")
        lib = ctypes.CDLL(str(so))
        for entry, ((n_ptr, n_int), n_occ) in entries.items():
            if not hasattr(lib, entry):  # a tree from before the entry
                continue
            getattr(lib, entry).argtypes = [p] * n_ptr + [i] * n_int + [p]
            getattr(lib, entry).restype = i
            getattr(lib, entry + "_occupancy").argtypes = [i] * n_occ
            getattr(lib, entry + "_occupancy").restype = i
        PARENT[kind] = lib
        log(f"--parent: built {src} -> {so}")


def parent_turns(torch, args, out, launch, new, what, source, tag):
    """The parent's kernel (launch(), its CUDA return code) and this tree's
    route (new(), its output) in turns (parent, new, new, parent; 5
    launches a turn, none counted), with the share of live entries the
    two outputs hold equal; returns the row's fields ({tag}_ms and the
    turns)."""
    def run():
        rc = launch()
        if rc != 0:
            fail(f"{what}: the parent's {source} launch failed: CUDA error "
                 f"{rc}")

    run()
    live = args[1] >= 0
    agree = share_equal(out[live], new()[live])
    t, turns = in_turns(torch, {tag: run, "new": new}, 5)
    log(f"  {what}: in turns, the parent's {source} {t[tag]:.3f} ms "
        f"({' / '.join(f'{x:.3f}' for x in turns[tag])}), this tree "
        f"{t['new']:.3f} ms ({' / '.join(f'{x:.3f}' for x in turns['new'])})"
        f", {t[tag] / t['new']:.2f}x; live entries equal {agree:.6f}")
    return {f"{tag}_ms": t[tag], f"{tag}_turns": turns[tag],
            f"{tag}_new_turns": turns["new"], f"{tag}_source": source,
            f"{tag}_live_equal": agree}


def wg_launch_fn(torch, bs, lib, args, kkw):
    """(launch, out): a closure that launches `lib`'s warp-specialised block
    scan (torchpq_block_scan_wg, or its _int8 twin where kkw holds the
    scales) on args into out, uncounted, and returns its CUDA return code
    (the grid: lib's occupancy times the card's SMs, at most a CTA a
    block); (None, None) where lib's occupancy query refuses the shapes."""
    b, p_tile = args[1].shape
    d = args[6].shape[1]
    int8 = kkw.get("scale") is not None
    name = "torchpq_block_scan_wg" + ("_int8" if int8 else "")
    pack32, k_pair = kkw["pack32"], kkw["k_pair"]
    groups = bs.n_groups(kkw["s_eff"], k_pair) if pack32 else 0
    per_sm = getattr(lib, name + "_occupancy")(d, int(pack32), k_pair)
    if per_sm <= 0:
        return None, None
    n_ctas = min(b, per_sm * torch.cuda.get_device_properties(
        args[6].device).multi_processor_count)
    out = torch.empty((b, p_tile, k_pair if pack32 else 2 * k_pair),
                      dtype=torch.int32, device=args[6].device)
    ptrs = [t.data_ptr() for t in args]
    if int8:  # the entry's order: q8, q_scale, ..., penalty, scale, y8
        ptrs = ptrs[:1] + [kkw["q_scale"].data_ptr()] + ptrs[1:6] + [
            kkw["scale"].data_ptr(), ptrs[6]]

    def launch():
        return getattr(lib, name)(
            *ptrs, out.data_ptr(), b, p_tile, d, args[6].shape[0],
            kkw["s_eff"], k_pair, int(kkw["euclidean"]), int(pack32),
            kkw["slot_mask"], groups, n_ctas,
            torch.cuda.current_stream().cuda_stream)

    return launch, out


def tc_launch_fn(torch, bs, lib, args, kkw):
    """(launch, out): the same for the mma.sync block scan
    (torchpq_block_scan_tc: bf16, d <= 128, pack32 k_pair 17-64) of a
    tree that holds it; (None, None) where it refuses the shapes."""
    b, p_tile = args[1].shape
    d = args[6].shape[1]
    pack32, k_pair = kkw["pack32"], kkw["k_pair"]
    if kkw.get("scale") is not None or not pack32 or k_pair <= 16:
        return None, None
    groups = bs.n_groups(kkw["s_eff"], k_pair)
    per_sm = lib.torchpq_block_scan_tc_occupancy(d, 1, k_pair)
    if per_sm <= 0:
        return None, None
    n_ctas = min(b, per_sm * torch.cuda.get_device_properties(
        args[6].device).multi_processor_count)
    out = torch.empty((b, p_tile, k_pair), dtype=torch.int32,
                      device=args[6].device)
    ptrs = [t.data_ptr() for t in args]

    def launch():
        return lib.torchpq_block_scan_tc(
            *ptrs, out.data_ptr(), b, p_tile, d, kkw["s_eff"], k_pair,
            int(kkw["euclidean"]), 1, kkw["slot_mask"], groups, n_ctas,
            torch.cuda.current_stream().cuda_stream)

    return launch, out


def block_turns(torch, bs, args, kkw, route, what):
    """With --parent, a block-scan row's arguments (its select kkw) on
    `route` in turns with the parent's kernels (parent_turns): its
    block_scan_wg.cu on a warp-specialised route (the live keys must equal
    this tree's: the products and the selects' results are the same), and
    its mma.sync block_scan_tc.cu on a narrow bf16 pack32 row above k_pair
    16, where the parent holds and takes it; {} without --parent."""
    row = {}
    new = (lambda: block_launch(torch, bs, args, route, **kkw))
    if "wg" in PARENT and is_wg(route):
        launch, out = wg_launch_fn(torch, bs, PARENT["wg"], args, kkw)
        if launch is None or launch() != 0:
            log(f"  {what}: the parent's block_scan_wg.cu does not take "
                "these shapes")
        else:
            row.update(parent_turns(torch, args, out, launch, new, what,
                                    "block_scan_wg.cu", "parent_wg"))
            if row["parent_wg_live_equal"] != 1.0:
                fail(f"{what}: the live keys differ from the parent's "
                     f"block_scan_wg.cu instance: "
                     f"{row['parent_wg_live_equal']:.6f} equal")
    if "bf16" in PARENT and route == "tc_wgn_pack32" \
            and kkw["k_pair"] > 16 and kkw.get("scale") is None:
        launch, out = tc_launch_fn(torch, bs, PARENT["bf16"], args, kkw)
        if launch is None or launch() != 0:
            log(f"  {what}: the parent's block_scan_tc.cu does not take "
                "these shapes")
        else:
            row.update(parent_turns(torch, args, out, launch, new, what,
                                    "block_scan_tc.cu", "mma_sync"))
    return row


def codes_launch_fn(torch, bs, lib, entry, args, kkw):
    """(launch, out): a closure that launches `lib`'s codes-scan entry point
    `entry` (torchpq_codes_scan_wg, block_scan_wg.cu's codes instances; or
    torchpq_codes_scan_tc, the mma.sync sorted kernel of a tree that holds
    it) on args into out, uncounted, and returns its CUDA return code (the
    grid: its occupancy times the card's SMs, at most a CTA a block);
    (None, None) where its occupancy query refuses the shapes."""
    b, p_tile = args[1].shape
    m, _, dsub = args[7].shape
    pack32, k_pair = kkw["pack32"], kkw["k_pair"]
    groups = bs.n_groups(kkw["s_eff"], k_pair) if pack32 else 0
    per_sm = getattr(lib, entry + "_occupancy")(m, dsub, int(pack32), k_pair)
    if per_sm <= 0:
        return None, None
    n_ctas = min(b, per_sm * torch.cuda.get_device_properties(
        args[6].device).multi_processor_count)
    out = torch.empty((b, p_tile, k_pair if pack32 else 2 * k_pair),
                      dtype=torch.int32, device=args[6].device)
    ptrs = [t.data_ptr() for t in args]

    def launch():
        return getattr(lib, entry)(
            *ptrs, out.data_ptr(), b, p_tile, m, dsub, args[6].shape[1] // m,
            kkw["s_eff"], k_pair, int(kkw["euclidean"]), int(pack32),
            kkw["slot_mask"], groups, n_ctas,
            torch.cuda.current_stream().cuda_stream)

    return launch, out


def codes_parent_turns(torch, bs, cs, args, kkw, route, what):
    """With --parent, a codes row's arguments (its select kkw) on `route`
    in turns (parent_turns) with the parent's kernels, where it holds and
    takes them: its block_scan_wg.cu codes instance of the row's select
    (the live keys must equal this tree's: the products and the selects'
    results are the same), and its mma.sync codes_scan_tc.cu (the sorted
    kernel of older trees; its share of equal live keys logged: only the
    f32 summation order differs); {} without --parent."""
    row = {}
    new = (lambda: codes_launch(torch, cs, args, route, **kkw))
    for kind, entry, source, tag in (
            ("wg", "torchpq_codes_scan_wg", "block_scan_wg.cu", "parent_wg"),
            ("codes", "torchpq_codes_scan_tc", "codes_scan_tc.cu",
             "mma_sync")):
        if kind not in PARENT or not hasattr(PARENT[kind], entry):
            continue
        launch, out = codes_launch_fn(torch, bs, PARENT[kind], entry, args,
                                      kkw)
        if launch is None or launch() != 0:
            log(f"  {what}: the parent's {source} does not take these "
                "shapes")
            continue
        row.update(parent_turns(torch, args, out, launch, new, what, source,
                                tag))
        if kind == "wg" and row["parent_wg_live_equal"] != 1.0:
            fail(f"{what}: the live keys differ from the parent's "
                 f"block_scan_wg.cu codes instance: "
                 f"{row['parent_wg_live_equal']:.6f} equal")
    return row


def sass_counts(torch, path):
    """Per warp-specialised instance of the built library (block_scan_wg.cu's
    and flat_scan_wg.cu's), its SASS counts of WG_OPS (cuobjdump -sass);
    fails where the library holds other than N_WG_KERNELS block-scan
    instances and one flat-scan kernel, or one lacks an op."""
    res = subprocess.run(["cuobjdump", "-sass", str(path)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[-2000:]}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            fn = fn if WG_KERNEL.search(fn) or FLAT_WG_KERNEL.search(fn) \
                else None
            if fn:
                counts[fn] = dict.fromkeys(WG_OPS, 0)
            continue
        if fn:
            for op in WG_OPS:
                if re.search(r"\b" + op + r"\b", line):
                    counts[fn][op] += 1
    for fn, c in sorted(counts.items()):
        log(f"SASS {fn}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
        if not all(c[op] for op in wg_ops(fn)):
            fail(f"{fn}: no {[op for op in wg_ops(fn) if not c[op]]} in its "
                 "SASS")
    blocks = [fn for fn in counts if WG_KERNEL.search(fn)]
    flats = [fn for fn in counts if FLAT_WG_KERNEL.search(fn)]
    if len(blocks) != N_WG_KERNELS or len(flats) != 1:
        fail(f"cuobjdump found {sorted(counts)}, not the {N_WG_KERNELS} "
             f"warp-specialised block-scan instances and the flat scan")
    return counts


def kernel_row(name, s_eff, blocks, err, agree, ms, plain_ms):
    return (f"{name} s_eff={s_eff} blocks={blocks}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, max_abs_err {err:.3g}"
            + (f", key agreement {agree:.7f}" if agree is not None else ""))


def narrow_wide_rows(torch, bs):
    """The warp-specialised route at k-chunked widths below the GIST-class
    cache (d 200 and 384, the latter the wide tests' 768-byte rows), on
    sparsely live blocks (8 live probers of 128: one live 64-prober tile,
    as at n_probe 1) and on blocks of random liveness: held to the plain
    version (check_kernel) and timed in turns with block_scan.cu, the
    route these shapes would take without it (logged)."""
    for d in (200, 384):
        for sparse in (True, False):
            args = bs.random_inputs("cuda", s_eff=640, n_blocks=1024,
                                    nq=10000, d=d, cap_total=1 << 18,
                                    seed=d + sparse)
            if sparse:
                args[1][:, 8:] = -1
            for pack32 in (False, True):
                kw = dict(s_eff=640, k_pair=10, euclidean=True,
                          pack32=pack32, slot_mask=1023)
                check_kernel(torch, bs, args, s_eff=640, k_pair=10,
                             pack32=pack32, reps=0)
                mode = "pack32" if pack32 else "exact"
                route = bs.pick_route(dtype=args[6].dtype, d=d, p_tile=128,
                                      s_eff=640, k_pair=10, pack32=pack32)
                t, turns = in_turns(torch, {
                    "cuda_cores": lambda: block_launch(torch, bs, args, mode,
                                                       **kw),
                    route: lambda: block_launch(torch, bs, args, route,
                                                **kw)}, 5)
                log(f"block_scan {route} d={d} s_eff=640 k_pair=10, 1024 "
                    f"blocks, {int((args[1] >= 0).sum())} live probers "
                    f"({'8 a block' if sparse else 'random'}): "
                    f"{t[route]:.3f} ms "
                    f"({' / '.join(f'{x:.3f}' for x in turns[route])}), "
                    f"block_scan.cu {t['cuda_cores']:.3f} ms "
                    f"({' / '.join(f'{x:.3f}' for x in turns['cuda_cores'])})"
                    f", {t['cuda_cores'] / t[route]:.2f}x; live rows within "
                    f"tolerance, pad rows dead")
            del args


def phase_kernels(torch, bs, cs, fs, gr):
    """Seeded inputs at s_eff 1024 and 2048 (1024 blocks of 128 probers,
    d=128, k_pair=10, bf16), both selects; then the f32-cache kernel; then
    the codes kernel (PQ64 codes, s_eff 1024), both selects; then the int8
    mode, the flat scan and the row gather."""
    for s_eff in (1024, 2048):
        args = bs.random_inputs("cuda", s_eff=s_eff, n_blocks=1024,
                                nq=10000, cap_total=1 << 21, seed=s_eff)
        for pack32 in (False, True):
            res = check_kernel(torch, bs, args, s_eff=s_eff, k_pair=10,
                               pack32=pack32)
            name = "block_scan_pack32" if pack32 else "block_scan_exact"
            log(kernel_row(name, s_eff, 1024, *res) + " (tensor cores; live "
                "rows within tolerance, pad rows dead; the CUDA-core kernel "
                "matches the plain version on every row)")
    # integer inputs with runs of equal rows: bit for bit, ties included
    # (d 40 pads K to 48; s_eff 200 ends in a ragged tile; the deep pack32
    # selects (csrc/deep_select.cuh) of the narrow instance: k_pair 40 over
    # 512 groups (4 tiles a phase), 64 over 512 (8) and 57 over 256 (2), the
    # deep-k selects, and 64 over 128 (one phase of 5 tiles, the residual
    # record's); d 1024, the GIST-class cache in 256-byte k chunks, at the
    # records' k = 10 and k = 100 shapes and pack32 k_pair 40 (the deep
    # instance of k_pair 17-48), on the warp-specialised route; d 200, whose
    # rows end inside a k chunk)
    for d, s_eff, k_pair, selects in ((128, 640, 10, (False, True)),
                                      (128, 2048, 40, (True,)),
                                      (128, 4096, 64, (True,)),
                                      (128, 512, 57, (True,)),
                                      (128, 640, 64, (True,)),
                                      (40, 200, 16, (False,)),
                                      (1024, 2048, 10, (False, True)),
                                      (1024, 2048, 64, (True,)),
                                      (1024, 2048, 40, (True,)),
                                      (200, 640, 16, (False, True))):
        args = bs.integer_block_inputs("cuda", s_eff=s_eff,
                                       n_blocks=256 if d > 128 else 1024,
                                       nq=10000, d=d, cap_total=1 << 18,
                                       seed=d + k_pair)
        for pack32 in selects:
            for euclidean in (True, False):
                check_kernel(torch, bs, args, s_eff=s_eff, k_pair=k_pair,
                             pack32=pack32, euclidean=euclidean, equal=True,
                             reps=0)
        ref = bs.block_scan_ref(*args, s_eff=s_eff, k_pair=k_pair,
                                euclidean=True, pack32=False,
                                slot_mask=bs.util.next_pow2(s_eff) - 1)
        ref = ref[args[1] >= 0][:, :k_pair]
        routes = sorted({bs.pick_route(dtype=args[6].dtype, d=d, p_tile=128,
                                       s_eff=s_eff, k_pair=k_pair, pack32=p)
                         for p in selects})
        log(f"block_scan ({', '.join(routes)}) integer inputs d={d} "
            f"s_eff={s_eff} k_pair={k_pair}: live rows equal bit for bit, "
            f"{' and '.join('pack32' if p else 'exact' for p in selects)}, "
            f"euclidean and "
            f"inner ({int((ref[:, 1:] == ref[:, :-1]).sum())} tied "
            f"neighbours in the exact lists); pad rows dead; the CUDA-core "
            f"kernel equal bit for bit on every row")
        del args
    narrow_wide_rows(torch, bs)
    args = bs.random_inputs("cuda", s_eff=512, n_blocks=64, nq=10000,
                            cap_total=1 << 21, seed=7, dtype=torch.float32)
    err = check_kernel(torch, bs, args, s_eff=512, k_pair=10, pack32=False,
                       euclidean=False, reps=1)[0]
    log(f"block_scan_exact f32 cache, inner: max_abs_err {err:.3g}")
    args = cs.random_codes_inputs("cuda", s_eff=1024, n_blocks=1024,
                                  nq=10000, m=64, dsub=2, cap_total=1 << 21,
                                  seed=11)
    for pack32 in (False, True):
        res = check_codes(torch, bs, cs, args, s_eff=1024, k_pair=10,
                          pack32=pack32)
        name = "codes_scan_pack32" if pack32 else "codes_scan_exact"
        log(kernel_row(name, 1024, 1024, *res) + " (tensor cores, PQ64, "
            "g=2; live rows within tolerance, pad rows dead; the CUDA-core "
            "kernel matches the plain version on every row)")
    del args
    # integer inputs with runs of equal codes: bit for bit, ties included
    # (the wgmma codes instances at exact k_pair 10 and 16 and pack32 10,
    # 16 and 20, PQ128 in two raw passes and PQ8 of dsub 9 a ragged second
    # k half; k_pair 40, 52 and 64 over 512 groups at d = 128: the deep
    # select, the IVFPQR code domain's k = 100 shapes, for PQ64 and the
    # 4-bit byte pairs)
    for m, dsub, s_eff, k_pair in ((64, 2, 1024, 10), (8, 4, 256, 10),
                                   (64, 2, 1024, 16), (64, 2, 1024, 20),
                                   (128, 1, 1024, 16), (8, 9, 256, 16),
                                   (32, 4, 1024, 16),
                                   (64, 2, 1024, 40), (64, 2, 1024, 52),
                                   (64, 2, 1024, 64), (32, 4, 1024, 52),
                                   (32, 4, 1024, 64)):
        args = cs.integer_codes_inputs("cuda", s_eff=s_eff, n_blocks=1024,
                                       nq=10000, m=m, dsub=dsub,
                                       cap_total=1 << 18, seed=m + k_pair)
        for pack32 in ((True,) if k_pair > 16 else (False, True)):
            for euclidean in (True, False):
                check_codes(torch, bs, cs, args, s_eff=s_eff, k_pair=k_pair,
                            pack32=pack32, euclidean=euclidean,
                            exact_bits=True, reps=0)
        ref = cs.codes_scan_ref(*args, s_eff=s_eff, k_pair=10,
                                euclidean=True, pack32=False,
                                slot_mask=s_eff - 1)[args[1] >= 0][:, :10]
        log(f"codes_scan (tensor cores) integer inputs m={m} dsub={dsub} "
            f"s_eff={s_eff} k_pair={k_pair}: live rows equal bit for bit, "
            f"{'pack32' if k_pair > 16 else 'both selects'}, euclidean and "
            f"inner ({int((ref[:, 1:] == ref[:, :-1]).sum())} tied "
            f"neighbours in the exact lists); pad rows dead; the CUDA-core "
            f"kernel equal bit for bit on every row")
        del args
    # int8 mode at d 128 and at the GIST cache width 1024, both routes: bit
    # for bit on random inputs and on inputs with exact ties (also at d 16,
    # half a k32 step, and 272, the narrowest k-chunked row)
    for d in (128, 1024):
        args, scale, q_scale = bs.random_int8_inputs(
            "cuda", s_eff=1024, n_blocks=1024, nq=10000, d=d,
            cap_total=1 << 20, seed=d)
        for pack32 in (False, True):
            res = check_kernel(torch, bs, args, s_eff=1024, k_pair=10,
                               pack32=pack32, equal=True, reps=5,
                               extra=dict(scale=scale, q_scale=q_scale))
            name = "block_scan_int8_" + ("pack32" if pack32 else "exact")
            log(kernel_row(name, 1024, 1024, *res) + f" (d={d}; tensor "
                "cores on live rows, pad rows dead; the CUDA-core kernel on "
                "every row; bit for bit)")
    for d in (16, 128, 272, 1024):
        args, scale, q_scale = bs.int8_tie_inputs(
            "cuda", s_eff=640, n_blocks=1024, nq=10000, d=d,
            cap_total=1 << 18, seed=d)
        extra = dict(scale=scale, q_scale=q_scale)
        for pack32, k_pair in ((False, 10), (True, 40)):
            for euclidean in (True, False):
                check_kernel(torch, bs, args, s_eff=640, k_pair=k_pair,
                             pack32=pack32, euclidean=euclidean, equal=True,
                             reps=0, extra=extra)
        ref = bs.block_scan_ref(*args, s_eff=640, k_pair=10, euclidean=True,
                                pack32=False, slot_mask=1023, **extra)
        ref = ref[args[1] >= 0][:, :10]
        routes = [bs.pick_route(dtype=torch.int8, d=d, p_tile=128, s_eff=640,
                                k_pair=k, pack32=pk)
                  for pk, k in ((False, 10), (True, 40))]
        log(f"block_scan_int8 ({' / '.join(routes)}) tie inputs d={d} "
            f"s_eff=640: "
            f"live rows equal bit for bit, exact k_pair 10 and pack32 40, "
            f"euclidean and inner ({int((ref[:, 1:] == ref[:, :-1]).sum())} "
            f"tied neighbours in the exact lists); pad rows dead; the "
            f"CUDA-core kernel equal bit for bit on every row")
        del args
    # pack32 k_pair 64 over 512 groups, 2 tiles a phase: at d 128 the
    # narrow deep wgmma instance, at d 1024 the k-chunked one of three ring
    # stages
    for d in (128, 1024):
        args, scale, q_scale = bs.int8_tie_inputs(
            "cuda", s_eff=1024, n_blocks=1024 if d == 128 else 256,
            nq=10000, d=d,
            cap_total=1 << 18, seed=64)
        for euclidean in (True, False):
            check_kernel(torch, bs, args, s_eff=1024, k_pair=64, pack32=True,
                         euclidean=euclidean, equal=True, reps=0,
                         extra=dict(scale=scale, q_scale=q_scale))
        route = bs.pick_route(dtype=torch.int8, d=d, p_tile=128, s_eff=1024,
                              k_pair=64, pack32=True)
        log(f"block_scan_int8 ({route}) tie inputs d={d} s_eff=1024 "
            f"pack32 k_pair 64: live rows equal bit for bit, euclidean and "
            f"inner; pad rows dead; the CUDA-core kernel equal bit for bit "
            f"on every row")
        del args
    phase_flat_kernels(torch, fs)
    # the row gather: bit for bit, out-of-range indices clipped
    g = torch.Generator(device="cuda").manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        table = (torch.randn(100000, 128, generator=g, device="cuda")
                 * 40).to(dtype)
        idx = torch.randint(-1000, 101000, (1 << 20,), generator=g,
                            device="cuda", dtype=torch.int32)
        got = gr.gather_rows(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, gr.gather_rows_ref(table, idx)):
            fail(f"gather_rows differs from table[idx.clamp] ({dtype})")
        ms = cuda_ms(torch, lambda: gr.gather_rows(table, idx), 20)
        log(f"gather_rows {dtype} [100000, 128] x 2^20 indices: equal bit "
            f"for bit; kernel {ms:.3f} ms")


def flat_launch(torch, fs, args, route, **kw):
    """The flat scan's kernel of `route` ("flat_wg", "flat_tc" or "flat")
    on args, without counting a launch: the comparisons with the plain
    version and the yardstick times."""
    from torchpq_tpu_torch import _build
    return fs.launch(_build.library(), torch.cuda.current_stream().cuda_stream,
                     *args, route=route, **kw)


def phase_flat_kernels(torch, fs):
    """The flat scan's three kernels on seeded inputs: the glue's head k=10
    of the top r_keep=16 (tolerances), the wgmma kernel at d 128, the
    mma.sync one at d 1024, the CUDA-core one at d 128; then the wgmma
    kernel at d 64 and 128, r_keep 8, 16 and 32, and the mma.sync one at d
    1024, r_keep 16 and 32 (tolerances); then both on integer-valued inputs
    with ties (bit for bit, euclidean and inner)."""
    args = fs.random_flat_inputs("cuda", nq=1024, cap=262144, seed=5)
    wide = fs.random_flat_inputs("cuda", nq=1024, cap=262144, d=1024, seed=5)
    for route, a_ in (("flat_wg", args), ("flat_tc", wide), ("flat", args)):
        vr, ar = fs.flat_scan_ref(*a_, r_keep=16, euclidean=True)
        plain_ms = cuda_ms(torch, lambda: fs.flat_scan_ref(
            *a_, r_keep=16, euclidean=True), 2)
        v, a = flat_launch(torch, fs, a_, route, r_keep=16, euclidean=True)
        torch.cuda.synchronize()
        err = compare_topk(torch, v[:, :10], a[:, :10], vr[:, :10],
                           ar[:, :10])
        ms = cuda_ms(torch, lambda: flat_launch(
            torch, fs, a_, route, r_keep=16, euclidean=True), 5)
        log(f"flat_scan ({route}) nq=1024 cap=262144 d={a_[1].shape[1]}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, max_abs_err "
            f"{err:.3g}, head-10 addresses equal "
            f"{share_equal(a[:, :10], ar[:, :10]):.5f}")
    del wide
    for route, d, r_keep in (("flat_wg", 64, 8), ("flat_wg", 64, 32),
                             ("flat_wg", 128, 8), ("flat_wg", 128, 16),
                             ("flat_wg", 128, 32), ("flat_tc", 1024, 16),
                             ("flat_tc", 1024, 32)):
        args = fs.random_flat_inputs("cuda", nq=1000, cap=100000, d=d,
                                     seed=d + r_keep)
        v, a = flat_launch(torch, fs, args, route, r_keep=r_keep,
                           euclidean=True)
        torch.cuda.synchronize()
        vr, ar = fs.flat_scan_ref(*args, r_keep=r_keep, euclidean=True)
        err = compare_topk(torch, v, a, vr, ar)
        log(f"flat_scan ({route}) nq=1000 cap=100000 d={d} r_keep={r_keep}: "
            f"max_abs_err {err:.3g}, addresses equal "
            f"{share_equal(a, ar):.5f}")
    for route, d in (("flat_wg", 64), ("flat_wg", 128), ("flat_tc", 1024)):
        args = fs.integer_flat_inputs("cuda", nq=1000, cap=100000, d=d,
                                      seed=d)
        for euclidean in (True, False):
            v, a = flat_launch(torch, fs, args, route, r_keep=16,
                               euclidean=euclidean)
            torch.cuda.synchronize()
            vr, ar = fs.flat_scan_ref(*args, r_keep=16, euclidean=euclidean)
            if not (torch.equal(v, vr) and torch.equal(a, ar)):
                fail(f"flat_scan ({route}) differs from flat_scan_ref on "
                     f"integer inputs (d={d}, euclidean={euclidean}): "
                     f"{share_equal(a, ar):.5f} of addresses equal")
        ties = int((vr[:, 1:] == vr[:, :-1]).sum())
        log(f"flat_scan ({route}) integer inputs nq=1000 cap=100000 d={d}: "
            f"equal bit for bit, values and addresses ({ties} tied "
            f"neighbours in the lists)")


def parent_flat_fn(torch, fs, args, kw):
    """(launch, out): a closure that launches the parent tree's mma.sync
    flat scan (PARENT["flat"]: csrc/flat_scan_tc.cu, at d <= 128 the
    parent's route for bf16 caches) on args into out, uncounted, and
    returns its CUDA return code (its warps and split as the parent's
    wrapper chose them: ops/flat_scan.py:tc_splits); (None, None) where
    --parent gave no such source, or where d <= 128 and the parent tree
    holds flat_scan_wg.cu (whose flat_scan_tc.cu serves 128 < d <= 1024
    only). Any other refusal fails in parent_turns."""
    import ctypes
    lib = PARENT.get("flat")
    if lib is None:
        return None, None
    query, decoded, penalty = args
    nq, d = query.shape
    if d <= 128 and (PARENT_CSRC / "flat_scan_wg.cu").exists():
        log(f"--parent: the parent's flat_scan_tc.cu does not serve d={d} "
            f"(its flat_scan_wg.cu does): no turn")
        return None, None
    cap, r_keep = decoded.shape[0], kw["r_keep"]
    lib.torchpq_flat_scan_tc_smem.argtypes = [ctypes.c_int] * 3
    lib.torchpq_flat_scan_tc_smem.restype = ctypes.c_longlong
    warps = next(w for w in (8, 4, 2, 1)
                 if lib.torchpq_flat_scan_tc_smem(w, d, r_keep)
                 <= fs._SMEM_LIMIT)
    per_sm = lib.torchpq_flat_scan_tc_occupancy(warps, d, r_keep)
    if per_sm <= 0:
        fail(f"--parent: flat_scan_tc.cu takes no CTA of {warps} warps "
             f"(CUDA error {-per_sm})")
    split, n_splits = fs.tc_splits(
        nq, cap, 32 * warps, per_sm,
        torch.cuda.get_device_properties(0).multi_processor_count)
    qtable = query.to(torch.bfloat16).contiguous()
    part_v = torch.empty((n_splits, nq, r_keep), dtype=torch.float32,
                         device="cuda")
    part_a = torch.empty_like(part_v, dtype=torch.int32)
    out = (torch.empty((nq, r_keep), dtype=torch.float32, device="cuda"),
           torch.empty((nq, r_keep), dtype=torch.int32, device="cuda"))
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        return lib.torchpq_flat_scan_tc(
            qtable.data_ptr(), penalty.data_ptr(), decoded.data_ptr(),
            part_v.data_ptr(), part_a.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), nq, cap, d, r_keep, split, n_splits,
            int(kw["euclidean"]), warps, stream)
    return launch, out


def capture_call(tp, index, xq, k, module=None, name="block_scan",
                 n_calls=1):
    """One search with the index's current settings, keeping the arguments
    it hands the kernel wrapper `module.name` (default: the block scan, as
    ops/adc.py calls it): the (args, kw) of its one call, or the list of
    its n_calls calls (the split taper's head and tail scans)."""
    module = module or tp.ops.adc
    seen = []
    launch = getattr(module, name)

    def record(*args, **kw):
        seen.append((args, kw))
        return launch(*args, **kw)

    setattr(module, name, record)
    try:
        index.search(xq.T, k=k)
    finally:
        setattr(module, name, launch)
    if len(seen) != n_calls:
        fail(f"expected {n_calls} {name} call(s) per search, saw {len(seen)}")
    return seen[0] if n_calls == 1 else seen


def phase_main_shapes(torch, tp, bs, index, xq, k, label="main path",
                      suffix="", plans=((8, False), (32, True)), reps=20,
                      both=True, f32_bound=False):
    """The kernel against its plain version on the inputs the main path
    really gives it: the block-scan arguments of the exact n_probe=8 and
    the pack32 n_probe=32 searches (plans: (n_probe, approx) pairs), each
    checked with both selects (both=False: the select the search ran) (the
    tensor-core kernel on live rows, pad rows dead; the CUDA-core one on
    every row); then the select the search ran timed on both kernels in
    turns (reps launches a turn). f32_bound: check_kernel's. Returns the
    kernels' JSON rows (names + suffix) without their launch counts."""
    rows = {}
    for n_probe, approx in plans:
        index.scan_mode, index.n_probe = "cell_major", n_probe
        index.use_approx_topk = approx
        args, kw = capture_call(tp, index, xq, k)
        s_eff, k_pair = kw["s_eff"], kw["k_pair"]
        blocks, p_tile = args[1].shape
        live = int((args[1] >= 0).sum())
        live_tiles = int((args[1].view(blocks, -1, 16) >= 0).any(-1).sum())
        d = args[6].shape[1]
        log(f"{label} n_probe={n_probe} ({'pack32' if approx else 'exact'}"
            f"): {blocks} blocks x {p_tile} probers, {live} live "
            f"({live / (blocks * p_tile):.3f}), {live_tiles} live 16-prober "
            f"tiles of {blocks * p_tile // 16}, s_eff={s_eff}, "
            f"k_pair={k_pair}, d={d}")
        for pack32 in ((False, True) if both else (approx,)):
            res = check_kernel(torch, bs, args, s_eff=s_eff, k_pair=k_pair,
                               pack32=pack32, euclidean=kw["euclidean"],
                               reps=0, f32_bound=f32_bound)
            name = ("block_scan_pack32" if pack32 else "block_scan_exact") \
                + suffix
            log(f"{name} (tensor cores) on the inputs of the {label} n_probe="
                f"{n_probe} search: live rows max_abs_err {res[0]:.3g}"
                + (f", key agreement {res[1]:.7f}" if pack32 else "")
                + "; pad rows dead; the CUDA-core kernel matches the plain "
                "version on every row")
            if pack32 != approx:
                continue
            # the select the search ran: both kernels in turns
            mode = "pack32" if pack32 else "exact"
            route = bs.pick_route(dtype=args[6].dtype, d=d, p_tile=p_tile,
                                  s_eff=s_eff, k_pair=k_pair, pack32=pack32)
            kkw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=kw["euclidean"],
                       pack32=pack32, slot_mask=kw["slot_mask"])
            t, turns = in_turns(torch, {
                "cuda_cores": lambda: block_launch(torch, bs, args, mode,
                                                   **kkw),
                "tensor_cores": lambda: block_launch(torch, bs, args, route,
                                                     **kkw)}, reps)
            ms, cc_ms = t["tensor_cores"], t["cuda_cores"]
            plain_ms = cuda_ms(torch, lambda: bs.block_scan_ref(*args, **kkw),
                               3)
            b_ms, b_by = scan_bound(torch, args, kkw, slot_bytes=2 * d + 4,
                                    row_bytes=2 * d, peak="bf16", d=d)
            flop = 2.0 * s_eff * d
            log(f"  {name} on the {label} n_probe={n_probe} search's "
                f"arguments: "
                f"{route} {ms:.3f} ms ("
                f"{' / '.join(f'{x:.3f}' for x in turns['tensor_cores'])}; "
                f"{flop * live / ms / 1e9:.2f} TFLOP/s over live probers, "
                f"{flop * 16 * live_tiles / ms / 1e9:.2f} over live tiles, "
                f"{b_ms / ms:.1%} of the bound), CUDA cores {cc_ms:.3f} ms "
                f"({' / '.join(f'{x:.3f}' for x in turns['cuda_cores'])}; "
                f"{flop * live / cc_ms / 1e9:.2f} TFLOP/s over live "
                f"probers), speed-up {cc_ms / ms:.2f}x; plain {plain_ms:.3f} "
                f"ms, bound {b_ms:.3f} ms ({b_by})")
            rows[name] = dict(
                name=name, route="cuda", source=route_source(route),
                replaces="torchpq_tpu/ops/pallas_scan.py:281",
                max_abs_err=res[0], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                launch_key=route, cuda_core_ms=cc_ms,
                cuda_core_source="torchpq_tpu_torch/csrc/block_scan.cu",
                **block_turns(torch, bs, args, kkw, route,
                                 f"{name} on the {label} n_probe={n_probe} "
                                 "search's arguments"))
            if is_wg(route):
                inst = wg_instance(pack32, k_pair, d)
                rows[name].update(instance=inst, sass=SASS.get(inst))
    return rows


def phase_gather_main(torch, gr, index):
    """The row gather on the main path's own arguments: the decoded rows
    of the main index's compacted layout (its addr_map, clipped as
    _gather_compact clips it), against the plain version and against one
    library call (torch.index_select, the same function on in-range
    indices). Returns the kernel's JSON row without its launch count."""
    table = index.aux("decoded")
    idx = index._compact_cache[1][3].long().clamp(min=0)
    got = gr.gather_rows(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, gr.gather_rows_ref(table, idx)):
        fail("gather_rows differs from its plain version on the main path's "
             "compaction")
    ms = cuda_ms(torch, lambda: gr.gather_rows(table, idx), 20)
    plain_ms = cuda_ms(torch, lambda: gr.gather_rows_ref(table, idx), 5)
    lib_ms = cuda_ms(torch, lambda: torch.index_select(table, 0, idx), 20)
    row_b = table.shape[1] * table.element_size()
    b_ms, b_by = bound(0.0, idx.numel() * (2 * row_b + 8), "bf16")
    log(f"gather_rows on the compaction's rows ({idx.numel()} x {row_b} B):"
        f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, index_select "
        f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms")
    return dict(name="gather_rows", route="cuda",
                source="torchpq_tpu_torch/csrc/gather_rows.cu",
                replaces="torchpq_tpu/ops/pallas_gather.py:39",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def phase_relayout(torch, tp, index, trained, base, xq, per_cell, k):
    """A second index with the same trained codecs but cells of a quarter
    the main index's initial size, filled by the same four adds: the adds
    must relayout, and the store and the exact probed search must equal the
    main index's."""
    d, n_cells = index.d_vector, index.n_cells
    small = tp.IVFPQIndex(d_vector=d, n_subvectors=index.n_subvectors,
                          n_cells=n_cells, initial_size=per_cell // 4,
                          distance="euclidean", device="cuda")
    small.load_state_dict(trained)
    first_cap = small.max_cell_capacity
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = base.shape[0] // 4
    for i in range(0, base.shape[0], step):
        small.add(torch.from_numpy(base[i:i + step]).cuda().T)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    log(f"relayout index: initial cell capacity {first_cap}, after the adds "
        f"{small.max_cell_capacity}; add {add_s:.2f} s")
    if small.max_cell_capacity <= first_cap:
        fail("the adds into the small-cell index did not relayout")
    if not np.array_equal(small._cell_size_np, index._cell_size_np):
        fail("the relayout index holds other cell sizes than the main index")
    for idx in (index, small):
        idx.scan_mode, idx.n_probe, idx.use_approx_topk = "cell_major", 8, \
            False
    v, i = index.search(xq.T, k=k)
    v_s, i_s = small.search(xq.T, k=k)
    agree = recall_at(i_s.long(), i.long())
    if not torch.equal(v_s, v) or agree < 0.999:
        fail(f"relayout index disagrees with the main index: id agreement "
             f"{agree:.5f}, max value diff {float((v_s - v).abs().max())}")
    log(f"relayout index vs main index (exact, n_probe=8, {xq.shape[0]} "
        f"queries): values equal, id agreement {agree:.5f}")
    del small


# every time_plans row's ms by (label, plan, n_probe, approx, k)
TIMED = {}


def time_plans(torch, tp, index, xq, gt, k, launches, label,
               short_ok=False, plans=None, floors=True, plain_ok=()):
    """Each plan of PLANS on `index`: the warm-up search, then the median of
    3 host-clock searches to torch.cuda.synchronize(), q/s, recall@k and
    the kernel launches per search (from the counters in `launches`).
    Fails on a malformed result or a probed plan that launched nothing,
    but for the plans in `plain_ok`, which must then have run the plain
    select (the JAX package's gate sends them to XLA: k_pair above 64
    where the completeness floor lifts it, at n_probe 1 and k = 100).

    short_ok: pack32 plans may return fewer than k results (-inf / -1) for
    a query. The code-domain kernel groups columns, and with g = 2 a group
    holds slots 2j and 2j+1, so a cell of n live items fills only
    ceil(n / 2) groups: at n_probe=1 a cell under 2k items comes up short,
    as in the JAX package's kernel; and at k = 100 a query whose probed
    cells hold fewer than k live items comes up short in either package."""
    n_query = xq.shape[0]
    rows, results = [], {}
    for mode, n_probe, approx in plans or PLANS:
        index.scan_mode = mode
        index.n_probe = n_probe
        index.use_approx_topk = approx
        vals, ids = index.search(xq.T, k=k)  # warm-up (builds layouts)
        torch.cuda.synchronize()
        before = dict(launches)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            vals, ids = index.search(xq.T, k=k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launched = sum(launches[x] - before[x] for x in before) // 3
        if tuple(vals.shape) != (n_query, k) or tuple(ids.shape) != \
                (n_query, k):
            fail(f"{label}{mode} np={n_probe}: result shape "
                 f"{tuple(vals.shape)}")
        dead = ~torch.isfinite(vals)
        if bool(torch.isnan(vals).any()) or bool((vals == torch.inf).any()) \
                or not torch.equal(dead, ids < 0):
            fail(f"{label}{mode} np={n_probe}: NaN or +inf values, or dead "
                 "values and missing ids apart")
        short = int(dead.any(1).sum())
        if short and not (short_ok and approx and mode == "cell_major"):
            fail(f"{label}{mode} np={n_probe}: {short} queries with fewer "
                 f"than {k} results")
        ms = float(np.median(times)) * 1e3
        rec = recall_at(ids.long(), gt)
        gate = tp.ops.adc.LAST_GATE
        row = dict(plan=mode, n_probe=n_probe, approx=approx, ms=ms,
                   qps=n_query / ms * 1e3, **{f"recall_at_{k}": rec},
                   kernel_launches=launched, short_rows=short,
                   select=gate.get("impl") if mode == "cell_major" else None,
                   s_eff=gate.get("s_eff") if mode == "cell_major" else None)
        rows.append(row)
        TIMED[(label, mode, n_probe, approx, k)] = ms
        results[(mode, n_probe, approx)] = (vals, ids)
        log(label + json.dumps(row))
        if (mode, n_probe, approx) in plain_ok:
            if launched or gate.get("impl") != "block_select":
                fail(f"{label}cell_major np={n_probe}: expected the plain "
                     f"select, got {gate}")
        elif mode == "cell_major" and launched <= 0:
            fail(f"{label}cell_major np={n_probe} did not launch the kernel")
    rec = {(r["plan"], r["n_probe"], r["approx"]): r[f"recall_at_{k}"]
           for r in rows}
    if not floors:
        return rec, results
    if rec[("flat", 1, True)] < 0.85:
        fail(f"{label}flat recall@10 {rec[('flat', 1, True)]:.4f} < 0.85")
    if rec[("cell_major", 32, True)] < 0.75:
        fail(f"{label}n_probe=32 recall@10 "
             f"{rec[('cell_major', 32, True)]:.4f} < 0.75")
    r1, r8, r32 = (rec[("cell_major", p, True)] for p in (1, 8, 32))
    if r8 < r1 - 0.005 or r32 < r8 - 0.005:
        fail(f"{label}recall falls with n_probe: {r1:.4f} {r8:.4f} "
             f"{r32:.4f}")
    return rec, results


def phase_code_domain(torch, tp, bs, cs, sl):
    """The code-domain tier at the slice's shape: the main index's trained
    codecs and adds in an index that keeps only codes and norms; every
    plan, held to the floors and to the main index's results; then the
    codes kernel against its plain version and against the block-scan
    kernel over the decoded rows, on the phase's own kernel arguments.
    Returns (launch counts, the codes kernels' JSON rows)."""
    index, base, xq, gt, k = (sl[x] for x in ("index", "base", "xq", "gt",
                                              "k"))
    code = tp.IVFPQIndex(d_vector=index.d_vector,
                         n_subvectors=index.n_subvectors,
                         n_cells=index.n_cells, initial_size=sl["per_cell"],
                         distance="euclidean", scan_cache_dtype="none",
                         device="cuda")
    code.load_state_dict(sl["trained"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = base.shape[0] // 4
    for i in range(0, base.shape[0], step):
        code.add(torch.from_numpy(base[i:i + step]).cuda().T)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    if "decoded" in code._aux or hasattr(code, "_aux_decoded"):
        fail("the code-domain index holds a decoded store")
    if not np.array_equal(code._cell_size_np, index._cell_size_np):
        fail("the code-domain index holds other cell sizes")
    codes_b = code._storage.numel() * code._storage.element_size()
    norm_b = code.aux("norm").numel() * 4
    dec = index.aux("decoded")
    dec_b = dec.numel() * dec.element_size()
    comp_b = (index._compact_cache[1][0].numel() * dec.element_size()
              if index._compact_cache is not None else 0)
    log(f"code-domain index: add {add_s:.2f} s; storage {tuple(code._storage.shape)}"
        f" uint8 (pack_group {code.pack_group}); device bytes: codes "
        f"{codes_b}, norms {norm_b}; main index: decoded cache {dec_b}, "
        f"compacted copy {comp_b}, norms {index.aux('norm').numel() * 4}, "
        f"codes {index._storage.numel()}")

    for key in cs.launches:
        cs.launches[key] = 0
    rec, res = time_plans(torch, tp, code, xq, gt, k, cs.launches,
                          "code-domain ", short_ok=True)
    counts = dict(cs.launches)
    log(f"code-domain launches: {counts}")
    require_codes_wg(counts, "the code-domain slice")

    # the same exact probed search on the main index: equal results
    index.scan_mode, index.n_probe, index.use_approx_topk = "cell_major", 8, \
        False
    v_m, i_m = index.search(xq.T, k=k)
    v_c, i_c = res[("cell_major", 8, False)]
    agree = recall_at(i_c.long(), i_m.long())
    verr = float((v_c - v_m).abs().max())
    log(f"code-domain vs main index, exact n_probe=8: id agreement "
        f"{agree:.5f}, max value diff {verr:.3g}")
    if agree < 0.999 or bool(((v_c - v_m).abs()
                              > TOL_REL * v_m.abs() + TOL_ABS).any()):
        fail("the code-domain exact n_probe=8 result differs from the main "
             "index's")
    index.scan_mode, index.use_approx_topk = "flat", True
    _, i_mf = index.search(xq.T, k=k)
    agree = recall_at(res[("flat", 1, True)][1].long(), i_mf.long())
    rec_main = recall_at(i_mf.long(), gt)
    log(f"code-domain vs main index, flat: id agreement {agree:.5f}, "
        f"recall {rec[('flat', 1, True)]:.4f} vs {rec_main:.4f}")
    if agree < 0.99 or abs(rec[("flat", 1, True)] - rec_main) > 0.005:
        fail("the code-domain flat result differs from the main index's")

    planner_sweep(torch, tp, code, xq, "code", nq_probes=(8,))
    # the kernels on the arguments the code-domain searches give them
    return counts, codes_rows(torch, tp, bs, cs, code, xq, k,
                              "code-domain"), code


def require_codes_wg(counts, what):
    """Fails unless both wgmma codes keys (CODES_WG_KEYS) launched and no
    other codes route did."""
    for name, c in counts.items():
        if (c <= 0) == (name in CODES_WG_KEYS):
            fail(f"{what} launched the codes kernel route {name} {c} times: "
                 f"its probed plans must run the wgmma codes instances "
                 f"{CODES_WG_KEYS}, both selects, and no other")


def codes_rows(torch, tp, bs, cs, code, xq, k, label, suffix=""):
    """The codes kernels on the arguments a code-domain index's searches
    give them: the exact n_probe=8 and pack32 n_probe=32 searches' codes
    scans, each checked with both selects (check_codes: the tensor-core
    kernel against codes_scan_ref on live rows, pad rows dead; the
    CUDA-core one on every row), and against the tensor-core block scan
    over the decoded bf16 rows; then the select each search ran timed on
    its route and the CUDA-core codes kernel in turns (with --parent, and
    on the parent's kernels: codes_parent_turns). Returns the kernels' JSON rows
    (names codes_scan_exact / codes_scan_pack32 + suffix) without their
    launch counts."""
    rows = {}
    onehot = tp.ops.onehot_adc
    decoded = None
    for n_probe, approx in ((8, False), (32, True)):
        code.scan_mode, code.n_probe = "cell_major", n_probe
        code.use_approx_topk = approx
        args, kw = capture_call(tp, code, xq, k, module=onehot,
                                name="codes_scan")
        s_eff, k_pair = kw["s_eff"], kw["k_pair"]
        blocks, p_tile = args[1].shape
        live = int((args[1] >= 0).sum())
        live_tiles = int((args[1].view(blocks, -1, 16) >= 0).any(-1).sum())
        m = args[7].shape[0]
        d = args[0].shape[1]
        log(f"{label} path n_probe={n_probe} "
            f"({'pack32' if approx else 'exact'}): {blocks} blocks x "
            f"{p_tile} probers, {live} live ({live / (blocks * p_tile):.3f})"
            f", {live_tiles} live 16-prober tiles of {blocks * p_tile // 16}"
            f", s_eff={s_eff}, k_pair={k_pair}, m={m}, "
            f"g={args[6].shape[1] // m}")
        if decoded is None:
            decoded = cs.decode_codes(args[6].view(-1, m), args[7]) \
                .contiguous()
        bs_args = list(args[:6]) + [decoded]
        for pack32 in (False, True):
            err, agree, _, _ = check_codes(
                torch, bs, cs, args, s_eff=s_eff, k_pair=k_pair,
                pack32=pack32, euclidean=kw["euclidean"], reps=0)
            name = ("codes_scan_pack32" if pack32 else "codes_scan_exact") \
                + suffix
            log(f"{name} (tensor cores) on the inputs of the {label} "
                f"n_probe={n_probe} search: live rows max_abs_err {err:.3g}"
                + (f", key agreement {agree:.7f}" if pack32 else "")
                + "; pad rows dead; the CUDA-core kernel matches the plain "
                "version on every row")
            kkw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=kw["euclidean"],
                       pack32=pack32, slot_mask=kw["slot_mask"])
            got = cs.codes_scan(*args, **kkw)
            ref = bs.block_scan(*bs_args, **kkw)
            torch.cuda.synchronize()
            sel = args[1] >= 0
            # one kernel body over the same bf16 rows, but the codes
            # kernel visits the slots in its deinterleaved column order:
            # exact ties may keep other slots, and pack32 groups columns,
            # not slots: keys may differ
            vs = "  vs block_scan (tensor cores) over the decoded rows"
            if pack32:
                log(f"{vs} (live rows): key agreement "
                    f"{share_equal(got[sel], ref[sel]):.5f}")
            else:
                err_b = compare_exact(torch, bs, got[sel], ref[sel], k_pair)
                log(f"{vs} (live rows): "
                    f"values within tolerance (max_abs_err {err_b:.3g}), "
                    f"addresses equal at separated values")
            if pack32 != approx:
                continue
            # the select the search ran: its route and the CUDA-core codes
            # kernel in turns
            mode = "pack32" if pack32 else "exact"
            route = cs.pick_route(m=m, dsub=args[7].shape[2],
                                  p_tile=p_tile, s_eff=s_eff, k_pair=k_pair,
                                  pack32=pack32)
            if route not in CODES_WG_KEYS:
                fail(f"{name} routes to {route}, not the wgmma codes "
                     "instances")
            (t, turns) = in_turns(torch, {
                "cuda_cores": lambda: codes_launch(torch, cs, args, mode,
                                                   **kkw),
                "tensor_cores": lambda: codes_launch(torch, cs, args, route,
                                                     **kkw)},
                20)
            parent = codes_parent_turns(
                torch, bs, cs, args, kkw, route,
                f"{name} on the {label} n_probe={n_probe} search")
            ms, cc_ms = t["tensor_cores"], t["cuda_cores"]
            plain_ms = cuda_ms(torch, lambda: cs.codes_scan_ref(*args,
                                                                **kkw), 3)
            bs_ms = cuda_ms(torch, lambda: bs.block_scan(*bs_args, **kkw),
                            20)
            b_ms, b_by = scan_bound(
                torch, args, kkw, slot_bytes=m + 4, row_bytes=2 * d,
                peak="bf16", d=d, extra_bytes=args[7].numel() * 2)
            flop = 2.0 * live * s_eff * d
            log(f"  {name} on the {label} n_probe={n_probe} search's "
                f"arguments: "
                f"tensor cores {ms:.3f} ms ("
                f"{' / '.join(f'{x:.3f}' for x in turns['tensor_cores'])}; "
                f"{flop / ms / 1e9:.2f} TFLOP/s over live probers, "
                f"{b_ms / ms:.1%} of the bound), CUDA cores {cc_ms:.3f} ms "
                f"({' / '.join(f'{x:.3f}' for x in turns['cuda_cores'])}), "
                f"speed-up {cc_ms / ms:.2f}x; plain {plain_ms:.3f} ms, "
                f"bound {b_ms:.3f} ms ({b_by}); block_scan (tensor cores) over "
                f"the decoded rows {bs_ms:.3f} ms")
            rows[name] = dict(
                name=name, route="cuda", source=codes_source(route),
                replaces="torchpq_tpu/ops/pallas_codes_scan.py:198",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                launch_key=route,
                instance=codes_instance(pack32, k_pair),
                cuda_core_ms=cc_ms,
                cuda_core_source="torchpq_tpu_torch/csrc/codes_scan.cu",
                **parent)
    del decoded
    return rows


def profile_complete(prof):
    """(kernel records, kernel launches) of a profiler session: the
    device's records but copies and fills, and the host's launch calls
    (cudaLaunchKernel, cuLaunchKernelEx); a session that kept every record
    holds at least as many records as launches."""
    from torch.autograd import DeviceType
    recorded = launched = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            recorded += not e.name.startswith(("Memcpy", "Memset"))
        elif "LaunchKernel" in e.name:
            launched += 1
    return recorded, launched


def profile_search(torch, search, what, host_ops=False, complete=False):
    """torch.profiler over one call of search() after a warm-up one:
    device-busy time (the sum of the kernels' own device times) and the
    largest kernels; with host_ops also the host's wall time and its
    largest operators by self CPU time. A session that records no kernel
    (complete: fewer kernels than the host launched, profile_complete) is
    run again, up to PROFILE_TRIES sessions; then the run fails. Returns
    (busy ms, [(kernel name, device ms)] largest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    search()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            search()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        recorded, launched = profile_complete(prof)
        if recorded >= (launched if complete else 1):
            break
        # the card's profiler drops kernel records: at times all of a
        # session's, and later in a run the first few of every session
        # (PERF.md section 7)
        log(f"profile of {what}: {recorded} kernel records of {launched} "
            f"launches; profiling again")
    else:
        fail(f"profile of {what}: {recorded} kernel records of {launched} "
             f"launches in each of {PROFILE_TRIES} sessions")
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = "; ".join(f"{e.key[:48]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.3f} ms"
                    for e in kernels[:5])
    log(f"profile {what}: device busy {busy:.3f} ms ({recorded} kernels of "
        f"{launched} launches recorded); {top}")
    by_name = [(e.key, e.self_device_time_total / 1e3) for e in kernels]
    if host_ops:
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CPU),
                     key=lambda e: -e.self_cpu_time_total)
        log(f"profile {what}: host wall {wall:.3f} ms (profiled); "
            + "; ".join(f"{e.key[:40]} x{e.count} "
                        f"{e.self_cpu_time_total / 1e3:.3f} ms"
                        for e in ops[:8]))
    return busy, by_name


def phase_profile(torch, index, xq, k, label="", plans=None):
    """profile_search over one search per plan of an index."""
    for mode, n_probe, approx in plans or PLANS:
        index.scan_mode, index.n_probe = mode, n_probe
        index.use_approx_topk = approx
        profile_search(torch, lambda: index.search(xq.T, k=k),
                       f"{label}{mode} n_probe={n_probe} approx={approx}")


def profile_pallas_flat(torch, sl):
    """The pallas_flat flat plan on the main index (phase 19's profile),
    profiled before the other phases: later in a run the card's profiler
    drops the first kernel records of each session, and the flat kernel is
    among its search's first launches. Every kernel launched must be
    recorded. The index's plan settings are restored after."""
    index = sl["index"]
    keep = (index.scan_impl, index.scan_mode, index.n_probe,
            index.use_approx_topk)
    index.scan_impl, index.scan_mode = "pallas_flat", "flat"
    index.n_probe, index.use_approx_topk = 1, True
    profile_search(torch, lambda: index.search(sl["xq"].T, k=sl["k"]),
                   "pallas_flat flat n_probe=1 approx=True", complete=True)
    (index.scan_impl, index.scan_mode, index.n_probe,
     index.use_approx_topk) = keep


def build_index(torch, tp, trained, base, *, d, m, n_cells, per_cell,
                cache, spill=False, cls=None, **kw):
    """An index (cls, default IVFPQIndex) with the given scan cache tier
    (and constructor kwargs), the trained codecs loaded, filled by four
    adds of a quarter each; spill: 8 candidate cells at the initial cell
    capacity (the JAX package's sweep default). Returns (index, add
    seconds)."""
    index = (cls or tp.IVFPQIndex)(
        d_vector=d, n_subvectors=m, n_cells=n_cells, initial_size=per_cell,
        distance="euclidean", scan_cache_dtype=cache, device="cuda", **kw)
    index.load_state_dict(trained)
    if spill:
        index.spill_cells = 8
        index.spill_capacity = index.max_cell_capacity
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = base.shape[0] // 4
    for i in range(0, base.shape[0], step):
        index.add(torch.from_numpy(base[i:i + step]).cuda().T)
    torch.cuda.synchronize()
    return index, time.perf_counter() - t0


def int8_kernel_rows(torch, tp, bs, index, xq, k, label, suffix="",
                     reps=20):
    """Both int8 kernels against the plain version on the arguments an int8
    index's exact n_probe=8 and pack32 n_probe=32 searches give them (both
    selects on each, bit for bit: the tensor-core one on live rows with pad
    rows dead, the CUDA-core one on every row); then the select each search
    ran timed on both in turns (reps launches a turn). Returns the JSON
    rows of those selects (names + suffix), the route that served each."""
    rows = {}
    for n_probe, approx in ((8, False), (32, True)):
        index.scan_mode, index.n_probe = "cell_major", n_probe
        index.use_approx_topk = approx
        args, kw = capture_call(tp, index, xq, k)
        s_eff, k_pair = kw["s_eff"], kw["k_pair"]
        blocks, p_tile = args[1].shape
        live = int((args[1] >= 0).sum())
        live_tiles = int((args[1].view(blocks, -1, 16) >= 0).any(-1).sum())
        d = args[6].shape[1]
        log(f"{label}path n_probe={n_probe} "
            f"({'pack32' if approx else 'exact'}): {blocks} blocks x "
            f"{p_tile} probers, {live} live ({live / (blocks * p_tile):.3f})"
            f", {live_tiles} live 16-prober tiles of {blocks * p_tile // 16}"
            f", s_eff={s_eff}, k_pair={k_pair}, d_cache={d}")
        extra = dict(scale=kw["scale"], q_scale=kw["q_scale"])
        for pack32 in (False, True):
            err = check_kernel(torch, bs, args, s_eff=s_eff, k_pair=k_pair,
                               pack32=pack32, euclidean=kw["euclidean"],
                               equal=True, extra=extra, reps=0)[0]
            mode = "pack32" if pack32 else "exact"
            route = bs.pick_route(dtype=args[6].dtype, d=d, p_tile=p_tile,
                                  s_eff=s_eff, k_pair=k_pair, pack32=pack32)
            name = "block_scan_int8_" + mode + suffix
            log(f"{name} ({route}) on the inputs of the {label}n_probe="
                f"{n_probe} search: equal to the plain version bit for bit"
                + ("; pad rows dead; the CUDA-core kernel equal on every row"
                   if route.startswith("tc_") else ""))
            if pack32 != approx:
                continue
            kkw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=kw["euclidean"],
                       pack32=pack32, slot_mask=kw["slot_mask"], **extra)
            t, turns = in_turns(torch, {
                "cuda_cores": lambda: block_launch(torch, bs, args,
                                                   "int8_" + mode, **kkw),
                route: lambda: block_launch(torch, bs, args, route, **kkw)},
                reps)
            ms, cc_ms = t[route], t["cuda_cores"]
            plain_ms = cuda_ms(torch, lambda: bs.block_scan_ref(*args, **kkw),
                               1 if suffix else 3)
            b_ms, b_by = scan_bound(torch, args, kkw, slot_bytes=d + 8,
                                    row_bytes=d + 4, peak="int8", d=d)
            ops = 2.0 * s_eff * d
            log(f"  {name} on the {label}n_probe={n_probe} search's "
                f"arguments: {route} {ms:.3f} ms ("
                f"{' / '.join(f'{x:.3f}' for x in turns[route])}; "
                f"{ops * live / ms / 1e9:.2f} TOP/s over live probers, "
                f"{ops * 16 * live_tiles / ms / 1e9:.2f} over live tiles, "
                f"{b_ms / ms:.1%} of the bound), CUDA cores {cc_ms:.3f} ms "
                f"({' / '.join(f'{x:.3f}' for x in turns['cuda_cores'])}; "
                f"{ops * live / cc_ms / 1e9:.2f} TOP/s over live probers), "
                f"speed-up {cc_ms / ms:.2f}x; plain {plain_ms:.3f} ms, bound "
                f"{b_ms:.3f} ms ({b_by})")
            rows[name] = dict(
                name=name, route="cuda", source=route_source(route),
                replaces="torchpq_tpu/ops/pallas_scan.py:281",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, launch_key=route,
                cuda_core_ms=cc_ms,
                cuda_core_source="torchpq_tpu_torch/csrc/block_scan.cu",
                **block_turns(torch, bs, args, kkw, route,
                                 f"{name} on the {label}n_probe={n_probe} "
                                 "search's arguments"))
            if is_wg(route):
                inst = wg_instance(pack32, k_pair, d, int8=True)
                rows[name].update(instance=inst, sass=SASS.get(inst))
    return rows


def phase_int8(torch, tp, bs, sl):
    """The int8 tier at the slice's shape: the main index's trained codecs
    and adds in an index whose cache rows are int8 with per-slot scales;
    the five plans with the launch counters zeroed before and read after,
    each plan's recall within 0.005 of the bf16 tier's; then the int8
    kernel on the phase's own arguments. Returns (launch counts, the int8
    kernels' JSON rows, the index)."""
    index, base, xq, gt, k = (sl[x] for x in ("index", "base", "xq", "gt",
                                              "k"))
    i8, add_s = build_index(torch, tp, sl["trained"], base,
                            d=index.d_vector, m=index.n_subvectors,
                            n_cells=index.n_cells, per_cell=sl["per_cell"],
                            cache="int8")
    dec = i8.aux("decoded")
    if dec.dtype != torch.int8 or dec.shape[1] != index.d_vector:
        fail(f"the int8 index holds a {dec.dtype} cache {tuple(dec.shape)}")
    if not np.array_equal(i8._cell_size_np, index._cell_size_np):
        fail("the int8 index holds other cell sizes than the main index")
    for key in bs.launches:
        bs.launches[key] = 0
    rec, _ = time_plans(torch, tp, i8, xq, gt, k, bs.launches, "int8 ")
    counts = dict(bs.launches)
    log(f"int8 launches: {counts}")
    require_only_tc(counts, INT8_KEYS, "the int8 tier")
    for plan, r in rec.items():
        if abs(r - sl["rec"][plan]) > 0.005:
            fail(f"int8 plan {plan}: recall {r:.4f} vs the bf16 tier's "
                 f"{sl['rec'][plan]:.4f}")
    comp = i8._compact_cache[1] if i8._compact_cache is not None else None
    log(f"int8 index: add {add_s:.2f} s; device bytes: int8 cache "
        f"{dec.numel()}, scales {i8.aux('scale').numel() * 4}, norms "
        f"{i8.aux('norm').numel() * 4}, codes {i8._storage.numel()}, "
        f"compacted copy "
        f"{0 if comp is None else comp[0].numel() + comp[4].numel() * 4}; "
        f"recall within 0.005 of the bf16 tier on every plan")
    rows = int8_kernel_rows(torch, tp, bs, i8, xq, k, "int8 ")
    planner_sweep(torch, tp, i8, xq, "int8", nq_probes=(8,))
    return counts, rows, i8


# the JAX package's deep-k record (benchmark/results/
# ivf4096_pq64_sift1m_deepk_r6_g8c64kp64t8_16.json): supercells of 8 cells,
# at most 64 of them per query, k_pair 64, the merge taper (8, 16) run as
# the split (super-probe and split taper on by default), n_probe 128, k 100
DEEPK_K, DEEPK_NPROBE, DEEPK_GROUP = 100, 128, 8
DEEPK_R6 = dict(scan_group=DEEPK_GROUP, scan_probe_cap=64, scan_k_pair=64,
                scan_merge_taper=(8, 16), scan_super_probe=True,
                scan_split_taper=True)
# the yardstick: the same index untapered (no supercells, cap or taper)
DEEPK_PLAIN = dict(scan_group=1, scan_probe_cap=None, scan_k_pair=None,
                   scan_merge_taper=None)


def spill_recorder(tp, seen):
    """Wrap the index's spill routing so each add's candidates, the
    occupancy before it and its result land in `seen`; returns the
    function that restores the original."""
    mod = tp.index.ivfpq
    orig = mod.spill_assign_device

    def record(top, cell_size, **kw):
        before = cell_size.clone()
        chosen, counts = orig(top, cell_size, **kw)
        seen.append((top, before, chosen, counts, kw["cap"]))
        return chosen, counts

    mod.spill_assign_device = record
    return lambda: setattr(mod, "spill_assign_device", orig)


def check_spill(torch, seen):
    """Each add's spill routing held to its rule: every item went to one of
    its candidates, to its best one wherever that cell stayed below the
    capacity; a cell ends above the capacity only through items all of
    whose candidates ended full (the all-full fallback). Returns the count
    of items placed above the capacity."""
    over = 0
    for top, before, chosen, counts, cap in seen:
        after = before.long() + counts.long()
        c = chosen.long()
        top = top.long()
        if not bool((top == c[:, None]).any(1).all()):
            fail("spill: an item went to a cell outside its candidates")
        best_open = after[top[:, 0]] < cap
        if not bool((c[best_open] == top[best_open, 0]).all()):
            fail("spill: an item whose best cell stayed open went elsewhere")
        overfull = after[c] > cap
        all_full = (after[top] >= cap).all(1)
        if not bool(all_full[overfull].all()):
            fail("spill: a cell went above the capacity while an item in it "
                 "had a candidate with room")
        over += int((after - torch.maximum(before.long(), torch.full_like(
            after, cap))).clamp(min=0).sum())
    return over


def one_key_ms(torch, bs, args, kw, reps):
    """The warp-specialised pack32 launch on a scan's own arguments (bf16,
    or int8 where kw holds its scales), but writing k_pair = 1 key per row
    over the same strided groups: the same tiles, products, group maxima
    and phases on the instance and ring stages of the real launch's k_pair
    (torchpq_block_scan_wg_instance), with one extraction pass and one
    merge step per phase on the instances of k_pair <= 16, and on the deep
    ones each phase's survivors of a one-key list (a few a row). The
    difference to the real launch is what the rest of the select costs (the
    passes or the merges, the writes). Mean CUDA-event ms over reps
    launches (none counted)."""
    from torchpq_tpu_torch import _build
    lib = _build.library()
    b, p_tile = args[1].shape
    d = args[6].shape[1]
    int8 = kw.get("scale") is not None
    name = "torchpq_block_scan_wg" + ("_int8" if int8 else "")
    groups = bs.n_groups(kw["s_eff"], kw["k_pair"])
    n_ctas = bs.resident_ctas(lib, name + "_occupancy", args[6].device, d,
                              1, kw["k_pair"])
    out = torch.empty((b, p_tile, 1), dtype=torch.int32,
                      device=args[1].device)
    ptrs = [t.data_ptr() for t in args]
    if int8:  # the entry's order: q8, q_scale, ..., penalty, scale, y8
        ptrs = ptrs[:1] + [kw["q_scale"].data_ptr()] + ptrs[1:6] + [
            kw["scale"].data_ptr(), ptrs[6]]

    def run():
        rc = getattr(lib, name + "_instance")(
            *ptrs, out.data_ptr(), b, p_tile, d, args[6].shape[0],
            kw["s_eff"], 1, int(kw["euclidean"]), 1, kw["slot_mask"], groups,
            min(n_ctas, b), torch.cuda.current_stream().cuda_stream,
            kw["k_pair"])
        if rc != 0:
            fail(f"the one-key tensor-core launch failed: CUDA error {rc}")

    return cuda_ms(torch, run, reps)


def scan_recorder(tp, seen):
    """Wrap the block-scan wrapper that ops/adc.py calls so that each call's
    k_pair lands in `seen` (the split's head and tail scans differ in it);
    returns the function that restores the original."""
    mod = tp.ops.adc
    orig = mod.block_scan

    def record(*args, **kw):
        seen.append(kw["k_pair"])
        return orig(*args, **kw)

    mod.block_scan = record
    return lambda: setattr(mod, "block_scan", orig)


def pack32_f64(torch, bs, args, kw):
    """block_scan_ref's pack32 select (bf16 cache) over scores summed in
    f64 and rounded once to f32: the scores every f32 summation order
    approximates."""
    s_eff, dev = kw["s_eff"], args[1].device
    factor = 2.0 if kw["euclidean"] else 1.0

    def scores(sl):
        probers, start_c, off, cap = (args[i][sl] for i in (1, 2, 3, 4))
        slot = torch.arange(s_eff, device=dev)
        rows = start_c.long()[:, None] + slot[None]
        in_cell = (slot[None] >= off[:, None]) \
            & (slot[None] < (off + cap)[:, None])
        pen = args[5][rows] + torch.where(in_cell, 0.0, bs.BIG)
        ab = torch.bmm(args[0][probers.clamp(min=0).long()].double(),
                       args[6][rows].double().transpose(1, 2))
        return (factor * ab - pen[:, None, :].double()).float()

    return bs.select_chunks(
        scores, lambda sc, _: bs.select_pack32(sc, kw["k_pair"],
                                               kw["slot_mask"]),
        args[1], args[2], s_eff=s_eff, width=kw["k_pair"], cost=6)


def pack32_scan_row(torch, bs, name, args, kw, what, against_f64=False):
    """One pack32 scan (the deep-k, 4-bit and residual phases') on its
    search's own arguments: it must route to the tensor-core pack32 kernel; held to block_scan_ref (live rows, >= 0.99
    of the keys equal; pad rows dead; the CUDA-core kernel on every row),
    then timed in turns with block_scan.cu on the same arguments, and the
    same launch writing one key per row. A key keeps 31 - log2(s_eff)
    value bits, which at s_eff 512 are finer than any f32 summation order
    holds at these scores (2 <q, y> - |y|^2 cancels): where the plain
    version's own keys agree with the f64-summed select's on fewer than
    0.99 of the entries, no other order can reach 0.99 against it, and the
    scan is held to >= 0.99 equal slots instead, each with its value within
    the tolerance (compare_pack32's by_slot); every agreement is logged.
    against_f64: the kernel is held to the f64-summed select itself, by
    the same rule, with the values within the tolerance (its ratio to it
    logged), and the CUDA-core kernel to it by slot, its values within the
    tolerance plus the bound of an f32 sum of their terms (sum_slack, the
    f32 side only: at d_cache 1024 its one sequential chain comes near the
    tolerance where the score cancels, 2 <q, y> ~ |y|^2 ~ 1e3); each
    kernel's keys equal over two launches.
    Returns the kernels-line row."""
    s_eff, k_pair = kw["s_eff"], kw["k_pair"]
    blocks, p_tile = args[1].shape
    d = args[6].shape[1]
    live = int((args[1] >= 0).sum())
    live_tiles = int((args[1].view(blocks, -1, 16) >= 0).any(-1).sum())
    route = bs.pick_route(dtype=args[6].dtype, d=d, p_tile=p_tile,
                          s_eff=s_eff, k_pair=k_pair, pack32=True)
    groups = bs.n_groups(s_eff, k_pair)
    log(f"{what}: {blocks} blocks x {p_tile} probers, {live} live "
        f"({live / (blocks * p_tile):.3f}), {live_tiles} live 16-prober "
        f"tiles, s_eff={s_eff}, k_pair={k_pair}, G={groups}, route {route}")
    if route not in ("tc_wgn_pack32", "tc_wg_pack32"):
        fail(f"{what} routes to {route}, not the tensor cores")
    kkw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=kw["euclidean"],
               pack32=True, slot_mask=kw["slot_mask"])
    alive = args[1] >= 0
    full = pack32_f64(torch, bs, args, kkw)
    exact = full[alive]
    tc = block_launch(torch, bs, args, route, **kkw)
    plain_f64 = share_equal(bs.block_scan_ref(*args, **kkw)[alive], exact)
    tc_f64 = share_equal(tc[alive], exact)
    by_slot = plain_f64 < 0.99
    if against_f64:
        # the routed kernel: pad rows dead, keys equal over two launches,
        # held to the f64-summed select within the tolerance (no sum_slack)
        slack = entry_slack(torch, args, full, k_pair=k_pair, pack32=True,
                            slot_mask=kkw["slot_mask"],
                            euclidean=kw["euclidean"], sides=1)
        cc = block_launch(torch, bs, args, "pack32", **kkw)
        for name_, out in (("pack32 (CUDA cores)", cc), (route, tc)):
            key = name_.split()[0]
            if key != "pack32" and not dead_rows(torch, bs, out, args[1],
                                                 k_pair, True):
                fail(f"{what}: {key} pad rows are not written dead")
            if not torch.equal(out, block_launch(torch, bs, args, key,
                                                 **kkw)):
                fail(f"{what}: {name_} differs between two launches on the "
                     "same arguments")
        compare_pack32(torch, bs, cc, full, kkw["slot_mask"],
                       "pack32 (CUDA cores) against the f64 select", True,
                       slack)
        err, agree = compare_pack32(torch, bs, tc[alive], exact,
                                    kkw["slot_mask"],
                                    f"{route} against the f64 select",
                                    by_slot, ratio=True)
        del cc, slack
    del exact, tc, full
    if not against_f64:
        err, agree, _, _ = check_kernel(torch, bs, args, s_eff=s_eff,
                                        k_pair=k_pair, pack32=True,
                                        euclidean=kw["euclidean"], reps=0,
                                        by_slot=by_slot)
    t, turns = in_turns(torch, {
        "cuda_cores": lambda: block_launch(torch, bs, args, "pack32", **kkw),
        "tensor_cores": lambda: block_launch(torch, bs, args, route,
                                             **kkw)}, 5)
    ms, cc_ms = t["tensor_cores"], t["cuda_cores"]
    k1_ms = one_key_ms(torch, bs, args, kkw, 5)
    plain_ms = cuda_ms(torch, lambda: bs.block_scan_ref(*args, **kkw), 1)
    b_ms, b_by = scan_bound(torch, args, kkw, slot_bytes=2 * d + 4,
                            row_bytes=2 * d, peak="bf16", d=d)
    flop = 2.0 * live * s_eff * d
    log(f"{name} on {what}'s arguments: {route} {ms:.3f} ms ("
        f"{' / '.join(f'{x:.3f}' for x in turns['tensor_cores'])}), CUDA "
        f"cores {cc_ms:.3f} ms ("
        f"{' / '.join(f'{x:.3f}' for x in turns['cuda_cores'])}), speed-up "
        f"{cc_ms / ms:.2f}x; the tensor-core launch writing one key per row "
        f"(the same products and group maxima over the {groups} groups, one "
        f"extraction pass and one merge step per phase) {k1_ms:.3f} ms; "
        f"{flop / ms / 1e9:.2f} TFLOP/s over live probers, "
        f"{b_ms / ms:.1%} of the bound; plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}); live rows held to "
        f"{'the f64-summed select' if against_f64 else 'block_scan_ref'} by "
        f"{'slot' if by_slot else 'key'}: max_abs_err {err:.3g}, key "
        f"agreement {agree:.7f} (with the f64-summed select: the plain "
        f"version's {plain_f64:.7f}, the kernel's {tc_f64:.7f}); pad rows "
        f"dead; the CUDA-core kernel matches on every row")
    row = dict(
        name=name, route="cuda", source=route_source(route),
        replaces="torchpq_tpu/ops/pallas_scan.py:281",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, launch_key=route, cuda_core_ms=cc_ms,
        cuda_core_source="torchpq_tpu_torch/csrc/block_scan.cu",
        one_key_ms=k1_ms, key_agreement=agree, held_by_slot=by_slot,
        held_against="f64" if against_f64 else "plain",
        **block_turns(torch, bs, args, kkw, route,
                         f"{name} on {what}'s arguments"))
    if is_wg(route):
        inst = wg_instance(True, k_pair, d)
        row.update(instance=inst, sass=SASS.get(inst))
    return row


def deepk_counts(bs, seen, counts, what, s_eff):
    """The block-scan launches of a deep-k run (scans at s_eff): each scan
    call ops/adc.py made launched the tensor-core pack32 route pick_route
    names for its k_pair (the narrow wgmma instances: the deep select's
    above k_pair 16), every such route at least once and no other key;
    returns the calls per k_pair."""
    want = {}
    for kp in seen:
        route = bs.pick_route(dtype=bs.torch.bfloat16, d=128, p_tile=128,
                              s_eff=s_eff, k_pair=kp, pack32=True)
        want[route] = want.get(route, 0) + 1
    for key, n in counts.items():
        if n != want.get(key, 0):
            fail(f"{what} launched block_scan {key!r} {n} times, not "
                 f"{want.get(key, 0)}: {counts} (routes {want})")
    if not want or not all(k.startswith("tc_") for k in want):
        fail(f"{what}: its scans route to {want}, not the tensor cores")
    return {kp: seen.count(kp) for kp in sorted(set(seen))}


def phase_deepk(torch, tp, bs, sl, gt):
    """The JAX package's deep-k configuration (DEEPK_R6) at the slice's
    shape: the main index's trained codecs in an index with the spill on
    (8 candidate cells, capacity the initial per-cell 2 x n / n_cells,
    device route), filled by the same four adds; the r6 plan with the
    block-scan counters zeroed before its searches and read after (both
    sides of the split must launch the tensor-core pack32 kernel, the head
    at k_pair 64 over G = 512 groups, the tail at k_pair 16; the CUDA-core
    kernel never), its gate record (super-probe, split (8, 16), s_eff 8 x
    capacity on both sides), recall@100 against exact f32 ground truth
    within 0.03 of the untapered plan's (gt: the exact top 100 ids;
    DEEPK_PLAIN at n_probe 128, its
    counters zeroed and read the same way: k_pair 64 over G = 256 on the
    tensor cores), the flat plan's recall@100 (the ADC ceiling); then the
    three scans against block_scan_ref on their searches' own arguments,
    each timed in turns with the CUDA-core kernel. Returns ({row name:
    launches}, the three scans' JSON rows, the index with the r6 knobs
    set)."""
    index, base, xq = (sl[x] for x in ("index", "base", "xq"))
    k = DEEPK_K
    n_base, n_cells = base.shape[0], index.n_cells
    per_cell = n_base // n_cells * 2
    deep = tp.IVFPQIndex(d_vector=index.d_vector,
                         n_subvectors=index.n_subvectors, n_cells=n_cells,
                         initial_size=per_cell, distance="euclidean",
                         device="cuda")
    deep.load_state_dict(sl["trained"])
    deep.spill_cells = 8
    deep.spill_capacity = cap = deep.max_cell_capacity
    seen = []
    restore = spill_recorder(tp, seen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = n_base // 4
    for i in range(0, n_base, step):
        deep.add(torch.from_numpy(base[i:i + step]).cuda().T)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    restore()
    if len(seen) != 4:
        fail(f"the deep-k adds routed {len(seen)} of 4 batches by spill")
    over = check_spill(torch, seen)
    del seen
    sizes = deep._cell_size_np
    dec = deep.aux("decoded")
    log(f"deep-k index: spill 8 cells at capacity {cap}; add {add_s:.2f} s; "
        f"largest cell {int(sizes.max())}, {int((sizes >= cap).sum())} cells "
        f"at capacity, {over} items above it (all-full fallback), max cell "
        f"capacity {deep.max_cell_capacity}; device bytes: decoded cache "
        f"{dec.numel() * dec.element_size()}, norms "
        f"{deep.aux('norm').numel() * 4}, codes {deep._storage.numel()}")
    if int(sizes.sum()) != n_base:
        fail(f"the deep-k index holds {int(sizes.sum())} items")
    if int((np.maximum(sizes - cap, 0)).sum()) != over:
        fail("deep-k cells above the capacity beyond the fallback's items")

    # the r6 plan, the path's counters zeroed just before its searches
    for name, value in DEEPK_R6.items():
        setattr(deep, name, value)
    plan = [("cell_major", DEEPK_NPROBE, True)]
    calls = []
    restore = scan_recorder(tp, calls)
    for key in bs.launches:
        bs.launches[key] = 0
    rec, _ = time_plans(torch, tp, deep, xq, gt, k, bs.launches,
                        "deep-k r6 ", plans=plan, floors=False)
    counts = dict(bs.launches)
    restore()
    gate = tp.ops.adc.LAST_GATE
    head, tail = gate.get("head", {}), gate.get("tail", {})
    s_want = DEEPK_GROUP * cap
    per_kp = deepk_counts(bs, calls, counts, "the r6 plan",
                          DEEPK_GROUP * cap)
    log(f"deep-k r6 launches: {counts}, calls per k_pair {per_kp}; gate: "
        f"super_probe {gate.get('super_probe')}, split {gate.get('split')}, "
        f"head {head}, tail {tail}")
    if gate.get("super_probe") is not True or gate.get("split") != (8, 16):
        fail("the r6 plan did not run supercell-native probing and the "
             "split (8, 16)")
    for side, g in (("head", head), ("tail", tail)):
        if g.get("impl") != "block_scan" or g.get("s_eff") != s_want \
                or not g.get("pack32"):
            fail(f"the r6 {side} scan did not run the block scan's pack32 "
                 f"select at s_eff {s_want}: {g}")
    kp_head, kp_tail = head.get("k_pair"), tail.get("k_pair")
    if set(per_kp) != {kp_head, kp_tail} or kp_head == kp_tail:
        fail(f"the r6 scans' k_pair {per_kp} are not the gate's head "
             f"{kp_head} and tail {kp_tail}")
    r6 = rec[plan[0]]

    # the untapered plan, its counters zeroed the same way; then the flat
    # plan (its launches are no block scan's)
    for name, value in DEEPK_PLAIN.items():
        setattr(deep, name, value)
    calls = []
    restore = scan_recorder(tp, calls)
    for key in bs.launches:
        bs.launches[key] = 0
    rec_plain, _ = time_plans(torch, tp, deep, xq, gt, k, bs.launches,
                              "deep-k untapered ", plans=plan, floors=False)
    counts_plain = dict(bs.launches)
    restore()
    per_kp_plain = deepk_counts(bs, calls, counts_plain,
                                "the untapered plan", cap)
    log(f"deep-k untapered launches: {counts_plain}, calls per k_pair "
        f"{per_kp_plain}")
    rec_flat, _ = time_plans(torch, tp, deep, xq, gt, k, bs.launches,
                             "deep-k ", plans=[("flat", 1, True)],
                             floors=False)
    plain = rec_plain[plan[0]]
    planner_point(tp, deep, "deep-k r6", xq.shape[0], k, DEEPK_NPROBE, True,
                  {"flat": TIMED[("deep-k ", "flat", 1, True, k)],
                   "cell_major": TIMED[("deep-k r6 ", *plan[0], k)]}, 3)
    log(f"deep-k recall@{k}: r6 {r6:.5f}, untapered yardstick {plain:.5f} "
        f"(gap {r6 - plain:+.5f}), flat (ADC ceiling) "
        f"{rec_flat[('flat', 1, True)]:.5f}")
    if r6 < plain - 0.03:
        fail(f"the r6 plan's recall@{k} {r6:.5f} is more than 0.03 below "
             f"the untapered yardstick's {plain:.5f}")

    # the three scans on their searches' own arguments
    deep.scan_mode, deep.n_probe = "cell_major", DEEPK_NPROBE
    (plain_args, plain_kw) = capture_call(tp, deep, xq, k)
    rows = {"block_scan_pack32_deepk_untapered": pack32_scan_row(
        torch, bs, "block_scan_pack32_deepk_untapered", plain_args,
        plain_kw, "the untapered search")}
    launches = {"block_scan_pack32_deepk_untapered":
                per_kp_plain[plain_kw["k_pair"]]}
    del plain_args
    for name, value in DEEPK_R6.items():
        setattr(deep, name, value)
    for side, (args, kw) in zip(("head", "tail"), capture_call(
            tp, deep, xq, k, n_calls=2)):
        name = f"block_scan_pack32_deepk_{side}"
        rows[name] = pack32_scan_row(torch, bs, name, args, kw,
                                    f"the r6 search's {side}")
        launches[name] = per_kp[kw["k_pair"]]
    return launches, rows, deep


# the JAX package's 4-bit record (benchmark/results/
# ivf4096_pq64_sift1m_pq4.json, at the sweep's defaults: spill 8 cells at
# the initial capacity 3 x n / n_cells, approximate top-k) with scan_group
# 4: pack32 at n_probe 1/8/32/128 for k = 10 and k = 100, exact at n_probe 8
# (k = 10), and flat at both k
# (the residual record, ivf4096_pq64_residual_sift1m_residual.json, runs
# the same plans)
PQ4_GROUP = 4
PLANS_K10 = [("flat", 1, True), ("cell_major", 1, True),
             ("cell_major", 8, True), ("cell_major", 32, True),
             ("cell_major", 128, True), ("cell_major", 8, False)]
PLANS_K100 = [("flat", 1, True)] + [("cell_major", p, True)
                                    for p in (1, 8, 32, 128)]
# at n_probe 1 and k = 100 the completeness floor lifts k_pair to 100,
# above the kernel gate's 64, in both packages: the plain select serves it
PLAIN_K100 = {("cell_major", 1, True)}


def exact_gt(torch, base, xq, k):
    """Exact f32 euclidean top-k ids of the queries over the base, on the
    card in chunks of 1,000 queries."""
    xb = torch.from_numpy(base).cuda()
    nb = (xb * xb).sum(-1)
    gt = [torch.topk(2 * xq[i:i + 1000] @ xb.T - nb[None], k,
                     dim=-1).indices for i in range(0, xq.shape[0], 1000)]
    del xb
    return torch.cat(gt)


def all_cells_check(torch, index, xq, k, label):
    """Over 256 queries, the exact select probing every cell must find what
    the exact flat sweep finds (ids >= 0.99, values within the tolerance);
    the index's probe settings are restored after."""
    keep = (index.scan_mode, index.n_probe, index.use_approx_topk,
            index.use_smart_probing)
    qs = xq[:256]
    index.use_approx_topk = index.use_smart_probing = False
    index.scan_mode, index.n_probe = "cell_major", index.n_cells
    v_p, i_p = index.search(qs.T, k=k)
    index.scan_mode = "flat"
    v_f, i_f = index.search(qs.T, k=k)
    torch.cuda.synchronize()
    verr = float((v_p - v_f).abs().max())
    agree = recall_at(i_p.long(), i_f.long())
    log(f"{label}all-cells probe vs flat (256 queries, exact): id agreement "
        f"{agree:.4f}, max value diff {verr:.3g}")
    if agree < 0.99 or verr > TOL_REL * float(v_f.abs().max()) + TOL_ABS:
        fail(f"{label}the probed exact plan disagrees with the flat plan")
    (index.scan_mode, index.n_probe, index.use_approx_topk,
     index.use_smart_probing) = keep


# the block scan's tensor-core keys per cache: (exact, pack32); bf16 rows
# of d <= 128 on the narrow warp-specialised instances (the k = 100 plans
# of the 4-bit, residual and pqr3 tiers on their deep pack32 instance)
BF16_KEYS = ("tc_wgn_exact", "tc_wgn_pack32")
INT8_KEYS = ("tc_wgn_int8_exact", "tc_wgn_int8_pack32")
# and those of the int8 scans at d_cache 1024 (the GIST-class int8 tier and
# the GIST int8 record: the k-chunked int8 instances)
GIST_INT8_KEYS = ("tc_wg_int8_exact", "tc_wg_int8_pack32")
# and those of the GIST bf16 record's scans (d_cache 1024: the k-chunked
# warp-specialised instances)
GIST_BF16_KEYS = ("tc_wg_exact", "tc_wg_pack32")


def require_only_tc(counts, keys, what):
    """A run's block-scan launches: each of `keys` (tensor-core) launched,
    no CUDA-core key ("exact", "pack32", "int8_exact", "int8_pack32"), and
    no other route's key of the same cache type (the narrow and k-chunked
    instances serve disjoint widths)."""
    for key in keys:
        if counts[key] <= 0:
            fail(f"kernel block_scan {key} was never launched by {what}")
    others = []
    for family in (BF16_KEYS + GIST_BF16_KEYS, INT8_KEYS + GIST_INT8_KEYS):
        if set(keys) <= set(family):
            others = [k for k in family if k not in keys]
    for key in ("exact", "pack32", "int8_exact", "int8_pack32", *others):
        if counts[key] > 0:
            fail(f"{what} launched block_scan {key} {counts[key]} times, "
                 f"not {keys}: {counts}")


def rising(rec, plans, what):
    """Recall non-decreasing in n_probe (within 0.005) over the pack32
    plans of `plans`."""
    r = [rec[p] for p in plans if p[0] == "cell_major" and p[2]]
    if any(b < a - 0.005 for a, b in zip(r, r[1:])):
        fail(f"{what}: recall falls with n_probe: {r}")


def codec_state(index, pq_from=None):
    """The trained VQ codec of `index`, and the PQ codec of `pq_from` (if
    given), as a state dict to load."""
    out = index.vq_codec.state_dict("vq_codec.")
    if pq_from is not None:
        out.update(pq_from.pq_codec.state_dict("pq_codec."))
    return out


def phase_pq4(torch, tp, bs, cs, sl, gt100):
    """The JAX package's 4-bit record at the slice's shape: IVF4096 x PQ64
    at n_bits 4 (32 code bytes per slot), the bf16 cache, spill 8 cells
    at 3 x n / n_cells, scan_group 4, approximate top-k; the main VQ codec
    and a 16-cluster PQ trained on the 100k train slice; four adds. The
    bf16 plans (PLANS_K10, PLANS_K100) with the block-scan counters zeroed
    before and read after (the tensor-core selects only), recall rising
    with n_probe, the all-cells probe against the flat sweep, and the
    pack32 scan held to block_scan_ref on its search's own arguments. Then
    the code domain at 4 bits (scan_cache_dtype="none", pack group 4, no
    spill, no supercells): its plans with the codes-scan counters zeroed
    (the tensor-core codes kernel at 32 byte pairs, dsub 4, only); a 4-bit
    bf16 index of the same layout (the main index's) runs the slice's
    plans, each recall@10 below the 8-bit tier's, and holds the code
    domain's exact n_probe 8 and flat results; the codes kernels on the
    code-domain searches' own arguments. Returns ({row name: launches},
    the kernels' JSON rows)."""
    index, base, xq, gt, k = (sl[x] for x in ("index", "base", "xq", "gt",
                                              "k"))
    d, m, n_cells = index.d_vector, index.n_subvectors, index.n_cells
    per_cell = sl["per_cell"]
    t0 = time.perf_counter()
    proto = tp.IVFPQIndex(d_vector=d, n_subvectors=m, n_cells=n_cells,
                          n_bits=4, initial_size=16, device="cuda")
    proto.load_state_dict(codec_state(index))
    proto.pq_codec.train(torch.from_numpy(base[: base.shape[0] // 10])
                         .cuda().T)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = codec_state(index, proto)
    del proto
    pq4, add_s = build_index(torch, tp, trained, base, d=d, m=m,
                             n_cells=n_cells, per_cell=per_cell, cache=None,
                             spill=True, n_bits=4)
    pq4.scan_group = PQ4_GROUP
    dec = pq4.aux("decoded")
    sizes = pq4._cell_size_np
    log(f"pq4 index: PQ train {train_s:.2f} s, add {add_s:.2f} s; storage "
        f"{tuple(pq4._storage.shape)} uint8 (pack group {pq4.pack_group}), "
        f"codebook {tuple(pq4.pq_codec.codebook_internal.shape)}, byte-pair "
        f"view {tuple(pq4._scan_codebook.shape)}; spill 8 cells at capacity "
        f"{pq4.spill_capacity}: largest cell {int(sizes.max())}; device "
        f"bytes: codes {pq4._storage.numel()}, decoded cache "
        f"{dec.numel() * dec.element_size()}")
    if pq4._storage.shape[1] != m // 2 or pq4.pack_group != 1:
        fail("the 4-bit bf16 index does not store unpacked m/2-byte rows")

    for key in bs.launches:
        bs.launches[key] = 0
    rec10, _ = time_plans(torch, tp, pq4, xq, gt, k, bs.launches,
                          "pq4 ", plans=PLANS_K10, floors=False)
    counts10 = dict(bs.launches)
    rec100, _ = time_plans(torch, tp, pq4, xq, gt100, 100, bs.launches,
                           "pq4 k=100 ", plans=PLANS_K100, floors=False,
                           short_ok=True, plain_ok=PLAIN_K100)
    counts = dict(bs.launches)
    counts100 = {key: counts[key] - counts10[key] for key in counts}
    log(f"pq4 launches: k=10 plans {counts10}, k=100 plans {counts100}")
    require_only_tc(counts, BF16_KEYS,
                    "the pq4 bf16 plans")
    rising(rec10, PLANS_K10, "pq4 k=10")
    rising(rec100, PLANS_K100, "pq4 k=100")
    all_cells_check(torch, pq4, xq, k, "pq4 ")
    pq4.scan_mode, pq4.n_probe, pq4.use_approx_topk = "cell_major", 32, True
    rows, launches = {}, {}
    # k = 10 (k_pair 10) and k = 100 (k_pair 64 over G = 512, 5 tiles a
    # phase: the deep select) at n_probe 32
    for name, kk, key_counts in (("block_scan_pack32_pq4", k, counts10),
                                 ("block_scan_pack32_pq4_k100", 100,
                                  counts100)):
        args, kw = capture_call(tp, pq4, xq, kk)
        rows[name] = pack32_scan_row(
            torch, bs, name, args, kw,
            f"the pq4 k={kk} n_probe=32 search")
        launches[name] = key_counts[rows[name]["launch_key"]]
        del args
    phase_profile(torch, pq4, xq, k, label="pq4 ",
                  plans=[p for p in PLANS_K10 if p[1] in (1, 8, 32)])
    phase_profile(torch, pq4, xq, 100, label="pq4 k=100 ",
                  plans=[("cell_major", 32, True)])

    # the code domain at 4 bits, held to a 4-bit bf16 index of its layout
    code = build_index(torch, tp, trained, base, d=d, m=m, n_cells=n_cells,
                       per_cell=per_cell, cache="none", n_bits=4)[0]
    if code.pack_group != 4 or code._storage.shape[1] != 128:
        fail(f"the 4-bit code-domain index packs {code.pack_group} slots "
             f"per row, {tuple(code._storage.shape)}")
    slot_b = code._storage.numel() // code.capacity + 4
    log(f"pq4 code-domain index: storage {tuple(code._storage.shape)} uint8 "
        f"(pack group {code.pack_group}); device bytes per slot: "
        f"{code._storage.numel() // code.capacity} B codes + 4 B norm = "
        f"{slot_b} B (the 8-bit code domain: {m} + 4 = {m + 4} B)")
    for key in cs.launches:
        cs.launches[key] = 0
    plans = [p for p in PLANS_K10 if p[1] != 128]
    rec_c, res_c = time_plans(torch, tp, code, xq, gt, k, cs.launches,
                              "pq4 code-domain ", short_ok=True,
                              plans=plans, floors=False)
    code_counts = dict(cs.launches)
    log(f"pq4 code-domain launches: {code_counts}")
    require_codes_wg(code_counts, "the 4-bit code domain")
    gate = tp.ops.adc.LAST_GATE
    if (gate.get("m"), code._scan_codebook.shape[-1]) != (m // 2, 4):
        fail(f"the 4-bit codes scan ran at m {gate.get('m')}, not 32 byte "
             "pairs of dsub 4")
    # a 4-bit bf16 index of the main index's layout (no spill, no
    # supercells): its recall@10 below the 8-bit tier's on every plan,
    # and the code domain's results held to it
    ref, _ = build_index(torch, tp, trained, base, d=d, m=m,
                         n_cells=n_cells, per_cell=per_cell, cache=None,
                         n_bits=4)
    rec_r, res_r = time_plans(torch, tp, ref, xq, gt, k, bs.launches,
                              "pq4 main layout ", floors=False)
    log("4-bit recall@10 against the 8-bit tier, same layout and plans: "
        + ", ".join(f"{p[0]} np={p[1]}{'' if p[2] else ' exact'} "
                    f"{rec_r[p]:.4f} vs {sl['rec'][p]:.4f}" for p in rec_r))
    for plan, r in rec_r.items():
        if not r < sl["rec"][plan]:
            fail(f"4-bit plan {plan}: recall@10 {r:.4f} not below the "
                 f"8-bit tier's {sl['rec'][plan]:.4f}")
    for plan in (("cell_major", 8, False), ("flat", 1, True)):
        v_r, i_r = res_r[plan]
        v_c, i_c = res_c[plan]
        agree = recall_at(i_c.long(), i_r.long())
        err = float((v_c - v_r).abs().max())
        log(f"pq4 code-domain vs a 4-bit bf16 index of its layout, {plan}: "
            f"id agreement {agree:.5f}, max value diff {err:.3g}, recall "
            f"{rec_c[plan]:.4f} vs {rec_r[plan]:.4f}")
        if plan[0] == "cell_major" and (agree < 0.999 or bool(
                ((v_c - v_r).abs() > TOL_REL * v_r.abs() + TOL_ABS).any())):
            fail("the 4-bit code-domain exact n_probe=8 result differs from "
                 "the 4-bit bf16 index's")
        if plan[0] == "flat" and (agree < 0.99
                                  or abs(rec_c[plan] - rec_r[plan]) > 0.005):
            fail("the 4-bit code-domain flat result differs from the 4-bit "
                 "bf16 index's")
    del ref, res_r
    rows.update(codes_rows(torch, tp, bs, cs, code, xq, k,
                           "pq4 code-domain", suffix="_pq4"))
    launches.update(codes_scan_exact_pq4=code_counts["tc_wgn_exact"],
                    codes_scan_pack32_pq4=code_counts["tc_wgn_pack32"])
    phase_profile(torch, code, xq, k, label="pq4 code-domain ",
                  plans=[("cell_major", 32, True)])
    del code, pq4
    return launches, rows


def phase_residual(torch, tp, bs, sl, gt100):
    """The JAX package's residual record at the slice's shape: IVF4096 x
    PQ64 with pq_use_residual, the bf16 cache, the main phase's settings
    (no spill, no supercells), approximate top-k; the main VQ codec and a
    PQ trained on the residuals of the 100k train slice; four adds. The
    plans (PLANS_K100, PLANS_K10) with the block-scan counters zeroed before
    and read after (tensor-core selects only); 4,096 sampled live cache
    rows equal bf16(centroid[cell] + PQ decode) bit for bit; the
    reconstruction error on the train slice below the main index's; the
    all-cells probe against the flat sweep; the k = 100 pack32 scan (k_pair
    64) on its search's own arguments. Returns ({row name: launches}, the
    kernel's JSON rows)."""
    index, base, xq, gt, k = (sl[x] for x in ("index", "base", "xq", "gt",
                                              "k"))
    d, m, n_cells = index.d_vector, index.n_subvectors, index.n_cells
    xt = torch.from_numpy(base[: base.shape[0] // 10]).cuda().T
    t0 = time.perf_counter()
    proto = tp.IVFPQIndex(d_vector=d, n_subvectors=m, n_cells=n_cells,
                          pq_use_residual=True, initial_size=16,
                          device="cuda")
    proto.load_state_dict(codec_state(index))
    proto.pq_codec.train(xt - proto.vq_codec.decode(proto.vq_codec.encode(
        xt)))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = codec_state(index, proto)
    del proto
    res, add_s = build_index(torch, tp, trained, base, d=d, m=m,
                             n_cells=n_cells, per_cell=sl["per_cell"],
                             cache=None, pq_use_residual=True)
    if not np.array_equal(res._cell_size_np, index._cell_size_np):
        fail("the residual index holds other cell sizes than the main index")
    live = torch.nonzero(~res._is_empty).flatten()
    gen = torch.Generator(device="cpu").manual_seed(0)
    addr = live[torch.randperm(live.numel(), generator=gen)[:4096].cuda()]
    cells = res.get_cell_by_address(addr).long()
    want = (res._coarse_cb()[cells] + res._decode_stored(
        res.storage_rows(addr))).to(torch.bfloat16)
    if not torch.equal(res.aux("decoded")[addr], want):
        fail("residual cache rows differ from bf16(centroid + PQ decode)")
    mse = {}
    for name, idx in (("main", index), ("residual", res)):
        rec_x = idx.decode(idx.encode(xt))
        mse[name] = float(((rec_x - xt) ** 2).mean())
    log(f"residual index: PQ train on residuals {train_s:.2f} s, add "
        f"{add_s:.2f} s; 4,096 sampled cache rows equal bf16(centroid[cell] "
        f"+ PQ decode) bit for bit; reconstruction MSE on the train slice "
        f"{mse['residual']:.6g} (main index {mse['main']:.6g})")
    if not mse["residual"] < mse["main"]:
        fail("the residual index reconstructs the train slice no better "
             "than the main index")
    for key in bs.launches:
        bs.launches[key] = 0
    rec100, _ = time_plans(torch, tp, res, xq, gt100, 100, bs.launches,
                           "residual k=100 ", plans=PLANS_K100, floors=False,
                           short_ok=True, plain_ok=PLAIN_K100)
    counts100 = dict(bs.launches)
    rec10, _ = time_plans(torch, tp, res, xq, gt, k, bs.launches,
                          "residual ", plans=PLANS_K10, floors=False)
    counts = dict(bs.launches)
    log(f"residual launches: k=100 plans {counts100}, all plans {counts}")
    require_only_tc(counts, BF16_KEYS,
                    "the residual plans")
    rising(rec10, PLANS_K10, "residual k=10")
    rising(rec100, PLANS_K100, "residual k=100")
    log("residual recall@10 against the main index: " + ", ".join(
        f"{p[0]} np={p[1]}{'' if p[2] else ' exact'} {rec10[p]:.4f} vs "
        f"{sl['rec'][p]:.4f}" for p in rec10 if p in sl["rec"]))
    all_cells_check(torch, res, xq, k, "residual ")
    res.scan_mode, res.n_probe, res.use_approx_topk = "cell_major", 32, True
    args, kw = capture_call(tp, res, xq, 100)
    if kw["k_pair"] != 64:
        fail(f"the residual k=100 scan ran k_pair {kw['k_pair']}, not 64")
    rows = {"block_scan_pack32_residual_k100": pack32_scan_row(
        torch, bs, "block_scan_pack32_residual_k100", args, kw,
        "the residual k=100 n_probe=32 search")}
    launches = {"block_scan_pack32_residual_k100": counts100[
        rows["block_scan_pack32_residual_k100"]["launch_key"]]}
    del args
    phase_profile(torch, res, xq, 100, label="residual k=100 ",
                  plans=[p for p in PLANS_K100 if p[1] in (1, 8, 32)])
    del res
    return launches, rows


# the JAX package's IVFPQR records (benchmark/results/
# ivf4096_pq64r32_sift1m_pqr3.json and _pqr3_codes.json, built as
# benchmark/sweep.py:112-127 builds them): PQ64 base + PQ32 rerank, rerank
# multiplier 4, spill 8 cells at the initial capacity, scan_group 4,
# approximate top-k; cached bf16 at initial_mult 2, code domain at 3
PQR_RERANK_M, PQR_MULT, PQR_GROUP = 32, 4, 4
PQR_PLANS_K10 = [("flat", 1, True), ("cell_major", 1, True),
                 ("cell_major", 8, True), ("cell_major", 32, True),
                 ("cell_major", 8, False)]
PQR_PLANS_K100 = [("flat", 1, True)] + [("cell_major", p, True)
                                        for p in (1, 8, 32)]
PQR_CODE_PLANS = [("flat", 1, True), ("cell_major", 8, True),
                  ("cell_major", 32, True)]


def build_pqr(torch, tp, trained, base, main, *, initial_mult, cache):
    """An IVFPQRIndex of the records' settings (the main index's cells and
    subvectors, cells of initial_mult x n / n_cells, spill, supercells of
    PQR_GROUP) with the trained codecs, filled by build_index's adds."""
    index, add_s = build_index(
        torch, tp, trained, base, d=base.shape[1], m=main.n_subvectors,
        n_cells=main.n_cells, cache=cache, spill=True, cls=tp.IVFPQRIndex,
        per_cell=max(16, base.shape[0] // main.n_cells * initial_mult),
        n_subvectors_rerank=PQR_RERANK_M, rerank_multiplier=PQR_MULT)
    index.scan_group = PQR_GROUP
    return index, add_s


def relayout_keeps_search(torch, index, xq, k, label):
    """A forced relayout (expand: every cell's capacity doubled, the cache
    rebuilt from the codes through the rerank hook) leaves the exact
    n_probe 8 and flat searches' values within 1e-5 (rel 1e-5; logged when
    bit-equal) and their ids equal on >= 0.999 (exact ties may fall either
    way). A cache rebuilt without the rerank decode moves every value by
    the refinement's 2 q.r - |r|^2 terms, far above that."""
    plans = [("cell_major", 8, False), ("flat", 1, True)]
    before = {}
    for mode, n_probe, approx in plans:
        index.scan_mode, index.n_probe = mode, n_probe
        index.use_approx_topk = approx
        before[mode] = index.search(xq.T, k=k)
    cap = index.max_cell_capacity
    index.expand()
    for mode, n_probe, approx in plans:
        index.scan_mode, index.n_probe = mode, n_probe
        index.use_approx_topk = approx
        v, i = index.search(xq.T, k=k)
        v0, i0 = before[mode]
        agree = recall_at(i.long(), i0.long())
        err = float((v - v0).abs().max())
        log(f"{label}forced relayout (cell capacity {cap} -> "
            f"{index.max_cell_capacity}), {mode} np={n_probe}: values "
            f"bit-equal {torch.equal(v, v0)} (max diff {err:.3g}), id "
            f"agreement {agree:.5f}")
        if bool(((v - v0).abs() > 1e-5 * v0.abs() + 1e-5).any()) \
                or agree < 0.999:
            fail(f"{label}a forced relayout changed the {mode} search: the "
                 "rebuilt cache lost the refinement")


def phase_pqr(torch, tp, bs, sl, gt100):
    """The JAX package's IVFPQR record, cached bf16 tier (pqr3): the main
    index's codecs and a PQ32 rerank trained on the train slice's
    second-stage residuals, the cache rows the full two-stage
    reconstruction; k = 10 (PQR_PLANS_K10, with an exact plan) and k = 100
    (PQR_PLANS_K100) with the block-scan counters zeroed before and read
    after: the tensor-core keys only, n_probe 1 at k = 100 on the plain
    select (time_plans' plain_ok); the flat plan's recall@10 above the main
    index's; the pack32 scans at n_probe 32 (k = 10: k_pair 10; k = 100:
    k_pair 64) held to block_scan_ref on their searches' own arguments;
    the exact select at n_probe 8 and 32 and scan_group 1 (the cells the
    code domain scans); a forced relayout keeps the searches. Returns
    (launches, the kernels' rows, the trained codec state, the recalls)."""
    index, base, xq, gt, k = (sl[x] for x in ("index", "base", "xq", "gt",
                                              "k"))
    xt = torch.from_numpy(base[: base.shape[0] // 10]).cuda().T
    t0 = time.perf_counter()
    proto = tp.IVFPQRIndex(d_vector=index.d_vector,
                           n_subvectors=index.n_subvectors,
                           n_subvectors_rerank=PQR_RERANK_M,
                           n_cells=index.n_cells, initial_size=16,
                           device="cuda")
    proto.load_state_dict(codec_state(index, index))
    proto.rerank_codec.train(xt - proto.decode(proto.encode(xt)))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = {**codec_state(index, index),
               **proto.rerank_codec.state_dict("rerank_codec.")}
    del proto, xt
    pqr, add_s = build_pqr(torch, tp, trained, base, index, initial_mult=2,
                           cache=None)
    sizes = pqr._cell_size_np
    dec = pqr.aux("decoded")
    log(f"pqr3 index (IVF4096 x PQ64 + rerank PQ{PQR_RERANK_M}, bf16 cache "
        f"of the full reconstruction): rerank PQ train {train_s:.2f} s, add "
        f"{add_s:.2f} s; s_max {pqr.max_cell_capacity} (spill 8 cells at "
        f"{pqr.spill_capacity}: largest cell {int(sizes.max())}), "
        f"scan_group {pqr.scan_group}; device bytes: codes "
        f"{pqr._storage.numel()}, rerank codes "
        f"{pqr.aux('rerank_codes').numel()}, decoded cache "
        f"{dec.numel() * dec.element_size()}")
    for key in bs.launches:
        bs.launches[key] = 0
    rec10, _ = time_plans(torch, tp, pqr, xq, gt, k, bs.launches, "pqr3 ",
                          plans=PQR_PLANS_K10, floors=False)
    counts10 = dict(bs.launches)
    rec100, _ = time_plans(torch, tp, pqr, xq, gt100, 100, bs.launches,
                           "pqr3 k=100 ", plans=PQR_PLANS_K100, floors=False,
                           short_ok=True, plain_ok=PLAIN_K100)
    counts = dict(bs.launches)
    counts100 = {key: counts[key] - counts10[key] for key in counts}
    log(f"pqr3 launches: k=10 plans {counts10}, k=100 plans {counts100}")
    require_only_tc(counts, BF16_KEYS,
                    "the pqr3 plans")
    rising(rec10, PQR_PLANS_K10, "pqr3 k=10")
    rising(rec100, PQR_PLANS_K100, "pqr3 k=100")
    flat = ("flat", 1, True)
    log(f"pqr3 recall@10 flat {rec10[flat]:.4f} against the main index's "
        f"{sl['rec'][flat]:.4f}; recall@100 " + ", ".join(
            f"{p[0]} np={p[1]} {rec100[p]:.4f}" for p in PQR_PLANS_K100))
    if not rec10[flat] > sl["rec"][flat]:
        fail("the refined cache's flat recall@10 is not above the main "
             "index's")
    all_cells_check(torch, pqr, xq, k, "pqr3 ")
    rows, launches = {}, {}
    for name, kk, key_counts in (("block_scan_pack32_pqr", k, counts10),
                                 ("block_scan_pack32_pqr_k100", 100,
                                  counts100)):
        pqr.scan_mode, pqr.n_probe, pqr.use_approx_topk = "cell_major", 32, \
            True
        args, kw = capture_call(tp, pqr, xq, kk)
        if kw["k_pair"] != min(kk, 64):
            fail(f"the pqr3 k={kk} scan ran k_pair {kw['k_pair']}")
        rows[name] = pack32_scan_row(torch, bs, name, args, kw,
                                     f"the pqr3 k={kk} n_probe=32 search")
        launches[name] = key_counts[rows[name]["launch_key"]]
        del args
    phase_profile(torch, pqr, xq, k, label="pqr3 ",
                  plans=[("cell_major", 32, True)])
    phase_profile(torch, pqr, xq, 100, label="pqr3 k=100 ",
                  plans=[("cell_major", 32, True)])
    # the exact select over the probed cells alone (scan_group 1): the
    # two-stage ranking of the cells the code domain scans, which takes no
    # supercells in either package (k = 100: k_pair 100, the plain select)
    pqr.scan_group = 1
    rec = {"k10": rec10, "k100": rec100}
    same_set = [("cell_major", p, False) for p in (8, 32)]
    for key, kk, g in (("k10_g1", k, gt), ("k100_g1", 100, gt100)):
        rec[key], _ = time_plans(
            torch, tp, pqr, xq, g, kk, bs.launches,
            f"pqr3 k={kk} scan_group 1 ", plans=same_set, floors=False,
            plain_ok=set(same_set) if kk > 64 else ())
    pqr.scan_group = PQR_GROUP
    planner_sweep(torch, tp, pqr, xq, "pqr3")
    relayout_keeps_search(torch, pqr, xq, k, "pqr3 ")
    return launches, rows, trained, rec


def codes_pack32_row(torch, bs, cs, name, args, kw, what, want):
    """One pack32 codes scan on its search's own arguments, through the
    tensor-core route `want` pick_route must name: against codes_scan_ref
    on the live rows, pad rows dead (check_codes; the CUDA-core kernel on
    every row), timed in turns with the CUDA-core codes_scan.cu (the
    cuda_core_ms yardstick) and, with --parent, with the parent's kernels
    (codes_parent_turns: its sorted mma.sync codes_scan_tc.cu on the deep
    rows, with its share of equal live keys), with its bound. Returns the
    kernels-line row."""
    s_eff, k_pair = kw["s_eff"], kw["k_pair"]
    blocks, p_tile = args[1].shape
    m, _, dsub = args[7].shape
    d = args[0].shape[1]
    live = int((args[1] >= 0).sum())
    picked = cs.pick_route(m=m, dsub=dsub, p_tile=p_tile, s_eff=s_eff,
                           k_pair=k_pair, pack32=True)
    log(f"{what}: {blocks} blocks x {p_tile} probers, {live} live, "
        f"s_eff={s_eff}, k_pair={k_pair}, m={m}, route {picked}")
    if picked != want:
        fail(f"{what} routes to {picked}, not {want}")
    kkw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=kw["euclidean"],
               pack32=True, slot_mask=kw["slot_mask"])
    err, agree, _, _ = check_codes(torch, bs, cs, args, s_eff=s_eff,
                                   k_pair=k_pair, pack32=True,
                                   euclidean=kw["euclidean"], reps=0)
    t, turns = in_turns(torch, {
        "cuda_cores": lambda: codes_launch(torch, cs, args, "pack32", **kkw),
        "tensor_cores": lambda: codes_launch(torch, cs, args, want, **kkw)},
        10)
    parent = codes_parent_turns(torch, bs, cs, args, kkw, want, what)
    ms, cc_ms = t["tensor_cores"], t["cuda_cores"]
    plain_ms = cuda_ms(torch, lambda: cs.codes_scan_ref(*args, **kkw), 1)
    b_ms, b_by = scan_bound(torch, args, kkw, slot_bytes=m + 4,
                            row_bytes=2 * d, peak="bf16", d=d,
                            extra_bytes=args[7].numel() * 2)
    log(f"{name} on {what}'s arguments: tensor cores {ms:.3f} ms ("
        f"{' / '.join(f'{x:.3f}' for x in turns['tensor_cores'])}), CUDA "
        f"cores {cc_ms:.3f} ms ("
        f"{' / '.join(f'{x:.3f}' for x in turns['cuda_cores'])}); "
        f"{2.0 * live * s_eff * d / ms / 1e9:.2f} TFLOP/s over live "
        f"probers, {b_ms / ms:.1%} of the bound; plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.3f} ms ({b_by}); max_abs_err {err:.3g}, key agreement "
        f"{agree:.7f}")
    return dict(name=name, route="cuda", source=codes_source(want),
                replaces="torchpq_tpu/ops/pallas_codes_scan.py:198",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, cuda_core_ms=cc_ms,
                launch_key=want, instance=codes_instance(True, k_pair),
                key_agreement=agree, **parent)


def phase_pqr_codes(torch, tp, bs, cs, sl, gt100, trained, rec_cached):
    """The JAX package's IVFPQR record, code domain (pqr3_codes): the same
    codecs in a scan_cache_dtype="none" index (codes, rerank codes, base
    norms and norm deltas: no cache), initial_mult 3; each plan of
    PQR_CODE_PLANS at k = 10 and 100 with the codes-scan counters zeroed
    before it and read after. The base scan runs at k * 4 under the code
    scan's k_pair rule: k = 10 (k' 40) at pack32 k_pair 20 / 16 (n_probe
    8 / 32), k = 100 (k' 400) at k_pair 64 / 52 (the deep select), all
    on the tensor-core pack32 key only ("tc_wgn_pack32": the passes of
    k_pair 16 and 20, the deep select of 52 and 64). Recall@10 and @100
    within 0.02 of the cached tier's exact select over the same probed
    cells (scan_group 1: the code domain takes no supercells, in either
    package) at n_probe 8 and 32; the cached tier's pack32 plans over
    supercells of 4 are logged beside (on manifold-12 the supercells lift
    them 0.01-0.05 above both); the n_probe 32 scans of both k and the k =
    100 n_probe 8 scan held to codes_scan_ref on their searches' own
    arguments. Returns (launches, the kernels' rows): a k = 10 row
    launched by both probed plans, a k = 100 row per probed plan."""
    base, xq, gt, k = (sl[x] for x in ("base", "xq", "gt", "k"))
    code, add_s = build_pqr(torch, tp, trained, base, sl["index"],
                            initial_mult=3, cache="none")
    if "decoded" in code._aux or code._aux_rebuild_names != ("norm",
                                                             "dnorm2"):
        fail("the pqr3 code-domain index holds a decoded cache or does not "
             "rebuild its norm deltas")
    per_slot = (code._storage.numel() + code.aux("rerank_codes").numel()
                + 8 * code.capacity) / code.capacity
    log(f"pqr3 code-domain index: add {add_s:.2f} s; s_max "
        f"{code.max_cell_capacity}; storage {tuple(code._storage.shape)} "
        f"uint8 (pack group {code.pack_group}); device bytes per slot "
        f"{per_slot:.0f} (64 B codes, {PQR_RERANK_M} B rerank codes, 4 B "
        "norm, 4 B norm delta)")
    rec, launches, rows = {}, {}, {}
    for kk, g in ((k, gt), (100, gt100)):
        want = "tc_wgn_pack32"
        rec[kk], counts = {}, {}
        for plan in PQR_CODE_PLANS:
            for key in cs.launches:
                cs.launches[key] = 0
            r, _ = time_plans(torch, tp, code, xq, g, kk, cs.launches,
                              f"pqr3 code-domain k={kk} ", plans=[plan],
                              floors=False, short_ok=True)
            rec[kk].update(r)
            counts[plan] = dict(cs.launches)
            log(f"pqr3 code-domain k={kk} {plan[0]} np={plan[1]} launches: "
                f"{counts[plan]} (the route that must serve: {want})")
            for key, c in counts[plan].items():
                if c > 0 and (key != want or plan[0] == "flat") or (
                        key == want and plan[0] != "flat" and c <= 0):
                    fail(f"the pqr3 code-domain k={kk} {plan[0]} "
                         f"np={plan[1]} plan launched the codes scan's {key}"
                         f" {c} times: only {want} may serve the probed "
                         "plans")
        key = "k10" if kk == k else "k100"
        cached, same_set = rec_cached[key], rec_cached[key + "_g1"]
        for plan in PQR_CODE_PLANS[1:]:
            r, exact = rec[kk][plan], same_set[(plan[0], plan[1], False)]
            log(f"pqr3 code-domain k={kk} {plan[0]} np={plan[1]}: recall "
                f"{r:.4f}; the cached tier's exact select over the same "
                f"probed cells (scan_group 1) {exact:.4f}, its pack32 plan "
                f"over supercells of {PQR_GROUP} {cached[plan]:.4f}")
            if abs(r - exact) > 0.02:
                fail(f"the pqr3 code domain's recall@{kk} at n_probe "
                     f"{plan[1]} is not within 0.02 of the cached tier's")
        named = ({"codes_scan_pack32_pqr": PQR_CODE_PLANS[1:]} if kk == k
                 else {"codes_scan_pack32_pqr_k100": [PQR_CODE_PLANS[2]],
                       "codes_scan_pack32_pqr_k100_np8": [PQR_CODE_PLANS[1]]})
        for name, plans in named.items():
            n_probe = plans[-1][1]
            code.scan_mode, code.n_probe, code.use_approx_topk = \
                "cell_major", n_probe, True
            args, kw = capture_call(tp, code, xq, kk,
                                    module=tp.ops.onehot_adc,
                                    name="codes_scan")
            rows[name] = codes_pack32_row(
                torch, bs, cs, name, args, kw,
                f"the pqr3 code-domain k={kk} n_probe={n_probe} search",
                want)
            launches[name] = sum(counts[p][want] for p in plans)
            del args
    phase_profile(torch, code, xq, 100, label="pqr3 code-domain k=100 ",
                  plans=[("cell_major", 8, True), ("cell_major", 32, True)])
    return launches, rows


@contextlib.contextmanager
def search_precision(tp, precision):
    """config.SEARCH_PRECISION set to `precision` inside, then restored.
    The card-against-CPU checks run at "highest": the CPU computes f32 at
    every precision, so they compare the algorithm, not the precision."""
    keep = tp.config.SEARCH_PRECISION
    tp.config.set_search_precision(precision)
    try:
        yield
    finally:
        tp.config.set_search_precision(keep)


def matmul_bound(torch, a, b, precision):
    """The largest error util.matmul(a, b, precision) may show against the
    f64 product of its operands (of their bf16 roundings at "default"),
    per entry: the f32 summation bound (d + 2) * F32_UNIT * sum |a_i b_i|
    (F32_UNIT: one f32 unit for accumulators that truncate, as the tensor
    cores' f32 accumulation does), at "high" three GEMMs' worth of it plus
    bf16_3x's dropped terms, lo * lo and the low parts' own rounding, at
    most 2^-14 sum |a_i b_i| (each part rounds to 8 significant bits, so
    a - a_hi - a_lo is within 2^-16 |a|)."""
    d = a.shape[-1]
    if precision == "default":
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    mag = a.double().abs() @ b.double().abs().T
    if precision == "high":
        return (2.0 ** -14 + 2 * (d + 4) * F32_UNIT) * mag
    return (d + 2) * F32_UNIT * mag


def check_matmul(torch, tp, label, a, b):
    """util.matmul on the card at each precision against its oracle:
    "default" and "high" within matmul_bound of the f64 product (of the
    bf16-rounded operands at "default"), as is each mode's plain version;
    "highest" bit-equal to the f32 product a.float() @ b.float().T."""
    util = tp.util
    for p in ("default", "high", "highest"):
        got = util.matmul(a, b, p)
        if got.dtype != torch.float32 or tuple(got.shape) != (
                a.shape[0], b.shape[0]):
            fail(f"precision {label} {p}: {got.dtype} {tuple(got.shape)}")
        if p == "highest":
            if not torch.equal(got, a.float() @ b.float().T):
                fail(f"precision {label}: 'highest' is not the f32 product")
            log(f"precision {label} highest: bit-equal to the f32 product")
            continue
        x, y = (a.to(torch.bfloat16), b.to(torch.bfloat16)) \
            if p == "default" else (a, b)
        want = x.double() @ y.double().T
        tol = matmul_bound(torch, a, b, p)
        for name, v in (("card", got), ("plain", util.matmul_plain(a, b, p))):
            ratio = float(((v.double() - want).abs() / tol).max())
            log(f"precision {label} {p} ({name}): largest error over the "
                f"bound {ratio:.4f}")
            if not ratio <= 1.0:  # NaN fails too
                fail(f"precision {label} {p} ({name}) beyond its bound")


def phase_precision(torch, tp, sl):
    """Phase 14b: the JAX package's matmul precision on the card (C11).
    util.matmul's three modes held to their oracles on the slice's
    operands; then, at each precision, the coarse GEMM, the bf16 index's
    flat plan (its GEMMs' device ms from a profile) and cell_major n_probe
    32, and a 1M x 128 f32 FlatIndex, timed in one call; the "default"
    results held to their floors and to "highest"'s."""
    index, base, xq, gt, k = (sl[x] for x in ("index", "base", "xq", "gt",
                                                "k"))
    util = tp.util
    xb = torch.from_numpy(base[:65536]).cuda()
    check_matmul(torch, tp, "queries x coarse centroids", xq[:1024],
                 index._coarse_cb())
    check_matmul(torch, tp, "queries x base rows", xq[:1024], xb)
    q16 = xq[:1024].to(torch.bfloat16)
    live = torch.nonzero(~index._is_empty).flatten()[:65536]
    rows = index.aux("decoded")[live]
    check_matmul(torch, tp, "bf16 queries x bf16 cache rows", q16, rows)
    if not torch.equal(util.matmul(q16, rows, "default"),
                       util.matmul(q16, rows, "high")):
        fail("precision: 'high' on bf16 operands is not the one bf16 GEMM")
    del xb

    n, d = base.shape
    flat = tp.FlatIndex(d_vector=d, initial_size=n, device="cuda")
    flat.add(torch.from_numpy(base).cuda().T)
    keep = (index.scan_mode, index.n_probe, index.use_approx_topk)
    out, rows_log = {}, []
    for p in ("default", "high", "highest"):
        with search_precision(tp, p):
            row = dict(precision=p, coarse_gemm_ms=cuda_ms(
                torch, lambda: util.matmul(xq, index._coarse_cb()), 10))
            for plan, n_probe in (("flat", 1), ("cell_major", 32)):
                ms, _ = plan_ms(torch, index, xq, k, plan, n_probe, True)
                _, ids = index.search(xq.T, k=k)
                row[f"{plan}_ms"], row[f"{plan}_recall"] = ms, recall_at(
                    ids.long(), gt)
                if plan == "flat":
                    if tp.ops.flat_adc.LAST_FLAT.get("precision") != p:
                        fail(f"precision {p}: the flat plan recorded "
                             f"{tp.ops.flat_adc.LAST_FLAT}")
                    out[p] = ids
                    _, kernels = profile_search(
                        torch, lambda: index.search(xq.T, k=k),
                        f"precision {p}, flat plan")
                    gemm = [(name, ms) for name, ms in kernels
                            if re.search(r"gemm|xmma|cutlass|nvjet", name,
                                         re.I)]
                    row["flat_gemm_device_ms"] = sum(x for _, x in gemm)
                    row["flat_gemm_kernels"] = [name[:60] for name, _ in gemm]
                elif tp.ops.adc.LAST_GATE.get("precision") != p:
                    fail(f"precision {p}: the scan recorded "
                         f"{tp.ops.adc.LAST_GATE}")
            flat.search(xq.T, k=k)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                v_f, i_f = flat.search(xq.T, k=k)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            if tp.index.flat.LAST_SEARCH.get("precision") != p:
                fail(f"precision {p}: FlatIndex recorded "
                     f"{tp.index.flat.LAST_SEARCH}")
            row["flat_index_ms"] = float(np.median(times)) * 1e3
            row["flat_index_recall"] = recall_at(i_f.long(), gt)
            if p == "default":
                i_default = i_f
        rows_log.append(row)
        log("precision " + json.dumps(row))
    index.scan_mode, index.n_probe, index.use_approx_topk = keep
    r = rows_log[0]
    if r["flat_recall"] < 0.85 or r["cell_major_recall"] < 0.75:
        fail(f"precision default: recall@10 flat {r['flat_recall']:.4f} "
             f"(floor 0.85), n_probe 32 {r['cell_major_recall']:.4f} "
             f"(floor 0.75)")
    agree = share_equal(out["default"], out["highest"])
    log(f"precision: the flat plan's ids at default equal to highest's on "
        f"{agree:.5f}")
    if agree < 0.99:
        fail("precision: the flat plan at default departs from highest")
    # FlatIndex at "default": an f32 sweep of the bf16-rounded operands
    xb = torch.from_numpy(base).cuda()
    nb = (xb * xb).sum(-1)
    xb16 = xb.to(torch.bfloat16).float()
    want = torch.cat([torch.topk(
        2 * (xq[i:i + 1000].to(torch.bfloat16).float() @ xb16.T) - nb[None],
        k, dim=-1).indices for i in range(0, xq.shape[0], 1000)])
    del xb, xb16
    agree = recall_at(i_default.long(), want)
    log(f"precision: FlatIndex at default, ids against an f32 sweep of the "
        f"bf16-rounded operands {agree:.5f}, recall@10 against the f32 "
        f"truth {r['flat_index_recall']:.5f}")
    if agree < 0.999:
        fail("precision: FlatIndex at default departs from the bf16 sweep")
    del flat
    return rows_log


def phase_flat_index(torch, tp, sl):
    """FlatIndex over the slice's 1M x 128 base, f32, euclidean: 10k
    queries at k = 10 and 100, each search's ids held to the exact f32
    ground truth (>= 0.999 agreement: only exact ties may fall either
    way), ms per batch and device bytes logged, one k = 10 search
    profiled; then a seeded 10% of the ids removed and 1,000 queries held
    to the exact ground truth of the survivors."""
    base, xq = sl["base"], sl["xq"]
    n, d = base.shape
    t0 = time.perf_counter()
    flat = tp.FlatIndex(d_vector=d, initial_size=n, device="cuda")
    ids = flat.add(torch.from_numpy(base).cuda().T)
    torch.cuda.synchronize()
    log(f"FlatIndex: add {n} x {d} f32 {time.perf_counter() - t0:.2f} s; "
        f"capacity {flat.capacity}, device bytes {flat.state_nbytes()}")
    if not torch.equal(ids.cpu(), torch.arange(n, dtype=ids.dtype)):
        fail("FlatIndex did not assign ids 0..n-1")
    for kk, gt in ((10, sl["gt"]), (100, exact_gt(torch, base, xq, 100))):
        flat.search(xq.T, k=kk)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            vals, got = flat.search(xq.T, k=kk)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        agree = recall_at(got.long(), gt)
        ms = float(np.median(times)) * 1e3
        log(f"FlatIndex k={kk}: {ms:.2f} ms per {xq.shape[0]}-query batch "
            f"({xq.shape[0] / ms * 1e3:.0f} q/s), id agreement with the "
            f"exact ground truth {agree:.5f}")
        if tuple(got.shape) != (xq.shape[0], kk) or agree < 0.999 \
                or not bool(torch.isfinite(vals).all()):
            fail(f"FlatIndex k={kk} disagrees with the exact ground truth")
    profile_search(torch, lambda: flat.search(xq.T, k=10),
                   "FlatIndex k=10")
    gen = np.random.default_rng(0)
    gone = gen.choice(n, n // 10, replace=False)
    if flat.remove(gone) != gone.size:
        fail("FlatIndex removed another count than asked")
    keep = np.setdiff1d(np.arange(n), gone)
    sub = xq[:1000]
    gt = exact_gt(torch, base[keep], sub, 10)
    want = torch.from_numpy(keep).cuda()[gt]
    _, got = flat.search(sub.T, k=10)
    agree = recall_at(got.long(), want)
    log(f"FlatIndex after removing {gone.size} seeded ids: {flat.n_items} "
        f"items; 1,000 queries, id agreement with the survivors' exact "
        f"ground truth {agree:.5f}")
    if agree < 0.999 or bool(np.isin(got.cpu().numpy(), gone).any()):
        fail("FlatIndex after the remove disagrees with the survivors' "
             "ground truth")
    del flat


def phase_transforms(torch, tp, sl):
    """The transforms and SQ at 100k x 128 of the slice's data (no kernel
    on these paths), each card result against the same calls on the CPU
    from the same carried state: OPQ (PQ16, 3 rounds, trained on the card)
    -> rotate (within 1e-4) -> an IVFPQIndex IVF256 x PQ16 (trained on the
    card over the rotated rows, carried to the CPU, the same adds): the
    exact n_probe 8 search of 1,000 rotated queries, ids on >= 0.99 and
    values within 1e-2 where the ids agree; PCA 128 -> 64 (trained on the
    card) -> encode (within 1e-3) -> FlatIndex: 1,000 queries, the same
    holds; and an SQCodec (8 bits) round trip: codes equal to the CPU's on
    >= 0.999, every decode within half a bin of its input (1e-5 of the
    largest |x| for rounding)."""
    base, xq = sl["base"], sl["xq"]
    n = min(100_000, base.shape[0])
    x_cpu = torch.from_numpy(base[:n]).T.contiguous()
    x = x_cpu.cuda()
    q_cpu = xq[:1000].T.cpu().contiguous()
    q = q_cpu.cuda()

    def held(label, v, i, v_ref, i_ref, tol):
        """ids on >= 0.99; values within tol where the ids agree (the two
        devices' rows differ in their last bits, so a code may flip)."""
        agree = recall_at(i.cpu().long(), i_ref.long())
        same = i.cpu() == i_ref
        err = float((v.cpu() - v_ref).abs()[same].max())
        log(f"transforms: {label} card vs CPU: id agreement {agree:.5f}, "
            f"max value diff at equal ids {err:.3g}")
        if agree < 0.99 or err > tol:
            fail(f"{label}: the card's search differs from the CPU's")

    t0 = time.perf_counter()
    opq = tp.transform.OPQ(d_vector=128, n_subvectors=16, n_iter=3,
                           device="cuda")
    opq.train(x)
    opq_cpu = tp.transform.OPQ(d_vector=128, n_subvectors=16, device="cpu")
    opq_cpu.load_state_dict(opq.state_dict())
    z, z_cpu = opq.rotate(x), opq_cpu.rotate(x_cpu)
    if float((z.cpu() - z_cpu).abs().max()) > 1e-4:
        fail("OPQ.rotate on the card differs from the CPU's")
    kw = dict(d_vector=128, n_subvectors=16, n_cells=256, initial_size=512)
    ivf = tp.IVFPQIndex(**kw, device="cuda")
    ivf.train(z)
    ivf_cpu = tp.IVFPQIndex(**kw, device="cpu")
    ivf_cpu.load_state_dict(ivf.state_dict())
    ivf.add(z)
    ivf_cpu.add(z_cpu)
    for idx in (ivf, ivf_cpu):
        idx.scan_mode, idx.n_probe, idx.use_approx_topk = "cell_major", 8, \
            False
    v, i = ivf.search(opq.rotate(q), k=10)
    v_ref, i_ref = ivf_cpu.search(opq_cpu.rotate(q_cpu), k=10)
    held("OPQ (PQ16) -> IVFPQIndex IVF256 x PQ16, exact n_probe 8", v, i,
         v_ref, i_ref, 1e-2)
    log(f"transforms: OPQ path {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    pca = tp.transform.PCA(n_components=64, device="cuda")
    pca.train(x)
    pca_cpu = tp.transform.PCA(n_components=64, device="cpu")
    pca_cpu.load_state_dict(pca.state_dict())
    y, y_cpu = pca.encode(x), pca_cpu.encode(x_cpu)
    if float((y.cpu() - y_cpu).abs().max()) > 1e-3:
        fail("PCA.encode on the card differs from the CPU's")
    flat = tp.FlatIndex(d_vector=64, initial_size=n, device="cuda")
    flat_cpu = tp.FlatIndex(d_vector=64, initial_size=n, device="cpu")
    flat.add(y)
    flat_cpu.add(y_cpu)
    v, i = flat.search(pca.encode(q), k=10)
    v_ref, i_ref = flat_cpu.search(pca_cpu.encode(q_cpu), k=10)
    held("PCA 128 -> 64 -> FlatIndex", v, i, v_ref, i_ref, 1e-2)
    log(f"transforms: PCA path {time.perf_counter() - t0:.2f} s")

    sq = tp.codec.SQCodec(bits=8, device="cuda")
    sq.train(x)
    sq_cpu = tp.codec.SQCodec(bits=8, device="cpu")
    sq_cpu.load_state_dict(sq.state_dict())
    codes = sq.encode(x)
    same = share_equal(codes.cpu(), sq_cpu.encode(x_cpu))
    err = ((sq.decode(codes) - x).abs() - sq.binsize[:, None] / 2).max()
    log(f"transforms: SQCodec 8-bit round trip on the card: codes equal to "
        f"the CPU's {same:.6f}, decode within half a bin (excess "
        f"{float(err):.3g})")
    if same < 0.999 or float(err) > 1e-5 * (1 + float(x.abs().max())):
        fail("SQCodec round trip on the card")


def phase_aniso_manhattan(torch, tp, bs, cs, sl):
    """No kernel lies on these paths, so they run at a reduced size, 100k x
    128 of the slice's data. Anisotropic PQ: from the main PQ codebook as
    the warm start, the card's _aniso_assign and _aniso_refine (eta 4, 8
    iterations) on the 100k rows, timed; the same two calls on the card and
    on the CPU over the first 10,000 rows: labels agree on >= 0.999, the
    refined centroids on >= 0.99 of their entries within 1e-3 + 1e-3 |c|
    (the card's per-cluster sums are atomic adds in a run-dependent order,
    and a label flipped on a near-tie in one of 8 rounds moves its two
    clusters: 0.9992-0.9997 measured on an H100).
    Manhattan: an IVF256 x PQ64 index trained and filled on the 100k rows,
    1,000 queries: pack32 at n_probe 8 and flat, recall@10 against exact L1
    ground truth logged, the all-cells exact probe against the flat sweep,
    and the block-scan and codes-scan counters unmoved (the gates exclude
    manhattan, as the JAX package's: zeroed before, 0 after)."""
    from torchpq_tpu_torch.codec import pq as tpq
    base, xq = sl["base"], sl["xq"]
    n, d = min(100_000, base.shape[0]), base.shape[1]
    x = torch.from_numpy(base[:n]).cuda()
    main_pq = sl["index"].pq_codec
    m, k_c = main_pq.n_subvectors, main_pq.n_clusters
    sub = x.T.reshape(m, d // m, n).contiguous()
    warm = main_pq.codebook_internal
    chunk = tpq._aniso_chunk(m, k_c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined = tpq._aniso_refine(sub, warm, eta=4.0, iters=8, k=k_c,
                                chunk=chunk)
    lab = tpq._aniso_assign(sub, refined, eta=4.0, k=k_c, chunk=chunk)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    moved = float((refined - warm).abs().max())
    changed = float((lab != tpq._aniso_assign(sub, warm, eta=1.0, k=k_c,
                                              chunk=chunk)).float().mean())
    small = sub[:, :, :10_000]
    lab_g = tpq._aniso_assign(small, warm, eta=4.0, k=k_c, chunk=chunk)
    ref_g = tpq._aniso_refine(small, warm, eta=4.0, iters=8, k=k_c,
                              chunk=chunk)
    t0 = time.perf_counter()
    lab_c = tpq._aniso_assign(small.cpu(), warm.cpu(), eta=4.0, k=k_c,
                              chunk=chunk)
    ref_c = tpq._aniso_refine(small.cpu(), warm.cpu(), eta=4.0, iters=8,
                              k=k_c, chunk=chunk)
    cpu_s = time.perf_counter() - t0
    lab_agree = share_equal(lab_g.cpu(), lab_c)
    close = (ref_g.cpu() - ref_c).abs() <= 1e-3 + 1e-3 * ref_c.abs()
    cent_agree = share_equal(close, torch.ones_like(close))
    log(f"anisotropic PQ (eta 4, 8 iterations, warm start: the main PQ "
        f"codebook): card on {n} rows {card_s:.2f} s (centroids moved up "
        f"to {moved:.4g}, {changed:.4f} of the codes differ from the "
        f"plain assignment); card vs CPU on 10,000 rows (CPU {cpu_s:.2f} "
        f"s): labels agree {lab_agree:.6f}, refined centroid entries "
        f"within 1e-3 + 1e-3 |c| {cent_agree:.6f} (max diff "
        f"{float((ref_g.cpu() - ref_c).abs().max()):.3g})")
    if lab_agree < 0.999 or cent_agree < 0.99:
        fail("the card's anisotropic assignment or refinement disagrees "
             "with the CPU's")
    del sub, refined, lab, small

    # manhattan: IVF256 x PQ64 on the 100k rows, 1,000 queries
    q = xq[:1000]
    for launches in (bs.launches, cs.launches):
        for key in launches:
            launches[key] = 0
    t0 = time.perf_counter()
    man = tp.IVFPQIndex(d_vector=d, n_subvectors=m, n_cells=256,
                        initial_size=max(16, n // 256 * 3),
                        distance="manhattan", device="cuda")
    man.train(x.T)
    man.add(x.T)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gt = torch.cat([torch.topk(tp.metric.negative_manhattan_distance(
        q[i:i + 250], x), 10, dim=-1).indices
        for i in range(0, q.shape[0], 250)])
    out = {}
    for plan in (("cell_major", 8, True), ("flat", 1, True)):
        man.scan_mode, man.n_probe, man.use_approx_topk = plan
        man.search(q.T, k=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, i = man.search(q.T, k=10)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[plan] = recall_at(i.long(), gt)
        log(f"manhattan {plan[0]} n_probe={plan[1]}: {ms:.2f} ms per "
            f"1,000 queries, recall@10 against exact L1 {out[plan]:.4f}"
            + (f", select {tp.ops.adc.LAST_GATE.get('impl')}"
               if plan[0] == "cell_major" else ""))
    all_cells_check(torch, man, q, 10, "manhattan ")
    counts = {**bs.launches, **cs.launches}
    log(f"manhattan index: train + add {build_s:.2f} s; block / codes scan "
        f"launches {counts}")
    if any(counts.values()):
        fail(f"the manhattan plans launched a scan kernel: {counts}")
    del man, x


def phase_pallas_flat(torch, tp, fs, sl):
    """scan_impl="pallas_flat" on the main index: the flat plan through the
    fused flat scan (its counters zeroed before, read after; the bf16
    cache must take the warp-specialised kernel, "flat_wg", and no other),
    held to the exact flat plan run in the same call (ids >= 0.98, recall
    within 0.01), both timed; then the kernel against flat_scan_ref on the
    plan's own arguments, timed in turns with the CUDA-core kernel on the
    same arguments and, with --parent, with the parent tree's
    csrc/flat_scan_tc.cu (its mma.sync kernel, the parent's route here),
    and a yardstick of the product alone (bf16 torch.matmul over a slice of
    the cache, scaled to the whole) and the kernel at half the width.
    Returns (launch counts, the kernel's JSON row)."""
    index, xq, gt, k = (sl[x] for x in ("index", "xq", "gt", "k"))
    index.scan_mode, index.use_approx_topk = "flat", True

    def timed():
        index.search(xq.T, k=k)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = index.search(xq.T, k=k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, float(np.median(times)) * 1e3

    index.scan_impl = "auto"
    (_, i_ref), sweep_ms = timed()
    for key in fs.launches:
        fs.launches[key] = 0
    index.scan_impl = "pallas_flat"
    (v, i), kern_ms = timed()
    counts = dict(fs.launches)
    if counts["flat_wg"] <= 0 or any(n for key, n in counts.items()
                                     if key != "flat_wg") \
            or tp.ops.flat_adc.LAST_FLAT["impl"] != "flat_scan":
        fail("the pallas_flat flat plan did not launch the warp-specialised "
             f"flat kernel alone: {counts}")
    agree = recall_at(i.long(), i_ref.long())
    r_k, r_s = recall_at(i.long(), gt), recall_at(i_ref.long(), gt)
    log(f"pallas_flat flat plan: {kern_ms:.2f} ms ({xq.shape[0] / kern_ms * 1e3:.0f} q/s), "
        f"recall {r_k:.4f}; exact sweep {sweep_ms:.2f} ms, recall "
        f"{r_s:.4f}; id agreement {agree:.5f}; launches {counts}")
    # The kernel keeps the TPU kernel's bucket approximation (the top 2 of
    # each 64-slot bucket): in the cell-ordered flat layout a query's
    # neighbours share buckets, and ~1.2% of the exact top-10 ids drop out
    # on this data (0.98758, recall -0.0067 in the first card run). Its
    # fidelity is the check against flat_scan_ref below; these floors
    # guard against a broken plan.
    if agree < 0.98 or abs(r_k - r_s) > 0.01:
        fail("the pallas_flat flat plan disagrees with the exact flat plan")
    args, kw = capture_call(tp, index, xq, k, module=tp.ops.flat_adc,
                            name="flat_scan")
    index.scan_impl = "auto"
    got = flat_launch(torch, fs, args, "flat_wg", **kw)
    torch.cuda.synchronize()
    ref = fs.flat_scan_ref(*args, **kw)
    err = compare_topk(torch, got[0][:, :k], got[1][:, :k], ref[0][:, :k],
                       ref[1][:, :k])
    q, dec = args[0], args[1]
    nq, d = q.shape
    cap = dec.shape[0]
    # in turns: CUDA cores, wgmma, wgmma, CUDA cores; then, with --parent,
    # the parent's mma.sync kernel, wgmma, wgmma, the parent's
    t, turns = in_turns(torch, {
        "flat": lambda: flat_launch(torch, fs, args, "flat", **kw),
        "flat_wg": lambda: flat_launch(torch, fs, args, "flat_wg", **kw)},
        3)
    ms, cc_ms = t["flat_wg"], t["flat"]
    row = {}
    launch_parent, out_parent = parent_flat_fn(torch, fs, args, kw)
    if launch_parent is not None:
        row.update(parent_turns(
            torch, [None, got[1]], out_parent[1], launch_parent,
            lambda: flat_launch(torch, fs, args, "flat_wg", **kw)[1],
            "the pallas_flat plan's flat scan",
            "csrc/flat_scan_tc.cu (mma.sync)", "parent_flat"))
        if row["parent_flat_live_equal"] != 1.0:
            # both exact: the lists may differ only where values tie
            compare_topk(torch, out_parent[0], out_parent[1], got[0], got[1])
    plain_ms = cuda_ms(torch, lambda: fs.flat_scan_ref(*args, **kw), 2)
    flop = 2.0 * nq * cap * d
    b_ms, b_by = bound(flop, cap * d * dec.element_size() + cap * 4
                       + nq * d * 4 + nq * kw["r_keep"] * 8, "bf16")
    # the product alone: bf16 queries x a 65,536-slot slice, scaled to cap
    sl_rows = min(cap, 65536)
    qb, yb = q.to(torch.bfloat16), dec[:sl_rows]
    mm_ms = cuda_ms(torch, lambda: torch.matmul(qb, yb.T), 10) * cap / sl_rows
    # the same queries and slots at d = 64: half the products, the same
    # epilogue, which splits the kernel's time between the two
    half = fs.random_flat_inputs("cuda", nq=nq, cap=cap, d=d // 2, seed=1)
    half_ms = cuda_ms(torch, lambda: flat_launch(torch, fs, half, "flat_wg",
                                                 **kw), 10)
    del half
    log(f"flat_scan on the plan's arguments (nq={nq}, cap={cap}, d={d}, "
        f"r_keep={kw['r_keep']}): flat_wg {ms:.3f} ms "
        f"({' / '.join(f'{x:.3f}' for x in turns['flat_wg'])}; "
        f"{flop / ms / 1e9:.2f} TFLOP/s, {b_ms / ms:.1%} of the bound), CUDA "
        f"cores {cc_ms:.3f} ms "
        f"({' / '.join(f'{x:.3f}' for x in turns['flat'])}; "
        f"{flop / cc_ms / 1e9:.2f} TFLOP/s), speed-up {cc_ms / ms:.2f}x; "
        f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
        f"max_abs_err {err:.3g}")
    log(f"flat_scan yardstick, the product alone (bf16 torch.matmul "
        f"[{nq}, {d}] x [{d}, {sl_rows}], scaled to cap): {mm_ms:.3f} ms "
        f"({flop / mm_ms / 1e9:.2f} TFLOP/s); flat_wg at d={d // 2} "
        f"(half the products, the same epilogue): {half_ms:.3f} ms")
    return counts, dict(
        name="flat_scan", route="cuda",
        source="torchpq_tpu_torch/csrc/flat_scan_wg.cu",
        replaces="torchpq_tpu/ops/pallas_flat.py:139", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, cuda_core_ms=cc_ms,
        cuda_core_source="torchpq_tpu_torch/csrc/flat_scan.cu",
        matmul_ms=mm_ms, half_width_ms=half_ms, **row)


# the GIST-class phase's searches
GIST_PLANS = [("flat", 1, True), ("cell_major", 8, True),
              ("cell_major", 32, True), ("cell_major", 8, False)]
# the JAX package's two GIST records (benchmark/results/
# ivf4096_pq64_gist1m_class_r3.json, bf16 cache, and
# ivf4096_pq64_gist1m_int8_r5.json, int8 cache): spill 8 cells at the
# initial capacity 2 x n / n_cells (512 slots), scan_group 4 (s_eff 2048),
# approximate top-k; k = 10: flat, pack32 at n_probe 8 and 32, exact at
# n_probe 8; k = 100: pack32 at n_probe 8 and 32 (k_pair 64 over G = 512)
GIST_GROUP = 4
GIST_PLANS_K10 = [("flat", 1, True), ("cell_major", 8, True),
                  ("cell_major", 32, True), ("cell_major", 8, False)]
GIST_PLANS_K100 = [("cell_major", 8, True), ("cell_major", 32, True)]


def pq_ceiling(torch, index, xq, xb, k):
    """The exact f32 top-k ids of the queries over the PQ-decoded rows of
    every vector an index stores (its ADC ceiling), in chunks of 500."""
    addr = torch.nonzero(~index._is_empty).flatten()
    ids = index._address2id[addr].long()
    rows = index._decode_stored(index.storage_rows(addr))
    norms = (rows * rows).sum(-1)
    top = [ids[torch.topk(2 * xq[i:i + 500] @ rows.T - norms[None], k,
                          dim=-1).indices]
           for i in range(0, xq.shape[0], 500)]
    del rows
    return torch.cat(top)


def gist_gate(gates, plans, k_pair, label):
    """Each pack32 plan's gate record: the block scan's pack32 select at
    s_eff 2048 (supercells of 4 cells of 512 slots) and this k_pair, as the
    records' scan_gate shows."""
    for plan in plans:
        g = gates[plan]
        if plan[0] != "cell_major" or not plan[2]:
            continue
        if g.get("impl") != "block_scan" or not g.get("pack32") \
                or g.get("s_eff") != 2048 or g.get("k_pair") != k_pair:
            fail(f"{label}n_probe={plan[1]}: gate {g}, not the records' "
                 f"pack32 scan at s_eff 2048, k_pair {k_pair}")


def gist_plans(torch, tp, bs, index, xq, gt, k, plans, label):
    """time_plans over one set of plans with the block-scan counters zeroed
    just before and read just after, each plan's gate record kept ->
    (recall per plan, counts, gates)."""
    gates = {}
    for key in bs.launches:
        bs.launches[key] = 0
    rec = {}
    for plan in plans:
        r, _ = time_plans(torch, tp, index, xq, gt, k, bs.launches, label,
                          plans=[plan], floors=False)
        rec.update(r)
        gates[plan] = dict(tp.ops.adc.LAST_GATE)
    return rec, dict(bs.launches), gates


def int8_deep_row(torch, tp, bs, index, xq, k, name, what):
    """The int8 tier's pack32 k = 100 scan (k_pair 64 over G = 512, the
    k-chunked warp-specialised int8 instance of four ring stages, the deep
    select) on its search's own arguments: bit for bit against
    block_scan_ref on live rows, pad rows dead, the CUDA-core int8 kernel
    on every row; timed in turns with it (and, with --parent, with the
    parent's block_scan_wg.cu instance) and beside the same launch writing
    one key per row. Returns the kernels-line row."""
    args, kw = capture_call(tp, index, xq, k)
    s_eff, k_pair = kw["s_eff"], kw["k_pair"]
    blocks, p_tile = args[1].shape
    d = args[6].shape[1]
    live = int((args[1] >= 0).sum())
    route = bs.pick_route(dtype=args[6].dtype, d=d, p_tile=p_tile,
                          s_eff=s_eff, k_pair=k_pair, pack32=True)
    log(f"{what}: {blocks} blocks x {p_tile} probers, {live} live "
        f"({live / (blocks * p_tile):.3f}), s_eff={s_eff}, k_pair={k_pair}, "
        f"G={bs.n_groups(s_eff, k_pair)}, d_cache={d}, route {route}")
    if route != "tc_wg_int8_pack32":
        fail(f"{what} routes to {route}, not the k-chunked warp-specialised "
             "int8 instances")
    extra = dict(scale=kw["scale"], q_scale=kw["q_scale"])
    check_kernel(torch, bs, args, s_eff=s_eff, k_pair=k_pair, pack32=True,
                 euclidean=kw["euclidean"], equal=True, extra=extra, reps=0)
    kkw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=kw["euclidean"],
               pack32=True, slot_mask=kw["slot_mask"], **extra)
    t, turns = in_turns(torch, {
        "cuda_cores": lambda: block_launch(torch, bs, args, "int8_pack32",
                                           **kkw),
        route: lambda: block_launch(torch, bs, args, route, **kkw)}, 3)
    ms, cc_ms = t[route], t["cuda_cores"]
    k1_ms = one_key_ms(torch, bs, args, kkw, 3)
    plain_ms = cuda_ms(torch, lambda: bs.block_scan_ref(*args, **kkw), 1)
    b_ms, b_by = scan_bound(torch, args, kkw, slot_bytes=d + 8,
                            row_bytes=d + 4, peak="int8", d=d)
    log(f"{name} on {what}'s arguments: {route} {ms:.3f} ms ("
        f"{' / '.join(f'{x:.3f}' for x in turns[route])}; "
        f"{2.0 * s_eff * d * live / ms / 1e9:.2f} TOP/s over live probers, "
        f"{b_ms / ms:.1%} of the bound), CUDA cores {cc_ms:.3f} ms ("
        f"{' / '.join(f'{x:.3f}' for x in turns['cuda_cores'])}), speed-up "
        f"{cc_ms / ms:.2f}x; the launch writing one key per row {k1_ms:.3f} "
        f"ms; plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); equal "
        f"to the plain version bit for bit on live rows, pad rows dead, the "
        f"CUDA-core kernel equal on every row")
    inst = wg_instance(True, k_pair, d, int8=True)
    return dict(
        name=name, route="cuda", source=route_source(route),
        replaces="torchpq_tpu/ops/pallas_scan.py:281", max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, launch_key=route, cuda_core_ms=cc_ms,
        cuda_core_source="torchpq_tpu_torch/csrc/block_scan.cu",
        one_key_ms=k1_ms, instance=inst, sass=SASS.get(inst),
        **block_turns(torch, bs, args, kkw, route,
                         f"{name} on {what}'s arguments"))


def phase_gist_records(torch, tp, bs, trained, base, xq, xb, gt100, d, m,
                       n_cells):
    """The JAX package's two GIST records at their settings on the phase's
    trained codecs: the same four adds into a bf16 tier (r3) and an int8
    tier (r5), spill 8 cells at 2 x n / n_cells, scan_group 4. Per tier,
    the k = 10 plans and then the k = 100 plans, the block-scan counters
    zeroed before and read after each set (the tensor-core keys only, no
    CUDA-core key); each pack32 plan's gate at s_eff 2048 with k_pair 10 /
    64; recall non-decreasing in n_probe (within 0.005); the flat plan
    within 0.02 of the exact f32 sweep over the tier's PQ-decoded rows;
    int8 within 0.005 of bf16 per k = 10 plan; recall@100 logged. Then the
    scans on the tiers' own arguments: bf16 exact (n_probe 8) and pack32
    k = 10 and k = 100 (n_probe 32) held to block_scan_ref (values within
    the tolerance, pack32 keys or slots >= 0.99), int8 pack32 k = 100 bit
    for bit, each timed in turns with block_scan.cu; both tiers profiled.
    Returns ({row name: launches}, the kernels' JSON rows)."""
    gt10 = gt100[:, :10]
    per_cell = base.shape[0] // n_cells * 2
    rows, launches, rec10 = {}, {}, {}
    for tier, cache in (("bf16", None), ("int8", "int8")):
        t0 = time.perf_counter()
        idx, add_s = build_index(torch, tp, trained, base, d=d, m=m,
                                 n_cells=n_cells, per_cell=per_cell,
                                 cache=cache, spill=True)
        idx.scan_group = GIST_GROUP
        dec = idx.aux("decoded")
        sizes = idx._cell_size_np
        label = f"GIST {tier} records "
        log(f"{label}index: add {add_s:.2f} s; cache {tuple(dec.shape)} "
            f"{dec.dtype}; spill 8 cells at capacity {idx.spill_capacity}, "
            f"largest cell {int(sizes.max())}, max cell capacity "
            f"{idx.max_cell_capacity}, scan_group {idx.scan_group}")
        if tuple(dec.shape[1:]) != (1024,) or idx.max_cell_capacity != 512:
            fail(f"{label}: cache {tuple(dec.shape)}, capacity "
                 f"{idx.max_cell_capacity}; the records' are 1024 wide, 512")
        keys = GIST_INT8_KEYS if cache else GIST_BF16_KEYS
        r10, c10, g10 = gist_plans(torch, tp, bs, idx, xq, gt10, 10,
                                   GIST_PLANS_K10, label)
        log(f"{label}k=10 launches: {c10}")
        require_only_tc(c10, keys, f"the {label}k = 10 plans")
        r100, c100, g100 = gist_plans(torch, tp, bs, idx, xq, gt100, 100,
                                      GIST_PLANS_K100, label + "k=100 ")
        log(f"{label}k=100 launches: {c100}")
        require_only_tc(c100, keys[1:], f"the {label}k = 100 plans")
        gist_gate(g10, GIST_PLANS_K10, 10, label)
        gist_gate(g100, GIST_PLANS_K100, 64, label + "k=100 ")
        rising(r10, GIST_PLANS_K10, label + "k=10")
        rising(r100, GIST_PLANS_K100, label + "k=100")
        rec_pq = recall_at(pq_ceiling(torch, idx, xq, xb, 10), gt10)
        gap = r10[("flat", 1, True)] - rec_pq
        log(f"{label}recall@10: flat {r10[('flat', 1, True)]:.4f} vs the "
            f"exact f32 sweep over its PQ-decoded rows {rec_pq:.4f} (gap "
            f"{gap:+.4f}); pack32 n_probe 8 / 32 "
            f"{r10[('cell_major', 8, True)]:.4f} / "
            f"{r10[('cell_major', 32, True)]:.4f}, exact n_probe 8 "
            f"{r10[('cell_major', 8, False)]:.4f}; recall@100 pack32 "
            f"n_probe 8 / 32 {r100[('cell_major', 8, True)]:.4f} / "
            f"{r100[('cell_major', 32, True)]:.4f}")
        if abs(gap) > 0.02:
            fail(f"{label}flat recall is {gap:+.4f} off the PQ ceiling")
        if cache:
            for plan, r in r10.items():
                if abs(r - rec10[plan]) > 0.005:
                    fail(f"{label}{plan}: recall@10 {r:.4f} vs the bf16 "
                         f"tier's {rec10[plan]:.4f}")
            log(f"{label}recall@10 within 0.005 of the bf16 tier's on "
                f"every plan")
        rec10 = r10
        if not cache:
            # the flat plan's GEMMs at "highest" beside the default, in turns
            flat_ms = {}
            for p in ("default", "highest", "highest", "default"):
                with search_precision(tp, p):
                    flat_ms.setdefault(p, []).append(plan_ms(
                        torch, idx, xq, 10, "flat", 1, True)[0])
            log(f"{label}flat plan by search precision, in turns (ms): "
                f"{json.dumps(flat_ms)}")
        if cache:
            name = "block_scan_int8_pack32_k100_d1024"
            rows[name] = int8_deep_row(torch, tp, bs, idx, xq, 100, name,
                                       f"the {label}k=100 n_probe=32 search")
            launches[name] = c100["tc_wg_int8_pack32"]
        else:
            rows.update(phase_main_shapes(
                torch, tp, bs, idx, xq, 10, label=label.strip(),
                suffix="_d1024", plans=((8, False),), reps=5, both=False,
                f32_bound=True))
            launches["block_scan_exact_d1024"] = c10[keys[0]]
            for kk, name, cnt in ((10, "block_scan_pack32_d1024", c10),
                                  (100, "block_scan_pack32_k100_d1024",
                                   c100)):
                idx.scan_mode, idx.n_probe = "cell_major", 32
                idx.use_approx_topk = True
                args, kw = capture_call(tp, idx, xq, kk)
                rows[name] = pack32_scan_row(
                    torch, bs, name, args, kw,
                    f"the {label}k={kk} n_probe=32 search", against_f64=True)
                launches[name] = cnt[keys[1]]
                del args
        if not cache:
            planner_sweep(torch, tp, idx, xq, "GIST bf16 record",
                          nq_probes=(32,))
        phase_profile(torch, idx, xq, 10, label=label,
                      plans=[p for p in GIST_PLANS_K10 if p[0] != "flat"])
        phase_profile(torch, idx, xq, 100, label=label + "k=100 ",
                      plans=GIST_PLANS_K100)
        log(f"{label}phase: {time.perf_counter() - t0:.1f} s")
        del idx, dec
        torch.cuda.empty_cache()
    return launches, rows


def phase_gist(torch, tp, bs):
    """The int8 tier at a GIST-class shape: 1M x 960 manifold-12 data
    (seed 1), IVF4096 x PQ64, an int8 cache lane-padded to 1024, 10k
    queries, k=10, spill and scan_group off. Then the JAX package's two
    GIST records on the same trained codecs (phase_gist_records). Returns
    the int8 launch counts of its plans, the int8 kernels' JSON rows at
    d_cache 1024, the index and its queries, and the records' ({row name:
    launches}, rows)."""
    n_base, n_query, d, m, n_cells, k = 1_000_000, 10_000, 960, 64, 4096, 10
    t0 = time.perf_counter()
    base, query = make_data(n_base, n_query, d, seed=1)
    log(f"GIST-class data {n_base} x {d} + {n_query} queries: "
        f"{time.perf_counter() - t0:.1f} s (host)")
    per_cell = max(16, n_base // n_cells * 3)
    index = tp.IVFPQIndex(d_vector=d, n_subvectors=m, n_cells=n_cells,
                          initial_size=per_cell, distance="euclidean",
                          scan_cache_dtype="int8", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.train(torch.from_numpy(base[: n_base // 10]).cuda().T)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = {**index.vq_codec.state_dict("vq_codec."),
               **index.pq_codec.state_dict("pq_codec.")}
    del index
    index, add_s = build_index(torch, tp, trained, base, d=d, m=m,
                               n_cells=n_cells, per_cell=per_cell,
                               cache="int8")
    dec = index.aux("decoded")
    log(f"GIST-class int8 index: train {train_s:.2f} s, add {add_s:.2f} s; "
        f"cache {tuple(dec.shape)} {dec.dtype}; max cell capacity "
        f"{index.max_cell_capacity}, largest cell "
        f"{int(index._cell_size_np.max())}")
    if tuple(dec.shape[1:]) != (1024,) or dec.dtype != torch.int8:
        fail("the GIST-class cache is not int8 and 1024 wide")

    xb = torch.from_numpy(base).cuda()
    xq = torch.from_numpy(query).cuda()
    # exact f32 ground truth (top 100; its first 10 the k = 10 truth), and
    # the exact f32 sweep over the PQ-decoded rows of every stored vector
    # (the ADC ceiling of these codes)
    xb_n = (xb * xb).sum(-1)
    gt100 = torch.cat([torch.topk(2 * xq[i:i + 500] @ xb.T - xb_n[None],
                                  100, dim=-1).indices
                       for i in range(0, n_query, 500)])
    gt = gt100[:, :k]
    rec_pq = recall_at(pq_ceiling(torch, index, xq, xb, k), gt)
    torch.cuda.synchronize()

    for key in bs.launches:
        bs.launches[key] = 0
    rec, _ = time_plans(torch, tp, index, xq, gt, k, bs.launches,
                        "GIST int8 ", plans=GIST_PLANS, floors=False)
    counts = dict(bs.launches)
    log(f"GIST int8 launches: {counts}")
    require_only_tc(counts, GIST_INT8_KEYS, "the GIST-class phase")
    r8, r32 = rec[("cell_major", 8, True)], rec[("cell_major", 32, True)]
    gap = rec[("flat", 1, True)] - rec_pq
    log(f"GIST int8: flat recall {rec[('flat', 1, True)]:.4f} vs the exact "
        f"f32 sweep over the PQ-decoded rows {rec_pq:.4f} (gap {gap:+.4f});"
        f" pack32 n_probe 8 / 32: {r8:.4f} / {r32:.4f}")
    if r32 < r8 - 0.005:
        fail(f"GIST recall falls with n_probe: {r8:.4f} {r32:.4f}")
    if abs(gap) > 0.02:
        fail(f"GIST int8 flat recall is {gap:+.4f} off the PQ ceiling")
    rows = int8_kernel_rows(torch, tp, bs, index, xq, k, "GIST int8 ",
                            suffix="_d1024", reps=3)
    records = phase_gist_records(torch, tp, bs, trained, base, xq, xb, gt100,
                                 d, m, n_cells)
    del xb, base
    return counts, rows, index, xq, records


# the slice's searches: (scan_mode, n_probe, use_approx_topk)
PLANS = [("flat", 1, True), ("cell_major", 1, True), ("cell_major", 8, True),
         ("cell_major", 32, True), ("cell_major", 8, False)]


def recall_at(ids, gt):
    hit = (ids[:, :, None] == gt[:, None, :]).any(-1).float().sum(-1)
    return float(hit.mean() / gt.shape[1])


def codec_hash(torch, state):
    """sha256 over a codec state dict's tensors' bytes, in key order."""
    import hashlib
    h = hashlib.sha256()
    for key in sorted(state):
        h.update(key.encode())
        v = state[key]
        h.update(v.detach().cpu().contiguous().numpy().tobytes()
                 if isinstance(v, torch.Tensor) else repr(v).encode())
    return h.hexdigest()


def first_segment_sum_s(torch):
    """Host seconds of the process's first compute_centroids call on the
    card (1,000 x 128 rows into 16 clusters), and then of the first
    index_add_ under PyTorch's deterministic algorithms (switched on for
    that call), the other deterministic route: one-time costs a first
    training would carry."""
    from torchpq_tpu_torch.ops import segment_ops
    x = torch.ones((1000, 128), device="cuda")
    labels = torch.arange(1000, device="cuda") % 16

    def first(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def det_index_add():
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            torch.zeros((16, 128), device="cuda").index_add_(0, labels, x)
        finally:
            torch.use_deterministic_algorithms(was)

    return (first(lambda: segment_ops.compute_centroids(x, labels, 16)),
            first(det_index_add))


def train_repro(torch, tp, index, trained, base, train_s, first_s):
    """The card's training is reproducible: a second index of the main
    layout trained on the same slice holds bit-equal codecs (the Lloyd
    sums sort by label and sum each cluster in a fixed order,
    ops/segment_ops.py). Then the cost: trainings with the atomic
    index_add_ sums in their place, timed in turns with the fixed-order
    ones (two each), and compute_centroids alone at 1M x 128
    into 4096 clusters (the trained coarse labels), deterministic against
    atomic sums, CUDA events; first_s: first_segment_sum_s's."""
    from torchpq_tpu_torch.ops import segment_ops

    def train():
        idx = tp.IVFPQIndex(d_vector=index.d_vector,
                            n_subvectors=index.n_subvectors,
                            n_cells=index.n_cells, initial_size=16,
                            distance="euclidean", device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.train(torch.from_numpy(base[: base.shape[0] // 10]).cuda().T)
        torch.cuda.synchronize()
        return idx, time.perf_counter() - t0

    det = segment_ops._sum_rows

    def atomic_train():
        segment_ops._sum_rows = lambda out, labels, rows: \
            out.index_add_(0, labels, rows)
        try:
            return train()
        finally:
            segment_ops._sum_rows = det

    again, again_s = train()
    h1 = codec_hash(torch, trained)
    h2 = codec_hash(torch, {**again.vq_codec.state_dict("vq_codec."),
                            **again.pq_codec.state_dict("pq_codec.")})
    atomic, atomic_s = atomic_train()
    h3 = codec_hash(torch, {**atomic.vq_codec.state_dict("vq_codec."),
                            **atomic.pq_codec.state_dict("pq_codec.")})
    del again, atomic
    # two more trainings, in the other order: the cost in turns
    atomic_s = (atomic_s + atomic_train()[1]) / 2
    again_s = (again_s + train()[1]) / 2
    x = torch.from_numpy(base).cuda()
    labels = index.vq_codec.kmeans.predict(x.T).long()
    n_cells = index.n_cells

    det_ms = cuda_ms(torch, lambda: segment_ops.compute_centroids(
        x, labels, n_cells), 10)
    segment_ops._sum_rows = lambda out, labels, rows: \
        out.index_add_(0, labels, rows)
    try:
        atomic_ms = cuda_ms(torch, lambda: segment_ops.compute_centroids(
            x, labels, n_cells), 10)
    finally:
        segment_ops._sum_rows = det
    del x, labels
    log(f"training reproducible: codecs sha256 {h1[:16]} (a second "
        f"training {h2[:16]}; with atomic sums {h3[:16]}); train "
        f"{train_s:.3f} s; in turns (deterministic, atomic, atomic, "
        f"deterministic) {again_s:.3f} s deterministic, {atomic_s:.3f} s "
        f"atomic, mean of two each; the process's first compute_centroids "
        f"call {first_s[0]:.3f} s (the first deterministic index_add_ after "
        f"it {first_s[1]:.3f} s); compute_centroids at {base.shape[0]} x "
        f"{base.shape[1]} "
        f"into {n_cells} clusters: {det_ms:.3f} ms deterministic, "
        f"{atomic_ms:.3f} ms with atomic sums")
    if h1 != h2:
        fail("two trainings of the main layout on the same slice gave other "
             "codecs")


def phase_slice(torch, tp, bs, gr):
    n_base, n_query, d, m, n_cells, k = 1_000_000, 10_000, 128, 64, 4096, 10

    t0 = time.perf_counter()
    base, query = make_data(n_base, n_query, d)
    log(f"data {n_base} x {d} + {n_query} queries: "
        f"{time.perf_counter() - t0:.1f} s (host)")
    for launches in (bs.launches, gr.launches):
        for key in launches:
            launches[key] = 0
    per_cell = max(16, n_base // n_cells * 3)  # 732 at 1M: bench.py's 3x
    index = tp.IVFPQIndex(d_vector=d, n_subvectors=m, n_cells=n_cells,
                          initial_size=per_cell,
                          distance="euclidean", device="cuda")
    first_s = first_segment_sum_s(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.train(torch.from_numpy(base[: n_base // 10]).cuda().T)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = {**index.vq_codec.state_dict("vq_codec."),
               **index.pq_codec.state_dict("pq_codec.")}
    train_repro(torch, tp, index, trained, base, train_s, first_s)

    xq = torch.from_numpy(query).cuda()
    add_s = 0.0
    step = n_base // 4
    for i in range(0, n_base, step):
        if i == n_base - step:
            # the main path's counters: zeroed after the planner's sweeps
            for launches in (bs.launches, gr.launches):
                for key in launches:
                    launches[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.add(torch.from_numpy(base[i:i + step]).cuda().T)
        torch.cuda.synchronize()
        add_s += time.perf_counter() - t0
        if i < n_base - step:
            planner_sweep(torch, tp, index, xq, "bf16")
    log(f"train {train_s:.2f} s, add {add_s:.2f} s; capacity "
        f"{index.capacity}, max cell capacity {index.max_cell_capacity}, "
        f"items {index.n_items}")
    log(f"largest cell {int(index._cell_size_np.max())} items; "
        f"relayout ran: "
        f"{index.max_cell_capacity > tp.util.next_pow2(per_cell)}")

    gt = exact_gt(torch, base, xq, k)
    torch.cuda.synchronize()

    rec, _ = time_plans(torch, tp, index, xq, gt, k, bs.launches, "")
    counts = {**bs.launches, **gr.launches}
    log(f"main-path launches: {counts}")
    require_only_tc(counts, BF16_KEYS, "the bf16 plans")
    if counts["gather"] <= 0:
        fail("the row gather was never launched by the slice")
    # small-input reference: probing every cell with the exact select must
    # find what the exact flat sweep finds
    all_cells_check(torch, index, xq, k, "")
    planner_sweep(torch, tp, index, xq, "bf16", nq_probes=(8, 32))
    return counts, dict(index=index, trained=trained, base=base, xq=xq,
                        gt=gt, per_cell=per_cell, k=k, rec=rec)


def write_fvecs(path, rows):
    """rows [n, d] f32 -> a texmex .fvecs file ([int32 d][d floats] rows)."""
    n, d = rows.shape
    body = np.empty((n, 4 + 4 * d), np.uint8)
    body[:, :4] = np.frombuffer(np.int32(d).tobytes(), np.uint8)
    body[:, 4:] = rows.view(np.uint8).reshape(n, -1)
    body.tofile(path)


def bits_equal(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def spill_index(torch, tp, sl, impl, initial_size):
    """The main index's trained codecs in an index with the deep-k phase's
    spill (8 candidate cells, capacity its initial per-cell capacity) on
    the given route."""
    index = sl["index"]
    idx = tp.IVFPQIndex(d_vector=index.d_vector,
                        n_subvectors=index.n_subvectors,
                        n_cells=index.n_cells, initial_size=initial_size,
                        distance="euclidean", device="cuda")
    idx.load_state_dict(sl["trained"])
    idx.spill_cells = 8
    idx.spill_impl = impl
    return idx


def add_quarters(torch, idx, base):
    """Four adds of a quarter of `base` each; returns seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = base.shape[0] // 4
    for i in range(0, base.shape[0], step):
        idx.add(torch.from_numpy(base[i:i + step]).cuda().T)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def host_spill_recorder(tp, seen):
    """Wrap native.spill_assign so each add's candidates, the occupancy
    before it and its result land in `seen`; returns the restorer."""
    orig = tp.native.spill_assign

    def record(top, counts, cap):
        before = np.array(counts, np.int64)
        out, after = orig(top, counts, cap)
        seen.append((np.array(top, np.int32), before, cap, out.copy()))
        return out, after

    tp.native.spill_assign = record
    return lambda: setattr(tp.native, "spill_assign", orig)


def phase_native(torch, tp, sl, work, timer):
    """The native data plane at the slice's size: the 1M base written as
    .fvecs and read back whole and in 250k chunks (bit-equal, through the
    C++ route); the deep-k spill (8 cells at 2 x n / n_cells) through
    spill_impl="host" over the four adds, each add's cells equal to the
    numpy greedy's on the same top matrix and occupancy, beside the same
    adds through the device route."""
    base = sl["base"]
    path = os.path.join(work, "base.fvecs")
    with timer.phase("native write .fvecs (numpy)"):
        write_fvecs(path, base)
    mb = os.path.getsize(path) / 1e6
    with timer.phase("native read_fvecs"):
        got = tp.native.read_fvecs(path)
    if tp.native.LAST_ROUTE.get("read_fvecs") != "cpp":
        fail(f"read_fvecs did not run the C++ route: "
             f"{tp.native.LAST_ROUTE} ({tp.native.BUILD_ERROR})")
    if not bits_equal(got, base):
        fail("read_fvecs: the rows read differ from the rows written")
    del got
    quarter = base.shape[0] // 4  # 250k at the slice's size
    with timer.phase("native stream_vecs"):
        chunks = list(tp.native.stream_vecs(path, chunk_rows=quarter))
    if [len(c) for c in chunks] != [quarter] * 4 \
            or not bits_equal(np.concatenate(chunks), base):
        fail("stream_vecs: the chunks differ from the rows written")
    del chunks
    os.remove(path)
    read_s = timer.phases["native read_fvecs"]
    stream_s = timer.phases["native stream_vecs"]
    log(f"native: {mb:.1f} MB .fvecs; read_fvecs {read_s:.3f} s "
        f"({mb / read_s:.1f} MB/s), stream_vecs {quarter} rows a chunk "
        f"{stream_s:.3f} s "
        f"({mb / stream_s:.1f} MB/s); bit-equal; route "
        f"{tp.native.LAST_ROUTE['read_fvecs']}, {tp.native.library_path().name}")

    per_cell = base.shape[0] // sl["index"].n_cells * 2
    times = {}
    for impl in ("device", "host"):
        idx = spill_index(torch, tp, sl, impl, per_cell)
        idx.spill_capacity = cap = idx.max_cell_capacity
        seen = []
        restore = host_spill_recorder(tp, seen)
        try:
            with timer.phase(f"spill adds, {impl} route"):
                times[impl] = add_quarters(torch, idx, base)
        finally:
            restore()
        sizes = idx._cell_size_np
        log(f"spill {impl} route: four adds {times[impl]:.3f} s; "
            f"capacity {cap}, largest cell {int(sizes.max())}, "
            f"{int((sizes >= cap).sum())} cells at capacity, "
            f"{int(np.maximum(sizes - cap, 0).sum())} items above it")
        if impl == "device":
            if seen:
                fail("the device spill route called the host greedy")
            continue
        if len(seen) != 4 or tp.native.LAST_ROUTE["spill_assign"] != "cpp":
            fail(f"the host spill routed {len(seen)} of 4 adds, route "
                 f"{tp.native.LAST_ROUTE.get('spill_assign')}")
        with timer.phase("spill numpy greedy replay"):
            for top, before, c, out in seen:
                ref = tp.native._spill_assign_numpy(top, before.copy(), c)
                if not np.array_equal(out, ref):
                    fail(f"host spill: {int((out != ref).sum())} cells "
                         "differ from the numpy greedy's")
        if int(sizes.max()) > cap or int(sizes.sum()) != base.shape[0]:
            fail(f"host spill: largest cell {int(sizes.max())} above the "
                 f"capacity {cap}, or {int(sizes.sum())} items held")
    log(f"host spill: the cells of all 4 adds equal the numpy greedy's on "
        f"the same top matrices; add s host {times['host']:.3f} vs device "
        f"{times['device']:.3f}")
    return times


def phase_presize(torch, tp, sl, gt, timer):
    """Presize before ingest: on an empty index of the main layout (16 slots
    per cell), a counting pass routes the 1M rows through the host spill
    greedy in the adds' chunks against running counts; expand(required,
    exact=True); then the four adds with the same spill: every capacity a
    multiple of 16 (of 128 from 128 up), unchanged by the adds (no
    relayout), and the cell sizes the counting pass's."""
    from torchpq_tpu_torch.ops.max_sim import topk_sim
    base, xq = sl["base"], sl["xq"]
    idx = spill_index(torch, tp, sl, "host", 16)
    spill_cap = base.shape[0] // idx.n_cells * 2
    counts = np.zeros(idx.n_cells, np.int64)
    step = base.shape[0] // 4
    with timer.phase("presize counting pass"):
        for i in range(0, base.shape[0], step):
            x = idx._prep(torch.from_numpy(base[i:i + step]).cuda().T)
            _, top = topk_sim(x.T, idx._coarse_cb(), 8, "euclidean")
            tp.native.spill_assign(top.to(torch.int16).cpu().numpy(), counts,
                                   spill_cap)
    with timer.phase("presize expand(exact=True)"):
        idx.expand(required={int(c): int(n)
                             for c, n in enumerate(counts) if n},
                   exact=True)
        torch.cuda.synchronize()
    caps = idx._cell_capacity_np.copy()
    if not (((caps % 16 == 0) & ((caps < 128) | (caps % 128 == 0))).all()
            and (caps >= counts).all()):
        fail("presize: capacities not multiples of 16 / 128 or below the "
             "counts")
    idx.spill_capacity = spill_cap
    with timer.phase("presize adds"):
        add_s = add_quarters(torch, idx, base)
    if not np.array_equal(idx._cell_capacity_np, caps):
        fail("presize: the adds relayouted the presized store")
    if not np.array_equal(idx._cell_size_np, counts):
        fail("presize: the adds' cells differ from the counting pass's")
    pow2 = sum(tp.util.next_pow2(max(int(c), 16)) for c in counts)
    idx.scan_mode, idx.n_probe, idx.use_approx_topk = "cell_major", 32, True
    _, ids = idx.search(xq.T, k=10)
    torch.cuda.synchronize()
    log(f"presize: {int(caps.sum())} slots exact (power-of-two capacities "
        f"would take {pow2}); max cell capacity {int(caps.max())}; 4 x 250k "
        f"adds {add_s:.3f} s with no relayout; pack32 n_probe 32 "
        f"recall@10 {recall_at(ids.long(), gt):.4f}")


SHARDED_PLANS = [("cell_major", 8, True), ("cell_major", 32, True),
                 ("cell_major", 8, False), ("flat", 1, True)]
TIER_PLAN = ("cell_major", 32, True)
# the kernels' JSON rows the sharded plans launch: (tier, launch key)
SHARDED_KEYS = {"block_scan_exact": ("bf16", "tc_wgn_exact"),
                "block_scan_pack32": ("bf16", "tc_wgn_pack32"),
                "block_scan_int8_pack32": ("int8", "tc_wgn_int8_pack32"),
                "codes_scan_pack32": ("codes", "tc_wgn_pack32")}


# the scans of the sharded plans held to their plain versions on a rank's
# own arguments: (row name, tier, plan)
SHARDED_ROWS = (("block_scan_exact_sharded", "bf16", ("cell_major", 8, False)),
                ("block_scan_pack32_sharded", "bf16", TIER_PLAN),
                ("block_scan_int8_pack32_sharded", "int8", TIER_PLAN),
                ("codes_scan_pack32_sharded", "codes", TIER_PLAN))
SHARDED_SOURCES = {"bf16": "block_scan_wg.cu", "int8": "block_scan_wg.cu",
                   "codes": "block_scan_wg.cu"}


def sharded_kernel_rows(torch, tp, bs, cs, searchers, tiers, xq, check,
                        label):
    """The scans of the sharded plans (SHARDED_ROWS) on the arguments a
    rank's local scan gives them: its shard's uncompacted layout, with
    shard-local cell tables and windows. Collective: every rank of the mesh
    runs the captured searches (each ends in an all_gather); the ranks with
    `check` hold each scan, as its wrapper routes it, to its plain version
    (check_kernel / check_codes: the tensor-core kernel on live rows, pad
    rows dead, the CUDA-core one on every row; the int8 scans bit for bit)
    and time it, uncounted, beside the plain version and the bound from
    these arguments. Returns {name: JSON row without its launch count}."""
    rows = {}
    for name, tier, plan in SHARDED_ROWS:
        s, codes = searchers[tier], tier == "codes"
        set_plan(tiers[tier], plan)
        s.scan_mode = "cell_major"
        args, kw = capture_call(
            tp, s, xq, 10, module=tp.ops.onehot_adc if codes else None,
            name="codes_scan" if codes else "block_scan")
        if not check:
            continue
        s_eff, k_pair, pack32 = kw["s_eff"], kw["k_pair"], kw["pack32"]
        kkw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=kw["euclidean"],
                   pack32=pack32, slot_mask=kw["slot_mask"])
        blocks, p_tile = args[1].shape
        live = int((args[1] >= 0).sum())
        if codes:
            m, _, dsub = args[7].shape
            d = args[0].shape[1]
            route = cs.pick_route(m=m, dsub=dsub, p_tile=p_tile, s_eff=s_eff,
                                  k_pair=k_pair, pack32=pack32)
            err = check_codes(torch, bs, cs, args, s_eff=s_eff,
                              k_pair=k_pair, pack32=pack32,
                              euclidean=kw["euclidean"], reps=0)[0]
            ms = cuda_ms(torch, lambda: codes_launch(torch, cs, args, route,
                                                     **kkw), 20)
            plain_ms = cuda_ms(torch, lambda: cs.codes_scan_ref(*args, **kkw),
                               3)
            b_ms, b_by = scan_bound(torch, args, kkw, slot_bytes=m + 4,
                                    row_bytes=2 * d, peak="bf16", d=d,
                                    extra_bytes=args[7].numel() * 2)
            shape = f"m={m}, g={args[6].shape[1] // m}"
            turns = codes_parent_turns(torch, bs, cs, args, kkw, route,
                                       f"{label}{name}")
        else:
            d = args[6].shape[1]
            int8 = tier == "int8"
            if int8:
                kkw.update(scale=kw["scale"], q_scale=kw["q_scale"])
            route = bs.pick_route(dtype=args[6].dtype, d=d, p_tile=p_tile,
                                  s_eff=s_eff, k_pair=k_pair, pack32=pack32)
            err = check_kernel(
                torch, bs, args, s_eff=s_eff, k_pair=k_pair, pack32=pack32,
                euclidean=kw["euclidean"], reps=0, equal=int8,
                extra=dict(scale=kw["scale"], q_scale=kw["q_scale"])
                if int8 else None)[0]
            ms = cuda_ms(torch, lambda: block_launch(torch, bs, args, route,
                                                     **kkw), 20)
            turns = block_turns(torch, bs, args, kkw, route,
                                   f"{label}{name}")
            plain_ms = cuda_ms(torch, lambda: bs.block_scan_ref(*args, **kkw),
                               3)
            b_ms, b_by = scan_bound(
                torch, args, kkw, slot_bytes=d + 8 if int8 else 2 * d + 4,
                row_bytes=d + 4 if int8 else 2 * d,
                peak="int8" if int8 else "bf16", d=d)
            shape = f"d_cache={d}, {args[6].dtype}"
        if not route.startswith("tc_"):
            fail(f"{label}{name}: the wrapper routes these shapes to {route}, "
                 "not the tensor cores")
        log(f"{label}{name} on the arguments of the {tier} {plan} plan: "
            f"{blocks} blocks x {p_tile} probers, {live} live, s_eff={s_eff},"
            f" k_pair={k_pair}, cache rows {args[5].shape[0]}, {shape}; "
            f"{route} live rows max_abs_err {err:.3g} (pad rows dead; the "
            f"CUDA-core kernel matches on every row); {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
        rows[name] = dict(
            name=name, route="cuda",
            source="torchpq_tpu_torch/csrc/" + SHARDED_SOURCES[tier],
            replaces="torchpq_tpu/ops/" + (
                "pallas_codes_scan.py:198" if codes else "pallas_scan.py:281"),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, launch_key=route, s_eff=s_eff,
            cache_rows=int(args[5].shape[0]), **turns)
    return rows


def run_plan(torch, search, reps=3):
    """A warm-up call, then the median ms of `reps` calls to a sync."""
    out = search()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = search()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times)) * 1e3


def set_plan(index, plan):
    index.scan_mode, index.n_probe, index.use_approx_topk = plan


def sharded_suite(torch, tp, bs, cs, tiers, xq, extra, rm_ids, mesh, check,
                  label):
    """The sharded surface over `mesh` (collective: every rank of the mesh
    runs it alike): a searcher per tier (bf16, int8, codes); the bf16
    plans, then one pack32 plan per other tier, each tier's launch counters
    zeroed before and read after; sharded_kernel_rows (check: this rank
    compares and times); the all_gather's ms; an add of `extra` and a
    remove of `rm_ids`, then the exact n_probe 8 plan. Returns (results
    {name: (values, ids)}, ms {name: ms}, counts {tier: launches}, kernel
    rows, the add's ids, the count removed, the bf16 searcher)."""
    S = tp.parallel.ShardedIVFPQSearcher
    res, ms, counts, searchers = {}, {}, {}, {}
    for tier, idx in tiers.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        searchers[tier] = S(idx, mesh=mesh)
        torch.cuda.synchronize()
        ms[f"relayout {tier}"] = (time.perf_counter() - t0) * 1e3
    for tier, plans, launches in (("bf16", SHARDED_PLANS, bs.launches),
                                  ("int8", [TIER_PLAN], bs.launches),
                                  ("codes", [TIER_PLAN], cs.launches)):
        s = searchers[tier]
        for key in launches:
            launches[key] = 0
        for plan in plans:
            set_plan(tiers[tier], plan)
            s.scan_mode = "flat" if plan[0] == "flat" else "cell_major"
            name = f"{tier} {plan[0]} n_probe={plan[1]} approx={plan[2]}"
            res[name], ms[name] = run_plan(
                torch, lambda: s.search(xq.T, k=10))
        counts[tier] = dict(launches)
    rows = sharded_kernel_rows(torch, tp, bs, cs, searchers, tiers, xq, check,
                               label)
    s = searchers["bf16"]
    v, i = res[f"bf16 {SHARDED_PLANS[0][0]} n_probe=8 approx=True"]
    ms["all_gather"] = cuda_ms(torch, lambda: tp.parallel.sharded_ivfpq
                               ._merge(v, i, 10, s.group, s.n_shards), 20)
    torch.cuda.synchronize()
    new_ids = s.add(torch.from_numpy(extra).cuda().T)
    removed = s.remove(rm_ids)
    set_plan(tiers["bf16"], ("cell_major", 8, False))
    s.scan_mode = "cell_major"
    res["post"] = s.search(xq.T, k=10)
    torch.cuda.synchronize()
    return res, ms, counts, rows, new_ids, removed, s


TIER_FILES = {"bf16": None, "int8": "int8", "codes": "none"}


def sharded_child(args):
    """One rank of the D-rank gloo run on the card (chip_smoke.py
    --sharded-rank R --world D --work DIR): loads the three indexes the
    parent saved, runs sharded_suite over get_mesh(D), and writes its
    results to DIR/d{D}.r{R}.npz and its launches and ms to .json."""
    import torch
    import torch.distributed as dist
    import torchpq_tpu_torch as tp
    from torchpq_tpu_torch.ops import block_scan as bs
    from torchpq_tpu_torch.ops import codes_scan as cs
    torch.cuda.set_device(0)
    rank, world, work = args.sharded_rank, args.world, args.work
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, f"store.d{world}"),
                                     world), rank=rank, world_size=world)
    with open(os.path.join(work, "tiers.json")) as f:
        spec = json.load(f)
    tiers = {}
    for tier, cache in TIER_FILES.items():
        idx = tp.IVFPQIndex(**spec, scan_cache_dtype=cache, device="cuda")
        idx.load(os.path.join(work, f"{tier}.npz"))
        tiers[tier] = idx
    with np.load(os.path.join(work, "inputs.npz")) as f:
        xq = torch.from_numpy(f["xq"]).cuda()
        extra, rm_ids = f["extra"], f["rm_ids"]
    # rank 0 holds the scans to their plain versions (the ranks share one
    # card: one rank's times are not disturbed by the other's checks)
    res, ms, counts, rows, new_ids, removed, _ = sharded_suite(
        torch, tp, bs, cs, tiers, xq, extra, rm_ids,
        tp.parallel.get_mesh(world), rank == 0,
        f"sharded D={world} (gloo) rank {rank} ")
    out = {"new_ids": new_ids.cpu().numpy(), "removed": np.int64(removed)}
    for i, (name, (v, ids)) in enumerate(res.items()):
        out[f"v{i}"], out[f"i{i}"] = v.cpu().numpy(), ids.cpu().numpy()
    np.savez(os.path.join(work, f"d{world}.r{rank}.npz"), **out)
    with open(os.path.join(work, f"d{world}.r{rank}.json"), "w") as f:
        json.dump({"names": list(res), "ms": ms, "counts": counts,
                   "rows": rows}, f)
    dist.destroy_process_group()


def compare_sharded(torch, label, res, ref, gt, new_ids, ref_ids, removed,
                    ref_removed):
    """A sharded run's results against the single-device index's on the
    same plans: exact plans (exact select, flat sweep, the post add /
    remove plan) ids equal outside ties and values within compare_topk's
    tolerance; pack32 ids agreeing >= 0.99; recall@10 within 0.005; the
    add's ids and the remove's count equal."""
    for name, (v, i) in res.items():
        vr, ir = ref[name]
        v, i = v.cuda(), i.cuda().long()
        ir = ir.long()
        if "approx=True" in name and "flat" not in name:
            agree = recall_at(i, ir)
            extra = f"id agreement {agree:.5f}"
            if agree < 0.99:
                fail(f"{label}{name}: pack32 id agreement {agree:.5f}")
        else:
            err = compare_topk(torch, v, i, vr, ir)
            extra = f"ids equal outside ties, max value diff {err:.3g}"
        r, rr = recall_at(i, gt), recall_at(ir, gt)
        log(f"{label}{name}: recall@10 {r:.4f} vs single {rr:.4f}; {extra}")
        if abs(r - rr) > 0.005:
            fail(f"{label}{name}: recall {r:.4f} vs the single device's "
                 f"{rr:.4f}")
    if not torch.equal(torch.as_tensor(new_ids).cpu().long(),
                       ref_ids.cpu().long()) or removed != ref_removed:
        fail(f"{label}the sharded add / remove differ from the single "
             f"device's (removed {removed} vs {ref_removed})")


def phase_sharded(torch, tp, bs, cs, sl, tiers, work, timer):
    """The sharded surface at D = 1 (NCCL, this process) and D = 2 (gloo,
    two processes on this card, loading the indexes this process saved),
    each held to the single-device index on the same plans; the launches
    of the tensor-core scan keys required on both; profiling.trace around
    one sharded search, whose named scope must be in the trace; the
    data-parallel k-means at D = 1 against a plain Lloyd loop. Returns
    ({tier: {"d1": counts, "d2": counts}}, the sharded scans' JSON rows:
    sharded_kernel_rows' of D = 1 and of D = 2's rank 0, with that rank's
    launches)."""
    import torch.distributed as dist
    xq, gt, base = sl["xq"], sl["gt"], sl["base"]
    # new rows from the base's own distribution: seeded base rows with the
    # manifold's noise (0.02) drawn again
    rng = np.random.default_rng(7)
    n_add = base.shape[0] // 10  # 100k at the slice's size
    extra = base[rng.choice(base.shape[0], n_add, replace=False)] \
        + np.float32(0.02) * rng.standard_normal(
            (n_add, base.shape[1]), dtype=np.float32)
    # a tenth of the added rows' ids (the adds number them from n on)
    rm_ids = rng.choice(np.arange(base.shape[0], base.shape[0] + n_add),
                        n_add // 10, replace=False)

    # the single-device reference plans, on the uncompacted layout the
    # shards scan (the default compacted plan's ms beside)
    ref, ref_ms = {}, {}
    with timer.phase("sharded: single-device reference plans"):
        for tier, plans in (("bf16", SHARDED_PLANS), ("int8", [TIER_PLAN]),
                            ("codes", [TIER_PLAN])):
            idx = tiers[tier]
            for plan in plans:
                set_plan(idx, plan)
                name = f"{tier} {plan[0]} n_probe={plan[1]} approx={plan[2]}"
                idx.scan_compact = False
                ref[name], ref_ms[name] = run_plan(
                    torch, lambda: idx.search(xq.T, k=10))
                idx.scan_compact = "auto"
                _, ref_ms[name + " (compacted)"] = run_plan(
                    torch, lambda: idx.search(xq.T, k=10))
    spec = dict(d_vector=sl["index"].d_vector,
                n_subvectors=sl["index"].n_subvectors,
                n_cells=sl["index"].n_cells, initial_size=sl["per_cell"],
                distance="euclidean")
    with timer.phase("sharded: save the indexes (.npz)"):
        for tier, idx in tiers.items():
            idx.save(os.path.join(work, f"{tier}.npz"))
        np.savez(os.path.join(work, "inputs.npz"), xq=xq.cpu().numpy(),
                 extra=extra, rm_ids=rm_ids)
        with open(os.path.join(work, "tiers.json"), "w") as f:
            json.dump(spec, f)

    # D = 1 over NCCL in this process
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(work, "store.d1"), 1),
        rank=0, world_size=1)
    try:
        mesh = tp.parallel.get_mesh(1)
        with timer.phase("sharded D=1 (NCCL)"):
            res1, ms1, counts1, rows1, ids1, rm1, s1 = sharded_suite(
                torch, tp, bs, cs, tiers, xq, extra, rm_ids, mesh, True,
                "sharded D=1 (NCCL) ")
        with timer.phase("profiling.trace of one sharded search"):
            set_plan(tiers["bf16"], ("cell_major", 32, True))
            with tp.profiling.trace(work) as prof:
                with tp.profiling.named_scope("torchpq_sharded_search"):
                    s1.search(xq.T, k=10)
            with open(prof.trace_path) as f:
                events = json.load(f)["traceEvents"]
            os.remove(prof.trace_path)
        # where a sharded plan's time goes, beside the single device's on
        # the same (uncompacted) layout
        profile_search(torch, lambda: s1.search(xq.T, k=10),
                       "sharded D=1 bf16 cell_major n_probe=32 approx=True",
                       host_ops=True)
        tiers["bf16"].scan_compact = False
        profile_search(torch, lambda: tiers["bf16"].search(xq.T, k=10),
                       "single device, uncompacted, bf16 cell_major "
                       "n_probe=32 approx=True", host_ops=True)
        tiers["bf16"].scan_compact = "auto"
        scopes = [e for e in events if e.get("name") == "torchpq_sharded_search"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        log(f"profiling.trace: {len(events)} events, scope "
            f"'torchpq_sharded_search' x{len(scopes)}, {len(kernels)} device "
            f"kernel events")
        if not scopes or not kernels:
            fail("profiling.trace: the named scope or the device kernels are "
                 "missing from the trace")
        phase_dp_kmeans(torch, tp, base, mesh, timer, k=sl["index"].n_cells)
    finally:
        dist.destroy_process_group()

    # D = 2: two gloo ranks on this card
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    with timer.phase("sharded D=2 (gloo, 2 processes)"):
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank",
             str(r), "--world", "2", "--work", work], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=400)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"sharded D=2 rank {r} exited {p.returncode}:\n"
                 f"{text[-3000:]}")
    runs = []
    for r in range(2):
        with open(os.path.join(work, f"d2.r{r}.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(work, f"d2.r{r}.npz")) as f:
            out = {k: f[k] for k in f.files}
        runs.append((meta, out))
    for key in runs[0][1]:
        if not np.array_equal(runs[0][1][key], runs[1][1][key]):
            fail(f"sharded D=2: the two ranks returned different {key}")
    meta2, out2 = runs[0]
    res2 = {name: (torch.from_numpy(out2[f"v{i}"]),
                   torch.from_numpy(out2[f"i{i}"]))
            for i, name in enumerate(meta2["names"])}

    # the same add and remove on the single-device index
    index = tiers["bf16"]
    ref_ids = index.add(torch.from_numpy(extra).cuda().T)
    ref_rm = index.remove(ids=torch.as_tensor(rm_ids).cuda())
    set_plan(index, ("cell_major", 8, False))
    index.scan_compact = False
    ref["post"] = index.search(xq.T, k=10)
    index.scan_compact = "auto"
    counts = {}
    for label, res, ms, cnt, ids, rm in (
            ("sharded D=1 (NCCL) ", res1, ms1, counts1, ids1, rm1),
            ("sharded D=2 (gloo) ", res2, meta2["ms"],
             [m["counts"] for m, _ in runs], out2["new_ids"],
             int(out2["removed"]))):
        compare_sharded(torch, label, res, ref, gt, ids, ref_ids, rm, ref_rm)
        for c in (cnt if isinstance(cnt, list) else [cnt]):
            require_only_tc(c["bf16"], BF16_KEYS, f"{label}bf16 plans")
            require_only_tc(c["int8"], INT8_KEYS[1:], f"{label}int8 plan")
            if c["codes"]["tc_wgn_pack32"] <= 0 or any(
                    n for key, n in c["codes"].items()
                    if key != "tc_wgn_pack32"):
                fail(f"{label}code-domain plan must launch the wgmma codes "
                     f"instances' pack32 select only: {c['codes']}")
        log(f"{label}launches: {cnt}")
        for name in res:
            if name in ms:
                log(f"{label}{name}: {ms[name]:.3f} ms vs single device "
                    f"{ref_ms[name]:.3f} ms (compacted layout "
                    f"{ref_ms[name + ' (compacted)']:.3f} ms)")
        log(f"{label}all_gather + merge of [10000, 10]: "
            f"{ms['all_gather']:.4f} ms; re-layouts "
            + ", ".join(f"{t} {ms['relayout ' + t]:.1f} ms" for t in tiers))
        d = "d1" if "D=1" in label else "d2"
        first = cnt if isinstance(cnt, dict) else cnt[0]
        for tier in tiers:
            counts.setdefault(tier, {})[d] = first[tier]
    # the sharded scans' rows, with rank 0's launches on its plans
    rows = []
    for d, krows, cnt in (("d1", rows1, counts1),
                          ("d2", runs[0][0]["rows"], runs[0][0]["counts"])):
        for name, tier, _ in SHARDED_ROWS:
            row = krows[name]
            rows.append(dict(row, name=f"{name}_{d}",
                             launches=cnt[tier][row["launch_key"]]))
    return counts, rows


def plain_lloyd(torch, x, k, iters, seed):
    """A plain single-device Lloyd loop from the rows the dp fit starts
    from (np.random.default_rng(seed).choice(n, k, replace=False))."""
    from torchpq_tpu_torch.ops.max_sim import max_sim
    from torchpq_tpu_torch.ops.segment_ops import compute_centroids
    pick = np.random.default_rng(seed).choice(x.shape[0], k, replace=False)
    ref = x[torch.as_tensor(pick).cuda()].clone()
    for _ in range(iters):
        _, labels = max_sim(x, ref, "euclidean")
        sums, cnt = compute_centroids(x, labels, k)
        ref = torch.where((cnt > 0)[:, None],
                          sums / torch.clamp(cnt, min=1.0)[:, None], ref)
    return ref


def phase_dp_kmeans(torch, tp, base, mesh, timer, k, iters=10):
    """data_parallel_kmeans_fit on the 100k train slice to k (4096)
    clusters, 10 iterations, over `mesh`, timed beside a plain single-device
    Lloyd loop from the same initial rows; then both again under
    torch.use_deterministic_algorithms, where they must agree within a
    relative Frobenius difference of 1e-3. (The sums run in a fixed order
    on the card, ops/segment_ops.py; the two fits' difference without the
    switch is logged beside it.)"""
    import warnings
    x = torch.from_numpy(base[: base.shape[0] // 10]).cuda()
    fit = tp.parallel.data_parallel_kmeans_fit
    torch.cuda.synchronize()
    with timer.phase("dp k-means fit"):
        cents, it = fit(x, k, mesh=mesh, max_iter=iters, tol=0.0, seed=0)
        torch.cuda.synchronize()
    with timer.phase("plain Lloyd loop"):
        ref = plain_lloyd(torch, x, k, iters, 0)
        torch.cuda.synchronize()

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    spread = rel(cents, ref)
    was = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det, it_det = fit(x, k, mesh=mesh, max_iter=iters, tol=0.0,
                              seed=0)
            det_ref = plain_lloyd(torch, x, k, iters, 0)
        finally:
            torch.use_deterministic_algorithms(was)
    diff = rel(det, det_ref)
    fit_s = timer.phases["dp k-means fit"]
    plain_s = timer.phases["plain Lloyd loop"]
    log(f"dp k-means D={mesh.size()}: {it} iterations, {fit_s / it:.4f} s "
        f"per iteration (plain loop {plain_s / iters:.4f}); relative "
        f"difference {diff:.3g} with deterministic algorithms, {spread:.3g} "
        f"without")
    if it != iters or it_det != iters or diff > 1e-3:
        fail(f"dp k-means: {it} iterations, relative difference {diff:.3g}")
    return dict(s_per_iter=fit_s / it, plain_s_per_iter=plain_s / iters,
                rel=diff, spread=spread)


def phase_legacy(torch, tp, sl, timer):
    """The v1 IVFPQ facade at 100k x 128 (IVF256 x PQ64, blocksize 512,
    the CPU-RAM SQ tier on): trained on the card, its state carried into a
    CPU facade, the same 100k adds in both; 1,000 queries at n_probe 8,
    cell_major pinned on both (the card's planner reads the card's costs),
    exact select: ids agree >= 0.999; the SQ reconstructions close."""
    base, xq = sl["base"], sl["xq"]
    x = base[:100_000]
    kw = dict(d_vector=x.shape[1], n_subvectors=sl["index"].n_subvectors,
              n_cq_clusters=256, blocksize=512)
    with timer.phase("legacy facade, card"):
        card = tp.legacy.IVFPQ(**kw, device="cuda",
                               cpu_quantizer=tp.legacy.SQ(bits=8,
                                                          device="cuda"))
        card.train(torch.from_numpy(x[:50_000]).cuda().T)
        trained = card._index.state_dict()  # copies, before the adds
        ids = card.add(torch.from_numpy(x).cuda().T)
        card.n_probe = 8
        card._index.scan_mode = "cell_major"
        v, i = card.topk(xq[:1000].T, k=10)
        rec = card.reconstruct_from_cpu_ram(ids[:1000])
        torch.cuda.synchronize()
    with timer.phase("legacy facade, CPU"):
        cpu = tp.legacy.IVFPQ(**kw, device="cpu")
        cpu._index.load_state_dict(trained)
        ids_c = cpu.add(x.T)
        cpu.n_probe = 8
        cpu._index.scan_mode = "cell_major"
        v_c, i_c = cpu.topk(xq[:1000].cpu().T, k=10)
    agree = share_equal(i.cpu(), i_c)
    err = float((rec.cpu().T - torch.from_numpy(x[:1000])).abs().mean())
    log(f"legacy IVFPQ 100k: card vs CPU id agreement {agree:.5f}, max value "
        f"diff {float((v.cpu() - v_c).abs().max()):.3g}; SQ CPU-RAM tier "
        f"mean abs reconstruction error {err:.4f}")
    if not torch.equal(ids.cpu(), ids_c) or agree < 0.999 or err > 0.05:
        fail("legacy IVFPQ: the card facade disagrees with the CPU one")


# the planner phase (25): the points the sweeps below time, each with the
# plan "auto" picks on the card and the JAX package's rule's pick (plan_for
# on the CPU, its TPU v5e crossovers); filled by the phases that build the
# indexes, read by phase_planner
PLANNER = []
PLANNER_NQ = (1, 16, 64, 256, 1024)
# the indexes whose points fail the run where auto's plan is more than 2x
# slower than the fastest one timed (flat and probed far apart there)
PLANNER_CHECKED = ("bf16", "code", "int8", "GIST bf16 record", "pqr3",
                   "deep-k r6")


def plan_ms(torch, index, q, k, plan, n_probe, approx, cap_ms=None):
    """time_plans' clock for one plan on queries q [nq, d]: the warm-up
    search, then the median of 3 host-clock searches to
    torch.cuda.synchronize() -> (ms, timed searches). A warm-up above
    cap_ms is kept as the time (0 timed searches): the plan is that much
    slower."""
    index.scan_mode, index.n_probe, index.use_approx_topk = \
        plan, n_probe, approx
    t0 = time.perf_counter()
    index.search(q.T, k=k)
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t0) * 1e3
    if cap_ms is not None and warm > cap_ms:
        return warm, 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        index.search(q.T, k=k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, 3


def planner_point(tp, index, label, nq, k, n_probe, approx, ms, reps):
    """Record one point: the plans' ms, the plan auto picks on the card,
    the JAX package's rule's pick on the same shadows, the card table's
    estimates and the fastest plan timed."""
    index.scan_mode, index.n_probe, index.use_approx_topk = \
        "auto", n_probe, approx
    auto = index.plan_scan_mode(nq, k)
    shadows = index._plan_shadows()
    before = tp.index.ivfpq.plan_for(nq, k, **dict(shadows, device="cpu"))
    est = tp.index.ivfpq.card_plan_ms(nq, k, **{
        x: shadows[x] for x in ("n_probe", "s_pow2", "n_items", "d_vector",
                                "tier", "approx", "precision")})
    PLANNER.append(dict(
        index=label, n_live=int(index.n_items), nq=nq, k=k,
        n_probe=n_probe, approx=approx, s_pow2=shadows["s_pow2"],
        precision=shadows["precision"],
        d=index.d_vector, tier=shadows["tier"], ms=ms, reps=reps,
        est={p: round(v, 3) for p, v in est.items()}, auto=auto,
        before=before, fastest=min(ms, key=ms.get)))


def planner_sweep(torch, tp, index, xq, label, nq_probes=()):
    """The planner's points on one index state: per k, the flat plan at
    the full batch (its top-k is exact either way), then cell_major at
    n_probe 1, 2, 4, ... up to n_cells / 4 per approx setting, a series
    ending after the first point slower than flat whose select the next
    n_probe keeps (approx k = 100 at n_probe 1 lifts k_pair to 100: the
    plain select); a warm-up above flat is that point's time; then at
    each n_probe of nq_probes the batch axis: flat, cell_major and (bf16 /
    f32 caches: the int8 and code tiers run every probed plan cell-major)
    query_major at PLANNER_NQ queries, k 10, approx on."""
    from torchpq_tpu_torch.index.ivfpq import _select_class as select_class
    t0 = time.perf_counter()
    nq = xq.shape[0]
    for k in (10, 100):
        flat = plan_ms(torch, index, xq, k, "flat", 1, True)[0]
        for approx in (True, False):
            n_probe = 1
            while n_probe <= index.n_cells // 4:
                ms, reps = plan_ms(torch, index, xq, k, "cell_major",
                                   n_probe, approx, cap_ms=flat)
                planner_point(tp, index, label, nq, k, n_probe, approx,
                              {"flat": flat, "cell_major": ms}, reps)
                if ms > flat and select_class(
                        k, n_probe, approx) == select_class(
                        k, 2 * n_probe, approx):
                    break
                n_probe *= 2
    plans = ("flat", "cell_major")
    if index._plan_tier() in ("bf16", "float32"):
        plans += ("query_major",)
    for n_probe in nq_probes:
        for n in PLANNER_NQ:
            ms = {p: plan_ms(torch, index, xq[:n], 10, p, n_probe, True)[0]
                  for p in plans}
            planner_point(tp, index, label, n, 10, n_probe, True, ms, 3)
    log(f"planner sweep, {label} at {index.n_items} items: "
        f"{time.perf_counter() - t0:.1f} s")


def planner_small(torch, tp, sl):
    """The small-index regime: the main codecs in an index of the main
    layout filled with the base's first 20k rows, then its first 100k,
    swept at both sizes (the batch axis at n_probe 8)."""
    index, base = sl["index"], sl["base"]
    small = tp.IVFPQIndex(d_vector=index.d_vector,
                          n_subvectors=index.n_subvectors,
                          n_cells=index.n_cells, initial_size=32,
                          distance="euclidean", device="cuda")
    small.load_state_dict(sl["trained"])
    for lo, hi in ((0, 20_000), (20_000, 100_000)):
        small.add(torch.from_numpy(base[lo:hi]).cuda().T)
        planner_sweep(torch, tp, small, sl["xq"], "small", nq_probes=(8,))
    del small


PLANNER_CASES = (
    # (case, index label, k, n_probe): the searches auto sent to the flat
    # sweep under the JAX package's rule
    ("1M x 128 bf16, approx, k = 10, n_probe 8", "bf16", 10, 8),
    ("1M x 128 bf16, approx, k = 10, n_probe 32", "bf16", 10, 32),
    ("1M x 128 pqr3, approx, k = 100, n_probe 8", "pqr3", 100, 8),
    ("1M x 128 pqr3, approx, k = 100, n_probe 32", "pqr3", 100, 32),
    ("deep-k r6, k = 100, n_probe 128", "deep-k r6", 100, 128),
    ("GIST bf16 record, approx, k = 10, n_probe 32", "GIST bf16 record",
     10, 32),
    ("GIST bf16 record, approx, k = 100, n_probe 32", "GIST bf16 record",
     100, 32))


def ran(plan, tier):
    """The plan a search under `plan` runs: the int8 and code tiers run
    every probed plan cell-major."""
    return "cell_major" if plan == "query_major" and tier in ("int8",
                                                              "codes") \
        else plan


def fit_planner(points):
    """The card table's constants (index/ivfpq.py:CARD_PLAN_COSTS' terms)
    fitted to the points by non-negative least squares on relative
    errors, in steps: the bf16 points fix each plan's per-call term and
    widths (two widths: d 128 and 960); each other tier (and select) its
    own terms with those fixed; the flat terms per precision class of the
    points' search precision (flat_class). The points a warm-up timed (a
    series' last) count as timed."""
    from scipy.optimize import nnls
    from torchpq_tpu_torch.index.ivfpq import _select_class, flat_class

    def solve(rows, ys):
        a = np.array(rows, float) / np.array(ys, float)[:, None]
        return [float(x) for x in nnls(a, np.ones(len(ys)))[0]]

    def sel(p):
        return _select_class(p["k"], p["n_probe"], p["approx"])

    def r(p):
        return p["d"] / 128.0 - 1.0

    def slots(p):
        return p["nq"] * p["n_probe"] * max(p["s_pow2"], 128) * 1e-9

    def pairs(p):
        return p["nq"] * p["n_probe"] * 1e-6

    flat, seen = [], set()
    for p in points:
        key = (p["index"], p["n_live"], p["nq"], p["k"])
        if "flat" in p["ms"] and key not in seen:
            seen.add(key)
            flat.append(p)

    def n(p):
        return p["n_live"] * 1e-9

    def fit_flat(flat):
        b16 = [p for p in flat if p["tier"] == "bf16"]
        c0, pa, pb, sa, sb = solve(
            [[1.0, n(p), n(p) * r(p), p["nq"] * n(p), p["nq"] * n(p) * r(p)]
             for p in b16], [p["ms"]["flat"] for p in b16])
        pw, sw = pb / pa if pa else 0.0, sb / sa if sa else 0.0
        fl = dict(call_ms=c0, pass_width=pw, slot_width=sw,
                  pass_ps={"bf16": pa}, slot_ps={"bf16": sa})
        for tier in ("int8", "codes"):
            tp_ = [p for p in flat if p["tier"] == tier]
            fl["pass_ps"][tier], fl["slot_ps"][tier] = solve(
                [[n(p) * (1 + pw * r(p)), p["nq"] * n(p) * (1 + sw * r(p))]
                 for p in tp_], [p["ms"]["flat"] - c0 for p in tp_]) \
                if tp_ else (pa, sa)
        return fl

    classes = {flat_class(p["precision"]) for p in flat}
    fl = {c: fit_flat([p for p in flat if flat_class(p["precision"]) == c])
          for c in sorted(classes)}

    cm = [p for p in points if "cell_major" in p["ms"]]
    terms = {t: {} for t in ("query_us", "pair_ns", "slot_ps")}
    width = {}

    def put(tier, s, vals):
        for name, v in zip(("query_us", "pair_ns", "slot_ps"), vals):
            terms[name].setdefault(tier, {})[s] = v

    fast = [p for p in cm if p["tier"] == "bf16" and sel(p) == "fast"]
    c0, q, pp, a, b = solve(
        [[1.0, p["nq"] * 1e-3, pairs(p), slots(p), slots(p) * r(p)]
         for p in fast], [p["ms"]["cell_major"] for p in fast])
    width["fast"] = b / a if a else 0.0
    put("bf16", "fast", (q, pp, a))
    slow = [p for p in cm if p["tier"] == "bf16" and sel(p) == "slow"]
    q, pp, a, b = solve(
        [[p["nq"] * 1e-3, pairs(p), slots(p), slots(p) * r(p)]
         for p in slow], [p["ms"]["cell_major"] - c0 for p in slow])
    width["slow"] = b / a if a else 0.0
    put("bf16", "slow", (q, pp, a))
    for tier in ("int8", "codes"):
        for s in ("fast", "slow"):
            tp_ = [p for p in cm if p["tier"] == tier and sel(p) == s]
            put(tier, s, solve(
                [[p["nq"] * 1e-3, pairs(p),
                  slots(p) * (1 + width[s] * r(p))] for p in tp_],
                [p["ms"]["cell_major"] - c0 for p in tp_]) if tp_ else
                [terms[x]["bf16"][s] for x in ("query_us", "pair_ns",
                                               "slot_ps")])
    out = dict(flat=fl, cell_major=dict(call_ms=c0, width=width, **terms))
    qm = [p for p in points if "query_major" in p["ms"]]
    c0, a, b = solve([[1.0, slots(p), slots(p) * r(p)] for p in qm],
                     [p["ms"]["query_major"] for p in qm])
    out["query_major"] = dict(call_ms=c0, width=b / a if a else 0.0,
                              slot_ps=a)
    return sig3(out)


def sig3(x):
    """Every float of a nested dict to 3 significant digits."""
    if isinstance(x, dict):
        return {key: sig3(v) for key, v in x.items()}
    return float(f"{x:.3g}") if isinstance(x, float) else x


def phase_planner(torch, tp, card):
    """Phase 25: the planner line. Every point's plan times, auto's plan
    (after: the card's table; before: the JAX package's rule) and the
    fastest; the cases the JAX rule sent to the flat sweep (PLANNER_CASES),
    their plans and ms before and after; the constants fitted to this
    call's points beside the shipped table. Fails
    where auto's plan at a point of PLANNER_CHECKED is more than 2x slower
    than the fastest plan timed there; lists the points at 1.25-2x and
    those near a crossover (the two plans within 1.25x) without failing."""
    pts = PLANNER
    cases = []
    for name, label, k, n_probe in PLANNER_CASES:
        hit = [p for p in pts if p["index"] == label and p["k"] == k
               and p["n_probe"] == n_probe and p["approx"]
               and p["nq"] == 10_000 and p["n_live"] >= 1_000_000]
        if not hit:
            fail(f"planner: no point for the case {name}")
        p = hit[0]
        b, a = ran(p["before"], p["tier"]), ran(p["auto"], p["tier"])
        cases.append(dict(case=name, before=p["before"],
                          before_ms=p["ms"].get(b), after=p["auto"],
                          after_ms=p["ms"].get(a), fastest=p["fastest"],
                          ms=p["ms"]))
    slow, near, bad = [], [], []
    for p in pts:
        a = ran(p["auto"], p["tier"])
        best = p["ms"][p["fastest"]]
        p["auto_over_fastest"] = None if a not in p["ms"] \
            else round(p["ms"][a] / best, 3)
        times = sorted(p["ms"].values())
        if len(times) > 1 and times[1] <= 1.25 * times[0]:
            near.append(p)
        x = p["auto_over_fastest"]
        if x is None:
            continue
        if x > 2.0 and p["index"] in PLANNER_CHECKED:
            bad.append(p)
        elif x > 1.25:
            slow.append(p)
    fit = fit_planner(pts)
    shipped = dict(tp.index.ivfpq.CARD_PLAN_COSTS, batch_threshold=(
        tp.fn.ivfpq_topk.BATCH_THRESHOLD["cuda"]))
    # the shipped table's query_major / cell_major crossover at the main
    # shape (1M x 128 bf16, cell capacity 1024, k 10, approx): the largest
    # batch of 1, 2, 4, ... that card_probed_plan sends to query_major
    qm_below = {}
    for n_probe in (8, 32):
        nqs = [n for n in (2 ** i for i in range(14))
               if tp.index.ivfpq.card_probed_plan(
                   n, 10, n_probe=n_probe, s_pow2=1024, d_vector=128,
                   tier="bf16", approx=True) == "query_major"]
        qm_below[n_probe] = max(nqs) if nqs else 0
    summary = dict(points=len(pts), timed=sum(1 for p in pts if p["reps"]),
                   auto_fastest=sum(1 for p in pts
                                    if p["auto_over_fastest"] == 1.0),
                   slow_1_25_to_2=len(slow), near_crossover=len(near),
                   over_2x_checked=len(bad))
    log("planner: " + json.dumps(summary))
    for p in slow + bad:
        log(f"planner: auto {p['auto']} at {p['auto_over_fastest']}x the "
            f"fastest ({p['fastest']}): {p['index']} n_live {p['n_live']} "
            f"nq {p['nq']} k {p['k']} n_probe {p['n_probe']} approx "
            f"{p['approx']} ms {p['ms']}")
    for c in cases:
        log(f"planner case {c['case']}: before {c['before']} "
            f"{c['before_ms']} ms, after {c['after']} {c['after_ms']} ms "
            f"(fastest {c['fastest']})")
    log("planner fit (this call's points): " + json.dumps(fit))
    log("planner: the shipped table sends a 1M x 128 bf16 search (k 10, "
        "approx) to query_major up to this batch, by n_probe: "
        + json.dumps(qm_below))
    print(json.dumps({"planner": dict(
        card=card, summary=summary, cases=cases, fit=fit, shipped=shipped,
        query_major_up_to=qm_below,
        near_crossover=[(p["index"], p["n_live"], p["nq"], p["k"],
                         p["n_probe"], p["approx"]) for p in near],
        points=pts)}), flush=True)
    if bad:
        fail(f"planner: auto's plan is more than 2x slower than the fastest "
             f"timed at {len(bad)} points of {PLANNER_CHECKED}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel-vs-plain phase")
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="a checkout of a parent tree: each warp-specialised "
                    "block-scan and codes row also times DIR's "
                    "csrc/block_scan_wg.cu in turns (its live keys held "
                    "equal), each codes row DIR's csrc/codes_scan_tc.cu and "
                    "each narrow bf16 deep pack32 row DIR's "
                    "csrc/block_scan_tc.cu, each where the tree holds and "
                    "takes it")
    ap.add_argument("--sharded-rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # a rank of the D=2 phase
    ap.add_argument("--world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sharded_rank is not None:
        sharded_child(args)
        return

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} (count {torch.cuda.device_count()}); "
        f"nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    import torchpq_tpu_torch as tp
    from torchpq_tpu_torch import _build
    from torchpq_tpu_torch.ops import block_scan as bs
    from torchpq_tpu_torch.ops import codes_scan as cs
    from torchpq_tpu_torch.ops import flat_scan as fs
    from torchpq_tpu_torch.ops import gather as gr
    t_start = time.perf_counter()
    lib = _build.library()
    log(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    kernel, report = "?", {}
    for line in lib.build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = kernel_name(entry.group(1))
        elif re.search(r"Used \d+ registers|spill", line):
            log(f"ptxas {kernel}: " + line.strip())
            report[kernel] = report.get(kernel, "") + " " + line.strip()
        elif "Performance Loss" in line:  # wgmma serialized (C7520)
            log("ptxas: " + line.strip())
    # the block scan's warp-specialised instances, the deep codes one
    # among them, and the flat scan's: no spill, no stack frame
    checked = sorted(x for x in report
                     if WG_KERNEL.search(x) or FLAT_WG_KERNEL.search(x))
    for name in checked:
        rep = report[name]
        regs = re.search(r"Used (\d+) registers", rep)
        frame = [int(x) for x in re.findall(
            r"(\d+) bytes (?:stack frame|spill stores|spill loads)", rep)]
        log(f"ptxas checked instance {name}: "
            f"{regs.group(1) if regs else '?'} registers, stack frame / "
            f"spill stores / spill loads {frame} bytes")
        if not regs or len(frame) != 3 or any(frame):
            fail(f"ptxas reports a stack frame or spills for {name} (or no "
                 f"report): {rep.strip()!r}")
    if len(checked) != N_WG_KERNELS + 1 or DEEP_CODES_KERNEL not in checked \
            or not any(FLAT_WG_KERNEL.search(x) for x in checked):
        fail(f"ptxas reported {checked}, not the {N_WG_KERNELS} checked "
             f"block-scan instances and the flat scan")
    # the warp-specialised instances: warpgroup products and TMA loads
    SASS.update(sass_counts(torch, lib.path))
    if args.parent:
        build_parent(_build, args.parent)

    phase_kernels(torch, bs, cs, fs, gr)
    log(f"phases 1-3: {time.perf_counter() - t_start:.1f} s")
    if args.kernels_only:
        return
    counts, sl = phase_slice(torch, tp, bs, gr)
    profile_pallas_flat(torch, sl)
    planner_small(torch, tp, sl)
    krows = phase_main_shapes(torch, tp, bs, sl["index"], sl["xq"], sl["k"])
    krows["gather_rows"] = phase_gather_main(torch, gr, sl["index"])
    phase_relayout(torch, tp, sl["index"], sl["trained"], sl["base"],
                   sl["xq"], sl["per_cell"], sl["k"])
    code_counts, code_rows, code = phase_code_domain(torch, tp, bs, cs, sl)
    int8_counts, int8_rows, i8 = phase_int8(torch, tp, bs, sl)
    gt100 = exact_gt(torch, sl["base"], sl["xq"], DEEPK_K)
    deep_launches, deep_rows, deep = phase_deepk(torch, tp, bs, sl, gt100)
    t_phase = time.perf_counter()
    pq4_launches, pq4_rows = phase_pq4(torch, tp, bs, cs, sl, gt100)
    log(f"pq4 phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    res_launches, res_rows = phase_residual(torch, tp, bs, sl, gt100)
    log(f"residual phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    pqr_launches, pqr_rows, pqr_trained, pqr_rec = phase_pqr(
        torch, tp, bs, sl, gt100)
    log(f"pqr3 phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    pqrc_launches, pqrc_rows = phase_pqr_codes(
        torch, tp, bs, cs, sl, gt100, pqr_trained, pqr_rec)
    log(f"pqr3 code-domain phase: {time.perf_counter() - t_phase:.1f} s")
    del gt100
    t_phase = time.perf_counter()
    with search_precision(tp, "highest"):
        phase_flat_index(torch, tp, sl)
    log(f"FlatIndex phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_precision(torch, tp, sl)
    log(f"precision phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    with search_precision(tp, "highest"):
        phase_transforms(torch, tp, sl)
    log(f"transforms and SQ phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_aniso_manhattan(torch, tp, bs, cs, sl)
    log(f"anisotropic and manhattan check: "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    gist_counts, gist_rows, gist, gist_q, (rec_launches, rec_rows) = \
        phase_gist(torch, tp, bs)
    log(f"GIST-class phase: {time.perf_counter() - t_phase:.1f} s")
    # last of the paths: its floor holds the kernel's bucket approximation
    flat_counts, flat_row = phase_pallas_flat(torch, tp, fs, sl)
    log(f"phases 4-18: {time.perf_counter() - t_start:.1f} s")
    phase_profile(torch, sl["index"], sl["xq"], sl["k"])
    phase_profile(torch, code, sl["xq"], sl["k"], label="code-domain ")
    phase_profile(torch, i8, sl["xq"], sl["k"], label="int8 ")
    for label, knobs in (("deep-k untapered ", DEEPK_PLAIN),
                         ("deep-k r6 ", DEEPK_R6)):
        for name, value in knobs.items():
            setattr(deep, name, value)
        phase_profile(torch, deep, sl["xq"], DEEPK_K, label=label,
                      plans=[("cell_major", DEEPK_NPROBE, True)])
    del deep
    phase_profile(torch, gist, gist_q, 10, label="GIST int8 ",
                  plans=GIST_PLANS)
    log(f"phases 4-19: {time.perf_counter() - t_start:.1f} s")
    phase_planner(torch, tp, card)

    # phases 20-24, timed through profiling.PhaseTimer; the sharded phase
    # comes last: its single-device add / remove change the main index
    timer = tp.profiling.PhaseTimer()
    work = tempfile.mkdtemp(prefix="torchpq_smoke_")
    try:
        phase_native(torch, tp, sl, work, timer)
        phase_presize(torch, tp, sl, sl["gt"], timer)
        with search_precision(tp, "highest"):
            phase_legacy(torch, tp, sl, timer)
        sharded, sharded_rows = phase_sharded(
            torch, tp, bs, cs, sl,
            {"bf16": sl["index"], "int8": i8, "codes": code}, work, timer)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("phases 20-24 (PhaseTimer, s): " + json.dumps(timer.report()))
    log(f"phases 4-24: {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, row, cnt in (
            ("block_scan_exact", krows, counts["tc_wgn_exact"]),
            ("block_scan_pack32", krows, counts["tc_wgn_pack32"]),
            ("block_scan_int8_exact", int8_rows,
             int8_counts["tc_wgn_int8_exact"]),
            ("block_scan_int8_pack32", int8_rows,
             int8_counts["tc_wgn_int8_pack32"]),
            ("block_scan_int8_exact_d1024", gist_rows,
             gist_counts["tc_wg_int8_exact"]),
            ("block_scan_int8_pack32_d1024", gist_rows,
             gist_counts["tc_wg_int8_pack32"]),
            ("block_scan_exact_d1024", rec_rows,
             rec_launches["block_scan_exact_d1024"]),
            ("block_scan_pack32_d1024", rec_rows,
             rec_launches["block_scan_pack32_d1024"]),
            ("block_scan_pack32_k100_d1024", rec_rows,
             rec_launches["block_scan_pack32_k100_d1024"]),
            ("block_scan_int8_pack32_k100_d1024", rec_rows,
             rec_launches["block_scan_int8_pack32_k100_d1024"]),
            ("block_scan_pack32_deepk_head", deep_rows,
             deep_launches["block_scan_pack32_deepk_head"]),
            ("block_scan_pack32_deepk_tail", deep_rows,
             deep_launches["block_scan_pack32_deepk_tail"]),
            ("block_scan_pack32_deepk_untapered", deep_rows,
             deep_launches["block_scan_pack32_deepk_untapered"]),
            ("codes_scan_exact", code_rows, code_counts["tc_wgn_exact"]),
            ("codes_scan_pack32", code_rows, code_counts["tc_wgn_pack32"]),
            ("block_scan_pack32_pq4", pq4_rows,
             pq4_launches["block_scan_pack32_pq4"]),
            ("block_scan_pack32_pq4_k100", pq4_rows,
             pq4_launches["block_scan_pack32_pq4_k100"]),
            ("codes_scan_exact_pq4", pq4_rows,
             pq4_launches["codes_scan_exact_pq4"]),
            ("codes_scan_pack32_pq4", pq4_rows,
             pq4_launches["codes_scan_pack32_pq4"]),
            ("block_scan_pack32_residual_k100", res_rows,
             res_launches["block_scan_pack32_residual_k100"]),
            ("block_scan_pack32_pqr", pqr_rows,
             pqr_launches["block_scan_pack32_pqr"]),
            ("block_scan_pack32_pqr_k100", pqr_rows,
             pqr_launches["block_scan_pack32_pqr_k100"]),
            ("codes_scan_pack32_pqr", pqrc_rows,
             pqrc_launches["codes_scan_pack32_pqr"]),
            ("codes_scan_pack32_pqr_k100", pqrc_rows,
             pqrc_launches["codes_scan_pack32_pqr_k100"]),
            ("codes_scan_pack32_pqr_k100_np8", pqrc_rows,
             pqrc_launches["codes_scan_pack32_pqr_k100_np8"]),
            ("flat_scan", {"flat_scan": flat_row}, flat_counts["flat_wg"]),
            ("gather_rows", krows, counts["gather"])):
        # launches on the sharded path (phase 24), per rank, D = 1 and 2
        tier, key = SHARDED_KEYS.get(name, (None, None))
        kernels.append(dict(row[name], launches=cnt, sharded_launches={
            d: sharded[tier][d][key] if tier else 0 for d in ("d1", "d2")}))
    kernels += sharded_rows
    for row in kernels:  # the share of the bound each kernel reaches
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
