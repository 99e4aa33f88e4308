#!/usr/bin/env python3
"""Smoke run of the PyTorch port (torchpq_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # the full run, as below
    python3 chip_smoke.py --kernels-only  # phases 1-3 only, no result line

Phases, each of which fails the run on error:
  1. device: a CUDA card is required (no CPU continuation); prints its name
     and `nvidia-smi` name + power limit.
  2. build: compiles the kernels from `torchpq_tpu_torch/csrc` with nvcc.
  3. kernel vs plain on seeded inputs: the block-scan kernel against its
     plain PyTorch version (`block_scan_ref`) on the card (p_tile=128,
     d=128, s_eff 1024 and 2048, k_pair=10, 1024 blocks, bf16), both
     selects, with CUDA-event times of each; then the f32-cache kernel;
     then the codes-scan kernel against `codes_scan_ref` (PQ64 codes,
     s_eff 1024, 1024 blocks), both selects.
  4. the slice: 1M x 128 manifold-12 base + 10k queries (the numpy draws of
     bench.py:make_data, seed 0), IVFPQIndex IVF4096 x PQ64 euclidean,
     trained on 100k and filled in four 250k adds; exact f32 ground truth
     on the card; searches: flat, cell_major at n_probe 1/8/32 (pack32
     select), cell_major at n_probe 8 (exact select). Launch counters are
     zeroed before and read after this phase; every kernel of the path must
     have launched. Floors: flat recall@10 >= 0.85, n_probe=32 >= 0.75,
     recall non-decreasing in n_probe within 0.005. Then a small-input
     check: the probed exact plan over every cell equals the flat exact
     plan.
  5. kernel vs plain at the main path's shapes: the block-scan arguments of
     the exact n_probe=8 and pack32 n_probe=32 searches, each checked with
     both selects and timed; these times go into the kernels' JSON line.
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
     bf16). Both selects must have launched. Then the codes kernel against
     `codes_scan_ref` (exact: equal values, equal addresses outside ties;
     pack32: >= 0.9999 of keys equal) and against the block-scan kernel over
     the decoded bf16 rows, on the codes-scan arguments of the exact
     n_probe=8 and pack32 n_probe=32 searches, timed.
  8. profile: torch.profiler over one search per plan of both indexes;
     device-busy time and the largest kernels of each.
  9. prints the kernels' JSON line, the card line, and the result line.

Imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

TOL_REL = 1e-3  # bf16 products are exact in f32; only summation order differs
TOL_ABS = 1e-3


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


def compare_exact(torch, bs, got, ref, k, rel=TOL_REL, abs_=TOL_ABS):
    """Values within rel * |v| + abs_; addresses equal wherever a value is
    separated from its neighbours by more than rel * |v| (rel = abs_ = 0:
    equal values, equal addresses outside exact ties)."""
    v = bs.sortable_i32_to_f32(got[..., :k])
    vr = bs.sortable_i32_to_f32(ref[..., :k])
    fin = torch.isfinite(vr)
    if not torch.equal(fin, torch.isfinite(v)):
        fail("exact select: dead entries differ from the plain version")
    err = torch.where(fin, (v - vr).abs(), 0.0)
    tol = rel * vr.abs() + abs_
    if bool((err > torch.where(fin, tol, 1.0)).any()):
        fail(f"exact select: values off by up to {float(err.max())}")
    # addresses must agree wherever the value is separated from its
    # neighbours by more than the tolerance (else the order may swap)
    gap = rel * vr.abs()
    left = torch.ones_like(fin)
    left[..., 1:] = (vr[..., :-1] - vr[..., 1:]).abs() > gap[..., 1:]
    right = torch.zeros_like(fin)  # the k-th may tie with the (k+1)-th
    right[..., :-1] = (vr[..., :-1] - vr[..., 1:]).abs() > gap[..., :-1]
    sep = left & right & fin
    a, ar = got[..., k:], ref[..., k:]
    if bool((a != ar)[sep].any()):
        fail("exact select: addresses differ at separated values")
    return float(err.max())


def compare_pack32(torch, bs, got, ref, slot_mask):
    agree = float((got == ref).float().mean())
    if agree < 0.99:
        fail(f"pack32 select: key agreement {agree:.4f} < 0.99")
    same_slot = (got & slot_mask) == (ref & slot_mask)
    v = bs.sortable_i32_to_f32(got & ~slot_mask)
    vr = bs.sortable_i32_to_f32(ref & ~slot_mask)
    err = torch.where(same_slot, (v - vr).abs(), 0.0)
    if bool((err > TOL_REL * vr.abs() + TOL_ABS).any()):
        fail(f"pack32 select: equal slots, values off by {float(err.max())}")
    return float(err.max()), agree


def check_kernel(torch, bs, args, *, s_eff, k_pair, pack32, euclidean=True,
                 reps=20, kernel=None, plain=None, exact_bits=False):
    """A kernel (default: the block scan) against its plain version on the
    same inputs; fails the run on disagreement. exact_bits: exact values
    equal, and pack32 keys agree on >= 0.9999 of entries (the plain
    version's batched GEMM may sum in another order on some chunks, which
    moves a key's low value bits). Returns (max_abs_err, key agreement, ms,
    plain_ms)."""
    kernel = kernel or bs.block_scan
    plain = plain or bs.block_scan_ref
    slot_mask = bs.util.next_pow2(s_eff) - 1
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=slot_mask)
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    if pack32:
        err, agree = compare_pack32(torch, bs, got, ref, slot_mask)
        if exact_bits and agree < 0.9999:
            fail(f"pack32 select: key agreement {agree:.7f} < 0.9999")
    elif exact_bits:
        err, agree = compare_exact(torch, bs, got, ref, k_pair, 0.0, 0.0), \
            None
    else:
        err, agree = compare_exact(torch, bs, got, ref, k_pair), None
    ms = cuda_ms(torch, lambda: kernel(*args, **kw), reps)
    plain_ms = cuda_ms(torch, lambda: plain(*args, **kw), 3)
    return err, agree, ms, plain_ms


def kernel_row(name, s_eff, blocks, err, agree, ms, plain_ms):
    return (f"{name} s_eff={s_eff} blocks={blocks}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, max_abs_err {err:.3g}"
            + (f", key agreement {agree:.7f}" if agree is not None else ""))


def phase_kernels(torch, bs, cs):
    """Seeded inputs at s_eff 1024 and 2048 (1024 blocks of 128 probers,
    d=128, k_pair=10, bf16), both selects; then the f32-cache kernel; then
    the codes kernel (PQ64 codes, s_eff 1024), both selects."""
    for s_eff in (1024, 2048):
        args = bs.random_inputs("cuda", s_eff=s_eff, n_blocks=1024,
                                nq=10000, cap_total=1 << 21, seed=s_eff)
        for pack32 in (False, True):
            res = check_kernel(torch, bs, args, s_eff=s_eff, k_pair=10,
                               pack32=pack32)
            name = "block_scan_pack32" if pack32 else "block_scan_exact"
            log(kernel_row(name, s_eff, 1024, *res))
    args = bs.random_inputs("cuda", s_eff=512, n_blocks=64, nq=10000,
                            cap_total=1 << 21, seed=7, dtype=torch.float32)
    err = check_kernel(torch, bs, args, s_eff=512, k_pair=10, pack32=False,
                       euclidean=False, reps=1)[0]
    log(f"block_scan_exact f32 cache, inner: max_abs_err {err:.3g}")
    args = cs.random_codes_inputs("cuda", s_eff=1024, n_blocks=1024,
                                  nq=10000, m=64, dsub=2, cap_total=1 << 21,
                                  seed=11)
    for pack32 in (False, True):
        res = check_kernel(torch, bs, args, s_eff=1024, k_pair=10,
                           pack32=pack32, kernel=cs.codes_scan,
                           plain=cs.codes_scan_ref, exact_bits=True)
        name = "codes_scan_pack32" if pack32 else "codes_scan_exact"
        log(kernel_row(name, 1024, 1024, *res) + " (PQ64, g=2)")


def capture_call(tp, index, xq, k, module=None, name="block_scan"):
    """One search with the index's current settings, keeping the arguments
    it hands the kernel wrapper `module.name` (default: the block scan, as
    ops/adc.py calls it)."""
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
    if len(seen) != 1:
        fail(f"expected one {name} call per search, saw {len(seen)}")
    return seen[0]


def phase_main_shapes(torch, tp, bs, index, xq, k):
    """The kernel against its plain version on the inputs the main path
    really gives it: the block-scan arguments of the exact n_probe=8 and
    the pack32 n_probe=32 searches, each checked with both selects. Returns
    the kernels' JSON rows without their launch counts."""
    rows = {}
    for n_probe, approx in ((8, False), (32, True)):
        index.scan_mode, index.n_probe = "cell_major", n_probe
        index.use_approx_topk = approx
        args, kw = capture_call(tp, index, xq, k)
        s_eff, k_pair = kw["s_eff"], kw["k_pair"]
        blocks, p_tile = args[1].shape
        live = int((args[1] >= 0).sum())
        d = args[6].shape[1]
        log(f"main path n_probe={n_probe} ({'pack32' if approx else 'exact'}"
            f"): {blocks} blocks x {p_tile} probers, {live} live "
            f"({live / (blocks * p_tile):.3f}), s_eff={s_eff}, "
            f"k_pair={k_pair}, d={d}")
        for pack32 in (False, True):
            res = check_kernel(torch, bs, args, s_eff=s_eff, k_pair=k_pair,
                               pack32=pack32, euclidean=kw["euclidean"])
            name = "block_scan_pack32" if pack32 else "block_scan_exact"
            log(kernel_row(name, s_eff, blocks, *res)
                + f" (inputs of the n_probe={n_probe} search)")
            err, _, ms, plain_ms = res
            # executed FMAs count every prober slot, -1 pads included
            flop = 2.0 * s_eff * d
            log(f"  {flop * blocks * p_tile / ms / 1e9:.2f} TFLOP/s executed,"
                f" {flop * live / ms / 1e9:.2f} TFLOP/s over live probers")
            if pack32 == approx:
                rows[name] = dict(
                    name=name, route="cuda",
                    source="torchpq_tpu_torch/csrc/block_scan.cu",
                    replaces="torchpq_tpu/ops/pallas_scan.py:281",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rows


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


def time_plans(torch, tp, index, xq, gt, k, launches, label,
               short_ok=False):
    """Each plan of PLANS on `index`: the warm-up search, then the median of
    3 host-clock searches to torch.cuda.synchronize(), q/s, recall@10 and
    the kernel launches per search (from the counters in `launches`).
    Fails on a malformed result or a probed plan that launched nothing.

    short_ok: pack32 plans may return fewer than k results (-inf / -1) for
    a query. The code-domain kernel groups columns, and with g = 2 a group
    holds slots 2j and 2j+1, so a cell of n live items fills only
    ceil(n / 2) groups: at n_probe=1 a cell under 2k items comes up short,
    as in the JAX package's kernel."""
    n_query = xq.shape[0]
    rows, results = [], {}
    for mode, n_probe, approx in PLANS:
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
                   qps=n_query / ms * 1e3, recall_at_10=rec,
                   kernel_launches=launched, short_rows=short,
                   select=gate.get("impl") if mode == "cell_major" else None,
                   s_eff=gate.get("s_eff") if mode == "cell_major" else None)
        rows.append(row)
        results[(mode, n_probe, approx)] = (vals, ids)
        log(label + json.dumps(row))
        if mode == "cell_major" and launched <= 0:
            fail(f"{label}cell_major np={n_probe} did not launch the kernel")
    rec = {(r["plan"], r["n_probe"], r["approx"]): r["recall_at_10"]
           for r in rows}
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
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel codes_scan_{name} was never launched by the "
                 "code-domain slice")

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

    # the kernel on the arguments the code-domain searches give it
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
        m = args[7].shape[0]
        log(f"code-domain path n_probe={n_probe} "
            f"({'pack32' if approx else 'exact'}): {blocks} blocks x "
            f"{p_tile} probers, {live} live ({live / (blocks * p_tile):.3f})"
            f", s_eff={s_eff}, k_pair={k_pair}, m={m}, "
            f"g={args[6].shape[1] // m}")
        if decoded is None:
            decoded = cs.decode_codes(args[6].view(-1, m), args[7]) \
                .contiguous()
        bs_args = list(args[:6]) + [decoded]
        for pack32 in (False, True):
            res_k = check_kernel(torch, bs, args, s_eff=s_eff, k_pair=k_pair,
                                 pack32=pack32, euclidean=kw["euclidean"],
                                 kernel=cs.codes_scan, plain=cs.codes_scan_ref,
                                 exact_bits=True)
            name = "codes_scan_pack32" if pack32 else "codes_scan_exact"
            log(kernel_row(name, s_eff, blocks, *res_k)
                + f" (inputs of the code-domain n_probe={n_probe} search)")
            kkw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=kw["euclidean"],
                       pack32=pack32, slot_mask=kw["slot_mask"])
            got = cs.codes_scan(*args, **kkw)
            ref = bs.block_scan(*bs_args, **kkw)
            torch.cuda.synchronize()
            bs_ms = cuda_ms(torch, lambda: bs.block_scan(*bs_args, **kkw), 20)
            if pack32:
                # strided groups of columns, not of slots: may differ
                agree = float((got == ref).float().mean())
                log(f"  vs block_scan over the decoded rows: key agreement "
                    f"{agree:.5f}; block_scan {bs_ms:.3f} ms")
            else:
                compare_exact(torch, bs, got, ref, k_pair, 0.0, 0.0)
                log(f"  vs block_scan over the decoded rows: values equal, "
                    f"addresses equal outside ties; block_scan "
                    f"{bs_ms:.3f} ms")
            err, _, ms, plain_ms = res_k
            if pack32 == approx:
                rows[name] = dict(
                    name=name, route="cuda",
                    source="torchpq_tpu_torch/csrc/codes_scan.cu",
                    replaces="torchpq_tpu/ops/pallas_codes_scan.py:198",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms)
    del decoded
    return counts, rows, code


def phase_profile(torch, index, xq, k, label=""):
    """torch.profiler over one search per plan: device-busy time (the sum
    of the kernels' own device times) and the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for mode, n_probe, approx in PLANS:
        index.scan_mode, index.n_probe = mode, n_probe
        index.use_approx_topk = approx
        index.search(xq.T, k=k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            index.search(xq.T, k=k)
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        if not kernels:
            fail(f"profile of {mode} n_probe={n_probe}: no device time")
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        top = "; ".join(f"{e.key[:48]} x{e.count} "
                        f"{e.self_device_time_total / 1e3:.3f} ms"
                        for e in kernels[:5])
        log(f"profile {label}{mode} n_probe={n_probe} approx={approx}: "
            f"device busy {busy:.3f} ms; {top}")


# the slice's searches: (scan_mode, n_probe, use_approx_topk)
PLANS = [("flat", 1, True), ("cell_major", 1, True), ("cell_major", 8, True),
         ("cell_major", 32, True), ("cell_major", 8, False)]


def recall_at(ids, gt):
    hit = (ids[:, :, None] == gt[:, None, :]).any(-1).float().sum(-1)
    return float(hit.mean() / gt.shape[1])


def phase_slice(torch, tp, bs):
    n_base, n_query, d, m, n_cells, k = 1_000_000, 10_000, 128, 64, 4096, 10

    t0 = time.perf_counter()
    base, query = make_data(n_base, n_query, d)
    log(f"data {n_base} x {d} + {n_query} queries: "
        f"{time.perf_counter() - t0:.1f} s (host)")
    for key in bs.launches:
        bs.launches[key] = 0
    per_cell = max(16, n_base // n_cells * 3)  # 732 at 1M: bench.py's 3x
    index = tp.IVFPQIndex(d_vector=d, n_subvectors=m, n_cells=n_cells,
                          initial_size=per_cell,
                          distance="euclidean", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.train(torch.from_numpy(base[: n_base // 10]).cuda().T)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = {**index.vq_codec.state_dict("vq_codec."),
               **index.pq_codec.state_dict("pq_codec.")}
    t0 = time.perf_counter()
    step = n_base // 4
    for i in range(0, n_base, step):
        index.add(torch.from_numpy(base[i:i + step]).cuda().T)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    log(f"train {train_s:.2f} s, add {add_s:.2f} s; capacity "
        f"{index.capacity}, max cell capacity {index.max_cell_capacity}, "
        f"items {index.n_items}")
    log(f"largest cell {int(index._cell_size_np.max())} items; "
        f"relayout ran: "
        f"{index.max_cell_capacity > tp.util.next_pow2(per_cell)}")

    xb = torch.from_numpy(base).cuda()
    xq = torch.from_numpy(query).cuda()
    gt = []
    for i in range(0, n_query, 1000):
        qc = xq[i:i + 1000]
        s = 2 * qc @ xb.T - (xb * xb).sum(-1)[None]
        gt.append(torch.topk(s, k, dim=-1).indices)
    gt = torch.cat(gt)
    del xb
    torch.cuda.synchronize()

    time_plans(torch, tp, index, xq, gt, k, bs.launches, "")
    counts = dict(bs.launches)
    log(f"main-path launches: {counts}")
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel block_scan_{name} was never launched by the slice")

    # small-input reference: probing every cell with the exact select must
    # find what the exact flat sweep finds
    qs = xq[:256]
    index.use_approx_topk = False
    index.use_smart_probing = False
    index.scan_mode, index.n_probe = "cell_major", n_cells
    v_p, i_p = index.search(qs.T, k=k)
    index.scan_mode = "flat"
    v_f, i_f = index.search(qs.T, k=k)
    torch.cuda.synchronize()
    verr = float((v_p - v_f).abs().max())
    agree = recall_at(i_p.long(), i_f.long())
    log(f"all-cells probe vs flat (256 queries, exact): id agreement "
        f"{agree:.4f}, max value diff {verr:.3g}")
    if agree < 0.99 or verr > TOL_REL * float(v_f.abs().max()) + TOL_ABS:
        fail("the probed exact plan disagrees with the flat exact plan")
    index.use_smart_probing = True
    return counts, dict(index=index, trained=trained, base=base, xq=xq,
                        gt=gt, per_cell=per_cell, k=k)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel-vs-plain phase")
    args = ap.parse_args()

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
    lib = _build.library()
    log(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())

    phase_kernels(torch, bs, cs)
    if args.kernels_only:
        return
    counts, sl = phase_slice(torch, tp, bs)
    krows = phase_main_shapes(torch, tp, bs, sl["index"], sl["xq"], sl["k"])
    phase_relayout(torch, tp, sl["index"], sl["trained"], sl["base"],
                   sl["xq"], sl["per_cell"], sl["k"])
    code_counts, code_rows, code = phase_code_domain(torch, tp, bs, cs, sl)
    phase_profile(torch, sl["index"], sl["xq"], sl["k"])
    phase_profile(torch, code, sl["xq"], sl["k"], label="code-domain ")

    kernels = []
    for name, rows, cnt in (("block_scan_exact", krows, counts),
                            ("block_scan_pack32", krows, counts),
                            ("codes_scan_exact", code_rows, code_counts),
                            ("codes_scan_pack32", code_rows, code_counts)):
        row = dict(rows[name])
        row["launches"] = cnt[name.rsplit("_", 1)[1]]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
