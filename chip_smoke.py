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
     selects, with CUDA-event times of each; then the f32-cache kernel.
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
  7. profile: torch.profiler over one search per plan; device-busy time
     and the largest kernels of each.
  8. prints the kernels' JSON line, the card line, and the result line.

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


def compare_exact(torch, bs, got, ref, k):
    v = bs.sortable_i32_to_f32(got[..., :k])
    vr = bs.sortable_i32_to_f32(ref[..., :k])
    fin = torch.isfinite(vr)
    if not torch.equal(fin, torch.isfinite(v)):
        fail("exact select: dead entries differ from the plain version")
    err = torch.where(fin, (v - vr).abs(), 0.0)
    tol = TOL_REL * vr.abs() + TOL_ABS
    if bool((err > torch.where(fin, tol, 1.0)).any()):
        fail(f"exact select: values off by up to {float(err.max())}")
    # addresses must agree wherever the value is separated from its
    # neighbours by more than the tolerance (else the order may swap)
    gap = TOL_REL * vr.abs()
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
                 reps=20):
    """The kernel against its plain version on the same inputs; fails the
    run on disagreement. Returns (max_abs_err, key agreement, ms, plain_ms)."""
    slot_mask = bs.util.next_pow2(s_eff) - 1
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=slot_mask)
    got = bs.block_scan(*args, **kw)
    torch.cuda.synchronize()
    ref = bs.block_scan_ref(*args, **kw)
    if pack32:
        err, agree = compare_pack32(torch, bs, got, ref, slot_mask)
    else:
        err, agree = compare_exact(torch, bs, got, ref, k_pair), None
    ms = cuda_ms(torch, lambda: bs.block_scan(*args, **kw), reps)
    plain_ms = cuda_ms(torch, lambda: bs.block_scan_ref(*args, **kw), 3)
    return err, agree, ms, plain_ms


def kernel_row(name, s_eff, blocks, err, agree, ms, plain_ms):
    return (f"{name} s_eff={s_eff} blocks={blocks}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, max_abs_err {err:.3g}"
            + (f", key agreement {agree:.5f}" if agree is not None else ""))


def phase_kernels(torch, bs):
    """Seeded inputs at s_eff 1024 and 2048 (1024 blocks of 128 probers,
    d=128, k_pair=10, bf16), both selects; then the f32-cache kernel."""
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


def capture_block_scan(tp, index, xq, k):
    """One search with the index's current settings, keeping the arguments
    its cell-major scan hands the block-scan kernel."""
    adc = tp.ops.adc
    seen = []
    launch = adc.block_scan

    def record(*args, **kw):
        seen.append((args, kw))
        return launch(*args, **kw)

    adc.block_scan = record
    try:
        index.search(xq.T, k=k)
    finally:
        adc.block_scan = launch
    if len(seen) != 1:
        fail(f"expected one block-scan call per search, saw {len(seen)}")
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
        args, kw = capture_block_scan(tp, index, xq, k)
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


def phase_profile(torch, index, xq, k):
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
        log(f"profile {mode} n_probe={n_probe} approx={approx}: device busy "
            f"{busy:.3f} ms; {top}")


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

    rows = []
    for mode, n_probe, approx in PLANS:
        index.scan_mode = mode
        index.n_probe = n_probe
        index.use_approx_topk = approx
        vals, ids = index.search(xq.T, k=k)  # warm-up (builds layouts)
        torch.cuda.synchronize()
        before = dict(bs.launches)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            vals, ids = index.search(xq.T, k=k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launched = sum(bs.launches[x] - before[x] for x in before) // 3
        if tuple(vals.shape) != (n_query, k) or tuple(ids.shape) != \
                (n_query, k):
            fail(f"{mode} np={n_probe}: result shape {tuple(vals.shape)}")
        if not bool(torch.isfinite(vals).all()) or bool((ids < 0).any()):
            fail(f"{mode} np={n_probe}: non-finite values or missing ids")
        ms = float(np.median(times)) * 1e3
        rec = recall_at(ids.long(), gt)
        row = dict(plan=mode, n_probe=n_probe, approx=approx, ms=ms,
                   qps=n_query / ms * 1e3, recall_at_10=rec,
                   block_scan_launches=launched,
                   select=(tp.ops.adc.LAST_GATE.get("impl")
                           if mode == "cell_major" else None),
                   s_eff=(tp.ops.adc.LAST_GATE.get("s_eff")
                          if mode == "cell_major" else None))
        rows.append(row)
        log(json.dumps(row))
        if mode == "cell_major" and launched <= 0:
            fail(f"cell_major np={n_probe} did not launch the kernel")
    counts = dict(bs.launches)
    log(f"main-path launches: {counts}")
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel block_scan_{name} was never launched by the slice")

    rec = {(r["plan"], r["n_probe"], r["approx"]): r["recall_at_10"]
           for r in rows}
    if rec[("flat", 1, True)] < 0.85:
        fail(f"flat recall@10 {rec[('flat', 1, True)]:.4f} < 0.85")
    if rec[("cell_major", 32, True)] < 0.75:
        fail(f"n_probe=32 recall@10 {rec[('cell_major', 32, True)]:.4f} "
             "< 0.75")
    r1, r8, r32 = (rec[("cell_major", p, True)] for p in (1, 8, 32))
    if r8 < r1 - 0.005 or r32 < r8 - 0.005:
        fail(f"recall falls with n_probe: {r1:.4f} {r8:.4f} {r32:.4f}")

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
                        per_cell=per_cell, k=k)


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
    lib = _build.library()
    log(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())

    phase_kernels(torch, bs)
    if args.kernels_only:
        return
    counts, sl = phase_slice(torch, tp, bs)
    krows = phase_main_shapes(torch, tp, bs, sl["index"], sl["xq"], sl["k"])
    phase_relayout(torch, tp, sl["index"], sl["trained"], sl["base"],
                   sl["xq"], sl["per_cell"], sl["k"])
    phase_profile(torch, sl["index"], sl["xq"], sl["k"])

    kernels = []
    for name in ("block_scan_exact", "block_scan_pack32"):
        row = dict(krows[name])
        row["launches"] = counts[name.rsplit("_", 1)[1]]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
