#!/usr/bin/env python3
"""Variant builds of the block scan, timed in turns with the built library
on the JAX package's GIST records' arguments (k-chunked rows) or on narrow
random inputs (d 128, --narrow), on one CUDA card; and the int8 routes
in turns with a parent tree's mma.sync int8 kernel (--int8-turns):

    python3 chip_variants.py                       # every variant and tier
    python3 chip_variants.py --variants wg8_ring4 --tiers int8
    python3 chip_variants.py --variants wgn_noscore --narrow
    python3 chip_variants.py --variants wgn_sorted --ptxas-only
    python3 chip_variants.py --variants '' --int8-turns --parent DIR

On each of the records' searches (1M x 960 manifold-12, seed 1, IVF4096 x
PQ64, spill 8 cells at 512, scan_group 4: bf16 pack32 k = 10 and k = 100
at n_probe 32, exact at n_probe 8; int8 the same three) it logs the
block's shapes (blocks, live probers, live 64-prober tiles and the share
of pad rows they carry) and the built route's agreement with an
f64-summed pack32 select (bf16; the int8 routes are exact, held by
chip_smoke and the card tests): the warp-specialised instances of
block_scan_wg.cu, wgmma + TMA, bf16 and s8.

Each variant is a copy of `torchpq_tpu_torch/csrc` with text edits, built
with the package's nvcc flags into its own library under
`build/variants/`, and timed in turns with the built one on its route
(built, variant, variant, built):
  - wg_regs224: (wgmma) the consumer warpgroups' register budget
            lowered from 232 to 224 (the producer's raised from 40 to 56);
  - wg_ring4: (wgmma) rings of four stages where the built instances
            take five (exact k_pair <= 10) or six (pack32 k_pair <= 16);
  - wg_sorted: (wgmma) the deep instance (pack32 k_pair > 48) with sorted
            phase ends instead of passes (ptxas spills 352 B there at the
            consumers' 232 registers);
  - wg8_ring4: (wgmma; for the int8 rows, whose k-chunked tiles take half
            the stages of bf16 ones) rings of four stages where the built
            k-chunked instances take five (exact k_pair <= 10) or six
            (pack32 k_pair <= 16);
  - wg8_onelist_ring4: (wgmma, k-chunked pack32 k_pair > 48) one running
            list where the built instance keeps two (the merge reads and
            writes the same list: wrong keys, a timing variant only), and
            the 33,280 B it frees at k_pair 64 spent on a fourth ring stage;
  - wgn_*: (wgmma, narrow rows d <= 128; ptxas only, these records being
            d 1024) wgn_regs224: the producer's and the consumers'
            registers at 56 / 224 instead of 40 / 232; wgn_sorted: the
            deep instance (pack32 k_pair > 16) sorting its phase ends
            instead of extracting them pass by pass, and wgn_sorted_regs240
            the same at 24 / 240; and some that compute wrong keys, to
            time what a part costs (--narrow only): wgn_nopen, no penalty
            loads in the producer; wgn_noscore, no scores or maxima;
            wgn_noprod, no products; wgn_noselect, no phase-end extraction
            (pack32) or list pops (exact).
It prints each variant's ptxas report for the k-chunked and
warp-specialised instances; --ptxas-only stops there.
Imports nothing of JAX."""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

VARIANTS = {
    "wg8_ring4": [("wg_layout.cuh", "constexpr int RING_EXACT_10 = 5;",
                   "constexpr int RING_EXACT_10 = 4;"),
                  ("wg_layout.cuh", "constexpr int RING_PACK_16 = 6;",
                   "constexpr int RING_PACK_16 = 4;")],
    "wg8_onelist_ring4": [
        ("block_scan_wg.cu",
         "const int* cur = run_s + ((phase & 1) * MAX_PT + ct) * kls;",
         "const int* cur = run_s + ct * kls;"),
        ("block_scan_wg.cu",
         "int* nxt = run_s + (((phase + 1) & 1) * MAX_PT + ct) * kls;",
         "int* nxt = run_s + ct * kls;"),
        ("block_scan_wg.cu",
         "run_s + ((phase & 1) * MAX_PT + 16 * l2 + rw) * kls;",
         "run_s + (16 * l2 + rw) * kls;"),
        ("wg_layout.cuh", "(pack32 ? (size_t)2 * 4 * MAX_PT * (k_pair | 1)",
         "(pack32 ? (size_t)1 * 4 * MAX_PT * (k_pair | 1)"),
        ("wg_layout.cuh", "constexpr int RING_DEEP = 3;",
         "constexpr int RING_DEEP = 4;")],
    "wg_regs224": [("block_scan_wg.cu", "constexpr int PRODUCER_REGS = 40;",
                    "constexpr int PRODUCER_REGS = 56;"),
                   ("block_scan_wg.cu", "constexpr int CONSUMER_REGS = 232;",
                    "constexpr int CONSUMER_REGS = 224;")],
    "wg_sorted": [("block_scan_wg.cu", a + "true, tc::PASS_K, RING_DEEP" + z,
                   a + "true, tc::MAX_PACK_K, RING_DEEP" + z)
                  for a, z in (("TPQ_LAUNCH(", ", 0)"),
                               ("occupancy_of<", ", 0>"))],
    "wgn_regs224": [("block_scan_wg.cu",
                     "constexpr int NARROW_PRODUCER_REGS = 40;",
                     "constexpr int NARROW_PRODUCER_REGS = 56;"),
                    ("block_scan_wg.cu",
                     "constexpr int NARROW_CONSUMER_REGS = 232;",
                     "constexpr int NARROW_CONSUMER_REGS = 224;")],
    "wgn_sorted_regs240": [
        ("block_scan_wg.cu",
         "TPQ_LAUNCH(true, tc::PASS_K, NRING_DEEP, NQB_DEEP)",
         "TPQ_LAUNCH(true, tc::MAX_PACK_K, NRING_DEEP, NQB_DEEP)"),
        ("block_scan_wg.cu",
         "occupancy_of<true, tc::PASS_K, NRING_DEEP, NQB_DEEP>",
         "occupancy_of<true, tc::MAX_PACK_K, NRING_DEEP, NQB_DEEP>"),
        ("block_scan_wg.cu", "constexpr int NARROW_PRODUCER_REGS = 40;",
         "constexpr int NARROW_PRODUCER_REGS = 24;"),
        ("block_scan_wg.cu", "constexpr int NARROW_CONSUMER_REGS = 232;",
         "constexpr int NARROW_CONSUMER_REGS = 240;")],
    "wgn_nopen": [("block_scan_wg.cu", "p = __ldg(penalty + s0 + j) +",
                   "p = 0.0f +")],
    "wgn_noscore": [("block_scan_wg.cu",
                     "const int ncol = wlive ? s_eff : 0;",
                     "const int ncol = 0;")],
    "wgn_noprod": [("block_scan_wg.cu",
                    "if (nm64 == 2) {  // both halves in one chain",
                    "if (false) {"),
                   ("block_scan_wg.cu",
                    "} else if (64 * h < nrow) {  // one: this warpgroup's",
                    "} else if (false) {  //")],
    "wgn_noselect": [("block_scan_wg.cu",
                      "const int kx = wlive ? k_pair : 0;",
                      "const int kx = 0;"),
                     ("block_scan_wg.cu",
                      "for (int i = 0; i < (wlive ? k_pair : 0); ++i) {",
                      "for (int i = 0; i < 0; ++i) {")],
    "wgn_sorted": [("block_scan_wg.cu",
                    "TPQ_LAUNCH(true, tc::PASS_K, NRING_DEEP, NQB_DEEP)",
                    "TPQ_LAUNCH(true, tc::MAX_PACK_K, NRING_DEEP, NQB_DEEP)"),
                   ("block_scan_wg.cu",
                    "occupancy_of<true, tc::PASS_K, NRING_DEEP, NQB_DEEP>",
                    "occupancy_of<true, tc::MAX_PACK_K, NRING_DEEP, "
                    "NQB_DEEP>")],
}
SOURCES = ("block_scan.cu", "block_scan_wg.cu")


def ptxas(log, tag):
    """Registers and spills of the warp-specialised instances (bf16 and
    int8) in a build log."""
    kernel = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = cs.kernel_name(m.group(1))
        elif ("registers" in line or "spill" in line) and \
                "block_scan_wg_kernel" in kernel:
            print(f"ptxas {tag} {kernel}: {line.strip()}", flush=True)


def build_variant(_build, name, edits):
    """The variant's library: csrc copied, edited, built, bound."""
    src = Path("build/variants") / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build._PKG / "csrc", src)
    for fname, old, new in edits:
        text = (src / fname).read_text()
        if old not in text:
            cs.fail(f"variant {name}: {old!r} not in {fname}")
        (src / fname).write_text(text.replace(old, new))
    nvcc = _build._nvcc()
    objs = [src / (f + ".o") for f in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-c", str(src / f), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f, o in zip(SOURCES, objs)]
    log = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        cs.fail(f"variant {name}: nvcc failed:\n{log}")
    so = src / "libvariant.so"
    subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs),
                    *_build.LINK_FLAGS], check=True)
    ptxas(log, name)
    lib = ctypes.CDLL(str(so))
    for fn_name, (argtypes, restype) in _build._SIGNATURES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def shapes(torch, args):
    """Blocks, live probers, live 64-prober tiles and the share of pad rows
    those tiles carry (the warp-specialised route's products)."""
    probers = args[1]
    blocks = probers.shape[0]
    live = int((probers >= 0).sum())
    tiles = probers.view(blocks, -1, 64) >= 0
    live64 = int(tiles.any(-1).sum())
    return (f"{blocks} blocks, {live} live probers "
            f"({live / probers.numel():.3f}), {live64} live 64-prober tiles "
            f"({1 - live / max(64 * live64, 1):.3f} of their rows pads)")


def narrow_turns(torch, bs, lib, libs):
    """The narrow route (bf16, d 128) of the built library and of each
    variant in turns (built, variant, variant, built; 5 launches a turn),
    on `random_inputs` at the main path's window (s_eff 640: exact and
    pack32 k_pair 10, 4,096 blocks) and the deep-k tail's (s_eff 4096:
    pack32 k_pair 16, 2,048 blocks); each block's live probers drawn
    uniformly from 1-128."""
    stream = torch.cuda.current_stream().cuda_stream
    for s_eff, blocks, k_pair, pack32 in ((640, 4096, 10, False),
                                          (640, 4096, 10, True),
                                          (4096, 2048, 16, True)):
        args = bs.random_inputs("cuda", s_eff=s_eff, n_blocks=blocks,
                                nq=10000, cap_total=1 << 21, seed=s_eff)
        kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
                  slot_mask=bs.util.next_pow2(s_eff) - 1)
        route = bs.pick_route(dtype=torch.bfloat16, d=128, p_tile=128,
                              s_eff=s_eff, k_pair=k_pair, pack32=pack32)
        what = f"{route} s_eff={s_eff} k_pair={k_pair} ({shapes(torch, args)})"
        for name, vlib in libs.items():
            t, turns = cs.in_turns(torch, {
                "built": lambda: bs.launch(lib, stream, *args, route=route,
                                           **kw),
                name: lambda: bs.launch(vlib, stream, *args, route=route,
                                        **kw)}, 5)
            print(f"{what}: built {t['built']:.3f} ms "
                  f"{[round(x, 3) for x in turns['built']]}, {name} "
                  f"{t[name]:.3f} ms {[round(x, 3) for x in turns[name]]}",
                  flush=True)
        del args


# the int8 shape classes --int8-turns times: (what, d, s_eff, blocks,
# pack32, k_pair, live probers a block of 128); the int8 tiers' (1M x 128:
# 15% of rows live at n_probe 8, 56% at 32), the GIST-class width's, and
# the deep pack32 selects of narrow rows at 2, 4, 5 and 8 tiles a phase
INT8_CLASSES = (
    ("d 128 exact", 128, 640, 4096, False, 10, 19),
    ("d 128 pack32", 128, 640, 4096, True, 10, 72),
    ("d 256 pack32", 256, 640, 4096, True, 10, 64),
    ("d 1024 exact", 1024, 640, 4096, False, 10, 19),
    ("d 1024 pack32", 1024, 640, 4096, True, 10, 72),
    ("d 1024 pack32 k48, G 512", 1024, 2048, 2048, True, 48, 64),
    ("d 1024 pack32 k64, G 512", 1024, 2048, 2048, True, 64, 64),
    ("d 128 pack32 k64, G 256: 2 tiles a phase", 128, 512, 4096, True, 64,
     64),
    ("d 128 pack32 k64, G 512: 4 tiles", 128, 2048, 2048, True, 64, 64),
    ("d 128 pack32 k64, G 128: 5 tiles", 128, 640, 4096, True, 64, 64),
    ("d 128 pack32 k64, G 512: 8 tiles", 128, 4096, 2048, True, 64, 64))


def int8_turns(torch, bs):
    """Each INT8_CLASSES shape on random int8 inputs (the first n probers
    of every block live): pick_route's route (an s8 wgmma instance of
    block_scan_wg.cu) in turns with the parent's mma.sync int8 kernel
    (chip_smoke.mma_sync_turns: --parent's block_scan_tc_int8.cu; 5
    launches a turn), live entries compared."""
    for what, d, s_eff, blocks, pack32, k_pair, n_live in INT8_CLASSES:
        args, scale, q_scale = bs.random_int8_inputs(
            "cuda", s_eff=s_eff, n_blocks=blocks, nq=10000, d=d,
            cap_total=1 << 21 if d <= 256 else 1 << 20, seed=7)
        args[1][:, n_live:] = -1
        kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
                  slot_mask=bs.util.next_pow2(s_eff) - 1, scale=scale,
                  q_scale=q_scale)
        route = bs.pick_route(dtype=torch.int8, d=d, p_tile=128, s_eff=s_eff,
                              k_pair=k_pair, pack32=pack32)
        what = (f"int8 {what} (s_eff {s_eff}, {blocks} blocks, {n_live} of "
                f"128 probers live), {route}")
        if not cs.mma_sync_turns(torch, bs, args, kw, route, what):
            cs.fail("--int8-turns needs --parent DIR (the mma.sync int8 "
                    "kernel of DIR's tree)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS ('' for none)")
    ap.add_argument("--tiers", default="bf16,int8",
                    help="the records' caches to time: bf16, int8")
    ap.add_argument("--ptxas-only", action="store_true",
                    help="build the variants, print their ptxas reports "
                    "and stop")
    ap.add_argument("--narrow", action="store_true",
                    help="time the variants on narrow random inputs "
                    "(narrow_turns) and stop")
    ap.add_argument("--int8-turns", action="store_true",
                    help="time the int8 routes on INT8_CLASSES in turns "
                    "with --parent's mma.sync int8 kernel (int8_turns) "
                    "and stop")
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="a checkout of the tree whose int8 scans ran on "
                    "csrc/block_scan_tc_int8.cu (mma.sync)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs a card")
    print(cs.card_line(), flush=True)
    import torchpq_tpu_torch as tp
    from torchpq_tpu_torch import _build
    from torchpq_tpu_torch.ops import block_scan as bs
    lib = _build.library()
    ptxas(lib.build_log, "built")
    libs = {name: build_variant(_build, name, VARIANTS[name])
            for name in filter(None, opts.variants.split(","))}
    if opts.ptxas_only:
        return
    if opts.narrow:
        narrow_turns(torch, bs, lib, libs)
        return
    if opts.int8_turns:
        if opts.parent:
            cs.build_parent(_build, opts.parent)
        int8_turns(torch, bs)
        return
    base, query = cs.make_data(1_000_000, 10_000, 960, seed=1)
    proto = tp.IVFPQIndex(d_vector=960, n_subvectors=64, n_cells=4096,
                          initial_size=16, device="cuda")
    proto.train(torch.from_numpy(base[:100_000]).cuda().T)
    trained = {**proto.vq_codec.state_dict("vq_codec."),
               **proto.pq_codec.state_dict("pq_codec.")}
    del proto
    xq = torch.from_numpy(query).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    tiers = opts.tiers.split(",")
    for cache, plans in ((None, ((10, 32, True), (100, 32, True),
                                 (10, 8, False))),
                         ("int8", ((10, 32, True), (100, 32, True),
                                   (10, 8, False)))):
        if (cache or "bf16") not in tiers:
            continue
        index, _ = cs.build_index(torch, tp, trained, base, d=960, m=64,
                                  n_cells=4096, per_cell=488, cache=cache,
                                  spill=True)
        index.scan_group = cs.GIST_GROUP
        for k, n_probe, approx in plans:
            index.scan_mode, index.n_probe = "cell_major", n_probe
            index.use_approx_topk = approx
            args, kw = cs.capture_call(tp, index, xq, k)
            kkw = dict(s_eff=kw["s_eff"], k_pair=kw["k_pair"],
                       euclidean=kw["euclidean"], pack32=approx,
                       slot_mask=kw["slot_mask"])
            if cache:
                kkw.update(scale=kw["scale"], q_scale=kw["q_scale"])
            route = bs.pick_route(dtype=args[6].dtype, d=1024, p_tile=128,
                                  s_eff=kw["s_eff"], k_pair=kw["k_pair"],
                                  pack32=approx)
            what = (f"{cache or 'bf16'} {route} k={k} n_probe={n_probe} "
                    f"k_pair={kw['k_pair']}")
            print(f"{what}: {shapes(torch, args)}", flush=True)
            live = args[1] >= 0
            f64 = cs.pack32_f64(torch, bs, args, kkw)[live] \
                if approx and not cache else None
            if f64 is not None:
                out = bs.launch(lib, stream, *args, **kkw)
                print(f"{what} built: keys equal to the f64-summed select "
                      f"{cs.share_equal(out[live], f64):.6f}", flush=True)
            for name, vlib in libs.items():
                if name.startswith("wgn") or \
                        name.startswith("wg") != route.startswith("tc_wg_"):
                    continue  # a variant of another route's instances
                out = bs.launch(vlib, stream, *args, route=route, **kkw)
                if f64 is not None:
                    print(f"{what} {name} ({route}): keys equal to the "
                          f"f64-summed select "
                          f"{cs.share_equal(out[live], f64):.6f}",
                          flush=True)
                t, turns = cs.in_turns(torch, {
                    "built": lambda: bs.launch(lib, stream, *args,
                                               route=route, **kkw),
                    name: lambda: bs.launch(vlib, stream, *args,
                                            route=route, **kkw)}, 5)
                print(f"{what}: built {t['built']:.3f} ms "
                      f"{[round(x, 3) for x in turns['built']]}, {name} "
                      f"{t[name]:.3f} ms {[round(x, 3) for x in turns[name]]}",
                      flush=True)
            if f64 is not None:
                ref = bs.block_scan_ref(*args, **kkw)[live]
                print(f"{what} plain version: keys equal to the f64-summed "
                      f"select {cs.share_equal(ref, f64):.6f}", flush=True)
            del args, f64
        del index
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
