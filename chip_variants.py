#!/usr/bin/env python3
"""Variant builds of the tensor-core block scan over k-chunked rows, timed
in turns with the built library on the JAX package's GIST records'
arguments, on one CUDA card:

    python3 chip_variants.py

Each variant is a copy of `torchpq_tpu_torch/csrc` with one text edit,
built with the package's nvcc flags into its own library under
`build/variants/`:
  - chain:  each tile's sums in one mma.sync chain across its k chunks
            (APART off), the accumulation the int8 instances keep;
  - pp4:    every chunk summed apart four pairs a pass (pack32 too; the
            built source takes two there);
  - sorted: the one-list instances (k-chunked pack32 above k_pair 48)
            with sorted phase ends instead of passes.
It prints each variant's ptxas report for the k-chunked instances, and on
the arguments of the GIST records' searches (1M x 960 manifold-12, seed 1,
IVF4096 x PQ64, spill 8 cells at 512, scan_group 4: bf16 pack32 k = 10
and k = 100 at n_probe 32, exact at n_probe 8; int8 pack32 k = 100) each
variant's agreement with an f64-summed pack32 select and its CUDA-event
ms in turns (built, variant, variant, built). Imports nothing of JAX."""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

VARIANTS = {
    "chain": [("scan_tc.cuh",
               "constexpr bool APART = CHUNKED && !Op::EXACT;",
               "constexpr bool APART = false;")],
    "pp4": [("scan_tc.cuh", "constexpr int PP = PACK ? 2 : 4;",
             "constexpr int PP = 4;")],
    "sorted": [(f, a, b) for f in ("block_scan_tc.cu",
                                   "block_scan_tc_int8.cu")
               for a, b in (("TPQ_LAUNCH(true, PASS_K, true, true)",
                             "TPQ_LAUNCH(true, MAX_PACK_K, true, true)"),
                            ("occupancy_of<true, PASS_K, true, true>",
                             "occupancy_of<true, MAX_PACK_K, true, true>"))],
}
SOURCES = ("block_scan_tc.cu", "block_scan_tc_int8.cu", "block_scan.cu")


def ptxas(log, tag):
    """Registers and spills of the k-chunked instances in a build log."""
    kernel = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = cs.kernel_name(m.group(1))
        elif ("registers" in line or "spill" in line) \
                and re.search(r"block_scan_tc\w*Lb1ELb[01]E$", kernel):
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
    subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                   check=True)
    ptxas(log, name)
    lib = ctypes.CDLL(str(so))
    for fn_name, (argtypes, restype) in _build._SIGNATURES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs a card")
    print(cs.card_line(), flush=True)
    import torchpq_tpu_torch as tp
    from torchpq_tpu_torch import _build
    from torchpq_tpu_torch.ops import block_scan as bs
    lib = _build.library()
    ptxas(lib.build_log, "built")
    libs = {name: build_variant(_build, name, edits)
            for name, edits in VARIANTS.items()}
    base, query = cs.make_data(1_000_000, 10_000, 960, seed=1)
    proto = tp.IVFPQIndex(d_vector=960, n_subvectors=64, n_cells=4096,
                          initial_size=16, device="cuda")
    proto.train(torch.from_numpy(base[:100_000]).cuda().T)
    trained = {**proto.vq_codec.state_dict("vq_codec."),
               **proto.pq_codec.state_dict("pq_codec.")}
    del proto
    xq = torch.from_numpy(query).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    for cache, plans in ((None, ((10, 32, True), (100, 32, True),
                                 (10, 8, False))),
                         ("int8", ((100, 32, True),))):
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
            live = args[1] >= 0
            f64 = cs.pack32_f64(torch, bs, args, kkw)[live] \
                if approx and not cache else None
            for name, vlib in [("built", lib)] + list(libs.items()):
                out = bs.launch(vlib, stream, *args, route=route, **kkw)
                if f64 is not None:
                    print(f"{what} {name}: keys equal to the f64-summed "
                          f"select {cs.share_equal(out[live], f64):.6f}",
                          flush=True)
                if name == "built":
                    continue
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
