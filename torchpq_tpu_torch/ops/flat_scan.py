"""Fused flat scan: every query against every cache slot, keeping a top R
of bucket winners (the flat plan's kernel under scan_impl="pallas_flat").

Replaces the TPU kernel torchpq_tpu/ops/pallas_flat.py:flat_scan_pallas.
Three kernels serve it, chosen by the cache's dtype and width before launch
(`pick_route`), each built by `_build.py` and bound through a plain C entry
point, each counted under its own key of `launches`:
  - "flat_wg", `csrc/flat_scan_wg.cu`: bf16 caches with d % 8 == 0 and
    d <= 128 (the main index's d = 128 and every lane-padded width below),
    on the tensor cores (wgmma over a TMA ring, a producer warpgroup and
    three consumer warpgroups; each bucket's maximum tested against its
    row's running bound, `csrc/flat_select.cuh`);
  - "flat_tc", `csrc/flat_scan_tc.cu`: bf16 caches with d % 8 == 0 and
    128 < d <= 1024, on the tensor cores (mma.sync bf16, f32 sums);
  - "flat", `csrc/flat_scan.cu`: f32 caches and the other widths, on the
    CUDA cores (f32 FMAs).

What it computes, for query q and slot j of a cache padded to a multiple of
W = 2048 slots (the TPU kernel's window) with dead slots (zero rows,
penalty BIG), as the JAX glue pads it:
    score = c * <bf16(q), y_j> - penalty[j]         (f32 sum)
with c = 2 for euclidean and 1 otherwise; the query rounds to bf16 even
over an f32 cache, as in the TPU kernel. Each bucket of W/32 = 64 slots
offers its top 2 (the first maximal slot, then the first maximum of the
rest), and the result is each query's top r_keep of those candidates, by value
descending then address ascending -> (values [nq, r_keep] f32, addresses
[nq, r_keep] int32). Dead entries keep their value (<= -BIG/2): the
caller masks them.

What bounds it on an H100: 2 * nq * cap * d operations on cap * d cache
elements, so arithmetic, not bytes. Every kernel splits the cache into runs
of whole windows (the top R is associative over address ranges) and merges
the partial lists in a second launch.

`flat_scan` takes the plain version `flat_scan_ref` only for tensors on the
CPU. For CUDA tensors it launches the kernel of its route or raises.
"""

import ctypes

import numpy as np
import torch

from .. import util
from .block_scan import (BIG, _H100_SMS, _SMEM_LIMIT, _WG_BOX_ROWS,
                         _WG_STAGE_BYTES, _WG_SW_ATOM)

# kernel launches, counted by `flat_scan` where it launches
launches = {"flat": 0, "flat_tc": 0, "flat_wg": 0}

W = 2048     # the TPU kernel's window; the cache pads to a multiple
BUCKET = 64  # slots per bucket, W / 32 (pallas_flat.py:151; flat_scan.cu)

# CTAs to aim for when splitting the cache (4 per SM of an H100's 132)
_TARGET_CTAS = 528

# warps per CTA of the mma.sync kernel (32 queries each), the first whose
# shared memory fits: 8 warps (one CTA per SM by registers) read each cache
# tile into shared memory once for 256 queries
_TC_WARPS = (8, 4, 2, 1)

# the warp-specialised kernel (csrc/flat_scan_wg.cu): its widest row, the
# query rows of a CTA (three consumer warpgroups of one m64 tile), and the
# mirror of its shared memory (csrc/flat_select.cuh: smem_bytes; the ring's
# stages and tiles are block_scan_wg.cu's: wg_layout.cuh)
_WG_MAX_D = 128
_WG_QROWS = 192
_WG_SW_ROW = 128        # bytes of a swizzled row: a k half of 64 elements
_WG_MAX_RING = 8
# a unit's fixed cost in windows, beside its run (the query rows' copy, the
# lists' first fill): the split's tie-breaker
_WG_UNIT_WINDOWS = 1

_CHUNK_SCORES = 1 << 26  # f32 scores per chunk of the plain version


def _pad(decoded, penalty):
    """The glue's padding: dead slots up to a multiple of W."""
    pad = (-decoded.shape[0]) % W
    if pad:
        decoded = torch.nn.functional.pad(decoded, (0, 0, 0, pad))
        penalty = torch.nn.functional.pad(penalty, (0, pad), value=BIG)
    return decoded, penalty


def flat_scan_ref(query, decoded, penalty, *, r_keep, euclidean):
    """Plain PyTorch version of the kernel: per chunk of buckets, the f32
    scores, each bucket's first and second maxima (argmax keeps the first
    maximal slot), then a stable descending sort of the running list
    followed by the chunk's candidates, which are in address order."""
    decoded, penalty = _pad(decoded, penalty)
    nq = query.shape[0]
    bucket = BUCKET
    q = query.to(torch.bfloat16).float()
    factor = 2.0 if euclidean else 1.0
    run_v = torch.full((nq, r_keep), -torch.inf, device=query.device)
    run_a = torch.full((nq, r_keep), -1, dtype=torch.long,
                       device=query.device)
    chunk = max(bucket, _CHUNK_SCORES // max(nq, 1) // bucket * bucket)
    for c0 in range(0, decoded.shape[0], chunk):
        y = decoded[c0:c0 + chunk].float()
        s = factor * (q @ y.T) - penalty[c0:c0 + chunk][None, :]
        s = s.view(nq, -1, bucket)
        a1 = torch.argmax(s, dim=-1, keepdim=True)
        m1 = torch.gather(s, -1, a1)
        s = s.scatter(-1, a1, -torch.inf)
        a2 = torch.argmax(s, dim=-1, keepdim=True)
        m2 = torch.gather(s, -1, a2)
        base = c0 + torch.arange(s.shape[1], device=s.device)[:, None] \
            * bucket
        cand_v = torch.cat([m1, m2], -1).reshape(nq, -1)
        cand_a = (torch.cat([a1, a2], -1) + base).reshape(nq, -1)
        v, order = torch.sort(torch.cat([run_v, cand_v], 1), dim=1,
                              descending=True, stable=True)
        run_v = v[:, :r_keep]
        run_a = torch.gather(torch.cat([run_a, cand_a], 1), 1,
                             order[:, :r_keep])
    return run_v, run_a.int()


def random_flat_inputs(device, *, nq, cap, d=128, dtype=torch.bfloat16,
                       seed=0):
    """Seeded flat-scan inputs: f32 queries, a cache in `dtype`, and its
    squared norms as penalty with BIG at 5% empty slots."""
    g = torch.Generator(device=device).manual_seed(seed)
    query = torch.randn(nq, d, generator=g, device=device)
    decoded = torch.randn(cap, d, generator=g, device=device).to(dtype)
    empty = torch.rand(cap, generator=g, device=device) < 0.05
    penalty = torch.where(empty, BIG,
                          decoded.float().pow(2).sum(-1)).contiguous()
    return [query, decoded, penalty]


def integer_flat_inputs(device, *, nq, cap, d=128, seed=0):
    """Seeded integer-valued flat-scan inputs (numpy draws): query and bf16
    cache entries in {-3..3}, integer penalties with BIG at 5% empty
    slots, and equal rows inside and across buckets. Every score is an
    integer the f32 sums hold exactly in any order, so the kernels and the
    plain version agree bit for bit, ties and addresses included."""
    rng = np.random.default_rng(seed)
    query = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    decoded = rng.integers(-3, 4, (cap, d)).astype(np.float32)
    run = slice(cap // 10, cap // 10 + min(200, cap // 5))
    decoded[run] = decoded[run.start]       # a run of equal rows
    decoded[cap // 2::97] = decoded[1]      # equal rows far apart
    penalty = rng.integers(-50, 50, cap).astype(np.float32)
    penalty[rng.random(cap) < 0.05] = BIG
    return [torch.from_numpy(query).to(device),
            torch.from_numpy(decoded).to(torch.bfloat16).to(device),
            torch.from_numpy(penalty).to(device)]


def _check(query, decoded, penalty, r_keep):
    dev = decoded.device
    if decoded.dtype not in (torch.bfloat16, torch.float32) \
            or decoded.ndim != 2:
        raise TypeError(f"decoded must be bf16 or f32 [cap, d], got "
                        f"{decoded.dtype} {tuple(decoded.shape)}")
    if query.dtype != torch.float32 or query.ndim != 2 \
            or query.shape[1] != decoded.shape[1]:
        raise TypeError(f"query must be float32 [nq, {decoded.shape[1]}]")
    if penalty.dtype != torch.float32 \
            or tuple(penalty.shape) != (decoded.shape[0],):
        raise TypeError(f"penalty must be float32 [{decoded.shape[0]}]")
    for name, t in (("query", query), ("decoded", decoded),
                    ("penalty", penalty)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, decoded on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= r_keep <= 32:
        raise ValueError(f"need 1 <= r_keep={r_keep} <= 32")


def pick_route(dtype, d):
    """The kernel that serves a cache of `dtype` and width d, which is also
    its key in `launches`: for bf16 with d % 8 == 0, "flat_wg" (wgmma)
    up to d = 128 and "flat_tc" (mma.sync) up to 1024; else "flat" (CUDA
    cores)."""
    if dtype == torch.bfloat16 and d % 8 == 0 and 0 < d <= 1024:
        return "flat_wg" if d <= _WG_MAX_D else "flat_tc"
    return "flat"


def wg_halves(d):
    """The k halves (64 elements, a 128-byte swizzled row each) of a row of
    width d: the warp-specialised kernel's ring stages a tile and query
    buffers."""
    return (2 * d + _WG_SW_ROW - 1) // _WG_SW_ROW


def _wg_fixed_bytes(d, r_keep):
    return (_WG_SW_ATOM + wg_halves(d) * _WG_QROWS * _WG_SW_ROW + 16
            + 8 * _WG_QROWS * (r_keep | 1))


_WG_RING_STAGE = _WG_STAGE_BYTES + 4 * _WG_BOX_ROWS + 16


def wg_ring(d, r_keep):
    """The warp-specialised kernel's ring stages at (d, r_keep): as many as
    the rest of its shared memory leaves room for, at most eight
    (csrc/flat_select.cuh: ring_of)."""
    return min(_WG_MAX_RING,
               (_SMEM_LIMIT - _wg_fixed_bytes(d, r_keep)) // _WG_RING_STAGE)


def wg_smem_bytes(d, r_keep):
    """Mirror of csrc/flat_select.cuh:smem_bytes: alignment slack, the
    query rows [halves][192][128 B], the ring (a 128-slot tile's k half, its
    penalties and two barriers a stage), the query rows' barriers and the
    rows' lists [192][r_keep | 1] of values and addresses."""
    return _wg_fixed_bytes(d, r_keep) + wg_ring(d, r_keep) * _WG_RING_STAGE


def wg_splits(nq, cap, ctas):
    """(split, n_splits) of the warp-specialised kernel: runs of whole
    windows, as even as the window count allows; a unit is 192 queries over
    a run, `ctas` persistent CTAs walk the units. The split count whose
    busiest CTA has the fewest windows to scan (units a CTA, times the run
    and a unit's fixed cost) wins, the fewer splits on a tie: longer runs
    fill each row's list once, and its bound then prunes the most."""
    n_windows = util.cdiv(cap, W)
    q_tiles = util.cdiv(nq, _WG_QROWS)
    best, best_key = None, None
    for n_splits in range(1, n_windows + 1):
        per = util.cdiv(n_windows, n_splits)
        if util.cdiv(n_windows, per) != n_splits:
            continue  # no split of whole windows gives this count
        waves = util.cdiv(q_tiles * n_splits, ctas)
        if best is not None and waves > 64:
            break
        key = waves * (per + _WG_UNIT_WINDOWS)
        if best is None or key < best_key:
            best, best_key = (per * W, n_splits), key
    return best


def tc_splits(nq, cap, rows, resident, n_sm):
    """(split, n_splits) of the tensor-core kernel: runs of whole windows,
    as even as the window count allows; CTAs of `rows` queries, `resident`
    of them per SM at once. Of the split counts up to four waves of
    resident CTAs, the one with at least two CTAs per SM (where the cache
    has windows enough) and then the fullest last wave; fewer splits on a
    tie."""
    n_windows = util.cdiv(cap, W)
    q_tiles = util.cdiv(nq, rows)
    slots = n_sm * resident
    best, best_key = None, None
    for n_splits in range(1, n_windows + 1):
        per = util.cdiv(n_windows, n_splits)
        ctas = q_tiles * n_splits
        if util.cdiv(n_windows, per) != n_splits:
            continue  # no split of whole windows gives this count
        if best is not None and ctas > 4 * slots:
            break
        key = (ctas >= 2 * n_sm, ctas / (util.cdiv(ctas, slots) * slots))
        if best is None or key > best_key:
            best, best_key = (per * W, n_splits), key
    return best


def flat_scan(query, decoded, penalty, *, r_keep, euclidean):
    """Run the flat scan: query [nq, d] f32, decoded [cap, d] bf16/f32,
    penalty [cap] f32 (norms-or-0, BIG at empty slots). Returns (values
    [nq, r_keep] f32, addresses [nq, r_keep] int32), sorted."""
    _check(query, decoded, penalty, r_keep)
    kw = dict(r_keep=r_keep, euclidean=euclidean)
    if decoded.device.type == "cpu":
        return flat_scan_ref(query, decoded, penalty, **kw)
    if decoded.device.type != "cuda":
        raise ValueError(f"flat_scan runs on cpu or cuda, not "
                         f"{decoded.device}")
    from .. import _build
    route = pick_route(decoded.dtype, decoded.shape[1])
    with torch.cuda.device(decoded.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = launch(_build.library(), stream, query, decoded, penalty,
                     route=route, **kw)
    launches[route] += 1
    return out


def _scratch(n_splits, nq, r_keep, dev):
    """The per-split partial lists [n_splits, nq, r_keep]: values and
    addresses."""
    return (torch.empty((n_splits, nq, r_keep), dtype=torch.float32,
                        device=dev),
            torch.empty((n_splits, nq, r_keep), dtype=torch.int32,
                        device=dev))


def _prepare(query, decoded, r_keep):
    """The outputs (values, addresses [nq, r_keep]), the query rounded to
    bf16 in the cache's dtype for the kernels' loads, and the card's SMs."""
    nq = query.shape[0]
    dev = decoded.device
    out = (torch.empty((nq, r_keep), dtype=torch.float32, device=dev),
           torch.empty((nq, r_keep), dtype=torch.int32, device=dev))
    qtable = query.to(torch.bfloat16).to(decoded.dtype).contiguous()
    n_sm = (torch.cuda.get_device_properties(dev).multi_processor_count
            if dev.type == "cuda" else _H100_SMS)
    return out, qtable, n_sm


def _launch_wg(lib, stream, query, decoded, penalty, *, r_keep, euclidean,
               n_splits=None):
    """launch(route="flat_wg") with the cache in n_splits runs of whole
    windows (default: wg_splits' choice): the tests and chip_variants.py
    time and check other run counts through it."""
    nq, d = query.shape
    cap = decoded.shape[0]
    dev = decoded.device
    if pick_route(decoded.dtype, d) != "flat_wg":
        raise ValueError(f"the warp-specialised flat scan takes bf16 "
                         f"caches with d % 8 == 0 and d <= "
                         f"{_WG_MAX_D}, got {decoded.dtype} d={d}")
    (out_v, out_a), qtable, n_sm = _prepare(query, decoded, r_keep)
    if nq == 0:
        return out_v, out_a
    if decoded.data_ptr() % 16:  # TMA reads 16-byte aligned rows
        decoded = decoded.clone()
    if euclidean:  # c folded into the bf16 query: x 2 is exact
        qtable = qtable * 2
    resident = lib.torchpq_flat_scan_wg_occupancy(d, r_keep)
    if resident <= 0:
        raise RuntimeError(f"flat_scan_wg: no CTA fits an SM (CUDA "
                           f"error {-resident})")
    ctas = n_sm * resident
    if n_splits is None:
        split, n_splits = wg_splits(nq, cap, ctas)
    else:
        per = util.cdiv(util.cdiv(cap, W), n_splits)
        split, n_splits = per * W, util.cdiv(cap, per * W)
    part_v, part_a = _scratch(n_splits, nq, r_keep, dev)
    # the rows' bound shared by their runs: no run has published one
    gkey = torch.full((nq,), torch.iinfo(torch.int32).min,
                      dtype=torch.int32, device=dev)
    n_ctas = min(ctas, util.cdiv(nq, _WG_QROWS) * n_splits)
    rc = lib.torchpq_flat_scan_wg(
        qtable.data_ptr(), penalty.data_ptr(), decoded.data_ptr(),
        part_v.data_ptr(), part_a.data_ptr(), gkey.data_ptr(),
        out_v.data_ptr(), out_a.data_ptr(), nq, cap, d, r_keep, split,
        n_splits, n_ctas, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flat_wg kernel launch failed: CUDA error {rc}")
    return out_v, out_a


def launch(lib, stream, query, decoded, penalty, *, r_keep, euclidean,
           route=None):
    """Launch the kernel of `route` ("flat_wg", "flat_tc" or "flat";
    default pick_route's) of `lib` on `stream` with checked arguments.
    Raises if the route does not take the cache or the launch fails."""
    nq, d = query.shape
    cap = decoded.shape[0]
    dev = decoded.device
    route = route or pick_route(decoded.dtype, d)
    if route not in launches:
        raise ValueError(f"unknown flat scan route {route!r}")
    if route == "flat_wg":
        return _launch_wg(lib, stream, query, decoded, penalty,
                          r_keep=r_keep, euclidean=euclidean)
    (out_v, out_a), qtable, n_sm = _prepare(query, decoded, r_keep)
    if nq == 0:
        return out_v, out_a
    if route == "flat_tc":
        if pick_route(decoded.dtype, d) != "flat_tc":
            raise ValueError(f"the tensor-core flat scan takes bf16 caches "
                             f"with d % 8 == 0 and {_WG_MAX_D} < d <= "
                             f"1024, got {decoded.dtype} d={d}")
        if decoded.data_ptr() % 16:  # its copies read 16-byte pieces
            decoded = decoded.clone()
        warps = next(
            w for w in _TC_WARPS
            if lib.torchpq_flat_scan_tc_smem(w, d, r_keep) <= _SMEM_LIMIT)
        resident = lib.torchpq_flat_scan_tc_occupancy(warps, d, r_keep)
        if resident <= 0:
            raise RuntimeError(f"flat_scan_tc: no CTA of {warps} warps fits "
                               f"an SM (CUDA error {-resident})")
        split, n_splits = tc_splits(nq, cap, 32 * warps, resident, n_sm)
        part_v, part_a = _scratch(n_splits, nq, r_keep, dev)
        rc = lib.torchpq_flat_scan_tc(
            qtable.data_ptr(), penalty.data_ptr(), decoded.data_ptr(),
            part_v.data_ptr(), part_a.data_ptr(), out_v.data_ptr(),
            out_a.data_ptr(), nq, cap, d, r_keep, split, n_splits,
            int(euclidean), warps, ctypes.c_void_p(stream))
    else:
        if d % 4:
            raise ValueError(f"flat scan kernel needs d % 4 == 0, got d={d}")
        is_bf16 = int(decoded.dtype == torch.bfloat16)
        pt = next((pt for pt in (128, 64, 32)
                   if lib.torchpq_flat_scan_smem(pt, d, is_bf16)
                   <= _SMEM_LIMIT), None)
        if pt is None:
            raise ValueError(f"flat scan: no CTA shape fits shared memory "
                             f"at d={d}")
        # split the padded cache into runs of whole windows
        n_windows = util.cdiv(cap, W)
        want = util.cdiv(_TARGET_CTAS, util.cdiv(nq, pt))
        split = util.cdiv(n_windows, max(1, min(want, n_windows))) * W
        n_splits = util.cdiv(cap, split)
        part_v, part_a = _scratch(n_splits, nq, r_keep, dev)
        rc = lib.torchpq_flat_scan(
            qtable.data_ptr(), penalty.data_ptr(), decoded.data_ptr(),
            part_v.data_ptr(), part_a.data_ptr(), out_v.data_ptr(),
            out_a.data_ptr(), nq, cap, d, r_keep, split, n_splits,
            int(euclidean), is_bf16, pt, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{route} kernel launch failed: CUDA error {rc}")
    return out_v, out_a
