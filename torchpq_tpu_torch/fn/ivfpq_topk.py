"""IVFPQ scan facade (counterpart of torchpq_tpu/fn/ivfpq_topk.py): picks
the query-major scan for small batches and the cell-major scan for large
ones (on a CUDA card, below the batch threshold, by the card's cost
estimates), with explicit overrides; a code-domain index's raw codes take
the code-domain cell-major scan, and an int8 cache (per-slot scales given)
the cell-major scan."""

import torch

from .. import util
from ..ops import adc
from ..ops.onehot_adc import scan_cell_major_codes

# The batch size from which "auto" takes the cell-major scan, by the
# queries' device type. The CPU keeps the JAX package's 256 (a TPU v5e's),
# below which it takes the query-major scan, so the CPU parity tests compare
# the same plan. On a CUDA card the query-major scan is a candidate below
# the threshold, and the card's cost estimates choose
# (index/ivfpq.py:card_probed_plan): chip_smoke.py's planner sweep timed it
# up to 1,024 queries, where it still beat cell_major on a 100k index.
BATCH_THRESHOLD = {"cpu": 256, "cuda": 2048}


def batch_threshold_for(device, given=None):
    """`given` where set, else the threshold of the device's type."""
    if given is not None:
        return given
    return BATCH_THRESHOLD.get(getattr(device, "type", str(device)),
                               BATCH_THRESHOLD["cpu"])


class IVFPQTopk:
    def __init__(self, n_cells, mode="auto", batch_threshold=None,
                 p_tile=128, approx=False):
        """batch_threshold None: the queries' device type's entry of
        BATCH_THRESHOLD (the JAX package's 256 on the CPU)."""
        assert mode in ("auto", "query_major", "cell_major", "flat")
        self.n_cells = n_cells
        self.mode = mode
        self.batch_threshold = batch_threshold
        self.p_tile = p_tile
        self.approx = approx

    def topk(self, query, cells, probe_mask, decoded, norms, is_empty,
             cell_start, cell_capacity, *, k, distance, s_max, scales=None,
             mode=None, approx=None, impl="xla", group=1, precision=None,
             pq_codebook=None, probe_cap=None, m=None):
        """Returns (values [nq, k] f32, addresses [nq, k] int32; -1 pads).
        With explicit cells, "flat" and "auto" pick by batch size. When
        `decoded` is the raw uint8 codes (scan_cache_dtype="none"), pass
        `pq_codebook`: every mode runs the code-domain cell-major scan, with
        `m` the per-slot code width of the packed [cap/g, g*m] layout. An
        int8 cache passes its per-slot `scales` and always runs cell-major.
        `impl` is the index's scan_impl ("xla" by default, as in the JAX
        package); `group` and `probe_cap` pass through to the cell-major
        scan (supercells, the probe cap), as in the JAX package, which
        takes no merge taper here. `precision` (None: the search
        precision) is the scans' products'."""
        mode = mode or self.mode
        approx = self.approx if approx is None else approx
        if pq_codebook is not None:
            return scan_cell_major_codes(
                query, cells, probe_mask, decoded, norms, is_empty,
                cell_start, cell_capacity, pq_codebook, k=k,
                distance=distance, s_max=s_max, n_cells=self.n_cells,
                p_tile=self.p_tile, approx=approx, m=m, impl=impl,
                precision=precision)
        if mode in ("auto", "flat") and query.is_cuda:
            from ..index.ivfpq import card_probed_plan
            mode = card_probed_plan(
                query.shape[0], k, n_probe=cells.shape[1],
                s_pow2=util.next_pow2(s_max), d_vector=decoded.shape[-1],
                tier="int8" if scales is not None else (
                    "float32" if decoded.dtype == torch.float32 else "bf16"),
                approx=approx, batch_threshold=self.batch_threshold)
        elif mode in ("auto", "flat"):
            mode = ("query_major" if query.shape[0] < batch_threshold_for(
                query.device, self.batch_threshold) else "cell_major")
        if scales is not None:
            mode = "cell_major"  # the int8 cache path
        if mode == "query_major":
            return adc.scan_query_major(
                query, cells, probe_mask, decoded, norms, is_empty,
                cell_start, cell_capacity, k=k, distance=distance,
                s_max=s_max, precision=precision)
        return adc.scan_cell_major(
            query, cells, probe_mask, decoded, norms, is_empty, cell_start,
            cell_capacity, k=k, distance=distance, s_max=s_max,
            n_cells=self.n_cells, p_tile=self.p_tile, approx=approx,
            scales=scales, impl=impl, group=group, probe_cap=probe_cap,
            precision=precision)
