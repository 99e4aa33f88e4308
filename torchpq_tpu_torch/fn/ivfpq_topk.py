"""IVFPQ scan facade (counterpart of torchpq_tpu/fn/ivfpq_topk.py): picks
the query-major scan for small batches and the cell-major scan for large
ones, with explicit overrides."""

from ..ops import adc


class IVFPQTopk:
    def __init__(self, n_cells, mode="auto", batch_threshold=256,
                 p_tile=128, approx=False):
        assert mode in ("auto", "query_major", "cell_major", "flat")
        self.n_cells = n_cells
        self.mode = mode
        self.batch_threshold = batch_threshold
        self.p_tile = p_tile
        self.approx = approx

    def topk(self, query, cells, probe_mask, decoded, norms, is_empty,
             cell_start, cell_capacity, *, k, distance, s_max, mode=None,
             approx=None):
        """Returns (values [nq, k] f32, addresses [nq, k] int32; -1 pads).
        With explicit cells, "flat" and "auto" pick by batch size."""
        mode = mode or self.mode
        approx = self.approx if approx is None else approx
        if mode in ("auto", "flat"):
            mode = ("query_major" if query.shape[0] < self.batch_threshold
                    else "cell_major")
        if mode == "query_major":
            return adc.scan_query_major(
                query, cells, probe_mask, decoded, norms, is_empty,
                cell_start, cell_capacity, k=k, distance=distance,
                s_max=s_max)
        return adc.scan_cell_major(
            query, cells, probe_mask, decoded, norms, is_empty, cell_start,
            cell_capacity, k=k, distance=distance, s_max=s_max,
            n_cells=self.n_cells, p_tile=self.p_tile, approx=approx)
