"""Capacity-bounded (spill) cell assignment on the device (counterpart of
torchpq_tpu/ops/spill.py).

An index with `spill_cells` = l > 1 and a `spill_capacity` routes an item
whose best cell is full to its next-best cell, so the scan's per-block
window (the largest cell capacity) stays near the mean cell size
(index/ivfpq.py:_assign_cells). The routing runs in l rounds without a
host sync: in round r every undecided item bids for its r-th choice, items
are ranked within each cell by batch position, and an item is accepted iff
occupancy[cell] + rank < cap. Items that exhaust all l choices fall back to
their least-occupied choice (the container grows that cell).

The rounds are the JAX package's, so the two packages assign alike, bit
for bit, on the same candidates and occupancy.
"""

import torch


def rank_in_group(cells, active, n_cells):
    """Rank of each active item among the active items of its cell, stable
    by batch position (one stable sort + run starts). Inactive items get
    ranks that nothing reads."""
    b = cells.shape[0]
    key = torch.where(active, cells.long(), n_cells)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    first = torch.searchsorted(
        sorted_key, torch.arange(n_cells, device=cells.device))
    safe = sorted_key.clamp(max=n_cells - 1)
    rank_sorted = torch.arange(b, device=cells.device) - first[safe]
    rank = torch.empty(b, dtype=torch.int32, device=cells.device)
    rank[order] = rank_sorted.int()
    return rank


def spill_assign_device(top, cell_size, *, cap, n_cells):
    """top [n, l] int best-first candidate cells; cell_size [n_cells] int
    current occupancy; cap the per-cell bound.

    Returns (chosen [n] int32, counts [n_cells] int32 new items per
    cell)."""
    n, l = top.shape
    dev = top.device
    top = top.long()
    occ = cell_size.long().clone()
    chosen = torch.full((n,), -1, dtype=torch.long, device=dev)
    undecided = torch.ones(n, dtype=torch.bool, device=dev)
    for r in range(l):
        cand = top[:, r]
        rank = rank_in_group(cand, undecided, n_cells)
        accept = undecided & (occ[cand] + rank < cap)
        chosen = torch.where(accept, cand, chosen)
        occ += torch.bincount(cand[accept], minlength=n_cells)
        undecided &= ~accept
    # leftovers: the least-occupied of their l choices (argmin keeps the
    # first of equal occupancies, as jnp.argmin)
    lf = torch.argmin(occ[top], dim=1)
    fallback = torch.gather(top, 1, lf[:, None])[:, 0]
    chosen = torch.where(undecided, fallback, chosen)
    counts = torch.bincount(chosen, minlength=n_cells)
    return chosen.int(), counts.int()
