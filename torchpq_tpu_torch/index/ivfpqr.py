"""IVFPQ with a second, re-ranking PQ over the first stage's residual
(counterpart of torchpq_tpu/index/ivfpqr.py).

The rerank codes live in an aux row store beside the base codes, and the
rerank PQ (`rerank_codec`) is trained on x - decode(encode(x)).

* Cached tiers (bf16 / f32 / int8): each cache row is the full two-stage
  reconstruction (base + rerank decode), so `search` is the parent's
  one-stage scan at the requested k, every probed slot ranked by its
  refined score. A relayout rebuilds the cache with the rerank decode
  through the parent's `_rerank_cache_parts` hook.
* Code domain (scan_cache_dtype="none"): the codes scan at k *
  rerank_multiplier, then a rescore of the shortlist. Euclidean, inner and
  cosine correct the base scan's own scores by 2 q.r - (|y|^2 - |b|^2)
  (euclidean, with the per-slot norm delta in the "dnorm2" store) or q.r,
  so only the rerank codes are decoded (`_rerank_correct`); manhattan
  decodes base + rerank codes and rescores (`_rerank_from_codes`). Both
  decode codewords rounded to bf16, as the JAX package does.

No kernel of its own: the cached tiers run the block scan over the refined
cache, the code domain the codes scan, both through the parent.
"""

import torch

from .. import util
from ..codec import PQCodec
from ..container import CellContainer
from ..ops.codes_scan import decode_codes
from .ivfpq import IVFPQIndex


def _decode_bf16(codes, codebook):
    """codes [n, m] -> [n, m * dsub] f32 of the bf16-rounded codewords."""
    return decode_codes(codes, codebook.to(torch.bfloat16)).float()


def _shortlist(cand_addr, is_empty, valid):
    """(flat safe addresses [nq * k'], valid [nq, k']) of a shortlist:
    invalid entries point at slot 0 and slots emptied since are invalid."""
    safe = torch.where(valid, cand_addr, 0).long()
    return safe.reshape(-1), valid & ~is_empty[safe]


def _take_topk(sims, cand_addr, valid, k):
    """Top min(k, k') of the rescored shortlist -> (vals, addr), -1 where
    the value is -inf."""
    sims = torch.where(valid, sims, -torch.inf)
    vals, idx = torch.topk(sims, min(k, sims.shape[-1]), dim=-1)
    addr = torch.gather(cand_addr, 1, idx)
    return vals, torch.where(torch.isfinite(vals), addr, -1)


def _rerank_correct(q, vals_b, cand_addr, rerank_codes, dnorm2, rr_codebook,
                    is_empty, *, k, distance):
    """Base-scan scores (vals_b, as the parent's search returned them) of
    the shortlist cand_addr [nq, k'] corrected to the two-stage score: +
    2 q.r - dnorm2 (euclidean) or + q.r (inner / cosine), r the rerank
    decode of the slot."""
    flat, valid = _shortlist(cand_addr, is_empty,
                             (cand_addr >= 0) & torch.isfinite(vals_b))
    nq, kp = cand_addr.shape
    rdec = _decode_bf16(rerank_codes[flat], rr_codebook).reshape(nq, kp, -1)
    ip = torch.bmm(rdec, q[:, :, None].float())[..., 0]
    if distance == "euclidean":
        sims = vals_b + 2.0 * ip - dnorm2[flat].reshape(nq, kp)
    else:
        sims = vals_b + ip
    return _take_topk(sims, cand_addr, valid, k)


def _rerank_from_codes(q, cand_addr, codes, rerank_codes, cell_start,
                       pq_codebook, rr_codebook, vq_rows, is_empty, *, k):
    """Manhattan rescore of the shortlist: decode base + rerank codes (+ the
    cell's centroid when vq_rows is given: residual PQ) and score -|q - y|_1.
    codes: [cap, code_size], the storage's unpacked view."""
    flat, valid = _shortlist(cand_addr, is_empty, cand_addr >= 0)
    nq, kp = cand_addr.shape
    dec = _decode_bf16(codes[flat], pq_codebook)
    if vq_rows is not None:
        cell = (torch.searchsorted(cell_start.long(), flat, right=True) - 1) \
            .clamp(0, cell_start.shape[0] - 1)
        dec = dec + vq_rows[cell]
    dec = dec + _decode_bf16(rerank_codes[flat], rr_codebook)
    sims = -torch.sum(torch.abs(q[:, None, :].float()
                                - dec.reshape(nq, kp, -1)), dim=-1)
    return _take_topk(sims, cand_addr, valid, k)


class IVFPQRIndex(IVFPQIndex):
    def __init__(self, d_vector, n_subvectors=8, n_subvectors_rerank=8,
                 n_cells=128, rerank_multiplier=4, **kwargs):
        super().__init__(d_vector, n_subvectors=n_subvectors,
                         n_cells=n_cells, **kwargs)
        assert d_vector % n_subvectors_rerank == 0
        self.n_subvectors_rerank = n_subvectors_rerank
        self.rerank_multiplier = int(rerank_multiplier)
        self.add_aux_store("rerank_codes", n_subvectors_rerank, "uint8")
        if self._code_domain:
            # |y|^2 - |b|^2 per slot, the euclidean rescore's norm term;
            # "norm" stays the base norm, which the codes scan reads. Both
            # are derived: a relayout rebuilds them (replacing the parent's
            # ("norm",))
            self.add_aux_store("dnorm2", 1, "float32")
            self.set_aux_rebuilder(("norm", "dnorm2"),
                                   self._rebuild_scan_cache)
        self.register_module("rerank_codec", PQCodec(
            d_vector=d_vector, n_subvectors=n_subvectors_rerank,
            n_clusters=256, distance=self.distance,
            verbose=kwargs.get("verbose", 0), device=self.device))

    def _rerank_cache_parts(self):
        """The cached tiers fold the rerank decode into every cache row."""
        if self._code_domain or not self.rerank_codec.is_trained:
            return None, None
        return self.aux("rerank_codes"), self.rerank_codec.codebook_internal

    def _rebuild_scan_cache(self):
        """Cached tiers: the parent's rebuild, with the rerank decode folded
        in. Code domain: the base norms and the norm deltas."""
        if not self._code_domain:
            return super()._rebuild_scan_cache()
        cap = self._capacity
        chunk = min(cap, util.next_pow2(
            max(16384, (1 << 27) // max(self.d_vector, 1))))
        nrm = torch.zeros((cap, 1), dtype=torch.float32, device=self.device)
        dn = torch.zeros((cap, 1), dtype=torch.float32, device=self.device)
        codes = self._codes_view()
        rr_codes = self.aux("rerank_codes")
        rr_cb = self.rerank_codec.codebook_internal
        for c0 in range(0, cap, chunk):
            db = self._decode_stored(codes[c0:c0 + chunk])
            full = db + decode_codes(rr_codes[c0:c0 + chunk], rr_cb).float()
            nb = torch.sum(db * db, dim=-1)
            nrm[c0:c0 + chunk, 0] = nb
            dn[c0:c0 + chunk, 0] = torch.sum(full * full, dim=-1) - nb
        return {"norm": nrm, "dnorm2": dn}

    @property
    def is_trained(self):
        return super().is_trained and self.rerank_codec.is_trained

    def train(self, x, force_retrain=False):
        """The parent's codecs, then the rerank PQ on the second-stage
        residual x - decode(encode(x)) (cosine rows normalized first)."""
        if self.is_trained and not force_retrain:
            self.print_message("index is already trained", 1)
            return
        x = util.as_tensor(x, self.device, torch.float32)
        super().train(x, force_retrain=force_retrain)
        if self.distance == "cosine":
            x = util.normalize(x, dim=0)
        recon = self.decode(self.encode(x))
        self.rerank_codec.train(x - recon)
        self.print_message("rerank codec trained", 1)

    def add(self, x, ids=None, return_address=False):
        """x: [d_vector, n]. Base codes as the parent's, the rerank codes of
        the second-stage residual; the cached tiers store the full
        reconstruction (int8: quantized), the code domain the base norm
        and the norm delta."""
        self._check_ported()
        self._assert_unfrozen("add")
        assert self.is_trained, "train the index first"
        x = self._prep(x)
        cells, codes_nm, decoded = self._encode_rows(x)
        rcodes_nm = self.rerank_codec.encode_nd(x.T - decoded)
        full = decoded + self.rerank_codec.decode_nd(rcodes_nm)
        full_sq = torch.sum(full * full, dim=-1, keepdim=True)
        aux_rows = {"rerank_codes": rcodes_nm}
        if self._code_domain:
            nb = torch.sum(decoded * decoded, dim=-1, keepdim=True)
            aux_rows["norm"] = nb
            aux_rows["dnorm2"] = full_sq - nb
        else:
            aux_rows["norm"] = full_sq
            if self._int8_cache:
                qd, scale = util.int8_quantize_rows(full)
                aux_rows["decoded"] = util.pad_cols(qd, self._d_cache)
                aux_rows["scale"] = scale[:, None]
            else:
                aux_rows["decoded"] = util.pad_cols(full, self._d_cache)
        return CellContainer.add(
            self, self._pack_codes(codes_nm).T, cells, ids=ids,
            return_address=return_address, aux_rows=aux_rows)

    def _rescore(self, q, vals_b, cand_addr, k):
        """The code domain's second stage: the top k of the shortlist
        cand_addr [nq, k'] (base-scan values vals_b) by the two-stage score
        -> (vals, addr)."""
        rr = self.rerank_codec
        if self.distance == "manhattan":
            return _rerank_from_codes(
                q, cand_addr, self._codes_view(), self.aux("rerank_codes"),
                self._cell_start, self._scan_codebook, rr.codebook_internal,
                self._coarse_cb() if self.pq_use_residual else None,
                self._is_empty, k=k)
        return _rerank_correct(
            q, vals_b, cand_addr, self.aux("rerank_codes"),
            self._aux_col0("dnorm2"), rr.codebook_internal, self._is_empty,
            k=k, distance=self.distance)

    def search(self, x, k=1, return_address=False):
        """Cached tiers: the parent's one-stage scan over the refined cache.
        Code domain: the base scan at k * rerank_multiplier, then the
        rescore of its shortlist; values and ids pad to k with -inf / -1."""
        if not self._code_domain:
            return super().search(x, k=k, return_address=return_address)
        x = self._prep(x)
        k = int(k)
        vals_b, _, cand_addr = super().search(
            x, k=k * self.rerank_multiplier, return_address=True)
        vals, addr = self._rescore(x.T, vals_b, cand_addr, k)
        ids = torch.where(addr >= 0, self.get_id_by_address(addr), -1)
        addr = addr.int()
        pad = k - vals.shape[1]
        if pad:
            vals = torch.nn.functional.pad(vals, (0, pad), value=-torch.inf)
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            addr = torch.nn.functional.pad(addr, (0, pad), value=-1)
        if return_address:
            return vals, ids, addr
        return vals, ids
