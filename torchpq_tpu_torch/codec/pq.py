"""Product-quantizer codec (counterpart of torchpq_tpu/codec/pq.py):
codebooks of n_clusters centroids per subvector trained with MultiKMeans
(256 for 8-bit codes, 16 for 4-bit ones), uint8 codes, decode by codebook
gather.

The JAX package decodes large batches with a block-diagonal one-hot matmul
(a TPU layout workaround); at HIGHEST precision that is bit-identical to the
gather used here.

4-bit codes travel packed two per byte (`pack_nibbles`); a packed byte is a
plain 256-cluster code over the byte-pair codebook (`paired_codebook`), so
everything downstream of the index's storage decodes and scores packed
bytes without unpacking them.

Anisotropic PQ (`anisotropic_eta` > 1; Guo et al. 2020, the separable
per-subvector form) refines the k-means codebooks against the loss
eta * |r_par|^2 + |r_orth|^2 and assigns codes by it (`_aniso_refine`,
`_aniso_assign`).
"""

import torch

from .base import BaseCodec
from ..clustering import MultiKMeans
from ..ops.adc import build_adc_table
from ..ops.codes_scan import decode_codes
from ..ops.max_sim import batched_max_sim
from .. import config
from .. import util
from ..metric import canonical_distance


def _decode_nd(codes_nm, codebook):
    """codes [n, m] uint8, codebook [m, n_clusters, dsub] -> [n, m*dsub] f32."""
    return decode_codes(codes_nm, codebook).float()


def _aniso_chunk(m, k):
    """Columns per block of the anisotropic passes: the [m, chunk, k] cost
    tile within config.MAX_SIM_CHUNK_ELEMS (codec/pq.py:_aniso_chunk)."""
    return util.next_pow2(min(max(
        8, config.MAX_SIM_CHUNK_ELEMS // max(m * k, 1)), 65536))


def _aniso_blocks(sub_dn, chunk, labels=None):
    """Feature-major column blocks [m, d, c] of sub_dn [m, d, n] (the last
    one shorter), with the matching label blocks [m, c] when given."""
    n = sub_dn.shape[2]
    cols = [slice(c0, c0 + chunk) for c0 in range(0, n, chunk)]
    if labels is None:
        return [sub_dn[:, :, sl] for sl in cols]
    return [(sub_dn[:, :, sl], labels[:, sl]) for sl in cols]


def _xhat(b_dn):
    """(|x| [m, c], x / max(|x|, 1e-12) [m, d, c]) of a block."""
    nrm = torch.sqrt(torch.sum(b_dn * b_dn, dim=1))
    return nrm, b_dn / torch.clamp(nrm, min=1e-12)[:, None, :]


def _aniso_assign(sub_dn, cents, *, eta, k, chunk):
    """Anisotropic codeword assignment: per (row, codeword) the cost
    |c|^2 - 2 eta |x| p + (eta - 1) p^2 with p = <c, x / |x|> (the loss
    with the row's constant terms dropped), its argmin per subvector, over
    feature-major column blocks. sub_dn [m, dsub, n], cents [m, k, dsub]
    -> labels [m, n] int32."""
    cents = cents.float()
    c_sq = torch.sum(cents * cents, dim=-1)[:, None, :]         # [m, 1, k]
    out = []
    for b_dn in _aniso_blocks(sub_dn.float(), chunk):
        nrm, xhat = _xhat(b_dn)
        p = torch.bmm(xhat.transpose(1, 2), cents.transpose(1, 2))
        # c_sq - (2 eta |x|) p + ((eta - 1) p) p, rounded step by step as
        # the JAX expression, in place over the [m, c, k] tile
        cost = torch.mul(p, ((2.0 * eta) * nrm)[..., None]).neg_().add_(c_sq)
        cost.add_(torch.mul(p, eta - 1.0).mul_(p))
        out.append(torch.argmin(cost, dim=-1).int())
    return torch.cat(out, dim=1)


def _aniso_refine(sub_dn, cents, *, eta, iters, k, chunk):
    """Anisotropic Lloyd refinement from a warm start: `iters` rounds of
    assignment, then per cluster the minimizer of the summed loss, the
    [dsub, dsub] solve (n_c I + (eta - 1) sum xhat xhat^T + 1e-6 I) c =
    eta sum x, batched over [m, k] systems. The per-cluster sums are
    index-adds over feature-major column blocks (the JAX package's one-hot
    products sum the same terms: O(n d^2) work here against its O(n k d));
    empty clusters keep their centroid. sub_dn [m, dsub, n], cents [m, k,
    dsub] -> [m, k, dsub]."""
    sub_dn = sub_dn.float()
    c = cents.float()
    m, d, _ = sub_dn.shape
    dev = sub_dn.device
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    base = (torch.arange(m, device=dev) * k)[:, None]
    for _ in range(iters):
        lab = _aniso_assign(sub_dn, c, eta=eta, k=k, chunk=chunk)
        cnt = torch.zeros(m * k, device=dev)
        sx = torch.zeros((m * k, d), device=dev)
        mat = torch.zeros((m * k, d * d), device=dev)
        for b_dn, lb in _aniso_blocks(sub_dn, chunk, lab):
            _, xhat = _xhat(b_dn)
            idx = (base + lb.long()).reshape(-1)                # [m * c]
            cnt.index_add_(0, idx, torch.ones_like(idx, dtype=cnt.dtype))
            sx.index_add_(0, idx, b_dn.transpose(1, 2).reshape(-1, d))
            outer = xhat.transpose(1, 2)[:, :, :, None] \
                * xhat.transpose(1, 2)[:, :, None, :]           # [m,c,d,d]
            mat.index_add_(0, idx, outer.reshape(-1, d * d))
        cnt = cnt.view(m, k)
        a = (cnt[..., None, None] * eye
             + (eta - 1.0) * mat.view(m, k, d, d) + 1e-6 * eye)
        c_new = torch.linalg.solve(
            a, (eta * sx.view(m, k, d))[..., None])[..., 0]
        c = torch.where((cnt > 0)[..., None], c_new, c)
    return c


class PQCodec(BaseCodec):
    def __init__(self, d_vector, n_subvectors=8, n_clusters=256,
                 distance="euclidean", verbose=0, max_iter=25, n_redo=1,
                 tol=1e-4, seed=0, anisotropic_eta=None, anisotropic_iters=8,
                 device=None):
        super().__init__(verbose=verbose, device=device)
        assert d_vector % n_subvectors == 0
        assert anisotropic_eta is None or anisotropic_eta >= 1.0, \
            "anisotropic_eta weights the parallel residual; must be >= 1"
        self.anisotropic_eta = (None if anisotropic_eta is None
                                else float(anisotropic_eta))
        self.anisotropic_iters = int(anisotropic_iters)
        self.d_vector = d_vector
        self.n_subvectors = n_subvectors
        self.n_clusters = n_clusters
        self.d_subvector = d_vector // n_subvectors
        self.distance = canonical_distance(distance)
        self.register_module("kmeans", MultiKMeans(
            n_clusters=n_clusters, distance=distance, max_iter=max_iter,
            n_redo=n_redo, tol=tol, verbose=verbose, seed=seed,
            device=device))

    @property
    def codebook(self):
        """[n_subvectors, d_subvector, n_clusters]."""
        return self.kmeans.centroids if self.is_trained else None

    @property
    def codebook_internal(self):
        """[m, n_clusters, d_subvector] row-major, for the ops layer."""
        return self.kmeans._centroids

    def train(self, x, centroids=None):
        """x: [d_vector, n]; `centroids` ([m, d_subvector, n_clusters])
        seed the codebooks."""
        x = util.as_tensor(x, self.device, torch.float32)
        assert x.shape[0] == self.d_vector
        sub = x.reshape(self.n_subvectors, self.d_subvector, -1)
        self.kmeans.fit(sub, centroids=centroids)
        if self._anisotropic:
            # the score-aware refinement, warm-started from the k-means fit
            m, k = self.n_subvectors, self.n_clusters
            cents = _aniso_refine(
                sub, self.kmeans._centroids, eta=self.anisotropic_eta,
                iters=self.anisotropic_iters, k=k, chunk=_aniso_chunk(m, k))
            self.kmeans.register_state("_centroids", cents.contiguous())
        self._set_trained()

    @property
    def _anisotropic(self):
        return self.anisotropic_eta is not None and self.anisotropic_eta > 1.0

    def encode(self, x):
        """x: [d_vector, n] -> codes [n_subvectors, n] uint8."""
        return self.encode_nd(util.as_tensor(x, self.device).T).T

    def decode(self, code):
        """codes [n_subvectors, n] uint8 -> [d_vector, n] f32."""
        return self.decode_nd(util.as_tensor(code, self.device).T).T

    def precompute_adc(self, query):
        """query [d_vector, nq] -> ADC table [m, nq, 256] f32."""
        assert self.is_trained, "codec is not trained"
        q = util.as_tensor(query, self.device, torch.float32).T
        return build_adc_table(q, self.codebook_internal,
                               self.distance).transpose(0, 1)

    def encode_nd(self, x_nd):
        """[n, d] -> [n, m] uint8 codes."""
        assert self.is_trained, "codec is not trained"
        x_nd = util.as_tensor(x_nd, self.device, torch.float32)
        n = x_nd.shape[0]
        sub = x_nd.T.reshape(self.n_subvectors, self.d_subvector, n)
        if self._anisotropic:
            labels = _aniso_assign(
                sub, self.codebook_internal, eta=self.anisotropic_eta,
                k=self.n_clusters,
                chunk=_aniso_chunk(self.n_subvectors, self.n_clusters))
            return labels.T.to(torch.uint8).contiguous()
        if self.distance == "cosine":
            sub = util.normalize(sub, dim=1)
        _, labels = batched_max_sim(sub, self.codebook_internal,
                                    self.distance, layout="dn")
        return labels.T.to(torch.uint8).contiguous()

    def decode_nd(self, codes_nm):
        """[n, m] uint8 -> [n, d] f32 reconstruction."""
        assert self.is_trained, "codec is not trained"
        return _decode_nd(util.as_tensor(codes_nm, self.device),
                          self.codebook_internal)


def pack_nibbles(codes):
    """4-bit codes [m, n] (values < 16) -> bytes [m // 2, n]: code 2i in
    the high nibble, 2i + 1 in the low one."""
    codes = torch.as_tensor(codes)
    assert codes.shape[0] % 2 == 0
    return codes[0::2].to(torch.uint8) * 16 + codes[1::2].to(torch.uint8)


def unpack_nibbles(packed):
    """Inverse of pack_nibbles: [m // 2, n] -> [m, n] uint8."""
    packed = torch.as_tensor(packed).to(torch.uint8)
    out = torch.empty((packed.shape[0] * 2, packed.shape[1]),
                      dtype=torch.uint8, device=packed.device)
    out[0::2] = packed // 16
    out[1::2] = packed % 16
    return out


def paired_codebook(codebook):
    """4-bit codebook [m, 16, dsub] -> byte-pair codebook [m // 2, 256,
    2 * dsub]: entry (i, hi * 16 + lo) = concat(codebook[2i, hi],
    codebook[2i + 1, lo]). A packed byte against it decodes (and scores,
    for every per-subvector-decomposable similarity) exactly as its two
    codes against the original."""
    m, nc, _ = codebook.shape
    assert m % 2 == 0 and nc == 16
    hi = codebook[0::2].repeat_interleave(nc, dim=1)  # index b -> b // 16
    lo = codebook[1::2].repeat(1, nc, 1)              # index b -> b % 16
    return torch.cat([hi, lo], dim=-1)
