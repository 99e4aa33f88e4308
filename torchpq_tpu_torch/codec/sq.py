"""Scalar-quantizer codec (counterpart of torchpq_tpu/codec/sq.py).

bits in {4, 8, 16, 32}; modes `minmax` (per-dimension min/max window) and
`meanstd` (mean +- alpha * std); 4-bit codes pack two per byte along the
feature axis (dimension 2i in the high nibble). Layout [d_vector, n_data];
lower / upper / binsize are per dimension.
"""

import torch

from .. import util
from .base import BaseCodec


class SQCodec(BaseCodec):
    def __init__(self, bits=8, alpha=1.0, mode="minmax", verbose=0,
                 device=None):
        super().__init__(verbose=verbose, device=device)
        assert bits in (4, 8, 16, 32)
        assert mode in ("minmax", "meanstd")
        self.bits = bits
        self.alpha = alpha
        self.mode = mode
        self.n_bins = 2 ** bits
        self.register_state("lower", None)
        self.register_state("upper", None)
        self.register_state("binsize", None)

    def train(self, x):
        """x: [d_vector, n]."""
        x = util.as_tensor(x, self.device, torch.float32)
        if self.mode == "minmax":
            lower, upper = x.amin(dim=-1), x.amax(dim=-1)
        else:
            mean = x.mean(dim=-1)
            std = x.std(dim=-1, unbiased=False)
            lower = mean - self.alpha * std
            upper = mean + self.alpha * std
        self.register_state("lower", lower)
        self.register_state("upper", upper)
        if self.bits <= 8:
            self.register_state("binsize", torch.clamp(
                upper - lower, min=1e-12) / (self.n_bins - 1))
        self._set_trained()

    def encode(self, x):
        """x: [d, n] -> codes: f32 (32 bits), f16 (16), uint8 [d, n] (8) or
        uint8 [d / 2, n] (4)."""
        assert self.is_trained, "codec is not trained"
        x = util.as_tensor(x, self.device, torch.float32)
        if self.bits == 32:
            return x
        if self.bits == 16:
            return x.half()
        q = torch.clamp(torch.round((x - self.lower[:, None])
                                    / self.binsize[:, None]),
                        0, self.n_bins - 1).to(torch.uint8)
        if self.bits == 8:
            return q
        assert q.shape[0] % 2 == 0, "4-bit SQ needs an even d_vector"
        return q[0::2] * 16 + q[1::2]

    def decode(self, code):
        """Inverse of encode -> [d, n] f32."""
        assert self.is_trained, "codec is not trained"
        code = util.as_tensor(code, self.device)
        if self.bits >= 16:
            return code.float()
        if self.bits == 4:
            out = torch.empty((code.shape[0] * 2, code.shape[1]),
                              dtype=torch.uint8, device=code.device)
            out[0::2] = code // 16
            out[1::2] = code % 16
            code = out
        return code.float() * self.binsize[:, None] + self.lower[:, None]
