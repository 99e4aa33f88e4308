"""v1 SQ adapter (reference legacy/SQ.py: the v1 name for SQCodec)."""

from ..codec import SQCodec


class SQ(SQCodec):
    def __init__(self, bits=8, alpha=1.0, mode="minmax", verbose=0,
                 device=None, **kwargs):
        super().__init__(bits=bits, alpha=alpha, mode=mode, verbose=verbose,
                         device=device, **kwargs)
