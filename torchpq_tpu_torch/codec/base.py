"""Codec base (counterpart of torchpq_tpu/codec/base.py): train / encode /
decode plus an `is_trained` flag that serializes with the model."""

from abc import abstractmethod

from ..module import StateModule


class BaseCodec(StateModule):
    def __init__(self, verbose=0, device=None):
        super().__init__(verbose=verbose, device=device)
        self.register_state("_is_trained", False)

    @property
    def is_trained(self):
        return bool(self._is_trained)

    def _set_trained(self, value=True):
        self.register_state("_is_trained", bool(value))

    @abstractmethod
    def train(self, x):
        ...

    @abstractmethod
    def encode(self, x):
        ...

    @abstractmethod
    def decode(self, code):
        ...
