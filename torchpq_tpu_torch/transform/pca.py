"""PCA transform (counterpart of torchpq_tpu/transform/pca.py): the
covariance's leading eigenvectors, with the mean removed on encode and
added back on decode. Eigenvectors are unique up to sign: a state carried
from the JAX package encodes alike, a fresh fit may flip columns."""

import torch

from .. import util
from ..module import StateModule


class PCA(StateModule):
    def __init__(self, n_components, verbose=0, device=None):
        super().__init__(verbose=verbose, device=device)
        self.n_components = int(n_components)
        self.register_state("_components", None)  # [n_components, d]
        self.register_state("_mean", None)        # [d]
        self.register_state("_is_trained", False)

    @property
    def is_trained(self):
        return bool(self._is_trained)

    @staticmethod
    def covar(x, meaned=True, rowvar=True):
        """Covariance; x: [d, n] when rowvar, else [n, d]."""
        x = torch.as_tensor(x).float()
        if not rowvar:
            x = x.T
        if not meaned:
            x = x - x.mean(dim=1, keepdim=True)
        return (x @ x.T) / max(x.shape[1] - 1, 1)

    def train(self, x):
        """x: [d_vector, n]."""
        x = util.as_tensor(x, self.device, torch.float32)
        mean = x.mean(dim=1)
        cov = self.covar(x - mean[:, None], meaned=True, rowvar=True)
        eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
        comps = eigvecs.flip(1)[:, :self.n_components].T.contiguous()
        self.register_state("_components", comps)
        self.register_state("_mean", mean)
        self.register_state("_is_trained", True)
        explained = eigvals.flip(0)[:self.n_components].sum() / eigvals.sum()
        self.print_message(f"explained variance: {float(explained):.4f}", 1)
        return self

    def encode(self, x):
        """[d, n] -> [n_components, n]."""
        assert self.is_trained
        x = util.as_tensor(x, self.device, torch.float32)
        return self._components @ (x - self._mean[:, None])

    def decode(self, y):
        """[n_components, n] -> [d, n]."""
        assert self.is_trained
        y = util.as_tensor(y, self.device, torch.float32)
        return self._components.T @ y + self._mean[:, None]
