"""Stateful-shell base class (counterpart of torchpq_tpu/module.py).

Each class keeps its tensor state in named attributes registered with
`register_state`, on one explicit `device`. `state_dict()` returns a flat
dict of numpy arrays (plus python scalars) with the JAX package's keys and
layout, and `load_state_dict()` replaces shapes wholesale. This is the
carry-across function: an index saved by either package loads into the
other.

bfloat16 has no numpy dtype without `ml_dtypes`, so it travels as its raw
uint16 bits plus a `<key>::bfloat16` marker entry — the JAX package's npz
layout (torchpq_tpu/module.py:save). `load_state_dict` also takes the JAX
package's in-process `state_dict()` output: `ml_dtypes.bfloat16` arrays
(recognised by dtype name), or such arrays viewed as uint16 where the
registered tensor is bfloat16.
"""

import os

import numpy as np
import torch

BF16_MARK = "::bfloat16"


def _to_numpy(v):
    """Tensor -> (numpy array, is_bf16). bf16 comes back as uint16 bits."""
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy().view(np.uint16), True
    return v.numpy(), False


def _from_numpy(a, bf16, device):
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if bf16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16))
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _is_bf16_bits(a):
    """numpy arrays that hold bf16 bits: ml_dtypes.bfloat16 itself, or
    2-byte void/unsigned arrays (bf16 viewed as raw bits)."""
    return (a.dtype.name == "bfloat16"
            or (a.dtype.itemsize == 2 and a.dtype.kind in "Vu"))


class StateModule:
    def __init__(self, verbose=0, device=None):
        self.verbose = verbose
        self.device = torch.device(device if device is not None else "cpu")
        self._state_keys = []
        self._submodules = {}

    def print_message(self, message, level=1):
        if getattr(self, "verbose", 0) >= level:
            print(f"[{type(self).__name__}] {message}")

    # -- state registry --
    def register_state(self, name, value):
        if name not in self._state_keys:
            self._state_keys.append(name)
        setattr(self, name, value)

    def register_module(self, name, module):
        self._submodules[name] = module
        setattr(self, name, module)

    def state_dict(self, prefix=""):
        out = {}
        for k in self._state_keys:
            v = getattr(self, k)
            if v is None:
                continue
            if isinstance(v, torch.Tensor):
                a, bf16 = _to_numpy(v)
                out[prefix + k] = a
                if bf16:
                    out[prefix + k + BF16_MARK] = True
            else:
                out[prefix + k] = v
        for name, mod in self._submodules.items():
            out.update(mod.state_dict(prefix=prefix + name + "."))
        return out

    def load_state_dict(self, state, prefix=""):
        for k in self._state_keys:
            key = prefix + k
            if key not in state:
                continue
            v = state[key]
            cur = getattr(self, k, None)
            if isinstance(v, torch.Tensor):
                v = v.to(self.device)
            elif isinstance(v, np.ndarray) and v.ndim == 0 \
                    and not _is_bf16_bits(v):
                v = v.item()
            elif isinstance(v, np.ndarray):
                bf16 = bool(state.get(key + BF16_MARK, False)) or (
                    _is_bf16_bits(v)
                    and (v.dtype.name == "bfloat16" or v.dtype.kind == "V"
                         or (isinstance(cur, torch.Tensor)
                             and cur.dtype == torch.bfloat16)))
                v = _from_numpy(v, bf16, self.device)
                if v.ndim == 0:
                    v = v.item()
            setattr(self, k, v)
        for name, mod in self._submodules.items():
            mod.load_state_dict(state, prefix=prefix + name + ".")
        self._after_load()

    def _after_load(self):
        """Hook for derived classes to rebuild derived/python-side state."""

    def save(self, path):
        """One portable np.savez file, in the JAX package's npz layout."""
        arrays = {k: np.asarray(v) for k, v in self.state_dict().items()}
        np.savez(path, **arrays)

    def load(self, path):
        if not os.path.exists(path) and os.path.exists(str(path) + ".npz"):
            # np.savez appends .npz to extension-less save paths
            path = str(path) + ".npz"
        with np.load(path, allow_pickle=False) as f:
            state = {k: f[k] for k in f.files}
        self.load_state_dict(state)
