"""torchpq_tpu_torch — the PyTorch / CUDA port of torchpq_tpu.

IVFPQ search (coarse VQ + PQ codes, a bf16 decoded scan cache, cell-major
block scans and a flat sweep) on one NVIDIA Hopper GPU, with the JAX
package's public API, state layout and results. The JAX package `torchpq_tpu`
is the reference; this package never imports it or JAX. Each TPU kernel on
the ported path is a hand-written CUDA kernel under `csrc/`, built at first
use by `_build.py`; on CPU tensors its plain PyTorch version runs instead.
Objects live on the card unless they are built with device="cpu".
Multi-device search and k-means run over torch.distributed (`parallel`);
the host data plane (dataset readers, the host spill greedy) is C++ built
with g++ at first use (`native`); the v1 API lives in `legacy`.
"""

from . import config
from . import util
from . import metric
from . import ops
from . import clustering
from . import codec
from . import container
from . import fn
from . import index
from . import transform
from . import native
from . import parallel
from . import legacy
from . import profiling
from .fn import Topk
from .module import StateModule
from .index import FlatIndex, IVFPQIndex, IVFPQRIndex

# the reference's name of the stateful-shell base class
CustomModule = StateModule

# the reference's module-level top-k facade
topk = Topk()

__version__ = "0.1.0"
