"""Global configuration for torchpq_tpu_torch.

Counterpart of torchpq_tpu/config.py, with its matmul precision contract:
one global precision for training math (k-means, codebooks) and one for
search scoring, plus per-call overrides. A precision says what a float32
product computes on the card (util.matmul):

* "default": both operands rounded to bf16, exact products, f32 sums;
* "high": bf16_3x, three bf16 products of the operands' high and low
  bf16 parts, summed in f32;
* "highest": IEEE float32.

On the CPU every precision computes float32, as XLA:CPU does for the JAX
package. Products whose operands are bf16 already (the decoded cache) are
exact at every precision. TF32 stays off: no precision here is TF32.
"""

import torch

# TF32 is off for matmuls and for cuDNN: a float32 product at "highest" is
# IEEE float32 (torch's matmul default is already False; cuDNN's is True).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Precision of training math (k-means, PQ codebooks): exact.
TRAIN_PRECISION = "highest"

# Precision of search scoring: one bf16 pass, f32 accumulation.
SEARCH_PRECISION = "default"

# dtype of the decoded-vector scan cache kept by IVFPQIndex.
SCAN_CACHE_DTYPE = "bfloat16"

# Default chunk size (elements) used to bound intermediate score tiles.
MAX_SIM_CHUNK_ELEMS = 1 << 26  # ~64M f32 elems = 256 MiB score chunks

# the names jax.lax.Precision accepts, by the precision they name
PRECISIONS = {
    "default": "default", "bfloat16": "default", "fastest": "default",
    "high": "high", "bfloat16_3x": "high", "tensorfloat32": "high",
    "highest": "highest", "float32": "highest",
}


def set_search_precision(p):
    global SEARCH_PRECISION
    SEARCH_PRECISION = p


def set_train_precision(p):
    global TRAIN_PRECISION
    TRAIN_PRECISION = p


def resolve_precision(p, train=False):
    """"default", "high" or "highest" from a precision: None means the
    global one (TRAIN_PRECISION where `train`, else SEARCH_PRECISION; a
    global set to None means XLA's default, "default"); else a name
    jax.lax.Precision accepts, or any object whose .name is DEFAULT, HIGH
    or HIGHEST (a jax.lax.Precision member). Anything else raises."""
    if p is None:
        p = TRAIN_PRECISION if train else SEARCH_PRECISION
    if p is None:
        return "default"
    if isinstance(p, str):
        if p in PRECISIONS:
            return PRECISIONS[p]
    elif getattr(p, "name", None) in ("DEFAULT", "HIGH", "HIGHEST"):
        return p.name.lower()
    raise ValueError(f"unknown matmul precision {p!r}")
