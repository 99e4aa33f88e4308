"""Global configuration for torchpq_tpu_torch.

Counterpart of torchpq_tpu/config.py. The JAX package picks a matmul
precision per call; here every float32 product runs in full float32:
training (k-means, codebooks) and the coarse probe must agree with the JAX
package on the CPU, and TF32 keeps only ~10 mantissa bits. The search-time
bf16 scoring of the decoded cache is done by upcasting bf16 operands, so
products are exact in float32 and only the summation order differs.
"""

import torch

# TF32 is off for matmuls and for cuDNN: float32 means float32 everywhere in
# the port (torch's matmul default is already False; cuDNN's is True).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# dtype of the decoded-vector scan cache kept by IVFPQIndex.
SCAN_CACHE_DTYPE = "bfloat16"

# Default chunk size (elements) used to bound intermediate score tiles.
MAX_SIM_CHUNK_ELEMS = 1 << 26  # ~64M f32 elems = 256 MiB score chunks
