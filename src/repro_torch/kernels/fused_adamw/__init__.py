"""The default AdamW chain as one in-place pass over the parameters: the CUDA
kernel and its leaf table (its plain version is the chain,
``repro_torch.optim.transforms``)."""
from repro_torch.kernels.fused_adamw.kernel import (  # noqa: F401
    TELEMETRY, LeafTable, chunk_table, fused_adamw)
