"""Split-KV decode attention: CUDA kernel and its plain version."""
from repro_torch.kernels.flash_decode.kernel import (  # noqa: F401
    flash_decode_fwd, flash_decode_fwd_plain)
from repro_torch.kernels.flash_decode.ops import (  # noqa: F401
    flash_decode, flash_decode_partials)
