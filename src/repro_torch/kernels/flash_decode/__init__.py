"""Split-KV decode attention, dense and paged: CUDA kernels and their plain
versions."""
from repro_torch.kernels.flash_decode.kernel import (  # noqa: F401
    flash_decode_fwd, flash_decode_fwd_plain, flash_decode_paged_fwd,
    flash_decode_paged_fwd_plain, gather_pages)
from repro_torch.kernels.flash_decode.ops import (  # noqa: F401
    flash_decode, flash_decode_paged, flash_decode_paged_partials,
    flash_decode_partials)
