// Causal flash attention: the kernels and launchers of flash_attention.cuh
// at the tiles' D = 96 and 256 for fp32, and at D = 96 for bf16 heads that
// fill their tiles in 16-byte copies, built beside flash_attention.cu (which declares
// them extern and dispatches to them) so that the parts compile in
// parallel.

#include "flash_attention.cuh"

namespace mqgan_flash {

MQGAN_FLASH_WIDE_SIZES()

}  // namespace mqgan_flash
