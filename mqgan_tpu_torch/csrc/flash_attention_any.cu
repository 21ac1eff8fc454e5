// Causal flash attention: the bf16 kernels and launchers of
// flash_attention.cuh for any head (kAny) at the tiles' D = 32, 64 and 128,
// built beside flash_attention.cu (which declares them extern and
// dispatches to them) so that the parts compile in parallel.

#include "flash_attention.cuh"

namespace mqgan_flash {

MQGAN_FLASH_ANY_SIZES()

}  // namespace mqgan_flash
