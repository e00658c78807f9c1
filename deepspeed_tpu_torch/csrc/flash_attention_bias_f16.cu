// The f16 flash forward with the additive biases (flash_fwd_tc_kernel's 24
// biased instantiations at E = __half, f16 or f32 biases, the evoformer
// path in f16; see flash_attention.cu), compiled as a translation unit of
// its own so that nvcc builds them beside the bf16 ones.  It defines
// ds_flash::run_fwd_tc_bias_f16, which the f16 unit's run_fwd_f16 calls for
// an f16 call with a bias.
#define DS_FLASH_BIAS_UNIT 2
#include "flash_attention.cu"
