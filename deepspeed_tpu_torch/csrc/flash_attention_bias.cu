// The bf16 flash forward with the additive biases (flash_fwd_tc_kernel's
// 24 biased instantiations, the evoformer path; see flash_attention.cu),
// compiled as a translation unit of its own so that nvcc builds them beside
// flash_attention.cu's other kernels.  It defines ds_flash::run_fwd_tc_bias,
// which flash_attention.cu's ds_flash_fwd calls for a bf16 call with a bias.
#define DS_FLASH_BIAS_UNIT 1
#include "flash_attention.cu"
