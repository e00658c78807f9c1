// The f16 tensor-core flash kernels (flash_fwd_tc_kernel, flash_dkdv_tc_kernel
// and flash_dq_tc_kernel at E = __half, head dims 32, 64 and 128; see
// flash_attention.cu), compiled as a translation unit of their own so that
// nvcc builds them beside flash_attention.cu's other kernels.  It defines
// ds_flash::run_fwd_f16, run_dkdv_f16 and run_dq_f16, which
// flash_attention.cu's C entry points call for dtype 2 (float16).
#define DS_FLASH_F16_UNIT 1
#include "flash_attention.cu"
