// The key-bias forms of the flash-attention backward (K3 with ToMe's
// proportional attention): every kernel of flash_attn_bwd.cu instantiated
// with BIAS, behind the entry `flash_attn_bwd_bias`. A translation unit of
// its own, so that nvcc builds these forms in parallel with the forms
// without a bias, and those stay as they were.
#define DMC_FLASH_BIAS_FORMS
#include "flash_attn_bwd.cu"
