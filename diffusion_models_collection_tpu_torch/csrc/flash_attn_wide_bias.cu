// The wide forms of the flash-attention forward with the key bias (K2 at
// head_dim past 128 with ToMe's proportional attention), behind the entry
// `flash_attn_fwd_wide_bias`; a translation unit of its own as
// flash_attn_wide.cu.
#define DMC_FLASH_WIDE_FORMS
#define DMC_FLASH_BIAS_FORMS
#include "flash_attn.cu"
