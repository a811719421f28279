// The wide forms of the flash-attention backward with the key bias (K3 at
// head_dim past 128 with ToMe's proportional attention), behind the entry
// `flash_attn_bwd_wide_bias`; a translation unit of its own as
// flash_attn_bwd_wide.cu.
#define DMC_FLASH_WIDE_FORMS
#define DMC_FLASH_BIAS_FORMS
#include "flash_attn_bwd.cu"
