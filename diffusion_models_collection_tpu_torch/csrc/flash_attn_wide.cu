// The wide forms of the flash-attention forward (K2 at head_dim past 128):
// the kernels of flash_attn.cu's "head dimensions past 128" section behind
// the entry `flash_attn_fwd_wide`. A translation unit of its own, so that
// nvcc builds these forms in parallel with the others, and the forms up to
// 128 stay as they were.
#define DMC_FLASH_WIDE_FORMS
#include "flash_attn.cu"
