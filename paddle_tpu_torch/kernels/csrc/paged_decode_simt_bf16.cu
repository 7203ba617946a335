// The CUDA cores' paged decode (paged_decode_simt.cuh) for bfloat16
// queries, over bfloat16 or int8 pools.

#include "paged_decode_simt.cuh"

PAGED_DECODE_SIMT_ENTRY(paged_decode_simt_bf16, __nv_bfloat16)
