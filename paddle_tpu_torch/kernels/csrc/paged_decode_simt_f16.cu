// The CUDA cores' paged decode (paged_decode_simt.cuh) for float16
// queries, over float16 or int8 pools.

#include "paged_decode_simt.cuh"

PAGED_DECODE_SIMT_ENTRY(paged_decode_simt_f16, __half)
