// The CUDA cores' paged decode (paged_decode_simt.cuh) for float32
// queries, over float32 or int8 pools.

#include "paged_decode_simt.cuh"

PAGED_DECODE_SIMT_ENTRY(paged_decode_simt_f32, float)
