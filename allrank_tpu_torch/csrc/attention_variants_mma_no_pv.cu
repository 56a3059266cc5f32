// X3's no_pv mode on the tensor cores: attention_variants_mma.cuh.
#include "attention_variants_mma.cuh"

ALLRANK_VARIANT_ENTRY(allrank::kAttnNoPv)
