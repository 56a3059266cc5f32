// X3's no_softmax mode on the tensor cores: attention_variants_mma.cuh.
#include "attention_variants_mma.cuh"

ALLRANK_VARIANT_ENTRY(allrank::kAttnNoSoftmax)
