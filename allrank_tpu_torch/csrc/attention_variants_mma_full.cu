// X3's full mode on the tensor cores: attention_variants_mma.cuh.
// (also the exp2 mode's: B1's exponent is exp2 already)
#include "attention_variants_mma.cuh"

ALLRANK_VARIANT_ENTRY(allrank::kAttnFull)
