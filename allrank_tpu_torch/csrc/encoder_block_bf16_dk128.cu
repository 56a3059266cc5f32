// The whole-encoder kernel pair B10 (encoder_block.cuh) for bf16 activations
// (B1's and B2's "mma" routes) and heads of 65 to 128 columns: one source a
// head class, so that nvcc builds the classes in parallel.
#include "encoder_block_bf16.cuh"

ENCODER_ENTRY_POINTS(MmaRoute, 128)
