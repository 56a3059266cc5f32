// The whole-encoder kernel pair B10 (encoder_block.cuh) for fp32 activations
// (B1's and B2's "tf32x3" routes, 3xTF32) and heads of 33 to 64 columns: one
// source a head class, so that nvcc builds the classes in parallel.
#include "encoder_block_f32.cuh"

ENCODER_ENTRY_POINTS(Tf32x3Route, 64)
