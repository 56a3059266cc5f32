"""Framework-wide constants: the padding contract of a slate batch.

A copy of the JAX package's constants (this package imports nothing of it):
a slate batch is (x [B, L, F] float32, y [B, L] float32, indices [B, L]
int64) where padded documents carry y == PADDED_Y_VALUE and
indices == PADDED_INDEX_VALUE.
"""

PADDED_Y_VALUE = -1
PADDED_INDEX_VALUE = -1

# Large-negative fill for padded attention keys in place of -inf: a fully
# padded slate then gets a uniform softmax instead of NaN, in fp32 and bf16.
NEG_INF_FILL = -1e9

# the losses' default epsilon (clamps and normalisers)
DEFAULT_EPS = 1e-10
