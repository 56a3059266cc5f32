"""allrank_tpu_torch: the PyTorch/CUDA port of allrank-tpu for NVIDIA
Hopper GPUs.

A package of its own beside the JAX package, which stays the reference;
this one imports nothing of it. Its first slice is the scoring service of
the flagship ranker: the model (FC tower, slate Transformer encoder, output
head), the scorer and ranker (``serving.py``) and the HTTP service
(``serve_http.py``), with hand-written CUDA kernels for the encoder's
attention and FFN sublayers (``ops/``, sources in ``csrc/``).
"""

__version__ = "0.1.0"

from allrank_tpu_torch.constants import PADDED_INDEX_VALUE, PADDED_Y_VALUE  # noqa: F401
