"""allrank_tpu_torch: the PyTorch/CUDA port of allrank-tpu for NVIDIA
Hopper GPUs.

A package of its own beside the JAX package, which stays the reference;
this one imports nothing of it. Ported so far: the scoring service of the
flagship ranker (the model, ``serving.py``, ``serve_http.py``), the train
step (``training/``, ``losses/``) and the train CLI end to end
(``main.py``, ``data/``, ``metrics.py``), with hand-written CUDA kernels
for the encoder's attention and FFN sublayers, the lambdaLoss pair chain,
the fused NeuralNDCG soft-sort and Sinkhorn scaling (``ops/``, sources in
``csrc/``), and offline ranking with the click-model zoo
(``rank_and_click.py``, ``inference/``, ``click_models/``).
"""

__version__ = "0.1.0"

from allrank_tpu_torch.constants import PADDED_INDEX_VALUE, PADDED_Y_VALUE  # noqa: F401
