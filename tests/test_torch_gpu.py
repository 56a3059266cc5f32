"""The port's CUDA kernels on the card: each against its plain version, and
the flagship scorer's launches. Every test here is marked ``gpu`` and skips
without a CUDA device (the kernels have no CPU mode).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from allrank_tpu_torch.ops.attention_block import (
    attention_sublayer_fwd,
    attention_sublayer_fwd_plain,
)
from allrank_tpu_torch.ops.ffn_block import (
    ffn_sublayer_fwd,
    ffn_sublayer_fwd_plain,
)

pytestmark = pytest.mark.gpu

# fp32: the same FMAs summed in another order; bf16: the same rounding
# points, a rounding flip moves y by one or two bf16 ulps
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2 ** -6, atol=2 ** -6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(gen, shapes, dev):
    out = []
    for shape, center, scale in shapes:
        out.append((center + torch.randn(*shape, generator=gen) * scale)
                   .to(dev))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,d_ff", [(128, 4, 512), (144, 2, 512),
                                      (96, 1, 384)])
def test_kernels_match_plain(cuda, d, h, d_ff, dtype):
    gen = torch.Generator().manual_seed(d)
    b, l = 8, 240
    x = torch.randn(b, l, d, generator=gen).to(dtype).to(cuda)
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = 0
    mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(cuda)
    attn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                         ((d, 3 * d), 0, d ** -0.5), ((3 * d,), 0, 0.1),
                         ((d, d), 0, d ** -0.5), ((d,), 0, 0.1)], cuda)
    ffn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                        ((d, d_ff), 0, d ** -0.5), ((d_ff,), 0, 0.1),
                        ((d_ff, d), 0, d_ff ** -0.5), ((d,), 0, 0.1)], cuda)
    before = (attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches)
    y = attention_sublayer_fwd(x, mask, *attn, h)
    torch.testing.assert_close(
        y.float(), attention_sublayer_fwd_plain(x, mask, *attn, h).float(),
        **TOL[dtype])
    z = ffn_sublayer_fwd(y, *ffn)
    torch.testing.assert_close(z.float(),
                               ffn_sublayer_fwd_plain(y, *ffn).float(),
                               **TOL[dtype])
    assert (attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches) == (
        before[0] + 1, before[1] + 1)


def test_scorer_launches_each_kernel_once_per_block(cuda):
    from allrank_tpu_torch.config import (
        FCConfig,
        ModelConfig,
        PostModelConfig,
        TransformerConfig,
    )
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.serving import make_scorer

    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[32], input_norm=True, activation="ReLU",
                          dropout=0.0),
        transformer=TransformerConfig(N=3, d_ff=64, h=2, dropout=0.0,
                                      positional_encoding=None),
        post_model=PostModelConfig(d_output=1)), 10)
    model = LTRModel(mdef, torch.Generator().manual_seed(0), device="cpu")
    x = np.random.RandomState(0).randn(4, 20, 10).astype(np.float32)
    lengths = np.array([20, 7, 0, 1])
    ref = make_scorer(model, device="cpu")(x, lengths).numpy()
    scorer = make_scorer(model, device=cuda)
    scorer(x, lengths)
    attention_sublayer_fwd.launches = ffn_sublayer_fwd.launches = 0
    got = scorer(x, lengths).cpu().numpy()
    assert (attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches) == (
        3, 3)
    assert (np.isneginf(got) == np.isneginf(ref)).all()
    assert not np.isnan(got).any()
    valid = ~np.isneginf(ref)
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-4, atol=1e-4)


def test_kernels_raise_outside_their_envelope(cuda):
    x = torch.zeros(1, 1025, 128, device=cuda)
    mask = torch.zeros(1, 1025, dtype=torch.bool, device=cuda)
    attn = [torch.zeros(*s, device=cuda)
            for s in ((128,), (128,), (128, 384), (384,), (128, 128), (128,))]
    with pytest.raises(NotImplementedError, match="L <= 1024"):
        attention_sublayer_fwd(x, mask, *attn, 4)
    ffn = [torch.zeros(*s, device=cuda)
           for s in ((128,), (128,), (128, 2048), (2048,), (2048, 128),
                     (128,))]
    with pytest.raises(NotImplementedError, match="d_ff <= 1024"):
        ffn_sublayer_fwd(x[:, :8].contiguous(), *ffn)
    with pytest.raises(NotImplementedError, match="dropout"):
        attention_sublayer_fwd(x[:, :8].contiguous(), mask[:, :8].contiguous(),
                               *attn, 4, p_drop=0.1)
