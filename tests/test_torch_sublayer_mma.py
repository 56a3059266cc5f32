"""B1's three routes of kernels (allrank_tpu_torch/ops/attention_block.py):
the pure-Python choice between the tensor-core kernels in bf16
(csrc/attention_block_mma.cu) and in fp32 as 3xTF32 split products
(csrc/attention_block_tf32x3.cu), both for d_k <= 128, and the SIMT kernels
(csrc/attention_block.cu: wider heads in either dtype), made from
dtype, d and h alone before any launch; and the plain bf16 forward and
backward, which the card holds both routes to, against the JAX package's
TPU kernel in Pallas interpret mode at the shapes the tensor-core
instantiations take there: one head width in each padded class (d_k 32,
48 -> 64, 100 -> 128), a full, a ragged and a fully padded slate.

On the CPU the wrappers take the plain versions; tests/test_torch_gpu.py
holds every tensor-core instantiation against them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from allrank_tpu.ops.attention_block import attention_sublayer
from allrank_tpu_torch.ops.attention_block import (
    MMA_MAX_HEAD,
    attention_sublayer_bwd,
    attention_sublayer_fwd,
    route,
)

torch.set_num_threads(2)

BF16 = torch.bfloat16
GRADS = ("dx", "dg", "db", "dwqkv", "dbqkv", "dwout", "dbout")


# ----------------------------------------------------------------------------
# the route


@pytest.mark.parametrize("d,h", [(128, 4), (144, 2), (96, 1)])
def test_paper_widths_take_the_tensor_cores_in_bf16(d, h):
    assert route(BF16, d, h) == "mma"
    assert route(torch.float32, d, h) == "tf32x3"


# d_k 8, 20, 32 (padded to 32), 36, 48 (to 64), 72, 100, 128 (to 128)
@pytest.mark.parametrize("d,h", [(32, 4), (80, 4), (128, 4), (144, 4),
                                 (96, 2), (144, 2), (100, 1), (256, 2)])
def test_each_padded_head_class_takes_the_tensor_cores(d, h):
    assert d // h <= MMA_MAX_HEAD
    assert route(BF16, d, h) == "mma"


@pytest.mark.parametrize("d,h", [(256, 1), (129, 1), (240, 1)])
def test_heads_wider_than_128_stay_on_the_simt_kernels(d, h):
    assert d // h > MMA_MAX_HEAD
    assert route(BF16, d, h) == "simt"
    assert route(torch.float32, d, h) == "simt"


@pytest.mark.parametrize("d,h", [(1, 1), (128, 4), (256, 2)])
def test_fp32_takes_the_tensor_cores_as_3xtf32(d, h):
    """fp32 keeps its parity on the tensor cores as 3xTF32 split products
    (three TF32 products an fp32 one), never as plain TF32."""
    assert route(torch.float32, d, h) == "tf32x3"


@pytest.mark.parametrize("dtype,d,h,match", [
    (torch.float16, 128, 4, "float32 or bfloat16"),
    (torch.float64, 128, 4, "float32 or bfloat16"),
    (BF16, 257, 1, "d_model <= 256"),
    (BF16, 0, 1, "d_model <= 256"),
    (BF16, 130, 4, "multiple of h"),
    (torch.float32, 96, 0, "multiple of h"),
])
def test_outside_the_envelope_raises_before_any_launch(dtype, d, h, match):
    with pytest.raises(NotImplementedError, match=match):
        route(dtype, d, h)


def test_the_route_reads_no_tensor_and_counts_nothing():
    """The choice is a function of (dtype, d, h): the same answer every
    time, and no launch counted for asking."""
    fwd = dict(attention_sublayer_fwd.route_launches)
    bwd = dict(attention_sublayer_bwd.route_launches)
    answers = {route(BF16, 128, 4) for _ in range(3)}
    assert answers == {"mma"}
    assert attention_sublayer_fwd.route_launches == fwd
    assert attention_sublayer_bwd.route_launches == bwd
    assert set(fwd) == set(bwd) == {"mma", "tf32x3", "simt"}


# ----------------------------------------------------------------------------
# the plain bf16 versions against the TPU kernel, at the new instantiations'
# shapes


def _inputs(d, l, seed):
    rng = np.random.RandomState(seed)
    lengths = np.array([l, max(1, l // 3), 0])  # full, ragged, fully padded
    x = rng.randn(3, l, d).astype(np.float32)
    dy = rng.randn(3, l, d).astype(np.float32)
    mask = np.arange(l)[None, :] >= lengths[:, None]
    params = [(1.0 + 0.1 * rng.randn(d)).astype(np.float32),
              (0.1 * rng.randn(d)).astype(np.float32),
              (rng.randn(d, 3 * d) / np.sqrt(d)).astype(np.float32),
              (0.1 * rng.randn(3 * d)).astype(np.float32),
              (rng.randn(d, d) / np.sqrt(d)).astype(np.float32),
              (0.1 * rng.randn(d)).astype(np.float32)]
    return x, dy, mask, params


# (d, h, L): d_k 32 (class 32), 48 (class 64), 100 (class 128, rows off a
# 16-byte boundary on the card)
SHAPES = [(64, 2, 65), (48, 1, 70), (100, 1, 37)]


@pytest.mark.parametrize("d,h,l", SHAPES)
def test_bf16_forward_plain_matches_tpu_kernel(d, h, l):
    """The same rounding points as the TPU kernel (LN output, qkv, the
    dropped P, ctx): at most one or two bf16 ulps where an fp32 sum lands on
    the other side of a rounding edge, 2^-6 relative and absolute (phase 2's
    kernel tolerance)."""
    x, _, mask, params = _inputs(d, l, seed=d + l)
    with pltpu.force_tpu_interpret_mode():
        ref = attention_sublayer(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(mask), *map(jnp.asarray, params),
                                 jnp.zeros(2, jnp.int32), h, 0.0, 0.0)
    got = attention_sublayer_fwd(torch.tensor(x).to(BF16),
                                 torch.tensor(mask),
                                 *map(torch.tensor, params), h)
    assert got.dtype == BF16 and got.shape == (3, l, d)
    assert torch.isfinite(got.float()).all()  # the padded slate too
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -6, atol=2 ** -6)


@pytest.mark.parametrize("d,h,l", SHAPES)
def test_bf16_backward_plain_matches_tpu_kernel_vjp(d, h, l):
    """Each gradient within 2^-5 of its largest value (phase 7's kernel
    tolerance): the same rounding points (da, dO, dS, dqkv), where an fp32
    sum on the other side of a rounding edge moves one bf16 intermediate by
    an ulp and every weight gradient summed over it a little."""
    x, dy, mask, params = _inputs(d, l, seed=2 * d + l)

    def f(x, *p):
        return attention_sublayer(x, jnp.asarray(mask), *p,
                                  jnp.zeros(2, jnp.int32), h, 0.0, 0.0)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(x, jnp.bfloat16),
                         *map(jnp.asarray, params))
        ref = vjp(jnp.asarray(dy, jnp.bfloat16))
    got = attention_sublayer_bwd(torch.tensor(x).to(BF16), torch.tensor(mask),
                                 *map(torch.tensor, params),
                                 torch.tensor(dy).to(BF16), h)
    assert got[0].dtype == BF16
    for name, g, r in zip(GRADS, got, ref):
        g = g.float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        assert g.shape == r.shape, name
        assert np.isfinite(g).all(), name
        scale = float(np.abs(r).max())
        err = float(np.abs(g - r).max())
        assert err <= 2 ** -5 * scale + 1e-6, (name, err, scale)


# ----------------------------------------------------------------------------
# the timing tool and the build's A/B hook


def test_time_sublayers_measures_nothing_without_a_card(monkeypatch, capsys):
    from allrank_tpu_torch.tools import time_sublayers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert time_sublayers.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("h", [1, 4])
def test_the_library_yardstick_computes_b1s_function(h):
    """The yardstick the tool times beside B1 (std-LN, matmul, SDPA) is the
    sublayer's function: at dropout 0 in fp32 it agrees with the plain
    version on slates with a valid document."""
    from allrank_tpu_torch.tools.time_sublayers import b1_library
    from allrank_tpu_torch.ops.attention_block import (
        attention_sublayer_fwd_plain,
    )

    x, _, mask, params = _inputs(32, 9, seed=h)
    mask[2, 0] = False  # one valid document: SDPA's mask then agrees
    xt, mt = torch.tensor(x), torch.tensor(mask)
    pt = list(map(torch.tensor, params))
    mask_add = torch.zeros(3, 1, 1, 9).masked_fill(mt[:, None, None, :], -1e9)
    torch.testing.assert_close(b1_library(xt, mask_add, *pt, h),
                               attention_sublayer_fwd_plain(xt, mt, *pt, h),
                               rtol=1e-4, atol=1e-5)



def test_busy_time_counts_overlapping_spans_once():
    """The device's busy time in a trace (``time_sublayers --step``, chip
    smoke's profiles): the union of the kernels' spans."""
    from allrank_tpu_torch.tools.timing import busy_us

    spans = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0),
             ("d", 21.0, 22.0)]
    assert busy_us(spans) == 17.0
    assert busy_us(spans[::-1]) == 17.0  # in any order


def test_device_spans_leave_out_annotated_ranges():
    """A trace's device spans (``timing.device_spans``, which every busy
    time and kernel table reads) hold its kernels and copies, not the
    ranges ``record_function`` marks on the device's timeline, such as
    the optimizer's step, nor the lead kernels nor host events."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import FunctionEvent

    from allrank_tpu_torch.tools.timing import LEAD_KERNEL_NAME, device_spans

    def event(i, name, start, end, device, annotation=False):
        return FunctionEvent(i, name, 0, start, end, device_type=device,
                             is_user_annotation=annotation)

    events = [
        event(0, "b2_fwd_kernel", 0.0, 4.0, DeviceType.CUDA),
        event(1, "Optimizer.step#Adam.step", 5.0, 60.0, DeviceType.CUDA,
              annotation=True),
        event(2, "Memcpy HtoD", 6.0, 7.0, DeviceType.CUDA),
        event(3, f"at::cuda::{LEAD_KERNEL_NAME}_kernel", 8.0, 9.0,
              DeviceType.CUDA),
        event(4, "aten::mm", 0.0, 3.0, DeviceType.CPU),
        event(5, "ProfilerStep#1", 0.0, 70.0, DeviceType.CPU,
              annotation=True),
    ]
    assert device_spans(events) == [("b2_fwd_kernel", 0.0, 4.0),
                                    ("Memcpy HtoD", 6.0, 7.0)]


@pytest.mark.parametrize("spans, complete", [
    ([("a", 0, 1), ("b", 1, 2)] * 3, True),
    ([("a", 0, 1), ("b", 1, 2)] * 3 + [("c", 2, 3)], False),  # another
    ([("a", 0, 1), ("b", 1, 2)] * 2 + [("a", 0, 1)], False),  # lost one
    ([("b", 1, 2), ("a", 0, 1)] * 3, True),  # in any order
    ([], False),
])
def test_a_trace_that_lost_kernels_is_incomplete(spans, complete):
    """A trace of 3 calls is complete when it holds each kernel of a trace
    of one call 3 times as often and no other (``timing.trace_complete``):
    the profiler has lost some or all of a trace's device events."""
    from allrank_tpu_torch.tools.timing import trace_complete

    one_call = [("a", 0, 1), ("b", 1, 2)]
    assert trace_complete(spans, one_call, 3) is complete
    assert not trace_complete(spans, [], 3)  # one call's trace lost all


def test_trace_kernels_takes_a_lossy_trace_again(monkeypatch):
    """``timing.trace_kernels`` takes a trace that lost events again, and
    raises ``IncompleteTrace`` when every attempt lost some, so that a lost
    kernel cannot read as a low time."""
    from allrank_tpu_torch.tools import timing

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    one = [("k", 0.0, 1.0)]
    traces = iter([(one, 1.0), (one, 2.0), (one, 1.0), (one * 2, 2.0)])
    monkeypatch.setattr(timing, "_trace", lambda fn, calls: next(traces))
    monkeypatch.setattr(timing.trace_kernels, "lost", 0)
    assert timing.trace_kernels(lambda: None, 2) == (one * 2, 2.0)
    assert timing.trace_kernels.lost == 1
    monkeypatch.setattr(timing, "_trace", lambda fn, calls: (one, 1.0))
    with pytest.raises(timing.IncompleteTrace):
        timing.trace_kernels(lambda: None, 2)
    assert timing.trace_kernels.lost == 1 + timing.TRACE_ATTEMPTS


def test_the_step_tool_builds_bench_configs_step():
    """``time_sublayers --step``'s step: bench.py's configuration (the
    flagship model, bf16, lambdaLoss) takes a step with a finite loss over
    all 64 slates; on the CPU it runs the plain versions."""
    from allrank_tpu_torch.tools.time_sublayers import B, L, flagship_step

    step, (x, y, indices) = flagship_step(torch.device("cpu"))
    assert x.shape == (B, L, 136) and (indices[:, -40:] == -1).all()
    loss, n_real = step(x, y, indices)
    assert torch.isfinite(loss) and n_real.item() == B
