"""Post-training int8 quantization for serving (w8a8): the JAX package's
``quant.py`` in PyTorch, over the int8 dense kernel X1 (``ops/q8_dense``).

Weights: symmetric per-output-channel int8, ``w_q = round(w / s)`` with
``s = max_i |w[i, :]| / 127``, quantized once by ``quantize_model``. Each
dense layer of the tower (FC layers, the fused QKV, the attention
out-projection, FFN up and down, the head) then runs int8 x int8 -> int32
with its activation quantized on the fly, in one of two modes:

- dynamic (``quantize_model(model)``): a per-row absmax scale per call;
- static (``quantize_model(model, act_scales)``, from
  ``calibrate_activations``): one activation scale per site, or per input
  channel where the calibrated spread (max / median) exceeds
  ``PER_CHANNEL_SPREAD_THRESHOLD``, in which case the channel scales migrate
  into the weights before they are quantized (SmoothQuant-style).

LayerNorms, positional encodings, residuals, activations and the attention
core stay in float. The attention core follows the JAX package's device
split (its ``_q_attention`` and ``models/transformer.py:364-365``: the
fused bf16 kernel on the accelerator, the XLA chain elsewhere): on the GPU q,
k and v go in bf16 through the bare attention kernels at dropout 0, B4
(``ops/attention_fused``) to L = 1224 and B5 (``ops/attention_tiled``) to
8192, and beyond 8192 the tower raises ``NotImplementedError`` before any
launch; on the CPU it runs the plain chain (einsum, mask, softmax, einsum)
in the flow's dtype.

``QuantizedLTRModel`` names its state as the JAX ``qparams`` tree
(``transformer.layers.0.qkv.w_q`` for ``transformer|layers|0|qkv|w_q``), so
``interop.export_params`` compares with ``interop.flatten_params`` leaf by
leaf. Eval only: training keeps full precision.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from allrank_tpu_torch.constants import NEG_INF_FILL, PADDED_Y_VALUE
from allrank_tpu_torch.models.core import (
    get_activation,
    layer_norm,
    std_layer_norm,
)
from allrank_tpu_torch.models.factory import LTRModel, LTRModelDef, as_dtype
from allrank_tpu_torch.models.positional import positional_apply
from allrank_tpu_torch.models.transformer import (
    FUSED_ATTENTION_MAX_LEN,
    TILED_ATTENTION_MAX_LEN,
)
from allrank_tpu_torch.ops.attention_fused import attention_fused_fwd
from allrank_tpu_torch.ops.attention_tiled import tiled_attention_fwd
from allrank_tpu_torch.ops.q8_dense import QMAX, TINY, q8_dense

# a calibrated site whose per-channel absmax spread (max / median) is at
# most this collapses to one per-tensor scale (the JAX package's value)
PER_CHANNEL_SPREAD_THRESHOLD = 4.0


def quantize_dense(w: torch.Tensor, b: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8 of one dense layer ``w [d_in,
    d_out]``: ``{"w_q": int8, "w_scale": [d_out] f32, "b": f32}``, on the
    CPU (a CUDA division by a Python number multiplies by its reciprocal;
    here every quotient is IEEE, as in the JAX package)."""
    w = w.detach().float().cpu()
    s = torch.clamp_min(w.abs().amax(dim=0), TINY) / QMAX
    w_q = torch.clamp(torch.round(w / s), -QMAX, QMAX).to(torch.int8)
    return {"w_q": w_q, "w_scale": s, "b": b.detach().float().cpu().clone()}


def q_dense_apply(qp: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` through int8 (``quant.q_dense_apply`` there): static
    when ``qp`` has ``x_inv_scale`` (output in x's dtype), else dynamic
    (output fp32); ``qp["w_q"]`` in the JAX layout [d_in, d_out]."""
    return QuantizedDense(qp).to(x.device)(x)


def _static_dense(site: str, w: torch.Tensor, b: torch.Tensor,
                  act_scales: dict) -> dict:
    """One dense layer with its calibrated static activation scale."""
    if site not in act_scales:
        raise KeyError(
            f"calibration has no activation scale for site '{site}' "
            f"(have: {sorted(act_scales)}) — calibrate with the same "
            "model definition")
    cal = np.asarray(act_scales[site], dtype=np.float32)
    w = w.detach().float().cpu()
    if cal.ndim == 1 and cal.shape[0] != w.shape[0]:
        raise ValueError(
            f"calibration for site '{site}' has {cal.shape[0]} channels "
            f"but the weight expects {w.shape[0]} — act_scales.json from "
            "a different model definition?")
    if cal.ndim == 1:
        # np.median averages the two middle channels (torch.median would
        # take the lower one and move the collapse decision)
        spread = float(cal.max() / max(float(np.median(cal)), TINY))
        if spread <= PER_CHANNEL_SPREAD_THRESHOLD:
            cal = cal.max()  # uniform channels: per-tensor is free
    if cal.ndim == 0:
        # the scalar in float64, as Python computes it there; out_scale
        # rounds s_x to fp32 first (JAX's weak typing)
        s_x = max(float(cal), TINY) / QMAX
        qp = quantize_dense(w, b)
        qp["x_inv_scale"] = torch.tensor(np.float32(1.0 / s_x))
        qp["out_scale"] = torch.tensor(np.float32(s_x)) * qp["w_scale"]
        return qp
    # per-channel scale migration: divide each input channel by its
    # calibrated absmax and fold the factor into the weights before they
    # are quantized; x / s_chan has channel max 1, so s_x = 1 / 127
    s_chan = torch.clamp_min(torch.as_tensor(cal), TINY)
    w_mig = w * s_chan[:, None]
    s_w = torch.clamp_min(w_mig.abs().amax(dim=0), TINY) / QMAX
    w_q = torch.clamp(torch.round(w_mig / s_w), -QMAX, QMAX).to(torch.int8)
    # a tensor numerator: torch divides a Python number by a tensor as a
    # multiply by the reciprocal
    return {"w_q": w_q, "w_scale": s_w, "b": b.detach().float().cpu().clone(),
            "x_inv_scale": torch.tensor(QMAX) / s_chan,
            "out_scale": s_w / QMAX}


class QuantizedDense(nn.Module):
    """One int8 dense layer: buffers ``w_q`` [d_in, d_out] int8 (the JAX
    layout), ``w_scale``, ``b`` and, in the static mode, ``x_inv_scale``
    and ``out_scale``. ``w_q`` is stored column-major, so ``w_q.t()`` is
    the kernel's contiguous [d_out, d_in] without a second copy (``.to``
    keeps the strides)."""

    def __init__(self, qp: dict):
        super().__init__()
        for name in ("w_scale", "b", "x_inv_scale", "out_scale"):
            if name in qp:
                self.register_buffer(name, qp[name])
        self.register_buffer("w_q", qp["w_q"].t().contiguous().t())
        self.static = "x_inv_scale" in qp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.static:
            return q8_dense(x, self.w_q.t(), self.out_scale, self.b,
                            self.x_inv_scale)
        return q8_dense(x, self.w_q.t(), self.w_scale, self.b)


class _Buffers(nn.Module):
    """Float parameters carried across as buffers (a LayerNorm's scale and
    bias, a positional table)."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t.detach().clone())


def _attention_core(l: int, device_type: str):
    """The attention core at slate length ``l``: None (the plain chain) on
    the CPU, else B4's or B5's forward; raises beyond B5's envelope."""
    if device_type == "cpu":
        return None
    if l <= FUSED_ATTENTION_MAX_LEN:
        return attention_fused_fwd
    if l <= TILED_ATTENTION_MAX_LEN:
        return tiled_attention_fwd
    raise NotImplementedError(
        f"the quantized tower covers slates of L <= {TILED_ATTENTION_MAX_LEN}"
        f" on the GPU (the tiled attention kernel's envelope), got L={l}")


def _attention(blk, h: int, x, key_mask, dense, site: str, core):
    """Eval-mode multi-head attention with quantized QKV and out
    projections (``_q_attention`` there)."""
    b, l, d = x.shape
    dk = d // h
    qkv = dense(site + "/qkv", blk.qkv, x)
    q, k, v = (t.reshape(b, l, h, dk) for t in qkv.split(d, dim=-1))
    if core is not None:
        ctx = core(*(t.to(torch.bfloat16).transpose(1, 2).contiguous()
                     for t in (q, k, v)), key_mask)
        ctx = ctx.transpose(1, 2).reshape(b, l, d).to(x.dtype)
        return dense(site + "/out", blk.out, ctx)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)
    scores = scores.masked_fill(key_mask[:, None, None, :], NEG_INF_FILL)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, d)
    return dense(site + "/out", blk.out, ctx)


def _tower(m: nn.Module, mdef: LTRModelDef, x, mask, indices, dense,
           compute_dtype) -> torch.Tensor:
    """The eval-mode model over ``m``'s layers (an ``LTRModel`` or a
    ``QuantizedLTRModel``: the same attribute names) with every dense
    layer run as ``dense(site, layer, x)`` (``quantized_forward`` there);
    ``compute_dtype`` is the flow between the dense layers; the head's input
    is fp32."""
    core = None
    if mdef.transformer:
        core = _attention_core(x.shape[1], x.device.type)
    x = x.to(compute_dtype)
    if mdef.fc:
        if mdef.fc.input_norm:
            x = layer_norm(x, m.fc.input_norm.scale, m.fc.input_norm.bias)
        act = get_activation(mdef.fc.activation)
        for i, layer in enumerate(m.fc.layers):
            x = act(dense(f"fc/{i}", layer, x))
    if mdef.transformer:
        enc = m.transformer
        if enc.pe is not None:
            x = positional_apply(enc.pe.table, x, mask, indices)
        for i, blk in enumerate(enc.layers):
            normed = std_layer_norm(x, blk.ln1.scale, blk.ln1.bias)
            x = x + _attention(blk, mdef.transformer.h, normed, mask, dense,
                               f"t{i}", core)
            normed = std_layer_norm(x, blk.ln2.scale, blk.ln2.bias)
            x = x + dense(f"t{i}/ff2", blk.ff2,
                          torch.relu(dense(f"t{i}/ff1", blk.ff1, normed)))
        x = std_layer_norm(x, enc.final_ln.scale, enc.final_ln.bias)
    out = dense("output", m.output, x.float())
    if mdef.output.d_output == 1:
        out = out.squeeze(2)
    return get_activation(mdef.output.output_activation)(out)


def _run_quantized(site, layer, x):
    return layer(x)


class QuantizedLTRModel(nn.Module):
    """The int8 serving tower of an ``LTRModel`` (``quantize_model``), or,
    by ``from_state_dict``, of its stored quantized tensors."""

    def __init__(self, model: LTRModel, act_scales: Optional[dict] = None):
        super().__init__()

        def dense(site: str, path: str) -> dict:
            layer = model.get_submodule(path)
            if act_scales is None:
                return quantize_dense(layer.w, layer.b)
            return _static_dense(site, layer.w, layer.b, act_scales)

        self._assemble(model.mdef, dense,
                       lambda path: model.get_submodule(path).state_dict())

    @classmethod
    def from_state_dict(cls, mdef: LTRModelDef,
                        state: Dict[str, torch.Tensor]
                        ) -> "QuantizedLTRModel":
        """The tower of ``mdef`` over ``state``, a ``state_dict()`` of such
        a tower (int8 weights, their scales, the float rest), on the CPU;
        a missing, extra or mis-shaped tensor raises."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)

        def under(path: str) -> dict:
            return {k[len(path) + 1:]: torch.as_tensor(v).clone()
                    for k, v in state.items() if k.startswith(path + ".")}

        def dense(site: str, path: str) -> dict:
            qp = under(path)
            for name in ("w_q", "w_scale", "b"):
                if name not in qp:
                    raise KeyError(f"stored quantized tensors lack "
                                   f"'{path}.{name}'")
            return qp

        self._assemble(mdef, dense, under)
        want = {k: tuple(t.shape) for k, t in self.state_dict().items()}
        got = {k: tuple(np.shape(v)) for k, v in state.items()}
        if want != got:
            differ = sorted(k for k in set(want) & set(got)
                            if want[k] != got[k])
            raise ValueError(
                f"stored quantized tensors do not match the model: missing "
                f"{sorted(set(want) - set(got))}, unexpected "
                f"{sorted(set(got) - set(want))}, shapes differ at {differ}")
        return self

    def _assemble(self, mdef: LTRModelDef, dense, tensors) -> None:
        """The tower's modules: ``dense(site, path)`` gives the quantized
        layer at module path ``path`` as ``QuantizedDense`` takes it,
        ``tensors(path)`` the float tensors of a LayerNorm or a positional
        table there."""
        self.mdef = mdef

        def norm(path: str) -> _Buffers:
            return _Buffers(**tensors(path))

        self.fc = self.transformer = None
        if mdef.fc:
            self.fc = nn.Module()
            self.fc.layers = nn.ModuleList(
                [QuantizedDense(dense(f"fc/{i}", f"fc.layers.{i}"))
                 for i in range(len(mdef.fc.sizes))])
            self.fc.input_norm = (norm("fc.input_norm")
                                  if mdef.fc.input_norm else None)
        if mdef.transformer:
            self.transformer = nn.Module()
            blocks = nn.ModuleList()
            for i in range(mdef.transformer.N):
                qblk = nn.Module()
                path = f"transformer.layers.{i}"
                for name in ("qkv", "out", "ff1", "ff2"):
                    setattr(qblk, name, QuantizedDense(
                        dense(f"t{i}/{name}", f"{path}.{name}")))
                qblk.ln1, qblk.ln2 = norm(f"{path}.ln1"), norm(f"{path}.ln2")
                blocks.append(qblk)
            self.transformer.layers = blocks
            self.transformer.final_ln = norm("transformer.final_ln")
            self.transformer.pe = (
                norm("transformer.pe")
                if mdef.transformer.positional_encoding else None)
        self.output = QuantizedDense(dense("output", "output"))

    def forward(self, x, mask, indices, compute_dtype=torch.float32):
        """[B, L, F] -> [B, L, d_output], squeezed to [B, L] when d_output
        == 1 (``quantized_forward`` there); ``compute_dtype`` is the flow
        between the int8 layers."""
        return _tower(self, self.mdef, x, mask, indices, _run_quantized,
                      as_dtype(compute_dtype))

    def score(self, x, mask, indices, compute_dtype=torch.float32):
        """Per-document scores [B, L]; multi-output heads sum over d_output
        (``quantized_score`` there)."""
        out = self.forward(x, mask, indices, compute_dtype)
        if self.mdef.output.d_output > 1:
            out = out.sum(dim=-1)
        return out


def quantize_model(model: LTRModel, act_scales: Optional[dict] = None
                   ) -> QuantizedLTRModel:
    """The int8 tower of ``model``, on its device: dynamic activation scales,
    or static ones from ``act_scales`` (``{site: [absmax per input channel]}``
    or a legacy ``{site: absmax}``, as ``calibrate_activations`` returns).
    The weights are quantized on the CPU and then moved."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        return QuantizedLTRModel(model, act_scales).to(dev)


def calibrate_activations(model: LTRModel, batches: Iterable) -> Dict:
    """The static activation scales: runs ``(x [B, L, F], lengths [B])``
    batches through the fp32 tower of ``model`` on its device (dense layers
    as a plain fp32 ``torch.matmul`` on the float weights, the attention
    core on the device split above) and records each site's running
    per-input-channel absmax. Returns ``{site: [float]}``, JSON that either
    package loads. Serve-time semantics: padding from ``lengths``, rank
    index 1, eval mode."""
    dev = next(model.parameters()).device
    out: Dict[str, np.ndarray] = {}
    for x, lengths in batches:
        cap: Dict[str, torch.Tensor] = {}

        def capture(site, layer, xin):
            xin = xin.float()
            chan = xin.abs().amax(dim=tuple(range(xin.dim() - 1)))
            cap[site] = (torch.maximum(cap[site], chan) if site in cap
                         else chan)
            return xin @ layer.w + layer.b

        with torch.inference_mode():
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
            lengths = torch.as_tensor(lengths, device=dev).long()
            mask = (torch.arange(x.shape[1], device=dev)[None, :]
                    >= lengths[:, None])
            indices = torch.ones(x.shape[:2], dtype=torch.long, device=dev)
            _tower(model, model.mdef, x, mask, indices, capture,
                   torch.float32)
        for site, chan in cap.items():
            vec = chan.cpu().numpy().astype(np.float64)
            out[site] = vec if site not in out else np.maximum(out[site], vec)
    return {site: [float(v) for v in vec] for site, vec in out.items()}


def calibration_batches_from_dataset(ds, slate_length: int,
                                     batch_size: int = 64,
                                     n_batches: int = 8):
    """The first ``n_batches`` serve-style ``(x, lengths)`` batches of a
    ``SlateDataset`` in its own order: the bridge from the data layer to
    ``calibrate_activations`` for the evaluate and serve CLIs. Batch-padding
    slates (no real document) get length 1, as serving never sees 0."""
    from allrank_tpu_torch.data.batching import SlateBatcher

    out = []
    for batch in SlateBatcher(ds, slate_length, batch_size, shuffle=False):
        lengths = (batch.y != PADDED_Y_VALUE).sum(axis=1).astype("int32")
        out.append((batch.x, lengths.clip(min=1)))
        if len(out) >= n_batches:
            break
    return out


def quantized_bytes(qmodel: QuantizedLTRModel) -> int:
    """Bytes of the quantized state (int8 weights and the fp32 rest), the
    JAX ``qparams`` tree's count and the tower's device memory."""
    return sum(t.numel() * t.element_size()
               for t in qmodel.state_dict().values())
