"""Shared transformer building blocks, as plain functions on tensors.

Counterpart of ``multimodal_audio_search_tpu/models/layers.py``. Params
are the JAX package's pytree with torch tensors as leaves, under the same
keys: dense W is [in, out] (``models/convert.py`` layout), so a dense
layer is ``b + x @ W``.

Matmuls run in the model dtype (bf16 on the card) with float32
accumulation inside the BLAS call; layer norm and softmax run in float32.
"""
from __future__ import annotations

import math

import torch


def dense(params, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b in x's dtype. On the card the bias lands in the GEMM
    epilogue before the single rounding to bf16, as the JAX layer adds it
    in float32 before its cast. An int8-quantized leaf (``"wq"``,
    ops/quant.py) goes through K5."""
    if "wq" in params:
        from ..ops.quant import quant_dense_apply
        return quant_dense_apply(params, x)
    w = params["w"]
    x2 = x.reshape(-1, x.shape[-1])
    if "b" in params:
        y = torch.addmm(params["b"].to(x.dtype), x2, w)
    else:
        y = torch.mm(x2, w)
    return y.reshape(*x.shape[:-1], w.shape[1])


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, evaluated in float32."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, T, H] -> [B, heads, T, H/heads] (a view, no copy)."""
    b, t, h = x.shape
    return x.reshape(b, t, n_heads, h // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, heads, T, D] -> [B, T, heads*D]"""
    b, n, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, n * d)


def attention_scores(q, k, v, bias=None) -> torch.Tensor:
    """Softmax attention with f32 logits. q,k,v: [B, heads, T, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def mha(params, x_q, x_kv, n_heads: int, bias=None) -> torch.Tensor:
    """Projected multi-head attention (self or cross)."""
    q = split_heads(dense(params["q"], x_q), n_heads)
    k = split_heads(dense(params["k"], x_kv), n_heads)
    v = split_heads(dense(params["v"], x_kv), n_heads)
    out = merge_heads(attention_scores(q, k, v, bias))
    return dense(params["o"], out)


def dense_partial(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ W in float32 without a bias: a row-parallel layer's share on
    one rank of the mesh's model axis (W its rows of the layer's weight),
    x's values multiplied and summed in float32 (TF32 off on the card).
    The ranks' shares meet in parallel/mesh.py::model_sum, which adds the
    bias once."""
    return torch.matmul(x.float(), w.float())


def mha_partial(params, x_q, x_kv, n_heads: int, bias=None) -> torch.Tensor:
    """One rank's share of ``mha`` on the mesh's model axis: ``params``
    holds its head shard (q/k/v columns and biases of ``n_heads`` heads,
    the matching rows of o), ``bias`` the additive bias of those heads
    (or one that broadcasts over them); returns the float32 partial
    o-projection, without o's bias (dense_partial)."""
    q = split_heads(dense(params["q"], x_q), n_heads)
    k = split_heads(dense(params["k"], x_kv), n_heads)
    v = split_heads(dense(params["v"], x_kv), n_heads)
    out = merge_heads(attention_scores(q, k, v, bias))
    return dense_partial(params["o"]["w"], out)


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] {0,1} key mask -> additive [B, 1, 1, T] bias."""
    return (1.0 - mask.float())[:, None, None, :] * -1e9


def causal_bias(t_q: int, t_k: int, offset: int = 0,
                device=None) -> torch.Tensor:
    """Additive [1, 1, t_q, t_k] float32 causal mask; query i attends keys
    <= i + offset (offset = number of cached positions)."""
    qi = torch.arange(t_q, device=device)[:, None] + offset
    ki = torch.arange(t_k, device=device)[None, :]
    return torch.where(ki <= qi, 0.0, -1e9)[None, None]


# ------------------------------------------------------------------ init
def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               bias: bool = True, std: float = 0.02):
    p = {"w": torch.randn(d_in, d_out, generator=gen) * std}
    if bias:
        p["b"] = torch.zeros(d_out)
    return p


def init_layer_norm(d: int):
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def init_mha(gen: torch.Generator, d_model: int, bias: bool = True,
             k_bias: bool = True):
    return {
        "q": init_dense(gen, d_model, d_model, bias),
        "k": init_dense(gen, d_model, d_model, k_bias),
        "v": init_dense(gen, d_model, d_model, bias),
        "o": init_dense(gen, d_model, d_model, bias),
    }


def cast_floats(tree, dtype: torch.dtype, device: torch.device):
    """Move a param tree to ``device``, casting floating leaves to
    ``dtype``. Leaves keyed 'scale' (layer-norm scales and the int8
    weights' per-column scales) stay float32, as the JAX package's
    cast_floats keeps them; integer leaves (int8 weights) keep their
    dtype."""
    def f(x, key):
        if isinstance(x, dict):
            return {k: f(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(f(v, None) for v in x)
        if torch.is_tensor(x):
            if x.is_floating_point() and key != "scale":
                return x.to(device=device, dtype=dtype)
            return x.to(device=device)
        return x
    return f(tree, None)
