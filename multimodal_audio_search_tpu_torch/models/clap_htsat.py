"""Weight-parity CLAP towers: HTSAT-Swin audio encoder + RoBERTa text encoder.

Counterpart of ``multimodal_audio_search_tpu/models/clap_htsat.py``:
laion's CLAP architecture (laion/clap-htsat-unfused and -fused) -- a Swin
transformer over a reshaped log-mel image and a RoBERTa text encoder,
each followed by a 2-layer MLP projection -- as plain PyTorch functions
over the JAX package's param tree (same keys; dense W [in, out]; the
conv weights stay OIHW, as the JAX tree keeps them).

The numpy half is copied function for function and held to the
original by ``tests/test_torch_copies.py``: the configs, the bicubic
resize matrix, the static Swin geometry (relative-position index, shift
masks with -100 fill), the HF converters and ``load_from_dir`` (which
return numpy trees; ``weights.htsat_params`` / ``weights.roberta_params``
carry them over).

Device notes:
  * The patch convolution and the fused path's ``mel_conv2d`` run as an
    im2col (``F.unfold``) plus one matmul, so they are float32 on the
    card whatever cuDNN's TF32 setting (a float32 matmul is not TF32 by
    default in PyTorch); the 1x1 convolutions of the AFF block are
    channel matmuls, as in JAX.
  * Window partition/merge are reshapes and permutes; the (shifted)
    window attention of a block is one batched matmul over every window.
    ``torch.roll`` moves the map in the direction ``jnp.roll`` does.
  * The static tables (bicubic matrices, relative-position index, shift
    masks) are made once per shape and device and cached.
  * The fused path computes both the global and the AFF branch for every
    row and selects per row by ``is_longer``, as the JAX ``jnp.where``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from . import layers as L


# --------------------------------------------------------------------- config
@dataclass(frozen=True)
class HTSATConfig:
    """Mirrors transformers.ClapAudioConfig (unfused) — defaults are laion's."""
    num_mel_bins: int = 64
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: tuple = (4, 4)
    patch_embed_dim: int = 96          # patch_embeds_hidden_size
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    hidden_size: int = 768             # = patch_embed_dim * 2**(n_stages-1)
    projection_dim: int = 512
    ln_eps: float = 1e-5
    bn_eps: float = 1e-5
    # laion/clap-htsat-fused: 4-channel inputs + AFF fusion in patch embed
    enable_fusion: bool = False
    aff_block_r: int = 4

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins

    @property
    def grid_size(self) -> tuple:
        return (self.spec_size // self.patch_stride[0],
                self.spec_size // self.patch_stride[1])


@dataclass(frozen=True)
class RobertaConfig:
    """Mirrors transformers.ClapTextConfig — defaults are laion's."""
    vocab_size: int = 50265
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 514
    type_vocab: int = 1
    pad_token_id: int = 1
    ln_eps: float = 1e-12
    projection_dim: int = 512


# ------------------------------------------------- static bicubic resize math
def _cubic_weights(t: np.ndarray, a: float = -0.75):
    """Cubic-convolution tap weights (torch's A=-0.75), t in [0,1)."""
    def k1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k2(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return np.stack([k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)], axis=-1)


@lru_cache(maxsize=16)
def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] matrix reproducing torch bicubic, align_corners=True.

    Sample i reads source coordinate i*(n_in-1)/(n_out-1); 4 taps at
    floor-1..floor+2, edge-clamped. resize(x) == M @ x along that axis.
    """
    m = np.zeros((n_out, n_in), np.float64)
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    src = np.arange(n_out) * scale
    base = np.floor(src).astype(np.int64)
    w = _cubic_weights(src - base)                      # [n_out, 4]
    for tap in range(4):
        idx = np.clip(base + tap - 1, 0, n_in - 1)
        np.add.at(m, (np.arange(n_out), idx), w[:, tap])
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_table(make, args: tuple, device: str,
                  dtype: torch.dtype) -> torch.Tensor | None:
    """``make(*args)``, one of this module's static numpy tables, on
    ``device`` (a normal tensor even when first asked for under inference
    mode, so a later autograd pass can use it)."""
    table = make(*args)
    if table is None:
        return None
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(table)).to(
            device=device, dtype=dtype)


def reshape_mel2img(x: torch.Tensor, cfg: HTSATConfig) -> torch.Tensor:
    """[B, C, T, F] normalized log-mel -> [B, C, spec, spec] Swin image.

    ClapAudioEncoder.reshape_mel2img: bicubic align-corners stretch of
    time to spec_size*freq_ratio (and freq to spec_size/freq_ratio if
    short), then the freq_ratio fold of time chunks into the frequency
    axis."""
    fr = cfg.freq_ratio
    spec_w = cfg.spec_size * fr
    spec_h = cfg.spec_size // fr
    b, c, t, f = x.shape
    if t > spec_w or f > spec_h:
        raise ValueError(
            f"mel [{t},{f}] exceeds Swin input [{spec_w},{spec_h}]")
    if t < spec_w:
        mt = _device_table(bicubic_matrix, (t, spec_w), str(x.device),
                           x.dtype)
        x = torch.matmul(mt, x)                        # [B, C, spec_w, F]
        t = spec_w
    if f < spec_h:
        mf = _device_table(bicubic_matrix, (f, spec_h), str(x.device),
                           x.dtype)
        x = torch.matmul(x, mf.T)
        f = spec_h
    x = x.reshape(b, c * fr, t // fr, f)
    x = x.transpose(2, 3)
    return x.reshape(b, c, f * fr, t // fr)


# ------------------------------------------------------- static Swin geometry
@lru_cache(maxsize=64)
def _relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] lookup into the (2ws-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]       # [2, N, N]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


@lru_cache(maxsize=64)
def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray | None:
    """Additive [nW, ws*ws, ws*ws] mask for shifted windows (-100 fill)."""
    if shift == 0:
        return None
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C]"""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B*nW, ws*ws, C] -> [B, H, W, C]"""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _swin_block(params, x, hw, n_heads, ws, shift, cfg: HTSATConfig):
    """One Swin layer (modeling_clap.py ClapAudioLayer): LN -> (shifted)
    window MSA with relative-position bias -> residual -> LN -> MLP ->
    residual. The window shrinks to the map where the map is no larger
    than it (no shift then); the map is padded to whole windows."""
    h, w = hw
    if min(h, w) <= ws:                # window covers the map: no shift
        ws, shift = min(h, w), 0
    b, n, c = x.shape
    shortcut = x
    y = L.layer_norm(params["ln1"], x, cfg.ln_eps).reshape(b, h, w, c)

    pad_b = (ws - h % ws) % ws
    pad_r = (ws - w % ws) % ws
    if pad_b or pad_r:
        y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))

    win = _window_partition(y, ws)                     # [B*nW, N, C]
    nwin = win.shape[0] // b
    nq = ws * ws
    q = L.split_heads(L.dense(params["q"], win), n_heads)
    k = L.split_heads(L.dense(params["k"], win), n_heads)
    v = L.split_heads(L.dense(params["v"], win), n_heads)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits / math.sqrt(c // n_heads)
    dev = str(x.device)
    rel_idx = _device_table(_relative_position_index, (ws,), dev,
                            torch.int64)
    rel = params["rel_bias"].float()[rel_idx.reshape(-1)]
    logits = logits + rel.reshape(nq, nq, n_heads).permute(2, 0, 1)[None]
    mask = _device_table(_shift_mask, (hp, wp, ws, shift), dev,
                         torch.float32)
    if mask is not None:
        logits = logits.reshape(b, nwin, n_heads, nq, nq) \
            + mask[None, :, None]
        logits = logits.reshape(b * nwin, n_heads, nq, nq)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = L.merge_heads(torch.matmul(probs.float(), v.float()).to(v.dtype))
    att = L.dense(params["o"], ctx)

    y = _window_reverse(att, ws, hp, wp)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    if pad_b or pad_r:
        y = y[:, :h, :w]
    x = shortcut + y.reshape(b, n, c)

    hmid = L.layer_norm(params["ln2"], x, cfg.ln_eps)
    hmid = L.dense(params["mlp_out"], L.gelu(L.dense(params["mlp_in"], hmid)))
    return x + hmid


def _patch_merge(params, x, hw, cfg: HTSATConfig):
    """[B, H*W, C] -> [B, H/2*W/2, 2C] (ClapAudioPatchMerging)."""
    h, w = hw
    b, _, c = x.shape
    y = x.reshape(b, h, w, c)
    if h % 2 or w % 2:
        y = F.pad(y, (0, 0, 0, w % 2, 0, h % 2))
    y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                   y[:, 0::2, 1::2], y[:, 1::2, 1::2]], dim=-1)
    y = y.reshape(b, -1, 4 * c)
    y = L.layer_norm(params["norm"], y, cfg.ln_eps)
    return L.dense(params["reduction"], y)


# -------------------------------------------------------------- convolutions
def _conv2d(x: torch.Tensor, w: torch.Tensor, stride, pad) -> torch.Tensor:
    """NCHW x OIHW convolution (no bias) as im2col + one matmul in x's
    dtype with float32 accumulation: float32 on the card, not TF32."""
    o, _, kh, kw = w.shape
    n, _, h, wd = x.shape
    cols = F.unfold(x, (kh, kw), padding=pad, stride=stride)  # [N, CKK, P]
    oh = (h + 2 * pad[0] - kh) // stride[0] + 1
    ow = (wd + 2 * pad[1] - kw) // stride[1] + 1
    y = torch.matmul(w.reshape(o, -1).to(x.dtype), cols)      # [N, O, P]
    return y.reshape(n, o, oh, ow)


def _conv1x1(p, x: torch.Tensor) -> torch.Tensor:
    """1x1 Conv2d as a channel matmul. x [B,C,H,W], w [O,C,1,1]."""
    y = torch.einsum("oc,bchw->bohw", p["w"][:, :, 0, 0].to(x.dtype), x)
    return (y.float() + p["b"].float()[None, :, None, None]).to(x.dtype)


def _bn2d(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Inference BatchNorm2d over the channel dim."""
    xf = x.float()
    inv = torch.rsqrt(p["var"].float() + eps)
    y = (xf - p["mean"][None, :, None, None]) \
        * (inv * p["scale"])[None, :, None, None] \
        + p["bias"][None, :, None, None]
    return y.to(x.dtype)


def _aff_fuse(p, hidden: torch.Tensor, residual: torch.Tensor,
              eps: float) -> torch.Tensor:
    """ClapAudioAFFBlock: sigmoid-gated mix of global and local patches."""
    x = hidden + residual

    def att(branch, y):
        y = torch.relu(_bn2d(branch["bn1"], _conv1x1(branch["conv1"], y),
                             eps))
        return _bn2d(branch["bn2"], _conv1x1(branch["conv2"], y), eps)

    gate = torch.sigmoid(
        att(p["local"], x).float()
        + att(p["global"], x.mean(dim=(2, 3), keepdim=True)).float())
    return (2.0 * hidden.float() * gate
            + 2.0 * residual.float() * (1.0 - gate)).to(hidden.dtype)


# ---------------------------------------------------------------- audio tower
def htsat_pooled(params, input_features: torch.Tensor,
                 cfg: HTSATConfig = HTSATConfig(),
                 is_longer=None) -> torch.Tensor:
    """[B, C, T, F] log-mel -> [B, hidden_size] pooled HTSAT features.

    ClapAudioEncoder.forward: per-mel-bin eval BatchNorm, mel->image
    reshape, patch conv + LN, the Swin stages with patch merging, final
    LN, mean pool over the tokens.

    ``enable_fusion`` checkpoints take C=4 (global + 3 crops) and a
    per-row ``is_longer`` bool [B] (tensor or array): longer rows get the
    mel_conv2d local path fused into the global patches by the AFF
    block; short rows use the global channel alone."""
    bn = params["batch_norm"]
    xf = input_features.float()
    inv = torch.rsqrt(bn["var"].float() + cfg.bn_eps)
    x = (xf - bn["mean"]) * inv * bn["scale"] + bn["bias"]
    x = x.to(input_features.dtype)

    x = reshape_mel2img(x, cfg)                        # [B, C, S, S]

    pe = params["patch_embed"]
    ps = (cfg.patch_size, cfg.patch_size)
    pad = ((ps[0] - cfg.patch_stride[0]) // 2,
           (ps[1] - cfg.patch_stride[1]) // 2)
    glob = x[:, 0:1] if cfg.enable_fusion else x
    y = _conv2d(glob, pe["w"], cfg.patch_stride, pad).to(x.dtype)
    y = y + pe["b"].to(x.dtype)[None, :, None, None]
    if cfg.enable_fusion and is_longer is not None:
        f = pe["fusion"]
        bsz, nch, s1, s2 = x.shape
        loc = x[:, 1:].reshape(bsz * (nch - 1), 1, s1, s2)
        loc = _conv2d(loc, f["mel_conv2d"]["w"],
                      (cfg.patch_stride[0], cfg.patch_stride[1] * 3),
                      pad).to(x.dtype)
        loc = loc + f["mel_conv2d"]["b"].to(x.dtype)[None, :, None, None]
        _, cc, lh, lw = loc.shape
        loc = loc.reshape(bsz, nch - 1, cc, lh, lw) \
            .permute(0, 2, 3, 1, 4).reshape(bsz, cc, lh, (nch - 1) * lw)
        loc = F.pad(loc, (0, y.shape[-1] - (nch - 1) * lw))
        fused = _aff_fuse(f, y, loc, cfg.bn_eps)
        longer = torch.as_tensor(is_longer, device=y.device).to(torch.bool)
        y = torch.where(longer.reshape(-1, 1, 1, 1), fused, y)
    x = y
    b, c, gh, gw = x.shape
    x = x.reshape(b, c, gh * gw).transpose(1, 2)       # [B, N, C]
    x = L.layer_norm(pe["norm"], x, cfg.ln_eps)

    hw = cfg.grid_size
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage["blocks"]):
            shift = 0 if bi % 2 == 0 else cfg.window_size // 2
            x = _swin_block(blk, x, hw, cfg.num_heads[si],
                            cfg.window_size, shift, cfg)
        if stage.get("downsample") is not None:
            x = _patch_merge(stage["downsample"], x, hw, cfg)
            hw = ((hw[0] + 1) // 2, (hw[1] + 1) // 2)

    x = L.layer_norm(params["norm"], x, cfg.ln_eps)
    return x.float().mean(dim=1)                       # [B, hidden]


def projection(params, x: torch.Tensor) -> torch.Tensor:
    """ClapProjectionLayer: linear-ReLU-linear."""
    return L.dense(params["linear2"],
                   torch.relu(L.dense(params["linear1"], x)))


def _unit(z: torch.Tensor) -> torch.Tensor:
    z = z.float()
    return z / z.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def audio_embed(params, input_features: torch.Tensor,
                cfg: HTSATConfig = HTSATConfig(),
                is_longer=None) -> torch.Tensor:
    """ClapModel.get_audio_features: pooled -> projection -> L2 norm."""
    return _unit(projection(
        params["proj"], htsat_pooled(params, input_features, cfg,
                                     is_longer)))


# ----------------------------------------------------------------- text tower
def roberta_positions(input_ids: torch.Tensor, mask: torch.Tensor,
                      pad_id: int) -> torch.Tensor:
    """RoBERTa position ids: pad-aware cumsum offset by padding_idx
    (create_position_ids_from_input_ids), from the attention mask."""
    m = mask.to(torch.int64)
    return torch.cumsum(m, dim=1) * m + pad_id


def roberta_pooled(params, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor,
                   cfg: RobertaConfig = RobertaConfig()) -> torch.Tensor:
    """[B, T] -> [B, hidden] tanh-pooled CLS (ClapTextModel + pooler)."""
    emb = params["embeddings"]
    pos = roberta_positions(input_ids, attention_mask, cfg.pad_token_id)
    x = emb["word"][input_ids] + emb["position"][pos] \
        + emb["token_type"][0][None, None]
    x = L.layer_norm(emb["ln"], x, cfg.ln_eps)
    bias = L.padding_bias(attention_mask)
    for blk in params["blocks"]:
        a = L.mha(blk["attn"], x, x, cfg.heads, bias)
        x = L.layer_norm(blk["attn_ln"], x + a, cfg.ln_eps)
        h = L.dense(blk["mlp_out"], L.gelu(L.dense(blk["mlp_in"], x)))
        x = L.layer_norm(blk["mlp_ln"], x + h, cfg.ln_eps)
    return torch.tanh(L.dense(params["pooler"], x[:, 0]).float())


def text_embed(params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               cfg: RobertaConfig = RobertaConfig()) -> torch.Tensor:
    """ClapModel.get_text_features: pooled -> projection -> L2 norm."""
    return _unit(projection(
        params["proj"], roberta_pooled(params, input_ids, attention_mask,
                                       cfg)))


# -------------------------------------------------------------- random init
def _normal(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(*shape, generator=gen) * 0.02


def _bn_init(c: int) -> dict:
    return {"mean": torch.zeros(c), "var": torch.ones(c),
            "scale": torch.ones(c), "bias": torch.zeros(c)}


def init_audio_params(gen: torch.Generator,
                      cfg: HTSATConfig = HTSATConfig()) -> dict:
    """Random init (float32, CPU) with the JAX package's shapes/scales."""
    params: dict = {
        "batch_norm": _bn_init(cfg.num_mel_bins),
        "patch_embed": {
            "w": _normal(gen, cfg.patch_embed_dim, 1, cfg.patch_size,
                         cfg.patch_size),
            "b": torch.zeros(cfg.patch_embed_dim),
            "norm": L.init_layer_norm(cfg.patch_embed_dim),
        },
        "norm": L.init_layer_norm(cfg.hidden_size),
        "proj": {
            "linear1": L.init_dense(gen, cfg.hidden_size,
                                    cfg.projection_dim),
            "linear2": L.init_dense(gen, cfg.projection_dim,
                                    cfg.projection_dim),
        },
        "stages": [],
    }
    if cfg.enable_fusion:
        inter = cfg.patch_embed_dim // cfg.aff_block_r

        def conv1x1_init(cin, cout):
            return {"w": _normal(gen, cout, cin, 1, 1),
                    "b": torch.zeros(cout)}

        def att_init():
            return {"conv1": conv1x1_init(cfg.patch_embed_dim, inter),
                    "bn1": _bn_init(inter),
                    "conv2": conv1x1_init(inter, cfg.patch_embed_dim),
                    "bn2": _bn_init(cfg.patch_embed_dim)}

        params["patch_embed"]["fusion"] = {
            "mel_conv2d": {
                "w": _normal(gen, cfg.patch_embed_dim, 1, cfg.patch_size,
                             cfg.patch_size * 3),
                "b": torch.zeros(cfg.patch_embed_dim)},
            "local": att_init(),
            "global": att_init(),
        }
    n_stages = len(cfg.depths)
    for si in range(n_stages):
        dim = cfg.patch_embed_dim * (2 ** si)
        inter = int(cfg.mlp_ratio * dim)
        blocks = [{
            "q": L.init_dense(gen, dim, dim),
            "k": L.init_dense(gen, dim, dim),
            "v": L.init_dense(gen, dim, dim),
            "o": L.init_dense(gen, dim, dim),
            "rel_bias": _normal(gen, (2 * cfg.window_size - 1) ** 2,
                                cfg.num_heads[si]),
            "ln1": L.init_layer_norm(dim),
            "ln2": L.init_layer_norm(dim),
            "mlp_in": L.init_dense(gen, dim, inter),
            "mlp_out": L.init_dense(gen, inter, dim),
        } for _ in range(cfg.depths[si])]
        stage = {"blocks": blocks, "downsample": None}
        if si < n_stages - 1:
            stage["downsample"] = {
                "norm": L.init_layer_norm(4 * dim),
                "reduction": L.init_dense(gen, 4 * dim, 2 * dim, bias=False),
            }
        params["stages"].append(stage)
    return params


def init_text_params(gen: torch.Generator,
                     cfg: RobertaConfig = RobertaConfig()) -> dict:
    """Random init (float32, CPU) with the JAX package's shapes/scales."""
    return {
        "embeddings": {
            "word": _normal(gen, cfg.vocab_size, cfg.hidden),
            "position": _normal(gen, cfg.max_positions, cfg.hidden),
            "token_type": _normal(gen, cfg.type_vocab, cfg.hidden),
            "ln": L.init_layer_norm(cfg.hidden),
        },
        "blocks": [{
            "attn": L.init_mha(gen, cfg.hidden),
            "attn_ln": L.init_layer_norm(cfg.hidden),
            "mlp_in": L.init_dense(gen, cfg.hidden, cfg.intermediate),
            "mlp_out": L.init_dense(gen, cfg.intermediate, cfg.hidden),
            "mlp_ln": L.init_layer_norm(cfg.hidden),
        } for _ in range(cfg.layers)],
        "pooler": L.init_dense(gen, cfg.hidden, cfg.hidden),
        "proj": {
            "linear1": L.init_dense(gen, cfg.hidden, cfg.projection_dim),
            "linear2": L.init_dense(gen, cfg.projection_dim,
                                    cfg.projection_dim),
        },
    }


# ------------------------------------------------------------------- convert
def _np(t) -> np.ndarray:
    try:
        return t.detach().cpu().numpy().astype(np.float32)
    except AttributeError:
        return np.asarray(t, np.float32)


def _lin(sd, prefix, bias=True):
    p = {"w": _np(sd[f"{prefix}.weight"]).T}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def htsat_config_from_hf(hf_cfg) -> HTSATConfig:
    stride = hf_cfg.patch_stride
    stride = tuple(stride) if not isinstance(stride, int) \
        else (stride, stride)
    return HTSATConfig(
        num_mel_bins=hf_cfg.num_mel_bins, spec_size=hf_cfg.spec_size,
        patch_size=hf_cfg.patch_size, patch_stride=stride,
        patch_embed_dim=hf_cfg.patch_embeds_hidden_size,
        depths=tuple(hf_cfg.depths),
        num_heads=tuple(hf_cfg.num_attention_heads),
        window_size=hf_cfg.window_size, mlp_ratio=hf_cfg.mlp_ratio,
        hidden_size=hf_cfg.hidden_size,
        projection_dim=hf_cfg.projection_dim,
        ln_eps=hf_cfg.layer_norm_eps,
        enable_fusion=bool(getattr(hf_cfg, "enable_fusion", False)),
        aff_block_r=int(getattr(hf_cfg, "aff_block_r", 4)))


def roberta_config_from_hf(hf_cfg) -> RobertaConfig:
    return RobertaConfig(
        vocab_size=hf_cfg.vocab_size, hidden=hf_cfg.hidden_size,
        layers=hf_cfg.num_hidden_layers, heads=hf_cfg.num_attention_heads,
        intermediate=hf_cfg.intermediate_size,
        max_positions=hf_cfg.max_position_embeddings,
        type_vocab=hf_cfg.type_vocab_size, pad_token_id=hf_cfg.pad_token_id,
        ln_eps=hf_cfg.layer_norm_eps,
        projection_dim=hf_cfg.projection_dim)


def convert_clap_audio(state_dict: Mapping[str, Any],
                       cfg: HTSATConfig) -> dict:
    """ClapModel / ClapAudioModelWithProjection state_dict -> audio pytree."""
    sd = dict(state_dict)
    has_fusion = any(".fusion_model." in k or ".mel_conv2d." in k
                     for k in sd)
    if has_fusion and not cfg.enable_fusion:
        raise ValueError(
            "this is an enable_fusion checkpoint (laion/clap-htsat-fused);"
            " pass an HTSATConfig(enable_fusion=True)")
    if cfg.enable_fusion and not has_fusion:
        raise ValueError(
            "enable_fusion=True but the state_dict has no fusion weights "
            "(is this laion/clap-htsat-unfused?)")
    enc = "audio_model.audio_encoder"
    params = {
        "batch_norm": {
            "mean": _np(sd[f"{enc}.batch_norm.running_mean"]),
            "var": _np(sd[f"{enc}.batch_norm.running_var"]),
            "scale": _np(sd[f"{enc}.batch_norm.weight"]),
            "bias": _np(sd[f"{enc}.batch_norm.bias"]),
        },
        "patch_embed": {
            "w": _np(sd[f"{enc}.patch_embed.proj.weight"]),   # OIHW as-is
            "b": _np(sd[f"{enc}.patch_embed.proj.bias"]),
            "norm": _ln(sd, f"{enc}.patch_embed.norm"),
        },
        "norm": _ln(sd, f"{enc}.norm"),
        "proj": {
            "linear1": _lin(sd, "audio_projection.linear1"),
            "linear2": _lin(sd, "audio_projection.linear2"),
        },
        "stages": [],
    }
    if cfg.enable_fusion:
        pe = f"{enc}.patch_embed"

        def conv(prefix):
            return {"w": _np(sd[f"{prefix}.weight"]),
                    "b": _np(sd[f"{prefix}.bias"])}

        def bn(prefix):
            return {"mean": _np(sd[f"{prefix}.running_mean"]),
                    "var": _np(sd[f"{prefix}.running_var"]),
                    "scale": _np(sd[f"{prefix}.weight"]),
                    "bias": _np(sd[f"{prefix}.bias"])}

        # Sequential indices (modeling_clap.py ClapAudioAFFBlock):
        # local_att = [Conv, BN, ReLU, Conv, BN]; global_att has an
        # AdaptiveAvgPool2d at slot 0, shifting everything by one
        params["patch_embed"]["fusion"] = {
            "mel_conv2d": conv(f"{pe}.mel_conv2d"),
            "local": {
                "conv1": conv(f"{pe}.fusion_model.local_att.0"),
                "bn1": bn(f"{pe}.fusion_model.local_att.1"),
                "conv2": conv(f"{pe}.fusion_model.local_att.3"),
                "bn2": bn(f"{pe}.fusion_model.local_att.4")},
            "global": {
                "conv1": conv(f"{pe}.fusion_model.global_att.1"),
                "bn1": bn(f"{pe}.fusion_model.global_att.2"),
                "conv2": conv(f"{pe}.fusion_model.global_att.4"),
                "bn2": bn(f"{pe}.fusion_model.global_att.5")},
        }
    for si in range(len(cfg.depths)):
        st = f"{enc}.layers.{si}"
        blocks = []
        for bi in range(cfg.depths[si]):
            b = f"{st}.blocks.{bi}"
            blocks.append({
                "q": _lin(sd, f"{b}.attention.self.query"),
                "k": _lin(sd, f"{b}.attention.self.key"),
                "v": _lin(sd, f"{b}.attention.self.value"),
                "o": _lin(sd, f"{b}.attention.output.dense"),
                "rel_bias": _np(
                    sd[f"{b}.attention.self.relative_position_bias_table"]),
                "ln1": _ln(sd, f"{b}.layernorm_before"),
                "ln2": _ln(sd, f"{b}.layernorm_after"),
                "mlp_in": _lin(sd, f"{b}.intermediate.dense"),
                "mlp_out": _lin(sd, f"{b}.output.dense"),
            })
        stage = {"blocks": blocks, "downsample": None}
        if f"{st}.downsample.reduction.weight" in sd:
            stage["downsample"] = {
                "norm": _ln(sd, f"{st}.downsample.norm"),
                "reduction": _lin(sd, f"{st}.downsample.reduction",
                                  bias=False),
            }
        params["stages"].append(stage)
    return params


def convert_clap_text(state_dict: Mapping[str, Any],
                      cfg: RobertaConfig) -> dict:
    """ClapModel / ClapTextModelWithProjection state_dict -> text pytree."""
    sd = dict(state_dict)
    tm = "text_model"
    e = f"{tm}.embeddings"
    params = {
        "embeddings": {
            "word": _np(sd[f"{e}.word_embeddings.weight"]),
            "position": _np(sd[f"{e}.position_embeddings.weight"]),
            "token_type": _np(sd[f"{e}.token_type_embeddings.weight"]),
            "ln": _ln(sd, f"{e}.LayerNorm"),
        },
        "blocks": [],
        "pooler": _lin(sd, f"{tm}.pooler.dense"),
        "proj": {
            "linear1": _lin(sd, "text_projection.linear1"),
            "linear2": _lin(sd, "text_projection.linear2"),
        },
    }
    for i in range(cfg.layers):
        b = f"{tm}.encoder.layer.{i}"
        params["blocks"].append({
            "attn": {
                "q": _lin(sd, f"{b}.attention.self.query"),
                "k": _lin(sd, f"{b}.attention.self.key"),
                "v": _lin(sd, f"{b}.attention.self.value"),
                "o": _lin(sd, f"{b}.attention.output.dense"),
            },
            "attn_ln": _ln(sd, f"{b}.attention.output.LayerNorm"),
            "mlp_in": _lin(sd, f"{b}.intermediate.dense"),
            "mlp_out": _lin(sd, f"{b}.output.dense"),
            "mlp_ln": _ln(sd, f"{b}.output.LayerNorm"),
        })
    return params


def load_from_dir(path: str):
    """Local ClapModel checkpoint dir -> (audio_params, text_params,
    HTSATConfig, RobertaConfig). Reads config.json directly (no transformers
    import needed at serve time); weights via convert.load_state_dict_from_dir.
    """
    import json
    import pathlib

    from .convert import load_state_dict_from_dir

    raw = json.loads((pathlib.Path(path) / "config.json").read_text())
    ac, tc = raw["audio_config"], raw["text_config"]

    class _NS:
        def __init__(self, d, defaults):
            self.__dict__.update({**defaults, **d})

    audio_defaults = dict(
        num_mel_bins=64, spec_size=256, patch_size=4, patch_stride=[4, 4],
        patch_embeds_hidden_size=96, depths=[2, 2, 6, 2],
        num_attention_heads=[4, 8, 16, 32], window_size=8, mlp_ratio=4.0,
        hidden_size=768, projection_dim=raw.get("projection_dim", 512),
        layer_norm_eps=1e-5)
    text_defaults = dict(
        vocab_size=50265, hidden_size=768, num_hidden_layers=12,
        num_attention_heads=12, intermediate_size=3072,
        max_position_embeddings=514, type_vocab_size=1, pad_token_id=1,
        layer_norm_eps=1e-12, projection_dim=raw.get("projection_dim", 512))
    acfg = htsat_config_from_hf(_NS(ac, audio_defaults))
    tcfg = roberta_config_from_hf(_NS(tc, text_defaults))
    sd = load_state_dict_from_dir(path)
    return (convert_clap_audio(sd, acfg), convert_clap_text(sd, tcfg),
            acfg, tcfg)
