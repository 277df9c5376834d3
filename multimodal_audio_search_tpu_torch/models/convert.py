"""HF checkpoint -> param tree weight conversion (offline).

A copy of ``multimodal_audio_search_tpu/models/convert.py`` (numpy only),
whose config imports resolve to the port's dataclasses of the same
fields; ``tests/test_torch_copies.py`` holds it to the original. The
trees it makes are numpy; ``weights.whisper_params`` /
``weights.minilm_params`` / ``weights.mpnet_params`` turn them into the
port's torch trees.

The reference downloads its three models from the Hub at runtime
(audio_search.py:153,178,200). This image has no egress, so conversion is a
pure state_dict -> pytree mapping that works on anything torch can load
locally: a cached HF checkpoint directory, a random-init torch model (used by
the numerical parity tests), or a safetensors file.

Conventions: torch Linear stores [out, in]; our dense is y = x @ W + b with
W [in, out], so linear weights transpose. Conv1d [out, in, k] -> [k, in, out].
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from .minilm import MiniLMConfig
from .whisper import WhisperConfig


def _np(t) -> np.ndarray:
    try:  # torch tensor
        return t.detach().cpu().numpy().astype(np.float32)
    except AttributeError:
        return np.asarray(t, np.float32)


def _lin(sd: Mapping[str, Any], prefix: str, bias: bool = True):
    p = {"w": _np(sd[f"{prefix}.weight"]).T}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _ln(sd: Mapping[str, Any], prefix: str):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


# ---------------------------------------------------------------- BERT/MiniLM
def bert_config_from_hf(hf_cfg) -> MiniLMConfig:
    return MiniLMConfig(
        vocab_size=hf_cfg.vocab_size, hidden=hf_cfg.hidden_size,
        layers=hf_cfg.num_hidden_layers, heads=hf_cfg.num_attention_heads,
        intermediate=hf_cfg.intermediate_size,
        max_positions=hf_cfg.max_position_embeddings,
        type_vocab=hf_cfg.type_vocab_size, ln_eps=hf_cfg.layer_norm_eps)


def convert_bert(
    state_dict: Mapping[str, Any], cfg: MiniLMConfig
) -> dict:
    """BertModel state_dict -> minilm.py param pytree.

    Accepts both bare BertModel keys and 'bert.'-prefixed ones; the
    sentence-transformers checkpoint prefixes with '0.auto_model.'.
    """
    sd = dict(state_dict)
    for pref in ("bert.", "0.auto_model."):
        if any(k.startswith(pref) for k in sd):
            sd = {k[len(pref):]: v for k, v in sd.items()
                  if k.startswith(pref)}
    e = "embeddings"
    emb = {
        "word": _np(sd[f"{e}.word_embeddings.weight"]),
        "position": _np(sd[f"{e}.position_embeddings.weight"]),
        "token_type": _np(sd[f"{e}.token_type_embeddings.weight"]),
        "ln": _ln(sd, f"{e}.LayerNorm"),
    }
    blocks = []
    for i in range(cfg.layers):
        b = f"encoder.layer.{i}"
        blocks.append({
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
    return {"embeddings": emb, "blocks": blocks}


# -------------------------------------------------------------------- Whisper
def whisper_config_from_hf(hf_cfg) -> WhisperConfig:
    return WhisperConfig(
        vocab_size=hf_cfg.vocab_size, d_model=hf_cfg.d_model,
        enc_layers=hf_cfg.encoder_layers, dec_layers=hf_cfg.decoder_layers,
        heads=hf_cfg.encoder_attention_heads, ffn=hf_cfg.encoder_ffn_dim,
        n_mels=hf_cfg.num_mel_bins,
        enc_positions=hf_cfg.max_source_positions,
        dec_positions=hf_cfg.max_target_positions,
        bos_token_id=hf_cfg.decoder_start_token_id,
        eos_token_id=hf_cfg.eos_token_id,
        pad_token_id=hf_cfg.pad_token_id
        if hf_cfg.pad_token_id is not None else hf_cfg.eos_token_id)


def _whisper_attn(sd, prefix):
    return {
        "q": _lin(sd, f"{prefix}.q_proj"),
        "k": _lin(sd, f"{prefix}.k_proj", bias=False),
        "v": _lin(sd, f"{prefix}.v_proj"),
        "o": _lin(sd, f"{prefix}.out_proj"),
    }


def convert_whisper(
    state_dict: Mapping[str, Any], cfg: WhisperConfig
) -> dict:
    """WhisperForConditionalGeneration (or WhisperModel) state_dict ->
    whisper.py param pytree."""
    sd = dict(state_dict)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    enc = {
        "conv1": {"w": _np(sd["encoder.conv1.weight"]).transpose(2, 1, 0),
                  "b": _np(sd["encoder.conv1.bias"])},
        "conv2": {"w": _np(sd["encoder.conv2.weight"]).transpose(2, 1, 0),
                  "b": _np(sd["encoder.conv2.bias"])},
        "positions": _np(sd["encoder.embed_positions.weight"]),
        "ln": _ln(sd, "encoder.layer_norm"),
        "blocks": [],
    }
    for i in range(cfg.enc_layers):
        b = f"encoder.layers.{i}"
        enc["blocks"].append({
            "self_attn": _whisper_attn(sd, f"{b}.self_attn"),
            "self_ln": _ln(sd, f"{b}.self_attn_layer_norm"),
            "mlp_in": _lin(sd, f"{b}.fc1"),
            "mlp_out": _lin(sd, f"{b}.fc2"),
            "mlp_ln": _ln(sd, f"{b}.final_layer_norm"),
        })
    dec = {
        "embed_tokens": _np(sd["decoder.embed_tokens.weight"]),
        "positions": _np(sd["decoder.embed_positions.weight"]),
        "ln": _ln(sd, "decoder.layer_norm"),
        "blocks": [],
    }
    for i in range(cfg.dec_layers):
        b = f"decoder.layers.{i}"
        dec["blocks"].append({
            "self_attn": _whisper_attn(sd, f"{b}.self_attn"),
            "self_ln": _ln(sd, f"{b}.self_attn_layer_norm"),
            "cross_attn": _whisper_attn(sd, f"{b}.encoder_attn"),
            "cross_ln": _ln(sd, f"{b}.encoder_attn_layer_norm"),
            "mlp_in": _lin(sd, f"{b}.fc1"),
            "mlp_out": _lin(sd, f"{b}.fc2"),
            "mlp_ln": _ln(sd, f"{b}.final_layer_norm"),
        })
    return {"encoder": enc, "decoder": dec}


# ------------------------------------------------------------------- loading
def load_state_dict_from_dir(path: str) -> dict:
    """Load a local checkpoint dir: safetensors or pytorch_bin."""
    import pathlib
    p = pathlib.Path(path)
    st = list(p.glob("*.safetensors"))
    if st:
        from safetensors.numpy import load_file
        out = {}
        for f in st:
            out.update(load_file(str(f)))
        return out
    bins = list(p.glob("pytorch_model*.bin")) + list(p.glob("*.pt"))
    if bins:
        import torch
        out = {}
        for f in bins:
            out.update(torch.load(str(f), map_location="cpu",
                                  weights_only=True))
        return out
    raise FileNotFoundError(f"no checkpoint files under {path}")


def distilbert_config_from_hf(hf_cfg) -> MiniLMConfig:
    """DistilBertConfig -> MiniLMConfig (type_vocab=0: no token types)."""
    return MiniLMConfig(
        vocab_size=hf_cfg.vocab_size, hidden=hf_cfg.dim,
        layers=hf_cfg.n_layers, heads=hf_cfg.n_heads,
        intermediate=hf_cfg.hidden_dim,
        max_positions=hf_cfg.max_position_embeddings,
        type_vocab=0, ln_eps=1e-12)


def convert_distilbert(state_dict: Mapping[str, Any],
                       cfg: MiniLMConfig) -> dict:
    """DistilBertModel state_dict -> minilm.py param pytree.

    DistilBERT (the clip-ViT-B-32-multilingual-v1 text tower,
    clean_audio_search.py:36) is a post-LN BERT block with different key
    names and no token-type embeddings; encode_tokens handles type_vocab=0.
    """
    sd = dict(state_dict)
    if any(k.startswith("distilbert.") for k in sd):
        sd = {k[len("distilbert."):]: v for k, v in sd.items()
              if k.startswith("distilbert.")}
    emb = {
        "word": _np(sd["embeddings.word_embeddings.weight"]),
        "position": _np(sd["embeddings.position_embeddings.weight"]),
        "ln": _ln(sd, "embeddings.LayerNorm"),
    }
    blocks = []
    for i in range(cfg.layers):
        b = f"transformer.layer.{i}"
        blocks.append({
            "attn": {
                "q": _lin(sd, f"{b}.attention.q_lin"),
                "k": _lin(sd, f"{b}.attention.k_lin"),
                "v": _lin(sd, f"{b}.attention.v_lin"),
                "o": _lin(sd, f"{b}.attention.out_lin"),
            },
            "attn_ln": _ln(sd, f"{b}.sa_layer_norm"),
            "mlp_in": _lin(sd, f"{b}.ffn.lin1"),
            "mlp_out": _lin(sd, f"{b}.ffn.lin2"),
            "mlp_ln": _ln(sd, f"{b}.output_layer_norm"),
        })
    return {"embeddings": emb, "blocks": blocks}


# --------------------------------------------------------------------- MPNet
def mpnet_config_from_hf(hf_cfg):
    from .mpnet import MPNetConfig
    return MPNetConfig(
        vocab_size=hf_cfg.vocab_size, hidden=hf_cfg.hidden_size,
        layers=hf_cfg.num_hidden_layers, heads=hf_cfg.num_attention_heads,
        intermediate=hf_cfg.intermediate_size,
        max_positions=hf_cfg.max_position_embeddings,
        pad_token_id=hf_cfg.pad_token_id,
        rel_buckets=hf_cfg.relative_attention_num_buckets,
        ln_eps=hf_cfg.layer_norm_eps)


def convert_mpnet(state_dict: Mapping[str, Any], cfg) -> dict:
    """MPNetModel state_dict -> mpnet.py param pytree (all-mpnet-base-v2,
    clean_audio_search.py:32). Accepts bare MPNetModel keys,
    'mpnet.'-prefixed, and sentence-transformers '0.auto_model.'."""
    sd = dict(state_dict)
    for pref in ("mpnet.", "0.auto_model."):
        if any(k.startswith(pref) for k in sd):
            sd = {k[len(pref):]: v for k, v in sd.items()
                  if k.startswith(pref)}
    emb = {
        "word": _np(sd["embeddings.word_embeddings.weight"]),
        "position": _np(sd["embeddings.position_embeddings.weight"]),
        "ln": _ln(sd, "embeddings.LayerNorm"),
    }
    rel_bias = _np(sd["encoder.relative_attention_bias.weight"])
    blocks = []
    for i in range(cfg.layers):
        b = f"encoder.layer.{i}"
        blocks.append({
            "attn": {
                "q": _lin(sd, f"{b}.attention.attn.q"),
                "k": _lin(sd, f"{b}.attention.attn.k"),
                "v": _lin(sd, f"{b}.attention.attn.v"),
                "o": _lin(sd, f"{b}.attention.attn.o"),
            },
            "attn_ln": _ln(sd, f"{b}.attention.LayerNorm"),
            "mlp_in": _lin(sd, f"{b}.intermediate.dense"),
            "mlp_out": _lin(sd, f"{b}.output.dense"),
            "mlp_ln": _ln(sd, f"{b}.output.LayerNorm"),
        })
    return {"embeddings": emb, "rel_bias": rel_bias, "blocks": blocks}
