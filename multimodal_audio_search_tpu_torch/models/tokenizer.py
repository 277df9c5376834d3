"""Tokenizers for the text embedder (WordPiece) and Whisper decode (BPE).

The reference gets these implicitly from HF hub downloads
(audio_search.py:153,200). This image has no egress, so:

  * when local tokenizer assets exist (a ``tokenizer.json`` or
    ``vocab.txt``), they load through the bundled ``tokenizers`` runtime
    (HF's native Rust tokenizer library — already in the image),
  * otherwise a deterministic ``HashWordTokenizer`` keeps every pipeline,
    test, and benchmark runnable: stable word -> id hashing for encode and a
    reversible ``tok<id>`` decode. Retrieval semantics (same text -> same
    ids -> same embedding) are preserved; only human readability is not.

A near-copy of ``multimodal_audio_search_tpu/models/tokenizer.py``
(``tests/test_torch_copies.py`` names the differences): the port imports
``tokenizers`` only after it has found tokenizer assets, so a directory
of weights alone takes the hash fallback on a host without the package,
as ``load_tokenizer`` promises, while a directory with assets still
raises ModuleNotFoundError there. The original imports it first and
raises on any checkpoint directory (ROADMAP §3, known faults).
"""
from __future__ import annotations

import hashlib
import pathlib
import re
from typing import Sequence

import numpy as np


class HashWordTokenizer:
    """Deterministic offline tokenizer (fallback when no assets exist)."""

    def __init__(self, vocab_size: int = 30522, cls_id: int = 101,
                 sep_id: int = 102, pad_id: int = 0, reserved: int = 1000,
                 add_cls_sep: bool = True, eos_id: int | None = None):
        self.vocab_size = vocab_size
        self.cls_id, self.sep_id, self.pad_id = cls_id, sep_id, pad_id
        # special-id space can't exceed a quarter of a tiny test vocab
        self.reserved = min(reserved, max(vocab_size // 4, 8))
        self.add_cls_sep = add_cls_sep
        self.eos_id = eos_id

    def _word_id(self, w: str) -> int:
        h = int.from_bytes(
            hashlib.blake2s(w.encode(), digest_size=4).digest(), "little")
        return self.reserved + h % (self.vocab_size - self.reserved)

    def encode(
        self, texts: Sequence[str], max_len: int = 64
    ) -> tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), max_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for i, t in enumerate(texts):
            words = re.findall(r"[a-z0-9]+", t.lower())
            toks = [self._word_id(w) for w in words]
            if self.add_cls_sep:
                toks = [self.cls_id] + toks[: max_len - 2] + [self.sep_id]
            else:
                toks = toks[:max_len]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        special = {self.cls_id, self.sep_id, self.pad_id}
        if self.eos_id is not None:
            special.add(self.eos_id)
        out = []
        for t in ids:
            t = int(t)
            if skip_special_tokens and (t < self.reserved or t in special):
                continue
            out.append(f"tok{t}")
        return " ".join(out)


def build_byte_level_bpe(ckpt_dir: pathlib.Path):
    """Reconstruct a Whisper/GPT-2-style byte-level BPE tokenizer from the
    raw checkpoint assets ``vocab.json`` + ``merges.txt``
    (+ ``added_tokens.json`` for the <|...|> specials).

    This is the builder the reference never needed (HF hub shipped it a
    ready tokenizer, audio_search.py:153,200); with it, a local Whisper
    checkpoint dir becomes a working production tokenizer with no egress.
    """
    import json

    from tokenizers import AddedToken, Tokenizer, decoders, models, \
        pre_tokenizers
    vocab = json.loads((ckpt_dir / "vocab.json").read_text())
    merges = []
    for line in (ckpt_dir / "merges.txt").read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        a, b = line.split(" ")
        merges.append((a, b))
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges, fuse_unk=False))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()

    added_path = ckpt_dir / "added_tokens.json"
    if added_path.exists():
        added = json.loads(added_path.read_text())
        # `tokenizers` assigns added ids sequentially after the base
        # vocab; whisper's specials are contiguous from len(vocab), so
        # inserting in id order reproduces the exact ids — verify.
        for t, want in sorted(added.items(), key=lambda kv: kv[1]):
            got = tok.add_special_tokens(
                [AddedToken(t, special=True, normalized=False)])
            del got
            have = tok.token_to_id(t)
            if have != want:
                raise ValueError(
                    f"added token {t!r} landed at id {have}, checkpoint "
                    f"says {want}; non-contiguous added_tokens.json needs "
                    f"a hand-written tokenizer.json")
    return tok


def build_wordpiece(ckpt_dir: pathlib.Path, lowercase: bool = True):
    """Reconstruct a BERT/MiniLM WordPiece tokenizer from ``vocab.txt``
    with the [CLS] ... [SEP] template MiniLM's encoder expects."""
    from tokenizers import Tokenizer, decoders, models, normalizers, \
        pre_tokenizers, processors
    vocab_path = ckpt_dir / "vocab.txt"
    words = vocab_path.read_text().splitlines()
    vocab = {w: i for i, w in enumerate(words)}
    tok = Tokenizer(models.WordPiece(vocab=vocab, unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=lowercase)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.decoder = decoders.WordPiece(prefix="##")
    cls_id, sep_id = vocab["[CLS]"], vocab["[SEP]"]
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]",
        pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", cls_id), ("[SEP]", sep_id)])
    # register the bracket tokens as special so skip_special_tokens works;
    # they are already in the vocab, so their ids are unchanged
    from tokenizers import AddedToken
    tok.add_special_tokens([
        AddedToken(t, special=True) for t in
        ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]") if t in vocab])
    return tok


def build_from_checkpoint_dir(path: str | pathlib.Path):
    """tokenizer.json > (vocab.json + merges.txt) > vocab.txt, rebuilt
    into a ``tokenizers.Tokenizer``. Raises FileNotFoundError if the dir
    carries no tokenizer assets at all."""
    p = pathlib.Path(path)
    if (p / "tokenizer.json").exists():
        # ``tokenizers`` is imported only once there are assets to read:
        # a directory of weights alone raises FileNotFoundError, and the
        # hash fallback serves it, on a host without the package
        from tokenizers import Tokenizer
        return Tokenizer.from_file(str(p / "tokenizer.json"))
    if (p / "vocab.json").exists() and (p / "merges.txt").exists():
        return build_byte_level_bpe(p)
    if (p / "vocab.txt").exists():
        return build_wordpiece(p)
    raise FileNotFoundError(f"no tokenizer assets under {path}")


class HFTokenizerWrapper:
    """Wraps a ``tokenizers.Tokenizer`` (from local tokenizer.json or raw
    vocab/merges assets, rebuilt by build_from_checkpoint_dir)."""

    def __init__(self, tok, pad_id: int = 0):
        self.tok = tok
        self.pad_id = pad_id

    @classmethod
    def from_path(cls, path: str | pathlib.Path) -> "HFTokenizerWrapper":
        p = pathlib.Path(path)
        if not p.is_dir() and p.suffix == ".json":
            from tokenizers import Tokenizer
            return cls(Tokenizer.from_file(str(p)))
        return cls(build_from_checkpoint_dir(p))

    def encode(
        self, texts: Sequence[str], max_len: int = 64
    ) -> tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), max_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for i, t in enumerate(texts):
            e = self.tok.encode(t)
            toks = e.ids[:max_len]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        return self.tok.decode(
            [int(t) for t in ids], skip_special_tokens=skip_special_tokens)


def load_tokenizer(
    path: str | None = None, vocab_size: int = 30522, **hash_kw
):
    """Local assets if present (tokenizer.json, or vocab.json+merges.txt /
    vocab.txt rebuilt via build_from_checkpoint_dir), deterministic hash
    fallback otherwise — so the same code path serves both a weights-day
    production setup and this weightless image."""
    if path is not None and pathlib.Path(path).exists():
        try:
            return HFTokenizerWrapper.from_path(path)
        except FileNotFoundError:
            pass  # weights-only dir: fall through to the hash fallback
    return HashWordTokenizer(vocab_size=vocab_size, **hash_kw)
