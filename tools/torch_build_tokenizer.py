"""Build a ready tokenizer.json from raw checkpoint-dir assets.

Usage:
    python tools/torch_build_tokenizer.py /path/to/checkpoint_dir [more dirs...]

For each dir: if tokenizer.json already exists it is left alone; otherwise
the tokenizer is reconstructed from vocab.json+merges.txt (Whisper/GPT-2
byte-level BPE, incl. added_tokens.json specials) or vocab.txt (BERT/
MiniLM WordPiece) and saved as tokenizer.json next to the weights, making
HFTokenizerWrapper the production tokenizer path of the PyTorch port
(multimodal_audio_search_tpu_torch/models/tokenizer.py). A directory with
no assets raises FileNotFoundError before ``tokenizers`` is imported.

The port's counterpart of tools/build_tokenizer.py, in the weights-day
chain (tools/torch_weights_day.py): conversion -> tokenizer build ->
tools/torch_parity_eval.py.
"""
import os
import pathlib
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_dir(d: pathlib.Path) -> str:
    from multimodal_audio_search_tpu_torch.models.tokenizer import (
        build_from_checkpoint_dir)
    out = d / "tokenizer.json"
    if out.exists():
        return f"{d}: tokenizer.json already present"
    tok = build_from_checkpoint_dir(d)
    tok.save(str(out))
    return f"{d}: wrote tokenizer.json ({tok.get_vocab_size()} tokens)"


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    for a in argv:
        print(build_dir(pathlib.Path(a)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
