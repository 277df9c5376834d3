"""Multi-device engine on the PyTorch port: the SAME production engine,
sharded over a mesh.

The port's counterpart of examples/03_multichip.py.
EngineConfig(data_parallel=..., model_parallel=...) builds a (data,
model) mesh of devices: ingest batches and the index shard over 'data',
the models split by heads over 'model' (tensor parallelism). The engine
takes the mesh's entries as ``devices``; with fewer cards than the mesh
has entries they repeat (one card named several times runs every
sharded path on it), and on the CPU they are virtual CPU entries. On a
host with eight cards the identical code uses eight.

    python examples/torch_03_multichip.py [--device cpu]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

DATA, MODEL = 4, 2                       # a 4x2 (data, model) mesh


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch
    from multimodal_audio_search_tpu_torch import (
        AudioSearchEngine, EngineConfig)
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, ModelSpec)

    dev = torch.device(args.device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards)
                   for i in range(DATA * MODEL)]
    else:
        devices = [dev] * (DATA * MODEL)
    print(f"{len(devices)} devices: {devices[:4]} ...")
    cfg = EngineConfig(
        data_parallel=DATA, model_parallel=MODEL,
        asr_model=ModelSpec(family="whisper", preset="tiny"),
        caption_model=ModelSpec(family="whisper", preset="tiny"),
        asr_decode=DecodeConfig(max_new_tokens=8),
        caption_decode=DecodeConfig(max_new_tokens=8),
        short_context=True,
        ingest_batch=8,
    )
    engine = AudioSearchEngine(cfg=cfg, device=dev, devices=devices)
    print(f"mesh: {dict(engine.mesh.shape)}")

    rng = np.random.default_rng(0)
    wave = (rng.normal(size=16000 * 40) * 0.3).astype(np.float32)
    segs = engine.ingest_waveform(wave, 16000, "mesh-demo")
    print(f"ingested {len(segs)} segment(s) with batches sharded over "
          f"{engine.mesh.shape['data']} data-parallel devices")
    hits, info = engine.search("anything")
    print(f"sharded search: {len(hits)} hit(s), "
          f"weights {info.get('asr_weight'):.2f}/"
          f"{info.get('audio_weight'):.2f}")


if __name__ == "__main__":
    main()
