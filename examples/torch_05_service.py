"""Service boundary of the PyTorch port: HTTP server, async ingest jobs,
streaming PCM, and the stats surface -- driven end-to-end with urllib.

The port's counterpart of examples/05_service.py, the engine on the card
unless ``--device cpu`` is passed.

    python examples/torch_05_service.py [--device cpu]
"""
import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from multimodal_audio_search_tpu_torch import (
        AudioSearchEngine, EngineConfig)
    from multimodal_audio_search_tpu_torch.config import (
        DecodeConfig, ModelSpec)
    from multimodal_audio_search_tpu_torch.service.server import serve

    cfg = EngineConfig(
        asr_model=ModelSpec(family="whisper", preset="tiny"),
        caption_model=ModelSpec(family="whisper", preset="tiny"),
        asr_decode=DecodeConfig(max_new_tokens=8),
        caption_decode=DecodeConfig(max_new_tokens=8),
        short_context=True, ingest_batch=4,
    )
    with tempfile.TemporaryDirectory() as root:
        srv = serve(AudioSearchEngine(cfg=cfg, device=args.device),
                    host="127.0.0.1", port=0, block=False, data_root=root)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            drive(f"http://127.0.0.1:{srv.server_address[1]}")
        finally:
            srv.shutdown()
            srv.server_close()


def drive(base: str) -> None:
    print("serving on", base)
    rng = np.random.default_rng(0)
    from multimodal_audio_search_tpu_torch.audio.wav import write_wav
    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        write_wav(f.name, (rng.normal(size=16000 * 12) * 0.3)
                  .astype(np.float32), 16000)
        body = open(f.name, "rb").read()

    # async ingest: 202 + job id, poll to completion
    req = urllib.request.Request(
        base + "/api/ingest?async=1&name=demo.wav", data=body,
        method="POST")
    job = json.loads(urllib.request.urlopen(req).read())["job"]
    while True:
        j = json.loads(urllib.request.urlopen(
            base + "/api/jobs/" + job).read())
        if j["state"] in ("done", "failed"):
            break
        time.sleep(0.5)
    print(f"job {job}: {j['state']}, {j.get('n_segments')} segment(s)")

    # streaming PCM ingest: open -> chunks -> close
    sid = json.loads(urllib.request.urlopen(urllib.request.Request(
        base + "/api/stream/open?name=live", method="POST"))
        .read())["session"]
    pcm = (rng.normal(size=16000 * 11) * 0.2 * 32767).astype(np.int16)
    for lo in range(0, len(pcm), 16000 * 4):
        urllib.request.urlopen(urllib.request.Request(
            base + f"/api/stream/{sid}/chunk?rate=16000",
            data=pcm[lo: lo + 16000 * 4].tobytes(), method="POST"))
    out = json.loads(urllib.request.urlopen(urllib.request.Request(
        base + f"/api/stream/{sid}/close", method="POST")).read())
    print(f"stream committed; index total {out['total']}")

    res = json.loads(urllib.request.urlopen(
        base + "/api/search?q=music&k=5").read())
    print(f"search: {len(res['results'])} hit(s)")
    stats = json.loads(urllib.request.urlopen(
        base + "/api/stats").read())
    print("stats: total_segments =",
          stats["database"]["total_segments"])
    prom = urllib.request.urlopen(base + "/metrics").read().decode()
    print("prometheus lines:", len(prom.splitlines()))


if __name__ == "__main__":
    main()
