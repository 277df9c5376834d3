"""Builds the JAX package's native audio libraries once, before any test
process imports them.

``multimodal_audio_search_tpu/audio/native.py``, ``audio/mp3_native.py``
and ``audio/ffdecode.py`` compile their shared libraries at first use,
each into one shared temporary name under ``native/build/``. Under
pytest-xdist several workers reach that first use together, one of them
finds another's half-written file, and its native tests skip. So the
controller builds the three libraries here, before the workers start,
and every worker then finds them in place.

The build runs in a subprocess with ``JAX_PLATFORMS=cpu``: importing the
JAX package in this process would start jax before ``tests/conftest.py``
sets its ``XLA_FLAGS``. A failed build is left to the tests, which report
it as they always have.
"""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
BUILD = ("from multimodal_audio_search_tpu.audio import ffdecode, mp3_native, "
         "native; native.get_lib(); mp3_native.get_lib(); ffdecode.get_lib()")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built
        return
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    try:
        subprocess.run([sys.executable, "-c", BUILD], cwd=ROOT, env=env,
                       capture_output=True, timeout=600)
    except subprocess.TimeoutExpired:
        pass  # the tests build (or skip) as they did without this
