"""Every kernel launch on its tensor's device, on the CPU.

The kernel library is replaced by a fake whose every function records
the device ``torch.cuda.device`` last entered (the guard, replaced by a
recorder); the wrappers' launch paths are called with tensors on the
``meta`` device, so an entered device can only have come from the
tensors. Checked:

* ``runtime.kernels`` runs the INIT functions and the sm_90 check once
  per device index, with that device current, builds the library once,
  and refuses a card that is not sm_90;
* every wrapper's launch and every plan query (``*_fit``) runs under its
  tensor's device, through ``runtime.launch``, the only module that
  calls the library.
"""
import ast
import ctypes
import pathlib

import pytest
import torch

from multimodal_audio_search_tpu_torch import runtime
from multimodal_audio_search_tpu_torch.ops import (attention, cached_attention,
                                                   cross_attention,
                                                   decoder_block,
                                                   encoder_block,
                                                   fused_search, quant,
                                                   stream_read)

PKG = pathlib.Path(runtime.__file__).resolve().parent
META = torch.device("meta")


class Guard:
    """Stands in for torch.cuda.device: records the entered devices."""
    stack: list = []

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        d = self.device
        Guard.stack.append(d if isinstance(d, int) else torch.device(d))

    def __exit__(self, *exc):
        Guard.stack.pop()


class FakeLib:
    """Any mas_* function: records (name, the device current at the call)
    and answers a plan query's out-parameter with 2 blocks."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mas_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, Guard.stack[-1] if Guard.stack
                               else None))
            for a in args:
                if type(a).__name__ == "CArgObject":
                    a._obj.value = 2
            return 0
        return fn


@pytest.fixture
def fake(monkeypatch, tmp_path):
    lib = FakeLib()
    Guard.stack = []
    caps = []
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i: caps.append(i) or ((8, 0) if i == 7
                                                     else (9, 0)))
    monkeypatch.setattr(runtime, "_lib", lib)
    monkeypatch.setattr(runtime, "_ready", set())
    monkeypatch.setattr(runtime, "COUNTS", dict.fromkeys(runtime.COUNTS, 0))
    monkeypatch.setattr(runtime, "stream_handle", lambda dev: None)
    monkeypatch.setattr(runtime, "raw_stream", lambda dev: 0)
    monkeypatch.setattr(runtime, "sm_count", lambda dev: 132)
    # plan and scratch caches keyed by device: fresh, so no meta entry
    # outlives the test
    for mod, names in ((cross_attention, ("_SCRATCH", "_FIT", "_PLAN")),
                       (cached_attention, ("_FIT",)),
                       (quant, ("_SCRATCH",)),
                       (decoder_block, ("_FIT", "_X_FIT", "_X_PLAN",
                                        "_COUNTERS", "_BUFS"))):
        for n in names:
            monkeypatch.setattr(mod, n, {})
    encoder_block._fit.cache_clear()
    encoder_block._plan.cache_clear()
    yield lib, caps
    encoder_block._fit.cache_clear()
    encoder_block._plan.cache_clear()


def test_init_runs_once_per_device_index(fake, monkeypatch, tmp_path):
    lib, caps = fake
    # the first call builds (here: loads the fake) and sets device 0 up
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "_build", lambda so: ("nvcc ...", "log"))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: lib)
    monkeypatch.setattr(runtime, "_declare", lambda lib: None)
    for d in (torch.device("cuda", 0), torch.device("cuda", 1),
              torch.device("cuda", 1), 1, None, torch.device("cuda", 0)):
        assert runtime.kernels(d) is lib
    init = [c for c in lib.calls if c[0] in runtime.INIT]
    assert init == [(n, 0) for n in runtime.INIT] + \
        [(n, 1) for n in runtime.INIT]
    assert caps == [0, 1] and runtime.ready_devices() == [0, 1]
    assert runtime.build_info["command"] == "nvcc ..."
    with pytest.raises(RuntimeError, match="card 7 is sm_80"):
        runtime.kernels(torch.device("cuda", 7))
    assert runtime.ready_devices() == [0, 1]


def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


def _launches():
    """One call of every wrapper's launch path (and so of every plan
    query) on meta tensors."""
    f32, i8 = torch.float32, torch.int8
    b, h, t, d = 2, 2, 8, 64
    hd = h * d
    q = _m(b, h, t, d)
    x3, wo, bo = _m(b, t, hd), _m(hd, hd), _m(hd)
    yield "K8", lambda: attention._launch(q, _m(b, h, t, d), _m(b, h, t, d))
    q32 = _m(b, h, t, d, dtype=f32)
    yield "K8 float32", lambda: attention._launch(q32, q32, q32)
    yield "K1", lambda: encoder_block._launch(q, q, q, x3, wo, bo,
                                              cluster=1)
    yield "K10", lambda: encoder_block._launch(q, q, q, x3, wo, bo,
                                               pair_heads=True, cluster=1)
    yield "K11", lambda: encoder_block._launch(q, q, q, x3, wo, bo,
                                               form="post", cluster=1)
    yield "K9", lambda: encoder_block._launch_int8(
        q, _m(b, h, t, d, dtype=i8), _m(b, h, t, dtype=f32),
        _m(b, h, t, d, dtype=i8), _m(b, h, t, dtype=f32), x3, wo, bo)
    # the partial forms of the model axis: Wo a [H*64, HD_out] row shard
    wr = _m(hd, 2 * hd)
    yield "K1p", lambda: encoder_block._launch_partial(q, q, q, wr,
                                                       cluster=1)
    yield "K10p", lambda: encoder_block._launch_partial(
        q, q, q, wr, cluster=1, pair_heads=True)
    yield "K9p", lambda: encoder_block._launch_int8(
        q, _m(b, h, t, d, dtype=i8), _m(b, h, t, dtype=f32),
        _m(b, h, t, d, dtype=i8), _m(b, h, t, dtype=f32), None, wr, None,
        partial=True)
    qm = _m(b, hd)
    yield "K2", lambda: cross_attention._launch(qm, _m(b, t, hd),
                                                _m(b, t, hd), h, t)
    kv32 = _m(b, t, hd, dtype=f32)
    yield "K2 float32", lambda: cross_attention._launch(
        _m(b, hd, dtype=f32), kv32, kv32, h, t)
    yield "K6", lambda: cross_attention._launch_int8(
        qm, _m(b, t, hd, dtype=i8), _m(b, t, h, dtype=f32),
        _m(b, t, hd, dtype=i8), _m(b, t, h, dtype=f32), h, t)
    yield "K7", lambda: cached_attention._launch(
        _m(b, h, d), _m(b, h, t, d, dtype=i8), _m(b, h, t, dtype=f32),
        _m(b, h, t, d, dtype=i8), _m(b, h, t, dtype=f32))
    b16, f = 16, 256
    x, vf, vb, w = _m(b16, hd), _m(hd, dtype=f32), _m(hd), _m(hd, hd)
    selfw = (x, vf, vb, w, vb, w, w, vb, w, vb)
    cache = _m(b16, t, hd)
    yield "K3", lambda: decoder_block._launch_self(
        *selfw, cache, cache, 3, h, 1e-5)
    yield "K3-q", lambda: decoder_block._launch_self(
        *selfw, cache, cache, 3, h, 1e-5, tail=(vf, vb, w, vb))
    mlp = (x, vf, vb, _m(hd, f), _m(f), _m(f, hd), vb)
    yield "K4", lambda: decoder_block._launch_mlp(*mlp, 1e-5)
    yield "K4-o", lambda: decoder_block._launch_mlp(
        *mlp, 1e-5, head=(_m(b16, hd, dtype=f32), w, vb))
    # K3's, K3-q's, K4's and K4-o's float32 forms: every tensor float32
    x32, w32 = _m(b16, hd, dtype=f32), _m(hd, hd, dtype=f32)
    self32 = (x32, vf, vf, w32, vf, w32, w32, vf, w32, vf)
    cache32 = _m(b16, t, hd, dtype=f32)
    yield "K3 float32", lambda: decoder_block._launch_self(
        *self32, cache32, cache32, 3, h, 1e-5)
    yield "K3-q float32", lambda: decoder_block._launch_self(
        *self32, cache32, cache32, 3, h, 1e-5, tail=(vf, vf, w32, vf))
    mlp32 = (x32, vf, vf, _m(hd, f, dtype=f32), _m(f, dtype=f32),
             _m(f, hd, dtype=f32), vf)
    yield "K4 float32", lambda: decoder_block._launch_mlp(*mlp32, 1e-5)
    yield "K4-o float32", lambda: decoder_block._launch_mlp(
        *mlp32, 1e-5, head=(_m(b16, hd, dtype=f32), w32, vf))
    yield "K14", lambda: decoder_block._launch_cross_mlp(
        x, vf, vb, w, vb, w, vb, vf, vb, _m(hd, f), _m(f), _m(f, hd), vb,
        cache, cache, h, 1e-5)
    xq = _m(4, 64)
    yield "K5", lambda: quant._launch(xq, _m(64, 32, dtype=i8),
                                      _m(32, dtype=f32), _m(32), f32)
    yield "K5 table", lambda: quant._launch(
        xq, None, _m(40, dtype=f32), None, f32, wq_t=_m(40, 64, dtype=i8))
    yield "K12", lambda: fused_search._launch(
        _m(32, dtype=f32), _m(10, 2, 32, dtype=f32),
        _m(10, 2, dtype=torch.bool), 0.6, 0.4, 0.1)
    yield "K13", lambda: stream_read._launch(_m(16, 64), 1)


def test_every_launch_enters_its_tensors_device(fake):
    lib, _ = fake
    called = set()
    for kernel, call in _launches():
        lib.calls.clear()
        call()
        mine = [c for c in lib.calls if c[0] not in runtime.INIT]
        assert mine, kernel
        for name, dev in mine:
            assert dev == META, (kernel, name, dev)
            called.add(name)
    # the encoder's plan query, on the device it is asked for
    lib.calls.clear()
    encoder_block.cluster_fit(2, device=torch.device("cuda", 1))
    assert [c for c in lib.calls if c[0] not in runtime.INIT] == \
        [("mas_encoder_block_fit", torch.device("cuda", 1))]
    assert runtime.ready_devices() == [0, 1]
    called.add("mas_encoder_block_fit")
    assert called == {
        "mas_encoder_attention", "mas_attn_o_residual",
        "mas_attn_o_residual_paired", "mas_attn_o_residual_ab",
        "mas_attn_o_residual_int8", "mas_attn_o_residual_partial",
        "mas_attn_o_residual_paired_partial",
        "mas_attn_o_residual_int8_partial", "mas_single_query_attention",
        "mas_single_query_attention_f32", "mas_encoder_attention_f32",
        "mas_single_query_attention_int8",
        "mas_single_query_attention_int8_fit", "mas_int8_cached_attention",
        "mas_int8_cached_attention_fit", "mas_decoder_self_block",
        "mas_decoder_self_block_fit", "mas_decoder_mlp_block",
        "mas_decoder_self_block_f32", "mas_decoder_self_block_f32_fit",
        "mas_decoder_mlp_block_f32",
        "mas_cross_mlp_block", "mas_cross_mlp_attention_fit",
        "mas_quant_matmul", "mas_quant_matmul_table", "mas_fused_scores",
        "mas_stream_read", "mas_encoder_block_fit"}
    assert all(runtime.COUNTS[k] for k in (
        "encoder_attention", "single_query_attention", "decoder_self_block",
        "decoder_self_block_q", "decoder_mlp_block", "decoder_mlp_block_o",
        "cross_mlp_block", "quant_matmul", "fused_scores", "stream_read"))


@pytest.mark.parametrize("dtype,k2,k8", [
    (torch.bfloat16, "mas_single_query_attention", "mas_encoder_attention"),
    (torch.float32, "mas_single_query_attention_f32",
     "mas_encoder_attention_f32"),
    (torch.float16, None, None)])
def test_k2_k8_form_by_dtype(fake, dtype, k2, k8):
    """K2 and K8 launch their bf16 or float32 form by the inputs' dtype
    and refuse any other dtype, or a mix, before a launch."""
    lib, _ = fake
    b, h, t = 2, 2, 8
    qm, kv = _m(b, h * 64, dtype=dtype), _m(b, t, h * 64, dtype=dtype)
    q = _m(b, h, t, 64, dtype=dtype)
    calls = ((k2, lambda: cross_attention._launch(qm, kv, kv, h, t)),
             (k8, lambda: attention._launch(q, q, q)))
    for want, call in calls:
        lib.calls.clear()
        if want is None:
            with pytest.raises(TypeError, match="bf16 or float32"):
                call()
        else:
            call()
        assert [c[0] for c in lib.calls if c[0] not in runtime.INIT] == \
            ([want] if want else [])
    mixed = _m(b, t, h * 64, dtype=torch.float32 if dtype != torch.float32
               else torch.bfloat16)
    with pytest.raises(TypeError, match="of one dtype"):
        cross_attention._launch(qm, kv, mixed, h, t)


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, "mas_attn_o_residual"),
    (torch.float32, "mas_attn_o_residual_f32"),
    (torch.float16, None)])
def test_k1_form_by_dtype(fake, dtype, want):
    """K1 launches its bf16 or its float32 form by the inputs' dtype (a
    float32 encode on the card takes the float32 one, on clusters of
    f32_cluster(H) blocks, the merged attention in a scratch of x's
    shape), and refuses any other dtype, or a mix, before a launch. K10,
    K11 and the partial forms K1p and K10p keep to bf16."""
    lib, _ = fake
    b, h, t = 2, 2, 8
    hd = h * 64
    q, x = _m(b, h, t, 64, dtype=dtype), _m(b, t, hd, dtype=dtype)
    wo, bo = _m(hd, hd, dtype=dtype), _m(hd, dtype=dtype)
    launched = lambda: [c[0] for c in lib.calls                # noqa: E731
                        if c[0] not in runtime.INIT
                        and not c[0].endswith("_fit")]
    if want is None:
        with pytest.raises(TypeError, match="bf16 or float32 tensors"):
            encoder_block._launch(q, q, q, x, wo, bo)
    else:
        out = encoder_block._launch(q, q, q, x, wo, bo)
        assert out.dtype == dtype and out.shape == x.shape
        assert runtime.COUNTS["encoder_attn_o_residual"] == 1
    assert launched() == ([want] if want else [])
    other = torch.float32 if dtype != torch.float32 else torch.bfloat16
    with pytest.raises(TypeError, match="of one dtype"):
        encoder_block._launch(q, q, q, _m(b, t, hd, dtype=other), wo, bo)
    if dtype == torch.float32:
        for kw in ({"pair_heads": True}, {"form": "post"}):
            with pytest.raises(TypeError, match="takes bf16 tensors"):
                encoder_block._launch(q, q, q, x, wo, bo, **kw)
        for pair in (False, True):
            with pytest.raises(TypeError, match="takes bf16 tensors"):
                encoder_block._launch_partial(q, q, q, wo, pair_heads=pair)
    assert launched() == ([want] if want else [])


@pytest.mark.parametrize("dtype,self_sym,mlp_sym", [
    (torch.bfloat16, "mas_decoder_self_block", "mas_decoder_mlp_block"),
    (torch.float32, "mas_decoder_self_block_f32",
     "mas_decoder_mlp_block_f32"),
    (torch.float16, None, None)])
def test_k3_k4_form_by_dtype(fake, dtype, self_sym, mlp_sym):
    """K3, K3-q, K4 and K4-o launch their bf16 form on bf16 tensors (the
    layer-norm scales and K4-o's attn float32) and their float32 form
    (csrc/decoder_block_f32.cu) on float32 tensors, each counted under
    its kernel's key, and refuse any other dtype, or a mix, before a
    launch. K3p, K4p and K14 keep to bf16: on float32 they raise, naming
    why."""
    lib, _ = fake
    b, h, t, f = 16, 2, 8, 256
    hd = h * 64
    ln = torch.float32 if dtype == torch.bfloat16 else dtype
    x, vf, vb, w = (_m(b, hd, dtype=dtype), _m(hd, dtype=ln),
                    _m(hd, dtype=dtype), _m(hd, hd, dtype=dtype))
    cache = _m(b, t, hd, dtype=dtype)
    attn = _m(b, hd, dtype=torch.float32 if dtype == torch.bfloat16
              else dtype)
    w1, b1, w2 = (_m(hd, f, dtype=dtype), _m(f, dtype=dtype),
                  _m(f, hd, dtype=dtype))

    def calls(wq=w, fc1=w1):
        selfw = (x, vf, vb, wq, vb, w, w, vb, w, vb)
        mlp = (x, vf, vb, fc1, b1, w2, vb)
        return (
            ("decoder_self_block", self_sym,
             lambda: decoder_block._launch_self(*selfw, cache, cache, 3, h,
                                                1e-5)),
            ("decoder_self_block_q", self_sym,
             lambda: decoder_block._launch_self(*selfw, cache, cache, 3, h,
                                                1e-5, tail=(vf, vb, wq, vb))),
            ("decoder_mlp_block", mlp_sym,
             lambda: decoder_block._launch_mlp(*mlp, 1e-5)),
            ("decoder_mlp_block_o", mlp_sym,
             lambda: decoder_block._launch_mlp(*mlp, 1e-5,
                                               head=(attn, wq, vb))))
    launched = lambda: [c[0] for c in lib.calls                # noqa: E731
                        if c[0] not in runtime.INIT
                        and not c[0].endswith("_fit")]
    for key, want, call in calls():
        lib.calls.clear()
        if want is None:
            with pytest.raises(TypeError, match="bf16 or float32 tensors"):
                call()
        else:
            out = call()
            out = out[0] if isinstance(out, tuple) else out
            assert out.dtype == dtype and out.shape == x.shape
            assert runtime.COUNTS[key] == 1
        assert launched() == ([want] if want else [])
    # a weight of the other dtype: refused before any launch
    other = torch.float32 if dtype != torch.float32 else torch.bfloat16
    lib.calls.clear()
    for _, _, call in calls(_m(hd, hd, dtype=other), _m(hd, f, dtype=other)):
        with pytest.raises(TypeError, match="of one dtype"):
            call()
    assert launched() == []
    if dtype == torch.float32:
        wr = _m(hd, hd // 2, dtype=dtype)
        with pytest.raises(TypeError, match="Q5"):      # K3p
            decoder_block._launch_self(
                x, vf, vb, wr, _m(hd // 2, dtype=dtype), wr, wr,
                _m(hd // 2, dtype=dtype), _m(hd // 2, hd, dtype=dtype), vb,
                _m(b, t, hd // 2, dtype=dtype), _m(b, t, hd // 2,
                                                   dtype=dtype),
                3, 1, 1e-5, partial=True)
        with pytest.raises(TypeError, match="Q5"):      # K4p
            decoder_block._launch_mlp(x, vf, vb, w1, b1, w2, vb, 1e-5,
                                      partial=True)
        with pytest.raises(TypeError, match="no decode step"):   # K14
            decoder_block._launch_cross_mlp(x, vf, vb, w, vb, w, vb, vf, vb,
                                            w1, b1, w2, vb, cache, cache, h,
                                            1e-5)
        assert launched() == []


def test_only_runtime_calls_the_library():
    """No module but runtime.py reaches the library itself: every other
    call goes through runtime.launch, which enters the device."""
    for path in sorted(PKG.rglob("*.py")):
        if path.name == "runtime.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr in (
                        "kernels", "check_launch"):
                raise AssertionError(f"{path.relative_to(PKG)}:"
                                     f"{node.lineno} calls "
                                     f"{node.func.attr}()")
