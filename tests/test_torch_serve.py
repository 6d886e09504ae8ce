"""The port's serving path (aod_meh_hua_torch/tools/deployment/serve.py)
against the JAX package's (tools/deployment/serve.py), its profiling
helpers (utils/profiling.py) and the FPS tool (tools/benchmark.py), on
the CPU, f32.

Weights: tests/torch_parity.py jax_retinanet draws on the tiny config,
the cls head sharpened (kernel x150) so that there are detections; the
port loads them with from_jax_variables. The JAX server's classes run
in this process, on the CPU.

Tolerances: the Batcher's coalesced results equal the single Detector
calls to rtol 1e-5 (atol 1e-4; the batch changes the sums' order, as in
tests/test_torch_api.py); the HTTP replies hold the JAX server's rows in
the same order, with the same class names, boxes and scores to rtol
1e-4 (atol 1e-4): the port's JPEG decoder is bit-equal to OpenCV's, and
the two libraries' convolutions sum in other orders.
"""

import base64
import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request
from contextlib import contextmanager
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest
import torch

from aod_meh_hua_tpu import api as japi
from aod_meh_hua_tpu.data import PipelineConfig as JPipelineConfig
from aod_meh_hua_tpu.utils.config import tiny_test_config as jtiny
from aod_meh_hua_torch import api as tapi
from aod_meh_hua_torch.data.pipeline import PipelineConfig
from aod_meh_hua_torch.data.voc import VOC_CLASSES
from aod_meh_hua_torch.models.convert import from_jax_variables
from aod_meh_hua_torch.tools import benchmark
from aod_meh_hua_torch.tools.deployment import serve
from aod_meh_hua_torch.utils import profiling
from aod_meh_hua_torch.utils.config import tiny_test_config as ttiny

from torch_parity import few_threads  # noqa: F401 (the fixture of pytestmark)
from torch_parity import jax_retinanet, sharpen

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.join(os.path.dirname(__file__), "..")
SHARPEN = 150.0
SCORE_THR = 0.1
WAIT_S = 120  # every join and request in this file


def _jax_serve():
    spec = importlib.util.spec_from_file_location(
        "jax_serve", os.path.join(REPO, "tools", "deployment", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pipe(cls):
    h, w = ttiny().canvas
    return cls(img_scale=(max(h, w), min(h, w)), canvas=(h, w), device_normalize=True)


def _images(n=4):
    r = np.random.RandomState(7)
    shapes = [(40, 80), (80, 40), (50, 90), (36, 70), (70, 36), (60, 100)]
    return [(r.rand(h, w, 3) * 255).astype(np.uint8) for h, w in shapes[:n]]


@pytest.fixture(scope="module")
def shared():
    jmodel, variables = jax_retinanet()
    variables = sharpen(variables, SHARPEN)
    model = tapi.init_detector(ttiny(), device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    return (japi.Detector(jtiny(), jmodel, variables, pipeline=_pipe(JPipelineConfig)),
            tapi.Detector(ttiny(), model, pipeline=_pipe(PipelineConfig)))


def _assert_same(got, want, rtol):
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"class {c}: {g.shape} vs {w.shape}"
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-4, err_msg=f"class {c}")


def _concurrently(fn, n):
    """fn(i) in n threads started together; their results (or exceptions)
    in order; every thread joined within WAIT_S."""
    out = [None] * n
    start = threading.Barrier(n)

    def run(i):
        start.wait()
        try:
            out[i] = fn(i)
        except Exception as e:  # handed back to the test
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads), "a caller did not return"
    return out


class _Spy:
    """A detector that records every predict_batch call."""

    def __init__(self, det):
        self.det, self.calls = det, []

    def predict_batch(self, images, max_batch=8):
        self.calls.append(len(images))
        return self.det.predict_batch(images, max_batch=max_batch)


def test_batcher_coalesces_concurrent_callers(shared):
    _, tdet = shared
    imgs = _images(4)
    want = [tdet(im) for im in imgs]
    spy = _Spy(tdet)
    batcher = serve.Batcher(spy, max_batch=4, delay_ms=5000.0)
    try:
        got = _concurrently(lambda i: batcher.predict(imgs[i]), len(imgs))
    finally:
        batcher.close()
    assert spy.calls == [4]
    for g, w in zip(got, want):
        _assert_same(g, w, rtol=1e-5)
    assert sum(len(a) for g in got for a in g) > 0


def test_batcher_hands_an_error_to_every_waiter():
    class Boom:
        def __init__(self):
            self.n = 0

        def predict_batch(self, images, max_batch=8):
            self.n += 1
            if self.n == 1:
                raise RuntimeError("boom")
            return [len(images)] * len(images)

    batcher = serve.Batcher(Boom(), max_batch=3, delay_ms=5000.0)
    try:
        got = _concurrently(lambda i: batcher.predict(i), 3)
        assert all(isinstance(g, RuntimeError) and str(g) == "boom" for g in got), got
        # the worker survives the failed batch
        assert _concurrently(lambda i: batcher.predict(i), 3) == [3, 3, 3]
    finally:
        batcher.close()
    assert not batcher._thread.is_alive()


@contextmanager
def _server(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    handler.log_message = lambda *a: None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(WAIT_S)


def _call(url, data=None):
    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _jpeg(img):
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


def test_http_replies_match_jax(shared):
    jdet, tdet = shared
    jserve = _jax_serve()
    classes = VOC_CLASSES[:ttiny().num_fg_classes]
    tb = serve.Batcher(tdet, max_batch=2, delay_ms=1.0)
    jb = jserve.Batcher(jdet, max_batch=2, delay_ms=1.0)
    try:
        with _server(serve.make_handler(tb, classes, SCORE_THR)) as turl, \
                _server(jserve.make_handler(jb, classes, SCORE_THR)) as jurl:
            assert _call(turl + "/ping") == (200, {"status": "Healthy"})
            assert _call(turl + "/nope")[0] == 404
            n_rows = 0
            for img in _images(3):
                raw = _jpeg(img)
                for payload in (raw, base64.b64encode(raw)):
                    code, got = _call(turl + "/predictions", payload)
                    jcode, want = _call(jurl + "/predictions", payload)
                    assert code == jcode == 200
                    assert [r["class_name"] for r in got] == [r["class_name"] for r in want]
                    for g, w in zip(got, want):
                        np.testing.assert_allclose(g["bbox"] + [g["score"]],
                                                   w["bbox"] + [w["score"]],
                                                   rtol=1e-4, atol=1e-4)
                        assert g["score"] >= SCORE_THR
                    n_rows += len(got)
            assert n_rows > 0
            ok, png = cv2.imencode(".png", _images(1)[0])
            assert _call(turl + "/predictions", png.tobytes()) == (
                400, {"error": "undecodable image payload"})
            assert _call(turl + "/predictions", b"not-an-image")[0] == 400
    finally:
        tb.close()


def test_handler_answers_500_on_a_failed_batch():
    class Boom:
        def predict_batch(self, images, max_batch=8):
            raise RuntimeError("boom")

    batcher = serve.Batcher(Boom(), max_batch=2, delay_ms=1.0)
    try:
        with _server(serve.make_handler(batcher, VOC_CLASSES, 0.5)) as url:
            code, body = _call(url + "/predictions", _jpeg(_images(1)[0]))
        assert (code, body) == (500, {"error": "RuntimeError: boom"})
    finally:
        batcher.close()


def test_profile_time_and_compiled_cost(capsys):
    x = torch.randn(64, 64)
    with profiling.profile_time("matmul", device="cpu"):
        y = x @ x
    line = capsys.readouterr().out.strip()
    assert line.startswith("matmul: ") and line.endswith(" ms")
    assert float(line.split()[1]) >= 0
    cost = profiling.compiled_cost(lambda a: a @ a, x)
    assert cost["flops"] == 2 * 64 ** 3 and np.isnan(cost["bytes_accessed"])
    assert torch.equal(y, x @ x)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), cuda=False) as prof:
        torch.randn(32, 32).sum()
    assert prof.key_averages()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_benchmark_runs_on_the_tiny_config():
    out = benchmark.benchmark(ttiny(), batch=2, iters=2, warmup=1, device="cpu")
    assert out["img_per_s"] > 0 and out["device"] == "cpu"
    with pytest.raises(NotImplementedError, match="item 16"):
        benchmark.main(["--dtype", "bfloat16", "--cpu"])
    with pytest.raises(NotImplementedError, match="item 15"):
        benchmark.main(["--family", "fcos", "--cpu"])
