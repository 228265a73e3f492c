"""PyTorch port: the HTTP serving daemon (``serve.py``) over the CPU.

The cases of the JAX package's ``tests/test_serve.py`` on the port: a
ThreadingHTTPServer on an ephemeral port over a tiny artifact's
``AOTPipeline`` (no capture on the CPU): health, a generation whose PNG,
read back by the port's ``png.read_png``, equals the pipeline's image,
determinism per seed, 400 on a batch mismatch, bad payloads and type
errors, concurrent clients, and 404 on unknown routes.
"""
import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu_torch import png
from sdxl_training_improvements_tpu_torch.aot import (
    AOTPipeline, export_text2img)
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
from sdxl_training_improvements_tpu_torch.serve import build_server


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu")
    pipe = SDXLPipeline.from_model(model)
    art = export_text2img(pipe, tmp_path_factory.mktemp("aot"), batch=1,
                          height=32, width=32, num_inference_steps=2)
    aot = AOTPipeline.load(art, model, pipe.tokenizers, device="cpu")
    server = build_server(aot, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}", aot
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _image(b64, tmp_path):
    path = tmp_path / "served.png"
    path.write_bytes(base64.b64decode(b64))
    return png.read_png(path)


def test_healthz(served):
    url, _ = served
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        body = json.loads(r.read())
    assert body["ok"] is True
    assert body["meta"]["batch"] == 1
    assert body["meta"]["num_inference_steps"] == 2


def test_generate_png_roundtrip(served, tmp_path):
    url, aot = served
    status, body = _post(url + "/generate", {"prompts": ["a cat"],
                                             "seed": 7,
                                             "guidance_scale": 3.0})
    assert status == 200 and body["seed"] == 7
    img = _image(body["images"][0], tmp_path)
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(
        img, aot(["a cat"], seed=7, guidance_scale=3.0)[0])


def test_deterministic_per_seed(served):
    url, _ = served
    a = _post(url + "/generate", {"prompts": ["x"], "seed": 1})[1]
    b = _post(url + "/generate", {"prompts": ["x"], "seed": 1})[1]
    c = _post(url + "/generate", {"prompts": ["x"], "seed": 2})[1]
    assert a["images"][0] == b["images"][0]
    assert a["images"][0] != c["images"][0]


def test_batch_mismatch_is_400(served):
    url, _ = served
    status, body = _post(url + "/generate", {"prompts": ["a", "b"]})
    assert status == 400
    assert body["artifact_batch"] == 1


def test_bad_payloads_are_400(served):
    url, _ = served
    assert _post(url + "/generate", {})[0] == 400
    assert _post(url + "/generate", {"prompts": "x"})[0] == 400
    assert _post(url + "/generate", {"prompts": [3]})[0] == 400


def test_type_errors_are_400(served):
    """seed null, a non-numeric guidance, a bare-string negative_prompts:
    client errors, not 500s."""
    url, _ = served
    assert _post(url + "/generate",
                 {"prompts": ["x"], "seed": None})[0] == 400
    assert _post(url + "/generate",
                 {"prompts": ["x"], "guidance_scale": [1.0]})[0] == 400
    status, body = _post(url + "/generate", {"prompts": ["x"],
                                             "negative_prompts": "blurry"})
    assert status == 400
    assert "negative_prompts" in body["error"]


def test_concurrent_clients(served):
    """Four clients in flight: all succeed, the runner's lock serializes
    the device work, same-seed requests agree."""
    url, _ = served
    results = {}

    def hit(name, seed):
        results[name] = _post(url + "/generate",
                              {"prompts": ["x"], "seed": seed})

    threads = [threading.Thread(target=hit, args=(f"c{i}", i % 2))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert all(r[0] == 200 for r in results.values()), results
    assert results["c0"][1]["images"][0] == results["c2"][1]["images"][0]
    assert results["c0"][1]["images"][0] != results["c1"][1]["images"][0]


def test_unknown_routes_404(served):
    url, _ = served
    assert _post(url + "/nope", {})[0] == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(url + "/nope", timeout=60)
    assert ei.value.code == 404
