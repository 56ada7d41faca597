"""The port's serving example (``refiners_tpu_torch/examples/serve_txt2img.py``):
its HTTP layer as ``tests/test_serve_example.py`` holds the JAX example's (no
weights), and its engine's worker on the port's `TextToImage` over a reduced
SD1.5 on the CPU."""

import base64
import http.client
import io
import json
import queue
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from refiners_tpu_torch.examples.serve_txt2img import _Engine, _Job, _make_handler


class _FakeEngine:
    """Resolves every job with a 1-byte 'image' without touching a model."""

    def submit(self, job: _Job) -> None:
        if job.prompt == "boom":
            job.error = "ValueError: boom"
        else:
            job.image_png = b"\x89PNG-fake"
        job.done.set()


def _request(port: int, method: str, path: str, body: dict | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request(method, path, json.dumps(body) if body is not None else None)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_serve_http_layer() -> None:
    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(_FakeEngine()))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, data = _request(port, "GET", "/healthz")
        assert (status, data) == (200, b"ok")

        status, data = _request(port, "POST", "/generate", {"prompt": "a cat", "seed": 3})
        assert status == 200
        assert base64.b64decode(json.loads(data)["image_base64"]) == b"\x89PNG-fake"

        status, _ = _request(port, "POST", "/generate", {"negative_prompt": "no prompt key"})
        assert status == 400

        status, data = _request(port, "POST", "/generate", {"prompt": "boom"})
        assert status == 500
        assert "boom" in json.loads(data)["error"]

        status, _ = _request(port, "GET", "/nope")
        assert status == 404
    finally:
        server.shutdown()


def test_engine_serves_the_pipeline_and_builds_on_the_card_only(tmp_path) -> None:
    """The worker serves each job through the port's `TextToImage` (a PNG of
    the pipeline's image for the job's seed), micro-batched, and reports a
    job's error; building the engine needs the card (no fallback here)."""
    from torch_mesh_group import FakeLDA, FakeTextEncoder

    from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, SD1UNet, StableDiffusion_1
    from refiners_tpu_torch.pipelines import TextToImage

    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            _Engine("sd15", tmp_path, steps=1, size=64, max_batch=2)
    sd = StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=32, device="cpu"), lda=FakeLDA(), clip_text_encoder=FakeTextEncoder(),
        solver=DDIM(num_inference_steps=2, device="cpu"), device="cpu",
    )  # fmt: skip
    pipe = TextToImage(sd, size=(64, 64))
    engine = object.__new__(_Engine)
    engine.pipe, engine.max_batch = pipe, 2
    engine.queue = queue.Queue()
    threading.Thread(target=engine._worker, daemon=True).start()
    jobs = [_Job(prompt="a cat", negative="", seed=seed) for seed in (1, 2)]
    for job in jobs:
        engine.submit(job)
    for job in jobs:
        assert job.done.wait(timeout=120)
        assert job.error is None
        got = Image.open(io.BytesIO(job.image_png))
        want = pipe("a cat", seed=job.seed)
        assert got.size == (64, 64) and np.array_equal(np.asarray(got), np.asarray(want))
    bad = _Job(prompt=None, negative="", seed=0)  # type: ignore[arg-type]
    engine.submit(bad)
    assert bad.done.wait(timeout=120)
    assert bad.error is not None and bad.image_png is None
