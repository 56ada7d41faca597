"""Minimal production-style txt2img server (stdlib HTTP, micro-batching), on one NVIDIA card.

    python -m refiners_tpu_torch.examples.serve_txt2img --model sdxl --weights-dir ~/weights \
        --port 8000 --max-batch 4

    curl -s localhost:8000/generate -d '{"prompt": "a lighthouse at dawn"}' \
        | jq -r .image_base64 | base64 -d > out.png

The port's counterpart of ``examples/serve_txt2img.py``: the same HTTP layer
(``POST /generate`` with ``prompt``, ``negative_prompt`` and ``seed``;
``GET /healthz``) and an engine on the port's `TextToImage` in bfloat16.

- The weights are the port's converted files in its own layout
  (``python -m refiners_tpu_torch.conversion.cli``): ``<stem>.safetensors``
  under ``--weights-dir`` for the UNet, the VAE and the text encoder
  (``sdxl.unet``, ``sdxl.autoencoder``, ``sdxl.text_encoder``, or the
  ``sd15.`` ones), loaded once, strictly, on the card.
- Requests are micro-batched: a background worker drains the queue up to
  ``--max-batch`` and serves the jobs it took one after the other, each
  with its own seed, on the model that stays on the card.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path


@dataclass
class _Job:
    prompt: str
    negative: str
    seed: int
    done: threading.Event = field(default_factory=threading.Event)
    image_png: bytes | None = None
    error: str | None = None


class _Engine:
    """Owns the model and the micro-batching worker thread."""

    def __init__(self, model: str, weights_dir: Path, steps: int, size: int, max_batch: int) -> None:
        import torch

        from refiners_tpu_torch.foundationals.latent_diffusion import DDIM
        from refiners_tpu_torch.pipelines import TextToImage

        if model == "sdxl":
            from refiners_tpu_torch.foundationals.latent_diffusion import StableDiffusion_XL

            sd = StableDiffusion_XL(solver=DDIM(num_inference_steps=steps), dtype=torch.bfloat16)
            names = {"unet": "sdxl.unet", "lda": "sdxl.autoencoder", "clip_text_encoder": "sdxl.text_encoder"}
        else:
            from refiners_tpu_torch.foundationals.latent_diffusion import StableDiffusion_1

            sd = StableDiffusion_1(solver=DDIM(num_inference_steps=steps), dtype=torch.bfloat16)
            names = {"unet": "sd15.unet", "lda": "sd15.autoencoder", "clip_text_encoder": "sd15.text_encoder"}
        for attr, stem in names.items():
            getattr(sd, attr).load_from_safetensors(weights_dir / f"{stem}.safetensors")

        self.pipe = TextToImage(sd, size=(size, size))
        self.max_batch = max_batch
        self.queue: "queue.Queue[_Job]" = queue.Queue()
        threading.Thread(target=self._worker, daemon=True).start()

    def submit(self, job: _Job) -> None:
        self.queue.put(job)

    def _worker(self) -> None:
        while True:
            jobs = [self.queue.get()]
            while len(jobs) < self.max_batch:
                try:
                    jobs.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            try:
                for job in jobs:
                    image = self.pipe(job.prompt, negative_prompt=job.negative, seed=job.seed)
                    buf = io.BytesIO()
                    image.save(buf, format="PNG")
                    job.image_png = buf.getvalue()
            except Exception as e:  # surface errors to the requester
                for job in jobs:
                    job.error = f"{type(e).__name__}: {e}"
            finally:
                for job in jobs:
                    job.done.set()


def _make_handler(engine: _Engine):
    class Handler(BaseHTTPRequestHandler):
        def do_POST(self) -> None:  # noqa: N802 (stdlib naming)
            if self.path != "/generate":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", "0"))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                job = _Job(
                    prompt=body["prompt"],
                    negative=body.get("negative_prompt", ""),
                    seed=int(body.get("seed", 0)),
                )
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self.send_error(400, str(e))
                return
            engine.submit(job)
            job.done.wait()
            if job.error is not None:
                payload = json.dumps({"error": job.error}).encode()
                self.send_response(500)
            else:
                assert job.image_png is not None
                payload = json.dumps({"image_base64": base64.b64encode(job.image_png).decode()}).encode()
                self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self) -> None:  # noqa: N802
            if self.path != "/healthz":
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

    return Handler


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["sd15", "sdxl"], default="sdxl")
    p.add_argument("--weights-dir", type=Path, required=True)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=4)
    args = p.parse_args()

    size = args.size or (1024 if args.model == "sdxl" else 512)
    engine = _Engine(args.model, args.weights_dir, args.steps, size, args.max_batch)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), _make_handler(engine))
    print(f"serving {args.model} on :{args.port} (steps={args.steps}, size={size})")
    server.serve_forever()


if __name__ == "__main__":
    main()
