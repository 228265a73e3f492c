"""Serving daemon over an artifact, on the card.

Port of ``sdxl_training_improvements_tpu/serve.py``:

    python -m sdxl_training_improvements_tpu_torch.serve \\
        --artifact artifacts/sdxl_28step --model /ckpt/base --port 8000

loads the checkpoint, captures the artifact's CUDA graphs
(``aot.AOTPipeline``) and serves them over HTTP.  Standard library only
(``http.server``); PNGs are encoded by ``png.encode_png`` (no Pillow).

Endpoints::

    GET  /healthz   -> {"ok": true, "meta": {...artifact meta...}}
    POST /generate  -> {"images": ["<base64 PNG>", ...], "seed": N}
        body: {"prompts": [...], "negative_prompts": [...]?,
               "seed": int?, "guidance_scale": float?}

The artifact's batch is static: ``prompts`` must hold exactly that many
entries (a 400 names the artifact's batch).  A lock runs one request on
the card at a time; the threaded server overlaps the host work (JSON,
tokenizing, PNG encoding) of the others.
"""
from __future__ import annotations

import argparse
import base64
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Runner:
    """Owns the AOTPipeline and runs one request on the device at a
    time."""

    def __init__(self, aot):
        self.aot = aot
        self._lock = threading.Lock()

    def generate(self, prompts, negative_prompts=None, seed=0,
                 guidance_scale=None):
        with self._lock:
            return self.aot(prompts, negative_prompts=negative_prompts,
                            seed=seed, guidance_scale=guidance_scale)


def _png_b64(img_hwc_uint8) -> str:
    from sdxl_training_improvements_tpu_torch.png import encode_png
    return base64.b64encode(encode_png(img_hwc_uint8)).decode("ascii")


def make_handler(runner: _Runner):
    meta = runner.aot.meta

    class Handler(BaseHTTPRequestHandler):
        # socket read/write timeout: a stalled client cannot hold a server
        # thread (and its place in the device queue) forever
        timeout = 60

        def log_message(self, fmt, *args):  # noqa: D102
            pass  # no line on stderr per request

        def _reply(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "meta": meta})
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/generate":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompts = req.get("prompts")
                if not isinstance(prompts, list) or not all(
                        isinstance(p, str) for p in prompts):
                    raise ValueError('"prompts" must be a list of strings')
                negs = req.get("negative_prompts")
                if negs is not None and (not isinstance(negs, list) or not
                                         all(isinstance(p, str)
                                             for p in negs)):
                    # a bare string would be split into characters
                    raise ValueError(
                        '"negative_prompts" must be a list of strings')
                seed = int(req.get("seed", 0))
                g = req.get("guidance_scale")
                images = runner.generate(
                    prompts, negative_prompts=negs, seed=seed,
                    guidance_scale=None if g is None else float(g))
            except (ValueError, TypeError) as e:
                # TypeError: "seed": null, a non-numeric guidance
                self._reply(400, {"error": str(e),
                                  "artifact_batch": meta["batch"]})
                return
            except Exception as e:  # answer, and keep the thread alive
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {"images": [_png_b64(im) for im in images],
                              "seed": seed})

    return Handler


def build_server(aot, host: str = "127.0.0.1",
                 port: int = 8000) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer ready for ``serve_forever()``; ``port=0``
    picks a free port (``server.server_address[1]``)."""
    return ThreadingHTTPServer((host, port), make_handler(_Runner(aot)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="sdxl-torch-serve",
        description="Serve a text-to-image artifact over HTTP")
    p.add_argument("--artifact", required=True,
                   help="artifact directory from generate --export-aot")
    p.add_argument("--model", required=True,
                   help="diffusers-layout checkpoint (the weights)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--tiny", action="store_true",
                   help="tiny test topology (CI smoke)")
    p.add_argument("--device", default="cuda",
                   help="torch device (the card unless told otherwise)")
    args = p.parse_args(argv)
    from sdxl_training_improvements_tpu_torch.aot import AOTPipeline
    aot = AOTPipeline.from_pretrained(args.artifact, args.model,
                                      tiny=args.tiny, device=args.device)
    server = build_server(aot, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"serving artifact batch={aot.meta['batch']} "
          f"{aot.meta['height']}x{aot.meta['width']} "
          f"steps={aot.meta['num_inference_steps']} on http://{host}:{port}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
