"""Interactive demo UI (the port's counterpart of ``scripts/gradio_app.py``;
ref:gradio_app.py:12-52).

    python -m latentsync_tpu_torch.scripts.gradio_app [--port 7860] \\
        [--unet-config tiny.yaml] [--device cpu]

Uses gradio where it is installed; otherwise serves a small HTML form over
the standard library's HTTP server that drives the same inference function:
``scripts/inference.build_pipeline``'s pipeline on a video and an audio
path (and, optionally, the avatar's onboarded bundle, ``data``), with the
guidance scale, the DDIM steps and the seed. The card unless ``--device
cpu``; seeded random weights where a checkpoint file is missing.
"""

from __future__ import annotations

import argparse
import html
import os
import sys
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

FORM = """<html><body><h2>LatentSync demo</h2>
<form method=post>
video path: <input name=video size=60><br>
audio path: <input name=audio size=60><br>
bundle (.npz, optional): <input name=data size=60><br>
guidance: <input name=guidance value=1.5>
steps: <input name=steps value=20>
seed: <input name=seed value=1247><br>
<input type=submit value=Run></form>{result}</body></html>"""


def build_infer(args):
    """The inference function: (video, audio, guidance, steps, seed, data)
    → the output video's path (in ``args.out_dir``, or a new temporary
    directory)."""
    from .inference import build_pipeline

    pipe = build_pipeline(args)
    out_dir = getattr(args, "out_dir", "") or ""

    def infer(video_path, audio_path, guidance_scale=1.5, inference_steps=20, seed=1247,
              data_path=None):
        root = out_dir or tempfile.mkdtemp()
        os.makedirs(root, exist_ok=True)
        out = os.path.join(root, f"out_{len(os.listdir(root))}.mp4")
        result = pipe(video_path=video_path, audio_path=audio_path, video_out_path=out,
                      guidance_scale=float(guidance_scale),
                      num_inference_steps=int(inference_steps), seed=int(seed),
                      data_path=data_path or None)
        return result.video_path

    return infer


def make_server(infer, host: str, port: int) -> ThreadingHTTPServer:
    """The standard library's form: GET shows it, POST runs `infer` and
    shows the output path or the error."""

    class Handler(BaseHTTPRequestHandler):
        def _page(self, result: str):
            body = FORM.format(result=result).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._page("")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            fields = parse_qs(self.rfile.read(length).decode())
            try:
                out = infer(fields["video"][0], fields["audio"][0],
                            fields.get("guidance", ["1.5"])[0], fields.get("steps", ["20"])[0],
                            fields.get("seed", ["1247"])[0], fields.get("data", [""])[0])
                result = f"<p>done: {html.escape(out)}</p>"
            except Exception as e:  # noqa: BLE001 — the page shows it
                result = f"<p>error: {html.escape(str(e))}</p>"
            self._page(result)

        def log_message(self, fmt, *args):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--unet-config", default="")
    p.add_argument("--unet-ckpt", default="checkpoints/latentsync_unet.pt")
    p.add_argument("--vae-ckpt", default="checkpoints/sd-vae-ft-mse.pt")
    p.add_argument("--whisper-ckpt", default="checkpoints/whisper/tiny.pt")
    p.add_argument("--out-dir", default="", help="where outputs go (a temporary directory "
                                                 "a request by default)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from .inference import no_card

    if no_card("gradio_app", args.device):
        return 2
    infer = build_infer(args)
    try:
        import gradio as gr
    except ImportError:
        gr = None
    if gr is not None:
        demo = gr.Interface(
            fn=lambda v, a, g, s, seed: infer(v, a, g, s, seed),
            inputs=[gr.Video(label="Input video"),
                    gr.Audio(label="Input audio", type="filepath"),
                    gr.Slider(1.0, 3.0, value=1.5, label="Guidance scale"),
                    gr.Slider(10, 50, value=20, step=1, label="Inference steps"),
                    gr.Number(value=1247, label="Seed")],
            outputs=gr.Video(label="Lip-synced output"), title="LatentSync")
        demo.launch(server_name=args.host, server_port=args.port)
        return 0
    server = make_server(infer, args.host, args.port)
    print(f"demo UI on {args.host}:{server.server_address[1]} (gradio not installed; the "
          "standard library's form)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
