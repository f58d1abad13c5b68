"""Transcription CLI: audio → word-timestamp JSON (and optionally VTT).

    python -m latentsync_tpu_torch.scripts.transcribe --audio a.wav [--out t.json]
        [--vtt t.vtt] [--language en] [--model tiny|small] [--device cuda]

Counterpart of ``scripts/transcribe.py``: prints (or writes to ``--out``)
``{"segments": [{start, end, text, words: [{word, start, end}]}]}``, the
structure the worker's helpers consume. The weights come from the whisper
``.pt`` that ``$LATENTSYNC_WHISPER_CKPT`` names (random, with a warning,
without one) and the vocab from the directory ``$LATENTSYNC_WHISPER_VOCAB``
names (``vocab.json`` + ``merges.txt``; required). Runs on the card unless
``--device cpu``.
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--audio", required=True)
    p.add_argument("--out", help="output JSON path (default: stdout)")
    p.add_argument("--vtt", help="also write a WEBVTT subtitle file here")
    p.add_argument("--language", default="en")
    p.add_argument("--model", default="tiny", choices=["tiny", "small"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..audio.transcribe import make_transcriber
    from ..config import WhisperConfig

    cfg = WhisperConfig.tiny() if args.model == "tiny" else WhisperConfig.small()
    transcriber = make_transcriber(cfg, language=args.language, device=args.device)
    segments = transcriber(args.audio)
    out = json.dumps({"segments": segments}, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    else:
        print(out)
    if args.vtt:
        from ..serving.helpers import add_line_breaks_to_vtt, segments_to_vtt

        with open(args.vtt, "w") as f:
            f.write(add_line_breaks_to_vtt(segments_to_vtt(segments)))


if __name__ == "__main__":
    main()
