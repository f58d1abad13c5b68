"""The data-processing pipeline from the command line (the port's
counterpart of ``scripts/data_processing_pipeline.py``;
ref:data_processing_pipeline.sh → preprocess/data_processing_pipeline.py).

    python -m latentsync_tpu_torch.scripts.data_processing_pipeline \\
        --input raw_videos/ --output data/ [--fileslist files.txt] \\
        [--with-quality-gate] [--min-sync-conf 3] [--max-av-offset 6] \\
        [--min-iqa 40] [--device cpu]

Runs ``preprocess/pipeline.DataProcessingPipeline``'s eight stages (each
prints its count) with the reference's thresholds unless told otherwise;
``--with-quality-gate`` adds the HyperIQA scorer. As in the JAX CLI, the
SyncNet and HyperIQA scorers have seeded random weights (the permissive
gates ``--min-sync-conf -1e9 --max-av-offset 1000000 --min-iqa -1e9`` let
every clip through them). The model stages run on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--fileslist", default="")
    p.add_argument("--with-quality-gate", action="store_true",
                   help="enable the HyperIQA visual-quality stage")
    p.add_argument("--min-sync-conf", type=float, default=3.0,
                   help="SyncNet confidence gate (ref README.md:148)")
    p.add_argument("--max-av-offset", type=int, default=6)
    p.add_argument("--min-iqa", type=float, default=40.0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from .inference import no_card

    if no_card("data_processing_pipeline", args.device):
        return 2
    from ..preprocess.pipeline import DataProcessingPipeline, write_fileslist

    scorer = None
    if args.with_quality_gate:
        from ..models.hyper_iqa import HyperIQAScorer

        scorer = HyperIQAScorer(device=args.device)
    pipe = DataProcessingPipeline(
        output_root=args.output, resolution=args.resolution, quality_scorer=scorer,
        min_sync_conf=args.min_sync_conf, max_av_offset=args.max_av_offset, min_iqa=args.min_iqa, device=args.device)
    files = pipe.run(args.input)
    if args.fileslist:
        write_fileslist(files, args.fileslist)
        print(f"wrote {len(files)} paths to {args.fileslist}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
