"""Prepare a training dataset from score/performance MIDI pairs with the port.

Counterpart of the repo's root prepare_dataset.py (the same layout and
flags), importing only this package. It runs on the host alone.

Layout convention: a directory of pieces, each
  <root>/<piece>/score.mid + <root>/<piece>/*.mid [+ score.musicxml|.xml|.mxl]

Usage:
  python -m scoreperformer_tpu_torch.prepare_dataset --input raw_midis/ --output dataset/ \\
      [--tokenization SPMupleWindow] [--splits train=0.9,eval=0.1] [--workers 4]
"""
import argparse
import glob
import os


def discover_pairs(root):
    pairs, directions = [], {}
    for entry in sorted(os.listdir(root)):
        piece_dir = os.path.join(root, entry)
        if os.path.isdir(piece_dir):
            score = os.path.join(piece_dir, "score.mid")
            if not os.path.exists(score):
                continue
            perfs = sorted(
                p for p in glob.glob(os.path.join(piece_dir, "*.mid"))
                if os.path.basename(p) != "score.mid"
            )
            if perfs:
                pairs.append((entry, score, perfs))
            for ext in (".musicxml", ".xml", ".mxl"):
                xml = os.path.join(piece_dir, "score" + ext)
                if os.path.exists(xml):
                    directions[entry] = xml
                    break
    return pairs, directions


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--tokenization", default="SPMupleWindow")
    parser.add_argument("--max-bar-embedding", type=int, default=256)
    parser.add_argument("--splits", default=None, help="e.g. train=0.9,eval=0.1")
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument(
        "--workers", type=int, default=0,
        help="parallel piece tokenization processes (0/1 = serial; outputs identical)",
    )
    args = parser.parse_args(argv)

    from scoreperformer_tpu_torch.data.prepare import prepare_dataset
    from scoreperformer_tpu_torch.tokenizers import TokenizerConfig

    pairs, directions = discover_pairs(args.input)
    if not pairs:
        raise SystemExit(f"no (score.mid, perf*.mid) pairs found under {args.input}")
    print(f"found {len(pairs)} pieces, {sum(len(p[2]) for p in pairs)} performances")

    splits = None
    if args.splits:
        splits = {
            name: float(ratio)
            for name, ratio in (part.split("=") for part in args.splits.split(","))
        }

    prepare_dataset(
        pairs,
        args.output,
        tokenization=args.tokenization,
        tokenizer_config=TokenizerConfig(
            additional_params={"max_bar_embedding": args.max_bar_embedding}
        ),
        directions=directions or None,
        splits=splits,
        seed=args.seed,
        workers=args.workers,
    )
    print(f"dataset written to {args.output}")


if __name__ == "__main__":
    main()
