"""Render expressive performances from score MIDIs with a checkpoint, on the
PyTorch port (the port's copy of the repository's `render.py`).

Usage:
  # one score
  python -m scoreperformer_tpu_torch.render --checkpoint results/.../checkpoint_best \\
      --score score.mid --out performance.mid [--temperature 0.9] [--greedy] [--device cpu]

  # many scores (files and/or directories of .mid) -> one coalesced batched
  # render; --out is a directory
  python -m scoreperformer_tpu_torch.render --checkpoint ... --score a.mid b.mid scores_dir/ --out perfs/

It runs on the GPU unless --device cpu is given.
"""
import argparse
import os


def _collect_scores(args_scores):
    paths = []
    for p in args_scores:
        if os.path.isdir(p):
            paths.extend(sorted(os.path.join(p, f) for f in os.listdir(p) if f.lower().endswith((".mid", ".midi"))))
        else:
            paths.append(p)
    if not paths:
        raise SystemExit("no scores found")
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser(description="ScorePerformer renderer (PyTorch port)")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--score", required=True, nargs="+", help="input score .mid file(s) and/or directories")
    parser.add_argument("--out", required=True, help="output .mid (single score) or directory (several)")
    parser.add_argument("--tokenizer", default=None,
                        help="tokenizer config.json (defaults to the tokenizer.json beside the checkpoint)")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--greedy", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bucket", type=int, default=128, help="length bucket for the batched path")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    tokenizer_path = args.tokenizer
    if tokenizer_path is None:
        base = args.checkpoint if os.path.isdir(args.checkpoint) else os.path.dirname(args.checkpoint)
        tokenizer_path = os.path.join(base, "tokenizer.json")
        if not os.path.exists(tokenizer_path):
            raise SystemExit("--tokenizer is required (no tokenizer.json beside the checkpoint)")

    scores = _collect_scores(args.score)

    from .midi import read_midi

    if len(scores) == 1 and not os.path.isdir(args.out):
        from .inference.render import load_model_from_checkpoint, render_performance
        from .tokenizers import load_tokenizer

        model, _ = load_model_from_checkpoint(args.checkpoint, device=args.device)
        render_performance(
            model, load_tokenizer(tokenizer_path), read_midi(scores[0]), seed=args.seed,
            temperature=args.temperature, greedy=args.greedy, output_path=args.out, device=args.device,
        )
        print(f"rendered {scores[0]} -> {args.out}")
        return

    # several scores: ONE coalesced batched render (length and batch buckets)
    os.makedirs(args.out, exist_ok=True)
    from .inference.server import RenderServer

    server = RenderServer(args.checkpoint, tokenizer_path=tokenizer_path, bucket=args.bucket, device=args.device)
    requests, outs = [], []
    for i, p in enumerate(scores):
        out_path = os.path.join(args.out, f"{os.path.splitext(os.path.basename(p))[0]}.perf.mid")
        outs.append(out_path)
        requests.append(dict(score_midi=read_midi(p), temperature=args.temperature,
                             greedy=args.greedy, seed=args.seed + i, output_path=out_path))
    results = server.render_batch(requests)
    for p, out_path, r in zip(scores, outs, results):
        print(f"rendered {p} -> {out_path} ({r['notes']} notes, batch {r['batched']}, {r['wall_ms']} ms)")


if __name__ == "__main__":
    main()
