"""End-to-end lifecycle on a synthetic dataset: prepare -> train -> render.

Counterpart of examples/train_render_lifecycle.py, the script-sized
counterpart of the reference's Colab demo: it builds a tiny synthetic
score/performance corpus, trains the smoke ScorePerformer recipe
(recipes/smoke.yaml) for a few epochs, and renders a fresh score with the
trained checkpoint.

Run (on the GPU; add --device cpu for the CPU):
    python -m scoreperformer_tpu_torch.examples.train_render_lifecycle [--epochs 6] [--out <dir>]
"""
import argparse
import os
import tempfile
from pathlib import Path

RECIPES = Path(__file__).resolve().parents[2] / "recipes"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=6)
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sp_example"))
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np

    from scoreperformer_tpu_torch.data.synthetic import build_synthetic_dataset, synthetic_score
    from scoreperformer_tpu_torch.device import resolve_device
    from scoreperformer_tpu_torch.inference import load_model_from_checkpoint, render_performance
    from scoreperformer_tpu_torch.midi import write_midi
    from scoreperformer_tpu_torch.tokenizers import load_tokenizer
    from scoreperformer_tpu_torch.training import ExperimentComponents

    device = resolve_device(args.device)
    data_root = os.path.join(args.out, "data")
    run_dir = os.path.join(args.out, "run")

    # 1) synthetic corpus (scores + expressive performances + directions)
    if not os.path.exists(os.path.join(data_root, "metadata.json")):
        build_synthetic_dataset(data_root, n_scores=4, n_perfs_per_score=2,
                                n_bars=12, seed=1, splits=True)
    print(f"dataset at {data_root}")

    # 2) train the smoke recipe against it
    comps = ExperimentComponents.from_yaml(str(RECIPES), "smoke.yaml", device=device)
    comps.config["data"]["dataset"]["root"] = data_root
    comps.config["data"]["dataset"]["performance_directions"] = os.path.join(
        data_root, "direction_classes.json")
    comps.config["data"]["dataset"]["score_directions_dict"] = os.path.join(
        data_root, "score_directions.json")
    comps.init_components()
    comps.trainer.config.epochs = args.epochs
    comps.trainer.config.output_dir = run_dir
    state = comps.trainer.train()
    losses = [l for l in state.log_history if "train/loss" in l]
    print(f"trained {args.epochs} epochs: loss {losses[0]['train/loss']:.3f} -> "
          f"{losses[-1]['train/loss']:.3f}")

    # 3) render a brand-new score with the trained checkpoint
    ckpt = os.path.join(run_dir, "checkpoint_last")
    model, _ = load_model_from_checkpoint(ckpt, device=device)
    tokenizer = load_tokenizer(os.path.join(ckpt, "tokenizer.json"))

    score = synthetic_score(np.random.RandomState(99), n_bars=8)
    score_path = os.path.join(args.out, "new_score.mid")
    perf_path = os.path.join(args.out, "rendered_performance.mid")
    write_midi(score, score_path)
    perf = render_performance(model, tokenizer, score, seed=3, output_path=perf_path, device=device)
    print(f"rendered {perf.num_notes} notes: {score_path} -> {perf_path}")


if __name__ == "__main__":
    main()
