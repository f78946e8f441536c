"""Training entry point of the PyTorch port (counterpart of train.py).

Usage: python -m scoreperformer_tpu_torch.train -r recipes -n scoreperformer/base.yaml [--device cpu]

It runs on the GPU unless asked for the CPU (`--device cpu`). base.yaml, the
paper's recipe, trains the direction classifiers on a dataset with direction
labels (`python -m scoreperformer_tpu_torch.prepare_dataset` writes one from
MIDI pairs and MusicXML scores); no_classifiers.yaml needs none.
performer.yaml trains the standalone Performer LM on the same dataset layout.
"""
import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a recipe's model (ScorePerformer or Performer) with the PyTorch port")
    parser.add_argument("-r", "--root", type=str, default="recipes", help="config root dir")
    parser.add_argument("-n", "--name", type=str, required=True, help="config name (yaml)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--eval-only", action="store_true")
    args = parser.parse_args(argv)

    from scoreperformer_tpu_torch.training import ExperimentComponents

    components = ExperimentComponents.from_yaml(args.root, args.name, device=args.device)
    components.init_components()
    if args.eval_only:
        print(components.trainer.evaluate())
    else:
        components.trainer.train()


if __name__ == "__main__":
    main()
