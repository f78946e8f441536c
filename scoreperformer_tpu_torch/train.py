"""Training entry point of the PyTorch port (counterpart of train.py).

Usage: python -m scoreperformer_tpu_torch.train -r recipes -n scoreperformer/base.yaml [--device cpu]

It runs on the GPU unless asked for the CPU (`--device cpu`). base.yaml, the
paper's recipe, trains the direction classifiers on a dataset with direction
labels (`python -m scoreperformer_tpu_torch.prepare_dataset` writes one from
MIDI pairs and MusicXML scores); no_classifiers.yaml needs none.
performer.yaml trains the standalone Performer LM on the same dataset layout.

On several processes, torchrun starts it:
    torchrun --nproc-per-node 2 -m scoreperformer_tpu_torch.train -r ... -n ... [--device cpu]
(nccl on cards, gloo on the CPU), or each process of a recipe whose trainer
sets `multihost` with `coordinator_address`, `num_processes` and
`process_id`. The trainer's `mesh_data`, `mesh_model` and `mesh_expert` lay
the processes out.
"""
import argparse


def main(argv=None):
    """Train (or evaluate) a recipe; returns its `ExperimentComponents`."""
    parser = argparse.ArgumentParser(description="Train a recipe's model (ScorePerformer or Performer) with the PyTorch port")
    parser.add_argument("-r", "--root", type=str, default="recipes", help="config root dir")
    parser.add_argument("-n", "--name", type=str, required=True, help="config name (yaml)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--eval-only", action="store_true")
    args = parser.parse_args(argv)

    from types import SimpleNamespace

    import torch.distributed as dist

    from scoreperformer_tpu_torch.configs import load_experiment_config
    from scoreperformer_tpu_torch.parallel import maybe_distributed_initialize, rank_device
    from scoreperformer_tpu_torch.training import ExperimentComponents

    # the process group starts before anything is built (JAX's train.py
    # starts jax.distributed here): from the recipe's multihost fields, else
    # from torchrun's environment; one process starts none
    config = load_experiment_config(args.root, args.name)
    trainer = config.get("trainer") or {}
    fields = ("coordinator_address", "num_processes", "process_id")
    multihost = SimpleNamespace(**{k: trainer.get(k) if trainer.get("multihost") else None for k in fields})
    started = maybe_distributed_initialize(multihost, args.device)
    components = ExperimentComponents(config=config, device=rank_device(args.device))
    try:
        components.init_components()
        if args.eval_only:
            print(components.trainer.evaluate())
        else:
            components.trainer.train()
    finally:
        if started:
            dist.destroy_process_group()
    return components


if __name__ == "__main__":
    main()
