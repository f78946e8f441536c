"""Interactive streaming generation: 0.5-second windows, like the Colab demo.

Counterpart of examples/interactive_streaming.py: drives the port's
ScorePerformerGenerator the way the reference's interactive notebook does
(reference inference/generators.py flow): encode score + style once, then
repeatedly generate just the notes whose onset falls inside the next
real-time window, converting tokens to (time, pitch, velocity, on/off)
messages incrementally with tempo intermediates carried across windows.

Run (on the GPU; add --device cpu for the CPU):
    python -m scoreperformer_tpu_torch.examples.interactive_streaming [--windows 10] [--window 0.5]
"""
import argparse
import os
import tempfile


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--windows", type=int, default=10)
    parser.add_argument("--window", type=float, default=0.5)
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sp_streaming_example"))
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np

    from scoreperformer_tpu_torch.data import LocalScorePerformanceDataset, MixedLMScorePerformanceCollator
    from scoreperformer_tpu_torch.data.synthetic import build_synthetic_dataset
    from scoreperformer_tpu_torch.device import resolve_device
    from scoreperformer_tpu_torch.inference import ScorePerformerGenerator, SPMuple2Messenger
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer
    from scoreperformer_tpu_torch.training import inject_data_config

    device = resolve_device(args.device)
    root = os.path.join(args.out, "data")
    if not os.path.exists(os.path.join(root, "metadata.json")):
        build_synthetic_dataset(root, n_scores=1, n_perfs_per_score=1,
                                n_bars=10, seed=7, with_directions=False)
    dataset = LocalScorePerformanceDataset(
        root=root, max_seq_len=64, bar_sliding_window=8, fit_to_zero_bar=True,
        add_sos_eos=True, preload=True, auxiliary_data_keys=["bars"],
    )
    collator = MixedLMScorePerformanceCollator(
        mask_ignore_token_ids=[0, 1, 2, 3],
        mask_ignore_token_dims=[0, 1, 2, 4, 6, 7, 8, 9],
    )

    # a randomly initialized tiny model (weights from a seed) keeps the
    # example self-contained; swap in load_model_from_checkpoint(...) for a
    # trained one
    emb = {"_target_": "simple", "emb_dims": 16, "mode": "cat", "emb_norm": True,
           "discrete": False, "continuous": True, "continuous_dense": True,
           "discrete_ids": [0, 1, 2, 3]}
    attn = {"dim_head": 8, "one_kv_head": True, "alibi_pos_bias": True, "alibi_learned": True}
    ff = {"mult": 2, "glu": True, "swish": True}
    enc = {"_target_": "encoder", "depth": 1, "heads": 2, "attention": attn, "feed_forward": ff}
    cfg = inject_data_config({
        "dim": 32, "tie_token_emb": True, "mode": "mixlm",
        "score_encoder": {"token_embeddings": dict(emb), "use_abs_pos_emb": False,
                          "max_seq_len": 66, "transformer": dict(enc)},
        "perf_encoder": {"token_embeddings": dict(emb), "use_abs_pos_emb": False,
                         "max_seq_len": 66, "latent_dim": [8, 6, 4, 2],
                         "aggregate_mode": ["mean", "bar_mean", "beat_mean", "onset_mean"],
                         "max_segments": 64, "hierarchical": True, "transformer": dict(enc)},
        "perf_decoder": {"token_embeddings": {**emb, "_target_": "multi-seq",
                                              "multiseq_mode": "post-cat"},
                         "use_abs_pos_emb": False, "max_seq_len": 66,
                         "context_emb_mode": "cat", "style_emb_mode": "adanorm",
                         "transformer": {"_target_": "decoder", "depth": 1, "heads": 2,
                                         "attention": attn, "feed_forward": ff},
                         "lm_head": {"_target_": "lm-tied"}},
    }, dataset)
    model, _ = build_scoreperformer(cfg, device=device, seed=0)

    generator = ScorePerformerGenerator(model, dataset, collator, SPMuple2Messenger(dataset.tokenizer))

    # encode once, then stream window by window
    generator.reset()
    generator.prepare_performance_notes(0, overlay_bars=0.0)
    # run every decode shape once, so that no real-time window pays a
    # one-off set-up (pass the same sampling config you stream with)
    generator.warmup(max_context_len=48, greedy=True)
    clock = 0.0
    total_notes = 0
    for w in range(args.windows):
        n_ahead = generator.predict_number_of_notes(clock, time_window=args.window)
        gen, messages = generator.generate_performance_notes(
            start_time=clock, time_window=args.window, greedy=True,
            max_context_len=48,
        )
        n_new = 0 if gen is None else len(gen)
        total_notes += n_new
        preview = ""
        if messages is not None and len(messages):
            # message rows are (time, midi_status, pitch, velocity); 0x90 = on
            ons = [m for m in np.asarray(messages) if int(m[1]) == 0x90][:3]
            preview = "  " + " ".join(f"(t={m[0]:.2f} p={int(m[2])} v={int(m[3])})" for m in ons)
        print(f"window {w}: [{clock:.1f}, {clock + args.window:.1f}) "
              f"predicted~{n_ahead} generated {n_new}{preview}")
        clock += args.window
        if generator.perf_data.gen_seq.shape[0] - 1 >= len(dataset.performances[0]):
            print("piece finished")
            break
    print(f"streamed {total_notes} notes over {clock:.1f}s of score time")


if __name__ == "__main__":
    main()
