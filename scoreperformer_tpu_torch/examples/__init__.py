"""The JAX package's examples (`examples/`) as modules of the port:
`python -m scoreperformer_tpu_torch.examples.interactive_streaming` and
`python -m scoreperformer_tpu_torch.examples.train_render_lifecycle`."""
