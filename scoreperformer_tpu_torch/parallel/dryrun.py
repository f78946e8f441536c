"""The multi-device dry run: the counterpart of __graft_entry__.py's
`dryrun_multichip` (`_dryrun_inproc`), part for part, at its tiny shapes
(dim 32, seq 8).

    python -m scoreperformer_tpu_torch.parallel.dryrun --ranks N [--device cpu]

One launch of N ranks runs every part; each part prints its own `... OK`
line once the parent has held it to one process:
1. train: a tiny ScorePerformer (2 MMD levels, dropout on) through the
   `Trainer` at (N/2 data x 2 model) with ZeRO, with and without sequence
   parallelism, each within 1e-5 of the one-process step;
2. pipeline: a GPipe trunk (depth N/2, learned ALiBi, one KV head) at
   (2 data x N/2 pipe), forward and gradients against the one-process stack;
3. experts: a 4-expert top-2 MoE trunk at (N/2 data x 2 expert), loss (with
   the aux loss) and gradients against one process;
4. composed (N a multiple of 8): (2 data x 2 pipe x 2 model) with sequence
   parallelism, loss and gradients against the one-process stack, then a
   ZeRO-split adam step that lowers the loss.
It runs on the card unless `--device cpu` is given (gloo on the CPU); with
fewer cards than ranks the ranks share them over gloo. No card and no
`--device cpu` raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device

DIM, SEQ = 32, 8
NUM_TOKENS = {"Bar": 260, "Position": 132, "Pitch": 92, "Velocity": 132, "Duration": 133, "Tempo": 125,
              "TimeSig": 26, "PositionShift": 69, "NotesInOnset": 16, "PositionInOnset": 16, "RelOnsetDev": 165,
              "RelPerfDuration": 85}
PERF_DIMS = (3, 5, 10, 11)


def tiny_model_config(mmd_levels: int = 2, max_segments: int = 24) -> Dict[str, Any]:
    """JAX's `_tiny_model_and_batch` model (dim 32, no classifiers)."""
    score_tokens = {k: v for k, v in NUM_TOKENS.items() if k not in ("RelOnsetDev", "RelPerfDuration")}
    emb = {"_target_": "simple", "emb_dims": DIM // 2, "mode": "cat", "emb_norm": True, "discrete": False,
           "continuous": True, "continuous_dense": True, "discrete_ids": [0, 1, 2, 3],
           "token_values": {k: np.linspace(0, 1, v).tolist() for k, v in NUM_TOKENS.items()}}
    attn = {"dim_head": 16, "one_kv_head": True, "dropout": 0.1, "alibi_pos_bias": True, "alibi_learned": True}
    ff = {"mult": 4, "glu": True, "swish": True, "dropout": 0.1}
    enc = {"_target_": "encoder", "depth": 1, "heads": 4, "attention": attn, "feed_forward": ff}
    return {
        "num_tokens": NUM_TOKENS, "num_score_tokens": score_tokens, "dim": DIM, "tie_token_emb": True,
        "mode": "mixlm",
        "score_encoder": {"token_embeddings": dict(emb), "emb_norm": True, "use_abs_pos_emb": False,
                          "max_seq_len": SEQ + 2, "transformer": dict(enc)},
        "perf_encoder": {"token_embeddings": dict(emb), "emb_norm": True, "use_abs_pos_emb": False,
                         "max_seq_len": SEQ + 2, "latent_dim": [32, 20, 8, 4][:mmd_levels],
                         "aggregate_mode": ["mean", "bar_mean", "beat_mean", "onset_mean"][:mmd_levels],
                         "latent_dropout": [0.0, 0.1, 0.2, 0.4][:mmd_levels], "hierarchical": True,
                         "deadpan_zero_latent": True, "max_segments": max_segments, "transformer": dict(enc)},
        "perf_decoder": {"token_embeddings": {**emb, "_target_": "multi-seq", "multiseq_mode": "post-cat"},
                         "emb_norm": True, "use_abs_pos_emb": False, "max_seq_len": SEQ + 2,
                         "context_emb_mode": "cat", "style_emb_mode": "adanorm",
                         "transformer": {"_target_": "decoder", "depth": 1, "heads": 4, "attention": attn,
                                         "feed_forward": ff},
                         "lm_head": {"_target_": "lm-tied"}},
    }


def tiny_batch(batch: int, seq: int = SEQ, max_segments: int = 24, seed: int = 0) -> Dict[str, np.ndarray]:
    """JAX's `_tiny_model_and_batch` batch, from a seed."""
    rng = np.random.RandomState(seed)
    score_tokens = [v for k, v in NUM_TOKENS.items() if k not in ("RelOnsetDev", "RelPerfDuration")]
    perf = np.stack([rng.randint(4, v, (batch, seq)) for v in NUM_TOKENS.values()], -1)
    score = np.stack([rng.randint(4, v, (batch, seq)) for v in score_tokens], -1)
    labels = np.full(perf.shape, -100)
    masked = perf.copy()
    for d in PERF_DIMS:
        labels[..., d] = perf[..., d]
        masked[..., d] = 1
    segments = [np.sort(rng.randint(4, min(top, max_segments), (batch, seq)), 1) for top in (20, 64, seq + 4)]
    ones = np.ones((batch, seq), bool)
    return {"perf": perf, "perf_mask": ones, "score": score, "score_mask": ones, "masked_perf": masked,
            "labels": labels, "bars": segments[0], "beats": segments[1], "onsets": segments[2],
            "deadpan_mask": np.zeros(batch, bool)}


def trunk_payload(depth: int, mesh: Dict[str, int], microbatches: int, seed: int, alibi_mqa: bool = True,
                  **kw) -> Dict[str, Any]:
    """JAX's dry-run trunk (dim 32, 2 causal heads of 16; learned ALiBi and
    one KV head unless `alibi_mqa` is off, as the composed part's) with its
    weights and an (8, 8, 32) input from `seed`."""
    from ..models.transformer import AttentionConfig, TransformerConfig, TransformerStack

    attention = AttentionConfig(dim_head=16, one_kv_head=alibi_mqa, alibi_pos_bias=alibi_mqa,
                                alibi_learned=alibi_mqa)
    cfg = TransformerConfig(dim=DIM, depth=depth, heads=2, causal=True, attention=attention)
    torch.manual_seed(seed)
    stack = TransformerStack(cfg)
    x = torch.from_numpy(np.random.RandomState(seed).randn(8, SEQ, DIM).astype(np.float32))
    return {"config": cfg, "state_dict": {k: v.clone() for k, v in stack.state_dict().items()}, "x": x,
            "mesh": mesh, "microbatches": microbatches, **kw}


def moe_payload(seed: int = 21) -> Dict[str, Any]:
    """JAX's dry-run MoE trunk: depth 2, 4 experts, top-2, capacity 2.0."""
    from ..models.transformer import AttentionConfig, FeedForwardConfig, TransformerConfig, TransformerStack

    cfg = TransformerConfig(dim=DIM, depth=2, heads=2, causal=True,
                            attention=AttentionConfig(dim_head=16, one_kv_head=True),
                            feed_forward=FeedForwardConfig(num_experts=4, expert_top_k=2, capacity_factor=2.0,
                                                           glu=True, swish=True))
    torch.manual_seed(seed)
    stack = TransformerStack(cfg)
    x = torch.from_numpy(np.random.RandomState(seed).randn(8, SEQ, DIM).astype(np.float32))
    return {"config": cfg, "state_dict": {k: v.clone() for k, v in stack.state_dict().items()}, "x": x}


def moe_trunk_step(payload: Dict[str, Any], device, mesh=None) -> Dict[str, Any]:
    """(out**2).mean() plus the MoE aux losses of the payload's trunk and
    its whole gradients, on `mesh` (this rank's rows, experts split) or in
    one process."""
    from ..models.transformer import TransformerStack
    from . import collectives as coll
    from .mesh import DATA_AXIS, ProcessMesh
    from .shard import gather_state_dict, shard_model

    stack = TransformerStack(payload["config"]).to(device).eval()
    stack.load_state_dict(payload["state_dict"])
    x = torch.as_tensor(payload["x"]).to(device)
    mesh = mesh or ProcessMesh()
    specs = shard_model(stack, mesh)
    n, d = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    rows = x.shape[0] // n
    x = x[d * rows:(d + 1) * rows]
    with mesh.activate():
        stats = []
        out = stack(x, mask=torch.ones(x.shape[:2], dtype=torch.bool, device=device), moe_stats=stats)
        count = coll.data_total(torch.tensor(float(out.numel()), device=device))
        loss = (out ** 2).sum() / count + sum(aux for aux, _ in stats)
        loss.backward()
        params = [p for p in stack.parameters() if p.grad is not None]
        flat = coll.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), DATA_AXIS)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)
        grads = gather_state_dict({k: p.grad for k, p in stack.named_parameters()}, specs)
        return {"loss": float(coll.all_reduce(loss.detach(), DATA_AXIS)),
                "grads": {k: v.cpu() for k, v in grads.items()}}


def dryrun_worker(rank: int, world: int, paths: Dict[str, str]) -> Dict[str, Any]:
    """Every part's ranks, in one launch: each part builds its own mesh
    over the same process group."""
    from .mesh import ProcessMesh, rank_device
    from .workers import pipeline_worker, train_worker

    out: Dict[str, Any] = {"train": [train_worker(rank, world, paths["train"]),
                                     train_worker(rank, world, paths["train_sp"])],
                           "pipeline": pipeline_worker(rank, world, paths["pipeline"])}
    payload = torch.load(paths["experts"], weights_only=False)
    device = rank_device(resolve_device(payload["device"]))
    out["experts"] = moe_trunk_step(payload, device, ProcessMesh(data=world // 2, expert=2))
    if "composed" in paths:
        out["composed"] = pipeline_worker(rank, world, paths["composed"])
    return out


def _max_err(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The largest difference of any tensor, over that tensor's largest
    value where it passes 1."""
    if set(got) != set(want):
        raise AssertionError(f"different tensors: {sorted(set(got) ^ set(want))[:4]}")
    return max(float((got[k].float() - w.float()).abs().max() / max(1.0, float(w.abs().max())))
               for k, w in want.items())


def _check(what: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"dryrun {what}: {err:.3g} past {tol:.0e}")


def dryrun(ranks: int, device: str = "cuda") -> Dict[str, Any]:
    """Run the four parts on `ranks` ranks; raise on the first that fails."""
    from .launch import launch
    from .workers import run_one_process, run_trunk_one_process

    dev = resolve_device(device)
    if ranks < 4 or ranks % 2:
        raise ValueError(f"the dry run takes an even number of ranks, at least 4 (got {ranks})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, pipe = ranks // 2, ranks // 2
    batch = max(data * 2, 4)
    backend = None if dev.type == "cpu" or torch.cuda.device_count() >= ranks else "gloo"
    report: Dict[str, Any] = {"ranks": ranks, "device": str(dev), "backend": backend or
                              ("gloo" if dev.type == "cpu" else "nccl")}
    from ..models.factory import build_scoreperformer

    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        model, _ = build_scoreperformer(tiny_model_config(), device="cpu", seed=0)
        train = {"model_name": "ScorePerformer", "model_config": tiny_model_config(),
                 "state_dict": {k: v.clone() for k, v in model.state_dict().items()}, "batch": tiny_batch(batch),
                 "steps": 1, "device": str(dev),
                 "trainer": {"seed": 7, "optimization": {"optimizer": "adamw", "lr": 2e-4, "grad_clip": 2.0},
                             "zero_sharding": True, "mesh_data": data, "mesh_model": 2}}
        payloads = {
            "train": {**train, "output_dir": os.path.join(tmp, "train")},
            "train_sp": {**train, "output_dir": os.path.join(tmp, "train_sp"),
                         "trainer": {**train["trainer"], "sequence_parallel": True}},
            "pipeline": trunk_payload(pipe, {"data": 2, "pipe": pipe}, 2, seed=11, device=str(dev)),
            "experts": {**moe_payload(), "device": str(dev)},
        }
        if ranks % 8 == 0:
            payloads["composed"] = trunk_payload(2, {"data": 2, "pipe": 2, "model": 2}, 2, seed=31,
                                                 alibi_mqa=False, device=str(dev), sequence_parallel=True, steps=1,
                                                 zero_sharding=True, optimization={"optimizer": "adam", "lr": 1e-3})
        paths = {}
        for name, payload in payloads.items():
            paths[name] = os.path.join(tmp, f"{name}.pt")
            torch.save(payload, paths[name])
        one = {"train": run_one_process(payloads["train"], device=dev),
               "pipeline": run_trunk_one_process(payloads["pipeline"], device=dev),
               "experts": moe_trunk_step(payloads["experts"], dev)}
        if "composed" in payloads:
            one["composed"] = run_trunk_one_process(payloads["composed"], device=dev)
        got = launch(dryrun_worker, ranks, (paths,), backend=backend, device=dev.type)[0]

    # 1. the data x model step with ZeRO, without and with sequence parallelism
    losses = [r["metrics"][0]["loss"] for r in got["train"]]
    ref = one["train"]["metrics"][0]["loss"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"dryrun train: non-finite loss {losses}")
    _check("train loss", max(abs(v - ref) for v in losses), 1e-5 * max(1.0, abs(ref)))
    for r in got["train"]:
        _check("train gradients", _max_err(r["grads"], one["train"]["grads"]), 1e-5)
    report["train"] = {"loss": losses, "one_process_loss": ref}
    print(f"dryrun train OK: mesh=({data} data x 2 model), batch={batch}, ZeRO opt-state, loss={losses[0]:.4f}; "
          f"sequence-parallel loss={losses[1]:.4f} matches", flush=True)

    # 2. the GPipe trunk
    pp, ref = got["pipeline"], one["pipeline"]
    _check("pipeline forward", _max_err({"out": pp["out"]}, {"out": ref["out"]}), 1e-5)
    _check("pipeline gradients", _max_err(pp["grads"], ref["grads"]), 1e-4)
    report["pipeline"] = {"loss": pp["losses"][0], "one_process_loss": ref["losses"][0]}
    print(f"dryrun pipeline OK: {pipe}-stage GPipe trunk over (2 data x {pipe} pipe), forward matches one "
          "process, gradients match the one-process trunk", flush=True)

    # 3. the MoE trunk over the expert axis
    ep, ref = got["experts"], one["experts"]
    _check("experts loss", abs(ep["loss"] - ref["loss"]), 1e-5 * max(1.0, abs(ref["loss"])))
    _check("experts gradients", _max_err(ep["grads"], ref["grads"]), 1e-5)
    report["experts"] = {"loss": ep["loss"], "one_process_loss": ref["loss"]}
    print(f"dryrun experts OK: 4-expert MoE trunk over ({ranks // 2} data x 2 expert), loss+grads match one "
          "process (aux load-balance loss included)", flush=True)

    # 4. the composed mesh with sequence parallelism and a ZeRO-split adam step
    if "composed" in got:
        cp, ref = got["composed"], one["composed"]
        _check("composed loss", abs(cp["losses"][0] - ref["losses"][0]), 1e-5 * max(1.0, abs(ref["losses"][0])))
        _check("composed gradients", _max_err(cp["grads"], ref["grads"]), 1e-4)
        if not cp["losses"][1] < cp["losses"][0]:
            raise AssertionError(f"dryrun composed: the adam step did not lower the loss {cp['losses']}")
        report["composed"] = {"losses": cp["losses"], "one_process_losses": ref["losses"]}
        print("dryrun composed OK: (2 data x 2 pipe x 2 model) mesh, GPipe over data/pipe, model-split layers "
              "with a sequence-parallel residual stream, grads match one process, a ZeRO-split adam step "
              f"lowers the loss {cp['losses'][0]:.4f} -> {cp['losses'][1]:.4f}", flush=True)
    return report


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=8)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    dryrun(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
