"""Persistent render server: load a checkpoint once, serve many requests.

Counterpart of scoreperformer_tpu/inference/server.py. Scores are padded to
LENGTH BUCKETS and concurrent requests coalesce into power-of-two BATCH
BUCKETS, so one batched encoder pass and one batched chunked decode serve
many requests at once; decode throughput on the GPU grows with the batch, as
it does on the TPU. The JAX server compiles one program per bucket; the port
runs eagerly and has no compile step, so `warmup` only allocates and runs
each bucket once.

Padding correctness (length AND batch padding), as in the JAX server:
- encoder: padded positions carry mask=False; the MMD encoder zeroes masked
  hidden states before aggregation, and padded segment ids are a sentinel
  that the one-hot aggregation clips to max_segments-1;
- decoder: `mixedlm_unmask(valid_len)` is per row; positions at or past
  valid_len are left as they are and the decode is causal, so padded tails
  cannot reach valid positions, and batch-padding rows (valid_len=1) cannot
  reach real rows;
- outputs are cut back to each request's length before detokenization.

Determinism: greedy requests are batch-invariant up to the device's
arithmetic (GPU matrix products may sum in another order at another batch
size). A coalesced SAMPLED batch draws from one `torch.Generator` on the
device, seeded from the requests' seeds by a fixed fold (`fold_seeds`), so
its output is deterministic for a given batch composition. It cannot share
JAX's threefry stream: sampled output never equals the JAX server's.

Wire protocol (`python -m scoreperformer_tpu_torch.serve`): one JSON object
per line, over stdin/stdout or TCP.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..midi import MidiScore
from ..models.wrappers import mixedlm_unmask
from ..ops.sampling import top_k
from ..tokenizers import TokSequence, load_tokenizer
from .render import PERF_STREAMS, load_model_from_checkpoint, prepare_render_inputs

CACHE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def fold_seeds(seeds: Sequence[int]) -> int:
    """One generator seed for a coalesced batch: the first request's seed
    with each later one folded in (a fixed 63-bit polynomial hash)."""
    seed = int(seeds[0])
    for s in seeds[1:]:
        seed = (seed * 1_000_003 + int(s)) % (1 << 63)
    return seed


class RenderServer:
    """Stateful renderer with length- and batch-bucketed batched decoding."""

    def __init__(
        self,
        checkpoint: str,
        tokenizer_path: Optional[str] = None,
        bucket: int = 128,
        max_len: int = 2048,
        cache_dtype: str = "fp32",
        chunk_size: int = 16,
        device: Union[str, torch.device] = "cuda",
    ):
        """`checkpoint` is a port checkpoint directory or a reference `.pt`
        file (`load_model_from_checkpoint`); the tokenizer defaults to the
        `tokenizer.json` beside it. `cache_dtype`: the decoder KV caches'
        precision, "fp32" (default), "bf16", "int8" (quantized prefix with
        per-row scales; not bit-stable against fp32), or "auto", which picks
        int8 at model dim >= 1024 and fp32 below, as the JAX server's
        measured ladder does. `chunk_size`: the chunked decode's chunk."""
        self.device = resolve_device(device)
        self.model, self.model_cfg = load_model_from_checkpoint(checkpoint, device=self.device)
        if not hasattr(self.model, "encode_embeddings"):
            raise TypeError(f"{checkpoint}: the server renders with a ScorePerformer, not a {type(self.model).__name__}")
        if cache_dtype == "auto":
            cache_dtype = "int8" if int(getattr(self.model_cfg, "dim", 0)) >= 1024 else "fp32"
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype {cache_dtype!r} not in {sorted(CACHE_DTYPES)} or 'auto'")
        self.cache_dtype = cache_dtype
        if tokenizer_path is None:
            base = checkpoint if os.path.isdir(checkpoint) else os.path.dirname(checkpoint)
            tokenizer_path = os.path.join(base, "tokenizer.json")
        self.tokenizer = load_tokenizer(tokenizer_path)
        self.bucket = int(bucket)
        self.chunk_size = int(chunk_size)
        # the caches are sized per bucket, but the decoder's max_seq_len
        # bounds usable positions
        dec_max = getattr(self.model_cfg.perf_decoder, "max_seq_len", max_len) or max_len
        self.max_len = min(int(max_len), int(dec_max))
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "errors": 0, "buckets": set(), "batches": {}}
        # the decode fills only the performance streams
        self.sample_dims = tuple(
            int(self.tokenizer.types_idx[k]) for k in PERF_STREAMS if k in self.tokenizer.types_idx
        )
        latent_dim = getattr(self.model_cfg.perf_encoder, "latent_dim", 0)
        self.style_dim = int(sum(latent_dim) if isinstance(latent_dim, (list, tuple)) else latent_dim)

    # ---- helpers ----

    def _bucketed_len(self, T: int) -> int:
        if T > self.max_len:
            raise ValueError(f"score has {T} tokens, server max_len is {self.max_len}")
        return min(self.max_len, -(-T // self.bucket) * self.bucket)

    @staticmethod
    def _bucketed_batch(B: int) -> int:
        """Next power of two: batches of a bucket share their shapes."""
        return 1 << max(0, B - 1).bit_length()

    @staticmethod
    def _pad_to(arr: np.ndarray, T_pad: int, value) -> np.ndarray:
        pad = T_pad - arr.shape[0]
        if pad <= 0:
            return arr
        return np.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1), constant_values=value)

    @torch.inference_mode()
    def _render_step(self, arrays: Dict[str, np.ndarray], valid, deltas, temps, seed: int, greedy: bool):
        """Encoders, style steering and the chunked decode of one padded
        batch; returns the (B_pad, T_pad, S) tokens on the host."""
        dev = self.device

        def on_device(a, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

        T_pad = arrays["deadpan_ids"].shape[1]
        valid_t = on_device(valid)
        mask = torch.arange(T_pad, device=dev)[None, :] < valid_t[:, None]
        score_emb, style_emb, _ = self.model.encode_embeddings(
            on_device(arrays["deadpan_ids"]), mask, on_device(arrays["score_ids"]), mask,
            on_device(arrays["bars"]), on_device(arrays["beats"]), on_device(arrays["onsets"]),
        )
        style = style_emb + on_device(deltas, torch.float32)[:, None, :]
        generator = None
        if not greedy:
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        out = mixedlm_unmask(
            self.model, on_device(arrays["tokens_in"]), on_device(arrays["masked_all"]),
            generator=generator, style_embeddings=style, context=score_emb, valid_len=valid_t,
            temperature=on_device(temps, torch.float32), filter_fn=top_k, greedy=greedy,
            cache_dtype=CACHE_DTYPES[self.cache_dtype], chunk_size=self.chunk_size,
            sample_dims=self.sample_dims,
        )
        return out.cpu().numpy()

    def warmup(self, lengths, greedy_variants=(False,), batch_sizes=(1,)) -> None:
        """Run each (length bucket, batch bucket, greedy flag) once on dummy
        PAD inputs (valid_len=1), so that its allocations and the kernels'
        build happen before the first request. There is no compile step."""
        S = len(self.tokenizer.sizes)
        S_sc = len(getattr(self.tokenizer, "score_sizes", self.tokenizer.sizes))
        for B in batch_sizes:
            B_pad = self._bucketed_batch(int(B))
            for T in lengths:
                T_pad = self._bucketed_len(int(T))
                zeros = np.zeros((B_pad, T_pad), np.int64)
                arrays = {"deadpan_ids": np.zeros((B_pad, T_pad, S), np.int64),
                          "score_ids": np.zeros((B_pad, T_pad, S_sc), np.int64),
                          "bars": zeros, "beats": zeros, "onsets": zeros,
                          "tokens_in": np.zeros((B_pad, T_pad, S), np.int64),
                          "masked_all": np.zeros((B_pad, T_pad, S), np.int64)}
                with self._lock:
                    for greedy in greedy_variants:
                        self._render_step(arrays, np.ones(B_pad, np.int64),
                                          np.zeros((B_pad, self.style_dim), np.float32),
                                          np.ones(B_pad, np.float32), 0, greedy)
                    self.stats["buckets"].add(T_pad)
                    self.stats["batches"].setdefault(B_pad, 0)

    # ---- API ----

    def render(
        self,
        score_midi: MidiScore,
        temperature: float = 1.0,
        greedy: bool = False,
        seed: int = 0,
        style_delta: Optional[np.ndarray] = None,
        output_path: Optional[str] = None,
    ) -> Dict:
        """Render one score; returns {perf, notes, wall_ms, padded_to, ...}.
        `style_delta` (length = the total style latent dim) is added to the
        encoder's style embeddings before decoding."""
        return self.render_batch([
            dict(score_midi=score_midi, temperature=temperature, greedy=greedy,
                 seed=seed, style_delta=style_delta, output_path=output_path)
        ])[0]

    def render_batch(self, requests: Sequence[Dict]) -> List[Dict]:
        """Render several scores as ONE padded batch (dynamic batching).

        Each request dict: {score_midi, temperature?, greedy?, seed?,
        style_delta?, output_path?}. All requests of a batch share the
        `greedy` flag (the serve coalescer groups by it). Returns one result
        dict per request, in order."""
        if not requests:
            return []
        t_start = time.perf_counter()
        greedy = bool(requests[0].get("greedy", False))
        if any(bool(r.get("greedy", False)) != greedy for r in requests):
            raise ValueError("all requests in a batch must share the greedy flag")

        prepared = [prepare_render_inputs(self.tokenizer, r["score_midi"]) for r in requests]
        lens = [len(p["deadpan_ids"]) for p in prepared]
        T_pad = self._bucketed_len(max(lens))
        B = len(requests)
        B_pad = self._bucketed_batch(B)

        # sentinel segment id for the padded tail: clipped to max_segments-1
        # by the one-hot aggregation, a bucket valid notes essentially never use
        sentinel = 10**6

        def stacked(key, value=0):
            rows = [self._pad_to(np.asarray(p[key]), T_pad, value) for p in prepared]
            rows += [np.full_like(rows[0], value)] * (B_pad - B)
            return np.stack(rows)

        arrays = {key: stacked(key) for key in ("deadpan_ids", "score_ids", "tokens_in", "masked_all")}
        arrays.update({key: stacked(key, sentinel) for key in ("bars", "beats", "onsets")})
        valid = np.asarray(lens + [1] * (B_pad - B), np.int64)

        deltas = np.zeros((B_pad, self.style_dim), np.float32)
        for i, r in enumerate(requests):
            sd = r.get("style_delta")
            if sd is None:
                continue
            d = np.asarray(sd, np.float32).reshape(-1)
            if d.shape[0] != self.style_dim:
                raise ValueError(f"style_delta has {d.shape[0]} dims, style embedding has {self.style_dim}")
            deltas[i] = d

        temps = np.asarray([float(r.get("temperature", 1.0)) for r in requests] + [1.0] * (B_pad - B), np.float32)
        seed = fold_seeds([int(r.get("seed", 0)) for r in requests])

        t_prep = time.perf_counter()
        with self._lock:
            out_np = self._render_step(arrays, valid, deltas, temps, seed, greedy)
            t_dec = time.perf_counter()
            self.stats["requests"] += B
            self.stats["buckets"].add(T_pad)
            self.stats["batches"][B_pad] = self.stats["batches"].get(B_pad, 0) + 1
        ms = lambda a, b: round((b - a) * 1000, 2)  # noqa: E731

        results = []
        for i, r in enumerate(requests):
            perf_midi = self.tokenizer.performance_tokens_to_midi(
                TokSequence(ids=out_np[i, : lens[i]]), output_path=r.get("output_path"),
            )
            results.append({
                "perf": perf_midi,
                "tokens": out_np[i, : lens[i]],
                "notes": int(perf_midi.num_notes),
                "wall_ms": ms(t_start, time.perf_counter()),
                "padded_to": T_pad,
                "batched": B_pad,
                "timings": {
                    "prepare_ms": ms(t_start, t_prep),
                    "render_ms": ms(t_prep, t_dec),
                    "detok_ms": ms(t_dec, time.perf_counter()),
                },
            })
        return results

    # ---- wire layer ----

    @staticmethod
    def _parse_request(req: Dict) -> Dict:
        """JSON request dict -> render_batch request dict (raises on error)."""
        from ..midi import read_midi

        if "score" in req:
            score_midi = read_midi(req["score"])
        elif "score_b64" in req:
            import base64

            score_midi = read_midi(base64.b64decode(req["score_b64"]))
        else:
            raise ValueError("request needs 'score' (path) or 'score_b64'")
        return dict(
            score_midi=score_midi,
            temperature=float(req.get("temperature", 1.0)),
            greedy=bool(req.get("greedy", False)),
            seed=int(req.get("seed", 0)),
            style_delta=req.get("style_delta"),
            output_path=req.get("out"),
        )

    def _wire_response(self, rid, req: Dict, result: Dict) -> Dict:
        resp = {"id": rid, "ok": True, "notes": result["notes"],
                "wall_ms": result["wall_ms"], "padded_to": result["padded_to"],
                "batched": result["batched"], "timings": result["timings"]}
        out_path = req.get("out")
        if out_path:
            resp["out"] = out_path
        else:
            import base64

            from ..midi import write_midi

            resp["midi_b64"] = base64.b64encode(write_midi(result["perf"], None)).decode("ascii")
        return resp

    def handle_request(self, req: Dict) -> Dict:
        """One JSON-dict request -> JSON-dict response (wire layer)."""
        return self.handle_batch([req])[0]

    def handle_batch(self, reqs: List[Dict]) -> List[Dict]:
        """Several JSON-dict requests -> responses, rendered in coalesced
        batches (one per greedy-flag group). Per-request parse errors give
        per-request error responses; the rest still render."""
        responses: List[Optional[Dict]] = [None] * len(reqs)
        parsed = []
        for i, req in enumerate(reqs):
            rid = req.get("id")
            if req.get("cmd") == "ping":
                responses[i] = {"id": rid, "ok": True, "pong": True, "requests": self.stats["requests"]}
                continue
            try:
                parsed.append((i, self._parse_request(req)))
            except Exception as e:  # noqa: BLE001 — wire boundary
                with self._lock:
                    self.stats["errors"] += 1
                responses[i] = {"id": rid, "ok": False, "error": f"{type(e).__name__}: {e}"}
        for greedy in (False, True):
            group = [(i, r) for i, r in parsed if r["greedy"] == greedy]
            if not group:
                continue
            try:
                results = self.render_batch([r for _, r in group])
                for (i, _), result in zip(group, results):
                    responses[i] = self._wire_response(reqs[i].get("id"), reqs[i], result)
            except Exception as e:  # noqa: BLE001 — report and keep serving
                with self._lock:
                    self.stats["errors"] += len(group)
                for i, _ in group:
                    responses[i] = {"id": reqs[i].get("id"), "ok": False, "error": f"{type(e).__name__}: {e}"}
        return responses
