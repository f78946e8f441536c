"""Real-time streaming performance generator.

Counterpart of scoreperformer_tpu/inference/generator.py: renders a piece
chord-group by chord-group inside a wall-clock time window, with a sliding
`max_context_len` window shifted at bar boundaries.

`StreamingDecoder` holds ONE static KV cache of `max_context_len` rows that
the decoder's `decode_step` writes in place (`write_kv_pair`, one launch a
layer and call). Known rows are consumed in chunks of `CHUNKS` rows, each
chunk one causal `decode_step`; a block of new notes is decoded by a Python
loop of single-row steps that sample on the device, with one device-to-host
copy of the block's rows. A window shift resets the cache and re-consumes
the window, as the JAX decoder does.

Sampling cannot share JAX's threefry stream. It keeps the property that the
JAX package builds from `fold_in(rng, note)`: the Gumbel noise of a note's
stream is a hash of (seed, absolute note index, stream column, token id)
alone (`gumbel_noise`), so one seed samples the same tokens whether a note
is decoded in a block or on its own, on the CPU and on the card alike.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.wrappers import NEG_INF, batched_column_mask, batched_top_k
from ..ops.sampling import apply_temperature, top_k
from ..tokenizers import EOS, MASK, PAD, SOS, SPMuple2
from ..utils import find_closest
from .messengers import IntermediateData, SPMuple2IntermediateData, SPMupleMessenger

# the JAX decoder's largest block bucket: the note estimate that sizes the
# blocks looks two such blocks ahead, so both packages cut windows alike
MAX_BLOCK = 64


def _hash32(x: np.ndarray) -> np.ndarray:
    """A 32-bit integer mixer (lowbias32) over uint32 arrays, wrapping."""
    x = np.atleast_1d(np.asarray(x, dtype=np.uint32))
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def gumbel_noise(seed: int, notes, cols, vocab: int) -> np.ndarray:
    """(len(notes), len(cols), vocab) float32 Gumbel noise for the token ids
    of stream columns `cols` at absolute note indices `notes`: each entry a
    function of (seed, note, column, id) alone. Adding it to logits and
    taking the argmax draws from their softmax (the Gumbel-max trick, which
    jax.random.categorical uses too)."""
    key = _hash32(_hash32(np.uint32(seed & 0xFFFFFFFF)) ^ np.asarray(notes, dtype=np.uint32))
    key = _hash32(key[:, None] ^ _hash32(np.asarray(cols, dtype=np.uint32) + np.uint32(0x9E3779B9))[None])
    ids = _hash32(np.arange(vocab, dtype=np.uint32) * np.uint32(0x85EBCA6B) + np.uint32(0x27D4EB2F))
    h = _hash32(key[..., None] ^ ids)
    u = ((h >> np.uint32(8)).astype(np.float64) + 0.5) / 2.0**24  # in (0, 1)
    return (-np.log(-np.log(u))).astype(np.float32)


class _StreamSampler:
    """Fills the MASK entries of the sampled stream columns of a row from
    one step's logits, on the logits' device: greedy, or top-k (any
    `filter_fn`) at a temperature with `gumbel_noise`. PAD and MASK ids are
    never drawn. Greedy and top-k pick every stream at once from the logits
    stacked into one (1, S, Vmax) tensor, as `mixedlm_unmask` does; another
    filter runs stream by stream."""

    def __init__(self, model, cols, greedy: bool, filter_fn: Callable, filter_kwargs: Optional[Dict], device):
        streams = model.config.num_tokens
        names = list(streams)
        self.cols = tuple(int(c) for c in cols)
        self.keys = [names[c] for c in self.cols]
        self.sizes = [streams[k] for k in self.keys]
        self.vmax = max(self.sizes, default=1)
        self.greedy, self.filter_fn = greedy, filter_fn
        self.filter_kwargs = dict(filter_kwargs or {})
        self.batched = greedy or filter_fn is top_k
        self.col_index = torch.tensor(self.cols, dtype=torch.int64, device=device)
        self.col_mask = batched_column_mask(self.sizes, PAD, MASK).to(device)
        if self.batched and not greedy:
            thres, k = self.filter_kwargs.get("thres", 0.9), self.filter_kwargs.get("k")
            self.ks = torch.tensor([max(1, min(int(k) if k else int(np.ceil((1 - thres) * V)), V))
                                    for V in self.sizes], device=device)

    def noise(self, seed: int, notes, device) -> Optional[torch.Tensor]:
        if self.greedy:
            return None
        return torch.from_numpy(gumbel_noise(seed, notes, self.cols, self.vmax)).to(device)

    def __call__(self, logits: Dict[str, torch.Tensor], row: torch.Tensor, noise, temperature) -> torch.Tensor:
        """`row` (1, S) with MASK where a sampled stream is to be filled;
        `noise` (len(cols), Vmax) for this note. Returns the filled row."""
        if not self.cols:
            return row
        if self.batched:
            lg = torch.stack([F.pad(logits[k].float(), (0, self.vmax - logits[k].shape[-1]), value=NEG_INF)
                              for k in self.keys], dim=1) + self.col_mask
            if not self.greedy:
                lg = apply_temperature(batched_top_k(lg, self.ks), temperature) + noise
            samples = lg.argmax(dim=-1)
        else:
            samples = []
            for s, (key, V) in enumerate(zip(self.keys, self.sizes)):
                lg = logits[key].float().clone()
                lg[:, PAD] = NEG_INF
                lg[:, MASK] = NEG_INF
                if self.greedy:
                    samples.append(lg.argmax(dim=-1))
                else:
                    filtered = apply_temperature(self.filter_fn(lg, **self.filter_kwargs), temperature)
                    samples.append((filtered + noise[s, :V]).argmax(dim=-1))
            samples = torch.stack(samples, dim=-1)
        target = row[:, self.col_index]
        out = row.clone()
        out[:, self.col_index] = torch.where(target == MASK, samples.to(row.dtype), target)
        return out


class StreamingDecoder:
    """MixedLM decoder with a persistent static KV cache.

    Known tokens are consumed in chunks of `CHUNKS` rows, each chunk ONE
    causal `decode_step` (the cached attend writes KV rows [start, start+C)
    and masks each query to the keys at or before it). When the caller does
    not need the returned logits, the tail chunk is padded UP to the
    smallest chunk that fits the cache, so a catch-up takes at most two
    calls, as in the JAX decoder, whose chunk sizes the port keeps. Unlike
    it, `predict` consumes the row whose logits it returns in a call of its
    own, and a block decodes only its real rows (see `decode_block`).
    """

    CHUNKS = (128, 64, 8, 1)

    def __init__(self, model, max_context_len: int, num_streams: int):
        self.model = model
        self.device = next(model.parameters()).device
        self.max_context_len = max_context_len
        self.num_streams = num_streams
        self.caches = None
        self.consumed = 0  # number of tokens written into the cache
        self._cache0 = None
        # cache positions as device views: a call's start is a slice of this,
        # never a host-to-device copy
        self._positions = torch.arange(max_context_len + 1, dtype=torch.int64, device=self.device)
        self._samplers: Dict = {}
        # measurement counters: consume calls and tokens, block calls, the
        # rows they decoded (one decode step each), block refusals (a block
        # past the cache -> the caller's per-note path) and resets
        self.stats = {"consume_calls": 0, "consumed_tokens": 0,
                      "block_calls": 0, "block_steps": 0, "block_refusals": 0, "resets": 0,
                      "consume_wall_s": 0.0, "block_wall_s": 0.0}

    def reset(self):
        self.caches = None
        self.consumed = 0
        self.stats["resets"] += 1

    def _init_cache(self):
        """The zero KV cache, allocated on the device once. The decode writes
        its rows in place, so a later call gets it zeroed again, never with
        the rows an earlier window wrote."""
        if self._cache0 is None:
            self._cache0 = self.model.init_decoder_cache(1, self.max_context_len, device=self.device)
        else:
            torch._foreach_zero_([t for layer in self._cache0 if layer is not None for t in layer.values()])
        return self._cache0

    def _rows(self, a, lo: int, hi: int, dtype) -> Optional[torch.Tensor]:
        """Rows [lo, hi) of the host array `a` as a (1, hi-lo, ...) tensor on
        the device, the array's last row repeated past its end."""
        if a is None:
            return None
        a = np.asarray(a)
        rows = a[lo:hi]
        if rows.shape[0] < hi - lo:
            rows = np.concatenate([rows, np.repeat(a[-1:], hi - lo - rows.shape[0], axis=0)], axis=0)
        return torch.as_tensor(rows[None], dtype=dtype).to(self.device)

    def _step(self, seq, masked, style, ctx, start: int, need_logits: bool = True):
        """Consume `seq` (1, C, S) at cache rows [start, start+C); returns the
        logits at position start+C (None without `need_logits`). masked,
        style and ctx are the +1-aligned companions."""
        hidden = self.model.decode_step(
            seq, masked_tokens=masked, style_embeddings=style, context=ctx,
            caches=self.caches, cache_index=self._positions[start : start + 1],
        )
        return self.model.decoder.apply_lm_head(hidden[:, -1]) if need_logits else None

    @torch.inference_mode()
    def predict(self, tokens, masked_tokens, style, context, position: int) -> Dict[str, torch.Tensor]:
        """Consume final tokens up to `position`-1 and return the logits for
        `position`, per stream, on the device. tokens: (T, S) numpy;
        style/context: (T, D) or None. Row `position`-1 is consumed in a call
        of its own (the JAX decoder takes it in the catch-up's last chunk)."""
        if self.caches is None:
            self.caches = self._init_cache()
            self.consumed = 0

        assert position >= 1, "position 0 has no preceding token to consume"
        if self.consumed >= position:
            # a previous speculative decode consumed at or past this position
            # (its tokens were discarded at the window cut): re-consume the
            # final row so the logits reflect the current window content.
            # Stale rows beyond `position` are masked by the attend's causal
            # check and overwritten on re-consume.
            self.consumed = position - 1
        if self.consumed < position - 1:
            # the rows before the last one in padded chunks, as a block's
            # catch-up takes them, and the last row alone, as a block's step
            # takes it: the per-note and block paths compute the same logits
            self._consume_to(tokens, masked_tokens, style, context, position - 1, need_logits=False)
        return self._consume_to(tokens, masked_tokens, style, context, position)

    def _consume_to(self, tokens, masked_tokens, style, context, position, need_logits=True):
        """Consume token rows [consumed, position); returns the logits of the
        final consume call (logits for row `position`), or None when already
        caught up or without `need_logits`.

        Without `need_logits` the tail chunk is PADDED UP to the smallest
        chunk that fits the cache, taking the rows that follow (the array's
        last row repeated past its end). The padded rows write K/V at cache
        rows [position, j+C) that only a later call reads, after writing them
        again: queries run only at the write frontier. The rows of all
        chunks go to the device in one copy of each array."""
        t0 = time.perf_counter()
        plan, j = [], self.consumed
        while j < position:
            remaining = position - j
            C = real = next(c for c in self.CHUNKS if c <= remaining)
            if not need_logits:
                for b in reversed(self.CHUNKS):
                    if b >= remaining and j + b <= self.max_context_len:
                        C, real = b, remaining
                        break
            plan.append((j, C))
            j += real
        logits = None
        if plan:
            lo, hi = plan[0][0], max(j0 + C for j0, C in plan)
            seq = self._rows(tokens, lo, hi, torch.int64)
            masked = self._rows(masked_tokens, lo + 1, hi + 1, torch.int64)
            style = self._rows(style, lo + 1, hi + 1, torch.float32)
            ctx = self._rows(context, lo + 1, hi + 1, torch.float32)

            def sl(a, j0, C):
                return None if a is None else a[:, j0 - lo : j0 - lo + C]

            for k, (j0, C) in enumerate(plan):
                last = k == len(plan) - 1
                logits = self._step(sl(seq, j0, C), sl(masked, j0, C), sl(style, j0, C), sl(ctx, j0, C), j0,
                                    need_logits=need_logits and last)
                self.stats["consume_calls"] += 1
            self.stats["consumed_tokens"] += j - self.consumed
            self.consumed = j
        self.stats["consume_wall_s"] += time.perf_counter() - t0
        return logits

    def rollback(self, position: int):
        """Logical rollback: mark tokens from `position` as not consumed (the
        cache rows will simply be overwritten)."""
        self.consumed = min(self.consumed, position)

    def _sampler(self, mask_cols, greedy, filter_fn, filter_kwargs) -> _StreamSampler:
        key = (tuple(mask_cols), bool(greedy), filter_fn, tuple(sorted((filter_kwargs or {}).items())))
        sampler = self._samplers.get(key)
        if sampler is None:
            sampler = self._samplers[key] = _StreamSampler(self.model, mask_cols, greedy, filter_fn, filter_kwargs,
                                                           self.device)
        return sampler

    @torch.inference_mode()
    def warmup(self, style_dim=None, ctx_dim=None, *, greedy=False, temperature=1.0, filter_kwargs=None,
               mask_cols=(), filter_fn=top_k):
        """Run every decode-path shape once against zero-filled inputs: one
        consume call per `CHUNKS` size that fits the cache, each of them
        explicitly (the JAX decoder's peel of the chunks misses the 64 chunk
        when 130 < max_context_len <= 201), and one block of 4 steps with
        the given sampling configuration; then reset. The first real window
        then pays no one-off library and allocator set-up."""
        T = self.max_context_len
        toks = np.zeros((T + 2, self.num_streams), dtype=np.int64)
        style = np.zeros((T + 2, style_dim), np.float32) if style_dim else None
        ctx = np.zeros((T + 2, ctx_dim), np.float32) if ctx_dim else None
        self.caches = self._init_cache()
        self.consumed = 0
        for C in self.CHUNKS:
            if C <= T - 1:
                self.consumed = 0
                self._consume_to(toks, toks, style, ctx, C)
        if T >= 5:
            self.decode_block(toks, toks, style, ctx, 1, 4, 0, 0, greedy, temperature, filter_kwargs,
                              tuple(mask_cols), filter_fn)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reset()

    @torch.inference_mode()
    def decode_block(self, tokens, masked_tokens, style, context, first, n, note_base, seed, greedy, temperature,
                     filter_kwargs, mask_cols, filter_fn=top_k):
        """Decode rows [first, first+n) of `tokens`, sampling on the device,
        with one device-to-host copy of the decoded rows.

        Catches the cache up to the block start (padded chunks), then runs n
        single-row steps: step k consumes row first+k-1 (known, or the row
        step k-1 decoded) and fills row first+k's MASK entries in the
        `mask_cols` streams. Row k's noise comes from note `note_base + k`.
        Returns the (n, S) decoded rows as numpy, or None (a refusal: the
        caller takes the per-note path) when the block would run past the
        cache.

        The JAX decoder runs blocks as compiled scans over bucket sizes (4 to
        64): it decodes padded rows past the block's end, refuses a block
        larger than every bucket, and left-aligns a bucket near the cache's
        end over rows it already decoded. The port compiles nothing, so it
        decodes just the n real rows: the same tokens, with no speculative
        steps, no bucket to left-align and no refusal inside the cache."""
        if self.caches is None:
            self.caches = self._init_cache()
            self.consumed = 0
        if self.consumed >= first:
            self.consumed = max(0, first - 1)
        if first < 1 or first - 1 + n > self.max_context_len:
            self.stats["block_refusals"] += 1
            return None
        self.stats["block_calls"] += 1
        self.stats["block_steps"] += n

        if self.consumed < first - 1:
            # the block consumes row first-1 itself, so the catch-up's final
            # logits are unused -> padded (fewest-call) chunks
            self._consume_to(tokens, masked_tokens, style, context, first - 1, need_logits=False)

        t0 = time.perf_counter()
        sampler = self._sampler(mask_cols, greedy, filter_fn, filter_kwargs)
        noise = sampler.noise(seed, np.arange(note_base, note_base + n), self.device)
        rows = self._rows(tokens, first - 1, first + n, torch.int64)  # the known row, then the block
        masked = self._rows(masked_tokens, first, first + n, torch.int64)
        style = self._rows(style, first, first + n, torch.float32)
        ctx = self._rows(context, first, first + n, torch.float32)

        prev, out = rows[:, :1], []
        for k in range(n):
            logits = self._step(prev, masked[:, k : k + 1], None if style is None else style[:, k : k + 1],
                                None if ctx is None else ctx[:, k : k + 1], first - 1 + k)
            row = sampler(logits, rows[:, k + 1], None if noise is None else noise[k], temperature)
            out.append(row)
            prev = row[:, None]
        self.consumed = first + n - 1
        decoded = torch.cat(out, dim=0).cpu().numpy()
        self.stats["block_wall_s"] += time.perf_counter() - t0
        return decoded


@dataclass
class PerformanceData:
    perf_seq: Optional[np.ndarray] = None
    notes: Optional[np.ndarray] = None
    embeddings: Optional[np.ndarray] = None
    context: Optional[np.ndarray] = None
    gen_seq: Optional[np.ndarray] = None
    intermediates: Optional[IntermediateData] = None
    reached_eos: bool = False


class ScorePerformerGenerator:
    """(generators.py:35-443 of the reference.) `model` is a port
    `ScorePerformerModel` on the device the generator runs on: the GPU, or
    the CPU when it was built there."""

    def __init__(self, model, dataset, collator, messenger: SPMupleMessenger):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.dataset = dataset
        self.tokenizer = dataset.tokenizer
        self.collator = collator
        self.messenger = messenger

        self.sos_token_id = SOS
        self.eos_token_id = EOS

        num_dims = len(self.tokenizer.sizes)
        self.mask_dims = np.array(
            sorted(set(range(num_dims)) - set(self.collator.mask_ignore_token_dims))
        )

        self.perf_data = PerformanceData()
        self._decoder: Optional[StreamingDecoder] = None
        self._last_window_start = 0

    def reset(self):
        self.perf_data = PerformanceData()
        if self._decoder is not None:
            self._decoder.reset()

    # ---- preparation (generators.py:68-104) ----

    def prepare_performance_notes(
        self,
        perf_idx: int,
        score_embeddings: Optional[np.ndarray] = None,
        perf_embeddings: Optional[np.ndarray] = None,
        overlay_bars: float = 0.5,
    ) -> PerformanceData:
        perf_seq = self.dataset.performances[perf_idx]
        self.perf_data.perf_seq = perf_seq

        initial_tempo = 120.0
        if isinstance(self.tokenizer, SPMuple2) and hasattr(self.dataset, "initial_tempos"):
            initial_tempo = self.dataset.initial_tempos[
                self.dataset.performance_names[perf_idx]
            ]

        perf_seq = self.dataset.processor.add_sos_token(perf_seq)
        perf_seq = self.dataset.processor.add_eos_token(perf_seq)

        need_emb = perf_embeddings is None or score_embeddings is None
        if need_emb:
            score_embeddings, perf_embeddings, _ = self.encode_embeddings(
                perf_idx, overlay_bars=overlay_bars
            )

        perf_notes = perf_seq.copy()
        perf_notes[1:-1][:, self.mask_dims] = MASK

        self.perf_data.notes = perf_notes
        self.perf_data.embeddings = np.asarray(perf_embeddings) if perf_embeddings is not None else None
        self.perf_data.context = np.asarray(score_embeddings) if score_embeddings is not None else None

        if isinstance(self.tokenizer, SPMuple2):
            self.perf_data.intermediates = SPMuple2IntermediateData(initial_tempo=initial_tempo)

        return self.perf_data

    # ---- chunked encoder pass (generators.py:320-426) ----

    def _tensor(self, a):
        a = np.asarray(a)
        return torch.as_tensor(a, dtype=torch.bool if a.dtype == bool else torch.int64).to(self.device)

    @torch.inference_mode()
    def encode_embeddings(
        self, perf_idx: int, compute_latents: bool = False, overlay_bars: float = 0.0
    ):
        """Score and style embeddings of the whole performance, from encoder
        passes over windows of `dataset.max_seq_len` notes (overlapping by
        `overlay_bars` of a window), bars re-based to zero in each; with
        `compute_latents`, the style encoder's per-level latents of them."""
        from ..data.collators import scoreperformer_model_inputs
        from ..data.datasets import ScorePerformanceSampleMeta, get_end_bar

        dataset = self.dataset
        perf = dataset.performance_names[perf_idx]
        score, _ = dataset._performance_map[perf]
        score_idx = dataset.scores._name_to_idx[score]
        score_indices = dataset._score_indices[score_idx]
        if score_indices is None:
            score_indices = dataset.indexer.compute_bar_indices(dataset.scores[score_idx])
            dataset._score_indices[score_idx] = score_indices

        bar_col = self.tokenizer.types_idx["Bar"]
        z = self.tokenizer.zero_token
        score_seq = dataset.scores[score_idx]

        start_bar = 0
        end_bar = get_end_bar(score_indices, start_bar, dataset.max_seq_len, dataset.max_bar)
        meta = ScorePerformanceSampleMeta(
            idx=None, score_idx=score_idx, perf_idx=perf_idx,
            start_bar=start_bar, end_bar=end_bar,
        )
        sample = dataset.get(meta=meta)

        emb_start_bar = start_bar
        score_embeddings, perf_embeddings = [], []
        while True:
            has_sos = sample.score[0, 0] == self.sos_token_id
            has_eos = sample.score[-1, 0] == self.eos_token_id
            first_note_idx = int(has_sos)
            last_note_idx = sample.score.shape[0] - int(has_eos)
            last_perf_idx = sample.perf.shape[0] - int(has_eos)

            inputs = scoreperformer_model_inputs(self.collator([sample]))

            # re-base bars to zero (generators.py:362-366)
            shift = inputs["score"][0, first_note_idx, bar_col] - z
            inputs["score"][0, first_note_idx:last_note_idx, bar_col] -= shift
            inputs["perf"][0, first_note_idx:last_perf_idx, bar_col] -= shift

            score_emb, perf_emb, _ = self.model.encode_embeddings(
                *(self._tensor(inputs[k])
                  for k in ("perf", "perf_mask", "score", "score_mask", "bars", "beats", "onsets"))
            )

            n_notes = sample.score.shape[0]
            note_cut_idx = 0
            if overlay_bars:
                hits = np.where(sample.score[:, bar_col] - z >= emb_start_bar)[0]
                note_cut_idx = (int(hits[0]) - first_note_idx) if len(hits) else 0

            if score_emb is not None:
                score_embeddings.append(score_emb[0, note_cut_idx:n_notes].cpu().numpy())
            if perf_emb is not None:
                perf_embeddings.append(perf_emb[0, note_cut_idx:n_notes].cpu().numpy())

            if has_eos:
                break

            if overlay_bars:
                start_bar = int(
                    sample.score[int(sample.score.shape[0] * (1 - overlay_bars)), 0] - z
                )
                emb_start_bar = end_bar + 1
            else:
                emb_start_bar = start_bar = end_bar + 1
            end_bar = get_end_bar(score_indices, start_bar, dataset.max_seq_len, dataset.max_bar)
            meta.start_bar, meta.end_bar = start_bar, end_bar
            sample = dataset.get(meta=meta)

        score_embeddings = np.concatenate(score_embeddings, 0) if score_embeddings else None
        perf_embeddings = np.concatenate(perf_embeddings, 0) if perf_embeddings else None

        latents = None
        if compute_latents and perf_embeddings is not None:
            bars, beats, onsets = (
                self._tensor(np.concatenate([[s[0]], s, [s[-1]]])[None])
                for s in (score_seq[:, 0], dataset._beat_maps[score_idx], dataset._onset_maps[score_idx])
            )
            latents = self.model.perf_encoder.embeddings_to_latents(
                torch.as_tensor(perf_embeddings[None]).to(self.device), bars=bars, beats=beats, onsets=onsets,
            )

        return score_embeddings, perf_embeddings, latents

    # ---- streaming generation (generators.py:106-295) ----

    def _new_decoder(self, max_context_len: int):
        if self._decoder is None or self._decoder.max_context_len != max_context_len:
            self._decoder = StreamingDecoder(self.model, max_context_len, len(self.tokenizer.sizes))
        return self._decoder

    def warmup(
        self,
        max_context_len: int = 512,
        *,
        greedy: bool = False,
        temperature: float = 1.0,
        filter_fn: Callable = top_k,
        filter_kwargs: Optional[Dict] = None,
    ):
        """Run every decode-path shape once (each consume chunk, a block with
        this sampling configuration) before the first real-time window, so
        that no window pays a one-off set-up inside its wall-clock budget."""
        cfg = self.model.config
        style_dim = cfg.perf_encoder.embedding_dim if cfg.perf_encoder is not None else None
        ctx_dim = cfg.dim if cfg.score_encoder is not None else None
        self._new_decoder(max_context_len).warmup(
            style_dim, ctx_dim, greedy=greedy, temperature=temperature, filter_kwargs=filter_kwargs,
            mask_cols=self._sampled_stream_cols(), filter_fn=filter_fn,
        )

    def _sampled_stream_cols(self):
        """The columns of the sampled streams."""
        return tuple(int(s) for s in self.mask_dims)

    def _decode_rows_per_note(
        self, wb, wb_masked, style, ctx, window, base, num_new, note_base,
        bar_shift, bar_col, seed, greedy, temperature, filter_fn, filter_kwargs,
    ):
        """Per-note decode: one predict (one host copy of the row) per position."""
        decoder = self._decoder
        sampler = decoder._sampler(self._sampled_stream_cols(), greedy, filter_fn, filter_kwargs)
        noise = sampler.noise(seed, np.arange(note_base, note_base + num_new), decoder.device)
        with torch.inference_mode():
            for k in range(num_new):
                pos = base + k
                logits = decoder.predict(wb, wb_masked, style, ctx, pos)
                # the same noise for the same note as the block path
                row = sampler(logits, torch.as_tensor(wb[pos][None], dtype=torch.int64).to(decoder.device),
                              None if noise is None else noise[k], temperature)
                row = row[0].cpu().numpy()
                wb[pos] = row
                window[pos] = row
                # restore absolute bar id in the carried window
                if row[bar_col] > EOS:
                    window[pos, bar_col] = row[bar_col] + bar_shift

    def generate_performance_notes(
        self,
        start_time: float = 0.0,
        time_window: float = 0.2,
        time_window_overflow: float = 0.1,
        delta_embedding: Optional[np.ndarray] = None,
        max_context_len: int = 512,
        group_chord_notes: bool = True,
        seed: int = 0,
        temperature: float = 1.0,
        filter_fn: Callable = top_k,
        filter_kwargs: Optional[Dict] = None,
        greedy: bool = False,
        block_size: int = 16,
    ):
        """Generate the notes whose onsets fall in [start_time, start_time +
        time_window): returns (tokens, messages), or (None, []) when none
        does. Sampling draws from `seed` (the JAX generator's `rng`): a note
        samples the same tokens for one seed whatever the block size."""
        tok = self.tokenizer
        perf_notes = self.perf_data.notes
        perf_embeddings = (
            self.perf_data.embeddings.copy() if self.perf_data.embeddings is not None else None
        )
        score_embeddings = self.perf_data.context

        if self.perf_data.gen_seq is None:
            self.perf_data.gen_seq = perf_notes[:1].copy()
        gen_total = self.perf_data.gen_seq

        self._new_decoder(max_context_len)

        current_note_idx = gen_total.shape[0]
        intermediates = self.perf_data.intermediates
        bar_col = 0
        z = tok.zero_token

        # window start (generators.py:133-146)
        start_idx = 0
        if current_note_idx >= max_context_len - 1:
            bars = gen_total[1:, bar_col]
            next_bar_idx = np.where(np.diff(bars))[0]
            fits = np.where(current_note_idx - (next_bar_idx + 1) < max_context_len)[0]
            start_idx = 0 if len(fits) == 0 else int(next_bar_idx[fits[0]] + 2)

        # working buffers over the window
        window = gen_total[start_idx:].copy()
        known_len = window.shape[0]

        all_token_times: List[float] = []
        all_gen_tokens: List[np.ndarray] = []
        window_start = start_idx  # absolute index of window[0]
        # cache stays valid across calls only if the window start is unchanged
        needs_prefill = start_idx != self._last_window_start or self._decoder.caches is None
        self._last_window_start = start_idx

        tempo_col = tok.types_idx["Tempo"]
        # host tempo refresh rewrites each chord's Tempo token from the
        # messenger recursion BEFORE decoding it — the per-note path must
        # interleave host work per chord, so block decode is disabled then
        tempo_host_refresh = isinstance(tok, SPMuple2) and tempo_col not in self.mask_dims
        use_block = block_size > 1 and not tempo_host_refresh
        sampled_cols = self._sampled_stream_cols() if use_block else None
        # block sizing from the score's predicted note count for the window
        # (generators.py:764-777 of the JAX package): the note keys do not
        # depend on the partition, but the notes decoded past the window's
        # end decide its cut, so the sizing is the JAX generator's
        n_est = 0
        if use_block:
            n_est = self.predict_number_of_notes(
                start_time, time_window + time_window_overflow, max_notes=2 * MAX_BLOCK,
            )

        while not self.perf_data.reached_eos:
            if use_block:
                # SHRINK-ONLY: blocks never grow above block_size; a window
                # whose estimate is used up (est_left <= 0) takes a full one
                est_left = n_est - len(all_token_times)
                eff = block_size if est_left <= 0 else max(
                    4, min(est_left + 2, block_size)
                )
                eff_block = max(1, min(eff, max_context_len // 2))
                end = min(current_note_idx + eff_block, len(perf_notes))
                new_notes = perf_notes[current_note_idx:end].copy()
                eos_rows = np.where(new_notes[:, bar_col] == self.eos_token_id)[0]
                if eos_rows.size:
                    new_notes = new_notes[: eos_rows[0]]
                    if new_notes.shape[0] == 0:
                        self.perf_data.reached_eos = True
                        break
            # chord group (generators.py:159-166)
            elif group_chord_notes:
                end = current_note_idx + 1
                while end < len(perf_notes) and np.all(
                    perf_notes[current_note_idx, :2] == perf_notes[end, :2]
                ):
                    end += 1
                new_notes = perf_notes[current_note_idx:end].copy()
            else:
                new_notes = perf_notes[current_note_idx : current_note_idx + 1].copy()
            num_new = new_notes.shape[0]

            # refresh tempo tokens from intermediates when not predicted
            if isinstance(tok, SPMuple2) and tempo_col not in self.mask_dims:
                tempo = (
                    intermediates.tempos[-1, 0]
                    if intermediates is not None and intermediates.tempos is not None
                    else intermediates.initial_tempo
                )
                new_notes[:, tempo_col] = find_closest(tok.vocab.tempos, tempo) + z

            if new_notes[-1, bar_col] == self.eos_token_id:
                self.perf_data.reached_eos = True
                break

            window = np.concatenate([window, new_notes], axis=0)

            # window shift at bar boundaries (generators.py:183-200)
            if window.shape[0] >= max_context_len:
                has_sos = window[0, bar_col] == self.sos_token_id
                first = int(has_sos)
                bars = window[first:, bar_col]
                next_bar_idx = np.where(np.diff(bars))[0]
                shift = 1
                if len(next_bar_idx) > 0:
                    fits = np.where(window.shape[0] - (next_bar_idx + first) < max_context_len)[0]
                    if len(fits) > 0 and next_bar_idx[fits[0]] + 1 + first != window.shape[0] - 1:
                        shift = int(next_bar_idx[fits[0]] + 1 + first)
                # hard cap: the decoder's KV cache holds max_context_len
                # rows, and decode positions are window indices — when no
                # bar boundary fits (a single bar wider than the window),
                # shift far enough that the window fits
                min_shift = window.shape[0] - max_context_len + 1
                if shift < min_shift:
                    if min_shift > window.shape[0] - num_new:
                        raise ValueError(
                            f"a single decode group of {num_new} notes "
                            f"cannot fit the {max_context_len}-token "
                            f"context window; raise max_context_len or "
                            f"disable group_chord_notes"
                        )
                    shift = min_shift
                window = window[shift:]
                known_len -= shift
                window_start += shift
                self._last_window_start = window_start
                self._decoder.reset()
                needs_prefill = True
                if known_len < max_context_len / 8:
                    break

            # bar re-base to zero (generators.py:203-204)
            wb = window.copy()
            first = int(wb[0, bar_col] == self.sos_token_id)
            live = wb[first:, bar_col] > EOS
            bar_shift = wb[first, bar_col] - z
            wb[first:, bar_col] = np.where(live, wb[first:, bar_col] - bar_shift, wb[first:, bar_col])

            # doubled masked input (generators.py:207-208)
            wb_masked = wb.copy()
            wb_masked[first:][:, self.mask_dims] = MASK

            # style delta (generators.py:211-212)
            if perf_embeddings is not None and delta_embedding is not None:
                perf_embeddings[current_note_idx : current_note_idx + num_new] += delta_embedding

            style = (
                perf_embeddings[window_start : window_start + wb.shape[0]]
                if perf_embeddings is not None
                else None
            )
            ctx = (
                score_embeddings[window_start : window_start + wb.shape[0]]
                if score_embeddings is not None
                else None
            )

            if needs_prefill:
                self._decoder.reset()
                needs_prefill = False

            base = wb.shape[0] - num_new
            rows = None
            if use_block:
                rows = self._decoder.decode_block(
                    wb, wb_masked, style, ctx, base, num_new,
                    current_note_idx, seed,
                    greedy=greedy, temperature=temperature,
                    filter_kwargs=filter_kwargs,
                    mask_cols=sampled_cols,
                    filter_fn=filter_fn,
                )
            if rows is not None:
                for k in range(num_new):
                    row = rows[k]
                    wb[base + k] = row
                    window[base + k] = row
                    if row[bar_col] > EOS:
                        window[base + k, bar_col] = row[bar_col] + bar_shift
            else:
                # per-note path (tempo host refresh, or a block past the
                # cache): unmask each position in turn, with the block
                # path's noise for each note
                self._decode_rows_per_note(
                    wb, wb_masked, style, ctx, window, base, num_new,
                    current_note_idx, bar_shift, bar_col, seed, greedy,
                    temperature, filter_fn, filter_kwargs,
                )

            gen_tokens = window[base:].copy()

            token_times, intermediates = self.messenger.tokens_to_messages(
                gen_tokens,
                note_attributes=False,
                note_off_events=False,
                intermediates=intermediates,
                return_intermediates=True,
                sort=False,
            )
            all_token_times.extend(np.atleast_1d(token_times).tolist())
            all_gen_tokens.append(gen_tokens)

            current_note_idx += num_new

            if np.max(token_times) >= start_time + time_window + time_window_overflow:
                break

        if not all_gen_tokens:
            return None, []

        # cut to the window (generators.py:259-276)
        times = np.array(all_token_times)
        fit = np.where(times <= start_time + time_window)[0]
        cut_idx = 0 if len(fit) == 0 else int(fit[-1] + 1)

        # tokens decoded beyond the cut are discarded: ROLL BACK the decoder
        # past them instead of resetting — the kept prefix rows stay valid, so
        # the next window never re-consumes the whole context
        overshoot = len(all_token_times) - cut_idx
        if overshoot > 0:
            self._decoder.rollback(max(0, self._decoder.consumed - overshoot))

        if cut_idx == 0:
            return None, []

        gen_tokens = np.concatenate(all_gen_tokens, axis=0)[:cut_idx]
        messages, self.perf_data.intermediates = self.messenger.tokens_to_messages(
            gen_tokens,
            intermediates=self.perf_data.intermediates,
            return_intermediates=True,
            to_times=True,
            sort=False,
        )

        if perf_embeddings is not None and delta_embedding is not None:
            total_len = self.perf_data.gen_seq.shape[0]
            self.perf_data.embeddings[total_len : total_len + cut_idx] = perf_embeddings[
                total_len : total_len + cut_idx
            ]

        self.perf_data.gen_seq = np.concatenate([self.perf_data.gen_seq, gen_tokens], axis=0)

        return gen_tokens, messages

    def predict_number_of_notes(
        self, start_time: float = 0.0, time_window: float = 0.2, max_notes: int = 32
    ):
        """(generators.py:297-318)"""
        num_gen = len(self.perf_data.gen_seq) - 1 if self.perf_data.gen_seq is not None else 0
        future = self.perf_data.perf_seq[num_gen : num_gen + max_notes].copy()
        if len(future) == 0:
            return 0

        inter = self.perf_data.intermediates
        if inter is not None and inter.tempos is not None:
            tempo_col = self.tokenizer.types_idx["Tempo"]
            tempo_token = int(
                find_closest(self.tokenizer.vocab.tempos, inter.tempos[-1, 0])
                + self.tokenizer.zero_token
            )
            shift = tempo_token - self.perf_data.perf_seq[num_gen - 1, tempo_col]
            z = self.tokenizer.zero_token
            # clip to the tempo vocab: extreme shifts would index past the
            # bin table during messaging
            future[:, tempo_col] = np.clip(
                future[:, tempo_col] + shift, z,
                z + len(self.tokenizer.vocab.tempos) - 1,
            )

        times = self.messenger.tokens_to_messages(
            future, note_attributes=False, note_off_events=False,
            intermediates=inter, sort=False,
        )
        return int((np.atleast_1d(times) <= start_time + time_window).sum())
