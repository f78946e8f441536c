"""Tokenizer operations on tensors, on the tensors' device.

Counterpart of scoreperformer_tpu/ops/tokenizer_ops.py: the note onset ticks
of a (T, S) token matrix (`note_on_ticks`, octuple_m.py:460-520's time
signature segments with a static cap on their number) and the SPMuple2 time
reconstruction (`spmuple2_decode_times`, spmuple2.py:398-444), batched
(`spmuple2_decode_times_batch`), and the deadpan performance columns of a
score (`score_tokens_as_performance`). The JAX package has no Pallas kernel
here: these are plain tensor operations, in fp32 as JAX computes them.

JAX's `lax.scan` over onset groups (`onset_step`) carries the previous
group's tick and onset time: each valid group's onset time is the previous
one plus its time shift scaled by (1 + mean deviation); an invalid group
keeps the carry. Here that carry is a cumulative sum of the groups' time
increments (0 for an invalid group) started at the initial time, which adds
them in the scan's order, and the previous tick is the last valid group's
tick before this one (`torch.cummax` over the valid indices).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class TokenizerConstants:
    """The vocabulary tables the operations read."""

    zero_token: int
    max_beat_res: int
    duration_values: np.ndarray  # beats per Duration token index
    tempos: np.ndarray
    time_signatures: np.ndarray  # (N, 2) num/den per TimeSig token index
    rel_onset_deviations: Optional[np.ndarray]
    rel_performed_durations: Optional[np.ndarray]
    types_idx: Dict[str, int]

    @classmethod
    def from_tokenizer(cls, tokenizer) -> "TokenizerConstants":
        v = tokenizer.vocab
        return cls(
            zero_token=tokenizer.zero_token,
            max_beat_res=tokenizer.max_beat_res,
            duration_values=np.asarray(v.duration_values),
            tempos=np.asarray(v.tempos),
            time_signatures=np.asarray(v.time_signatures),
            rel_onset_deviations=(
                np.asarray(v.rel_onset_deviations) if v.rel_onset_deviations is not None else None
            ),
            rel_performed_durations=(
                np.asarray(v.rel_performed_durations) if v.rel_performed_durations is not None else None
            ),
            types_idx=dict(tokenizer.types_idx),
        )


def _table(values: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    """A constant table on `device`, in the type JAX gives it (fp32 for
    floats, int32 for integers)."""
    return torch.as_tensor(np.asarray(values), device=device).to(dtype)


class TokenizerOps:
    def __init__(self, tokenizer, max_ts_changes: int = 8):
        self.const = TokenizerConstants.from_tokenizer(tokenizer)
        self.max_ts_changes = max_ts_changes

    def note_on_ticks(self, tokens: torch.Tensor, time_division: int = 480) -> torch.Tensor:
        """Per-note onset ticks (T,) in fp32 of a (T, S) int token matrix:
        the first `max_ts_changes` time signature changes, as JAX's static
        cap keeps them."""
        c = self.const
        z = c.zero_token
        K = self.max_ts_changes
        T = tokens.shape[0]
        dev = tokens.device
        tokens = tokens.to(torch.int32)

        bars = tokens[:, c.types_idx["Bar"]] - z
        positions = tokens[:, c.types_idx["Position"]] - z
        ts_col = tokens[:, c.types_idx["TimeSig"]]
        ticks_per_sample = time_division / c.max_beat_res

        change = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ts_col[1:] != ts_col[:-1]])
        # the first K change indices, padded with T - 1 (jnp.where(size=K, fill_value=T - 1))
        pos = torch.arange(T, device=dev)
        first = torch.sort(torch.where(change, pos, T)).values[:K]
        first = torch.cat([first, torch.full((max(0, K - T),), T, dtype=first.dtype, device=dev)])
        order = torch.where(first >= T, T - 1, first)
        change_bars = bars[order]
        sigs = _table(c.time_signatures, dev, torch.int32)[
            torch.clamp(ts_col[order] - z, 0, len(c.time_signatures) - 1)]
        ticks_per_bar = time_division * 4.0 * sigs[:, 0].float() / sigs[:, 1].float()

        # cumulative tick at each change boundary
        dbars = torch.diff(change_bars, prepend=change_bars[:1])
        cum_ticks = torch.cumsum(dbars * torch.cat([ticks_per_bar[:1], ticks_per_bar[:-1]]), dim=0)

        seg = torch.clamp(torch.searchsorted(change_bars, bars, right=True) - 1, 0, K - 1)
        return cum_ticks[seg] + (bars - change_bars[seg]) * ticks_per_bar[seg] + positions * ticks_per_sample

    def spmuple2_decode_times(self, tokens: torch.Tensor,
                              time_division: int = 480) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Note (start, end) times in seconds and the performed mask of a
        (T, S) token matrix, tempo the mean of each onset's tempo tokens
        (spmuple2.py:385-386, 404-405): (perf_times, perf_offset_times,
        is_performed)."""
        c = self.const
        z = c.zero_token
        T = tokens.shape[0]
        dev = tokens.device
        tokens = tokens.to(torch.int32)
        tempo_scale = 60.0 / time_division
        ticks_per_sample = time_division // c.max_beat_res

        def column(name, table):
            idx = torch.clamp(tokens[:, c.types_idx[name]] - z, 0, len(table) - 1)
            return _table(table, dev)[idx]

        note_ticks = self.note_on_ticks(tokens, time_division)
        duration_ticks = column("Duration", c.duration_values) * c.max_beat_res * ticks_per_sample
        token_tempos = column("Tempo", c.tempos)
        rel_devs = column("RelOnsetDev", c.rel_onset_deviations)
        rel_durs = column("RelPerfDuration", c.rel_performed_durations)
        is_performed = tokens[:, c.types_idx["Velocity"]] != z

        # notes grouped by tick (tick-sorted); only groups with a performed
        # note count, renumbered consecutively; every same-tick note belongs
        # to its group (the reference's onset mask is tick equality)
        num_groups = T
        tick_change = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), note_ticks[1:] != note_ticks[:-1]])
        ag = torch.cumsum(tick_change.long(), dim=0) - 1
        has_perf_g = torch.zeros(num_groups, dtype=torch.int32, device=dev).scatter_reduce(
            0, ag, is_performed.int(), "amax", include_self=False) > 0
        perf_group_rank = torch.cumsum(has_perf_g.long(), dim=0) - 1
        in_group = has_perf_g[ag]
        oid = torch.clamp(perf_group_rank[ag], 0, num_groups - 1)

        w_note = in_group.float()
        w_perf = (in_group & is_performed).float()

        def seg_sum(x, w):
            return torch.zeros(num_groups, device=dev).index_add(0, oid, x * w)

        ones = torch.ones(T, device=dev)
        cnt_all = torch.clamp(seg_sum(ones, w_note), min=1.0)
        cnt_perf = torch.clamp(seg_sum(ones, w_perf), min=1.0)
        g_tick = torch.full((num_groups,), float("-inf"), device=dev).scatter_reduce(
            0, oid, torch.where(in_group, note_ticks, float("-inf")), "amax")
        g_tempo = seg_sum(token_tempos, w_note) / cnt_all
        g_mean_dev = seg_sum(rel_devs, w_perf) / cnt_perf
        g_valid = torch.zeros(num_groups, dtype=torch.int32, device=dev).scatter_reduce(
            0, oid, in_group.int(), "amax", include_self=False) > 0
        g_tick = torch.where(g_valid, g_tick, 0.0)

        first_tick_positive = note_ticks[0] > 0
        init_tick = torch.where(first_tick_positive, 0.0, -1.0)
        init_time = torch.where(first_tick_positive, 0.0, -1.0 / g_tempo[0] * tempo_scale)

        # JAX's onset_step scan: the previous valid group's tick, and the
        # onset times summed in the scan's order
        groups = torch.arange(num_groups, device=dev)
        last_valid = torch.cummax(torch.where(g_valid, groups, -1), dim=0).values
        prev_idx = torch.cat([torch.full((1,), -1, dtype=last_valid.dtype, device=dev), last_valid[:-1]])
        prev_tick = torch.where(prev_idx >= 0, g_tick[prev_idx.clamp_min(0)], init_tick)
        g_time_shift = (g_tick - prev_tick) / g_tempo * tempo_scale
        increments = torch.where(g_valid, g_time_shift * (1.0 + g_mean_dev), 0.0)
        g_prev_time = torch.cumsum(torch.cat([init_time[None], increments[:-1]]), dim=0)

        note_prev_time = g_prev_time[oid]
        note_shift = g_time_shift[oid]
        note_tempo = g_tempo[oid]

        perf_times = note_prev_time + note_shift * (1.0 + rel_devs)
        score_time_dur = duration_ticks / note_tempo * tempo_scale
        perf_offset_times = perf_times + rel_durs * score_time_dur

        valid = in_group
        perf_times = torch.where(valid, perf_times, 0.0)
        perf_offset_times = torch.where(valid, perf_offset_times, 0.0)
        return perf_times, perf_offset_times, is_performed & valid

    def spmuple2_decode_times_batch(self, tokens: torch.Tensor, time_division: int = 480):
        """`spmuple2_decode_times` of each (T, S) matrix of a (B, T, S)
        batch, stacked (JAX's vmap)."""
        outs = [self.spmuple2_decode_times(t, time_division) for t in tokens]
        return tuple(torch.stack(parts) for parts in zip(*outs))

    def score_tokens_as_performance(self, score_tokens: torch.Tensor) -> torch.Tensor:
        """The deadpan performance of score tokens (spmuple.py:513-540): the
        zero onset deviation and unit performed duration columns appended."""
        c = self.const
        zero_dev = int(np.where(c.rel_onset_deviations == 0.0)[0][0]) + c.zero_token
        unit_dur = int(np.where(c.rel_performed_durations == 1.0)[0][0]) + c.zero_token
        shape = (*score_tokens.shape[:-1], 1)
        dev_col = torch.full(shape, zero_dev, dtype=score_tokens.dtype, device=score_tokens.device)
        dur_col = torch.full(shape, unit_dur, dtype=score_tokens.dtype, device=score_tokens.device)
        return torch.cat([score_tokens, dev_col, dur_col], dim=-1)
