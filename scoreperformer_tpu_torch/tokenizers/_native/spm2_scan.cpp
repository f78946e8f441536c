// Verbatim copy of scoreperformer_tpu/tokenizers/_native/spm2_scan.cpp; the port imports nothing of the JAX package.
// Native core for the SPMuple2 sequential tempo/clamp scan.
//
// C++ counterpart of scoreperformer_tpu/tokenizers/spmuple2.py::
// _tempo_clamp_scan + filter_onsets_in_window + compute_local_tempo +
// compute_onset_tempo (reference semantics: spmuple2.py:209-308). The scan is
// the only O(K^2) sequential part of dataset preparation (profiled at ~75% of
// performance-encode time); everything around it stays vectorized numpy.
//
// Float64 operation ORDER mirrors the Python line for line so results match
// bit-for-bit in the quantized-tempo configs (the only sums are inside the
// local-tempo estimate, whose output is immediately snapped to a tempo bin;
// parity is asserted by tests/test_native_scan.py against the Python scan and
// the golden fixtures).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// numpy searchsorted-left + tie-to-right nearest-bin (utils/functions.py:38-57)
int64_t find_closest(const double* bins, int64_t n, double v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (bins[mid] < v) lo = mid + 1; else hi = mid;
  }
  int64_t id = lo;
  const double arrv = bins[id < n ? id : n - 1];
  const double prevv = bins[(id - 1) > 0 ? (id - 1) : 0];
  if (id == n || std::fabs(v - prevv) < std::fabs(v - arrv)) id -= 1;
  return id;
}

double quantize(double tempo, int32_t do_quantize, const double* bins, int64_t n_bins) {
  if (!do_quantize) return tempo;
  return bins[find_closest(bins, n_bins, tempo)];
}

}  // namespace

extern "C" {

// pairs: (K+1, 2) row-major [tick, time]; times are updated in place exactly
// like the Python scan. note_times: flattened per-onset performed-note times,
// group k = [group_off[k], group_off[k+1]). Outputs: tempos (K+1),
// cum_offsets (K).
void spm2_tempo_scan(
    double* pairs, int64_t K,
    const double* note_times, const int64_t* group_off,
    double initial_tempo, double tempo_scale,
    int32_t limit_devs, double dev_limit,
    int32_t onset_tempos,
    double tempo_window, double min_onset_dist, int64_t min_onsets,
    int32_t do_quantize, const double* bins, int64_t n_bins, double min_tempo,
    double* tempos, double* cum_offsets) {
  tempos[0] = initial_tempo;
  double offset = 0.0;

  std::vector<int64_t> cand;
  std::vector<int64_t> sel;
  cand.reserve(K + 1);
  sel.reserve(K + 1);

  for (int64_t k = 0; k < K; k++) {
    double* cur = pairs + 2 * (k + 1);
    cur[1] += offset;
    const double prev_tick = pairs[2 * k];
    const double prev_time = pairs[2 * k + 1];
    const double dt = (cur[0] - prev_tick) / tempos[k] * tempo_scale;

    if (limit_devs) {
      // worst relative deviation of this onset's notes vs the predicted time;
      // clamp shifts everything after (expressed as the running offset)
      const int64_t g0 = group_off[k], g1 = group_off[k + 1];
      const double pred = prev_time + dt;
      double worst_rel = -1.0, max_abs = -1.0, worst_dev = 0.0;
      for (int64_t i = g0; i < g1; i++) {
        const double dev = (note_times[i] + offset) - pred;
        const double rel = std::fabs(dev / dt);
        if (rel > worst_rel) worst_rel = rel;
        const double a = std::fabs(dev);
        if (a > max_abs) { max_abs = a; worst_dev = dev; }
      }
      if (worst_rel > dev_limit) {
        const double clamp = (1.0 - dev_limit / worst_rel) * -worst_dev;
        cur[1] += clamp;
        offset += clamp;
      }
    }
    cum_offsets[k] = offset;

    double tempo;
    if (onset_tempos) {
      // compute_onset_tempo (spmuple2.py:128-139)
      if (cur[1] <= prev_time) {
        tempo = bins[n_bins - 1];
      } else {
        tempo = (cur[0] - prev_tick) / (cur[1] - prev_time) * tempo_scale;
      }
      tempo = quantize(tempo, do_quantize, bins, n_bins);
    } else if (cur[1] < 2.0 * min_onset_dist) {
      tempo = initial_tempo;
    } else {
      // filter_onsets_in_window (spmuple2.py:94-115) over rows [0, k]
      const double t = cur[1];
      cand.clear();
      for (int64_t i = 0; i <= k; i++) {
        if (pairs[2 * i + 1] <= t - min_onset_dist) cand.push_back(i);
      }
      if (cand.empty()) {
        for (int64_t i = 0; i <= k; i++) cand.push_back(i);
      }
      sel.clear();
      for (int64_t i : cand) {
        if (pairs[2 * i + 1] >= t - tempo_window) sel.push_back(i);
      }
      if ((int64_t)sel.size() < min_onsets) {
        sel.clear();
        int64_t start = (int64_t)cand.size() - min_onsets;
        if (start < 0) start = 0;
        for (size_t j = (size_t)start; j < cand.size(); j++) {
          if (pairs[2 * cand[j] + 1] >= t - 4.0 * tempo_window) sel.push_back(cand[j]);
        }
      }
      if (sel.empty()) sel = cand;

      // compute_local_tempo (spmuple2.py:117-126): inverse-distance weights
      const int64_t n = (int64_t)sel.size();
      double dmax = -1.0;
      for (int64_t i : sel) {
        const double d1 = t - pairs[2 * i + 1];
        if (d1 > dmax) dmax = d1;
      }
      double wsum = 0.0;
      for (int64_t i : sel) wsum += 1.0 - (t - pairs[2 * i + 1]) / (dmax + 0.01);
      double avg = 0.0;
      for (int64_t i : sel) {
        const double d0 = cur[0] - pairs[2 * i];
        const double d1 = t - pairs[2 * i + 1];
        const double local = d0 / d1 * tempo_scale;
        const double w = (1.0 - d1 / (dmax + 0.01)) / wsum;
        avg += w * local;
      }
      tempo = avg > min_tempo ? avg : min_tempo;
      tempo = quantize(tempo, do_quantize, bins, n_bins);
      (void)n;
    }
    tempos[k + 1] = tempo;
  }
}

}  // extern "C"
