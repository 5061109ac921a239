// Host-side audio helpers of end2end_asr_tpu_torch, built with g++ at
// first use and bound with ctypes (data/audio_host.py).
//
// The JAX package's default augmentation path stretches audio with its
// C++ WSOLA (end2end_asr_tpu/native/audio_native.cc, tempo_wsola and the
// resample_linear it calls for input shorter than two windows). This file
// is the port's own copy of those two functions, so that an augmented
// batch of the port equals the JAX package's bit for bit. Build flags are
// the JAX package's (-O3 -fPIC -shared -std=c++17, no -march=native): the
// float and double arithmetic below must round exactly as there.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Linear resampler: n_out = round(n_in * sr_out / sr_in) points spread
// evenly over [0, n_in - 1]. Returns n_out, or -1 on bad arguments.
int64_t resample_linear(const float* in, int64_t n_in, int32_t sr_in,
                        int32_t sr_out, float* out, int64_t max_out) {
  if (n_in <= 1 || sr_in <= 0 || sr_out <= 0) return -1;
  int64_t n_out = (int64_t)llround((double)n_in * sr_out / sr_in);
  if (n_out > max_out) n_out = max_out;
  double step = (double)(n_in - 1) / (n_out > 1 ? (n_out - 1) : 1);
  for (int64_t i = 0; i < n_out; ++i) {
    double x = i * step;
    int64_t i0 = (int64_t)x;
    if (i0 >= n_in - 1) { out[i] = in[n_in - 1]; continue; }
    double frac = x - i0;
    out[i] = (float)(in[i0] * (1.0 - frac) + in[i0 + 1] * frac);
  }
  return n_out;
}

// Pitch-preserving tempo change by waveform-similarity overlap-add: a
// 30 ms Hann window (built in float), half-window output hop, a +-10 ms
// search scored by a double dot product with the previous segment's
// second half, the first best candidate kept. Input shorter than two
// windows is stretched by resample_linear instead. Returns the output
// length, or -1 on bad arguments.
int64_t tempo_wsola(const float* in, int64_t n_in, float tempo,
                    int32_t sample_rate, float* out, int64_t max_out) {
  if (tempo <= 0.f || n_in <= 0) return -1;
  int64_t win = (int64_t)(0.030 * sample_rate);
  win -= win % 2;
  if (win < 32) win = 32;
  const int64_t hop_out = win / 2;
  const double hop_in = tempo * (double)hop_out;
  const int64_t seek = (int64_t)(0.010 * sample_rate);
  int64_t n_out = (int64_t)(n_in / tempo);
  if (n_out > max_out) n_out = max_out;

  if (n_in < 2 * win) {  // too short: linear stretch
    return resample_linear(in, n_in, sample_rate,
                           (int32_t)(sample_rate / tempo), out, max_out);
  }

  std::vector<float> window(win), acc(n_out + win, 0.f),
      norm(n_out + win, 0.f);
  for (int64_t i = 0; i < win; ++i)
    window[i] = 0.5f - 0.5f * cosf(2.f * (float)M_PI * i / (win - 1));

  std::vector<float> prev(win);
  for (int64_t i = 0; i < win; ++i) prev[i] = in[i] * window[i];
  for (int64_t i = 0; i < win; ++i) {
    acc[i] += prev[i];
    norm[i] += window[i];
  }

  int64_t t_out = hop_out;
  double pos = 0.0;
  while (t_out + win <= n_out) {
    pos += hop_in;
    int64_t center = (int64_t)pos;
    int64_t lo = center - seek;
    if (lo < 0) lo = 0;
    int64_t hi = center + seek;
    if (hi > n_in - win) hi = n_in - win;
    if (hi <= lo) break;
    const float* target = prev.data() + hop_out;
    const int64_t tail = win - hop_out;
    int64_t best = lo;
    double best_score = -1e30;
    for (int64_t c = lo; c < hi; ++c) {
      double s = 0.0;
      const float* seg = in + c;
      for (int64_t i = 0; i < tail; ++i) s += seg[i] * target[i];
      if (s > best_score) {
        best_score = s;
        best = c;
      }
    }
    for (int64_t i = 0; i < win; ++i) {
      float v = in[best + i] * window[i];
      acc[t_out + i] += v;
      norm[t_out + i] += window[i];
      prev[i] = v;
    }
    t_out += hop_out;
  }
  for (int64_t i = 0; i < n_out; ++i)
    out[i] = acc[i] / (norm[i] > 1e-6f ? norm[i] : 1e-6f);
  return n_out;
}

}  // extern "C"
