// F0 (pitch) tracker — C++ host kernel for data-prep / GAN training targets
// (the port's copy of the JAX package's native/f0.cpp).
//
// Native equivalent of the reference's pyworld extractor (a C++ library;
// reference: cosyvoice/dataset/processor.py compute_f0).  Implements exactly
// the normalized-autocorrelation contract of cosy_tpu_torch/ops/f0.py's
// numpy tracker: per mel-hop frame, mean-removed linear autocorrelation over
// the [sr/fmax, sr/fmin] lag range, first-peak pick with threshold gating and
// parabolic interpolation.  The numpy version computes the same linear
// autocorrelation via rfft/irfft; the direct double-precision sums here are
// mathematically identical up to summation order.
//
// A plain C entry point loaded with ctypes (no Python headers needed);
// frames are independent, so the frame loop is parallelized with OpenMP.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// wav: (n,) float32.  out: (n_frames,) float32, pre-zeroed by the caller.
void extract_f0_impl(const float* wav, int64_t n, double sr, int hop,
                     double fmin, double fmax, double threshold, float* out,
                     int64_t n_frames) {
  const int win = static_cast<int>(sr / fmin * 2.0);
  const int pad = win / 2;
  const int lag_min = static_cast<int>(sr / fmax);
  const int lag_max = static_cast<int>(sr / fmin);
  if (win <= 0 || lag_min < 1 || lag_max <= lag_min) return;

  // zero-padded copy (matches np.pad(wav, (pad, pad)))
  std::vector<double> x(static_cast<size_t>(n) + 2 * pad, 0.0);
  for (int64_t i = 0; i < n; ++i) x[pad + i] = static_cast<double>(wav[i]);

#pragma omp parallel
  {
    std::vector<double> f(win);
    std::vector<double> acn(lag_max + 1);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n_frames; ++i) {
      // frame starts at i*hop in the padded signal (= centered on i*hop+pad)
      const size_t start = static_cast<size_t>(i) * hop;
      if (start + win > x.size()) continue;  // cannot happen for valid input
      double mean = 0.0;
      for (int t = 0; t < win; ++t) mean += x[start + t];
      mean /= win;
      for (int t = 0; t < win; ++t) f[t] = x[start + t] - mean;

      double energy = 0.0;
      for (int t = 0; t < win - lag_max; ++t) energy += f[t] * f[t];
      if (energy < 1e-8) continue;

      double ac0 = 0.0;
      for (int t = 0; t < win; ++t) ac0 += f[t] * f[t];
      if (ac0 <= 0.0) continue;

      // linear autocorrelation over [lag_min-1, lag_max] (the -1 feeds the
      // parabolic neighbor), normalized by ac[0]
      const int lo = lag_min - 1;
      for (int l = lo; l <= lag_max; ++l) {
        double s = 0.0;
        const int m = win - l;
        for (int t = 0; t < m; ++t) s += f[t] * f[t + l];
        acn[l] = s / ac0;
      }

      // first maximum over [lag_min, lag_max] (np.argmax tie semantics)
      int k = lag_min;
      double best = acn[lag_min];
      for (int l = lag_min + 1; l <= lag_max; ++l) {
        if (acn[l] > best) {
          best = acn[l];
          k = l;
        }
      }
      if (best < threshold) continue;

      double kf = static_cast<double>(k);
      if (k > 0 && k < lag_max) {
        const double a = acn[k - 1], b = acn[k], c = acn[k + 1];
        const double denom = a - 2.0 * b + c;
        if (std::fabs(denom) > 1e-12) {
          double shift = 0.5 * (a - c) / denom;
          shift = std::max(-1.0, std::min(1.0, shift));
          kf += shift;
        }
      }
      out[i] = static_cast<float>(sr / kf);
    }
  }
}

}  // namespace

// wav (n,) float32; out (n_frames,) float32, zeroed here first.
extern "C" void cosy_extract_f0(const float* wav, int64_t n, int sr, int hop, double fmin,
                                double fmax, double threshold, float* out,
                                int64_t n_frames) {
  std::fill(out, out + n_frames, 0.0f);
  extract_f0_impl(wav, n, static_cast<double>(sr), hop, fmin, fmax, threshold, out,
                  n_frames);
}
