// Monotonic Alignment Search (MAS), a C++ host kernel (the port's copy of
// the JAX package's native/mas.cpp).
//
// Reference: the Cython maximum_path kernel of matcha/utils/monotonic_align
// (core.pyx), the O(T_x * T_y) Viterbi-style DP of Matcha-TTS training,
// written against the public Glow-TTS / VITS recurrence:
//
//   V[x, y] = logp[x, y] + max(V[x, y-1], V[x-1, y-1])
//   path    = backtrack of argmax decisions from (t_x-1, t_y-1)
//
// A plain C entry point loaded with ctypes (no Python headers needed); the
// batch loop is parallelized with OpenMP.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr float kNegInf = -1e9f;

// value: (t_x, t_y) row-major, modified in place; path: (t_x, t_y) int32 out.
void maximum_path_single(float* value, int32_t* path, int t_x, int t_y) {
  for (int y = 0; y < t_y; ++y) {
    const int x_lo = std::max(0, t_x + y - t_y);
    const int x_hi = std::min(t_x - 1, y);
    for (int x = x_lo; x <= x_hi; ++x) {
      float v_cur = (x == y) ? kNegInf : value[x * t_y + (y - 1)];
      float v_prev;
      if (x == 0) {
        v_prev = (y == 0) ? 0.0f : kNegInf;
      } else {
        v_prev = (y == 0) ? kNegInf : value[(x - 1) * t_y + (y - 1)];
      }
      value[x * t_y + y] += std::max(v_cur, v_prev);
    }
  }
  int index = t_x - 1;
  for (int y = t_y - 1; y >= 0; --y) {
    path[index * t_y + y] = 1;
    if (index != 0 &&
        (index == y ||
         value[index * t_y + (y - 1)] < value[(index - 1) * t_y + (y - 1)])) {
      --index;
    }
  }
}

}  // namespace

// value: (B, Tx, Ty) float32, modified in place (each sample's DP over its
// valid (t_x, t_y) corner); path: (B, Tx, Ty) int32, pre-zeroed;
// t_xs, t_ys: (B,) int32 valid lengths.
extern "C" void cosy_maximum_path(float* value, int32_t* path, const int32_t* t_xs,
                                  const int32_t* t_ys, int B, int Tx, int Ty) {
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < B; ++b) {
    const int tx = t_xs[b];
    const int ty = t_ys[b];
    if (tx <= 0 || ty <= 0) continue;
    // copy the sample's (tx, ty) corner of the padded (Tx, Ty) grid into a
    // compact buffer so the DP indexing stays simple
    std::vector<float> v(static_cast<size_t>(tx) * ty);
    std::vector<int32_t> p(static_cast<size_t>(tx) * ty, 0);
    for (int x = 0; x < tx; ++x) {
      std::copy_n(value + (static_cast<size_t>(b) * Tx + x) * Ty, ty,
                  v.data() + static_cast<size_t>(x) * ty);
    }
    maximum_path_single(v.data(), p.data(), tx, ty);
    for (int x = 0; x < tx; ++x) {
      std::copy_n(p.data() + static_cast<size_t>(x) * ty, ty,
                  path + (static_cast<size_t>(b) * Tx + x) * Ty);
      std::copy_n(v.data() + static_cast<size_t>(x) * ty, ty,
                  value + (static_cast<size_t>(b) * Tx + x) * Ty);
    }
  }
}
