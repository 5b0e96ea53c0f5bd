// Native host-side kernels for storage_tpu.
//
// The accelerator owns all tensor math (simulation, regressions, DP scans); what
// remains on the host is the sequential, branchy setup work that the
// reference keeps in C#/MKL: the inventory-space reduction with its
// per-period, per-constraint bound solving (reference
// StorageHelper.CalculateInventorySpace, StorageHelper.cs:39-107, and the
// IInjectWithdrawConstraint bound solvers).  At hourly granularity this is
// ~10^4 sequential steps of pillar walking — a poor fit for Python loops and
// for XLA alike, and exactly the kind of component the reference implements
// natively.
//
// Build: g++ -O3 -shared -fPIC -o libstorage_host_ops.so storage_host_ops.cpp
// ABI: plain C, consumed via ctypes (storage_tpu/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kInterpLinear = 0;
constexpr int kInterpStep = 1;

struct PillarTable {
  const double* rows;  // [count, 3] (inventory, min_rate, max_rate)
  int count;
};

bool is_constant(const PillarTable& t) {
  for (int i = 1; i < t.count; ++i) {
    if (t.rows[i * 3 + 1] != t.rows[1] || t.rows[i * 3 + 2] != t.rows[2]) return false;
  }
  return true;
}

void interp_rates(const PillarTable& t, int interp_kind, double inventory,
                  double* min_rate, double* max_rate) {
  const int n = t.count;
  if (interp_kind == kInterpStep) {
    // Floor lookup (StepInjectWithdrawConstraint.cs:72-79), clamped.
    int idx = 0;
    while (idx + 1 < n && t.rows[(idx + 1) * 3] <= inventory) ++idx;
    *min_rate = t.rows[idx * 3 + 1];
    *max_rate = t.rows[idx * 3 + 2];
    return;
  }
  // Piecewise linear with boundary clamping (PiecewiseLinear...cs:67-72).
  if (inventory <= t.rows[0]) {
    *min_rate = t.rows[1];
    *max_rate = t.rows[2];
    return;
  }
  if (inventory >= t.rows[(n - 1) * 3]) {
    *min_rate = t.rows[(n - 1) * 3 + 1];
    *max_rate = t.rows[(n - 1) * 3 + 2];
    return;
  }
  int lo = 0;
  while (lo + 2 < n && t.rows[(lo + 1) * 3] <= inventory) ++lo;
  const double x0 = t.rows[lo * 3], x1 = t.rows[(lo + 1) * 3];
  const double seg = x1 - x0;
  const double w = seg > 0.0 ? (inventory - x0) / seg : 0.0;
  *min_rate = t.rows[lo * 3 + 1] + (t.rows[(lo + 1) * 3 + 1] - t.rows[lo * 3 + 1]) * w;
  *max_rate = t.rows[lo * 3 + 2] + (t.rows[(lo + 1) * 3 + 2] - t.rows[lo * 3 + 2]) * w;
}

double solve_linear(double x1, double y1, double x2, double y2, double y) {
  const double gradient = (y2 - y1) / (x2 - x1);
  const double constant = y1 - gradient * x1;
  return (y - constant) / gradient;
}

// Max inventory this period from which next period's [lo, hi] is reachable
// (mirrors ops/inventory_space.py::upper_bound).
int upper_bound(const PillarTable& t, int interp_kind, double next_lo, double next_hi,
                double cur_min, double cur_max, double loss, double* out) {
  if (is_constant(t)) {
    const double min_rate = t.rows[1];
    *out = std::min((next_hi - min_rate) / (1.0 - loss), cur_max);
    return 0;
  }
  double min_at_max, max_at_max;
  interp_rates(t, interp_kind, cur_max, &min_at_max, &max_at_max);
  const double next_max_from_max = cur_max * (1.0 - loss) + max_at_max;
  const double next_min_from_max = cur_max * (1.0 - loss) + min_at_max;
  if (next_min_from_max <= next_hi && next_lo <= next_max_from_max) {
    *out = cur_max;
    return 0;
  }
  const int n = t.count;
  if (interp_kind == kInterpLinear) {
    double upper_inv = t.rows[(n - 1) * 3];
    double upper_after = next_min_from_max;
    for (int i = n - 2; i >= 0; --i) {
      const double lower_inv = t.rows[i * 3];
      const double lower_after = lower_inv * (1.0 - loss) + t.rows[i * 3 + 1];
      if (lower_after <= next_hi && next_hi <= upper_after && upper_inv > lower_inv) {
        *out = solve_linear(lower_inv, lower_after, upper_inv, upper_after, next_hi);
        return 0;
      }
      upper_after = lower_after;
      upper_inv = lower_inv;
    }
    return 1;  // infeasible
  }
  bool found = false;
  double solution = 0.0;
  for (int i = 0; i < n - 1; ++i) {
    const double rate = t.rows[i * 3 + 1];
    const double lo_inv = t.rows[i * 3];
    const double hi_inv = t.rows[(i + 1) * 3];
    if (hi_inv <= lo_inv) continue;
    const double lo_after = lo_inv * (1.0 - loss) + rate;
    const double hi_after = hi_inv * (1.0 - loss) + rate;
    if (lo_after <= next_hi && next_hi <= hi_after) {
      solution = solve_linear(lo_inv, lo_after, hi_inv, hi_after, next_hi);
      found = true;  // keep the max (last) solution, like the reference
    }
  }
  if (!found) return 1;
  *out = solution;
  return 0;
}

int lower_bound(const PillarTable& t, int interp_kind, double next_lo, double next_hi,
                double cur_min, double cur_max, double loss, double* out) {
  if (is_constant(t)) {
    const double max_rate = t.rows[2];
    *out = std::max((next_lo - max_rate) / (1.0 - loss), cur_min);
    return 0;
  }
  double min_at_min, max_at_min;
  interp_rates(t, interp_kind, cur_min, &min_at_min, &max_at_min);
  const double next_max_from_min = cur_min * (1.0 - loss) + max_at_min;
  const double next_min_from_min = cur_min * (1.0 - loss) + min_at_min;
  if (next_min_from_min <= next_hi && next_lo <= next_max_from_min) {
    *out = cur_min;
    return 0;
  }
  const int n = t.count;
  if (interp_kind == kInterpLinear) {
    double lower_inv = t.rows[0];
    double lower_after = next_max_from_min;
    for (int i = 1; i < n; ++i) {
      const double upper_inv = t.rows[i * 3];
      const double upper_after = upper_inv * (1.0 - loss) + t.rows[i * 3 + 2];
      if (lower_after <= next_lo && next_lo <= upper_after && upper_inv > lower_inv) {
        *out = solve_linear(lower_inv, lower_after, upper_inv, upper_after, next_lo);
        return 0;
      }
      lower_after = upper_after;
      lower_inv = upper_inv;
    }
    return 1;
  }
  bool found = false;
  double solution = 0.0;
  for (int i = n - 2; i >= 0; --i) {
    const double rate = t.rows[i * 3 + 2];
    const double lo_inv = t.rows[i * 3];
    const double hi_inv = t.rows[(i + 1) * 3];
    if (hi_inv <= lo_inv) continue;
    const double lo_after = lo_inv * (1.0 - loss) + rate;
    const double hi_after = hi_inv * (1.0 - loss) + rate;
    if (lo_after <= next_lo && next_lo <= hi_after) {
      solution = solve_linear(lo_inv, lo_after, hi_inv, hi_after, next_lo);
      found = true;  // keep the min (last, since iterating downward)
    }
  }
  if (!found) return 1;
  *out = solution;
  return 0;
}

}  // namespace

extern "C" {

// Inventory-space reduction over n decision steps.
//
// pillars:        [n, max_pillars, 3] row-major, padded by repeating last row
// pillar_counts:  [n] actual pillar count per step
// min_inv/max_inv:[n+1]
// loss:           [n]
// out_min/out_max:[n+1]
// Returns 0 on success, 1 if constraints cannot be fulfilled, 2 on bad args.
int stpu_inventory_space(const double* pillars, const int32_t* pillar_counts,
                         int32_t max_pillars, int32_t n_steps, int32_t interp_kind,
                         const double* min_inv, const double* max_inv,
                         const double* loss, double start_inventory,
                         int32_t must_be_empty, double* out_min, double* out_max) {
  if (n_steps <= 0 || max_pillars < 2) return 2;
  const int n = n_steps;
  const double eps = 1e-12;
  if (start_inventory < min_inv[0] - eps || start_inventory > max_inv[0] + eps) return 1;

  auto table_at = [&](int k) {
    return PillarTable{pillars + static_cast<int64_t>(k) * max_pillars * 3,
                       pillar_counts[k]};
  };

  // Forward reachability (StorageHelper.cs:49-74).
  double* fwd_min = new double[n + 1];
  double* fwd_max = new double[n + 1];
  fwd_min[0] = fwd_max[0] = start_inventory;
  for (int k = 0; k < n; ++k) {
    double min_rate, max_rate, dummy;
    interp_rates(table_at(k), interp_kind, fwd_min[k], &min_rate, &dummy);
    fwd_min[k + 1] = std::max(fwd_min[k] * (1.0 - loss[k]) + min_rate, min_inv[k + 1]);
    interp_rates(table_at(k), interp_kind, fwd_max[k], &dummy, &max_rate);
    fwd_max[k + 1] = std::min(fwd_max[k] * (1.0 - loss[k]) + max_rate, max_inv[k + 1]);
  }

  // Backward reachability (StorageHelper.cs:76-91).
  double* back_min = new double[n + 1];
  double* back_max = new double[n + 1];
  back_min[n] = must_be_empty ? 0.0 : min_inv[n];
  back_max[n] = must_be_empty ? 0.0 : max_inv[n];
  int status = 0;
  for (int k = n - 1; k >= 1 && status == 0; --k) {
    status |= upper_bound(table_at(k), interp_kind, back_min[k + 1], back_max[k + 1],
                          min_inv[k], max_inv[k], loss[k], &back_max[k]);
    status |= lower_bound(table_at(k), interp_kind, back_min[k + 1], back_max[k + 1],
                          min_inv[k], max_inv[k], loss[k], &back_min[k]);
  }
  back_min[0] = back_max[0] = start_inventory;

  if (status == 0) {
    for (int k = 0; k <= n; ++k) {
      out_min[k] = std::max(fwd_min[k], back_min[k]);
      out_max[k] = std::min(fwd_max[k], back_max[k]);
      if (out_min[k] > out_max[k]) status = 1;
    }
    out_min[0] = out_max[0] = start_inventory;
  }

  delete[] fwd_min;
  delete[] fwd_max;
  delete[] back_min;
  delete[] back_max;
  return status;
}

// Library identification for the ctypes loader.
int stpu_abi_version() { return 1; }

}  // extern "C"
