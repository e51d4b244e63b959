// Native CPU reference kernel for LDPC belief propagation.
//
// Float64 oracle used to validate the JAX BP kernel, implementing
// the same flat Tanner-graph message passing as the reference C kernel
// (ldpc_jossy/src/c_ldpc.c): variable-node sums read through an interleaver,
// check-node updates via either the tanh product ("sumprod") or the
// numerically-stable forward-backward pairwise LLR-XOR trellis
// ("sumprod2" / "minsum"). Unlike the reference, minsum takes max_itcount
// properly (the reference's Python wrapper dropped it, ldpc.py:487 vs
// c_ldpc.c:339-340 — a known upstream bug we do not replicate).
//
// Exposed with C linkage for ctypes; loaded once per process (the reference
// re-dlopened the shared library on every decode call, ldpc.py:467).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Pairwise LLR of XOR: sign product * min magnitude, plus the two-term
// log-domain correction for the exact sum-product rule.
inline double llr_xor(double a, double b, bool correct) {
  double sgn = (std::signbit(a) == std::signbit(b)) ? 1.0 : -1.0;
  double out = sgn * std::fmin(std::fabs(a), std::fabs(b));
  if (correct) {
    out += std::log1p(std::exp(-std::fabs(a + b)));
    out -= std::log1p(std::exp(-std::fabs(a - b)));
  }
  return out;
}

// Extrinsic LLRs for a degree-dc check via forward/backward combining.
// msgs is updated in place; returns the full (non-extrinsic) combination,
// whose sign indicates whether the parity check is currently satisfied.
double check_extrinsic(double* msgs, int64_t dc, bool correct) {
  std::vector<double> fwd(dc), bwd(dc);
  fwd[0] = msgs[0];
  bwd[dc - 1] = msgs[dc - 1];
  for (int64_t k = 1; k < dc; ++k) {
    fwd[k] = llr_xor(fwd[k - 1], msgs[k], correct);
    bwd[dc - 1 - k] = llr_xor(bwd[dc - k], msgs[dc - 1 - k], correct);
  }
  double total = bwd[0];
  msgs[0] = bwd[1];
  for (int64_t k = 1; k < dc - 1; ++k)
    msgs[k] = llr_xor(fwd[k - 1], bwd[k + 1], correct);
  msgs[dc - 1] = fwd[dc - 2];
  return total;
}

enum class CheckRule { kTanhProduct, kFbExact, kFbMinSum };

int run_bp(const double* ch, const int64_t* vdeg, const int64_t* cdeg,
           const int64_t* intrlv, int64_t nv, int64_t nc, int64_t nmsg,
           double* app, int max_iters, CheckRule rule, double corr_factor) {
  std::vector<double> msg(nmsg, 0.0);
  int it = 0;
  for (it = 0; it < max_iters; ++it) {
    // Variable nodes: total = channel + all incoming (via interleaver),
    // outgoing extrinsic = total minus the incoming on that edge.
    int64_t pos = 0;
    for (int64_t v = 0; v < nv; ++v) {
      double total = ch[v];
      for (int64_t k = 0; k < vdeg[v]; ++k) total += msg[intrlv[pos + k]];
      for (int64_t k = 0; k < vdeg[v]; ++k) {
        double& m = msg[intrlv[pos + k]];
        m = total - m;
      }
      app[v] = total;
      pos += vdeg[v];
    }

    // Check nodes; track whether every parity check is satisfied.
    bool all_satisfied = true;
    pos = 0;
    for (int64_t c = 0; c < nc; ++c) {
      const int64_t dc = cdeg[c];
      double total;
      if (rule == CheckRule::kTanhProduct) {
        double prod = 1.0;
        for (int64_t k = 0; k < dc; ++k)
          prod *= (msg[pos + k] = std::tanh(msg[pos + k] / 2.0));
        total = 2.0 * std::atanh(prod);
        for (int64_t k = 0; k < dc; ++k)
          msg[pos + k] = 2.0 * std::atanh(prod / msg[pos + k]);
      } else {
        total = check_extrinsic(&msg[pos], dc, rule == CheckRule::kFbExact);
        if (rule == CheckRule::kFbMinSum)
          for (int64_t k = 0; k < dc; ++k) msg[pos + k] *= corr_factor;
      }
      if (total <= 0.0) all_satisfied = false;
      pos += dc;
    }

    if (all_satisfied) break;
  }
  return it;
}

}  // namespace

extern "C" {

int ref_sumprod(const double* ch, const int64_t* vdeg, const int64_t* cdeg,
                const int64_t* intrlv, int64_t nv, int64_t nc, int64_t nmsg,
                double* app, int max_iters) {
  return run_bp(ch, vdeg, cdeg, intrlv, nv, nc, nmsg, app, max_iters,
                CheckRule::kTanhProduct, 0.0);
}

int ref_sumprod2(const double* ch, const int64_t* vdeg, const int64_t* cdeg,
                 const int64_t* intrlv, int64_t nv, int64_t nc, int64_t nmsg,
                 double* app, int max_iters) {
  return run_bp(ch, vdeg, cdeg, intrlv, nv, nc, nmsg, app, max_iters,
                CheckRule::kFbExact, 0.0);
}

int ref_minsum(const double* ch, const int64_t* vdeg, const int64_t* cdeg,
               const int64_t* intrlv, int64_t nv, int64_t nc, int64_t nmsg,
               double* app, double corr_factor, int max_iters) {
  return run_bp(ch, vdeg, cdeg, intrlv, nv, nc, nmsg, app, max_iters,
                CheckRule::kFbMinSum, corr_factor);
}

double ref_lxor(double a, double b, int correct) {
  return llr_xor(a, b, correct != 0);
}

double ref_lxfb(double* msgs, int64_t dc, int correct) {
  return check_extrinsic(msgs, dc, correct != 0);
}

}  // extern "C"
