// Fast Needleman-Wunsch duration aligner (C++ core), a copy of
// kokoro_tpu/native/aligner.cpp.
//
// The MFA->G2P duration alignment (kokoro_tpu_torch/data/mfa.py
// align_durations) is an O(n*m) dynamic program executed once per utterance
// when features are computed -- a host-side loop over the whole corpus.
// Phone-equivalence relations are precomputed in numpy
// (kokoro_tpu_torch/native/binding.py) and passed as boolean matrices so the
// DP never touches strings.  Host code: it runs on the CPU, not the card.
//
// Ops and costs are identical to the Python implementation (which remains the
// reference/fallback): match 0 / mismatch 3 / skip-MFA 1.5 (frames pool) /
// skip-text by kind (sil 0.05, prosody 0, phone 2) / iotation merge 0 /
// geminate split 0 / spn 1:N expansion 0.2 per phone (max 40).  Costs are
// doubles, summed in the Python DP's order, so every comparison and every tie
// breaks as it does in Python (the JAX package's copy sums floats).
//
// Built at first use by native/binding.py: g++ -O3 -shared -fPIC into
// kokoro_tpu_torch/build/libaligner-<hash of this file>.so

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double COST_MATCH = 0.0;
constexpr double COST_MISMATCH = 3.0;
constexpr double COST_SKIP_MFA = 1.5;
constexpr double COST_SKIP_SIL = 0.05;
constexpr double COST_SKIP_PROSODY = 0.0;
constexpr double COST_SKIP_PHONE = 2.0;
constexpr double COST_IOTATION = 0.0;
constexpr double COST_GEMINATE = 0.0;
constexpr double COST_SPN_PER_PHONE = 0.2;
constexpr int MAX_SPN_SPAN = 40;
constexpr double INF = std::numeric_limits<double>::infinity();

// back-pointer op codes
enum Op : int32_t {
  OP_NONE = -1,
  OP_MATCH = 0,
  OP_SKIP_MFA = 1,
  OP_SKIP_TEXT = 2,
  OP_IOTATION = 3,
  OP_GEMINATE = 4,
  OP_SPN_BASE = 100,  // OP_SPN_BASE + k encodes a 1:k spn expansion
};

}  // namespace

extern "C" {

// Returns 0 on success (durations filled), 1 when no alignment path exists.
//
//   n            number of MFA phones
//   m            number of text phones
//   mfa_frames   [n]    frame count per MFA phone
//   eq           [n*m]  1 if mfa[i] is equivalent to text[j]
//   iot          [n*m]  1 if (mfa[i]=='j', mfa[i+1]==component(text[j]))
//   gem          [n*m]  1 if mfa[i] is a geminate matching text[j]==text[j+1]
//   spn          [n]    1 if mfa[i] is 'spn'
//   text_kind    [m]    0 = phone, 1 = <sil>, 2 = prosody token
//   durations    [m]    output frame counts
int align_durations_dp(int32_t n, int32_t m, const int32_t* mfa_frames,
                       const uint8_t* eq, const uint8_t* iot,
                       const uint8_t* gem, const uint8_t* spn,
                       const uint8_t* text_kind, int32_t* durations) {
  if (m == 0) return 0;
  if (n == 0) {
    std::memset(durations, 0, sizeof(int32_t) * m);
    return 0;
  }

  const int64_t W = m + 1;
  std::vector<double> dp((n + 1) * W, INF);
  std::vector<int32_t> bop((n + 1) * W, OP_NONE);
  dp[0] = 0.0;

  auto relax = [&](int64_t ni, int64_t nj, double cost, int32_t op) {
    const int64_t idx = ni * W + nj;
    if (cost < dp[idx]) {
      dp[idx] = cost;
      bop[idx] = op;
    }
  };

  for (int32_t i = 0; i <= n; ++i) {
    for (int32_t j = 0; j <= m; ++j) {
      const double here = dp[i * W + j];
      if (here == INF) continue;
      if (i < n && j < m) {
        const double step = eq[i * m + j] ? COST_MATCH : COST_MISMATCH;
        relax(i + 1, j + 1, here + step, OP_MATCH);
      }
      if (i < n) relax(i + 1, j, here + COST_SKIP_MFA, OP_SKIP_MFA);
      if (j < m) {
        const double gap = text_kind[j] == 2   ? COST_SKIP_PROSODY
                          : text_kind[j] == 1 ? COST_SKIP_SIL
                                              : COST_SKIP_PHONE;
        relax(i, j + 1, here + gap, OP_SKIP_TEXT);
      }
      if (i + 1 < n && j < m && iot[i * m + j])
        relax(i + 2, j + 1, here + COST_IOTATION, OP_IOTATION);
      if (i < n && j + 1 < m && gem[i * m + j])
        relax(i + 1, j + 2, here + COST_GEMINATE, OP_GEMINATE);
      if (i < n && spn[i]) {
        const int32_t max_k = std::min(m - j, MAX_SPN_SPAN);
        for (int32_t k = 1; k <= max_k; ++k)
          relax(i + 1, j + k, here + COST_SPN_PER_PHONE * k, OP_SPN_BASE + k);
      }
    }
  }

  if (dp[(int64_t)n * W + m] == INF) return 1;

  // traceback: recover (i, j, op) triples in reverse
  struct Step {
    int32_t i, j, op;
  };
  std::vector<Step> ops;
  ops.reserve(n + m);
  int32_t ci = n, cj = m;
  while (ci > 0 || cj > 0) {
    const int32_t op = bop[(int64_t)ci * W + cj];
    if (op == OP_NONE) return 1;
    int32_t pi = ci, pj = cj;
    if (op == OP_MATCH) {
      pi -= 1;
      pj -= 1;
    } else if (op == OP_SKIP_MFA) {
      pi -= 1;
    } else if (op == OP_SKIP_TEXT) {
      pj -= 1;
    } else if (op == OP_IOTATION) {
      pi -= 2;
      pj -= 1;
    } else if (op == OP_GEMINATE) {
      pi -= 1;
      pj -= 2;
    } else {  // spn 1:k
      pi -= 1;
      pj -= op - OP_SPN_BASE;
    }
    ops.push_back({pi, pj, op});
    ci = pi;
    cj = pj;
  }

  std::memset(durations, 0, sizeof(int32_t) * m);
  int32_t pending = 0;
  for (auto it = ops.rbegin(); it != ops.rend(); ++it) {
    const int32_t i = it->i, j = it->j, op = it->op;
    if (op == OP_MATCH) {
      durations[j] = mfa_frames[i] + pending;
      pending = 0;
    } else if (op == OP_SKIP_MFA) {
      pending += mfa_frames[i];
    } else if (op == OP_SKIP_TEXT) {
      durations[j] = 0;
    } else if (op == OP_IOTATION) {
      durations[j] = mfa_frames[i] + mfa_frames[i + 1] + pending;
      pending = 0;
    } else if (op == OP_GEMINATE) {
      const int32_t total = mfa_frames[i] + pending;
      durations[j] = total / 2;
      durations[j + 1] = total - total / 2;
      pending = 0;
    } else {  // spn 1:k
      const int32_t k = op - OP_SPN_BASE;
      const int32_t total = mfa_frames[i] + pending;
      pending = 0;
      const int32_t per = total / k, rem = total % k;
      for (int32_t off = 0; off < k; ++off)
        durations[j + off] = per + (off < rem ? 1 : 0);
    }
  }
  if (pending > 0) durations[m - 1] += pending;
  return 0;
}

}  // extern "C"
