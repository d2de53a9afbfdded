// Host array engine of the port: the sequential greedy batch solve
// (solver="native") and the columnar assume's scatter-add. The counterpart
// of kubernetes_tpu/native/hostsched.cpp.
//
// The reference scheduler's hot loop (schedule_one.go:590 findNodesThatPass
// Filters + :754 prioritizeNodes) runs as compiled Go; greedy_assign is the
// native equivalent on the host: dense feasibility + score + sequential
// greedy commit over the same struct-of-arrays the scan kernel consumes
// (ops/solver.py SolverInputs). Array-in/array-out C ABI, loaded via ctypes.
//
// Formula parity with ops/solver.py greedy_scan_solve for batches without
// topology-spread constraints (those route to the scan): fit_feasible,
// dynamic NodePorts, least_allocated_score, balanced_score,
// default_normalize(napref/taint), ImageLocality bonus; sequential within
// batch, argmax score, lowest node index wins ties, capacity and ports
// committed before the next pod.

#include <cstdint>

namespace {

constexpr int32_t kMaxNodeScore = 100;  // framework/interface.go:255

// DefaultNormalizeScore (plugins/helper/normalize_score.go) over the feasible
// set: scaled = 100*raw//max; reverse flips to 100-scaled (100 when max==0).
inline int32_t normalize(int32_t raw, int64_t mx, bool reverse) {
  if (mx <= 0) return reverse ? kMaxNodeScore : 0;
  int32_t scaled = (int32_t)((int64_t)kMaxNodeScore * raw / mx);
  return reverse ? kMaxNodeScore - scaled : scaled;
}

}  // namespace

extern "C" {

// Sequential greedy batch assignment. Mutates used/used_nz/pod_count/
// node_ports (the virtual commit that makes pod p+1 see pod p's placement).
// Layouts (row-major): alloc/used/used_nz [N,R]; static_ok/napref_raw/
// taint_cnt/img_score [C,N]; class_ports [C,Pt]; node_ports [N,Pt];
// req/req_nz [P,R]. Returns number of pods placed; assignment[p] = node or -1.
int64_t greedy_assign(const int32_t* alloc, int32_t* used, int32_t* used_nz,
                      int32_t* pod_count, const int32_t* max_pods,
                      const uint8_t* static_ok, const int32_t* napref_raw,
                      const uint8_t* has_napref, const int32_t* taint_cnt,
                      const int32_t* img_score, const uint8_t* class_ports,
                      uint8_t* node_ports, const int32_t* class_of_pod,
                      const int32_t* req, const int32_t* req_nz,
                      const uint8_t* bal_active, int64_t p, int64_t n,
                      int64_t r, int64_t pt, uint8_t* feas_buf,
                      int32_t* assignment) {
  int64_t placed = 0;
  for (int64_t pi = 0; pi < p; ++pi) {
    const int64_t c = class_of_pod[pi];
    const uint8_t* ok_row = static_ok + c * n;
    const int32_t* napref_row = napref_raw + c * n;
    const int32_t* taint_row = taint_cnt + c * n;
    const int32_t* img_row = img_score + c * n;
    const uint8_t* cports = pt ? class_ports + c * pt : nullptr;
    const int32_t* preq = req + pi * r;
    const int32_t* preq_nz = req_nz + pi * r;

    // pass 1: feasibility (fit_feasible + class filter + dynamic ports) and
    // the normalization maxima over the feasible set
    int64_t napref_max = 0, taint_max = 0;
    for (int64_t i = 0; i < n; ++i) {
      uint8_t ok = ok_row[i];
      if (ok && pod_count[i] + 1 > max_pods[i]) ok = 0;
      if (ok) {
        const int32_t* a = alloc + i * r;
        const int32_t* u = used + i * r;
        for (int64_t k = 0; k < r; ++k) {
          if (preq[k] != 0 && preq[k] > a[k] - u[k]) { ok = 0; break; }
        }
      }
      if (ok && cports) {
        const uint8_t* nports = node_ports + i * pt;
        for (int64_t q = 0; q < pt; ++q) {
          if (nports[q] & cports[q]) { ok = 0; break; }
        }
      }
      feas_buf[i] = ok;
      if (ok) {
        if (napref_row[i] > napref_max) napref_max = napref_row[i];
        if (taint_row[i] > taint_max) taint_max = taint_row[i];
      }
    }

    // pass 2: score feasible nodes, track argmax (lowest index wins ties)
    int64_t best = -1;
    int64_t best_score = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (!feas_buf[i]) continue;
      const int32_t* a = alloc + i * r;
      const int32_t* unz = used_nz + i * r;
      const int32_t* u = used + i * r;
      // leastResourceScorer over cpu+memory (least_allocated.go:30)
      int64_t least = 0, wsum = 0;
      for (int k = 0; k < 2 && k < r; ++k) {
        int64_t cap = a[k];
        if (cap <= 0) continue;
        ++wsum;
        int64_t want = (int64_t)unz[k] + preq_nz[k];
        if (want <= cap) least += (cap - want) * kMaxNodeScore / cap;
      }
      if (wsum == 0) wsum = 1;
      least /= wsum;
      // balancedResourceScorer 2-resource shortcut (balanced_allocation.go:145).
      // float (not double) on purpose: the scan solver computes this in
      // float32, and the truncation at the *100 boundary must round the same
      // way for bit parity.
      int64_t bal = 0;
      if (bal_active[pi]) {
        float frac[2] = {0.0f, 0.0f};
        int n_frac = 0;
        for (int k = 0; k < 2 && k < r; ++k) {
          float cap = (float)a[k];
          if (cap <= 0.0f) continue;
          ++n_frac;
          float want = (float)u[k] + (float)preq[k];
          float f = want / cap;
          frac[k] = f > 1.0f ? 1.0f : f;
        }
        float stdv = n_frac == 2 ? (frac[0] > frac[1] ? frac[0] - frac[1]
                                                      : frac[1] - frac[0]) / 2.0f
                                 : 0.0f;
        bal = (int64_t)(int32_t)((1.0f - stdv) * (float)kMaxNodeScore);
      }
      int64_t napref =
          has_napref[c] ? normalize(napref_row[i], napref_max, false) : 0;
      int64_t taint = normalize(taint_row[i], taint_max, true);
      int64_t total = least + bal + 2 * napref + 3 * taint + img_row[i];
      if (best < 0 || total > best_score) {
        best = i;
        best_score = total;
      }
    }

    assignment[pi] = (int32_t)best;
    if (best >= 0) {
      int32_t* u = used + best * r;
      int32_t* unz = used_nz + best * r;
      for (int64_t k = 0; k < r; ++k) {
        u[k] += preq[k];
        unz[k] += preq_nz[k];
      }
      pod_count[best] += 1;
      if (cports) {
        uint8_t* nports = node_ports + best * pt;
        for (int64_t q = 0; q < pt; ++q) nports[q] |= cports[q];
      }
      ++placed;
    }
  }
  return placed;
}

// Fused columnar-assume scatter-add (the _columnar_account hot block):
// d_used[nodes[i]] += raw_req[rows[i]], d_used_nz likewise, d_count bump,
// touched-node flags — ONE pass over the batch instead of two np.add.at
// dispatches + bincount + unique. Pure array math: called via ctypes CDLL,
// which RELEASES the GIL for the duration (the scheduling thread's commit
// accounting no longer steals interpreter time from the bind worker). Must
// therefore never run under a store/scheduler lock. Layouts: raw_req/raw_req_nz [p_all, R]
// int64 row-major; d_used/d_used_nz [N, R] int64 zeroed by the caller;
// d_count [N] int64 zeroed; touched [N] uint8 zeroed.
//
// Indices are VALIDATED (pass 1) before anything is written (pass 2): the
// numpy oracle surfaces a bad node/row as a catchable IndexError that the
// assume/dispatch failure-domain guard rolls back — a silent out-of-bounds
// heap write here would defeat that machinery. Returns 0, or (bad_index+1)
// negated for the first out-of-range entry; the wrapper raises IndexError.
int64_t commit_deltas(const int64_t* rows, const int64_t* nodes, int64_t p,
                      const int64_t* raw_req, const int64_t* raw_req_nz,
                      int64_t r, int64_t p_all, int64_t n, int64_t* d_used,
                      int64_t* d_used_nz, int64_t* d_count,
                      uint8_t* touched) {
  for (int64_t i = 0; i < p; ++i) {
    if (nodes[i] < 0 || nodes[i] >= n || rows[i] < 0 || rows[i] >= p_all)
      return -(i + 1);
  }
  for (int64_t i = 0; i < p; ++i) {
    const int64_t node = nodes[i];
    const int64_t row = rows[i];
    int64_t* du = d_used + node * r;
    int64_t* dz = d_used_nz + node * r;
    const int64_t* rq = raw_req + row * r;
    const int64_t* rz = raw_req_nz + row * r;
    for (int64_t k = 0; k < r; ++k) {
      du[k] += rq[k];
      dz[k] += rz[k];
    }
    d_count[node] += 1;
    touched[node] = 1;
  }
  return 0;
}

}  // extern "C"
