// The batched NFA step as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the JAX package's fused Pallas TPU kernel,
// kafkastreams_cep_tpu/ops/pallas_step.py::build_pallas_batched_advance
// (kernel body :364-905, launched at :965), and computes what it computes:
// for every key, its R run lanes advance through the T events of a
// micro-batch -- window expiry against max(ts, wm), the L-level epsilon
// descent, stateful predicates and fold registers, the seq_collisions
// detector, buffer-node puts ranked into P_CAP, branch clones and begin
// re-adds, the 3L-slot table in the oracle's DFS order, fresh run ids,
// match extraction (M_STEP), lane compaction and 8 counters. The plain
// PyTorch version of the same function is ops/step.py; the two are held
// bitwise equal on the card (chip_smoke.py) and, through a g++ build of
// this file under cpu_emu.h, in the CPU tests.
//
// What bounds it on an H100. The data is small: at the flagship shape
// (skip_any8: K = 2048 keys, T = 64 events, R = 320 lanes, D = 11 Dewey
// digits, A = 1 register, P_CAP = 128, M_STEP = 32) one launch reads and
// writes the lane state once, reads xi and writes the w_* rows: 351 MB,
// 0.105 ms at 3.35 TB/s. The work is a chain of dependent integer
// operations per live lane and event (stage-table lookups, the descent,
// the slot table, a prefix scan), and most of a key's R lanes are empty
// (about 11 live lanes per key and event on average at the flagship, p90
// 26). Work is issued for live lanes only, so a launch lasts about as
// long as its busiest key takes to walk its chunks through the T events:
// the latency of one warp's dependent chain bounds it, not bytes
// (PERF.md has the measurements).
//
// Design. One warp per key, 16 keys per block (one block per SM, every
// key of the flagship resident at once), no block barrier between the
// staging of the stage tables and the exit:
//   * The key's lanes live in a scratch table in device memory (the
//     wrapper allocates it; 2 x NREC x R words per key, double-buffered by
//     event parity, field-major so a chunk's loads coalesce). Only the
//     live prefix is touched, so the working set stays in the 50 MB L2.
//   * Per event the warp walks the live lanes in chunks of 32 and touches
//     no chunk past the live count. Ranks still run in lane order across
//     the whole key: each chunk's warp scan (warp shuffles, two counts
//     packed per word) is offset by running bases carried from chunk to
//     chunk, so puts into P_CAP, matches into M_STEP, fresh seq ids and
//     kept lanes land where the plain version's exclusive prefix puts
//     them. Each thread walks only its own occupied slots, scattering
//     kept lanes to the other parity's table, which the next event reads
//     after a __syncwarp. What the descent asks of a stage (its consume
//     op, proceed kind, flags, whether the predicate of an edge holds) is
//     a bit of a 64-bit stage mask in registers -- the predicate masks are
//     built once per event from the stateless predicates, plus each lane's
//     stateful ones -- and the few integer lookups left (targets, windows,
//     names) read shared memory without a branch.
//   * The next event's xi/xf row is loaded into registers before the
//     current event computes; its columns reach the warp by shuffles, the
//     stateless predicate bits by ballots.
//   * Entry gathers the active lanes, in lane order, into the table (the
//     initial state or a restored snapshot need not be compacted; an
//     inactive lane contributes nothing, so no rank moves). Exit waits for
//     the block's 16 keys and writes their state together: the state is
//     K-last ([R, K], [R, D, K], as the post pass reads it), so a warp's
//     store covers 16 consecutive keys of two lanes, not 32 lanes of one
//     key 4 x K bytes apart (32 partial sectors a store, which congests the
//     memory system under every warp still walking its events). Past the
//     live count go the defaults; a key whose events were all padding
//     writes its state back as it came in.
//
// Exactness: integer planes and f32 fold registers are bitwise the plain
// version's. Build with --fmad=false (no contraction) and IEEE division;
// integer // and % follow XLA's division as jnp does (helpers below).
//
// The per-query parts -- sizes, stage tables, the stateful predicates and
// the fold updates as C -- come from ops/codegen.py in "nfa_query.cuh".

#include <climits>
#include <cmath>
#include <cstdint>

#ifdef NFA_CPU_EMU
#include "cpu_emu.h"
#else
#include <cuda_runtime.h>
#endif

// ---- jnp arithmetic (XLA division semantics, wrapping int32) ------------
__device__ __forceinline__ int jadd_i(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int jsub_i(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int jmul_i(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int jdiv_trunc(int a, int b) {
  if (b == 0) return -1;
  if (a == INT_MIN && b == -1) return INT_MIN;
  return a / b;
}
__device__ __forceinline__ int jrem_trunc(int a, int b) {
  if (b == 0) return a;
  if (b == -1) return 0;
  return a % b;
}
__device__ __forceinline__ int jsign_i(int a) { return (a > 0) - (a < 0); }
__device__ __forceinline__ int jfloordiv_i(int a, int b) {
  const int q = jdiv_trunc(a, b);
  return (jsign_i(a) != jsign_i(b) && jrem_trunc(a, b) != 0) ? jsub_i(q, 1) : q;
}
__device__ __forceinline__ int jmod_i(int a, int b) {
  if (b == 0) b = 1;
  const int t = jrem_trunc(a, b);
  return (((t < 0) != (b < 0)) && t != 0) ? jadd_i(t, b) : t;
}
__device__ __forceinline__ float jfloordiv_f(float a, float b) {
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div = div - 1.0f;
  return roundf(div);
}
__device__ __forceinline__ float jmod_f(float a, float b) {
  const float t = fmodf(a, b);
  return (((t < 0.0f) != (b < 0.0f)) && t != 0.0f) ? t + b : t;
}

// Stage-table rows in s_tab (filled from c_tab at block start); the
// yes/no facts about stages are the header's M_* stage masks.
enum { TB_CONSUME_TARGET, TB_PROCEED_TARGET, TB_WINDOW, TB_NAME_ID, TB_PURE_NAME, N_TAB };
enum { PR_NONE = 0, PR_PROCEED = 1, PR_SKIP = 2 };
// Counter order (ops/step.py COUNTER_FIELDS).
enum { C_RUNS, C_EVENTS, C_BRANCHES, C_EXPIRED, C_LANE_DROPS, C_NODE_DROPS,
       C_MATCH_DROPS, C_COLLISIONS, N_CTR };
// Fields of one lane record in the scratch lane table (the Dewey digits
// and the registers follow F_VER; a lane in the table is active).
enum { F_SRC, F_EPS, F_VLEN, F_SEQ, F_NODE, F_ROOT, F_TS, F_BR, F_IG, F_VER };
#include "nfa_query.cuh"

constexpr int NREC = F_VER + D + 2 * A;
constexpr int S = 3 * L;
static_assert(S <= 64, "slot masks are 64-bit");
#if NFA_WIDE_MASKS
// Wide masks: a query past 64 stages or 64 predicates (stacked queries,
// ops/tables.py compile_multi_query). Each stage set is an SMask of SW
// 64-bit words and each predicate set a PMask of PW words (the header's
// Mask<W>, held in registers; a word is read by selects). The blocks
// marked NFA_WIDE_MASKS are resolved by ops/step_kernel.py when it
// splices in the header: a query of at most 64 stages and 64 predicates
// gets the single-word code, and its source is what it was before wide
// masks existed.
static_assert(N_ST <= 64 * SW, "stage masks hold SW words");
static_assert(NP <= 64 * PW, "predicate masks hold PW words");
#else
static_assert(N_ST <= 64, "stage masks are 64-bit");
#endif  // NFA_WIDE_MASKS
constexpr int WARPS = 16;                 // keys per block, one warp each
constexpr int NTHREADS = 32 * WARPS;      // one block per SM: <= 128 registers
constexpr int XW = (CI + 31) / 32;        // xi words each thread holds of a row
constexpr int FW = NF > 0 ? (NF + 31) / 32 : 1;
constexpr unsigned FULL = 0xffffffffu;
// Scratch words per key: two lane tables (event parity), then the
// fold-divergence detector's event-start seq/active arrays.
constexpr int TABLE_WORDS = NREC * R;
constexpr long long SCRATCH_WORDS = 2LL * TABLE_WORDS + (HAS_FOLDS ? 2 * R : 0);

struct Args {
  const int* xi;           // [T, K, CI]
  const float* xf;         // [T, K, CF] (null when CF == 0)
  // state in (K-last engine layout)
  const uint8_t* active; const int* src; const int* eps; const int* vlen;
  const int* seq; const int* node; const int* ts; const uint8_t* branching;
  const uint8_t* ignored; const int* root; const int* ver;
  const float* regs; const uint8_t* regs_set; const int* gc_phase;
  const int* ctr_in[N_CTR];
  // state out
  uint8_t* o_active; int* o_src; int* o_eps; int* o_vlen; int* o_seq;
  int* o_node; int* o_ts; uint8_t* o_branching; uint8_t* o_ignored;
  int* o_root; int* o_ver; float* o_regs; uint8_t* o_regs_set;
  int* ctr_out[N_CTR];
  // step outputs
  int* w_event; int* w_name; int* w_pred;   // [T, K, P_CAP]
  int* w_match; int* w_mroot;               // [T, K, M_STEP]
  int* scratch;                             // [K, SCRATCH_WORDS]
  int T, K;
};

// a[i] of a small register array, by selects (no local memory).
template <class T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = i == j ? a[j] : v;
  return v;
}

// Inclusive warp scan.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__global__ void __launch_bounds__(NTHREADS, 1) nfa_step_kernel(Args a) {
  __shared__ int s_tab[N_TAB][N_ST];
  for (int i = threadIdx.x; i < N_TAB * N_ST; i += NTHREADS)
    s_tab[i / N_ST][i % N_ST] = c_tab[i / N_ST][i % N_ST];
  __shared__ int s_exit_live[WARPS], s_exit_parity[WARPS];
  __syncthreads();  // the tables are staged; each warp runs alone until the exit

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * WARPS + warp;
  const int K = a.K;
  const unsigned lanes_below = (1u << lane) - 1u;

  // Stage-table lookups without a branch: the index is clamped into the
  // table, an id outside it reads as 0. `has` tests a stage's bit of one
  // of the header's stage masks; an id outside the table has none.
  auto tab = [&](int t, int id) -> int {
    const int v = s_tab[t][min(max(id, 0), N_ST - 1)];
    return (unsigned)id < (unsigned)N_ST ? v : 0;
  };
#if NFA_WIDE_MASKS
  auto has = [](const SMask& mask, int id) -> bool {
    return (unsigned)id < (unsigned)N_ST && ((mask.word(id >> 6) >> (id & 63)) & 1ull);
  };
#else
  auto has = [](unsigned long long mask, int id) -> bool {
    return (unsigned)id < (unsigned)N_ST && ((mask >> (id & 63)) & 1ull);
  };
#endif  // NFA_WIDE_MASKS
  // Window expiry of an active lane at clock clk.
  auto expired_at = [&](int src, int eps, int ts, int clk) -> bool {
    const int w_src = tab(TB_WINDOW, src);
#if STRICT_WINDOWS
    int w_eps = tab(TB_WINDOW, eps);
    if (w_eps < 0) w_eps = w_src;
    const int eff_window = eps >= 0 ? w_eps : w_src;
    return ts >= 0 && eff_window >= 0 && jsub_i(clk, ts) > eff_window;
#else
    const int eff_window = eps >= 0 ? -1 : w_src;
    return !has(M_IS_BEGIN, src) && eff_window >= 0 && jsub_i(clk, ts) > eff_window;
#endif
  };

  int n_live = 0, parity = 0;
  bool touched = false;  // a valid event ran: the state goes out compacted
  if (k < K) {
    int* const table0 = a.scratch + (size_t)k * SCRATCH_WORDS;

    // ---- entry: gather the active lanes, in lane order, into table 0 -------
    for (int c = 0; c < R; c += 32) {
      const int j = c + lane;
      const bool act = j < R && a.active[(size_t)j * K + k] != 0;
      const unsigned m = __ballot_sync(FULL, act);
      if (act) {
        int* rec = table0 + n_live + __popc(m & lanes_below);
        const size_t o = (size_t)j * K + k;
        rec[F_SRC * R] = a.src[o]; rec[F_EPS * R] = a.eps[o]; rec[F_VLEN * R] = a.vlen[o];
        rec[F_SEQ * R] = a.seq[o]; rec[F_NODE * R] = a.node[o]; rec[F_ROOT * R] = a.root[o];
        rec[F_TS * R] = a.ts[o]; rec[F_BR * R] = a.branching[o] != 0;
        rec[F_IG * R] = a.ignored[o] != 0;
#pragma unroll
        for (int d = 0; d < D; ++d) rec[(F_VER + d) * R] = a.ver[((size_t)j * D + d) * K + k];
#pragma unroll
        for (int s = 0; s < A; ++s) {
          rec[(F_VER + D + s) * R] = __float_as_int(a.regs[((size_t)j * A + s) * K + k]);
          rec[(F_VER + D + A + s) * R] = a.regs_set[((size_t)j * A + s) * K + k] != 0;
        }
      }
      n_live += __popc(m);
    }
    __syncwarp();  // table 0 is written
    int ctr[N_CTR];
#pragma unroll
    for (int i = 0; i < N_CTR; ++i) ctr[i] = a.ctr_in[i][k];
    const int phase = a.gc_phase[k];

    // ---- the event row, one ahead ------------------------------------------
    int x_next[XW];
    float f_next[FW];
    auto load_row = [&](int t) {
      const size_t row = (size_t)t * K + k;
#pragma unroll
      for (int w = 0; w < XW; ++w) {
        const int c = w * 32 + lane;
        x_next[w] = c < CI ? a.xi[row * CI + c] : 0;
      }
#pragma unroll
      for (int w = 0; w < FW; ++w) {
        const int c = w * 32 + lane;
        f_next[w] = c < NF ? a.xf[row * NF + c] : 0.0f;
      }
    };
    if (a.T > 0) load_row(0);

    for (int t = 0; t < a.T; ++t) {
      int x[XW];
      float xf[FW];
#pragma unroll
      for (int w = 0; w < XW; ++w) x[w] = x_next[w];
#pragma unroll
      for (int w = 0; w < FW; ++w) xf[w] = f_next[w];
      if (t + 1 < a.T) load_row(t + 1);
      auto col = [&](int c) -> int { return __shfl_sync(FULL, x[c >> 5], c & 31); };

      const size_t row = (size_t)t * K + k;
      int* wev = a.w_event + row * P_CAP;
      int* wnm = a.w_name + row * P_CAP;
      int* wpr = a.w_pred + row * P_CAP;
      int* wmt = a.w_match + row * M_STEP;
      int* wmr = a.w_mroot + row * M_STEP;
      if (col(XI_VALID) == 0) {  // padding for this key: hold state, empty rows
        for (int j = lane; j < P_CAP; j += 32) { wev[j] = -1; wnm[j] = -1; wpr[j] = -1; }
        for (int j = lane; j < M_STEP; j += 32) { wmt[j] = -1; wmr[j] = -1; }
        continue;
      }
      touched = true;
      Ev ev;
      ev.ts = col(XI_TS);
      ev.topic = col(XI_TOPIC);
#pragma unroll
      for (int j = 0; j < NI; ++j) ev.fi[j] = col(XI_FIELDS + j);
#pragma unroll
      for (int j = 0; j < NF; ++j)
        ev.ff[j] = __int_as_float(__shfl_sync(FULL, __float_as_int(xf[j >> 5]), j & 31));
      const int gidx = col(XI_GIDX);
      const int wm = col(XI_WM);
      const int clk = ev.ts > wm ? ev.ts : wm;
#if NFA_WIDE_MASKS
      PMask stateless_bits = {};
      {
        unsigned nz[XW];
#pragma unroll
        for (int w = 0; w < XW; ++w) nz[w] = __ballot_sync(FULL, x[w] != 0);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int c = XI_SPRED + p;
          if (STATELESS_MASK.bit(p) && ((nz[c >> 5] >> (c & 31)) & 1u))
            stateless_bits.w[p >> 6] |= 1ull << (p & 63);
        }
      }
      // The stages whose consume / ignore / proceed predicate holds, for
      // the stateless predicates (the same for every lane of the key).
      SMask ev_cons = {}, ev_ign = {}, ev_proc = {};
      stages_on(stateless_bits, ev_cons, ev_ign, ev_proc);
#else
      uint64_t stateless_bits = 0;
      {
        unsigned nz[XW];
#pragma unroll
        for (int w = 0; w < XW; ++w) nz[w] = __ballot_sync(FULL, x[w] != 0);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int c = XI_SPRED + p;
          if (((STATELESS_MASK >> p) & 1ull) && ((nz[c >> 5] >> (c & 31)) & 1u))
            stateless_bits |= 1ull << p;
        }
      }
      // The stages whose consume / ignore / proceed predicate holds, for
      // the stateless predicates (the same for every lane of the key).
      unsigned long long ev_cons = 0, ev_ign = 0, ev_proc = 0;
      stages_on(stateless_bits, ev_cons, ev_ign, ev_proc);
#endif  // NFA_WIDE_MASKS

      const int* cur = table0 + parity * TABLE_WORDS;
      int* nxt = table0 + (parity ^ 1) * TABLE_WORDS;
      const int base = B_NODES + (phase + t) * P_CAP;

#if HAS_FOLDS
      // Event-start seq and activity of every live lane, for the
      // fold-divergence detector (which compares across chunks).
      int* d_seq = table0 + 2 * TABLE_WORDS;
      int* d_act = d_seq + R;
      for (int j = lane; j < n_live; j += 32) {
        d_seq[j] = cur[F_SEQ * R + j];
        d_act[j] = !expired_at(cur[F_SRC * R + j], cur[F_EPS * R + j], cur[F_TS * R + j], clk);
      }
      __syncwarp();
      bool collide = false;
#endif

      // Running bases: what the chunks before this one produced.
      int b_put = 0, b_new = 0, b_match = 0, b_keep = 0, n_branch = 0, n_expired = 0;
      for (int c0 = 0; c0 < n_live; c0 += 32) {
        const int j = c0 + lane;
        const bool is_lane = j < n_live;

        // ---- the lane's record (an empty lane past the live count is inactive)
        bool st_act = false, st_br = false, st_ig = false;
        int st_src = 0, st_eps = -1, st_vlen = 0, st_seq = 0, st_node = -1,
            st_root = -1, st_ts = -1;
        int ver[D];
        float regs[A];
        bool rset[A];
#pragma unroll
        for (int d = 0; d < D; ++d) ver[d] = 0;
#pragma unroll
        for (int s = 0; s < A; ++s) { regs[s] = 0.0f; rset[s] = false; }
        if (is_lane) {
          const int* rec = cur + j;
          st_act = true;
          st_src = rec[F_SRC * R]; st_eps = rec[F_EPS * R]; st_vlen = rec[F_VLEN * R];
          st_seq = rec[F_SEQ * R]; st_node = rec[F_NODE * R]; st_root = rec[F_ROOT * R];
          st_ts = rec[F_TS * R]; st_br = rec[F_BR * R] != 0; st_ig = rec[F_IG * R] != 0;
#pragma unroll
          for (int d = 0; d < D; ++d) ver[d] = rec[(F_VER + d) * R];
#pragma unroll
          for (int s = 0; s < A; ++s) {
            regs[s] = __int_as_float(rec[(F_VER + D + s) * R]);
            rset[s] = rec[(F_VER + D + A + s) * R] != 0;
          }
        }
        // ... plus the lane's own stateful predicates.
#if NFA_WIDE_MASKS
        SMask cons = ev_cons, ign = ev_ign, proc = ev_proc;
#else
        unsigned long long cons = ev_cons, ign = ev_ign, proc = ev_proc;
#endif  // NFA_WIDE_MASKS
        if (is_lane) stages_on(stateful_pred_bits(ev, regs, rset), cons, ign, proc);

        // ---- window expiry -------------------------------------------------
        const bool root_begin = has(M_IS_BEGIN, st_src);
        const bool expired = st_act && expired_at(st_src, st_eps, st_ts, clk);
        const bool act = st_act && !expired;
        const bool root_fwd = st_eps >= 0 || has(M_IS_FWD, st_src);
        const int start_ts = root_begin ? ev.ts : st_ts;
        const bool state_match = (st_eps >= 0 && has(M_IS_FINAL, st_eps)) ||
                                 (st_eps < 0 && has(M_FWD_FINAL, st_src));

        // ---- downward pass: unrolled epsilon descent -----------------------
        int lv_cs[L], lv_vlen[L], lv_ps[L];
        bool lv_alive[L], lv_cm[L], lv_take[L], lv_igm[L], lv_branch[L];
        {
          bool alive = act, is_eps = st_eps >= 0, br = st_br, ig = st_ig;
          int cs = st_src, ceps = st_eps, vlen = st_vlen, ps = -1;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const bool c_m = alive && !is_eps && has(M_COP_ANY & cons, cs);
            const bool take_m = c_m && has(M_COP_TAKE, cs);
            const bool ig_m = alive && !is_eps && has(ign, cs);
            const int pk = is_eps ? PR_PROCEED
                           : has(M_PK_PROCEED, cs) ? PR_PROCEED
                           : has(M_PK_SKIP, cs) ? PR_SKIP : PR_NONE;
            const int ptgt = is_eps ? ceps : tab(TB_PROCEED_TARGET, cs);
            const bool p_m = alive && pk != PR_NONE && (is_eps || has(proc, cs));
            const bool p_strict = p_m && pk == PR_PROCEED;
            const bool branch_m = (p_strict && take_m) || (ig_m && (c_m || p_strict));
            const bool pure_differs = (l == 0 && is_eps)
                                          ? tab(TB_PURE_NAME, ceps) != tab(TB_PURE_NAME, cs)
                                          : has(M_PURE_DIFF, cs);
            const bool fwd_next = p_m && pure_differs && !br && !ig;
            lv_alive[l] = alive; lv_cs[l] = cs; lv_vlen[l] = vlen; lv_ps[l] = ps;
            lv_cm[l] = c_m; lv_take[l] = take_m; lv_igm[l] = ig_m; lv_branch[l] = branch_m;
            if (fwd_next) { vlen += 1; br = false; ig = false; }
            if (pk != PR_SKIP) ps = cs;
            alive = p_m;
            cs = ptgt < 0 ? 0 : ptgt;
            is_eps = false;
            ceps = -1;
          }
        }

        // ---- fold-register chain (deepest level first) ---------------------
        float cregs[L][A];
        bool cset[L][A];
        float fregs[A];
        bool fset[A];
#pragma unroll
        for (int s = 0; s < A; ++s) { fregs[s] = regs[s]; fset[s] = rset[s]; }
#pragma unroll
        for (int l = L - 1; l >= 0; --l) {
#pragma unroll
          for (int s = 0; s < A; ++s) { cregs[l][s] = fregs[s]; cset[l][s] = fset[s]; }
          apply_folds(ev, lv_cm[l], lv_cs[l], fregs, fset);
        }

#if HAS_FOLDS
        // ---- fold-divergence detector: a consuming lane whose seq another
        // active lane of the key shares (event-start table, every chunk) ----
        {
          bool consuming = false;
#pragma unroll
          for (int l = 0; l < L; ++l) consuming = consuming || lv_cm[l];
          bool hit = false;
          if (consuming)
            for (int i = 0; i < n_live; ++i)
              if (i != j && d_act[i] && d_seq[i] == st_seq) { hit = true; break; }
          collide = __any_sync(FULL, hit) || collide;
        }
#endif

        // ---- upward pass: clones / begin re-adds ---------------------------
        bool u_ign[L], u_clone[L], u_copy[L], u_fresh[L], u_root[L], u_add[L];
        {
          bool desc_any = false;
#pragma unroll
          for (int l = L - 1; l >= 0; --l) {
            const bool ignore_emit = lv_igm[l] && !lv_branch[l];
            const bool clone_m = lv_branch[l] && lv_cm[l];
            const bool rootcopy_m = lv_branch[l] && !lv_cm[l] && !desc_any;
            const bool readd_cond = root_begin && !root_fwd && lv_alive[l];
            const bool fresh = readd_cond && lv_cm[l];
            const bool rroot = readd_cond && !lv_cm[l];
            const bool ns_before = lv_cm[l] || ignore_emit || desc_any || clone_m || rootcopy_m;
            u_ign[l] = ignore_emit; u_clone[l] = clone_m; u_copy[l] = rootcopy_m;
            u_fresh[l] = fresh; u_root[l] = rroot; u_add[l] = fresh && ns_before;
            desc_any = ns_before || fresh || rroot;
          }
        }

        // ---- slot flags in oracle DFS order --------------------------------
        // slot l < L: level l's consume/ignore emission; then for each level
        // from the deepest up, its clone (or root copy) and its begin re-add.
        uint64_t occ = 0, mat = 0, nsq = 0;
        int c_put = 0, c_branch = 0;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const bool match_consume = lv_take[l] ? has(M_IS_FINAL, lv_cs[l])
                                                : has(M_ISFIN_CTGT, lv_cs[l]);
          if (lv_cm[l] || u_ign[l]) occ |= 1ull << l;
          if (lv_cm[l] ? match_consume : state_match) mat |= 1ull << l;
          c_put += lv_cm[l] ? 1 : 0;
          c_branch += u_clone[l] ? 1 : 0;
        }
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const int l = L - 1 - i;
          const int sc = L + 2 * i, sr = sc + 1;
          if (u_clone[l] || u_copy[l]) occ |= 1ull << sc;
          if (u_clone[l] ? has(M_IS_FINAL, lv_cs[l]) : state_match) mat |= 1ull << sc;
          if (u_clone[l]) nsq |= 1ull << sc;
          if (u_fresh[l] || u_root[l]) occ |= 1ull << sr;
          if (state_match) mat |= 1ull << sr;
          if (u_fresh[l]) nsq |= 1ull << sr;
        }
        nsq &= occ;
        const uint64_t m_slots = occ & mat, k_slots = occ & ~mat;

        // ---- the chunk's scan (two counts of at most 32 x 64 per word),
        // offset by the running bases: ranks in lane order across the key
        const int v0 = c_put | ((int)__popcll(nsq) << 16);
        const int v1 = (int)__popcll(m_slots) | ((int)__popcll(k_slots) << 16);
        const int v2 = c_branch | ((expired ? 1 : 0) << 16);
        const int i0 = warp_scan(v0, lane), i1 = warp_scan(v1, lane), i2 = warp_scan(v2, lane);
        const int t0 = __shfl_sync(FULL, i0, 31), t1 = __shfl_sync(FULL, i1, 31),
                  t2 = __shfl_sync(FULL, i2, 31);
        const int e0 = i0 - v0, e1 = i1 - v1;

        // ---- buffer puts at their rank (w_event is written whole below) ---
        int put_idx[L];
        {
          int pr = b_put + (e0 & 0xffff);
#pragma unroll
          for (int l = 0; l < L; ++l) {
            put_idx[l] = -1;
            if (lv_cm[l]) {
              if (pr < P_CAP) {
                put_idx[l] = base + pr;
                wnm[pr] = tab(TB_NAME_ID, lv_cs[l]);
                wpr[pr] = st_node;
              }
              ++pr;
            }
          }
        }

        // ---- slots: fresh run ids, matches, surviving lanes ----------------
        // Each thread walks its own occupied slots (most lanes have one or
        // two), ranked in slot order from the chunk's exclusive prefixes.
        {
          const int ns0 = b_new + (e0 >> 16), m0 = b_match + (e1 & 0xffff),
                    k0 = b_keep + (e1 >> 16);
          for (uint64_t todo = occ; todo != 0; todo &= todo - 1) {
            const int s = __ffsll((long long)todo) - 1;
            const uint64_t below = (1ull << s) - 1ull;
            // level / clone / re-add decoding of slot s
            const bool is_level = s < L;
            const int i = is_level ? 0 : (s - L) >> 1;
            const int l = is_level ? s : L - 1 - i;
            const bool is_clone = !is_level && ((s - L) & 1) == 0;
            const int cs = pick(lv_cs, l), vl = pick(lv_vlen, l);
            int o_src, o_eps, o_vlen, o_node, o_ts, addpos = -1;
            bool o_br, o_ig, clone_regs = false, zero_regs = false;
            if (is_level) {
              const bool c_m = pick(lv_cm, l);
              o_src = c_m ? cs : st_src;
              o_eps = c_m ? (pick(lv_take, l) ? cs : tab(TB_CONSUME_TARGET, cs)) : st_eps;
              o_vlen = vl;
              o_node = c_m ? pick(put_idx, l) : st_node;
              o_ts = c_m ? start_ts : st_ts;
              o_br = false;
              o_ig = !c_m;
            } else if (is_clone) {
              const bool m = pick(u_clone, l);
              const int ps = pick(lv_ps, l);
              const bool has_ps = ps >= 0;
              const bool ps_begin = !has_ps || has(M_IS_BEGIN, ps);
              const int off = (ps_begin && vl >= 2) ? 2 : 1;
              o_src = m ? (has_ps ? ps : cs) : st_src;
              o_eps = m ? cs : st_eps;
              if (m) addpos = vl - off;
              o_vlen = m ? vl : st_vlen;
              o_node = m ? (pick(lv_igm, l) ? st_node : pick(put_idx, l)) : st_node;
              o_ts = m ? start_ts : st_ts;
              o_br = m || st_br;
              o_ig = !m && st_ig;
              clone_regs = m;
            } else {
              const bool m = pick(u_fresh, l);
              o_src = st_src;
              o_eps = st_eps;
              if (m && pick(u_add, l)) addpos = vl - 1;
              o_vlen = m ? vl : st_vlen;
              o_node = m ? -1 : st_node;
              o_ts = m ? -1 : st_ts;
              o_br = !m && st_br;
              o_ig = !m && st_ig;
              zero_regs = m;
            }
            const int o_seq = ((nsq >> s) & 1ull)
                                  ? ctr[C_RUNS] + 1 + ns0 + (int)__popcll(nsq & below)
                                  : st_seq;
            const int o_root = st_root >= 0 ? st_root : o_node;
            if ((mat >> s) & 1ull) {
              const int m = m0 + (int)__popcll(m_slots & below);
              if (m < M_STEP) { wmt[m] = o_node; wmr[m] = o_root; }
            } else {
              const int q = k0 + (int)__popcll(k_slots & below);
              if (q < R) {
                int* rec = nxt + q;
                rec[F_SRC * R] = o_src; rec[F_EPS * R] = o_eps; rec[F_VLEN * R] = o_vlen;
                rec[F_SEQ * R] = o_seq; rec[F_NODE * R] = o_node; rec[F_ROOT * R] = o_root;
                rec[F_TS * R] = o_ts; rec[F_BR * R] = o_br ? 1 : 0; rec[F_IG * R] = o_ig ? 1 : 0;
#pragma unroll
                for (int d = 0; d < D; ++d) rec[(F_VER + d) * R] = ver[d] + (d == addpos ? 1 : 0);
#pragma unroll
                for (int sl = 0; sl < A; ++sl) {
                  float v = fregs[sl];
                  bool b = fset[sl];
                  if (clone_regs) {
#pragma unroll
                    for (int ll = 0; ll < L; ++ll)
                      if (ll == l) { v = cregs[ll][sl]; b = cset[ll][sl]; }
                  }
                  if (zero_regs) { v = 0.0f; b = false; }
                  rec[(F_VER + D + sl) * R] = __float_as_int(v);
                  rec[(F_VER + D + A + sl) * R] = b ? 1 : 0;
                }
              }
            }
          }
        }
        b_put += t0 & 0xffff; b_new += t0 >> 16;
        b_match += t1 & 0xffff; b_keep += t1 >> 16;
        n_branch += t2 & 0xffff; n_expired += t2 >> 16;
      }

      // ---- the rest of the rows: w_event whole, empty tails ----------------
      const int n_w = b_put < P_CAP ? b_put : P_CAP;
      for (int j = lane; j < P_CAP; j += 32) {
        wev[j] = j < n_w ? gidx : -1;
        if (j >= n_w) { wnm[j] = -1; wpr[j] = -1; }
      }
      const int n_m = b_match < M_STEP ? b_match : M_STEP;
      for (int j = n_m + lane; j < M_STEP; j += 32) { wmt[j] = -1; wmr[j] = -1; }
      __syncwarp();  // the kept lanes are the next event's table

      // ---- counters (every lane keeps the warp-uniform copy) --------------
      ctr[C_RUNS] += b_new;
      ctr[C_EVENTS] += 1;
      ctr[C_BRANCHES] += n_branch;
      ctr[C_EXPIRED] += n_expired;
      ctr[C_LANE_DROPS] += b_keep > R ? b_keep - R : 0;
      ctr[C_NODE_DROPS] += b_put > P_CAP ? b_put - P_CAP : 0;
      ctr[C_MATCH_DROPS] += b_match > M_STEP ? b_match - M_STEP : 0;
#if HAS_FOLDS
      ctr[C_COLLISIONS] += collide ? 1 : 0;
#endif
      n_live = b_keep < R ? b_keep : R;
      parity ^= 1;
    }

    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N_CTR; ++i) a.ctr_out[i][k] = ctr[i];
      s_exit_live[warp] = touched ? n_live : -1;
      s_exit_parity[warp] = parity;
    }
  }

  // ---- exit: the block writes its keys' lane state together -------------
  // A thread takes one key and every (NTHREADS / WARPS)-th lane, so a
  // warp's store covers whole runs of the block's consecutive keys in the
  // K-last state. A key whose events were all padding writes its state back
  // as it came in; past the live count go the compaction's defaults.
  __syncthreads();
  const int kl = threadIdx.x % WARPS;
  const int kk = blockIdx.x * WARPS + kl;
  if (kk >= K) return;
  const int live = s_exit_live[kl];
  const int* fin = a.scratch + (size_t)kk * SCRATCH_WORDS + s_exit_parity[kl] * TABLE_WORDS;
  for (int j = threadIdx.x / WARPS; j < R; j += NTHREADS / WARPS) {
    const size_t o = (size_t)j * K + kk;
    if (live < 0) {
      a.o_active[o] = a.active[o]; a.o_src[o] = a.src[o]; a.o_eps[o] = a.eps[o];
      a.o_vlen[o] = a.vlen[o]; a.o_seq[o] = a.seq[o]; a.o_node[o] = a.node[o];
      a.o_ts[o] = a.ts[o]; a.o_branching[o] = a.branching[o];
      a.o_ignored[o] = a.ignored[o]; a.o_root[o] = a.root[o];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const size_t od = ((size_t)j * D + d) * K + kk;
        a.o_ver[od] = a.ver[od];
      }
#pragma unroll
      for (int s = 0; s < A; ++s) {
        const size_t os = ((size_t)j * A + s) * K + kk;
        a.o_regs[os] = a.regs[os];
        a.o_regs_set[os] = a.regs_set[os];
      }
    } else if (j < live) {
      const int* rec = fin + j;
      a.o_active[o] = 1; a.o_src[o] = rec[F_SRC * R]; a.o_eps[o] = rec[F_EPS * R];
      a.o_vlen[o] = rec[F_VLEN * R]; a.o_seq[o] = rec[F_SEQ * R];
      a.o_node[o] = rec[F_NODE * R]; a.o_ts[o] = rec[F_TS * R];
      a.o_branching[o] = (uint8_t)rec[F_BR * R]; a.o_ignored[o] = (uint8_t)rec[F_IG * R];
      a.o_root[o] = rec[F_ROOT * R];
#pragma unroll
      for (int d = 0; d < D; ++d) a.o_ver[((size_t)j * D + d) * K + kk] = rec[(F_VER + d) * R];
#pragma unroll
      for (int s = 0; s < A; ++s) {
        const size_t os = ((size_t)j * A + s) * K + kk;
        a.o_regs[os] = __int_as_float(rec[(F_VER + D + s) * R]);
        a.o_regs_set[os] = (uint8_t)rec[(F_VER + D + A + s) * R];
      }
    } else {
      a.o_active[o] = 0; a.o_src[o] = 0; a.o_eps[o] = -1; a.o_vlen[o] = 0;
      a.o_seq[o] = 0; a.o_node[o] = -1; a.o_ts[o] = -1; a.o_branching[o] = 0;
      a.o_ignored[o] = 0; a.o_root[o] = -1;
#pragma unroll
      for (int d = 0; d < D; ++d) a.o_ver[((size_t)j * D + d) * K + kk] = 0;
#pragma unroll
      for (int s = 0; s < A; ++s) {
        const size_t os = ((size_t)j * A + s) * K + kk;
        a.o_regs[os] = 0.0f;
        a.o_regs_set[os] = 0;
      }
    }
  }
}

// Host entry, bound with ctypes. `p` holds the pointers in Args order
// (xi, xf, 14 state-in leaves, 8 counters in, 13 state-out leaves,
// 8 counters out, 5 outputs, the scratch). Returns the launch's
// cudaError_t.
extern "C" int nfa_step_launch(void** p, int T, int K, void* stream) {
  Args a;
  int i = 0;
  a.xi = (const int*)p[i++]; a.xf = (const float*)p[i++];
  a.active = (const uint8_t*)p[i++]; a.src = (const int*)p[i++];
  a.eps = (const int*)p[i++]; a.vlen = (const int*)p[i++];
  a.seq = (const int*)p[i++]; a.node = (const int*)p[i++];
  a.ts = (const int*)p[i++]; a.branching = (const uint8_t*)p[i++];
  a.ignored = (const uint8_t*)p[i++]; a.root = (const int*)p[i++];
  a.ver = (const int*)p[i++]; a.regs = (const float*)p[i++];
  a.regs_set = (const uint8_t*)p[i++]; a.gc_phase = (const int*)p[i++];
  for (int c = 0; c < N_CTR; ++c) a.ctr_in[c] = (const int*)p[i++];
  a.o_active = (uint8_t*)p[i++]; a.o_src = (int*)p[i++]; a.o_eps = (int*)p[i++];
  a.o_vlen = (int*)p[i++]; a.o_seq = (int*)p[i++]; a.o_node = (int*)p[i++];
  a.o_ts = (int*)p[i++]; a.o_branching = (uint8_t*)p[i++];
  a.o_ignored = (uint8_t*)p[i++]; a.o_root = (int*)p[i++];
  a.o_ver = (int*)p[i++]; a.o_regs = (float*)p[i++]; a.o_regs_set = (uint8_t*)p[i++];
  for (int c = 0; c < N_CTR; ++c) a.ctr_out[c] = (int*)p[i++];
  a.w_event = (int*)p[i++]; a.w_name = (int*)p[i++]; a.w_pred = (int*)p[i++];
  a.w_match = (int*)p[i++]; a.w_mroot = (int*)p[i++];
  a.scratch = (int*)p[i++];
  a.T = T;
  a.K = K;
  const int blocks = (K + WARPS - 1) / WARPS;
#ifdef NFA_CPU_EMU
  emu::launch(blocks, NTHREADS, [&]() { nfa_step_kernel(a); });
  return 0;
#else
  nfa_step_kernel<<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
#endif
}

// Scratch the wrapper allocates: int32 words per key.
extern "C" long long nfa_step_scratch_words() { return SCRATCH_WORDS; }

#ifndef NFA_CPU_EMU
// Occupancy on the current card: resident blocks per SM and threads per
// block (a warp per key). Returns the cudaError_t of the query.
extern "C" int nfa_step_occupancy(int* blocks_per_sm, int* threads_per_block) {
  *threads_per_block = NTHREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, nfa_step_kernel,
                                                            NTHREADS, 0);
}
#endif

#ifdef NFA_CPU_EMU
// Expression probe of the CPU emulation build, with which the tests hold
// the generated C against eager jnp: for each of n events, the stateful
// predicate bits against the registers as given, then one stage's fold
// chain applied to those registers in place. Row-major inputs: fi [n, NI],
// ff [n, NF], regs and rset [n, A].
extern "C" void nfa_eval_exprs(int n, int stage, const int* ts, const int* topic,
                               const int* fi, const float* ff, float* regs,
                               uint8_t* rset, unsigned long long* bits) {
  for (int i = 0; i < n; ++i) {
    Ev ev;
    ev.ts = ts[i];
    ev.topic = topic[i];
    for (int j = 0; j < NI; ++j) ev.fi[j] = fi[(size_t)i * NI + j];
    for (int j = 0; j < NF; ++j) ev.ff[j] = ff[(size_t)i * NF + j];
    float* rg = regs + (size_t)i * A;
    bool rs[A > 0 ? A : 1];
    for (int a = 0; a < A; ++a) rs[a] = rset[(size_t)i * A + a] != 0;
#if NFA_WIDE_MASKS
    // bits is [n, PW] here.
    const PMask pb = stateful_pred_bits(ev, rg, rs);
    for (int w = 0; w < PW; ++w) bits[(size_t)i * PW + w] = pb.w[w];
#else
    bits[i] = stateful_pred_bits(ev, rg, rs);
#endif  // NFA_WIDE_MASKS
    apply_folds(ev, true, stage, rg, rs);
    for (int a = 0; a < A; ++a) rset[(size_t)i * A + a] = rs[a];
  }
}
#endif
