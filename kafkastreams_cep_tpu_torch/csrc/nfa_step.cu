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
// bitwise equal on the card (chip_smoke.py).
//
// Design. One block per key, one thread per run lane (R rounded up to a
// whole warp), the loop over T inside the block: the lane state is loaded
// once, carried in registers across all T events and written once -- the
// counterpart of the Pallas kernel's VMEM carry. Where the TPU kernel
// ranked slots with an MXU matmul against a triangular matrix and selected
// them with one-hot matmuls (f32 16-bit splits and sentinel biasing
// included), this kernel runs one block-wide exclusive scan per event
// (warp shuffles plus one shared-memory pass over the warp totals) and
// each thread scatters its slots straight to their rank: matches and
// buffer nodes to the w_* rows, surviving slots to a shared-memory
// next-lane table the lanes reload from. Integers stay integers, so the
// 2^24 node-id and 512-cap envelope of supports_pallas() does not apply;
// this kernel's own envelope (lanes <= 1024, shared memory) is checked by
// the wrapper, ops/step_kernel.py. An event that is padding for a key
// (valid == 0) is a block-uniform branch: the state is held and the rows
// are written empty.
//
// What bounds it on an H100. The kernel moves little data: at the
// flagship shape (skip_any8: K = 2048 keys, T = 64 events, R = 320 lanes,
// D = 11 Dewey digits, A = 1 register, P_CAP = 128, M_STEP = 32) one
// launch reads and writes the lane state once (80 bytes per lane:
// 2 x 52 MB), reads xi (64 x 2048 x 21 words: 11 MB) and writes
// w_event/w_name/w_pred and w_match/w_mroot (64 x 2048 x (3 x 128 +
// 2 x 32) words: 235 MB) -- 351 MB, 0.105 ms at 3.35 TB/s. It measured
// ~2.1 ms per launch on an H100 80GB HBM3 at 700 W (PERF.md): per event
// and lane it does a few hundred
// dependent integer operations (table lookups in shared memory, the
// descent, the slot table, the scan), so it is bound by integer issue
// and by the block-wide barriers of the per-event scan, not by memory.
// The design keeps every lane's state in registers for the whole batch,
// so no event touches device memory for state, and reads each event's
// row once per block; tuning (several keys per block, persistent
// blocks, TMA for the xi rows) is later work.
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
#define NFA_DYN_SMEM(T, name) T* name = reinterpret_cast<T*>(emu::dyn_smem())
#else
#include <cuda_runtime.h>
#define NFA_DYN_SMEM(T, name) extern __shared__ T name[]
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

// Stage-table rows in s_tab (filled from c_tab at block start).
enum {
  TB_CONSUME_OP, TB_CONSUME_PRED, TB_CONSUME_TARGET, TB_IGNORE_PRED,
  TB_PROCEED_KIND, TB_PROCEED_PRED, TB_PROCEED_TARGET, TB_WINDOW,
  TB_NAME_ID, TB_PURE_NAME, TB_IS_BEGIN, TB_IS_FINAL, TB_IS_FWD,
  TB_FWD_FINAL, TB_PURE_OF_PTGT, TB_ISFIN_OF_CTGT, N_TAB
};
enum { OP_NONE = 0, OP_BEGIN = 1, OP_TAKE = 2 };
enum { PR_NONE = 0, PR_PROCEED = 1, PR_SKIP = 2 };
// Counter order (ops/step.py COUNTER_FIELDS).
enum { C_RUNS, C_EVENTS, C_BRANCHES, C_EXPIRED, C_LANE_DROPS, C_NODE_DROPS,
       C_MATCH_DROPS, C_COLLISIONS, N_CTR };
// Fields of one lane record in the shared next-lane table.
enum { F_SRC, F_EPS, F_VLEN, F_SEQ, F_NODE, F_ROOT, F_TS, F_BR, F_IG, F_VER };
#include "nfa_query.cuh"


constexpr int NREC = F_VER + D + 2 * A;
constexpr int NWARPS = NTHREADS / 32;
constexpr int S = 3 * L;
static_assert(S <= 64, "slot masks are 64-bit");
static_assert(NTHREADS % 32 == 0 && NTHREADS <= 1024, "block of whole warps");

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
  int T, K;
};

// Block-wide scan of NV per-thread counts: exclusive prefixes in thread
// order and block totals. All threads must call it.
template <int NV>
__device__ __forceinline__ void block_scan(const int (&v)[NV], int (&excl)[NV],
                                           int (&tot)[NV], int (*s_scan)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) incl[i] = v[i];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int y = __shfl_up_sync(0xffffffffu, incl[i], o);
      if (lane >= o) incl[i] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int i = 0; i < NV; ++i) s_scan[i][warp] = incl[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      int x = lane < NWARPS ? s_scan[i][lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane < NWARPS) s_scan[i][lane] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    excl[i] = (warp > 0 ? s_scan[i][warp - 1] : 0) + incl[i] - v[i];
    tot[i] = s_scan[i][NWARPS - 1];
  }
  __syncthreads();  // s_scan is rewritten by the next call
}

__global__ void __launch_bounds__(NTHREADS) nfa_step_kernel(Args a) {
  __shared__ int s_tab[N_TAB][N_ST];
  __shared__ int s_scan[6][32];
  NFA_DYN_SMEM(int, s_next);  // [NREC][R] next-lane table (+ [2][R] seq/active)
  const int k = blockIdx.x;
  const int r = threadIdx.x;
  const int K = a.K;
  const bool is_lane = r < R;

  for (int i = r; i < N_TAB * N_ST; i += NTHREADS) s_tab[i / N_ST][i % N_ST] = c_tab[i / N_ST][i % N_ST];
  __syncthreads();

  auto tab = [&](int t, int id) -> int {
    return (id >= 0 && id < N_ST) ? s_tab[t][id] : 0;
  };

  // ---- load the lane (registers for the whole batch) --------------------
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
    const size_t o = (size_t)r * K + k;
    st_act = a.active[o] != 0; st_src = a.src[o]; st_eps = a.eps[o];
    st_vlen = a.vlen[o]; st_seq = a.seq[o]; st_node = a.node[o];
    st_ts = a.ts[o]; st_br = a.branching[o] != 0; st_ig = a.ignored[o] != 0;
    st_root = a.root[o];
#pragma unroll
    for (int d = 0; d < D; ++d) ver[d] = a.ver[((size_t)r * D + d) * K + k];
#pragma unroll
    for (int s = 0; s < A; ++s) {
      regs[s] = a.regs[((size_t)r * A + s) * K + k];
      rset[s] = a.regs_set[((size_t)r * A + s) * K + k] != 0;
    }
  }
  int ctr[N_CTR];
#pragma unroll
  for (int i = 0; i < N_CTR; ++i) ctr[i] = a.ctr_in[i][k];
  const int phase = a.gc_phase[k];

  for (int t = 0; t < a.T; ++t) {
    const size_t row = (size_t)t * K + k;
    const int* x = a.xi + row * CI;
    int* wev = a.w_event + row * P_CAP;
    int* wnm = a.w_name + row * P_CAP;
    int* wpr = a.w_pred + row * P_CAP;
    int* wmt = a.w_match + row * M_STEP;
    int* wmr = a.w_mroot + row * M_STEP;
    if (x[XI_VALID] == 0) {  // padding for this key: hold state, empty rows
      for (int j = r; j < P_CAP; j += NTHREADS) { wev[j] = -1; wnm[j] = -1; wpr[j] = -1; }
      for (int j = r; j < M_STEP; j += NTHREADS) { wmt[j] = -1; wmr[j] = -1; }
      continue;
    }
    Ev ev;
    ev.ts = x[XI_TS];
    ev.topic = x[XI_TOPIC];
#pragma unroll
    for (int j = 0; j < NI; ++j) ev.fi[j] = x[XI_FIELDS + j];
#pragma unroll
    for (int j = 0; j < NF; ++j) ev.ff[j] = a.xf[row * NF + j];
    const int gidx = x[XI_GIDX];
    const int clk = ev.ts > x[XI_WM] ? ev.ts : x[XI_WM];
    uint64_t pbits = 0;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      if (((STATELESS_MASK >> p) & 1ull) && x[XI_SPRED + p] != 0) pbits |= 1ull << p;
    if (is_lane) pbits |= stateful_pred_bits(ev, regs, rset);
    auto pred = [&](int t_, int id) -> bool {
      if (id < 0 || id >= N_ST) return false;
      const int pid = s_tab[t_][id];
      return pid >= 0 && ((pbits >> pid) & 1ull);
    };

    // ---- window expiry ---------------------------------------------------
    const bool root_begin = tab(TB_IS_BEGIN, st_src) != 0;
    const int w_src = tab(TB_WINDOW, st_src);
    const int age = jsub_i(clk, st_ts);
#if STRICT_WINDOWS
    int w_eps = tab(TB_WINDOW, st_eps);
    if (w_eps < 0) w_eps = w_src;
    const int eff_window = st_eps >= 0 ? w_eps : w_src;
    const bool expired = st_act && st_ts >= 0 && eff_window >= 0 && age > eff_window;
#else
    const int eff_window = st_eps >= 0 ? -1 : w_src;
    const bool expired = st_act && !root_begin && eff_window >= 0 && age > eff_window;
#endif
    const bool act = st_act && !expired;
    const bool root_fwd = st_eps >= 0 || tab(TB_IS_FWD, st_src) != 0;
    const int start_ts = root_begin ? ev.ts : st_ts;
    const bool state_match = (st_eps >= 0 && tab(TB_IS_FINAL, st_eps) != 0) ||
                             (st_eps < 0 && tab(TB_FWD_FINAL, st_src) != 0);

    // ---- downward pass: unrolled epsilon descent -------------------------
    int lv_cs[L], lv_vlen[L], lv_ps[L];
    bool lv_alive[L], lv_cm[L], lv_take[L], lv_igm[L], lv_branch[L];
    {
      bool alive = act, is_eps = st_eps >= 0, br = st_br, ig = st_ig;
      int cs = st_src, ceps = st_eps, vlen = st_vlen, ps = -1;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int c_op = is_eps ? OP_NONE : tab(TB_CONSUME_OP, cs);
        const bool c_m = alive && !is_eps && c_op != OP_NONE && pred(TB_CONSUME_PRED, cs);
        const bool take_m = c_m && c_op == OP_TAKE;
        const bool ig_m = alive && !is_eps && pred(TB_IGNORE_PRED, cs);
        const int pk = is_eps ? PR_PROCEED : tab(TB_PROCEED_KIND, cs);
        const int ptgt = is_eps ? ceps : tab(TB_PROCEED_TARGET, cs);
        const bool p_m = alive && pk != PR_NONE && (is_eps || pred(TB_PROCEED_PRED, cs));
        const bool p_strict = p_m && pk == PR_PROCEED;
        const bool branch_m = (p_strict && take_m) || (ig_m && (c_m || p_strict));
        int pure_tgt = tab(TB_PURE_OF_PTGT, cs);
        if (l == 0 && is_eps) pure_tgt = tab(TB_PURE_NAME, ceps);
        const bool fwd_next = p_m && pure_tgt != tab(TB_PURE_NAME, cs) && !br && !ig;
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

    // ---- fold-register chain (deepest level first) -----------------------
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

    // ---- fold-divergence detector ----------------------------------------
    int collide = 0;
#if HAS_FOLDS
    {
      int* s_seq = s_next + NREC * R;
      int* s_act = s_seq + R;
      if (is_lane) { s_seq[r] = st_seq; s_act[r] = act ? 1 : 0; }
      __syncthreads();
      bool consuming = false;
#pragma unroll
      for (int l = 0; l < L; ++l) consuming = consuming || lv_cm[l];
      bool hit = false;
      if (consuming)
        for (int j = 0; j < R; ++j)
          if (j != r && s_act[j] && s_seq[j] == st_seq) { hit = true; break; }
      collide = __syncthreads_or(hit) ? 1 : 0;
    }
#endif

    // ---- upward pass: clones / begin re-adds -----------------------------
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

    // ---- slot flags in oracle DFS order ----------------------------------
    // slot l < L: level l's consume/ignore emission; then for each level
    // from the deepest up, its clone (or root copy) and its begin re-add.
    uint64_t occ = 0, mat = 0, nsq = 0;
    int c_put = 0, c_branch = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const bool match_consume = lv_take[l] ? tab(TB_IS_FINAL, lv_cs[l]) != 0
                                            : tab(TB_ISFIN_OF_CTGT, lv_cs[l]) != 0;
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
      if (u_clone[l] ? tab(TB_IS_FINAL, lv_cs[l]) != 0 : state_match) mat |= 1ull << sc;
      if (u_clone[l]) nsq |= 1ull << sc;
      if (u_fresh[l] || u_root[l]) occ |= 1ull << sr;
      if (state_match) mat |= 1ull << sr;
      if (u_fresh[l]) nsq |= 1ull << sr;
    }
    nsq &= occ;
    const uint64_t m_slots = occ & mat, k_slots = occ & ~mat;

    // ---- one block-wide scan: ranks and totals ---------------------------
    int cnt[6] = {c_put, (int)__popcll(nsq), (int)__popcll(m_slots),
                  (int)__popcll(k_slots), c_branch, expired ? 1 : 0};
    int ex[6], tot[6];
    block_scan<6>(cnt, ex, tot, s_scan);
    const int n_put = tot[0], n_new = tot[1], n_match = tot[2], n_keep = tot[3];

    // ---- buffer puts at their rank ---------------------------------------
    const int base = B_NODES + (phase + t) * P_CAP;
    int put_idx[L];
    {
      int pr = ex[0];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        put_idx[l] = -1;
        if (lv_cm[l]) {
          if (pr < P_CAP) {
            put_idx[l] = base + pr;
            wev[pr] = gidx;
            wnm[pr] = tab(TB_NAME_ID, lv_cs[l]);
            wpr[pr] = st_node;
          }
          ++pr;
        }
      }
    }
    {
      const int n_w = n_put < P_CAP ? n_put : P_CAP;
      for (int j = n_w + r; j < P_CAP; j += NTHREADS) { wev[j] = -1; wnm[j] = -1; wpr[j] = -1; }
      const int n_m = n_match < M_STEP ? n_match : M_STEP;
      for (int j = n_m + r; j < M_STEP; j += NTHREADS) { wmt[j] = -1; wmr[j] = -1; }
    }

    // ---- slots: fresh run ids, matches, surviving lanes ------------------
    {
      int ns_r = ex[1], m_r = ex[2], k_r = ex[3];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (!((occ >> s) & 1ull)) continue;
        // level / clone / re-add decoding of slot s
        const bool is_level = s < L;
        const int i = is_level ? 0 : (s - L) >> 1;
        const int l = is_level ? s : L - 1 - i;
        const bool is_clone = !is_level && ((s - L) & 1) == 0;
        int o_src, o_eps, o_vlen, o_seq, o_node, o_ts, addpos = -1;
        bool o_br, o_ig, clone_regs = false, zero_regs = false;
        if (is_level) {
          const bool c_m = lv_cm[l];
          o_src = c_m ? lv_cs[l] : st_src;
          o_eps = c_m ? (lv_take[l] ? lv_cs[l] : tab(TB_CONSUME_TARGET, lv_cs[l])) : st_eps;
          o_vlen = lv_vlen[l];
          o_seq = st_seq;
          o_node = c_m ? put_idx[l] : st_node;
          o_ts = c_m ? start_ts : st_ts;
          o_br = false;
          o_ig = !c_m;
        } else if (is_clone) {
          const bool m = u_clone[l];
          const bool has_ps = lv_ps[l] >= 0;
          const bool ps_begin = !has_ps || tab(TB_IS_BEGIN, lv_ps[l]) != 0;
          const int off = (ps_begin && lv_vlen[l] >= 2) ? 2 : 1;
          o_src = m ? (has_ps ? lv_ps[l] : lv_cs[l]) : st_src;
          o_eps = m ? lv_cs[l] : st_eps;
          if (m) addpos = lv_vlen[l] - off;
          o_vlen = m ? lv_vlen[l] : st_vlen;
          o_seq = st_seq;
          o_node = m ? (lv_igm[l] ? st_node : put_idx[l]) : st_node;
          o_ts = m ? start_ts : st_ts;
          o_br = m || st_br;
          o_ig = !m && st_ig;
          clone_regs = m;
        } else {
          const bool m = u_fresh[l];
          o_src = st_src;
          o_eps = st_eps;
          if (m && u_add[l]) addpos = lv_vlen[l] - 1;
          o_vlen = m ? lv_vlen[l] : st_vlen;
          o_seq = st_seq;
          o_node = m ? -1 : st_node;
          o_ts = m ? -1 : st_ts;
          o_br = !m && st_br;
          o_ig = !m && st_ig;
          zero_regs = m;
        }
        if ((nsq >> s) & 1ull) o_seq = ctr[C_RUNS] + 1 + ns_r++;
        const int o_root = st_root >= 0 ? st_root : o_node;
        if ((mat >> s) & 1ull) {
          const int m = m_r++;
          if (m < M_STEP) { wmt[m] = o_node; wmr[m] = o_root; }
        } else {
          const int q = k_r++;
          if (q < R) {
            int* rec = s_next + q;
            rec[F_SRC * R] = o_src; rec[F_EPS * R] = o_eps; rec[F_VLEN * R] = o_vlen;
            rec[F_SEQ * R] = o_seq; rec[F_NODE * R] = o_node; rec[F_ROOT * R] = o_root;
            rec[F_TS * R] = o_ts; rec[F_BR * R] = o_br ? 1 : 0; rec[F_IG * R] = o_ig ? 1 : 0;
#pragma unroll
            for (int d = 0; d < D; ++d) rec[(F_VER + d) * R] = ver[d] + (d == addpos ? 1 : 0);
#pragma unroll
            for (int sl = 0; sl < A; ++sl) {
              const float v = zero_regs ? 0.0f : (clone_regs ? cregs[l][sl] : fregs[sl]);
              const bool b = !zero_regs && (clone_regs ? cset[l][sl] : fset[sl]);
              rec[(F_VER + D + sl) * R] = __float_as_int(v);
              rec[(F_VER + D + A + sl) * R] = b ? 1 : 0;
            }
          }
        }
      }
    }
    __syncthreads();

    // ---- reload the compacted lane table ---------------------------------
    if (is_lane) {
      const int n_live = n_keep < R ? n_keep : R;
      if (r < n_live) {
        const int* rec = s_next + r;
        st_act = true;
        st_src = rec[F_SRC * R]; st_eps = rec[F_EPS * R]; st_vlen = rec[F_VLEN * R];
        st_seq = rec[F_SEQ * R]; st_node = rec[F_NODE * R]; st_root = rec[F_ROOT * R];
        st_ts = rec[F_TS * R]; st_br = rec[F_BR * R] != 0; st_ig = rec[F_IG * R] != 0;
#pragma unroll
        for (int d = 0; d < D; ++d) ver[d] = rec[(F_VER + d) * R];
#pragma unroll
        for (int sl = 0; sl < A; ++sl) {
          regs[sl] = __int_as_float(rec[(F_VER + D + sl) * R]);
          rset[sl] = rec[(F_VER + D + A + sl) * R] != 0;
        }
      } else {
        st_act = false; st_src = 0; st_eps = -1; st_vlen = 0; st_seq = 0;
        st_node = -1; st_root = -1; st_ts = -1; st_br = false; st_ig = false;
#pragma unroll
        for (int d = 0; d < D; ++d) ver[d] = 0;
#pragma unroll
        for (int sl = 0; sl < A; ++sl) { regs[sl] = 0.0f; rset[sl] = false; }
      }
    }

    // ---- counters (every thread keeps the block-uniform copy) ------------
    ctr[C_RUNS] += n_new;
    ctr[C_EVENTS] += 1;
    ctr[C_BRANCHES] += tot[4];
    ctr[C_EXPIRED] += tot[5];
    ctr[C_LANE_DROPS] += n_keep > R ? n_keep - R : 0;
    ctr[C_NODE_DROPS] += n_put > P_CAP ? n_put - P_CAP : 0;
    ctr[C_MATCH_DROPS] += n_match > M_STEP ? n_match - M_STEP : 0;
    ctr[C_COLLISIONS] += collide;
  }

  // ---- write the lane state once -------------------------------------------
  if (is_lane) {
    const size_t o = (size_t)r * K + k;
    a.o_active[o] = st_act ? 1 : 0; a.o_src[o] = st_src; a.o_eps[o] = st_eps;
    a.o_vlen[o] = st_vlen; a.o_seq[o] = st_seq; a.o_node[o] = st_node;
    a.o_ts[o] = st_ts; a.o_branching[o] = st_br ? 1 : 0;
    a.o_ignored[o] = st_ig ? 1 : 0; a.o_root[o] = st_root;
#pragma unroll
    for (int d = 0; d < D; ++d) a.o_ver[((size_t)r * D + d) * K + k] = ver[d];
#pragma unroll
    for (int s = 0; s < A; ++s) {
      a.o_regs[((size_t)r * A + s) * K + k] = regs[s];
      a.o_regs_set[((size_t)r * A + s) * K + k] = rset[s] ? 1 : 0;
    }
  }
  if (r == 0) {
#pragma unroll
    for (int i = 0; i < N_CTR; ++i) a.ctr_out[i][k] = ctr[i];
  }
}

// Shared memory of one block: the next-lane table, plus the seq/active
// arrays of the fold-divergence detector.
constexpr size_t SMEM_BYTES = sizeof(int) * ((size_t)NREC * R + (HAS_FOLDS ? 2 * R : 0));

// Host entry, bound with ctypes. `p` holds the pointers in Args order
// (xi, xf, 14 state-in leaves, 8 counters in, 13 state-out leaves,
// 8 counters out, 5 outputs). Returns the launch's cudaError_t.
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
  a.T = T;
  a.K = K;
#ifdef NFA_CPU_EMU
  emu::launch(K, NTHREADS, SMEM_BYTES, [&]() { nfa_step_kernel(a); });
  return 0;
#else
  cudaError_t err = cudaFuncSetAttribute(
      nfa_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  nfa_step_kernel<<<K, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
#endif
}

// The block's shared-memory bytes (dynamic part), for the wrapper's
// envelope check.
extern "C" long long nfa_step_smem_bytes() { return (long long)SMEM_BYTES; }

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
    bits[i] = stateful_pred_bits(ev, rg, rs);
    apply_folds(ev, true, stage, rg, rs);
    for (int a = 0; a < A; ++a) rset[(size_t)i * A + a] = rs[a];
  }
}
#endif
