// Native host kernels for the MSA and clustering hot paths: the port's own
// copy of the JAX package's sarlacc_tpu/native/msa_host.cpp, code unchanged.
//
// Device kernels do the DP volume; these C++ routines cover the sequential
// host-side graph work the reference also kept native (SeqAn's T-Coffee
// internals, src/cluster_umis.cpp):
//
//   * triplet consistency extension over per-group pairwise libraries
//     (the O(G^3 * L) step of T-Coffee library construction)
//   * the greedy UMI clusterer (cluster_umis.cpp:7-112 semantics, including
//     the ties-to-highest-index rule)
//   * merge-cost accumulation (library-sum column scores for a profile
//     merge, the np.add.at hot loop)
//
// Compiled on first use by sarlacc_tpu_torch/native/__init__.py into
// sarlacc_tpu_torch/_build/ and called through ctypes.  The port has no
// Python fallback: a failed build raises.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <utility>
#include <vector>

namespace {

// Banded doubled-cost masked-Levenshtein accept test (see verify_pairs_lev2
// below for the exactness argument).
inline bool lev2_banded_ok(
    const int8_t* a, int32_t la, const int8_t* b, int32_t lb,
    int32_t limit, int32_t thr, int32_t* prev, int32_t* cur)
{
    const int B = 2 * limit + 1;
    const int32_t BIG = 1 << 28;
    if (la - lb > limit || lb - la > limit) return false;
    for (int k = 0; k < B; ++k) {
        const int32_t j = k - limit;
        prev[k] = (j >= 0 && j <= lb) ? 2 * j : BIG;
    }
    for (int32_t i = 1; i <= la; ++i) {
        const int8_t ai = a[i - 1];
        int32_t rowmin = BIG;
        for (int k = 0; k < B; ++k) {
            const int32_t j = i - limit + k;
            if (j < 0 || j > lb) { cur[k] = BIG; continue; }
            int32_t best = (k + 1 < B) ? prev[k + 1] + 2 : BIG;
            if (k > 0 && cur[k - 1] + 2 < best) best = cur[k - 1] + 2;
            if (j > 0) {
                const int8_t bj = b[j - 1];
                const int32_t ms =
                    (ai == 4 || bj == 4) ? 1 : (ai == bj ? 0 : 2);
                if (prev[k] + ms < best) best = prev[k] + ms;
            }
            cur[k] = best;
            if (best < rowmin) rowmin = best;
        }
        if (rowmin > thr) return false;
        std::swap(prev, cur);
    }
    const int kfin = lb - la + limit;
    return kfin >= 0 && kfin < B && prev[kfin] <= thr;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Greedy clustering (src/cluster_umis.cpp semantics).
//
// storage: concatenated neighbour lists; offsets[n+1].
// out_members / out_offsets must hold n ints / n+1 ints.
// Returns the number of clusters, or -1 (zero-length group) / -2 (bad solo).
// ---------------------------------------------------------------------------
int64_t greedy_cluster(
    const int32_t* storage, const int64_t* offsets, int64_t n,
    int32_t* out_members, int64_t* out_offsets)
{
    std::vector<int64_t> remaining(n);
    std::vector<int32_t> candidates;
    candidates.reserve(n);

    int64_t ncl = 0;
    int64_t at = 0;
    out_offsets[0] = 0;

    for (int64_t a = 0; a < n; ++a) {
        int64_t size = offsets[a + 1] - offsets[a];
        remaining[a] = size;
        if (size > 1) {
            candidates.push_back((int32_t)a);
        } else if (size == 1) {
            if (storage[offsets[a]] != a) return -2;
            out_members[at++] = (int32_t)a;
            out_offsets[++ncl] = at;
        } else {
            return -1;
        }
    }

    // Lazy max-heap of (remaining << 32) | index: the packed comparison is
    // exactly "max remaining, ties to the highest index"
    // (cluster_umis.cpp:62-69).  Counts only decrease, so a popped entry
    // whose stored count mismatches remaining[] is stale and skipped; every
    // decrement pushes a refreshed entry.  Replaces the per-round
    // candidate-list compaction (O(rounds * candidates) — quadratic-ish at
    // 1M UMIs) with O((n + E) log) total.
    std::priority_queue<uint64_t> heap;
    for (int32_t c : candidates)
        heap.push(((uint64_t)remaining[c] << 32) | (uint32_t)c);

    while (!heap.empty()) {
        const uint64_t top = heap.top();
        heap.pop();
        const int32_t best = (int32_t)(top & 0xFFFFFFFFu);
        if (remaining[best] != (int64_t)(top >> 32) || remaining[best] == 0)
            continue;  // stale (decremented or already claimed)

        for (int64_t p = offsets[best]; p < offsets[best + 1]; ++p) {
            int32_t nb = storage[p];
            if (remaining[nb] == 0) continue;
            out_members[at++] = nb;
            remaining[nb] = 0;
            for (int64_t q = offsets[nb]; q < offsets[nb + 1]; ++q) {
                int32_t nxt = storage[q];
                if (remaining[nxt] > 0) {
                    --remaining[nxt];
                    if (remaining[nxt] > 0)
                        heap.push(((uint64_t)remaining[nxt] << 32)
                                  | (uint32_t)nxt);
                }
            }
        }
        out_offsets[++ncl] = at;
    }
    return ncl;
}

// ---------------------------------------------------------------------------
// Unique-string-level greedy clustering, weighted by duplicate counts —
// EXACTLY the read-level greedy (cluster_umis.cpp:7-112 semantics) on the
// collapsed graph.  Identical reads always share a neighbour list, so reads
// of one unique string are claimed as a block and every read of an
// unclaimed unique u has remaining = W(u) = sum of wt[v] over unclaimed
// v in N(u).  Ties to the highest READ index = the unique with the largest
// maxidx among its reads.  Member emission (DFS-list order, reads of each
// unique ascending) and cluster order (read-index-ordered singletons first,
// then selection order) match the read-level clusterer byte for byte; the
// caller expands unique members back to read indices.
//
// storage/offsets: unique-level symmetric CSR (diagonal included, DFS
// order); wt[u] = #reads of u; maxidx[u] = largest read index of u.
// Returns #clusters, or -1 (empty list) / -2 (bad solo).
// ---------------------------------------------------------------------------
int64_t greedy_cluster_weighted(
    const int32_t* storage, const int64_t* offsets, int64_t m,
    const int64_t* wt, const int64_t* maxidx,
    int32_t* out_members, int64_t* out_offsets)
{
    std::vector<int64_t> W(m);
    std::vector<std::pair<int64_t, int32_t>> singles;
    std::priority_queue<std::pair<uint64_t, int32_t>> heap;
    for (int64_t u = 0; u < m; ++u) {
        const int64_t size = offsets[u + 1] - offsets[u];
        if (size == 0) return -1;
        if (size == 1 && storage[offsets[u]] != u) return -2;
        int64_t w = 0;
        for (int64_t p = offsets[u]; p < offsets[u + 1]; ++p)
            w += wt[storage[p]];
        W[u] = w;
        if (w == 1) {
            singles.emplace_back(maxidx[u], (int32_t)u);
            W[u] = 0;  // read-level singleton: emitted below, never greedy
        } else {
            heap.push({((uint64_t)w << 32) | (uint32_t)maxidx[u], (int32_t)u});
        }
    }

    int64_t ncl = 0, at = 0;
    out_offsets[0] = 0;
    std::sort(singles.begin(), singles.end());
    for (auto& s : singles) {
        out_members[at++] = s.second;
        out_offsets[++ncl] = at;
    }

    while (!heap.empty()) {
        const auto top = heap.top();
        heap.pop();
        const int32_t best = top.second;
        if (W[best] != (int64_t)(top.first >> 32) || W[best] == 0)
            continue;  // stale
        for (int64_t p = offsets[best]; p < offsets[best + 1]; ++p) {
            const int32_t v = storage[p];
            if (W[v] == 0) continue;
            out_members[at++] = v;
            const int64_t dec = wt[v];
            W[v] = 0;
            for (int64_t q = offsets[v]; q < offsets[v + 1]; ++q) {
                const int32_t w2 = storage[q];
                if (W[w2] > 0) {
                    W[w2] -= dec;
                    heap.push({((uint64_t)W[w2] << 32) | (uint32_t)maxidx[w2],
                               w2});
                }
            }
        }
        out_offsets[++ncl] = at;
    }
    return ncl;
}

// ---------------------------------------------------------------------------
// Triplet consistency extension for one group.
//
// Library input (pairs x < y, any order):
//   px[np], py[np]: pair endpoints; off[np+1]: entry offsets;
//   pa[tot], pb[tot] (positions on x / y, 1-based), w[tot].
// Output: merged (base + extension) entries per pair, aggregated by
// position pair and emitted with pairs sorted by (x, y) and entries sorted
// by (pa, pb).  Caller passes output buffers of capacity cap; returns the
// total entry count or -(needed) if cap is too small.
// ---------------------------------------------------------------------------
int64_t triplet_extend(
    int32_t g,
    const int32_t* px, const int32_t* py, int64_t npairs,
    const int64_t* off, const int32_t* pa, const int32_t* pb, const float* w,
    int32_t* out_px, int32_t* out_py, int64_t* out_off,
    int32_t* out_pa, int32_t* out_pb, float* out_w, int64_t cap)
{
    // Pairwise alignment paths are monotone 1:1 maps, so the consistency
    // composition x~z~y is a direct two-step array lookup — no sorted joins
    // or hash maps.  Dense ordered-pair base maps:
    //   mpos[(x*g+z)*stride + a] = position on z aligned to position a on x
    //   mwt [(x*g+z)*stride + a] = that entry's weight
    int32_t maxpos = 1;
    for (int64_t t = 0; t < off[npairs]; ++t) {
        if (pa[t] > maxpos) maxpos = pa[t];
        if (pb[t] > maxpos) maxpos = pb[t];
    }
    const int64_t stride = (int64_t)maxpos + 1;

    std::vector<int32_t> mpos((size_t)g * g * stride, 0);
    std::vector<float> mwt((size_t)g * g * stride, 0.f);
    auto base_of = [&](int32_t a, int32_t b) -> int64_t {
        return ((int64_t)a * g + b) * stride;
    };
    for (int64_t p = 0; p < npairs; ++p) {
        const int64_t bx = base_of(px[p], py[p]);
        const int64_t by = base_of(py[p], px[p]);
        for (int64_t t = off[p]; t < off[p + 1]; ++t) {
            mpos[bx + pa[t]] = pb[t]; mwt[bx + pa[t]] = w[t];
            mpos[by + pb[t]] = pa[t]; mwt[by + pb[t]] = w[t];
        }
    }

    // Per pair (x < y), per position a on x: the candidates are the base
    // entry plus one composed b per middle z (<= g-1 total) — dedup-sum and
    // emit each tiny per-a bucket directly, in (a, b) order.  Sorting these
    // <=g-element buckets beats one big per-pair sort (fewer comparisons,
    // cache-resident, no large scratch).
    int64_t at = 0, pr = 0, needed = 0;
    bool overflow = false;
    std::vector<std::pair<const int32_t*, const float*>> xzm, zym;
    std::vector<std::pair<int32_t, float>> cand;
    xzm.reserve(g); zym.reserve(g); cand.reserve((size_t)g + 1);
    for (int32_t x = 0; x < g; ++x) {
        for (int32_t y = x + 1; y < g; ++y) {
            const int32_t* bp = &mpos[base_of(x, y)];
            const float* bw = &mwt[base_of(x, y)];
            xzm.clear(); zym.clear();
            for (int32_t z = 0; z < g; ++z) {
                if (z == x || z == y) continue;
                xzm.emplace_back(&mpos[base_of(x, z)], &mwt[base_of(x, z)]);
                zym.emplace_back(&mpos[base_of(z, y)], &mwt[base_of(z, y)]);
            }
            const size_t nz = xzm.size();
            const int64_t pair_start = at;
            bool any = false;
            for (int64_t a = 1; a < stride; ++a) {
                cand.clear();
                if (bp[a]) cand.emplace_back(bp[a], bw[a]);
                for (size_t zi = 0; zi < nz; ++zi) {
                    const int32_t k = xzm[zi].first[a];
                    if (!k) continue;
                    const int32_t b = zym[zi].first[k];
                    if (!b) continue;
                    cand.emplace_back(
                        b, std::min(xzm[zi].second[a], zym[zi].second[k]));
                }
                if (cand.empty()) continue;
                if (!any) {
                    any = true;
                    if (!overflow) {
                        out_px[pr] = x;
                        out_py[pr] = y;
                        out_off[pr] = pair_start;
                    }
                }
                std::sort(cand.begin(), cand.end(),
                          [](const std::pair<int32_t, float>& l,
                             const std::pair<int32_t, float>& r) {
                              return l.first < r.first;
                          });
                size_t i = 0;
                while (i < cand.size()) {
                    const int32_t b = cand[i].first;
                    double ww = 0.0;
                    while (i < cand.size() && cand[i].first == b) {
                        ww += cand[i].second;
                        ++i;
                    }
                    ++needed;
                    if (at >= cap) { overflow = true; continue; }
                    out_pa[at] = (int32_t)a;
                    out_pb[at] = b;
                    out_w[at] = (float)ww;
                    ++at;
                }
            }
            if (any && !overflow) ++pr;
        }
    }
    if (overflow) return -needed;
    out_off[pr] = at;
    // Return (pair count << 40) | entry count; entry counts stay far below
    // 2^40 here.
    return ((int64_t)pr << 40) | at;
}

// ---------------------------------------------------------------------------
// Merge-cost accumulation: cost[ci-1, k] += w for k = cj - ci - lo in range.
// ci/cj are 1-based profile columns already mapped by the caller.
// ---------------------------------------------------------------------------
void accumulate_cost(
    const int32_t* ci, const int32_t* cj, const float* w, int64_t n,
    int32_t lo, int32_t la, int32_t width, float* cost /* la*width */)
{
    for (int64_t t = 0; t < n; ++t) {
        int32_t c = ci[t];
        if (c < 1) continue;
        int64_t k = (int64_t)cj[t] - c - lo;
        if (k < 0 || k >= width) continue;
        cost[(int64_t)(c - 1) * width + k] += w[t];
    }
}

// ---------------------------------------------------------------------------
// Symmetric-delete candidate pairing for the thresholded Levenshtein search
// (the host half of the sorted_trie.cpp replacement; the device DP verifies
// every candidate so only completeness matters here).
//
// Entries are (variant hash, owner string id).  Sorts by (hash, owner),
// drops duplicate (hash, owner) rows, and for every run of equal hashes
// emits each unordered owner pair once as (lo << 32) | hi, then globally
// sorts + uniques the pair keys.  Returns the number of unique pairs, or
// -needed if cap was too small (caller retries with a bigger buffer).
// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// Banded doubled-cost masked-Levenshtein verification for candidate pairs
// (sorted_trie.cpp:13-21 cost model: match 0, N-vs-anything 1, mismatch and
// indel 2).  Any path cell (i, j) costs >= 2*|i-j|, so restricting the DP to
// the |i-j| <= limit band is EXACT for the "d2 <= thr = 2*limit" decision;
// pairs with |la-lb| > limit reject immediately.  codes: int8 [n, W]
// (A=0..N=4, pad anything); out[p] = 1 iff d2(pair p) <= thr.
// ---------------------------------------------------------------------------
void verify_pairs_lev2(
    const int8_t* codes, const int32_t* lens, int32_t W,
    const int64_t* ua, const int64_t* ub, int64_t npairs,
    int32_t limit, int32_t thr, uint8_t* out)
{
    const int B = 2 * limit + 1;
    std::vector<int32_t> prev(B), cur(B);
    for (int64_t p = 0; p < npairs; ++p) {
        out[p] = lev2_banded_ok(
            codes + ua[p] * (int64_t)W, lens[ua[p]],
            codes + ub[p] * (int64_t)W, lens[ub[p]],
            limit, thr, prev.data(), cur.data()) ? 1 : 0;
    }
}

// ---------------------------------------------------------------------------
// Fused symmetric-delete candidate generation + banded verification: walks
// shared-variant runs and verifies each raw pair inline, so the (heavily
// duplicated) raw pair stream is never materialized or globally sorted —
// only SURVIVING pair keys are appended, then sorted + deduped (a true pair
// appears once per shared variant, but survivors are few).  Two threads
// split the run list (runs never straddle the split).  Returns the number
// of unique surviving keys, or -needed if cap was too small.
// ---------------------------------------------------------------------------
int64_t candidate_verify_pairs(
    const uint64_t* h, const int32_t* owner, int64_t n,
    const int8_t* codes, const int32_t* lens, int32_t W,
    int32_t limit, int32_t thr, uint64_t* out, int64_t cap,
    int64_t raw_cap)
{
    std::vector<std::pair<uint64_t, int32_t>> e(n);
    for (int64_t i = 0; i < n; ++i) e[i] = {h[i], owner[i]};
    std::sort(e.begin(), e.end());
    e.erase(std::unique(e.begin(), e.end()), e.end());
    const int64_t ne = (int64_t)e.size();

    std::vector<int64_t> run_starts;
    for (int64_t s = 0; s < ne;) {
        int64_t t = s + 1;
        while (t < ne && e[t].first == e[s].first) ++t;
        if (t - s > 1) run_starts.push_back(s);
        s = t;
    }
    run_starts.push_back(ne);  // sentinel

    const int nruns = (int64_t)run_starts.size() - 1;
    const int nthreads = nruns > 1024 ? 2 : 1;
    std::vector<std::vector<uint64_t>> found(nthreads);
    std::vector<int64_t> raw(nthreads, 0);
    volatile bool abort_flag = false;  // low-complexity blowup guard

    auto work = [&](int tid) {
        const int B = 2 * limit + 1;
        std::vector<int32_t> prev(B), cur(B);
        auto& mine = found[tid];
        for (int64_t ri = tid; ri < nruns; ri += nthreads) {
            if (abort_flag) return;
            if (raw[tid] > raw_cap) { abort_flag = true; return; }
            const int64_t s = run_starts[ri];
            int64_t t = s + 1;
            while (t < ne && e[t].first == e[s].first) ++t;
            for (int64_t i = s; i < t; ++i) {
                const int32_t oa = e[i].second;
                const int8_t* a = codes + (int64_t)oa * W;
                const int32_t la = lens[oa];
                for (int64_t j = i + 1; j < t; ++j) {
                    const int32_t ob = e[j].second;
                    if (ob == oa) continue;
                    ++raw[tid];
                    if (lev2_banded_ok(a, la, codes + (int64_t)ob * W,
                                       lens[ob], limit, thr,
                                       prev.data(), cur.data())) {
                        const uint32_t lo = oa < ob ? oa : ob;
                        const uint32_t hi = oa < ob ? ob : oa;
                        mine.push_back(((uint64_t)lo << 32) | hi);
                    }
                }
            }
        }
    };
    if (nthreads == 1) {
        work(0);
    } else {
        std::thread th(work, 1);
        work(0);
        th.join();
    }
    if (abort_flag) return INT64_MIN;

    int64_t m = 0;
    for (auto& v : found) m += (int64_t)v.size();
    if (m > cap) return -m;
    int64_t at = 0;
    for (auto& v : found) {
        std::memcpy(out + at, v.data(), v.size() * sizeof(uint64_t));
        at += (int64_t)v.size();
    }
    std::sort(out, out + m);
    return (int64_t)(std::unique(out, out + m) - out);
}

// ---------------------------------------------------------------------------
// Fully-fused symmetric-delete neighbour search: variant hashing, bucketed
// sort, shared-variant run walk, memoized banded verification — all native,
// all threads.  Replaces the numpy hash stage + 2-thread
// candidate_verify_pairs for the large-n UMI path (sorted_trie.cpp:107-187
// pruned-walk semantics; results identical because every candidate passes
// the exact banded DP).
//
//   codes [n, W] int8 (A=0..N=4), lens [n], k = max deletions,
//   limit/thr = band half-width / doubled-cost threshold,
//   out/cap = surviving unique (lo<<32)|hi keys,
//   raw_cap = abort guard on total probed candidate pairs.
//
// Returns #unique surviving keys, -needed if cap too small, INT64_MIN on
// raw blowup (caller falls back to the dense scan).
// ---------------------------------------------------------------------------
}  // extern "C" — helpers below use templates (no C linkage)

namespace {

struct VarEntry {
    uint64_t h;
    int32_t owner;
    uint32_t dp;  // deletion positions: count (4 bits) | pos_i << (4 + 5*i)
};

inline bool entry_less(const VarEntry& a, const VarEntry& b) {
    if (a.h != b.h) return a.h < b.h;
    if (a.owner != b.owner) return a.owner < b.owner;
    return a.dp < b.dp;
}

// Whether a shared-variant occurrence is consistent with SOME <=k-edit
// alignment: unpack the two sorted deletion-position lists and look for a
// monotone matching of >= da + db - k pairs with per-pair |delta| <= k.
// For a true pair the canonical alignment's variant (delete exactly the
// non-match columns on both sides) has s matched substitution columns with
// |delta| <= #indels <= k and d + i unmatched, s + d + i <= k — so it always
// passes, making this prune EXACT.  Accidental collisions (random strings
// sharing a k-deletion variant with incompatible positions) drop here
// instead of reaching the DP.
inline bool delpos_compatible(uint32_t dpa, uint32_t dpb, int32_t k) {
    int ca = (int)(dpa & 15), cb = (int)(dpb & 15);
    if (ca + cb <= k) return true;  // enough edits to leave all unmatched
    int need = ca + cb - k;
    int A[8], B[8];
    for (int i = 0; i < ca; ++i) A[i] = (int)((dpa >> (4 + 5 * i)) & 31);
    for (int i = 0; i < cb; ++i) B[i] = (int)((dpb >> (4 + 5 * i)) & 31);
    // Greedy two-pointer maximum monotone matching under |a - b| <= k.
    int i = 0, j = 0, matched = 0;
    while (i < ca && j < cb) {
        const int d = A[i] - B[j];
        if (d > k) ++j;
        else if (d < -k) ++i;
        else { ++matched; ++i; ++j; }
    }
    return matched >= need;
}

// Murmur3 finalizer — spreads base-5-packed variant hashes (which occupy
// only their low bits, heavily banded by variant length) evenly over the
// bucket space so threads see balanced buckets.
inline uint64_t mix64(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ull;
    x ^= x >> 33; return x;
}

// Enumerate every <=k-deletion variant of one string; calls
// fn(hash, packed_delpos) with delpos packed as in VarEntry::dp.
template <typename F>
inline void for_each_variant(
    const int8_t* c, int32_t L, int32_t k, const uint64_t* pow5, F&& fn)
{
    // d = 0.
    {
        uint64_t h = 0;
        for (int32_t t = 0; t < L; ++t) h += (uint64_t)c[t] * pow5[t];
        fn(h + pow5[L], 0u);
    }
    const int32_t kk = k < L ? k : L;
    // d >= 1: standard next-combination over deletion positions.
    int32_t dp[8];
    for (int32_t d = 1; d <= kk; ++d) {
        for (int32_t i = 0; i < d; ++i) dp[i] = i;
        const uint64_t sentinel = pow5[L - d];
        const bool packable = d <= 4 && L <= 31;
        for (;;) {
            uint64_t h = sentinel;
            int32_t r = 0, di = 0;
            for (int32_t t = 0; t < L; ++t) {
                if (di < d && t == dp[di]) { ++di; continue; }
                h += (uint64_t)c[t] * pow5[r++];
            }
            uint32_t packed = 0;
            if (packable) {
                packed = (uint32_t)d;
                for (int32_t i = 0; i < d; ++i)
                    packed |= (uint32_t)dp[i] << (4 + 5 * i);
            }
            fn(h, packed);
            int32_t i = d - 1;
            while (i >= 0 && dp[i] == L - d + i) --i;
            if (i < 0) break;
            ++dp[i];
            for (int32_t j = i + 1; j < d; ++j) dp[j] = dp[j - 1] + 1;
        }
    }
}

inline int64_t variant_count(int32_t L, int32_t k) {
    int64_t total = 0, c = 1;
    for (int32_t d = 0; d <= (k < L ? k : L); ++d) {
        total += c;
        c = c * (L - d) / (d + 1);
    }
    return total;
}

// Parallel LSD radix sort for uint64 keys occupying the low ``nbits`` bits.
// 16-bit digits; per-thread-chunk histograms and cursors keep each pass
// stable, so the whole sort is stable and exact.
void radix_sort_u64(std::vector<uint64_t>& v, int nbits, int T) {
    const int64_t n = (int64_t)v.size();
    if (n < (1 << 14)) {
        std::sort(v.begin(), v.end());
        return;
    }
    constexpr int DB = 16, ND = 1 << DB;
    std::vector<uint64_t> tmp(v.size());
    uint64_t* src = v.data();
    uint64_t* dst = tmp.data();
    const int passes = (nbits + DB - 1) / DB;
    std::vector<std::vector<int64_t>> hist(T, std::vector<int64_t>(ND));
    std::vector<std::vector<int64_t>> cur(T, std::vector<int64_t>(ND));
    for (int p = 0; p < passes; ++p) {
        const int sh = p * DB;
        for (auto& hh : hist) std::fill(hh.begin(), hh.end(), 0);
        {
            std::vector<std::thread> th;
            auto hw = [&](int t) {
                const int64_t s = n * t / T, e = n * (t + 1) / T;
                auto& hh = hist[t];
                for (int64_t i = s; i < e; ++i)
                    ++hh[(src[i] >> sh) & (ND - 1)];
            };
            for (int t = 1; t < T; ++t) th.emplace_back(hw, t);
            hw(0);
            for (auto& x : th) x.join();
        }
        int64_t at = 0;
        for (int d = 0; d < ND; ++d)
            for (int t = 0; t < T; ++t) { cur[t][d] = at; at += hist[t][d]; }
        {
            std::vector<std::thread> th;
            auto sw = [&](int t) {
                const int64_t s = n * t / T, e = n * (t + 1) / T;
                auto& cc = cur[t];
                for (int64_t i = s; i < e; ++i)
                    dst[cc[(src[i] >> sh) & (ND - 1)]++] = src[i];
            };
            for (int t = 1; t < T; ++t) th.emplace_back(sw, t);
            sw(0);
            for (auto& x : th) x.join();
        }
        std::swap(src, dst);
    }
    if (src != v.data())
        std::memcpy(v.data(), src, (size_t)n * sizeof(uint64_t));
}

}  // namespace

extern "C" {

int64_t sym_delete_verify(
    const int8_t* codes, const int32_t* lens, int32_t W, int64_t n,
    int32_t k, int32_t limit, int32_t thr,
    uint64_t* out, int64_t cap, int64_t raw_cap, int32_t nthreads)
{
    const bool timing = getenv("SARLACC_NATIVE_TIMING") != nullptr;
    auto clk = [] {
        return std::chrono::duration<double>(
                   std::chrono::steady_clock::now().time_since_epoch())
            .count();
    };
    double t0 = timing ? clk() : 0.0;
    auto mark = [&](const char* what) {
        if (timing) {
            double t1 = clk();
            fprintf(stderr, "[sym_delete_verify] %s: %.3fs\n", what, t1 - t0);
            t0 = t1;
        }
    };
    if (k > 8) return INT64_MIN;  // dp[8] bound; callers cap far below this
    uint64_t pow5[32];
    pow5[0] = 1;
    for (int i = 1; i < 32; ++i) pow5[i] = pow5[i - 1] * 5;

    unsigned hw = std::thread::hardware_concurrency();
    int T = nthreads > 0 ? nthreads : (hw ? (int)hw : 2);
    if (T > 16) T = 16;
    if ((int64_t)T > n) T = n > 0 ? (int)n : 1;

    // Per-string entry offsets (analytic counts — no dedup at this stage).
    std::vector<int64_t> soff(n + 1);
    soff[0] = 0;
    for (int64_t i = 0; i < n; ++i)
        soff[i + 1] = soff[i] + variant_count(lens[i], k);
    const int64_t E = soff[n];
    if (E == 0) return 0;

    // Bucket by the mixed hash: base-5 packing bands hashes by variant
    // length (83% of entries can land in a handful of raw-value buckets);
    // the murmur finalizer spreads them uniformly.  Equal hashes still map
    // to equal buckets, so shared-variant runs never straddle buckets.
    // Bucket count scales with the entry count (targeting <= 16k entries
    // per bucket, 11..16 bits): at 1M 12-bp UMIs the fixed 2048 buckets
    // held ~134k entries each and the per-bucket std::sort was 43% of the
    // engine (r5 phase split); smaller buckets sort in cache with a lower
    // log factor.
    int nb_bits = 11;
    {
        int64_t ecount = 0;
        for (int64_t i = 0; i < n; ++i) ecount += variant_count(lens[i], k);
        while (nb_bits < 16 && (ecount >> nb_bits) > (int64_t)16384) ++nb_bits;
    }
    const int NB_BITS = nb_bits;
    const int NB = 1 << NB_BITS;
    auto bucket_of = [NB_BITS](uint64_t h) {
        return (int)(mix64(h) >> (64 - NB_BITS));
    };

    // Pass 1: per-thread bucket histograms (hashes recomputed in pass 2 —
    // cheaper than materializing a stripe-ordered temp copy).
    std::vector<std::vector<int64_t>> hist(T, std::vector<int64_t>(NB, 0));
    auto stripe = [&](int t) -> std::pair<int64_t, int64_t> {
        return {n * t / T, n * (t + 1) / T};
    };
    {
        std::vector<std::thread> th;
        for (int t = 0; t < T; ++t) {
            th.emplace_back([&, t] {
                auto [s, e] = stripe(t);
                auto& hh = hist[t];
                for (int64_t i = s; i < e; ++i) {
                    for_each_variant(
                        codes + i * (int64_t)W, lens[i], k, pow5,
                        [&](uint64_t h, uint32_t) { ++hh[bucket_of(h)]; });
                }
            });
        }
        for (auto& x : th) x.join();
    }
    mark("histogram");

    // Bucket offsets + per-thread scatter cursors.
    std::vector<int64_t> boff(NB + 1, 0);
    for (int b = 0; b < NB; ++b) {
        boff[b + 1] = boff[b];
        for (int t = 0; t < T; ++t) boff[b + 1] += hist[t][b];
    }
    std::vector<std::vector<int64_t>> cur(T, std::vector<int64_t>(NB));
    for (int b = 0; b < NB; ++b) {
        int64_t at = boff[b];
        for (int t = 0; t < T; ++t) { cur[t][b] = at; at += hist[t][b]; }
    }

    // Pass 2: scatter into bucket order.
    std::vector<VarEntry> e(E);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < T; ++t) {
            th.emplace_back([&, t] {
                auto [s, xe] = stripe(t);
                auto& cc = cur[t];
                for (int64_t i = s; i < xe; ++i) {
                    const int32_t ow = (int32_t)i;
                    for_each_variant(
                        codes + i * (int64_t)W, lens[i], k, pow5,
                        [&](uint64_t h, uint32_t dp) {
                            e[cc[bucket_of(h)]++] = {h, ow, dp};
                        });
                }
            });
        }
        for (auto& x : th) x.join();
    }
    mark("scatter");

    // Phase 3 — per-bucket: sort, dedup (h, owner), walk shared-hash runs
    // and EMIT raw pair keys (no DP here: at UMI lengths the banded DP is
    // as cheap as a hash probe, so memoization loses; dedup-then-verify
    // wins by running each unique pair's DP exactly once).  Buckets are
    // hash-disjoint so runs never straddle them; threads pull buckets from
    // an atomic cursor.
    std::vector<std::vector<uint64_t>> rawk(T);
    std::vector<int64_t> raw(T, 0);
    std::atomic<int> next_bucket{0};
    std::atomic<bool> abort_flag{false};

    auto walk = [&](int tid) {
        auto& mine = rawk[tid];
        mine.reserve((size_t)(E / T / 2));
        for (;;) {
            const int b = next_bucket.fetch_add(1);
            if (b >= NB || abort_flag.load(std::memory_order_relaxed)) break;
            VarEntry* bs = e.data() + boff[b];
            const int64_t bn = boff[b + 1] - boff[b];
            if (bn < 2) continue;
            std::sort(bs, bs + bn, entry_less);
            int64_t m = 0;  // in-place dedup of (h, owner, delpos)
            for (int64_t i = 0; i < bn; ++i) {
                if (m && bs[m - 1].h == bs[i].h
                      && bs[m - 1].owner == bs[i].owner
                      && bs[m - 1].dp == bs[i].dp)
                    continue;
                bs[m++] = bs[i];
            }
            for (int64_t s = 0; s < m;) {
                int64_t t2 = s + 1;
                while (t2 < m && bs[t2].h == bs[s].h) ++t2;
                if ((raw[tid] += (t2 - s) * (t2 - s - 1) / 2) > raw_cap) {
                    abort_flag.store(true, std::memory_order_relaxed);
                    return;
                }
                for (int64_t i = s; i < t2; ++i) {
                    // Arithmetic packing lo * n + hi occupies only
                    // 2*bit_width(n) bits — one fewer radix pass than
                    // (lo << 32) | hi.  Owners ascend within a run
                    // (entry_less), so (i, j) is already (lo, hi).
                    const uint64_t lo = (uint64_t)(uint32_t)bs[i].owner * (uint64_t)n;
                    const uint32_t dpi = bs[i].dp;
                    for (int64_t j = i + 1; j < t2; ++j) {
                        if (bs[j].owner == bs[i].owner) continue;
                        if (!delpos_compatible(dpi, bs[j].dp, limit)) continue;
                        mine.push_back(lo + (uint32_t)bs[j].owner);
                    }
                }
                s = t2;
            }
        }
    };
    {
        std::vector<std::thread> th;
        for (int t = 1; t < T; ++t) th.emplace_back(walk, t);
        walk(0);
        for (auto& x : th) x.join();
    }
    mark("sort+walk");
    if (abort_flag.load()) return INT64_MIN;

    // Phase 4 — gather, radix-sort, unique.
    int64_t nraw = 0;
    for (auto& v : rawk) nraw += (int64_t)v.size();
    std::vector<uint64_t> allk((size_t)nraw);
    {
        int64_t at = 0;
        for (auto& v : rawk) {
            std::memcpy(allk.data() + at, v.data(), v.size() * sizeof(uint64_t));
            at += (int64_t)v.size();
            std::vector<uint64_t>().swap(v);
        }
    }
    int nbits = 1;
    while (((__uint128_t)1 << nbits) < (__uint128_t)n * (uint64_t)n) ++nbits;
    radix_sort_u64(allk, nbits, T);
    const int64_t m = (int64_t)(std::unique(allk.begin(), allk.end()) - allk.begin());
    if (timing)
        fprintf(stderr, "[sym_delete_verify] raw=%lld unique=%lld\n",
                (long long)nraw, (long long)m);
    mark("pair radix+unique");

    // Base-count prefilter tables: for N-free strings every unit of doubled
    // edit cost moves the (A,C,G,T) count vector by at most 1 in L1, so
    // L1 > thr rejects without touching the DP (~5 ns vs ~200 ns).  Strings
    // containing N (N-vs-X costs 1) skip the shortcut.
    std::vector<uint32_t> pc((size_t)n);
    std::vector<uint8_t> hasn((size_t)n, 0);
    for (int64_t i = 0; i < n; ++i) {
        uint32_t c4 = 0;
        uint8_t hn = 0;
        const int8_t* s = codes + i * (int64_t)W;
        for (int32_t t = 0; t < lens[i]; ++t) {
            const int8_t b = s[t];
            if (b >= 0 && b < 4) c4 += 1u << (8 * b);
            else hn = 1;
        }
        pc[i] = c4;
        hasn[i] = hn;
    }

    // Phase 5 — verify unique candidates in parallel stripes; compacting
    // survivors per stripe keeps the output sorted.
    std::vector<uint8_t> okv((size_t)m);
    {
        std::vector<std::thread> th;
        auto vw = [&](int tid) {
            const int B = 2 * limit + 1;
            std::vector<int32_t> prev(B), cur_row(B);
            const int64_t s = m * tid / T, e2 = m * (tid + 1) / T;
            for (int64_t i = s; i < e2; ++i) {
                const int32_t oa = (int32_t)(allk[i] / (uint64_t)n);
                const int32_t ob = (int32_t)(allk[i] % (uint64_t)n);
                if (!hasn[oa] && !hasn[ob]) {
                    const uint32_t a4 = pc[oa], b4 = pc[ob];
                    int sad = 0;
                    for (int sh2 = 0; sh2 < 32; sh2 += 8) {
                        const int d = (int)((a4 >> sh2) & 255)
                                      - (int)((b4 >> sh2) & 255);
                        sad += d < 0 ? -d : d;
                    }
                    if (sad > thr) { okv[i] = 0; continue; }
                }
                okv[i] = lev2_banded_ok(
                    codes + (int64_t)oa * W, lens[oa],
                    codes + (int64_t)ob * W, lens[ob],
                    limit, thr, prev.data(), cur_row.data()) ? 1 : 0;
            }
        };
        for (int t = 1; t < T; ++t) th.emplace_back(vw, t);
        vw(0);
        for (auto& x : th) x.join();
    }
    int64_t nsurv = 0;
    for (int64_t i = 0; i < m; ++i) nsurv += okv[i];
    if (nsurv > cap) return -nsurv;
    int64_t at = 0;
    for (int64_t i = 0; i < m; ++i)
        if (okv[i]) {
            const uint64_t lo = allk[i] / (uint64_t)n;
            const uint64_t hi = allk[i] % (uint64_t)n;
            out[at++] = (lo << 32) | hi;  // API format
        }
    mark("verify");
    return nsurv;
}

int64_t candidate_pairs(
    const uint64_t* h, const int32_t* owner, int64_t n,
    uint64_t* out, int64_t cap)
{
    std::vector<std::pair<uint64_t, int32_t>> e(n);
    for (int64_t i = 0; i < n; ++i) e[i] = {h[i], owner[i]};
    std::sort(e.begin(), e.end());
    e.erase(std::unique(e.begin(), e.end()), e.end());

    int64_t m = 0;
    const int64_t ne = (int64_t)e.size();
    for (int64_t s = 0; s < ne;) {
        int64_t t = s + 1;
        while (t < ne && e[t].first == e[s].first) ++t;
        for (int64_t i = s; i < t; ++i) {
            const uint64_t lo = (uint64_t)(uint32_t)e[i].second << 32;
            for (int64_t j = i + 1; j < t; ++j) {
                if (m < cap) out[m] = lo | (uint32_t)e[j].second;
                ++m;
            }
        }
        s = t;
    }
    if (m > cap) return -m;
    std::sort(out, out + m);
    return (int64_t)(std::unique(out, out + m) - out);
}

}  // extern "C"
