/* Native host-side encoder for findkmer-tpu.
 *
 * Host-side counterpart of the reference findKmer's C byte scanner
 * (SURVEY.md §2.1 R3): instead of a branchy fgetc loop feeding a count
 * structure, this translation unit only does the host-side part of the
 * job — byte -> 2-bit base code translation and validity masking at
 * memory bandwidth — and leaves window extraction + counting to the device
 * (ops/window.py, ops/histogram.py).
 *
 * Exposed via ctypes (findkmer_tpu/io/native.py); build with
 * `make -C src/native` -> libfindkmer_encode.so.
 *
 * C17, no dependencies beyond libc.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

#define FK_INVALID 4u

/* Multi-threading note: every parallel loop below uses STATIC
 * partitioning with disjoint output ranges, so results are bit-identical
 * for any thread count (OMP_NUM_THREADS; default = cores).  Small inputs
 * take the serial path — thread fork/join costs ~10 us. */
#define FK_MT_MIN (1u << 20)

static uint8_t LUT[256];

__attribute__((constructor)) static void fk_init_lut(void) {
  memset(LUT, FK_INVALID, sizeof(LUT));
  LUT['A'] = 0; LUT['a'] = 0;
  LUT['C'] = 1; LUT['c'] = 1;
  LUT['G'] = 2; LUT['g'] = 2;
  LUT['T'] = 3; LUT['t'] = 3;
}

/* bytes -> codes {0..3, FK_INVALID}.  Plain LUT translate; gcc -O3
 * unrolls this to a few loads/stores per byte and the loop is purely
 * memory-bound (several GB/s). */
void fk_encode(const uint8_t *restrict in, uint8_t *restrict out, size_t n) {
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    out[i + 0] = LUT[in[i + 0]];
    out[i + 1] = LUT[in[i + 1]];
    out[i + 2] = LUT[in[i + 2]];
    out[i + 3] = LUT[in[i + 3]];
    out[i + 4] = LUT[in[i + 4]];
    out[i + 5] = LUT[in[i + 5]];
    out[i + 6] = LUT[in[i + 6]];
    out[i + 7] = LUT[in[i + 7]];
  }
  for (; i < n; ++i) out[i] = LUT[in[i]];
}

/* Fused: bytes -> 2-bit packed codes (4 bases/byte, little-endian within
 * the byte; invalid bases pack as 0) + validity bitmask (1 bit/base,
 * little-endian).  n need not be a multiple of 4/8; tails are
 * zero-padded.  packed must hold ceil(n/4) bytes, validmask ceil(n/8). */
/* Bit order is MSB-first (big-endian bitstream): base j of packed byte i
 * sits at bits (6-2j), valid bit for base j of mask byte at bit (7-j).
 * This makes the byte sequence one big-endian 2-bit stream, so the
 * device extracts whole window codes with two shifted word combines
 * instead of a k-slice OR chain (ops/window.py window_codes_packed). */
static void fk_encode_packed_range(const uint8_t *restrict in,
                                   uint8_t *restrict packed,
                                   uint8_t *restrict validmask, size_t i0,
                                   size_t i1) {
  for (size_t i = i0; i < i1; ++i) {
    uint8_t c0 = LUT[in[4 * i + 0]];
    uint8_t c1 = LUT[in[4 * i + 1]];
    uint8_t c2 = LUT[in[4 * i + 2]];
    uint8_t c3 = LUT[in[4 * i + 3]];
    uint8_t v0 = c0 < 4, v1 = c1 < 4, v2 = c2 < 4, v3 = c3 < 4;
    packed[i] = (uint8_t)(((c0 & 3) << 6) | ((c1 & 3) << 4) |
                          ((c2 & 3) << 2) | (c3 & 3));
    uint8_t nib = (uint8_t)((v0 << 3) | (v1 << 2) | (v2 << 1) | v3);
    if (i & 1)
      validmask[i / 2] |= nib;
    else
      validmask[i / 2] = (uint8_t)(nib << 4);
  }
}

void fk_encode_packed(const uint8_t *restrict in, uint8_t *restrict packed,
                      uint8_t *restrict validmask, size_t n) {
  size_t nb4 = n / 4;
#ifdef _OPENMP
  if (n >= FK_MT_MIN) {
    /* segment boundaries at even packed-byte indices (8-base aligned)
     * so no two threads touch the same validmask byte */
    size_t nb8 = nb4 / 2;
#pragma omp parallel
    {
      int t = omp_get_thread_num(), T = omp_get_num_threads();
      size_t lo = 2 * (nb8 * t / T), hi = 2 * (nb8 * (t + 1) / T);
      fk_encode_packed_range(in, packed, validmask, lo, hi);
    }
    fk_encode_packed_range(in, packed, validmask, 2 * nb8, nb4);
  } else
#endif
  {
    fk_encode_packed_range(in, packed, validmask, 0, nb4);
  }
  if (n % 4) {
    uint8_t pb = 0, vb = 0;
    for (size_t j = 0; j < n % 4; ++j) {
      uint8_t c = LUT[in[4 * nb4 + j]];
      pb |= (uint8_t)((c & 3) << (6 - 2 * j));
      vb |= (uint8_t)((c < 4) << (3 - j));
    }
    packed[nb4] = pb;
    if (nb4 & 1)
      validmask[nb4 / 2] |= vb;
    else
      validmask[nb4 / 2] = (uint8_t)(vb << 4);
  }
}

/* Fused whitespace-strip + encode: raw FASTA sequence-region bytes ->
 * compacted codes.  ASCII whitespace (space, \t, \r, \n, \v, \f) is
 * dropped; ACGT/acgt -> 0..3; everything else -> FK_INVALID.  Returns the
 * compacted length (<= n).  Single pass, branch-light — replaces the
 * separate numpy mask+compact pass that dominated host batching. */
static uint8_t LUT_WS[256];

__attribute__((constructor)) static void fk_init_ws_lut(void) {
  memset(LUT_WS, FK_INVALID, sizeof(LUT_WS));
  LUT_WS['A'] = 0; LUT_WS['a'] = 0;
  LUT_WS['C'] = 1; LUT_WS['c'] = 1;
  LUT_WS['G'] = 2; LUT_WS['g'] = 2;
  LUT_WS['T'] = 3; LUT_WS['t'] = 3;
  LUT_WS[' '] = 255; LUT_WS['\t'] = 255; LUT_WS['\r'] = 255;
  LUT_WS['\n'] = 255; LUT_WS['\v'] = 255; LUT_WS['\f'] = 255;
}

static size_t fk_compact_range(const uint8_t *restrict in,
                               uint8_t *restrict out, size_t i0, size_t i1) {
  /* Branchless write-then-advance: whitespace writes a transient byte
   * at out[m] that the next survivor overwrites.  At the very end one
   * garbage byte may remain at out[count]; single-threaded that slot is
   * either re-written by the caller's next region or past the returned
   * length, multi-threaded the caller repairs it (see below). */
  size_t m = 0;
  for (size_t i = i0; i < i1; ++i) {
    uint8_t c = LUT_WS[in[i]];
    out[m] = c;
    m += (c != 255);
  }
  return m;
}

/* Count ACGT codes among the first m compacted output codes — runs on
 * the already-compacted buffer (sequential, OMP) so stats need no numpy
 * pass. */
size_t fk_count_acgt(const uint8_t *restrict codes, size_t n) {
  size_t c = 0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : c) schedule(static) \
    if (n >= FK_MT_MIN)
#endif
  for (size_t i = 0; i < n; ++i) c += (codes[i] < 4);
  return c;
}

size_t fk_encode_compact(const uint8_t *restrict in, uint8_t *restrict out,
                         size_t n) {
#ifdef _OPENMP
  if (n >= FK_MT_MIN) {
    /* Three-phase: count survivors per segment (parallel), prefix the
     * output offsets (serial, T entries), compact each segment to its
     * offset (parallel).  Thread t's branchless pass may leave one
     * transient byte at out[offs[t+1]] — the next thread's FIRST
     * output byte — so after a barrier each thread rewrites its first
     * survivor.  Output is byte-identical to the serial pass. */
    int T;
    size_t counts[256], offs[257];
    uint8_t firsts[256];
#pragma omp parallel
    {
#pragma omp single
      T = omp_get_num_threads();
      int t = omp_get_thread_num();
      size_t lo = n * (size_t)t / (size_t)T;
      size_t hi = n * (size_t)(t + 1) / (size_t)T;
      size_t i = lo;
      while (i < hi && LUT_WS[in[i]] == 255) ++i;
      firsts[t] = (i < hi) ? LUT_WS[in[i]] : 255;
      size_t c = 0;
      for (; i < hi; ++i) c += (LUT_WS[in[i]] != 255);
      counts[t] = c;
#pragma omp barrier
#pragma omp single
      {
        offs[0] = 0;
        for (int j = 0; j < T; ++j) offs[j + 1] = offs[j] + counts[j];
      }
      fk_compact_range(in, out + offs[t], lo, hi);
#pragma omp barrier
      if (counts[t]) out[offs[t]] = firsts[t];
    }
    return offs[T];
  }
#endif
  return fk_compact_range(in, out, 0, n);
}

/* Pack batch rows straight out of the pipeline's flat work buffer into
 * the 2-bit + validity-bitmask device format (Config.packed_h2d): row i
 * reads codes work[i*L .. i*L+R) (rows overlap by the k-1 halo) and is
 * padded with invalid to R8 (R rounded up to a multiple of 8).  Output
 * pitches: packed R8/4 bytes/row, validbits R8/8 bytes/row.  One pass,
 * no intermediate (B, R) byte matrix. */
void fk_pack_rows(const uint8_t *restrict work, size_t B, size_t L,
                  size_t R, size_t R8, uint8_t *restrict packed,
                  uint8_t *restrict validbits) {
  size_t pp = R8 / 4, vp = R8 / 8;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (B * R >= FK_MT_MIN)
#endif
  for (size_t i = 0; i < B; ++i) {
    const uint8_t *row = work + i * L;
    uint8_t *prow = packed + i * pp;
    uint8_t *vrow = validbits + i * vp;
    for (size_t b = 0; b < vp; ++b) {
      uint8_t pb0 = 0, pb1 = 0, vb = 0;
      size_t base = b * 8;
      for (size_t j = 0; j < 8; ++j) {
        size_t idx = base + j;
        uint8_t c = idx < R ? row[idx] : FK_INVALID;
        uint8_t valid = c < 4;
        uint8_t code = (uint8_t)(c & 3u & (uint8_t)-valid);
        if (j < 4)
          pb0 |= (uint8_t)(code << (6 - 2 * j));
        else
          pb1 |= (uint8_t)(code << (6 - 2 * (j - 4)));
        vb |= (uint8_t)(valid << (7 - j));
      }
      prow[2 * b] = pb0;
      prow[2 * b + 1] = pb1;
      vrow[b] = vb;
    }
  }
}

/* Format spectrum lines "KMER<sep>COUNT\n" for n entries in one pass —
 * the C replacement for the per-line Python/numpy string assembly in
 * output.py (the reference's output traversal, SURVEY.md §3.1 E4, at
 * memory bandwidth).  codes are 2k-bit k-mer codes (A=0..T=3, most
 * significant base first); out must hold n*(k+22) bytes.  Returns bytes
 * written. */
static inline int fk_digits(unsigned long long v) {
  int d = 1;
  while (v >= 10) {
    v /= 10;
    ++d;
  }
  return d;
}

static uint8_t *fk_format_range(const uint64_t *restrict codes,
                                const long long *restrict counts, size_t i0,
                                size_t i1, uint32_t k, uint8_t sep,
                                uint8_t *restrict p) {
  static const char BASES[4] = {'A', 'C', 'G', 'T'};
  for (size_t i = i0; i < i1; ++i) {
    uint64_t c = codes[i];
    for (uint32_t j = 0; j < k; ++j)
      p[j] = (uint8_t)BASES[(c >> (2 * (k - 1 - j))) & 3u];
    p += k;
    *p++ = sep;
    unsigned long long v = (unsigned long long)counts[i];
    char tmp[24];
    int t = 0;
    do {
      tmp[t++] = (char)('0' + (v % 10));
      v /= 10;
    } while (v);
    while (t) *p++ = (uint8_t)tmp[--t];
    *p++ = '\n';
  }
  return p;
}

size_t fk_format_spectrum(const uint64_t *restrict codes,
                          const long long *restrict counts, size_t n,
                          uint32_t k, uint8_t sep, uint8_t *restrict out) {
#ifdef _OPENMP
  if (n >= (1u << 16)) {
    /* two-phase: per-segment output sizes from digit counts (parallel),
     * serial prefix over T offsets, parallel fill at exact offsets —
     * byte-identical to the serial pass for any thread count. */
    int T;
    size_t sizes[256], offs[257];
#pragma omp parallel
    {
#pragma omp single
      T = omp_get_num_threads();
      int t = omp_get_thread_num();
      size_t lo = n * (size_t)t / (size_t)T;
      size_t hi = n * (size_t)(t + 1) / (size_t)T;
      size_t s = 0;
      for (size_t i = lo; i < hi; ++i)
        s += k + 2 +
             (size_t)fk_digits((unsigned long long)counts[i]);
      sizes[t] = s;
#pragma omp barrier
#pragma omp single
      {
        offs[0] = 0;
        for (int j = 0; j < T; ++j) offs[j + 1] = offs[j] + sizes[j];
      }
      fk_format_range(codes, counts, lo, hi, k, sep, out + offs[t]);
    }
    return offs[T];
  }
#endif
  return (size_t)(fk_format_range(codes, counts, 0, n, k, sep, out) - out);
}

/* Count valid (ACGT) bytes — used for stats without a second pass in
 * Python. */
size_t fk_count_valid(const uint8_t *restrict in, size_t n) {
  size_t cnt = 0;
  for (size_t i = 0; i < n; ++i) cnt += LUT[in[i]] < 4;
  return cnt;
}

/* ------------------------------------------------------------------ */
/* G-way merge of sorted (code, count) runs, summing counts of equal   */
/* codes.  The device-side sparse store compacts into independent      */
/* sorted rows (ops/compaction.row_geometry), so global order is       */
/* restored here on the host, fused into the D2H/output tail.  Runs    */
/* are passed as per-run pointers — no concatenation copy (a lazily-   */
/* backed VM faults fresh pages at ~0.02 GB/s).  Output                */
/* counts are int64 (sums of per-run totals).  Returns the merged      */
/* distinct count.  Binary min-heap on (code, run); G <= 64.           */

typedef struct {
  uint64_t code;
  uint32_t run;
} fk_heap_ent;

static inline void fk_heap_sift_down(fk_heap_ent *h, size_t n, size_t i) {
  for (;;) {
    size_t l = 2 * i + 1, r = l + 1, m = i;
    if (l < n && h[l].code < h[m].code) m = l;
    if (r < n && h[r].code < h[m].code) m = r;
    if (m == i) return;
    fk_heap_ent tmp = h[i];
    h[i] = h[m];
    h[m] = tmp;
    i = m;
  }
}

#define FK_MERGE_BODY                                                     \
  if (G > 64) return (size_t)-1;                                          \
  fk_heap_ent heap[64];                                                   \
  size_t pos[64];                                                         \
  size_t hn = 0;                                                          \
  for (int g = 0; g < G; ++g) {                                           \
    pos[g] = 0;                                                           \
    if (lens[g]) {                                                        \
      heap[hn].code = codes[g][0];                                        \
      heap[hn].run = (uint32_t)g;                                         \
      ++hn;                                                               \
    }                                                                     \
  }                                                                       \
  for (size_t i = hn; i-- > 0;) fk_heap_sift_down(heap, hn, i);           \
  size_t out_n = 0;                                                       \
  uint64_t last = 0;                                                      \
  int have_last = 0;                                                      \
  while (hn) {                                                            \
    uint64_t c = heap[0].code;                                            \
    uint32_t g = heap[0].run;                                             \
    long long v = (long long)counts[g][pos[g]];                           \
    if (have_last && c == last) {                                         \
      out_counts[out_n - 1] += v;                                         \
    } else {                                                              \
      out_codes[out_n] = c;                                               \
      out_counts[out_n] = v;                                              \
      ++out_n;                                                            \
      last = c;                                                           \
      have_last = 1;                                                      \
    }                                                                     \
    ++pos[g];                                                             \
    if (pos[g] < lens[g]) {                                               \
      heap[0].code = codes[g][pos[g]];                                    \
      fk_heap_sift_down(heap, hn, 0);                                     \
    } else {                                                              \
      heap[0] = heap[--hn];                                               \
      if (hn) fk_heap_sift_down(heap, hn, 0);                             \
    }                                                                     \
  }                                                                       \
  return out_n;

size_t fk_merge_runs64(const uint64_t *const *restrict codes,
                       const long long *const *restrict counts,
                       const size_t *restrict lens, int G,
                       uint64_t *restrict out_codes,
                       long long *restrict out_counts) {
  FK_MERGE_BODY
}

size_t fk_merge_runs32(const uint64_t *const *restrict codes,
                       const int32_t *const *restrict counts,
                       const size_t *restrict lens, int G,
                       uint64_t *restrict out_codes,
                       long long *restrict out_counts) {
  FK_MERGE_BODY
}

/* Parallel merge: partition CODE SPACE into ~2x-threads ranges (all
 * occurrences of a code land in exactly one range, so dedup stays
 * local), heap-merge each range independently into its input-offset
 * slot of the output (a safe upper bound on its output size), then
 * compact the <= 64 segments left.  Boundaries come from quantiles of
 * the largest run — exact balance is irrelevant, only fault/bandwidth
 * parallelism. */

static size_t fk_lower_bound(const uint64_t *a, size_t n, uint64_t key) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t m = lo + (hi - lo) / 2;
    if (a[m] < key)
      lo = m + 1;
    else
      hi = m;
  }
  return lo;
}

#define FK_DEFINE_MERGE_SEG(NAME, CNT_T)                                  \
  static size_t NAME(const uint64_t *const *codes,                        \
                     const CNT_T *const *counts, const size_t *starts,    \
                     const size_t *ends, int G, uint64_t *out_codes,      \
                     long long *out_counts) {                             \
    fk_heap_ent heap[256];                                                \
    size_t pos[256];                                                      \
    size_t hn = 0;                                                        \
    for (int g = 0; g < G; ++g) {                                         \
      pos[g] = starts[g];                                                 \
      if (starts[g] < ends[g]) {                                          \
        heap[hn].code = codes[g][starts[g]];                              \
        heap[hn].run = (uint32_t)g;                                       \
        ++hn;                                                             \
      }                                                                   \
    }                                                                     \
    for (size_t i = hn; i-- > 0;) fk_heap_sift_down(heap, hn, i);         \
    size_t out_n = 0;                                                     \
    uint64_t last = 0;                                                    \
    int have_last = 0;                                                    \
    while (hn) {                                                          \
      uint64_t c = heap[0].code;                                          \
      uint32_t g = heap[0].run;                                           \
      long long v = (long long)counts[g][pos[g]];                         \
      if (have_last && c == last) {                                       \
        out_counts[out_n - 1] += v;                                       \
      } else {                                                            \
        out_codes[out_n] = c;                                             \
        out_counts[out_n] = v;                                            \
        ++out_n;                                                          \
        last = c;                                                         \
        have_last = 1;                                                    \
      }                                                                   \
      ++pos[g];                                                           \
      if (pos[g] < ends[g]) {                                             \
        heap[0].code = codes[g][pos[g]];                                  \
        fk_heap_sift_down(heap, hn, 0);                                   \
      } else {                                                            \
        heap[0] = heap[--hn];                                             \
        if (hn) fk_heap_sift_down(heap, hn, 0);                           \
      }                                                                   \
    }                                                                     \
    return out_n;                                                         \
  }

FK_DEFINE_MERGE_SEG(fk_merge_seg64, long long)
FK_DEFINE_MERGE_SEG(fk_merge_seg32, int32_t)

#define FK_MERGE_MT_BODY(SEGFN)                                           \
  if (G > 256) return (size_t)-1;                                         \
  size_t total = 0;                                                       \
  int big = 0;                                                            \
  for (int g = 0; g < G; ++g) {                                           \
    total += lens[g];                                                     \
    if (lens[g] > lens[big]) big = g;                                     \
  }                                                                       \
  int T = omp_get_max_threads() * 2;                                      \
  if (T > 64) T = 64;                                                     \
  if (T < 2 || total < (1u << 21)) {                                      \
    size_t st[256] = {0};                                                 \
    return SEGFN(codes, counts, st, lens, G, out_codes, out_counts);      \
  }                                                                       \
  uint64_t bounds[65];                                                    \
  bounds[0] = 0;                                                          \
  bounds[T] = UINT64_MAX;                                                 \
  for (int j = 1; j < T; ++j)                                             \
    bounds[j] = codes[big][(size_t)j * lens[big] / T];                    \
  size_t seg_off[64], seg_n[64];                                          \
  _Pragma("omp parallel for schedule(dynamic, 1)")                        \
  for (int j = 0; j < T; ++j) {                                           \
    size_t st[256], en[256], off = 0;                                     \
    for (int g = 0; g < G; ++g) {                                         \
      st[g] = fk_lower_bound(codes[g], lens[g], bounds[j]);               \
      en[g] = fk_lower_bound(codes[g], lens[g], bounds[j + 1]);           \
      off += st[g];                                                       \
    }                                                                     \
    seg_off[j] = off;                                                     \
    seg_n[j] = SEGFN(codes, counts, st, en, G, out_codes + off,           \
                     out_counts + off);                                   \
  }                                                                       \
  size_t out_n = seg_n[0];                                                \
  for (int j = 1; j < T; ++j) {                                           \
    if (seg_off[j] != out_n) {                                            \
      memmove(out_codes + out_n, out_codes + seg_off[j],                  \
              seg_n[j] * sizeof(uint64_t));                               \
      memmove(out_counts + out_n, out_counts + seg_off[j],                \
              seg_n[j] * sizeof(long long));                              \
    }                                                                     \
    out_n += seg_n[j];                                                    \
  }                                                                       \
  return out_n;

size_t fk_merge_runs64_mt(const uint64_t *const *restrict codes,
                          const long long *const *restrict counts,
                          const size_t *restrict lens, int G,
                          uint64_t *restrict out_codes,
                          long long *restrict out_counts) {
  FK_MERGE_MT_BODY(fk_merge_seg64)
}

size_t fk_merge_runs32_mt(const uint64_t *const *restrict codes,
                          const int32_t *const *restrict counts,
                          const size_t *restrict lens, int G,
                          uint64_t *restrict out_codes,
                          long long *restrict out_counts) {
  FK_MERGE_MT_BODY(fk_merge_seg32)
}

/* ------------------------------------------------------------------ */
/* Sorted-spectrum TSV parsing: "KMER<sep>COUNT\n" lines -> (code u64, */
/* count i64) arrays.  The text tail of `findkmer merge` parses at     */
/* ~1-2 Mline/s in Python; this parses at memory bandwidth (OMP over   */
/* line-aligned segments) so chr-scale merges reuse the binary-run     */
/* heap merge above.  Codes are 2 bits/char MSB-first (A=0,C=1,G=2,    */
/* T=3) — lexicographic k-mer order == ascending code order.           */
/* Returns the line count, or (size_t)-1 on any malformed line, a      */
/* k-mer of length != k, k > 31, or out-of-order/duplicate codes       */
/* (callers fall back to the Python parser for exotic inputs).         */

static const int8_t FK_BASE_CODE[256] = {
    ['A'] = 1, ['C'] = 2, ['G'] = 3, ['T'] = 4,
};  /* value-1; 0 = invalid */

static size_t fk_parse_seg(const uint8_t *buf, size_t lo, size_t hi, int k,
                           uint8_t sep, uint64_t *codes, long long *counts,
                           size_t max_out) {
  size_t n = 0;
  size_t i = lo;
  while (i < hi) {
    if (n >= max_out) return (size_t)-1;
    uint64_t code = 0;
    int j = 0;
    for (; j < k && i < hi; ++j, ++i) {
      int8_t c = FK_BASE_CODE[buf[i]];
      if (!c) return (size_t)-1;
      code = (code << 2) | (uint64_t)(c - 1);
    }
    if (j != k || i >= hi || buf[i] != sep) return (size_t)-1;
    ++i;
    long long v = 0;
    int digits = 0;
    for (; i < hi && buf[i] >= '0' && buf[i] <= '9'; ++i, ++digits)
      v = v * 10 + (buf[i] - '0');
    if (!digits) return (size_t)-1;
    if (i < hi) {
      if (buf[i] == '\r') ++i;
      if (i >= hi || buf[i] != '\n') return (size_t)-1;
      ++i;
    }
    codes[n] = code;
    counts[n] = v;
    ++n;
  }
  return n;
}

size_t fk_parse_spectrum(const uint8_t *restrict buf, size_t len, int k,
                         uint8_t sep, uint64_t *restrict codes,
                         long long *restrict counts, size_t max_out) {
  if (k < 1 || k > 31) return (size_t)-1;
  if (!len) return 0;
  size_t total = 0;
  int bad = 0;
#ifdef _OPENMP
  if (len >= FK_MT_MIN) {
    int T = omp_get_max_threads();
    if (T > 64) T = 64;
    size_t seg_lo[64], seg_hi[64], seg_n[64], seg_off[64];
    /* segment bounds snapped forward to line starts */
    for (int t = 0; t < T; ++t) {
      size_t p = len * (size_t)t / (size_t)T;
      if (t) {
        while (p < len && buf[p - 1] != '\n') ++p;
      }
      seg_lo[t] = p;
    }
    for (int t = 0; t < T - 1; ++t) seg_hi[t] = seg_lo[t + 1];
    seg_hi[T - 1] = len;
    /* line width is k + sep + digits: upper-bound each segment's line
     * count by bytes/(k+2) */
#pragma omp parallel for schedule(static)
    for (int t = 0; t < T; ++t) {
      size_t cap = (seg_hi[t] - seg_lo[t]) / (size_t)(k + 2) + 1;
      seg_off[t] = seg_lo[t] / (size_t)(k + 2);
      size_t m = fk_parse_seg(buf, seg_lo[t], seg_hi[t], k, sep,
                              codes + seg_off[t], counts + seg_off[t],
                              cap);
      seg_n[t] = m;
    }
    for (int t = 0; t < T; ++t) {
      if (seg_n[t] == (size_t)-1) bad = 1;
    }
    if (bad) return (size_t)-1;
    for (int t = 0; t < T; ++t) {
      if (seg_off[t] != total) {
        memmove(codes + total, codes + seg_off[t],
                seg_n[t] * sizeof(uint64_t));
        memmove(counts + total, counts + seg_off[t],
                seg_n[t] * sizeof(long long));
      }
      total += seg_n[t];
    }
  } else
#endif
  {
    total = fk_parse_seg(buf, 0, len, k, sep, codes, counts, max_out);
    if (total == (size_t)-1) return (size_t)-1;
  }
  for (size_t i = 1; i < total; ++i)
    if (codes[i] <= codes[i - 1]) return (size_t)-1;
  return total;
}

/* ----------------------------------------------------------------- */
/* Read filtering: per-read k-mer membership scoring (findkmer filter)
 *
 * For each read (a contiguous byte span of `buf`), a rolling 2-bit
 * scan counts valid windows and how many of their codes are present
 * in a sorted u64 table — a one-probe bit-table prefilter in front of
 * the binary search so misses (the common case against a foreign
 * spectrum) cost one load.  Mirrors filter.py's numpy hits_batch
 * semantics exactly (non-ACGT resets the window; canonical folds to
 * min(code, revcomp)); OpenMP over reads.                            */

/* case-insensitive base map for the filter scan, stored value+1 so
 * the zero default means invalid (window reset) — matches
 * io/encode.py / filter.py semantics                                 */
static const int8_t FK_FILTER_CODE[256] = {
    ['A'] = 1, ['C'] = 2, ['G'] = 3, ['T'] = 4,
    ['a'] = 1, ['c'] = 2, ['g'] = 3, ['t'] = 4,
};

static inline int fk_table_has(const uint64_t *t, size_t n, uint64_t key) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = lo + ((hi - lo) >> 1);
    if (t[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && t[lo] == key;
}

/* Device-engine host legs (filter_device.py):
 *
 * fk_filter_prepare: joined read bytes -> the device wire's code
 * stream (0..3 = base, 4 = invalid/reset), one OpenMP LUT pass.
 * Replaces the numpy _CODE_LUT + minimum() pair whose fresh-page
 * faults (~0.02 GB/s on lazily-backed VMs) dominated the filter's
 * host time.
 *
 * fk_filter_bitmap_hits: per-read (hits, valid windows) from the
 * device's window-hit bitmap.  Window starting at joined position p
 * is bit p + halo of `words` (filter_device._filter_step packs bit s
 * of word w as window 32w + s, little-endian).  The per-read rolling
 * run counter recomputes validity exactly like fk_filter_hits, so
 * the device engine's attribution matches the host engine's
 * bit-for-bit; OpenMP over reads.                                    */

void fk_filter_prepare(const uint8_t *restrict buf, long long n,
                       uint8_t *restrict out) {
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < n; ++i) {
    int b = (int)FK_FILTER_CODE[buf[i]] - 1;
    out[i] = (uint8_t)(b < 0 ? 4 : b);
  }
}

void fk_filter_bitmap_hits(const uint8_t *restrict buf,
                           const long long *restrict starts,
                           const long long *restrict lens,
                           long long n_reads, int k,
                           const uint32_t *restrict words,
                           long long halo,
                           long long *restrict hits_out,
                           long long *restrict win_out) {
#pragma omp parallel for schedule(dynamic, 64)
  for (long long r = 0; r < n_reads; ++r) {
    const uint8_t *p = buf + starts[r];
    long long n = lens[r];
    long long run = 0, wins = 0, hits = 0;
    for (long long i = 0; i < n; ++i) {
      int b = (int)FK_FILTER_CODE[p[i]] - 1;
      if (b < 0) {
        run = 0;
        continue;
      }
      if (++run >= k) {
        ++wins;
        /* window start: joined position starts[r] + i - k + 1 */
        long long j = starts[r] + i - k + 1 + halo;
        hits += (words[j >> 5] >> (j & 31)) & 1u;
      }
    }
    hits_out[r] = hits;
    win_out[r] = wins;
  }
}

void fk_filter_hits(const uint8_t *restrict buf,
                    const long long *restrict starts,
                    const long long *restrict lens, long long n_reads,
                    int k, int canonical,
                    const uint64_t *restrict table, size_t tsize,
                    const uint8_t *restrict bloom, int bloom_shift,
                    long long *restrict hits_out,
                    long long *restrict win_out) {
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  const uint64_t mult = 0x9E3779B97F4A7C15ULL;
  const int rc_shift = 2 * (k - 1);
#pragma omp parallel for schedule(dynamic, 64)
  for (long long r = 0; r < n_reads; ++r) {
    const uint8_t *p = buf + starts[r];
    long long n = lens[r];
    uint64_t code = 0, rc = 0;
    long long run = 0, wins = 0, hits = 0;
    for (long long i = 0; i < n; ++i) {
      int b = (int)FK_FILTER_CODE[p[i]] - 1;
      if (b < 0) {
        run = 0;
        continue;
      }
      code = ((code << 2) | (uint64_t)b) & mask;
      rc = (rc >> 2) | ((uint64_t)(3 - b) << rc_shift);
      if (++run >= k) {
        ++wins;
        uint64_t c = code;
        if (canonical && rc < c) c = rc;
        if (bloom[(c * mult) >> bloom_shift] &&
            fk_table_has(table, tsize, c))
          ++hits;
      }
    }
    hits_out[r] = hits;
    win_out[r] = wins;
  }
}

/* ----------------------------------------------------------------- */
/* FASTQ record scanner (offsets-based zero-copy; findkmer filter's
 * end-to-end host leg).  One memchr walk over a buffered block
 * produces per-record OFFSETS into the block — no per-read byte
 * copies, no per-line Python.  Semantics mirror
 * filter._fastq_records_block exactly: strict 4-line records
 * (@header / seq / + / quality), blank lines tolerated only where a
 * HEADER is expected, CRLF stripped from the sequence span, anything
 * else (wrapped FASTQ) is an error, never a misparse.
 *
 * Returns the record count; *consumed_out = bytes of `buf` fully
 * consumed (the caller carries the tail into the next block);
 * *err_out = 0 ok, 1 = multi-line/malformed record at the position
 * where a header or '+' was expected.  Scanning stops early (no
 * error) when a record's four lines are not all terminated within
 * the block or out arrays are full (max_rec).                        */
long long fk_fastq_scan(const uint8_t *restrict buf, long long n,
                        long long *restrict seq_s,
                        long long *restrict seq_e,
                        long long *restrict rec_s,
                        long long *restrict rec_e, long long max_rec,
                        long long *restrict consumed_out,
                        int *restrict err_out) {
  long long pos = 0, nrec = 0, consumed = 0;
  *err_out = 0;
  while (nrec < max_rec) {
    /* skip blank lines ("" or lone "\r") where a header is expected */
    while (pos < n) {
      if (buf[pos] == '\n') {
        pos += 1;
        consumed = pos;
        continue;
      }
      if (buf[pos] == '\r' && pos + 1 < n && buf[pos + 1] == '\n') {
        pos += 2;
        consumed = pos;
        continue;
      }
      break;
    }
    if (pos >= n) break;
    const uint8_t *nl0 = memchr(buf + pos, '\n', (size_t)(n - pos));
    if (!nl0) break;
    long long s0 = pos;
    long long s1 = (long long)(nl0 - buf) + 1;
    const uint8_t *nl1 = memchr(buf + s1, '\n', (size_t)(n - s1));
    if (!nl1) break;
    long long e1 = (long long)(nl1 - buf);
    long long s2 = e1 + 1;
    const uint8_t *nl2 = memchr(buf + s2, '\n', (size_t)(n - s2));
    if (!nl2) break;
    long long s3 = (long long)(nl2 - buf) + 1;
    const uint8_t *nl3 = memchr(buf + s3, '\n', (size_t)(n - s3));
    if (!nl3) break;
    long long e3 = (long long)(nl3 - buf) + 1; /* past the newline */
    if (buf[s0] != '@' || (s2 < n && buf[s2] != '+')) {
      *consumed_out = consumed;
      *err_out = 1;
      return nrec;
    }
    if (e1 > s1 && buf[e1 - 1] == '\r') e1 -= 1; /* CRLF seq line */
    seq_s[nrec] = s1;
    seq_e[nrec] = e1;
    rec_s[nrec] = s0;
    rec_e[nrec] = e3;
    ++nrec;
    pos = e3;
    consumed = e3;
  }
  *consumed_out = consumed;
  return nrec;
}

/* Device-engine gather leg: LUT-encode each read's bytes straight
 * from the BLOCK buffer into its joined-stream position of the
 * device work buffer (pre-filled with 4 = invalid, so separators and
 * padding are already in place).  Replaces the b"N".join(seqs) copy
 * plus fk_filter_prepare pass of the list-based flow.               */
void fk_filter_gather_prepare(const uint8_t *restrict buf,
                              const long long *restrict starts,
                              const long long *restrict joined,
                              const long long *restrict lens,
                              long long n_reads,
                              uint8_t *restrict out) {
#pragma omp parallel for schedule(dynamic, 64)
  for (long long r = 0; r < n_reads; ++r) {
    const uint8_t *p = buf + starts[r];
    uint8_t *q = out + joined[r];
    long long n = lens[r];
    for (long long i = 0; i < n; ++i) {
      int b = (int)FK_FILTER_CODE[p[i]] - 1;
      q[i] = (uint8_t)(b < 0 ? 4 : b);
    }
  }
}

/* fk_filter_bitmap_hits with SEPARATE byte/bitmap coordinates: read
 * r's bytes live at buf[byte_starts[r] .. +lens[r]) (offsets into the
 * original block), while its windows sit at joined[r]-relative bitmap
 * positions (the gather leg's joined-stream layout).  The list-based
 * flow (fk_filter_bitmap_hits) is the byte_starts == joined case.    */
void fk_filter_bitmap_hits2(const uint8_t *restrict buf,
                            const long long *restrict byte_starts,
                            const long long *restrict joined,
                            const long long *restrict lens,
                            long long n_reads, int k,
                            const uint32_t *restrict words,
                            long long halo,
                            long long *restrict hits_out,
                            long long *restrict win_out) {
#pragma omp parallel for schedule(dynamic, 64)
  for (long long r = 0; r < n_reads; ++r) {
    const uint8_t *p = buf + byte_starts[r];
    long long n = lens[r];
    long long run = 0, wins = 0, hits = 0;
    for (long long i = 0; i < n; ++i) {
      int b = (int)FK_FILTER_CODE[p[i]] - 1;
      if (b < 0) {
        run = 0;
        continue;
      }
      if (++run >= k) {
        ++wins;
        long long j = joined[r] + i - k + 1 + halo;
        hits += (words[j >> 5] >> (j & 31)) & 1u;
      }
    }
    hits_out[r] = hits;
    win_out[r] = wins;
  }
}
