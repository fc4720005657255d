/* Host list-engine kernels: k-mer extraction, radix sort, run-length
 * counting, and record emission for the glistmaker pipeline.
 *
 * Placement (utils/backend.py): the tools run this host engine when
 * JAX's backend is the CPU, and their device paths otherwise; the
 * device paths are tested byte for byte against this engine.
 *
 * This is a fresh design, not a port: the reference splits work into
 * per-thread GT4WordTables sorted with an MSD 8-bit hybrid radix
 * (src/utils.c:101-198) and k-way-merges tmp lists
 * (src/glistmaker.c:788-835).  Here the whole extraction is one rolling
 * pass (role of src/fasta.c:218-264), the sort is LSD radix over 11-bit
 * digits (2048 write streams keep the distribution pass L2-resident;
 * uniform digits are skipped, so a k=25 canonical key sorts in <=5
 * passes), and counts are never stored: they fall out of run lengths in
 * the single emit pass that writes the final 12-byte records.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifdef __AVX2__
#include <immintrin.h>
#endif

#define RADIX_BITS 11
#define RADIX_SIZE (1 << RADIX_BITS)
#define RADIX_MASK (RADIX_SIZE - 1)

/* 12-byte record accessors (defined below) */
static void put_rec (unsigned char *r, long idx, unsigned long long w,
                     unsigned int c);
static void rec_get (const unsigned char *r, long i,
                     unsigned long long *w, unsigned int *c);

/* ------------------------------------------------------------------ */
/* FASTA slab parse: raw bytes -> 2-bit codes                          */
/* ------------------------------------------------------------------ */

/* Byte->code table: ACGTUacgtu map to 0..3, everything else is 255
 * (invalid: resets the k-mer window, matching src/fasta.c:258-264 and
 * the numpy NUCL_CODES twin in ops/encode.py). */
static unsigned char nucl_codes[256];
static int nucl_init_done = 0;

static void nucl_init (void)
{
  if (nucl_init_done) return;
  memset (nucl_codes, 255, 256);
  nucl_codes['A'] = nucl_codes['a'] = 0;
  nucl_codes['C'] = nucl_codes['c'] = 1;
  nucl_codes['G'] = nucl_codes['g'] = 2;
  nucl_codes['T'] = nucl_codes['t'] = 3;
  nucl_codes['U'] = nucl_codes['u'] = 3;
  nucl_init_done = 1;
}

/* Parse one newline-cut FASTA fragment whose leading lines may continue
 * a record opened in a previous slab (exact twin of the vectorized
 * _parse_fasta_slab in io/fasta.py; shared semantics: empty lines are
 * dropped, one trailing \r per line is stripped, '>' only opens a
 * header at line start, records are separated by one 255 sentinel with
 * none after the final record, pre-header junk is ignored when not
 * continuing).  codes must have capacity n + 1.  Returns the number of
 * codes written, or -1 when the fragment contains no '>' line and no
 * record is being continued (caller raises). */
long fgx_parse_fasta_slab (const unsigned char *data, long n,
                           int continuing, unsigned char *codes,
                           long *n_headers, long *total_bases,
                           long *count_n)
{
  nucl_init ();
  long i = 0, m = 0;
  long headers = 0, bases = 0, ncnt = 0;
  int open_record = continuing ? 1 : 0;
  while (i < n) {
    /* find line end */
    long e = i;
    while (e < n && data[e] != '\n') e++;
    long line_end = e;
    if (line_end > i && data[line_end - 1] == '\r') line_end--;
    if (line_end > i) {                 /* skip empty lines */
      if (data[i] == '>') {
        if (open_record) codes[m++] = 255;
        headers++;
        open_record = 1;
      } else if (open_record) {
        long j;
        for (j = i; j < line_end; j++) {
          unsigned char b = data[j];
          codes[m++] = nucl_codes[b];
          if (b == 'N' || b == 'n') ncnt++;
        }
        bases += line_end - i;
      }
      /* pre-header lines with no carried record: dropped */
    }
    i = e + 1;
  }
  if (headers == 0 && !continuing) return -1;
  *n_headers = headers;
  *total_bases = bases;
  *count_n = ncnt;
  return m;
}

/* FASTQ slab parse: 4-line records (name/seq/+/quality). Twin of
 * parse_fastq in io/fasta.py: EMPTY lines are dropped before grouping,
 * one trailing \r per line is stripped, records trailing beyond the
 * last complete 4-line group are ignored, and one 255 sentinel follows
 * every record's codes (including the last). Outputs: codes (capacity
 * n+1), rec_starts = code offset of each record's first base,
 * name_pos = byte offset of the name (line start + 1, past '@').
 * Returns the record count. */
long fgx_parse_fastq_slab (const unsigned char *data, long n,
                           unsigned char *codes, long *m_out,
                           long *rec_starts, long *name_pos,
                           long *total_bases, long *count_n)
{
  nucl_init ();
  long i = 0, m = 0, nrec = 0, bases = 0, ncnt = 0;
  long n_lines = 0, n_full;
  int line_in_group = 0;
  long pending_name = -1;
  /* pass 1: count lines the way parse_fastq's _line_index_fastq does —
   * EVERY '\n'-delimited segment is a line, including zero-length ones
   * ("@n\n\n+\n\n" is a complete 4-line record with an empty sequence
   * and quality — the reference's state machine is strictly
   * line-driven, src/fasta.c:190-293); only a zero-length segment at
   * EOF after a trailing newline is not a line. Round-4 fuzz_ingest
   * findings (seeds 404/517): any emptiness-based skipping desyncs the
   * 4-line group cadence and silently drops records. parse_fastq
   * groups lines by 4 and drops any trailing partial group outright,
   * even one holding a sequence line. */
  while (i < n) {
    long e = i;
    while (e < n && data[e] != '\n') e++;
    if (e < n || e > i) n_lines++;
    i = e + 1;
  }
  n_full = n_lines / 4;
  i = 0;
  while (i < n && nrec < n_full) {
    long e = i;
    while (e < n && data[e] != '\n') e++;
    long line_end = e;
    if (line_end > i && data[line_end - 1] == '\r') line_end--;
    if (e < n || e > i) {   /* every segment except an empty EOF tail */
      if (line_in_group == 0) {
        pending_name = i + 1;             /* past '@' */
      } else if (line_in_group == 1) {
        long j;
        rec_starts[nrec] = m;
        name_pos[nrec] = pending_name;
        for (j = i; j < line_end; j++) {
          unsigned char b = data[j];
          codes[m++] = nucl_codes[b];
          if (b == 'N' || b == 'n') ncnt++;
        }
        codes[m++] = 255;                 /* sentinel */
        bases += line_end - i;
        nrec++;
      }
      /* lines 2 (+) and 3 (quality) are skipped */
      line_in_group = (line_in_group + 1) & 3;
    }
    i = e + 1;
  }
  *m_out = m;
  *total_bases = bases;
  *count_n = ncnt;
  return nrec;
}

/* ------------------------------------------------------------------ */
/* extraction: 2-bit codes -> canonical k-mer words                    */
/* ------------------------------------------------------------------ */

/* codes[i] in 0..3 are bases, anything >3 resets the window (the
 * N-reset semantics of src/fasta.c:258-264; the parser already mapped
 * bytes to codes).  Returns the number of words written to out. */
long fgx_extract_canonical (const unsigned char *codes, long n, int k,
                            unsigned long long *out)
{
  unsigned long long mask =
    (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  int rc_shift = 2 * (k - 1);
  unsigned long long fw = 0, rc = 0;
  int run = 0;
  long i, m = 0;
  for (i = 0; i < n; i++) {
    unsigned int c = codes[i];
    if (c > 3) { run = 0; continue; }
    fw = ((fw << 2) | c) & mask;
    /* reverse complement built incrementally: the complement of the
     * incoming base enters at the top; k shifts flush any pre-reset
     * remnant bits out the bottom, so no reset of rc is needed */
    rc = (rc >> 2) | ((unsigned long long) (3 - c) << rc_shift);
    if (++run >= k) out[m++] = (fw < rc) ? fw : rc;
  }
  return m;
}

/* Non-canonical variant (glistmaker has no flag for it, but the device
 * twin supports it and the differential tests exercise both). */
long fgx_extract_forward (const unsigned char *codes, long n, int k,
                          unsigned long long *out)
{
  unsigned long long mask =
    (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  unsigned long long fw = 0;
  int run = 0;
  long i, m = 0;
  for (i = 0; i < n; i++) {
    unsigned int c = codes[i];
    if (c > 3) { run = 0; continue; }
    fw = ((fw << 2) | c) & mask;
    if (++run >= k) out[m++] = fw;
  }
  return m;
}

/* ------------------------------------------------------------------ */
/* LSD radix sort, 11-bit digits, uniform-digit skipping               */
/* ------------------------------------------------------------------ */

/* Sorts a[0..n) ascending using tmp as scratch.  Returns the pointer
 * holding the sorted data (a or tmp - an even/odd number of passes). */
unsigned long long *fgx_radix_sort_u64 (unsigned long long *a,
                                        unsigned long long *tmp,
                                        long n, int key_bits)
{
  int n_digits = (key_bits + RADIX_BITS - 1) / RADIX_BITS;
  if (n_digits > 6) n_digits = 6;           /* 66 bits capacity */
  if (n_digits < 1) n_digits = 1;
  /* one histogram pass for every digit at once (stack-local: callers
   * may sort independent buckets from parallel threads) */
  long hist[6][RADIX_SIZE];
  memset (hist, 0, n_digits * RADIX_SIZE * sizeof (long));
  long i;
  for (i = 0; i < n; i++) {
    unsigned long long v = a[i];
    int d;
    for (d = 0; d < n_digits; d++)
      hist[d][(v >> (d * RADIX_BITS)) & RADIX_MASK]++;
  }
  unsigned long long *src = a, *dst = tmp;
  int d;
  for (d = 0; d < n_digits; d++) {
    long *h = hist[d];
    /* skip digits where every key agrees (common in the top digit of
     * canonical words: only 2k-? bits are populated) */
    int first_digit = (n > 0)
      ? (int) ((src[0] >> (d * RADIX_BITS)) & RADIX_MASK) : 0;
    if (n > 0 && h[first_digit] == n) continue;
    long off[RADIX_SIZE];
    long acc = 0;
    for (i = 0; i < RADIX_SIZE; i++) { off[i] = acc; acc += h[i]; }
    int sh = d * RADIX_BITS;
    for (i = 0; i < n; i++) {
      unsigned long long v = src[i];
      dst[off[(v >> sh) & RADIX_MASK]++] = v;
    }
    unsigned long long *t = src; src = dst; dst = t;
  }
  return src;
}

/* ------------------------------------------------------------------ */
/* run-length emit: sorted words -> 12-byte .list records              */
/* ------------------------------------------------------------------ */

static void put_rec (unsigned char *r, long idx, unsigned long long w,
                     unsigned int c)
{
  __builtin_memcpy (r + 12 * idx, &w, 8);
  __builtin_memcpy (r + 12 * idx + 8, &c, 4);
}

/* Emits one record per run of equal words whose length passes
 * [min_count, max_count].  Returns the number of records; *total gets
 * the sum of emitted counts (the .list header total, u64 like the
 * reference header field word-list.h:61-72). */
long fgx_emit_runs (const unsigned long long *sorted, long n,
                    unsigned int min_count, unsigned int max_count,
                    unsigned char *records, unsigned long long *total)
{
  long i = 0, m = 0;
  unsigned long long tot = 0;
  while (i < n) {
    unsigned long long w = sorted[i];
    long j = i + 1;
    while (j < n && sorted[j] == w) j++;
    /* counts are u32 in the record; the reference's table counts wrap
     * rather than saturate (u32 freq field, src/word-list.h:72) */
    unsigned int c = (unsigned int) (j - i);
    if (c >= min_count && c <= max_count) {
      put_rec (records, m, w, c);
      tot += c;
      m++;
    }
    i = j;
  }
  *total = tot;
  return m;
}

/* ------------------------------------------------------------------ */
/* MSD-bucketed sort with streaming run emission                       */
/* ------------------------------------------------------------------ */

/* The flat LSD sort above streams the full array every pass; for large
 * n an MSD first pass into ~n/32k buckets makes every later pass
 * L2-resident, and because bucket order IS word order, runs can be
 * emitted (and written to the output file) bucket by bucket — no
 * full-size record buffer, no second pass over 600 MB of records.
 * This is also the natural OpenMP grain for multi-core hosts: buckets
 * are independent and ordered, so parallel sorting with in-order
 * retirement keeps the output byte-stable at any thread count. */

typedef struct {
  unsigned long long *words;    /* caller's buffer (clobbered) */
  unsigned long long *tmp;      /* MSD-distributed copy (owned) */
  long n;
  int key_bits;
  int msd_bits;                 /* top bits used for bucketing */
  long n_buckets;
  long *bucket_off;             /* [n_buckets + 1] offsets into tmp */
  long cur_bucket;
  long cur_pos;                 /* emit cursor within current bucket */
  int cur_sorted;               /* current bucket already sorted? */
  int presorted;                /* all buckets sorted up front (OpenMP) */
} FgxSce;

void *fgx_sce_start (unsigned long long *words, long n, int key_bits)
{
  FgxSce *st = (FgxSce *) calloc (1, sizeof (FgxSce));
  if (!st) return NULL;
  st->words = words;
  st->n = n;
  st->key_bits = key_bits;
  /* target ~32k keys per bucket (256 KB: inner sorts run in L2) */
  int b = 0;
  while ((n >> b) > 32768 && b < key_bits && b < 14) b++;
  if (b < 1) b = 1;
  st->msd_bits = b;
  st->n_buckets = 1L << b;
  st->tmp = (unsigned long long *)
    malloc ((size_t) (n > 0 ? n : 1) * sizeof (unsigned long long));
  st->bucket_off = (long *) calloc (st->n_buckets + 1, sizeof (long));
  if (!st->tmp || !st->bucket_off) {
    free (st->tmp); free (st->bucket_off); free (st);
    return NULL;
  }
  int sh = key_bits - b;
  long i;
  long *cnt = (long *) calloc (st->n_buckets, sizeof (long));
  for (i = 0; i < n; i++) cnt[words[i] >> sh]++;
  long acc = 0;
  for (i = 0; i < st->n_buckets; i++) {
    st->bucket_off[i] = acc;
    acc += cnt[i];
    cnt[i] = st->bucket_off[i];
  }
  st->bucket_off[st->n_buckets] = acc;
  for (i = 0; i < n; i++) st->tmp[cnt[words[i] >> sh]++] = words[i];
  free (cnt);
  st->cur_bucket = 0;
  st->cur_pos = 0;
  st->cur_sorted = 0;
#ifdef _OPENMP
  /* multi-core hosts: buckets are independent, so presort them all in
   * parallel (scratch = the matching segment of the caller's words
   * buffer, disjoint per bucket; the radix sort is reentrant). Emission
   * order — and therefore the output byte stream — is unchanged at any
   * thread count: parallelism only moves WHEN a bucket gets sorted. */
  if (omp_get_max_threads () > 1) {
    long b;
#pragma omp parallel for schedule(dynamic, 4)
    for (b = 0; b < st->n_buckets; b++) {
      long a = st->bucket_off[b], z = st->bucket_off[b + 1];
      if (z <= a) continue;
      unsigned long long *sorted = fgx_radix_sort_u64 (
        st->tmp + a, st->words + a, z - a, st->key_bits - st->msd_bits);
      if (sorted != st->tmp + a)
        memcpy (st->tmp + a, sorted,
                (size_t) (z - a) * sizeof (unsigned long long));
    }
    st->presorted = 1;
  }
#endif
  return st;
}

/* Emit up to cap_records records into buf; returns the record count
 * (0 = exhausted).  chunk_total gets the sum of the emitted counts. */
long fgx_sce_next (void *handle, unsigned int min_count,
                   unsigned int max_count, unsigned char *buf,
                   long cap_records, unsigned long long *chunk_total)
{
  FgxSce *st = (FgxSce *) handle;
  long m = 0;
  unsigned long long tot = 0;
  while (st->cur_bucket < st->n_buckets && m < cap_records) {
    long a = st->bucket_off[st->cur_bucket];
    long z = st->bucket_off[st->cur_bucket + 1];
    unsigned long long *seg = st->tmp + a;
    long len = z - a;
    if (len == 0) { st->cur_bucket++; st->cur_sorted = 0; continue; }
    if (!st->cur_sorted) {
      if (!st->presorted) {
        /* scratch: the matching segment of the caller's words buffer */
        unsigned long long *sorted = fgx_radix_sort_u64 (
          seg, st->words + a, len, st->key_bits - st->msd_bits);
        if (sorted != seg)
          memcpy (seg, sorted, (size_t) len * sizeof (unsigned long long));
      }
      st->cur_sorted = 1;
      st->cur_pos = 0;
    }
    long i = st->cur_pos;
    while (i < len && m < cap_records) {
      unsigned long long w = seg[i];
      long j = i + 1;
      while (j < len && seg[j] == w) j++;
      unsigned int c = (unsigned int) (j - i);
      if (c >= min_count && c <= max_count) {
        put_rec (buf, m, w, c);
        tot += c;
        m++;
      }
      i = j;
    }
    st->cur_pos = i;
    if (i >= len) { st->cur_bucket++; st->cur_sorted = 0; }
  }
  *chunk_total = tot;
  return m;
}

void fgx_sce_free (void *handle)
{
  FgxSce *st = (FgxSce *) handle;
  if (!st) return;
  free (st->tmp);
  free (st->bucket_off);
  free (st);
}

/* ------------------------------------------------------------------ */
/* fused one-call pipeline for a code slab                             */
/* ------------------------------------------------------------------ */

/* codes -> sorted unique records in one call.  records must have
 * capacity 12 * (number of valid windows) bytes; scratch management is
 * internal.  Returns the record count, or -1 on allocation failure. */
long fgx_count_kmers_list (const unsigned char *codes, long n, int k,
                           int canonical,
                           unsigned int min_count, unsigned int max_count,
                           unsigned char *records,
                           unsigned long long *total_count)
{
  long cap = (n > 0) ? n : 1;
  unsigned long long *words =
    (unsigned long long *) malloc (cap * sizeof (unsigned long long));
  unsigned long long *tmp =
    (unsigned long long *) malloc (cap * sizeof (unsigned long long));
  if (!words || !tmp) { free (words); free (tmp); return -1; }
  long m = canonical
    ? fgx_extract_canonical (codes, n, k, words)
    : fgx_extract_forward (codes, n, k, words);
  unsigned long long *sorted = fgx_radix_sort_u64 (words, tmp, m, 2 * k);
  long n_rec = fgx_emit_runs (sorted, m, min_count, max_count,
                              records, total_count);
  free (words);
  free (tmp);
  return n_rec;
}

/* In-place convenience sort (scratch managed internally). */
int fgx_sort_u64 (unsigned long long *a, long n, int key_bits)
{
  unsigned long long *tmp = (unsigned long long *)
    malloc ((size_t) (n > 0 ? n : 1) * sizeof (unsigned long long));
  if (!tmp) return -1;
  unsigned long long *res = fgx_radix_sort_u64 (a, tmp, n, key_bits);
  if (res != a)
    memcpy (a, res, (size_t) n * sizeof (unsigned long long));
  free (tmp);
  return 0;
}

/* Sort-then-emit over a caller-accumulated word buffer: the multi-slab
 * ingestion path extracts every slab into one buffer and sorts ONCE
 * (cheaper than per-slab sorts plus a k-way merge when the buffer fits
 * in RAM).  words is clobbered.  Returns the record count, -1 on OOM. */
long fgx_sort_count_emit (unsigned long long *words, long n, int key_bits,
                          unsigned int min_count, unsigned int max_count,
                          unsigned char *records,
                          unsigned long long *total_count)
{
  unsigned long long *tmp = (unsigned long long *)
    malloc ((size_t) (n > 0 ? n : 1) * sizeof (unsigned long long));
  if (!tmp) return -1;
  unsigned long long *sorted = fgx_radix_sort_u64 (words, tmp, n, key_bits);
  long m = fgx_emit_runs (sorted, n, min_count, max_count, records,
                          total_count);
  free (tmp);
  return m;
}

/* Count-only variant for callers that keep (words, counts) as arrays
 * (the sharded merge path): writes unique words and u32 counts to
 * separate outputs, no cutoff. */
long fgx_count_kmers_arrays (const unsigned char *codes, long n, int k,
                             int canonical,
                             unsigned long long *uwords,
                             unsigned int *ucounts,
                             unsigned long long *total_count)
{
  long cap = (n > 0) ? n : 1;
  unsigned long long *words =
    (unsigned long long *) malloc (cap * sizeof (unsigned long long));
  unsigned long long *tmp =
    (unsigned long long *) malloc (cap * sizeof (unsigned long long));
  if (!words || !tmp) { free (words); free (tmp); return -1; }
  long m = canonical
    ? fgx_extract_canonical (codes, n, k, words)
    : fgx_extract_forward (codes, n, k, words);
  unsigned long long *sorted = fgx_radix_sort_u64 (words, tmp, m, 2 * k);
  long i = 0, mu = 0;
  unsigned long long tot = 0;
  while (i < m) {
    unsigned long long w = sorted[i];
    long j = i + 1;
    while (j < m && sorted[j] == w) j++;
    uwords[mu] = w;
    ucounts[mu] = (unsigned int) (j - i);
    tot += (unsigned long long) (j - i);
    mu++;
    i = j;
  }
  free (words);
  free (tmp);
  *total_count = tot;
  return mu;
}

/* ------------------------------------------------------------------ */
/* list dump formatting (glistquery full dump)                         */
/* ------------------------------------------------------------------ */

/* Format raw 12-byte records as "KMER\tCOUNT\n" text (the reference's
 * word2string + printf loop, src/glistquery.c:495-541 / word2string
 * src/sequence.c:88-130). out must have capacity n * (k + 12) bytes.
 * Returns the number of bytes written. */
long fgx_dump_records (const unsigned char *r, long n, int k,
                       unsigned char *out)
{
  static const char NUCL[4] = { 'A', 'C', 'G', 'T' };
  long i, o = 0;
  for (i = 0; i < n; i++) {
    unsigned long long w;
    unsigned int c;
    int j;
    __builtin_memcpy (&w, r + 12 * i, 8);
    __builtin_memcpy (&c, r + 12 * i + 8, 4);
    for (j = k - 1; j >= 0; j--)
      out[o + j] = NUCL[(w >> (2 * (k - 1 - j))) & 3];
    o += k;
    out[o++] = '\t';
    {
      char tmp[12];
      int t = 0;
      if (c == 0) tmp[t++] = '0';
      while (c) { tmp[t++] = '0' + (c % 10); c /= 10; }
      while (t) out[o++] = tmp[--t];
    }
    out[o++] = '\n';
  }
  return o;
}

/* Random subsetting (-ss, src/glistcompare.c:719-787) over raw record
 * streams. glibc's srand48/drand48 here IS the reference's PRNG, so
 * the selection stream is bit-exact by construction. Unlike the
 * reference, the walk stops at the end of the list (the reference's
 * while(out>0) runs past it — undefined behavior — whenever a single
 * pass cannot satisfy the requested size). method: 0 rand,
 * 1 rand_unique, 2 rand_weighted_unique. Returns records written. */
long fgx_subset (const unsigned char *recs, long n_words,
                 unsigned long long sum_counts, int method,
                 unsigned long long size, long seed,
                 unsigned char *out, unsigned long long *total_out)
{
  unsigned long long in_n, out_n = size, tot = 0;
  long i = 0, m = 0;
  srand48 (seed);
  if (method == 0) {
    in_n = sum_counts;
    while (out_n > 0 && i < n_words) {
      unsigned long long w;
      unsigned int c, cnt = 0, j;
      rec_get (recs, i, &w, &c);
      for (j = 0; j < c && out_n > 0; j++) {
        double val = drand48 ();
        if (val <= (double) out_n / in_n) { cnt++; out_n--; }
        in_n--;
      }
      if (cnt) { put_rec (out, m, w, cnt); m++; tot += cnt; }
      i++;
    }
  } else if (method == 1) {
    in_n = (unsigned long long) n_words;
    while (out_n > 0 && i < n_words) {
      unsigned long long w;
      unsigned int c;
      double val = drand48 ();
      rec_get (recs, i, &w, &c);
      if (val <= (double) out_n / in_n) {
        put_rec (out, m, w, c); m++; tot += c; out_n--;
      }
      in_n--;
      i++;
    }
  } else {
    in_n = sum_counts;
    while (out_n > 0 && i < n_words) {
      unsigned long long w;
      unsigned int c;
      double val = drand48 ();
      rec_get (recs, i, &w, &c);
      if (val <= (double) c * out_n / in_n) {
        put_rec (out, m, w, c); m++; tot += c; out_n--;
      }
      in_n -= c;
      i++;
    }
  }
  *total_out = tot;
  return m;
}

static long put_uint (unsigned char *out, unsigned long long v)
{
  char tmp[24];
  int t = 0;
  long o = 0;
  if (v == 0) tmp[t++] = '0';
  while (v) { tmp[t++] = '0' + (int) (v % 10); v /= 10; }
  while (t) out[o++] = tmp[--t];
  return o;
}


/* Same dump, but straight off the mmapped .index blobs: interleaved
 * (word, loc_start) k-mer records and raw u64 location codes
 * (file << (sb+pb+1) | subseq << (pb+1) | pos << 1 | dir,
 * src/index-map.h:60-83). Folds the field decode into the formatter so
 * the caller passes no per-location temporaries. end_start bounds the
 * last word's block (next chunk's loc_start, or the header's
 * num_locations for the final chunk — src/index-map.c:128-139
 * semantics). Returns bytes written. */
long fgx_dump_index_locations_raw (const unsigned long long *recs,
                                   long n_words,
                                   unsigned long long end_start, int k,
                                   const unsigned long long *locs,
                                   int fb, int sb, int pb,
                                   unsigned char *out)
{
  static const char NUCL[4] = { 'A', 'C', 'G', 'T' };
  const unsigned long long pmask = (pb >= 64) ? ~0ULL : ((1ULL << pb) - 1);
  const unsigned long long smask = (sb >= 64) ? ~0ULL : ((1ULL << sb) - 1);
  const unsigned long long fmask = (fb >= 64) ? ~0ULL : ((1ULL << fb) - 1);
  long i, o = 0;
  for (i = 0; i < n_words; i++) {
    unsigned long long word = recs[2 * i];
    unsigned long long s = recs[2 * i + 1];
    unsigned long long e = (i + 1 < n_words) ? recs[2 * i + 3] : end_start;
    int j;
    for (j = k - 1; j >= 0; j--)
      out[o + j] = NUCL[(word >> (2 * (k - 1 - j))) & 3];
    o += k;
    out[o++] = '\t';
    o += put_uint (out + o, (unsigned int) (e - s));
    out[o++] = '\n';
    for (; s < e; s++) {
      unsigned long long c = locs[s];
      o += put_uint (out + o, (c >> (sb + pb + 1)) & fmask);
      out[o++] = '\t';
      o += put_uint (out + o, (c >> (pb + 1)) & smask);
      out[o++] = '\t';
      o += put_uint (out + o, (c >> 1) & pmask);
      out[o++] = '\t';
      o += put_uint (out + o, c & 1);
      out[o++] = '\n';
    }
  }
  return o;
}

/* ------------------------------------------------------------------ */
/* list statistics (glistquery --gc)                                   */
/* ------------------------------------------------------------------ */

/* One pass over raw 12-byte records: GC-weighted base count and count
 * sum (a base is G or C iff its two bits differ; popcount of the
 * even-position difference mask counts them per word). */
void fgx_gc_rec (const unsigned char *r, long n,
                 unsigned long long *gc_total,
                 unsigned long long *count_total)
{
  long i;
  unsigned long long gt = 0, ct = 0;
  for (i = 0; i < n; i++) {
    unsigned long long w;
    unsigned int c;
    __builtin_memcpy (&w, r + 12 * i, 8);
    __builtin_memcpy (&c, r + 12 * i + 8, 4);
    gt += (unsigned long long) __builtin_popcountll (
      (w ^ (w >> 1)) & 0x5555555555555555ULL) * c;
    ct += c;
  }
  *gc_total = gt;
  *count_total = ct;
}

/* Iterative median-search twin of src/glistquery.c:814-892 over raw
 * 12-byte records. One min/max pass; when the count range is small a
 * prefix-summed histogram answers every bisection step from one more
 * pass (identical above/below/equal integers to per-step scans),
 * otherwise each step rescans like the reference. */
void fgx_median_rec (const unsigned char *r, long n,
                     unsigned int *out_min, unsigned int *out_max,
                     unsigned int *out_med)
{
  unsigned long long mn, mx, med;
  unsigned int gmin = 0xFFFFFFFFu, gmax = 0;
  long i;
  for (i = 0; i < n; i++) {
    unsigned int c;
    __builtin_memcpy (&c, r + 12 * i + 8, 4);
    if (c < gmin) gmin = c;
    if (c > gmax) gmax = c;
  }
  if (!n) { gmin = 0xFFFFFFFFu; gmax = 0; }
  *out_min = gmin;
  *out_max = gmax;
  mn = gmin;
  mx = gmax;
  med = (mn + mx) / 2;
  if (n && (unsigned long long) gmax - gmin <= (1ULL << 22)) {
    long range = (long) (gmax - gmin) + 1;
    long long *pre = (long long *) calloc (range + 1, sizeof (long long));
    for (i = 0; i < n; i++) {
      unsigned int c;
      __builtin_memcpy (&c, r + 12 * i + 8, 4);
      pre[c - gmin + 1] += 1;
    }
    for (i = 1; i <= range; i++) pre[i] += pre[i - 1];
    while (mx > mn) {
      /* med is always within [gmin, gmax] here */
      long long below = pre[med - gmin];
      long long atmost = pre[med - gmin + 1];
      long long above = n - atmost;
      long long equal = atmost - below;
      if (mx == mn + 1) {
        if (above > below + equal) med = mx;
        break;
      }
      if (above > below) {
        if (above - below < equal) break;
        mn = med;
      } else if (below > above) {
        if (below - above < equal) break;
        mx = med;
      } else break;
      med = (mn + mx) / 2;
    }
    free (pre);
  } else {
    while (mx > mn) {
      long long above = 0, below = 0, equal;
      for (i = 0; i < n; i++) {
        unsigned int c;
        __builtin_memcpy (&c, r + 12 * i + 8, 4);
        above += c > med;
        below += c < med;
      }
      equal = n - above - below;
      if (mx == mn + 1) {
        if (above > below + equal) med = mx;
        break;
      }
      if (above > below) {
        if (above - below < equal) break;
        mn = med;
      } else if (below > above) {
        if (below - above < equal) break;
        mx = med;
      } else break;
      med = (mn + mx) / 2;
    }
  }
  *out_med = (unsigned int) med;
}

/* Count histogram for glistquery --distribution: hist[min(c, max_v)]++
 * (caller sizes hist as max_v+1 u64 slots, zeroed). */
void fgx_distro_rec (const unsigned char *r, long n,
                     unsigned long long max_v, unsigned long long *hist)
{
  long i;
  for (i = 0; i < n; i++) {
    unsigned int c;
    __builtin_memcpy (&c, r + 12 * i + 8, 4);
    hist[c < max_v ? c : max_v] += 1;
  }
}

/* ------------------------------------------------------------------ */
/* resumable two-list set operations (glistcompare host path)          */
/* ------------------------------------------------------------------ */

/* Chunked twin of fastgt_exact.c:fgx_pair_ops_rec (same include_in_*
 * semantics, src/glistcompare.c:433-496): the zipper suspends whenever
 * an active op's chunk buffer fills, so outputs stream to the .list
 * writers in bounded memory and the file writes overlap the next
 * chunk's merge work (the Python side double-buffers). */

static void rec_get (const unsigned char *r, long i,
                     unsigned long long *w, unsigned int *c)
{
  __builtin_memcpy (w, r + 12 * i, 8);
  __builtin_memcpy (c, r + 12 * i + 8, 4);
}

typedef struct {
  const unsigned char *r1, *r2;
  long n1, n2, i, j;
  int r_u, r_i, r_d;
  unsigned int cutoff, override_;
  int subtract;
  int active[4];                /* union, intrsec, diff1, diff2 */
} FgxPairStream;

static unsigned int pair_rule_freq (unsigned int f1, unsigned int f2,
                                    int rule, unsigned int override_)
{
  switch (rule) {
  case 1: return f1 + f2;
  case 2: return (f1 > f2) ? f1 - f2 : 0;
  case 3: return (f1 < f2) ? f1 : f2;
  case 4: return (f1 > f2) ? f1 : f2;
  case 5: return f1;
  case 6: return f2;
  case 7: return override_;
  default: return 0;
  }
}

void *fgx_pair_stream_start (const unsigned char *r1, long n1,
                             const unsigned char *r2, long n2, int rule,
                             unsigned int cutoff, unsigned int override_,
                             int subtract, int a_u, int a_i, int a_d1,
                             int a_d2)
{
  FgxPairStream *st = (FgxPairStream *) calloc (1, sizeof (*st));
  if (!st) return NULL;
  st->r1 = r1; st->n1 = n1; st->r2 = r2; st->n2 = n2;
  st->r_u = (rule == 0) ? 1 : rule;
  st->r_i = (rule == 0) ? 3 : rule;
  st->r_d = (rule == 0) ? 2 : rule;
  st->cutoff = cutoff; st->override_ = override_; st->subtract = subtract;
  st->active[0] = a_u; st->active[1] = a_i;
  st->active[2] = a_d1; st->active[3] = a_d2;
  return st;
}

/* Fills the active op buffers with up to cap records each.  n_out[4]
 * gets per-op record counts, sums[4] per-op count sums.  Returns 1
 * while input remains, 0 when exhausted. */
int fgx_pair_stream_next (void *handle, unsigned char *bu,
                          unsigned char *bi, unsigned char *bd1,
                          unsigned char *bd2, long cap, long *n_out,
                          unsigned long long *sums)
{
  FgxPairStream *st = (FgxPairStream *) handle;
  unsigned char *bufs[4] = { bu, bi, bd1, bd2 };
  long k_[4] = { 0, 0, 0, 0 };
  unsigned long long s_[4] = { 0, 0, 0, 0 };
  long i = st->i, j = st->j;
  const unsigned char *r1 = st->r1, *r2 = st->r2;
  long n1 = st->n1, n2 = st->n2;
  unsigned int cutoff = st->cutoff;
  while (i < n1 || j < n2) {
    /* suspend when any active buffer is full */
    if ((st->active[0] && k_[0] >= cap) || (st->active[1] && k_[1] >= cap)
        || (st->active[2] && k_[2] >= cap)
        || (st->active[3] && k_[3] >= cap))
      break;
    unsigned long long w, wa = 0, wb = 0;
    unsigned int f1 = 0, f2 = 0, ca = 0, cb = 0;
    if (i < n1) rec_get (r1, i, &wa, &ca);
    if (j < n2) rec_get (r2, j, &wb, &cb);
    if (i < n1 && (j >= n2 || wa <= wb)) {
      w = wa; f1 = ca;
      if (j < n2 && wb == w) { f2 = cb; j++; }
      i++;
    } else {
      w = wb; f2 = cb; j++;
    }
    {
      unsigned int ge1 = f1 >= cutoff, ge2 = f2 >= cutoff;
      unsigned int p1 = f1 > 0, p2 = f2 > 0;
      if (st->active[0]) {
        unsigned int fr = pair_rule_freq (f1, f2, st->r_u, st->override_);
        if ((ge1 || ge2) && fr) {
          put_rec (bufs[0], k_[0], w, fr); k_[0]++; s_[0] += fr;
        }
      }
      if (st->active[1]) {
        unsigned int fr = pair_rule_freq (f1, f2, st->r_i, st->override_);
        if (p1 && p2 && ge1 && ge2 && fr) {
          put_rec (bufs[1], k_[1], w, fr); k_[1]++; s_[1] += fr;
        }
      }
      if (st->active[2]) {
        if (st->subtract) {
          if (p1 && p2 && (f1 == f2) && ge1) {
            put_rec (bufs[2], k_[2], w, f1); k_[2]++; s_[2] += f1;
          }
        } else {
          unsigned int fr = pair_rule_freq (f1, f2, st->r_d, st->override_);
          if (p1 && ge1 && !ge2 && fr) {
            put_rec (bufs[2], k_[2], w, fr); k_[2]++; s_[2] += fr;
          }
        }
      }
      if (st->active[3]) {
        unsigned int fr = pair_rule_freq (f2, f1, st->r_d, st->override_);
        if (p2 && ge2 && !ge1 && fr) {
          put_rec (bufs[3], k_[3], w, fr); k_[3]++; s_[3] += fr;
        }
      }
    }
  }
  st->i = i; st->j = j;
  int more = (i < n1 || j < n2);
  int t;
  for (t = 0; t < 4; t++) { n_out[t] = k_[t]; sums[t] = s_[t]; }
  return more;
}

void fgx_pair_stream_free (void *handle) { free (handle); }

/* one-pass 4-output zipper, defined in fastgt_exact.c */
void fgx_pair_ops_rec (const unsigned char *r1, long n1,
                       const unsigned char *r2, long n2, int rule,
                       unsigned int cutoff, unsigned int override_,
                       int subtract,
                       unsigned char *ou, long *n_u,
                       unsigned long long *s_u,
                       unsigned char *oi, long *n_i,
                       unsigned long long *s_i,
                       unsigned char *od1, long *n_d1,
                       unsigned long long *s_d1,
                       unsigned char *od2, long *n_d2,
                       unsigned long long *s_d2);

/* OpenMP bucket-parallel pair ops: both inputs are pre-cut at
 * IDENTICAL word boundaries (merge-path rank select on the Python
 * side), every bucket runs the same one-pass zipper independently, and
 * outputs land in per-bucket regions of caller-provided buffers whose
 * bucket-order concatenation is byte-identical to the sequential scan
 * (parallelism moves only WHERE a record is computed, never its value
 * or order). cuts1/cuts2: long[n_buckets+1]; per active op X:
 * bufX capacity 12*(span1+span2) bytes per bucket laid out
 * back-to-back at offX[b] = 12*(cuts1[b]+cuts2[b] - cuts1[0]-cuts2[0]),
 * outputs nX[b] records and sumX[b]. */
void fgx_pair_ops_buckets (const unsigned char *r1, const unsigned char *r2,
                           const long *cuts1, const long *cuts2,
                           int n_buckets, int rule, unsigned int cutoff,
                           unsigned int override_, int subtract,
                           unsigned char *bu, long *n_u,
                           unsigned long long *s_u,
                           unsigned char *bi, long *n_i,
                           unsigned long long *s_i,
                           unsigned char *bd1, long *n_d1,
                           unsigned long long *s_d1,
                           unsigned char *bd2, long *n_d2,
                           unsigned long long *s_d2)
{
  int b;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (b = 0; b < n_buckets; b++) {
    long a1 = cuts1[b], z1 = cuts1[b + 1];
    long a2 = cuts2[b], z2 = cuts2[b + 1];
    long off = 12 * ((a1 - cuts1[0]) + (a2 - cuts2[0]));
    fgx_pair_ops_rec (r1 + 12 * a1, z1 - a1, r2 + 12 * a2, z2 - a2,
                      rule, cutoff, override_, subtract,
                      bu ? bu + off : 0, n_u ? n_u + b : 0,
                      s_u ? s_u + b : 0,
                      bi ? bi + off : 0, n_i ? n_i + b : 0,
                      s_i ? s_i + b : 0,
                      bd1 ? bd1 + off : 0, n_d1 ? n_d1 + b : 0,
                      s_d1 ? s_d1 + b : 0,
                      bd2 ? bd2 + off : 0, n_d2 ? n_d2 + b : 0,
                      s_d2 ? s_d2 + b : 0);
  }
}

/* ------------------------------------------------------------------ */
/* resumable N-list union/intersection (glistcompare multi host path)  */
/* ------------------------------------------------------------------ */

/* Streaming k-way merge over N sorted unique record streams with the
 * reference's combination semantics (src/glistcompare.c:500-717):
 * per word, the rule combines counts over the lists CONTAINING it
 * (ADD with u32 wrap / MIN / MAX / NUMBER override), the cutoff
 * applies to the combined frequency, and intersection additionally
 * requires presence in every list. */

/* Union path: cascaded binary merge tree.  The flat one-pass loop
 * (kept below for intersection and the n==1 degenerate) pays a
 * min-scan over all N stream heads per unique output word — a long
 * serial dependency chain (load head -> SIMD min reduce -> compare)
 * that measured 0.6x the reference's scalar cursor loop at 8x4M
 * lists.  The tree instead runs log2(N) levels of branch-light 2-way
 * merges (~6 cycles/record/level, cmov-selected), with each internal
 * node refilling a 32K-record buffer on demand so every intermediate
 * level stays cache-resident: only the leaf reads and the final
 * output touch DRAM.  ADD (u32 wrap), MIN and MAX are associative, so
 * pairwise combining is exact; NUMBER ignores intermediate counts and
 * overrides at the root, where the cutoff is also applied — identical
 * combination semantics to the reference's per-word head scan
 * (src/glistcompare.c:544-592) on strictly-sorted unique lists, which
 * is what valid .list files are. */

#define MNODE_CAP 32768        /* records per node buffer (384 KB) */

struct FgxMNode;

typedef struct FgxMSrc {
  const unsigned char *base;   /* stream records base, or node buf */
  long len;                    /* stream: total records; node: fill */
  long pos;
  struct FgxMNode *node;       /* NULL => raw input stream */
  int done;                    /* node source: children exhausted */
} FgxMSrc;

typedef struct FgxMNode {
  FgxMSrc a, b;
  unsigned char *buf;          /* MNODE_CAP records */
} FgxMNode;

typedef struct {
  const unsigned char **streams;
  long *lens;
  long *pos;
  unsigned long long *head_w;   /* cached head word per stream */
  unsigned int *head_c;         /* cached head count */
  int n;
  int n_active;                 /* union path: live (non-exhausted)
                                 * stream count; exhausted streams are
                                 * compacted past this index */
  int intersect;
  int rule;                     /* 1 ADD, 3 MIN, 4 MAX, 7 NUMBER */
  unsigned int cutoff, override_;
  int tree;                     /* union n>=2: merge tree active */
  FgxMNode *nodes;
  unsigned char *arena;         /* node buffers */
  FgxMSrc root_a, root_b;       /* the root merge's two sources */
} FgxMulti;

static long mnode_fill (FgxMNode *nd, int rule);

/* make sure the source has a readable head; refill node buffers on
 * demand.  Returns 0 when the source is permanently exhausted. */
static int msrc_ensure (FgxMSrc *s, int rule)
{
  if (s->pos < s->len) return 1;
  if (!s->node || s->done) return 0;
  s->len = mnode_fill (s->node, rule);
  s->pos = 0;
  if (s->len == 0) { s->done = 1; return 0; }
  return 1;
}

/* branch-light 2-way merge of one buffer-bounded run; combines equal
 * words with COMBINE (equality is rare on real k-mer lists, so the
 * branch predicts; everything else is cmov-selected) */
#define FGX_MERGE_RUN(COMBINE)                                          \
  while (m < cap && i < ea && j < eb) {                                 \
    unsigned long long wa, wb, w;                                      \
    unsigned int ca, cb, c, eqm;                                       \
    int le, ge;                                                        \
    __builtin_memcpy (&wa, ap + 12 * i, 8);                            \
    __builtin_memcpy (&ca, ap + 12 * i + 8, 4);                        \
    __builtin_memcpy (&wb, bp + 12 * j, 8);                            \
    __builtin_memcpy (&cb, bp + 12 * j + 8, 4);                        \
    le = (wa <= wb); ge = (wa >= wb);                                  \
    w = le ? wa : wb;                                                  \
    c = le ? ca : cb;                                                  \
    eqm = (unsigned int) -(le & ge);  /* arithmetic mask: a data-      \
                                       * dependent equality branch     \
                                       * mispredicts ~50% here */      \
    c = (c & ~eqm) | ((unsigned int) (COMBINE) & eqm);                 \
    __builtin_memcpy (out + 12 * m, &w, 8);                            \
    __builtin_memcpy (out + 12 * m + 8, &c, 4);                        \
    m++; i += le; j += ge;                                             \
  }

/* refill an internal node's buffer from its two children (no cutoff:
 * that applies only at the root, on the fully combined frequency) */
static long mnode_fill (FgxMNode *nd, int rule)
{
  unsigned char *out = nd->buf;
  long m = 0;
  const long cap = MNODE_CAP;
  FgxMSrc *A = &nd->a, *B = &nd->b;
  while (m < cap) {
    int ha = msrc_ensure (A, rule), hb = msrc_ensure (B, rule);
    if (ha && hb) {
      const unsigned char *ap = A->base, *bp = B->base;
      long i = A->pos, ea = A->len, j = B->pos, eb = B->len;
      switch (rule) {
      case 3:  FGX_MERGE_RUN (ca < cb ? ca : cb); break;
      case 4:  FGX_MERGE_RUN (ca > cb ? ca : cb); break;
      default: FGX_MERGE_RUN (ca + cb); break;  /* ADD u32 wrap; rule
                                                 * NUMBER's intermediate
                                                 * counts are dead */
      }
      A->pos = i; B->pos = j;
    } else if (ha || hb) {
      FgxMSrc *S = ha ? A : B;
      long take = S->len - S->pos;
      if (take > cap - m) take = cap - m;
      memcpy (out + 12 * m, S->base + 12 * S->pos, 12 * take);
      m += take; S->pos += take;
    } else {
      break;
    }
  }
  return m;
}

/* build a balanced source tree over input streams [lo, hi) */
static FgxMSrc mtree_build (const unsigned char **streams,
                            const long *lens, int lo, int hi,
                            FgxMNode **next_node, unsigned char **arena)
{
  FgxMSrc s;
  if (hi - lo == 1) {
    s.base = streams[lo];
    s.len = lens[lo];
    s.pos = 0;
    s.node = NULL;
    s.done = 0;
    return s;
  }
  {
    FgxMNode *nd = (*next_node)++;
    int mid = lo + (hi - lo) / 2;
    nd->buf = *arena;
    *arena += 12L * MNODE_CAP;
    nd->a = mtree_build (streams, lens, lo, mid, next_node, arena);
    nd->b = mtree_build (streams, lens, mid, hi, next_node, arena);
    s.base = nd->buf;
    s.len = 0;
    s.pos = 0;
    s.node = nd;
    s.done = 0;
    return s;
  }
}

static void multi_load_head (FgxMulti *st, int s)
{
  if (st->pos[s] < st->lens[s]) {
    __builtin_memcpy (&st->head_w[s], st->streams[s] + 12 * st->pos[s], 8);
    __builtin_memcpy (&st->head_c[s], st->streams[s] + 12 * st->pos[s] + 8,
                      4);
  } else {
    st->head_w[s] = 0xFFFFFFFFFFFFFFFFULL;  /* exhausted sentinel */
    st->head_c[s] = 0;
  }
}

/* swap exhausted stream s out of the union-path active prefix (a true
 * swap: the intersect path iterates all n streams and must still see
 * every entry) */
static void multi_swap_out (FgxMulti *st, int s)
{
  int a = --st->n_active;
  const unsigned char *tsp = st->streams[s];
  long tl = st->lens[s], tp = st->pos[s];
  unsigned long long tw = st->head_w[s];
  unsigned int tc = st->head_c[s];
  st->streams[s] = st->streams[a]; st->streams[a] = tsp;
  st->lens[s] = st->lens[a]; st->lens[a] = tl;
  st->pos[s] = st->pos[a]; st->pos[a] = tp;
  st->head_w[s] = st->head_w[a]; st->head_w[a] = tw;
  st->head_c[s] = st->head_c[a]; st->head_c[a] = tc;
}

void *fgx_multi_stream_start (const unsigned char **streams,
                              const long *lens, int n, int intersect,
                              int rule, unsigned int cutoff,
                              unsigned int override_)
{
  FgxMulti *st = (FgxMulti *) calloc (1, sizeof (*st));
  if (!st) return NULL;
  int n_pad = (n + 3) & ~3;     /* head_w padded to a 4-lane multiple
                                 * (AVX2 union scan); pad lanes hold the
                                 * exhausted sentinel forever */
  st->streams = (const unsigned char **) malloc (n * sizeof (void *));
  st->lens = (long *) malloc (n * sizeof (long));
  st->pos = (long *) calloc (n, sizeof (long));
  st->head_w = (unsigned long long *) malloc (n_pad * sizeof (long long));
  st->head_c = (unsigned int *) malloc (n * sizeof (int));
  if (!st->streams || !st->lens || !st->pos || !st->head_w
      || !st->head_c) {
    free (st->streams); free (st->lens); free (st->pos);
    free (st->head_w); free (st->head_c); free (st);
    return NULL;
  }
  memcpy (st->streams, streams, n * sizeof (void *));
  memcpy (st->lens, lens, n * sizeof (long));
  st->n = n;
  st->intersect = intersect;
  st->rule = rule;
  st->cutoff = cutoff;
  st->override_ = override_;
  {
    int s;
    for (s = 0; s < n; s++) multi_load_head (st, s);
    for (s = n; s < n_pad; s++) st->head_w[s] = 0xFFFFFFFFFFFFFFFFULL;
    /* compact empty streams out of the union-path active prefix
     * (reference union_multi skips num_words==0 sources at setup,
     * src/glistcompare.c:525-531) */
    st->n_active = n;
    s = 0;
    while (s < st->n_active) {
      if (st->lens[s] == 0) multi_swap_out (st, s);
      else s++;
    }
  }
  if (!intersect && n >= 2) {
    /* union: cascaded binary merge tree (see above).  n-2 internal
     * nodes (the root merge streams straight into the caller's
     * buffer, so it owns no node). */
    int n_nodes = n - 2;
    FgxMNode *np;
    unsigned char *ap;
    st->nodes = (FgxMNode *) malloc ((n_nodes > 0 ? n_nodes : 1)
                                     * sizeof (FgxMNode));
    st->arena = (unsigned char *) (n_nodes > 0
                                   ? malloc (12L * MNODE_CAP * n_nodes)
                                   : NULL);
    if (!st->nodes || (n_nodes > 0 && !st->arena)) {
      free (st->nodes); free (st->arena);
      free (st->streams); free (st->lens); free (st->pos);
      free (st->head_w); free (st->head_c); free (st);
      return NULL;
    }
    np = st->nodes;
    ap = st->arena;
    {
      int mid = n / 2;
      st->root_a = mtree_build (st->streams, st->lens, 0, mid, &np, &ap);
      st->root_b = mtree_build (st->streams, st->lens, mid, n, &np, &ap);
    }
    st->tree = 1;
  }
  return st;
}

int fgx_multi_stream_next (void *handle, unsigned char * restrict buf,
                           long cap, long *n_out,
                           unsigned long long *sum_out)
{
  FgxMulti *st = (FgxMulti *) handle;
  long m = 0;
  unsigned long long tot = 0;
  int s;
  if (st->tree) {
    /* root of the union merge tree: same 2-way merge as the internal
     * nodes plus the cutoff/override applied to the final combined
     * frequency (src/glistcompare.c:573-583 semantics) */
    FgxMSrc *A = &st->root_a, *B = &st->root_b;
    unsigned char * restrict out = buf;
    const int rule = st->rule;
    const unsigned int cutoff = st->cutoff, override_ = st->override_;
    while (m < cap) {
      int ha = msrc_ensure (A, rule), hb = msrc_ensure (B, rule);
      if (ha && hb) {
        const unsigned char *ap = A->base, *bp = B->base;
        long i = A->pos, ea = A->len, j = B->pos, eb = B->len;
        while (m < cap && i < ea && j < eb) {
          unsigned long long wa, wb, w;
          unsigned int ca, cb, c, fr;
          int le, ge;
          __builtin_memcpy (&wa, ap + 12 * i, 8);
          __builtin_memcpy (&ca, ap + 12 * i + 8, 4);
          __builtin_memcpy (&wb, bp + 12 * j, 8);
          __builtin_memcpy (&cb, bp + 12 * j + 8, 4);
          le = (wa <= wb); ge = (wa >= wb);
          w = le ? wa : wb;
          c = le ? ca : cb;
          {
            unsigned int comb = (rule == 3) ? (ca < cb ? ca : cb) :
                                (rule == 4) ? (ca > cb ? ca : cb) :
                                ca + cb;
            unsigned int eqm = (unsigned int) -(le & ge);
            c = (c & ~eqm) | (comb & eqm);
          }
          fr = (rule == 7) ? override_ : c;
          if (fr >= cutoff) {
            __builtin_memcpy (out + 12 * m, &w, 8);
            __builtin_memcpy (out + 12 * m + 8, &fr, 4);
            tot += fr;
            m++;
          }
          i += le; j += ge;
        }
        A->pos = i; B->pos = j;
      } else if (ha || hb) {
        FgxMSrc *S = ha ? A : B;
        const unsigned char *sp = S->base;
        long i = S->pos, e = S->len;
        while (m < cap && i < e) {
          unsigned long long w;
          unsigned int c, fr;
          __builtin_memcpy (&w, sp + 12 * i, 8);
          __builtin_memcpy (&c, sp + 12 * i + 8, 4);
          fr = (rule == 7) ? override_ : c;
          if (fr >= cutoff) {
            __builtin_memcpy (out + 12 * m, &w, 8);
            __builtin_memcpy (out + 12 * m + 8, &fr, 4);
            tot += fr;
            m++;
          }
          i++;
        }
        S->pos = i;
      } else {
        *n_out = m;
        *sum_out = tot;
        return 0;
      }
    }
    *n_out = m;
    *sum_out = tot;
    return 1;
  }
  if (st->intersect) {
    /* reference-shaped max-chase (src/glistcompare.c:628-704): no
     * intersection word can lie beyond ANY exhausted list, so finish
     * on first exhaustion instead of draining every stream, and
     * advance laggards with a tight pointer-bump loop instead of a
     * min-scan per unique word (9x on disjoint-ish inputs; the result
     * SET is loop-shape independent, locked by the differential
     * tests). */
    int done = 0;
    while (m < cap && !done) {
      unsigned long long word = 0;
      int equal = 1;
      for (s = 0; s < st->n; s++) {
        if (st->pos[s] >= st->lens[s]) { done = 1; break; }
        if (st->head_w[s] > word) word = st->head_w[s];
      }
      if (done) break;
      for (s = 0; s < st->n && !done; s++) {
        while (st->head_w[s] < word) {
          st->pos[s]++;
          if (st->pos[s] >= st->lens[s]) { done = 1; break; }
          multi_load_head (st, s);
        }
        if (!done && st->head_w[s] > word) { equal = 0; break; }
      }
      if (done || !equal) continue;
      {
        unsigned int f_add = 0, f_min = 0xFFFFFFFFu, f_max = 0, fr;
        for (s = 0; s < st->n; s++) {
          unsigned int c = st->head_c[s];
          f_add += c;                    /* u32 wrap */
          if (c < f_min) f_min = c;
          if (c > f_max) f_max = c;
        }
        fr = (st->rule == 1) ? f_add :
             (st->rule == 3) ? f_min :
             (st->rule == 4) ? f_max : st->override_;
        if (fr >= st->cutoff) {
          put_rec (buf, m, word, fr);
          tot += fr;
          m++;
        }
        for (s = 0; s < st->n; s++) {
          st->pos[s]++;
          if (st->pos[s] < st->lens[s]) multi_load_head (st, s);
        }
      }
    }
    *n_out = m;
    *sum_out = tot;
    return !done;
  }
  /* union, n==1 degenerate only (n>=2 takes the merge tree above):
   * ONE scan per unique word over the live streams (the reference's
   * union_multi loop shape, src/glistcompare.c:544-592), with a
   * galloping single-source fast path.  A wider AVX2 head-scan variant
   * of this loop existed through round 3; it measured 0.6x the
   * reference at 8x4M lists (serial load->min-reduce->compare chain
   * per word) and was superseded by the cascaded 2-way merge tree. */
  {
    unsigned long long word;
    int na = st->n_active;
    if (na == 0 || m >= cap) { *n_out = m; *sum_out = tot; return na > 0; }
    word = st->head_w[0];
    for (s = 1; s < na; s++)
      if (st->head_w[s] < word) word = st->head_w[s];
    while (m < cap && na) {
      unsigned long long next = 0xFFFFFFFFFFFFFFFFULL;
      unsigned long long next2 = 0xFFFFFFFFFFFFFFFFULL;
      int src_next = -1, n_next = 0;
      unsigned int f_add = 0, f_min = 0xFFFFFFFFu, f_max = 0, fr;
      s = 0;
      while (s < na) {
        unsigned long long hw = st->head_w[s];
        if (hw == word) {
          unsigned int c = st->head_c[s];
          f_add += c;                    /* u32 wrap */
          if (c < f_min) f_min = c;
          if (c > f_max) f_max = c;
          st->pos[s]++;
          if (st->pos[s] >= st->lens[s]) {
            multi_swap_out (st, s);
            na = st->n_active;
            continue;                    /* swapped-in entry re-checks */
          }
          multi_load_head (st, s);
          hw = st->head_w[s];
        }
        if (hw < next) {
          next2 = next;
          next = hw; src_next = s; n_next = 1;
        } else if (hw == next) {
          n_next++;
        } else if (hw < next2) {
          next2 = hw;
        }
        s++;
      }
      fr = (st->rule == 1) ? f_add :
           (st->rule == 3) ? f_min :
           (st->rule == 4) ? f_max : st->override_;
      if (fr >= st->cutoff) {
        put_rec (buf, m, word, fr);
        tot += fr;
        m++;
      }
      if (n_next == 1) {
        /* gallop: every record of stream src_next below next2 is
         * single-source (each stream's head is its minimum remaining
         * word, so no other stream can contain a word < next2 beyond
         * its head); combined frequency = own count (ADD=MIN=MAX) or
         * the override (NUMBER) */
        const unsigned char *sp = st->streams[src_next];
        long p = st->pos[src_next], e = st->lens[src_next];
        while (m < cap && p < e) {
          unsigned long long w;
          unsigned int c;
          __builtin_memcpy (&w, sp + 12 * p, 8);
          if (w >= next2) break;
          __builtin_memcpy (&c, sp + 12 * p + 8, 4);
          fr = (st->rule == 7) ? st->override_ : c;
          if (fr >= st->cutoff) {
            put_rec (buf, m, w, fr);
            tot += fr;
            m++;
          }
          p++;
        }
        st->pos[src_next] = p;
        if (p >= e) {
          multi_swap_out (st, src_next);
          na = st->n_active;
        } else {
          multi_load_head (st, src_next);
        }
        word = next2;                    /* heads are all >= next2 now;
                                          * if the gallop stopped on a
                                          * full buffer instead, the
                                          * loop exits and the next
                                          * call re-derives the min */
        continue;
      }
      word = next;
    }
    *n_out = m;
    *sum_out = tot;
    return st->n_active > 0;
  }
}

void fgx_multi_stream_free (void *handle)
{
  FgxMulti *st = (FgxMulti *) handle;
  if (!st) return;
  free (st->nodes);
  free (st->arena);
  free (st->streams);
  free (st->lens);
  free (st->pos);
  free (st->head_w);
  free (st->head_c);
  free (st);
}

/* ------------------------------------------------------------------ */
/* k-way merge of sorted (word, count) record shards                   */
/* ------------------------------------------------------------------ */

/* Streams S sorted unique record shards (12-byte records each) into a
 * single sorted unique record stream, summing counts of equal words
 * (u32 wrap, matching union rule ADD) and applying the cutoff window.
 * The role of the reference's gt4_write_union (set-operations.c:40-129)
 * without its fd streaming: shards here are host arrays (RAM or mmap).
 * Returns the record count. */
long fgx_merge_rec_shards (const unsigned char **shards, const long *lens,
                           int n_shards,
                           unsigned int min_count, unsigned int max_count,
                           unsigned char *records,
                           unsigned long long *total_count)
{
  long m = 0;
  unsigned long long tot = 0;
  if (n_shards <= 0) { *total_count = 0; return 0; }
  if (n_shards == 1) {
    const unsigned char *sp = shards[0];
    long p, e = lens[0];
    for (p = 0; p < e; p++) {
      unsigned long long w;
      unsigned int c;
      __builtin_memcpy (&w, sp + 12 * p, 8);
      __builtin_memcpy (&c, sp + 12 * p + 8, 4);
      if (c >= min_count && c <= max_count) {
        put_rec (records, m, w, c);
        tot += c;
        m++;
      }
    }
    *total_count = tot;
    return m;
  }
  /* cascaded binary merge tree, same machinery as the N-list union:
   * spill shards each cover the full word range, so their heads
   * interleave like random streams and the per-word head scan this
   * replaces paid a serial min-reduce chain per output word */
  {
    int n_nodes = n_shards - 2;
    FgxMNode *nodes = (FgxMNode *) malloc ((n_nodes > 0 ? n_nodes : 1)
                                           * sizeof (FgxMNode));
    unsigned char *arena = (unsigned char *)
      (n_nodes > 0 ? malloc (12L * MNODE_CAP * n_nodes) : NULL);
    FgxMNode *np = nodes;
    unsigned char *ap = arena;
    FgxMSrc ra, rb;
    if (!nodes || (n_nodes > 0 && !arena)) {
      free (nodes); free (arena);
      return -1;
    }
    {
      int mid = n_shards / 2;
      ra = mtree_build (shards, lens, 0, mid, &np, &ap);
      rb = mtree_build (shards, lens, mid, n_shards, &np, &ap);
    }
    for (;;) {
      int ha = msrc_ensure (&ra, 1), hb = msrc_ensure (&rb, 1);
      if (ha && hb) {
        const unsigned char *a_ = ra.base, *b_ = rb.base;
        long i = ra.pos, ea = ra.len, j = rb.pos, eb = rb.len;
        while (i < ea && j < eb) {
          unsigned long long wa, wb, w;
          unsigned int ca, cb, c, eqm;
          int le, ge;
          __builtin_memcpy (&wa, a_ + 12 * i, 8);
          __builtin_memcpy (&ca, a_ + 12 * i + 8, 4);
          __builtin_memcpy (&wb, b_ + 12 * j, 8);
          __builtin_memcpy (&cb, b_ + 12 * j + 8, 4);
          le = (wa <= wb); ge = (wa >= wb);
          w = le ? wa : wb;
          c = le ? ca : cb;
          eqm = (unsigned int) -(le & ge);
          c = (c & ~eqm) | ((ca + cb) & eqm);   /* u32 wrap, union ADD */
          if (c >= min_count && c <= max_count) {
            put_rec (records, m, w, c);
            tot += c;
            m++;
          }
          i += le; j += ge;
        }
        ra.pos = i; rb.pos = j;
      } else if (ha || hb) {
        FgxMSrc *S = ha ? &ra : &rb;
        const unsigned char *sp = S->base;
        long i = S->pos, e = S->len;
        while (i < e) {
          unsigned long long w;
          unsigned int c;
          __builtin_memcpy (&w, sp + 12 * i, 8);
          __builtin_memcpy (&c, sp + 12 * i + 8, 4);
          if (c >= min_count && c <= max_count) {
            put_rec (records, m, w, c);
            tot += c;
            m++;
          }
          i++;
        }
        S->pos = i;
      } else {
        break;
      }
    }
    free (nodes);
    free (arena);
  }
  *total_count = tot;
  return m;
}

/* ------------------------------------------------------------------ */
/* text SNV database fast-path parse (gmer_counter -db)                */
/* ------------------------------------------------------------------ */

/* Strictly clean databases only: every line is
 *   NAME \t COUNT \t KMER ( \t KMER )* \n
 * with COUNT plain digits matching the kmer token count, every kmer
 * token exactly `wordsize` ACGTUacgtu bytes, and no other control
 * bytes. '#' comment lines are skipped. Returns the number of node
 * lines parsed, or -1 when ANY line deviates — the caller then falls
 * back to the exact bug-compatible Python parser (formats/gmerdb.py),
 * which reproduces src/database.c:94-260 quirk for quirk. wordsize is
 * taken from the first node line's first kmer token; *wordsize_out
 * receives it. Outputs per line: name_off, name_len, nkmers; words
 * receives the packed forward 2-bit kmers in file order (capacity
 * >= n / (wordsize+1) + 1). */
long fgx_parse_text_db (const unsigned char *data, long n,
                        long max_kmers_per_node,
                        long *name_off, long *name_len, long *nkmers,
                        unsigned long long *words, long *n_words_out,
                        int *wordsize_out)
{
  nucl_init ();
  long pos = 0, n_lines = 0, n_words = 0;
  int wordsize = 0;
  if (n < 256) return -1;      /* reference's byte<csize bug territory */
  while (pos < n) {
    if (data[pos] == '#') {
      while (pos < n && data[pos] != '\n') pos++;
      pos++;
      continue;
    }
    if (data[pos] == '\n') return -1;        /* empty line: not clean */
    /* NAME token */
    long ns = pos;
    while (pos < n && data[pos] >= 0x20) pos++;
    if (pos >= n || data[pos] != '\t') return -1;
    long ne = pos;
    pos++;
    /* COUNT token: digits only */
    long nk = 0;
    if (pos >= n || data[pos] < '0' || data[pos] > '9') return -1;
    while (pos < n && data[pos] >= '0' && data[pos] <= '9') {
      nk = nk * 10 + (data[pos] - '0');
      pos++;
    }
    if (nk <= 0 || nk > max_kmers_per_node) return -1;
    /* kmer tokens */
    long t;
    for (t = 0; t < nk; t++) {
      if (pos >= n || data[pos] != '\t') return -1;
      pos++;
      long ks = pos;
      unsigned long long w = 0;
      while (pos < n && data[pos] >= 0x20) {
        unsigned char c = nucl_codes[data[pos]];
        if (c > 3) return -1;
        w = (w << 2) | c;
        pos++;
      }
      long wl = pos - ks;
      if (wordsize == 0) {
        if (wl < 1 || wl > 32) return -1;
        wordsize = (int) wl;
      }
      if (wl != wordsize) return -1;
      words[n_words++] = w;
    }
    if (pos < n && data[pos] == '\r') return -1;
    if (pos < n) {
      if (data[pos] != '\n') return -1;
      pos++;
    }
    name_off[n_lines] = ns;
    name_len[n_lines] = ne - ns;
    nkmers[n_lines] = nk;
    n_lines++;
  }
  if (n_lines == 0) return -1;
  *n_words_out = n_words;
  *wordsize_out = wordsize;
  return n_lines;
}

/* ------------------------------------------------------------------ */
/* gapped multi-alignment build (gassembler)                           */
/* ------------------------------------------------------------------ */

/* Exact twin of create_gapped_alignment in pipelines/gassemble.py
 * (reference walk: src/gassembler.c:2008-2077).  Sequential over
 * reference positions (the gap state carries), linear over reads.
 * Nucleotide codes: GAP=5, NONE=6; position sentinels BEFORE=-1,
 * AFTER=-2, UNKNOWN=-3.  Returns p_len. */
long fgx_gapped_alignment (const signed char *ref, int n, int ref_start,
                           int skip, const short *seq_mat, long na,
                           int max_rl, const int *a, int max_p,
                           int *aligned_ref, int *ref_pos, short *ga,
                           long *read_p, long *last_read_p)
{
  long i;
  int ref_p = skip;
  int last_ref_p = -3;
  long p_len = 0;
  for (i = 0; i < na; i++) {
    read_p[i] = a[i * (long) n + skip];
    last_read_p[i] = -3;
  }
  while (ref_p < n - skip) {
    if (last_ref_p < 0 || ref_p > last_ref_p) {
      aligned_ref[p_len] = ref[ref_p];
      last_ref_p = ref_p;
    } else {
      aligned_ref[p_len] = 5;                      /* GAP */
    }
    ref_pos[p_len] = ref_start + ref_p;
    for (i = 0; i < na; i++) {
      long rp = read_p[i];
      short col;
      if (rp >= 0 && (last_read_p[i] < 0 || rp > last_read_p[i])) {
        long idx = rp < 0 ? 0 : rp;
        col = seq_mat[i * (long) max_rl + idx];
        last_read_p[i] = rp;
      } else {
        col = rp >= 0 ? 5 : 6;                     /* GAP : NONE */
      }
      ga[i * (long) max_p + p_len] = col;
    }
    {
      int rgap = 1;
      if (ref_p < n - skip - 1 && na) {
        long g, any = 0;
        long best = 1;
        for (i = 0; i < na; i++) {
          int nrp = a[i * (long) n + ref_p + 1];
          if (read_p[i] >= 0 && nrp >= 0) {
            g = nrp - read_p[i];
            if (!any || g > best) best = g;
            any = 1;
          }
        }
        if (any && best > 1) rgap = (int) best;
        for (i = 0; i < na; i++) {
          int nrp = a[i * (long) n + ref_p + 1];
          long adv;
          if (nrp >= 0) {
            if (read_p[i] < 0) adv = (rgap == 1) ? nrp : read_p[i];
            else adv = (read_p[i] < nrp && nrp - read_p[i] == rgap)
                       ? read_p[i] + 1 : read_p[i];
          } else {
            adv = nrp;
          }
          read_p[i] = adv;
        }
      }
      if (rgap == 1) ref_p++;
    }
    p_len++;
  }
  return p_len;
}

/* ------------------------------------------------------------------ */
/* lane-parallel Smith-Waterman align phase                            */
/* ------------------------------------------------------------------ */

/* 32 reads fill in parallel: lanes are independent reads over the same
 * reference, so every op in the recurrence is lane-wise and the
 * compiler vectorizes the lane loop onto AVX2 int16 lanes (32 lanes
 * measured best: 2 registers deep for ILP without blowing L2; 64 lanes
 * regress).  Layout: score/sx/sy[(i*(m+1)+j)*LANES + lane].
 * The recurrence and tie-breaks are the exact integer semantics of
 * src/gassembler.c:2185-2321 (see ops/swalign.py). */

#define SW_LANES 32

static void sw_fill_lanes (const signed char *ref, int n,
                           const signed char *rdt /* [m][LANES] */, int m,
                           short *sc, short *sx, short *sy,
                           short *tgs /* [(m+1)*LANES] */, short *tgl)
{
  int i, j, l;
  for (j = 0; j <= m; j++)
    for (l = 0; l < SW_LANES; l++) {
      tgs[j * SW_LANES + l] = -1000;
      tgl[j * SW_LANES + l] = 0;
    }
  for (i = 1; i <= n; i++) {
    short lgs[SW_LANES], lgl[SW_LANES];
    int a_n = ref[i - 1];
    short *row = sc + ((long) i * (m + 1)) * SW_LANES;
    short *prow = sc + ((long) (i - 1) * (m + 1)) * SW_LANES;
    short *sxr = sx + ((long) i * (m + 1)) * SW_LANES;
    short *syr = sy + ((long) i * (m + 1)) * SW_LANES;
    for (l = 0; l < SW_LANES; l++) { lgs[l] = -1000; lgl[l] = 0; }
    for (j = 1; j <= m; j++) {
      short *tgsj = tgs + j * SW_LANES;
      short *tglj = tgl + j * SW_LANES;
      const signed char *bcol = rdt + (long) (j - 1) * SW_LANES;
      for (l = 0; l < SW_LANES; l++) {
        int b_n = bcol[l];
        short sub = (a_n >= 4 || b_n >= 4) ? 0 : (a_n == b_n ? 2 : -3);
        short dsc = (short) (prow[(j - 1) * SW_LANES + l] + sub);
        int take = dsc > 0;
        short cell = take ? dsc : 0;
        short csx = take ? -1 : 0, csy = take ? -1 : 0;
        short ls = (short) (cell - 4), lse = (short) (lgs[l] - 2);
        int ext = lse > ls;
        short ll = ext ? (short) (lgl[l] + 1) : 0;
        ls = ext ? lse : ls;
        {
          int sel = ls >= cell;
          cell = sel ? ls : cell;
          csx = sel ? (short) (-ll) : csx;
          csy = sel ? 0 : csy;
        }
        lgs[l] = ls; lgl[l] = ll;
        {
          short ts = (short) (cell - 4), tse = (short) (tgsj[l] - 2);
          int ext2 = tse > ts;
          short tl = ext2 ? (short) (tglj[l] + 1) : 0;
          ts = ext2 ? tse : ts;
          {
            int sel2 = ts >= cell;
            cell = sel2 ? ts : cell;
            csx = sel2 ? 0 : csx;
            csy = sel2 ? (short) (-tl) : csy;
          }
          tgsj[l] = ts; tglj[l] = tl;
        }
        row[j * SW_LANES + l] = cell;
        sxr[j * SW_LANES + l] = csx;
        syr[j * SW_LANES + l] = csy;
      }
    }
  }
}

/* Strided traceback of one lane (semantics of fgx_sw_traceback). */
static int sw_traceback_lane (const short *sc, const short *sx,
                              const short *sy, int n, int m, int lane,
                              int m_valid, int *a_pos, int *b_pos)
{
  int i, j, mi = 0, mj = 0, cnt = 0, half;
  int W = m + 1;
  short best = sc[lane];
  for (i = 0; i <= n; i++) {
    const short *row = sc + ((long) i * W) * SW_LANES;
    for (j = 0; j <= m_valid; j++) {
      short v = row[j * SW_LANES + lane];
      if (v > best) { best = v; mi = i; mj = j; }
    }
  }
  while (mi > 0 && mj > 0) {
    long at = ((long) mi * W + mj) * SW_LANES + lane;
    short cx = sx[at], cy = sy[at];
    if (cx == 0 && cy == 0) break;
    if (sc[at] < 1) break;
    if (cx && cy) { a_pos[cnt] = mi - 1; b_pos[cnt] = mj - 1; cnt++; }
    mi += cy;
    mj += cx;
  }
  half = cnt / 2;
  for (i = 0; i < half; i++) {
    int t = a_pos[i]; a_pos[i] = a_pos[cnt - 1 - i]; a_pos[cnt - 1 - i] = t;
    t = b_pos[i]; b_pos[i] = b_pos[cnt - 1 - i]; b_pos[cnt - 1 - i] = t;
  }
  return cnt;
}

/* Lane-parallel version of fgx_sw_align_region (fastgt_exact.c): same
 * filters, same row semantics, internal scratch.  Returns kept count,
 * -1 on allocation failure.
 * stats (optional, NULL to skip): int[B*6] of per-read
 * {align_len, n_divergent, n_gaps, gaps_total, s_gap, e_gap} for every
 * PROCESSED read (kept or filtered) — the -DD per-read alignment trace
 * (src/gassembler.c:1928-1970) prints from these; entries of reads
 * never reached (early stop at max_aligned) are left untouched. */
long fgx_sw_align_region8 (const signed char *ref, int n,
                           const signed char *reads, long B, int m,
                           const int *read_lens,
                           int max_divergent, int min_align_len,
                           int max_endgap, int max_gaps, long max_aligned,
                           int *rows, int *keep_idx, int *hit_cap,
                           int *stats)
{
  long blk = (long) (n + 1) * (m + 1) * SW_LANES;
  short *sc = (short *) calloc (blk, sizeof (short));
  short *sx = (short *) calloc (blk, sizeof (short));
  short *sy = (short *) calloc (blk, sizeof (short));
  short *tgs = (short *) malloc ((size_t) (m + 1) * SW_LANES
                                 * sizeof (short));
  short *tgl = (short *) malloc ((size_t) (m + 1) * SW_LANES
                                 * sizeof (short));
  signed char *rblk = (signed char *) malloc ((size_t) SW_LANES * m);
  int *a_pos = (int *) malloc ((size_t) (n + m + 2) * sizeof (int));
  int *b_pos = (int *) malloc ((size_t) (n + m + 2) * sizeof (int));
  long b0, kept = 0;
  *hit_cap = 0;
  if (!sc || !sx || !sy || !tgs || !tgl || !rblk || !a_pos || !b_pos) {
    free (sc); free (sx); free (sy); free (tgs); free (tgl);
    free (rblk); free (a_pos); free (b_pos);
    return -1;
  }
  for (b0 = 0; b0 < B && !*hit_cap; b0 += SW_LANES) {
    int nl = (B - b0 < SW_LANES) ? (int) (B - b0) : SW_LANES;
    int l;
    /* pad the partial block with NONE(6): zero-substitution lanes never
     * score above 0, so their traceback is empty and they are skipped.
     * TRANSPOSED layout [pos][lane]: the fill's inner lane loop then
     * reads 32 contiguous int8s — the strided [lane][pos] access
     * blocked AVX2 vectorization of the substitution load */
    memset (rblk, 6, (size_t) SW_LANES * m);
    for (l = 0; l < nl; l++) {
      const signed char *src = reads + (b0 + l) * (long) m;
      int jj;
      for (jj = 0; jj < m; jj++)
        rblk[(long) jj * SW_LANES + l] = src[jj];
    }
    sw_fill_lanes (ref, n, rblk, m, sc, sx, sy, tgs, tgl);
    for (l = 0; l < nl; l++) {
      long b = b0 + l;
      const signed char *rd = reads + b * (long) m;
      int rl = read_lens[b];
      int cnt = sw_traceback_lane (sc, sx, sy, n, m, l, rl, a_pos, b_pos);
      if (cnt == 0) {
        if (stats) {
          stats[b * 6 + 0] = 0; stats[b * 6 + 1] = -1;
          stats[b * 6 + 2] = -1; stats[b * 6 + 3] = -1;
          stats[b * 6 + 4] = -1; stats[b * 6 + 5] = -1;
        }
        continue;
      }
      {
        int n_gaps = 0, gaps_total = 0, s_gap = 0, e_gap = 0, n_div, t;
        if (a_pos[0] > 0 && b_pos[0] > 0) {
          int mn = a_pos[0] < b_pos[0] ? a_pos[0] : b_pos[0];
          n_gaps++; s_gap = mn; gaps_total += mn;
        }
        if (a_pos[cnt - 1] < n - 1 && b_pos[cnt - 1] < rl - 1) {
          int ga = n - 1 - a_pos[cnt - 1];
          int gb = rl - 1 - b_pos[cnt - 1];
          int mn = ga < gb ? ga : gb;
          n_gaps++; e_gap = mn; gaps_total += mn;
        }
        n_div = n_gaps;
        for (t = 0; t < cnt; t++)
          if (ref[a_pos[t]] != rd[b_pos[t]]) n_div++;
        if (stats) {
          stats[b * 6 + 0] = cnt; stats[b * 6 + 1] = n_div;
          stats[b * 6 + 2] = n_gaps; stats[b * 6 + 3] = gaps_total;
          stats[b * 6 + 4] = s_gap; stats[b * 6 + 5] = e_gap;
        }
        if (n_div > max_divergent) continue;
        if (cnt < min_align_len) continue;
        if (s_gap > max_endgap || e_gap > max_endgap) continue;
        if (gaps_total > max_gaps) continue;
      }
      {
        int *row = rows + kept * n;
        int a0 = a_pos[0], bp0 = b_pos[0];
        int a_last = a_pos[cnt - 1], b_last = b_pos[cnt - 1];
        int p, before_end = a0 - bp0;
        if (before_end > a0) before_end = a0;
        if (before_end < 0) before_end = 0;
        for (p = 0; p < before_end; p++) row[p] = -1;          /* BEFORE */
        for (p = before_end; p < a0; p++) row[p] = -3;         /* UNKNOWN */
        {
          int t = 0, cur = 0;
          for (p = a0; p <= a_last; p++) {
            if (t < cnt && a_pos[t] == p) { cur = b_pos[t]; t++; }
            row[p] = cur;
          }
        }
        {
          int cut = a_last + rl - b_last;
          int unk_end = cut > a_last + 1 ? cut : a_last + 1;
          if (unk_end > n) unk_end = n;
          for (p = a_last + 1; p < unk_end; p++) row[p] = -3;  /* UNKNOWN */
          for (p = unk_end; p < n; p++) row[p] = -2;           /* AFTER */
        }
        keep_idx[kept] = (int) b;
        kept++;
        if (kept >= max_aligned) { *hit_cap = 1; break; }
      }
    }
  }
  free (sc); free (sx); free (sy); free (tgs); free (tgl);
  free (rblk); free (a_pos); free (b_pos);
  return kept;
}

/* ------------------------------------------------------------------ */
/* greedy read-group merging (gassembler)                              */
/* ------------------------------------------------------------------ */

/* Count non-zero 3-bit groups of a divergent-position tag. */
static long popcount3 (unsigned long long x)
{
  unsigned long long y = (x | (x >> 1) | (x >> 2))
    & 0x1249249249249249ULL;
  return __builtin_popcountll (y);
}

/* Greedy merge of tag-compatible read groups (src/gassembler.c:
 * 1327-1591 selection semantics: best pair by strictly-greater
 * (n_common_positions, size_sum) over the row-major i<j scan; merged
 * group keeps slot i, last row swaps into slot j).  Arrays are
 * modified in place; group_of has one entry per READ (length na) and
 * is relabeled on merge/swap exactly like the reference.  The
 * reference rescans all pairs each round; at gassembler scales
 * (<=1024 reads, typically ~100) the rescan is cheaper in C than any
 * incremental bookkeeping.  Returns the final group count. */
static long group_merge_impl (unsigned long long *tags,
                              unsigned long long *masks,
                              long *sizes, long *dirs, long *group_of,
                              long na, int dbg)
{
  long n = na, r;
  while (n > 1) {
    long best_i = -1, best_j = -1, best_nc = -1, best_sz = -1;
    long i, j;
    for (i = 0; i < n; i++) {
      for (j = i + 1; j < n; j++) {
        unsigned long long cm = masks[i] & masks[j];
        if ((tags[i] & cm) != (tags[j] & cm)) continue;
        long nc = popcount3 (cm);
        long sz = sizes[i] + sizes[j];
        if (nc > best_nc || (nc == best_nc && sz > best_sz)) {
          best_nc = nc; best_sz = sz; best_i = i; best_j = j;
        }
      }
    }
    if (best_i < 0) break;
    i = best_i; j = best_j;
    /* -DG merge trace (src/gassembler.c:1413-1418): the second half
     * prints the UPDATED tag but group j's (unchanged) mask */
    if (dbg) fprintf (stderr, "Merging groups %u (size %u) and %u "
                      "(size %u) (common %u): %llx %llx %llx %llx -> ",
                      (unsigned int) i, (unsigned int) sizes[i],
                      (unsigned int) j, (unsigned int) sizes[j],
                      (unsigned int) best_nc, tags[i], masks[i],
                      tags[j], masks[j]);
    tags[i] = (tags[i] & masks[i]) | (tags[j] & masks[j]);
    masks[i] |= masks[j];
    sizes[i] += sizes[j];
    dirs[i] |= dirs[j];
    if (dbg) fprintf (stderr, "%llx %llx\n", tags[i], masks[j]);
    for (r = 0; r < na; r++) if (group_of[r] == j) group_of[r] = i;
    n--;
    tags[j] = tags[n]; masks[j] = masks[n];
    sizes[j] = sizes[n]; dirs[j] = dirs[n];
    for (r = 0; r < na; r++) if (group_of[r] == n) group_of[r] = j;
  }
  if (dbg) fprintf (stderr, "Num remaining groups: %u\n",
                    (unsigned int) n);
  return n;
}

long fgx_group_merge (unsigned long long *tags, unsigned long long *masks,
                      long *sizes, long *dirs, long *group_of, long na)
{
  return group_merge_impl (tags, masks, sizes, dirs, group_of, na, 0);
}

/* ------------------------------------------------------------------ */
/* Smith-Waterman (integer-only, moved here for the -O3 object)       */
/* ------------------------------------------------------------------ */

/* ---- Smith-Waterman matrix fill (gassembler twin) -------------------
 *
 * Exact integer port of src/gassembler.c:2185-2321's DP as expressed in
 * ops/swalign.py (same tie-breaks, same int8 gap-length wraparound).
 * Row-major fill: the left-gap state carries as scalars along the row,
 * the top-gap state as per-column arrays. ~30x the numpy wavefront on
 * one host core.
 */
#define SW_M 2
#define SW_MM (-3)
#define SW_GO (-4)
#define SW_GE (-2)
#define SW_NEG (-1000)
#define SW_NUCL_N 4

void fgx_sw_batch (const signed char *ref, int n, const signed char *reads,
                   int B, int m, short *score, signed char *sx,
                   signed char *sy, short *tg_s_buf, signed char *tg_l_buf)
{
  int b, i, j;
  int stride = (n + 1) * (m + 1);
  for (b = 0; b < B; b++) {
    const signed char *rd = reads + (long) b * m;
    short *sc = score + (long) b * stride;
    signed char *sxb = sx + (long) b * stride;
    signed char *syb = sy + (long) b * stride;
    for (j = 0; j <= m; j++) { tg_s_buf[j] = SW_NEG; tg_l_buf[j] = 0; }
    for (i = 1; i <= n; i++) {
      short lg_s = SW_NEG;
      signed char lg_l = 0;
      int a_n = ref[i - 1];
      short *row = sc + i * (m + 1);
      short *prow = sc + (i - 1) * (m + 1);
      signed char *sxr = sxb + i * (m + 1);
      signed char *syr = syb + i * (m + 1);
      for (j = 1; j <= m; j++) {
        int b_n = rd[j - 1];
        short sub = (a_n >= SW_NUCL_N || b_n >= SW_NUCL_N) ? 0
                    : (a_n == b_n ? SW_M : SW_MM);
        short dsc = (short) (prow[j - 1] + sub);
        short cell; signed char csx, csy;
        if (dsc > 0) { cell = dsc; csx = -1; csy = -1; }
        else { cell = 0; csx = 0; csy = 0; }
        /* left gap from (i, j-1) */
        {
          short ls = (short) (cell + SW_GO);
          signed char ll = 0;
          if ((short) (lg_s + SW_GE) > ls) {
            ls = (short) (lg_s + SW_GE);
            ll = (signed char) (lg_l + 1);
          }
          if (ls >= cell) {
            cell = ls; csx = (signed char) (-ll); csy = 0;
          }
          lg_s = ls; lg_l = ll;
        }
        /* top gap from (i-1, j), uses the updated cell */
        {
          short ts = (short) (cell + SW_GO);
          signed char tl = 0;
          if ((short) (tg_s_buf[j] + SW_GE) > ts) {
            ts = (short) (tg_s_buf[j] + SW_GE);
            tl = (signed char) (tg_l_buf[j] + 1);
          }
          if (ts >= cell) {
            cell = ts; csx = 0; csy = (signed char) (-tl);
          }
          tg_s_buf[j] = ts; tg_l_buf[j] = tl;
        }
        row[j] = cell; sxr[j] = csx; syr[j] = csy;
      }
    }
  }
}

/* Traceback one read's SW matrices (src/gassembler.c:2298-2320): first
 * row-major maximum over columns 0..m_valid, then walk sx/sy. Returns
 * the number of aligned pairs; a_pos/b_pos are filled in ascending
 * order (capacity >= n1 + m1). */
int fgx_sw_traceback (const short *score, const signed char *sx,
                      const signed char *sy, int n1, int m1, int m_valid,
                      int *a_pos, int *b_pos)
{
  int i, j, mi = 0, mj = 0, cnt = 0, half;
  short best = score[0];
  for (i = 0; i < n1; i++) {
    const short *row = score + (long) i * m1;
    for (j = 0; j <= m_valid; j++) {
      if (row[j] > best) { best = row[j]; mi = i; mj = j; }
    }
  }
  while (mi > 0 && mj > 0) {
    signed char cx = sx[(long) mi * m1 + mj];
    signed char cy = sy[(long) mi * m1 + mj];
    if (cx == 0 && cy == 0) break;
    if (score[(long) mi * m1 + mj] < 1) break;
    if (cx && cy) { a_pos[cnt] = mi - 1; b_pos[cnt] = mj - 1; cnt++; }
    mi += cy;
    mj += cx;
  }
  half = cnt / 2;
  for (i = 0; i < half; i++) {
    int t = a_pos[i]; a_pos[i] = a_pos[cnt - 1 - i]; a_pos[cnt - 1 - i] = t;
    t = b_pos[i]; b_pos[i] = b_pos[cnt - 1 - i]; b_pos[cnt - 1 - i] = t;
  }
  return cnt;
}


/* Fused align phase for one region (src/gassembler.c:1912-2006 with the
 * divergence count of :1162-1196): per read, SW fill into an
 * L2-resident scratch matrix (reused across reads, unlike the batched
 * fill above which streams B full matrices through RAM), traceback,
 * divergence filters, and the per-reference-position read-position row.
 * Row semantics match align_reads in pipelines/gassemble.py exactly
 * (BEFORE=-1, AFTER=-2, UNKNOWN=-3, untouched=-1000).
 *
 * rows is int32[max_aligned, n]; keep_idx[r] records which input read
 * produced kept row r. Returns the kept count; *hit_cap is set when
 * the max_aligned cap stopped the scan early (caller prints the
 * reference's stderr message). Scratch (score/sx/sy/tg) is caller-
 * provided so repeated calls do not churn the allocator:
 * score (n+1)*(m+1) shorts, sx/sy same in bytes, tg_s m+1 shorts,
 * tg_l m+1 bytes, a_pos/b_pos n+m+2 ints. */
long fgx_sw_align_region (const signed char *ref, int n,
                          const signed char *reads, long B, int m,
                          const int *read_lens,
                          int max_divergent, int min_align_len,
                          int max_endgap, int max_gaps, long max_aligned,
                          int *rows, int *keep_idx, int *hit_cap,
                          short *score, signed char *sx, signed char *sy,
                          short *tg_s, signed char *tg_l,
                          int *a_pos, int *b_pos)
{
  long b, kept = 0;
  *hit_cap = 0;
  /* the DP only writes interior cells; row 0 / col 0 must read as zero
   * for the argmax and traceback (the batched path allocates zeroed) */
  memset (score, 0, (size_t) (n + 1) * (m + 1) * sizeof (short));
  memset (sx, 0, (size_t) (n + 1) * (m + 1));
  memset (sy, 0, (size_t) (n + 1) * (m + 1));
  for (b = 0; b < B; b++) {
    const signed char *rd = reads + b * m;
    int rl = read_lens[b];
    fgx_sw_batch (ref, n, rd, 1, m, score, sx, sy, tg_s, tg_l);
    int cnt = fgx_sw_traceback (score, sx, sy, n + 1, m + 1, rl,
                                a_pos, b_pos);
    if (cnt == 0) continue;
    /* divergence count (src/gassembler.c:1162-1196) */
    {
      int n_gaps = 0, gaps_total = 0, s_gap = 0, e_gap = 0, n_div, t;
      if (a_pos[0] > 0 && b_pos[0] > 0) {
        int mn = a_pos[0] < b_pos[0] ? a_pos[0] : b_pos[0];
        n_gaps++; s_gap = mn; gaps_total += mn;
      }
      if (a_pos[cnt - 1] < n - 1 && b_pos[cnt - 1] < rl - 1) {
        int ga = n - 1 - a_pos[cnt - 1];
        int gb = rl - 1 - b_pos[cnt - 1];
        int mn = ga < gb ? ga : gb;
        n_gaps++; e_gap = mn; gaps_total += mn;
      }
      n_div = n_gaps;
      for (t = 0; t < cnt; t++)
        if (ref[a_pos[t]] != rd[b_pos[t]]) n_div++;
      if (n_div > max_divergent) continue;
      if (cnt < min_align_len) continue;
      if (s_gap > max_endgap || e_gap > max_endgap) continue;
      if (gaps_total > max_gaps) continue;
    }
    /* alignment row */
    {
      int *row = rows + kept * n;
      int a0 = a_pos[0], b0 = b_pos[0];
      int a_last = a_pos[cnt - 1], b_last = b_pos[cnt - 1];
      int p, before_end = a0 - b0;
      if (before_end > a0) before_end = a0;
      if (before_end < 0) before_end = 0;
      for (p = 0; p < before_end; p++) row[p] = -1;            /* BEFORE */
      for (p = before_end; p < a0; p++) row[p] = -3;           /* UNKNOWN */
      {
        int t = 0, cur = 0;
        for (p = a0; p <= a_last; p++) {
          if (t < cnt && a_pos[t] == p) { cur = b_pos[t]; t++; }
          row[p] = cur;
        }
      }
      {
        int cut = a_last + rl - b_last;
        int unk_end = cut > a_last + 1 ? cut : a_last + 1;
        if (unk_end > n) unk_end = n;
        for (p = a_last + 1; p < unk_end; p++) row[p] = -3;    /* UNKNOWN */
        for (p = unk_end; p < n; p++) row[p] = -2;             /* AFTER */
      }
      keep_idx[kept] = (int) b;
      kept++;
      /* the reference prints its cap warning and stops the moment the
       * cap is reached, even on the final read (gassembler.c:1990-1998) */
      if (kept >= max_aligned) { *hit_cap = 1; break; }
    }
  }
  return kept;
}



/* ------------------------------------------------------------------ */
/* gassembler read fetch (src/gassembler.c:2630-2665)                  */
/* ------------------------------------------------------------------ */

/* For each read info: the name runs from name_pos to the first '\n' of
 * its file buffer; sequence bytes follow while byte >= 'A'; the scan
 * length is reported in orig_len (the caller prints the reference's
 * truncation warning), the kept prefix is truncated to maxlen and then
 * reverse-complemented when rdir (A<->T / C<->G, other bytes kept, like
 * the Python twin's table).  Sequence bytes and int8 nucleotide codes
 * (A0 C1 G2 T/U3 N4 -5, case-insensitive) land in per-read slots of
 * stride maxlen. */
void fgx_fetch_reads (const unsigned char *const *file_data,
                      const long long *file_len,
                      const long long *name_pos_a, const int *file_idx_a,
                      const unsigned char *rdir_a, long n, long maxlen,
                      unsigned char *seq_arena, signed char *code_arena,
                      long long *name_end, long long *seq_len,
                      long long *orig_len)
{
  static unsigned char rc[256];
  static signed char c2n[256];
  static int init = 0;
  long i;
  if (!init) {
    int j;
    for (j = 0; j < 256; j++) { rc[j] = (unsigned char) j; c2n[j] = 4; }
    rc['A'] = 'T'; rc['T'] = 'A'; rc['C'] = 'G'; rc['G'] = 'C';
    c2n['A'] = c2n['a'] = 0; c2n['C'] = c2n['c'] = 1;
    c2n['G'] = c2n['g'] = 2; c2n['T'] = c2n['t'] = 3;
    c2n['U'] = c2n['u'] = 3; c2n['-'] = 5;
    init = 1;
  }
  for (i = 0; i < n; i++) {
    const unsigned char *d = file_data[file_idx_a[i]];
    long long len = file_len[file_idx_a[i]];
    long long p = name_pos_a[i];
    long long q, sl, j;
    unsigned char *seq = seq_arena + i * maxlen;
    signed char *code = code_arena + i * maxlen;
    while (p < len && d[p] != '\n') p += 1;
    name_end[i] = p;
    p += 1;
    q = p;
    while (q < len && d[q] >= 'A') q += 1;
    orig_len[i] = q - p;
    sl = q - p;
    if (sl > maxlen) sl = maxlen;
    seq_len[i] = sl;
    if (rdir_a[i]) {
      /* truncate FIRST, then reverse-complement the kept prefix */
      for (j = 0; j < sl; j++) seq[j] = rc[d[p + sl - 1 - j]];
    } else {
      __builtin_memcpy (seq, d + p, sl);
    }
    for (j = 0; j < sl; j++) code[j] = c2n[seq[j]];
  }
}

/* ------------------------------------------------------------------ */
/* gassembler group phase (src/gassembler.c:1327-1591)                 */
/* ------------------------------------------------------------------ */

/* Full group phase after alignment: greedy tag merge (fgx_group_merge),
 * per-group coverage min/max, read-compatibility counts, per-group
 * consensus (gated on GLOBAL nucleotide counts > 1, nucleotide order
 * 0,1,2,3,5 skipping N), divergence vs the aligned reference with the
 * reference's sequential last-value carry ACROSS group rows, the
 * pairwise (divergence asc, size desc) sort with read relabeling, and
 * group selection.  The relative-size filter multiplies in float like
 * the reference's `(float) size < size0 * min_group_rsize`.
 *
 * tags/masks/sizes/dirs are in/out [na] (group slots 0..n_groups-1 on
 * return); group_of [na] gets final labels; divergent/min_cov/max_cov/
 * compat_n/included sized [na]; consensus [na*p_len] int8; good_groups
 * [max_groups].  Returns n_groups; *n_good_out = selected count. */
long fgx_group_phase (unsigned long long *tags, unsigned long long *masks,
                      long *sizes, long *dirs, long *group_of,
                      const unsigned long long *read_tags,
                      const unsigned long long *read_masks,
                      const signed char *ga, long na, long p_len,
                      const signed char *aligned_ref,
                      const unsigned char *known,
                      long *divergent, long *min_cov, long *max_cov,
                      long *compat_n, signed char *consensus,
                      int max_groups, int require_both_dirs,
                      long min_group_coverage, long min_group_size,
                      long max_group_divergence, long max_group_rdivergence,
                      float min_group_rsize,
                      unsigned char *included, long *good_groups,
                      long *n_good_out,
                      /* -DG chrome (src/gassembler.c:1404-1580): level,
                       * chromosome id, per-position reference positions,
                       * and the pre-rendered SNV allele chars for the
                       * Known-SNV line (0 when not known) */
                      int debug_groups, unsigned int chr_id,
                      const long long *ref_pos,
                      const unsigned char *snv_ref_c,
                      const unsigned char *snv_alt_c,
                      /* -DG level-2 (src/gassembler.c:1521-1526):
                       * per-read name strings for the member dump;
                       * NULL skips the level-2 lines */
                      const char *const *read_names)
{
  long n_groups = group_merge_impl (tags, masks, sizes, dirs, group_of,
                                    na, debug_groups);
  long g, r, i, j, k;
  long *cov_gp = (long *) calloc ((size_t) (n_groups * (p_len ? p_len : 1)),
                                  sizeof (long));
  long *cnt = (long *) calloc ((size_t) (n_groups * (p_len ? p_len : 1) * 7),
                               sizeof (long));
  long *gcnt = (long *) calloc ((size_t) ((p_len ? p_len : 1) * 7),
                                sizeof (long));
  long min_div, n_good = 0;
  signed char last_ar = 4, last_cons = 4;   /* N */

  /* global per-position nucleotide counts + per-group grids */
  for (r = 0; r < na; r++) {
    const signed char *row = ga + r * p_len;
    long *grp_cov = cov_gp + group_of[r] * p_len;
    long *grp_cnt = cnt + group_of[r] * p_len * 7;
    for (i = 0; i < p_len; i++) {
      signed char v = row[i];
      gcnt[i * 7 + v] += 1;
      grp_cnt[i * 7 + v] += 1;
      if (v <= 5) grp_cov[i] += 1;   /* <= GAP */
    }
  }
  for (g = 0; g < n_groups; g++) {
    if (p_len) {
      long mn = cov_gp[g * p_len], mx = mn;
      for (i = 1; i < p_len; i++) {
        long c = cov_gp[g * p_len + i];
        if (c < mn) mn = c;
        if (c > mx) mx = c;
      }
      min_cov[g] = mn;
      max_cov[g] = mx;
    } else {
      min_cov[g] = na;
      max_cov[g] = 0;
    }
    compat_n[g] = 0;
    for (r = 0; r < na; r++) {
      unsigned long long cm = masks[g] & read_masks[r];
      if ((tags[g] & cm) == (read_tags[r] & cm)) compat_n[g] += 1;
    }
    /* consensus */
    for (i = 0; i < p_len; i++) {
      signed char c = aligned_ref[i];
      long *cc = cnt + (g * p_len + i) * 7;
      long *gc = gcnt + i * 7;
      static const signed char order[5] = { 0, 1, 2, 3, 5 };
      for (k = 0; k < 5; k++) {
        signed char kk = order[k];
        if (gc[kk] > 1 && cc[kk] > cc[c]) c = kk;
      }
      consensus[g * p_len + i] = c;
    }
  }
  /* divergence with the flattened carry across rows; the -DG trace
   * prints on EVERY consensus!=ref position, before the known-SNV
   * gate (src/gassembler.c:1466-1479) */
  for (g = 0; g < n_groups; g++) {
    long d = 0;
    for (i = 0; i < p_len; i++) {
      signed char ar = aligned_ref[i];
      signed char cs = consensus[g * p_len + i];
      if (cs != ar) {
        if (debug_groups)
          fprintf (stderr, "Divergent position in group %u %u:%u\n",
                   (unsigned int) g, chr_id,
                   (unsigned int) (ref_pos ? ref_pos[i] : 0));
        if (known && known[i]) {
          if (debug_groups)
            fprintf (stderr, "Known SNV (%c/%c)\n",
                     snv_ref_c ? snv_ref_c[i] : '?',
                     snv_alt_c ? snv_alt_c[i] : '?');
        } else {
          if (debug_groups)
            fprintf (stderr, "Potential DeNovo\n");
          if (((last_ar != 5) || (ar != 5))
              && ((last_cons != 5) || (cs != 5)))
            d += 1;
        }
      }
      last_ar = ar;
      last_cons = cs;
    }
    divergent[g] = d;
  }
  /* pairwise sort: divergence asc, size desc; reads relabel per swap */
  for (i = 0; i < n_groups; i++) {
    for (j = i + 1; j < n_groups; j++) {
      if (divergent[j] < divergent[i]
          || (divergent[j] == divergent[i] && sizes[j] > sizes[i])) {
        unsigned long long ut;
        long lt;
        lt = divergent[i]; divergent[i] = divergent[j]; divergent[j] = lt;
        lt = sizes[i]; sizes[i] = sizes[j]; sizes[j] = lt;
        lt = min_cov[i]; min_cov[i] = min_cov[j]; min_cov[j] = lt;
        lt = max_cov[i]; max_cov[i] = max_cov[j]; max_cov[j] = lt;
        lt = compat_n[i]; compat_n[i] = compat_n[j]; compat_n[j] = lt;
        lt = dirs[i]; dirs[i] = dirs[j]; dirs[j] = lt;
        ut = tags[i]; tags[i] = tags[j]; tags[j] = ut;
        ut = masks[i]; masks[i] = masks[j]; masks[j] = ut;
        for (k = 0; k < p_len; k++) {
          signed char t = consensus[i * p_len + k];
          consensus[i * p_len + k] = consensus[j * p_len + k];
          consensus[j * p_len + k] = t;
        }
        for (r = 0; r < na; r++) {
          if (group_of[r] == i) group_of[r] = j;
          else if (group_of[r] == j) group_of[r] = i;
        }
      }
    }
  }
  /* post-sort -DG dumps (src/gassembler.c:1504-1521) */
  if (debug_groups) {
    for (g = 0; g < n_groups; g++)
      fprintf (stderr, "%llu\t", tags[g]);
    fprintf (stderr, "\n");
    for (g = 0; g < n_groups; g++)
      fprintf (stderr, "%llu\t", masks[g]);
    fprintf (stderr, "\n");
    fprintf (stderr, "Read groups:");
    for (r = 0; r < na; r++)
      fprintf (stderr, " %u:%u", (unsigned int) r,
               (unsigned int) group_of[r]);
    fprintf (stderr, "\n");
    for (g = 0; g < n_groups; g++) {
      fprintf (stderr, "Group %u size %u divergent %u, min %u max %u "
               "tag %llx mask %llx\n", (unsigned int) g,
               (unsigned int) sizes[g], (unsigned int) divergent[g],
               (unsigned int) min_cov[g], (unsigned int) max_cov[g],
               tags[g], masks[g]);
      if (debug_groups > 1 && read_names) {
        /* level-2: consensus chars + member read names
         * (src/gassembler.c:1521-1526) */
        static const char n2c[] = "ACGTN- ";
        for (i = 0; i < p_len; i++)
          fputc (n2c[consensus[g * p_len + i]], stderr);
        fputc ('\n', stderr);
        for (r = 0; r < na; r++)
          if (group_of[r] == g)
            fprintf (stderr, "%s\n", read_names[r]);
      }
    }
  }
  /* selection; every filter prints its own discard line, so one group
   * can print several (src/gassembler.c:1547-1575), and the
   * min-coverage message ends with a LITERAL backslash-n (the C source
   * says \\n — reproduced) */
  min_div = n_groups ? divergent[0] : 0;
  for (g = 1; g < n_groups; g++)
    if (divergent[g] < min_div) min_div = divergent[g];
  for (g = 0; g < n_groups; g++) {
    int inc = n_good < max_groups;
    if (require_both_dirs && dirs[g] != 3) {
      inc = 0;
      if (debug_groups)
        fprintf (stderr, "Discarded group %u (%u): All reads have the "
                 "same dir (%s)\n", (unsigned int) g,
                 (unsigned int) sizes[g], dirs[g] == 2 ? "rev" : "fwd");
    }
    if (min_cov[g] < min_group_coverage) {
      inc = 0;
      if (debug_groups)
        fprintf (stderr, "Discarded group %u (%u): Minimum coverage "
                 "is 0\\n", (unsigned int) g, (unsigned int) sizes[g]);
    }
    if (sizes[g] < min_group_size) {
      inc = 0;
      if (debug_groups)
        fprintf (stderr, "Discarded group %u (%u): size too small "
                 "(%u < %u)\n", (unsigned int) g, (unsigned int) sizes[g],
                 (unsigned int) sizes[g], (unsigned int) min_group_size);
    }
    if (divergent[g] > max_group_divergence) {
      inc = 0;
      if (debug_groups)
        fprintf (stderr, "Discarded group %u (%u): too big divergence "
                 "(%u > %u)\n", (unsigned int) g, (unsigned int) sizes[g],
                 (unsigned int) divergent[g],
                 (unsigned int) max_group_divergence);
    }
    if (divergent[g] > min_div + max_group_rdivergence) {
      inc = 0;
      if (debug_groups)
        fprintf (stderr, "Discarded group %u (%u): too big relative "
                 "divergence (%u > %u)\n", (unsigned int) g,
                 (unsigned int) sizes[g], (unsigned int) divergent[g],
                 (unsigned int) (min_div + max_group_rdivergence));
    }
    if ((float) sizes[g] < ((float) sizes[0] * min_group_rsize)) {
      inc = 0;
      if (debug_groups)
        fprintf (stderr, "Discarded group %u (%u): relative size too "
                 "small (%.2f < %.2f)\n", (unsigned int) g,
                 (unsigned int) sizes[g],
                 (double) sizes[g] / sizes[0], (double) min_group_rsize);
    }
    included[g] = (unsigned char) inc;
    if (inc) good_groups[n_good++] = g;
  }
  *n_good_out = n_good;
  free (cov_gp);
  free (cnt);
  free (gcnt);
  return n_groups;
}

/* --compile_index host kernel: rolling canonical windows binary-
 * searched in the DB's sorted word array (L2-resident at SNV-DB
 * sizes); emits (code, window-start, is_rc) per hit in stream order —
 * the same triples as the device index program (pipelines/gmercount.
 * _make_index_fn; reference semantics src/gmer_counter.c:905-917).
 * Returns the hit count; *n_valid_out counts N-free windows. */
long fgx_index_hits (const unsigned char *codes, long n, int k,
                     const unsigned long long *db_words,
                     const unsigned int *db_codes, long ndb,
                     unsigned int *hit_code, long long *hit_pos,
                     unsigned char *hit_dir, long long *n_valid_out)
{
  unsigned long long mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  int rc_shift = 2 * (k - 1);
  unsigned long long fw = 0, rc = 0;
  int run = 0;
  long i, m = 0;
  long long n_valid = 0;
  /* top-PBITS prefix offset table (SURVEY hard-parts note): at FastGT
   * production scale (~30 M DB words, 240 MB) a plain binary search
   * cache-misses ~25 levels per window; the 4 MB offset table cuts it
   * to the 1-2 resident levels of a short range. Prefix of the CODED
   * word's top bits within 2k. */
  enum { PBITS = 20 };
  int shift = 2 * k - PBITS;
  unsigned int *off = NULL;
  if (shift > 0 && ndb >= (1 << 16)) {
    long p, d = 0;
    off = (unsigned int *) malloc (((1 << PBITS) + 1) * sizeof (unsigned int));
    if (off) {
      for (p = 0; p <= (1 << PBITS); p++) {
        while (d < ndb && (long) (db_words[d] >> shift) < p) d += 1;
        off[p] = (unsigned int) d;
      }
    }
  }
  for (i = 0; i < n; i++) {
    unsigned int c = codes[i];
    if (c > 3) { run = 0; continue; }
    fw = ((fw << 2) | c) & mask;
    rc = (rc >> 2) | ((unsigned long long) (3 - c) << rc_shift);
    if (++run >= k) {
      unsigned long long w = (fw < rc) ? fw : rc;
      long lo, hi;
      if (off) {
        unsigned long long p = w >> shift;
        lo = off[p];
        hi = off[p + 1];
      } else {
        lo = 0;
        hi = ndb;
      }
      n_valid += 1;
      while (lo < hi) {
        long mid = (lo + hi) >> 1;
        if (db_words[mid] < w) lo = mid + 1; else hi = mid;
      }
      if (lo < ndb && db_words[lo] == w) {
        hit_code[m] = db_codes[lo];
        hit_pos[m] = i - k + 1;
        hit_dir[m] = (unsigned char) (w != fw);
        m += 1;
      }
    }
  }
  free (off);
  *n_valid_out = n_valid;
  return m;
}

/* Big-DB twin of fgx_index_hits (same contract, same hit stream
 * bit-for-bit).  Past a few million DB words the sorted table no
 * longer fits cache and the rolling binary search pays DRAM misses
 * per level (~8 M windows/s measured at 30 M words / 240 MB).
 * MEASURED COUNTER-RESULT (round 3, this 1-vCPU container): a full
 * inverted join — MSD-bucket (word, pos) pairs so each bucket
 * searches an L2-resident DB range, then radix-sort the hits back to
 * stream order — is SLOWER at every DB size (14 vs 77 M windows/s at
 * 200k words, 7 vs 9 M at 30 M): the pair scatter's first-touch +
 * random-write traffic costs more than the misses it saves.  What
 * wins is keeping the rolling search but running BATCHES of windows
 * through software-pipelined binary search: per level, one pass
 * computes every lane's midpoint and prefetches it, the next pass
 * consumes it — FGX_SEARCH_LANES independent misses in flight instead
 * of one (memory-level parallelism).  64 lanes measured best (256
 * overflows the miss queue and regresses); ~1.4x at 30 M DB words,
 * below ~4 M the plain loop wins (measured on the host CPU). */
#define FGX_SEARCH_LANES 64

long fgx_index_hits_batched (const unsigned char *codes, long n, int k,
                             const unsigned long long *db_words,
                             const unsigned int *db_codes, long ndb,
                             unsigned int *hit_code, long long *hit_pos,
                             unsigned char *hit_dir,
                             long long *n_valid_out)
{
  unsigned long long wmask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  int rc_shift = 2 * (k - 1);
  unsigned long long fw = 0, rc = 0;
  int run = 0;
  long i, m = 0;
  long long n_valid = 0;
  enum { PBITS = 20 };
  int shift = 2 * k - PBITS;
  unsigned int *off = NULL;
  unsigned long long bw[FGX_SEARCH_LANES];
  long bp[FGX_SEARCH_LANES];
  unsigned char bd[FGX_SEARCH_LANES];
  long lo[FGX_SEARCH_LANES], hi[FGX_SEARCH_LANES], mid[FGX_SEARCH_LANES];
  int nb = 0, j;
  if (shift > 0 && ndb >= (1 << 16)) {
    long p, d = 0;
    off = (unsigned int *) malloc (((1 << PBITS) + 1)
                                   * sizeof (unsigned int));
    if (off) {
      for (p = 0; p <= (1 << PBITS); p++) {
        while (d < ndb && (long) (db_words[d] >> shift) < p) d += 1;
        off[p] = (unsigned int) d;
      }
    }
  }
  for (i = 0; i <= n; i++) {
    if (i < n) {
      unsigned int c = codes[i];
      if (c > 3) { run = 0; }
      else {
        fw = ((fw << 2) | c) & wmask;
        rc = (rc >> 2) | ((unsigned long long) (3 - c) << rc_shift);
        if (++run >= k) {
          unsigned long long w = (fw < rc) ? fw : rc;
          bw[nb] = w;
          bp[nb] = i - k + 1;
          bd[nb] = (unsigned char) (w != fw);
          /* the 4 MB offset table misses too — start its line now so
           * the flush's range setup finds it resident */
          if (off) __builtin_prefetch (&off[w >> shift], 0, 0);
          nb += 1;
          n_valid += 1;
        }
      }
      if (nb < FGX_SEARCH_LANES) continue;
    }
    if (nb == 0) continue;
    /* flush: interleaved binary search, one level per round */
    for (j = 0; j < nb; j++) {
      if (off) {
        unsigned long long p = bw[j] >> shift;
        lo[j] = off[p];
        hi[j] = off[p + 1];
      } else {
        lo[j] = 0;
        hi[j] = ndb;
      }
    }
    for (;;) {
      int active = 0;
      for (j = 0; j < nb; j++) {
        if (lo[j] < hi[j]) {
          mid[j] = (lo[j] + hi[j]) >> 1;
          __builtin_prefetch (&db_words[mid[j]], 0, 0);
          active = 1;
        }
      }
      if (!active) break;
      for (j = 0; j < nb; j++) {
        if (lo[j] < hi[j]) {
          if (db_words[mid[j]] < bw[j]) lo[j] = mid[j] + 1;
          else hi[j] = mid[j];
        }
      }
    }
    for (j = 0; j < nb; j++) {
      if (lo[j] < ndb && db_words[lo[j]] == bw[j]) {
        hit_code[m] = db_codes[lo[j]];
        hit_pos[m] = bp[j];
        hit_dir[m] = bd[j];
        m += 1;
      }
    }
    nb = 0;
  }
  free (off);
  *n_valid_out = n_valid;
  return m;
}

/* Batched point lookups over the RAW 12-byte record stream of a .list
 * mmap — no contiguous copy of the 600 MB word column (numpy's
 * searchsorted needs one, 2.5 s at 50M records; round-3 find), and
 * FGX_SEARCH_LANES interleaved searches keep that many misses in
 * flight (same software pipelining as fgx_index_hits_batched).
 * Queries may be in any order; sorted queries add locality.
 * out[j] = count of q[j], or 0 when absent. */
void fgx_lookup_records_batched (const unsigned char *recs, long n,
                                 const unsigned long long *q, long nq,
                                 unsigned int *out)
{
  long b0;
  for (b0 = 0; b0 < nq; b0 += FGX_SEARCH_LANES) {
    int nb = (nq - b0 < FGX_SEARCH_LANES) ? (int) (nq - b0)
             : FGX_SEARCH_LANES;
    long lo[FGX_SEARCH_LANES], hi[FGX_SEARCH_LANES];
    long mid[FGX_SEARCH_LANES];
    int j;
    for (j = 0; j < nb; j++) { lo[j] = 0; hi[j] = n; }
    for (;;) {
      int active = 0;
      for (j = 0; j < nb; j++) {
        if (lo[j] < hi[j]) {
          mid[j] = (lo[j] + hi[j]) >> 1;
          __builtin_prefetch (recs + 12 * mid[j], 0, 0);
          active = 1;
        }
      }
      if (!active) break;
      for (j = 0; j < nb; j++) {
        if (lo[j] < hi[j]) {
          unsigned long long w;
          __builtin_memcpy (&w, recs + 12 * mid[j], 8);
          if (w < q[b0 + j]) lo[j] = mid[j] + 1;
          else hi[j] = mid[j];
        }
      }
    }
    for (j = 0; j < nb; j++) {
      unsigned int c = 0;
      if (lo[j] < n) {
        unsigned long long w;
        __builtin_memcpy (&w, recs + 12 * lo[j], 8);
        if (w == q[b0 + j])
          __builtin_memcpy (&c, recs + 12 * lo[j] + 8, 4);
      }
      out[b0 + j] = c;
    }
  }
}

/* The .index k-mer block from the sorted word column: one pass over
 * runs of equal words emitting interleaved (word, loc_start) u64
 * pairs. Offsets accumulate over KEPT words only while every word's
 * locations are still written — the reference's cutoff bug, see
 * formats/index_format.py (src/glistmaker.c:628-782). Returns the
 * record count; *num_locations_out gets the kept-count sum. Replaces
 * a ~6-pass numpy mask/cumsum/gather/interleave chain (round 3). */
long fgx_index_kmer_records (const unsigned long long *aw, long n,
                             unsigned int min_count,
                             unsigned int max_count,
                             unsigned long long *recs,
                             unsigned long long *num_locations_out)
{
  long i = 0, m = 0;
  unsigned long long loc = 0;
  while (i < n) {
    unsigned long long w = aw[i];
    long j = i + 1;
    unsigned int c;
    while (j < n && aw[j] == w) j++;
    c = (unsigned int) (j - i);
    if (c >= min_count && c <= max_count) {
      recs[2 * m] = w;
      recs[2 * m + 1] = loc;
      loc += c;
      m++;
    }
    i = j;
  }
  *num_locations_out = loc;
  return m;
}

/* Counts of SORTED queries against the raw record stream: one linear
 * dual-pointer zipper, O(n + nq) streaming — for glistquery -l both
 * sides are sorted .lists, so the reference's zipper
 * (src/glistquery.c:702-717) is the right shape, not nq binary
 * searches (round 3: 2.9 s of pipelined searches -> ~0.4 s).
 * Duplicate queries are fine (the table cursor holds). */
void fgx_lookup_records_zipper (const unsigned char *recs, long n,
                                const unsigned long long *q, long nq,
                                unsigned int *out)
{
  long i = 0, j;
  unsigned long long w = 0;
  if (n > 0) __builtin_memcpy (&w, recs, 8);
  for (j = 0; j < nq; j++) {
    unsigned long long qq = q[j];
    unsigned int c = 0;
    while (i < n && w < qq) {
      i++;
      if (i < n) __builtin_memcpy (&w, recs + 12 * i, 8);
    }
    if (i < n && w == qq)
      __builtin_memcpy (&c, recs + 12 * i + 8, 4);
    out[j] = c;
  }
}

/* Occurrence counts of every (sorted, unique) DB word in a SORTED
 * window stream: one dual-pointer merge pass, O(n + ndb) streaming —
 * numpy's searchsorted costs 4.2 s for the same answer at 30 M DB
 * words / 22 M windows because it runs 2x30M independent bisections
 * that cannot exploit the queries being sorted too (round-3
 * measurement; this pass is ~0.2 s). acc[i] += count, so per-slab
 * calls accumulate. */
void fgx_sorted_occurrences (const unsigned long long *words, long n,
                             const unsigned long long *db, long ndb,
                             unsigned long long *acc)
{
  long i = 0, d;
  for (d = 0; d < ndb; d++) {
    unsigned long long w = db[d];
    while (i < n && words[i] < w) i++;
    if (i < n && words[i] == w) {
      long j = i;
      while (j < n && words[j] == w) j++;
      acc[d] += (unsigned long long) (j - i);
      i = j;
    }
  }
}

/* Rolling canonical extraction with window positions + directions —
 * the glistmaker --index host path needs (word, start, is_rc) per
 * valid window (reference record loop src/glistmaker.c:1052-1068).
 * Same rolling recurrence as fgx_extract_canonical. Returns the
 * window count. */
long fgx_extract_canonical_posdir (const unsigned char *codes, long n,
                                   int k, unsigned long long *words,
                                   long long *pos, unsigned char *dirs)
{
  unsigned long long wmask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  int rc_shift = 2 * (k - 1);
  unsigned long long fw = 0, rc = 0;
  int run = 0;
  long i, m = 0;
  for (i = 0; i < n; i++) {
    unsigned int c = codes[i];
    if (c > 3) { run = 0; continue; }
    fw = ((fw << 2) | c) & wmask;
    rc = (rc >> 2) | ((unsigned long long) (3 - c) << rc_shift);
    if (++run >= k) {
      unsigned long long w = (fw < rc) ? fw : rc;
      words[m] = w;
      pos[m] = i - k + 1;
      dirs[m] = (unsigned char) (w != fw);
      m += 1;
    }
  }
  return m;
}

/* STABLE LSD radix pair sort: orders (keys[i], vals[i]) by keys,
 * preserving the relative order of equal keys (the --index path relies
 * on this: location codes arrive ascending, so one stable sort by word
 * yields the full lexicographic order). 13-bit digits measured best on
 * this VM class (0.79 s vs 1.08 s with 8-bit at 10M pairs / 50 key
 * bits: 4 passes instead of 7, 64 KB histogram stays L2-resident);
 * digit passes where all keys agree are skipped. Returns 0, or -1 on
 * allocation failure. */
#define FGX_PAIR_DBITS 13
#define FGX_PAIR_DSIZE (1L << FGX_PAIR_DBITS)

int fgx_sort_pair_u64 (unsigned long long *keys, unsigned long long *vals,
                       long n, int key_bits)
{
  int n_digits = (key_bits + FGX_PAIR_DBITS - 1) / FGX_PAIR_DBITS, d;
  unsigned long long *kt = (unsigned long long *)
    malloc ((size_t) (n > 0 ? n : 1) * 8);
  unsigned long long *vt = (unsigned long long *)
    malloc ((size_t) (n > 0 ? n : 1) * 8);
  long *h = (long *) malloc ((FGX_PAIR_DSIZE + 1) * sizeof (long));
  unsigned long long *ks = keys, *vs = vals, *kd = kt, *vd = vt;
  unsigned long long mask = FGX_PAIR_DSIZE - 1;
  long i;
  if (!kt || !vt || !h) { free (kt); free (vt); free (h); return -1; }
  for (d = 0; d < n_digits; d++) {
    int sh = d * FGX_PAIR_DBITS;
    memset (h, 0, (FGX_PAIR_DSIZE + 1) * sizeof (long));
    for (i = 0; i < n; i++) h[((ks[i] >> sh) & mask) + 1] += 1;
    if (n > 0 && h[(long) ((ks[0] >> sh) & mask) + 1] == n) continue;
    for (i = 0; i < FGX_PAIR_DSIZE; i++) h[i + 1] += h[i];
    for (i = 0; i < n; i++) {
      long t = h[(ks[i] >> sh) & mask]++;
      kd[t] = ks[i];
      vd[t] = vs[i];
    }
    { unsigned long long *t = ks; ks = kd; kd = t; }
    { unsigned long long *t = vs; vs = vd; vd = t; }
  }
  if (ks != keys) {
    memcpy (keys, ks, (size_t) n * 8);
    memcpy (vals, vs, (size_t) n * 8);
  }
  free (kt);
  free (vt);
  free (h);
  return 0;
}

/* gmer_counter default per-node output: "NAME\tNK\tc1\t...\tcNK\n"
 * (src/gmer_counter.c:636-663, --kmers only). names is a blob indexed
 * by name_off (NUL- or tab-terminated; name_len gives the byte count).
 * Returns bytes written. */
long fgx_format_node_counts (const unsigned char *names,
                             const long long *name_off,
                             const int *name_len,
                             const long long *starts,
                             const long long *nks,
                             const unsigned long long *counts,
                             long n_nodes, unsigned char *out)
{
  long o = 0, i, j;
  for (i = 0; i < n_nodes; i++) {
    long nk = nks[i];
    __builtin_memcpy (out + o, names + name_off[i], (size_t) name_len[i]);
    o += name_len[i];
    out[o++] = '\t';
    o += put_uint (out + o, (unsigned long long) nk);
    for (j = 0; j < nk; j++) {
      out[o++] = '\t';
      o += put_uint (out + o, counts[starts[i] + j]);
    }
    out[o++] = '\n';
  }
  return o;
}

/* ------------------------------------------------------------------ */
/* glistcompare -mm: mismatch-neighborhood candidate filter            */
/* (src/glistcompare.c:1095-1169 find_diff/search_query semantics)     */
/* ------------------------------------------------------------------ */

/* full-word reverse complement (same butterfly as
 * ops/encode.reverse_complement_u64; src/sequence.c:65-79) */
static inline unsigned long long rc_u64 (unsigned long long w, int k)
{
  w = ~w;
  w = ((w & 0x3333333333333333ULL) << 2) | ((w >> 2) & 0x3333333333333333ULL);
  w = ((w & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((w >> 4) & 0x0F0F0F0F0F0F0F0FULL);
  w = __builtin_bswap64 (w);
  return w >> (64 - 2 * k);
}

static inline int u64_present (const unsigned long long *a, long n,
                               unsigned long long v)
{
  long lo = 0, hi = n;
  while (lo < hi) {
    long mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return (lo < n) && (a[lo] == v);
}

/* For every still-alive candidate, canonicalize its XOR-mask
 * neighborhood and count PRESENT neighbor words in mw (the reference's
 * dict lookup returns the found flag, not the count — see the Python
 * twin in pipelines/listcompare.compare_pair_mm).  Non-subtract mode
 * drops as soon as the running present-count reaches the cutoff (the
 * sum is monotone and < 2^32, so the early exit is exact); subtract
 * mode drops immediately when a neighbor is present in mw more than in
 * qw, else accumulates the signed difference and applies the Python
 * twin's u32 wrap before the cutoff test.  Returns the kill count. */
long fgx_mm_filter (const unsigned long long *cand, long n, int k,
                    const unsigned long long *masks, long nmask,
                    const unsigned long long *mw, long nmw,
                    const unsigned long long *qw, long nqw,
                    unsigned int cutoff, int subtract,
                    unsigned char *alive)
{
  long i, j, killed = 0;
  for (i = 0; i < n; i++) {
    if (!alive[i]) continue;
    unsigned long long w = cand[i];
    long long sum = 0;
    int drop = 0;
    if (subtract) {
      for (j = 0; j < nmask; j++) {
        unsigned long long nb = w ^ masks[j];
        unsigned long long rc = rc_u64 (nb, k);
        if (rc < nb) nb = rc;
        int cur = u64_present (mw, nmw, nb);
        int qf = u64_present (qw, nqw, nb);
        if (cur > qf) { drop = 1; break; }
        sum += cur - qf;
      }
    } else {
      for (j = 0; j < nmask; j++) {
        unsigned long long nb = w ^ masks[j];
        unsigned long long rc = rc_u64 (nb, k);
        if (rc < nb) nb = rc;
        sum += u64_present (mw, nmw, nb);
        if ((unsigned long long) sum >= cutoff) { drop = 1; break; }
      }
    }
    if (!drop && (unsigned int) ((unsigned long long) sum & 0xFFFFFFFFULL)
        >= cutoff)
      drop = 1;
    if (drop) { alive[i] = 0; killed++; }
  }
  return killed;
}
