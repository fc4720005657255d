/* FastGT exact-math kernel library.
 *
 * gmer_caller's genotype model is an empirical-Bayes classifier whose
 * published behavior is defined by specific float/double mixed-precision
 * arithmetic, libm lgamma/log/exp, and the glibc rand() stream seeded
 * with srand(1) (reference: src/gmer_caller.c, src/genotypes.c,
 * src/binomial.c, src/simplex.c).  Reproducing those call outputs
 * bit-for-bit is impossible from JAX (different libm, different
 * reductions), so the exact path lives here as a host-native library:
 * Python orchestrates I/O and formatting, this library does the numeric
 * inner loops (vectorized over markers), and a separate jnp
 * implementation (genometester4_tpu/models/genotype.py) is a float32
 * device twin for throughput work.
 *
 * Everything here is a fresh implementation written against the
 * reference's observed semantics; expression groupings and precision
 * mixes are preserved deliberately, because they are the file format,
 * so to speak, of this model.
 *
 * Build: gcc -O2 -shared -fPIC fastgt_exact.c -o libfastgt_exact.so -lm
 * (no -march / -ffast-math: the reference builds plain -O3 x86-64 SSE2,
 * with no FMA contraction available, src/Makefile:168-176).
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define N_GT 15
#define TABLE_N 16384 /* log-factorial table size, src/binomial.c:11 */

/* ------------------------------------------------------------------ */
/* binomial / negative binomial kernels (semantics: src/binomial.c)    */
/* ------------------------------------------------------------------ */

static double *lf_d = NULL;   /* log n!   (double) */
static double *ls_d = NULL;   /* sum_{j=1..n} log j built the slow way */
static volatile int tables_ready = 0;

static void build_tables (void)
{
  unsigned int i, j;
  lf_d = (double *) malloc (TABLE_N * sizeof (double));
  lf_d[0] = 0;
  for (i = 1; i < TABLE_N; i++) lf_d[i] = lf_d[i - 1] + log (i);
  /* the reference accumulates these per-entry from scratch
   * (src/binomial.c:40-51), giving slightly different rounding than a
   * running sum - reproduce that summation order */
  ls_d = (double *) malloc (TABLE_N * sizeof (double));
  {
    double *logs = (double *) malloc (TABLE_N * sizeof (double));
    for (i = 1; i < TABLE_N; i++) {
      logs[i] = log (i);
      ls_d[i] = logs[i];
      for (j = 2; j < i; j++) ls_d[i] += logs[j];
    }
    free (logs);
  }
}

/* Lazy: the O(TABLE_N^2) reference-rounding-order build costs ~90 ms,
 * which pure list-path CLI runs (glistquery dumps, set ops) must not
 * pay. Called from the table gateways fgx_dbinom/fgx_dnbinom_mu, which
 * run inside OpenMP regions (fgx_genotype_batch) - hence the critical
 * section; tables_ready is written only after the build completes. */
void fgx_init (void)
{
  if (tables_ready) return;
#pragma omp critical (fgx_tables)
  {
    if (!tables_ready) {
      build_tables ();
      tables_ready = 1;
    }
  }
}

static double log_factorial (unsigned int v)
{
  double dv = v;
  double val = 0;
  while (v >= TABLE_N) {
    val += log (dv);
    dv -= 1;
    v -= 1;
  }
  return val + lf_d[v];
}

static double log_combinations_d (unsigned int n, unsigned int k)
{
  if (!k || (k == n)) return 0;
  if (k == 1) return log (n);
  if (n >= TABLE_N) {
    double num = log (n), den = log (k);
    while (k > 1) {
      n -= 1;
      k -= 1;
      num += log (n);
      den -= log (k);
    }
    return num - den;
  }
  return ls_d[n] - ls_d[n - k] - ls_d[k];
}

double fgx_dbinom (unsigned int x, unsigned int n, double p)
{
  fgx_init ();
  if ((x == 0) && (p == 0)) return 1;
  if ((x == n) && (p == 1)) return 1;
  {
    double c = exp (log_combinations_d (n, x));
    double p0 = pow (p, x);
    double p1 = pow (1 - p, n - x);
    return c * p0 * p1;
  }
}

static double log_comb_k_r (unsigned int k, double r)
{
  if (!k) return 0;
  return lgamma (k + r) - lgamma (r) - log_factorial (k);
}

double fgx_dnbinom_mu (unsigned int x, double size, double mu)
{
  double p, c, p0, p1;
  fgx_init ();
  if (size <= 0) return 0;
  if (mu <= 0) return 0;
  p = mu / (size + mu);
  c = log_comb_k_r (x, size);
  p0 = log (p) * x;
  p1 = log (1 - p) * size;
  return exp (c + p0 + p1);
}

double fgx_poisson (unsigned int k, double lambda)
{
  double dk = k;
  double dl = lambda;
  double p = exp (-dl);
  while (k > 0) {
    p *= dl;
    p /= dk;
    dk -= 1;
    k -= 1;
  }
  return p;
}

/* ------------------------------------------------------------------ */
/* 15-genotype posterior (semantics: src/genotypes.c:10-125)           */
/* ------------------------------------------------------------------ */

/* negbin mu levels shared by the genotype table */
enum { MU_ERR, MU_HALF, MU_FULL, MU_15, MU_2, N_MU };

/* (allele-A count level, allele-B count level) per genotype, in the
 * X,A,B,AA,AB,BB,AAA,AAB,BBA,BBB,AAAA,AAAB,BBBA,AABB,BBBB order of
 * src/genotypes.h:4-6 */
static const unsigned char GT_MU[N_GT][2] = {
  {MU_ERR, MU_ERR},   /* X    */
  {MU_HALF, MU_ERR},  /* A    */
  {MU_ERR, MU_HALF},  /* B    */
  {MU_FULL, MU_ERR},  /* AA   */
  {MU_HALF, MU_HALF}, /* AB   */
  {MU_ERR, MU_FULL},  /* BB   */
  {MU_15, MU_ERR},    /* AAA  */
  {MU_FULL, MU_HALF}, /* AAB  */
  {MU_HALF, MU_FULL}, /* BBA  */
  {MU_ERR, MU_15},    /* BBB  */
  {MU_2, MU_ERR},     /* AAAA */
  {MU_15, MU_HALF},   /* AAAB */
  {MU_HALF, MU_15},   /* BBBA */
  {MU_FULL, MU_FULL}, /* AABB */
  {MU_ERR, MU_2},     /* BBBB */
};

void fgx_genotype_probabilities (double a[], float pB,
                                 unsigned int var1, unsigned int var2,
                                 double l_viga, double p_0, double p_1,
                                 double p_2, double lambda, double size,
                                 double size2)
{
  double p[N_GT];
  double mu[N_MU], sz[N_MU], q1[N_MU], q2[N_MU];
  double pb = pB, pa = 1 - pb;
  double p_lisa, pl1, pl2;
  unsigned int g, l;

  p[0] = p_0;
  p[1] = pa * p_1;
  p[2] = pb * p_1;
  p[3] = pa * pa * p_2;
  p[4] = 2 * pa * pb * p_2;
  p[5] = pb * pb * p_2;
  p_lisa = 1 - p_0 - p_1 - p_2;
  if (p_lisa >= 0) {
    /* sqrtf, not sqrt: the reference computes the 3-copy prior in float
     * (src/genotypes.c:31) */
    pl1 = (-1 + sqrtf (1 + 4 * p_lisa)) / 2;
    pl2 = pl1 * pl1;
  } else {
    pl1 = 0;
    pl2 = 0;
  }
  p[6] = fgx_dbinom (3, 3, pa) * pl1;  /* AAA */
  p[7] = fgx_dbinom (2, 3, pa) * pl1;  /* AAB */
  p[8] = fgx_dbinom (1, 3, pa) * pl1;  /* BBA */
  p[9] = fgx_dbinom (0, 3, pa) * pl1;  /* BBB */
  p[10] = fgx_dbinom (4, 4, pa) * pl2; /* AAAA */
  p[11] = fgx_dbinom (3, 4, pa) * pl2; /* AAAB */
  p[12] = fgx_dbinom (1, 4, pa) * pl2; /* BBBA */
  p[13] = fgx_dbinom (2, 4, pa) * pl2; /* AABB */
  p[14] = fgx_dbinom (0, 4, pa) * pl2; /* BBBB */

  /* mu / size per coverage level; groupings must match the reference's
   * inline expressions (e.g. size + size2 * lambda / 2 groups as
   * size + ((size2 * lambda) / 2)) */
  mu[MU_ERR] = l_viga;
  sz[MU_ERR] = size + size2 * l_viga;
  mu[MU_HALF] = lambda / 2;
  sz[MU_HALF] = size + size2 * lambda / 2;
  mu[MU_FULL] = lambda;
  sz[MU_FULL] = size + size2 * lambda;
  mu[MU_15] = lambda * 1.5;
  sz[MU_15] = size + size2 * lambda * 1.5;
  mu[MU_2] = lambda * 2;
  sz[MU_2] = size + size2 * lambda * 2;
  for (l = 0; l < N_MU; l++) {
    q1[l] = fgx_dnbinom_mu (var1, sz[l], mu[l]);
    q2[l] = fgx_dnbinom_mu (var2, sz[l], mu[l]);
  }
  for (g = 0; g < N_GT; g++) {
    a[g] = q1[GT_MU[g][0]] * q2[GT_MU[g][1]] * p[g];
  }
}

/* ------------------------------------------------------------------ */
/* batch posterior for printing (semantics: src/gmer_caller.c:363-388) */
/* ------------------------------------------------------------------ */

void fgx_genotype_batch (const unsigned short *counts /* 2n */,
                         unsigned int n, float pB, const float params[7],
                         double *out_a /* n*15 */, double *out_sum,
                         unsigned int *out_best)
{
  long long i;
  unsigned int j;
  /* markers are independent and write disjoint slots: parallelism
   * cannot change any output bit */
#ifdef _OPENMP
#pragma omp parallel for schedule(static) private(j)
#endif
  for (i = 0; i < (long long) n; i++) {
    double *a = out_a + (size_t) i * N_GT;
    double best;
    fgx_genotype_probabilities (a, pB, counts[2 * i], counts[2 * i + 1],
                                params[0], params[1], params[2], params[3],
                                params[4], params[5], params[6]);
    out_sum[i] = a[0];
    out_best[i] = 0;
    best = a[0];
    for (j = 1; j < N_GT; j++) {
      out_sum[i] += a[j];
      if (a[j] > best) {
        out_best[i] = j;
        best = a[j];
      }
    }
  }
}

/* ------------------------------------------------------------------ */
/* training objective (semantics: src/gmer_caller.c:811-914)           */
/* ------------------------------------------------------------------ */

#define MIN_P (1.0f / 8192)
#define MAX_E 0.25f

static float logit_clamped (float p, float min, float max)
{
  if (p <= min) p = min;
  else if (p >= max) p = max;
  else p = (p - min) / (max - min);
  return logf (p / (1 - p));
}

static float logit_1_clamped (float a, float min, float max)
{
  a = 1 / (1 + expf (-a));
  return min + (max - min) * a;
}

typedef struct {
  const unsigned int *var1;
  const unsigned int *var2;
  unsigned int n_calls;
  float pB;
  float lambda_est;
  float lambda_sigma;
  unsigned int n_chunks;
  unsigned int chunk_size;
} Objective;

static double chunk_neg_loglik (const Objective *obj, unsigned int first,
                                unsigned int count, float l_viga, float p_0,
                                float p_1, float p_2, float lambda,
                                float size, float size2)
{
  double sum = 0;
  unsigned int i;
  for (i = 0; i < count; i++) {
    double a[N_GT];
    double call_sum = 0;
    int j;
    fgx_genotype_probabilities (a, obj->pB, obj->var1[first + i],
                                obj->var2[first + i], l_viga, p_0, p_1, p_2,
                                lambda, size, size2);
    for (j = 0; j < N_GT; j++) call_sum += a[j];
    if (call_sum < 1e-30) call_sum = 1e-30;
    sum += log (call_sum);
  }
  /* per-chunk coverage prior (float arithmetic, added to the double
   * chunk sum, src/gmer_caller.c:855-858) */
  return -sum + count * (obj->lambda_est - lambda) * (obj->lambda_est - lambda)
         / (obj->lambda_sigma * obj->lambda_sigma);
}

static float objective_distance (int ndim, const float params[], void *data)
{
  Objective *obj = (Objective *) data;
  float l_viga = logit_1_clamped (params[0], MIN_P, MAX_E);
  float p_0 = logit_1_clamped (params[1], MIN_P, 1 - MIN_P);
  float p_1 = logit_1_clamped (params[2], MIN_P, 1 - MIN_P);
  float p_2 = logit_1_clamped (params[3], MIN_P, 1 - MIN_P);
  float lambda = expf (params[4]);
  float size = params[5];
  float size2 = -expf (params[6]);
  double result = 0;
  double delta0, delta1;
  double stack_sums[256];
  double *chunk_sums;
  int c, n_chunks = (int) obj->n_chunks;
  chunk_sums = (n_chunks <= 256) ? stack_sums
               : (double *) malloc (n_chunks * sizeof (double));
  (void) ndim;
  /* chunk sums are combined in chunk order AFTER the parallel section:
   * this reproduces the reference's thread-pool fan-out, whose partial
   * sums are added in thread-index order regardless of completion order
   * (src/gmer_caller.c:875-880) — so OpenMP here cannot change the
   * result bit (each chunk's serial sum is unchanged, and the final
   * reduction order is fixed) */
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (c = 0; c < n_chunks; c++) {
    unsigned int first = c * obj->chunk_size;
    unsigned int count = obj->chunk_size;
    if (first + count > obj->n_calls) count = obj->n_calls - first;
    chunk_sums[c] = chunk_neg_loglik (obj, first, count, l_viga, p_0, p_1,
                                      p_2, lambda, size, size2);
  }
  for (c = 0; c < n_chunks; c++) result += chunk_sums[c];
  if (chunk_sums != stack_sums) free (chunk_sums);
  if (p_0 + p_1 + p_2 > 1) {
    result = result + 10000 - 100000 * (1 - p_0 - p_1 - p_2);
  }
  delta0 = size + size2 * lambda / 2;
  if (delta0 < 0) result = result + 10000 + 100 * delta0;
  delta1 = size + size2 * l_viga;
  if (delta1 < 0) result = result + 10000 + 100 * delta1;
  return (float) result;
}

/* ------------------------------------------------------------------ */
/* Nelder-Mead downhill simplex (semantics: src/simplex.c:14-209)      */
/*                                                                     */
/* This must track the reference's unusual variant decision-for-       */
/* decision: restarts perturb the start point with glibc rand(), the   */
/* contraction failure path tries point reflection through the low     */
/* vertex and then a quartic line search before collapsing, and all    */
/* vertex math is float with double-literal promotion.                 */
/* ------------------------------------------------------------------ */

typedef float (*fgx_objective) (int, const float[], void *);

float fgx_downhill_simplex (int ndim, float mx[], float mdx[], float emax,
                            int nruns, int niterations, fgx_objective func,
                            void *data)
{
  float mp[26][25];
  float pb[25], pr[25], prr[25];
  float y[26];
  int i, j, run, iter;
  int ilo = 0, ihi, inhi;
  int npts = ndim + 1;
  float al = 1.0, bt = 0.5, gm = 2.0;
  float ypr, yprr;
  (void) emax;

  y[0] = func (ndim, mx, data);
  for (run = 0; run < nruns; run++) {
    for (i = 0; i < ndim; i++) {
      for (j = 0; j < npts; j++) mp[j][i] = mx[i];
      mp[i][i] += mdx[i] * (0.9 + 0.2 * rand () / RAND_MAX) / (5 * run + 1);
    }
    for (j = 0; j <= ndim; j++) {
      for (i = 0; i < ndim; i++) mx[i] = mp[j][i];
      y[j] = func (ndim, mx, data);
    }
    for (iter = 0; iter < niterations; iter++) {
      ilo = 0;
      if (y[0] > y[1]) { ihi = 0; inhi = 1; }
      else { ihi = 1; inhi = 0; }
      for (i = 0; i < npts; i++) {
        if (y[i] < y[ilo]) ilo = i;
        if (y[i] > y[ihi]) { inhi = ihi; ihi = i; }
        else if (y[i] > y[inhi]) { if (i != ihi) inhi = i; }
      }
      /* centroid of all but the worst */
      for (j = 0; j < ndim; j++) pb[j] = 0.0;
      for (i = 0; i < npts; i++) {
        if (i != ihi) for (j = 0; j < ndim; j++) pb[j] += mp[i][j];
      }
      for (j = 0; j < ndim; j++) {
        pb[j] /= ndim;
        pr[j] = (1.0 + al) * pb[j] - al * mp[ihi][j];
      }
      for (j = 0; j < ndim; j++) mx[j] = pr[j];
      ypr = func (ndim, mx, data);
      if (ypr <= y[ilo]) {
        /* expand */
        for (j = 0; j < ndim; j++) prr[j] = gm * pr[j] + (1.0 - gm) * pb[j];
        for (j = 0; j < ndim; j++) mx[j] = prr[j];
        yprr = func (ndim, mx, data);
        if (ypr > yprr) {
          for (j = 0; j < ndim; j++) mp[ihi][j] = prr[j];
          y[ihi] = yprr;
        } else {
          for (j = 0; j < ndim; j++) mp[ihi][j] = pr[j];
          y[ihi] = ypr;
        }
      } else if (ypr >= y[inhi]) {
        if (ypr < y[ihi]) {
          for (j = 0; j < ndim; j++) mp[ihi][j] = pr[j];
          y[ihi] = ypr;
        }
        /* contract toward centroid */
        for (j = 0; j < ndim; j++) prr[j] = bt * mp[ihi][j] + (1.0 - bt) * pb[j];
        for (j = 0; j < ndim; j++) mx[j] = prr[j];
        yprr = func (ndim, mx, data);
        if (yprr < y[ihi]) {
          for (j = 0; j < ndim; j++) mp[ihi][j] = prr[j];
          y[ihi] = yprr;
        } else {
          /* midpoint toward the best vertex */
          for (j = 0; j < ndim; j++) pr[j] = 0.5 * (mp[ihi][j] + mp[ilo][j]);
          for (j = 0; j < ndim; j++) mx[j] = pr[j];
          ypr = func (ndim, mx, data);
          if (ypr < y[ihi]) {
            for (j = 0; j < ndim; j++) mp[ihi][j] = pr[j];
            y[ihi] = ypr;
          } else {
            /* reflect the worst through the best */
            for (j = 0; j < ndim; j++) prr[j] = -mp[ihi][j] + 2.0 * mp[ilo][j];
            for (j = 0; j < ndim; j++) mx[j] = prr[j];
            yprr = func (ndim, mx, data);
            if (yprr < y[ihi]) {
              for (j = 0; j < ndim; j++) mp[ihi][j] = prr[j];
              y[ihi] = yprr;
            } else {
              /* quartic model line search along (lo -> hi) */
              float xa = 3 * y[ihi] - 8 * ypr + 6 * y[ilo] - yprr;
              float xb = y[ihi] - 2 * y[ilo] + yprr;
              float xc = -0.5 * y[ihi] + 8 * ypr / 3 - 2 * y[ilo] + yprr / 6;
              float xd = xb * xb - 4 * xa * xc;
              if (xd > 0) {
                float lmin = 0.5 * (-xb - sqrt (xd)) / xa;
                if (isfinite (lmin)) {
                  for (j = 0; j < ndim; j++)
                    pr[j] = lmin * mp[ihi][j] + (1 - lmin) * mp[ilo][j];
                } else {
                  for (j = 0; j < ndim; j++)
                    pr[j] = 0.5f * mp[ihi][j] + 0.5f * mp[ilo][j];
                }
                for (j = 0; j < ndim; j++) mx[j] = pr[j];
                ypr = func (ndim, mx, data);
              }
              if (ypr < y[ihi]) {
                for (j = 0; j < ndim; j++) mp[ihi][j] = pr[j];
                y[ihi] = ypr;
              } else {
                /* collapse the worst onto the best */
                for (j = 0; j < ndim; j++) mp[ihi][j] = mp[ilo][j];
                y[ihi] = y[ilo];
              }
            }
          }
        }
      } else {
        for (j = 0; j < ndim; j++) mp[ihi][j] = pr[j];
        y[ihi] = ypr;
      }
    }
    ilo = 0;
    for (i = 1; i < npts; i++) if (y[i] < y[ilo]) ilo = i;
    for (i = 0; i < ndim; i++) mx[i] = mp[ilo][i];
  }
  return y[ilo];
}

/* ------------------------------------------------------------------ */
/* training driver (semantics: src/gmer_caller.c:225-347)              */
/* ------------------------------------------------------------------ */

void fgx_srand (unsigned int seed) { srand (seed); }

/* expose the glibc rand stream and libm lgamma for host-side callers
 * that must consume them in reference order (gassembler coverage
 * sampling / read subsampling, exome-model likelihoods) */
int fgx_rand (void) { return rand (); }

/* Fast-forward the glibc rand() stream: lets parallel gassembler
 * workers start their region at the exact offset the sequential run
 * would have reached (each >200-read region consumes exactly 200
 * calls, src/gassembler.c:2619-2626). */
void fgx_rand_skip (unsigned long n) { while (n--) rand (); }
double fgx_lgamma (double x) { return lgamma (x); }

static unsigned long long rand_ull (unsigned long long min_v,
                                    unsigned long long max_v)
{
  unsigned long long delta = max_v - min_v + 1;
  return min_v + (unsigned long long) (delta * (rand () / (RAND_MAX + 1.0)));
}

float fgx_allele_freq (const unsigned short *counts, unsigned int n)
{
  double ppb = 0, npb = 0;
  unsigned int i;
  for (i = 0; i < n; i++) {
    unsigned int c0 = counts[2 * i], c1 = counts[2 * i + 1];
    if (c0 + c1) {
      ppb += (1.0f * c1) / (c0 + c1);
      npb += 1;
    }
  }
  return npb ? (float) (ppb / npb) : 0;
}

/* returns 0 if training was aborted (empty sample), 1 otherwise.
 * debug mirrors the reference's level-1 -D chatter from train_model
 * (src/gmer_caller.c:238-270,324-328) byte for byte, including the
 * max_c bug (the c1 branch re-assigns c0). */
int fgx_train_model (const unsigned short *counts /* 2*ncalls */,
                     unsigned int ncalls, unsigned int max_training,
                     unsigned int nruns, float v[7], float *pB,
                     unsigned int mul, unsigned int nthreads,
                     unsigned int debug)
{
  unsigned int *train;
  unsigned int ntrain, i, chunk_size, max_c = 0;
  double s0 = 0, s1 = 0, ppb = 0, npb = 0;
  double mean;
  float params[7], deltas[7];
  unsigned int *var1, *var2;
  Objective obj;

  fgx_init ();
  if (debug) fprintf (stderr, "Building training set...");
  ntrain = ncalls < max_training ? ncalls : max_training;
  /* partial Fisher-Yates over the identity permutation,
   * one rand_ull(0, ncalls-1) per training slot */
  train = (unsigned int *) malloc (ncalls * sizeof (unsigned int));
  for (i = 0; i < ncalls; i++) train[i] = i;
  for (i = 0; i < ntrain; i++) {
    unsigned int p = (unsigned int) rand_ull (0, ncalls - 1);
    unsigned int t = train[i];
    train[i] = train[p];
    train[p] = t;
  }
  if (debug) fprintf (stderr, "done\n");

  if (debug) fprintf (stderr, "Calculating mean...");
  for (i = 0; i < ntrain; i++) {
    unsigned int c0 = counts[2 * train[i]];
    if (c0 > max_c) max_c = c0;
    unsigned int c1 = counts[2 * train[i] + 1];
    if (c1 > max_c) max_c = c0;  /* sic: reference assigns c0 here */
    s0 += c0;
    s1 += c1;
    if (c0 + c1) {
      ppb += (1.0f * c1) / (c0 + c1);
      npb += 1;
    }
  }
  *pB = npb ? (float) (ppb / npb) : 0;
  mean = (s0 + s1) / ntrain;
  if (debug) {
    fprintf (stderr, "done\n");
    fprintf (stderr, "A %g B %g\n", s0, s1);
    fprintf (stderr, "Training size %u mean %.1f\n", ntrain, mean);
    fprintf (stderr, "pB %.3f\n", *pB);
    fprintf (stderr, "Max count %u\n", max_c);
  }
  if (mean == 0) {
    /* unconditional, src/gmer_caller.c:268-270 */
    fprintf (stderr, "No calls in training sample, aborting model optimization\n");
    free (train);
    return 0;
  }
  if (v[4] == 0) v[4] = mul * mean;

  params[0] = logit_clamped (v[0], MIN_P, MAX_E);
  params[1] = logit_clamped (v[1], MIN_P, 1 - MIN_P);
  params[2] = logit_clamped (v[2], MIN_P, 1 - MIN_P);
  params[3] = logit_clamped (v[3], MIN_P, 1 - MIN_P);
  params[4] = logf (v[4]);
  params[5] = v[5];
  params[6] = logf (-v[6]);
  for (i = 0; i < 7; i++) deltas[i] = params[i] / 10;

  var1 = (unsigned int *) malloc (ntrain * sizeof (unsigned int));
  var2 = (unsigned int *) malloc (ntrain * sizeof (unsigned int));
  for (i = 0; i < ntrain; i++) {
    var1[i] = counts[2 * train[i]];
    var2[i] = counts[2 * train[i] + 1];
  }
  obj.var1 = var1;
  obj.var2 = var2;
  obj.n_calls = ntrain;
  obj.pB = *pB;
  obj.lambda_est = v[4];
  obj.lambda_sigma = obj.lambda_est / 4;
  chunk_size = (ntrain + nthreads - 1) / nthreads;
  if (chunk_size < 2000) chunk_size = 2000;
  obj.chunk_size = chunk_size;
  obj.n_chunks = (ntrain + chunk_size - 1) / chunk_size;

  fgx_downhill_simplex (7, params, deltas, 1e-6, nruns, 100,
                        objective_distance, &obj);
  if (debug) {
    /* print_params + one objective re-eval (src/gmer_caller.c:324-328) */
    float dist = objective_distance (7, params, &obj);
    fprintf (stderr, "%s %g %g %g %g %g %g %g\n", "Best",
             logit_1_clamped (params[0], MIN_P, MAX_E),
             logit_1_clamped (params[1], MIN_P, 1 - MIN_P),
             logit_1_clamped (params[2], MIN_P, 1 - MIN_P),
             logit_1_clamped (params[3], MIN_P, 1 - MIN_P),
             expf (params[4]), params[5], -expf (params[6]));
    fprintf (stderr, "Best distance %.6f\n", dist);
  }

  v[0] = logit_1_clamped (params[0], MIN_P, MAX_E);
  v[1] = logit_1_clamped (params[1], MIN_P, 1 - MIN_P);
  v[2] = logit_1_clamped (params[2], MIN_P, 1 - MIN_P);
  v[3] = logit_1_clamped (params[3], MIN_P, 1 - MIN_P);
  v[4] = expf (params[4]);
  v[5] = params[5];
  v[6] = -expf (params[6]);

  free (var1);
  free (var2);
  free (train);
  return 1;
}


/* ------------------------------------------------------------------ */
/* gassembler call phase (src/gassembler.c:1593-1855 + 2803-3027)      */
/* ------------------------------------------------------------------ */

/* The per-position genotype call: nucleotide ranking, the trained
 * logistic-regression quality models (calc_p_*), and the exome
 * multinomial models (gt1/gt2_prob).  Batched per region: one call
 * evaluates every position, replacing ~90k Python-level evaluations
 * per 200-region run.  Exact-math rules as the rest of this file:
 * every formula keeps the reference's term order and float/double
 * mix ((double)(float) where the reference stores through float). */

double fgx_lgamma (double x);

static double sigmoid_or_1 (double p)
{
  p = exp (p);
  return isfinite (p) ? p / (1 + p) : 1.0;
}

/* shared feature block for the diploid select/qual formulas */
typedef struct {
  double COMP_2, G0_COMP, katvus, EDIST, EDIST0, EDIST1, EDIST2;
  double alternatiiv, mitualternatiivi, ignoreeri;
  double kaugus1;
  long n_groups_total, n_groups;
} CallFeat;

static double calc_p_select_diploid_c (const long *counts, long cov,
                                       const CallFeat *f, int n0, int n1)
{
  double mx = (double) (counts[n0] > counts[n1] ? counts[n0] : counts[n1]);
  double allc = (double) (counts[0] + counts[1] + counts[2] + counts[3]
                          + counts[5]);
  double kaugus1 = f->kaugus1;
  double kaugus2 = ((mx - 0.5 * allc) / sqrt ((double) cov))
    * (f->n_groups >= 2 ? 1.0 : 0.0);
  double suhe = mx / allc * (f->n_groups != 1 ? 1.0 : 0.0);
  double deletsioon2 = (n0 == 5 && n1 == 5) ? 1.0 : 0.0;
  double deletsioon1 = ((n0 != 5 && n1 == 5) || (n0 == 5 && n1 != 5))
    ? 1.0 : 0.0;
  double HET = (n0 == n1 && n0 != 5) ? 1.0 : 0.0;
  double EDIST = f->EDIST, katvus = f->katvus;
  double p = (1.549817e+01
    + f->COMP_2 / f->G0_COMP * 3.214268e+00
    + HET * -1.603723e+01
    + deletsioon1 * 4.057173e+00
    + deletsioon2 * -1.295838e+01
    + katvus * 3.327203e-01
    + f->EDIST0 * -2.055305e+00
    + f->EDIST1 * -1.914959e+00
    + f->EDIST2 * -5.105844e-01
    + EDIST * 5.987854e-02
    + f->alternatiiv * -7.634908e-01
    + kaugus1 * 1.563516e+00
    + kaugus2 * -1.233070e+01
    + (kaugus1 + 0.5) * (kaugus1 > -0.5 ? 1.0 : 0.0) * -3.456876e-01
    + (kaugus1 - 2) * (kaugus1 > 2 ? 1.0 : 0.0) * -1.089758e-01
    + (kaugus1 - 3) * (kaugus1 > 3 ? 1.0 : 0.0) * -8.686674e-01
    + kaugus2 * kaugus2 * -6.547970e-01
    + f->G0_COMP / katvus * -1.655326e+00
    + f->G0_COMP * f->G0_COMP / (katvus * katvus) * 2.113226e-01
    + (EDIST - 40) * (EDIST - 40) * (EDIST - 40)
      * (EDIST > 40 ? 1.0 : 0.0) * 2.992796e-03
    + (EDIST - 45) * (EDIST - 45) * (EDIST - 45)
      * (EDIST > 45 ? 1.0 : 0.0) * -6.197973e-03
    + f->ignoreeri * -2.224370e-01
    + suhe * -1.255600e+02
    + suhe * suhe * 3.233437e+02
    + suhe * suhe * suhe * -2.755079e+02
    + suhe * suhe * suhe * suhe * 7.897496e+01
    + EDIST * EDIST * -8.887499e-04
    + HET * (EDIST <= 5 ? 1.0 : 0.0) * -2.998684e-01
    + f->COMP_2 / f->G0_COMP * katvus * -1.062955e-01
    + HET * katvus * -2.855130e-01
    + deletsioon1 * katvus * -9.098014e-02
    + deletsioon2 * katvus * -2.018754e-01
    + deletsioon2 * EDIST * 7.388170e-02
    + deletsioon2 * f->alternatiiv * -4.950726e+00
    + deletsioon2 * kaugus1 * -6.573440e-01
    + deletsioon2 * kaugus2 * 1.337017e+01
    + HET * kaugus2 * kaugus2 * 2.234410e+00
    + HET * f->G0_COMP / katvus * 2.994476e+00
    + HET * f->G0_COMP * f->G0_COMP / (katvus * katvus) * -4.286640e-01
    + HET * kaugus1 * -8.026551e-01
    + HET * kaugus2 * 9.614824e+00
    + deletsioon1 * EDIST * -1.301157e-01
    + EDIST * kaugus1 * -1.017782e-02
    + kaugus1 * EDIST * EDIST * 1.413317e-04
    + deletsioon1 * EDIST * EDIST * 2.472375e-03);
  return sigmoid_or_1 (p);
}

static double calc_p_qual_diploid_c (const long *counts, long cov,
                                     const CallFeat *f, int nu0, int nu1)
{
  double mx = (double) (counts[nu0] > counts[nu1] ? counts[nu0]
                        : counts[nu1]);
  double allc = (double) (counts[0] + counts[1] + counts[2] + counts[3]
                          + counts[5]);
  double kaugus1 = f->kaugus1;
  double kaugus2 = ((mx - 0.5 * allc) / sqrt ((double) cov))
    * (f->n_groups >= 2 ? 1.0 : 0.0);
  double suhe = mx / allc * (f->n_groups != 1 ? 1.0 : 0.0);
  double deletsioon2 = (nu0 == 5 && nu1 == 5) ? 1.0 : 0.0;
  double deletsioon1 = ((nu0 != 5 && nu1 == 5) || (nu0 == 5 && nu1 != 5))
    ? 1.0 : 0.0;
  double HET = (nu0 == nu1 && nu0 != 5) ? 1.0 : 0.0;
  double EDIST = f->EDIST, katvus = f->katvus;
  double p = (5.625990e+00
    + HET * -1.926639e+00
    + deletsioon2 * -4.149465e+00
    + kaugus1 * 1.976799e+00
    + deletsioon1 * -3.674773e-01
    + katvus * 2.505259e-01
    + f->COMP_2 / f->G0_COMP * 3.530792e+00
    + f->mitualternatiivi * 2.384205e-01
    + f->alternatiiv * -1.893987e+00
    + f->EDIST0 * 2.488365e+00
    + f->EDIST1 * 3.614451e+00
    + f->EDIST2 * -8.343540e-01
    + (kaugus1 + 2) * (kaugus1 > -2 ? 1.0 : 0.0) * -3.608020e-01
    + (kaugus1 - 2) * (kaugus1 > 2 ? 1.0 : 0.0) * -1.369033e+00
    + kaugus2 * -8.717219e-01
    + (kaugus1 + 1) * (kaugus1 > -1 ? 1.0 : 0.0) * -5.990449e-01
    + f->G0_COMP / katvus * -5.090870e-01
    + (EDIST - 35) * (EDIST > 35 ? 1.0 : 0.0) * 7.200000e-02
    + (EDIST - 30) * (EDIST > 30 ? 1.0 : 0.0) * -6.277709e-02
    + (EDIST - 45) * (EDIST > 45 ? 1.0 : 0.0) * 1.407460e-01
    + katvus * katvus * -3.807892e-03
    + f->ignoreeri * -5.524936e-01
    + HET * (EDIST < 5 ? 1.0 : 0.0) * 1.155368e+00
    + suhe * -1.489082e+02
    + suhe * suhe * 6.542650e+02
    + suhe * suhe * suhe * -9.392902e+02
    + suhe * suhe * suhe * suhe * 4.360459e+02
    + kaugus1 * deletsioon1 * -2.069432e-01
    + HET * katvus * 1.598539e-01
    + deletsioon2 * katvus * 2.304383e-01
    + kaugus1 * katvus * -1.981619e-02
    + deletsioon1 * katvus * 5.554233e-02
    + deletsioon2 * f->alternatiiv * -5.609686e-01
    + deletsioon2 * kaugus1 * 7.001617e-01
    + deletsioon1 * kaugus1 * kaugus1 * 1.859963e-01
    + HET * kaugus1 * 6.971654e-01
    + HET * kaugus2 * -1.003972e-01
    + HET * f->G0_COMP / katvus * -6.196470e-01
    + HET * f->G0_COMP * f->G0_COMP / (katvus * katvus) * 1.267673e-01
    + HET * kaugus2 * kaugus2 * 2.281341e-01
    + kaugus1 * deletsioon1 * katvus * 1.536606e-02);
  return sigmoid_or_1 (p);
}

static double calc_p_select_haploid_c (const CallFeat *f)
{
  double EDIST = f->EDIST;
  double p = (2.734031375
    + f->EDIST0 * -8.395304525
    + ((EDIST == 1 || EDIST == 2) ? 1.0 : 0.0) * -2.292773866
    + (EDIST - 45) * (EDIST > 45 ? 1.0 : 0.0) * 1.502826728
    + f->kaugus1 * 0.617528244
    + EDIST * f->kaugus1 * -0.009752782);
  return sigmoid_or_1 (p);
}

static double calc_p_qual_haploid_c (const CallFeat *f, int nu0, int nu1)
{
  double EDIST = f->EDIST;
  double HET = (nu0 == nu1 && nu0 != 5) ? 1.0 : 0.0;
  double p = (7.7911387
    + (EDIST - 45) * (EDIST > 45 ? 1.0 : 0.0) * 0.7390936
    + HET * (EDIST < 5 ? 1.0 : 0.0) * -0.9447409);
  return sigmoid_or_1 (p);
}

static double calc_p_mdetect_c (const long *counts, long cov,
                                const CallFeat *f, int exome)
{
  if (exome) return (double) cov / ((double) cov + 8.0);
  double EDIST = f->EDIST, katvus = f->katvus;
  double COV = (double) cov;
  double kaugus1 = f->kaugus1;
  double p = (-7.339851e+00
    + kaugus1 * 2.457963e+00
    + kaugus1 * kaugus1 * -2.092731e-01
    + kaugus1 * kaugus1 * kaugus1 * 1.757365e-02
    + EDIST * 1.174253e+00
    + COV * 2.189787e-01
    + katvus * 7.489705e-01
    + COV * COV * -1.873808e-02
    + COV * COV * COV * 2.716039e-04
    + (kaugus1 + 0.5) * (kaugus1 > -0.5 ? 1.0 : 0.0) * -5.814003e-01
    + (kaugus1 - 3) * (kaugus1 > 3 ? 1.0 : 0.0) * -8.967198e-02
    + f->EDIST2 * 1.881940e+00
    + EDIST * EDIST * -1.146688e-01
    + EDIST * EDIST * EDIST * 4.807719e-03
    + EDIST * EDIST * EDIST * EDIST * -9.036972e-05
    + EDIST * EDIST * EDIST * EDIST * EDIST * 6.263128e-07
    + kaugus1 * EDIST * -4.384856e-03
    + COV * katvus * -3.309976e-02
    + katvus * COV * COV * 9.086561e-04
    + katvus * COV * COV * COV * -9.727565e-06
    + EDIST * katvus * -9.141201e-05);
  return sigmoid_or_1 (p);
}

static double gt1_prob_c (const long *counts, int n0, long coverage,
                          double error_prob)
{
  double log_p = fgx_lgamma ((double) coverage);
  int i;
  for (i = 0; i <= 5; i++) {
    log_p -= fgx_lgamma ((double) (counts[i] + 1));
    if (i == n0) log_p += log (1 - error_prob) * counts[i];
    else log_p += log (error_prob / 4) * counts[i];
  }
  return exp (log_p);
}

static double gt2_prob_c (const long *counts, int n0, int n1,
                          long coverage, double error_prob)
{
  double log_p = fgx_lgamma ((double) coverage);
  int i;
  for (i = 0; i <= 5; i++) {
    log_p -= fgx_lgamma ((double) (counts[i] + 1));
    if (i == n0 || i == n1) log_p += log (0.5 - error_prob / 2) * counts[i];
    else log_p += log (error_prob / 3) * counts[i];
  }
  return (double) (float) exp (log_p);
}

/* One region's calls (the numeric body of the reference's call(),
 * src/gassembler.c:1594-1855).  i runs over [skip_end_call,
 * p_len - skip_end_call); outputs are indexed by i directly.
 * status: 0 = called, 1 = early return (fp hit or below
 * min_confirming; the caller leaves Call defaults untouched).
 * When alternative != 0 and the call is heterozygous, the
 * force-homozygote variant is evaluated into the alt_* arrays and
 * alt_valid[i] = 1. */
void fgx_call_batch (const long *counts, const long *coverage,
                     const int *aligned_ref, long p_len,
                     int skip_end_call, const signed char *fp_mask,
                     double compat_both, double compat_0,
                     long n_groups_total, long n_groups,
                     double error_prob, long min_confirming, int exome,
                     double coverage_arg, long chr_cov, int cb_haploid,
                     int alternative,
                     int *status, int *nucl0, int *nucl1, double *p_out,
                     double *q_out, double *pdet_out, double *rprob_out,
                     int *alt_valid, int *alt_nucl, double *alt_p,
                     double *alt_q, double *alt_pdet, double *alt_rprob)
{
  long i;
  for (i = skip_end_call; i < p_len - skip_end_call; i++) {
    const long *cnt = counts + i * 6;       /* A,C,G,T,N,GAP */
    long cov = coverage[i];
    int pass;
    alt_valid[i] = 0;
    status[i] = 1;
    nucl0[i] = 6; nucl1[i] = 6;                        /* NONE */
    if (fp_mask && fp_mask[i]) continue;
    /* best two nucleotides over A,C,G,T,GAP (N skipped), first wins */
    {
      long best0 = 0, best1 = 0;
      int best_n0 = 0, best_n1 = 0, n;
      for (n = 0; n <= 5; n++) {
        if (n == 4) continue;                          /* N */
        long c = cnt[n];
        if (c > best0) {
          best1 = best0; best_n1 = best_n0;
          best0 = c; best_n0 = n;
        } else if (c > best1) {
          best1 = c; best_n1 = n;
        }
      }
      if (best0 < min_confirming) continue;
      status[i] = 0;
      {
        CallFeat f;
        long edist_i = i < p_len - 1 - i ? i : p_len - 1 - i;
        long local_cov = chr_cov;
        double p_hom, p_het, sum_probs;
        f.COMP_2 = compat_both;
        f.G0_COMP = compat_0;
        f.katvus = (double) local_cov;
        f.EDIST = (double) edist_i;
        f.EDIST0 = edist_i == 0 ? 1.0 : 0.0;
        f.EDIST1 = edist_i == 1 ? 1.0 : 0.0;
        f.EDIST2 = edist_i == 2 ? 1.0 : 0.0;
        f.alternatiiv = n_groups_total > 1 ? 1.0 : 0.0;
        f.mitualternatiivi = n_groups_total > 2 ? 1.0 : 0.0;
        f.ignoreeri = n_groups_total != n_groups ? 1.0 : 0.0;
        f.kaugus1 = ((double) cov - f.katvus) / sqrt (f.katvus);
        f.n_groups_total = n_groups_total;
        f.n_groups = n_groups;
        if (!exome) {
          p_hom = calc_p_select_diploid_c (cnt, cov, &f, best_n0, best_n0);
          p_het = calc_p_select_diploid_c (cnt, cov, &f, best_n0, best_n1);
        } else {
          p_hom = gt1_prob_c (cnt, best_n0, cov - cnt[4], error_prob);
          p_het = (best1 >= min_confirming)
            ? gt2_prob_c (cnt, best_n0, best_n1, cov - cnt[4], error_prob)
            : 0.0;
        }
        sum_probs = p_hom + p_het;
        if (sum_probs == 0) sum_probs = 1.0;
        p_hom /= sum_probs;
        p_het /= sum_probs;
        if (coverage_arg == -2) {
          local_cov = cov;
          f.katvus = (double) local_cov;
          f.kaugus1 = ((double) cov - f.katvus) / sqrt (f.katvus);
        }
        for (pass = 0; pass < 2; pass++) {
          int force_hz = pass;
          int nu0, nu1;
          double pv, qv;
          if (cb_haploid) {
            nu0 = best_n0; nu1 = best_n0;
            if (!exome) {
              pv = calc_p_select_haploid_c (&f);
              qv = calc_p_qual_haploid_c (&f, nu0, nu1);
            } else { pv = p_hom; qv = p_hom; }
          } else if (!best1 || force_hz) {
            nu0 = best_n0; nu1 = best_n0;
            if (!exome) {
              pv = calc_p_select_diploid_c (cnt, cov, &f, best_n0, best_n0);
              qv = calc_p_qual_diploid_c (cnt, cov, &f, nu0, nu1);
            } else { pv = p_hom; qv = p_hom; }
          } else {
            if (p_het >= p_hom) {
              nu0 = best_n0 < best_n1 ? best_n0 : best_n1;
              nu1 = best_n0 > best_n1 ? best_n0 : best_n1;
              pv = p_het;
            } else {
              nu0 = best_n0; nu1 = best_n0;
              pv = p_hom;
            }
            if (!exome) qv = calc_p_qual_diploid_c (cnt, cov, &f, nu0, nu1);
            else qv = pv;
          }
          {
            double pdet = calc_p_mdetect_c (cnt, cov, &f, exome);
            double pf = (double) (float) pv;
            double qf = (double) (float) qv;
            double pdf = (double) (float) pdet;
            double rp = (double) (float) (qf / sum_probs);
            if (pass == 0) {
              nucl0[i] = nu0; nucl1[i] = nu1;
              p_out[i] = pf; q_out[i] = qf; pdet_out[i] = pdf;
              rprob_out[i] = rp;
              /* alternative pass only for heterozygous primary calls */
              if (!(alternative && nu0 != nu1)) break;
            } else {
              alt_valid[i] = 1;
              alt_nucl[i] = nu0;
              alt_p[i] = pf; alt_q[i] = qf; alt_pdet[i] = pdf;
              alt_rprob[i] = rp;
            }
          }
        }
      }
    }
  }
}


/* Two-list aligned union (glistcompare host path): merge two sorted
 * unique word arrays into (word, freq1, freq2) rows. The reference's
 * zipper (src/glistcompare.c:843-905) reformulated as a plain merge;
 * output capacity n1 + n2. Returns the row count. */
long fgx_pair_align (const unsigned long long *w1, const unsigned int *c1,
                     long n1, const unsigned long long *w2,
                     const unsigned int *c2, long n2,
                     unsigned long long *uw, unsigned int *f1,
                     unsigned int *f2)
{
  long i = 0, j = 0, k = 0;
  while (i < n1 && j < n2) {
    if (w1[i] == w2[j]) {
      uw[k] = w1[i]; f1[k] = c1[i]; f2[k] = c2[j]; i++; j++;
    } else if (w1[i] < w2[j]) {
      uw[k] = w1[i]; f1[k] = c1[i]; f2[k] = 0; i++;
    } else {
      uw[k] = w2[j]; f1[k] = 0; f2[k] = c2[j]; j++;
    }
    k++;
  }
  for (; i < n1; i++, k++) { uw[k] = w1[i]; f1[k] = c1[i]; f2[k] = 0; }
  for (; j < n2; j++, k++) { uw[k] = w2[j]; f1[k] = 0; f2[k] = c2[j]; }
  return k;
}


/* Fused two-list set operations (glistcompare host path): one merge
 * pass over the sorted inputs evaluating all four outputs at once with
 * exact include_in_* semantics (src/glistcompare.c:433-496) — the
 * numpy mask/compaction passes over a materialized aligned table cost
 * ~3x this. rule: 0 default 1 add 2 subtract 3 min 4 max 5 first
 * 6 second 7 number. */
static unsigned int fgx_rule_freq (unsigned int f1, unsigned int f2,
                                   int rule, unsigned int override)
{
  switch (rule) {
  case 1: return f1 + f2;
  case 2: return (f1 > f2) ? f1 - f2 : 0;
  case 3: return (f1 < f2) ? f1 : f2;
  case 4: return (f1 > f2) ? f1 : f2;
  case 5: return f1;
  case 6: return f2;
  case 7: return override;
  default: return 0;
  }
}

void fgx_pair_ops (const unsigned long long *w1, const unsigned int *c1,
                   long n1, const unsigned long long *w2,
                   const unsigned int *c2, long n2, int rule,
                   unsigned int cutoff, unsigned int override,
                   int subtract,
                   unsigned long long *ouw, unsigned int *ouc, long *n_u,
                   unsigned long long *oiw, unsigned int *oic, long *n_i,
                   unsigned long long *d1w, unsigned int *d1c, long *n_d1,
                   unsigned long long *d2w, unsigned int *d2c, long *n_d2)
{
  long i = 0, j = 0;
  long ku = 0, ki = 0, k1 = 0, k2 = 0;
  int r_u = (rule == 0) ? 1 : rule;   /* union default: add */
  int r_i = (rule == 0) ? 3 : rule;   /* intersection default: min */
  int r_d = (rule == 0) ? 2 : rule;   /* difference default: subtract */
  while (i < n1 || j < n2) {
    unsigned long long w;
    unsigned int f1 = 0, f2 = 0;
    if (i < n1 && (j >= n2 || w1[i] <= w2[j])) {
      w = w1[i]; f1 = c1[i];
      if (j < n2 && w2[j] == w) { f2 = c2[j]; j++; }
      i++;
    } else {
      w = w2[j]; f2 = c2[j]; j++;
    }
    {
      unsigned int ge1 = f1 >= cutoff, ge2 = f2 >= cutoff;
      unsigned int p1 = f1 > 0, p2 = f2 > 0;
      if (n_u) {
        unsigned int fr = fgx_rule_freq (f1, f2, r_u, override);
        if ((ge1 || ge2) && fr) { ouw[ku] = w; ouc[ku] = fr; ku++; }
      }
      if (n_i) {
        unsigned int fr = fgx_rule_freq (f1, f2, r_i, override);
        if (p1 && p2 && ge1 && ge2 && fr) {
          oiw[ki] = w; oic[ki] = fr; ki++;
        }
      }
      if (n_d1) {
        if (subtract) {
          if (p1 && p2 && (f1 == f2) && ge1) {
            d1w[k1] = w; d1c[k1] = f1; k1++;
          }
        } else {
          unsigned int fr = fgx_rule_freq (f1, f2, r_d, override);
          if (p1 && ge1 && !ge2 && fr) { d1w[k1] = w; d1c[k1] = fr; k1++; }
        }
      }
      if (n_d2) {
        unsigned int fr = fgx_rule_freq (f2, f1, r_d, override);
        if (p2 && ge2 && !ge1 && fr) { d2w[k2] = w; d2c[k2] = fr; k2++; }
      }
    }
  }
  if (n_u) *n_u = ku;
  if (n_i) *n_i = ki;
  if (n_d1) *n_d1 = k1;
  if (n_d2) *n_d2 = k2;
}


/* Record-level variant: operates directly on the .list 12-byte record
 * streams (u64 word + u32 count, unaligned), writing output records
 * and per-op u64 count sums — no strided gather copies on either side. */
static void fgx_rec_get (const unsigned char *r, long i,
                         unsigned long long *w, unsigned int *c)
{
  __builtin_memcpy (w, r + 12 * i, 8);
  __builtin_memcpy (c, r + 12 * i + 8, 4);
}

static void fgx_rec_put (unsigned char *r, long k, unsigned long long w,
                         unsigned int c)
{
  __builtin_memcpy (r + 12 * k, &w, 8);
  __builtin_memcpy (r + 12 * k + 8, &c, 4);
}

void fgx_pair_ops_rec (const unsigned char *r1, long n1,
                       const unsigned char *r2, long n2, int rule,
                       unsigned int cutoff, unsigned int override,
                       int subtract,
                       unsigned char *ou, long *n_u,
                       unsigned long long *s_u,
                       unsigned char *oi, long *n_i,
                       unsigned long long *s_i,
                       unsigned char *od1, long *n_d1,
                       unsigned long long *s_d1,
                       unsigned char *od2, long *n_d2,
                       unsigned long long *s_d2)
{
  long i = 0, j = 0;
  long ku = 0, ki = 0, k1 = 0, k2 = 0;
  unsigned long long su = 0, si = 0, s1 = 0, s2 = 0;
  int r_u = (rule == 0) ? 1 : rule;
  int r_i = (rule == 0) ? 3 : rule;
  int r_d = (rule == 0) ? 2 : rule;
  unsigned long long wa = 0, wb = 0;
  unsigned int ca = 0, cb = 0;
  if (i < n1) fgx_rec_get (r1, i, &wa, &ca);
  if (j < n2) fgx_rec_get (r2, j, &wb, &cb);
  while (i < n1 || j < n2) {
    unsigned long long w;
    unsigned int f1 = 0, f2 = 0;
    if (i < n1 && (j >= n2 || wa <= wb)) {
      w = wa; f1 = ca;
      if (j < n2 && wb == w) {
        f2 = cb; j++;
        if (j < n2) fgx_rec_get (r2, j, &wb, &cb);
      }
      i++;
      if (i < n1) fgx_rec_get (r1, i, &wa, &ca);
    } else {
      w = wb; f2 = cb; j++;
      if (j < n2) fgx_rec_get (r2, j, &wb, &cb);
    }
    {
      unsigned int ge1 = f1 >= cutoff, ge2 = f2 >= cutoff;
      unsigned int p1 = f1 > 0, p2 = f2 > 0;
      if (n_u) {
        unsigned int fr = fgx_rule_freq (f1, f2, r_u, override);
        if ((ge1 || ge2) && fr) { fgx_rec_put (ou, ku, w, fr); ku++; su += fr; }
      }
      if (n_i) {
        unsigned int fr = fgx_rule_freq (f1, f2, r_i, override);
        if (p1 && p2 && ge1 && ge2 && fr) {
          fgx_rec_put (oi, ki, w, fr); ki++; si += fr;
        }
      }
      if (n_d1) {
        if (subtract) {
          if (p1 && p2 && (f1 == f2) && ge1) {
            fgx_rec_put (od1, k1, w, f1); k1++; s1 += f1;
          }
        } else {
          unsigned int fr = fgx_rule_freq (f1, f2, r_d, override);
          if (p1 && ge1 && !ge2 && fr) {
            fgx_rec_put (od1, k1, w, fr); k1++; s1 += fr;
          }
        }
      }
      if (n_d2) {
        unsigned int fr = fgx_rule_freq (f2, f1, r_d, override);
        if (p2 && ge2 && !ge1 && fr) {
          fgx_rec_put (od2, k2, w, fr); k2++; s2 += fr;
        }
      }
    }
  }
  if (n_u) { *n_u = ku; *s_u = su; }
  if (n_i) { *n_i = ki; *s_i = si; }
  if (n_d1) { *n_d1 = k1; *s_d1 = s1; }
  if (n_d2) { *n_d2 = k2; *s_d2 = s2; }
}
