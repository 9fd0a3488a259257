/* A pure-C host of the continuous-learning entries of the C API
 * (lightgbm_tpu_torch/native/capi.cpp): a Dataset from memory, rows
 * appended under its frozen binning, an online trainer continuing a model
 * file, labeled batches fed, delayed-label captures joined by their late
 * labels, the join counters, a flush and the close.
 *
 * Build against the C library (python -m lightgbm_tpu_torch.native.build_capi
 * builds it and prints its path, LIB.so):
 *   gcc scripts/torch_online_host.c LIB.so -o online_host -Wl,-rpath,LIBDIR
 * Run:
 *   online_host MODEL BASE_X BASE_Y NBASE NCOL FEED_X FEED_Y NFEED PARAMS
 * where the *_X / *_Y files hold row-major f64 rows and f64 labels. The
 * first quarter of the feed is appended to the Dataset, the second quarter
 * fed in batches of 50 rows, the rest captured one row at a time under
 * request ids "r<i>" and labeled. Prints one line per step; with
 * online_wal=1 in PARAMS the model of the flush is the feed log's newest
 * model_*.txt.
 */
#include <stdio.h>
#include <stdlib.h>

extern const char* LGBMTPU_GetLastError(void);
extern int LGBMTPU_DatasetCreateFromMat(const double*, long long, int,
                                        const char*, void*, void**);
extern int LGBMTPU_DatasetSetField(void*, const char*, const void*,
                                   long long, int);
extern int LGBMTPU_DatasetAppend(void*, const double*, long long, int,
                                 const double*);
extern int LGBMTPU_DatasetNumData(void*, long long*);
extern int LGBMTPU_DatasetFree(void*);
extern int LGBMTPU_BoosterCreateFromModelfile(const char*, void**);
extern int LGBMTPU_BoosterFree(void*);
extern int LGBMTPU_OnlineCreate(void*, void*, void*, const char*, void**);
extern int LGBMTPU_OnlineFeed(void*, const double*, long long, int,
                              const double*, int*);
extern int LGBMTPU_OnlineCapture(void*, const char*, const double*,
                                 long long, int, int*);
extern int LGBMTPU_OnlineLabel(void*, const char*, double, double, int*);
extern int LGBMTPU_OnlineJoinStatsJSON(void*, char*, long long, long long*);
extern int LGBMTPU_OnlineFlush(void*, int*);
extern int LGBMTPU_OnlineClose(void*);

#define CHECK(x, code)                                  \
  if (x) {                                              \
    fprintf(stderr, "%s\n", LGBMTPU_GetLastError());    \
    return code;                                        \
  }

static double* load(const char* path, long long n) {
  double* p = malloc(sizeof(double) * (size_t)n);
  FILE* f = fopen(path, "rb");
  if (f == NULL || fread(p, sizeof(double), (size_t)n, f) != (size_t)n)
    exit(9);
  fclose(f);
  return p;
}

int main(int argc, char** argv) {
  if (argc != 10) return 10;
  long long nbase = atoll(argv[4]), nfeed = atoll(argv[8]);
  int ncol = atoi(argv[5]);
  const char* params = argv[9];
  double* bx = load(argv[2], nbase * ncol);
  double* by = load(argv[3], nbase);
  double* fx = load(argv[6], nfeed * ncol);
  double* fy = load(argv[7], nfeed);
  long long q = nfeed / 4, n = 0;
  void *d, *b, *t;
  int v = 0;
  CHECK(LGBMTPU_DatasetCreateFromMat(bx, nbase, ncol, params, 0, &d), 1);
  CHECK(LGBMTPU_DatasetSetField(d, "label", by, nbase, 0), 2);
  CHECK(LGBMTPU_DatasetAppend(d, fx, q, ncol, fy), 3);
  CHECK(LGBMTPU_DatasetNumData(d, &n), 3);
  printf("appended %lld rows: %lld\n", q, n);
  CHECK(LGBMTPU_BoosterCreateFromModelfile(argv[1], &b), 4);
  CHECK(LGBMTPU_OnlineCreate(d, b, 0, params, &t), 5);
  for (long long i = q; i < 2 * q; i += 50) {
    long long m = 2 * q - i < 50 ? 2 * q - i : 50;
    CHECK(LGBMTPU_OnlineFeed(t, fx + i * ncol, m, ncol, fy + i, &v), 6);
    printf("feed %lld: version %d\n", i, v);
  }
  int pending = 0, joined = 0;
  char rid[32];
  for (long long i = 2 * q; i < nfeed; ++i) {
    snprintf(rid, sizeof(rid), "r%lld", i);
    CHECK(LGBMTPU_OnlineCapture(t, rid, fx + i * ncol, 1, ncol, &pending), 7);
  }
  for (long long i = 2 * q; i < nfeed; ++i) {
    snprintf(rid, sizeof(rid), "r%lld", i);
    CHECK(LGBMTPU_OnlineLabel(t, rid, fy[i], 0.0, &v), 8);
    if (v < 0) return 8;
    joined += v >= 0;
  }
  CHECK(LGBMTPU_OnlineLabel(t, "ghost", 1.0, 0.0, &v), 8);
  printf("captured %lld, pending after captures %d, joined %d, ghost %d\n",
         nfeed - 2 * q, pending, joined, v);
  char buf[1 << 12];
  long long len = 0;
  CHECK(LGBMTPU_OnlineJoinStatsJSON(t, buf, sizeof(buf), &len), 9);
  printf("%s\n", buf);
  CHECK(LGBMTPU_OnlineFlush(t, &v), 10);
  printf("flush: version %d\n", v);
  CHECK(LGBMTPU_OnlineClose(t), 11);
  CHECK(LGBMTPU_BoosterFree(b), 12);
  CHECK(LGBMTPU_DatasetFree(d), 13);
  free(bx);
  free(by);
  free(fx);
  free(fy);
  return 0;
}
