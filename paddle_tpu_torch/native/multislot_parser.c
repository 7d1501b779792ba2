/* MultiSlot text parser: the data layer's hot path (a copy of the JAX
 * package's native/multislot_parser.c, kept in the port so that the port
 * loads nothing of that package).
 *
 * The counterpart of the reference's C++ data feed
 * (data_feed.cc MultiSlotDataFeed::ParseOneInstance): one text line per
 * sample, and for each slot in order `<n> v1 ... vn`. A slot's values are
 * padded (zero) or truncated to the slot's fixed width, so every batch has
 * a static shape.
 *
 * The file is parsed in one pass with no per-token Python overhead; the
 * output is a sample-major double buffer [n_samples, sum(widths)] that the
 * Python side slices per slot and casts to each var's dtype (ids fit
 * doubles exactly up to 2^53).
 *
 * Built at first use with `cc -O2 -shared -fPIC` and bound with ctypes
 * (paddle_tpu_torch/native/__init__.py), which keeps a pure-Python parser
 * of the same semantics as the plain version.
 */
#include <ctype.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* Count newline-terminated, non-empty lines (samples) in the file. */
long long multislot_count(const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  long long n = 0;
  int c, seen = 0;
  while ((c = fgetc(f)) != EOF) {
    if (c == '\n') {
      if (seen) n++;
      seen = 0;
    } else if (!isspace(c)) {
      seen = 1;
    }
  }
  if (seen) n++;
  fclose(f);
  return n;
}

/* Parse up to max_samples lines into out[max_samples][row_width] where
 * row_width = sum(widths). Returns samples parsed, or -1 on IO error,
 * -2 on malformed line (slot count missing). */
long long multislot_parse(const char *path, int n_slots,
                          const long long *widths, double *out,
                          long long max_samples) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;

  long long row_width = 0;
  for (int s = 0; s < n_slots; s++) row_width += widths[s];

  char *line = NULL;
  size_t cap = 0;
  long long sample = 0;
  while (sample < max_samples) {
    ssize_t len = getline(&line, &cap, f);
    if (len < 0) break;
    char *p = line;
    while (*p && isspace((unsigned char)*p)) p++;
    if (!*p) continue; /* blank line */

    double *row = out + sample * row_width;
    memset(row, 0, (size_t)row_width * sizeof(double));
    long long off = 0;
    for (int s = 0; s < n_slots; s++) {
      char *end;
      long long cnt = strtoll(p, &end, 10);
      if (end == p) { /* malformed: missing slot count */
        free(line);
        fclose(f);
        return -2;
      }
      p = end;
      long long w = widths[s];
      for (long long i = 0; i < cnt; i++) {
        double v = strtod(p, &end);
        if (end == p) { /* fewer values than declared */
          free(line);
          fclose(f);
          return -2;
        }
        p = end;
        if (i < w) row[off + i] = v; /* truncate beyond width */
      }
      off += w;
    }
    sample++;
  }
  free(line);
  fclose(f);
  return sample;
}
