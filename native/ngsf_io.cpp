// Native IO core: streaming genotype-likelihood / position readers.
//
// Accelerator-side equivalent of the reference's C++ IO layer (reference:
// shared/read_data.cpp:13-218, shared/gen_func.cpp:389-416 tokenizer,
// gen_func.cpp:920-932 normalisation), built as a shared library driven
// from Python via ctypes (io/native.py). Single-pass and allocation-lean
// so the 5000-ind x 50M-site configs stream without NumPy temporaries;
// the pure-NumPy readers in io/readers.py are the correctness oracle.
//
// All outputs are site-major [n_sites][n_ind][3] float64 normalised
// log-GLs, matching io/readers.py exactly (tested to the ULP).

#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr int N_GENO = 3;
constexpr double BIG = 1e15;

void set_err(char *err, size_t errlen, const std::string &msg) {
  if (err && errlen) {
    snprintf(err, errlen, "%s", msg.c_str());
  }
}

// Chunked line reader over zlib (transparently handles plain files):
// 4MB gzread blocks scanned for newlines in place -- no per-line zlib
// calls, no copies for lines shorter than the buffer.
class GzLines {
 public:
  explicit GzLines(const char *path)
      : f_(gzopen(path, "rb")), buf_(1 << 22), begin_(0), end_(0),
        eof_(false) {
    if (f_) gzbuffer(f_, 1 << 20);
  }
  ~GzLines() {
    if (f_) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }

  // Returns false at EOF. Strips trailing \r\n and NUL-terminates the
  // line in place. `line` stays valid until the next call.
  bool next(char **line, size_t *len) {
    for (;;) {
      char *nl = (char *)memchr(buf_.data() + begin_, '\n', end_ - begin_);
      if (nl != nullptr || (eof_ && end_ > begin_)) {
        char *start = buf_.data() + begin_;
        char *stop = nl ? nl : buf_.data() + end_;
        begin_ = (stop - buf_.data()) + (nl ? 1 : 0);
        while (stop > start && (stop[-1] == '\r')) --stop;
        *stop = '\0';
        *line = start;
        *len = stop - start;
        return true;
      }
      if (eof_) return false;
      // compact + refill
      size_t keep = end_ - begin_;
      if (begin_ > 0) {
        memmove(buf_.data(), buf_.data() + begin_, keep);
        begin_ = 0;
        end_ = keep;
      }
      if (end_ + 1 >= buf_.size()) buf_.resize(buf_.size() * 2);
      int got = gzread(f_, buf_.data() + end_, (unsigned)(buf_.size() - end_ - 1));
      if (got <= 0) {
        eof_ = true;
      } else {
        end_ += (size_t)got;
      }
    }
  }

 private:
  gzFile f_;
  std::vector<char> buf_;
  size_t begin_, end_;
  bool eof_;
};

// strtod tokens with full-token validation, like the reference's
// split(char*, sep, double**) (gen_func.cpp:389-416): a token with any
// trailing non-numeric garbage is DROPPED (so Beagle marker/allele
// columns fall out and the last n_ind*n_geno numeric fields remain).
void numeric_tokens(char *line, std::vector<double> *out) {
  out->clear();
  char *p = line;
  while (*p) {
    while (*p == ' ' || *p == '\t') ++p;
    if (!*p) break;
    char *tok = p;
    while (*p && *p != ' ' && *p != '\t') ++p;
    // std::from_chars is correctly rounded like strtod (identical
    // doubles) but several times faster; it also accepts inf/nan but,
    // unlike strtod, no leading '+' or hex -- handle '+' explicitly.
    const char *start = (*tok == '+') ? tok + 1 : tok;
    double v;
    auto res = std::from_chars(start, (const char *)p, v);
    if (res.ec == std::errc() && res.ptr == p) out->push_back(v);
    if (*p) ++p;
  }
}

// post_prob with no prior: subtract the max-shifted log-sum
// (gen_func.cpp:920-932 / io/readers.py _normalise_log).
inline void normalise_log3(double *g) {
  double m = g[0] > g[1] ? g[0] : g[1];
  if (g[2] > m) m = g[2];
  if (std::isinf(m) && m < 0) {
    // all three -inf: numpy yields nan (-inf - -inf); match it exactly
    g[0] = g[1] = g[2] = NAN;
    return;
  }
  double norm = std::log(std::exp(g[0] - m) + std::exp(g[1] - m) +
                         std::exp(g[2] - m)) + m;
  g[0] -= norm;
  g[1] -= norm;
  g[2] -= norm;
}

}  // namespace

extern "C" {

// Raw little-endian doubles, site-major [S][N][3] likelihood triplets
// (ngsF-HMM.cpp:55-62 forces in_lkl for binary inputs). log_scale!=0
// means the file already stores logs. Mirrors read_data.cpp:83-99 incl.
// the conv_space(-inf -> -BIG) of the binary branch.
int ngsf_read_geno_binary(const char *path, uint64_t n_ind, uint64_t n_sites,
                          int log_scale, double *out, char *err,
                          size_t errlen) {
  FILE *f = fopen(path, "rb");
  if (!f) {
    set_err(err, errlen, std::string("cannot open ") + path);
    return 1;
  }
  const uint64_t total = n_sites * n_ind * N_GENO;
  uint64_t got = fread(out, sizeof(double), total, f);
  // must also be at EOF (size checked by the caller's sniff; double-check)
  char extra;
  bool eof = fread(&extra, 1, 1, f) == 0;
  fclose(f);
  if (got != total || !eof) {
    set_err(err, errlen, "invalid/corrupt genotype input file!");
    return 2;
  }
  bool nan_found = false;
  for (uint64_t i = 0; i < total; i += N_GENO) {
    double *g = out + i;
    if (!log_scale) {
      for (int k = 0; k < N_GENO; ++k) {
        g[k] = std::log(g[k]);
        if (std::isinf(g[k]) && g[k] < 0) g[k] = -BIG;
      }
    }
    normalise_log3(g);
    if (std::isnan(g[0]) || std::isnan(g[1]) || std::isnan(g[2]))
      nan_found = true;
  }
  if (nan_found) {
    set_err(err, errlen, "NaN found! Is the file format correct?");
    return 3;
  }
  return 0;
}

// Slab variant for multi-host loading: reads only sites
// [site_off, site_off+site_cnt) x individuals [ind_off, ind_off+ind_cnt)
// into out[site_cnt][ind_cnt][3].  The file's total size is still
// validated (fseek to end), so a bad n_sites/n_ind fails on every host;
// per-site reads fseek when the individual range is a strict subset and
// fall back to one bulk fread for full-width slabs.  Each host of a
// (ind|site)-sharded mesh loads exactly its shard -- the host-sharded GL
// loading SURVEY.md §5.8 calls for (reference loads everything on one
// host, read_data.cpp:83-99).
int ngsf_read_geno_binary_slab(const char *path, uint64_t n_ind,
                               uint64_t n_sites, uint64_t site_off,
                               uint64_t site_cnt, uint64_t ind_off,
                               uint64_t ind_cnt, int log_scale, double *out,
                               char *err, size_t errlen) {
  if (site_off + site_cnt > n_sites || ind_off + ind_cnt > n_ind) {
    set_err(err, errlen, "slab out of range");
    return 9;
  }
  FILE *f = fopen(path, "rb");
  if (!f) {
    set_err(err, errlen, std::string("cannot open ") + path);
    return 1;
  }
  // whole-file size check (the full reader's EOF check, slab-safe)
  const uint64_t bytes_total = n_sites * n_ind * N_GENO * sizeof(double);
  fseeko(f, 0, SEEK_END);
  if ((uint64_t)ftello(f) != bytes_total) {
    set_err(err, errlen, "invalid/corrupt genotype input file!");
    fclose(f);
    return 2;
  }
  const uint64_t row = ind_cnt * N_GENO;
  bool ok = true;
  if (ind_cnt == n_ind) {
    fseeko(f, (off_t)(site_off * n_ind * N_GENO * sizeof(double)), SEEK_SET);
    ok = fread(out, sizeof(double), site_cnt * row, f) == site_cnt * row;
  } else {
    for (uint64_t s = 0; ok && s < site_cnt; ++s) {
      fseeko(f,
             (off_t)(((site_off + s) * n_ind + ind_off) * N_GENO *
                     sizeof(double)),
             SEEK_SET);
      ok = fread(out + s * row, sizeof(double), row, f) == row;
    }
  }
  fclose(f);
  if (!ok) {
    set_err(err, errlen, "invalid/corrupt genotype input file!");
    return 2;
  }
  bool nan_found = false;
  for (uint64_t i = 0; i < site_cnt * row; i += N_GENO) {
    double *g = out + i;
    if (!log_scale) {
      for (int k = 0; k < N_GENO; ++k) {
        g[k] = std::log(g[k]);
        if (std::isinf(g[k]) && g[k] < 0) g[k] = -BIG;
      }
    }
    normalise_log3(g);
    if (std::isnan(g[0]) || std::isnan(g[1]) || std::isnan(g[2]))
      nan_found = true;
  }
  if (nan_found) {
    set_err(err, errlen, "NaN found! Is the file format correct?");
    return 3;
  }
  return 0;
}

// Gzip/plain text: called genotypes {-1,0,1,2} (probs=0) or 3 fields per
// individual (probs=1; log_scale per --loglkl). Keeps the LAST
// n_ind*n_geno numeric tokens per line (read_data.cpp:77-81).
int ngsf_read_geno_text(const char *path, uint64_t n_ind, uint64_t n_sites,
                        int probs, int log_scale, double *out, char *err,
                        size_t errlen) {
  GzLines lines(path);
  if (!lines.ok()) {
    set_err(err, errlen, std::string("cannot open ") + path);
    return 1;
  }
  const uint64_t n_geno = probs ? N_GENO : 1;
  const uint64_t want = n_ind * n_geno;
  std::vector<double> toks;
  toks.reserve(want + 16);
  uint64_t s = 0;
  char *line;
  size_t len;
  while (lines.next(&line, &len)) {
    if (len == 0) continue;
    numeric_tokens(line, &toks);
    if (toks.empty() || (s == 0 && toks.size() < want)) {
      if (s != 0) {
        set_err(err, errlen, "header found but not on first line");
        return 4;
      }
      continue;  // header
    }
    if (toks.size() < want) {
      set_err(err, errlen,
              "wrong GENO file format. Less fields than expected!");
      return 5;
    }
    if (s >= n_sites) {
      set_err(err, errlen, "GENO file not at EOF. Check number of sites!");
      return 6;
    }
    const double *row = toks.data() + (toks.size() - want);
    double *site = out + s * n_ind * N_GENO;
    if (probs) {
      for (uint64_t i = 0; i < n_ind * N_GENO; ++i)
        site[i] = log_scale ? row[i] : std::log(row[i]);
    } else {
      for (uint64_t i = 0; i < n_ind; ++i) {
        double *g = site + i * N_GENO;
        int call = (int)row[i];
        if (call > 2) {
          set_err(err, errlen,
                  "wrong GENO file format. Genotypes must be coded as "
                  "{-1,0,1,2}!");
          return 7;
        }
        if (call < 0) {
          g[0] = g[1] = g[2] = std::log(1.0 / N_GENO);
        } else {
          g[0] = g[1] = g[2] = -BIG;
          g[call] = 0.0;
        }
      }
    }
    for (uint64_t i = 0; i < n_ind; ++i)
      normalise_log3(site + i * N_GENO);
    ++s;
  }
  if (s != n_sites) {
    set_err(err, errlen, "GENO file at premature EOF. Check number of sites!");
    return 8;
  }
  return 0;
}

// Text slab reader (multi-host loading): decompresses and tokenises every
// line up to the end of the slab (gzip has no random access) but stores
// only sites [site_off, site_off+site_cnt) x individuals
// [ind_off, ind_off+ind_cnt).  Stops right after the slab unless the slab
// reaches the last site, in which case the tail is scanned so the
// "not at EOF" check still fires on the host that owns the end of the
// file; header/width errors fire on every host.
int ngsf_read_geno_text_slab(const char *path, uint64_t n_ind,
                             uint64_t n_sites, uint64_t site_off,
                             uint64_t site_cnt, uint64_t ind_off,
                             uint64_t ind_cnt, int probs, int log_scale,
                             double *out, char *err, size_t errlen) {
  if (site_off + site_cnt > n_sites || ind_off + ind_cnt > n_ind) {
    set_err(err, errlen, "slab out of range");
    return 9;
  }
  GzLines lines(path);
  if (!lines.ok()) {
    set_err(err, errlen, std::string("cannot open ") + path);
    return 1;
  }
  const uint64_t n_geno = probs ? N_GENO : 1;
  const uint64_t want = n_ind * n_geno;
  const bool owns_tail = site_off + site_cnt == n_sites;
  std::vector<double> toks;
  toks.reserve(want + 16);
  uint64_t s = 0;
  char *line;
  size_t len;
  while (lines.next(&line, &len)) {
    if (len == 0) continue;
    numeric_tokens(line, &toks);
    if (toks.empty() || (s == 0 && toks.size() < want)) {
      if (s != 0) {
        set_err(err, errlen, "header found but not on first line");
        return 4;
      }
      continue;  // header
    }
    if (toks.size() < want) {
      set_err(err, errlen,
              "wrong GENO file format. Less fields than expected!");
      return 5;
    }
    if (s >= n_sites) {
      set_err(err, errlen, "GENO file not at EOF. Check number of sites!");
      return 6;
    }
    if (s >= site_off && s < site_off + site_cnt) {
      const double *row =
          toks.data() + (toks.size() - want) + ind_off * n_geno;
      double *site = out + (s - site_off) * ind_cnt * N_GENO;
      if (probs) {
        for (uint64_t i = 0; i < ind_cnt * N_GENO; ++i)
          site[i] = log_scale ? row[i] : std::log(row[i]);
      } else {
        for (uint64_t i = 0; i < ind_cnt; ++i) {
          double *g = site + i * N_GENO;
          int call = (int)row[i];
          if (call > 2) {
            set_err(err, errlen,
                    "wrong GENO file format. Genotypes must be coded as "
                    "{-1,0,1,2}!");
            return 7;
          }
          if (call < 0) {
            g[0] = g[1] = g[2] = std::log(1.0 / N_GENO);
          } else {
            g[0] = g[1] = g[2] = -BIG;
            g[call] = 0.0;
          }
        }
      }
      for (uint64_t i = 0; i < ind_cnt; ++i)
        normalise_log3(site + i * N_GENO);
    }
    ++s;
    if (!owns_tail && s >= site_off + site_cnt) return 0;
  }
  if (s < site_off + site_cnt) {
    set_err(err, errlen, "GENO file at premature EOF. Check number of sites!");
    return 8;
  }
  return 0;
}

// CHR+POS text -> per-site distance in bp; dist[0] = absolute coordinate
// of the first site, +inf at chromosome changes, <1bp is an error
// (read_data.cpp:165-218 incl. the first-site quirk).
int ngsf_read_pos_dist(const char *path, uint64_t n_sites, double *out,
                       char *err, size_t errlen) {
  GzLines lines(path);
  if (!lines.ok()) {
    set_err(err, errlen, std::string("cannot open ") + path);
    return 1;
  }
  std::string prev_chr;
  bool have_chr = false;
  long long prev_pos = 0;
  uint64_t s = 0;
  char *line;
  size_t len;
  while (lines.next(&line, &len)) {
    if (len == 0 || line[0] == '#') continue;
    // first two whitespace-separated fields
    char *p = line;
    while (*p == ' ' || *p == '\t') ++p;
    char *c0 = p;
    while (*p && *p != ' ' && *p != '\t') ++p;
    if (!*p) {
      set_err(err, errlen, "wrong POS file format!");
      return 2;
    }
    *p = '\0';
    ++p;
    while (*p == ' ' || *p == '\t') ++p;
    char *c1 = p;
    while (*p && *p != ' ' && *p != '\t') ++p;
    *p = '\0';
    char *end = nullptr;
    double posval = strtod(c1, &end);
    if (end == c1 || *end != '\0') posval = 0.0;
    if (posval == 0.0) {
      if (s != 0) {
        set_err(err, errlen, "header found but not on first line");
        return 3;
      }
      continue;
    }
    if (s >= n_sites) {
      set_err(err, errlen, "wrong number of lines in POS file!");
      return 4;
    }
    if (!have_chr) {
      prev_chr = c0;
      have_chr = true;
    }
    if (prev_chr == c0) {
      out[s] = posval - (double)prev_pos;
      if (out[s] < 1) {
        set_err(err, errlen, "invalid distance between adjacent sites!");
        return 5;
      }
    } else {
      out[s] = INFINITY;
      prev_chr = c0;
    }
    prev_pos = (long long)posval;
    ++s;
  }
  if (s != n_sites) {
    set_err(err, errlen, "wrong number of lines in POS file!");
    return 4;
  }
  return 0;
}

// libm exp/log applied elementwise: the --opt compat engine
// (models/em_compat.py) needs transcendentals BIT-identical to the
// reference binary's (numpy's and XLA's vectorised f64 exp differ from
// glibc by 1 ulp on a few percent of inputs, which is enough to break
// %.10f byte parity through the est_maf feedback loop).
int ngsf_vexp(const double *in, double *out, long long n) {
  for (long long i = 0; i < n; i++) out[i] = exp(in[i]);
  return 0;
}

int ngsf_vlog(const double *in, double *out, long long n) {
  for (long long i = 0; i < n; i++) out[i] = log(in[i]);
  return 0;
}

}  // extern "C"
