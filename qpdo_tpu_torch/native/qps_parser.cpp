// Native QPS (MPS + QUADOBJ) parser.
//
// The native ingestion path of qpdo_tpu_torch (a copy of the JAX
// package's parser, qpdo_tpu/native/qps_parser.cpp): large
// Maros-Mészáros files (QPS text, possibly tens of MB) parse far faster
// here than in the pure-Python reader (qpdo_tpu_torch/io/qps.py), which
// stays the reference implementation.  Semantics are identical:
// canonical form  min 0.5 x'Qx + q'x + c  s.t.  l <= Ax <= u  with variable
// bounds appended as identity rows of A.
//
// C API (ctypes-friendly): qps_parse() -> opaque handle, accessor
// functions, qps_destroy().  No exceptions cross the boundary.

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Triplet {
  long i, j;
  double v;
};

struct Parsed {
  std::string name;
  std::string error;
  long n = 0;            // variables
  long m_struct = 0;     // structural rows
  long m_total = 0;      // structural + bound rows
  double obj_const = 0.0;
  std::vector<Triplet> q_entries;   // symmetric Q triplets (both halves)
  std::vector<double> q_lin;        // dense n
  std::vector<Triplet> a_entries;   // structural + bound rows
  std::vector<double> l, u;         // m_total
};

struct Tokenizer {
  const char* p;
  const char* end;
  // Split one line into whitespace-separated tokens; returns false at EOF.
  bool next_line(std::vector<std::string>& toks, bool& indented) {
    toks.clear();
    while (p < end) {
      const char* line_start = p;
      const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
      const char* line_end = nl ? nl : end;
      p = nl ? nl + 1 : end;
      if (line_start < line_end && *line_start == '*') continue;  // comment
      indented = line_start < line_end &&
                 (*line_start == ' ' || *line_start == '\t');
      const char* q = line_start;
      while (q < line_end) {
        while (q < line_end && std::isspace(static_cast<unsigned char>(*q))) q++;
        const char* tok = q;
        while (q < line_end && !std::isspace(static_cast<unsigned char>(*q))) q++;
        if (q > tok) toks.emplace_back(tok, q - tok);
      }
      if (!toks.empty()) return true;
    }
    return false;
  }
};

std::string upper(const std::string& s) {
  std::string r = s;
  for (auto& c : r) c = std::toupper(static_cast<unsigned char>(c));
  return r;
}

void parse_impl(const char* text, long len, Parsed& out) {
  Tokenizer tz{text, text + len};
  std::vector<std::string> toks;
  bool indented = false;

  std::string section;
  std::string obj_row;
  bool have_obj_row = false;
  bool maximize = false;

  std::unordered_map<std::string, long> row_index;  // structural rows
  std::vector<char> row_sense;                      // 'L','G','E' per row
  std::unordered_map<std::string, long> col_index;
  std::vector<double> rhs, rng_val;
  std::vector<char> has_rhs, has_rng;
  std::vector<double> xl, xu;
  std::vector<char> xl_set, xu_set;
  std::unordered_map<long, double> q_lin_map;
  struct QEntry { long i, j; double v; bool qmatrix; };
  std::vector<QEntry> q_raw;

  auto col_id = [&](const std::string& name) -> long {
    auto it = col_index.find(name);
    if (it != col_index.end()) return it->second;
    long id = static_cast<long>(col_index.size());
    col_index.emplace(name, id);
    xl.push_back(0.0); xu.push_back(kInf);
    xl_set.push_back(0); xu_set.push_back(0);
    return id;
  };

  bool more = tz.next_line(toks, indented);
  while (more) {
    if (!indented) {
      section = upper(toks[0]);
      if (section == "NAME") {
        if (toks.size() > 1) out.name = toks[1];
      } else if (section == "OBJSENSE" && toks.size() > 1) {
        std::string s = upper(toks[1]);
        maximize = (s == "MAX" || s == "MAXIMIZE");
      } else if (section == "ENDATA") {
        break;
      }
      more = tz.next_line(toks, indented);
      continue;
    }

    if (section == "OBJSENSE") {
      std::string s = upper(toks[0]);
      maximize = (s == "MAX" || s == "MAXIMIZE");
    } else if (section == "ROWS") {
      if (toks.size() >= 2) {
        std::string sense = upper(toks[0]);
        const std::string& rname = toks[1];
        if (sense == "N") {
          if (!have_obj_row) { obj_row = rname; have_obj_row = true; }
        } else if (sense == "L" || sense == "G" || sense == "E") {
          long id = static_cast<long>(row_index.size());
          row_index.emplace(rname, id);
          row_sense.push_back(sense[0]);
          rhs.push_back(0.0); rng_val.push_back(0.0);
          has_rhs.push_back(0); has_rng.push_back(0);
        }
      }
    } else if (section == "COLUMNS") {
      bool is_marker = false;
      for (const auto& t : toks)
        if (t == "'MARKER'") { is_marker = true; break; }
      if (is_marker) {
        // integer-section markers (INTORG/INTEND) are ignored
      } else if (toks.size() >= 3) {
        long j = col_id(toks[0]);
        for (size_t k = 1; k + 1 < toks.size(); k += 2) {
          const std::string& rname = toks[k];
          double v = std::strtod(toks[k + 1].c_str(), nullptr);
          if (have_obj_row && rname == obj_row) {
            q_lin_map[j] += v;
          } else {
            auto it = row_index.find(rname);
            if (it != row_index.end())
              out.a_entries.push_back({it->second, j, v});
          }
        }
      }
    } else if (section == "RHS" || section == "RANGES") {
      // first token is the set name when the token count is odd
      size_t start = (toks.size() % 2 == 1) ? 1 : 0;
      for (size_t k = start; k + 1 < toks.size(); k += 2) {
        const std::string& rname = toks[k];
        double v = std::strtod(toks[k + 1].c_str(), nullptr);
        if (section == "RHS") {
          if (have_obj_row && rname == obj_row) {
            out.obj_const = -v;
          } else {
            auto it = row_index.find(rname);
            if (it != row_index.end()) { rhs[it->second] = v; has_rhs[it->second] = 1; }
          }
        } else {
          auto it = row_index.find(rname);
          if (it != row_index.end()) { rng_val[it->second] = v; has_rng[it->second] = 1; }
        }
      }
    } else if (section == "BOUNDS") {
      if (!toks.empty()) {
        std::string btype = upper(toks[0]);
        if (btype == "FR" || btype == "MI" || btype == "PL" || btype == "BV") {
          if (toks.size() >= 2) {
            // the variable is the last NON-numeric token: these bound types
            // may carry an ignored trailing value (" MI BND X1 0.0")
            size_t vi = toks.size() - 1;
            for (size_t t = toks.size() - 1; t >= 1; t--) {
              char* endp = nullptr;
              std::strtod(toks[t].c_str(), &endp);
              if (endp == nullptr || *endp != '\0' || endp == toks[t].c_str()) {
                vi = t;
                break;
              }
              if (t == 1) break;
            }
            long j = col_id(toks[vi]);
            if (btype == "FR") { xl[j] = -kInf; xu[j] = kInf; xl_set[j] = xu_set[j] = 1; }
            else if (btype == "MI") { xl[j] = -kInf; xl_set[j] = 1; }
            else if (btype == "PL") { xu[j] = kInf; xu_set[j] = 1; }
            else { xl[j] = 0.0; xu[j] = 1.0; xl_set[j] = xu_set[j] = 1; }
          }
        } else if (toks.size() >= 3) {
          long j = col_id(toks[toks.size() - 2]);
          double v = std::strtod(toks.back().c_str(), nullptr);
          if (btype == "UP") {
            xu[j] = v; xu_set[j] = 1;
            if (v < 0 && !xl_set[j]) { xl[j] = -kInf; }  // MPS quirk
          } else if (btype == "LO") {
            xl[j] = v; xl_set[j] = 1;
          } else if (btype == "FX") {
            xl[j] = xu[j] = v; xl_set[j] = xu_set[j] = 1;
          }
        }
      }
    } else if (section == "QUADOBJ" || section == "QMATRIX") {
      if (toks.size() >= 3) {
        long i = col_id(toks[0]);
        long j = col_id(toks[1]);
        double v = std::strtod(toks[2].c_str(), nullptr);
        q_raw.push_back({i, j, v, section == "QMATRIX"});
      }
    }
    more = tz.next_line(toks, indented);
  }

  out.n = static_cast<long>(col_index.size());
  out.m_struct = static_cast<long>(row_index.size());

  // Q triplets, symmetrized; QUADOBJ stores one triangle, QMATRIX both
  for (const auto& e : q_raw) {
    double v = maximize ? -e.v : e.v;
    out.q_entries.push_back({e.i, e.j, v});
    if (!e.qmatrix && e.i != e.j) out.q_entries.push_back({e.j, e.i, v});
  }

  out.q_lin.assign(out.n, 0.0);
  for (const auto& kv : q_lin_map)
    out.q_lin[kv.first] = maximize ? -kv.second : kv.second;
  if (maximize) out.obj_const = -out.obj_const;

  // structural row bounds
  out.l.assign(out.m_struct, 0.0);
  out.u.assign(out.m_struct, 0.0);
  for (long i = 0; i < out.m_struct; i++) {
    double b = rhs[i];
    double lo, hi;
    switch (row_sense[i]) {
      case 'E': lo = hi = b; break;
      case 'L': lo = -kInf; hi = b; break;
      default:  lo = b; hi = kInf; break;  // 'G'
    }
    if (has_rng[i]) {
      double r = rng_val[i];
      if (row_sense[i] == 'L') lo = b - std::fabs(r);
      else if (row_sense[i] == 'G') hi = b + std::fabs(r);
      else { if (r >= 0) { lo = b; hi = b + r; } else { lo = b + r; hi = b; } }
    }
    out.l[i] = lo;
    out.u[i] = hi;
  }

  // bound rows (identity) for variables with any finite bound
  long row = out.m_struct;
  for (long j = 0; j < out.n; j++) {
    if (xl[j] > -kInf || xu[j] < kInf) {
      out.a_entries.push_back({row, j, 1.0});
      out.l.push_back(xl[j]);
      out.u.push_back(xu[j]);
      row++;
    }
  }
  out.m_total = row;
}

}  // namespace

extern "C" {

struct QpsHandle {
  Parsed parsed;
};

QpsHandle* qps_parse(const char* text, long len) {
  auto* h = new (std::nothrow) QpsHandle();
  if (!h) return nullptr;
  try {
    parse_impl(text, len, h->parsed);
  } catch (const std::exception& e) {
    h->parsed.error = e.what();
  } catch (...) {
    h->parsed.error = "unknown parse error";
  }
  return h;
}

const char* qps_error(QpsHandle* h) {
  return h->parsed.error.empty() ? nullptr : h->parsed.error.c_str();
}
const char* qps_name(QpsHandle* h) { return h->parsed.name.c_str(); }
long qps_n(QpsHandle* h) { return h->parsed.n; }
long qps_m_struct(QpsHandle* h) { return h->parsed.m_struct; }
long qps_m_total(QpsHandle* h) { return h->parsed.m_total; }
double qps_obj_const(QpsHandle* h) { return h->parsed.obj_const; }
long qps_q_nnz(QpsHandle* h) { return (long)h->parsed.q_entries.size(); }
long qps_a_nnz(QpsHandle* h) { return (long)h->parsed.a_entries.size(); }

void qps_copy_q(QpsHandle* h, long* qi, long* qj, double* qv) {
  const auto& e = h->parsed.q_entries;
  for (size_t k = 0; k < e.size(); k++) { qi[k] = e[k].i; qj[k] = e[k].j; qv[k] = e[k].v; }
}
void qps_copy_a(QpsHandle* h, long* ai, long* aj, double* av) {
  const auto& e = h->parsed.a_entries;
  for (size_t k = 0; k < e.size(); k++) { ai[k] = e[k].i; aj[k] = e[k].j; av[k] = e[k].v; }
}
void qps_copy_qlin(QpsHandle* h, double* q) {
  memcpy(q, h->parsed.q_lin.data(), h->parsed.q_lin.size() * sizeof(double));
}
void qps_copy_bounds(QpsHandle* h, double* l, double* u) {
  memcpy(l, h->parsed.l.data(), h->parsed.l.size() * sizeof(double));
  memcpy(u, h->parsed.u.data(), h->parsed.u.size() * sizeof(double));
}
void qps_destroy(QpsHandle* h) { delete h; }

}  // extern "C"
