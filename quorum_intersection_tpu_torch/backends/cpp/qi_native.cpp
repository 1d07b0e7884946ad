// qi_native — standalone native CLI for the quorum-intersection framework.
//
// The reference ships as a single C++ binary (CLI C21, frontend C10-C12,
// analytics C14-C16, pipeline C17-C19 of SURVEY.md §2.1; see
// the reference tool's quorum_intersection.cpp:402-800).  This translation unit is
// the framework's native equivalent: a fresh C++17 implementation of the
// full stdin→stdout pipeline — hand-rolled JSON parser (no Boost), trust
// graph with explicit dangling policy (Q1), iterative Tarjan SCC with the
// sink-first numbering contract, per-SCC quorum scan, the branch-and-bound
// disjointness search (linked from qi_oracle.cpp), PageRank with the
// reference's pinned deviations (C15), and SCC-colored Graphviz (C14).
//
// Flag surface and exit-code contract match the reference CLI
// (quorum_intersection.cpp:744-800): `-h` usage/exit 0, bad flag
// "Invalid option!"+usage/exit 1, `-p` PageRank/exit 0, default mode prints
// true/false and exits 0 iff intersecting.  Superset flags mirror the Python
// CLI: --dangling-policy, --scc-select, --scope-scc, --compat, --seed,
// --randomized.
//
// Build (done on demand by backends/cpp/__init__.py:build_native_cli):
//   g++ -O2 -std=c++17 qi_native.cpp qi_oracle.cpp -o qi_native

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <iostream>
#include <limits>
#include <memory>
#include <random>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

// ---- solver core (qi_oracle.cpp) -----------------------------------------

extern "C" {
int32_t qi_check_scc(int32_t n, const int32_t* succ_off,
                     const int32_t* succ_tgt, const int32_t* roots,
                     const int32_t* units, const int32_t* mem,
                     const int32_t* inner, const int32_t* scc,
                     int32_t scc_len, int32_t scope_to_scc, int32_t use_rng,
                     uint64_t seed, int32_t trace, int32_t* q1_out,
                     int32_t* q1_len, int32_t* q2_out, int32_t* q2_len,
                     int64_t* stats_out);
int32_t qi_max_quorum(int32_t n, const int32_t* roots, const int32_t* units,
                      const int32_t* mem, const int32_t* inner,
                      const int32_t* nodes, int32_t nodes_len, uint8_t* avail,
                      int32_t* out);
}

namespace {

// ---- minimal JSON ---------------------------------------------------------
// Just enough for stellarbeat /nodes/raw snapshots: objects, arrays, strings
// (with escapes incl. \uXXXX → UTF-8), numbers, true/false/null.

struct JValue;
using JPtr = std::unique_ptr<JValue>;

struct JValue {
  enum Kind { Null, Bool, Num, Str, Arr, Obj } kind = Null;
  bool b = false;
  bool is_int = false;  // number token had no fraction/exponent
  double num = 0;
  std::string str;
  std::vector<JPtr> arr;
  std::vector<std::pair<std::string, JPtr>> obj;  // order-preserving

  const JValue* get(const std::string& key) const {
    // Last occurrence wins on duplicate keys, like Python's json.loads.
    for (auto it = obj.rbegin(); it != obj.rend(); ++it) {
      if (it->first == key) return it->second.get();
    }
    return nullptr;
  }
};

// Hostile-input hardening: caps keep recursive descent (JSON values, quorum
// sets) inside the native stack instead of overflowing on crafted input.
// kMaxQSetDepth matches schema.py MAX_QSET_DEPTH so both CLIs reject the
// same snapshots with the same clean diagnostic.
constexpr int kMaxJsonDepth = 512;
constexpr int kMaxQSetDepth = 128;

struct JsonParser {
  const char* p;
  const char* end;
  int depth = 0;
  explicit JsonParser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

  [[noreturn]] void fail(const std::string& why) {
    throw std::runtime_error("JSON parse error: " + why);
  }
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  char peek() {
    skip_ws();
    if (p >= end) fail("unexpected end of input");
    return *p;
  }
  void expect(char c) {
    if (peek() != c) fail(std::string("expected '") + c + "'");
    ++p;
  }

  JPtr parse() {
    JPtr v = parse_value();
    skip_ws();
    if (p != end) fail("trailing data after top-level value");
    return v;
  }

  JPtr parse_value() {
    switch (peek()) {
      case '{': return parse_object();
      case '[': return parse_array();
      case '"': {
        auto v = std::make_unique<JValue>();
        v->kind = JValue::Str;
        v->str = parse_string();
        return v;
      }
      case 't': return parse_lit("true", true);
      case 'f': return parse_lit("false", false);
      case 'n': {
        check_lit("null");
        return std::make_unique<JValue>();
      }
      default: return parse_number();
    }
  }

  void check_lit(const char* lit) {
    const size_t len = std::strlen(lit);
    if (static_cast<size_t>(end - p) < len || std::strncmp(p, lit, len) != 0) {
      fail(std::string("bad literal, expected ") + lit);
    }
    p += len;
  }
  JPtr parse_lit(const char* lit, bool val) {
    check_lit(lit);
    auto v = std::make_unique<JValue>();
    v->kind = JValue::Bool;
    v->b = val;
    return v;
  }

  JPtr parse_number() {
    // Strict JSON grammar: -? (0 | [1-9][0-9]*) frac? exp? — so malformed
    // inputs the Python CLI rejects (json.loads) are rejected here too.
    const char* start = p;
    if (p < end && *p == '-') ++p;
    if (p >= end || *p < '0' || *p > '9') fail("bad number");
    if (*p == '0') {
      ++p;
    } else {
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    bool integral = true;
    if (p < end && *p == '.') {
      integral = false;
      ++p;
      if (p >= end || *p < '0' || *p > '9') fail("bad number fraction");
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      integral = false;
      ++p;
      if (p < end && (*p == '-' || *p == '+')) ++p;
      if (p >= end || *p < '0' || *p > '9') fail("bad number exponent");
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    auto v = std::make_unique<JValue>();
    v->kind = JValue::Num;
    v->is_int = integral;
    v->num = std::strtod(std::string(start, p).c_str(), nullptr);
    return v;
  }

  unsigned parse_hex4() {
    if (end - p < 4) fail("bad \\u escape");
    unsigned code = 0;
    for (int i = 0; i < 4; ++i) {
      const char h = *p++;
      code <<= 4;
      if (h >= '0' && h <= '9') code |= h - '0';
      else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
      else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
      else fail("bad \\u escape");
    }
    return code;
  }

  static void encode_utf8(std::string& out, unsigned code) {
    if (code < 0x80) {
      out.push_back(static_cast<char>(code));
    } else if (code < 0x800) {
      out.push_back(static_cast<char>(0xC0 | (code >> 6)));
      out.push_back(static_cast<char>(0x80 | (code & 0x3F)));
    } else if (code < 0x10000) {
      out.push_back(static_cast<char>(0xE0 | (code >> 12)));
      out.push_back(static_cast<char>(0x80 | ((code >> 6) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | (code & 0x3F)));
    } else {
      out.push_back(static_cast<char>(0xF0 | (code >> 18)));
      out.push_back(static_cast<char>(0x80 | ((code >> 12) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | ((code >> 6) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | (code & 0x3F)));
    }
  }

  std::string parse_string() {
    expect('"');
    std::string out;
    while (p < end && *p != '"') {
      char c = *p++;
      if (static_cast<unsigned char>(c) < 0x20) {
        fail("raw control character in string");  // json.loads parity
      }
      if (c != '\\') {
        out.push_back(c);
        continue;
      }
      if (p >= end) fail("dangling escape");
      char e = *p++;
      switch (e) {
        case '"': out.push_back('"'); break;
        case '\\': out.push_back('\\'); break;
        case '/': out.push_back('/'); break;
        case 'b': out.push_back('\b'); break;
        case 'f': out.push_back('\f'); break;
        case 'n': out.push_back('\n'); break;
        case 'r': out.push_back('\r'); break;
        case 't': out.push_back('\t'); break;
        case 'u': {
          // Surrogate pairs combine into one code point (matching Python's
          // json.loads); a LONE surrogate folds to U+FFFD — Python would
          // keep the unpaired surrogate and then crash encoding it to
          // stdout, so there is no valid byte-identical behavior to mirror.
          unsigned code = parse_hex4();
          if (code >= 0xDC00 && code <= 0xDFFF) {
            code = 0xFFFD;  // lone low surrogate
          } else if (code >= 0xD800 && code <= 0xDBFF) {
            const unsigned hi = code;
            code = 0xFFFD;  // unless a low surrogate follows:
            if (end - p >= 6 && p[0] == '\\' && p[1] == 'u') {
              const char* save = p;
              p += 2;
              const unsigned lo = parse_hex4();
              if (lo >= 0xDC00 && lo <= 0xDFFF) {
                code = 0x10000 + ((hi - 0xD800) << 10) + (lo - 0xDC00);
              } else {
                p = save;  // not a pair: re-process the escape next round
              }
            }
          }
          encode_utf8(out, code);
          break;
        }
        default: fail("unknown escape");
      }
    }
    if (p >= end) fail("unterminated string");
    ++p;  // closing quote
    return out;
  }

  JPtr parse_array() {
    if (++depth > kMaxJsonDepth) fail("nesting too deep");
    expect('[');
    auto v = std::make_unique<JValue>();
    v->kind = JValue::Arr;
    if (peek() == ']') {
      ++p;
      --depth;
      return v;
    }
    for (;;) {
      v->arr.push_back(parse_value());
      char c = peek();
      if (c == ',') {
        ++p;
        continue;
      }
      if (c == ']') {
        ++p;
        --depth;
        return v;
      }
      fail("expected ',' or ']'");
    }
  }

  JPtr parse_object() {
    if (++depth > kMaxJsonDepth) fail("nesting too deep");
    expect('{');
    auto v = std::make_unique<JValue>();
    v->kind = JValue::Obj;
    if (peek() == '}') {
      ++p;
      --depth;
      return v;
    }
    for (;;) {
      std::string key = parse_string();
      expect(':');
      v->obj.emplace_back(std::move(key), parse_value());
      char c = peek();
      if (c == ',') {
        ++p;
        continue;
      }
      if (c == '}') {
        ++p;
        --depth;
        return v;
      }
      fail("expected ',' or '}'");
    }
  }
};

// ---- schema (C10-C11) -----------------------------------------------------

struct QSet {
  bool null = true;  // null/empty quorumSet ⇒ never satisfiable (Q2)
  int64_t threshold = 0;
  std::vector<std::string> validators;
  std::vector<QSet> inner;
};

struct Node {
  std::string public_key;
  std::string name;
  QSet qset;
};

// Same validation rules as fbas/schema.py:_parse_qset — the native binary
// must reject exactly what the Python CLI rejects, or verdicts diverge on
// malformed snapshots.
QSet parse_qset(const JValue* v, const std::string& where, int depth = 0) {
  if (depth > kMaxQSetDepth) {
    throw std::runtime_error(where + ": quorumSet nesting exceeds depth " +
                             std::to_string(kMaxQSetDepth));
  }
  QSet q;
  if (v == nullptr || v->kind == JValue::Null) return q;
  if (v->kind != JValue::Obj) {
    throw std::runtime_error(where + ": quorumSet must be an object or null");
  }
  if (v->obj.empty()) return q;  // {} ≡ null (Q2)
  q.null = false;
  const JValue* t = v->get("threshold");
  if (t == nullptr) {
    throw std::runtime_error(where + ": non-empty quorumSet missing 'threshold'");
  }
  if (t->kind == JValue::Num && t->is_int) {
    q.threshold = static_cast<int64_t>(t->num);
  } else if (t->kind == JValue::Str) {
    // boost::property_tree compatibility: accept numeric strings
    // (schema.py accepts int("...") — full-string, optional sign).
    const std::string& s = t->str;
    size_t pos = 0;
    try {
      q.threshold = std::stoll(s, &pos);
    } catch (const std::out_of_range&) {
      // Python's arbitrary-precision int() accepts magnitudes beyond int64;
      // any such threshold is unsatisfiable either way (non-positive hits
      // the Q3 sentinel, huge positive exceeds every member count), so
      // clamp to the matching int64 extreme instead of rejecting the
      // snapshot — keeps stdout parity with the Python CLI.
      size_t i = 0;
      while (i < s.size() && std::isspace(static_cast<unsigned char>(s[i]))) ++i;
      const bool neg = i < s.size() && s[i] == '-';
      if (i < s.size() && (s[i] == '-' || s[i] == '+')) ++i;
      const size_t digits_start = i;
      while (i < s.size() && s[i] >= '0' && s[i] <= '9') ++i;
      pos = (i > digits_start) ? i : std::string::npos;
      q.threshold = neg ? std::numeric_limits<int64_t>::min()
                        : std::numeric_limits<int64_t>::max();
    } catch (...) {
      pos = std::string::npos;
    }
    // Python's int() also tolerates surrounding whitespace.
    while (pos != std::string::npos && pos < s.size() &&
           std::isspace(static_cast<unsigned char>(s[pos]))) {
      ++pos;
    }
    if (pos != s.size()) {
      throw std::runtime_error(where + ": threshold '" + s + "' is not an integer");
    }
  } else {
    throw std::runtime_error(where + ": threshold must be an integer");
  }
  if (const JValue* vals = v->get("validators"); vals != nullptr) {
    if (vals->kind == JValue::Null) {
      // absent/null → empty (schema.py validators=None path)
    } else if (vals->kind != JValue::Arr) {
      throw std::runtime_error(where + ": validators must be an array");
    } else {
      for (const auto& s : vals->arr) {
        if (s->kind != JValue::Str) {
          throw std::runtime_error(where + ": validator entries must be strings");
        }
        q.validators.push_back(s->str);
      }
    }
  }
  if (const JValue* in = v->get("innerQuorumSets"); in != nullptr) {
    if (in->kind == JValue::Null) {
      // absent/null → empty
    } else if (in->kind != JValue::Arr) {
      throw std::runtime_error(where + ": innerQuorumSets must be an array");
    } else {
      for (size_t i = 0; i < in->arr.size(); ++i) {
        q.inner.push_back(parse_qset(
            in->arr[i].get(),
            where + ".innerQuorumSets[" + std::to_string(i) + "]", depth + 1));
      }
    }
  }
  return q;
}

std::vector<Node> parse_fbas(const std::string& text) {
  JsonParser parser(text);
  JPtr root = parser.parse();
  if (root->kind != JValue::Arr) {
    throw std::runtime_error("top-level JSON must be an array of nodes");
  }
  std::vector<Node> nodes;
  nodes.reserve(root->arr.size());
  std::unordered_map<std::string, size_t> seen;  // duplicate publicKey guard
  for (size_t i = 0; i < root->arr.size(); ++i) {
    const JValue* nv = root->arr[i].get();
    if (nv->kind != JValue::Obj) {
      throw std::runtime_error("node " + std::to_string(i) + " is not an object");
    }
    Node node;
    const JValue* pk = nv->get("publicKey");
    if (pk == nullptr || pk->kind != JValue::Str) {
      throw std::runtime_error("node " + std::to_string(i) + " missing publicKey");
    }
    node.public_key = pk->str;
    if (!seen.emplace(node.public_key, i).second) {
      // schema.py Fbas.__post_init__: silently aliased vertices are a
      // foot-gun; reject like the Python CLI does.
      throw std::runtime_error("duplicate publicKey: '" + node.public_key + "'");
    }
    if (const JValue* nm = nv->get("name"); nm != nullptr && nm->kind == JValue::Str) {
      node.name = nm->str;
    }
    // quorumSet required, like the reference's get_child (cpp:430)
    bool has_qs = false;
    for (const auto& kv : nv->obj) {
      if (kv.first == "quorumSet") has_qs = true;
    }
    if (!has_qs) {
      throw std::runtime_error("node " + std::to_string(i) + " missing quorumSet");
    }
    node.qset = parse_qset(nv->get("quorumSet"), node.public_key);
    nodes.push_back(std::move(node));
  }
  return nodes;
}

// ---- graph build + flattened solver tables (C12 + oracle marshalling) -----

struct FlatGraph {
  int32_t n = 0;
  std::vector<int32_t> succ_off, succ_tgt;   // CSR with multiplicity (Q7)
  std::vector<int32_t> roots;                // -1 ⇒ null qset (Q2)
  std::vector<int32_t> units;                // 5 ints/unit
  std::vector<int32_t> mem, inner;
  std::vector<std::string> ids, names;
  int64_t dangling = 0;

  const std::string& label(int32_t v) const {
    return names[v].empty() ? ids[v] : names[v];
  }
};

int32_t flatten_qset(const QSet& q, FlatGraph& g,
                     const std::unordered_map<std::string, int32_t>& index,
                     bool alias0, std::vector<int32_t>& out_edges,
                     int depth = 0) {
  // Parsed qsets are already capped at kMaxQSetDepth; this guards
  // programmatic construction the same way encode/circuit.py does.
  if (depth > kMaxQSetDepth) {
    throw std::runtime_error("quorumSet nesting exceeds depth " +
                             std::to_string(kMaxQSetDepth));
  }
  // Root-level null/{} (Q2): the caller stores -1 and the solver skips
  // the node's slice entirely.  An INNER null must NOT get the sentinel —
  // it still occupies a voting slot that can never be satisfied
  // (fbas/semantics.py counts it in the fail budget; the Python-side
  // FlatGraph Q3-clamps it to the never-satisfiable sentinel m_count+1,
  // exactly like the normalization below).  Returning -1 at inner depths leaked
  // the root sentinel into the inner pool, where slice_unit dereferenced
  // units[-1] — a heap-buffer-overflow found by tools/fuzz_native.py on
  // `"innerQuorumSets": [{}]` inputs.  Falling through is sufficient: a
  // null qset has threshold 0 and no members, so the general path's Q3
  // normalization below emits the never-satisfiable unit {1,0,0,0,0}.
  if (q.null && depth == 0) return -1;
  const int32_t unit = static_cast<int32_t>(g.units.size() / 5);
  g.units.insert(g.units.end(), {0, 0, 0, 0, 0});  // placeholder
  std::vector<int32_t> members;
  for (const std::string& key : q.validators) {
    auto it = index.find(key);
    int32_t v;
    if (it == index.end()) {
      ++g.dangling;
      if (!alias0) continue;  // strict: never-available ≡ dropped (Q1)
      v = 0;                  // reference aliasing (cpp:456)
    } else {
      v = it->second;
    }
    members.push_back(v);
    out_edges.push_back(v);
  }
  std::vector<int32_t> inner_units;
  for (const QSet& iq : q.inner) {
    inner_units.push_back(flatten_qset(iq, g, index, alias0, out_edges, depth + 1));
  }
  const int32_t mb = static_cast<int32_t>(g.mem.size());
  g.mem.insert(g.mem.end(), members.begin(), members.end());
  const int32_t me = static_cast<int32_t>(g.mem.size());
  const int32_t ib = static_cast<int32_t>(g.inner.size());
  g.inner.insert(g.inner.end(), inner_units.begin(), inner_units.end());
  const int32_t ie = static_cast<int32_t>(g.inner.size());
  int32_t* U = g.units.data() + 5 * unit;
  // Q3 normalization (fbas/semantics.py contract): threshold <= 0 ⇒ never
  // satisfiable (members + inners + 1 can never be reached).  Thresholds
  // above the member count are equally unsatisfiable — clamping them to the
  // same sentinel also keeps huge int64 values exact in the int32 unit
  // table (a raw cast would truncate and could flip the verdict).
  const int64_t m_count = (me - mb) + (ie - ib);
  const int64_t t = q.threshold;
  U[0] = static_cast<int32_t>((t <= 0 || t > m_count) ? m_count + 1 : t);
  U[1] = mb;
  U[2] = me;
  U[3] = ib;
  U[4] = ie;
  return unit;
}

FlatGraph build_graph(const std::vector<Node>& nodes, bool alias0) {
  FlatGraph g;
  g.n = static_cast<int32_t>(nodes.size());
  std::unordered_map<std::string, int32_t> index;
  for (int32_t i = 0; i < g.n; ++i) {
    index.emplace(nodes[i].public_key, i);
    g.ids.push_back(nodes[i].public_key);
    g.names.push_back(nodes[i].name);
  }
  std::vector<std::vector<int32_t>> succ(g.n);
  g.roots.resize(g.n);
  for (int32_t i = 0; i < g.n; ++i) {
    g.roots[i] = flatten_qset(nodes[i].qset, g, index, alias0, succ[i]);
  }
  g.succ_off.push_back(0);
  for (int32_t i = 0; i < g.n; ++i) {
    g.succ_tgt.insert(g.succ_tgt.end(), succ[i].begin(), succ[i].end());
    g.succ_off.push_back(static_cast<int32_t>(g.succ_tgt.size()));
  }
  return g;
}

// ---- Tarjan SCC (sink-first numbering, matching fbas/graph.py) ------------

std::vector<std::vector<int32_t>> tarjan_sccs(const FlatGraph& g) {
  const int32_t n = g.n;
  std::vector<int32_t> comp(n, -1), low(n, 0), disc(n, 0);
  std::vector<uint8_t> on_stack(n, 0);
  std::vector<int32_t> stack;
  int32_t timer = 0, count = 0;
  std::vector<std::pair<int32_t, int32_t>> work;  // (vertex, edge cursor)

  for (int32_t root = 0; root < n; ++root) {
    if (disc[root]) continue;
    work.emplace_back(root, g.succ_off[root]);
    while (!work.empty()) {
      auto& [v, cursor] = work.back();
      if (cursor == g.succ_off[v]) {
        disc[v] = low[v] = ++timer;
        stack.push_back(v);
        on_stack[v] = 1;
      }
      bool advanced = false;
      while (cursor < g.succ_off[v + 1]) {
        const int32_t w = g.succ_tgt[cursor++];
        if (!disc[w]) {
          work.emplace_back(w, g.succ_off[w]);
          advanced = true;
          break;
        }
        if (on_stack[w]) low[v] = std::min(low[v], disc[w]);
      }
      if (advanced) continue;
      const int32_t done = v;
      work.pop_back();
      if (low[done] == disc[done]) {
        for (;;) {
          const int32_t w = stack.back();
          stack.pop_back();
          on_stack[w] = 0;
          comp[w] = count;
          if (w == done) break;
        }
        ++count;
      }
      if (!work.empty()) {
        low[work.back().first] = std::min(low[work.back().first], low[done]);
      }
    }
  }
  std::vector<std::vector<int32_t>> sccs(count);
  for (int32_t v = 0; v < n; ++v) sccs[comp[v]].push_back(v);
  return sccs;
}

// ---- verbose narration (pipeline parity, cpp:475-490 print shape) ---------

void print_quorum(const FlatGraph& g, const std::vector<int32_t>& quorum) {
  for (const int32_t v : quorum) {
    std::string names;
    const int32_t root = g.roots[v];
    std::string threshold = "null";
    if (root >= 0) {
      const int32_t* U = g.units.data() + 5 * root;
      threshold = std::to_string(U[0]);
      for (int32_t i = U[1]; i < U[2]; ++i) {
        names += g.ids[g.mem[i]];
        names += ' ';
      }
    }
    std::cout << g.names[v] << ' ' << g.ids[v] << "\n( quorumslice: threshold = "
              << threshold << ' ' << names << ") \n\n";
  }
  std::cout << "\n";
}

// ---- PageRank (C15 pinned semantics) + printer (C16) ----------------------

void page_rank(const FlatGraph& g, double m, double convergence,
               uint64_t max_iterations) {
  const int32_t n = g.n;
  if (n == 0) {
    std::cout << "PageRank:\n";
    return;
  }
  std::vector<double> rank(n, 0.0);
  rank[0] = 1.0;  // all mass on vertex 0 (cpp:543)
  std::vector<int32_t> outdeg(n);
  for (int32_t v = 0; v < n; ++v) outdeg[v] = g.succ_off[v + 1] - g.succ_off[v];
  for (uint64_t it = 0; it < max_iterations; ++it) {
    std::vector<double> next(n, m / n);  // base mass every iteration (cpp:555-557)
    for (int32_t v = 0; v < n; ++v) {
      if (outdeg[v] == 0) continue;  // dangling vertices leak their mass
      const double send = (1.0 - m) / outdeg[v] * rank[v];
      for (int32_t e = g.succ_off[v]; e < g.succ_off[v + 1]; ++e) {
        next[g.succ_tgt[e]] += send;  // multiplicity counts (Q7)
      }
    }
    double diff = 0.0, sum = 0.0;
    for (int32_t v = 0; v < n; ++v) {
      diff += std::abs(next[v] - rank[v]);  // un-normalized L1 (cpp:573-575)
      sum += next[v];
    }
    for (int32_t v = 0; v < n; ++v) rank[v] = next[v] / sum;
    if (diff <= convergence) break;
  }
  // sort desc by rank, ties asc by label (cpp:585-613)
  std::vector<int32_t> order(n);
  for (int32_t v = 0; v < n; ++v) order[v] = v;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    if (rank[a] != rank[b]) return rank[a] > rank[b];
    return g.label(a) < g.label(b);
  });
  std::cout << "PageRank:\n";
  char buf[64];
  for (const int32_t v : order) {
    std::snprintf(buf, sizeof(buf), "%g", rank[v]);
    std::cout << g.label(v) << ": " << buf << "\n";
  }
}

// ---- Graphviz (C14: fill color (0xFFFFFF / sccCount) * sccIndex) ----------

void graphviz(const FlatGraph& g, const std::vector<std::vector<int32_t>>& sccs) {
  std::vector<int32_t> comp(g.n);
  for (size_t s = 0; s < sccs.size(); ++s) {
    for (const int32_t v : sccs[s]) comp[v] = static_cast<int32_t>(s);
  }
  // Same print shape as analytics/graphviz.py (which mirrors Boost
  // write_graphviz + the reference's NodeWriter, cpp:492-530).
  const int64_t step = sccs.empty() ? 0 : 0xFFFFFF / static_cast<int64_t>(sccs.size());
  std::cout << "digraph G {\n";
  char color[16];
  for (int32_t v = 0; v < g.n; ++v) {
    std::snprintf(color, sizeof(color), "#%06llx",
                  static_cast<unsigned long long>(step * comp[v]) & 0xFFFFFF);
    std::string label;  // dot-escape like graphviz.py:_escape
    for (const char c : g.label(v)) {
      if (c == '\\' || c == '"') label.push_back('\\');
      label.push_back(c);
    }
    std::cout << v << "[style=filled color=\"" << color << "\" label=\""
              << label << "\" fontcolor=\"white\"];\n";
  }
  for (int32_t v = 0; v < g.n; ++v) {
    for (int32_t e = g.succ_off[v]; e < g.succ_off[v + 1]; ++e) {
      std::cout << v << "->" << g.succ_tgt[e] << " ;\n";
    }
  }
  std::cout << "}\n";
}

// ---- CLI ------------------------------------------------------------------

void usage(std::ostream& os) {
  os << "usage: qi_native [options] < nodes.json\n"
        "Decide the quorum-intersection property of a Stellar FBAS\n"
        "(stellarbeat /nodes/raw JSON on stdin).\n\n"
        "  -h, --help             produce help message\n"
        "  -v, --verbose          print info about the analyzed configuration\n"
        "  -g, --graph            print graphviz representation\n"
        "  -t, --trace            trace-level search narration on stderr\n"
        "  -p, --pagerank         compute PageRank instead\n"
        "  -i, --max_iterations N PageRank iteration cap (default 100000)\n"
        "  -m, --dangling_factor F  PageRank dangling factor (default 0.0001)\n"
        "  -c, --convergence F    PageRank convergence (default 0.0001)\n"
        "      --dangling-policy {strict|alias0}   unknown validator refs\n"
        "      --scc-select {quorum-bearing|front} which SCC to search\n"
        "      --scope-scc        scope availability to the searched SCC\n"
        "      --compat           reference-bug-compatible: alias0 + front\n"
        "      --seed N           randomized branching tie-break seed\n"
        "      --randomized       randomized tie-break (random seed)\n";
}

struct Options {
  bool verbose = false, graph = false, pagerank = false, scope_scc = false;
  bool trace = false;
  bool alias0 = false, front = false, randomized = false;
  uint64_t max_iterations = 100000, seed = 0;
  bool has_seed = false;
  double dangling_factor = 0.0001, convergence = 0.0001;
};

int invalid_option() {
  std::cout << "Invalid option!\n";
  usage(std::cout);
  return 1;
}

}  // namespace

int main(int argc, char** argv) {
  Options opt;
  bool flag_error = false;
  for (int i = 1; i < argc; ++i) {
    const std::string a = argv[i];
    auto next = [&](const char* what) -> const char* {
      if (i + 1 >= argc) {
        // Same surface as argparse's missing-value error (stdout, usage,
        // exit 1 — _RefCompatParser contract).
        (void)what;
        std::exit(invalid_option());
      }
      return argv[++i];
    };
    // Strict numeric flag values: garbage is a usage error (exit-code
    // parity with argparse's type=int/float rejection), not a silent 0.
    auto next_u64 = [&](const char* what) -> uint64_t {
      const char* s = next(what);
      char* endp = nullptr;
      const uint64_t v = std::strtoull(s, &endp, 10);
      if (endp == s || *endp != '\0') flag_error = true;
      return v;
    };
    auto next_f64 = [&](const char* what) -> double {
      const char* s = next(what);
      char* endp = nullptr;
      const double v = std::strtod(s, &endp);
      if (endp == s || *endp != '\0') flag_error = true;
      return v;
    };
    if (a == "-h" || a == "--help") {
      usage(std::cout);
      return 0;
    } else if (a == "-v" || a == "--verbose") {
      opt.verbose = true;
    } else if (a == "-g" || a == "--graph") {
      opt.graph = true;
    } else if (a == "-t" || a == "--trace") {
      opt.trace = true;
    } else if (a == "-p" || a == "--pagerank") {
      opt.pagerank = true;
    } else if (a == "-i" || a == "--max_iterations") {
      opt.max_iterations = next_u64("max_iterations");
    } else if (a == "-m" || a == "--dangling_factor") {
      opt.dangling_factor = next_f64("dangling_factor");
    } else if (a == "-c" || a == "--convergence") {
      opt.convergence = next_f64("convergence");
    } else if (a == "--dangling-policy") {
      const std::string v = next("dangling-policy");
      if (v == "alias0") opt.alias0 = true;
      else if (v == "strict") opt.alias0 = false;
      else return invalid_option();
    } else if (a == "--scc-select") {
      const std::string v = next("scc-select");
      if (v == "front") opt.front = true;
      else if (v == "quorum-bearing") opt.front = false;
      else return invalid_option();
    } else if (a == "--scope-scc") {
      opt.scope_scc = true;
    } else if (a == "--compat") {
      opt.alias0 = true;
      opt.front = true;
    } else if (a == "--seed") {
      opt.seed = next_u64("seed");
      opt.has_seed = true;
      opt.randomized = true;
    } else if (a == "--randomized") {
      opt.randomized = true;
    } else {
      return invalid_option();
    }
    if (flag_error) return invalid_option();
  }

  std::ostringstream ss;
  ss << std::cin.rdbuf();
  FlatGraph g;
  try {
    g = build_graph(parse_fbas(ss.str()), opt.alias0);
  } catch (const std::exception& e) {
    std::cerr << "invalid FBAS configuration: " << e.what() << "\n";
    return 1;
  }

  if (opt.pagerank) {
    page_rank(g, opt.dangling_factor, opt.convergence, opt.max_iterations);
    return 0;  // PageRank mode always exits 0 (cpp:787)
  }

  const std::vector<std::vector<int32_t>> sccs = tarjan_sccs(g);
  if (opt.graph) graphviz(g, sccs);
  if (opt.verbose) {
    std::cout << "total number of strongly connected components: " << sccs.size()
              << "\n";
  }

  // Per-SCC quorum scan (cpp:645-672).
  if (opt.trace) {
    std::fprintf(stderr, "trace: %zu strongly connected components; scanning for quorums\n",
                 sccs.size());
  }
  std::vector<int32_t> quorum_sccs;
  std::vector<uint8_t> avail(g.n, 0);
  std::vector<int32_t> qbuf(g.n);
  for (size_t s = 0; s < sccs.size(); ++s) {
    for (const int32_t v : sccs[s]) avail[v] = 1;
    const int32_t qlen =
        qi_max_quorum(g.n, g.roots.data(), g.units.data(), g.mem.data(),
                      g.inner.data(), sccs[s].data(),
                      static_cast<int32_t>(sccs[s].size()), avail.data(),
                      qbuf.data());
    for (const int32_t v : sccs[s]) avail[v] = 0;
    if (qlen > 0) {
      quorum_sccs.push_back(static_cast<int32_t>(s));
      if (opt.trace) {
        std::fprintf(stderr, "trace: scc %zu (size %zu) contains a quorum (size %d)\n",
                     s, sccs[s].size(), qlen);
      }
      if (opt.verbose) {
        std::cout << "found quorum inside of a strongly connected component:\n";
        print_quorum(g, std::vector<int32_t>(qbuf.begin(), qbuf.begin() + qlen));
      }
    }
  }

  static const std::vector<int32_t> kEmpty;
  const std::vector<int32_t>& main_scc =
      (opt.front || quorum_sccs.empty())
          ? (sccs.empty() ? kEmpty : sccs.front())
          : sccs[quorum_sccs.front()];
  if (opt.verbose) {
    std::cout << "number of strongly connected components containing some quorum: "
              << quorum_sccs.size() << "\n";
    std::cout << "size of the main strongly connected component: "
              << main_scc.size() << "\n";
    std::cout << "main strongly connected component (all minimal quorums are "
                 "included in it; small size means small resilience of the "
                 "network):\n";
    print_quorum(g, main_scc);
  }

  bool intersects;
  std::vector<int32_t> q1, q2;
  if (quorum_sccs.size() != 1) {
    // Guard (cpp:681-688).
    intersects = false;
    if (opt.verbose) {
      std::cout << "network's configuration is broken - more than one strongly "
                   "connected component contains a quorum - "
                << quorum_sccs.size() << "\n";
    }
  } else {
    std::vector<int32_t> q1b(g.n), q2b(g.n);
    int32_t q1l = 0, q2l = 0;
    int64_t stats[3] = {0, 0, 0};
    const int32_t ok = qi_check_scc(
        g.n, g.succ_off.data(), g.succ_tgt.data(), g.roots.data(),
        g.units.data(), g.mem.data(), g.inner.data(), main_scc.data(),
        static_cast<int32_t>(main_scc.size()), opt.scope_scc ? 1 : 0,
        opt.randomized ? 1 : 0,
        opt.has_seed ? opt.seed : std::random_device{}(), opt.trace ? 1 : 0,
        q1b.data(), &q1l, q2b.data(), &q2l, stats);
    intersects = ok == 1;
    q1.assign(q1b.begin(), q1b.begin() + q1l);
    q2.assign(q2b.begin(), q2b.begin() + q2l);
    if (opt.verbose) {
      if (!intersects) {
        std::cout << "found two non-intersecting quorums\nfirst quorum:\n";
        print_quorum(g, q1);
        std::cout << "second quorum:\n";
        print_quorum(g, q2);
      } else {
        std::cout << "all quorums are intersecting\n";
      }
    }
  }

  std::cout << (intersects ? "true" : "false") << "\n";
  return intersects ? 0 : 1;
}
