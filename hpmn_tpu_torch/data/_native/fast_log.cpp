// Native CSV event-log parser for dataset preprocessing.
//
// Reference equivalent: the raw-log pass of the per-dataset preprocessing
// scripts — SURVEY.md §3.1 marks it the preprocessing hot loop (I/O bound,
// run once over ~1e8-row behavior logs). Python's csv module tops out
// around 1e5 rows/s; this single-pass parser with string interning runs at
// millions of rows/s and hands interned int32 id arrays straight to the
// vectorized numpy example-assembly in preprocess.py.
//
// Interface (C, for ctypes): parse a CSV of
//     user,item,category[,behavior],timestamp
// interning user/item/category tokens to dense 0/1-based int ids.
// Items/categories are 1-based (0 = pad, matching the Batch schema);
// users are 0-based.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Result {
  std::vector<int32_t> uid, item, cat;
  std::vector<int64_t> ts;
  int32_t n_users = 0, n_items = 1, n_cats = 1;  // 1-based item/cat vocab
};

int32_t intern(std::unordered_map<std::string, int32_t>& map, int32_t& next,
               const char* begin, const char* end) {
  std::string key(begin, end - begin);
  auto it = map.find(key);
  if (it != map.end()) return it->second;
  map.emplace(std::move(key), next);
  return next++;
}

}  // namespace

extern "C" {

// behavior_col: 0-based column index of the behavior-type field, or -1 if
// the log has no behavior column (then timestamp is column 3, else 4).
// behavior_keep: value to keep (ignored when behavior_col < 0; empty = all).
Result* fast_parse_csv(const char* path, int behavior_col,
                       const char* behavior_keep) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* res = new Result();
  std::unordered_map<std::string, int32_t> users, items, cats;
  const bool filter = behavior_col >= 0 && behavior_keep[0] != '\0';
  const size_t keep_len = strlen(behavior_keep);
  const int ts_col = behavior_col >= 0 ? 4 : 3;

  char* line = nullptr;
  size_t cap = 0;
  ssize_t len;
  const char* field[8];
  size_t flen[8];
  while ((len = getline(&line, &cap, f)) > 0) {
    if (line[len - 1] == '\n') line[--len] = '\0';
    if (len > 0 && line[len - 1] == '\r') line[--len] = '\0';
    if (len == 0) continue;
    int nf = 0;
    const char* p = line;
    const char* start = p;
    for (; nf < 8; ++p) {
      if (*p == ',' || *p == '\0') {
        field[nf] = start;
        flen[nf] = p - start;
        ++nf;
        if (*p == '\0') break;
        start = p + 1;
      }
    }
    if (nf <= ts_col) continue;  // malformed row
    if (filter && (flen[behavior_col] != keep_len ||
                   strncmp(field[behavior_col], behavior_keep, keep_len)))
      continue;
    res->uid.push_back(
        intern(users, res->n_users, field[0], field[0] + flen[0]));
    res->item.push_back(
        intern(items, res->n_items, field[1], field[1] + flen[1]));
    res->cat.push_back(
        intern(cats, res->n_cats, field[2], field[2] + flen[2]));
    res->ts.push_back(strtoll(field[ts_col], nullptr, 10));
  }
  free(line);
  fclose(f);
  return res;
}

int64_t fast_n_rows(Result* r) { return (int64_t)r->uid.size(); }
int32_t fast_n_users(Result* r) { return r->n_users; }
int32_t fast_n_items(Result* r) { return r->n_items; }
int32_t fast_n_cats(Result* r) { return r->n_cats; }
const int32_t* fast_uid(Result* r) { return r->uid.data(); }
const int32_t* fast_item(Result* r) { return r->item.data(); }
const int32_t* fast_cat(Result* r) { return r->cat.data(); }
const int64_t* fast_ts(Result* r) { return r->ts.data(); }
void fast_free(Result* r) { delete r; }

}  // extern "C"
