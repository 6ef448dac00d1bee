// The dependency levels of one JODIE epoch, on the host.
//
// Event e = (u, i, neg) reads and writes row u of the user tables and rows
// i and neg of the item tables. Its level is one more than the last level
// of any of those rows, so the events of one level touch disjoint rows and
// every row meets its events in time order. ops/jodie_epoch.py holds this
// function to its numpy twin (scan_levels_np); csrc/jodie_epoch.cu walks the
// levels in order, the events of a level side by side.
//
//   g++ -O3 -shared -fPIC -std=c++17 -o libjodie_schedule.so jodie_schedule.cpp

#include <stdint.h>

#include <algorithm>
#include <vector>

extern "C" {

// uid, iid, negs: (T,) int32 event rows. Writes order (T,) int32, the
// events grouped by level and in time order inside a level, and
// level_ptr[0 .. L] (room for T + 1 int32), the start of each level in
// order. Returns L, or -1 - e for the first event e with a row out of
// range.
int64_t jodie_scan_levels(const int32_t* uid, const int32_t* iid,
                          const int32_t* negs, int64_t T, int64_t n_users,
                          int64_t n_items, int32_t* order,
                          int32_t* level_ptr) {
  std::vector<int32_t> last_u(n_users, 0), last_i(n_items, 0), level(T);
  int32_t L = 0;
  for (int64_t e = 0; e < T; ++e) {
    const int32_t u = uid[e], i = iid[e], n = negs[e];
    if (u < 0 || u >= n_users || i < 0 || i >= n_items || n < 0 ||
        n >= n_items)
      return -1 - e;
    const int32_t l =
        1 + std::max(last_u[u], std::max(last_i[i], last_i[n]));
    level[e] = l;
    last_u[u] = last_i[i] = last_i[n] = l;
    L = std::max(L, l);
  }
  // counting sort by level, stable
  std::fill(level_ptr, level_ptr + L + 1, 0);
  for (int64_t e = 0; e < T; ++e) ++level_ptr[level[e]];
  for (int32_t l = 1; l <= L; ++l) level_ptr[l] += level_ptr[l - 1];
  std::vector<int32_t> next(level_ptr, level_ptr + L);
  for (int64_t e = 0; e < T; ++e) order[next[level[e] - 1]++] = (int32_t)e;
  return L;
}

}  // extern "C"
