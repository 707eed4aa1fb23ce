// Native inverted-file index for BoW place recognition.
//
// TPU-native equivalent of the reference's KeyFrameDatabase inverted files
// (KeyFrameDatabase.cc:56-73): per-camera word -> keyframe postings with
// shared-word accumulation queries.  The device side scores BoW vectors in
// batch; THIS index is the irregular host-side part, called every frame
// during relocalization and the dual-camera bootstrap, so it is C++ like
// the reference's runtime rather than Python dict-of-sets.
//
// C ABI (ctypes): one opaque handle per database.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct InvFile {
  int n_cams = 0;
  int n_words = 0;
  // postings[cam][word] -> sorted vector of keyframe ids
  std::vector<std::vector<std::vector<int64_t>>> postings;
  // registered words per (kid, cam) so erase is exact
  std::unordered_map<int64_t, std::vector<std::vector<int32_t>>> kf_words;
};

}  // namespace

extern "C" {

void* invfile_create(int n_cams, int n_words) {
  auto* db = new InvFile();
  db->n_cams = n_cams;
  db->n_words = n_words;
  db->postings.assign(n_cams, std::vector<std::vector<int64_t>>(n_words));
  return db;
}

void invfile_destroy(void* h) { delete static_cast<InvFile*>(h); }

void invfile_add(void* h, int64_t kid, int cam, const int32_t* words,
                 int n) {
  auto* db = static_cast<InvFile*>(h);
  auto& rec = db->kf_words[kid];
  if (rec.empty()) rec.resize(db->n_cams);
  std::vector<char> seen(db->n_words, 0);
  for (int i = 0; i < n; ++i) {
    int32_t w = words[i];
    if (w < 0 || w >= db->n_words || seen[w]) continue;
    seen[w] = 1;
    db->postings[cam][w].push_back(kid);
    rec[cam].push_back(w);
  }
}

void invfile_erase(void* h, int64_t kid) {
  auto* db = static_cast<InvFile*>(h);
  auto it = db->kf_words.find(kid);
  if (it == db->kf_words.end()) return;
  for (int cam = 0; cam < db->n_cams; ++cam) {
    for (int32_t w : it->second[cam]) {
      auto& lst = db->postings[cam][w];
      for (size_t i = 0; i < lst.size(); ++i) {
        if (lst[i] == kid) {
          lst[i] = lst.back();
          lst.pop_back();
          break;
        }
      }
    }
  }
  db->kf_words.erase(it);
}

void invfile_clear(void* h) {
  auto* db = static_cast<InvFile*>(h);
  for (auto& cam : db->postings)
    for (auto& lst : cam) lst.clear();
  db->kf_words.clear();
}

// Query camera `resp_cam`'s index with a word list; excludes `exclude`
// kids.  Writes up to `cap` (kid, shared-word count) pairs; returns count.
int invfile_query(void* h, int resp_cam, const int32_t* words, int n,
                  const int64_t* exclude, int n_excl, int64_t* out_kids,
                  int32_t* out_counts, int cap) {
  auto* db = static_cast<InvFile*>(h);
  std::unordered_map<int64_t, int32_t> acc;
  std::vector<char> seen(db->n_words, 0);
  for (int i = 0; i < n; ++i) {
    int32_t w = words[i];
    if (w < 0 || w >= db->n_words || seen[w]) continue;
    seen[w] = 1;
    for (int64_t kid : db->postings[resp_cam][w]) acc[kid] += 1;
  }
  for (int i = 0; i < n_excl; ++i) acc.erase(exclude[i]);
  int m = 0;
  for (const auto& kv : acc) {
    if (m >= cap) break;
    out_kids[m] = kv.first;
    out_counts[m] = kv.second;
    ++m;
  }
  return m;
}

}  // extern "C"
