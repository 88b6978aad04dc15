// ThreadSanitizer test program for dvda_tpu_torch's multi-threaded MLP parser
// (dvda_tpu_torch/host/src/mlp_parse.cc): pass-1 scan, worker pool, the
// merger thread that merges finished sections while the caller steps,
// the sections it hands back to the caller (repairs, bails, the
// sequential redo), and teardown mid-parse.  Each step's published
// arrays are read while the merger writes past them, and parses are
// freed straight after begin and after one step.  Built and run by
// tests/test_torch_tsan.py, which writes the stream and checks that the
// MT parse equals the sequential one.
//
// Usage: torch_tsan_mt_parse <stream-file> <threads> [corrupt_byte_index...]

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
void* mlp_parse(const uint8_t*, int64_t, const int32_t*, const int32_t*);
void* mlp_parse_begin_mt(const uint8_t*, int64_t, const int32_t*,
                         const int32_t*, int32_t, int32_t);
int32_t mlp_parse_step(void*, int64_t);
void mlp_parse_free(void*);
int32_t mp_status(void*);
int64_t mp_nframes(void*);
int64_t mp_total_samples(void*);
int64_t mp_nblocks(void*, int);
int32_t mp_substream_count(void*);
const int32_t* mp_frame_len(void*);
void mp_fill_noise(void*);
const int32_t* mp_noise0(void*);
const int32_t* mp_residuals(void*, int);
int64_t mp_residuals_size(void*, int);
int32_t mp_mmc(void*);
int64_t mp_reconstruct(void*, int64_t, int32_t, int32_t, const int32_t*,
                       uint8_t*, int64_t, int32_t);
}

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <stream> <threads> [corrupt_idx...]\n",
                 argv[0]);
    return 2;
  }
  FILE* f = std::fopen(argv[1], "rb");
  if (!f) return 2;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(static_cast<size_t>(n), 0);
  if (std::fread(data.data(), 1, size_t(n), f) != size_t(n)) return 2;
  std::fclose(f);
  int threads = std::atoi(argv[2]);
  for (int i = 3; i < argc; i++) {
    long idx = std::atol(argv[i]);
    if (idx >= 0 && idx < n) data[size_t(idx)] ^= 0xFF;
  }
  // LUTs: the test writes them next to the stream as raw int32
  std::vector<int32_t> lv(4 * 512), ll(4 * 512);
  {
    std::string p = std::string(argv[1]) + ".luts";
    FILE* g = std::fopen(p.c_str(), "rb");
    if (!g) return 2;
    if (std::fread(lv.data(), 4, lv.size(), g) != lv.size()) return 2;
    if (std::fread(ll.data(), 4, ll.size(), g) != ll.size()) return 2;
    std::fclose(g);
  }

  void* seq = mlp_parse(data.data(), n, lv.data(), ll.data());
  void* mt = mlp_parse_begin_mt(data.data(), n, lv.data(), ll.data(), 0,
                                threads);
  // the incremental loop of the production decode, reading what each
  // step published while the merger goes on behind it
  int64_t seen = 0;
  while (mlp_parse_step(mt, 64)) {
    const int32_t* fl = mp_frame_len(mt);
    for (int64_t i = 0, nf = mp_nframes(mt); i < nf; i++) seen += fl[i];
    for (int s = 0; s < mp_substream_count(mt); s++) {
      const int32_t* r = mp_residuals(mt, s);
      for (int64_t i = 0, nr = mp_residuals_size(mt, s); i < nr; i += 97)
        seen += r[i];
    }
  }
  // teardown mid-parse: free straight after begin, and after one step
  mlp_parse_free(mlp_parse_begin_mt(data.data(), n, lv.data(), ll.data(), 0,
                                    threads));
  void* early = mlp_parse_begin_mt(data.data(), n, lv.data(), ll.data(), 0,
                                   threads);
  mlp_parse_step(early, 64);
  mlp_parse_free(early);
  int ok = 1;
  if (mp_status(seq) != mp_status(mt)) ok = 0;
  if (ok && mp_status(seq) == 0) {
    if (mp_nframes(seq) != mp_nframes(mt) ||
        mp_total_samples(seq) != mp_total_samples(mt))
      ok = 0;
    if (ok && std::memcmp(mp_frame_len(seq), mp_frame_len(mt),
                          size_t(mp_nframes(seq)) * 4) != 0)
      ok = 0;
    // noise is filled on demand (deferred in the parser)
    mp_fill_noise(seq);
    mp_fill_noise(mt);
    if (ok && std::memcmp(mp_noise0(seq), mp_noise0(mt),
                          size_t(mp_total_samples(seq)) * 4) != 0)
      ok = 0;
    for (int s = 0; ok && s < mp_substream_count(seq); s++) {
      if (mp_residuals_size(seq, s) != mp_residuals_size(mt, s)) ok = 0;
      if (ok && std::memcmp(mp_residuals(seq, s), mp_residuals(mt, s),
                            size_t(mp_residuals_size(seq, s)) * 4) != 0)
        ok = 0;
    }
    // threaded reconstruction (substream-parallel AR + frame-range
    // rematrix/pack) under TSAN: serial vs threads-N byte equality,
    // arenas riding the shared pool concurrently
    if (ok) {
      const int32_t perm[8] = {0, 1, 2, 3, 4, 5, 6, 7};
      const int out_ch = mp_mmc(seq) + 1;
      const int64_t cap = mp_total_samples(seq) * int64_t(out_ch) * 3;
      std::vector<uint8_t> a(static_cast<size_t>(cap));
      std::vector<uint8_t> b(static_cast<size_t>(cap));
      const int64_t ra =
          mp_reconstruct(seq, -1, out_ch, 24, perm, a.data(), cap, 1);
      const int64_t rb =
          mp_reconstruct(mt, -1, out_ch, 24, perm, b.data(), cap, threads);
      if (ra < 0 || ra != rb || std::memcmp(a.data(), b.data(), size_t(ra)))
        ok = 0;
    }
  }
  std::printf("frames=%lld status=%d %s (read %lld)\n",
              (long long)mp_nframes(mt), mp_status(mt),
              ok ? "EQUAL" : "MISMATCH", (long long)seen);
  mlp_parse_free(seq);
  mlp_parse_free(mt);
  return ok ? 0 : 1;
}
