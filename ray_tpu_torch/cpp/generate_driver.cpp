// A C++ driver of the port's head: the object plane's round trips and a
// CALL of an exported generate function, over the repository's
// cpp/ray_tpu_client.hpp (unchanged).
//
//   generate_driver <host> <port> <authkey_hex> <prompts.json> <bulk_bytes> <rounds>
//
// 1. PUT and GET of a small string, <rounds> times: the median
//    microseconds of each and of the pair.
// 2. PUT and GET of <bulk_bytes> seeded bytes: GB/s each way, the bytes
//    compared.
// 3. CALL("generate", the prompts file's JSON) and GET of its result: the
//    wall seconds from the CALL to the result.
//
// Prints one JSON line: {"put_us", "get_us", "rtt_us", "bulk_bytes",
// "put_gbps", "get_gbps", "call_s", "result": <the result's JSON>}.
// Exits 1 on any mismatch or error.

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#include "ray_tpu_client.hpp"

namespace {

double now_s() {
  return std::chrono::duration<double>(std::chrono::steady_clock::now().time_since_epoch()).count();
}

double median(std::vector<double> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

std::string seeded_bytes(size_t n) {
  std::string out(n, '\0');
  uint64_t x = 0x9E3779B97F4A7C15ull;
  for (size_t i = 0; i < n; i++) {
    x ^= x << 13; x ^= x >> 7; x ^= x << 17;  // xorshift64
    out[i] = char(x >> 56);
  }
  return out;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 7 || std::atoi(argv[6]) < 1) {
    std::fprintf(stderr, "usage: %s <host> <port> <authkey_hex> <prompts.json> <bulk_bytes> <rounds>\n", argv[0]);
    return 2;
  }
  const int rounds = std::atoi(argv[6]);
  try {
    ray_tpu::Client c(argv[1], std::atoi(argv[2]), argv[3]);

    const std::string small = "hello from c++";
    std::vector<double> put_us, get_us, rtt_us;
    for (int i = 0; i < rounds; i++) {
      double t0 = now_s();
      auto id = c.Put(small);
      double t1 = now_s();
      auto val = c.Get(id);
      double t2 = now_s();
      if (val != small) {
        std::fprintf(stderr, "small GET mismatch: %s\n", val.c_str());
        return 1;
      }
      put_us.push_back((t1 - t0) * 1e6);
      get_us.push_back((t2 - t1) * 1e6);
      rtt_us.push_back((t2 - t0) * 1e6);
    }

    const size_t bulk_n = size_t(std::strtoull(argv[5], nullptr, 10));
    const std::string bulk = seeded_bytes(bulk_n);
    double t0 = now_s();
    auto bid = c.Put(bulk);
    double t1 = now_s();
    auto back = c.Get(bid, 120.0);
    double t2 = now_s();
    if (back != bulk) {
      std::fprintf(stderr, "bulk GET mismatch: %zu bytes back of %zu\n", back.size(), bulk.size());
      return 1;
    }

    std::ifstream f(argv[4]);
    std::stringstream prompts;
    prompts << f.rdbuf();
    double t3 = now_s();
    auto rid = c.Call("generate", prompts.str());
    auto result = c.Get(rid, 900.0);
    double t4 = now_s();

    std::printf("{\"put_us\":%.3f,\"get_us\":%.3f,\"rtt_us\":%.3f,\"bulk_bytes\":%zu,\"put_gbps\":%.4f,"
                "\"get_gbps\":%.4f,\"call_s\":%.6f,\"result\":%s}\n",
                median(put_us), median(get_us), median(rtt_us), bulk_n, bulk_n / (t1 - t0) / 1e9,
                bulk_n / (t2 - t1) / 1e9, t4 - t3, result.c_str());
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "driver failed: %s\n", e.what());
    return 1;
  }
}
