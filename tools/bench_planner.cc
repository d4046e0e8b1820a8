// Standalone planner micro-benchmark / profiling harness.
//
// Feeds a payload dump (tools/dump_payloads.py) through hvqm4_plan_frame in
// a loop — no Python, no JAX — so gprof/perf see only the entropy hot loop.
//
//   g++ -std=c++17 -O3 -march=native -pthread [-pg] \
//       -o /tmp/bench_planner tools/bench_planner.cc hvqm4_jax/native/_entropy.cc
//   /tmp/bench_planner payloads.bin [reps]

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

struct PlaneOut {
    uint8_t* meta;
    uint8_t* dc;
    uint32_t* slot;
    uint32_t* meta5;
};
struct PoolOut {
    uint8_t* raw_pool;
    size_t raw_stride, raw_cap;
    uint32_t* desc_pool;
    size_t desc_stride, desc_cap;
    uint8_t* dc_pool;
    size_t dc_stride, dc_cap;
};
struct FrameOut {
    // keep in sync with native/_entropy.cc FrameOut (ABI mirror for the
    // JAX-free micro-bench): mv/mv2 are per-MB PACKED u32 (y16<<16 | x16)
    uint32_t display_id, dc_shift, nest_x, nest_y, raw_used, desc_used,
        dc_used, mv_flags;
    uint8_t* nest;
    uint32_t* mv;
    uint32_t* mv2;
};

extern "C" int hvqm4_plan_frame(const uint8_t*, size_t, int, int, int, int,
                                int, PlaneOut*, PoolOut*, FrameOut*, char*,
                                size_t);

int main(int argc, char** argv) {
    if (argc < 2) {
        std::fprintf(stderr, "usage: %s payloads.bin [reps]\n", argv[0]);
        return 2;
    }
    int reps = argc > 2 ? std::atoi(argv[2]) : 200;
    FILE* f = std::fopen(argv[1], "rb");
    if (!f) { std::perror("open"); return 1; }
    uint32_t w, h, hs, vs, n;
    if (std::fread(&w, 4, 1, f) != 1 || std::fread(&h, 4, 1, f) != 1 ||
        std::fread(&hs, 4, 1, f) != 1 || std::fread(&vs, 4, 1, f) != 1 ||
        std::fread(&n, 4, 1, f) != 1) { std::fprintf(stderr, "bad dump\n"); return 1; }
    std::vector<std::pair<int, std::vector<uint8_t>>> frames(n);
    for (uint32_t i = 0; i < n; i++) {
        uint8_t ft;
        uint32_t sz;
        if (std::fread(&ft, 1, 1, f) != 1 || std::fread(&sz, 4, 1, f) != 1) return 1;
        frames[i].first = ft;
        frames[i].second.resize(sz);
        if (std::fread(frames[i].second.data(), 1, sz, f) != sz) return 1;
    }
    std::fclose(f);

    const int total_blocks = (int)(w * h / 16 + 2 * ((w / hs) * (h / vs) / 16));
    std::vector<uint8_t> meta[3], dc[3];
    std::vector<uint32_t> slot[3], meta5[3];
    PlaneOut planes[3];
    const int bw[3] = {(int)w / 4, (int)(w / hs) / 4, (int)(w / hs) / 4};
    const int bh[3] = {(int)h / 4, (int)(h / vs) / 4, (int)(h / vs) / 4};
    for (int p = 0; p < 3; p++) {
        size_t nb = (size_t)bw[p] * bh[p];
        meta[p].resize(nb);
        dc[p].resize(nb);
        slot[p].resize(nb);
        meta5[p].resize((nb + 4) / 5);
        planes[p] = {meta[p].data(), dc[p].data(), slot[p].data(),
                     meta5[p].data()};
    }
    std::vector<uint8_t> raw_pool((size_t)total_blocks * 16);
    std::vector<uint32_t> desc_pool((size_t)total_blocks * 4);
    std::vector<uint8_t> dc_pool((size_t)total_blocks);
    PoolOut pool = {raw_pool.data(), 16, (size_t)total_blocks,
                    desc_pool.data(), 1, (size_t)total_blocks * 4,
                    dc_pool.data(), 1, (size_t)total_blocks};
    std::vector<uint8_t> nest(70 * 38);
    std::vector<uint32_t> mv((size_t)(w / 8) * (h / 8)), mv2(mv.size());
    FrameOut fout{};
    fout.nest = nest.data();
    fout.mv = mv.data();
    fout.mv2 = mv2.data();
    char err[256];

    auto t0 = std::chrono::steady_clock::now();
    long done = 0;
    for (int r = 0; r < reps; r++) {
        for (auto& fr : frames) {
            int rc = hvqm4_plan_frame(fr.second.data(), fr.second.size(),
                                      fr.first, (int)w, (int)h, (int)hs,
                                      (int)vs, planes, &pool, &fout, err,
                                      sizeof err);
            if (rc) { std::fprintf(stderr, "plan failed: %s\n", err); return 1; }
            done++;
        }
    }
    auto dt = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0).count();
    std::printf("%ld frames in %.3f s  =  %.0f fps  (%.3f ms/frame)\n",
                done, dt, done / dt, 1e3 * dt / done);
    return 0;
}
