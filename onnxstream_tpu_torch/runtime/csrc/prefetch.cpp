// libostt_prefetch — the threaded ordered disk prefetcher of
// onnxstream_tpu_torch (a copy of the JAX package's csrc/prefetch.cpp, with
// the same C interface: ostpu_prefetch_new / init / get / restart / delete).
//
// It implements the reference DiskPrefetch contract (reference
// src/onnxstream.h:356-664): on_init fixes the read order; a worker reads
// ahead into a bounded buffer (always allowing one file past the budget,
// matching m_limit_plus_one_file); get() pops the front entry, blocking until
// ready, and copies it into the caller's buffer (the executor's pinned
// staging); restart rewinds. Out-of-order requests read directly. The worker
// holds no Python lock. Built with g++ at first use by
// onnxstream_tpu_torch/runtime/native.py and loaded by
// onnxstream_tpu_torch/runtime/weights.py through ctypes.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#if defined(_WIN32)
#define OSTPU_EXPORT extern "C" __declspec(dllexport)
#else
#define OSTPU_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

struct Entry {
    std::string name;
    uint64_t size;
};

class Prefetcher {
public:
    Prefetcher(std::string prefix, uint64_t max_bytes)
        : prefix_(std::move(prefix)), max_bytes_(max_bytes) {}

    ~Prefetcher() { stop(); }

    void init(std::vector<Entry> entries) {
        stop();
        std::lock_guard<std::mutex> lk(mu_);
        entries_ = std::move(entries);
        ready_.clear();
        buffered_ = 0;
        next_read_ = 0;
        next_serve_ = 0;
        error_.clear();
        stop_flag_ = false;
        worker_ = std::thread([this] { run(); });
    }

    void restart() {
        std::vector<Entry> e;
        {
            std::lock_guard<std::mutex> lk(mu_);
            e = entries_;
        }
        init(std::move(e));
    }

    // returns 0 ok, -1 io error. Requests off the announced serve order (a
    // re-run of a single op, a skipped entry) fall back to a direct read —
    // same semantics as the Python DiskPrefetchWeightsProvider.get().
    int get(const std::string& name, void* dst, uint64_t size) {
        std::unique_lock<std::mutex> lk(mu_);
        bool in_order = next_serve_ < entries_.size() && entries_[next_serve_].name == name;
        if (!in_order && !ready_.count(name)) {
            lk.unlock();
            return read_direct(name, dst, size);
        }
        cv_.wait(lk, [&] { return ready_.count(name) || !error_.empty(); });
        if (!error_.empty()) return -1;
        auto it = ready_.find(name);
        if (it->second.size() != size) return -1;
        std::memcpy(dst, it->second.data(), size);
        buffered_ -= it->second.size();
        ready_.erase(it);
        if (in_order) next_serve_++;
        cv_.notify_all();
        return 0;
    }

    const char* error() const { return error_.c_str(); }

private:
    int read_direct(const std::string& name, void* dst, uint64_t size) {
        std::string path = prefix_ + name;
        FILE* f = ::fopen(path.c_str(), "rb");
        if (!f) return -1;
        size_t got = ::fread(dst, 1, size, f);
        ::fclose(f);
        return got == size ? 0 : -1;
    }

    void run() {
        try {
            while (true) {
                Entry e;
                {
                    std::unique_lock<std::mutex> lk(mu_);
                    // read ahead while within budget; always allow one file
                    // past the limit (reference m_limit_plus_one_file)
                    cv_.wait(lk, [&] {
                        return stop_flag_ || next_read_ >= entries_.size() ||
                               !(buffered_ > max_bytes_ && !ready_.empty());
                    });
                    if (stop_flag_ || next_read_ >= entries_.size()) return;
                    e = entries_[next_read_++];
                }
                std::vector<char> buf(e.size);
                std::string path = prefix_ + e.name;
                FILE* f = ::fopen(path.c_str(), "rb");
                if (!f || ::fread(buf.data(), 1, e.size, f) != e.size) {
                    if (f) ::fclose(f);
                    std::lock_guard<std::mutex> lk(mu_);
                    error_ = "prefetch: failed to read " + path;
                    cv_.notify_all();
                    return;
                }
                ::fclose(f);
                std::lock_guard<std::mutex> lk(mu_);
                buffered_ += buf.size();
                ready_.emplace(e.name, std::move(buf));
                cv_.notify_all();
            }
        } catch (...) {
            std::lock_guard<std::mutex> lk(mu_);
            error_ = "prefetch: worker exception";
            cv_.notify_all();
        }
    }

    void stop() {
        {
            std::lock_guard<std::mutex> lk(mu_);
            stop_flag_ = true;
            cv_.notify_all();
        }
        if (worker_.joinable()) worker_.join();
    }

    std::string prefix_;
    uint64_t max_bytes_;
    std::vector<Entry> entries_;
    std::map<std::string, std::vector<char>> ready_;
    uint64_t buffered_ = 0;
    size_t next_read_ = 0;
    size_t next_serve_ = 0;
    bool stop_flag_ = false;
    std::string error_;
    std::mutex mu_;
    std::condition_variable cv_;
    std::thread worker_;
};

}  // namespace

OSTPU_EXPORT void* ostpu_prefetch_new(const char* prefix, uint64_t max_bytes) {
    return new Prefetcher(prefix ? prefix : "", max_bytes);
}

OSTPU_EXPORT void ostpu_prefetch_init(void* h, const char** names, const uint64_t* sizes, int n) {
    std::vector<Entry> e(n);
    for (int i = 0; i < n; i++) e[i] = {names[i], sizes[i]};
    static_cast<Prefetcher*>(h)->init(std::move(e));
}

OSTPU_EXPORT int ostpu_prefetch_get(void* h, const char* name, void* dst, uint64_t size) {
    return static_cast<Prefetcher*>(h)->get(name, dst, size);
}

OSTPU_EXPORT void ostpu_prefetch_restart(void* h) { static_cast<Prefetcher*>(h)->restart(); }

OSTPU_EXPORT void ostpu_prefetch_delete(void* h) { delete static_cast<Prefetcher*>(h); }
