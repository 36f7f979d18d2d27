// Async host<->NVMe tensor IO: the ZeRO-Infinity swap backend.
//
// The port's copy of the JAX package's csrc/aio.cpp (reference csrc/aio/,
// deepspeed_py_aio_handle.cpp): a C++ thread pool that services pread/
// pwrite requests against swap files, so optimizer moments and params
// stream to NVMe while the Python thread returns at once. The pool uses
// plain p{read,write} on per-request fds: sequential requests of 1 MiB and
// more keep an NVMe device busy the way libaio's queue does (the
// reference's single_submit/overlap_events map to num_threads here).
//
// Files hold the raw bytes of the buffer, so a file written through either
// package's handle reads back bit for bit through the other's.
//
// C ABI: handle-based; buffers are caller-owned (CPU tensors or numpy
// arrays) and must stay alive until dstpu_aio_wait returns.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Request {
    bool write;
    std::string path;
    void* buf;
    int64_t nbytes;
    int64_t offset;
};

struct Handle {
    std::vector<std::thread> workers;
    std::deque<Request> queue;
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    int64_t inflight = 0;
    std::atomic<int64_t> errors{0};
    bool stop = false;

    explicit Handle(int num_threads) {
        for (int t = 0; t < num_threads; ++t)
            workers.emplace_back([this] { run(); });
    }

    ~Handle() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& w : workers) w.join();
    }

    void submit(Request r) {
        {
            std::lock_guard<std::mutex> lk(mu);
            queue.push_back(std::move(r));
            ++inflight;
        }
        cv.notify_one();
    }

    int64_t wait_all() {
        std::unique_lock<std::mutex> lk(mu);
        done_cv.wait(lk, [this] { return inflight == 0; });
        return errors.exchange(0);
    }

    void run() {
        for (;;) {
            Request r;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [this] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                r = std::move(queue.front());
                queue.pop_front();
            }
            if (!service(r)) errors.fetch_add(1);
            {
                std::lock_guard<std::mutex> lk(mu);
                if (--inflight == 0) done_cv.notify_all();
            }
        }
    }

    static bool service(const Request& r) {
        int flags = r.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
        int fd = ::open(r.path.c_str(), flags, 0644);
        if (fd < 0) return false;
        char* p = static_cast<char*>(r.buf);
        int64_t left = r.nbytes, off = r.offset;
        bool ok = true;
        while (left > 0) {
            ssize_t k = r.write ? ::pwrite(fd, p, left, off)
                                : ::pread(fd, p, left, off);
            if (k <= 0) { ok = false; break; }
            p += k; off += k; left -= k;
        }
        ::close(fd);
        return ok;
    }
};

}  // namespace

extern "C" {

void* dstpu_aio_create(int num_threads) {
    if (num_threads < 1) num_threads = 1;
    return new Handle(num_threads);
}

void dstpu_aio_destroy(void* h) { delete static_cast<Handle*>(h); }

void dstpu_aio_pwrite(void* h, const char* path, void* buf, int64_t nbytes,
                      int64_t offset) {
    static_cast<Handle*>(h)->submit(
        Request{true, path, buf, nbytes, offset});
}

void dstpu_aio_pread(void* h, const char* path, void* buf, int64_t nbytes,
                     int64_t offset) {
    static_cast<Handle*>(h)->submit(
        Request{false, path, buf, nbytes, offset});
}

// Block until all submitted requests finish; returns the number of failed
// requests since the last wait (0 = success).
int64_t dstpu_aio_wait(void* h) {
    return static_cast<Handle*>(h)->wait_all();
}

}  // extern "C"
