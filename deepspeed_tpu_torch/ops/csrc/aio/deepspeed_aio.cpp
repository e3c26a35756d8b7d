// Async file I/O engine for tensor swapping (DeepNVMe analog).
//
// The port's copy of deepspeed_tpu/ops/csrc/aio/deepspeed_aio.cpp: a pool of
// worker threads servicing pread/pwrite requests against files, used by the
// swap layer (runtime/swap_tensor/swapper.py) and the KV swap tier. Buffered
// positional I/O from a thread pool, no libaio dependency. Host C++ built by
// g++ at first use (ops/op_builder.py ``load_host``).
//
// Two changes from the copy it mirrors. A worker bumps ``completed`` and
// notifies ``done_cv`` while holding ``mu``: done outside the lock, the
// notify can land between a waiter's predicate check and its sleep, and
// that waiter then sleeps forever (a lost wakeup). And files are opened
// buffered only: no caller asks for O_DIRECT, so its path is left out.
//
// C ABI (ctypes-friendly): all functions exported with ds_aio_ prefix.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Request {
    int64_t id;
    bool write;
    std::string path;
    void* buf;
    int64_t nbytes;
    int64_t offset;
};

struct AioHandle {
    std::vector<std::thread> workers;
    std::deque<Request> queue;
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    std::atomic<int64_t> submitted{0};
    std::atomic<int64_t> completed{0};
    std::atomic<int64_t> errors{0};
    int block_size;
    bool stop = false;

    AioHandle(int num_threads, int block_size_) : block_size(block_size_) {
        for (int i = 0; i < num_threads; ++i) {
            workers.emplace_back([this] { this->worker_loop(); });
        }
    }

    ~AioHandle() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& t : workers) t.join();
    }

    void worker_loop() {
        for (;;) {
            Request req;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [this] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                req = queue.front();
                queue.pop_front();
            }
            int rc = do_io(req);
            {
                // under mu: wait_all checks its predicate under mu, so the
                // bump and the notify cannot fall between its check and
                // its sleep
                std::lock_guard<std::mutex> lk(mu);
                if (rc != 0) errors.fetch_add(1);
                completed.fetch_add(1);
                done_cv.notify_all();
            }
        }
    }

    int do_io(const Request& req) {
        int fd = ::open(req.path.c_str(), req.write ? (O_WRONLY | O_CREAT) : O_RDONLY, 0644);
        if (fd < 0) return -1;
        int rc = do_io_buffered(fd, req);
        ::close(fd);
        return rc;
    }

    int do_io_buffered(int fd, const Request& req) {
        int64_t remaining = req.nbytes;
        char* p = static_cast<char*>(req.buf);
        int64_t off = req.offset;
        // chunk into block_size pieces so queues interleave across workers
        while (remaining > 0) {
            int64_t n = remaining < block_size ? remaining : block_size;
            ssize_t r = req.write ? ::pwrite(fd, p, n, off) : ::pread(fd, p, n, off);
            if (r < 0) return -1;
            if (r == 0) break;  // EOF on read
            p += r;
            off += r;
            remaining -= r;
        }
        return remaining == 0 ? 0 : (req.write ? -1 : 0);
    }

    int64_t submit(bool write, const char* path, void* buf, int64_t nbytes, int64_t offset) {
        int64_t id = submitted.fetch_add(1) + 1;
        {
            std::lock_guard<std::mutex> lk(mu);
            queue.push_back(Request{id, write, path, buf, nbytes, offset});
        }
        cv.notify_one();
        return id;
    }

    void wait_all() {
        std::unique_lock<std::mutex> lk(mu);
        done_cv.wait(lk, [this] {
            return completed.load() >= submitted.load();
        });
    }
};

}  // namespace

extern "C" {

void* ds_aio_handle_new(int num_threads, int block_size) {
    if (num_threads < 1) num_threads = 1;
    if (block_size < 4096) block_size = 1 << 20;
    return new AioHandle(num_threads, block_size);
}

void ds_aio_handle_free(void* h) {
    delete static_cast<AioHandle*>(h);
}

int64_t ds_aio_pread(void* h, const char* path, void* buf, int64_t nbytes, int64_t offset) {
    return static_cast<AioHandle*>(h)->submit(false, path, buf, nbytes, offset);
}

int64_t ds_aio_pwrite(void* h, const char* path, void* buf, int64_t nbytes, int64_t offset) {
    return static_cast<AioHandle*>(h)->submit(true, path, buf, nbytes, offset);
}

void ds_aio_wait(void* h) {
    static_cast<AioHandle*>(h)->wait_all();
}

int64_t ds_aio_error_count(void* h) {
    return static_cast<AioHandle*>(h)->errors.load();
}

int64_t ds_aio_inflight(void* h) {
    auto* handle = static_cast<AioHandle*>(h);
    return handle->submitted.load() - handle->completed.load();
}

}  // extern "C"
